"""Time the port's scoring kernel in two checkouts, in turns, on one GPU.

    python scripts/kernel_ab.py PARENT_TREE CHANGE_TREE [--rounds N]

Each tree is a checkout of this repository (for instance a ``git archive``
of the parent commit unpacked into a directory ``.gitignore`` lists). The
script runs one process per (tree, turn) in the order parent, change,
change, parent (repeated ``--rounds`` times); each process builds that
tree's kernel, captures the main path's scoring inputs with that tree's
``chip_smoke.capture_inputs`` at the 10k x 100 bucket and at 131072 x 256,
and times ``shard_score`` (main-path variant) with that tree's
``chip_smoke.cuda_ms``: device ms per call, CUDA events, L2 flushed,
median of 20. Prints one JSON line per process and, last, the medians per
tree and shape. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((10000, 100), (131072, 256))

CHILD = r"""
import json, sys, torch
tree = sys.argv[1]
sys.path.insert(0, tree)
import chip_smoke as cs
from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
assert sk.__file__.startswith(tree), sk.__file__
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda").zero_
out = {}
for n_parts, n_brokers in json.loads(sys.argv[2]):
    args = cs.variant(cs.capture_inputs(n_parts, n_brokers, "cuda"), False, False)
    ms, host_ms = cs.cuda_ms(lambda: sk.shard_score(*args, allow_leader=False), 20, flush)
    out[f"{n_parts}x{n_brokers}"] = ms
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args()
    trees = {"parent": os.path.abspath(a.parent), "change": os.path.abspath(a.change)}
    times: dict = {name: {} for name in trees}
    for _ in range(a.rounds):
        for name in ("parent", "change", "change", "parent"):
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, trees[name], json.dumps(SHAPES)],
                cwd=trees[name], capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": name, "ms": row}), flush=True)
            for shape, ms in row.items():
                times[name].setdefault(shape, []).append(ms)
    print(json.dumps({
        name: {shape: statistics.median(v) for shape, v in per.items()}
        for name, per in times.items()
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
