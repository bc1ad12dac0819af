"""Time one of the port's kernels in two or more checkouts, in turns, on
one GPU.

    python scripts/kernel_ab.py PARENT_TREE CHANGE_TREE [MORE_TREES ...]
        [--rounds N] [--kernel shard_score|pallas_session]

Each tree is a checkout of this repository (for instance a ``git archive``
of the parent commit unpacked into a directory ``.gitignore`` lists). The
script runs one process per (tree, turn) in the order of the trees, then
in reverse (parent, change, change, parent for two; repeated ``--rounds``
times); each process builds that tree's kernel and times it at the 10k x
100 bucket and at 131072 x 256 with that tree's ``chip_smoke`` helpers
(``cuda_ms``: device ms per call, CUDA events, L2 flushed, a spin kernel
hiding the host's cost):

- ``shard_score`` (default): the main path's scoring inputs
  (``capture_inputs``), main-path variant, median of 20;
- ``pallas_session``: ``pallas_session.launch`` on the first chunk's
  session arguments (``capture_session``; budget, seed and batch as
  chip_smoke's phase 2b: the whole chunk, batch 100, and 4000 moves,
  batch 128), main-path variant, a fresh ``b2_state`` per launch, median
  of 5.

Prints one JSON line per process and, last, the medians per tree and
shape. Trees are named "parent" and "change" when there are two, else by
their path as given. Needs a CUDA device; exits non-zero without one.
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
tree, kernel = sys.argv[1], sys.argv[3]
sys.path.insert(0, tree)
import chip_smoke as cs
from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
from kafkabalancer_tpu_torch.solvers import pallas_session as ps
assert sk.__file__.startswith(tree), sk.__file__
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda").zero_
out = {}
for n_parts, n_brokers in json.loads(sys.argv[2]):
    if kernel == "shard_score":
        args = cs.variant(cs.capture_inputs(n_parts, n_brokers, "cuda"), False, False)
        ms, host_ms = cs.cuda_ms(lambda: sk.shard_score(*args, allow_leader=False), 20, flush)
    else:
        main = (n_parts, n_brokers) == tuple(cs.MAIN_SHAPE)
        args, kw = cs.capture_session(
            n_parts, n_brokers, cs.MAIN_REASSIGN if main else cs.SCALE_MOVES,
            cs.SEED if main else cs.SEED + 1, "cuda")
        a, k = cs.b2_variant(args, kw, False, False, 100 if main else 128)
        reps = 5
        states = iter([cs.b2_state(a, k) for _ in range(2 + 2 * reps)])
        ms, host_ms = cs.cuda_ms(
            lambda: ps.launch(next(states), *a[11:16], k["max_moves"], False),
            reps, flush)
    out[f"{n_parts}x{n_brokers}"] = ms
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernel", choices=("shard_score", "pallas_session"),
                    default="shard_score")
    a = ap.parse_args()
    if len(a.trees) < 2:
        ap.error("give at least two trees")
    names = ["parent", "change"] if len(a.trees) == 2 else list(a.trees)
    trees = {n: os.path.abspath(t) for n, t in zip(names, a.trees)}
    times: dict = {name: {} for name in trees}
    for _ in range(a.rounds):
        for name in names + names[::-1]:
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, trees[name], json.dumps(SHAPES),
                 a.kernel],
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
