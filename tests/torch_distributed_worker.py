"""Worker process of the port's two-process test (tests/test_torch_distributed.py).

Usage: python torch_distributed_worker.py <process_id> <port> <out.json>

Each worker joins a two-process gloo group through the port's
``parallel.distributed.initialize``, names two CPU devices of its own and
builds global meshes of four entries with ``make_mesh``:

- ``sharded_score_moves`` on a ``1 x 4`` mesh (the part axis spans both
  processes, so the per-shard minima cross the process boundary) and on
  a ``2 x 2`` mesh (each process's part axis is its own), each against
  the unsharded ``score_moves`` on the same inputs;
- ``plan_sharded`` on the ``1 x 4`` mesh, plain and with polish: every
  session iteration's pools are gathered across the processes;
- the four-scenario ``sweep`` on the ``2 x 2`` mesh: the sweep axis
  spans both processes, scenarios run where their device lives and the
  results are gathered in scenario order.

Writes what it computed to ``out.json``; the test compares both workers'
files with each other, with the port in one process and with the JAX
package. Imports no jax.
"""

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

process_id = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]

import torch  # noqa: E402

from kafkabalancer_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize,
    is_multi_host,
    process_count,
    process_index,
)

torch.set_num_threads(1)
initialize(f"127.0.0.1:{port}", num_processes=2, process_id=process_id,
           timeout_s=240)
assert is_multi_host() and process_count() == 2
assert process_index() == process_id

from kafkabalancer_tpu_torch.parallel import shard_kernel as sk  # noqa: E402
from kafkabalancer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

LOCAL = ["cpu", "cpu"]
row = make_mesh(4, shape=(1, 4), devices=LOCAL)  # part axis over both
grid = make_mesh(4, devices=LOCAL)  # 2 x 2: sweep axis over both
assert row.process_index.tolist() == [[0, 0, 1, 1]]
assert grid.process_index.tolist() == [[0, 0], [1, 1]]
assert row.spans_processes("part") and not grid.spans_processes("part")
assert grid.spans_processes("sweep")

import torch_distributed_cases as cases  # noqa: E402

result = {"proc": process_id}
result["score"] = {
    name: cases.score_all(mesh) for name, mesh in (("1x4", row), ("2x2", grid))
}
sk.shard_score.launches = 0
result["session"] = cases.session_moves(row, polish=False)
result["polish"] = cases.session_moves(row, polish=True)
result["k1_launches"] = sk.shard_score.launches
result["sweep"] = cases.sweep_fields(grid)
with open(out_path, "w") as fh:
    json.dump(result, fh)
print(f"DIST_OK proc={process_id}", flush=True)
