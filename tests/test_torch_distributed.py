"""The port's multi-process planning (kafkabalancer_tpu_torch/parallel/
distributed.py) with two gloo processes on the CPU, after
tests/test_distributed.py.

Two worker processes (tests/torch_distributed_worker.py, no jax) join
one group through ``initialize``, name two CPU devices each and build
global meshes of four entries. The cross-process ``sharded_score_moves``
(the part axis over both processes, and a 2 x 2 mesh whose part axes are
process-local), ``plan_sharded`` (plain and with polish: every session
iteration's pools gathered across the processes) and the four-scenario
``sweep`` (the sweep axis over both processes) must give:

- the same result on both processes;
- the result of the port in one process on the same mesh shapes
  (``make_mesh(devices=["cpu"] * 4)``) and of the unsharded scorer;
- the JAX package's single-process ``sharded_score_moves``,
  ``plan_sharded`` and ``sweep`` on the same clusters
  (``synth_cluster(96, 8, rf=3, seed=71)``, ``synth_cluster(24, 6,
  rf=2, seed=11)``).

Tolerance: none (floats compared by their bits).
"""

import copy
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import torch_distributed_cases as cases
import torch_helpers  # noqa: F401  (one torch CPU thread)
from kafkabalancer_tpu_torch.parallel import distributed
from kafkabalancer_tpu_torch.parallel.mesh import make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workers():
    """Both workers' results (one run for the module)."""
    d = tempfile.mkdtemp(prefix="kbd-")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port),
             os.path.join(d, f"w{i}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=HERE,
        )
        for i in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    try:
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {i} failed:\n{out}"
            assert f"DIST_OK proc={i}" in out, out
        res = []
        for i in range(2):
            with open(os.path.join(d, f"w{i}.json")) as fh:
                res.append(json.load(fh))
        yield res
    finally:
        shutil.rmtree(d, ignore_errors=True)


def without_proc(r):
    return {k: v for k, v in r.items() if k != "proc"}


def test_both_processes_agree(workers):
    assert [r["proc"] for r in workers] == [0, 1]
    assert without_proc(workers[0]) == without_proc(workers[1])
    assert workers[0]["session"]["moves"], "the session planned no move"
    assert len(workers[0]["polish"]["moves"]) >= len(
        workers[0]["session"]["moves"]) > 0


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_sharded_score_equals_one_process_and_unsharded(workers, shape):
    sweep_n, part_n = (int(x) for x in shape.split("x"))
    mesh = make_mesh(devices=["cpu"] * 4, shape=(sweep_n, part_n))
    want = cases.score_all(mesh)
    got = workers[0]["score"][shape]
    assert got == want
    for sharded, unsharded in got:
        assert sharded == unsharded


@pytest.mark.parametrize("polish", [False, True])
def test_plan_sharded_equals_one_process(workers, polish):
    mesh = make_mesh(devices=["cpu"] * 4, shape=(1, 4))
    want = cases.session_moves(mesh, polish=polish)
    assert workers[0]["polish" if polish else "session"] == want


def test_sweep_equals_one_process(workers):
    mesh = make_mesh(devices=["cpu"] * 4)
    assert workers[0]["sweep"] == cases.sweep_fields(mesh)


# --- the JAX package, one process -------------------------------------------


def test_sharded_score_equals_the_reference(workers):
    import jax.numpy as jnp

    from kafkabalancer_tpu.models import default_rebalance_config as jdefault
    from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize
    from kafkabalancer_tpu.parallel.mesh import make_mesh as jmesh
    from kafkabalancer_tpu.parallel.shard_move import (
        sharded_score_moves as jscore,
    )
    from kafkabalancer_tpu.solvers.tpu import _oracle_loads
    from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

    want = []
    for n, b, rf, seed in cases.SCORE_CLUSTERS:
        pl = jsynth(n, b, rf=rf, seed=seed, weighted=True)
        cfg = jdefault()
        dp = jtensorize(pl, cfg, min_bucket=8)
        loads = np.zeros(dp.bvalid.shape[0])
        for bid, load in _oracle_loads(pl, cfg).items():
            loads[dp.broker_index(bid)] = load
        jargs = (jnp.asarray(loads), jnp.asarray(dp.replicas),
                 jnp.asarray(dp.allowed), jnp.asarray(dp.member),
                 jnp.asarray(dp.weights), jnp.asarray(dp.nrep_cur),
                 jnp.asarray(dp.nrep_tgt), jnp.asarray(dp.pvalid),
                 jnp.asarray(dp.bvalid), float(dp.nb), 2)
        for leaders in (False, True):
            u, i, su, perm = jscore(*jargs, leaders=leaders,
                                    mesh=jmesh(4, shape=(1, 4)))
            want.append([cases.hexf(u), int(i), cases.hexf(su),
                         [int(x) for x in np.asarray(perm).reshape(-1)]])
    for shape in ("1x4", "2x2"):
        assert [row[0] for row in workers[0]["score"][shape]] == want


@pytest.mark.parametrize("polish", [False, True])
def test_plan_sharded_equals_the_reference(workers, polish):
    from kafkabalancer_tpu.models import default_rebalance_config as jdefault
    from kafkabalancer_tpu.parallel.mesh import make_mesh as jmesh
    from kafkabalancer_tpu.parallel.shard_session import (
        plan_sharded as jplan_sharded,
    )
    from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

    s = cases.SESSION
    pl = jsynth(s["n"], s["b"], rf=s["rf"], seed=s["seed"], weighted=True)
    cfg = jdefault()
    cfg.min_unbalance = 1e-7
    cfg.allow_leader_rebalancing = True
    opl = jplan_sharded(pl, copy.deepcopy(cfg), s["budget"],
                        jmesh(4, shape=(1, 4)), batch=s["batch"],
                        chunk_moves=s["chunk_moves"], polish=polish)
    want = {"moves": cases.moves(opl), "state": cases.state(pl)}
    assert workers[0]["polish" if polish else "session"] == want


def test_sweep_equals_the_reference(workers):
    from kafkabalancer_tpu.models import default_rebalance_config as jdefault
    from kafkabalancer_tpu.parallel.sweep import sweep as jsweep
    from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

    pl, scenarios = cases.sweep_instance(jsynth)
    results = jsweep(pl, jdefault(), scenarios,
                     max_reassign=cases.SWEEP["max_reassign"])
    assert workers[0]["sweep"] == [cases.sweep_row(r) for r in results]


# --- the wrapper outside a group ---------------------------------------------


def test_outside_a_group_is_one_process():
    assert distributed.is_multi_host() is False
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    mesh = make_mesh(devices=["cpu"] * 4, shape=(2, 2))
    assert mesh.process_index.tolist() == [[0, 0], [0, 0]]
    assert mesh.local_axis("part") == [(0, mesh.lead), (1, mesh.lead)]
    assert not mesh.spans_processes("part")
    assert not mesh.spans_processes("sweep")
