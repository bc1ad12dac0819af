"""The port's converge session against the reference's, move for move.

``kafkabalancer_tpu_torch.solvers.scan.plan(..., device="cpu")`` runs the
port's session with the scoring kernel's plain version (what
``shard_score`` runs on a CPU tensor). It must emit the same moves, in
the same order, and leave the same final assignment as

- ``kafkabalancer_tpu.solvers.scan.plan(engine="xla")`` at float64 (the
  reference's x64 test mode), for ``batch`` 1 and 16;
- ``kafkabalancer_tpu.parallel.shard_session.plan_sharded(engine=
  "pallas-interpret")`` at float32 on the 8-device CPU mesh — the
  reference's scoring kernel in interpret mode, in the set-ups of
  tests/test_parallel.py — with and without ``allow_leader`` and with
  restricted brokers.

Tolerance: none; the logs are compared for equality. On the card,
tests/test_torch_cuda.py runs the same session with the kernel and with
the plain scorer and requires identical logs.
"""

import copy
import random

import pytest
import torch

from helpers import random_partition_list

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

ensure_x64()

from kafkabalancer_tpu_torch.models import (  # noqa: E402
    Partition,
    PartitionList,
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.parallel import shard_kernel  # noqa: E402
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)


def to_port(pl):
    """The same partitions as the port's model objects."""
    return PartitionList(
        version=pl.version,
        partitions=[
            Partition(
                topic=p.topic, partition=p.partition, replicas=list(p.replicas),
                weight=p.weight, num_replicas=p.num_replicas,
                brokers=None if p.brokers is None else list(p.brokers),
                num_consumers=p.num_consumers,
            )
            for p in pl.partitions
        ],
    )


def moves(opl):
    return [(p.topic, p.partition, tuple(p.replicas)) for p in (opl.partitions or [])]


def state(pl):
    return [(p.topic, p.partition, tuple(p.replicas)) for p in pl.partitions]


def cfgs(allow_leader=False, min_unbalance=1e-7):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.allow_leader_rebalancing = allow_leader
        c.min_unbalance = min_unbalance
    return j, t


def restricted(synth, seed, n=160, b=16):
    pl = synth(n, b, rf=3, seed=seed, weighted=True)
    rng = random.Random(seed)
    for p in pl.iter_partitions():
        if rng.random() < 0.5:
            extra = [x for x in range(1, b + 1) if rng.random() < 0.5]
            p.brokers = sorted(set(p.replicas) | set(extra))
    return pl


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_plan_matches_reference_f64(batch, allow_leader, seed):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    rng = random.Random(1000 + seed)
    pl_j = random_partition_list(
        rng, 60, 9, weighted=True, with_consumers=True,
        restrict_brokers=bool(seed % 2),
    )
    pl_t = to_port(pl_j)
    jc, tc = cfgs(allow_leader)
    budget = 40 if batch == 1 else 400
    opl_j = jplan(pl_j, jc, budget, batch=batch, engine="xla")
    opl_t = tscan.plan(pl_t, tc, budget, batch=batch, device="cpu")
    assert moves(opl_j), "the reference planned no move"
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("batch", [1, 16])
def test_plan_synth_matches_reference_f64(batch):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    pl_j, pl_t = jsynth(300, 20, rf=3, seed=47), tsynth(300, 20, rf=3, seed=47)
    jc, tc = cfgs(allow_leader=True)
    budget = 60 if batch == 1 else 2000
    opl_j = jplan(pl_j, jc, budget, batch=batch, engine="xla")
    opl_t = tscan.plan(pl_t, tc, budget, batch=batch, device="cpu")
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("allow_leader", [False, True])
def test_plan_matches_reference_kernel_f32(allow_leader):
    """tests/test_parallel.py::test_sharded_pallas_engine_bit_matches_xla's
    set-up: 300 x 20, batch 16, the Pallas shard kernel in interpret mode."""
    from kafkabalancer_tpu.parallel.mesh import make_mesh
    from kafkabalancer_tpu.parallel.shard_session import plan_sharded

    pl_j, pl_t = jsynth(300, 20, rf=3, seed=47), tsynth(300, 20, rf=3, seed=47)
    jc, tc = cfgs(allow_leader)
    opl_j = plan_sharded(
        pl_j, copy.deepcopy(jc), 2000, make_mesh(8, shape=(1, 8)), batch=16,
        engine="pallas-interpret",
    )
    opl_t = tscan.plan(
        pl_t, tc, 2000, dtype=torch.float32, batch=16, device="cpu"
    )
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_plan_restricted_matches_reference_kernel_f32():
    """tests/test_parallel.py::test_sharded_pallas_engine_restricted_bit_
    matches_xla's set-up: per-partition broker restrictions (the [P, B]
    allowed matrix reaches the scorer)."""
    from kafkabalancer_tpu.parallel.mesh import make_mesh
    from kafkabalancer_tpu.parallel.shard_session import plan_sharded

    pl_j, pl_t = restricted(jsynth, 73), restricted(tsynth, 73)
    jc, tc = cfgs()
    opl_j = plan_sharded(
        pl_j, copy.deepcopy(jc), 1000, make_mesh(8, shape=(1, 8)), batch=8,
        engine="pallas-interpret",
    )
    opl_t = tscan.plan(pl_t, tc, 1000, dtype=torch.float32, batch=8, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_session_uses_the_scorer_hook():
    """The batched session scores through ``shard_score`` unless a scorer
    is passed; passing the plain version gives the same plan."""
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return shard_kernel.shard_score_plain(*a, **k)

    _, tc = cfgs()
    a = tscan.plan(tsynth(200, 12, seed=5), tc, 500, batch=8, device="cpu")
    b = tscan.plan(
        tsynth(200, 12, seed=5), tc, 500, batch=8, device="cpu", scorer=spy
    )
    assert calls and moves(a) == moves(b)


def test_invalid_engines_and_colocation_requests_raise():
    _, tc = cfgs()
    with pytest.raises(ValueError, match="batch > 1"):
        tscan.plan(tsynth(50, 6), tc, 10, batch=1, anti_colocation=0.5,
                   device="cpu")
    with pytest.raises(ValueError):
        tscan.plan(tsynth(50, 6), tdefault(), 10, engine="nope", device="cpu")


def test_cuda_is_the_default_device(monkeypatch):
    """Without a card, a plan that does not ask for the CPU raises; it
    never plans on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscan.plan(tsynth(50, 6), tdefault(), 10, batch=4)
