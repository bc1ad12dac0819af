"""The port's anti-colocation session against the reference's.

``kafkabalancer_tpu_torch.solvers.scan.plan(..., anti_colocation=λ,
device="cpu")`` runs the colocation session with the scoring kernel's
plain version (its colocation variant). It must emit the reference's
moves in the reference's order and leave the same final assignment as

- ``kafkabalancer_tpu.solvers.scan.plan(engine="xla", anti_colocation=λ)``
  at float64: batch 4 and 16, with and without ``allow_leader``,
  restricted brokers, chunked re-entry, the zipf-topic instance of
  tests/test_scan.py, and the polish composition;
- ``kafkabalancer_tpu.parallel.shard_session.plan_sharded(engine=
  "pallas-interpret", anti_colocation=λ)`` at float32 on the 8-device
  CPU mesh (the reference's scoring kernel in interpret mode).

``prefix_accept`` with the (topic, broker) claims and the colocation
deltas equals the reference's on seeded pools; the activation rules
raise and warn as the reference's do. Tolerance: none; logs, states and
acceptance masks compare equal.
"""

import copy
import random

import numpy as np
import pytest
import torch

from helpers import random_partition_list

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu_torch.models import (  # noqa: E402
    Partition,
    PartitionList,
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.ops.cost import broker_loads  # noqa: E402
from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device  # noqa: E402
from kafkabalancer_tpu_torch.parallel import shard_kernel  # noqa: E402
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import moves, restricted, state, to_port  # noqa: E402

LAM = 0.001


def cfgs(allow_leader=False, min_unbalance=1e-9):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.allow_leader_rebalancing = allow_leader
        c.min_unbalance = min_unbalance
    return j, t


def colo_count(pl):
    """Same-topic replicas sharing a broker, beyond the first."""
    import collections

    c = collections.Counter(
        (p.topic, b) for p in pl.iter_partitions() for b in p.replicas
    )
    return sum(v - 1 for v in c.values() if v > 1)


def pools(seed, dtype):
    """A seeded candidate pool of K = 24 over 8 partitions, 6 brokers and
    3 topics, with dead candidates, equal values and colocation deltas."""
    rng = np.random.default_rng(seed)
    K, B = 24, 6
    vals = rng.uniform(0.0, 1.0, K)
    vals[rng.random(K) < 0.15] = np.inf
    vals[3] = vals[5]  # a tie, decided by index
    s_ = rng.integers(0, B, K)
    t = (s_ + rng.integers(1, B, K)) % B
    return dict(
        vals=vals.astype(dtype),
        p=rng.integers(0, 8, K),
        s_=s_,
        t=t,
        w_k=rng.uniform(0.5, 3.0, K).astype(dtype),
        loads=rng.uniform(5.0, 15.0, B).astype(dtype),
        topic=rng.integers(0, 3, K),
        colo_d=(LAM * rng.integers(-1, 2, K)).astype(dtype),
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(6))
def test_prefix_accept_with_colocation_matches_reference(dtype, seed):
    from kafkabalancer_tpu.solvers.scan import prefix_accept as jaccept

    c = pools(seed, dtype)
    loads = c["loads"]
    avg = dtype(loads.mean())
    su = dtype(1.2)
    args = ("vals", "p", "s_", "t", "w_k", "loads")
    jr = jaccept(
        *(jnp.asarray(c[k]) for k in args), jnp.asarray(avg), jnp.asarray(su),
        jnp.asarray(1e-6, dtype), jnp.asarray(1.5, dtype), jnp.int32(3), 16,
        jnp.int32(40), 64, topic=jnp.asarray(c["topic"]),
        colo_d=jnp.asarray(c["colo_d"]),
    )
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tr = tscan.prefix_accept(
        *(torch.from_numpy(c[k]) for k in args), torch.tensor(avg),
        torch.tensor(su), torch.tensor(1e-6, dtype=tdt),
        torch.tensor(1.5, dtype=tdt), 3, 16, 40, 64,
        topic=torch.from_numpy(c["topic"]),
        colo_d=torch.from_numpy(c["colo_d"]),
    )
    for a, b in zip(jr, tr):
        assert np.array_equal(np.asarray(a), b.numpy())


def instance(kind, seed):
    """(reference list, port list) of one seeded instance."""
    if kind == "zipf":
        return (jsynth(600, 16, rf=3, seed=5, weighted=True, zipf_topics=True),
                tsynth(600, 16, rf=3, seed=5, weighted=True, zipf_topics=True))
    if kind == "restricted":
        return restricted(jsynth, seed), restricted(tsynth, seed)
    pl = random_partition_list(
        random.Random(2000 + seed), 70, 9, weighted=True, with_consumers=True,
    )
    return pl, to_port(pl)


@pytest.mark.parametrize("kind", ["random", "restricted", "zipf"])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("batch", [4, 16])
def test_colocation_plan_matches_reference_f64(batch, allow_leader, kind):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    pl_j, pl_t = instance(kind, 3)
    jc, tc = cfgs(allow_leader)
    opl_j = jplan(pl_j, jc, 100000, batch=batch, engine="xla",
                  anti_colocation=LAM)
    opl_t = tscan.plan(pl_t, tc, 100000, batch=batch, anti_colocation=LAM,
                       device="cpu")
    assert moves(opl_j), "the reference planned no move"
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_colocation_plan_chunked_reentry_matches_reference_f64():
    """Chunks of 8 moves re-enter on the mutated assignment."""
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    pl_j = jsynth(300, 10, rf=3, seed=11, weighted=True, zipf_topics=True)
    pl_t = tsynth(300, 10, rf=3, seed=11, weighted=True, zipf_topics=True)
    jc, tc = cfgs()
    opl_j = jplan(pl_j, jc, 300, batch=8, chunk_moves=8, anti_colocation=0.01)
    opl_t = tscan.plan(pl_t, tc, 300, batch=8, chunk_moves=8,
                       anti_colocation=0.01, device="cpu")
    assert len(moves(opl_j)) > 8
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_colocation_plan_reaches_the_floor_on_the_zipf_instance():
    """tests/test_scan.py's quality check, in the port: the colocation
    count lands on the pigeonhole floor and every assignment stays
    duplicate-free."""
    import collections

    pl = tsynth(600, 16, rf=3, seed=5, weighted=True, zipf_topics=True)
    sizes = collections.Counter(p.topic for p in pl.iter_partitions())
    floor = sum(max(0, 3 * s - 16) for s in sizes.values())
    assert colo_count(pl) > floor
    _, tc = cfgs(allow_leader=True)
    assert tscan.plan(pl, tc, 100000, batch=16, anti_colocation=LAM,
                      device="cpu").partitions
    assert colo_count(pl) == floor
    for p in pl.iter_partitions():
        assert len(set(p.replicas)) == len(p.replicas)


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("batch", [4, 16])
def test_colocation_polish_matches_reference_f64(batch, allow_leader):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    pl_j, pl_t = instance("zipf", 0)
    jc, tc = cfgs(allow_leader)
    opl_j = jplan(pl_j, jc, 100000, batch=batch, engine="xla", polish=True,
                  anti_colocation=LAM)
    opl_t = tscan.plan(pl_t, tc, 100000, batch=batch, polish=True,
                       anti_colocation=LAM, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("kind", ["zipf", "restricted"])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_colocation_plan_matches_reference_kernel_f32(allow_leader, kind):
    """The reference's scoring kernel (interpret mode, colocation terms
    on) through ``plan_sharded`` on the 8-device CPU mesh, batch 16."""
    from kafkabalancer_tpu.parallel.mesh import make_mesh
    from kafkabalancer_tpu.parallel.shard_session import plan_sharded

    pl_j, pl_t = instance(kind, 73)
    jc, tc = cfgs(allow_leader, min_unbalance=1e-7)
    opl_j = plan_sharded(
        pl_j, copy.deepcopy(jc), 100000, make_mesh(8, shape=(1, 8)),
        batch=16, engine="pallas-interpret", anti_colocation=LAM,
    )
    opl_t = tscan.plan(pl_t, tc, 100000, dtype=torch.float32, batch=16,
                       anti_colocation=LAM, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_colocation_validation_matches_reference():
    """tests/test_scan.py::test_colocation_session_validation in the
    port: batch 1 and ``rebalance_leaders`` raise, an explicit kernel
    engine is overridden with a warning, a cfg-derived penalty never
    raises."""
    pl = tsynth(40, 6, rf=2, seed=1, weighted=True)
    with pytest.raises(ValueError, match="batch"):
        tscan.plan(pl, tdefault(), 10, batch=1, anti_colocation=0.1,
                   device="cpu")
    cfg_rl = tdefault()
    cfg_rl.rebalance_leaders = True
    with pytest.raises(ValueError, match="rebalance_leaders"):
        tscan.plan(pl, cfg_rl, 10, batch=8, anti_colocation=0.1, device="cpu")
    with pytest.warns(UserWarning, match="overridden"):
        tscan.plan(copy.deepcopy(pl), tdefault(), 4, batch=8,
                   anti_colocation=0.1, engine="pallas-interpret",
                   device="cpu")
    # cfg-derived: dropped at batch 1 and under an explicit kernel engine
    c = tdefault()
    c.anti_colocation = 0.1
    assert tscan.resolve_anti_colocation(c, None, 1, "xla") == (0.0, "xla")
    assert tscan.resolve_anti_colocation(c, None, 8, "pallas") == (0.0, "pallas")
    assert tscan.resolve_anti_colocation(c, None, 8, "xla") == (0.1, "xla")
    assert tscan.anti_colocation_requested(c, -1.0, 8) == (0.0, True)


def test_session_refuses_colocation_at_batch_1():
    dp = tensorize(tsynth(40, 6, rf=2, seed=1, weighted=True), tdefault())
    d = to_device(dp, "cpu", torch.float64)
    B = dp.bvalid.shape[0]
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    with pytest.raises(ValueError, match="batch > 1"):
        tscan.session(
            loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
            d.nrep_tgt, d.ncons, d.pvalid, torch.zeros(B, dtype=torch.bool),
            d.bvalid, 2, 1e-9, 10, max_moves=128, allow_leader=False, batch=1,
            topic_id=torch.from_numpy(dp.topic_id), lam=0.1, n_topics=64,
        )


def slot_fixture():
    """Partition ``a`` (topic t) has followers on brokers 2 and 3 with
    equal loads; topic t has two replicas on broker 3 (``a``'s and
    ``b``'s), one on broker 2. Broker 5 is empty. Moving ``a``'s follower
    to 5 scores the same from either slot on the loads alone, and λ
    better from slot 2 (broker 3) with colocation: only the colocation
    term decides the recovered slot."""
    rows = [
        ("t", 0, [1, 2, 3]),  # a
        ("t", 1, [4, 3]),  # b
        ("u", 0, [4, 2]),
    ]
    pl = PartitionList(version=1, partitions=[
        Partition(topic=tp, partition=n, replicas=r) for tp, n, r in rows
    ])
    cfg = tdefault()
    cfg.brokers = [1, 2, 3, 4, 5]
    cfg.min_unbalance = 1e-9
    return pl, cfg


def test_slot_recovery_includes_the_colocation_term():
    """``batch_pool``'s per-target winner slots equal the reference's
    ``factored_target_best`` slots (whose recovery subtracts the
    colocation source term) when colocation alone decides the slot."""
    from kafkabalancer_tpu.ops import cost as jcost
    from kafkabalancer_tpu_torch.balancer import steps

    pl, cfg = slot_fixture()
    steps.validate_weights(pl, cfg)
    steps.fill_defaults(pl, cfg)
    dp = tensorize(pl, cfg)
    d = to_device(dp, "cpu", torch.float64)
    B = dp.bvalid.shape[0]
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    counts = torch.zeros((2, B), dtype=torch.float64)
    counts.index_add_(0, torch.from_numpy(dp.topic_id).long(),
                      (d.member & d.pvalid[:, None]).double())
    c_rows = counts[torch.from_numpy(dp.topic_id).long()]
    lam = torch.tensor(0.25, dtype=torch.float64)
    nb = d.bvalid.sum().double()
    cols = shard_kernel.pack_cols(d.weights, d.nrep_cur, d.nrep_tgt, d.ncons,
                                  d.pvalid)
    _v, p, slot, s_, t, *_ = tscan.batch_pool(
        loads, d.bvalid, nb, d.replicas.clone(), d.member.clone(), d.allowed,
        cols, torch.tensor(2.0, dtype=torch.float64),
        shard_kernel.shard_score_plain, allow_leader=False, c_rows=c_rows,
        lam=lam,
    )
    _su, jv, jp, jslot = jcost.factored_target_best(
        jnp.asarray(loads.numpy()), jnp.asarray(dp.replicas),
        jnp.asarray(dp.allowed), jnp.asarray(dp.member),
        jnp.asarray(dp.bvalid), jnp.asarray(dp.weights),
        jnp.asarray(dp.nrep_cur), jnp.asarray(dp.nrep_tgt),
        jnp.asarray(dp.ncons), jnp.asarray(dp.pvalid),
        jnp.asarray(float(dp.nb)), 2, allow_leader=False,
        c_rows=jnp.asarray(c_rows.numpy()), lam=jnp.asarray(0.25),
    )
    live = np.isfinite(np.asarray(jv))
    five = dp.broker_index(5)
    assert live[five] and int(jp[five]) == 0 and int(jslot[five]) == 2
    assert np.array_equal(p[:B].numpy()[live], np.asarray(jp)[live])
    assert np.array_equal(slot[:B].numpy()[live], np.asarray(jslot)[live])
    assert int(s_[five]) == dp.broker_index(3)


def test_slot_recovery_fixture_plan_matches_reference():
    """The same fixture through both packages' colocation sessions: the
    first move takes ``a``'s replica off broker 3, not broker 2."""
    from kafkabalancer_tpu.models import Partition as JPartition
    from kafkabalancer_tpu.models import PartitionList as JPartitionList
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    pl_t, tc = slot_fixture()
    pl_j = JPartitionList(version=1, partitions=[
        JPartition(topic=p.topic, partition=p.partition,
                   replicas=list(p.replicas))
        for p in pl_t.partitions
    ])
    jc = jdefault()
    jc.brokers, jc.min_unbalance = list(tc.brokers), tc.min_unbalance
    opl_j = jplan(pl_j, jc, 10, batch=4, anti_colocation=0.25)
    opl_t = tscan.plan(pl_t, tc, 10, batch=4, anti_colocation=0.25,
                       device="cpu")
    assert moves(opl_j)[0] == ("t", 0, (1, 2, 5))
    assert moves(opl_t) == moves(opl_j)
