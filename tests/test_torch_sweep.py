"""The port's what-if sweep against the reference's, case by case after
tests/test_parallel.py.

``kafkabalancer_tpu_torch.parallel.sweep.sweep`` on a CPU mesh of 2 × 4
(``make_mesh(devices=["cpu"] * 8)``: scenarios spread over two sweep
devices) against ``kafkabalancer_tpu.parallel.sweep.sweep`` on the
reference's 8-device virtual CPU mesh: every field of every
``SweepResult`` (feasibility, completion, evacuations, moves, repairs,
the final unbalance and assignment) compares equal, at float64 with the
``xla`` engine (batch 1 and 4) and at float32 with ``pallas-interpret``
on both sides; the ``pallas`` engine (on CPU tensors the whole-session
kernel's plain version) equals ``pallas-interpret``. As the reference's
tests do, the results are also held against a sequential run of the
port's host pipeline per scenario. Tolerance: none.
"""

import copy
import random

import pytest

from helpers import random_partition_list

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64

ensure_x64()

from kafkabalancer_tpu.parallel.sweep import sweep as jsweep  # noqa: E402

from kafkabalancer_tpu_torch.balancer import BalanceError, balance  # noqa: E402
from kafkabalancer_tpu_torch.balancer.costmodel import (  # noqa: E402
    get_bl,
    get_broker_load,
    get_unbalance_bl,
)
from kafkabalancer_tpu_torch.cli import apply_assignment  # noqa: E402
from kafkabalancer_tpu_torch.models import Partition, PartitionList  # noqa: E402
from kafkabalancer_tpu_torch.models import (  # noqa: E402
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from kafkabalancer_tpu_torch.parallel.sweep import (  # noqa: E402
    best_scenario,
    stack_instances,
    sweep,
)
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import to_port  # noqa: E402

MESH = make_mesh(devices=["cpu"] * 8)  # 2 sweep devices x 4

ENGINES = [("xla", 1), ("xla", 4), ("pallas-interpret", 4)]


def fields(r):
    return (r.brokers, r.feasible, r.completed, r.n_evacuations, r.n_moves,
            r.unbalance, r.replicas, r.n_repairs)


def both(pl, scenarios, engine="xla", batch=1, cfg=None, **kw):
    """(reference results, port results) of one sweep; ``pl`` is the
    reference's list (the port gets a copy as its own objects)."""
    jc = cfg or jdefault()
    tc = tdefault()
    for k in ("brokers", "min_unbalance", "allow_leader_rebalancing"):
        setattr(tc, k, copy.deepcopy(getattr(jc, k)))
    ref = jsweep(pl, jc, scenarios, engine=engine, batch=batch, **kw)
    got = sweep(to_port(pl), tc, scenarios, mesh=MESH, engine=engine,
                batch=batch, **kw)
    assert [fields(r) for r in got] == [fields(r) for r in ref]
    return ref, got


def wrap(rows):
    """Port partitions from ``(topic, partition, replicas, weight, kw)``."""
    return PartitionList(version=1, partitions=[
        Partition(topic=t, partition=n, replicas=list(r), weight=w, **kw)
        for t, n, r, w, kw in rows
    ])


def jwrap(rows):
    from kafkabalancer_tpu.models import Partition as JP
    from kafkabalancer_tpu.models import PartitionList as JPL

    return JPL(version=1, partitions=[
        JP(topic=t, partition=n, replicas=list(r), weight=w, **kw)
        for t, n, r, w, kw in rows
    ])


def unbalance_of(pl):
    return get_unbalance_bl(get_bl(get_broker_load(pl)))


def sequential_scenario(pl, cfg, brokers, max_moves=200):
    """The port's host pipeline for one scenario (``-broker-ids``)."""
    pl = copy.deepcopy(pl)
    cfg = copy.deepcopy(cfg)
    cfg.brokers = sorted(brokers)
    n = 0
    try:
        while n < max_moves:
            ppl = balance(pl, cfg)
            if len(ppl) == 0:
                break
            for changed in ppl.partitions:
                apply_assignment(pl, changed)
            n += 1
    except BalanceError:
        return None, None
    return pl, unbalance_of(pl)


def scenarios_of(pl):
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    hi = max(observed)
    return [observed, observed + [hi + 1], observed + [hi + 1, hi + 2],
            observed[1:]]


@pytest.mark.parametrize("engine,batch", ENGINES)
@pytest.mark.parametrize("weighted", [True, False])
def test_sweep_matches_reference_and_sequential(weighted, engine, batch):
    rng = random.Random(1000 + weighted)
    pl = random_partition_list(rng, 14, 5, weighted=weighted, max_rf=3)
    scenarios = scenarios_of(pl)
    _ref, got = both(pl, scenarios, engine, batch, max_reassign=200)
    if engine != "xla" or batch != 1:
        return  # batched trajectories differ from the pipeline's
    for sc, res in zip(scenarios, got):
        seq_pl, seq_u = sequential_scenario(to_port(pl), tdefault(), sc)
        if seq_pl is None:
            assert not res.feasible
            continue
        assert res.feasible and res.unbalance == pytest.approx(
            seq_u, rel=1e-9, abs=1e-12)
        if weighted:  # no exact ties: the same final assignment
            assert res.replicas == [p.replicas for p in seq_pl.partitions]


@pytest.mark.parametrize("engine,batch", ENGINES)
def test_sweep_infeasible_scenario(engine, batch):
    rows = [("a", 1, [1, 2], 1.0, {}), ("a", 2, [2, 1], 1.0, {})]
    _ref, got = both(jwrap(rows), [[1], [1, 2]], engine, batch,
                     max_reassign=50)
    assert not got[0].feasible and got[1].feasible
    assert best_scenario(got) == 1


def test_sweep_does_not_mutate_input():
    rng = random.Random(1100)
    pl = to_port(random_partition_list(rng, 8, 4))
    before = copy.deepcopy(pl)
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    sweep(pl, tdefault(), [observed], max_reassign=10, mesh=MESH)
    assert pl == before


def test_session_drained_broker_leaves_table():
    """A leader move drains broker 5; the next Balance call drops it from
    the load table. The port's fused plan reproduces the reference's
    pipeline and its plan."""
    from kafkabalancer_tpu.solvers.scan import plan as jplan
    from kafkabalancer_tpu_torch.solvers.scan import plan

    rows = [
        ("big", 1, [5, 1], 6.0, dict(num_consumers=3)),
        ("s", 1, [1, 2], 1.0, {}), ("s", 2, [2, 3], 1.0, {}),
        ("s", 3, [3, 4], 1.0, {}), ("s", 4, [4, 1], 1.0, {}),
    ]
    cfg, jc = tdefault(), jdefault()
    cfg.allow_leader_rebalancing = jc.allow_leader_rebalancing = True
    pl_g, pl_s, pl_j = wrap(rows), wrap(rows), jwrap(rows)
    moved_g = []
    for _ in range(8):
        ppl = balance(pl_g, copy.deepcopy(cfg))
        if len(ppl) == 0:
            break
        for changed in ppl.partitions:
            live = apply_assignment(pl_g, changed)
            moved_g.append((live.topic, live.partition))
    opl = plan(pl_s, copy.deepcopy(cfg), 8, device="cpu")
    opl_j = jplan(pl_j, jc, 8)
    moved_s = [(p.topic, p.partition) for p in (opl.partitions or [])]
    assert ("big", 1) in moved_g
    assert moved_s == moved_g == [(p.topic, p.partition) for p in opl_j.partitions]
    assert pl_s == pl_g


def test_sweep_contract_errors():
    pl = wrap([("a", 1, [1, 2], 1.0, {}), ("a", 2, [2, 1], 1.0, {})])
    cfg = tdefault()
    cfg_rl = copy.deepcopy(cfg)
    cfg_rl.rebalance_leaders = True
    with pytest.raises(BalanceError, match="rebalance_leaders"):
        sweep(pl, cfg_rl, [[1, 2]], mesh=MESH)
    with pytest.raises(ValueError, match="2\\^20"):
        sweep(pl, cfg, [[1, 2]], max_reassign=(1 << 20) + 1, mesh=MESH)
    with pytest.raises(ValueError, match="unknown engine"):
        sweep(pl, cfg, [[1, 2]], mesh=MESH, engine="tpu")
    bad = wrap([("a", 1, [1, 2], -1.0, {})])
    with pytest.raises(BalanceError, match="ValidateWeights"):
        sweep(bad, cfg, [[1, 2]], mesh=MESH)


UNSETTLED = [
    ("u", 1, [1, 2], 1.3, dict(num_replicas=3)),
    ("u", 2, [2, 3], 0.7, dict(num_replicas=3)),
    ("o", 1, [1, 2, 3], 1.1, dict(num_replicas=2)),
    ("s", 1, [3, 1], 0.9, {}), ("s", 2, [1, 3], 1.2, {}),
    ("s", 3, [2, 1], 0.8, {}),
]


@pytest.mark.parametrize("engine,batch", ENGINES)
def test_sweep_unsettled_input(engine, batch):
    """Under- and over-replicated partitions settle on the host per
    scenario (its broker set decides the repairs); the repairs consume
    budget like CLI loop iterations. Against the reference and, at
    batch 1, the sequential pipeline."""
    scenarios = [[1, 2, 3], [1, 2, 3, 4], [1, 2, 3, 4, 5], [2, 3, 4]]
    _ref, got = both(jwrap(UNSETTLED), scenarios, engine, batch,
                     max_reassign=200)
    for sc, res in zip(scenarios, got):
        seq_pl, seq_u = sequential_scenario(wrap(UNSETTLED), tdefault(), sc)
        if seq_pl is None:
            assert not res.feasible
            continue
        assert res.feasible and res.completed and res.n_repairs > 0
        if engine == "xla" and batch == 1:
            assert res.unbalance == pytest.approx(seq_u, rel=1e-9, abs=1e-12)
            assert res.replicas == [p.replicas for p in seq_pl.partitions]
    _ref, bounded = both(jwrap(UNSETTLED), scenarios[:1], engine, batch,
                         max_reassign=2)
    assert bounded[0].feasible and not bounded[0].completed
    assert bounded[0].n_repairs == 2 and bounded[0].n_moves == 0


def test_sweep_unsettled_with_configured_empty_broker():
    rows = [("u", 1, [1, 2], 1.2, dict(num_replicas=3)),
            ("s", 1, [2, 3], 0.8, {}), ("s", 2, [3, 1], 1.0, {})]
    jc = jdefault()
    jc.brokers = [1, 2, 3, 9]  # broker 9: configured, empty, in no scenario
    _ref, got = both(jwrap(rows), [[1, 2, 3]], cfg=jc, max_reassign=100)
    assert got[0].feasible and got[0].completed and got[0].n_repairs > 0
    tc = tdefault()
    tc.brokers = [1, 2, 3, 9]
    seq_pl, seq_u = sequential_scenario(wrap(rows), tc, [1, 2, 3])
    assert got[0].unbalance == pytest.approx(seq_u, rel=1e-9, abs=1e-12)
    assert got[0].replicas == [p.replicas for p in seq_pl.partitions]


@pytest.mark.parametrize("engine,batch", ENGINES)
def test_sweep_evacuations_consume_budget(engine, batch):
    rows = [("a", 1, [1, 9], 1.0, {}), ("a", 2, [2, 9], 1.0, {}),
            ("a", 3, [3, 9], 1.0, {}), ("b", 1, [1, 2], 1.0, {}),
            ("b", 2, [2, 3], 1.0, {})]
    _ref, full = both(jwrap(rows), [[1, 2, 3]], engine, batch,
                      max_reassign=200)
    assert full[0].n_evacuations == 3 and full[0].completed
    _ref, bounded = both(jwrap(rows), [[1, 2, 3]], engine, batch,
                         max_reassign=2)
    b = bounded[0]
    assert b.n_evacuations == 2 and b.n_moves == 0
    assert b.feasible and not b.completed
    assert sum(1 for reps in b.replicas if 9 in reps) == 1


def test_sweep_pallas_engine_equals_its_plain_version_and_xla_quality():
    """``pallas`` (on CPU tensors, the whole-session kernel's plain
    version) equals ``pallas-interpret``; both reach the ``xla`` engine's
    quality (tests/test_parallel.py's tolerance for the comparison
    across engines)."""
    rng = random.Random(1600)
    pl = to_port(random_partition_list(rng, 14, 5, weighted=True, max_rf=3))
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    scenarios = [observed, observed + [max(observed) + 1], observed[1:]]
    res = {
        e: sweep(pl, tdefault(), scenarios, max_reassign=200, batch=4,
                 engine=e, mesh=MESH)
        for e in ("xla", "pallas", "pallas-interpret")
    }
    assert [fields(r) for r in res["pallas"]] == [
        fields(r) for r in res["pallas-interpret"]]
    for rx, rp in zip(res["xla"], res["pallas"]):
        assert (rx.feasible, rx.completed, rx.n_evacuations) == (
            rp.feasible, rp.completed, rp.n_evacuations)
        if rx.feasible:
            assert rp.unbalance == pytest.approx(rx.unbalance, rel=1e-4,
                                                 abs=1e-6)


def test_sweep_results_do_not_depend_on_the_mesh(monkeypatch):
    """Two sweep devices (scenarios 0-1 and 2-3) or one: the same
    results, every scenario run once."""
    from kafkabalancer_tpu_torch.parallel import sweep as tsweep

    seen = []
    real = tsweep._scenario

    def spy(replicas, *a, **k):
        seen.append(replicas.device)
        return real(replicas, *a, **k)

    monkeypatch.setattr(tsweep, "_scenario", spy)
    rng = random.Random(1000)
    pl = to_port(random_partition_list(rng, 14, 5, weighted=True, max_rf=3))
    scenarios = scenarios_of(pl)
    a = sweep(pl, tdefault(), scenarios, max_reassign=200, mesh=MESH)
    b = sweep(pl, tdefault(), scenarios, max_reassign=200,
              mesh=make_mesh(devices=["cpu"]))
    assert [fields(r) for r in a] == [fields(r) for r in b]
    assert len(seen) == 8


def test_stack_instances_pads_with_the_first_row():
    import numpy as np

    out = stack_instances([np.arange(3), np.arange(3) + 5], pad_to=4)
    assert out.shape == (4, 3) and (out[2] == out[0]).all()
    out = stack_instances([np.zeros(2)], pad_to=2, pad_row=np.ones(2))
    assert out.tolist() == [[0, 0], [1, 1]]
