"""The port's ``-solver=tpu`` against the greedy oracle and the reference.

Following tests/test_solver_tpu.py: the port's pipeline with
``cfg.solver = "tpu"`` on the CPU (``balance(..., device="cpu")``) must
give byte-identical plans to the greedy pipeline over the golden table
and over random multi-move sessions (weighted, equal weights with many
ties, leader moves, restricted brokers, an empty configured broker,
duplicate topic+partition keys). ``MIN_DEVICE_CANDIDATES`` is 0 here so
every call takes the device pass. Tolerance: none for the plans.

The window scorer's output is held against the reference's
``_score_window`` at float32 and float64: the max-reductions and the
finite pattern exactly, the sums within the reference's own tolerance
for this scorer (tests/test_solver_tpu.py::test_score_window_matches_
score_moves_minima: 1e-5 at float32, 1e-12 at float64, relative to
max(1, |su|)). The reference's compiler orders the ``su`` reduction by
the fusion it lands in (at 32 brokers inside ``_score_window`` it differs
from the same sum compiled alone by an ulp), so its last bit is not a
property of the function; the window only filters the rows that the
host oracle then re-scans exactly.
"""

import copy
import random

import numpy as np
import pytest
import torch

from helpers import random_partition_list
from test_balancer import CASES, P, wrap

from kafkabalancer_tpu.ops.runtime import ensure_x64

ensure_x64()

from kafkabalancer_tpu_torch import obs  # noqa: E402
from kafkabalancer_tpu_torch.balancer import BalanceError, balance  # noqa: E402
from kafkabalancer_tpu_torch.cli import apply_assignment  # noqa: E402
from kafkabalancer_tpu_torch.models import default_rebalance_config  # noqa: E402
from kafkabalancer_tpu_torch.solvers import tpu as tpu_solver  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import to_port  # noqa: E402


@pytest.fixture(autouse=True)
def _force_device_path(monkeypatch):
    # small instances; the production threshold would route them to the
    # host scan
    monkeypatch.setattr(tpu_solver, "MIN_DEVICE_CANDIDATES", 0)


def tpu_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.solver = "tpu"
    return cfg


def port_cfg(factory):
    from kafkabalancer_tpu_torch.models import RebalanceConfig

    if factory is None:
        return default_rebalance_config()
    return RebalanceConfig(**vars(factory()))


def moves(ppl):
    return [(p.topic, p.partition, tuple(p.replicas)) for p in ppl.partitions or []]


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_golden_case_tpu(idx):
    parts, expected, err, factory = CASES[idx]
    pl = to_port(wrap(parts))
    cfg = tpu_cfg(port_cfg(factory))
    if err is not None:
        with pytest.raises(BalanceError, match=err):
            balance(pl, cfg, device="cpu")
        return
    ppl = balance(pl, cfg, device="cpu")
    if expected is None:
        assert len(ppl) == 0
    else:
        assert moves(ppl) == moves(wrap(expected))


def run_session(pl, cfg, max_moves, **kw):
    """The CLI main loop: balance + apply, collecting the plans."""
    out = []
    for _ in range(max_moves):
        ppl = balance(pl, cfg, **kw)
        if len(ppl) == 0:
            break
        for changed in ppl.partitions:
            live = apply_assignment(pl, changed)
            out.append((live.topic, live.partition, tuple(live.replicas)))
    return out


def assert_session_parity(pl, cfg, max_moves=6):
    pl_g, pl_t = copy.deepcopy(pl), copy.deepcopy(pl)
    obs.begin_invocation()
    got_g = run_session(pl_g, copy.deepcopy(cfg), max_moves)
    got_t = run_session(pl_t, tpu_cfg(cfg), max_moves, device="cpu")
    assert got_g == got_t
    assert [p.replicas for p in pl_g.partitions] == [
        p.replicas for p in pl_t.partitions
    ]
    return got_t


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_random_session_parity(weighted, allow_leader):
    rng = random.Random(100 + weighted * 10 + allow_leader)
    for _ in range(6):
        pl = to_port(random_partition_list(
            rng, rng.randint(2, 25), rng.randint(2, 8), max_rf=3,
            weighted=weighted, with_consumers=True, restrict_brokers=True,
        ))
        cfg = default_rebalance_config()
        cfg.allow_leader_rebalancing = allow_leader
        assert_session_parity(pl, cfg)


def test_session_parity_with_empty_configured_broker():
    rng = random.Random(42)
    for _ in range(4):
        pl = to_port(random_partition_list(rng, 12, 4, weighted=True))
        observed = sorted({b for p in pl.partitions for b in p.replicas})
        cfg = default_rebalance_config()
        cfg.brokers = observed + [max(observed) + 1, max(observed) + 2]
        assert_session_parity(pl, cfg)


def test_session_parity_equal_weights_many_ties():
    rng = random.Random(7)
    for _ in range(4):
        pl = to_port(random_partition_list(rng, 30, 6, weighted=False, max_rf=3))
        assert_session_parity(pl, default_rebalance_config(), max_moves=10)


def test_duplicate_topic_partition_parity():
    pl = to_port(wrap([
        P("a", 1, [1, 2], weight=2.0),
        P("a", 1, [1, 3], weight=1.0),
        P("a", 2, [1, 4], weight=1.5),
        P("b", 1, [2, 1], weight=1.0),
    ]))
    assert_session_parity(pl, default_rebalance_config(), max_moves=6)


def test_device_pass_runs_and_counts():
    """The session goes through the device pass (a pass counted per
    call and tier) and re-scans a window of rows on the host."""
    rng = random.Random(5)
    pl = to_port(random_partition_list(rng, 60, 8, weighted=True))
    got = assert_session_parity(pl, default_rebalance_config(), max_moves=4)
    assert got
    assert obs.REGISTRY.counter_get("solver.window_passes") >= len(got)
    assert obs.REGISTRY.counter_get("solver.window_rows") >= len(got)


def test_tiny_instance_takes_the_host_scan(monkeypatch):
    """Below ``MIN_DEVICE_CANDIDATES`` the greedy scan answers (a spy
    tells the paths apart); the plan is the same."""
    monkeypatch.setattr(tpu_solver, "MIN_DEVICE_CANDIDATES", 20_000)
    calls = []
    orig = tpu_solver.greedy_move

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tpu_solver, "greedy_move", spy)
    pl = to_port(wrap([
        P("a", 1, [1, 2, 3], weight=1.0),
        P("a", 2, [2, 1, 4], weight=1.0),
        P("a", 3, [1, 2, 5], weight=1.0),
    ]))
    ppl = balance(copy.deepcopy(pl), tpu_cfg(default_rebalance_config()),
                  device="cpu")
    assert calls
    assert moves(ppl) == moves(balance(copy.deepcopy(pl), default_rebalance_config()))


@pytest.mark.parametrize("restrict", [False, True])
@pytest.mark.parametrize("leaders", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_window_matches_reference(dtype, leaders, restrict):
    from kafkabalancer_tpu.balancer.steps import fill_defaults
    from kafkabalancer_tpu.models import default_rebalance_config as jdefault
    from kafkabalancer_tpu.ops.tensorize import tensorize
    from kafkabalancer_tpu.solvers import tpu as jtpu

    rng = random.Random(321 + restrict)
    for _ in range(4):
        pl = random_partition_list(
            rng, rng.randint(4, 60), rng.randint(3, 20), max_rf=3,
            weighted=True, with_consumers=True, restrict_brokers=restrict,
        )
        cfg = jdefault()
        fill_defaults(pl, cfg)
        dp = tensorize(pl, cfg)
        loads_map = jtpu._oracle_loads(pl, cfg)
        B = dp.bvalid.shape[0]
        loads = np.zeros(B)
        for bid, load in loads_map.items():
            loads[dp.broker_index(bid)] = load
        ints, floats64, allowed, all_allowed = jtpu._pack_window_args(
            dp, loads, cfg)
        got_args = tpu_solver.pack_window_args(dp, loads, cfg)
        assert all(
            (a is None and b is None) or np.array_equal(a, b)
            for a, b in zip(got_args, (ints, floats64, allowed, all_allowed))
        )
        ref = np.asarray(jtpu._score_window_jit(
            ints, floats64.astype(dtype), allowed, leaders=leaders,
            all_allowed=all_allowed,
        ))
        got = tpu_solver.score_window(
            torch.from_numpy(ints), torch.from_numpy(floats64.astype(dtype)),
            None if allowed is None else torch.from_numpy(allowed),
            leaders=leaders, all_allowed=all_allowed,
        ).numpy()
        assert got.dtype == ref.dtype
        assert np.array_equal(got[2:4], ref[2:4], equal_nan=True)
        finite = np.isfinite(ref)
        assert np.array_equal(np.isfinite(got), finite)
        tol = (1e-5 if dtype == "float32" else 1e-12) * max(1.0, abs(float(ref[1])))
        assert np.allclose(got[finite], ref[finite], rtol=0, atol=tol)


def test_tpu_rejects_below_min_unbalance():
    pl = to_port(wrap([
        P("a", 1, [1, 2], weight=1.0),
        P("a", 2, [2, 1], weight=1.0),
        P("a", 3, [1, 3], weight=1.0),
    ]))
    cfg = tpu_cfg(default_rebalance_config())
    cfg.min_unbalance = 1e9
    assert len(balance(pl, cfg, device="cpu")) == 0


def test_tpu_solver_needs_a_device(monkeypatch):
    """Without a card and without ``device="cpu"`` the device pass raises;
    it never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pl = to_port(random_partition_list(random.Random(9), 30, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        balance(pl, tpu_cfg(default_rebalance_config()))


@pytest.mark.parametrize("leaders", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_moves_matches_reference(dtype, leaders):
    """The full-tensor scorer bit for bit against the reference's, and the
    window scorer's per-partition minima against its own within the
    reference's tolerance (tests/test_solver_tpu.py)."""
    from kafkabalancer_tpu.balancer.steps import fill_defaults
    from kafkabalancer_tpu.models import default_rebalance_config as jdefault
    from kafkabalancer_tpu.ops.tensorize import tensorize
    from kafkabalancer_tpu.solvers import tpu as jtpu

    rng = random.Random(77)
    for case in range(4):
        pl = random_partition_list(
            rng, rng.randint(4, 40), rng.randint(3, 12), max_rf=3,
            weighted=True, with_consumers=True, restrict_brokers=case % 2 == 1,
        )
        cfg = jdefault()
        fill_defaults(pl, cfg)
        dp = tensorize(pl, cfg)
        loads_map = jtpu._oracle_loads(pl, cfg)
        loads = np.zeros(dp.bvalid.shape[0])
        for bid, load in loads_map.items():
            loads[dp.broker_index(bid)] = load
        args = (loads.astype(dtype), dp.replicas, dp.allowed, dp.member,
                dp.weights.astype(dtype), dp.nrep_cur, dp.nrep_tgt, dp.pvalid,
                dp.bvalid)
        ref = jtpu.score_moves(*args, np.dtype(dtype).type(dp.nb), 2,
                               leaders=leaders, tie_k=1)
        got = tpu_solver.score_moves(
            *(torch.from_numpy(np.asarray(a)) for a in args),
            torch.tensor(dp.nb, dtype=getattr(torch, dtype)), 2,
            leaders=leaders, tie_k=1,
        )
        for a, b in zip(got, ref):
            assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)
        ints, floats64, allowed, all_allowed = tpu_solver.pack_window_args(
            dp, loads, cfg)
        win = tpu_solver.score_window(
            torch.from_numpy(ints), torch.from_numpy(floats64.astype(dtype)),
            None if allowed is None else torch.from_numpy(allowed),
            leaders=leaders, all_allowed=all_allowed,
        ).numpy()
        pp = got[4].numpy()
        finite = np.isfinite(pp)
        assert np.array_equal(np.isfinite(win[4:]), finite)
        tol = (1e-5 if dtype == "float32" else 1e-12) * max(1.0, abs(float(win[1])))
        assert np.allclose(win[4:][finite], pp[finite], rtol=0, atol=tol)
