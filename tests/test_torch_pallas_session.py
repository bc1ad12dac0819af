"""The whole-session kernel's plain version against the reference kernel.

``kafkabalancer_tpu_torch.solvers.pallas_session.pallas_session_plain`` —
the function the port's CUDA kernel (``csrc/pallas_session.cu``) computes,
and what ``pallas_session`` runs on CPU tensors — against
``kafkabalancer_tpu.solvers.pallas_session.pallas_session`` with the Pallas
kernel in interpret mode, at float32, on the same seeded numpy inputs:

- called directly at P = 256 (two of the reference's 128-row tiles),
  B = 16, R = 4, over allow_leader x (all brokers allowed | a restricted
  allowed matrix) x batch {1, 8}, plus a case where one broker is the
  target of several accepted moves in one iteration (the commit's
  rounding order);
- through ``plan(engine="pallas", device="cpu")`` against the reference's
  ``plan(engine="pallas-interpret")`` in tests/test_pallas.py's set-ups.

Tolerance: none. Move counts, the four logs, the replicas and the loads
are compared under ``==`` (the loads came out bit-identical, so no
tolerance is stated for them); plans by their move lists and final
assignments. The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import copy
import io
import os
import random

import numpy as np
import pytest
import torch

from helpers import random_partition_list

from kafkabalancer_tpu.balancer import balance
from kafkabalancer_tpu.balancer.steps import fill_defaults
from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops import cost as jcost
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize
from kafkabalancer_tpu.utils.synth import synth_cluster

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu.solvers.pallas_session import TILE_P  # noqa: E402
from kafkabalancer_tpu.solvers.pallas_session import pallas_session as jps  # noqa: E402
from kafkabalancer_tpu.solvers.scan import plan as jplan  # noqa: E402
from kafkabalancer_tpu_torch.cli import run as trun  # noqa: E402
from kafkabalancer_tpu_torch.models import default_rebalance_config as tdefault  # noqa: E402
from kafkabalancer_tpu_torch.solvers import pallas_session as tps  # noqa: E402
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from test_torch_scan import moves, state, to_port  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)

MAX_MOVES = 256


def session_inputs(seed, restricted, n_brokers=16, empty_broker=False):
    """Session inputs as numpy arrays (float32), from the reference's
    encoding: a synthetic cluster, a few rows below min_replicas, some
    consumers, optionally a restricted allowed matrix and a configured
    broker that holds no replica yet."""
    pl = synth_cluster(200, n_brokers, rf=3, seed=seed, weighted=True)
    cfg = jdefault()
    if empty_broker:
        ids = sorted({b for p in pl.partitions for b in p.replicas})
        cfg.brokers = ids + [max(ids) + 1]
    fill_defaults(pl, cfg)
    dp = jtensorize(pl, cfg, min_bucket=TILE_P)
    rng = np.random.default_rng(seed)
    P, B = dp.member.shape
    f32 = np.float32
    w = dp.weights.astype(f32)
    nrep_tgt = dp.nrep_tgt.copy()
    nrep_tgt[rng.random(P) < 0.1] = 1
    ncons = (rng.integers(0, 3, P) * (rng.random(P) < 0.3)).astype(f32)
    loads = np.asarray(
        jcost.broker_loads(
            jnp.asarray(dp.replicas), jnp.asarray(w),
            jnp.asarray(dp.nrep_cur), jnp.asarray(ncons), B,
        )
    )
    allowed = dp.allowed.copy()
    if restricted:
        allowed &= (rng.random((P, B)) < 0.6) | dp.member
    always = np.zeros(B, dtype=bool)
    for bid in cfg.brokers or []:
        always[dp.broker_index(bid)] = True
    return dict(
        loads=loads, replicas=dp.replicas, allowed=allowed, weights=w,
        nrep_cur=dp.nrep_cur, nrep_tgt=nrep_tgt, ncons=ncons,
        pvalid=dp.pvalid, always=always, universe=dp.bvalid,
    )


ORDER = ("loads", "replicas", "allowed", "weights", "nrep_cur", "nrep_tgt",
         "ncons", "pvalid", "always", "universe")


def run_both(a, batch, allow_leader, restricted, budget=200):
    """(reference outputs, port outputs) as numpy, with n as an int."""
    out = jps(
        *(jnp.asarray(a[k]) for k in ORDER[:2]), None,
        *(jnp.asarray(a[k]) for k in ORDER[2:]),
        jnp.int32(2), jnp.float32(1e-6), jnp.int32(budget), jnp.int32(batch),
        jnp.float32(1.5), max_moves=MAX_MOVES, allow_leader=allow_leader,
        interpret=True, all_allowed=not restricted,
    )
    t = {k: torch.from_numpy(np.array(a[k])) for k in ORDER}
    got = tps.pallas_session_plain(
        t["loads"], t["replicas"], None,
        t["allowed"] if restricted else None,
        *(t[k] for k in ORDER[3:]), 2, 1e-6, budget, batch, 1.5,
        max_moves=MAX_MOVES, allow_leader=allow_leader,
        all_allowed=not restricted,
    )
    ref = [np.asarray(x) for x in out]
    port = [x if isinstance(x, int) else x.numpy() for x in got]
    ref[2] = int(ref[2])
    return ref, port


def assert_same(ref, port):
    names = ("replicas", "loads", "n", "move_p", "move_slot", "move_src",
             "move_tgt")
    assert ref[2] > 0, "the reference session accepted no move"
    for name, r, p in zip(names, ref, port):
        assert np.array_equal(np.asarray(r), np.asarray(p)), name


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_plain_matches_reference_kernel(allow_leader, restricted, batch):
    a = session_inputs(11 + 2 * allow_leader + restricted, restricted)
    assert a["replicas"].shape == (256, 4) and a["loads"].shape == (16,)
    assert_same(*run_both(a, batch, allow_leader, restricted))


def test_commit_order_trap(monkeypatch):
    """A configured broker with no replica draws the per-target and the
    pair candidate at once, and the hot brokers give up several replicas
    in one iteration: a broker's load changes by the sum of two or more
    deltas, where the commit's rounding order shows (the torch session
    adds them one at a time, the reference kernel sums them first). With
    this seed one iteration has a broker in three accepted moves; the spy
    proves the case is reached."""
    most = []
    real = tps._ordered_scatter

    def spy(idx, vals, ok, B):
        occ = [int(x) for x in idx[ok].tolist()]
        most.append(max((occ.count(i) for i in occ), default=0))
        return real(idx, vals, ok, B)

    monkeypatch.setattr(tps, "_ordered_scatter", spy)
    a = session_inputs(32, False, empty_broker=True)
    assert_same(*run_both(a, 16, True, False))
    assert max(most) >= 3


SETUPS = {
    # tests/test_pallas.py::test_pallas_session_matches_xla_batch
    "weighted-consumers": (3000, 40, 8, dict(weighted=True, with_consumers=True), 40, 16),
    # ::test_pallas_multi_tile_parity (equal weights: ties across tiles)
    "multi-tile-ties": (3300, TILE_P + 40, 10, dict(weighted=False, with_consumers=True), 25, 10),
    # ::test_pallas_session_restricted_brokers_parity
    "restricted": (3100, 40, 8, dict(weighted=True, restrict_brokers=True), 40, 16),
    # ::test_pallas_session_high_rf_parity
    "max-rf-6": (3200, 48, 10, dict(max_rf=6, weighted=True, with_consumers=True), 40, 16),
}


def plans(pl, allow_leader, budget, batch):
    jc, tc = jdefault(), tdefault()
    for c in (jc, tc):
        c.min_unbalance = 1e-6
        c.allow_leader_rebalancing = allow_leader
    pl_j, pl_t = copy.deepcopy(pl), to_port(pl)
    opl_j = jplan(pl_j, jc, budget, batch=batch, engine="pallas-interpret")
    opl_t = tscan.plan(pl_t, tc, budget, batch=batch, engine="pallas", device="cpu")
    return opl_j, opl_t, pl_j, pl_t


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_plan_matches_reference_plan(setup, allow_leader):
    seed, n_parts, n_brokers, kw, budget, batch = SETUPS[setup]
    pl = random_partition_list(random.Random(seed + allow_leader), n_parts, n_brokers, **kw)
    opl_j, opl_t, pl_j, pl_t = plans(pl, allow_leader, budget, batch)
    assert moves(opl_j), "the reference planned no move"
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_plan_budget_and_convergence():
    """tests/test_pallas.py::test_pallas_session_respects_budget_and_
    converges: budget 5 caps the plan; a large budget converges to a plan
    the greedy pipeline cannot improve."""
    pl = random_partition_list(random.Random(3100), 30, 6, weighted=True)
    opl_j, opl_t, _, _ = plans(pl, False, 5, 8)
    assert 0 < len(moves(opl_t)) <= 5 and moves(opl_t) == moves(opl_j)
    opl_j, opl_t, pl_j, pl_t = plans(pl, False, 500, 8)
    assert moves(opl_t) == moves(opl_j) and state(pl_t) == state(pl_j)
    assert len(balance(pl_j, jdefault())) == 0


def test_interpret_engine_runs_the_plain_version():
    """``pallas-interpret`` runs the plain version on the plan's device and
    plans what ``pallas`` plans; neither launches a kernel on the CPU."""
    tps.pallas_session.launches = 0
    a = tscan.plan(synth_cluster_t(), cfg_t(), 300, batch=8, engine="pallas", device="cpu")
    b = tscan.plan(
        synth_cluster_t(), cfg_t(), 300, batch=8, engine="pallas-interpret",
        device="cpu",
    )
    assert moves(a) and moves(a) == moves(b)
    assert tps.pallas_session.launches == 0


def synth_cluster_t():
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth

    return tsynth(120, 8, rf=3, seed=4, weighted=True)


def cfg_t():
    c = tdefault()
    c.min_unbalance = 1e-7
    return c


@pytest.mark.parametrize("where,message", [
    ("_load", "nvcc not found"),
    ("launch", "kernel launch failed"),
])
def test_kernel_failure_raises_and_never_falls_back(monkeypatch, where, message):
    """On a device other than the CPU, engine="pallas" goes to the kernel
    and only there: a failed build or launch is a planning failure (the
    CLI's exit 3), and the plain version is never called. The ``meta``
    device stands in for the card here."""

    def must_not_run(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    def fail(*a, **k):
        raise RuntimeError(message)

    monkeypatch.setattr(tps, "pallas_session_plain", must_not_run)
    monkeypatch.setattr(tps, where, fail)
    from kafkabalancer_tpu_torch.balancer import BalanceError

    with pytest.raises(BalanceError, match=message):
        tscan.plan(synth_cluster_t(), cfg_t(), 50, batch=8, engine="pallas",
                   device="meta")
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(""), o, e,
        ["kafkabalancer", "-input-json", "-input",
         os.path.join(os.path.dirname(__file__), "data", "test.json"),
         "-fused", "-fused-engine=pallas"],
        device="meta",
    )
    assert rc == 3 and o.getvalue() == ""
    assert "pallas engine failed" in e.getvalue()


def test_wrapper_checks_its_arguments():
    a = session_inputs(5, False)
    t = {k: torch.from_numpy(np.array(a[k])) for k in ORDER}
    args = [t["loads"], t["replicas"], None, None] + [t[k] for k in ORDER[3:]]
    with pytest.raises(ValueError, match="weights shape"):
        bad = list(args)
        bad[4] = t["weights"][:-1]
        tps.pallas_session(*bad, 2, 1e-6, 10, 4, max_moves=128, allow_leader=False)
    with pytest.raises(ValueError, match="batch"):
        tps.pallas_session(*args, 2, 1e-6, 10, 0, max_moves=128, allow_leader=False)


@pytest.mark.parametrize("seed,same_moves", [(44, True), (49, False)])
def test_commit_forms_differ_in_float32(seed, same_moves):
    """The torch session (``scan.session``, the port of the reference's
    XLA session) commits sources first, then targets; the kernel sums each
    broker's deltas first. At float32 on the same inputs the final loads
    differ in their last bits (seed 44: same moves, other loads), and now
    and then a rounding flips a later acceptance (seed 49: the move lists
    part). Pinned so the difference stays known; ROADMAP.md queue C."""
    a = session_inputs(seed, False, empty_broker=True)
    t = {k: torch.from_numpy(np.array(a[k])) for k in ORDER}
    rest = [t[k] for k in ORDER[3:]]
    kern = tps.pallas_session_plain(
        t["loads"], t["replicas"], None, None, *rest, 2, 1e-6, 200, 16, 1.5,
        max_moves=MAX_MOVES, allow_leader=False, all_allowed=True,
    )
    member = tps.SessionState(
        t["loads"], t["replicas"], None, *rest, True
    ).member
    sess = tscan.session(
        t["loads"], t["replicas"], member, None, *rest, 2, 1e-6, 200,
        max_moves=MAX_MOVES, allow_leader=False, batch=16,
    )
    logs_equal = sess[2] == kern[2] and all(
        torch.equal(sess[3 + i], kern[3 + i]) for i in range(4)
    )
    assert logs_equal == same_moves
    assert not torch.equal(sess[1], kern[1])
