"""The port's pair-swap polish against the reference's, move for move.

``kafkabalancer_tpu_torch.solvers.polish`` on CPU tensors against
``kafkabalancer_tpu.solvers.polish``: ``nearest_occupied`` and
``entry_table`` equal the reference's (and a brute force);
``plan(polish=True)`` emits the reference's moves in the reference's
order and leaves the same final assignment at float64 (engine ``xla``,
batch 1 and 16, with and without ``allow_leader``) and at float32
(``pallas-interpret`` on both sides: the port runs the whole-session
kernel's plain version, the reference its Pallas kernel in interpret
mode); the budget and ``min_unbalance`` gates behave as in
tests/test_polish.py. Tolerance: none; logs and states compare equal.
"""

import numpy as np
import pytest
import torch

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu_torch.balancer.costmodel import (  # noqa: E402
    get_bl,
    get_broker_load,
    get_unbalance_bl,
)
from kafkabalancer_tpu_torch.models import (  # noqa: E402
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.solvers import polish as tpolish  # noqa: E402
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import moves, restricted, state  # noqa: E402


def cfgs(allow_leader=False, min_unbalance=0.0):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.allow_leader_rebalancing = allow_leader
        c.min_unbalance = min_unbalance
    return j, t


def nearest_cases():
    """Random holders, pair tables and query ranks, with the rq = 0 and
    rq = Nc edges, block-boundary ranks, dead pairs and empty rows."""
    rng = np.random.default_rng(1234)
    for _ in range(8):
        Nc = int(rng.choice([256, 512, 1024]))
        nh = int(rng.choice([4, 8, 16]))
        B = 16
        holder = rng.integers(0, B + 1, size=Nc).astype(np.int32)
        tgt_b = rng.integers(0, B, size=nh).astype(np.int32)
        pair_live = rng.random(nh) < 0.8
        pe_c = rng.integers(0, nh, size=Nc).astype(np.int32)
        rq = np.concatenate(
            [rng.integers(0, Nc + 1, size=Nc - 6),
             [0, Nc, 127, 128, Nc - 1, Nc - 128]]
        ).astype(np.int32)[:Nc]
        yield holder, tgt_b, pair_live, pe_c, rq


def test_nearest_occupied_matches_reference_and_brute_force():
    from kafkabalancer_tpu.solvers.polish import nearest_occupied as jnear

    for holder, tgt_b, pair_live, pe_c, rq in nearest_cases():
        Nc = holder.shape[0]
        ja, jb = jnear(*(jnp.asarray(a) for a in (holder, tgt_b, pair_live, pe_c, rq)))
        ta, tb = tpolish.nearest_occupied(
            *(torch.from_numpy(a).long() if a.dtype != bool else torch.from_numpy(a)
              for a in (holder, tgt_b, pair_live, pe_c, rq))
        )
        assert np.array_equal(ta.numpy(), np.asarray(ja))
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        for q in range(Nc):
            k = pe_c[q]
            occ = (holder == tgt_b[k]) & pair_live[k]
            lo = min(rq[q], Nc - 1)
            above = np.nonzero(occ[lo:])[0]
            assert ta[q] == (lo + above[0] if len(above) else Nc + 1)
            hi = int(np.clip(rq[q] - 1, 0, Nc - 1))
            below = np.nonzero(occ[: hi + 1])[0]
            assert tb[q] == (below[-1] if len(below) else -1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_searchsorted_matches_reference_on_inf_and_nan(dtype):
    """The swap search queries ``ew`` (``+inf`` padding) with ``w1 - d*``,
    which is ``inf`` on padding entries and NaN when ``d*`` is not finite:
    torch's left search equals ``jnp.searchsorted`` on both."""
    ew = np.array([0.5, 1, 1, 2, 3, np.inf, np.inf, np.inf], dtype)
    q = np.array([np.nan, np.inf, -np.inf, 1, 0.5, 2.5, 3, 4, -np.nan, 0.0], dtype)
    ref = np.asarray(jnp.searchsorted(jnp.asarray(ew), jnp.asarray(q)))
    got = torch.searchsorted(torch.from_numpy(ew), torch.from_numpy(q)).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed,restrict", [(31, False), (32, True)])
def test_entry_table_matches_reference(seed, restrict):
    from kafkabalancer_tpu.balancer import steps as jsteps
    from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize
    from kafkabalancer_tpu.solvers.polish import entry_table as jentry

    pl = restricted(jsynth, seed, n=120, b=9) if restrict else jsynth(
        120, 9, rf=3, seed=seed)
    cfg = jdefault()
    jsteps.validate_weights(pl, cfg)
    jsteps.fill_defaults(pl, cfg)
    dp = jtensorize(pl, cfg)
    for min_replicas in (0, 2, 3):
        ref = jentry(dp, min_replicas)
        got = tpolish.entry_table(dp, min_replicas)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("batch", [1, 16])
def test_polish_plan_matches_reference_f64(batch, allow_leader):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    jc, tc = cfgs(allow_leader, min_unbalance=1e-7)
    pl_j, pl_t = jsynth(200, 12, rf=3, seed=7), tsynth(200, 12, rf=3, seed=7)
    # batch=1 with leader moves keeps re-moving slots until the budget
    # ends; a budget of a few hundred moves bounds it
    budget = 300 if batch == 1 else 100_000
    opl_j = jplan(pl_j, jc, budget, batch=batch, engine="xla", polish=True)
    opl_t = tscan.plan(pl_t, tc, budget, batch=batch, polish=True, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_polish_plan_restricted_matches_reference_f64():
    """Per-partition broker restrictions: the swap feasibility masks read
    the ``[P, B]`` allowed matrix."""
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    jc, tc = cfgs(min_unbalance=1e-7)
    pl_j, pl_t = restricted(jsynth, 73), restricted(tsynth, 73)
    opl_j = jplan(pl_j, jc, 100_000, batch=8, engine="xla", polish=True)
    opl_t = tscan.plan(pl_t, tc, 100_000, batch=8, polish=True, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("allow_leader", [False, True])
def test_polish_plan_matches_reference_kernel_f32(allow_leader):
    """``engine="pallas-interpret"``: the whole-session kernel's plain
    version up front, then float32 move, swap and shuffle phases."""
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    jc, tc = cfgs(allow_leader, min_unbalance=1e-7)
    pl_j, pl_t = jsynth(200, 12, rf=3, seed=7), tsynth(200, 12, rf=3, seed=7)
    opl_j = jplan(pl_j, jc, 100_000, batch=8, engine="pallas-interpret",
                  polish=True)
    opl_t = tscan.plan(pl_t, tc, 100_000, batch=8, engine="pallas-interpret",
                       polish=True, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_converge_session_log_matches_reference():
    """The packed move log itself (``[move_p | move_slot | move_tgt | n]``,
    log length ``2 * max_moves``), not only its decode."""
    from kafkabalancer_tpu.balancer import steps as jsteps
    from kafkabalancer_tpu.ops import cost as jcost
    from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize
    from kafkabalancer_tpu.solvers.polish import converge_session as jconverge
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import to_device

    pl = jsynth(150, 10, rf=3, seed=5)
    cfg = jdefault()
    jsteps.validate_weights(pl, cfg)
    jsteps.fill_defaults(pl, cfg)
    dp = jtensorize(pl, cfg)
    ew, ep, er, evalid = tpolish.entry_table(dp, 2)
    B = dp.bvalid.shape[0]
    always = np.zeros(B, bool)
    jl = jcost.broker_loads(
        jnp.asarray(dp.replicas), jnp.asarray(dp.weights),
        jnp.asarray(dp.nrep_cur), jnp.asarray(dp.ncons), B,
    )
    ref = np.asarray(jconverge(
        jl, jnp.asarray(dp.replicas), jnp.asarray(dp.allowed),
        jnp.asarray(dp.weights), jnp.asarray(dp.nrep_cur),
        jnp.asarray(dp.nrep_tgt), jnp.asarray(dp.ncons),
        jnp.asarray(dp.pvalid), jnp.asarray(always), jnp.asarray(dp.bvalid),
        jnp.int32(2), jnp.float64(1e-7), jnp.int32(500), jnp.asarray(ew),
        jnp.asarray(ep), jnp.asarray(er), jnp.asarray(evalid),
        max_moves=512, allow_leader=True, batch=4,
    ))
    d = to_device(dp, "cpu", torch.float64)
    got = tpolish.converge_session(
        broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B),
        d.replicas, d.allowed, d.weights, d.nrep_cur, d.nrep_tgt, d.ncons,
        d.pvalid, torch.from_numpy(always), d.bvalid, 2, 1e-7, 500,
        torch.from_numpy(ew), torch.from_numpy(ep).long(),
        torch.from_numpy(er).long(), torch.from_numpy(evalid),
        max_moves=512, allow_leader=True, batch=4,
    ).numpy()
    assert ref[-1] > 0
    assert np.array_equal(got, ref)


def u_of(pl):
    return get_unbalance_bl(get_bl(get_broker_load(pl)))


def test_polish_respects_budget():
    _, tc = cfgs()
    opl = tscan.plan(tsynth(200, 12, rf=3, seed=17), tc, 7, batch=4,
                     polish=True, device="cpu")
    assert 0 < len(opl) <= 7
    opl = tscan.plan(tsynth(200, 12, rf=3, seed=17), tc, 0, batch=4,
                     polish=True, device="cpu")
    assert len(opl) == 0


def test_polish_min_unbalance_gates_swaps():
    _, tc = cfgs(min_unbalance=10.0)
    a = tscan.plan(tsynth(200, 12, rf=3, seed=29), tc, 100_000, batch=8,
                   device="cpu")
    b = tscan.plan(tsynth(200, 12, rf=3, seed=29), tc, 100_000, batch=8,
                   polish=True, device="cpu")
    assert len(a) == len(b) == 0


def test_polish_beats_the_move_session():
    """The 200 x 12 instance has a strict single-move local optimum; the
    swaps escape it (tests/test_polish.py's margin)."""
    _, tc = cfgs()
    pl_plain, pl_pol = tsynth(200, 12, rf=3, seed=7), tsynth(200, 12, rf=3, seed=7)
    tscan.plan(pl_plain, tc, 100_000, batch=8, device="cpu")
    tscan.plan(pl_pol, tc, 100_000, batch=8, polish=True, device="cpu")
    assert u_of(pl_pol) < u_of(pl_plain) * 0.8
    for p in pl_pol.iter_partitions():
        assert len(set(p.replicas)) == len(p.replicas)
        assert set(p.replicas) <= set(p.brokers)
