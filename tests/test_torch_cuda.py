"""The port's kernels on the card (``cuda``-marked; skipped without a GPU).

This file imports nothing of JAX or of the JAX package, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the reference's
tests.) Each CUDA kernel is held against its plain torch version on the
inputs the session gives it (captured from a real session call) with
tolerance zero: the scoring kernel's eight outputs and the whole-session
kernel's seven, equal under ``==``; the scoring kernel also on synthetic
inputs at the shapes its tiling must handle. Its reciprocal division equals
the IEEE division for every finite float32 x at a few avgs. The torch
session with the scoring kernel must emit the same plan as with the plain
scorer, and
``plan(engine="pallas")`` the same plan as ``engine="pallas-interpret"``.
The batched scoring kernel (one launch over K instances) equals K solo
launches and its plain version; the instance-batched session equals solo
sessions; a daemon's fused round on the card answers each member's
in-process plan. A lane's residency pool stages on its own copy stream:
the copies overlap a kernel on the lane stream and carry the host's
bits, the caching allocator keeps a pooled block from reuse while the
lane stream reads it, and no kernel runs on the copy stream.
"""

import numpy as np
import pytest
import torch

from kafkabalancer_tpu_torch.models import default_rebalance_config
from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
from kafkabalancer_tpu_torch.solvers import pallas_session as ps
from kafkabalancer_tpu_torch.solvers import scan
from kafkabalancer_tpu_torch.utils.synth import synth_cluster
from torch_helpers import cuda_device, synthetic  # noqa: F401

pytestmark = pytest.mark.cuda


def cfg(allow_leader=False):
    c = default_rebalance_config()
    c.min_unbalance = 1e-7
    c.allow_leader_rebalancing = allow_leader
    return c


def captured(n_parts, n_brokers, device, seed=3):
    """The scorer's inputs at a session's first iteration (cloned)."""
    seen = []

    def capture(*args, **kw):
        if not seen:
            seen.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return sk.shard_score(*args, **kw)

    scan.plan(
        synth_cluster(n_parts, n_brokers, rf=3, seed=seed), cfg(), 1,
        batch=16, device=device, scorer=capture,
    )
    return seen[0]


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("shape", [(300, 20), (3000, 60)])
def test_kernel_matches_plain(cuda_device, shape, allow_leader, colo, restricted):
    args = captured(*shape, cuda_device)
    mem = args[2]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    if restricted:
        args[3] = torch.rand(mem.shape, generator=g, device=cuda_device) < 0.6
    crows = None
    if colo:
        crows = torch.randint(0, 4, mem.shape, generator=g, device=cuda_device)
        crows = crows.to(torch.float32)
        args[7] = args[7].clone()
        args[7][2] = 0.375
    got = sk.shard_score(*args, crows, allow_leader=allow_leader)
    ref = sk.shard_score_plain(*args, crows, allow_leader=allow_leader)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and bool((a == b).all())


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_takes_any_pair_frame(cuda_device, allow_leader):
    """Pair columns need not come from ``cost.pair_frame``: hot brokers
    that repeat, dead columns and arbitrary targets give the plain
    version's outputs too."""
    args = captured(3000, 60, cuda_device)
    B, B2 = args[2].shape[1], args[8].shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for k in (8, 9):
        args[k] = torch.randint(
            0, B, (B2,), generator=g, device=cuda_device, dtype=torch.int32
        )
    args[10] = torch.rand(B2, generator=g, device=cuda_device) < 0.7
    assert len(set(args[8].tolist())) < B2  # some hot broker repeats
    got = sk.shard_score(*args, allow_leader=allow_leader)
    ref = sk.shard_score_plain(*args, allow_leader=allow_leader)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and bool((a == b).all())


# (P, B, real rows): P below one tile; P not a multiple of the tile and
# spanning more tiles than the grid has blocks (the persistent walk); the
# widest broker bucket; more target groups than threads (B > 1024); B not
# a multiple of 4 or 2 (the target pass's multi-byte reads); a chunk of
# padding rows
SYNTHETIC = [
    (5, 8, 5),
    (100003, 24, 100003),
    (3000, 1024, 2900),
    (300, 1100, 300),
    (777, 30, 700),
    (50, 13, 50),
    (4096, 128, 2500),
]


@pytest.mark.parametrize("equal_weights", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("shape", SYNTHETIC)
def test_kernel_matches_plain_on_synthetic_inputs(
    cuda_device, shape, allow_leader, equal_weights
):
    """Restricted and colocation variants too; equal weights make values
    tie, so the lowest row decides."""
    P, B, n_real = shape
    full = synthetic(P, B, cuda_device, seed=P + B,
                     n_real=n_real, equal_weights=equal_weights)
    for restricted in (False, True):
        for colo in (False, True):
            args = list(full)
            if not restricted:
                args[3] = None
            if not colo:
                args[11] = None
                args[7] = args[7].clone()
                args[7][2] = 0.0
            got = sk.shard_score(*args, allow_leader=allow_leader)
            ref = sk.shard_score_plain(*args, allow_leader=allow_leader)
            torch.cuda.synchronize()
            for name, a, b in zip(("vf", "pf", "vl", "pl", "vpf", "ppf",
                                   "vpl", "ppl"), got, ref):
                assert a.dtype == b.dtype and bool((a == b).all()), (
                    name, restricted, colo)
            assert bool(torch.isfinite(got[0]).any())


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_matches_plain_with_dense_member_rows(cuda_device, allow_leader):
    """Half of every row's brokers are members: far more member cells than
    a tile lists, so the row pass works the rest where it finds them."""
    args = synthetic(600, 64, cuda_device, seed=13)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    args[2] = torch.rand(args[2].shape, generator=g, device=cuda_device) < 0.5
    for restricted in (False, True):
        a = list(args)
        if not restricted:
            a[3] = None
        got = sk.shard_score(*a, allow_leader=allow_leader)
        ref = sk.shard_score_plain(*a, allow_leader=allow_leader)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype and bool((x == y).all())
        assert bool(torch.isfinite(got[4]).any())


def test_division_matches_ieee_for_every_x(cuda_device):
    """The scoring pass's reciprocal division equals the IEEE division for
    every finite float32 x at each avg: one from a session, powers of two,
    significands of all ones, and values outside the reciprocal's range
    (which take the IEEE division)."""
    avg = float(captured(3000, 60, cuda_device)[7][0])
    avgs = [avg, 1.0, 3.0, 0.1, 123456.7, 2.0**39, 2.0**-39,
            float(np.float32(1.9999999)), float(np.float32(2.0**20 * 1.9999999)),
            1e-30, 1e30]
    t = torch.tensor(avgs, dtype=torch.float32, device=cuda_device)
    bad = sk.div_mismatches(t)
    torch.cuda.synchronize()
    assert bad.tolist() == [0] * len(avgs)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = captured(300, 20, cuda_device)
    bad = list(args)
    bad[4] = args[4].double()  # float64 loads: the kernel is float32 only
    with pytest.raises(TypeError):
        sk.shard_score(*bad, allow_leader=False)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()  # non-contiguous cols
    with pytest.raises(ValueError):
        sk.shard_score(*bad, allow_leader=False)


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_session_matches_plain_session(cuda_device, allow_leader):
    sk.shard_score.launches = 0
    a = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        device=cuda_device,
    )
    assert sk.shard_score.launches > 0
    b = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        device=cuda_device, scorer=sk.shard_score_plain,
    )
    ma = [(p.topic, p.partition, tuple(p.replicas)) for p in a.partitions]
    mb = [(p.topic, p.partition, tuple(p.replicas)) for p in b.partitions]
    assert ma and ma == mb


class Captured(Exception):
    """Stops a plan once its first session call is seen."""


def captured_session(n_parts, n_brokers, device, monkeypatch, seed=3,
                     weighted=True):
    """The whole-session kernel's arguments for a plan's first chunk,
    captured from ``plan(engine="pallas")``."""
    seen = []

    def capture(*args, **kw):
        seen.append((list(args), dict(kw)))
        raise Captured()

    monkeypatch.setattr(ps, "pallas_session", capture)
    with pytest.raises(Captured):
        scan.plan(
            synth_cluster(n_parts, n_brokers, rf=3, seed=seed,
                          weighted=weighted),
            cfg(), 1, batch=16, engine="pallas", device=device,
        )
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("shape", [(300, 20), (3000, 60)])
def test_session_kernel_matches_plain(
    cuda_device, monkeypatch, shape, allow_leader, restricted, batch
):
    args, kw = captured_session(*shape, cuda_device, monkeypatch)
    args[13] = 1 << 20  # the whole session: budget past convergence
    args[14] = batch
    kw.update(max_moves=8192, allow_leader=allow_leader)
    if restricted:
        P, B = args[1].shape[0], args[0].shape[0]
        g = torch.Generator(device=cuda_device).manual_seed(7)
        args[3] = torch.rand((P, B), generator=g, device=cuda_device) < 0.6
        kw["all_allowed"] = False
    ps.pallas_session.launches = 0
    got = ps.pallas_session(*args, **kw)
    again = ps.pallas_session(*args, **kw)
    assert ps.pallas_session.launches == 2
    ref = ps.pallas_session_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[2] > 0 and got[2] == again[2] == ref[2]
    for a, b, c in zip(got, again, ref):
        if torch.is_tensor(a):
            assert a.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("restricted", [False, True])
def test_session_kernel_matches_plain_at_the_widest_bucket(
    cuda_device, monkeypatch, restricted
):
    """700 brokers: the kernel's largest broker bucket (B = 1024, a pool
    of K = 1536 candidates), where the tiles shrink to fit shared memory
    and the prefix sums take ordered_sum's deepest level."""
    args, kw = captured_session(2000, 700, cuda_device, monkeypatch)
    assert args[0].shape[0] == 1024
    args[13] = 1 << 20
    args[14] = 64
    kw.update(max_moves=8192, allow_leader=True)
    if restricted:
        P, B = args[1].shape[0], args[0].shape[0]
        g = torch.Generator(device=cuda_device).manual_seed(5)
        args[3] = torch.rand((P, B), generator=g, device=cuda_device) < 0.6
        kw["all_allowed"] = False
    got = ps.pallas_session(*args, **kw)
    ref = ps.pallas_session_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[2] > 0 and got[2] == ref[2]
    for a, c in zip(got, ref):
        if torch.is_tensor(a):
            assert torch.equal(a, c)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_session_kernel_matches_plain_on_ties(
    cuda_device, monkeypatch, allow_leader, batch
):
    """Every partition weighs the same: candidate values tie often, and
    the acceptance's rank order is decided by the candidate index."""
    args, kw = captured_session(3000, 60, cuda_device, monkeypatch,
                                weighted=False)
    args[13] = 1 << 20
    args[14] = batch
    kw.update(max_moves=8192, allow_leader=allow_leader)
    got = ps.pallas_session(*args, **kw)
    ref = ps.pallas_session_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[2] > 0 and got[2] == ref[2]
    for a, c in zip(got, ref):
        if torch.is_tensor(a):
            assert a.dtype == c.dtype and torch.equal(a, c)


def test_stamped_launch_matches_unstamped(cuda_device, monkeypatch):
    """Phase stamps change no output; every iteration's stamps ascend."""
    args, kw = captured_session(3000, 60, cuda_device, monkeypatch)
    budget, max_moves = 1 << 20, 8192
    kw.update(max_moves=max_moves, allow_leader=False)

    def run(stamps=None):
        st = ps.SessionState(args[0], args[1], args[3], *args[4:11],
                             kw["all_allowed"])
        log, counts = ps.launch(st, args[11], args[12], budget, 16, args[15],
                                max_moves, False, stamps=stamps)
        return st, log, counts

    st0, log0, counts0 = run()
    stamps = torch.zeros((ps.stamp_rows(budget, max_moves),
                          len(ps.STAMP_PHASES)), dtype=torch.int64,
                         device=cuda_device)
    st1, log1, counts1 = run(stamps)
    torch.cuda.synchronize()
    assert torch.equal(counts0, counts1) and torch.equal(log0, log1)
    assert torch.equal(st0.replicas, st1.replicas)
    assert torch.equal(st0.loads, st1.loads)
    iters = int(counts1[1])
    assert iters > 1
    flat = stamps[:iters].reshape(-1)
    assert bool((flat[1:] >= flat[:-1]).all())
    assert not bool(stamps[iters:].any())


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_plan_matches_interpret_plan(cuda_device, allow_leader):
    ps.pallas_session.launches = 0
    a = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        engine="pallas", device=cuda_device,
    )
    assert ps.pallas_session.launches > 0
    b = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        engine="pallas-interpret", device=cuda_device,
    )
    ma = [(p.topic, p.partition, tuple(p.replicas)) for p in a.partitions]
    mb = [(p.topic, p.partition, tuple(p.replicas)) for p in b.partitions]
    assert ma and ma == mb


def test_session_kernel_rejects_what_it_does_not_take(cuda_device, monkeypatch):
    args, kw = captured_session(300, 20, cuda_device, monkeypatch)
    bad = list(args)
    bad[4] = args[4].cpu()  # weights on another device
    with pytest.raises(ValueError):
        ps.pallas_session(*bad, **kw)
    bad = list(args)
    bad[14] = 0  # batch
    with pytest.raises(ValueError):
        ps.pallas_session(*bad, **kw)


def plan_moves(opl):
    return [(p.topic, p.partition, tuple(p.replicas)) for p in opl.partitions]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_polish_with_the_kernel_matches_the_plain_scorer(
    cuda_device, allow_leader, batch
):
    """``plan(polish=True)`` on the card: every move phase scores through
    the scoring kernel (batched) and gives the plan of the same
    alternation with its plain version."""
    budget = 300 if batch == 1 else 100_000
    sk.shard_score.launches = 0
    a = scan.plan(synth_cluster(1500, 30, seed=21), cfg(allow_leader), budget,
                  batch=batch, polish=True, device=cuda_device)
    assert batch == 1 or sk.shard_score.launches > 0
    b = scan.plan(synth_cluster(1500, 30, seed=21), cfg(allow_leader), budget,
                  batch=batch, polish=True, device=cuda_device,
                  scorer=sk.shard_score_plain)
    assert plan_moves(a) and plan_moves(a) == plan_moves(b)


@pytest.mark.parametrize("allow_leader", [False, True])
def test_polish_with_the_session_kernel_matches_interpret(
    cuda_device, allow_leader
):
    """``engine="pallas"`` under polish: one whole-session launch up front,
    then the alternation; the same plan as with the kernel's plain
    version (``pallas-interpret``)."""
    ps.pallas_session.launches = 0
    a = scan.plan(synth_cluster(1500, 30, seed=22), cfg(allow_leader), 100_000,
                  batch=16, engine="pallas", polish=True, device=cuda_device)
    assert ps.pallas_session.launches == 1
    b = scan.plan(synth_cluster(1500, 30, seed=22), cfg(allow_leader), 100_000,
                  batch=16, engine="pallas-interpret", polish=True,
                  device=cuda_device)
    assert plan_moves(a) and plan_moves(a) == plan_moves(b)


@pytest.mark.parametrize("batch", [1, 16])
def test_leader_session_runs_on_the_card(cuda_device, batch):
    c = cfg()
    c.rebalance_leaders = True
    pl = synth_cluster(1500, 30, seed=23)
    opl = scan.plan(pl, c, 300, batch=batch, device=cuda_device)
    assert plan_moves(opl)
    for p in pl.partitions:
        assert len(set(p.replicas)) == len(p.replicas)


def test_solver_tpu_runs_on_the_card(cuda_device, monkeypatch):
    """``-solver=tpu`` through the pipeline on the card: the device pass
    runs and the session equals the greedy session."""
    import copy

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.balancer import balance
    from kafkabalancer_tpu_torch.cli import apply_assignment
    from kafkabalancer_tpu_torch.solvers import tpu

    monkeypatch.setattr(tpu, "MIN_DEVICE_CANDIDATES", 0)
    pl = synth_cluster(400, 20, seed=24)
    out = {}
    obs.begin_invocation()
    for solver, dev in (("greedy", None), ("tpu", cuda_device)):
        c = cfg()
        c.solver = solver
        live = copy.deepcopy(pl)
        got = []
        for _ in range(5):
            ppl = balance(live, c, device=dev)
            if not len(ppl):
                break
            got += [tuple(apply_assignment(live, x).replicas) for x in ppl.partitions]
        out[solver] = got
    assert out["tpu"] and out["tpu"] == out["greedy"]
    assert obs.REGISTRY.counter_get("solver.window_passes") >= len(out["tpu"])


def test_searchsorted_on_the_card_takes_inf_and_nan_as_on_the_cpu(cuda_device):
    ew = torch.tensor([0.5, 1, 1, 2, 3] + [float("inf")] * 3)
    q = torch.tensor([float("nan"), float("inf"), -float("inf"), 1, 0.5, 2.5])
    assert torch.equal(
        torch.searchsorted(ew.to(cuda_device), q.to(cuda_device)).cpu(),
        torch.searchsorted(ew, q),
    )


def test_polish_surfaces_the_session_kernel_limit(cuda_device):
    """More than 1024 brokers: the whole-session kernel refuses, and the
    polish pre-phase surfaces that as a planning failure (CLI exit 3);
    nothing falls back."""
    from kafkabalancer_tpu_torch.balancer import BalanceError

    with pytest.raises(BalanceError, match="pallas engine failed"):
        scan.plan(synth_cluster(3000, 1100, seed=25), cfg(), 1000, batch=16,
                  engine="pallas", polish=True, device=cuda_device)


@pytest.mark.parametrize("polish", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_colocation_session_with_the_kernel_matches_plain(
    cuda_device, allow_leader, polish
):
    """``plan(anti_colocation=λ)`` on the card: every batched iteration
    launches the scoring kernel's colocation variant, and the plan equals
    the same session with its plain version."""
    kw = dict(batch=16, anti_colocation=0.001, polish=polish,
              device=cuda_device)
    sk.shard_score.launches = 0
    a = scan.plan(synth_cluster(1500, 30, seed=26, zipf_topics=True),
                  cfg(allow_leader), 100_000, **kw)
    assert sk.shard_score.launches > 0
    b = scan.plan(synth_cluster(1500, 30, seed=26, zipf_topics=True),
                  cfg(allow_leader), 100_000, scorer=sk.shard_score_plain, **kw)
    assert plan_moves(a) and plan_moves(a) == plan_moves(b)


def test_colocation_kernel_failure_exits_3(cuda_device, monkeypatch):
    """A scoring-kernel failure on the colocation path is a planning
    failure (CLI exit 3); the plain version never stands in."""
    import io

    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.codecs import write_partition_list

    def broken(*a, **k):
        raise RuntimeError("shard_score kernel launch failed: test")

    monkeypatch.setattr(sk, "_launch", broken)
    buf = io.StringIO()
    write_partition_list(buf, synth_cluster(300, 12, seed=27, zipf_topics=True))
    o, e = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(buf.getvalue()), o, e,
                 ["kafkabalancer", "-input-json", "-fused", "-fused-batch=8",
                  "-anti-colocation=0.001", "-min-unbalance=1e-7"])
    assert rc == 3 and "engine failed" in e.getvalue()
    assert o.getvalue() == ""


@pytest.mark.parametrize("lam", [0.0, 0.001])
def test_beam_move_on_the_card_improves(cuda_device, lam):
    """``beam_move`` on ``cuda:0`` emits a move that improves, on its own,
    the host oracle's unbalance or (the depth-1 retry) the combined
    objective by ``min_unbalance``."""
    import collections

    from kafkabalancer_tpu_torch.balancer import steps
    from kafkabalancer_tpu_torch.balancer.costmodel import (
        get_bl,
        get_broker_load,
        get_unbalance_bl,
    )
    from kafkabalancer_tpu_torch.cli import apply_assignment
    from kafkabalancer_tpu_torch.solvers import beam

    def objectives(pl):
        u = get_unbalance_bl(get_bl(get_broker_load(pl)))
        n = collections.Counter(
            (p.topic, b) for p in pl.partitions for b in p.replicas
        )
        return u, u + lam * sum(v - 1 for v in n.values() if v > 1)

    c = cfg()
    c.anti_colocation = lam
    pl = synth_cluster(1500, 30, seed=28, zipf_topics=True)
    steps.validate_weights(pl, c)
    steps.fill_defaults(pl, c)
    u0, j0 = objectives(pl)
    ppl = beam.beam_move(pl, c, device=cuda_device)
    assert ppl is not None and len(ppl.partitions) == 1
    apply_assignment(pl, ppl.partitions[0])
    u1, j1 = objectives(pl)
    assert u1 < u0 - c.min_unbalance or j1 < j0 - c.min_unbalance


def plan_moves(opl):
    return [(p.topic, p.partition, tuple(p.replicas)) for p in (opl.partitions or [])]


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_sharded_plan_on_the_card_matches_single_device(
    cuda_device, S, scale, allow_leader
):
    """``plan_sharded`` on meshes that name the card S times: the card's
    single-device plan, with the scoring kernel launched S times (times
    the row chunks) per sharded iteration."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.shard_session import plan_sharded

    mesh = make_mesh(devices=[cuda_device] * S, shape=(1, S))
    obs.begin_invocation()
    sk.shard_score.launches = 0
    got = plan_sharded(synth_cluster(2000, 40, rf=3, seed=5), cfg(allow_leader),
                       100000, mesh, batch=16, scale=scale, row_chunk=96)
    iters = obs.REGISTRY.counter_get("shard.session_iterations")
    chunks = 1 if not scale else -(-(2048 // S) // 96)
    assert sk.shard_score.launches == S * chunks * iters > 0
    want = scan.plan(synth_cluster(2000, 40, rf=3, seed=5), cfg(allow_leader),
                     100000, batch=16, device=cuda_device)
    assert plan_moves(got) == plan_moves(want)


def test_sharded_plan_with_the_kernel_matches_the_plain_scorer(cuda_device):
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.shard_session import plan_sharded

    mesh = make_mesh(devices=[cuda_device] * 2, shape=(1, 2))
    runs = [
        plan_moves(plan_sharded(
            synth_cluster(1500, 30, rf=3, seed=9, zipf_topics=True),
            cfg(True), 100000, mesh, batch=16, anti_colocation=0.001,
            polish=True, **kw,
        ))
        for kw in ({}, {"scorer": sk.shard_score_plain})
    ]
    assert runs[0] and runs[0] == runs[1]


def test_sweep_on_the_card_matches_plain_versions(cuda_device):
    """Engine ``pallas`` (one whole-session launch per scenario) equals
    ``pallas-interpret`` on the card; engine ``xla`` with the scoring
    kernel equals it with the plain scorer."""
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.sweep import sweep

    pl = synth_cluster(1000, 20, rf=3, seed=11)
    obs_ = sorted({b for p in pl.partitions for b in p.replicas})
    scen = [obs_, obs_ + [max(obs_) + 1], obs_[1:]]
    mesh = make_mesh(devices=[cuda_device])

    def run(**kw):
        res = sweep(pl, cfg(), scen, max_reassign=500, mesh=mesh, batch=16, **kw)
        return [(r.feasible, r.completed, r.n_evacuations, r.n_moves,
                 r.unbalance, r.replicas) for r in res]

    ps.pallas_session.launches = 0
    kernel = run(engine="pallas")
    assert ps.pallas_session.launches == len(scen)
    assert kernel == run(engine="pallas-interpret")
    assert run(engine="xla") == run(engine="xla", scorer=sk.shard_score_plain)


def _cli(args, **kw):
    import io

    from kafkabalancer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(""), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


def _cluster_file(dirname, seed, n_parts=3000, n_brokers=60):
    import io
    import os

    from kafkabalancer_tpu_torch.codecs import write_partition_list

    path = os.path.join(dirname, f"c{seed}.json")
    buf = io.StringIO()
    write_partition_list(buf, synth_cluster(n_parts, n_brokers, rf=3,
                                            seed=seed))
    with open(path, "w") as fh:
        fh.write(buf.getvalue())
    return path


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_served_plan_on_the_card_matches_in_process(cuda_device, tmp_path,
                                                    engine):
    """The planning daemon with a lane on the card: a served -fused plan
    (K1 in every iteration) and a served -fused-engine=pallas plan (one
    B2 launch) equal the in-process plans on the same card, with the
    same launch counts."""
    from torch_helpers import running_daemon

    path = _cluster_file(str(tmp_path), 5)
    args = ["-input-json", f"-input={path}", "-fused", "-fused-batch=100",
            "-max-reassign=100000", "-min-unbalance=1e-7",
            f"-fused-engine={engine}"]
    counter = sk.shard_score if engine == "xla" else ps.pallas_session
    counter.launches = 0
    local = _cli(args + ["-no-daemon"], device=cuda_device)
    want = counter.launches
    assert local[0] == 0 and want > 0
    with running_daemon(devices=[cuda_device], lanes=0) as (sock, d, logs):
        counter.launches = 0
        served = _cli(args + [f"-serve-socket={sock}"])
        got = counter.launches
        assert d._requests == 1
        assert d._fallbacks == {"session_absent": 1}
    assert served[:2] == local[:2]
    assert got == want


def test_served_concurrent_on_the_card_matches_solo_plans(cuda_device, tmp_path):
    """Two concurrent same-bucket -fused clients of one daemon on the
    card: each prints its in-process plan, and the served requests
    launch the scoring kernel as often as the two in-process runs."""
    import threading

    from torch_helpers import running_daemon

    paths = [_cluster_file(str(tmp_path), seed) for seed in (6, 7)]
    args = ["-input-json", "-fused", "-fused-batch=100",
            "-max-reassign=100000", "-min-unbalance=1e-7"]
    sk.shard_score.launches = 0
    want = [_cli(args + [f"-input={p}", "-no-daemon"], device=cuda_device)
            for p in paths]
    want_launches = sk.shard_score.launches
    with running_daemon(devices=[cuda_device], lanes=0) as (sock, d, _logs):
        sk.shard_score.launches = 0
        got = [None, None]

        def client(i):
            got[i] = _cli(args + [f"-input={paths[i]}",
                                  f"-serve-socket={sock}"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert d._requests == 2
        assert d._fallbacks == {"session_absent": 2}
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert sk.shard_score.launches == want_launches


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_speculative_memo_on_the_card(cuda_device, tmp_path, engine):
    """Speculative plan-ahead with a lane on the card: a three-round
    deployment loop (the move applied to the file between rounds) is
    answered from memos in rounds 2-3, each answer equal to the in-process
    move on the card, and the speculative runs launch the engine's kernel
    (K1 for the torch session, B2 for the whole-session kernel)."""
    import io
    import json
    import time

    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )
    from torch_helpers import running_daemon

    path = _cluster_file(str(tmp_path), 8, n_parts=3000, n_brokers=60)
    args = ["-input-json", f"-input={path}", "-fused", "-fused-batch=100",
            "-max-reassign=1", "-min-unbalance=1e-7",
            f"-fused-engine={engine}"]
    with running_daemon(devices=[cuda_device], lanes=0,
                        speculate=True) as (sock, d, _logs):
        for rnd in range(3):
            want = _cli(args + ["-no-daemon"], device=cuda_device)
            hits0 = d.speculator.stats()["hits"]
            attempts0 = d.speculator.stats()["attempts"]
            got = _cli(args + [f"-serve-socket={sock}"])
            assert got[:2] == want[:2] and got[0] == 0, rnd
            assert d.speculator.stats()["hits"] - hits0 == (1 if rnd else 0)
            with open(path) as fh:
                pl = get_partition_list_from_reader(fh.read(), True)
            moved = {(r["topic"], r["partition"]): r["replicas"]
                     for r in json.loads(got[1])["partitions"]}
            for p in pl.partitions:
                p.replicas = moved.get((p.topic, p.partition), p.replicas)
            buf = io.StringIO()
            write_partition_list(buf, pl)
            with open(path, "w") as fh:
                fh.write(buf.getvalue())
            deadline = time.monotonic() + 120
            while True:
                st = d.speculator.stats()
                if st["attempts"] > attempts0 and not st["inflight"]:
                    break
                assert time.monotonic() < deadline, st
                time.sleep(0.02)
        made = d.internal_launches.get("spec", {})
        st = d.speculator.stats()
    kernel = "shard_score" if engine == "xla" else "pallas_session"
    assert made.get(kernel, 0) > 0, made
    assert st["attempts"] == st["hits"] + st["misses"] + st["poisoned"] + (
        st["memos"])


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_batched_kernel_matches_solo_launches_and_plain(
    cuda_device, K, allow_leader, colo, restricted
):
    """One launch of the batched scoring kernel over K instances: each
    instance's eight outputs equal a solo launch's and the plain
    version's, with zero tolerance; one launch counted."""
    per = [synthetic(300, 20, cuda_device, seed) for seed in range(K)]
    args = [[a[0], a[1], a[2], a[3] if restricted else None, *a[4:11],
             a[11] if colo else None] for a in per]
    st = [None if args[0][j] is None
          else torch.stack([x[j] for x in args]).contiguous()
          for j in range(12)]
    n0 = sk.shard_score_batched.launches
    got = sk.shard_score_batched(*st[:11], c_rows=st[11],
                                 allow_leader=allow_leader)
    assert sk.shard_score_batched.launches == n0 + 1
    ref = sk.shard_score_batched_plain(*st[:11], c_rows=st[11],
                                       allow_leader=allow_leader)
    torch.cuda.synchronize()
    for k, a in enumerate(args):
        solo = sk.shard_score(*a[:11], c_rows=a[11],
                              allow_leader=allow_leader)
        for x, y, z in zip(got, solo, ref):
            assert torch.equal(x[k], y) and bool((x[k] == z[k]).all())


@pytest.mark.parametrize("allow_leader", [False, True])
def test_session_batched_on_the_card_matches_solo_sessions(
    cuda_device, allow_leader
):
    """Three distinct clusters of one bucket (one with budget 0): the
    instance-batched session's logs equal three solo sessions' byte for
    byte, with one batched launch per iteration and no solo launch."""
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import (
        all_allowed_of,
        tensorize,
        to_device,
    )

    ins = []
    for seed in (11, 12, 13):
        pl = synth_cluster(3000, 60, rf=3, seed=seed)
        c = cfg(allow_leader)
        scan._settle_head(pl, c, 10 ** 6)
        dp = tensorize(pl, c)
        d = to_device(dp, torch.device(cuda_device), torch.float32,
                      all_allowed=all_allowed_of(dp))
        loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                             dp.bvalid.shape[0])
        always = torch.from_numpy(scan._cfg_broker_mask(dp, c)).to(
            cuda_device)
        ins.append((loads, d.replicas, d.member, d.allowed, d.weights,
                    d.nrep_cur, d.nrep_tgt, d.ncons, d.pvalid, always,
                    d.bvalid))
    budgets, mus = [4000, 0, 4000], [1e-7, 1e-7, 1e-3]
    solo = []
    for k in range(3):
        _r, _l, n, mp, msl, _ms, mt, _su = scan.session(
            *ins[k], 2, mus[k], budgets[k], max_moves=4096,
            allow_leader=allow_leader, batch=100)
        solo.append(torch.cat([mp, msl, mt, torch.tensor(
            [n], dtype=torch.int32, device=mp.device)]).cpu())
    stacked = [None if ins[0][j] is None
               else torch.stack([x[j] for x in ins]) for j in range(11)]
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    packed, iters, _secs = scan.session_batched(
        *stacked, [2] * 3, mus, budgets, max_moves=4096,
        allow_leader=allow_leader, batch=100)
    assert sk.shard_score.launches == 0
    assert sk.shard_score_batched.launches == max(iters)
    assert iters[1] == 0
    for k in range(3):
        assert torch.equal(packed[k].cpu(), solo[k]), k



def _card_instances(cuda_device, allow_leader, seeds=(21, 22, 23),
                    shape=(3000, 60)):
    """Settled zipf-topic clusters of one bucket on the card: each one's
    11 session tensors, topic ids and polish entry table."""
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import (
        all_allowed_of,
        tensorize,
        to_device,
    )
    from kafkabalancer_tpu_torch.solvers import polish

    dev = torch.device(cuda_device)
    out = []
    for seed in seeds:
        pl = synth_cluster(*shape, rf=3, seed=seed, zipf_topics=True)
        c = cfg(allow_leader)
        scan._settle_head(pl, c, 10 ** 6)
        dp = tensorize(pl, c)
        d = to_device(dp, dev, torch.float32, all_allowed=all_allowed_of(dp))
        loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                             dp.bvalid.shape[0])
        always = torch.from_numpy(scan._cfg_broker_mask(dp, c)).to(dev)
        ew, ep, er, ev = polish.entry_table(dp, 2)
        out.append(((loads, d.replicas, d.member, d.allowed, d.weights,
                     d.nrep_cur, d.nrep_tgt, d.ncons, d.pvalid, always,
                     d.bvalid),
                    torch.from_numpy(dp.topic_id).to(dev, torch.long),
                    (torch.from_numpy(ew).to(dev, torch.float32),
                     torch.from_numpy(ep).to(dev, torch.long),
                     torch.from_numpy(er).to(dev, torch.long),
                     torch.from_numpy(ev).to(dev))))
    return out


def _stack(xs):
    return [None if xs[0][j] is None else torch.stack([x[j] for x in xs])
            for j in range(len(xs[0]))]


@pytest.mark.parametrize("kind", ["colocation", "batch1"])
def test_session_batched_kinds_on_the_card(cuda_device, kind):
    """The instance-batched session in colocation mode (K1's colocation
    variant over the instance axis) and at batch 1 over three clusters
    of one bucket (one with budget 0): each log equal to its solo
    session's and to the same fused run with the plain scorer; at batch
    > 1 one batched launch per iteration and no solo launch, at batch 1
    no launch."""
    ins = _card_instances(cuda_device, allow_leader=True)
    batch = 100 if kind == "colocation" else 1
    budgets = [4000, 0, 4000] if batch > 1 else [150, 0, 150]
    mus, lams = [1e-7, 1e-7, 1e-3], [0.001, 0.001, 0.004]
    nt = 128  # 93 topics each: the 128 bucket
    solo = []
    for k in range(3):
        ck = dict(topic_id=ins[k][1], lam=lams[k], n_topics=nt) \
            if batch > 1 else {}
        _r, _l, n, mp, msl, _ms, mt, _su = scan.session(
            *ins[k][0], 2, mus[k], budgets[k], max_moves=4096,
            allow_leader=True, batch=batch, **ck)
        solo.append(torch.cat([mp, msl, mt, torch.tensor(
            [n], dtype=torch.int32, device=mp.device)]).cpu())
    st = _stack([x[0] for x in ins])
    kw = dict(max_moves=4096, allow_leader=True, batch=batch)
    if batch > 1:
        kw.update(topic_id=torch.stack([x[1] for x in ins]), lam=lams,
                  n_topics=nt)
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    packed, iters, _secs = scan.session_batched(
        *st, [2] * 3, mus, budgets, **kw)
    launches = sk.shard_score_batched.launches
    plain, _it, _s = scan.session_batched(
        *st, [2] * 3, mus, budgets, scorer=sk.shard_score_batched_plain,
        **kw)
    assert sk.shard_score.launches == 0
    assert launches == (max(iters) if batch > 1 else 0)
    assert iters[1] == 0
    for k in range(3):
        assert torch.equal(packed[k].cpu(), solo[k]), k
        assert torch.equal(plain[k].cpu(), solo[k]), k
    assert int(packed[0, -1]) > 0


@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_converge_session_batched_on_the_card(cuda_device, allow_leader,
                                              colo):
    """The batched polish alternation over three clusters of one bucket
    (one with budget 0): each log equal to its solo alternation's and to
    the same fused run with the plain scorer."""
    from kafkabalancer_tpu_torch.solvers import polish

    ins = _card_instances(cuda_device, allow_leader)
    budgets, mus, lams = [100000, 0, 100000], [1e-7, 1e-7, 1e-3], [
        0.001, 0.001, 0.004]
    nt = 128  # 93 topics each: the 128 bucket
    solo = []
    for k in range(3):
        t, tid, table = ins[k]
        ck = dict(topic_id=tid, lam=lams[k], n_topics=nt) if colo else {}
        solo.append(polish.converge_session(
            t[0], t[1], t[3], *t[4:11], 2, mus[k], budgets[k], *table,
            max_moves=8192, allow_leader=allow_leader, batch=100,
            **ck).cpu())
    st = _stack([x[0] for x in ins])
    table = _stack([x[2] for x in ins])
    kw = dict(max_moves=8192, allow_leader=allow_leader, batch=100)
    if colo:
        kw.update(topic_id=torch.stack([x[1] for x in ins]), lam=lams,
                  n_topics=nt)
    sk.shard_score.launches = 0
    packed, counters = polish.converge_session_batched(
        st[0], st[1], st[3], *st[4:11], [2] * 3, mus, budgets, *table, **kw)
    plain, _c = polish.converge_session_batched(
        st[0], st[1], st[3], *st[4:11], [2] * 3, mus, budgets, *table,
        scorer=sk.shard_score_batched_plain, **kw)
    assert sk.shard_score.launches == 0
    for k in range(3):
        assert torch.equal(packed[k].cpu(), solo[k]), k
        assert torch.equal(plain[k].cpu(), solo[k]), k
    assert int(packed[0, -1]) > 0 and counters[1] == {}


@pytest.mark.parametrize("allow_leader", [False, True])
def test_batched_colocation_kernel_at_the_main_bucket(cuda_device,
                                                      allow_leader):
    """K1's colocation variant over four instances of the 10k x 100
    bucket (P = 16384, B = 128) in one launch: each instance's eight
    outputs equal a solo launch's and the plain version's."""
    per = [synthetic(16384, 128, cuda_device, seed) for seed in range(4)]
    st = [None if per[0][j] is None
          else torch.stack([x[j] for x in per]).contiguous()
          for j in range(12)]
    st[3] = None  # every broker allowed, as the main path
    n0 = sk.shard_score_batched.launches
    got = sk.shard_score_batched(*st[:11], c_rows=st[11],
                                 allow_leader=allow_leader)
    assert sk.shard_score_batched.launches == n0 + 1
    ref = sk.shard_score_batched_plain(*st[:11], c_rows=st[11],
                                       allow_leader=allow_leader)
    torch.cuda.synchronize()
    for k, a in enumerate(per):
        solo = sk.shard_score(*a[:3], None, *a[4:11], c_rows=a[11],
                              allow_leader=allow_leader)
        for x, y, z in zip(got, solo, ref):
            assert torch.equal(x[k], y) and bool((x[k] == z[k]).all())

def test_served_fused_round_on_the_card(cuda_device, tmp_path):
    """Two held same-bucket -fused clients of a daemon with
    -serve-microbatch=2 -serve-admission-hold=2 on the card: one fused
    round, each plan its in-process plan, batched launches only."""
    import threading

    from torch_helpers import running_daemon

    paths = [_cluster_file(str(tmp_path), seed) for seed in (8, 9)]
    args = ["-input-json", "-fused", "-fused-batch=100",
            "-max-reassign=100000", "-min-unbalance=1e-7"]
    sk.shard_score.launches = 0
    want = []
    for p in paths:
        n0 = sk.shard_score.launches
        want.append(_cli(args + [f"-input={p}", "-no-daemon"],
                         device=cuda_device))
        want[-1] = want[-1] + (sk.shard_score.launches - n0,)
    with running_daemon(devices=[cuda_device], lanes=0, microbatch=2,
                        admission_hold=2) as (sock, d, _logs):
        d._coalescer._hold_window_s = 120.0
        sk.shard_score.launches = 0
        sk.shard_score_batched.launches = 0
        got = [None, None]

        def client(i):
            got[i] = _cli(args + [f"-input={paths[i]}",
                                  f"-serve-socket={sock}"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        doc = d._core_snapshot()
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert doc["microbatched"] == 2 and doc["mb_occupancy"] == {"2": 1}
    assert sk.shard_score.launches == 0
    assert 0 < sk.shard_score_batched.launches <= max(w[-1] for w in want)


# --- the residency pool's copy stream (serve/residency.py, ops/tensorize) ----

# cycles of torch.cuda._sleep per ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES_PER_MS = 1_980_000


def _tensorize_mod():
    import importlib

    # ops/__init__ re-exports the tensorize FUNCTION under the module name
    return importlib.import_module("kafkabalancer_tpu_torch.ops.tensorize")


def _host_arrays(seed=11):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(-1, 100, (16384, 4)).astype(np.int32),
        rng.random(16384),  # float64: staged raw, cast at use
        rng.random((16384, 128)) < 0.3,
    ]


def _trace_events(prof, tmp_path):
    import json as _json

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return [ev for ev in _json.load(fh)["traceEvents"]
                if ev.get("ph") == "X"]


def test_staged_copy_overlaps_a_long_kernel_and_has_the_right_bits(
        cuda_device):
    """Staged on the lane's copy stream while a spin kernel holds the
    lane stream: the copies complete before the spin does, and the
    tensors read on the lane stream right after their event hold the
    host bits (the float column cast on the lane stream at use)."""
    from kafkabalancer_tpu_torch.serve.lanes import Lane

    tz = _tensorize_mod()
    lane = Lane(0, torch.device(cuda_device))
    hosts = _host_arrays()
    with lane.context():
        lane_stream = torch.cuda.current_stream()
        assert lane_stream == torch.cuda.default_stream(cuda_device)
        copy = lane.copy_stream()
        assert copy != lane_stream
        torch.cuda._sleep(SPIN_CYCLES_PER_MS * 400)
        rec = {}
        n = tz.stage_host_arrays(lane.stage_cache, hosts, cuda_device, copy,
                                 rec)
        assert n == 3 and rec["bytes"] == sum(a.nbytes for a in hosts)
        rec["end"].synchronize()
        # the copies are done while the spin still runs
        assert not lane_stream.query()
        got = [tz._pooled(lane.stage_cache, a, cuda_device) for a in hosts]
        as32 = got[1].to(torch.float32)
        torch.cuda.synchronize()
    for a, t in zip(hosts, got):
        assert np.array_equal(t.cpu().numpy(), a)
    assert np.array_equal(as32.cpu().numpy(), hosts[1].astype(np.float32))
    st = lane.stage_cache.stats()
    assert st["hits"] == 3 and st["misses"] == 0
    # each fence is handed out once
    assert all(lane.stage_cache.pop_fence(k) is None
               for k, _t in lane.stage_cache.items())


def test_pooled_block_is_not_reused_while_the_lane_stream_reads_it(
        cuda_device):
    """A staged tensor first used on the lane stream is marked used
    there: dropped from the pool while a queued lane-stream kernel still
    reads it, its block is not handed to the next allocation on the
    copy stream. The control (a staged tensor never used on the lane
    stream) shows the allocator would otherwise reuse the block."""
    from kafkabalancer_tpu_torch.serve.lanes import Lane

    tz = _tensorize_mod()
    lane = Lane(0, torch.device(cuda_device))
    a = np.arange(1 << 20, dtype=np.int32)
    with lane.context():
        copy = lane.copy_stream()
        # the control: staged, freed, and the same-size allocation on the
        # copy stream takes the block back
        tz.stage_host_arrays(lane.stage_cache, [a], cuda_device, copy)
        torch.cuda.synchronize()
        ptr = lane.stage_cache.items()[0][1].data_ptr()
        lane.stage_cache.clear()
        with torch.cuda.stream(copy):
            again = torch.empty(a.shape, dtype=torch.int32,
                                device=cuda_device)
        assert again.data_ptr() == ptr
        del again
        torch.cuda.synchronize()
        # the pooled tensor read on the lane stream behind a spin kernel
        tz.stage_host_arrays(lane.stage_cache, [a + 1], cuda_device, copy)
        t = tz._pooled(lane.stage_cache, a + 1, cuda_device)
        ptr = t.data_ptr()
        torch.cuda._sleep(SPIN_CYCLES_PER_MS * 300)
        total = t.sum()
        lane.stage_cache.clear()
        del t
        with torch.cuda.stream(copy):
            other = torch.empty(a.shape, dtype=torch.int32,
                                device=cuda_device)
        assert other.data_ptr() != ptr
        torch.cuda.synchronize()
    assert int(total) == int((a.astype(np.int64) + 1).sum())


def test_no_kernel_is_launched_on_the_copy_stream(cuda_device, tmp_path):
    """The profiler's trace of a stage and its first use: the copy
    stream carries host-to-device copies and nothing else; the casts
    run as kernels on the lane stream."""
    from torch.profiler import ProfilerActivity, profile

    from kafkabalancer_tpu_torch.serve.lanes import Lane

    tz = _tensorize_mod()
    lane = Lane(0, torch.device(cuda_device))
    hosts = _host_arrays(12)
    with lane.context():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tz.stage_host_arrays(lane.stage_cache, hosts, cuda_device,
                                 lane.copy_stream())
            got = [tz._pooled(lane.stage_cache, a, cuda_device)
                   for a in hosts]
            got[1].to(torch.float32).sum()
            torch.cuda.synchronize()
    events = _trace_events(prof, tmp_path)
    copies = [ev for ev in events if ev.get("cat") == "gpu_memcpy"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    assert copies, "the profiler recorded no device copy"
    copy_streams = {ev["args"].get("stream") for ev in copies}
    kernel_streams = {ev["args"].get("stream") for ev in kernels}
    assert kernels, "the casts and the sum are kernels on the lane stream"
    assert len(copy_streams) == 1 and not copy_streams & kernel_streams, (
        copy_streams, kernel_streams)
    assert len(copies) == len(hosts)
