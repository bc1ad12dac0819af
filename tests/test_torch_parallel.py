"""The port's multi-device layer against the reference's, case by case
after tests/test_parallel.py.

The reference runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port on meshes that name the CPU several times
(``make_mesh(devices=["cpu"] * S)``), which drive the same code as S
cards. The same seeded instances go through both packages:

- ``sharded_score_moves``: the winner, its index, ``su`` and the rank
  permutation equal the reference's and the port's unsharded scorer's;
- ``plan_sharded``: move logs and final assignments equal the
  reference's ``plan_sharded`` at float64 with the ``xla`` engine and at
  float32 with ``pallas-interpret`` on both sides, and equal the port's
  single-device ``plan`` wherever the reference pins its own sharded
  plan to its ``plan`` (plain, restricted, odd meshes, the scale tier,
  colocation, the leader hand-over);
- the combine (``shard_session.combine_pools`` / ``gather_pool``)
  follows the scoring kernel's rules across shard boundaries: ``-0.0``
  ties ``+0.0`` and the lower global row wins, a NaN never wins, a
  column empty on every shard is shard 0's ``(+inf, row 0)``, and sharded
  pools equal the whole table's ``scan.rows_pool``.

Tolerance: none; logs, states and pools compare equal.
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

from kafkabalancer_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from kafkabalancer_tpu.parallel.shard_session import (  # noqa: E402
    plan_sharded as jplan_sharded,
)
from kafkabalancer_tpu.solvers.scan import plan as jplan  # noqa: E402

from kafkabalancer_tpu_torch.models import (  # noqa: E402
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.ops.cost import broker_loads  # noqa: E402
from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device  # noqa: E402
from kafkabalancer_tpu_torch.parallel import shard_kernel  # noqa: E402
from kafkabalancer_tpu_torch.parallel import shard_session as tss  # noqa: E402
from kafkabalancer_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    balanced_factors,
    make_mesh,
    replicate_put,
    shard_put,
)
from kafkabalancer_tpu_torch.parallel.shard_move import (  # noqa: E402
    sharded_score_moves,
)
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402
from test_torch_scan import moves, state  # noqa: E402


def cpu_mesh(S, sweep=1):
    return make_mesh(devices=["cpu"] * (S * sweep), shape=(sweep, S))


def cfgs(allow_leader=False, min_unbalance=1e-7, **kw):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.allow_leader_rebalancing = allow_leader
        c.min_unbalance = min_unbalance
        for k, v in kw.items():
            setattr(c, k, v)
    return j, t


def restricted(synth, n, b, seed):
    """tests/test_parallel.py's restricted instance: half the partitions
    keep their replicas plus a random half of the universe."""
    pl = synth(n, b, rf=3, seed=seed, weighted=True)
    rng = random.Random(seed)
    for p in pl.iter_partitions():
        if rng.random() < 0.5:
            extra = [x for x in range(1, b + 1) if rng.random() < 0.5]
            p.brokers = sorted(set(p.replicas) | set(extra))
    return pl


def both(kind, n, b, seed, **kw):
    """(reference list, port list, port list for the single-device plan)."""
    if kind == "restricted":
        return (restricted(jsynth, n, b, seed), restricted(tsynth, n, b, seed),
                restricted(tsynth, n, b, seed))
    return (jsynth(n, b, rf=3, seed=seed, weighted=True, **kw),
            tsynth(n, b, rf=3, seed=seed, weighted=True, **kw),
            tsynth(n, b, rf=3, seed=seed, weighted=True, **kw))


# --- meshes ---------------------------------------------------------------


def test_balanced_factors():
    assert balanced_factors(8) == (2, 4)
    assert balanced_factors(16) == (4, 4)
    assert balanced_factors(7) == (1, 7)
    assert balanced_factors(1) == (1, 1)


def test_make_mesh_shapes():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"sweep": 2, "part": 4}
    assert len(mesh.part) == 4 and mesh.lead == torch.device("cpu")
    mesh = make_mesh(8, shape=(8, 1), devices=["cpu"] * 8)
    assert mesh.shape["sweep"] == 8 and len(mesh.axis_devices("sweep")) == 8
    with pytest.raises(ValueError):
        make_mesh(10**9, devices=["cpu"])
    with pytest.raises(ValueError):
        make_mesh(8, shape=(3, 2), devices=["cpu"] * 8)


def test_make_mesh_needs_a_card_unless_devices_are_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_put_and_replicate_put():
    mesh = cpu_mesh(4)
    a = np.arange(32).reshape(8, 4)
    parts = shard_put(a, mesh)
    assert [p.shape for p in parts] == [(2, 4)] * 4
    assert np.array_equal(torch.cat(parts).numpy(), a)
    with pytest.raises(ValueError, match="min_bucket"):
        shard_put(np.zeros((6, 2)), mesh)
    reps = replicate_put(np.arange(5), mesh)
    assert len(reps) == 4 and reps[0] is reps[3]  # one copy per device


# --- the sharded per-move scorer ------------------------------------------


def score_args(dp, loads):
    return (torch.from_numpy(loads), torch.from_numpy(dp.replicas),
            torch.from_numpy(dp.allowed), torch.from_numpy(dp.member),
            torch.from_numpy(dp.weights), torch.from_numpy(dp.nrep_cur),
            torch.from_numpy(dp.nrep_tgt), torch.from_numpy(dp.pvalid),
            torch.from_numpy(dp.bvalid), torch.tensor(float(dp.nb)), 2)


def dense_loads(dp, loads_map):
    loads = np.zeros(dp.bvalid.shape[0])
    for bid, load in loads_map.items():
        loads[dp.broker_index(bid)] = load
    return loads


def check_score(pl, cfg_j, leaders, S, jm):
    from kafkabalancer_tpu.ops import tensorize as jtensorize
    from kafkabalancer_tpu.parallel.shard_move import (
        sharded_score_moves as jscore,
    )
    from kafkabalancer_tpu.solvers.tpu import _oracle_loads
    from kafkabalancer_tpu_torch.solvers.tpu import score_moves

    jdp = jtensorize(pl, cfg_j, min_bucket=8)
    loads = dense_loads(jdp, _oracle_loads(pl, cfg_j))
    jargs = (jnp.asarray(loads), jnp.asarray(jdp.replicas),
             jnp.asarray(jdp.allowed), jnp.asarray(jdp.member),
             jnp.asarray(jdp.weights), jnp.asarray(jdp.nrep_cur),
             jnp.asarray(jdp.nrep_tgt), jnp.asarray(jdp.pvalid),
             jnp.asarray(jdp.bvalid), float(jdp.nb), 2)
    ju, ji, jsu, jperm = jscore(*jargs, leaders=leaders, mesh=jm)
    args = score_args(jdp, loads)
    u1, i1, su1, perm1 = sharded_score_moves(*args, leaders=leaders,
                                             mesh=cpu_mesh(S))
    u0, i0, su0, perm0 = score_moves(*args, leaders=leaders)
    assert bool(torch.isinf(u1)) == bool(torch.isinf(u0)) == bool(jnp.isinf(ju))
    if not bool(torch.isinf(u0)):
        assert float(u1) == float(u0) == float(ju)
        assert int(i1) == int(i0) == int(ji)
    assert float(su1) == float(su0) == float(jsu)
    assert np.array_equal(perm1.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("leaders", [False, True])
def test_sharded_score_matches_unsharded_and_reference(leaders):
    rng = random.Random(900 + leaders)
    cfg = jdefault()
    for _ in range(4):
        pl = random_partition_list(
            rng, rng.randint(4, 30), rng.randint(3, 9),
            weighted=bool(rng.getrandbits(1)), with_consumers=True,
            filled=True,
        )
        check_score(pl, cfg, leaders, 4, jmesh(8, shape=(2, 4)))


def test_sharded_tie_break_across_shards():
    """Mirror-image partitions in different shards tie exactly; the
    combine keeps the lowest global index, as the reference's does."""
    from test_balancer import P, wrap

    from kafkabalancer_tpu.balancer.steps import fill_defaults

    cfg = jdefault()
    parts = [P("a", 1, [1, 2], weight=2.0)]
    parts += [P("pad", i, [1, 2], weight=1.0) for i in range(2, 9)]
    parts += [P("z", 1, [1, 2], weight=2.0)]
    parts += [P("t", 1, [3, 4], weight=1.0), P("t", 2, [4, 3], weight=1.0)]
    pl = wrap(parts)
    fill_defaults(pl, cfg)
    check_score(pl, cfg, False, 8, jmesh(8, shape=(1, 8)))


# --- the combine's rules across shard boundaries ---------------------------


def pool(vals, p, slot, s_):
    return (torch.tensor(vals, dtype=torch.float64), torch.tensor(p),
            torch.tensor(slot), torch.tensor(s_))


def test_combine_negative_zero_ties_positive_zero_lower_row_wins():
    # column 0: -0.0 on the higher row; column 1: -0.0 on the lower row
    a = pool([0.0, -0.0], [3, 3], [1, 1], [7, 7])  # shard 0, rows 0..
    b = pool([-0.0, 0.0], [9, 9], [1, 1], [8, 8])  # shard 1
    v, p, slot, s_ = tss.gather_pool(cpu_mesh(2), [a, b])
    assert p.tolist() == [3, 3] and s_.tolist() == [7, 7]
    assert (v == 0).all()


def test_combine_nan_never_wins():
    a = pool([float("nan"), 1.0, float("nan")], [1, 1, 1], [1, 1, 1], [0, 0, 0])
    b = pool([5.0, float("nan"), float("nan")], [6, 6, 6], [1, 1, 1], [2, 2, 2])
    v, p, _slot, s_ = tss.gather_pool(cpu_mesh(2), [a, b])
    assert v[:2].tolist() == [5.0, 1.0] and p[:2].tolist() == [6, 1]
    # no finite value anywhere: the column is empty, shard 0's entry
    assert p[2] == 1 and s_[2] == 0


def test_combine_empty_column_is_shard_zero_row_zero():
    """An empty column is (+inf, row 0) on every shard, the rows shifted
    to each shard's base; the combined answer is the whole table's
    (+inf, 0) — shard 0's entry even where another shard's would rank
    first by (is_leader, row)."""
    inf = float("inf")
    a = pool([inf, inf], [0, 0], [0, 1], [4, 4])  # slot 0: a leader entry
    b = pool([inf, inf], [8, 8], [1, 1], [5, 5])
    v, p, slot, s_ = tss.gather_pool(cpu_mesh(2), [a, b])
    assert torch.isinf(v).all() and p.tolist() == [0, 0]
    assert slot.tolist() == [0, 1] and s_.tolist() == [4, 4]


def test_combine_follower_wins_a_tie_with_a_leader():
    a = pool([2.0], [1], [0], [3])  # leader, lower row
    b = pool([2.0], [9], [1], [4])  # follower
    _v, p, slot, _s = tss.gather_pool(cpu_mesh(2), [a, b])
    assert p.tolist() == [9] and slot.tolist() == [1]


@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("case", ["ties", "ties-leader", "padded", "colo"])
def test_sharded_pools_equal_the_whole_tables(S, case):
    """``rows_pool`` on each shard's rows, combined by ``gather_pool``,
    equals ``rows_pool`` on the whole table: equal weights make ties
    across shard boundaries, ``padded`` leaves the last shards all padding
    (columns empty there), ``colo`` switches on the colocation terms."""
    P, B = 48, 12
    n_real = 20 if case == "padded" else P
    args = torch_helpers.synthetic(
        P, B, "cpu", seed=S, n_real=n_real, equal_weights=case != "colo"
    )
    rep, cols, mem, allowed, loads, _F, bvalid, scal = args[:8]
    crows = args[11] if case == "colo" else None
    lam = scal[2] if case == "colo" else None
    nb = bvalid.sum().float()
    frame = tscan.pool_frame(loads, bvalid, nb)
    kw = dict(allow_leader=case != "ties", c_rows=None, lam=lam)
    whole = tscan.rows_pool(frame, loads, bvalid, rep, mem, allowed, cols,
                            scal[1], shard_kernel.shard_score_plain,
                            **{**kw, "c_rows": crows})
    n = P // S
    pools = []
    for i in range(S):
        rows = slice(i * n, (i + 1) * n)
        v, p, slot, s_ = tscan.rows_pool(
            frame, loads, bvalid, rep[rows], mem[rows], allowed[rows],
            cols[rows], scal[1], shard_kernel.shard_score_plain,
            **{**kw, "c_rows": None if crows is None else crows[rows]},
        )
        pools.append((v, p + i * n, slot, s_))
    got = tss.gather_pool(cpu_mesh(S), pools)
    assert torch.equal(got[0], whole[0])
    for a, b in zip(got[1:], whole[1:]):
        assert torch.equal(a, b)
    if case == "padded":
        assert torch.isinf(whole[0]).any()  # some column is empty


# --- the sharded session against the single-device one and the reference -


def check_plan(kind, n, b, seed, budget, S, batch, jS=8, allow_leader=False,
               single=True, jkw=None, **kw):
    pl_j, pl_t, pl_1 = both(kind, n, b, seed, **(jkw or {}))
    jc, tc = cfgs(allow_leader, min_unbalance=kw.pop("min_unbalance", 1e-7))
    opl_j = jplan_sharded(pl_j, jc, budget, jmesh(jS, shape=(1, jS)),
                          batch=batch, **kw)
    opl_t = tss.plan_sharded(pl_t, copy.deepcopy(tc), budget, cpu_mesh(S),
                             batch=batch, **kw)
    assert moves(opl_j), "the reference planned no move"
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)
    if single:
        kw.pop("scale", None)
        kw.pop("row_chunk", None)
        opl_1 = tscan.plan(pl_1, tc, budget, batch=batch, device="cpu", **kw)
        assert moves(opl_1) == moves(opl_t)
    return pl_t


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_sharded_session_matches_single_device(S, allow_leader):
    check_plan("plain", 500, 24, 31, 4000, S, 16, allow_leader=allow_leader)


@pytest.mark.parametrize("S", [3, 4])
def test_sharded_session_matches_single_device_restricted(S):
    check_plan("restricted", 200, 16, 91, 2000, S, 8)


def test_sharded_session_odd_mesh():
    check_plan("plain", 250, 18, 53, 1500, 6, 8, jS=6)


def test_sharded_session_chunk_reentry():
    """Chunks of 16 moves re-enter with the mutated assignment: the
    reference's chunked plan, move for move."""
    pl_j, pl_t = jsynth(120, 10, rf=2, seed=33), tsynth(120, 10, rf=2, seed=33)
    jc, tc = cfgs()
    opl_j = jplan_sharded(pl_j, jc, 200, jmesh(4, shape=(1, 4)), batch=8,
                          chunk_moves=16)
    opl_t = tss.plan_sharded(pl_t, tc, 200, cpu_mesh(4), batch=8,
                             chunk_moves=16)
    assert len(moves(opl_j)) > 16
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_sharded_polish_matches_reference():
    """The polish tail on the sharded sessions' move floor: the
    reference's plan, move for move, and a floor far below the move-only
    session's (tests/test_parallel.py's quality check)."""
    from kafkabalancer_tpu_torch.balancer.costmodel import (
        get_bl,
        get_broker_load,
        get_unbalance_bl,
    )

    def u(pl):
        return get_unbalance_bl(get_bl(get_broker_load(pl)))

    pl_t = check_plan("plain", 600, 24, 4242, 6000, 4, 16, allow_leader=True,
                      single=False, polish=True, min_unbalance=0.0)
    pl_m = tsynth(600, 24, rf=3, seed=4242, weighted=True)
    _, tc = cfgs(True, min_unbalance=0.0)
    tss.plan_sharded(pl_m, tc, 6000, cpu_mesh(4), batch=16)
    assert u(pl_t) < u(pl_m) / 10


@pytest.mark.parametrize("scale", [False, True])
def test_sharded_rebalance_leaders_hands_over(scale):
    """``rebalance_leaders`` runs ``plan``'s fused leader session (with
    ``scale``, after a warning): the reference's plan and the port's
    single-device plan."""
    import warnings

    pl_j, pl_t, pl_1 = both("plain", 200, 12, 77)
    jc, tc = cfgs(min_unbalance=1e-6, rebalance_leaders=True)
    opl_j = jplan_sharded(pl_j, copy.deepcopy(jc), 500, jmesh(8, shape=(1, 8)),
                          batch=4)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        opl_t = tss.plan_sharded(pl_t, copy.deepcopy(tc), 500, cpu_mesh(8),
                                 batch=4, scale=scale)
    assert any("single-device" in str(w.message) for w in seen) == scale
    opl_1 = tscan.plan(pl_1, tc, 500, batch=4, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j) == moves(opl_1)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("polish", [False, True])
def test_sharded_colocation_matches_reference(polish):
    """The combined objective sharded: the reference's sharded colocation
    plan, and (without polish, as the reference pins it) the port's
    single-device colocation plan."""
    check_plan("plain", 400, 16, 5, 20000, 8, 16, allow_leader=True,
               single=not polish, polish=polish, anti_colocation=0.001,
               min_unbalance=1e-9, jkw=dict(zipf_topics=True))


def colo_count(pl):
    import collections

    c = collections.Counter(
        (p.topic, b) for p in pl.iter_partitions() for b in p.replicas
    )
    return sum(v - 1 for v in c.values() if v > 1)


def test_plan_sharded_cfg_colocation_convention():
    """A cfg-derived penalty activates with every engine (no warning),
    deactivates at batch 1; an explicit penalty at batch 1 raises."""
    import warnings

    def fresh():
        pl = tsynth(400, 16, rf=3, seed=5, weighted=True, zipf_topics=True)
        _, tc = cfgs(min_unbalance=1e-9, anti_colocation=0.001)
        return pl, tc

    mesh = cpu_mesh(4)
    pl_a, cfg_a = fresh()
    c0 = colo_count(pl_a)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tss.plan_sharded(pl_a, cfg_a, 20000, mesh, batch=8,
                         engine="pallas-interpret")
    assert colo_count(pl_a) < c0
    pl_b, cfg_b = fresh()
    tss.plan_sharded(pl_b, cfg_b, 20000, mesh, batch=8)
    assert colo_count(pl_b) < c0
    pl_c, cfg_c = fresh()
    assert len(tss.plan_sharded(pl_c, cfg_c, 500, mesh, batch=1)) > 0
    pl_d, cfg_d = fresh()
    cfg_d.anti_colocation = 0.0
    with pytest.raises(ValueError, match="batch"):
        tss.plan_sharded(pl_d, cfg_d, 500, mesh, batch=1, anti_colocation=0.001)
    with pytest.raises(ValueError, match="unknown engine"):
        tss.plan_sharded(pl_d, cfg_d, 500, mesh, engine="tpu")


# --- float32, the plain scorer against the reference's kernel --------------


@pytest.mark.parametrize(
    "kind,allow_leader,colo",
    [("plain", False, False), ("plain", True, False),
     ("restricted", False, False), ("plain", True, True)],
)
def test_sharded_plan_f32_matches_reference_kernel(kind, allow_leader, colo):
    """``engine="pallas-interpret"`` on both sides at float32: the
    reference's Pallas shard kernel in interpret mode against the port's
    plain scorer, 8 shards each."""
    n, b, seed = (160, 16, 73) if kind == "restricted" else (300, 20, 47)
    kw = dict(anti_colocation=0.001) if colo else {}
    check_plan(kind, n, b, seed, 2000, 8, 16, allow_leader=allow_leader,
               single=False, engine="pallas-interpret",
               jkw=dict(zipf_topics=True) if colo else None, **kw)


# --- the scale tier -------------------------------------------------------


@pytest.mark.parametrize("seed", [211, 212, 213])
@pytest.mark.parametrize("kind", ["plain", "restricted"])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_shard_scale_matches_single_device(seed, kind, allow_leader):
    """Row chunks of 8 rows (many per shard), lean membership, the fine
    ladder: the reference's scale-tier plan and the port's ``plan``."""
    check_plan(kind, 160, 12, seed, 600, 8, 8, allow_leader=allow_leader,
               scale=True, row_chunk=8, min_unbalance=1e-9)


def test_shard_scale_row_chunk_invariant():
    def one(rc):
        pl = tsynth(300, 20, rf=3, seed=47, weighted=True)
        _, tc = cfgs(True)
        return moves(tss.plan_sharded(pl, tc, 1500, cpu_mesh(8), batch=16,
                                      scale=True, row_chunk=rc))

    base = one(0)
    assert base
    for rc in (8, 13, 64):
        assert one(rc) == base, rc


@pytest.mark.parametrize("kind", ["plain", "restricted"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_shard_scale_load_table_and_argmin_vs_oracle(seed, kind):
    """``sharded_session`` (lean membership, 4-row chunks) against
    ``scan.session`` and the reference's session: move logs and the broker
    loads bit for bit, the loads equal to the oracle's replay of the log,
    and the first move the oracle's ``scan_moves`` winner."""
    from kafkabalancer_tpu.solvers.scan import session as jsession
    from kafkabalancer_tpu_torch.balancer import costmodel
    from kafkabalancer_tpu_torch.balancer.steps import (
        fill_defaults,
        replay_broker_loads,
        scan_moves,
    )

    pl = (restricted(tsynth, 120, 10, seed) if kind == "restricted"
          else tsynth(120, 10, rf=3, seed=seed, weighted=True))
    _, cfg = cfgs(min_unbalance=1e-9)
    fill_defaults(pl, cfg)
    dp = tensorize(pl, cfg, min_bucket=64)
    B = dp.bvalid.shape[0]
    d = to_device(dp, "cpu", torch.float64)
    loads0 = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    always = torch.from_numpy(tscan._cfg_broker_mask(dp, cfg))
    common = (loads0, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
              d.nrep_tgt, d.ncons, d.pvalid, always, d.bvalid, 2, 1e-9, 12)
    out_1 = tscan.session(*common, max_moves=128, allow_leader=False, batch=8)
    out_s = tss.sharded_session(
        loads0, d.replicas, None, d.allowed, *common[4:],
        max_moves=128, allow_leader=False, batch=8, mesh=cpu_mesh(8),
        row_chunk=4,
    )
    jout = jsession(
        jnp.asarray(loads0.numpy()), jnp.asarray(dp.replicas),
        jnp.asarray(dp.member), jnp.asarray(dp.allowed),
        jnp.asarray(d.weights.numpy()), jnp.asarray(dp.nrep_cur),
        jnp.asarray(dp.nrep_tgt), jnp.asarray(d.ncons.numpy()),
        jnp.asarray(dp.pvalid), jnp.asarray(always.numpy()),
        jnp.asarray(dp.bvalid), jnp.int32(2), jnp.asarray(1e-9),
        jnp.int32(12), max_moves=128, allow_leader=False, batch=8,
    )
    ns = out_s[2]
    assert ns == out_1[2] == int(jout[2]) > 0
    for k in (3, 4, 5, 6):
        assert np.array_equal(out_s[k].numpy(), out_1[k].numpy()), k
        assert np.array_equal(out_s[k].numpy(), np.asarray(jout[k])), k
    assert out_s[1].numpy().tobytes() == out_1[1].numpy().tobytes()
    assert out_s[1].numpy().tobytes() == np.asarray(jout[1]).tobytes()
    assert np.array_equal(torch.cat(out_s[0]).numpy(), out_1[0].numpy())
    mp, mslot, msrc, mtgt = (out_s[k].numpy() for k in (3, 4, 5, 6))
    moves_ = []
    for i in range(ns):
        p, slot = int(mp[i]), int(mslot[i])
        delta = (dp.weights[p] * (dp.nrep_cur[p] + dp.ncons[p]) if slot == 0
                 else dp.weights[p])
        moves_.append((int(msrc[i]), int(mtgt[i]), delta))
    bl0 = [[b, float(loads0[b])] for b in range(B)]
    replayed = np.asarray([c[1] for c in replay_broker_loads(bl0, moves_)])
    assert np.array_equal(replayed, out_s[1].numpy())
    bl = costmodel.get_bl(costmodel.get_broker_load(pl))
    su = costmodel.get_unbalance_bl(bl)
    _cu, best, _pos = scan_moves(list(pl.iter_partitions()), bl, su, None, cfg,
                                 False)
    first = dp.partitions[int(mp[0])]
    assert (first.topic, first.partition) == (best[0].topic, best[0].partition)
    assert int(dp.broker_ids[int(msrc[0])]) == best[1]
    assert int(dp.broker_ids[int(mtgt[0])]) == best[2]


def test_shard_scale_100k_partition_parity():
    """A 100k-partition plan on 8 CPU shards — the fine ladder (100032
    rows, not 131072), lean membership, row chunks of 4096 — equals the
    reference's single-device plan and the port's."""
    def fresh(synth):
        pl = synth(100_000, 16, rf=2, seed=7, weighted=True)
        return pl

    jc, tc = cfgs()
    pl_s, pl_j, pl_1 = fresh(tsynth), fresh(jsynth), fresh(tsynth)
    opl_s = tss.plan_sharded(pl_s, copy.deepcopy(tc), 128, cpu_mesh(8),
                             batch=64, scale=True, row_chunk=4096)
    opl_j = jplan(pl_j, jc, 128, batch=64)
    opl_1 = tscan.plan(pl_1, tc, 128, batch=64, device="cpu")
    assert len(moves(opl_s)) == 128
    assert moves(opl_s) == moves(opl_j) == moves(opl_1)
    assert state(pl_s) == state(pl_j)


def test_shard_engine_failure_on_a_card_is_a_balance_error(monkeypatch):
    """A kernel failure on a shard of a CUDA mesh is a planning failure
    (CLI exit 3); on the CPU a fault in the session raises as it is."""
    from kafkabalancer_tpu_torch.balancer.steps import BalanceError

    def broken(*a, **k):
        raise RuntimeError("shard_score kernel launch failed: test")

    pl = tsynth(60, 8, rf=2, seed=5, weighted=True)
    _, tc = cfgs()
    with pytest.raises(RuntimeError, match="test"):
        tss.plan_sharded(copy.deepcopy(pl), tc, 50, cpu_mesh(2), batch=4,
                         scorer=broken)
    with pytest.raises(BalanceError, match="pallas-interpret shard engine failed"):
        tss.plan_sharded(copy.deepcopy(pl), tc, 50, cpu_mesh(2), batch=4,
                         engine="pallas-interpret", scorer=broken)


def test_mesh_type_is_the_ports_own():
    assert isinstance(cpu_mesh(2), Mesh)
    assert "sweep" in repr(cpu_mesh(2))
