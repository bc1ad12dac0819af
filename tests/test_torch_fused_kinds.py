"""The instance-batched sessions of the three request kinds a lane of the
port's daemon fuses besides the plain move session — the colocation
objective, ``-fused-batch=1`` and the polish alternation — held against
K solo sessions and the JAX package on the CPU with zero tolerance.

The pins:

- ``scan.session_batched`` in colocation mode (the scoring pass's
  colocation variant over the instance axis, one λ per instance) and at
  batch 1, over K distinct instances (one with budget 0, others with
  another ``min_unbalance`` or λ), equals K solo ``scan.session`` calls
  bit for bit at every occupancy 1..5, in float32 and float64;
- ``polish.converge_session_batched`` with and without ``allow_leader``,
  with and without colocation and at batch 1 equals K solo
  ``polish.converge_session`` calls the same way;
- each instance's solo log equals the JAX package's ``session_packed``
  log on the same instance, for each kind;
- each fused member's counters (``polish.*`` and the session's) are its
  own phases' counts, and the plans of fused members their solo plans.
"""

import contextlib
import functools
import io
import threading

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (torch CPU thread setting)

N_PARTS, N_BROKERS = 200, 12
MAX_MOVES = 512
# instance k: seed, budget, min_unbalance, lambda — one budget 0, other
# thresholds and penalties
INSTANCES = [
    (300, 400, 1e-7, 0.001),
    (301, 0, 0.01, 0.01),
    (302, 300, 1e-7, 0.004),
    (303, 9, 0.01, 0.001),
    (304, 400, 0.5, 0.002),
]
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
N_TOPICS = 64


def cluster_text(k):
    from kafkabalancer_tpu_torch.codecs import write_partition_list
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    out = io.StringIO()
    write_partition_list(out, synth_cluster(
        N_PARTS, N_BROKERS, rf=3, seed=INSTANCES[k][0], zipf_topics=True))
    return out.getvalue()


def settled(k, pkg, allow_leader=True):
    """Instance ``k`` read and settled by ``pkg``'s pipeline head:
    ``(DensePlan, cfg)``."""
    if pkg == "jax":
        from kafkabalancer_tpu.codecs import get_partition_list_from_reader
        from kafkabalancer_tpu.models import default_rebalance_config
        from kafkabalancer_tpu.ops.tensorize import tensorize
        from kafkabalancer_tpu.solvers import scan
    else:
        from kafkabalancer_tpu_torch.codecs import (
            get_partition_list_from_reader,
        )
        from kafkabalancer_tpu_torch.models import default_rebalance_config
        from kafkabalancer_tpu_torch.ops.tensorize import tensorize
        from kafkabalancer_tpu_torch.solvers import scan
    pl = get_partition_list_from_reader(io.StringIO(cluster_text(k)), True, [])
    cfg = default_rebalance_config()
    cfg.min_unbalance = INSTANCES[k][2]
    cfg.allow_leader_rebalancing = allow_leader
    scan._settle_head(pl, cfg, 10 ** 6)
    return tensorize(pl, cfg), cfg


@functools.lru_cache(maxsize=None)
def inputs(k, dtype, allow_leader=True):
    """Instance ``k``'s session tensors ``(11 tensors, topic_id, entry
    table)`` on the CPU."""
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.runtime import next_bucket
    from kafkabalancer_tpu_torch.ops.tensorize import all_allowed_of, to_device
    from kafkabalancer_tpu_torch.solvers import polish, scan

    dp, cfg = settled(k, "torch", allow_leader)
    assert next_bucket(max(1, len(dp.topics)), 64) == N_TOPICS
    d = to_device(dp, torch.device("cpu"), dtype,
                  all_allowed=all_allowed_of(dp))
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                         dp.bvalid.shape[0])
    always = torch.from_numpy(scan._cfg_broker_mask(dp, cfg))
    ew, ep, er, evalid = polish.entry_table(dp, 2)
    table = (torch.from_numpy(ew).to(dtype), torch.from_numpy(ep).long(),
             torch.from_numpy(er).long(), torch.from_numpy(evalid))
    return ((loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
             d.nrep_tgt, d.ncons, d.pvalid, always, d.bvalid),
            torch.from_numpy(dp.topic_id).long(), table)


def stacked(occupancy, dtype, allow_leader=True):
    ins = [inputs(k, dtype, allow_leader) for k in range(occupancy)]
    tensors = [None if ins[0][0][j] is None
               else torch.stack([x[0][j] for x in ins]) for j in range(11)]
    tid = torch.stack([x[1] for x in ins])
    table = [torch.stack([x[2][j] for x in ins]) for j in range(4)]
    return tensors, tid, table


def knobs(occupancy):
    return ([2] * occupancy, [INSTANCES[k][2] for k in range(occupancy)],
            [INSTANCES[k][1] for k in range(occupancy)],
            [INSTANCES[k][3] for k in range(occupancy)])


def colo_kw(k, colo):
    return (dict(topic_id=inputs(k, torch.float64)[1],
                 lam=INSTANCES[k][3], n_topics=N_TOPICS) if colo else {})


@functools.lru_cache(maxsize=None)
def solo_session(k, dtype, batch, colo, allow_leader=True):
    from kafkabalancer_tpu_torch.solvers import scan

    _seed, budget, mu, _lam = INSTANCES[k]
    _r, _l, n, mp, mslot, _ms, mtgt, _su = scan.session(
        *inputs(k, dtype, allow_leader)[0], 2, mu, budget,
        max_moves=MAX_MOVES, allow_leader=allow_leader, batch=batch,
        **colo_kw(k, colo),
    )
    return torch.cat([mp, mslot, mtgt, torch.tensor([n], dtype=torch.int32)])


@functools.lru_cache(maxsize=None)
def solo_polish(k, dtype, batch, colo, allow_leader):
    from kafkabalancer_tpu_torch.solvers import polish

    _seed, budget, mu, _lam = INSTANCES[k]
    t, _tid, table = inputs(k, dtype, allow_leader)
    return polish.converge_session(
        t[0], t[1], t[3], *t[4:11], 2, mu, budget, *table,
        max_moves=MAX_MOVES, allow_leader=allow_leader, batch=batch,
        **colo_kw(k, colo),
    )


# --- the move session: colocation and batch 1 -------------------------------

SESSION_KINDS = {"colocation": (8, True), "batch1": (1, False)}


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("occupancy", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", sorted(SESSION_KINDS))
def test_session_batched_kind_equals_solo_sessions(kind, occupancy, dtype):
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    batch, colo = SESSION_KINDS[kind]
    tensors, tid, _table = stacked(occupancy, dtype)
    min_rep, mus, budgets, lams = knobs(occupancy)
    kw = dict(topic_id=tid, lam=lams, n_topics=N_TOPICS) if colo else {}
    before = sk.shard_score_batched.launches
    packed, iters, secs = scan.session_batched(
        *tensors, min_rep, mus, budgets, max_moves=MAX_MOVES,
        allow_leader=True, batch=batch, **kw,
    )
    # on the CPU the batched scoring pass is its plain version: no launch
    assert sk.shard_score_batched.launches == before
    assert packed.shape == (occupancy, 3 * MAX_MOVES + 1)
    for k in range(occupancy):
        assert torch.equal(packed[k], solo_session(k, dtype, batch, colo)), k
    n = packed[:, -1].tolist()
    if occupancy > 1:
        assert n[1] == 0 and iters[1] == 0  # budget 0: no iteration
    assert n[0] > 0 and iters[0] > 0
    if batch == 1:
        # one move per iteration, and the budget ends instance 0's run
        assert n[0] == iters[0] == INSTANCES[0][1]
    assert all(s >= 0 for s in secs)


def test_colocation_batched_scorer_gets_each_instances_counts():
    """The scoring pass of the colocation mode gets each instance's own
    ``[P, B]`` counts rows and λ in column 2 of its scalars: the
    counts the solo session passes, stacked."""
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    seen = []

    def solo_scorer(*a, c_rows=None, **kw):
        if len(seen) < 3:
            seen.append(("solo", a[7].clone(), c_rows.clone()))
        return sk.shard_score_plain(*a, c_rows=c_rows, **kw)

    def batched_scorer(*a, c_rows=None, **kw):
        if not any(s[0] == "batched" for s in seen):
            seen.append(("batched", a[7].clone(), c_rows.clone()))
        return sk.shard_score_batched_plain(*a, c_rows=c_rows, **kw)

    for k in (0, 2):
        scan.session(*inputs(k, torch.float64)[0], 2, INSTANCES[k][2], 1,
                     max_moves=128, allow_leader=True, batch=8,
                     scorer=solo_scorer, **colo_kw(k, True))
    tensors, tid, _ = stacked(3, torch.float64)
    min_rep, mus, _b, lams = knobs(3)
    scan.session_batched(*tensors, min_rep, mus, [1, 0, 1], max_moves=128,
                         allow_leader=True, batch=8, topic_id=tid, lam=lams,
                         n_topics=N_TOPICS, scorer=batched_scorer)
    (_, s0, c0), (_, s2, c2), (_, sb, cb) = seen
    assert torch.equal(sb[0], s0) and torch.equal(sb[2], s2)
    assert torch.equal(cb[0], c0) and torch.equal(cb[2], c2)
    assert float(sb[1, 2]) == INSTANCES[1][3]


def test_session_batched_refuses_colocation_at_batch_1():
    from kafkabalancer_tpu_torch.solvers import scan

    tensors, tid, _ = stacked(2, torch.float64)
    min_rep, mus, budgets, lams = knobs(2)
    with pytest.raises(ValueError, match="batch > 1"):
        scan.session_batched(*tensors, min_rep, mus, budgets,
                             max_moves=MAX_MOVES, allow_leader=True, batch=1,
                             topic_id=tid, lam=lams, n_topics=N_TOPICS)


# --- the polish alternation ---------------------------------------------------

POLISH_KINDS = {
    "plain": (8, False, False),
    "leader": (8, False, True),
    "colocation": (8, True, False),
    "colocation-leader": (8, True, True),
    "batch1": (1, False, False),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("occupancy", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", sorted(POLISH_KINDS))
def test_converge_session_batched_equals_solo_alternations(
    kind, occupancy, dtype
):
    from kafkabalancer_tpu_torch.solvers import polish

    batch, colo, lead = POLISH_KINDS[kind]
    tensors, tid, table = stacked(occupancy, dtype, lead)
    min_rep, mus, budgets, lams = knobs(occupancy)
    kw = dict(topic_id=tid, lam=lams, n_topics=N_TOPICS) if colo else {}
    t = tensors
    packed, counters = polish.converge_session_batched(
        t[0], t[1], t[3], *t[4:11], min_rep, mus, budgets, *table,
        max_moves=MAX_MOVES, allow_leader=lead, batch=batch, **kw,
    )
    assert packed.shape == (occupancy, 3 * 2 * MAX_MOVES + 1)
    for k in range(occupancy):
        assert torch.equal(packed[k], solo_polish(k, dtype, batch, colo,
                                                  lead)), k
    assert int(packed[0, -1]) > 0
    assert counters[0]["polish.swap_phases"] >= 1
    if occupancy > 1:
        # budget 0: the alternation never starts
        assert int(packed[1, -1]) == 0 and counters[1] == {}
    assert (("polish.shuffle_phases" in counters[0]) is lead)


# --- each solo log against the JAX package -----------------------------------

REFERENCE_KINDS = {
    # kind: batch, polish, colocation
    "colocation": (8, False, True),
    "batch1": (1, False, False),
    "polish": (8, True, False),
    "polish-colocation": (8, True, True),
    "polish-batch1": (1, True, False),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=DT_IDS)
@pytest.mark.parametrize("kind", sorted(REFERENCE_KINDS))
def test_solo_logs_of_each_kind_equal_the_reference(kind, dtype):
    """The batched sessions' yardstick (each instance's solo session)
    against the JAX package's ``session_packed`` on the same instance."""
    from kafkabalancer_tpu.solvers import scan as jscan

    batch, pol, colo = REFERENCE_KINDS[kind]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for k in (0, 2, 3):
        _seed, budget, _mu, lam = INSTANCES[k]
        dp, cfg = settled(k, "jax", allow_leader=True)
        table = [None] * 4
        if pol:
            from kafkabalancer_tpu.solvers.polish import entry_table

            table = entry_table(dp, cfg.min_replicas_for_rebalancing)
        args, statics = jscan.packed_call(
            dp, cfg, budget, dtype, batch, "xla", pol, False,
            jscan.all_allowed_of(dp), 1.5, *table,
            tid=dp.topic_id if colo else None, lam=lam if colo else None,
            n_topics=N_TOPICS if colo else 0,
        )
        ref = np.asarray(jscan.session_packed(*args, **statics))
        got = (solo_polish(k, tdt, batch, colo, True) if pol
               else solo_session(k, tdt, batch, colo)).numpy()
        ml, mm = (got.shape[0] - 1) // 3, (ref.shape[0] - 1) // 3
        n = int(ref[-1])
        assert n > 0 and int(got[-1]) == n, (k, int(got[-1]), n)
        for row in range(3):
            assert np.array_equal(got[row * ml: row * ml + n],
                                  ref[row * mm: row * mm + n]), (k, row)


# --- fused members: plans and counters ----------------------------------------

PLAN_KINDS = {
    "polish": dict(batch=4, polish=True),
    "polish-leader": dict(batch=100, polish=True),
    "colocation": dict(batch=4, anti_colocation=0.001),
    "batch1": dict(batch=1),
}


def member_plans(kind, mb=None, counts=None):
    """Instances 0 and 2 planned with ``PLAN_KINDS[kind]`` on two member
    threads of ``mb`` (or one after another without a batcher);
    ``counts`` collects each thread's counters by member index."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers import scan

    kw = dict(PLAN_KINDS[kind])
    out = [None, None]
    who = {}
    lock = threading.Lock()
    real_count = obs.metrics.count

    def count(name, value=1.0):
        me = who.get(threading.get_ident())
        if counts is not None and me is not None and (
                name.startswith("polish.") or name.startswith("solver.")):
            with lock:
                counts[me][name] = counts[me].get(name, 0.0) + value
        return real_count(name, value)

    def member(i):
        who[threading.get_ident()] = i
        pl = get_partition_list_from_reader(
            io.StringIO(cluster_text((0, 2)[i])), True, [])
        cfg = default_rebalance_config()
        cfg.min_unbalance = 1e-7
        cfg.allow_leader_rebalancing = kind in ("polish-leader", "batch1")
        cfg.complete_partition = False
        ctx = mb.member() if mb is not None else contextlib.nullcontext()
        with ctx:
            opl = scan.plan(pl, cfg, 40 if kind == "batch1" else 10 ** 5,
                            device="cpu", **kw)
        text = io.StringIO()
        write_partition_list(text, opl)
        out[i] = text.getvalue()

    obs.metrics.count = count
    try:
        if mb is None:
            for i in range(2):
                t = threading.Thread(target=member, args=(i,))
                t.start()
                t.join(120)
        else:
            threads = [threading.Thread(target=member, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
    finally:
        obs.metrics.count = real_count
    return out


@pytest.mark.parametrize("kind", sorted(PLAN_KINDS))
def test_fused_members_plan_and_count_as_solo(kind):
    """Two members of one batcher, each of one kind: each plan is its
    solo plan, the batched session ran (one fused round or more), and
    each member's counters are its solo run's — the same phase and
    iteration counts, with the fused phases' seconds."""
    from kafkabalancer_tpu_torch.serve import lanes

    solo_counts = [{}, {}]
    solo = member_plans(kind, counts=solo_counts)
    fused_counts = [{}, {}]
    mb = lanes.MicrobatchGroup(2)
    fused = member_plans(kind, mb, fused_counts)
    assert fused == solo
    assert mb.fused_requests == 2 and mb.occupancy.get(2, 0) >= 1
    assert mb.padded_slots == 0
    for i in range(2):
        s, f = solo_counts[i], fused_counts[i]
        assert f.pop("solver.microbatched_chunks") >= 1
        timed = {n for n in s if n.endswith("_seconds")}
        assert timed == {n for n in f if n.endswith("_seconds")}, i
        assert all(f[n] >= 0 for n in timed)
        assert ({n: v for n, v in s.items() if n not in timed}
                == {n: v for n, v in f.items() if n not in timed}), i
        if kind.startswith("polish"):
            assert s["polish.move_phases"] >= 1
