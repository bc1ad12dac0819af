"""Cross-request batching in the port's daemon (serve/lanes.py) and the
instance-batched move session (solvers/scan.py ``session_batched``), held
against the JAX package on the CPU with zero tolerance.

The pins:

- ``session_batched`` over K distinct instances (one with budget 0, two
  with other ``min_unbalance``) equals K solo ``session`` calls bit for bit
  at every occupancy 1..5, in float32 and float64; the solo logs equal the
  JAX package's sessions on the same instances;
- the batched scoring pass's plain version equals K solo passes;
- the batchers, scenario by scenario through the JAX package's
  ``MicrobatchGroup`` / ``ContinuousBatcher`` and the port's: plans equal
  solo and equal across packages, the barrier's release, the declines,
  every occupancy, the ``solo_fast`` path, mid-session admission, the
  admission hold and the queue-head prefix; the port pads nothing;
- a failure of the batched session fails every member (no solo retry);
- a continuous wave is admitted before its members start;
- served: four concurrent same-bucket ``-fused`` clients of a daemon with
  ``-serve-microbatch=4 -serve-admission-hold=4``, in both batch modes,
  against the JAX daemon under the same flags: plans equal; one round of
  4 and no padded slot in the port; ``microbatched`` and ``mb_occupancy``
  equal the JAX daemon's in oneshot mode (its continuous loop can round
  a member alone, so there its counts only add up); each request's own
  gauges show its fusion; the polish, colocation and batch-1 requests
  (tests/test_torch_fused_kinds.py holds their batched sessions) fuse
  the same way, two clients at once, against the JAX daemon; declined
  requests (leader, pallas, ``-solver=tpu``, the chaos replay's) run solo
  with unchanged plans.
"""

import io
import json
import os
import shutil
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from torch_helpers import PkgDaemon, one_jax_device, package, run_pkg  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "test.json")
PKGS = ("jax", "torch")
HOLD_WINDOW_S = 30.0


def mods(name):
    """One package's batching surface: lanes, scan, the codecs, the
    default config, and the keyword arguments that put ``scan.plan`` on
    the CPU."""
    if name == "jax":
        from kafkabalancer_tpu.codecs import (
            get_partition_list_from_reader as read,
        )
        from kafkabalancer_tpu.codecs import write_partition_list as write
        from kafkabalancer_tpu.models import default_rebalance_config as cfg
        from kafkabalancer_tpu.serve import daemon, lanes
        from kafkabalancer_tpu.solvers import scan

        plan_kw = {}
    else:
        from kafkabalancer_tpu_torch.codecs import (
            get_partition_list_from_reader as read,
        )
        from kafkabalancer_tpu_torch.codecs import write_partition_list as write
        from kafkabalancer_tpu_torch.models import (
            default_rebalance_config as cfg,
        )
        from kafkabalancer_tpu_torch.serve import daemon, lanes
        from kafkabalancer_tpu_torch.solvers import scan

        plan_kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, lanes=lanes, scan=scan, read=read, write=write, cfg=cfg,
        daemon=daemon, plan_kw=plan_kw,
    )


def variant(m, i=None):
    """The fixture, optionally with partition ``i``'s first two replicas
    swapped — a DISTINCT instance in the same shape bucket."""
    with open(FIXTURE) as fh:
        pl = m.read(fh, True, [])
    if i is not None:
        p = pl.partitions[i % len(pl.partitions)]
        p.replicas[0], p.replicas[1] = p.replicas[1], p.replicas[0]
    return pl, m.cfg()


def emit(m, opl):
    out = io.StringIO()
    m.write(out, opl)
    return out.getvalue()


def plan_variant(m, i, reassign=4, **kw):
    pl, cfg = variant(m, i)
    return emit(m, m.scan.plan(pl, cfg, reassign, **m.plan_kw, **kw))


def run_members(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)


# --- the instance-batched session ---------------------------------------------

N_PARTS, N_BROKERS = 200, 12
MAX_MOVES = 512
# instance k: seed, budget, min_unbalance — one budget 0, two thresholds
INSTANCES = [
    (100, 400, 0.01),
    (101, 0, 0.01),
    (102, 300, 1e-7),
    (103, 7, 0.01),
    (104, 400, 0.5),
]


def session_inputs(k, dtype, pkg="torch"):
    """Instance ``k``'s settled cluster as the session's tensors (torch)
    or as the JAX package's DensePlan and config."""
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    m = mods(pkg)
    text = io.StringIO()
    mods("torch").write(
        text, synth_cluster(N_PARTS, N_BROKERS, rf=3, seed=INSTANCES[k][0])
    )
    pl = m.read(io.StringIO(text.getvalue()), True, [])
    cfg = m.cfg()
    cfg.min_unbalance = INSTANCES[k][2]
    cfg.allow_leader_rebalancing = True
    m.scan._settle_head(pl, cfg, 10 ** 6)
    if pkg == "jax":
        from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize

        return jtensorize(pl, cfg), cfg
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import (
        all_allowed_of,
        tensorize,
        to_device,
    )

    dp = tensorize(pl, cfg)
    d = to_device(dp, torch.device("cpu"), dtype,
                  all_allowed=all_allowed_of(dp))
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                         dp.bvalid.shape[0])
    always = torch.from_numpy(m.scan._cfg_broker_mask(dp, cfg))
    return (loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
            d.nrep_tgt, d.ncons, d.pvalid, always, d.bvalid)


def solo_packed(k, dtype):
    from kafkabalancer_tpu_torch.solvers import scan

    _seed, budget, mu = INSTANCES[k]
    _r, _l, n, mp, mslot, _ms, mtgt, _su = scan.session(
        *session_inputs(k, dtype), 2, mu, budget, max_moves=MAX_MOVES,
        allow_leader=True, batch=8,
    )
    return torch.cat([mp, mslot, mtgt, torch.tensor([n], dtype=torch.int32)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("occupancy", [1, 2, 3, 4, 5])
def test_session_batched_equals_solo_sessions(occupancy, dtype):
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    ins = [session_inputs(k, dtype) for k in range(occupancy)]
    stacked = [None if ins[0][j] is None
               else torch.stack([x[j] for x in ins]) for j in range(11)]
    before = sk.shard_score_batched.launches
    packed, iters, secs = scan.session_batched(
        *stacked, [2] * occupancy, [INSTANCES[k][2] for k in range(occupancy)],
        [INSTANCES[k][1] for k in range(occupancy)], max_moves=MAX_MOVES,
        allow_leader=True, batch=8,
    )
    # on the CPU the batched scoring pass is its plain version: no launch
    assert sk.shard_score_batched.launches == before
    assert packed.shape == (occupancy, 3 * MAX_MOVES + 1)
    assert packed.dtype == torch.int32
    for k in range(occupancy):
        want = solo_packed(k, dtype)
        assert torch.equal(packed[k], want), k
    n = packed[:, -1].tolist()
    if occupancy > 1:
        assert n[1] == 0 and iters[1] == 0  # budget 0: no iteration
    assert n[0] > 0 and iters[0] > 0
    assert all(s >= 0 for s in secs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_solo_logs_of_the_instances_equal_the_reference(dtype):
    """The batched session's yardstick (the solo session on each
    instance) against the JAX package's session on the same instance."""
    from kafkabalancer_tpu.solvers import scan as jscan

    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for k in (0, 2, 3):
        _seed, budget, _mu = INSTANCES[k]
        dp, cfg = session_inputs(k, None, pkg="jax")
        args, statics = jscan.packed_call(
            dp, cfg, budget, dtype, 8, "xla", False, False,
            jscan.all_allowed_of(dp), 1.5,
        )
        ref = np.asarray(jscan.session_packed(*args, **statics))
        mm = (ref.shape[0] - 1) // 3
        n = int(ref[-1])
        got = solo_packed(k, tdt).numpy()
        assert int(got[-1]) == n, k
        for row in range(3):
            assert np.array_equal(got[row * MAX_MOVES: row * MAX_MOVES + n],
                                  ref[row * mm: row * mm + n]), (k, row)


def test_batched_scoring_plain_equals_solo_passes():
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from torch_helpers import synthetic

    per = [synthetic(64, 16, "cpu", seed) for seed in (1, 2, 3)]
    for colo in (False, True):
        for restricted in (False, True):
            args = [[a[0], a[1], a[2], a[3] if restricted else None, *a[4:11],
                     a[11] if colo else None] for a in per]
            stacked = [None if args[0][j] is None
                       else torch.stack([x[j] for x in args])
                       for j in range(12)]
            for lead in (False, True):
                outs = sk.shard_score_batched(*stacked[:11],
                                              c_rows=stacked[11],
                                              allow_leader=lead)
                for k, a in enumerate(args):
                    solo = sk.shard_score(*a[:11], c_rows=a[11],
                                          allow_leader=lead)
                    for x, y in zip(outs, solo):
                        assert torch.equal(x[k], y)


# --- the batchers, scenario by scenario through both packages ----------------


@pytest.mark.parametrize("pkg", PKGS)
def test_microbatch_group_differential_parity(pkg):
    """Two distinct same-bucket instances through the one-shot barrier:
    byte-identical to their solo plans, and the port's to the JAX
    package's."""
    from kafkabalancer_tpu_torch import obs as tobs

    m = mods(pkg)
    reg = tobs.REGISTRY if pkg == "torch" else None

    def counts():
        return (None if reg is None else
                (reg.counter_get("solver.session_iterations"),
                 reg.counter_get("solver.microbatched_chunks")))

    c0 = counts()
    solo = [plan_variant(m, i, batch=4) for i in (None, 0)]
    c1 = counts()
    mb = m.lanes.MicrobatchGroup(2)
    fused = [None, None]

    def member(idx):
        pl, cfg = variant(m, (None, 0)[idx])
        with mb.member():
            fused[idx] = emit(m, m.scan.plan(pl, cfg, 4, batch=4,
                                             **m.plan_kw))

    run_members(member, 2)
    assert fused == solo
    assert mb.fused_requests == 2 and mb.fused_dispatches >= 1
    if pkg == "torch":
        # each member counts its own session's iterations, as solo
        c2 = counts()
        assert c2[0] - c1[0] == c1[0] - c0[0] > 0
        assert c2[1] - c1[1] == 2 and c1[1] == c0[1]
        assert fused == [plan_variant(mods("jax"), i, batch=4)
                         for i in (None, 0)]
        assert mb.padded_slots == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_microbatch_member_leaving_releases_the_barrier(pkg):
    m = mods(pkg)
    mb = m.lanes.MicrobatchGroup(2)
    out = []
    statics = ({"engine": "xla", "leader": False} if pkg == "jax" else
               {"engine": "xla", "mode": "move", "batch": 4, "n_topics": 0})

    def member(idx):
        with mb.member():
            if idx == 0:
                time.sleep(0.1)  # never dispatches
            else:
                out.append(mb.dispatch((None,), dict(statics)))

    run_members(member, 2)
    assert out == [None]  # solo fallback, no deadlock


# the reference declines the kernel engines and the leader session; so
# does the port, and a custom scorer (which only a check passes)
DECLINES = [
    ("pallas", {"engine": "pallas", "leader": False},
     {"engine": "pallas", "mode": "move", "batch": 4, "n_topics": 0}),
    ("leader", {"engine": "xla", "leader": True},
     {"engine": "xla", "mode": "leader", "batch": 4, "n_topics": 0}),
    ("scorer", None,
     {"engine": "xla", "mode": "move", "batch": 4, "n_topics": 0,
      "scorer": True}),
]


@pytest.mark.parametrize("what,jstatics,tstatics", DECLINES,
                         ids=[d[0] for d in DECLINES])
def test_microbatch_declines(what, jstatics, tstatics):
    if jstatics is not None:
        jmb = mods("jax").lanes.MicrobatchGroup(1)
        assert jmb.dispatch((None,), jstatics) is None
    tmb = mods("torch").lanes.MicrobatchGroup(1)
    assert tmb.dispatch((None,), tstatics) is None
    assert tmb.fused_dispatches == 0 and not tmb._pending


@pytest.mark.parametrize("pkg", PKGS)
def test_continuous_batcher_every_occupancy(pkg):
    """At every occupancy 1..4 each member's plan through the continuous
    batcher is its solo plan; the occupancy histograms of the two packages
    agree; the port pads nothing (the reference pads 3 into 4)."""
    m = mods(pkg)
    K = 4
    solo = [plan_variant(m, v if v else None, batch=4) for v in range(K)]
    record = {}
    for n in range(1, K + 1):
        cb = m.lanes.ContinuousBatcher(K)
        fused = [None] * n

        def member(idx):
            pl, cfg = variant(m, idx if idx else None)
            with cb.member():
                fused[idx] = emit(m, m.scan.plan(pl, cfg, 4, batch=4,
                                                 **m.plan_kw))

        for _ in range(n):
            cb.admit()
        run_members(member, n)
        assert fused == solo[:n], n
        record[n] = (cb.fused_dispatches, dict(cb.occupancy))
        if n == 1:
            assert cb.fused_dispatches == 0
        else:
            assert cb.occupancy.get(n) == 1, (n, cb.occupancy)
        if pkg == "torch":
            assert cb.padded_slots == 0
    if pkg == "torch":
        jsolo = [plan_variant(mods("jax"), v if v else None, batch=4)
                 for v in range(K)]
        assert solo == jsolo
        assert record == {1: (0, {}), 2: (1, {2: 1}), 3: (1, {3: 1}),
                          4: (1, {4: 1})}


@pytest.mark.parametrize("pkg", PKGS)
def test_continuous_batcher_solo_fast_path_counter(pkg):
    m = mods(pkg)
    want = plan_variant(m, None, batch=4)
    cb = m.lanes.ContinuousBatcher(4)
    for _ in range(3):
        cb.admit()
        with cb.member():
            pl, cfg = variant(m, None)
            got = emit(m, m.scan.plan(pl, cfg, 4, batch=4, **m.plan_kw))
        assert got == want
    assert cb.solo_fast >= 3
    assert cb.fused_dispatches == 0 and cb.padded_slots == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_continuous_batcher_mid_session_admission(pkg):
    """Member B is admitted after member A's chunk-1 round (A runs two
    chunks), so B's chunk 1 fuses with A's chunk 2; both plans stay
    their solo plans."""
    m = mods(pkg)
    solo_a = plan_variant(m, None, reassign=6, batch=4, chunk_moves=2)
    solo_b = plan_variant(m, 1, reassign=2, batch=4, chunk_moves=2)

    class FirstOfferSignal(m.lanes.ContinuousBatcher):
        def __init__(self, max_k):
            super().__init__(max_k)
            self.first_offer_done = threading.Event()
            self.b_admitted = threading.Event()

        def dispatch(self, args, statics):
            out = super().dispatch(args, statics)
            if not self.first_offer_done.is_set():
                self.first_offer_done.set()
                # A's chunk 2 is offered only once B is admitted: on a
                # loaded machine A could otherwise offer it alone first
                # (and, with its last chunk, leave before B joins)
                assert self.b_admitted.wait(60)
            return out

    cb = FirstOfferSignal(4)
    fused = [None, None]

    def run(idx, i, reassign):
        pl, cfg = variant(m, i)
        with cb.member():
            fused[idx] = emit(m, m.scan.plan(pl, cfg, reassign, batch=4,
                                             chunk_moves=2, **m.plan_kw))

    ta = threading.Thread(target=run, args=(0, None, 6))
    cb.admit()
    ta.start()
    assert cb.first_offer_done.wait(60), "A never offered chunk 1"
    tb = threading.Thread(target=run, args=(1, 1, 2))
    cb.admit()
    cb.b_admitted.set()
    tb.start()
    ta.join(120)
    tb.join(120)
    assert fused == [solo_a, solo_b]
    assert cb.fused_dispatches >= 1
    assert cb.occupancy.get(2, 0) >= 1, cb.occupancy
    if pkg == "torch":
        jm = mods("jax")
        assert fused == [
            plan_variant(jm, None, reassign=6, batch=4, chunk_moves=2),
            plan_variant(jm, 1, reassign=2, batch=4, chunk_moves=2),
        ]


def test_batchers_under_thread_switch_stress():
    """More members than cores, with the interpreter switching threads
    every few microseconds, through both batchers three times: every
    member's plan is its solo plan and the fused counts add up (a lost
    update of the barrier's state would break either)."""
    import sys

    m = mods("torch")
    n = max(9, (os.cpu_count() or 8) + 1)
    solo = [plan_variant(m, i % 4 if i % 4 else None, batch=4)
            for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for rnd in range(3):
            for make in (lambda: m.lanes.MicrobatchGroup(n),
                         lambda: m.lanes.ContinuousBatcher(n)):
                mb = make()
                if isinstance(mb, m.lanes.ContinuousBatcher):
                    for _ in range(n):
                        mb.admit()
                got = [None] * n

                def member(i, mb=mb, got=got):
                    pl, cfg = variant(m, i % 4 if i % 4 else None)
                    with mb.member():
                        got[i] = emit(m, m.scan.plan(pl, cfg, 4, batch=4,
                                                     **m.plan_kw))

                run_members(member, n)
                assert got == solo, rnd
                assert mb.fused_requests == n and mb.fused_dispatches == 1
                assert mb.occupancy == {n: 1} and mb.padded_slots == 0
    finally:
        sys.setswitchinterval(old)


def test_fused_session_failure_fails_every_member(monkeypatch):
    """An exception of the batched session is raised in every member's
    chunk (their plans fail as a solo kernel failure fails one); nothing
    is retried solo."""
    m = mods("torch")
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("batched launch failed")

    monkeypatch.setattr(m.scan, "session_batched", broken)
    mb = m.lanes.MicrobatchGroup(2)
    errors = [None, None]
    solo_runs = []
    real_session = m.scan.session
    monkeypatch.setattr(
        m.scan, "session",
        lambda *a, **kw: solo_runs.append(1) or real_session(*a, **kw),
    )

    def member(idx):
        pl, cfg = variant(m, (None, 0)[idx])
        with mb.member():
            try:
                m.scan.plan(pl, cfg, 4, batch=4, **m.plan_kw)
            except RuntimeError as exc:
                errors[idx] = str(exc)

    run_members(member, 2)
    assert calls == [1]
    assert solo_runs == []
    assert all(e is not None and "batched launch failed" in e
               for e in errors), errors
    assert mb.fused_dispatches == 0 and mb.occupancy == {}


# --- the scheduler: admission hold and the queue-head prefix ------------------


def mk_req(m, name, bucket=None):
    req = m.daemon.PlanRequest([name], None)
    req.bucket = bucket
    req.bucketed = True
    return req


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_hold_forms_full_batch(pkg):
    m = mods(pkg)
    handled = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb):
        with lock:
            handled.append((req.argv[0], mb is not None))
        req.response = {"ok": True}

    B = (8, 2, 4, True)
    sched = m.lanes.LaneScheduler(
        handle, lambda r: B, [m.lanes.Lane(0)], microbatch=4,
        admissible=lambda r: True, admission_hold=2,
    )
    sched._hold_window_s = 20.0
    try:
        results = []

        def submit(name):
            results.append(sched.submit(mk_req(m, name, B)))

        t1 = threading.Thread(target=submit, args=("r1",))
        t1.start()
        time.sleep(0.4)
        assert handled == [], handled  # held: r1 still queued
        t2 = threading.Thread(target=submit, args=("r2",))
        t2.start()
        t1.join(20)
        t2.join(20)
        assert len(results) == 2 and all(r["ok"] for r in results)
        assert {n for n, _ in handled} == {"r1", "r2"}
        assert all(got_mb for _n, got_mb in handled), handled
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_hold_counts_only_batchable_requests(pkg):
    m = mods(pkg)
    handled = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb):
        with lock:
            handled.append(req.argv[0])
        req.response = {"ok": True}

    B = (8, 2, 4, True)
    sched = m.lanes.LaneScheduler(
        handle, lambda r: B, [m.lanes.Lane(0)], microbatch=4,
        admissible=lambda r: not r.argv[0].startswith("greedy"),
        admission_hold=2,
    )
    sched._hold_window_s = 20.0
    try:
        results = []

        def submit(name):
            results.append(sched.submit(mk_req(m, name, B)))

        threads = [threading.Thread(target=submit, args=("fused-1",))]
        threads[0].start()
        time.sleep(0.15)
        threads.append(threading.Thread(target=submit, args=("greedy-x",)))
        threads[1].start()
        time.sleep(0.4)
        assert handled == [], handled  # one batchable of two: held
        threads.append(threading.Thread(target=submit, args=("fused-2",)))
        threads[2].start()
        for t in threads:
            t.join(25)
        assert len(results) == 3 and all(r["ok"] for r in results)
        assert set(handled) == {"fused-1", "greedy-x", "fused-2"}
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_continuous_pull_is_queue_head_prefix_only(pkg):
    m = mods(pkg)
    B = (8, 2, 4, True)
    sched = m.lanes.LaneScheduler(
        lambda req, c, ln, mb: None, lambda r: r.bucket, [m.lanes.Lane(0)],
        microbatch=4,
        admissible=lambda r: not r.argv[0].startswith("greedy"),
    )
    try:
        lane = sched.lanes[0]
        a, g, b = (mk_req(m, n, B) for n in ("fused-a", "greedy-x", "fused-b"))
        with sched._cv:
            sched._stop = True
        sched._queues[0].extend([a, g, b])
        assert sched._pull_admissible(lane, B) == []  # _stop gates it
        sched._stop = False
        pulled = sched._pull_admissible(lane, B)
        assert [r.argv[0] for r in pulled] == ["fused-a"]
        assert [r.argv[0] for r in sched._queues[0]] == ["greedy-x",
                                                         "fused-b"]
        with sched._cv:
            sched._active[0] -= len(pulled)
            sched._queues[0].clear()
    finally:
        sched.stop()


def test_continuous_wave_is_admitted_before_it_starts():
    """Every member of a held wave finds the whole wave admitted when its
    thread starts, so no round can fire without a peer of its wave (the
    reference admits and starts one member at a time, and its first
    member can round alone)."""
    import sys

    m = mods("torch")
    seen = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb):
        if mb is None:
            with lock:
                seen.append(None)
        else:
            with mb.member(req):
                with lock:
                    seen.append(mb._live)
        req.response = {"ok": True}

    B = (8, 2, 4, True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    sched = m.lanes.LaneScheduler(
        handle, lambda r: B, [m.lanes.Lane(0)], microbatch=4,
        admissible=lambda r: True, admission_hold=4,
    )
    sched._hold_window_s = 30.0
    try:
        for rnd in range(20):
            seen.clear()
            results = []
            threads = [
                threading.Thread(target=lambda i=i: results.append(
                    sched.submit(mk_req(m, f"r{rnd}-{i}", B))))
                for i in range(4)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert len(results) == 4 and all(r["ok"] for r in results)
            assert seen[0] == 4 and all(v is not None for v in seen), seen
            deadline = time.monotonic() + 10
            while sched.busy():  # the next wave starts from an idle lane
                assert time.monotonic() < deadline
                time.sleep(0.005)
    finally:
        sys.setswitchinterval(old)
        sched.stop()


def test_scheduler_stats_carry_the_batching_keys():
    m = mods("torch")
    sched = m.lanes.LaneScheduler(
        lambda req, coalesced, lane, mb: None, lambda r: None,
        [m.lanes.Lane(0)],
    )
    try:
        st = sched.stats()
        for key in ("microbatched", "padded_slots", "solo_fast",
                    "occupancy_max"):
            assert st[key] == 0.0, key
        sched._note_fused(3, 0)
        sched._note_fused(2, 0)
        st = sched.stats()
        assert st["microbatched"] == 5.0 and st["occupancy_max"] == 3.0
        assert sched.occupancy_hist() == {"2": 1, "3": 1}
    finally:
        sched.stop()


# --- the admission prediction -------------------------------------------------

ADMISSION = [
    # (argv, the reference's verdict, the port's)
    (["-fused=true"], True, True),
    (["-fused=true", "-fused-batch=100"], True, True),
    (["-fused=true", "-rebalance-leader=true"], False, False),
    (["-fused=true", "-fused-engine=pallas"], False, False),
    (["-fused=true", "-fused-shard=true"], False, False),
    (["-fused=true", "-fused-polish=true"], True, True),
    (["-fused=true", "-anti-colocation=0.001"], True, True),
    (["-fused=true", "-fused-batch=1"], True, True),
    (["-solver=tpu"], False, False),
    ([], False, False),
]


@pytest.mark.parametrize("argv,jwant,twant", ADMISSION,
                         ids=[" ".join(a[0]) or "greedy" for a in ADMISSION])
def test_admissible_request(argv, jwant, twant):
    for pkg, want in (("jax", jwant), ("torch", twant)):
        m = mods(pkg)
        req = m.daemon.PlanRequest(list(argv), None)
        assert m.daemon.Daemon._admissible_request(req) is want, pkg
        req.internal = "spec"  # internal work is never admissible
        assert m.daemon.Daemon._admissible_request(req) is False, pkg


# --- served, against the JAX daemon -------------------------------------------


def variant_files(d, n):
    paths = []
    m = mods("torch")
    for i in range(n):
        pl, _cfg = variant(m, i if i else None)
        p = os.path.join(d, f"v{i}.json")
        with open(p, "w") as fh:
            m.write(fh, pl)
        paths.append(p)
    return paths


FUSED = ["-input-json", "-fused", "-fused-batch=4", "-max-reassign=4"]


def served_round(pkg, daemon_kw, paths, extra=(), base=FUSED):
    """Four (or len(paths)) concurrent clients of ``pkg``'s daemon with
    ``daemon_kw``, each with the flags ``base`` and ``extra``; returns
    (results, stats doc)."""
    p = package(pkg)
    sock_dir = tempfile.mkdtemp(prefix="kbb-")
    d = PkgDaemon(p, os.path.join(sock_dir, "kb.sock"), lanes=0,
                  **daemon_kw)
    try:
        daemon = d.start()
        daemon._coalescer._hold_window_s = HOLD_WINDOW_S
        sock = d.sock
        results = [None] * len(paths)

        def client(i):
            results[i] = run_pkg(p, list(base) + [f"-input={paths[i]}",
                                                  f"-serve-socket={sock}",
                                                  *extra])

        run_members(client, len(paths))
        doc = p.client.fetch_stats(sock)
    finally:
        d.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    return results, doc


@pytest.mark.parametrize("mode", ["continuous", "oneshot"])
def test_served_four_concurrent_clients_fuse_like_the_reference(
    mode, one_jax_device
):
    d = tempfile.mkdtemp(prefix="kbb-")
    try:
        paths = variant_files(d, 4)
        want = [run_pkg(package("torch"), FUSED + [f"-input={p}",
                                                   "-no-daemon"])
                for p in paths]
        kw = dict(microbatch=4, admission_hold=4, batch_mode=mode)
        got = {pkg: served_round(pkg, kw, paths) for pkg in PKGS}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (jres, jdoc), (tres, tdoc) = got["jax"], got["torch"]
    assert [r[:2] for r in tres] == [w[:2] for w in want]
    assert [r[:2] for r in tres] == [r[:2] for r in jres]
    assert tdoc["microbatched"] == 4 and tdoc["mb_occupancy"] == {"4": 1}
    assert tdoc["mb_padded_slots"] == 0
    assert tdoc["batch_mode"] == jdoc["batch_mode"] == mode
    if mode == "oneshot":
        assert jdoc["microbatched"] == 4 and jdoc["mb_occupancy"] == {"4": 1}
    else:
        # the reference's continuous drain loop admits and starts its
        # members one at a time, so a member that reaches its offer
        # before its peers are admitted rounds without them; its counts
        # only add up
        occ = {int(k): v for k, v in jdoc["mb_occupancy"].items()}
        assert jdoc["microbatched"] == sum(k * v for k, v in occ.items())
        assert 2 <= jdoc["microbatched"] <= 4


@pytest.mark.parametrize("mode", ["continuous", "oneshot"])
def test_request_gauges_show_own_fusion(mode, one_jax_device):
    """Each member's -metrics-json line, re-snapshotted at export, shows
    the fusion it rode — in both packages in oneshot mode, in the port's
    in continuous mode too (the reference's continuous loop can start
    its first member before the second is admitted, and that member then
    runs solo)."""
    d = tempfile.mkdtemp(prefix="kbb-")
    try:
        paths = variant_files(d, 2)
        lines = {}
        for pkg in (PKGS if mode == "oneshot" else ("torch",)):
            p = package(pkg)
            dd = PkgDaemon(p, os.path.join(d, f"{pkg}.sock"), lanes=0,
                           microbatch=4, admission_hold=2, batch_mode=mode)
            try:
                daemon = dd.start()
                daemon._coalescer._hold_window_s = HOLD_WINDOW_S
                out = [None, None]

                def client(i):
                    mpath = os.path.join(d, f"{pkg}-{i}.json")
                    rc = run_pkg(p, FUSED + [f"-input={paths[i]}",
                                             f"-serve-socket={dd.sock}",
                                             f"-metrics-json={mpath}"])[0]
                    with open(mpath) as fh:
                        out[i] = (rc, json.load(fh)["gauges"])

                run_members(client, 2)
                lines[pkg] = out
            finally:
                dd.stop()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for pkg in lines:
        for rc, g in lines[pkg]:
            assert rc == 0 and g["served"] is True
            assert g["serve.mb_occupancy_max"] == 2.0, (pkg, g)
            assert g["serve.mb_padded_slots"] == 0.0, (pkg, g)


def test_fused_members_explain_their_own_plans():
    """-explain of two members of one fused round: each document is the
    member's own (its moves, rounds and stop reason), equal to its
    -no-daemon document but for the timestamp."""
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbb-")

    def doc_of(out):
        lines = out.splitlines()
        doc = json.loads(lines[1])
        doc.pop("ts_epoch")
        return lines[0], doc

    try:
        paths = variant_files(d, 2)
        flags = FUSED + ["-explain=-"]
        want = [doc_of(run_pkg(p, flags + [f"-input={x}", "-no-daemon"])[1])
                for x in paths]
        assert want[0] != want[1]
        dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0,
                       microbatch=2, admission_hold=2)
        try:
            daemon = dd.start()
            daemon._coalescer._hold_window_s = HOLD_WINDOW_S
            got = [None, None]

            def client(i):
                got[i] = run_pkg(p, flags + [f"-input={paths[i]}",
                                             f"-serve-socket={dd.sock}"])

            run_members(client, 2)
            doc = p.client.fetch_stats(dd.sock)
        finally:
            dd.stop()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert doc["microbatched"] == 2
    assert [doc_of(g[1]) for g in got] == want


# the three kinds the port's lanes fuse besides the plain move session,
# as the reference's do
FUSED_KINDS = {
    "polish": ["-input-json", "-fused", "-fused-polish", "-fused-batch=4",
               "-max-reassign=4"],
    "colocation": ["-input-json", "-fused", "-fused-batch=4",
                   "-anti-colocation=0.001", "-max-reassign=4"],
    "batch1": ["-input-json", "-fused", "-fused-batch=1",
               "-complete-partition=false", "-max-reassign=4"],
}


@pytest.mark.parametrize("mode", ["continuous", "oneshot"])
@pytest.mark.parametrize("kind", sorted(FUSED_KINDS))
def test_served_kinds_fuse_like_the_reference(kind, mode, one_jax_device):
    """Two concurrent clients of one kind, against the JAX daemon under
    the same flags: each plan is its -no-daemon plan and the JAX
    daemon's; the port fuses both in one round; ``microbatched`` and
    ``mb_occupancy`` equal the JAX daemon's in oneshot mode (in
    continuous mode its loop can round a member alone: its counts only
    add up)."""
    d = tempfile.mkdtemp(prefix="kbb-")
    try:
        paths = variant_files(d, 2)
        base = FUSED_KINDS[kind]
        want = [run_pkg(package("torch"), base + [f"-input={p}",
                                                  "-no-daemon"])
                for p in paths]
        kw = dict(microbatch=4, admission_hold=2, batch_mode=mode)
        got = {pkg: served_round(pkg, kw, paths, base=base) for pkg in PKGS}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (jres, jdoc), (tres, tdoc) = got["jax"], got["torch"]
    assert all(w[0] == 0 for w in want)
    assert [r[:2] for r in tres] == [w[:2] for w in want]
    assert [r[:2] for r in tres] == [r[:2] for r in jres]
    assert tdoc["microbatched"] == 2 and tdoc["mb_occupancy"] == {"2": 1}
    assert tdoc["mb_padded_slots"] == 0
    if mode == "oneshot":
        assert jdoc["microbatched"] == tdoc["microbatched"]
        assert jdoc["mb_occupancy"] == tdoc["mb_occupancy"]
    else:
        occ = {int(k): v for k, v in jdoc["mb_occupancy"].items()}
        assert jdoc["microbatched"] == sum(k * v for k, v in occ.items())
        assert jdoc["microbatched"] <= 2


# every declined kind, two concurrent clients each, in both modes: solo
DECLINED = {
    "leader": ["-fused", "-rebalance-leader", "-complete-partition=false",
               "-max-reassign=4"],
    "pallas": ["-fused", "-fused-engine=pallas", "-fused-batch=4",
               "-max-reassign=4"],
    "solver-tpu": ["-solver=tpu", "-max-reassign=2"],
}


@pytest.mark.parametrize("mode", ["continuous", "oneshot"])
@pytest.mark.parametrize("kind", sorted(DECLINED))
def test_declined_requests_run_solo(kind, mode):
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbb-")
    try:
        paths = variant_files(d, 2)
        flags = ["-input-json"] + DECLINED[kind]
        want = [run_pkg(p, flags + [f"-input={x}", "-no-daemon"])
                for x in paths]
        dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0,
                       microbatch=4, batch_mode=mode)
        try:
            daemon = dd.start()
            got = [None, None]

            def client(i):
                got[i] = run_pkg(p, flags + [f"-input={paths[i]}",
                                             f"-serve-socket={dd.sock}"])

            run_members(client, 2)
            doc = p.client.fetch_stats(dd.sock)
            assert daemon._requests == 2
        finally:
            dd.stop()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert doc["microbatched"] == 0 and doc["mb_occupancy"] == {}


def test_chaos_daemon_requests_stay_solo():
    """The chaos replay's daemon (-serve-lanes=0 -serve-microbatch=2)
    goes through the batching scheduler; its requests (-solver=tpu, the
    greedy solver) are not admissible, so even held together they run
    solo: no fused dispatch, every plan the in-process one."""
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbb-")
    try:
        paths = variant_files(d, 3)
        dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0,
                       microbatch=2, admission_hold=2)
        try:
            daemon = dd.start()
            daemon._coalescer._hold_window_s = 1.0
            for flags in (["-input-json", "-solver=tpu", "-max-reassign=2"],
                          ["-input-json", "-max-reassign=2"]):
                want = [run_pkg(p, flags + [f"-input={x}", "-no-daemon"])
                        for x in paths]
                got = [None] * 3

                def client(i):
                    got[i] = run_pkg(p, flags + [f"-input={paths[i]}",
                                                 f"-serve-socket={dd.sock}"])

                run_members(client, 3)
                assert [g[:2] for g in got] == [w[:2] for w in want]
            doc = p.client.fetch_stats(dd.sock)
        finally:
            dd.stop()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert doc["microbatched"] == 0 and doc["mb_occupancy"] == {}
