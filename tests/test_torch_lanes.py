"""The port's device lanes (kafkabalancer_tpu_torch/serve/lanes.py) on
CPU lanes.

The pins:

- routing: bucket affinity, least-loaded placement, stealing by an idle
  lane, the mesh-exclusive drain;
- the lane context installs and clears the thread's row cache;
- served: four concurrent ``-fused`` clients on ``["cpu", "cpu"]`` lanes
  each print their solo plan — the port's in-process plan and the JAX
  CLI's — and launch the scoring session as often as four solo runs; a
  ``-fused-shard`` request runs mesh-exclusive over both lanes' devices
  and prints the unsharded plan;
- the kernel launch counters stay exact under concurrent increments;
- the port's ``ops.runtime.prefetch_hints`` keys requests exactly like
  the reference's ``ops.coldstart.prefetch_hints``.
"""

import io
import os
import shutil
import sys
import tempfile
import threading
import time

import pytest

from kafkabalancer_tpu import cli as jcli
from kafkabalancer_tpu.ops.coldstart import prefetch_hints as jprefetch_hints
from kafkabalancer_tpu_torch import cli
from kafkabalancer_tpu_torch.codecs import (
    get_partition_list_from_reader,
    write_partition_list,
)
from kafkabalancer_tpu_torch.ops import nvcc
from kafkabalancer_tpu_torch.ops.runtime import prefetch_hints
from kafkabalancer_tpu_torch.serve.daemon import PlanRequest
from kafkabalancer_tpu_torch.serve.lanes import Lane, LaneScheduler
from kafkabalancer_tpu_torch.solvers import scan
from kafkabalancer_tpu_torch.utils.synth import synth_cluster
from torch_helpers import running_daemon

import torch  # noqa: E402

N_PARTS, N_BROKERS = 96, 10
FLAGS = ["-input-json", "-fused", "-fused-batch=4", "-max-reassign=40"]


def cluster_text(seed):
    """A seeded synthetic cluster as reassignment JSON; every seed gives
    the same shape bucket (what concurrent clusters look like)."""
    out = io.StringIO()
    write_partition_list(
        out, synth_cluster(N_PARTS, N_BROKERS, rf=3, seed=seed)
    )
    return out.getvalue()


def run_port(args, stdin="", **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_jax(args, stdin=""):
    out, err = io.StringIO(), io.StringIO()
    rc = jcli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def cluster_files():
    d = tempfile.mkdtemp(prefix="kbt-")
    paths = []
    for seed in range(4):
        p = os.path.join(d, f"c{seed}.json")
        with open(p, "w") as fh:
            fh.write(cluster_text(seed))
        paths.append(p)
    yield paths
    shutil.rmtree(d, ignore_errors=True)


def _mk_req(name, bucket=None):
    req = PlanRequest([name], None)
    req.bucket = bucket
    req.bucketed = True
    return req


# --- routing -----------------------------------------------------------------


def test_affinity_and_least_loaded_routing():
    release = threading.Event()
    handled = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb=None):
        if req.argv[0].startswith("block"):
            release.wait(30)
        with lock:
            handled.append((req.argv[0], lane.index))
        req.response = {"ok": True}

    buckets = {"block-a": (8, 2, 4, True), "a2": (8, 2, 4, True),
               "b": (16, 2, 4, True)}
    sched = LaneScheduler(handle, lambda r: buckets.get(r.argv[0]),
                          [Lane(0, "cpu"), Lane(1, "cpu")])
    threads = []
    try:
        def submit(name):
            sched.submit(_mk_req(name, buckets[name]))

        threads.append(threading.Thread(target=submit, args=("block-a",)))
        threads[0].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(sched._active):
            time.sleep(0.01)
        for name in ("a2", "b"):
            threads.append(threading.Thread(target=submit, args=(name,)))
            threads[-1].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
            n == "b" for n, _ in handled
        ):
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(30)
        lanes_of = dict(handled)
        assert lanes_of["block-a"] == lanes_of["a2"], handled
        assert lanes_of["b"] != lanes_of["block-a"], handled
        assert sched.busy() is False
    finally:
        release.set()
        sched.stop()


def test_idle_lane_steals_distinct_bucket_work():
    release = threading.Event()
    handled = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb=None):
        if req.argv[0].startswith("block"):
            release.wait(30)
        with lock:
            handled.append((req.argv[0], lane.index))
        req.response = {"ok": True}

    A, B = (8, 2, 4, True), (16, 2, 4, True)
    sched = LaneScheduler(handle, lambda r: None,
                          [Lane(0, "cpu"), Lane(1, "cpu")])
    threads = []
    try:
        with sched._cv:
            sched._affinity[A] = 0
            sched._affinity[B] = 0

        def submit(req):
            sched.submit(req)

        threads.append(
            threading.Thread(target=submit, args=(_mk_req("block-1", A),))
        )
        threads[0].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not sched._active[0]:
            time.sleep(0.01)
        for name, b in (("a2", A), ("b1", B)):
            threads.append(
                threading.Thread(target=submit, args=(_mk_req(name, b),))
            )
            threads[-1].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
            n == "b1" for n, _ in handled
        ):
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(30)
        lanes_of = dict(handled)
        assert lanes_of["b1"] == 1, handled  # the tail, stolen by lane 1
        assert lanes_of["a2"] == 0, handled  # the queue head stayed
        assert sched.steals == 1
    finally:
        release.set()
        sched.stop()


def test_mesh_exclusive_drains_and_holds():
    release_block = threading.Event()
    excl_started = threading.Event()
    excl_release = threading.Event()
    handled = []
    lock = threading.Lock()

    def handle(req, coalesced, lane, mb=None):
        name = req.argv[0]
        if name == "block":
            release_block.wait(30)
        if name == "mesh":
            excl_started.set()
            excl_release.wait(30)
        with lock:
            handled.append(name)
        req.response = {"ok": True}

    sched = LaneScheduler(handle, lambda r: None,
                          [Lane(0, "cpu"), Lane(1, "cpu")],
                          exclusive=lambda r: r.argv[0] == "mesh")
    threads = []
    try:
        def submit(name):
            sched.submit(_mk_req(name))

        threads.append(threading.Thread(target=submit, args=("block",)))
        threads[0].start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(sched._active):
            time.sleep(0.01)
        threads.append(threading.Thread(target=submit, args=("mesh",)))
        threads[-1].start()
        assert not excl_started.wait(0.5), "ran beside in-flight work"
        threads.append(threading.Thread(target=submit, args=("late",)))
        threads[-1].start()
        time.sleep(0.3)
        with lock:
            assert "late" not in handled
        release_block.set()
        assert excl_started.wait(30), "exclusive never ran after the drain"
        time.sleep(0.3)
        with lock:
            assert "late" not in handled, handled
        excl_release.set()
        for t in threads:
            t.join(30)
        assert handled == ["block", "mesh", "late"]
        assert sched.stats()["mesh_exclusive"] == 1.0
    finally:
        release_block.set()
        excl_release.set()
        sched.stop()


def test_lane_context_installs_and_clears_the_thread_seams():
    from kafkabalancer_tpu_torch.ops.tensorize import row_cache
    from kafkabalancer_tpu_torch.serve.cache import TensorizeRowCache

    lane = Lane(0, torch.device("cpu"))
    lane.row_cache = TensorizeRowCache()
    with lane.context():
        assert row_cache() is lane.row_cache
        seen = []
        t = threading.Thread(target=lambda: seen.append(row_cache()))
        t.start()
        t.join(30)
        assert seen == [None]  # the seam is per thread
    assert row_cache() is None


# --- served ------------------------------------------------------------------


def test_served_concurrent_fused_on_two_cpu_lanes(cluster_files, monkeypatch):
    """Four concurrent same-bucket -fused clients of a two-lane daemon:
    each request runs solo on its lane and prints its in-process plan,
    and together they run exactly the sessions of four solo runs."""
    sessions = []
    real_session = scan.session

    def counted(*a, **k):
        sessions.append(threading.current_thread().name)
        return real_session(*a, **k)

    monkeypatch.setattr(scan, "session", counted)
    want = [run_port(FLAGS + [f"-input={p}", "-no-daemon"], device="cpu")
            for p in cluster_files]
    ref = [run_jax(FLAGS + [f"-input={p}", "-no-daemon"])
           for p in cluster_files]
    assert [w[:2] for w in want] == [r[:2] for r in ref]
    solo_sessions = len(sessions)
    sessions.clear()
    with running_daemon(devices=["cpu", "cpu"], lanes=0) as (sock, d, _logs):
        results = [None] * 4

        def client(i):
            results[i] = run_port(FLAGS + [f"-input={cluster_files[i]}",
                                           f"-serve-socket={sock}"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert [r[:2] for r in results] == [w[:2] for w in want]
        # each client's first session op finds no resident session and
        # re-sends its cluster whole: the only fallback reason allowed
        assert d._requests == 4
        assert d._fallbacks == {"session_absent": 4}
        assert sum(ln.requests for ln in d._lanes) == 4
    assert len(sessions) == solo_sessions
    assert all(n.startswith("serve-req-") for n in sessions), sessions


def test_served_fused_shard_runs_mesh_exclusive_over_both_lanes(
    cluster_files
):
    args = FLAGS + [f"-input={cluster_files[0]}"]
    unsharded = run_port(args + ["-no-daemon"], device="cpu")
    with running_daemon(devices=["cpu", "cpu"], lanes=0) as (sock, d, _logs):
        served = run_port(args + ["-fused-shard", f"-serve-socket={sock}"])
        assert d._coalescer.stats()["mesh_exclusive"] == 1.0
    assert served[:2] == unsharded[:2]


# --- counters and keys ---------------------------------------------------------


def test_launch_counter_exact_under_four_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    per_thread = 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [nvcc.count_launch(wrapper)
                                for _ in range(per_thread)]
            )
            for _ in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 4 * per_thread


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("brokers", [None, [1, 2, 3], list(range(1, 30))])
def test_prefetch_hints_match_the_reference(seed, brokers):
    from kafkabalancer_tpu.codecs import (
        get_partition_list_from_reader as jreader,
    )

    text = cluster_text(seed)
    got = prefetch_hints(
        get_partition_list_from_reader(io.StringIO(text), True, []), brokers
    )
    ref = jprefetch_hints(jreader(io.StringIO(text), True, []), brokers)
    for key in ("n_parts", "nb", "P", "R", "B", "n_topics", "movable",
                "all_allowed"):
        assert got[key] == ref[key], key


# the dispatcher choice: (-serve-lanes, -serve-microbatch, devices)
DISPATCH_GRID = [
    (lanes, mb, ndev)
    for lanes in (1, 0, 2, 3)
    for mb in (1, 2)
    for ndev in (1, 2)
]


@pytest.mark.parametrize("lanes,microbatch,ndev", DISPATCH_GRID)
def test_dispatcher_class_matches_the_reference(
    lanes, microbatch, ndev, monkeypatch
):
    """Both daemons pick the same dispatcher: the Coalescer for an
    explicit ``-serve-lanes=1`` or one lane without microbatching, the
    lane scheduler otherwise (so ``-serve-lanes=0 -serve-microbatch=2``
    keeps the scheduler, its watchdog and its ``lane_crash`` site on one
    device)."""
    import jax

    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu.serve.daemon import Daemon as JDaemon
    from kafkabalancer_tpu_torch import obs as tobs
    from kafkabalancer_tpu_torch.serve.daemon import Daemon as TDaemon

    jdevs = jax.devices()[:ndev]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: list(jdevs))
    d = tempfile.mkdtemp(prefix="kbt-")
    chosen = []
    try:
        for make in (
            lambda: JDaemon(os.path.join(d, "j.sock"), warm=False,
                            lanes=lanes, microbatch=microbatch),
            lambda: TDaemon(os.path.join(d, "t.sock"), warm=False,
                            lanes=lanes, microbatch=microbatch,
                            devices=["cpu"] * ndev),
        ):
            daemon = make()
            disp = daemon._make_dispatcher()
            try:
                n = len(getattr(disp, "lanes", ())) or 1
                chosen.append((type(disp).__name__, n))
            finally:
                disp.stop()
    finally:
        jobs.set_shared_registry(False)
        tobs.set_shared_registry(False)
        shutil.rmtree(d, ignore_errors=True)
    assert chosen[0] == chosen[1], chosen
    single = lanes == 1 or (min(ndev, lanes if lanes > 0 else ndev) <= 1
                            and microbatch <= 1)
    assert chosen[1][0] == ("Coalescer" if single else "LaneScheduler")


def test_quarantined_fleet_answer_keeps_the_admission_identity():
    """A request that passed admission while every lane is quarantined
    (a crashed worker's restart holds its lane quarantined for a moment)
    is answered with a quarantine shed and never begins handling: it
    counts as abandoned, so the chaos replay's ``admitted == requests +
    abandoned`` holds."""
    with running_daemon(lanes=0, microbatch=2) as (_sock, d, _logs):
        sched = d._coalescer
        assert isinstance(sched, LaneScheduler)
        sched.lanes[0].quarantined = True
        try:
            resp = d._dispatch_plan(PlanRequest(["-input-json"], "{}"))
        finally:
            sched.lanes[0].quarantined = False
        assert resp["op"] == "overload" and resp["reason"] == "quarantine"
        snap = d._core_snapshot()
        adm, lh = snap["admission"], snap["lane_health"]
        assert adm["admitted"] == 1
        assert snap["requests"] == 0 and lh["abandoned"] == 1
        assert adm["admitted"] == snap["requests"] + lh["abandoned"]
