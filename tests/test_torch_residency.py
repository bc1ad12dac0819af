"""The shared residency pool (serve/residency.py) and the lane's
stage-ahead pipeline, against the JAX package on the CPU.

- the port's ``ResidencyPool`` holds the reference's ``stats()`` after
  every step of scripted sequences (lookups, puts, pins from several
  threads, the per-thread pin cap, eviction past the cap, released
  threads);
- ``ops.tensorize.to_device`` looks its arrays up in an installed pool
  and publishes what it uploads; no session path writes a pooled tensor;
- the daemon's ``_stage_request`` primes the lane's row cache and pool,
  and a lane queued behind a busy lane stages its head;
- plans served through a pooled lane equal the in-process plans and the
  JAX daemon's, for ``-fused`` and the whole-session engine; the stats
  doc, the memory block and the request gauges carry the residency keys.
"""

import hashlib
import importlib
import io
import json
import os
import queue
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch

from kafkabalancer_tpu.serve import residency as jres
from kafkabalancer_tpu_torch.serve import residency as tres
from torch_helpers import PkgDaemon, one_jax_device, package, run_pkg  # noqa: F401

# the module (ops/__init__ re-exports the tensorize FUNCTION under its name)
ttens = importlib.import_module("kafkabalancer_tpu_torch.ops.tensorize")

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "test.json")


# --- the pool against the reference's ----------------------------------------


class Worker:
    """A thread that runs the callables it is given, one at a time: the
    pools pin per thread, so each scripted 'thread' is one of these."""

    def __init__(self):
        self.q = queue.Queue()
        self.t = threading.Thread(target=self._loop, daemon=True)
        self.t.start()

    def _loop(self):
        while True:
            fn, box = self.q.get()
            if fn is None:
                return
            try:
                box.put((True, fn()))
            except BaseException as exc:  # surfaced by call()
                box.put((False, exc))

    def call(self, fn):
        box = queue.Queue()
        self.q.put((fn, box))
        ok, val = box.get(timeout=30)
        if not ok:
            raise val
        return val

    def stop(self):
        self.q.put((None, None))
        self.t.join(30)


def k(i):
    return ((4,), "<i4", b"d%02d" % i)


SEQUENCES = {
    # (cap, steps); a step is (thread, op, *args)
    "lookup_put": (8, [
        (0, "lookup", 1), (0, "put", 1), (0, "lookup", 1),
        (0, "lookup", 1, False), (0, "lookup", 2), (0, "contains", 1),
        (0, "release"), (0, "lookup", 1),
    ]),
    "eviction_past_cap": (3, [
        (0, "put", 1, False), (0, "put", 2, False), (0, "put", 3, False),
        (0, "lookup", 1, False), (0, "put", 4, False), (0, "contains", 2),
        (0, "contains", 1), (0, "put", 5, False), (0, "put", 1, False),
        (0, "len",),
    ]),
    "pins_from_threads": (2, [
        (0, "put", 1), (1, "put", 2), (2, "lookup", 1), (2, "put", 3),
        (0, "put", 4, False), (0, "len",), (0, "release"), (0, "len",),
        (2, "release"), (1, "put", 5, False), (0, "len",), (1, "release"),
        (1, "put", 6, False), (0, "contains", 2), (0, "len",),
    ]),
    "past_thread_pin_cap": (4, [
        *[(0, "put", i) for i in range(tres.THREAD_PIN_CAP + 3)],
        (0, "len",), (1, "put", 40, False), (0, "len",),
        (0, "lookup", 0), (0, "lookup", tres.THREAD_PIN_CAP + 2),
        (0, "release"), (0, "len",),
    ]),
    "release_thread": (1, [
        (0, "put", 1), (1, "lookup", 1), (1, "put", 2), (0, "release"),
        (0, "put", 3, False), (0, "len",), (1, "release"), (0, "len",),
        (0, "contains", 1), (0, "contains", 3), (0, "clear"), (0, "len",),
        (0, "lookup", 3),
    ]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_pool_stats_equal_the_reference_at_every_step(name):
    cap, steps = SEQUENCES[name]
    pools = {"jax": jres.ResidencyPool(cap), "torch": tres.ResidencyPool(cap)}
    workers = {}
    try:
        for n, (tid, op, *args) in enumerate(steps):
            if tid not in workers:
                workers[tid] = Worker()
            w = workers[tid]
            got = {}
            for pkg, pool in pools.items():
                if op == "put":
                    fn = lambda p=pool: p.put(  # noqa: E731
                        k(args[0]), f"buf{args[0]}", *args[1:])
                elif op == "lookup":
                    fn = lambda p=pool: p.lookup(k(args[0]), *args[1:])  # noqa: E731
                elif op == "release":
                    fn = pool.release_thread
                elif op == "contains":
                    fn = lambda p=pool: k(args[0]) in p  # noqa: E731
                elif op == "len":
                    fn = lambda p=pool: len(p)  # noqa: E731
                else:
                    fn = pool.clear
                got[pkg] = (w.call(fn), pool.stats(), pool.hit_rate(),
                            pool.device_bytes())
            assert got["torch"] == got["jax"], (name, n, op, args)
    finally:
        for w in workers.values():
            w.stop()


def test_pool_counts_tensor_bytes_and_counters():
    pool = tres.ResidencyPool()
    from kafkabalancer_tpu_torch import obs

    before = obs.metrics.snapshot()["counters"]
    pool.put(k(1), torch.zeros((3, 5), dtype=torch.int32))
    pool.put(k(2), torch.zeros(7, dtype=torch.bool))
    pool.put(k(3), object())  # an opaque test buffer counts 0
    assert pool.device_bytes() == 3 * 5 * 4 + 7
    assert pool.lookup(k(1)) is not None and pool.lookup(k(9)) is None
    after = obs.metrics.snapshot()["counters"]
    for name, n in (("serve.residency_uploads", 3),
                    ("serve.residency_hits", 1),
                    ("serve.residency_misses", 1)):
        assert after.get(name, 0) - before.get(name, 0) == n, name
    # a staged entry's fence is handed out once; put() replaces it
    pool.put(k(4), "t", retain=False, fence="ev")
    assert pool.pop_fence(k(4)) == "ev" and pool.pop_fence(k(4)) is None
    pool.put(k(5), "t", fence="ev5")
    pool.put(k(5), "t2")
    assert pool.pop_fence(k(5)) is None


def test_pool_module_imports_no_torch():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import kafkabalancer_tpu_torch.serve.residency\n"
        "assert 'torch' not in sys.modules, 'torch'\n"
        "assert 'jax' not in sys.modules, 'jax'\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_pool_under_thread_switch_stress():
    """Many threads share one pool under a tiny switch interval: every
    lookup is counted once, the caps hold, and no pin outlives its
    thread's release."""
    import sys

    pool = tres.ResidencyPool(cap=6)
    n_threads, rounds = 24, 60
    lookups = [0] * n_threads

    def work(i):
        for r in range(rounds):
            key = k((i + r) % 10)
            if pool.lookup(key) is None:
                pool.put(key, f"buf{(i + r) % 10}")
            lookups[i] += 1
            if r % 7 == 0:
                pool.release_thread()
        pool.release_thread()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    st = pool.stats()
    assert st["hits"] + st["misses"] == sum(lookups) == n_threads * rounds
    assert st["uploads"] == st["misses"]
    assert st["referenced"] == 0 and st["entries"] <= 6
    # two threads that miss one key both upload it; the second replaces
    assert st["uploads"] - st["evictions"] >= st["entries"]


# --- to_device through an installed pool --------------------------------------


def dense(seed=0):
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize
    from kafkabalancer_tpu_torch.solvers.scan import _settle_head
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    pl = synth_cluster(60, 7, seed=seed)
    cfg = default_rebalance_config()
    _settle_head(pl, cfg, 8)
    return tensorize(pl, cfg)


@pytest.fixture
def installed_pool():
    pool = tres.ResidencyPool()
    ttens.set_staging_cache(pool)
    try:
        yield pool
    finally:
        ttens.set_staging_cache(None)


def test_to_device_looks_up_and_publishes(installed_pool):
    pool = installed_pool
    dp = dense()
    a = ttens.to_device(dp, "cpu", torch.float64, all_allowed=True)
    st = pool.stats()
    # replicas, weights, nrep_cur, nrep_tgt, ncons, member, pvalid,
    # bvalid; every partition is at its target count, so nrep_tgt has
    # nrep_cur's content and key, and hits the entry nrep_cur published
    assert np.array_equal(dp.nrep_cur, dp.nrep_tgt)
    assert st["misses"] == 7 and st["uploads"] == 7 and st["hits"] == 1
    b = ttens.to_device(dp, "cpu", torch.float64, all_allowed=True)
    assert pool.stats()["hits"] == 1 + 8
    assert a.nrep_tgt is a.nrep_cur
    assert b.replicas is a.replicas and b.member is a.member
    # a cast to the array's own dtype returns the pooled tensor itself
    assert b.weights is a.weights
    # an owned copy: the pool never aliases the host array
    assert a.replicas.data_ptr() != dp.replicas.ctypes.data
    for f in ("replicas", "nrep_cur", "member", "pvalid", "bvalid"):
        assert np.array_equal(getattr(a, f).numpy(), getattr(dp, f)), f
    c = ttens.to_device(dp, "cpu", torch.float32)
    assert c.allowed is not None and c.weights.dtype == torch.float32
    assert pool.stats()["misses"] == 8  # the allowed matrix
    # the key is (shape, dtype, md5, device)
    key = ttens.stage_key(dp.replicas, "cpu")
    assert key == (dp.replicas.shape, dp.replicas.dtype.str,
                   hashlib.md5(dp.replicas.tobytes()).digest(), "cpu")
    assert pool.lookup(key) is a.replicas


def test_to_device_without_a_pool_is_unchanged():
    dp = dense()
    assert ttens.staging_cache() is None
    a = ttens.to_device(dp, "cpu", torch.float64)
    # the plain path hands out views of the host arrays, as before
    assert a.replicas.data_ptr() == dp.replicas.ctypes.data


def test_stage_host_arrays_inserts_unpinned_owned_copies():
    pool = tres.ResidencyPool(cap=2)
    dp = dense()
    rec = {}
    n = ttens.stage_host_arrays(
        pool, (dp.replicas, None, dp.weights, dp.replicas), "cpu", None, rec)
    assert n == 2 and len(pool) == 2  # None and the repeat are skipped
    assert rec["arrays"] == 2
    assert rec["bytes"] == dp.replicas.nbytes + dp.weights.nbytes
    assert pool.stats()["referenced"] == 0  # inserted unpinned
    assert ttens.stage_host_arrays(pool, (dp.replicas,), "cpu") == 0
    # unpinned entries are evictable: a third entry drops the oldest
    ttens.stage_host_arrays(pool, (dp.nrep_cur,), "cpu")
    assert len(pool) == 2 and pool.stats()["evictions"] == 1
    with pytest.raises(ValueError):
        ttens.stage_host_arrays(pool, (dp.replicas,), "cuda:0")


# --- no session path writes a pooled tensor -----------------------------------


def cluster_json(n=200, b=12, seed=3, zipf=False):
    from kafkabalancer_tpu_torch.codecs import write_partition_list
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    out = io.StringIO()
    write_partition_list(out, synth_cluster(n, b, seed=seed, zipf_topics=zipf))
    return out.getvalue()


def assert_pool_intact(pool):
    """Every pooled tensor still holds the bytes its key digested."""
    items = pool.items()
    assert items
    for key, t in items:
        got = hashlib.md5(
            np.ascontiguousarray(t.numpy()).reshape(-1).view(np.uint8)
        ).digest()
        assert got == key[2], key[:2]


SESSION_PATHS = {
    "move": ["-fused", "-fused-batch=4", "-max-reassign=30"],
    "move-b1": ["-fused", "-fused-batch=1", "-max-reassign=12",
                "-complete-partition=false"],
    "leader-b4": ["-fused", "-rebalance-leader", "-fused-batch=4",
                  "-max-reassign=20"],
    "leader-b1": ["-fused", "-rebalance-leader", "-fused-batch=1",
                  "-max-reassign=12", "-complete-partition=false"],
    "polish": ["-fused", "-fused-polish", "-fused-batch=100", "-allow-leader",
               "-max-reassign=30"],
    "colocation": ["-fused", "-fused-batch=4", "-anti-colocation=0.001",
                   "-max-reassign=30"],
    "beam": ["-solver=beam", "-max-reassign=6"],
    "pallas-plain": ["-fused", "-fused-engine=pallas", "-fused-batch=4",
                     "-max-reassign=30"],
}


@pytest.mark.parametrize("path", sorted(SESSION_PATHS))
def test_session_paths_leave_pooled_inputs_unchanged(path, installed_pool):
    from kafkabalancer_tpu_torch import cli

    src = cluster_json(zipf=path == "colocation")
    argv = ["kafkabalancer", "-input-json", *SESSION_PATHS[path]]
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(src), out, err, argv, device="cpu")
    assert rc == 0, err.getvalue()
    # the same plan without a pool
    ttens.set_staging_cache(None)
    out2 = io.StringIO()
    assert cli.run(io.StringIO(src), out2, io.StringIO(), argv,
                   device="cpu") == 0
    assert out.getvalue() == out2.getvalue()
    assert installed_pool.stats()["uploads"] > 0
    assert_pool_intact(installed_pool)


def variant_paths(d, n):
    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )

    paths = []
    for i in range(n):
        with open(FIXTURE) as fh:
            pl = get_partition_list_from_reader(fh, True, [])
        if i:
            p = pl.partitions[i % len(pl.partitions)]
            p.replicas[0], p.replicas[1] = p.replicas[1], p.replicas[0]
        path = os.path.join(d, f"v{i}.json")
        with open(path, "w") as fh:
            write_partition_list(fh, pl)
        paths.append(path)
    return paths


FUSED = ["-input-json", "-fused", "-fused-batch=4", "-max-reassign=4"]


def test_batched_session_leaves_pooled_inputs_unchanged():
    """Four concurrent clients of a hold-4 lane run one instance-batched
    session; the lane's pool stays intact."""
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbr-")
    dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0, microbatch=4,
                   admission_hold=4)
    try:
        paths = variant_paths(d, 4)
        daemon = dd.start()
        daemon._coalescer._hold_window_s = 30.0
        res = [None] * 4

        def client(i):
            res[i] = run_pkg(p, FUSED + [f"-input={paths[i]}",
                                         f"-serve-socket={dd.sock}"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        doc = p.client.fetch_stats(dd.sock)
        assert doc["microbatched"] == 4
        assert all(r[0] == 0 for r in res)
        assert_pool_intact(daemon._lanes[0].stage_cache)
    finally:
        dd.stop()
        shutil.rmtree(d, ignore_errors=True)
        from kafkabalancer_tpu_torch import obs as tobs

        tobs.set_shared_registry(False)
        tobs.TRACER.disable()


# --- the stage pipeline ---------------------------------------------------------


def test_stage_request_primes_lane_caches():
    """Staging a fused request fills the lane's pool and primes its row
    cache, so the request's own upload hits both; a greedy request
    stages nothing (the reference's tests/test_serve.py pin)."""
    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.serve.cache import TensorizeRowCache
    from kafkabalancer_tpu_torch.serve.daemon import Daemon, PlanRequest
    from kafkabalancer_tpu_torch.serve.lanes import Lane

    d = Daemon(os.path.join(tempfile.gettempdir(), "unused.sock"),
               warm=False, log=lambda _m: None, devices=["cpu"])
    lane = Lane(0, device=torch.device("cpu"))
    lane.row_cache = TensorizeRowCache()
    with open(FIXTURE) as fh:
        src = fh.read()
    argv = ["-no-daemon=true", "-input-json=true", "-fused=true",
            "-max-reassign=4"]
    d._stage_request(PlanRequest(list(argv), src), lane)
    staged = len(lane.stage_cache)
    assert staged > 0 and lane.stage_cache.stats()["referenced"] == 0
    assert lane.row_cache._meta is not None
    assert lane.stage_log[-1]["arrays"] == staged
    # the request's run on the lane hits every staged array
    with lane.context():
        out = io.StringIO()
        assert cli.run(io.StringIO(src), out, io.StringIO(),
                       ["kafkabalancer", *argv], device="cpu") == 0
    st = lane.stage_cache.stats()
    assert st["hits"] >= staged
    assert lane.row_cache.stats()["hits"] >= 1
    # a greedy request has no device upload to stage for
    lane2 = Lane(1, device=torch.device("cpu"))
    lane2.row_cache = TensorizeRowCache()
    d._stage_request(
        PlanRequest(["-no-daemon=true", "-input-json=true"], src), lane2)
    assert len(lane2.stage_cache) == 0 and not lane2.stage_log


def test_lane_context_installs_and_releases_the_pool():
    from kafkabalancer_tpu_torch.serve.lanes import Lane

    lane = Lane(0, device=torch.device("cpu"))
    with lane.context():
        assert ttens.staging_cache() is lane.stage_cache
        lane.stage_cache.put(k(1), "t")
        assert lane.stage_cache.stats()["referenced"] == 1
    assert ttens.staging_cache() is None
    assert lane.stage_cache.stats()["referenced"] == 0
    assert lane.copy_stream() is None  # a CPU lane has no copy stream
    assert lane.residency_stats() == lane.stage_cache.stats()


def test_request_queued_behind_a_busy_lane_is_staged():
    """The scheduler stages the head of a busy lane's queue when it is
    submitted, and at most once; a failing stage is swallowed."""
    from kafkabalancer_tpu_torch.serve.lanes import Lane, LaneScheduler

    class Req:
        def __init__(self, name):
            self.argv, self.name = [name], name
            self.done = threading.Event()
            self.response = None
            self.bucket, self.bucketed, self.staged = None, False, False
            self.mb_entered, self.internal = False, None

    release = threading.Event()
    started = threading.Event()
    staged = []
    stage_seen = threading.Event()

    def handle(req, coalesced, lane, mb):
        if req.name == "r1":
            started.set()
            release.wait(30)
        req.response = {"ok": True, "name": req.name}

    def stage(req, lane):
        staged.append(req.name)
        stage_seen.set()
        if req.name == "r2":
            raise RuntimeError("a stage failure is swallowed")

    sched = LaneScheduler(handle, lambda r: None, [Lane(0)], stage=stage)
    try:
        out = {}
        t1 = threading.Thread(
            target=lambda: out.setdefault("r1", sched.submit(Req("r1"))))
        t1.start()
        assert started.wait(30)
        reqs = [Req("r2"), Req("r3")]
        ts = [threading.Thread(
            target=lambda r=r: out.setdefault(r.name, sched.submit(r)))
            for r in reqs]
        ts[0].start()
        assert stage_seen.wait(30)
        ts[1].start()
        release.set()
        for t in [t1, *ts]:
            t.join(30)
        assert {n: r["name"] for n, r in out.items()} == {
            "r1": "r1", "r2": "r2", "r3": "r3"}
        assert staged[0] == "r2" and staged.count("r2") == 1
        assert reqs[0].staged
    finally:
        sched.stop()


# --- served through a pooled lane ---------------------------------------------


ENGINES = {
    # the port's argv, the JAX CLI's (its plain whole-session version
    # runs on the CPU as pallas-interpret)
    "fused": (["-fused-batch=4"], ["-fused-batch=4"]),
    "pallas": (["-fused-batch=4", "-fused-engine=pallas"],
               ["-fused-batch=4", "-fused-engine=pallas-interpret"]),
}


def serve_sequence(pkg, argv, paths, metrics_dir=None):
    """One single-lane daemon of ``pkg`` (the lane scheduler: one device,
    the CLI's batching default) answering ``paths`` in order, each twice;
    returns (results, stats doc, per-request gauges, pool items)."""
    p = package(pkg)
    d = tempfile.mkdtemp(prefix="kbr-")
    dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0, microbatch=4)
    res, gauges, items = [], [], None
    try:
        daemon = dd.start()
        for n, path in enumerate([x for x in paths for _ in (0, 1)]):
            extra = []
            if metrics_dir is not None:
                extra = [f"-metrics-json={os.path.join(metrics_dir, f'{pkg}{n}.json')}"]
            res.append(run_pkg(p, ["-input-json", "-fused", "-max-reassign=4",
                                   *argv, f"-input={path}",
                                   f"-serve-socket={dd.sock}", *extra]))
            if extra:
                with open(extra[0].split("=", 1)[1]) as fh:
                    gauges.append(json.load(fh)["gauges"])
        doc = p.client.fetch_stats(dd.sock)
        if pkg == "torch":
            items = daemon._lanes[0].stage_cache.items()
    finally:
        dd.stop()
        shutil.rmtree(d, ignore_errors=True)
    return res, doc, gauges, items


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_pooled_lane_plans_equal_in_process_and_the_reference(
    engine, one_jax_device
):
    targ, jarg = ENGINES[engine]
    d = tempfile.mkdtemp(prefix="kbr-")
    try:
        paths = variant_paths(d, 2)
        tp = package("torch")
        want = [run_pkg(tp, ["-input-json", "-fused", "-max-reassign=4",
                             *targ, f"-input={x}", "-no-daemon"])[:2]
                for x in paths for _ in (0, 1)]
        tres_, tdoc, _g, items = serve_sequence("torch", targ, paths)
        jres_, jdoc, _g, _i = serve_sequence("jax", jarg, paths)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert all(w[0] == 0 for w in want)
    assert [r[:2] for r in tres_] == want
    assert [r[:2] for r in tres_] == [r[:2] for r in jres_]
    assert set(tdoc["residency"]) == set(jdoc["residency"]) == {
        "hits", "misses"}
    for key, t in items:
        got = hashlib.md5(np.ascontiguousarray(t.numpy()).reshape(-1)
                          .view(np.uint8)).digest()
        assert got == key[2]


def test_pooled_lane_counts_are_the_ports_own(one_jax_device):
    """The port looks up ``to_device``'s arrays, the reference XLA's
    dispatch arguments, so the two count differently over the same
    requests (ROADMAP "Departures"). The port's counts: the fixture's
    plan looks up 8 arrays in one chunk (the all-allowed mode skips the
    allowed matrix) and uploads 7 (nrep_tgt has nrep_cur's content, so
    it hits); the repeat hits all 8; the variant (two replicas of one
    partition swapped: the same membership) misses only its replicas."""
    d = tempfile.mkdtemp(prefix="kbr-")
    try:
        paths = variant_paths(d, 2)
        tres_, tdoc, tg, items = serve_sequence(
            "torch", ["-fused-batch=4"], paths, metrics_dir=d)
        jres_, jdoc, jg, _i = serve_sequence(
            "jax", ["-fused-batch=4"], paths, metrics_dir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert [r[:2] for r in tres_] == [r[:2] for r in jres_]
    assert tdoc["residency"] == {"hits": 1 + 8 + 7 + 8, "misses": 7 + 1}
    assert tdoc["residency"] != jdoc["residency"]
    assert len(items) == 8
    # the request gauges: the scheduler's running hit count at export
    hits = [g["serve.residency_hits"] for g in tg]
    assert hits == [1.0, 9.0, 16.0, 24.0]
    assert all(g["serve.residency_bytes"] > 0 for g in tg)
    assert all("serve.residency_hits" in g and "serve.residency_bytes" in g
               for g in jg)


def test_stats_doc_and_memory_block_carry_residency():
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbr-")
    try:
        paths = variant_paths(d, 1)
        for lanes, pooled in ((0, True), (1, False)):
            dd = PkgDaemon(p, os.path.join(d, f"kb{lanes}.sock"),
                           lanes=lanes, microbatch=4)
            try:
                daemon = dd.start()
                rc = run_pkg(p, FUSED + [f"-input={paths[0]}",
                                         f"-serve-socket={dd.sock}"])[0]
                assert rc == 0
                doc = p.client.fetch_stats(dd.sock)
                mem = doc["memory"]
                assert {"residency_bytes", "residency_entries"} <= set(mem[0])
                if pooled:
                    pool = daemon._lanes[0].stage_cache
                    assert doc["residency"]["misses"] > 0
                    assert mem[0]["residency_entries"] == len(pool) > 0
                    assert mem[0]["residency_bytes"] == sum(
                        t.numel() * t.element_size() for _k, t in pool.items())
                    assert mem[0]["residency_entries"] <= tres.DEFAULT_POOL_CAP
                else:
                    # the single-lane Coalescer has no pool
                    assert "residency" not in doc
                    assert mem[0]["residency_bytes"] == 0
                    assert mem[0]["residency_entries"] == 0
            finally:
                dd.stop()
    finally:
        shutil.rmtree(d, ignore_errors=True)
        from kafkabalancer_tpu_torch import obs as tobs

        tobs.set_shared_registry(False)
        tobs.TRACER.disable()


BATCHED_PATHS = {
    "polish": ["-fused-polish", "-fused-batch=100", "-allow-leader"],
    "colocation": ["-anti-colocation=0.001"],
    "batch1": ["-fused-batch=1", "-complete-partition=false"],
}


@pytest.mark.parametrize("path", sorted(BATCHED_PATHS))
def test_batched_session_paths_leave_pooled_inputs_unchanged(path):
    """Two concurrent clients of a hold-2 lane per batched kind (the
    polish alternation, the colocation objective, batch 1) run one
    instance-batched session; each plan is its -no-daemon plan and the
    lane's pool stays intact."""
    p = package("torch")
    d = tempfile.mkdtemp(prefix="kbr-")
    dd = PkgDaemon(p, os.path.join(d, "kb.sock"), lanes=0, microbatch=4,
                   admission_hold=2)
    try:
        paths = variant_paths(d, 2)
        flags = FUSED + BATCHED_PATHS[path]
        want = [run_pkg(p, flags + [f"-input={x}", "-no-daemon"])
                for x in paths]
        daemon = dd.start()
        daemon._coalescer._hold_window_s = 30.0
        res = [None] * 2

        def client(i):
            res[i] = run_pkg(p, flags + [f"-input={paths[i]}",
                                         f"-serve-socket={dd.sock}"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        doc = p.client.fetch_stats(dd.sock)
        assert doc["microbatched"] == 2
        assert [r[:2] for r in res] == [w[:2] for w in want]
        assert all(r[0] == 0 for r in res)
        assert_pool_intact(daemon._lanes[0].stage_cache)
    finally:
        dd.stop()
        shutil.rmtree(d, ignore_errors=True)
        from kafkabalancer_tpu_torch import obs as tobs

        tobs.set_shared_registry(False)
