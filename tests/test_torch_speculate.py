"""Speculative plan-ahead and the ``-watch`` controller of the port
(kafkabalancer_tpu_torch/serve/speculate.py) against the JAX package's.

The pins:

- the same seeded outer loop (register, then one applied move per
  round) through the JAX daemon and through the port's daemon on a CPU
  lane: every round's stdout equals ``-no-daemon`` in both, rounds past
  the first are memo hits, and the ``speculation`` block, the request
  counts and the per-tenant ``spec_hits`` are the same — for the greedy
  pipeline, ``-fused`` and the whole-session kernel's engine;
- a memo that cannot serve (external drift, changed flags) is a miss,
  answered live and byte-identical; release poisons a live memo; the
  identity ``attempts == hits + misses + poisoned + memos`` holds at
  every scrape;
- preemption: real traffic aborts an in-flight speculative run
  (``SpeculationAborted`` is a ``BaseException``, so no fail-open
  ladder swallows it); a request matching the in-flight run waits for
  it; speculation never touches the idle clock;
- resident state (torch commits in place): after a COMPLETED
  speculative run the resident session — raw rows, canonical bytes,
  digest, settled list and row-cache masters — is bit for bit the one a
  live request serving the same move leaves; after an ABORTED run (at a
  chunk round, or at the first applied move after the torch session
  ran) the raw rows and canonical bytes are bit for bit its snapshot
  from before the run, the row-cache masters those a completed run
  leaves, and the prediction is poisoned as in the reference;
- the watcher emits, over the ``_MutableZk`` fake, the plans the JAX
  watcher emits, each equal to ``-no-daemon`` on the tree, and steady
  state is memo reads; the ``$KAFKABALANCER_TPU_FAKE_ZK`` file fake
  drives it the same way;
- flag checks: ``-watch`` needs ``-serve`` and ``-watch-emit``,
  ``-watch-emit`` needs ``-watch``, and watch mode drops the default
  idle timeout — as in the JAX CLI.
"""

import json
import os
import re
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest

from test_torch_cli import FIXTURE
from torch_helpers import PkgDaemon, package, run_pkg

_TS = re.compile(r"^\d{4}/\d{2}/\d{2} \d{2}:\d{2}:\d{2} ", re.M)

# one planning path per case: (port argv, JAX argv); the port's kernel
# engine on CPU tensors is its plain version, the JAX package's plain
# version is its interpret mode
PATHS = {
    "greedy": ([], []),
    "fused": (["-fused", "-fused-batch=4"], ["-fused", "-fused-batch=4"]),
    "pallas": (["-fused", "-fused-engine=pallas", "-fused-batch=4"],
               ["-fused", "-fused-engine=pallas-interpret",
                "-fused-batch=4"]),
}


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="kbt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _state():
    with open(FIXTURE) as f:
        return json.load(f)


def _apply(state, plan_stdout):
    for entry in json.loads(plan_stdout).get("partitions") or []:
        for row in state["partitions"]:
            if (row["topic"], row["partition"]) == (
                entry["topic"], entry["partition"]
            ):
                row["replicas"] = list(entry["replicas"])
                break


def _identity_ok(st):
    return st["attempts"] == (
        st["hits"] + st["misses"] + st["poisoned"] + st["memos"]
    )


def _settled(d, timeout=30.0):
    """Wait until the speculator holds a memo and is out of flight."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = d.speculator.stats()
        assert _identity_ok(st), st
        if st["memos"] >= 1 and not st["inflight"]:
            return st
        time.sleep(0.02)
    return d.speculator.stats()


def _respeculated(d, attempts0, timeout=30.0):
    """Wait until the speculator made an attempt past ``attempts0`` and
    is out of flight (the plan-ahead a clean request enqueues)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = d.speculator.stats()
        if st["attempts"] > attempts0 and not st["inflight"]:
            return st
        time.sleep(0.02)
    return d.speculator.stats()


def _idle(d, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and d.speculator.stats()["inflight"]:
        time.sleep(0.02)
    return d.speculator.stats()


def _write(path, state):
    with open(path, "w") as f:
        json.dump(state, f)


def _loop(name, sock_dir, path, steps=4):
    """The outer loop through ``name``'s daemon: per round the plan (equal
    to ``-no-daemon``), then the speculation block, request counts and
    tenant attribution once the loop ends."""
    pkg = package(name)
    extra = PATHS[path][0 if name == "torch" else 1]
    sock = os.path.join(sock_dir, f"{name}.sock")
    src = os.path.join(sock_dir, f"{name}-cluster.json")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    state = _state()
    args = ["-input-json", f"-input={src}", "-max-reassign=1"] + extra
    outs = []
    try:
        for step in range(steps):
            _write(src, state)
            want = run_pkg(pkg, args + ["-no-daemon"])
            got = run_pkg(pkg, args + [f"-serve-socket={sock}"])
            assert got[:2] == want[:2], (name, path, step)
            assert _TS.sub("", got[2]) == _TS.sub("", want[2]), (name, step)
            outs.append(got[1])
            _apply(state, got[1])
            _settled(d)
        st = d.speculator.stats()
        doc = pkg.client.fetch_stats(sock)
        flight = pkg.client.fetch_trace(sock)["trace"]["otherData"]["requests"]
    finally:
        runner.stop()
    tenant = doc["tenants"]["top"][os.path.abspath(src)]
    return {
        "outs": outs,
        "speculation": st,
        "scraped": doc["speculation"],
        "requests": doc["requests"],
        "request_s": doc["hists"]["serve.request_s"]["count"],
        "hit_s": doc["hists"]["serve.spec.hit_s"]["count"],
        "delta_hits": doc["sessions"]["delta_hits"],
        "spec_hits": tenant["spec_hits"],
        "flight": len(flight),
        "flight_hits": sum(1 for r in flight if r.get("spec_hit")),
    }


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outer_loop_matches_jax(sock_dir, path):
    jx = _loop("jax", sock_dir, path)
    pt = _loop("torch", sock_dir, path)
    assert pt == jx
    st = pt["speculation"]
    assert st["hits"] == 3 and st["misses"] == 0 and _identity_ok(st)
    assert pt["requests"] == pt["request_s"] == pt["flight"] == 4
    assert pt["hit_s"] == pt["spec_hits"] == pt["flight_hits"] == 3


def _drift(name, sock_dir, change):
    pkg = package(name)
    sock = os.path.join(sock_dir, f"{name}.sock")
    src = os.path.join(sock_dir, f"{name}-cluster.json")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    args = ["-input-json", f"-input={src}", "-max-reassign=1"]
    state = _state()
    try:
        _write(src, state)
        rc, out, _ = run_pkg(pkg, args + [f"-serve-socket={sock}"])
        assert rc == 0
        _apply(state, out)
        _settled(d)
        extra = []
        if change == "drift":
            # out-of-band drift the prediction cannot know about
            state["partitions"][0]["replicas"] = [2, 3]
        else:
            # same digest, other argv (-unique keeps the session key)
            extra = ["-unique"]
        _write(src, state)
        want = run_pkg(pkg, args + extra + ["-no-daemon"])
        attempts0 = d.speculator.stats()["attempts"]
        got = run_pkg(pkg, args + extra + [f"-serve-socket={sock}"])
        assert got[:2] == want[:2]
        # the live answer enqueues the next plan-ahead
        st = _respeculated(d, attempts0)
        sess_stats = d.sessions.stats()
    finally:
        runner.stop()
    return out, got[1], st, sess_stats["resyncs_rows"]


@pytest.mark.parametrize("change", ["drift", "flags"])
def test_unusable_memo_is_a_miss_answered_live(sock_dir, change):
    jx = _drift("jax", sock_dir, change)
    pt = _drift("torch", sock_dir, change)
    assert pt == jx
    st = pt[2]
    assert st["misses"] >= 1 and _identity_ok(st)
    assert st["wasted_dispatches"] == st["misses"] + st["poisoned"]


def _release(name, sock_dir):
    pkg = package(name)
    sock = os.path.join(sock_dir, f"{name}.sock")
    src = os.path.join(sock_dir, f"{name}-cluster.json")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    try:
        _write(src, _state())
        assert run_pkg(pkg, ["-input-json", f"-input={src}",
                             "-max-reassign=1",
                             f"-serve-socket={sock}"])[0] == 0
        before = _settled(d)
        released = pkg.client.release_session(sock, os.path.abspath(src))
        after = d.speculator.stats()
        block = pkg.client.fetch_stats(sock)["speculation"]
    finally:
        runner.stop()
    return before, released, after, block


def test_release_poisons_live_memo(sock_dir):
    jx = _release("jax", sock_dir)
    pt = _release("torch", sock_dir)
    assert pt == jx
    before, released, after, block = pt
    assert before["memos"] == 1 and released >= 1
    assert after["poisoned"] == 1 and after["memos"] == 0
    assert _identity_ok(after) and block == after


def test_memoizable_argv_matches_jax():
    jx, pt = package("jax"), package("torch")
    for argv in (
        ["-no-daemon=true", "-max-reassign=1"],
        ["-no-daemon=true", "-fused=true", "-fused-shard=true"],
        ["-no-daemon=true", "-from-zk=zk:2181"],
        ["-no-daemon=true", "-metrics-json=/x"],
        ["-no-daemon=true", "-explain=-"],
        ["-no-daemon=true", "-pprof=true"],
        ["-no-daemon=true", "-unique=true", "-full-output=true"],
    ):
        assert pt.speculate.memoizable_argv(argv) == (
            jx.speculate.memoizable_argv(argv)
        ), argv


def test_non_memoizable_request_never_speculates(sock_dir):
    """A mesh-exclusive ``-fused-shard`` request is never speculated on
    (it would drain every lane as idle work)."""
    pkg = package("torch")
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    try:
        src = os.path.join(sock_dir, "c.json")
        state = _state()
        for _ in range(2):
            _write(src, state)
            rc, out, _ = run_pkg(pkg, [
                "-input-json", f"-input={src}", "-max-reassign=1", "-fused",
                "-fused-batch=4", "-fused-shard", f"-serve-socket={sock}"])
            assert rc == 0
            _apply(state, out)
        time.sleep(0.3)
        st = d.speculator.stats()
    finally:
        runner.stop()
    assert st["attempts"] == 0 and st["memos"] == 0, st


def _slow_internal(monkeypatch, started, sleep_s, preempt_first=None):
    """Make every internal (speculative) run of the port's daemon sleep
    before it plans; ``preempt_first`` (a Speculator) is preempted
    before the run starts planning, so it aborts at its first check."""
    from kafkabalancer_tpu_torch import cli

    real = cli.run

    def run(i, o, e, args, **kw):
        if threading.current_thread().name.startswith("serve-int-"):
            started.set()
            time.sleep(sleep_s)
            if preempt_first is not None:
                preempt_first._preempt.set()
        return real(i, o, e, args, **kw)

    monkeypatch.setattr(cli, "run", run)


def test_request_waits_for_inflight_speculation(sock_dir, monkeypatch):
    """A digest-matching request arriving while its answer is still
    being speculated waits for the run and answers from the fresh memo —
    no resync, no second dispatch."""
    pkg = package("torch")
    started = threading.Event()
    _slow_internal(monkeypatch, started, 0.8)
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    src = os.path.join(sock_dir, "c.json")
    args = ["-input-json", f"-input={src}", "-max-reassign=1"]
    try:
        state = _state()
        _write(src, state)
        rc, out, _ = run_pkg(pkg, args + [f"-serve-socket={sock}"])
        assert rc == 0
        _apply(state, out)
        assert started.wait(10)
        _write(src, state)
        want = run_pkg(pkg, args + ["-no-daemon"])
        got = run_pkg(pkg, args + [f"-serve-socket={sock}"])
        assert got[:2] == want[:2]
        st = d.speculator.stats()
        ss = d.sessions.stats()
    finally:
        runner.stop()
    assert st["hits"] >= 1, st
    assert ss["resyncs_rows"] == 0 and ss["resyncs_full"] == 0


@pytest.mark.parametrize("path", ["greedy", "fused"])
def test_real_traffic_preempts_speculation(sock_dir, monkeypatch, path):
    """Another tenant's request arriving mid-speculation: the arrival
    hook preempts, the speculative run aborts at its next chunk round
    (``-fused``) or applied move (greedy), the live request answers
    byte-identically, and the books balance."""
    pkg = package("torch")
    started = threading.Event()
    _slow_internal(monkeypatch, started, 0.6)
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True)
    d = runner.start()
    extra = PATHS[path][0]
    try:
        a_path = os.path.join(sock_dir, "a.json")
        b_path = os.path.join(sock_dir, "b.json")
        _write(a_path, _state())
        _write(b_path, _state())
        assert run_pkg(pkg, ["-input-json", f"-input={a_path}",
                             "-max-reassign=1", f"-serve-socket={sock}"]
                       + extra)[0] == 0
        assert started.wait(10)
        b_args = ["-input-json", f"-input={b_path}", "-max-reassign=1"] + extra
        t0 = time.perf_counter()
        got = run_pkg(pkg, b_args + [f"-serve-socket={sock}"])
        wall = time.perf_counter() - t0
        assert got[:2] == run_pkg(pkg, b_args + ["-no-daemon"])[:2]
        assert wall < 10.0
        st = _idle(d)
    finally:
        runner.stop()
    assert st["aborted"] >= 1 and _identity_ok(st), st


def test_speculating_daemon_honors_idle_timeout(sock_dir):
    pkg = package("torch")
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True, idle_timeout=2.0)
    d = runner.start()
    src = os.path.join(sock_dir, "c.json")
    _write(src, _state())
    t_last = time.monotonic()
    assert run_pkg(pkg, ["-input-json", f"-input={src}", "-max-reassign=1",
                         f"-serve-socket={sock}"])[0] == 0
    assert _settled(d)["attempts"] >= 1
    runner.t.join(15)
    assert runner.rc_box == [0]
    assert time.monotonic() - t_last < 12.0
    runner.t = None


def test_speculation_off_keeps_the_block(sock_dir):
    jx, pt = package("jax"), package("torch")
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pt, sock)
    runner.start()
    try:
        src = os.path.join(sock_dir, "c.json")
        _write(src, _state())
        assert run_pkg(pt, ["-input-json", f"-input={src}",
                            "-max-reassign=1", f"-serve-socket={sock}"])[0] == 0
        time.sleep(0.3)
        doc = pt.client.fetch_stats(sock)
        w = pt.client.fetch_watch(sock)
    finally:
        runner.stop()
    spec = doc["speculation"]
    assert spec["enabled"] is False
    assert spec["attempts"] == 0 and spec["memos"] == 0
    assert set(spec) == set(jx.speculate.Speculator(None).stats())
    assert set(doc["watch"]) == set(jx.speculate.ZkWatcher.disabled_stats())
    assert doc["watch"]["enabled"] is False
    assert w is not None and w["watch"] == doc["watch"]
    assert set(doc["paging"]) == set(jx.spill.SpillStore.disabled_stats())


def test_memo_hit_refreshes_spill_record(sock_dir):
    """The continuous spill moves with a memo hit: the warm record
    holds the state the client describes next (the live memo's key)."""
    pkg = package("torch")
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True,
                       spill_dir=os.path.join(sock_dir, "spill"))
    d = runner.start()
    src = os.path.join(sock_dir, "c.json")
    args = ["-input-json", f"-input={src}", "-max-reassign=1",
            f"-serve-socket={sock}"]
    try:
        state = _state()
        for _step in range(3):
            _write(src, state)
            rc, out, _ = run_pkg(pkg, args)
            assert rc == 0
            _apply(state, out)
            _settled(d)
        assert d.speculator.stats()["hits"] >= 1
        key = next(iter(d.sessions._sessions))
        memo = d.sessions._sessions[key].spec_memo
        hdr, _rows = d.spill.load(key)
    finally:
        runner.stop()
    assert memo is not None and hdr["digest"] == memo.key_digest


# --- the speculator's books ---------------------------------------------------


class _S:
    released = False
    spec_memo = None


def test_memo_retirement_is_exactly_once():
    pt = package("torch").speculate
    sp = pt.Speculator(None, enabled=True)
    sess = _S()
    memo = pt.SpecMemo("d0", [], 0, "", "", "d1")
    sp.attach_memo(sess, memo)
    sp.poison_session(sess)
    assert not sp.take_memo(sess, memo)
    sp.retire_miss(sess, memo)
    st = sp.stats()
    assert (st["hits"], st["misses"], st["poisoned"]) == (0, 0, 1)
    assert _identity_ok(st)
    memo2 = pt.SpecMemo("d1", [], 0, "", "", "d2")
    sp.attach_memo(sess, memo2)
    assert sp.take_memo(sess, memo2)
    sp.untake_memo(sess, memo2)
    assert sess.spec_memo is memo2
    st = sp.stats()
    assert st["hits"] == 0 and st["memos"] == 1 and _identity_ok(st)
    assert sp.take_memo(sess, memo2)
    sess.released = True
    sp.untake_memo(sess, memo2)
    assert sess.spec_memo is None and _identity_ok(sp.stats())


def test_fixed_point_memo_rearm():
    pt = package("torch").speculate
    sp = pt.Speculator(None, enabled=True)
    sess = _S()
    fixed = pt.SpecMemo("d0", [], 0, "out", "", "d0")
    sp.attach_memo(sess, fixed)
    assert sp.take_memo(sess, fixed)
    assert sp.rearm_memo(sess, fixed)
    st = sp.stats()
    assert (st["attempts"], st["hits"], st["memos"]) == (2, 1, 1)
    assert not sp.rearm_memo(sess, pt.SpecMemo("d0", [], 0, "", "", "d1"))
    assert not sp.rearm_memo(sess, pt.SpecMemo("d0", [], 2, "", "", "d0"))
    assert sp.take_memo(sess, fixed)
    sp.retire_miss(sess, fixed)
    assert _identity_ok(sp.stats())


def test_abort_check_machinery():
    pt = package("torch").speculate
    calls = []
    pt.install_abort_check(lambda: calls.append(1))
    try:
        pt.maybe_abort_dispatch()
    finally:
        pt.install_abort_check(None)
    pt.maybe_abort_dispatch()
    assert calls == [1]
    sp = pt.Speculator(None, enabled=True)
    assert not sp.preempted()
    sp._inflight = pt._Inflight(("t", "s"), "d", [])
    sp.note_real_traffic()
    assert sp.preempted()
    with pytest.raises(pt.SpeculationAborted):
        sp.maybe_abort()
    assert not issubclass(pt.SpeculationAborted, Exception)


def test_chunk_round_checks_for_an_abort(monkeypatch):
    """``plan``'s chunk loop consults the abort check once per chunk
    round, before the chunk reaches the device (``_run_chunk``), and the
    abort passes through the engine's RuntimeError/ValueError ladder."""
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers import scan

    pt = package("torch").speculate
    pl = get_partition_list_from_reader(open(FIXTURE), True, [])
    rounds = []

    def check():
        rounds.append(1)
        if len(rounds) == 2:
            raise pt.SpeculationAborted("preempted")

    pt.install_abort_check(check)
    try:
        with pytest.raises(pt.SpeculationAborted):
            scan.plan(pl, default_rebalance_config(), 50, batch=1,
                      chunk_moves=1, device="cpu")
    finally:
        pt.install_abort_check(None)
    assert len(rounds) == 2


# --- resident state after speculation ----------------------------------------


def _snapshot(pkg, sess):
    rc = sess.row_cache
    return {
        "raw": [pkg.state.partition_fields(p) for p in sess.raw],
        "canon": list(sess.canon),
        "digest": sess.digest,
        "version": sess.version,
        "pl": None if sess.pl is None else [
            pkg.state.partition_fields(p) for p in sess.pl.partitions
        ],
        "cache_meta": rc._meta,
        "cache_keys": list(rc._keys),
        "cache_ids": None if rc._ids is None else rc._ids.copy(),
        "cache_arrays": {k: v.copy() for k, v in rc._arrays.items()},
    }


def _same(a, b, skip=()):
    assert set(a) == set(b)
    for k in a:
        if k in skip:
            continue
        if k == "cache_arrays":
            assert set(a[k]) == set(b[k])
            for name in a[k]:
                x, y = a[k][name], b[k][name]
                assert x.dtype == y.dtype and x.shape == y.shape, name
                assert np.array_equal(x, y), name
        elif k == "cache_ids":
            assert (a[k] is None) == (b[k] is None)
            if a[k] is not None:
                assert np.array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _first_request(pkg, sock_dir, tag, extra, speculate):
    sock = os.path.join(sock_dir, f"{tag}.sock")
    src = os.path.join(sock_dir, f"{tag}.json")
    runner = PkgDaemon(pkg, sock, speculate=speculate)
    d = runner.start()
    state = _state()
    _write(src, state)
    args = ["-input-json", f"-input={src}", "-max-reassign=1"] + extra
    rc, out, _ = run_pkg(pkg, args + [f"-serve-socket={sock}"])
    assert rc == 0
    _apply(state, out)
    return runner, d, src, state, args, sock


@pytest.mark.parametrize("path", ["greedy", "fused", "pallas"])
def test_completed_speculation_leaves_the_live_state(sock_dir, path):
    """A completed speculative run leaves the session exactly as a live
    request serving the same move does — raw rows, canonical bytes,
    digest, settled list, row-cache masters, bit for bit — and the JAX
    daemon's session after the same run holds the same rows and digest."""
    pt, jx = package("torch"), package("jax")
    extra = PATHS[path][0]
    spec, d, _src, _state_, _args, _sock = _first_request(
        pt, sock_dir, "spec", extra, True)
    try:
        st = _settled(d)
        assert st["attempts"] == 1 and st["memos"] == 1
        sess = next(iter(d.sessions._sessions.values()))
        after_spec = _snapshot(pt, sess)
        memo = sess.spec_memo
    finally:
        spec.stop()
    live, d2, src, state, args, sock = _first_request(
        pt, sock_dir, "live", extra, False)
    try:
        _write(src, state)
        rc, out, _ = run_pkg(pt, args + [f"-serve-socket={sock}"])
        assert rc == 0 and out == memo.stdout
        assert d2.sessions.stats()["delta_hits"] == 1
        after_live = _snapshot(pt, next(iter(d2.sessions._sessions.values())))
    finally:
        live.stop()
    _same(after_spec, after_live)
    assert memo.next_digest == after_spec["digest"]
    jspec, jd, *_ = _first_request(jx, sock_dir, "jax", PATHS[path][1], True)
    try:
        _settled(jd)
        jsess = next(iter(jd.sessions._sessions.values()))
        jsnap = _snapshot(jx, jsess)
        jmemo = jsess.spec_memo
    finally:
        jspec.stop()
    for k in ("raw", "canon", "digest", "version"):
        assert after_spec[k] == jsnap[k], k
    assert (jmemo.stdout, jmemo.key_digest) == (memo.stdout, memo.key_digest)


@pytest.mark.parametrize("path,at", [
    ("greedy", "move"), ("fused", "chunk"), ("fused", "move"),
])
def test_aborted_speculation_leaves_the_snapshot(sock_dir, monkeypatch, path,
                                                 at):
    """A speculative run aborted at a chunk round (before the session
    reaches the device) or at its first applied move (after the torch
    session ran) leaves the raw shadow and canonical bytes bit for bit
    as they were before it, and the row-cache masters bit for bit as a
    completed run of the same move leaves them (both encode the same
    pre-move state; nothing the session commits in place reaches them).
    The prediction is poisoned (digest None, as the reference), and the
    next request answers byte-identically through a resync."""
    from kafkabalancer_tpu_torch.solvers import scan

    pt = package("torch")
    extra = PATHS[path][0]
    done, d0, *_ = _first_request(pt, sock_dir, "done", extra, True)
    try:
        _settled(d0)
        completed = _snapshot(pt, next(iter(d0.sessions._sessions.values())))
    finally:
        done.stop()
    runner, d, src, state, args, sock = _first_request(
        pt, sock_dir, "p", extra, False)
    try:
        key, sess = next(iter(d.sessions._sessions.items()))
        before = _snapshot(pt, sess)
        started = threading.Event()
        if at == "chunk" or path == "greedy":
            # greedy has no chunk round: its first check is the first
            # applied move
            _slow_internal(monkeypatch, started, 0.0,
                           preempt_first=d.speculator)
        else:
            real = scan._decode_packed

            def decode(*a, **kw):
                started.set()
                d.speculator._preempt.set()
                return real(*a, **kw)

            monkeypatch.setattr(scan, "_decode_packed", decode)
        d.speculator.enabled = True
        d.speculator.start()
        d.speculator.enqueue(key)
        assert started.wait(10)
        deadline = time.monotonic() + 10
        while d.speculator.stats()["aborted"] < 1 and (
            time.monotonic() < deadline
        ):
            time.sleep(0.02)
        st = _idle(d)
        assert st["aborted"] == 1 and st["attempts"] == 0, st
        after = _snapshot(pt, sess)
        _same(before, after, skip=("digest", "pl", "cache_meta",
                                   "cache_keys", "cache_ids",
                                   "cache_arrays"))
        _same(completed, after, skip=("raw", "canon", "digest", "pl"))
        assert after["digest"] is None
        monkeypatch.undo()
        d.speculator.enabled = False
        _write(src, state)
        want = run_pkg(pt, args + ["-no-daemon"])
        got = run_pkg(pt, args + [f"-serve-socket={sock}"])
        assert got[:2] == want[:2]
    finally:
        runner.stop()


# --- the watcher --------------------------------------------------------------


class _MutableZk:
    """An in-process dict-backed ZK fake whose whole tree swaps
    atomically (one attribute rebind)."""

    def __init__(self):
        self.tree = {}

    def start(self, timeout=10):
        pass

    def stop(self):
        pass

    def close(self):
        pass

    def get_children(self, path, watcher=None):
        return sorted(self.tree)

    def get(self, path, watcher=None):
        name = path.rsplit("/", 1)[1]
        return json.dumps(
            {"version": 1, "partitions": self.tree[name]}
        ).encode("utf-8"), None


def _oracle_input(tree):
    rows = [
        {"topic": t, "partition": int(pid), "replicas": tree[t][pid]}
        for t in sorted(tree)
        for pid in sorted(tree[t], key=int)
    ]
    return json.dumps({"version": 1, "partitions": rows})


def _next_plan(emit, seen, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        files = sorted(
            f for f in os.listdir(emit) if f.endswith(".json")
        ) if os.path.isdir(emit) else []
        if len(files) > seen:
            return os.path.join(emit, files[seen])
        time.sleep(0.03)
    return None


def _watch_run(name, sock_dir, extra, rounds=3):
    pkg = package(name)
    zk = _MutableZk()
    zk.tree = {"w": {str(i): [0, 1] for i in range(8)}}
    zk.tree["w"]["0"] = [2, 3]
    pkg.zk.set_zk_client_factory(lambda hosts: zk)
    emit = os.path.join(sock_dir, f"{name}-plans")
    sock = os.path.join(sock_dir, f"{name}.sock")
    runner = PkgDaemon(
        pkg, sock, speculate=True, idle_timeout=0.0,
        watch_conn="fake:2181", watch_emit=emit, watch_poll=0.1,
        watch_argv=["-no-daemon=true", "-max-reassign=1"] + extra,
    )
    runner.start()
    plans = []
    try:
        for rnd in range(rounds):
            path = _next_plan(emit, rnd)
            assert path is not None, (name, rnd)
            got = open(path).read()
            want = run_pkg(pkg, ["-input-json", "-max-reassign=1",
                                 "-no-daemon"] + extra,
                           stdin=_oracle_input(zk.tree))
            assert got == want[1], (name, rnd)
            meta = json.load(open(path[:-len(".json")] + ".meta"))
            plans.append((got, meta["moves"]))
            tree = json.loads(json.dumps(zk.tree))
            for entry in json.loads(got).get("partitions") or []:
                tree[entry["topic"]][str(entry["partition"])] = list(
                    entry["replicas"])
            zk.tree = tree
        # the tree converges after these rounds: the watcher plans no
        # move (a no-op plan) and emits nothing more
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            w = pkg.client.fetch_watch(sock)
            if w["watch"]["noop_plans"] >= 1:
                break
            time.sleep(0.05)
        stats = pkg.client.fetch_stats(sock)
        # out-of-band drift under the watcher
        tree = json.loads(json.dumps(zk.tree))
        tree["w"]["3"] = [4, 5]
        zk.tree = tree
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            w2 = (pkg.client.fetch_watch(sock) or {}).get("watch") or {}
            if w2.get("resyncs", 0) >= 1:
                break
            time.sleep(0.05)
    finally:
        runner.stop()
        pkg.zk.set_zk_client_factory(None)
    return plans, w, stats, w2


@pytest.mark.parametrize("path", ["greedy", "fused"])
def test_watcher_emits_the_jax_plans(sock_dir, path):
    jplans, *_ = _watch_run("jax", sock_dir, PATHS[path][1])
    plans, w, stats, w2 = _watch_run("torch", sock_dir, PATHS[path][0])
    assert plans == jplans
    assert w["watch"]["plans_emitted"] == 3 and w["watch"]["errors"] == 0
    assert w["watch"]["noop_plans"] >= 1
    assert w["watch"]["spec_hits"] >= 1, w["watch"]
    assert w["watch"]["last_event_lag_s"] is not None
    assert _identity_ok(w["speculation"])
    assert stats["requests"] == 0  # no client ever planned
    assert w2.get("resyncs", 0) >= 1


def test_watcher_reads_the_file_fake(sock_dir, monkeypatch):
    """``-watch`` over ``$KAFKABALANCER_TPU_FAKE_ZK`` (the file-backed
    fake a machine without kazoo uses): the emitted plan equals
    ``-from-zk`` through ``-no-daemon`` on the same tree."""
    pkg = package("torch")
    root = os.path.join(sock_dir, "zk")
    topics = os.path.join(root, "brokers", "topics")
    os.makedirs(topics)
    tree = {str(i): [0, 1] for i in range(8)}
    tree["0"] = [2, 3]
    with open(os.path.join(topics, "w"), "w") as f:
        json.dump({"version": 1, "partitions": tree}, f)
    monkeypatch.setenv("KAFKABALANCER_TPU_FAKE_ZK", root)
    emit = os.path.join(sock_dir, "plans")
    sock = os.path.join(sock_dir, "p.sock")
    runner = PkgDaemon(pkg, sock, speculate=True, idle_timeout=0.0,
                       watch_conn="zk1:2181", watch_emit=emit,
                       watch_poll=0.1,
                       watch_argv=["-no-daemon=true", "-max-reassign=1"])
    runner.start()
    try:
        path = _next_plan(emit, 0)
        assert path is not None
        want = run_pkg(pkg, ["-from-zk=zk1:2181", "-max-reassign=1",
                             "-no-daemon"])
        assert open(path).read() == want[1] and want[0] == 0
    finally:
        runner.stop()


# --- flags --------------------------------------------------------------------


@pytest.mark.parametrize("args,says", [
    (["-watch=zk:2181"], "-watch requires -serve"),
    (["-serve", "-watch=zk:2181"], "requires -watch-emit"),
    (["-watch-emit=plans"], "-watch-emit requires -watch"),
    (["-serve", "-watch-emit=-"], "-watch-emit requires -watch"),
    (["-watch=zk:2181", "-watch-emit=-"], "-watch requires -serve"),
])
def test_watch_flag_checks_match_jax(args, says):
    jx, pt = package("jax"), package("torch")
    jrc, jout, jerr = run_pkg(jx, args)
    prc, pout, perr = run_pkg(pt, args)
    assert (prc, pout) == (jrc, jout) == (3, "")
    line = [x for x in _TS.sub("", perr).splitlines() if says in x]
    assert line and line == [
        x for x in _TS.sub("", jerr).splitlines() if says in x
    ]


@pytest.mark.parametrize("extra,want", [
    ([], 0.0),
    (["-serve-idle-timeout=900"], 900.0),
    (["-serve-idle-timeout=30"], 30.0),
])
def test_watch_mode_drops_the_default_idle_timeout(monkeypatch, extra, want):
    jx, pt = package("jax"), package("torch")
    seen = {}
    for pkg in (jx, pt):
        monkeypatch.setattr(
            pkg.Daemon, "serve_forever",
            lambda self, n=pkg.name: seen.__setitem__(
                n, (self.idle_timeout, self.watch_conn, self.watch_emit,
                    self.watch_poll, self.watch_argv, self.speculator.enabled,
                    self.spill_dir, self.warm_cap_mb)) or 0,
        )
        rc, _out, err = run_pkg(pkg, [
            "-serve", "-serve-socket=/nonexistent/kb.sock",
            "-watch=zk1:2181", "-watch-emit=-", "-watch-poll=0.5",
            "-serve-session-spill-dir=/nonexistent/spill",
            "-serve-warm-cap-mb=8", "-max-reassign=2"] + extra)
        assert rc == 0
        assert ("default -serve-idle-timeout disabled" in err) is (not extra)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == want
    assert seen["torch"][4] == ["-no-daemon=true", "-max-reassign=2"]
