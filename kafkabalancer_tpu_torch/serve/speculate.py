"""Speculative plan-ahead and the watch-driven continuous controller.

The resident-session steady state (serve/sessions.py) already removed
parse/settle/tensorize from the served hot path — what remains of the
daemon-side time is the DISPATCH itself. But after answering
request N the lane sits idle, and the session already holds exactly the
post-move state the next request will describe (the mutation tap
mirrored the daemon's own emitted moves into the raw shadow). So keep
the *answer* resident, not just the state:

- :class:`Speculator` — after a clean session-backed plan, an
  idle-priority worker re-plans the NEXT move on the (already settled,
  trusted-delta-primed) resident session and memoizes the full answer
  (rc + plan stdout + stderr) keyed by the digest it predicts the
  client will send. A digest-and-argv-matching next request answers
  from the memo with ZERO dispatch (serve/daemon.py
  ``_answer_from_memo``); anything else drops the memo and falls back
  to the live delta/resync ladder with byte parity intact — the memo
  can make a request *faster*, never *different*.

  Speculation is PREEMPTIBLE: it only starts when the daemon is idle,
  any real plan-family dispatch sets the preempt flag
  (:meth:`Speculator.note_real_traffic`, wired through admission
  arrival), and the in-flight speculative run aborts cooperatively at
  the next solver chunk round or applied move
  (:func:`maybe_abort_dispatch`, raised as
  :class:`SpeculationAborted`) so live-traffic p95 cannot regress.
  An aborted run leaves the session's prediction poisoned — the next
  request re-syncs from ground truth, degraded but never wrong.

  Accounting model (the scrape's ``speculation`` block): every
  completed speculative run either produces a memo (``attempts``) or
  not (``aborted``); every memo retires exactly one way — ``hits``
  (consumed by a matching request), ``misses`` (a request arrived but
  could not use it: digest/argv mismatch or a resync path), or
  ``poisoned`` (lifecycle retirement: release / eviction / external
  drift / a crashed request). The exact identity
  ``attempts == hits + misses + poisoned + memos`` holds at every
  scrape instant (``memos`` = memos currently live);
  ``wasted_dispatches = misses + poisoned`` is the device work paid
  without payoff.

- :class:`ZkWatcher` — the ``-watch`` mode: the daemon subscribes to
  Zookeeper itself (codecs/zookeeper.py; kazoo watches where the
  client supports them, a poll-interval fallback everywhere), applies
  change events to a resident session, re-plans — speculation makes
  the steady-state re-plan a memo read — and streams reassignment
  plans to a sink (``-watch-emit <dir|->``). No client process exists
  in the steady state at all; the ``watch`` protocol op exposes watch
  lag (``serve/client.py`` ``fetch_watch``; the same block rides the
  ``stats`` document).

Neither class imports torch; the speculative run itself executes
through the ordinary dispatcher as an INTERNAL request
(``PlanRequest.internal``) — on the lane's request thread, under the
lane's device and default stream, never on this module's own threads —
that never touches the idle-timeout clock, ``serve.requests``,
``serve.request_s`` or the flight-recorder request log; it carries its
own ``serve.spec.plan_s`` / ``serve.watch.plan_s`` histograms instead.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from kafkabalancer_tpu_torch import obs

SessionKey = Tuple[str, str]
LogFn = Callable[[str], None]

# forwarded-argv prefixes that make an answer non-memoizable: the
# telemetry trio / explain write per-invocation side effects (files,
# appended stdout; parsed but not ported in this package, ROADMAP.md
# A1), profiling pins work to a process, zookeeper input
# re-reads external state, and a mesh-exclusive -fused-shard run must
# never be launched as idle work (it drains every lane)
_NON_MEMOIZABLE = (
    "-metrics-json=", "-trace=", "-stats=", "-explain=",
    "-pprof", "-jax-profile=", "-from-zk=", "-fused-shard=",
)

# how long the idle-priority worker waits for the daemon to go idle
# before deferring a queued speculation (the next real request
# re-enqueues it)
IDLE_WAIT_S = 30.0
# how long a mismatching request waits for an aborted in-flight
# speculative run to unwind before giving up (resync-full fallback)
ABORT_WAIT_S = 30.0
# busy-session retry: the enqueue can race the enqueuing request's own
# checkin by microseconds
BUSY_RETRIES = 20
BUSY_RETRY_SLEEP_S = 0.05


class SpeculationAborted(BaseException):
    """Raised inside a speculative run when real traffic preempts it.

    A ``BaseException`` on purpose: the solver's fail-open ladders catch
    ``Exception`` broadly, and a preemption must unwind the whole run,
    not degrade it to a slower engine."""


_tls = threading.local()


def install_abort_check(fn: Optional[Callable[[], None]]) -> None:
    """Install (or clear, with None) the calling thread's speculative
    abort check — set by the daemon around an internal speculative
    ``cli.run`` and consulted by the dispatch seams below."""
    _tls.fn = fn


def maybe_abort_dispatch() -> None:
    """The cooperative preemption seam: a no-op on every thread without
    an installed check (one getattr), called from
    ``solvers.scan._run_chunk`` (per device chunk round) and
    ``serve.sessions.PlanSessionContext.change`` (per applied move).
    Raises :class:`SpeculationAborted` when preempted."""
    fn = getattr(_tls, "fn", None)
    if fn is not None:
        fn()


class SpecMemo:
    """One memoized answer: the full response a digest-matching next
    request receives, plus the post-move digest the session advanced
    to (the next prediction)."""

    __slots__ = ("key_digest", "argv", "rc", "stdout", "stderr",
                 "next_digest")

    def __init__(
        self,
        key_digest: str,
        argv: List[str],
        rc: int,
        stdout: str,
        stderr: str,
        next_digest: str,
    ) -> None:
        self.key_digest = key_digest
        self.argv = argv
        self.rc = rc
        self.stdout = stdout
        self.stderr = stderr
        self.next_digest = next_digest


class _Inflight:
    __slots__ = ("key", "digest", "argv", "done")

    def __init__(self, key: SessionKey, digest: str, argv: List[str]) -> None:
        self.key = key
        self.digest = digest
        self.argv = argv
        self.done = threading.Event()


def memoizable_argv(argv: List[str]) -> bool:
    """Whether a forwarded canonical argv's answer is safe to memoize
    (pure function of session state — no per-invocation side effects)."""
    return not any(a.startswith(_NON_MEMOIZABLE) for a in argv)


class Speculator:
    """The idle-priority plan-ahead worker; see the module docstring.

    Thread-safety: one lock owns the counters and the memo population
    count; the inflight slot is written under it and read racily by the
    cheap preemption checks (a stale read only costs one conservative
    abort or one extra wait tick, never correctness)."""

    def __init__(self, daemon: Any, enabled: bool = False) -> None:
        self._d = daemon
        self.enabled = enabled
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._dq: Deque[Tuple[SessionKey, int]] = deque()
        self._queued: Set[SessionKey] = set()
        self._stop_flag = False
        self._preempt = threading.Event()
        self._inflight: Optional[_Inflight] = None
        self._thread: Optional[threading.Thread] = None
        # the accounting model (module docstring): attempts == hits +
        # misses + poisoned + memos, at every instant
        self.attempts = 0
        self.hits = 0
        self.misses = 0
        self.poisoned = 0
        self.aborted = 0
        self.deferred = 0
        self._memos = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serve-spec", daemon=True
        )
        self._thread.start()

    def request_stop(self) -> None:
        """Flag shutdown: the in-flight run aborts at its next check,
        the worker exits after it unwinds (join separately)."""
        with self._cv:
            self._stop_flag = True
            self._cv.notify_all()
        self._preempt.set()

    def join(self, timeout: float = 15.0) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- preemption -------------------------------------------------------
    def note_real_traffic(self) -> None:
        """A real plan-family request arrived (admission arrival hook):
        preempt any in-flight speculative dispatch."""
        if self._inflight is not None:
            self._preempt.set()

    def preempted(self) -> bool:
        return self._preempt.is_set() or self._stop_flag

    def maybe_abort(self) -> None:
        if self.preempted():
            raise SpeculationAborted("preempted by real traffic")

    def wait_for_key(
        self,
        key: SessionKey,
        digest: str,
        argv: List[str],
        budget_s: float,
    ) -> bool:
        """A plan-family request found its session busy: if speculation
        holds it, wait it out — a MATCHING in-flight run is this very
        request's answer being computed (wait the full budget), a
        mismatching one is aborted and waited briefly. Returns True
        when speculation was involved (the caller re-claims the
        session), False when the session is busy for another reason."""
        inf = self._inflight
        if inf is None or inf.key != key:
            return False
        if inf.digest == digest and inf.argv == argv:
            inf.done.wait(max(0.1, budget_s))
            return True
        self._preempt.set()
        inf.done.wait(min(max(0.1, budget_s), ABORT_WAIT_S))
        return True

    # -- the queue --------------------------------------------------------
    def enqueue(self, key: SessionKey) -> None:
        """Ask for a plan-ahead of ``key``'s next move (idle-priority;
        deduplicated; a no-op when speculation is off)."""
        if not self.enabled:
            return
        with self._cv:
            if self._stop_flag or key in self._queued:
                return
            self._queued.add(key)
            self._dq.append((key, 0))
            self._cv.notify_all()

    # -- memo accounting (the one owner of the counters) ------------------
    # Every sess.spec_memo mutation is a compare-and-swap under THIS
    # lock: a memo retires exactly once (hit, miss, or poisoned) even
    # when a `release`/replacement poisons it concurrently with a
    # request consuming it — a double retirement would break the
    # attempts == hits + misses + poisoned + memos identity forever.
    def attach_memo(self, sess: Any, memo: SpecMemo) -> None:
        with self._lock:
            sess.spec_memo = memo
            self.attempts += 1
            self._memos += 1

    def take_memo(self, sess: Any, memo: SpecMemo) -> bool:
        """Consume ``memo`` as a HIT iff it is still the session's live
        memo; False means a concurrent lifecycle event retired it first
        (the caller falls back to the live ladder)."""
        with self._lock:
            if getattr(sess, "spec_memo", None) is not memo:
                return False
            sess.spec_memo = None
            self.hits += 1
            self._memos -= 1
            return True

    def untake_memo(self, sess: Any, memo: SpecMemo) -> None:
        """Undo a :meth:`take_memo` whose answer was never delivered
        (the hit request was shed at admission): re-attach the memo so
        the client's backoff retry can still hit. Safe because the
        memo slot stayed None the whole time (no poison could land)."""
        with self._lock:
            if (
                getattr(sess, "spec_memo", None) is None
                and not sess.released
            ):
                sess.spec_memo = memo
                self.hits -= 1
                self._memos += 1

    def rearm_memo(self, sess: Any, memo: SpecMemo) -> bool:
        """Re-attach a just-consumed memo whose answer is a FIXED
        POINT: the plan moved nothing (``next_digest == key_digest``),
        so serving it did not advance the session and the identical
        next request deserves the identical answer — without burning a
        device dispatch re-deriving it. The steady-state poll loop
        (edge residency: an unchanged input stat-hitting the client
        cache every few seconds) collapses to zero speculative
        dispatches this way. Counted as a fresh zero-cost attempt, so
        the attempts == hits + misses + poisoned + memos identity is
        undisturbed. False when the slot is no longer re-armable (a
        concurrent release/poison or a newer memo won) — the caller
        falls back to a normal plan-ahead enqueue."""
        with self._lock:
            if (
                memo.next_digest != memo.key_digest
                or memo.rc != 0
                or getattr(sess, "spec_memo", None) is not None
                or getattr(sess, "released", False)
            ):
                return False
            sess.spec_memo = memo
            self.attempts += 1
            self._memos += 1
            return True

    def retire_miss(self, sess: Any, memo: SpecMemo) -> None:
        """Retire ``memo`` as a MISS (a request arrived that cannot use
        it) — a no-op when a concurrent event already retired it."""
        with self._lock:
            if getattr(sess, "spec_memo", None) is memo:
                sess.spec_memo = None
                self.misses += 1
                self._memos -= 1

    def poison_session(self, sess: Any) -> None:
        """Retire a session's live memo as poisoned (store removal,
        release, external drift) — safe to call with any lock held
        except this speculator's own."""
        with self._lock:
            if getattr(sess, "spec_memo", None) is not None:
                sess.spec_memo = None
                self.poisoned += 1
                self._memos -= 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "attempts": self.attempts,
                "hits": self.hits,
                "misses": self.misses,
                "poisoned": self.poisoned,
                "aborted": self.aborted,
                "deferred": self.deferred,
                "wasted_dispatches": self.misses + self.poisoned,
                "memos": self._memos,
                "inflight": self._inflight is not None,
            }

    # -- the worker -------------------------------------------------------
    def _busy(self) -> bool:
        d = self._d
        if d._admission.busy():
            return True
        disp = d._coalescer
        return disp is not None and bool(disp.busy())

    # thread-role: speculate
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._dq and not self._stop_flag:
                    self._cv.wait()
                if self._stop_flag:
                    return
                key, tries = self._dq.popleft()
                self._queued.discard(key)
            # idle gate: real traffic owns the device; speculation only
            # starts once the daemon has nothing better to do
            t0 = time.monotonic()
            deferred = False
            while self._busy():
                if self._stop_flag:
                    return
                if time.monotonic() - t0 > IDLE_WAIT_S:
                    with self._lock:
                        self.deferred += 1
                    deferred = True
                    break
                time.sleep(0.02)
            if deferred:
                continue
            try:
                self._run_one(key, tries)
            except Exception as exc:  # never kill the worker
                with self._lock:
                    self.aborted += 1
                self._d._log(f"serve: speculation failed: {exc!r}")

    def _requeue(self, key: SessionKey, tries: int) -> None:
        if tries >= BUSY_RETRIES:
            return
        time.sleep(BUSY_RETRY_SLEEP_S)
        with self._cv:
            if self._stop_flag or key in self._queued:
                return
            self._queued.add(key)
            self._dq.append((key, tries + 1))
            self._cv.notify_all()

    def _run_one(self, key: SessionKey, tries: int) -> None:
        from kafkabalancer_tpu_torch.serve.daemon import PlanRequest
        from kafkabalancer_tpu_torch.serve.sessions import PlanSessionContext

        d = self._d
        dispatcher = d._coalescer
        if dispatcher is None:
            return
        sess, busy = d.sessions.checkout(key)
        if sess is None:
            if busy:
                # the enqueuing request may still be checking in
                self._requeue(key, tries)
            return
        inf: Optional[_Inflight] = None
        try:
            if (
                sess.released
                or sess.digest is None
                or sess.spec_memo is not None
                or not sess.last_argv
                or not memoizable_argv(sess.last_argv)
            ):
                return
            argv = list(sess.last_argv)
            digest0 = sess.digest
            # mirror the live plan-delta fast path exactly: a settled
            # resident list plans as "delta"; a stale/absent one
            # re-derives from the raw shadow ("rebuild")
            kind = (
                "rebuild"
                if sess.universe_dirty or sess.pl is None
                else "delta"
            )
            ctx = PlanSessionContext(
                kind, sess,
                resident_pl=sess.pl if kind == "delta" else None,
            )
            req = PlanRequest(argv, None, sess.tenant)
            req.internal = "spec"
            req.session_ctx = ctx
            inf = _Inflight(key, digest0, argv)
            self._preempt.clear()
            with self._lock:
                self._inflight = inf
            resp = dispatcher.submit(req)
            if (
                resp is not None
                and bool(resp.get("ok"))
                and resp.get("rc") == 0
                and sess.digest is not None
                and not sess.released
            ):
                self.attach_memo(sess, SpecMemo(
                    digest0, argv, 0,
                    str(resp.get("stdout", "")),
                    str(resp.get("stderr", "")),
                    sess.digest,
                ))
            else:
                # preempted / deferred / crashed: no memo, and a
                # partially-run plan left the prediction poisoned —
                # the next request re-syncs from ground truth
                with self._lock:
                    self.aborted += 1
        finally:
            with self._lock:
                self._inflight = None
            if inf is not None:
                inf.done.set()
            d.sessions.checkin(sess)


# --- the watch-driven continuous controller --------------------------------

_WATCH_DISABLED_KEYS: Tuple[str, ...] = (
    "enabled", "conn", "emit", "ticks", "reads", "errors", "events",
    "resyncs", "plans_emitted", "noop_plans", "spec_hits",
    "last_read_age_s", "last_plan_s", "last_event_lag_s", "state_digest",
)


class ZkWatcher:
    """The ``-watch`` loop; see the module docstring.

    One thread (``serve-watch``) polls Zookeeper every ``poll_s``
    seconds (kazoo watch events wake it early when the client supports
    the ``watcher=`` kwarg), maintains a resident session under tenant
    ``zk:<conn>``, and drives the planning through the ordinary
    dispatcher as INTERNAL requests — consuming the speculator's memo
    whenever the cluster state confirms the daemon's own last emitted
    plan, which is the steady state. Watch ticks never touch the
    daemon's idle clock (the hello/scrape rule)."""

    def __init__(
        self,
        daemon: Any,
        conn: str,
        emit: str = "",
        poll_s: float = 5.0,
        argv: Optional[List[str]] = None,
        topics: Optional[List[str]] = None,
    ) -> None:
        from kafkabalancer_tpu_torch.serve.sessions import flags_signature

        self._d = daemon
        self.conn = conn
        self.emit = emit
        self.poll_s = max(0.05, poll_s)
        self.argv = list(argv) if argv else ["-no-daemon=true"]
        self.topics = list(topics or [])
        self.tenant = f"zk:{conn}"
        self._sig = flags_signature(self.argv)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._client: Optional[Any] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._prev_digest: Optional[str] = None
        self._last_planned_digest: Optional[str] = None
        self._last_plan_moves: Optional[int] = None
        self._last_read_t: Optional[float] = None
        self.ticks = 0
        self.reads = 0
        self.errors = 0
        self.events = 0
        self.resyncs = 0
        self.plans_emitted = 0
        self.noop_plans = 0
        self.spec_hits = 0
        self.last_plan_s: Optional[float] = None
        self.last_event_lag_s: Optional[float] = None
        self.state_digest: Optional[str] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        if self.emit and self.emit != "-":
            os.makedirs(self.emit, exist_ok=True)
        self._thread = threading.Thread(
            target=self._loop, name="serve-watch", daemon=True
        )
        self._thread.start()

    def request_stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def join(self, timeout: float = 15.0) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._close_client()

    @staticmethod
    def disabled_stats(conn: str = "") -> Dict[str, Any]:
        """The ``watch`` scrape block with the mode off — same key set
        as a live watcher's, so the schema never shifts."""
        out: Dict[str, Any] = {k: 0 for k in _WATCH_DISABLED_KEYS}
        out.update({
            "enabled": False, "conn": conn or None, "emit": None,
            "last_read_age_s": None, "last_plan_s": None,
            "last_event_lag_s": None, "state_digest": None,
        })
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            age = (
                round(time.monotonic() - self._last_read_t, 3)
                if self._last_read_t is not None else None
            )
            return {
                "enabled": True,
                "conn": self.conn,
                "emit": self.emit or None,
                "ticks": self.ticks,
                "reads": self.reads,
                "errors": self.errors,
                "events": self.events,
                "resyncs": self.resyncs,
                "plans_emitted": self.plans_emitted,
                "noop_plans": self.noop_plans,
                "spec_hits": self.spec_hits,
                "last_read_age_s": age,
                "last_plan_s": self.last_plan_s,
                "last_event_lag_s": self.last_event_lag_s,
                "state_digest": self.state_digest,
            }

    # -- zookeeper --------------------------------------------------------
    def _on_zk_event(self, *_a: Any, **_kw: Any) -> None:
        """kazoo watch callback: wake the loop early (the poll interval
        stays as the fallback for clients without watch support)."""
        self._wake.set()

    def _close_client(self) -> None:
        zk = self._client
        self._client = None
        if zk is None:
            return
        try:
            zk.stop()
            zk.close()
        except Exception:
            pass

    def _read_state(self) -> Any:
        from kafkabalancer_tpu_torch.codecs import zookeeper as zkmod

        if self._client is None:
            self._client = zkmod.make_zk_client(self.conn)
        return zkmod.read_cluster(
            self._client, self.topics, watcher=self._on_zk_event
        )

    # -- the loop ---------------------------------------------------------
    # thread-role: watch
    def _loop(self) -> None:
        d = self._d
        d._dispatcher_ready.wait(600.0)
        while not self._stop.is_set():
            self._wake.wait(self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._lock:
                self.ticks += 1
            try:
                self._tick()
            except Exception as exc:
                with self._lock:
                    self.errors += 1
                self._close_client()
                d._log(f"serve: watch tick failed: {exc!r}")

    def _tick(self) -> None:
        from kafkabalancer_tpu_torch.serve import state as sstate
        from kafkabalancer_tpu_torch.serve.sessions import session_from_rows

        d = self._d
        t_read0 = time.perf_counter()
        try:
            pl = self._read_state()
        except Exception as exc:
            with self._lock:
                self.errors += 1
            self._close_client()
            d._log(f"serve: watch read failed: {exc}")
            return
        parts = list(pl.iter_partitions())
        fields = [sstate.partition_fields(p) for p in parts]
        canon = [sstate.canonical_row_bytes(*f) for f in fields]
        digest = sstate.rows_digest(pl.version, canon)
        with self._lock:
            self.reads += 1
            self._last_read_t = time.monotonic()
            self.state_digest = digest
            if self._prev_digest is not None and digest != self._prev_digest:
                self.events += 1
            self._prev_digest = digest

        key = (self.tenant, self._sig)
        spec = d.speculator
        sess, busy = d.sessions.checkout(key)
        if sess is None and busy and spec is not None:
            # speculation holds the watch session: its in-flight run is
            # (in the steady state) exactly this tick's answer
            spec.wait_for_key(key, digest, self.argv, 120.0)
            sess, busy = d.sessions.checkout(key)
        if sess is None and busy:
            return  # claimed elsewhere; next tick retries
        adopted = False
        if sess is None:
            sess = session_from_rows(
                self.tenant, self._sig, pl.version, fields
            )
            sess.lock.acquire()
            sess.in_use = True
            if not d.sessions.adopt(key, sess):
                sess.in_use = False
                sess.lock.release()
                return
            adopted = True
        try:
            memo = getattr(sess, "spec_memo", None)
            memo_hit = (
                memo is not None
                and memo.key_digest == digest
                and memo.argv == self.argv
            )
            if memo_hit:
                # the cluster just confirmed the very state the
                # speculative memo answers for (the session itself has
                # already advanced past it) — the steady state:
                # _plan_and_emit below serves the memo, zero dispatch
                pass
            elif sess.digest != digest:
                if digest == self._last_planned_digest:
                    # our last emitted plan has not been applied yet:
                    # the state is the one we already planned from —
                    # re-emitting would duplicate the plan
                    return
                # external drift (or a poisoned prediction): re-adopt
                # the freshly read state as ground truth; the settled
                # list is force-rebuilt from raw on the next plan
                if spec is not None:
                    spec.poison_session(sess)
                sess.snapshot_from(pl)
                sess.pl = None
                with self._lock:
                    self.resyncs += 1
            elif (
                not adopted
                and digest == self._last_planned_digest
                and (self._last_plan_moves or 0) == 0
            ):
                return  # converged and unchanged: nothing to do
            self._plan_and_emit(sess, key, digest, t_read0)
        finally:
            d.sessions.checkin(sess)

    def _plan_and_emit(
        self, sess: Any, key: SessionKey, digest: str, t_read0: float
    ) -> None:
        from kafkabalancer_tpu_torch.serve.daemon import PlanRequest
        from kafkabalancer_tpu_torch.serve.sessions import PlanSessionContext

        d = self._d
        spec = d.speculator
        t0 = time.perf_counter()
        stdout: Optional[str] = None
        used_memo = False
        memo = getattr(sess, "spec_memo", None)
        if memo is not None and spec is not None:
            if (
                memo.key_digest == digest
                and memo.argv == self.argv
                and spec.take_memo(sess, memo)
            ):
                obs.metrics.tenant_count("serve.spec.hits", self.tenant)
                stdout = memo.stdout
                used_memo = True
                with self._lock:
                    self.spec_hits += 1
            else:
                spec.retire_miss(sess, memo)
        if stdout is None:
            kind = (
                "rebuild"
                if sess.universe_dirty or sess.pl is None
                else "delta"
            )
            ctx = PlanSessionContext(
                kind, sess,
                resident_pl=sess.pl if kind == "delta" else None,
            )
            req = PlanRequest(self.argv, None, self.tenant)
            req.internal = "watch"
            req.session_ctx = ctx
            sess.last_argv = list(self.argv)
            dispatcher = d._coalescer
            if dispatcher is None:
                return
            resp = dispatcher.submit(req)
            if resp is None or not resp.get("ok") or resp.get("rc") != 0:
                with self._lock:
                    self.errors += 1
                d._log(
                    "serve: watch plan failed: "
                    f"{(resp or {}).get('error', (resp or {}).get('rc'))}"
                )
                return
            stdout = str(resp.get("stdout", ""))
        moves = self._count_moves(stdout)
        wall = time.perf_counter() - t0
        self._last_planned_digest = digest
        self._last_plan_moves = moves
        with self._lock:
            self.last_plan_s = round(wall, 6)
        if moves > 0:
            self._emit_plan(stdout, digest, moves, used_memo)
            with self._lock:
                self.plans_emitted += 1
                self.last_event_lag_s = round(
                    time.perf_counter() - t_read0, 6
                )
        else:
            with self._lock:
                self.noop_plans += 1
        if spec is not None:
            spec.enqueue(key)

    @staticmethod
    def _count_moves(stdout: str) -> int:
        try:
            doc = json.loads(stdout)
        except ValueError:
            return 0
        parts = doc.get("partitions") if isinstance(doc, dict) else None
        return len(parts) if isinstance(parts, list) else 0

    def _emit_plan(
        self, stdout: str, digest: str, moves: int, spec_hit: bool
    ) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        if self.emit == "-":
            sys.stdout.write(stdout)
            sys.stdout.flush()
            return
        if not self.emit:
            return
        # the .meta sidecar publishes FIRST: consumers key on the plan
        # file appearing and immediately read its sidecar — the reverse
        # order would open a window where the plan exists meta-less
        meta = {
            "seq": seq,
            "digest": digest,
            "moves": moves,
            "spec_hit": spec_hit,
            "ts_epoch": round(time.time(), 3),
        }
        mpath = os.path.join(self.emit, f"plan-{seq:06d}.meta")
        mtmp = mpath + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
        os.replace(mtmp, mpath)
        path = os.path.join(self.emit, f"plan-{seq:06d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(stdout)
        os.replace(tmp, path)
