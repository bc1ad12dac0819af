"""Invocation tracer: nested and cross-thread spans, no-op when disabled.

The deployment unit is a stateless CLI process per move (the reference's
README.md:21-33), so "where did this invocation's milliseconds go" is a
question about ONE process lifecycle: parse -> flag validation -> the
background warmup/AOT-prefetch thread -> tensorize -> compile-or-load ->
device execute -> emit. This tracer records that lifecycle as spans:

- **nested** within a thread via a thread-local stack (``span()`` parents
  to the innermost open span);
- **cross-thread** via an explicit ``parent=`` handle — the spawner
  captures ``current()`` (or the launch span itself) and hands it to the
  thread body, so background warmup/prefetch/save work renders on its own
  Perfetto track while staying linked to the invocation that started it;
- **disabled by default** with a no-op fast path: ``span()`` returns a
  shared singleton and records nothing until ``enable()`` — the CLI
  enables only when one of ``-stats``/``-metrics-json``/``-trace`` is
  requested, so the default invocation pays one boolean check per site.

Zero jax imports by design (and by test): the error-exit-without-
importing-jax guarantee pinned by tests/test_coldstart.py must hold with
every telemetry flag enabled.

Spans are registered at START (under the id lock, so list order is
start-ordered and timestamps are monotone in it); an export that runs
while background threads are still working reports those spans as
in-flight (``done: false``) instead of losing them.

The serving daemon adds an always-on OBSERVER seam (:meth:`Tracer.
set_observer`): with an observer installed, span sites time themselves
and hand each COMPLETED span to the observer even while recording is
disabled — nothing is appended to the span list, so the daemon's
flight recorder and streaming histograms (obs/flight.py, obs/hist.py)
see every span at fixed memory cost without the flag trio. The
stateless CLI never installs one, so its disabled fast path is the
same shared no-op singleton as before.
"""

from __future__ import annotations

import threading
import time
from types import TracebackType
from typing import Any, Callable, Dict, List, Optional, Type, Union


class Span:
    """One timed region; a context manager created by :meth:`Tracer.span`."""

    __slots__ = (
        "_tracer", "sid", "parent_sid", "name", "t0_ns", "t1_ns",
        "tid", "thread_name", "attrs",
    )

    def __init__(
        self,
        tracer: "Tracer",
        sid: int,
        parent_sid: Optional[int],
        name: str,
        attrs: Dict[str, Any],
    ) -> None:
        self._tracer = tracer
        self.sid = sid
        self.parent_sid = parent_sid
        self.name = name
        self.attrs = attrs
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns: Optional[int] = None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(
        self,
        exc_type: Optional[Type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> None:
        self.t1_ns = time.perf_counter_ns()
        self._tracer._finish(self)


class _NoopSpan:
    """The disabled-tracer fast path: one shared do-nothing span."""

    __slots__ = ()
    sid: Optional[int] = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


NOOP_SPAN = _NoopSpan()

SpanLike = Union[Span, _NoopSpan]


class Tracer:
    """Process-wide span recorder (module-level instance: ``TRACER``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._enabled = False
        self._spans: List[Span] = []
        self._next_sid = 1
        self._tls = threading.local()
        self._observer: Optional[Callable[[Span], None]] = None
        self.base_ns = time.perf_counter_ns()
        self.epoch = time.time()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        """Back to the no-op fast path without dropping recorded spans
        (shared-registry mode's last-tracing-request-out hook)."""
        self._enabled = False

    def set_observer(
        self, observer: Optional[Callable[[Span], None]] = None
    ) -> None:
        """Install (or with None remove) the always-on completed-span
        observer — the daemon's flight-recorder/histogram feed. With an
        observer installed, span sites allocate real timed spans even
        while recording is disabled; the observer must be cheap and
        must not raise (it is wrapped defensively regardless)."""
        self._observer = observer

    def reset(self, enabled: Optional[bool] = None) -> None:
        """Start a fresh invocation: drop recorded spans, rebase the
        clock. Other threads' local stacks may still hold pre-reset
        spans; ``_pop`` removes by identity, so they cannot corrupt
        spans recorded after the reset. Sids stay monotone ACROSS
        resets: a background thread still holding a pre-reset parent
        handle must register as an orphan (parent sid absent from the
        new list), never re-parent onto an unrelated post-reset span
        that happened to be assigned the same sid."""
        with self._lock:
            self._spans = []
            self.base_ns = time.perf_counter_ns()
            self.epoch = time.time()
            if enabled is not None:
                self._enabled = enabled

    # shared-registry (multi-lane daemon) bound: a tracing daemon never
    # resets, so completed spans past this cap are dropped oldest-first
    # on each begin_invocation to keep the process bounded
    TRIM_CAP = 4096

    def trim(self, cap: Optional[int] = None) -> None:
        """Drop the oldest COMPLETED spans past ``cap`` (in-flight spans
        are kept — another thread still owns them). The shared-registry
        mode's bound; a no-op while under the cap."""
        cap = self.TRIM_CAP if cap is None else cap
        with self._lock:
            excess = len(self._spans) - cap
            if excess <= 0:
                return
            kept: List[Span] = []
            for sp in self._spans:
                if excess > 0 and sp.t1_ns is not None:
                    excess -= 1
                else:
                    kept.append(sp)
            self._spans = kept

    def current(self) -> Optional[Span]:
        """The innermost open span on THIS thread, or None — the handle a
        spawner passes to a background thread for cross-thread parenting."""
        stack: Optional[List[Span]] = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def span(
        self, name: str, parent: Optional[SpanLike] = None, **attrs: Any
    ) -> SpanLike:
        """A new span; parents to ``parent`` when given (cross-thread),
        else to this thread's innermost open span. Use as a context
        manager. Returns the shared no-op singleton when disabled —
        unless an observer is installed, in which case a real span is
        timed for the observer only (sid 0, never appended to the
        recorded list)."""
        if not self._enabled:
            if self._observer is None:
                return NOOP_SPAN
            return Span(self, 0, None, name, dict(attrs))
        psid: Optional[int]
        # sid 0 marks an observer-only span (never recorded): a recorded
        # child must not export a dangling parent_sid=0 — treat it as a
        # root instead (`or None` also covers the no-op singleton)
        if parent is not None:
            psid = parent.sid or None
        else:
            cur = self.current()
            psid = (cur.sid or None) if cur is not None else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            # constructed INSIDE the lock: t0 stamps under it, so list
            # order == start order and exported timestamps are monotone
            sp = Span(self, sid, psid, name, dict(attrs))
            self._spans.append(sp)
        return sp

    def _push(self, sp: Span) -> None:
        stack: Optional[List[Span]] = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(sp)

    def _pop(self, sp: Span) -> None:
        stack: Optional[List[Span]] = getattr(self._tls, "stack", None)
        if not stack:
            return
        if stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # unbalanced exit (generator teardown etc.)
            stack.remove(sp)

    def _finish(self, sp: Span) -> None:
        """Span exit: unstack, then hand the completed span to the
        observer (which must never be able to break a span site)."""
        self._pop(sp)
        observer = self._observer
        if observer is not None:
            try:
                observer(sp)
            except Exception:
                pass

    def snapshot(self) -> List[Dict[str, Any]]:
        """Recorded spans as export dicts, start-ordered; spans still in
        flight report their duration so far with ``done: false``. Start
        offsets clamp at 0: a pre-reset background span must not export
        a negative timestamp."""
        now = time.perf_counter_ns()
        with self._lock:
            spans = list(self._spans)
            base = self.base_ns
        out: List[Dict[str, Any]] = []
        for sp in spans:
            t1 = sp.t1_ns if sp.t1_ns is not None else now
            row: Dict[str, Any] = {
                "sid": sp.sid,
                "parent": sp.parent_sid,
                "name": sp.name,
                "tid": sp.tid,
                "thread": sp.thread_name,
                "start_us": round(max(0, sp.t0_ns - base) / 1e3, 1),
                "dur_us": round(max(0, t1 - sp.t0_ns) / 1e3, 1),
                "done": sp.t1_ns is not None,
            }
            if sp.attrs:
                row["attrs"] = dict(sp.attrs)
            out.append(row)
        return out


TRACER = Tracer()
