"""Client-side edge telemetry: phase attribution + cross-process tracing.

A served plan's end-to-end time is more than the daemon's: the
client's O(P) read/canonicalize/digest work, the connect/handshake and
the wire wait all happen before the daemon sees the request. This
module is the client half of the end-to-end story:

- :class:`EdgeContext` — one forwarded invocation's edge recorder. It
  owns the invocation's **trace id**, times the client phase chain
  (:data:`PHASES` is the glossary), collects the clock-handshake
  samples, and receives the daemon's reply **footer** (the bounded
  daemon span subtree) so the CLI can stitch ONE timeline;
- the **observer seam** (:meth:`EdgeContext.install`) — the
  always-on hook: phase spans are timed even with the ``-stats``/
  ``-metrics-json``/``-trace`` trio off, folded into ``client.phase.*``
  streaming histograms and the ``client.phase`` phase group at span
  exit. The installed observer CHAINS to any previous observer, so an
  in-process daemon's flight recorder keeps seeing every span;
- :func:`estimate_offset` — the min-RTT NTP-style clock-offset
  estimator that aligns daemon ``perf_counter_ns`` stamps onto the
  client's monotonic base.

Phase glossary (``client.phase.<name>``):

- ``cache_probe``     — the edge-residency probe (serve/edge_cache.py):
  stat + entry-header load + hit classification, before any read;
- ``input_read``      — reading the input bytes (file or stdin);
- ``canonicalize``    — building the canonical forwarded argv + session
  identity from parsed flags;
- ``digest``          — parsing the input through the codecs reader and
  digesting the canonical state (the session ladder's O(P) client tax);
- ``connect``         — the unix-socket ``connect()``;
- ``handshake``       — the hello/version/clock exchange;
- ``send``            — writing the plan-family request frame(s);
- ``wait_first_byte`` — blocking until the daemon's first reply byte;
- ``receive``         — draining + decoding the reply frame;
- ``fallback``        — a forward attempt abandoned to the in-process
  path: the whole wasted edge wall, start-of-forward to the decision.

No torch and no numpy, like everything under ``obs/``: the edge
recorder runs in the client process, whose whole point is never paying
those imports.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from kafkabalancer_tpu_torch.obs import metrics
from kafkabalancer_tpu_torch.obs.trace import TRACER, Span

#: the client phase chain, in causal order (see the module docstring)
PHASES: Tuple[str, ...] = (
    "cache_probe", "input_read", "canonicalize", "digest", "connect",
    "handshake", "send", "wait_first_byte", "receive", "fallback",
)

#: phases that complete BEFORE the plan frame is written — the only
#: ones that can ride the request's trace context to the daemon (the
#: daemon stamps them into its own metrics export as
#: ``client.phase.*`` gauges, so the served ``-metrics-json`` line
#: carries the edge attribution without a second writer)
PRE_SEND_PHASES: Tuple[str, ...] = (
    "cache_probe", "input_read", "canonicalize", "digest", "connect",
    "handshake",
)

#: streaming-hist / phase-group prefixes for the folded phases
HIST_PREFIX = "client.phase."
PHASE_GROUP = "client.phase"

#: reply-footer bound: the daemon never ships more spans than this
#: back per request (flight-recorder records are small dicts; 64 covers
#: the full parse→settle→tensorize→dispatch→encode chain with batching
#: rounds to spare)
FOOTER_SPAN_CAP = 64


def new_trace_id() -> str:
    """A 64-bit random trace id as 16 hex chars (no global state, no
    clock dependence — safe under fork)."""
    return os.urandom(8).hex()


def estimate_offset(
    samples: Iterable[Tuple[int, int, int, int]],
) -> Optional[Tuple[int, int]]:
    """The min-RTT NTP offset estimate from clock-handshake samples.

    Each sample is the 4-stamp tuple ``(t_send, d_recv, d_send,
    t_recv)``: client ``perf_counter_ns`` before the hello write, the
    daemon's ``perf_counter_ns`` at hello receipt and at hello reply,
    and client ``perf_counter_ns`` after the hello read. Returns
    ``(offset_ns, rtt_ns)`` from the minimum-RTT sample — the sample
    with the least queueing is the one whose symmetric-delay assumption
    is tightest — or None with no usable sample.

    ``offset_ns`` estimates ``daemon_clock − client_clock``; map a
    daemon stamp onto the client timeline as ``d_ns − offset_ns``. The
    error is bounded by ``± rtt_ns / 2`` (the classic NTP bound): with
    asymmetric path delays the true offset still lies within the RTT
    window, which is why stitched exports additionally clamp daemon
    spans to start no earlier than their client parent. A degenerate
    single-sample handshake is fully supported — one sample IS the
    minimum. Samples with a negative RTT (clock garbage, not physics)
    are discarded.
    """
    best: Optional[Tuple[int, int]] = None
    for sample in samples:
        try:
            t_send, d_recv, d_send, t_recv = (int(x) for x in sample)
        except (TypeError, ValueError):
            continue
        rtt = (t_recv - t_send) - (d_send - d_recv)
        if rtt < 0:
            continue
        offset = ((d_recv - t_send) + (d_send - t_recv)) // 2
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    return best


class EdgeContext:
    """One forwarded invocation's edge recorder (see module docstring).

    The CLI creates one per forward attempt, installs the observer seam
    around the whole attempt, and passes the context into
    ``serve.client.forward_plan`` (duck-typed — serve/client.py stays
    import-free of ``obs``). Phase timings accumulate in ``phases``
    (seconds); the trace id + pre-send phases ride the v2 header as the
    request's trace context; the daemon's reply footer lands in
    ``footer`` for the merged export.
    """

    __slots__ = (
        "trace_id", "parent_sid", "phases", "clock_samples", "footer",
        "t_start_ns", "e2e_s", "cache_hit",
    )

    def __init__(self, trace_id: Optional[str] = None) -> None:
        self.trace_id = trace_id or new_trace_id()
        # edge-residency attribution: None until the cache was probed,
        # then True (digest served from the shadow cache) or False —
        # rides the trace context so the daemon can stamp
        # ``client.edge_cache_hit`` into the served metrics export
        self.cache_hit: Optional[bool] = None
        # the client forward span's sid — informational in the context
        # (cross-process sids are not a namespace); the merged export
        # parents daemon events under the span itself
        self.parent_sid = 0
        self.phases: Dict[str, float] = {}
        self.clock_samples: List[Tuple[int, int, int, int]] = []
        self.footer: Optional[Dict[str, Any]] = None
        self.t_start_ns = time.perf_counter_ns()
        self.e2e_s: Optional[float] = None

    # -- the observer seam ----------------------------------------------
    @contextlib.contextmanager
    def install(self) -> Iterator["EdgeContext"]:
        """Install the always-on edge observer for the duration: every
        completed ``client.*`` span folds into the ``client.phase.*``
        streaming hist + the ``client.phase`` group, and every span is
        chained through to whatever observer was already installed (an
        in-process daemon's flight feed keeps working). Restores the
        previous observer on exit."""
        prev = TRACER._observer  # chain, don't displace (same package)

        def fold(sp: Span) -> None:
            if prev is not None:
                try:
                    prev(sp)
                except Exception:
                    pass
            if sp.t1_ns is None or not sp.name.startswith("client."):
                return
            key = sp.name[len("client."):]
            s = max(0.0, (sp.t1_ns - sp.t0_ns) / 1e9)
            metrics.hist_observe(HIST_PREFIX + key, s)
            metrics.phase_set(PHASE_GROUP, key, s)

        TRACER.set_observer(fold)
        try:
            yield self
        finally:
            TRACER.set_observer(prev)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time one client phase: a ``client.<name>`` span (real even
        with tracing disabled, thanks to the installed observer) whose
        duration also accumulates into ``phases[name]``."""
        t0 = time.perf_counter_ns()
        try:
            with TRACER.span("client." + name):
                yield
        finally:
            s = (time.perf_counter_ns() - t0) / 1e9
            self.phases[name] = self.phases.get(name, 0.0) + s

    # -- clock handshake -------------------------------------------------
    def note_clock_sample(
        self, t_send_ns: int, clock: Any, t_recv_ns: int
    ) -> None:
        """Record one hello clock sample: the client's send/recv stamps
        around the daemon's ``{"recv_ns", "send_ns"}`` hello block. A
        malformed block is ignored — the export then simply has no
        offset and falls back to footer-only annotation."""
        if not isinstance(clock, dict):
            return
        d_recv, d_send = clock.get("recv_ns"), clock.get("send_ns")
        if isinstance(d_recv, int) and isinstance(d_send, int):
            self.clock_samples.append(
                (int(t_send_ns), d_recv, d_send, int(t_recv_ns))
            )

    def clock_offset(self) -> Optional[Tuple[int, int]]:
        """This invocation's ``(offset_ns, rtt_ns)`` estimate, or None."""
        return estimate_offset(self.clock_samples)

    # -- trace context / results -----------------------------------------
    def pre_send_ms(self) -> float:
        """The pre-send edge wall (milliseconds) — what the trace
        context attributes to the client before the request frame."""
        return 1000.0 * sum(
            self.phases.get(p, 0.0) for p in PRE_SEND_PHASES
        )

    def trace_context(self) -> Dict[str, Any]:
        """The compact context that rides every plan-family v2 header:
        trace id, parent span handle, the pre-send phase timings
        (seconds) and their total, plus the min RTT when a clock sample
        landed. v1 frames never carry it — the caller only stamps v2
        headers."""
        ctx: Dict[str, Any] = {
            "id": self.trace_id,
            "parent": int(self.parent_sid or 0),
            "phases": {
                k: round(v, 6)
                for k, v in self.phases.items()
                if k in PRE_SEND_PHASES
            },
            "edge_pre_ms": round(self.pre_send_ms(), 3),
        }
        est = self.clock_offset()
        if est is not None:
            ctx["rtt_ns"] = est[1]
        if self.cache_hit is not None:
            ctx["edge_cache_hit"] = bool(self.cache_hit)
        return ctx

    def finish(self, footer: Any) -> None:
        """A served reply arrived: stamp the end-to-end wall, keep the
        daemon's span footer, and publish the ``serve.edge_ms`` gauge —
        end-to-end wall minus the daemon's request wall, i.e. every
        millisecond the daemon-side histograms cannot see."""
        self.e2e_s = (time.perf_counter_ns() - self.t_start_ns) / 1e9
        # a caller running the client in process reads this gauge to
        # reconcile the issued trace id against the daemon's flight log
        # (the registry persists until the next invocation's reset)
        metrics.gauge("client.trace_id", self.trace_id)
        if isinstance(footer, dict):
            self.footer = footer
            wall = footer.get("wall_s")
            if isinstance(wall, (int, float)) and not isinstance(
                wall, bool
            ):
                edge_ms = max(0.0, (self.e2e_s - float(wall)) * 1e3)
                metrics.gauge("serve.edge_ms", round(edge_ms, 3))
                metrics.hist_observe("client.edge_s", edge_ms / 1e3)

    def note_fallback(self) -> None:
        """The forward attempt was abandoned: the whole edge wall so
        far becomes the ``fallback`` phase (recorded directly — there
        is no span to close at this point)."""
        s = (time.perf_counter_ns() - self.t_start_ns) / 1e9
        self.phases["fallback"] = s
        metrics.hist_observe(HIST_PREFIX + "fallback", s)
        metrics.phase_set(PHASE_GROUP, "fallback", s)
