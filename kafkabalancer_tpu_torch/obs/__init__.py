"""kafkabalancer_tpu_torch.obs — span-based invocation telemetry.

The subset of the reference package's telemetry layer that the planning
path calls:

- ``obs.tracer`` / ``obs.span`` (obs/trace.py) — nested + cross-thread
  lifecycle spans with a no-op fast path;
- ``obs.metrics`` (obs/metrics.py) — the always-on thread-safe registry
  of counters and gauges (solver/session counters);
- ``obs.hist`` (obs/hist.py) — the streaming histograms the registry
  keeps;
- ``obs.convergence`` (obs/convergence.py) — the plan-outcome slot the
  balancer steps note their decline reasons into, and the mutation tap
  a daemon's resident session mirrors applied moves through;
- ``obs.flight`` (obs/flight.py) — the planning daemon's always-on
  flight recorder, fed through the tracer's observer hook;
- ``obs.edge`` (obs/edge.py) — a forwarding client's phase timings and
  trace context;
- obs/export.py — the ``-stats`` summary, the ``-metrics-json`` line, the
  ``-trace`` Chrome trace (merged with the daemon's spans on a served
  invocation) and the renderers of the ``-serve-stats`` and
  ``-metrics-prom`` scrapes; ``-explain`` renders through
  ``obs.convergence``.

Nothing under this package imports torch or numpy at import time: the
error exits and the scrape verbs stay torch-free with every telemetry
flag.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from kafkabalancer_tpu_torch.obs import convergence, edge, flight, hist  # noqa: F401
from kafkabalancer_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    SCHEMA,
    SCHEMA_VERSION,
    MetricsRegistry,
    PhasesView,
)
from kafkabalancer_tpu_torch.obs.trace import (  # noqa: F401
    NOOP_SPAN,
    TRACER,
    Span,
    SpanLike,
    Tracer,
)

# NOTE: ``obs.metrics`` is the SUBMODULE (bound by the import above),
# which aliases the registry's methods at module level — do not rebind
# it to REGISTRY here, or module-style imports silently yield the
# instance instead of the module. Pass REGISTRY where a
# ``MetricsRegistry`` object is expected.
tracer = TRACER


# Concurrent-serving mode (the multi-lane daemon, serve/lanes.py): with
# several requests in flight at once, a per-request registry/tracer
# reset would wipe another request's attribution mid-export, so
# begin_invocation keeps the daemon-lifetime stores instead. Counters
# then read as daemon-lifetime totals — which is exactly the right
# denominator for throughput attribution (serve.lane_busy_s). The
# stateless CLI and the single-lane daemon never set this.
_shared_registry = False
# tracing requests in flight (shared mode only): the tracer stays
# enabled while ANY -stats/-metrics-json/-trace request runs and drops
# back to the no-op fast path when the last one finishes — one traced
# request must not leave span recording on for the daemon's lifetime
_shared_tracing = 0
_shared_lock = threading.Lock()


def set_shared_registry(on: bool) -> None:
    """Enter/leave concurrent-serving mode; see the comment above."""
    global _shared_registry, _shared_tracing
    _shared_registry = on
    if not on:
        with _shared_lock:
            _shared_tracing = 0


def shared_registry() -> bool:
    return _shared_registry


def begin_invocation(enabled: bool = False) -> None:
    """Reset the process-global registry + tracer for a fresh invocation
    (the CLI calls this at the top of every ``run``). In shared-registry
    mode (multi-lane serving) the stores are daemon-lifetime: nothing
    resets, and the tracer only trims completed spans past its cap so a
    long-lived tracing daemon stays bounded."""
    if _shared_registry:
        if enabled:
            enable_tracing()
        TRACER.trim()
        return
    REGISTRY.reset()
    TRACER.reset(enabled=enabled)


def enable_tracing() -> None:
    if _shared_registry:
        global _shared_tracing
        with _shared_lock:
            _shared_tracing += 1
    TRACER.enable()


def end_invocation() -> None:
    """Shared-mode bookkeeping, called from ``cli.run``'s finally for
    invocations that enabled tracing: when the LAST tracing request
    finishes, the tracer returns to the no-op fast path (spans already
    recorded stay until trim). A no-op outside shared mode."""
    if not _shared_registry:
        return
    global _shared_tracing
    with _shared_lock:
        if _shared_tracing > 0:
            _shared_tracing -= 1
        if _shared_tracing == 0:
            TRACER.disable()


def span(
    name: str, parent: Optional[SpanLike] = None, **attrs: Any
) -> SpanLike:
    """Convenience for ``obs.tracer.span`` — the one call instrumented
    modules use."""
    return TRACER.span(name, parent=parent, **attrs)


def current_span() -> Optional[Span]:
    return TRACER.current()
