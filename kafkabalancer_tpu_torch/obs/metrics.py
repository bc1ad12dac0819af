"""Unified, thread-safe metrics registry for invocation telemetry.

One typed store behind one lock absorbs what used to be scattered:
``ops.aot``'s module-global ``stats`` dict (mutated from the prefetch
thread AND the main thread), the coldstart prefetch markers, the pallas
gate verdicts, and the solver/session counters. Four metric families:

- **counters** — monotone floats (``aot.loads``, ``solver.chunks``,
  ``solver.moves_committed``...), added under the lock;
- **gauges** — last-write-wins values (cache dir, gate verdicts);
- **phases** — per-program ``{key: float}`` timing groups. This is the
  shape ``ops.aot.stats`` always had (``load_s``/``blob_mb``/``exec1_s``/
  ``prefetch``/``staged`` per program name); :class:`PhasesView` keeps
  that name alive as a read-only alias;
- **events** — a bounded append-only log of discrete happenings
  (evictions, corrupt-entry drops, pallas gate verdicts, kernel
  fallbacks) with wall-clock stamps;
- **histograms** — streaming log-bucketed distributions (obs/hist.py):
  per-phase served latency, queue depth, batch occupancy. Unlike the
  other families these are PROCESS-LIFETIME: :meth:`reset` (the
  per-invocation epoch boundary) leaves them alone, because their whole
  point is the daemon-lifetime distribution a live ``stats`` scrape
  reads mid-traffic; tests reset them explicitly via
  :meth:`reset_hists`. Excluded from :meth:`snapshot` on purpose — the
  ``kafkabalancer-tpu.metrics/1`` schema is golden-pinned, and the
  scrape document (``kafkabalancer-tpu.serve-stats/8``) is the
  histograms' export seam;
- **label families** — bounded label-dimensioned histogram/counter
  families (``tenant_hist_observe`` / ``tenant_count``): per-tenant
  attribution with a hard memory bound (top-K labels by recent
  activity, LRU-demoted into an ``other`` rollup — obs/hist.py
  :class:`HistFamily`, :class:`CounterFamily`). Daemon-lifetime like
  the histograms (:meth:`reset` leaves them alone; the daemon clears
  them at startup via :meth:`reset_tenants`), exported through the
  scrape's ``tenants`` block, never :meth:`snapshot`.

The registry is ALWAYS on (its cost is the dict writes the old bare
``stats`` dict already paid, now lock-protected); only the tracer
(obs/trace.py) has an on/off switch. Zero jax imports by design.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Optional

from kafkabalancer_tpu_torch.obs.hist import (
    FAMILY_CAP,
    OTHER_LABEL,
    HistFamily,
    StreamingHist,
)

SCHEMA_VERSION = 1
SCHEMA = f"kafkabalancer-tpu.metrics/{SCHEMA_VERSION}"

# events are a diagnostic log, not a firehose: past the cap new events
# are counted as dropped instead of growing the registry unbounded
# (a long prewarm sweep or a pathological eviction storm must not turn
# the metrics payload into the artifact being debugged)
_MAX_EVENTS = 1024


class CounterFamily:
    """A bounded label-dimensioned counter family — the counter twin of
    :class:`~kafkabalancer_tpu_torch.obs.hist.HistFamily`: top-``cap`` labels
    by recent activity keep individual values, the LRU label past the
    cap is demoted into the ``other`` rollup (its value folded in, so
    the family-wide sum is exact and monotone across any label churn).
    One lock; every operation is a dict write."""

    def __init__(self, cap: int = FAMILY_CAP) -> None:
        self._lock = threading.Lock()
        self._cap = max(1, int(cap))
        self._labels: "OrderedDict[str, float]" = OrderedDict()
        self._other = 0.0
        self._demoted = 0

    def add(self, label: str, delta: float = 1.0) -> None:
        with self._lock:
            if label == OTHER_LABEL:
                self._other += delta
                return
            if label in self._labels:
                self._labels[label] += delta
                self._labels.move_to_end(label)
                return
            if len(self._labels) >= self._cap:
                _victim, v = self._labels.popitem(last=False)
                self._other += v
                self._demoted += 1
            self._labels[label] = delta

    def get(self, label: str) -> float:
        with self._lock:
            if label == OTHER_LABEL:
                return self._other
            return self._labels.get(label, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._labels.values()) + self._other

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cap": self._cap,
                "demoted": self._demoted,
                "other": self._other,
                "labels": dict(self._labels),
            }


class MetricsRegistry:
    """Lock-protected counters / gauges / phase-timings / events."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._phases: Dict[str, Dict[str, float]] = {}
        self._events: List[Dict[str, Any]] = []
        self._dropped_events = 0
        self._hists: Dict[str, StreamingHist] = {}
        # label-dimensioned (tenant) families: bounded top-K + "other"
        # rollup per name (obs/hist.py). Daemon-lifetime like the plain
        # histograms — reset() leaves them alone; reset_tenants clears.
        self._tenant_hists: Dict[str, HistFamily] = {}
        self._tenant_counters: Dict[str, CounterFamily] = {}

    # -- writers ---------------------------------------------------------
    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def phase_set(self, group: str, key: str, value: float) -> None:
        with self._lock:
            self._phases.setdefault(group, {})[key] = float(value)

    def phase_setdefault(self, group: str, key: str, value: float) -> float:
        with self._lock:
            return self._phases.setdefault(group, {}).setdefault(
                key, float(value)
            )

    def hist(self, name: str) -> StreamingHist:
        """Get-or-create the named streaming histogram. The registry
        lock covers only the lookup; observations go through the hist's
        own lock, so hot observers never contend with snapshot()."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = StreamingHist()
            return h

    def hist_observe(self, name: str, value: float) -> None:
        self.hist(name).observe(value)

    def tenant_hist(
        self, name: str, cap: Optional[int] = None
    ) -> HistFamily:
        """Get-or-create the named label-dimensioned histogram family;
        ``cap`` applies only on first creation (the family's label
        bound is fixed for its lifetime)."""
        with self._lock:
            fam = self._tenant_hists.get(name)
            if fam is None:
                fam = self._tenant_hists[name] = HistFamily(
                    cap=cap if cap is not None else FAMILY_CAP
                )
            return fam

    def tenant_hist_observe(
        self, name: str, label: str, value: float
    ) -> None:
        self.tenant_hist(name).observe(label, value)

    def tenant_counter(
        self, name: str, cap: Optional[int] = None
    ) -> CounterFamily:
        with self._lock:
            fam = self._tenant_counters.get(name)
            if fam is None:
                fam = self._tenant_counters[name] = CounterFamily(
                    cap=cap if cap is not None else FAMILY_CAP
                )
            return fam

    def tenant_count(
        self, name: str, label: str, delta: float = 1.0
    ) -> None:
        self.tenant_counter(name).add(label, delta)

    def tenant_counter_get(self, name: str, label: str) -> float:
        with self._lock:
            fam = self._tenant_counters.get(name)
        return 0.0 if fam is None else fam.get(label)

    def event(self, kind: str, **fields: Any) -> None:
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                self._dropped_events += 1
                return
            self._events.append({"kind": kind, "t": time.time(), **fields})

    # -- readers ---------------------------------------------------------
    def phase_get(self, group: str) -> Dict[str, float]:
        """Copy of one phase group ({} when absent) — the library seam
        bench.py's cold children read their attribution through."""
        with self._lock:
            return dict(self._phases.get(group, {}))

    def counter_get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, Any]:
        """Deep-enough copy of everything for the exporters."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "phases": {g: dict(kv) for g, kv in self._phases.items()},
                "events": [dict(ev) for ev in self._events],
                "events_dropped": self._dropped_events,
            }

    def hist_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Every histogram's export view — the ``stats`` scrape's
        payload (deliberately NOT part of :meth:`snapshot`: the
        metrics/1 schema is golden-pinned)."""
        with self._lock:
            hists = dict(self._hists)
        return {name: h.snapshot() for name, h in sorted(hists.items())}

    def tenant_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Every label family's export view — the scrape's per-tenant
        attribution payload (serve-stats/5 ``tenants`` block). Like the
        plain histograms, deliberately NOT part of :meth:`snapshot`."""
        with self._lock:
            hfams = dict(self._tenant_hists)
            cfams = dict(self._tenant_counters)
        return {
            "hists": {
                name: fam.snapshot() for name, fam in sorted(hfams.items())
            },
            "counters": {
                name: fam.snapshot() for name, fam in sorted(cfams.items())
            },
        }

    # -- lifecycle -------------------------------------------------------
    def reset(self) -> None:
        """Per-invocation epoch boundary. Histograms survive on purpose:
        they are process/daemon-lifetime distributions (module
        docstring); ``reset_hists`` clears them explicitly."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._phases.clear()
            self._events.clear()
            self._dropped_events = 0

    def reset_phases(self) -> None:
        with self._lock:
            self._phases.clear()

    def reset_hists(self) -> None:
        with self._lock:
            self._hists.clear()

    def reset_tenants(self) -> None:
        """Clear every label family (hist + counter) — the daemon's
        startup boundary, so per-tenant counts reconcile exactly from
        request 1 (mirrors ``reset_hists``)."""
        with self._lock:
            self._tenant_hists.clear()
            self._tenant_counters.clear()


class PhasesView(Mapping[str, Dict[str, float]]):
    """Read-only Mapping over the registry's phase groups — the
    backward-compatible ``ops.aot.stats`` alias.

    Lookups return COPIES (mutating one changes nothing); there is no
    item assignment — writes go through the registry's typed API. The
    one mutator kept is :meth:`clear` (delegating to
    ``reset_phases``), because the test/bench idiom ``aot.stats.clear()``
    is a between-measurements reset, not a data write.
    """

    def __init__(self, registry: MetricsRegistry) -> None:
        self._registry = registry

    def __getitem__(self, group: str) -> Dict[str, float]:
        with self._registry._lock:
            return dict(self._registry._phases[group])

    def __iter__(self) -> Iterator[str]:
        with self._registry._lock:
            return iter(list(self._registry._phases))

    def __len__(self) -> int:
        with self._registry._lock:
            return len(self._registry._phases)

    def clear(self) -> None:
        self._registry.reset_phases()


REGISTRY = MetricsRegistry()

# module-level aliases onto the process registry, so the idiomatic call
# sites (``obs.metrics.count(...)``) and module-style imports
# (``from kafkabalancer_tpu_torch.obs import metrics``) hit the same store —
# without shadowing this module behind a registry attribute on the
# package (``import kafkabalancer_tpu_torch.obs.metrics`` must yield a module
# that still carries SCHEMA / PhasesView)
count = REGISTRY.count
gauge = REGISTRY.gauge
phase_set = REGISTRY.phase_set
phase_setdefault = REGISTRY.phase_setdefault
event = REGISTRY.event
hist = REGISTRY.hist
hist_observe = REGISTRY.hist_observe
hist_snapshot = REGISTRY.hist_snapshot
tenant_hist = REGISTRY.tenant_hist
tenant_hist_observe = REGISTRY.tenant_hist_observe
tenant_counter = REGISTRY.tenant_counter
tenant_count = REGISTRY.tenant_count
tenant_counter_get = REGISTRY.tenant_counter_get
tenant_snapshot = REGISTRY.tenant_snapshot
phase_get = REGISTRY.phase_get
counter_get = REGISTRY.counter_get
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
reset_phases = REGISTRY.reset_phases
reset_hists = REGISTRY.reset_hists
reset_tenants = REGISTRY.reset_tenants
