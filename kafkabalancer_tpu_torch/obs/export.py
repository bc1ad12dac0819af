"""Telemetry exporters: ``-stats``, ``-metrics-json``, ``-trace``,
plus the renderers behind the live-daemon scrape verbs
(``-serve-stats`` pretty text and ``-metrics-prom`` Prometheus text
exposition over a ``stats`` scrape document).

Three renderings of one invocation's tracer + registry state:

- :func:`render_stats` — a human summary (span tree with per-thread
  attribution, phase timings, counters) written through the CLI's
  buffered stderr logger;
- :func:`metrics_payload` / :func:`write_metrics_json` — ONE line of
  schema-versioned JSON (``kafkabalancer-tpu.metrics/1``) for the outer
  automation loop and for bench.py, replacing stdout scraping. ``-``
  writes to stdout AFTER the plan, so the plan contract is untouched
  and the metrics line is the last line;
- :func:`chrome_trace` / :func:`write_trace` — Chrome trace-event JSON
  (the format Perfetto and chrome://tracing load): one ``X`` complete
  event per span, one track per thread (``M`` thread_name metadata),
  loadable alongside the ``-jax-profile`` device trace (in this
  package a ``torch.profiler`` Chrome trace of CPU and CUDA activity).

The document formats, the Prometheus names (``kafkabalancer_tpu_``
prefix) and the stats renderings are the reference package's, byte for
byte: an operator's dashboards and parsers read either package's
daemon.

Exporters run on EVERY exit path — the exit-3/exit-4 error invocations
are exactly the ones an outer-loop operator needs telemetry from — and
never raise past their callers' logging.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Set, TextIO, Tuple

from kafkabalancer_tpu_torch.obs.metrics import SCHEMA, MetricsRegistry
from kafkabalancer_tpu_torch.obs.trace import Tracer


def metrics_payload(
    registry: MetricsRegistry, tracer: Tracer, rc: Optional[int] = None
) -> Dict[str, Any]:
    """The schema-versioned metrics document for one invocation."""
    snap = registry.snapshot()
    return {
        "schema": SCHEMA,
        "rc": rc,
        "ts_epoch": round(tracer.epoch, 3),
        "pid": os.getpid(),
        "spans": tracer.snapshot(),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "phases": snap["phases"],
        "events": snap["events"],
        "events_dropped": snap["events_dropped"],
    }


def metrics_line(payload: Dict[str, Any]) -> str:
    """``payload`` as one newline-free JSON line (non-JSON values — dtype
    objects in gauge slots, say — degrade to ``str`` instead of failing
    the export)."""
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=str
    )


def write_metrics_json(
    path: str, payload: Dict[str, Any], stdout: TextIO
) -> None:
    """Write the single-line payload to ``path``, or to ``stdout`` when
    ``path`` is ``-`` (after the plan — the caller sequences that)."""
    line = metrics_line(payload) + "\n"
    if path == "-":
        stdout.write(line)
    else:
        with open(path, "w") as f:
            f.write(line)


def chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Chrome trace-event / Perfetto JSON: ``X`` complete events on one
    track per thread, start-ordered (monotonic ``ts``), with parent span
    ids and unfinished markers carried in ``args``."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "kafkabalancer-tpu"},
        },
    ]
    named: Set[int] = set()
    for sp in tracer.snapshot():
        tid = int(sp["tid"])
        if tid not in named:
            named.add(tid)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": str(sp["thread"])},
            })
        args: Dict[str, Any] = dict(sp.get("attrs", {}))
        if sp["parent"] is not None:
            args["parent_sid"] = sp["parent"]
        if not sp["done"]:
            args["unfinished"] = True
        ev: Dict[str, Any] = {
            "ph": "X", "name": sp["name"], "pid": pid, "tid": tid,
            "ts": sp["start_us"], "dur": sp["dur_us"],
        }
        if args:
            ev["args"] = args
        events.append(ev)
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {"schema": SCHEMA, "ts_epoch": tracer.epoch},
    }


def write_trace(path: str, tracer: Tracer) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, default=str)


def merged_trace(tracer: Tracer, edge: Any) -> Dict[str, Any]:
    """ONE Perfetto document for a forwarded invocation: the client's
    own span tree (exactly :func:`chrome_trace`) plus a second process
    track holding the daemon's reply-footer span subtree
    (serve/protocol.py § End-to-end tracing), aligned onto the
    client's monotonic timeline.

    Alignment: the daemon stamps are raw daemon ``perf_counter_ns``;
    the edge recorder's handshake clock-offset estimate
    (``obs.edge.estimate_offset`` — NTP-style, min-RTT sample, error
    bounded by rtt/2) maps them as ``client_ns = daemon_ns -
    offset_ns``. Mapped spans are additionally CLAMPED to start no
    earlier than their client parent (the ``serve.forward`` span) —
    causality must survive a worst-case asymmetric-RTT estimate. With
    no usable handshake sample (degenerate single-frame session, clock
    refused) the daemon track is pinned to the forward span's start
    instead, and ``otherData.clock_offset_ns`` is null.

    Both process tracks carry the invocation's trace id; daemon spans
    parent under the forward span (``args.parent_sid``)."""
    doc = chrome_trace(tracer)
    footer = getattr(edge, "footer", None)
    if not isinstance(footer, dict):
        return doc
    pid = os.getpid()
    dpid = pid + 1  # a distinct synthetic process track
    trace_id = str(footer.get("id") or edge.trace_id)
    fwd_sid = getattr(edge, "parent_sid", None)
    # the forward span's client-clock start (ns since tracer base)
    fwd_start_us: Optional[float] = None
    for sp in tracer.snapshot():
        if sp["sid"] == fwd_sid or (
            fwd_start_us is None and sp["name"] == "serve.forward"
        ):
            fwd_start_us = float(sp["start_us"])
            if sp["sid"] == fwd_sid:
                break
    events = doc["traceEvents"]
    events.append({
        "ph": "M", "name": "process_name", "pid": dpid, "tid": 0,
        "args": {
            "name": "kafkabalancer-tpu daemon",
            "trace_id": trace_id,
        },
    })
    events.append({
        "ph": "M", "name": "thread_name", "pid": dpid, "tid": 1,
        "args": {"name": "serve-req (footer)"},
    })
    off = edge.clock_offset()
    offset_ns = off[0] if off is not None else None
    spans = footer.get("spans") or []
    base_ns = tracer.base_ns
    if offset_ns is None and spans and fwd_start_us is not None:
        # degenerate fallback: pin the earliest daemon span to the
        # forward span's start
        d_min = min(int(s["t0_ns"]) for s in spans)
        offset_ns = d_min - (base_ns + int(fwd_start_us * 1e3))
    for s in spans:
        try:
            t0_ns = int(s["t0_ns"]) - (offset_ns or 0)
            t1_ns = int(s["t1_ns"]) - (offset_ns or 0)
        except (KeyError, TypeError, ValueError):
            continue
        ts_us = (t0_ns - base_ns) / 1e3
        dur_us = max(0.0, (t1_ns - t0_ns) / 1e3)
        if fwd_start_us is not None and ts_us < fwd_start_us:
            ts_us = fwd_start_us  # causality clamp (see docstring)
        args: Dict[str, Any] = {"trace_id": trace_id, "daemon": True}
        if fwd_sid is not None:
            args["parent_sid"] = fwd_sid
        events.append({
            "ph": "X", "name": str(s.get("name", "?")), "pid": dpid,
            "tid": 1, "ts": round(max(0.0, ts_us), 1),
            "dur": round(dur_us, 1), "args": args,
        })
    other = doc.setdefault("otherData", {})
    other["served"] = True
    other["trace_id"] = trace_id
    other["clock_offset_ns"] = off[0] if off is not None else None
    other["clock_rtt_ns"] = off[1] if off is not None else None
    if footer.get("spec_hit"):
        other["spec_hit"] = True
    if isinstance(footer.get("wall_s"), (int, float)):
        other["daemon_wall_s"] = footer["wall_s"]
    return doc


def write_merged_trace(path: str, tracer: Tracer, edge: Any) -> None:
    with open(path, "w") as f:
        json.dump(merged_trace(tracer, edge), f, default=str)


def render_stats(
    registry: MetricsRegistry, tracer: Tracer, rc: Optional[int] = None
) -> str:
    """Human telemetry summary: the span tree (indent = nesting, thread
    named when off the main thread), then phases, counters, gauges, and
    an event tail."""
    spans = tracer.snapshot()
    by_parent: Dict[Optional[int], List[Dict[str, Any]]] = {}
    for sp in spans:
        by_parent.setdefault(sp["parent"], []).append(sp)
    lines: List[str] = [
        "-- invocation telemetry" + (f" (rc={rc})" if rc is not None else "")
    ]
    seen: Set[int] = set()

    def walk(psid: Optional[int], depth: int) -> None:
        for sp in by_parent.get(psid, []):
            seen.add(int(sp["sid"]))
            flag = "" if sp["done"] else " (in flight)"
            thread = (
                "" if sp["thread"] == "MainThread" else f" [{sp['thread']}]"
            )
            lines.append(
                f"  {'  ' * depth}{sp['name']}: "
                f"{sp['dur_us'] / 1e3:.1f} ms{thread}{flag}"
            )
            walk(int(sp["sid"]), depth + 1)

    walk(None, 0)
    for sp in spans:  # orphans (parent from a pre-reset invocation)
        if int(sp["sid"]) not in seen:
            lines.append(f"  {sp['name']}: {sp['dur_us'] / 1e3:.1f} ms [orphan]")
    snap = registry.snapshot()
    for g in sorted(snap["phases"]):
        kv = " ".join(
            f"{k}={snap['phases'][g][k]:.4g}"
            for k in sorted(snap["phases"][g])
        )
        lines.append(f"  phase {g}: {kv}")
    for name in sorted(snap["counters"]):
        lines.append(f"  counter {name}: {snap['counters'][name]:g}")
    for name in sorted(snap["gauges"]):
        lines.append(f"  gauge {name}: {snap['gauges'][name]}")
    # streaming histograms (process-lifetime: AOT compile/deserialize
    # walls in any process, the serve.phase.* chain inside a daemon)
    for name, h in registry.hist_snapshot().items():
        lines.append(
            f"  hist {name}: n={h['count']} p50={h['p50']:.4g} "
            f"p95={h['p95']:.4g} p99={h['p99']:.4g}"
        )
    n_ev = len(snap["events"])
    if n_ev:
        shown = snap["events"][-5:]
        lines.append(
            f"  events: {n_ev}"
            + (f" (+{snap['events_dropped']} dropped)"
               if snap["events_dropped"] else "")
        )
        for ev in shown:
            detail = " ".join(
                f"{k}={v}" for k, v in ev.items() if k not in ("kind", "t")
            )
            lines.append(f"    {ev['kind']}: {detail}")
    return "\n".join(lines) + "\n"


# --- live-daemon scrape renderers ----------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")
_PROM_PREFIX = "kafkabalancer_tpu_"

# scrape-document scalars worth exposing, with their Prometheus type
_PROM_SCALARS = (
    ("uptime_s", "gauge"),
    ("requests", "counter"),
    ("coalesced", "counter"),
    ("requests_inflight", "gauge"),
    ("slow_requests", "counter"),
    ("crashed_requests", "counter"),
    ("lanes", "gauge"),
    ("steals", "counter"),
    ("mesh_exclusive", "counter"),
    ("microbatched", "counter"),
    ("mb_padded_slots", "counter"),
)


def _prom_name(name: str) -> str:
    return _PROM_PREFIX + _PROM_BAD.sub("_", name)


def _prom_label(value: str) -> str:
    """A label VALUE escaped per the exposition format (backslash,
    quote, newline) — tenant labels are operator strings (input paths,
    session names) and must not be able to break the exposition."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_summary_samples(
    lines: List[str], metric: str, labels: str, h: Dict[str, Any]
) -> None:
    """One summary's sample lines (p50/p95/p99 quantiles + ``_sum`` /
    ``_count``) under an optional label set (e.g. ``lane="0"``) — the
    ONE emission shared by the plain, lane-labeled and tenant-labeled
    histogram expositions, so quantile handling cannot drift between
    them. The caller emits the ``# TYPE`` line."""
    sep = "," if labels else ""
    for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        lines.append(
            f'{metric}{{{labels}{sep}quantile="{q}"}} '
            f"{_prom_value(h.get(key, 0))}"
        )
    suffix = f"{{{labels}}}" if labels else ""
    lines.append(f"{metric}_sum{suffix} {_prom_value(h.get('sum', 0))}")
    lines.append(f"{metric}_count{suffix} {int(h.get('count', 0))}")


# name-embedded per-lane histogram series ("serve.lane<N>.<metric>"):
# ALSO exposed as one label-dimensioned series per metric
# (kafkabalancer_tpu_serve_lane_<metric>{lane="N"}). The name-embedded
# spelling stays emitted alongside for one release — deprecated, see
_LANE_HIST_RE = re.compile(r"^serve\.lane(\d+)\.(.+)$")


def _prom_value(v: float) -> str:
    """Exact exposition: integers stay integers (a %g-rounded counter
    reads as frozen between scrapes once it passes 6 digits and breaks
    rate()); non-integral floats use repr (full precision)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(doc: Dict[str, Any]) -> str:
    """A ``stats`` scrape document as Prometheus text exposition:
    daemon scalars as counters/gauges, each streaming histogram as a
    summary (quantiles from the log-bucketed percentile extraction,
    plus ``_sum``/``_count``). Metric names are the scrape keys with
    non-word characters folded to ``_`` under the
    ``kafkabalancer_tpu_`` prefix."""
    lines: List[str] = []
    for key, typ in _PROM_SCALARS:
        v = doc.get(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        m = _prom_name(key)
        lines.append(f"# TYPE {m} {typ}")
        lines.append(f"{m} {_prom_value(v)}")
    cache = doc.get("cache")
    if isinstance(cache, dict):
        for key in ("hits", "misses", "rows_reused"):
            if isinstance(cache.get(key), (int, float)):
                m = _prom_name(f"tensorize_cache_{key}")
                lines.append(f"# TYPE {m} counter")
                lines.append(f"{m} {_prom_value(cache[key])}")
    # resident cluster sessions (serve-stats/3 "sessions" block):
    # gauges for the resident footprint, counters for the hit/resync
    # ladder — the delta-hit rate IS the steady-state health signal
    sessions = doc.get("sessions")
    if isinstance(sessions, dict):
        for key, typ in (
            ("count", "gauge"), ("bytes", "gauge"), ("cap", "gauge"),
            ("registered", "counter"), ("delta_hits", "counter"),
            ("resyncs_rows", "counter"), ("resyncs_full", "counter"),
            ("released", "counter"), ("evicted_lru", "counter"),
            ("expired_idle", "counter"),
        ):
            v = sessions.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"sessions_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
    # the warm session tier (serve-stats/8 "paging" block): spill /
    # restore / corrupt-drop counters under the conservation identity
    # spills + adopted == restores + corrupt_drops + evictions +
    # warm_entries, plus the live warm footprint gauges
    paging = doc.get("paging")
    if isinstance(paging, dict):
        for key, typ in (
            ("cap_bytes", "gauge"), ("warm_bytes", "gauge"),
            ("warm_entries", "gauge"), ("spills", "counter"),
            ("adopted", "counter"), ("restores", "counter"),
            ("restore_hits", "counter"), ("corrupt_drops", "counter"),
            ("evictions", "counter"), ("write_failures", "counter"),
        ):
            v = paging.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"paging_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
    # speculative plan-ahead (serve-stats/8 "speculation" block):
    # memo-lifecycle counters under the exact identity attempts ==
    # hits + misses + poisoned + memos
    spec = doc.get("speculation")
    if isinstance(spec, dict):
        for key, typ in (
            ("attempts", "counter"), ("hits", "counter"),
            ("misses", "counter"), ("poisoned", "counter"),
            ("aborted", "counter"), ("deferred", "counter"),
            ("wasted_dispatches", "counter"), ("memos", "gauge"),
        ):
            v = spec.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"spec_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
    # the watch-driven controller (serve-stats/8 "watch" block):
    # tick/read/emit counters plus the lag gauges (nulls skipped —
    # e.g. before the first read)
    watch = doc.get("watch")
    if isinstance(watch, dict) and watch.get("enabled"):
        for key, typ in (
            ("ticks", "counter"), ("reads", "counter"),
            ("errors", "counter"), ("events", "counter"),
            ("resyncs", "counter"), ("plans_emitted", "counter"),
            ("noop_plans", "counter"), ("spec_hits", "counter"),
            ("last_read_age_s", "gauge"), ("last_plan_s", "gauge"),
            ("last_event_lag_s", "gauge"),
        ):
            v = watch.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"watch_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
    # overload protection (serve-stats/5 "admission" block): queue
    # occupancy gauges, shed counters by reason, the live retry-after
    # estimate — the scrape half of the admission layer's overload
    adm = doc.get("admission")
    if isinstance(adm, dict):
        for key, typ in (
            ("window", "gauge"), ("max_queue", "gauge"),
            ("tenant_inflight", "gauge"), ("queued", "gauge"),
            ("granted", "gauge"), ("arrivals", "counter"),
            ("admitted", "counter"), ("shed_total", "counter"),
            ("retry_after_ms", "gauge"),
        ):
            v = adm.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"admission_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
        sheds = adm.get("sheds")
        if isinstance(sheds, dict) and sheds:
            m = _prom_name("serve_sheds")
            lines.append(f"# TYPE {m} counter")
            for reason in sorted(sheds):
                v = sheds[reason]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                lines.append(
                    f'{m}{{reason="{reason}"}} {_prom_value(v)}'
                )
    # lane health (serve-stats/5): quarantine/requeue/recovery counters
    # plus a per-lane quarantined gauge
    lh = doc.get("lane_health")
    if isinstance(lh, dict):
        for key, typ in (
            ("quarantines", "counter"), ("requeues", "counter"),
            ("recoveries", "counter"), ("watchdog_s", "gauge"),
        ):
            v = lh.get(key)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            m = _prom_name(f"lane_health_{key}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {_prom_value(v)}")
        if isinstance(lh.get("quarantined"), list):
            m = _prom_name("lane_quarantined")
            lines.append(f"# TYPE {m} gauge")
            for lane in lh["quarantined"]:
                lines.append(f'{m}{{lane="{lane}"}} 1')
    # daemon-observed fallback/resync reasons, one labeled counter —
    # a degraded fleet (clients silently planning in-process) shows up
    # as a rate() here instead of requiring log archaeology
    fallbacks = doc.get("fallbacks")
    if isinstance(fallbacks, dict) and fallbacks:
        m = _prom_name("serve_fallbacks")
        lines.append(f"# TYPE {m} counter")
        for reason in sorted(fallbacks):
            v = fallbacks[reason]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            lines.append(f'{m}{{reason="{reason}"}} {_prom_value(v)}')
    # per-lane device-memory attribution (the stats doc's "memory"
    # block): one labeled gauge per lane so a scraper can chart HBM
    # live bytes and residency-pool bytes per device
    mem = doc.get("memory")
    if isinstance(mem, list):
        samples: Dict[str, List[str]] = {}
        for entry in mem:
            if not isinstance(entry, dict):
                continue
            lane = entry.get("lane", 0)
            for key in (
                "hbm_bytes_in_use", "hbm_bytes_limit",
                "residency_bytes", "residency_entries",
            ):
                v = entry.get(key)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                samples.setdefault(_prom_name(f"lane_{key}"), []).append(
                    f'{{lane="{lane}"}} {_prom_value(v)}'
                )
        for m in sorted(samples):
            lines.append(f"# TYPE {m} gauge")
            for s in samples[m]:
                lines.append(f"{m}{s}")
    for name, h in sorted(doc.get("hists", {}).items()):
        if not isinstance(h, dict):
            continue
        m = _prom_name(name)
        lines.append(f"# TYPE {m} summary")
        _prom_summary_samples(lines, m, "", h)
    # per-lane histograms as LABEL-dimensioned series: every
    # serve.lane<N>.<metric> hist re-emitted under one
    # serve_lane_<metric>{lane="N"} summary per metric (the
    # name-embedded spelling above stays for one release — deprecated)
    lane_hists: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
    for name, h in sorted(doc.get("hists", {}).items()):
        mt = _LANE_HIST_RE.match(name)
        if mt is None or not isinstance(h, dict):
            continue
        lane_hists.setdefault(mt.group(2), []).append((mt.group(1), h))
    for metric in sorted(lane_hists):
        m = _prom_name(f"serve.lane.{metric}")
        lines.append(f"# TYPE {m} summary")
        for lane, h in lane_hists[metric]:
            _prom_summary_samples(lines, m, f'lane="{lane}"', h)
    _render_prometheus_tenants(lines, doc.get("tenants"))
    return "\n".join(lines) + "\n"


# per-tenant scalar samples: (entry key, exposed metric suffix, type)
_TENANT_SCALARS = (
    ("requests", "tenant_requests", "counter"),
    ("crashed", "tenant_crashed_requests", "counter"),
    ("delta_hits", "tenant_delta_hits", "counter"),
    ("spec_hits", "tenant_spec_hits", "counter"),
    ("resyncs_rows", "tenant_resyncs_rows", "counter"),
    ("resyncs_full", "tenant_resyncs_full", "counter"),
    ("fallbacks", "tenant_fallbacks", "counter"),
    ("sheds", "tenant_sheds", "counter"),
    ("restores", "tenant_restores", "counter"),
    ("sessions", "tenant_sessions", "gauge"),
    ("session_bytes", "tenant_session_bytes", "gauge"),
    ("warm_sessions", "tenant_warm_sessions", "gauge"),
    ("warm_bytes", "tenant_warm_bytes", "gauge"),
)


def _render_prometheus_tenants(
    lines: List[str], tenants: Any
) -> None:
    """The serve-stats/5 ``tenants`` block as tenant-labeled series:
    one sample per live top-K tenant plus the ``other`` rollup, and the
    per-tenant latency hist as a tenant-labeled summary. Label memory
    is bounded by the daemon's tenant cap, so the exposition cannot
    explode its series cardinality either."""
    if not isinstance(tenants, dict):
        return
    entries: List[Tuple[str, Dict[str, Any]]] = []
    top = tenants.get("top")
    if isinstance(top, dict):
        entries.extend(sorted(top.items()))
    other = tenants.get("other")
    if isinstance(other, dict):
        entries.append(("other", other))
    if isinstance(tenants.get("demoted"), (int, float)):
        m = _prom_name("tenants_demoted")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_prom_value(tenants['demoted'])}")
    if not entries:
        return
    for key, suffix, typ in _TENANT_SCALARS:
        samples = [
            (label, e[key]) for label, e in entries
            if isinstance(e.get(key), (int, float))
            and not isinstance(e.get(key), bool)
        ]
        if not samples:
            continue
        m = _prom_name(suffix)
        lines.append(f"# TYPE {m} {typ}")
        for label, v in samples:
            lines.append(
                f'{m}{{tenant="{_prom_label(label)}"}} {_prom_value(v)}'
            )
    m = _prom_name("tenant_request_s")
    emitted_type = False
    for label, e in entries:
        h = e.get("request_s")
        if not isinstance(h, dict):
            continue
        if not emitted_type:
            lines.append(f"# TYPE {m} summary")
            emitted_type = True
        _prom_summary_samples(
            lines, m, f'tenant="{_prom_label(label)}"', h
        )
    # serve-stats/8: the per-tenant edge overhead summary (client
    # pre-send phases + RTT, milliseconds — obs/edge.py); absent until
    # a tracing client reports, so pre-tracing scrapes are unchanged
    m = _prom_name("tenant_edge_ms")
    emitted_type = False
    for label, e in entries:
        h = e.get("edge_ms")
        if not isinstance(h, dict):
            continue
        if not emitted_type:
            lines.append(f"# TYPE {m} summary")
            emitted_type = True
        _prom_summary_samples(
            lines, m, f'tenant="{_prom_label(label)}"', h
        )


def _fmt_latency(v: Any) -> str:
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return "n/a"
    return f"{v * 1e3:.3g}ms" if v < 1.0 else f"{v:.3g}s"


def _render_tenant_table(tenants: Any) -> List[str]:
    """The ``-serve-stats`` top-tenants table: requests, latency
    p50/p95, delta-hit rate and resident session bytes per live top-K
    tenant (busiest first), plus the ``other`` rollup — so the scrape
    answers "which tenant is slow / thrashing / eating the fallback
    budget" without a Prometheus stack."""
    if not isinstance(tenants, dict):
        return []
    rows: List[Tuple[str, Dict[str, Any]]] = []
    top = tenants.get("top")
    if isinstance(top, dict):
        rows.extend(
            sorted(
                top.items(),
                key=lambda kv: -int(kv[1].get("requests", 0)),
            )
        )
    other = tenants.get("other")
    if isinstance(other, dict):
        rows.append(("(other)", other))
    if not rows:
        return []
    lines = [
        f"  tenants: {len(rows)} tracked (cap "
        f"{tenants.get('cap', 0)}, {tenants.get('demoted', 0)} demoted "
        "into other)",
        "    tenant                          requests  p50       "
        "p95       delta%  hot       warm",
    ]
    for label, e in rows:
        h = e.get("request_s") or {}
        n = int(e.get("requests", 0))
        hits = int(e.get("delta_hits", 0))
        rate = f"{100.0 * hits / n:.0f}%" if n else "-"
        name = label if len(label) <= 30 else "…" + label[-29:]
        # the tier columns: hot resident bytes beside warm (spilled)
        # bytes — a fully demoted tenant shows 0.0KB hot but keeps its
        # warm attribution instead of dropping out of the table
        warm_n = int(e.get("warm_sessions", 0))
        warm = (
            f"{int(e.get('warm_bytes', 0)) / 1e3:.1f}KB"
            + (f"({warm_n})" if warm_n else "")
        )
        hot = f"{int(e.get('session_bytes', 0)) / 1e3:.1f}KB"
        lines.append(
            f"    {name:<30}  {n:<8}  "
            f"{_fmt_latency(h.get('p50')):<8}  "
            f"{_fmt_latency(h.get('p95')):<8}  {rate:<6}  "
            f"{hot:<8}  {warm}"
        )
    return lines


def render_serve_stats(doc: Dict[str, Any]) -> str:
    """The ``-serve-stats`` human rendering of a scrape document: the
    daemon identity line, lane/cache attribution, then one line per
    histogram (lifetime count + p50/p95/p99 and the windowed recent
    view), and the flight-recorder occupancy tail."""
    lines = [
        f"-- serve stats (pid {doc.get('pid')}, version "
        f"{doc.get('version')}, uptime {doc.get('uptime_s', 0):.1f}s)",
        f"  requests: {doc.get('requests', 0)} "
        f"({doc.get('coalesced', 0)} coalesced, "
        f"{doc.get('requests_inflight', 0)} in flight, "
        f"{doc.get('slow_requests', 0)} slow, "
        f"{doc.get('crashed_requests', 0)} crashed, batch mode "
        f"{doc.get('batch_mode', '?')})",
    ]
    if "lanes" in doc:
        lines.append(
            f"  lanes: {doc['lanes']} (steals {doc.get('steals', 0)}, "
            f"mesh-exclusive {doc.get('mesh_exclusive', 0)}, "
            f"microbatched {doc.get('microbatched', 0)}, occupancy "
            f"{doc.get('mb_occupancy', {})}, padded slots "
            f"{doc.get('mb_padded_slots', 0)})"
        )
    cache = doc.get("cache")
    if isinstance(cache, dict):
        lines.append(
            f"  tensorize cache: {cache.get('hits', 0)} hits / "
            f"{cache.get('misses', 0)} misses"
        )
    sessions = doc.get("sessions")
    if isinstance(sessions, dict):
        lines.append(
            f"  sessions: {sessions.get('count', 0)} resident "
            f"({sessions.get('bytes', 0) / 1e6:.1f}MB, cap "
            f"{sessions.get('cap', 0)}): {sessions.get('delta_hits', 0)} "
            f"delta hits, {sessions.get('resyncs_rows', 0)} row / "
            f"{sessions.get('resyncs_full', 0)} full resyncs, "
            f"{sessions.get('evicted_lru', 0)} evicted, "
            f"{sessions.get('expired_idle', 0)} expired"
        )
    paging = doc.get("paging")
    if isinstance(paging, dict) and paging.get("enabled"):
        lines.append(
            f"  warm tier: {paging.get('warm_entries', 0)} records "
            f"({paging.get('warm_bytes', 0) / 1e6:.1f}MB of "
            f"{paging.get('cap_bytes', 0) / 1e6:.0f}MB): "
            f"{paging.get('spills', 0)} spills "
            f"(+{paging.get('adopted', 0)} adopted), "
            f"{paging.get('restores', 0)} restores "
            f"({paging.get('restore_hits', 0)} hits), "
            f"{paging.get('corrupt_drops', 0)} corrupt drops, "
            f"{paging.get('evictions', 0)} evicted, "
            f"{paging.get('write_failures', 0)} write failures"
        )
    spec = doc.get("speculation")
    if isinstance(spec, dict) and (
        spec.get("enabled") or spec.get("attempts")
    ):
        lines.append(
            f"  speculation: {spec.get('attempts', 0)} attempts — "
            f"{spec.get('hits', 0)} hits, {spec.get('misses', 0)} "
            f"misses, {spec.get('poisoned', 0)} poisoned, "
            f"{spec.get('aborted', 0)} aborted, "
            f"{spec.get('deferred', 0)} deferred "
            f"({spec.get('memos', 0)} memo"
            f"{'s' if spec.get('memos', 0) != 1 else ''} live, "
            f"{spec.get('wasted_dispatches', 0)} wasted dispatches)"
        )
    watch = doc.get("watch")
    if isinstance(watch, dict) and watch.get("enabled"):
        age = watch.get("last_read_age_s")
        lines.append(
            f"  watch: {watch.get('conn')} — "
            f"{watch.get('plans_emitted', 0)} plans emitted "
            f"({watch.get('spec_hits', 0)} from speculation, "
            f"{watch.get('noop_plans', 0)} no-ops), "
            f"{watch.get('reads', 0)} reads / "
            f"{watch.get('ticks', 0)} ticks, "
            f"{watch.get('resyncs', 0)} resyncs, "
            f"{watch.get('errors', 0)} errors; last read "
            + (
                f"{age:.1f}s ago" if isinstance(age, (int, float))
                and not isinstance(age, bool) else "never"
            )
        )
    fallbacks = doc.get("fallbacks")
    if isinstance(fallbacks, dict) and fallbacks:
        rendered = ", ".join(
            f"{k}={fallbacks[k]}" for k in sorted(fallbacks)
        )
        lines.append(f"  fallbacks: {rendered}")
    adm = doc.get("admission")
    if isinstance(adm, dict):
        sheds = adm.get("sheds") or {}
        shed_s = (
            " (" + ", ".join(
                f"{k}={sheds[k]}" for k in sorted(sheds)
            ) + ")" if sheds else ""
        )
        lines.append(
            f"  admission: {adm.get('queued', 0)} queued / "
            f"{adm.get('granted', 0)} granted (window "
            f"{adm.get('window', 0)}, max queue "
            f"{adm.get('max_queue', 0)}, tenant cap "
            f"{adm.get('tenant_inflight', 0)}); "
            f"{adm.get('shed_total', 0)} shed{shed_s}, retry-after "
            f"{adm.get('retry_after_ms', 0)}ms"
        )
    lh = doc.get("lane_health")
    if isinstance(lh, dict) and (
        lh.get("quarantines") or lh.get("quarantined")
    ):
        lines.append(
            f"  lane health: {lh.get('quarantines', 0)} quarantines, "
            f"{lh.get('requeues', 0)} requeues, "
            f"{lh.get('recoveries', 0)} recoveries"
            + (
                f"; QUARANTINED NOW: {lh['quarantined']}"
                if lh.get("quarantined") else ""
            )
        )
    flt = doc.get("faults")
    if isinstance(flt, dict) and flt.get("armed"):
        lines.append(
            f"  FAULTS ARMED: {flt['armed']} (fired: "
            f"{flt.get('fired') or {}})"
        )
    lines.extend(_render_tenant_table(doc.get("tenants")))
    mem = doc.get("memory")
    if isinstance(mem, list):
        for entry in mem:
            if not isinstance(entry, dict):
                continue
            hbm = entry.get("hbm_bytes_in_use")
            hbm_s = (
                f"{hbm / 1e6:.1f}MB" if isinstance(hbm, (int, float))
                and not isinstance(hbm, bool) else "n/a"
            )
            lines.append(
                f"  memory lane{entry.get('lane', 0)}: hbm {hbm_s}, "
                f"residency {entry.get('residency_bytes', 0) / 1e6:.1f}MB "
                f"({entry.get('residency_entries', 0)} entries)"
            )
    for name, h in sorted(doc.get("hists", {}).items()):
        if not isinstance(h, dict):
            continue
        w = h.get("window", {})
        lines.append(
            f"  hist {name}: n={h.get('count', 0)} "
            f"p50={h.get('p50', 0):.4g} p95={h.get('p95', 0):.4g} "
            f"p99={h.get('p99', 0):.4g} "
            f"(window n={w.get('count', 0)} p95={w.get('p95', 0):.4g})"
        )
    fl = doc.get("flight")
    if isinstance(fl, dict):
        lines.append(
            f"  flight: {fl.get('spans', 0)}/{fl.get('span_cap', 0)} "
            f"spans, {fl.get('requests', 0)}/{fl.get('request_cap', 0)} "
            f"requests, {fl.get('autodumps', 0)} autodumps"
        )
    return "\n".join(lines) + "\n"
