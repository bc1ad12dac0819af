"""The always-on flight recorder: a bounded ring of recent activity.

The serving daemon's failure modes happen while nobody is watching: a
request wedges, a batch round stalls, one client's plan takes 40x its
peers'. The ``-trace`` flag trio cannot help after the fact — tracing is
off by default and a daemon is not restarted to reproduce. The flight
recorder is the black box instead:

- a **span ring** (``SPAN_RING`` completed span records, oldest dropped
  first) fed by the tracer's always-on observer hook
  (``obs.trace.Tracer.set_observer``) — recording needs NO flag and
  costs fixed memory, because the ring holds plain dicts and the
  observer fires only at span exit;
- a **request ring** (``REQUEST_RING`` structured per-request
  summaries: request id, lane, shape bucket, rc, wall clock, per-phase
  timings) built by the daemon at request completion;
- per-thread **phase accumulation**: spans on a ``serve-req-N`` thread
  accumulate into that request's phase map (``PHASE_OF_SPAN`` names the
  chain: parse -> settle -> tensorize -> stage -> dispatch -> encode),
  popped by the daemon when the request retires;
- **auto-dump**: on a slow request (``-serve-slow-ms``) or a daemon-side
  crash the recorder writes a Perfetto-loadable trace of the ring (the
  request log rides in ``otherData.requests``) — capped at
  ``MAX_AUTODUMPS`` per process so a pathological workload cannot fill
  a disk. ``dump-trace`` (serve/protocol.py) exports the same document
  on demand from a healthy daemon.

No torch and no numpy, like everything under ``obs/``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set

SPAN_RING = 4096
REQUEST_RING = 512
MAX_AUTODUMPS = 8
# autodumps are additionally RATE-LIMITED: under a shed/crash storm
# (sustained overload, a quarantined lane answering dozens of errors a
# second) every incident would otherwise race to burn the dump cap in
# the first second, leaving nothing for the incident after the storm.
# Suppressed dumps are counted (stats "autodumps_suppressed").
AUTODUMP_MIN_INTERVAL_S = 5.0
# phase-accumulation threads tracked at once; serve-req threads pop
# their entry at retirement, so this only bounds leakage from threads
# that die without popping
THREAD_ACC_CAP = 1024

# span name -> phase key of the served request chain; dispatch rounds
# ACCUMULATE (one request runs many solver.dispatch_chunk spans)
PHASE_OF_SPAN = {
    "parse_input": "parse",
    "settle": "settle",
    "tensorize": "tensorize",
    "solver.dispatch_chunk": "dispatch",
    "plan": "plan",
    "emit": "encode",
}

# the request-thread naming convention (serve/daemon.py _handle_plan)
_REQ_THREAD_PREFIX = "serve-req-"


class FlightRecorder:
    """Bounded span + request rings; see the module docstring."""

    def __init__(
        self, span_cap: int = SPAN_RING, request_cap: int = REQUEST_RING
    ) -> None:
        self._lock = threading.Lock()
        self._spans: Deque[Dict[str, Any]] = deque(maxlen=max(1, span_cap))
        self._requests: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, request_cap)
        )
        self._acc: Dict[str, Dict[str, float]] = {}
        self._dumps = 0
        self._dumps_suppressed = 0
        self._last_dump_t = 0.0
        self.base_ns = time.perf_counter_ns()
        self.epoch = time.time()

    # -- recording -------------------------------------------------------
    def note_span(
        self,
        name: str,
        t0_ns: int,
        t1_ns: int,
        thread: str,
        tid: int,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One COMPLETED span (the tracer observer's callback body)."""
        rec: Dict[str, Any] = {
            "name": name,
            "t0_ns": t0_ns,
            "t1_ns": t1_ns,
            "thread": thread,
            "tid": tid,
        }
        if attrs:
            rec["attrs"] = dict(attrs)
        phase = PHASE_OF_SPAN.get(name)
        with self._lock:
            self._spans.append(rec)
            if phase is not None and thread.startswith(_REQ_THREAD_PREFIX):
                acc = self._acc.get(thread)
                if acc is None:
                    if len(self._acc) >= THREAD_ACC_CAP:
                        self._acc.clear()  # leak bound, not correctness
                    acc = self._acc[thread] = {}
                acc[phase] = acc.get(phase, 0.0) + (t1_ns - t0_ns) / 1e9

    def pop_request_phases(self, thread: str) -> Dict[str, float]:
        """This request thread's accumulated phase durations (seconds),
        cleared — called once by the daemon at request retirement."""
        with self._lock:
            return self._acc.pop(thread, {})

    def record_request(self, summary: Dict[str, Any]) -> None:
        with self._lock:
            self._requests.append(dict(summary))

    # -- readers ---------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "spans": len(self._spans),
                "requests": len(self._requests),
                "span_cap": self._spans.maxlen or 0,
                "request_cap": self._requests.maxlen or 0,
                "autodumps": self._dumps,
                "autodumps_suppressed": self._dumps_suppressed,
            }

    def spans_for_thread(
        self, thread: str, cap: int = 64
    ) -> List[Dict[str, Any]]:
        """The LAST ``cap`` completed spans recorded on ``thread`` —
        the reply footer's bounded daemon span subtree. Request-thread
        names are unique per request (``serve-req-<seq>``), so a ring
        scan filtered by thread name is exactly that request's spans;
        raw ``perf_counter_ns`` stamps are kept so the client can map
        them through its clock-offset estimate."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for rec in reversed(self._spans):
                if rec.get("thread") != thread:
                    continue
                out.append({
                    "name": rec["name"],
                    "t0_ns": rec["t0_ns"],
                    "t1_ns": rec["t1_ns"],
                })
                if len(out) >= max(1, cap):
                    break
        out.reverse()
        return out

    def to_perfetto(self) -> Dict[str, Any]:
        """The ring as Chrome trace-event / Perfetto JSON: one ``X``
        complete event per recorded span on one track per thread, with
        the request log riding in ``otherData.requests``."""
        with self._lock:
            spans = [dict(s) for s in self._spans]
            requests = [dict(r) for r in self._requests]
            base = self.base_ns
        pid = os.getpid()
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "kafkabalancer-tpu flight"},
        }]
        named: Set[int] = set()
        for sp in spans:
            tid = int(sp["tid"])
            if tid not in named:
                named.add(tid)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": str(sp["thread"])},
                })
            ev: Dict[str, Any] = {
                "ph": "X", "name": sp["name"], "pid": pid, "tid": tid,
                "ts": round(max(0, sp["t0_ns"] - base) / 1e3, 1),
                "dur": round(max(0, sp["t1_ns"] - sp["t0_ns"]) / 1e3, 1),
            }
            if sp.get("attrs"):
                ev["args"] = dict(sp["attrs"])
            events.append(ev)
        return {
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "otherData": {
                "schema": "kafkabalancer-tpu.flight/1",
                "ts_epoch": self.epoch,
                "requests": requests,
            },
        }

    # -- dumping ---------------------------------------------------------
    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f, default=str)

    def autodump(
        self,
        reason: str,
        directory: Optional[str] = None,
        log: Optional[Callable[[str], None]] = None,
        min_interval_s: float = AUTODUMP_MIN_INTERVAL_S,
    ) -> Optional[str]:
        """Write the ring to ``<directory>/kafkabalancer-flight-<pid>-
        <n>-<reason>.trace.json``; the written path, or None when the
        per-process dump cap is spent, a dump landed within
        ``min_interval_s`` (storm rate limit — suppressions are
        counted), or the write fails. Never raises — the recorder must
        not turn an incident into a crash."""
        with self._lock:
            if self._dumps >= MAX_AUTODUMPS:
                return None
            now = time.monotonic()
            if self._dumps and now - self._last_dump_t < min_interval_s:
                self._dumps_suppressed += 1
                return None
            self._last_dump_t = now
            self._dumps += 1
            seq = self._dumps
        path = os.path.join(
            directory or tempfile.gettempdir(),
            f"kafkabalancer-flight-{os.getpid()}-{seq}-{reason}.trace.json",
        )
        try:
            self.dump(path)
        except Exception as exc:
            if log is not None:
                log(f"flight: dump to {path} failed: {exc!r}")
            return None
        if log is not None:
            log(f"flight: dumped {reason} trace to {path}")
        return path
