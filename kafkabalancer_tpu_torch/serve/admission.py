"""Admission control: per-tenant fair queueing, caps, and shedding.

The daemon's dispatchers (serve/daemon.py Coalescer, serve/lanes.py
LaneScheduler) queue without bound and serve in arrival order: a
churn-heavy tenant that floods the socket starves everyone behind it,
and under sustained overload every client waits the full client timeout
before falling back — the worst possible failure mode for an
automation fleet. This module is the Clipper-style (NSDI '17, PAPERS.md)
admission layer in FRONT of the dispatcher:

- **per-tenant deficit-round-robin queueing** — arriving plan requests
  enter their tenant's FIFO queue; a bounded number of requests (the
  ``window``) may occupy the dispatcher at once, and freed slots are
  granted in DRR order across tenants (quantum one request, every
  tenant alike), so no tenant can starve another regardless of arrival
  skew;
- **caps** — a total queue bound (``-serve-max-queue``) and a
  per-tenant queued+inflight bound (``-serve-tenant-inflight``);
  an arrival past either is SHED immediately with a structured
  ``{ok: false, op: "overload", reason, retry_after_ms}`` frame
  (serve/protocol.py) instead of queueing forever — the client backs
  off (honoring ``retry_after_ms``), retries, and ultimately takes its
  byte-identical in-process fallback;
- **deadline shedding** — a QUEUED request whose client-supplied
  deadline (``deadline_ms`` in the plan header) has already passed is
  shed with ``reason: "deadline"`` on the daemon's sweep tick; a
  request already granted to the dispatcher is NEVER shed (its answer
  is coming — killing it could only waste the work);
- **retry-after estimation** — ``retry_after_ms`` is the queue depth
  times an EWMA of recent request service time over the dispatcher's
  parallelism, clamped to [25 ms, 30 s]; the client adds jitter.

Shed requests land in their OWN telemetry — the ``serve.shed_s``
histogram (time spent queued before shedding) and the ``serve.sheds``
counter plus per-tenant family — never in ``serve.request_s``, so an
overload storm cannot pollute the served-latency p99 it exists to
protect.

Host code like everything under serve/ (no torch); one condition variable owns all
state, and no lock is held across a dispatcher call.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.obs.hist import OTHER_LABEL
from kafkabalancer_tpu_torch.serve.protocol import PROTO_VERSION

# retry_after_ms clamp: never tell a client to hammer (< 25 ms) or to
# give up on a living daemon (> 30 s)
RETRY_AFTER_MIN_MS = 25
RETRY_AFTER_MAX_MS = 30_000

# service-time EWMA smoothing (per completed request)
_EWMA_ALPHA = 0.2
# the estimate before any request completed: a conservative guess that
# keeps first-storm retry_after in the human-scale range
_EWMA_SEED_S = 0.25

SHED_REASONS = ("overload", "tenant", "deadline", "quarantine", "shutdown")


def overload_response(
    reason: str, retry_after_ms: int, detail: str = ""
) -> Dict[str, Any]:
    """The structured shed frame (v1 shape; serve/daemon.py converts
    for v2 connections, preserving ``op``/``reason``/``retry_after_ms``)."""
    return {
        "v": PROTO_VERSION,
        "ok": False,
        "op": "overload",
        "reason": reason,
        "retry_after_ms": int(max(0, retry_after_ms)),
        "error": detail or f"request shed ({reason})",
    }


class _Waiter:
    __slots__ = ("req", "tenant", "event", "verdict", "t_arrival")

    def __init__(self, req: Any, tenant: str, t_arrival: float) -> None:
        self.req = req
        self.tenant = tenant
        self.event = threading.Event()
        # None until decided; True = admitted, a dict = the shed frame
        self.verdict: Any = None
        self.t_arrival = t_arrival


class AdmissionController:
    """The fair-queueing admission layer; see the module docstring.

    ``window`` is how many requests may occupy the dispatcher at once
    (sized so coalescing still sees concurrent same-bucket work); ``max_queue`` caps TOTAL queued arrivals (0
    disables); ``tenant_inflight`` caps one tenant's queued+granted
    total (0 disables); ``parallel`` is the retry-after estimate's
    effective service parallelism (the lane count).
    """

    def __init__(
        self,
        window: int = 8,
        max_queue: int = 256,
        tenant_inflight: int = 64,
        parallel: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._cv = threading.Condition()
        self._window = max(1, int(window))
        self.max_queue = max(0, int(max_queue))
        self.tenant_inflight = max(0, int(tenant_inflight))
        self._parallel = max(1, int(parallel))
        self._clock = clock
        # tenant -> FIFO of waiters; the ring is the DRR service order
        # (rotates one tenant per service turn — a tenant served this
        # turn goes to the BACK, so a deep backlog cannot monopolize
        # the freed slots the way ordered iteration would)
        self._queues: "OrderedDict[str, Deque[_Waiter]]" = OrderedDict()
        self._ring: Deque[str] = deque()
        self._deficit: Dict[str, float] = {}
        self._queued_total = 0
        self._granted_total = 0
        self._granted_by_tenant: Dict[str, int] = {}
        self._ewma_s = _EWMA_SEED_S
        self._stopped = False
        # lifetime counters (the scrape's "admission" block)
        self.arrivals = 0
        self.admitted = 0
        self.sheds: Dict[str, int] = {}
        # arrival hook (no lock held when called): the daemon wires the
        # speculator's preemption here so EVERY real plan-family
        # arrival — admitted, queued or shed — aborts in-flight
        # idle-priority work before it can delay live traffic
        # (serve/speculate.py)
        self.on_arrival: Optional[Callable[[], None]] = None

    # -- configuration ----------------------------------------------------
    def set_window(self, window: int) -> None:
        """Re-size the dispatcher occupancy window (the daemon calls
        this once lane resolution knows the real device count)."""
        with self._cv:
            self._window = max(1, int(window))
            self._grant_locked()

    def set_parallel(self, parallel: int) -> None:
        with self._cv:
            self._parallel = max(1, int(parallel))

    # -- the dispatch-side feedback ---------------------------------------
    def note_service(self, wall_s: float) -> None:
        """One request completed in ``wall_s`` — feeds the retry-after
        estimate's service-time EWMA."""
        with self._cv:
            self._ewma_s += _EWMA_ALPHA * (max(0.0, wall_s) - self._ewma_s)

    def _retry_after_ms_locked(self) -> int:
        waiting = self._queued_total + self._granted_total
        est_s = (waiting + 1) * self._ewma_s / self._parallel
        return min(
            RETRY_AFTER_MAX_MS,
            max(RETRY_AFTER_MIN_MS, int(est_s * 1000.0)),
        )

    # -- shedding ---------------------------------------------------------
    def _shed_locked(
        self, tenant: str, reason: str, waited_s: float,
        retry_after_ms: Optional[int] = None, detail: str = "",
    ) -> Dict[str, Any]:
        self.sheds[reason] = self.sheds.get(reason, 0) + 1
        if retry_after_ms is None:
            retry_after_ms = self._retry_after_ms_locked()
        resp = overload_response(reason, retry_after_ms, detail)
        # shed telemetry rides its OWN histogram/counters — never the
        # serve.request_s family (the p99 this layer protects)
        obs.metrics.hist_observe("serve.shed_s", max(0.0, waited_s))
        obs.metrics.count("serve.sheds")
        obs.metrics.tenant_count("serve.sheds", tenant or OTHER_LABEL)
        return resp

    # -- the client-facing surface ----------------------------------------
    def acquire(self, req: Any) -> Optional[Dict[str, Any]]:
        """Admit one plan request, blocking in its tenant's fair queue
        until a dispatcher slot is granted. None = admitted (the caller
        runs the dispatcher and MUST call :meth:`release` after);
        a dict = the structured shed/shutdown response to relay."""
        tenant = getattr(req, "tenant", "") or ""
        hook = self.on_arrival
        if hook is not None:
            try:
                hook()
            except Exception:
                pass  # a preemption hook failure must never shed
        now = self._clock()
        with self._cv:
            self.arrivals += 1
            if self._stopped:
                # counted as a shed so the conservation identity
                # (arrivals == admitted + shed_total) holds through
                # shutdown races; the client treats reason "shutdown"
                # as a decline (no backoff retry against a dying daemon)
                return self._shed_locked(
                    tenant, "shutdown", 0.0, retry_after_ms=0,
                    detail="daemon shutting down",
                )
            deadline = getattr(req, "deadline", None)
            if deadline is not None and now >= deadline:
                return self._shed_locked(
                    tenant, "deadline", 0.0, retry_after_ms=0,
                    detail="deadline already passed on arrival",
                )
            if self.max_queue and self._queued_total >= self.max_queue:
                return self._shed_locked(
                    tenant, "overload", 0.0,
                    detail=f"queue full ({self._queued_total} queued)",
                )
            if self.tenant_inflight:
                load = len(self._queues.get(tenant) or ()) + (
                    self._granted_by_tenant.get(tenant, 0)
                )
                if load >= self.tenant_inflight:
                    return self._shed_locked(
                        tenant, "tenant", 0.0,
                        detail=(
                            f"tenant {tenant or OTHER_LABEL!r} at its "
                            f"inflight cap ({self.tenant_inflight})"
                        ),
                    )
            w = _Waiter(req, tenant, now)
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit.setdefault(tenant, 0.0)
                self._ring.append(tenant)
            q.append(w)
            self._queued_total += 1
            self._grant_locked()
        w.event.wait()
        verdict = w.verdict
        return None if verdict is True else verdict

    def release(self, req: Any) -> None:
        """One granted request left the dispatcher (answered or
        crashed): free its slot and grant the next in DRR order."""
        tenant = getattr(req, "tenant", "") or ""
        with self._cv:
            self._granted_total = max(0, self._granted_total - 1)
            n = self._granted_by_tenant.get(tenant, 0) - 1
            if n > 0:
                self._granted_by_tenant[tenant] = n
            else:
                self._granted_by_tenant.pop(tenant, None)
            self._grant_locked()

    # -- fair granting -----------------------------------------------------
    def _drop_tenant_locked(self, tenant: str) -> None:
        self._queues.pop(tenant, None)
        self._deficit.pop(tenant, None)
        try:
            self._ring.remove(tenant)
        except ValueError:
            pass

    def _grant_locked(self) -> None:
        """Fill free dispatcher slots in deficit-round-robin order:
        each service turn takes the ring's HEAD tenant, grants while
        its deficit allows, and rotates it to the back — so the next
        freed slot goes to the next tenant, not back to the deepest
        backlog. Caller holds the condition. Expired queued waiters
        are shed in passing (the sweep tick bounds how long they can
        otherwise sit); granting never blocks."""
        now = self._clock()
        while self._granted_total < self._window and self._queued_total:
            # next ring tenant that still has queued work (stale
            # entries — drained queues — are dropped in passing)
            tenant = None
            for _ in range(len(self._ring)):
                t = self._ring.popleft()
                if self._queues.get(t):
                    tenant = t
                    self._ring.append(t)  # served this turn -> back
                    break
                self._queues.pop(t, None)
                self._deficit.pop(t, None)
            if tenant is None:
                break
            # quantum one request, every tenant weighted alike
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) + 1.0
            q = self._queues[tenant]
            while (
                q
                and self._deficit[tenant] >= 1.0
                and self._granted_total < self._window
            ):
                w = q.popleft()
                self._queued_total -= 1
                deadline = getattr(w.req, "deadline", None)
                if deadline is not None and now >= deadline:
                    # queued past its deadline: shed, not granted —
                    # the plan would only arrive to a gone client
                    w.verdict = self._shed_locked(
                        w.tenant, "deadline", now - w.t_arrival,
                        retry_after_ms=0,
                        detail="deadline passed while queued",
                    )
                    w.event.set()
                    continue
                self._deficit[tenant] -= 1.0
                self._granted_total += 1
                self._granted_by_tenant[tenant] = (
                    self._granted_by_tenant.get(tenant, 0) + 1
                )
                self.admitted += 1
                w.verdict = True
                w.event.set()
            if not q:
                # drained: drop its banked deficit too (an idle tenant
                # must not accumulate credit while away)
                self._drop_tenant_locked(tenant)

    # -- maintenance -------------------------------------------------------
    def sweep(self) -> int:
        """Shed every QUEUED waiter whose deadline has passed (the
        daemon's accept-loop tick); the number shed."""
        now = self._clock()
        flushed: List[_Waiter] = []
        with self._cv:
            for tenant in list(self._queues.keys()):
                q = self._queues[tenant]
                keep: Deque[_Waiter] = deque()
                for w in q:
                    deadline = getattr(w.req, "deadline", None)
                    if deadline is not None and now >= deadline:
                        w.verdict = self._shed_locked(
                            w.tenant, "deadline", now - w.t_arrival,
                            retry_after_ms=0,
                            detail="deadline passed while queued",
                        )
                        self._queued_total -= 1
                        flushed.append(w)
                    else:
                        keep.append(w)
                if keep:
                    self._queues[tenant] = keep
                else:
                    self._drop_tenant_locked(tenant)
        for w in flushed:
            w.event.set()
        return len(flushed)

    def busy(self) -> bool:
        """Queued or granted work — the daemon's idle-timeout check
        counts admission-queued requests as activity."""
        with self._cv:
            return bool(self._queued_total or self._granted_total)

    def stop(self) -> None:
        """Flush every queued waiter with a shutdown shed (granted
        requests finish through the dispatcher's own stop). Flushes are
        SHEDS for accounting — the conservation identity must survive
        shutdown."""
        flushed: List[_Waiter] = []
        with self._cv:
            self._stopped = True
            now = self._clock()
            for q in self._queues.values():
                for w in q:
                    w.verdict = self._shed_locked(
                        w.tenant, "shutdown", now - w.t_arrival,
                        retry_after_ms=0, detail="daemon shutting down",
                    )
                    flushed.append(w)
            self._queues.clear()
            self._deficit.clear()
            self._ring.clear()
            self._queued_total = 0
        for w in flushed:
            w.event.set()

    # -- the scrape --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            sheds = dict(self.sheds)
            return {
                "window": self._window,
                "max_queue": self.max_queue,
                "tenant_inflight": self.tenant_inflight,
                "queued": self._queued_total,
                "granted": self._granted_total,
                "arrivals": self.arrivals,
                "admitted": self.admitted,
                "sheds": sheds,
                "shed_total": sum(sheds.values()),
                "retry_after_ms": self._retry_after_ms_locked(),
                "service_ewma_s": round(self._ewma_s, 6),
            }
