"""The persistent planning daemon (``-serve``).

One long-lived process owns everything a fresh invocation of this
package pays again: the torch import, the CUDA context, the two kernel
libraries (built by nvcc on first use and loaded once, ``ops/nvcc.py``)
and the incremental tensorize cache (serve/cache.py). Requests arrive
as canonical flag lists over a unix socket (serve/protocol.py) and run
through the very same ``cli.run`` the in-process path uses, on the
request's lane device — the response relays its stdout/stderr/exit code
verbatim, so the ``kafka-reassign-partitions.sh`` contract and the outer
loop are unchanged.

Structure:

- an accept loop (one thread per connection) that answers ``hello``
  liveness handshakes immediately and enqueues ``plan`` requests;
- a dispatcher: the single-lane :class:`Coalescer` (``-serve-lanes=1``,
  or one device) that serializes planning, or the multi-lane
  ``LaneScheduler`` (serve/lanes.py) with one lane per GPU, which
  fuses a lane's concurrent same-bucket ``-fused`` requests into one
  instance-batched session (``_admissible_request`` predicts which
  requests may join). Each request runs on its own named thread
  (``serve-req-N``) so its spans render on their own track;
- request coalescing: when requests queue up concurrently, the
  dispatcher probes each waiting request's shape bucket
  (``ops.runtime.prefetch_hints``) and drains all same-bucket requests
  into one dispatch window. The probe runs only under contention;
- resident cluster sessions (serve/sessions.py, protocol v2): the outer
  loop's steady-state request ships a digest, not the cluster;
- speculative plan-ahead and the ``-watch`` controller
  (serve/speculate.py): after a clean session request an idle-priority
  INTERNAL request plans the next move on the resident session and
  memoizes the answer; a digest-matching next request is answered from
  the memo with no dispatch (:meth:`Daemon._answer_from_memo`). Internal
  requests run through the dispatcher like any other (on a lane request
  thread, the lane's device and default stream), are preempted by real
  traffic at the next chunk round or applied move, and never touch the
  idle clock, ``serve.requests``, ``serve.request_s`` or the flight
  request log;
- the warm session tier (serve/spill.py, ``-serve-session-spill-dir``):
  every clean real session request re-spills its session (the
  continuous spill), evicted/expired sessions demote to disk, and a
  ``plan-delta`` for an absent session restores its record through
  ``sessions.session_from_rows`` — a bad record is a counted cold miss;
- an idle-timeout shutdown, a pidfile next to the socket, and stale
  socket handling (a dead daemon's socket file is unlinked at startup;
  a live one refuses the second daemon).

Devices: ``Daemon(devices=None)`` takes every visible CUDA device, one
lane each; without a card it has none, and every request that needs the
device exits 3 exactly as in process — the daemon never plans on the
CPU unless it was given CPU devices (``devices=["cpu"]``, as the tests
do). The warm thread builds and loads both kernels; a kernel that fails
to build or load is logged, and each request that needs it then fails
on its own (exit 3), never falling back to the plain version. A failed
speculative run is a counted abort; the real request then plans live on
the card.

Observability: daemon-lifetime counters ride into every request's
registry as gauges (``served: true``, ``serve.requests``,
``serve.coalesced``, ``serve.cache_hits``). The daemon also records
ALWAYS-ON live telemetry: every span site feeds the tracer's observer
hook (obs/trace.py) into streaming per-phase histograms (obs/hist.py —
``serve.phase.*``, ``serve.request_s``) and the bounded flight recorder
(obs/flight.py), scraped live through the ``stats`` / ``dump-trace``
protocol ops without touching the plan dispatcher, and auto-dumped on
daemon-side crashes or requests over ``-serve-slow-ms``.
"""

from __future__ import annotations

import contextlib
import io
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

from kafkabalancer_tpu_torch import __version__, obs
from kafkabalancer_tpu_torch.obs.edge import FOOTER_SPAN_CAP
from kafkabalancer_tpu_torch.obs.flight import PHASE_OF_SPAN, FlightRecorder
from kafkabalancer_tpu_torch.obs.hist import OTHER_LABEL
from kafkabalancer_tpu_torch.obs.trace import Span
from kafkabalancer_tpu_torch.serve import faults
from kafkabalancer_tpu_torch.serve import speculate as spec_mod
from kafkabalancer_tpu_torch.serve import spill as spill_mod
from kafkabalancer_tpu_torch.serve.admission import AdmissionController
from kafkabalancer_tpu_torch.serve.devmem import device_memory_stats
from kafkabalancer_tpu_torch.serve.protocol import (
    PROTO_V2,
    PROTO_VERSION,
    STATS_SCHEMA,
    pidfile_path,
    read_frame,
    read_frame2,
    write_frame,
    write_frame2,
)

BucketKey = Tuple[int, int, int, bool]
LogFn = Callable[[str], None]

# a connection sitting in a queued/coalesced plan can legitimately wait
# minutes for the device; the read timeout only bounds DEAD peers
PLAN_CONNECTION_TIMEOUT_S = 7200.0

# a plan arriving during startup waits for the dispatcher (built on the
# warm thread); far past this the warm thread is presumed wedged and
# the request is refused
DISPATCHER_WAIT_S = 600.0

# the per-tenant label families the daemon feeds (obs.metrics registry,
# bounded top-K + "other"); created at startup so the configured
# tenant cap applies before the first observation
_TENANT_HIST_FAMILIES = (
    "serve.request_s", "serve.phase.queue", "serve.edge_ms",
)
_TENANT_COUNTER_FAMILIES = (
    "serve.requests", "serve.crashed_requests", "serve.delta_hits",
    "serve.resyncs_rows", "serve.resyncs_full", "serve.fallbacks",
    "serve.sheds", "serve.restores", "serve.spec.hits",
)

def _deadline_of(hdr: Dict[str, Any]) -> Optional[float]:
    """A request header's ``deadline_ms`` budget as an absolute
    monotonic deadline (None when absent/invalid — no deadline)."""
    ms = hdr.get("deadline_ms")
    if isinstance(ms, bool) or not isinstance(ms, (int, float)) or ms <= 0:
        return None
    return time.monotonic() + float(ms) / 1000.0


def _argv_value(argv: List[str], name: str) -> Optional[str]:
    """Last value of ``-name=value`` in a canonical argv (the client
    emits every forwarded flag in exactly that spelling)."""
    prefix = f"-{name}="
    val: Optional[str] = None
    for a in argv:
        if a.startswith(prefix):
            val = a[len(prefix):]
    return val


def _argv_brokers(argv: List[str]) -> Optional[List[int]]:
    """The ``-broker-ids`` list of a canonical argv (None = auto) —
    the ONE parse shared by the bucket probe (via ``_parse_request``)
    and the session bucket memoization, so the two can never drift."""
    from kafkabalancer_tpu_torch.utils.flags import go_atoi

    raw = _argv_value(argv, "broker-ids")
    if not raw or raw == "auto":
        return None
    return [go_atoi(b) for b in raw.split(",")]


class PlanRequest:
    """One queued ``plan`` request plus its completion latch."""

    __slots__ = (
        "argv", "stdin", "done", "response", "bucket", "bucketed", "staged",
        "mb_entered", "t_submit", "session_ctx", "tenant", "deadline",
        "started", "internal", "trace",
    )

    def __init__(
        self,
        argv: List[str],
        stdin: Optional[str],
        tenant: str = "",
        deadline: Optional[float] = None,
    ) -> None:
        self.argv = argv
        self.stdin = stdin
        self.done = threading.Event()
        self.response: Optional[Dict[str, Any]] = None
        self.bucket: Optional[BucketKey] = None
        self.bucketed = False  # probe memo (None is a valid "no bucket")
        self.staged = False  # lane pipelining: host-encode stage fired
        self.mb_entered = False  # joined its batcher's barrier
        self.t_submit: Optional[float] = None  # queue-wait hist anchor
        # resident-session context (serve/sessions.py
        # PlanSessionContext) for the protocol-v2 session ops
        self.session_ctx: Optional[Any] = None
        # telemetry attribution label (the v2 session identity, or the
        # plan header's "tenant"); "" lands in the scrape's "other"
        # rollup — never a correctness input, only an attribution key
        self.tenant = tenant
        # absolute monotonic deadline from the client's ``deadline_ms``
        # budget; QUEUED requests past it are shed (serve/admission.py),
        # in-flight ones always run to completion
        self.deadline = deadline
        # _handle_plan entered (the ``requests`` counter includes it):
        # the health monitor's ``abandoned`` accounting counts only
        # requests that never began handling, so the conservation
        # identity admitted == requests + abandoned cannot double-count
        # a wedged-mid-handling request
        self.started = False
        # daemon-internal work (serve/speculate.py): "spec" for a
        # speculative plan-ahead, "watch" for a watch-mode re-plan,
        # None for real client traffic. Internal requests never touch
        # the idle clock, serve.requests/request_s, admission feedback,
        # the flight request log or the `abandoned` identity — they
        # carry their own serve.spec.*/serve.watch.* telemetry
        self.internal: Optional[str] = None
        # the client's trace context from the v2 header ("trace" key:
        # id / parent / pre-send client phases / edge_pre_ms / rtt_ns,
        # serve/protocol.py § End-to-end tracing); None on v1 frames
        # and trace-less clients. Pure telemetry — never a correctness
        # input, like `tenant`.
        self.trace: Optional[Dict[str, Any]] = None


class Coalescer:
    """Serialize plan handling, draining same-bucket queue runs together.

    ``handle(req, coalesced)`` runs every request (in arrival order
    within a group); ``bucket_of(req)`` is the host-side shape probe,
    called lazily and only when more than one request is waiting — the
    uncontended case never pays it.
    """

    def __init__(
        self,
        handle: Callable[[PlanRequest, bool], None],
        bucket_of: Callable[[PlanRequest], Optional[BucketKey]],
    ) -> None:
        self._handle = handle
        self._bucket_of = bucket_of
        self._dq: Deque[PlanRequest] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._active = 0  # requests popped but not yet completed
        # the popped-but-unfinished group, for health_tick: a dispatch
        # thread dying mid-group must not leave its waiters blocked
        self._current: List[PlanRequest] = []
        self.quarantines = 0
        self.recoveries = 0
        self.abandoned = 0
        self._thread = threading.Thread(
            target=self._loop, name="serve-dispatch", daemon=True
        )
        self._thread.start()

    def busy(self) -> bool:
        """Queued or in-flight work — the daemon's idle-timeout check
        must not count a long-running plan as idleness."""
        with self._cv:
            return bool(self._dq) or self._active > 0

    def health_stats(self) -> Dict[str, Any]:
        """The single-lane half of the scrape's ``lane_health`` block
        (the Coalescer has no per-lane watchdog; its one failure mode
        is dispatch-thread death, recovered by :meth:`health_tick`)."""
        with self._cv:
            return {
                "watchdog_s": 0.0,
                "quarantined": [],
                "quarantines": self.quarantines,
                "requeues": 0,
                "recoveries": self.recoveries,
                "abandoned": self.abandoned,
            }

    def health_tick(
        self, log: Optional[LogFn] = None
    ) -> None:
        """Detect and recover a dead dispatch thread: queued requests
        are answered with a structured error (their submitters would
        otherwise block forever) and a fresh loop thread takes over."""
        if self._thread.is_alive() or self._stop:
            return
        with self._cv:
            if self._stop:
                return
            pending = list(self._current) + list(self._dq)
            self._current = []
            self._dq.clear()
            self._active = 0
            self.quarantines += 1
        flushed = 0
        for r in pending:
            if not r.done.is_set():
                r.response = {
                    "v": PROTO_VERSION, "ok": False,
                    "error": "dispatcher died; request abandoned",
                }
                r.done.set()
                # internal (speculative/watch) requests never passed
                # admission, so counting them here would break the
                # admitted == requests + abandoned identity
                if getattr(r, "internal", None) is None:
                    flushed += 1
        with self._cv:
            self.abandoned += flushed
        t = threading.Thread(
            target=self._loop, name="serve-dispatch", daemon=True
        )
        try:
            t.start()
        except Exception:
            return  # no thread to spare; retried next tick
        with self._cv:
            self._thread = t
            self.recoveries += 1
        if log is not None:
            log(
                "serve: dispatch thread died — restarted "
                f"({len(pending)} queued requests answered with errors)"
            )
        obs.metrics.event("serve_dispatcher_restarted", flushed=len(pending))

    def _bucket(self, req: PlanRequest) -> Optional[BucketKey]:
        from kafkabalancer_tpu_torch.serve.lanes import probe_bucket

        return probe_bucket(req, self._bucket_of)

    def submit(self, req: PlanRequest) -> Dict[str, Any]:
        with self._cv:
            if self._stop:
                return {
                    "v": PROTO_VERSION, "ok": False,
                    "error": "daemon shutting down",
                }
            self._dq.append(req)
            self._cv.notify_all()
        req.done.wait()
        return req.response or {
            "v": PROTO_VERSION, "ok": False, "error": "request dropped",
        }

    def stop(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)

    # thread-role: request
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._dq and not self._stop:
                    self._cv.wait()
                if not self._dq:
                    return  # stopping, queue drained
                first = self._dq.popleft()
                self._active += 1
                contended = bool(self._dq)
                group = [first]
                # alias, not copy: group extensions below stay visible
                # to health_tick's flush
                self._current = group
            try:
                if contended:
                    # the bucket probes (input read + parse) run OUTSIDE
                    # the lock: submitters must stay able to enqueue
                    # while the window is being assembled. Safe because
                    # this loop is the only consumer — a snapshotted
                    # request cannot be removed by anyone else.
                    b0 = self._bucket(first)
                    if b0 is not None:
                        with self._cv:
                            pending = list(self._dq)
                        same = [r for r in pending if self._bucket(r) == b0]
                        if same:
                            with self._cv:
                                for r in same:
                                    self._dq.remove(r)
                                self._active += len(same)
                            group.extend(same)
                for idx, req in enumerate(group):
                    try:
                        self._handle(req, idx > 0)
                    except Exception as exc:  # never wedge a waiter
                        req.response = {
                            "v": PROTO_VERSION, "ok": False,
                            "error": f"{type(exc).__name__}: {exc}",
                        }
                    finally:
                        with self._cv:
                            self._active -= 1
                        req.done.set()
                with self._cv:
                    self._current = []
            except Exception:
                # group-assembly failure: the popped requests must not
                # wedge their waiters nor leak the active count
                with self._cv:
                    self._active -= sum(
                        1 for r in group if not r.done.is_set()
                    )
                    self._current = []
                for r in group:
                    if not r.done.is_set():
                        r.response = {
                            "v": PROTO_VERSION, "ok": False,
                            "error": "dispatch failed",
                        }
                        r.done.set()


class Daemon:
    """The ``-serve`` daemon; see the module docstring."""

    def __init__(
        self,
        socket_path: str,
        idle_timeout: float = 900.0,
        log: Optional[LogFn] = None,
        warm: bool = True,
        devices: Optional[Sequence[Any]] = None,
        lanes: int = 1,
        microbatch: int = 1,
        batch_mode: str = "continuous",
        admission_hold: int = 0,
        slow_ms: float = 0.0,
        flight_dir: str = "",
        session_cap: int = 64,
        session_idle_s: float = 3600.0,
        tenant_cap: int = 32,
        max_queue: int = 256,
        tenant_inflight: int = 64,
        watchdog_s: float = 120.0,
        faults_spec: str = "",
        spill_dir: str = "",
        warm_cap_mb: float = 256.0,
        speculate: bool = False,
        watch_conn: str = "",
        watch_emit: str = "",
        watch_poll: float = 5.0,
        watch_argv: Optional[List[str]] = None,
        prewarm_shapes: str = "",
    ) -> None:
        self.socket_path = socket_path
        self.idle_timeout = idle_timeout
        # -serve-prewarm: a PARTITIONSxBROKERS[,...] grid the warm thread
        # runs one throw-away session per bucket of (prewarm.warm_store)
        self.prewarm_shapes = prewarm_shapes
        self.prewarm_summary: Optional[Dict[str, Any]] = None
        # warm=False builds the dispatcher on the calling thread before
        # the accept loop starts and skips the kernel build (the tests'
        # CPU daemons)
        self.warm = warm
        # devices: the lanes' devices (None: every visible CUDA device,
        # resolved on the warm thread — see _resolve_devices)
        self._device_spec = None if devices is None else list(devices)
        self._devices: List[Any] = []
        # slow_ms: a served request slower than this (milliseconds)
        # auto-dumps the flight recorder (0 disables); flight_dir
        # overrides the dump directory (default: the system tempdir)
        self.slow_ms = max(0.0, slow_ms)
        self.flight_dir = flight_dir
        self.flight = FlightRecorder()
        # lanes: 1 = the single-lane Coalescer; 0/negative = one lane per
        # device; N>1 = min(N, devices)
        self.lanes = lanes
        # microbatch (-serve-microbatch): the most concurrent same-bucket
        # requests one batcher fuses (1 disables); above 1 the lane
        # scheduler is kept even on one lane, whose batching lives there.
        # batch_mode: "continuous" re-forms the fused batch at every
        # solver chunk round, "oneshot" runs fixed-membership barriers.
        # admission_hold: deterministic batch forming — a lane holds its
        # pop until this many batchable requests are queued (or a short
        # window expires); 0 disables. serve/lanes.py
        self.microbatch = max(1, microbatch)
        self.batch_mode = batch_mode
        self.admission_hold = max(0, admission_hold)
        self._log: LogFn = log or (
            lambda msg: print(msg, file=sys.stderr, flush=True)
        )
        self._stop = threading.Event()
        self._warm_done = threading.Event()
        self._lock = threading.Lock()
        self._requests = 0
        self._coalesced = 0
        self._inflight = 0
        # daemon-lifetime outcome counters: the registry counters of the
        # same names are wiped by the next request's begin_invocation in
        # single-lane (per-invocation-epoch) mode, so the scrape reads
        # THESE, never the registry
        self._slow = 0
        self._crashed = 0
        self._started = time.monotonic()
        self._last_activity = time.monotonic()
        self._seq = 0
        # seconds the warm thread spent building the dispatcher and
        # loading the kernels (None until it finished)
        self.warm_seconds: Optional[float] = None
        from kafkabalancer_tpu_torch.serve.cache import TensorizeRowCache
        from kafkabalancer_tpu_torch.serve.sessions import SessionStore

        self.tensorize_cache = TensorizeRowCache()
        # resident cluster sessions (protocol v2; serve/sessions.py):
        # LRU-capped per-tenant parsed/settled state + primed row cache
        self.sessions = SessionStore(cap=session_cap, idle_s=session_idle_s)
        # the warm session tier (serve/spill.py): evicted/expired/
        # flushed sessions spill to versioned checksummed records under
        # spill_dir (empty = tier disabled); the store itself is opened
        # in serve_forever — opening claims the directory, and a
        # CONSTRUCTED-but-never-served daemon must not leave pidfiles
        # behind
        self.spill_dir = spill_dir
        self.warm_cap_mb = warm_cap_mb
        self.spill: Optional[Any] = None
        # speculative plan-ahead (serve/speculate.py): the idle-priority
        # worker that plans request N+1 on the resident session and
        # memoizes the answer; the store retires memos through it so
        # the speculation block's conservation identity stays exact.
        # Always constructed (the scrape block exists with the feature
        # off); its worker thread starts in serve_forever.
        self.speculator = spec_mod.Speculator(self, enabled=speculate)
        self.sessions.spec = self.speculator
        # watch mode (serve/speculate.py ZkWatcher): the daemon itself
        # subscribes to Zookeeper and streams plans to watch_emit — no
        # client process in the steady state
        self.watch_conn = watch_conn
        self.watch_emit = watch_emit
        self.watch_poll = watch_poll
        self.watch_argv = list(watch_argv) if watch_argv else None
        self.watcher: Optional[spec_mod.ZkWatcher] = None
        # kernel launches made by internal runs, by kind ("spec" /
        # "watch") and kernel wrapper name (ops/nvcc.py launch_tally):
        # which share of a kernel's launches was idle-priority work
        self.internal_launches: Dict[str, Dict[str, int]] = {}
        # per-tenant telemetry label bound: top-K tenants by recent
        # activity keep individual hists/counters, the rest roll into
        # "other" (obs/hist.py HistFamily)
        self.tenant_cap = max(1, tenant_cap)
        # daemon-observed client fallback/resync reasons, scraped as
        # the stats doc's "fallbacks" block
        self._fallbacks: Dict[str, int] = {}
        self._coalescer: Optional[Any] = None
        self._dispatcher_ready = threading.Event()
        self._lanes: "List[Any]" = []
        # request-thread -> lane map for the span-driven heartbeat:
        # every span completing on a serve-req thread beats its lane,
        # so a legitimately slow plan never reads as a wedged lane —
        # only a call that produces NO observable progress past
        # -serve-watchdog does
        self._thread_lanes: Dict[str, Any] = {}
        # overload protection (serve/admission.py): per-tenant fair
        # queueing + caps in FRONT of whichever dispatcher gets built.
        # The window starts sized for the single-lane case and is
        # re-sized once lane resolution knows the device count
        self.watchdog_s = max(0.0, watchdog_s)
        self.faults_spec = faults_spec
        self._admission = AdmissionController(
            window=max(4, 2 * self.microbatch, self.admission_hold),
            max_queue=max_queue,
            tenant_inflight=tenant_inflight,
            parallel=1,
        )
        # every real plan-family ARRIVAL (admitted or shed) preempts
        # any in-flight speculative dispatch (serve/speculate.py):
        # idle plan-ahead work must never cost live traffic its p95
        self._admission.on_arrival = self.speculator.note_real_traffic

    # -- warmup ----------------------------------------------------------
    # thread-role: warm
    def _warm_body(self) -> None:
        """Background startup warm: dispatcher construction FIRST (device
        resolution imports torch and creates the CUDA context; the
        accept loop answers hello immediately while it runs), then the
        build and load of both kernel libraries, so request 1 pays
        neither; then the process is marked warm (requests start no warm
        thread of their own, ops/coldstart.py), and with
        ``-serve-prewarm`` one throw-away session per shape bucket of the
        grid runs on every lane's device (prewarm.warm_store). Never
        raises: a dispatcher failure falls back to the single-lane
        Coalescer, and a kernel that fails to build or load is logged —
        each request that needs it then fails on its own (exit 3),
        nothing falls back to the plain version."""
        t0 = time.perf_counter()
        try:
            self._coalescer = self._make_dispatcher()
        except Exception as exc:
            # a broken device must not cost availability: fall back to
            # the single-lane dispatcher, with every lane-mode side
            # effect undone
            self._log(f"serve: dispatcher init failed ({exc!r}); 1 lane")
            from kafkabalancer_tpu_torch.ops.tensorize import set_row_cache

            obs.set_shared_registry(False)
            self._lanes = []
            set_row_cache(self.tensorize_cache)
            self._coalescer = Coalescer(self._handle_plan, self._bucket_of)
        finally:
            self._dispatcher_ready.set()
        try:
            cuda = [
                d for d in self._devices if getattr(d, "type", "") == "cuda"
            ]
            if cuda:
                import torch

                from kafkabalancer_tpu_torch.ops.coldstart import (
                    KERNELS,
                    load_kernel,
                )

                for dev in dict.fromkeys(cuda):
                    # the CUDA context of every lane's card, created now
                    torch.zeros(1, device=dev)
                for name in KERNELS:
                    try:
                        load_kernel(name)
                    except Exception as exc:
                        self._log(
                            f"serve: kernel {name} failed to build or "
                            f"load; requests that need it exit 3: {exc}"
                        )
            from kafkabalancer_tpu_torch.ops.coldstart import mark_process_warm

            mark_process_warm()
            if self.prewarm_shapes:
                from kafkabalancer_tpu_torch import prewarm

                summary: Dict[str, Any] = {}
                for dev in dict.fromkeys(cuda or self._devices):
                    counts = prewarm.warm_store(
                        self.prewarm_shapes, device=dev
                    )
                    for k, v in counts.items():
                        summary[k] = summary.get(k, 0) + v
                self.prewarm_summary = summary
                self._log(f"serve: prewarm {self.prewarm_shapes}: {summary}")
            self.warm_seconds = time.perf_counter() - t0
            self._log(
                f"serve: warm in {self.warm_seconds:.3f}s "
                f"({len(cuda)} CUDA lane device"
                f"{'s' if len(cuda) != 1 else ''})"
            )
        except Exception as exc:
            self._log(f"serve: warmup failed: {exc!r}")
        finally:
            # the idle clock starts HERE: a long kernel build must not
            # count as idleness
            self._touch()
            self._warm_done.set()

    # -- live telemetry ---------------------------------------------------
    def _observe_span(self, sp: Span) -> None:
        """The tracer's always-on observer (obs/trace.py): every
        completed span — tracing flags or not — lands in the flight
        recorder ring, and phase-chain spans feed the streaming
        per-phase histograms. Cheap by construction: one ring append +
        at most one histogram observation, no locks shared with the
        dispatcher."""
        t1 = sp.t1_ns if sp.t1_ns is not None else sp.t0_ns
        self.flight.note_span(
            sp.name, sp.t0_ns, t1, sp.thread_name, sp.tid, sp.attrs
        )
        lane = self._thread_lanes.get(sp.thread_name)
        if lane is not None:
            # watchdog heartbeat: observable request progress on this
            # lane (one dict get + a float store per span)
            lane.last_beat = time.monotonic()
        phase = PHASE_OF_SPAN.get(sp.name)
        if phase is not None and not sp.thread_name.startswith(
            "serve-int-"
        ):
            # internal (speculative/watch) runs keep the lane heartbeat
            # above but stay out of the serve.phase.* histograms — the
            # per-phase breakdowns must describe real traffic only
            obs.metrics.hist_observe(
                f"serve.phase.{phase}", (t1 - sp.t0_ns) / 1e9
            )

    # -- request handling ------------------------------------------------
    def _parse_request(
        self, req: PlanRequest
    ) -> "Optional[Tuple[Any, Optional[List[int]]]]":
        """Parse one queued request's input the way the real run will
        (reader + -input-json + -topics + -broker-ids semantics) — the
        ONE request-argv parse shared by the bucket probe and the lane
        stage hook, so the two cannot drift. Returns ``(partition_list,
        brokers)`` or None (zookeeper input / nothing to read — the
        real run surfaces any error)."""
        if _argv_value(req.argv, "from-zk"):
            return None
        input_path = _argv_value(req.argv, "input")
        if input_path:
            with open(input_path, "r") as fh:
                text = fh.read()
        elif req.stdin is not None:
            text = req.stdin
        else:
            return None
        from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader

        as_json = _argv_value(req.argv, "input-json") == "true"
        topics_raw = _argv_value(req.argv, "topics") or ""
        topics = [t for t in topics_raw.split(",") if len(t) >= 1]
        pl = get_partition_list_from_reader(io.StringIO(text), as_json, topics)
        return pl, _argv_brokers(req.argv)

    def _count_resync_full(self, tenant: str) -> None:
        """One full re-sync landed for ``tenant``: the store's global
        monotone counter plus the tenant family (session thrash is a
        per-tenant signal)."""
        self.sessions.count_resync_full()
        obs.metrics.tenant_count(
            "serve.resyncs_full", tenant or OTHER_LABEL
        )

    def _count_fallback(self, reason: str, tenant: str = "") -> None:
        with self._lock:
            self._fallbacks[reason] = self._fallbacks.get(reason, 0) + 1
        # tenant attribution rides the bounded label family: which
        # tenant is eating the fallback budget (untenanted reasons —
        # bad frames, version skew — roll up under "other")
        obs.metrics.tenant_count(
            "serve.fallbacks", tenant or OTHER_LABEL
        )

    def _bucket_of(self, req: PlanRequest) -> Optional[BucketKey]:
        """Host-side shape-bucket probe of one queued request
        (``ops.runtime.prefetch_hints``), so two requests coalesce
        exactly when their encodings share one padded shape. None
        (= never coalesced) for zookeeper inputs and
        anything that fails to parse (the real run surfaces the error).
        Resident-session requests carry no input text; their bucket is
        the session's memoized one (computed once, after its first
        request)."""
        ctx = req.session_ctx
        if ctx is not None:
            bucket: Optional[BucketKey] = ctx.session.bucket
            if bucket is not None or req.stdin is None:
                return bucket
        parsed = self._parse_request(req)
        if parsed is None:
            return None
        pl, brokers = parsed
        from kafkabalancer_tpu_torch.ops.runtime import prefetch_hints

        hints = prefetch_hints(pl, brokers)
        return (
            int(hints["P"]), int(hints["R"]), int(hints["B"]),
            bool(hints["all_allowed"]),
        )

    def _handle_plan(
        self,
        req: PlanRequest,
        coalesced: bool,
        lane: Optional[Any] = None,
        mb: Optional[Any] = None,
    ) -> None:
        from kafkabalancer_tpu_torch import cli

        internal = req.internal
        if internal == "spec" and (
            self.speculator.preempted() or self._admission.busy()
        ):
            # abort-before-start: real traffic arrived while the
            # speculative request sat queued — defer, never delay a
            # live request behind idle work (the speculator counts the
            # non-ok response as aborted)
            req.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": "speculation deferred (real traffic waiting)",
            }
            return
        # handling BEGINS here (before any injected wedge): a request
        # the watchdog later abandons mid-handling still lands in the
        # requests counter when it resumes, never in `abandoned`
        req.started = True
        # chaos seam (serve/faults.py; inert unless -serve-faults armed):
        # a scheduled dispatch_delay sleeps HERE — observable by the
        # lane watchdog exactly like a wedged host call
        faults.fire("dispatch_delay")
        t_start = time.perf_counter()
        tenant_label = req.tenant or OTHER_LABEL
        if req.t_submit is not None and internal is None:
            # queue wait: accept-thread submit to dispatcher pickup —
            # global hist AND the tenant family (who waits behind whom)
            queue_s = t_start - req.t_submit
            obs.metrics.hist_observe("serve.phase.queue", queue_s)
            obs.metrics.tenant_hist_observe(
                "serve.phase.queue", tenant_label, queue_s
            )
        with self._lock:
            if internal is None:
                # internal (speculative/watch) work is NOT a request:
                # serve.requests stays the real-traffic truth and the
                # admitted == requests + abandoned identity holds
                self._requests += 1
                if coalesced:
                    self._coalesced += 1
            n = self._requests
            n_coal = self._coalesced
            self._seq += 1
            seq = self._seq
        attrs: Dict[str, Any] = {
            "served": True,
            "serve.requests": float(n),
            "serve.coalesced": float(n_coal),
        }
        trace = req.trace if isinstance(req.trace, dict) else None
        if trace is not None and internal is None:
            # the client's trace context rides into the request's
            # gauges: the trace id plus the client's pre-send edge
            # phases as client.phase.* (obs/edge.py glossary); the
            # tenant serve.edge_ms family attributes client+network
            # overhead (pre-send phases + measured RTT) per label
            tid_hex = str(trace.get("id") or "")
            if tid_hex:
                attrs["trace_id"] = tid_hex
            cphases = trace.get("phases")
            if isinstance(cphases, dict):
                for key, val in sorted(cphases.items()):
                    if isinstance(val, (int, float)) and not isinstance(
                        val, bool
                    ):
                        attrs[f"client.phase.{key}"] = round(
                            float(val), 6
                        )
            edge_pre = trace.get("edge_pre_ms")
            if isinstance(edge_pre, (int, float)) and not isinstance(
                edge_pre, bool
            ):
                total_ms = float(edge_pre)
                rtt_ns = trace.get("rtt_ns")
                if isinstance(rtt_ns, int) and rtt_ns > 0:
                    total_ms += rtt_ns / 1e6
                attrs["client.edge_pre_ms"] = round(total_ms, 3)
                obs.metrics.tenant_hist_observe(
                    "serve.edge_ms", tenant_label, total_ms
                )
            ech = trace.get("edge_cache_hit")
            if isinstance(ech, bool):
                # the edge-residency attribution (serve/edge_cache.py):
                # True when this request's digest came from the shadow
                # cache without a client-side read+parse
                attrs["client.edge_cache_hit"] = ech
        ctx = req.session_ctx
        if req.tenant:
            attrs["serve.tenant"] = req.tenant
        if ctx is not None:
            ss = self.sessions.stats()
            attrs["serve.sessions"] = float(ss["count"])
            attrs["serve.session_bytes"] = float(ss["bytes"])
            attrs["serve.delta_hits"] = float(ss["delta_hits"])
            if getattr(ctx, "restored", False) and ctx.kind in (
                "delta", "rebuild"
            ):
                # answered from a warm spill record with NO resync — a
                # restored session whose digest drifted takes the rows
                # path and is a restore but not a hit, matching
                # paging.restore_hits exactly
                attrs["serve.restore_hit"] = True
            elif ctx.kind in ("delta", "rebuild"):
                attrs["serve.delta_hit"] = True
        sched = self._coalescer
        if lane is not None and hasattr(sched, "stats"):
            s = sched.stats()
            attrs.update({
                "serve.lanes": s["lanes"],
                "serve.lane": float(lane.index),
                "serve.lane_busy_s": s["lane_busy_s"],
                "serve.steals": s["steals"],
                "serve.microbatched": s["microbatched"],
                "serve.mb_occupancy_max": s["occupancy_max"],
                "serve.mb_padded_slots": s["padded_slots"],
                "serve.residency_hits": s["residency_hits"],
                "serve.cache_hits": s["cache_hits"],
                "serve.residency_bytes": float(
                    lane.stage_cache.device_bytes()
                ),
            })
            mem0 = device_memory_stats(lane.device)
            if mem0 is not None:
                attrs["serve.device_bytes_in_use"] = float(
                    mem0["bytes_in_use"]
                )
        else:
            attrs["serve.lanes"] = 1.0
            attrs["serve.residency_hits"] = 0.0
            attrs["serve.cache_hits"] = float(
                self.tensorize_cache.stats()["hits"]
                + self.sessions.cache_stats()["hits"]
            )

        def refresh() -> Dict[str, Any]:
            # re-snapshot at export time (cli.run calls this when the
            # request ends): the scheduler's batching gauges, after this
            # request's own fused dispatches committed (the batcher's
            # sink runs before member responses release), and the lane's
            # device memory
            out2: Dict[str, Any] = {}
            sched2 = self._coalescer
            if hasattr(sched2, "stats"):
                s2 = sched2.stats()
                out2["serve.mb_occupancy_max"] = s2["occupancy_max"]
                out2["serve.mb_padded_slots"] = s2["padded_slots"]
                out2["serve.residency_hits"] = s2["residency_hits"]
                out2["serve.residency_bytes"] = float(
                    lane.stage_cache.device_bytes()
                )
            mem2 = device_memory_stats(lane.device)
            if mem2 is not None:
                out2["serve.device_bytes_in_use"] = float(mem2["bytes_in_use"])
            return out2

        # the request's device: its lane's; the single-lane Coalescer
        # plans on the daemon's first device (None: the CLI's default,
        # CUDA — exit 3 without a card, exactly as in process). A
        # -fused-shard request (mesh-exclusive on a lane) spreads over
        # every device of the daemon.
        device = lane.device if lane is not None else self._device0()
        shard_devices = list(self._devices) or None
        i = io.StringIO(req.stdin or "")
        out, err = io.StringIO(), io.StringIO()
        rc_box: List[int] = []

        tally: Dict[str, int] = {}

        def body() -> None:  # thread-role: request
            # chaos seam: a scheduled transfer_fail raises before the
            # device work — the request crashes server-side and is
            # answered with a structured error, never a wrong plan
            faults.fire("transfer_fail")
            with contextlib.ExitStack() as st:
                if internal is not None:
                    from kafkabalancer_tpu_torch.ops import nvcc

                    # which kernel launches this internal run made
                    st.enter_context(nvcc.launch_tally(tally))
                if internal == "spec":
                    # the cooperative preemption hook: checked per
                    # solver chunk round and per applied move; a raise
                    # unwinds the whole run (caught below)
                    spec_mod.install_abort_check(
                        self.speculator.maybe_abort
                    )
                    st.callback(spec_mod.install_abort_check, None)
                if lane is not None:
                    st.enter_context(lane.context())
                if ctx is not None:
                    # session activation AFTER the lane context: the
                    # session's trusted-delta row cache overrides the
                    # lane's, and the mutation tap mirrors every
                    # applied move into the session's raw shadow
                    st.enter_context(ctx.activate())
                if mb is not None:
                    # join the lane's batcher on THIS thread (it is
                    # thread-local): the chunks this request's sessions
                    # offer may run fused with its peers', on the thread
                    # of whichever member completes a round — every one
                    # of them under its lane's device and stream
                    st.enter_context(mb.member(req))
                try:
                    rc_box.append(
                        cli.run(
                            i, out, err, ["kafkabalancer"] + req.argv,
                            device=device,
                            shard_devices=shard_devices,
                            attrs=attrs,
                            refresh_attrs=(
                                refresh if lane is not None else None
                            ),
                            session=ctx,
                        )
                    )
                except spec_mod.SpeculationAborted:
                    # a preempted speculative run: no rc, no traceback
                    # noise — the empty rc_box reads as a non-ok
                    # response and the speculator counts it aborted.
                    # Kernels it already queued run on the lane's
                    # stream ahead of the next request's, which reads
                    # none of their outputs.
                    pass

        # a named thread per request: the request's telemetry spans get
        # their own track ("serve-req-N"; internal speculative/watch
        # work runs as "serve-int-N" so the phase histograms can skip
        # it), and the flight recorder attributes phase spans to it by
        # name
        thread_name = (
            f"serve-int-{seq}" if internal is not None
            else f"serve-req-{seq}"
        )
        t = threading.Thread(target=body, name=thread_name)
        if lane is not None:
            self._thread_lanes[thread_name] = lane
        try:
            t.start()
            t.join()
            rc: Optional[int] = rc_box[0] if rc_box else None
            if rc is None:
                # cli.run raised: a daemon-side crash must NOT
                # masquerade as one of the CLI's documented exit codes —
                # an ok:false response makes the client fall back and
                # plan in-process
                if internal is None:
                    self._log(
                        f"serve: request {seq} crashed "
                        "(see traceback above)"
                    )
                if mb is not None and not req.mb_entered:
                    # the body died BEFORE joining its batcher's barrier
                    # (lane-context entry failure): release the slot, or
                    # the healthy peers stall at the barrier until its
                    # timeout
                    mb.abandon()
                req.response = {
                    "v": PROTO_VERSION,
                    "ok": False,
                    "error": (
                        "speculation aborted" if internal == "spec"
                        else "internal error: planner thread died"
                    ),
                }
            else:
                req.response = {
                    "v": PROTO_VERSION,
                    "ok": True,
                    "rc": rc,
                    "stdout": out.getvalue(),
                    "stderr": err.getvalue(),
                }
            if internal is None:
                # internal work must not reset the idle clock: a daemon
                # that is only speculating (or watch-ticking) still
                # honors -serve-idle-timeout
                self._touch()
        finally:
            # the flight-recorder request summary + the reconciliation
            # histogram: EVERY _handle_plan call (crash paths included)
            # lands exactly one serve.request_s observation, so a
            # post-traffic scrape's hist count equals serve.requests
            wall = time.perf_counter() - t_start
            if internal is None:
                obs.metrics.hist_observe("serve.request_s", wall)
                # feed the admission layer's retry-after estimate
                self._admission.note_service(wall)
                # the tenant dimension: same invariant per label
                obs.metrics.tenant_hist_observe(
                    "serve.request_s", tenant_label, wall
                )
                obs.metrics.tenant_count("serve.requests", tenant_label)
            else:
                # speculative/watch work carries its OWN wall hist —
                # never serve.request_s (its count must equal
                # serve.requests exactly) and never the retry-after
                # EWMA (idle work must not skew overload estimates)
                obs.metrics.hist_observe(f"serve.{internal}.plan_s", wall)
                if tally:
                    with self._lock:
                        kind = self.internal_launches.setdefault(
                            internal, {}
                        )
                        for name, k in tally.items():
                            kind[name] = kind.get(name, 0) + k
            phases = self.flight.pop_request_phases(thread_name)
            self._thread_lanes.pop(thread_name, None)
            rc_val = rc_box[0] if rc_box else None
            if ctx is not None:
                # revert the unemitted complete-partition probe
                # applies (post-run: the output already aliased them),
                # fold the tapped mutations into the session's
                # predicted digest (or poison it on failure), refresh
                # the byte estimate, and memoize the shape bucket once
                # — the connection thread still holds the session lock
                ctx.apply_unemitted_reverts()
                ctx.session.finish(rc_val)
                if ctx.session.bucket is None and ctx.session.raw:
                    try:
                        from kafkabalancer_tpu_torch.models.partition import (
                            PartitionList,
                        )
                        from kafkabalancer_tpu_torch.ops.runtime import (
                            prefetch_hints,
                        )

                        # hints run on the RAW shadow (pre-settle
                        # semantics, moves applied): the bucket must
                        # equal what the probe computes on the next
                        # request's freshly parsed input, or session
                        # requests would never coalesce with stateless
                        # same-cluster peers
                        hints = prefetch_hints(
                            PartitionList(
                                version=ctx.session.version,
                                partitions=ctx.session.raw,
                            ),
                            _argv_brokers(req.argv),
                        )
                        ctx.session.bucket = (
                            int(hints["P"]), int(hints["R"]),
                            int(hints["B"]), bool(hints["all_allowed"]),
                        )
                    except Exception:
                        pass  # bucket stays unmemoized; probe-only loss
                if self.spill is not None and internal is None:
                    # the CONTINUOUS spill: every clean session request
                    # refreshes the warm record (skipped when the
                    # digest has not moved), so a SIGKILL at any later
                    # instant loses at most the in-flight request —
                    # restart recovery works from exactly this write.
                    # One O(P) struct pack + an atomic tmp+rename per
                    # completed request; a failed write only costs
                    # durability, never the answer (write_failures).
                    # INTERNAL (speculative/watch) runs never spill:
                    # their post-run state is ahead of what the client
                    # has seen — the last real request's record is the
                    # one a restore must match (serve/sessions.py)
                    self.spill.spill(
                        (ctx.session.tenant, ctx.session.sig),
                        ctx.session,
                    )
            if internal is None:
                self.flight.record_request({
                    "req": seq,
                    "t": round(time.time(), 3),
                    "lane": lane.index if lane is not None else 0,
                    "tenant": req.tenant or None,
                    "bucket": list(req.bucket) if req.bucket else None,
                    "rc": rc_val,
                    "coalesced": coalesced,
                    "wall_s": round(wall, 6),
                    "phases": {k: round(v, 6) for k, v in sorted(
                        phases.items()
                    )},
                    "trace": (
                        str(trace["id"])
                        if trace is not None and trace.get("id")
                        else None
                    ),
                })
            if (
                trace is not None
                and internal is None
                and isinstance(req.response, dict)
                and req.response.get("ok")
            ):
                # the reply footer: this request's bounded daemon span
                # subtree rides back to the client (raw perf_counter_ns
                # stamps, mapped through the client's clock-offset
                # estimate)
                req.response["trace"] = {
                    "id": trace.get("id"),
                    "wall_s": round(wall, 6),
                    "spans": self.flight.spans_for_thread(
                        thread_name, cap=FOOTER_SPAN_CAP
                    ),
                }
            if rc_val is None and internal is None:
                with self._lock:
                    self._crashed += 1
                obs.metrics.count("serve.crashed_requests")
                obs.metrics.tenant_count(
                    "serve.crashed_requests", tenant_label
                )
                self.flight.autodump(
                    f"crash-req-{seq}",
                    directory=self.flight_dir or None,
                    log=self._log,
                )
            elif (
                internal is None
                and self.slow_ms > 0
                and wall * 1000.0 >= self.slow_ms
            ):
                with self._lock:
                    self._slow += 1
                obs.metrics.count("serve.slow_requests")
                self.flight.autodump(
                    f"slow-req-{seq}",
                    directory=self.flight_dir or None,
                    log=self._log,
                )

    # -- lanes -----------------------------------------------------------
    def _resolve_devices(self) -> List[Any]:
        """The daemon's devices: the ones it was given (tests pass CPU
        devices; a device may be named twice, as in ``parallel/mesh.py``),
        else every visible CUDA device — none without a card, and then
        device work fails exactly as in process (exit 3): the daemon
        never plans on the CPU unless it was given CPU devices."""
        import torch

        if self._device_spec is not None:
            return [torch.device(d) for d in self._device_spec]
        if not torch.cuda.is_available():
            return []
        return [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]

    def _device0(self) -> Any:
        return self._devices[0] if self._devices else None

    def _resolve_lanes(self) -> int:
        """How many lanes to run: 1 stays the Coalescer; auto (<=0) and
        N>1 resolve against the device count. One device always
        degrades to 1."""
        if self.lanes == 1:
            return 1
        ndev = len(self._devices)
        n = ndev if self.lanes <= 0 else min(self.lanes, ndev)
        return max(1, n)

    def _make_dispatcher(self) -> Any:
        """The request dispatcher, chosen by the reference's rule: the
        single-lane Coalescer for an explicit ``-serve-lanes=1`` or for
        one lane without ``-serve-microbatch`` above 1, else the lane
        scheduler with per-device lanes, affinity routing, stealing, the
        watchdog and the ``lane_crash`` fault site."""
        self._devices = self._resolve_devices()
        n_lanes = self._resolve_lanes()
        if self.lanes == 1 or (n_lanes <= 1 and self.microbatch <= 1):
            from kafkabalancer_tpu_torch.ops.tensorize import set_row_cache

            set_row_cache(self.tensorize_cache)
            return Coalescer(self._handle_plan, self._bucket_of)
        from kafkabalancer_tpu_torch.serve.cache import TensorizeRowCache
        from kafkabalancer_tpu_torch.serve.lanes import Lane, LaneScheduler

        self._lanes = []
        for i in range(n_lanes):
            lane = Lane(i, self._devices[i] if i < len(self._devices) else None)
            lane.row_cache = TensorizeRowCache()
            self._lanes.append(lane)
        scheduler = LaneScheduler(
            self._handle_plan,
            self._bucket_of,
            self._lanes,
            microbatch=self.microbatch,
            stage=self._stage_request,
            admissible=self._admissible_request,
            batch_mode=self.batch_mode,
            admission_hold=self.admission_hold,
            watchdog_s=self.watchdog_s,
            exclusive=self._mesh_exclusive_request,
        )
        # the admission window scales with the real lane count: each
        # lane can batch up to `microbatch` members and should have a
        # queued same-bucket feed for mid-flight admission
        self._admission.set_window(max(
            4, self.admission_hold,
            2 * self.microbatch * len(self._lanes),
        ))
        self._admission.set_parallel(len(self._lanes))
        # concurrent request bodies share the daemon-lifetime registry:
        # a per-request reset would wipe an in-flight peer's attribution.
        # Set only AFTER the scheduler constructed — a construction
        # failure falls back to the Coalescer, which must keep the
        # per-invocation metrics epochs.
        obs.set_shared_registry(True)
        self._log(
            f"serve: {n_lanes} device lane{'s' if n_lanes != 1 else ''} "
            f"({', '.join(str(ln.device) for ln in self._lanes)})"
            + (
                f", {self.batch_mode} batching up to {self.microbatch}"
                if self.microbatch > 1
                else ""
            )
        )
        return scheduler

    @staticmethod
    def _admissible_request(req: PlanRequest) -> bool:
        """ADMISSION prediction: will this request's planning reach a
        fusible dispatch (the torch engine's batched sessions: the move
        session at any batch, on the colocation objective too, and the
        polish alternation)? Only such requests join a lane's batcher
        (serve/lanes.py ``LaneScheduler._run_group``); the verdict is
        the reference's on every argv. Conservative on purpose: a false
        negative costs a missed fusion, a false positive stalls the
        batch's live peers until it completes."""
        if req.internal is not None:
            # idle speculative/watch work must never couple its
            # lifetime to a live request's fused batch
            return False
        if _argv_value(req.argv, "fused") != "true":
            return False
        if _argv_value(req.argv, "rebalance-leader") == "true":
            return False
        engine = _argv_value(req.argv, "fused-engine") or "auto"
        return (
            engine in ("auto", "xla")
            and _argv_value(req.argv, "fused-shard") != "true"
        )

    @staticmethod
    def _mesh_exclusive_request(req: PlanRequest) -> bool:
        """MESH-EXCLUSIVE prediction: a ``-fused-shard`` plan spreads
        over EVERY lane's device, so it must never race lane-pinned
        work — the scheduler drains all lanes before running it and
        holds new dispatches until it returns (serve/lanes.py
        ``LaneScheduler._run_exclusive``)."""
        return _argv_value(req.argv, "fused-shard") == "true"

    def _stage_request(self, req: PlanRequest, lane: Any) -> None:
        """Host-encode stage of the lane pipeline (runs on the lane's
        stage thread while the lane runs the request ahead): parse,
        settle and tensorize the NEXT request — priming the lane's row
        cache — and copy its dense arrays into the lane's residency
        pool, digest-keyed, so the request's upload finds them resident.
        Pure overlap: a misprediction costs only misses, and the
        scheduler swallows a failure (``serve.stage_failures``)."""
        if _argv_value(req.argv, "fused") != "true":
            # host-only planning, or a solver whose device pass uploads
            # its own arrays (-solver=tpu): nothing to stage
            return
        if _argv_value(req.argv, "fused-shard") == "true":
            return  # the sharded session places its own shards
        parsed = self._parse_request(req)
        if parsed is None:
            return
        pl, brokers = parsed
        from kafkabalancer_tpu_torch.models import default_rebalance_config
        from kafkabalancer_tpu_torch.utils.flags import go_atoi

        # the config subset that shapes settle/tensorize; a flag this
        # prediction misses costs only the overlap (digest misses)
        cfg = default_rebalance_config()
        cfg.brokers = brokers
        if _argv_value(req.argv, "allow-leader") == "true":
            cfg.allow_leader_rebalancing = True
        mr = _argv_value(req.argv, "min-replicas")
        if mr is not None:
            cfg.min_replicas_for_rebalancing = go_atoi(mr)
        budget_raw = _argv_value(req.argv, "max-reassign")
        budget = go_atoi(budget_raw) if budget_raw is not None else 1
        if budget <= 0:
            return
        with lane.context():
            from kafkabalancer_tpu_torch.ops.tensorize import (
                all_allowed_of,
                stage_host_arrays,
                tensorize,
            )
            from kafkabalancer_tpu_torch.solvers.scan import _settle_head

            _settle_head(pl, cfg, budget)
            with obs.span("serve.stage_encode", lane=lane.index):
                dp = tensorize(pl, cfg)
            # the arrays ops.tensorize.to_device uploads for this plan
            record: Dict[str, Any] = {}
            staged = stage_host_arrays(
                lane.stage_cache,
                (
                    dp.replicas, dp.weights, dp.nrep_cur, dp.nrep_tgt,
                    dp.ncons, None if all_allowed_of(dp) else dp.allowed,
                    dp.member, dp.pvalid, dp.bvalid,
                ),
                lane.device if lane.device is not None else "cpu",
                lane.copy_stream(),
                record,
            )
            lane.stage_log.append(record)
        obs.metrics.count("serve.staged_requests")
        obs.metrics.gauge("serve.last_staged_arrays", float(staged))

    def _memory_snapshot(self) -> List[Dict[str, Any]]:
        """Per-lane device-memory attribution: the caching allocator's
        bytes and the card's total (``serve.devmem`` — null until CUDA
        is initialized, and on CPU lanes) plus the residency pool's
        tensor bytes. One entry per lane; the single-lane Coalescer
        reports lane 0 with no pool."""
        lanes = [
            (ln.index, ln.device, ln.stage_cache) for ln in self._lanes
        ] or [(0, self._device0(), None)]
        out: List[Dict[str, Any]] = []
        for index, dev, pool in lanes:
            hbm = (device_memory_stats(dev) if dev is not None else None) or {}
            out.append({
                "lane": index,
                "hbm_bytes_in_use": hbm.get("bytes_in_use"),
                "hbm_bytes_limit": hbm.get("bytes_limit"),
                "residency_bytes": 0 if pool is None else pool.device_bytes(),
                "residency_entries": 0 if pool is None else len(pool),
            })
        return out

    def _core_snapshot(self) -> Dict[str, Any]:
        """The ONE daemon-state snapshot both ``hello`` and ``stats``
        render from — the two scrape paths cannot drift."""
        with self._lock:
            n, n_coal, inflight = (
                self._requests, self._coalesced, self._inflight,
            )
            slow, crashed = self._slow, self._crashed
            fallbacks = dict(self._fallbacks)
        fault_plan = faults.active()
        # tensorize-cache attribution: the process-wide cache plus every
        # resident session's trusted-delta cache (retired sessions
        # folded in, so the counters stay monotone)
        sess_cache = self.sessions.cache_stats()
        base_cache = self.tensorize_cache.stats()
        cache = {
            k: base_cache.get(k, 0) + sess_cache.get(k, 0)
            for k in ("hits", "misses", "rows_reused")
        }
        out: Dict[str, Any] = {
            "pid": os.getpid(),
            "version": __version__,
            "uptime_s": round(time.monotonic() - self._started, 3),
            # still inside the startup warm window: a client progress
            # probe must not read "no in-flight work" as a wedge while
            # the dispatcher is still being built
            "warming": not self._warm_done.is_set(),
            "requests": n,
            "coalesced": n_coal,
            "requests_inflight": inflight,
            "slow_requests": slow,
            "crashed_requests": crashed,
            "cache": cache,
            "memory": self._memory_snapshot(),
            # resident cluster sessions (serve/sessions.py): count,
            # resident bytes, delta hits/resyncs — serve-stats/3
            "sessions": self.sessions.stats(),
            # the warm session tier (serve/spill.py): spill/restore/
            # corrupt-drop counters under the conservation identity
            # spills + adopted == restores + corrupt_drops + evictions
            # + warm_entries, plus the live warm footprint; key set
            # identical with the tier disabled
            "paging": (
                self.spill.stats() if self.spill is not None
                else spill_mod.SpillStore.disabled_stats()
            ),
            # speculative plan-ahead (serve/speculate.py) under the
            # exact identity attempts == hits + misses + poisoned +
            # memos at every scrape instant
            "speculation": self.speculator.stats(),
            # the watch-driven continuous controller: ticks/reads/lag +
            # emitted-plan attribution; same key set with the mode off
            "watch": self._watch_stats(),
            # daemon-observed fallback/resync reasons, by name
            "fallbacks": fallbacks,
            # overload protection (serve-stats/5): fair-queue occupancy,
            # caps, shed counts by reason, the live retry_after estimate
            "admission": self._admission.stats(),
            # the chaos seam: armed spec (null when inert) + per-site
            # fired counts — a chaos run's scrape names what it injected
            "faults": {
                "armed": fault_plan.spec if fault_plan is not None else None,
                "fired": (
                    fault_plan.fired_counts()
                    if fault_plan is not None else {}
                ),
            },
        }
        sched = self._coalescer
        if sched is not None and hasattr(sched, "health_stats"):
            out["lane_health"] = sched.health_stats()
        else:
            out["lane_health"] = {
                "watchdog_s": self.watchdog_s, "quarantined": [],
                "quarantines": 0, "requeues": 0, "recoveries": 0,
                "abandoned": 0,
            }
        if self._lanes and hasattr(sched, "stats"):
            s = sched.stats()
            out["lanes"] = int(s["lanes"])
            out["steals"] = int(s["steals"])
            # mesh-exclusive runs (-fused-shard: drained the fleet and
            # owned every device for the dispatch)
            out["mesh_exclusive"] = int(s.get("mesh_exclusive", 0))
            out["microbatched"] = int(s["microbatched"])
            out["batch_mode"] = self.batch_mode
            out["mb_occupancy"] = sched.occupancy_hist()
            out["mb_padded_slots"] = int(s["padded_slots"])
            out["residency"] = {
                "hits": int(s["residency_hits"]),
                "misses": int(s["residency_misses"]),
            }
            out["lane_busy_s"] = [
                round(ln.busy_s, 3) for ln in self._lanes
            ]
            out["lane_requests"] = [ln.requests for ln in self._lanes]
            out["cache"] = {
                "hits": sess_cache["hits"] + sum(
                    ln.cache_stats()["hits"] for ln in self._lanes
                ),
                "misses": sess_cache["misses"] + sum(
                    ln.cache_stats()["misses"] for ln in self._lanes
                ),
                "rows_reused": sess_cache["rows_reused"] + sum(
                    ln.cache_stats()["rows_reused"] for ln in self._lanes
                ),
            }
        return out

    def _watch_stats(self) -> Dict[str, Any]:
        if self.watcher is not None:
            return self.watcher.stats()
        return spec_mod.ZkWatcher.disabled_stats(self.watch_conn)

    def _hello(self) -> Dict[str, Any]:
        return {
            "v": PROTO_VERSION, "ok": True, "op": "hello",
            # v2 negotiation: always advertised; only clients that
            # ALSO advertised it switch the connection's framing
            "max_v": PROTO_V2,
            **self._core_snapshot(),
        }

    def _tenants_block(self) -> Dict[str, Any]:
        """The serve-stats/5 per-tenant attribution block: one entry
        per live top-K tenant (keyed off the ``serve.request_s`` family
        — request activity is the authority on who is "top") carrying
        request counts, latency hists, queue time, the session
        delta/resync ladder, fallback counts and resident session
        bytes; demoted tenants aggregate under ``other``. Reads only
        the registry's label families and the session store — locks
        the plan dispatcher never holds across a dispatch."""
        snap = obs.metrics.tenant_snapshot()
        hfams, cfams = snap["hists"], snap["counters"]
        req_fam = hfams.get("serve.request_s") or {
            "cap": self.tenant_cap, "demoted": 0, "other": None,
            "labels": {},
        }
        queue_fam = hfams.get("serve.phase.queue") or {
            "other": None, "labels": {},
        }
        edge_fam = hfams.get("serve.edge_ms") or {
            "other": None, "labels": {},
        }

        def cval(name: str, label: str) -> int:
            fam = cfams.get(name)
            if fam is None:
                return 0
            if label == OTHER_LABEL:
                # the families LRU independently: a label demoted from
                # the request_s family may still hold live counters in
                # a sparser family (delta_hits is only touched on
                # hits). The rollup absorbs every count NOT attributed
                # to a live top-K label, so the table's totals always
                # reconcile with the global blocks.
                return int(
                    fam.get("other", 0)
                    + sum(
                        v for lbl, v in fam["labels"].items()
                        if lbl not in top_labels
                    )
                )
            return int(fam["labels"].get(label, 0))

        by_tenant = self.sessions.stats_by_tenant()
        # the rollup's session footprint: everything resident (hot OR
        # warm) that is NOT attributed to a live top-K label (demoted
        # tenants keep their sessions; the table must still reconcile
        # with the global "sessions"/"paging" blocks)
        top_labels = set(req_fam["labels"])
        rolled = {
            "sessions": 0, "bytes": 0,
            "warm_sessions": 0, "warm_bytes": 0,
        }
        for t_label, s in by_tenant.items():
            if t_label not in top_labels:
                rolled["sessions"] += s["sessions"]
                rolled["bytes"] += s["bytes"]
                rolled["warm_sessions"] += s.get("warm_sessions", 0)
                rolled["warm_bytes"] += s.get("warm_bytes", 0)

        def entry(label: str, hist: Optional[Dict[str, Any]]) -> Dict[str, Any]:
            sess = rolled if label == OTHER_LABEL else by_tenant.get(
                label, {}
            )
            queue = (
                queue_fam.get("other") if label == OTHER_LABEL
                else queue_fam["labels"].get(label)
            )
            edge = (
                edge_fam.get("other") if label == OTHER_LABEL
                else edge_fam["labels"].get(label)
            )
            return {
                "requests": cval("serve.requests", label),
                "crashed": cval("serve.crashed_requests", label),
                "request_s": hist,
                "queue_s": queue,
                # serve-stats/8: client+network edge overhead per label
                # (pre-send client phases + measured RTT, milliseconds)
                # — None until a tracing client reports (obs/edge.py)
                "edge_ms": edge,
                "delta_hits": cval("serve.delta_hits", label),
                "spec_hits": cval("serve.spec.hits", label),
                "resyncs_rows": cval("serve.resyncs_rows", label),
                "resyncs_full": cval("serve.resyncs_full", label),
                "fallbacks": cval("serve.fallbacks", label),
                "sheds": cval("serve.sheds", label),
                "restores": cval("serve.restores", label),
                "sessions": int(sess.get("sessions", 0)),
                "session_bytes": int(sess.get("bytes", 0)),
                # the warm tier column: a fully demoted tenant keeps
                # its byte attribution here instead of vanishing
                "warm_sessions": int(sess.get("warm_sessions", 0)),
                "warm_bytes": int(sess.get("warm_bytes", 0)),
            }

        other = entry(OTHER_LABEL, req_fam.get("other"))
        has_other = req_fam.get("other") is not None or any(
            other[k] for k in (
                "requests", "crashed", "delta_hits", "spec_hits",
                "resyncs_rows", "resyncs_full", "fallbacks", "sheds",
                "restores", "warm_sessions",
            )
        )
        return {
            "cap": int(req_fam.get("cap", self.tenant_cap)),
            "demoted": int(req_fam.get("demoted", 0)),
            "top": {
                label: entry(label, hist)
                for label, hist in req_fam["labels"].items()
            },
            "other": other if has_other else None,
        }

    def _watch_doc(self) -> Dict[str, Any]:
        """The ``watch`` op's answer: the watch block and the
        speculation block (the watcher's steady state is memo reads)."""
        return {
            "v": PROTO_VERSION, "ok": True, "op": "watch",
            "watch": self._watch_stats(),
            "speculation": self.speculator.stats(),
        }

    def _stats_doc(self) -> Dict[str, Any]:
        """The ``stats`` scrape document (``STATS_SCHEMA``): the shared
        core snapshot plus every streaming histogram, the per-tenant
        attribution block and the flight recorder's occupancy. Built
        entirely from locks the plan dispatcher never holds across a
        dispatch, so a scrape cannot pause planning."""
        doc: Dict[str, Any] = {
            "v": PROTO_VERSION, "ok": True, "op": "stats",
            "schema": STATS_SCHEMA,
            "ts_epoch": round(time.time(), 3),
            **self._core_snapshot(),
        }
        doc["batch_mode"] = self.batch_mode
        doc["hists"] = obs.metrics.hist_snapshot()
        doc["tenants"] = self._tenants_block()
        doc["flight"] = self.flight.stats()
        return doc

    def _touch(self) -> None:
        self._last_activity = time.monotonic()

    def _dispatch_plan(self, req: PlanRequest) -> Optional[Dict[str, Any]]:
        """Route one plan request through admission control and the
        dispatcher (waiting out the startup race), with the in-flight
        gauge held; None when the dispatcher never became ready. A shed
        returns the structured overload frame WITHOUT touching the
        dispatcher — shed latency lands in ``serve.shed_s``, never in
        the served-request histograms."""
        self._dispatcher_ready.wait(DISPATCHER_WAIT_S)
        dispatcher = self._coalescer
        if dispatcher is None:
            return None
        # t_submit anchors the queue-wait histogram at ARRIVAL: the
        # fair-queue wait is part of what a tenant waits behind
        # (admission.acquire preempts any in-flight speculation via
        # its arrival hook — idle work never costs live traffic p95)
        req.t_submit = time.perf_counter()
        shed = self._admission.acquire(req)
        if shed is not None:
            return shed
        try:
            return dispatcher.submit(req)
        finally:
            self._admission.release(req)

    @contextlib.contextmanager
    def _inflight_op(self) -> "Iterator[None]":
        """Hold the ``requests_inflight`` gauge across one plan-family
        connection op — from frame decode through response build, the
        session-op pre-dispatch work (register parse/digest, row
        patching) INCLUDED: a client's progress probe reads
        ``requests_inflight > 0`` as "my request is being worked on",
        and that must be true for every phase the daemon can spend
        real time in, or a slow register reads as a lost request."""
        with self._lock:
            self._inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._inflight -= 1

    # -- protocol v2: session ops ----------------------------------------
    def _v2_plan_resp(
        self, resp: Optional[Dict[str, Any]]
    ) -> Tuple[Dict[str, Any], bytes]:
        """A dispatcher response as a v2 frame: stdout rides the blob
        (no JSON escaping), the rest in the header."""
        if resp is None:
            return {
                "v": PROTO_V2, "ok": False, "op": "error",
                "error": "daemon dispatcher not ready",
            }, b""
        if not resp.get("ok"):
            if resp.get("op") == "overload":
                # the structured shed frame survives v2 framing intact:
                # the client's backoff ladder reads retry_after_ms
                return {
                    "v": PROTO_V2, "ok": False, "op": "overload",
                    "reason": str(resp.get("reason", "overload")),
                    "retry_after_ms": int(resp.get("retry_after_ms", 0)),
                    "error": str(resp.get("error", "request shed")),
                }, b""
            return {
                "v": PROTO_V2, "ok": False, "op": "error",
                "error": str(resp.get("error", "request failed")),
            }, b""
        hdr: Dict[str, Any] = {
            "v": PROTO_V2, "ok": True, "rc": int(resp.get("rc", -1)),
            "stderr": str(resp.get("stderr", "")),
        }
        if isinstance(resp.get("trace"), dict):
            # the reply footer (daemon span subtree + wall) rides the
            # v2 header back to tracing clients — ONLY when the request
            # carried a trace context, so trace-less clients see the
            # exact pre-tracing header shape
            hdr["trace"] = resp["trace"]
        return hdr, str(resp.get("stdout", "")).encode("utf-8")

    def _checkout_or_restore(
        self, key: Tuple[str, str], tenant: str
    ) -> Tuple[Optional[Any], bool, bool]:
        """Claim the hot session for ``key`` — or, when the hot tier
        has none and a warm tier is attached, RESTORE the spilled
        record into a fresh hot session (claimed before it is
        published, so no concurrent request can half-see it).

        Returns ``(session, busy, restored)``: a corrupt/absent warm
        record is simply ``(None, False, False)`` — a clean cold miss,
        the caller answers ``resync: full`` exactly as before the
        tier existed."""
        from kafkabalancer_tpu_torch.serve.sessions import session_from_rows

        sess, busy = self.sessions.checkout(key)
        if sess is not None or busy:
            return sess, busy, False
        if self.spill is None:
            return None, False, False
        # snapshot the tenant's release generation BEFORE reading the
        # record: a `release` op racing this restore must win — the
        # restored session is dropped, never served
        gen0 = self.sessions.release_gen(tenant)
        loaded = self.spill.load(key)
        if loaded is None:
            return None, False, False
        hdr, rows = loaded
        version = hdr.get("version")
        sess = session_from_rows(
            tenant, key[1],
            version if isinstance(version, int) else 1,
            rows,
        )
        sess.lock.acquire()
        sess.in_use = True
        if not self.sessions.adopt(key, sess):
            # a concurrent register won the key during the disk read:
            # the fresh session holds newer state — drop the restore
            # and claim the winner instead
            sess.in_use = False
            sess.lock.release()
            hot, busy = self.sessions.checkout(key)
            return hot, busy, False
        if self.sessions.release_gen(tenant) != gen0:
            # the tenant was released while we were restoring: honor
            # the forget — sweep the just-adopted session back out and
            # answer a clean cold miss (the record itself is already
            # consumed and counted); only THIS session is dropped, so
            # a fresh register that beat us to the key survives
            self.sessions.discard(key, sess)
            self.sessions.checkin(sess)
            return None, False, False
        obs.metrics.tenant_count("serve.restores", tenant or OTHER_LABEL)
        return sess, False, True

    def _answer_from_memo(
        self,
        key: Tuple[str, str],
        sess: Any,
        memo: Any,
        tenant: str,
        deadline: Optional[float],
        argv: List[str],
        t0: float,
        trace: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Answer a digest-and-argv-matching ``plan-delta`` from the
        speculative memo (serve/speculate.py): ZERO dispatch, ZERO
        parse — the answer was computed during the idle window after
        the previous request. The memo hit is a REAL request: it rides
        admission (so the fairness caps and the conservation identity
        ``admitted == requests + abandoned`` hold), counts in
        ``serve.requests``/``serve.request_s``/the flight log like any
        served request (with its near-zero wall — that IS the
        speedup), counts a delta hit (it is the delta fast path at its
        fastest) and carries the ``serve.spec.*`` hit attribution the
        acceptance gate reads. The caller still holds the session
        checkout and has already CONSUMED the memo via
        ``Speculator.take_memo`` (the CAS that makes hit-vs-poison
        retirement exactly-once)."""
        req = PlanRequest(argv, None, tenant, deadline=deadline)
        shed = self._admission.acquire(req)
        if shed is not None:
            # the answer was never delivered: put the memo back so the
            # client's backoff retry (same digest) can still hit
            self.speculator.untake_memo(sess, memo)
            return shed
        try:
            tenant_label = tenant or OTHER_LABEL
            obs.metrics.tenant_count("serve.spec.hits", tenant_label)
            self.sessions.count_delta_hit()
            obs.metrics.tenant_count("serve.delta_hits", tenant_label)
            with self._lock:
                self._requests += 1
                self._seq += 1
                seq = self._seq
            sess.last_used = time.monotonic()
            if self.spill is not None:
                # the continuous-spill invariant moves with the hit:
                # the client now advances to the memo's post-move
                # state, which is exactly the session's current raw
                # shadow — persist it so a SIGKILL still restores with
                # a digest match
                self.spill.spill(key, sess)
            wall = time.perf_counter() - t0
            obs.metrics.hist_observe("serve.spec.hit_s", wall)
            obs.metrics.hist_observe("serve.request_s", wall)
            obs.metrics.tenant_hist_observe(
                "serve.request_s", tenant_label, wall
            )
            obs.metrics.tenant_count("serve.requests", tenant_label)
            self.flight.record_request({
                "req": seq,
                "t": round(time.time(), 3),
                "lane": 0,
                "tenant": tenant or None,
                "bucket": list(sess.bucket) if sess.bucket else None,
                "rc": memo.rc,
                "coalesced": False,
                "spec_hit": True,
                "wall_s": round(wall, 6),
                "phases": {},
                "trace": (
                    str(trace["id"])
                    if trace is not None and trace.get("id")
                    else None
                ),
            })
            self._touch()
            resp: Dict[str, Any] = {
                "v": PROTO_VERSION, "ok": True, "rc": memo.rc,
                "stdout": memo.stdout, "stderr": memo.stderr,
            }
            if trace is not None:
                # the memo hit ran no request thread, so the footer's
                # span subtree is empty — spec_hit marks WHY for the
                # merged timeline (the answer predates the question)
                resp["trace"] = {
                    "id": trace.get("id"),
                    "wall_s": round(wall, 6),
                    "spans": [],
                    "spec_hit": True,
                }
            return resp
        finally:
            self._admission.release(req)

    def _session_op(
        self, op: str, hdr: Dict[str, Any], blob: bytes, argv: List[str]
    ) -> Tuple[Dict[str, Any], bytes]:
        """One v2 plan-family op (``plan``/``register``/``plan-delta``/
        ``plan-rows``) — the resident-session ladder of
        serve/sessions.py. Returns the response (header, blob)."""
        from kafkabalancer_tpu_torch.serve import state as sstate
        from kafkabalancer_tpu_torch.serve.sessions import (
            ClusterSession,
            PlanSessionContext,
            flags_signature,
        )

        def _resync_full() -> Tuple[Dict[str, Any], bytes]:
            return {
                "v": PROTO_V2, "ok": True, "op": op, "resync": "full",
            }, b""

        tenant = str(hdr.get("tenant", ""))
        deadline = _deadline_of(hdr)
        # the client's trace context (obs/edge.py), v2-only; telemetry
        # only: threaded onto every PlanRequest the op creates and NEVER
        # read by planning
        trace_hdr = hdr.get("trace")
        trace = trace_hdr if isinstance(trace_hdr, dict) else None
        if op == "plan":
            stdin = (
                blob.decode("utf-8", errors="replace")
                if hdr.get("has_stdin") else None
            )
            req = PlanRequest(argv, stdin, tenant, deadline=deadline)
            req.trace = trace
            return self._v2_plan_resp(self._dispatch_plan(req))

        key = (tenant, flags_signature(argv))
        if op == "register":
            text = blob.decode("utf-8", errors="replace")
            sess = ClusterSession(tenant, key[1])
            ctx = PlanSessionContext("register", sess)
            # the fresh session is private until put(); hold its lock
            # anyway so the store can never hand it out half-built
            with sess.lock:
                sess.in_use = True
                try:
                    req = PlanRequest(argv, text, tenant, deadline=deadline)
                    req.trace = trace
                    req.session_ctx = ctx
                    sess.last_argv = list(argv)
                    resp = self._dispatch_plan(req)
                finally:
                    sess.in_use = False
            if (
                resp is not None
                and resp.get("ok")
                and resp.get("rc") == 0
                and ctx.snapshotted
            ):
                self.sessions.put(key, sess)
                # the freshly registered session's next move can start
                # computing right away (idle-priority)
                self.speculator.enqueue(key)
            return self._v2_plan_resp(resp)

        if op == "plan-delta":
            digest = str(hdr.get("digest", ""))
            spec = self.speculator
            t_hit0 = time.perf_counter()
            sess, busy, restored = self._checkout_or_restore(key, tenant)
            if sess is None and busy and spec.wait_for_key(
                key, digest, argv,
                (deadline - time.monotonic()) if deadline else 120.0,
            ):
                # speculation held the session: a MATCHING in-flight
                # run just computed this very answer (the memo path
                # below consumes it); a mismatching one was aborted —
                # either way, re-claim and proceed
                sess, busy, restored = self._checkout_or_restore(
                    key, tenant
                )
            if sess is None:
                self._count_fallback(
                    "session_busy" if busy else "session_absent", tenant
                )
                return _resync_full()
            enqueue_spec = False
            try:
                memo = sess.spec_memo
                if memo is not None:
                    if (
                        memo.key_digest == digest
                        and memo.argv == argv
                        and spec.take_memo(sess, memo)
                    ):
                        # the tentpole fast path: the answer was
                        # planned before it was asked for (take_memo
                        # is the CAS — a concurrently poisoned memo
                        # falls through to the live ladder below)
                        resp = self._answer_from_memo(
                            key, sess, memo, tenant, deadline, argv,
                            t_hit0, trace=trace,
                        )
                        enqueue_spec = bool(resp.get("ok"))
                        if enqueue_spec and spec.rearm_memo(sess, memo):
                            # fixed point: the plan moved nothing, so
                            # the session did not advance — the same
                            # memo keeps answering the same digest
                            # with no re-dispatch
                            enqueue_spec = False
                        return self._v2_plan_resp(resp)
                    # the memo cannot serve this request (drifted
                    # digest or changed flags): drop it and fall back
                    # to the live ladder — parity over latency, always
                    spec.retire_miss(sess, memo)
                if sess.digest is not None and digest == sess.digest:
                    # a just-restored session has no settled list yet;
                    # like universe_dirty, it re-derives one from the
                    # raw shadow (the "rebuild" kind) — still no state
                    # transfer, still one request back to steady state
                    kind = (
                        "rebuild"
                        if restored or sess.universe_dirty or sess.pl is None
                        else "delta"
                    )
                    ctx = PlanSessionContext(
                        kind, sess,
                        resident_pl=sess.pl if kind == "delta" else None,
                        restored=restored,
                    )
                    if restored:
                        # the acceptance counter: a digest-matching
                        # request answered from the warm tier, no
                        # re-register storm
                        self.spill.note_restore_hit()
                    else:
                        self.sessions.count_delta_hit()
                        obs.metrics.tenant_count(
                            "serve.delta_hits", tenant or OTHER_LABEL
                        )
                    req = PlanRequest(
                        argv, None, tenant, deadline=deadline
                    )
                    req.trace = trace
                    req.session_ctx = ctx
                    sess.last_argv = list(argv)
                    resp = self._dispatch_plan(req)
                    enqueue_spec = (
                        resp is not None
                        and bool(resp.get("ok"))
                        and resp.get("rc") == 0
                    )
                    return self._v2_plan_resp(resp)
                # mismatch: offer the row-level diff — the client ships
                # only the rows whose hashes differ
                self._count_fallback("session_digest_mismatch", tenant)
                table = sess.hash_table()
                return {
                    "v": PROTO_V2, "ok": True, "op": op,
                    "resync": "rows", "nrows": len(sess.raw),
                }, table
            finally:
                self.sessions.checkin(sess)
                if enqueue_spec:
                    # plan-ahead AFTER the checkin (the speculator
                    # needs the session lock): the next request's
                    # answer starts computing in the idle window
                    spec.enqueue(key)

        if op == "plan-rows":
            digest = str(hdr.get("digest", ""))
            # restore applies here too: the row diff the client built
            # against a (possibly restored) hash table patches onto the
            # restored raw shadow the same as onto a hot one
            spec = self.speculator
            sess, busy, restored = self._checkout_or_restore(key, tenant)
            if sess is None and busy and spec.wait_for_key(
                key, "", [],
                (deadline - time.monotonic()) if deadline else 30.0,
            ):
                # a resync can never use an in-flight speculation:
                # abort it, wait it out, re-claim
                sess, busy, restored = self._checkout_or_restore(
                    key, tenant
                )
            if sess is None:
                self._count_fallback(
                    "session_busy" if busy else "session_absent", tenant
                )
                return _resync_full()
            enqueue_spec = False
            try:
                rows_memo = sess.spec_memo
                if rows_memo is not None:
                    # a resyncing client has drifted past the memo
                    spec.retire_miss(sess, rows_memo)
                try:
                    patches = sstate.unpack_rows(blob)
                except ValueError:
                    self._count_fallback("session_rows_invalid", tenant)
                    self._count_resync_full(tenant)
                    return _resync_full()
                if not sess.apply_row_patches(patches):
                    self._count_fallback("session_rows_mismatch", tenant)
                    self._count_resync_full(tenant)
                    return _resync_full()
                if sess.digest != digest:
                    # the diff was computed against a table an
                    # interleaved request has since invalidated;
                    # re-register from ground truth
                    self._count_fallback("session_rows_mismatch", tenant)
                    self._count_resync_full(tenant)
                    return _resync_full()
                self.sessions.count_resync_rows()
                obs.metrics.tenant_count(
                    "serve.resyncs_rows", tenant or OTHER_LABEL
                )
                ctx = PlanSessionContext("rows", sess, restored=restored)
                req = PlanRequest(argv, None, tenant, deadline=deadline)
                req.trace = trace
                req.session_ctx = ctx
                sess.last_argv = list(argv)
                resp = self._dispatch_plan(req)
                enqueue_spec = (
                    resp is not None
                    and bool(resp.get("ok"))
                    and resp.get("rc") == 0
                )
                return self._v2_plan_resp(resp)
            finally:
                self.sessions.checkin(sess)
                if enqueue_spec:
                    spec.enqueue(key)

        return {
            "v": PROTO_V2, "ok": False, "op": "error",
            "error": f"unknown op {op!r}",
        }, b""

    def _serve_v2(self, conn: socket.socket) -> None:
        """The per-connection loop after a v2 hello negotiation: same
        ops as v1 plus the session family, all in binary frames."""
        while True:
            try:
                t_read0 = time.perf_counter()
                frame = read_frame2(conn)
                read_s = time.perf_counter() - t_read0
            except ValueError as exc:
                self._count_fallback("bad_frame")
                self._log(f"serve: refused v2 frame: {exc}")
                try:
                    write_frame2(conn, {
                        "v": PROTO_V2, "ok": False, "op": "error",
                        "error": f"bad frame: {exc}",
                    })
                except Exception:
                    pass
                return
            except Exception:
                return
            if frame is None:
                return
            hdr, blob = frame
            if hdr.get("v") != PROTO_V2:
                self._count_fallback("version_mismatch")
                write_frame2(conn, {
                    "v": PROTO_V2, "ok": False, "op": "error",
                    "error": f"protocol version {hdr.get('v')!r}",
                })
                return
            op = str(hdr.get("op", ""))
            if op == "hello":
                write_frame2(conn, {**self._hello(), "v": PROTO_V2})
            elif op == "stats":
                write_frame2(conn, {**self._stats_doc(), "v": PROTO_V2})
            elif op == "watch":
                write_frame2(conn, {**self._watch_doc(), "v": PROTO_V2})
            elif op == "release":
                # an explicit forget covers BOTH tiers: dropping only
                # the hot session would leave a warm record that
                # silently restores the "released" state later. Warm
                # FIRST — once the records are gone no new restore can
                # begin, and the hot sweep (which also bumps the
                # release generation and marks in-flight sessions
                # `released`) then catches everything resident
                rel_tenant = str(hdr.get("tenant", ""))
                warm = (
                    self.spill.release(rel_tenant)
                    if self.spill is not None else 0
                )
                n = self.sessions.release(rel_tenant)
                if self.spill is not None:
                    # second warm sweep AFTER the hot sweep marked
                    # in-flight sessions `released`: a continuous
                    # spill that indexed its record between the first
                    # sweep and the mark would otherwise survive both
                    # its own released re-check and the sweep above
                    warm += self.spill.release(rel_tenant)
                write_frame2(conn, {
                    "v": PROTO_V2, "ok": True, "op": "release",
                    "released": n, "released_warm": warm,
                })
            elif op == "shutdown":
                write_frame2(conn, {"v": PROTO_V2, "ok": True})
                self._stop.set()
                return
            elif op in ("plan", "register", "plan-delta", "plan-rows"):
                self._touch()
                raw_argv = hdr.get("argv", [])
                if not isinstance(raw_argv, list):
                    self._count_fallback("plan_invalid")
                    write_frame2(conn, {
                        "v": PROTO_V2, "ok": False, "op": "error",
                        "error": "plan payload: argv is not a list",
                    })
                    return
                obs.metrics.hist_observe("serve.phase.read", read_s)
                argv = [str(a) for a in raw_argv]
                with self._inflight_op():
                    resp_hdr, resp_blob = self._session_op(
                        op, hdr, blob, argv
                    )
                if faults.should("socket_drop"):
                    # chaos seam: vanish mid-exchange instead of
                    # replying — the client sees a dead peer and takes
                    # its transport-error path (retry, then fallback)
                    return
                t_reply0 = time.perf_counter()
                write_frame2(conn, resp_hdr, resp_blob)
                obs.metrics.hist_observe(
                    "serve.phase.reply", time.perf_counter() - t_reply0
                )
            else:
                write_frame2(conn, {
                    "v": PROTO_V2, "ok": False,
                    "error": f"unknown op {op!r}",
                })

    # thread-role: accept-loop
    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(PLAN_CONNECTION_TIMEOUT_S)
            while True:
                try:
                    t_read0 = time.perf_counter()
                    msg = read_frame(conn)
                    read_s = time.perf_counter() - t_read0
                except ValueError as exc:
                    # a structured refusal instead of a dropped
                    # connection: an oversized length prefix or an
                    # unparseable payload gets an op-"error" frame with
                    # the reason, so the client can log WHY it fell back
                    # in-process instead of a generic fallback
                    self._count_fallback("bad_frame")
                    self._log(f"serve: refused frame: {exc}")
                    try:
                        write_frame(conn, {
                            "v": PROTO_VERSION, "ok": False, "op": "error",
                            "error": f"bad frame: {exc}",
                        })
                    except Exception:
                        pass
                    return
                except Exception:
                    return  # dead peer / mid-frame EOF: nothing to tell
                if msg is None:
                    return
                if msg.get("v") != PROTO_VERSION:
                    self._count_fallback("version_mismatch")
                    write_frame(conn, {
                        "v": PROTO_VERSION, "ok": False, "op": "error",
                        "error": f"protocol version {msg.get('v')!r}",
                    })
                    return
                op = msg.get("op")
                # NOTE: only PLAN work resets the idle clock. hello and
                # the scrape ops are passive — a periodic monitoring
                # scraper (-metrics-prom on a cron) must not pin an
                # otherwise-idle daemon alive past -serve-idle-timeout
                if op == "hello":
                    t_hello_ns = time.perf_counter_ns()
                    doc = self._hello()
                    if msg.get("clock"):
                        # the opt-in clock handshake (obs/edge.py):
                        # daemon-monotonic receive/send stamps for the
                        # client's NTP-style offset estimate. STRICTLY
                        # request-gated — a plain hello (liveness
                        # probes, the stats scraper's handshake) gets
                        # the exact historical doc, preserving the
                        # hello/stats key-parity contract. recv is
                        # stamped post-read, so any parse delay inflates
                        # the client's RTT bound, never skews the
                        # offset midpoint.
                        doc["clock"] = {
                            "recv_ns": t_hello_ns,
                            "send_ns": time.perf_counter_ns(),
                        }
                    write_frame(conn, doc)
                    mv = msg.get("max_v")
                    if isinstance(mv, int) and mv >= PROTO_V2:
                        # both sides advertised v2: every further frame
                        # on this connection is binary-framed. A v1
                        # client never sends max_v, so its byte
                        # sequences mean exactly what they always did.
                        self._serve_v2(conn)
                        return
                elif op == "stats":
                    # answered HERE, on the connection thread: a live
                    # scrape must never queue behind (or pause) planning
                    write_frame(conn, self._stats_doc())
                elif op == "dump-trace":
                    write_frame(conn, {
                        "v": PROTO_VERSION, "ok": True, "op": "dump-trace",
                        "trace": self.flight.to_perfetto(),
                    })
                elif op == "watch":
                    # the watch-lag scrape: answered on the connection
                    # thread like stats, passive for the idle clock
                    write_frame(conn, self._watch_doc())
                elif op == "plan":
                    self._touch()
                    raw_argv = msg.get("argv", [])
                    if not isinstance(raw_argv, list):
                        write_frame(conn, {
                            "v": PROTO_VERSION, "ok": False, "op": "error",
                            "error": "plan payload: argv is not a list",
                        })
                        return
                    # the wire half of the served phase chain: how long
                    # the daemon spent reading this plan frame off the
                    # socket (client encode + transfer)
                    obs.metrics.hist_observe("serve.phase.read", read_s)
                    argv = [str(a) for a in raw_argv]
                    stdin = msg.get("stdin")
                    req = PlanRequest(
                        argv,
                        str(stdin) if stdin is not None else None,
                        deadline=_deadline_of(msg),
                    )
                    # startup race: the dispatcher is built on the warm
                    # thread; a plan arriving first waits for it
                    with self._inflight_op():
                        resp = self._dispatch_plan(req)
                    if resp is None:
                        write_frame(conn, {
                            "v": PROTO_VERSION, "ok": False, "op": "error",
                            "error": "daemon dispatcher not ready",
                        })
                        return
                    if faults.should("socket_drop"):
                        return  # chaos seam: dead peer instead of a reply
                    t_reply0 = time.perf_counter()
                    write_frame(conn, resp)
                    obs.metrics.hist_observe(
                        "serve.phase.reply",
                        time.perf_counter() - t_reply0,
                    )
                elif op == "shutdown":
                    write_frame(conn, {"v": PROTO_VERSION, "ok": True})
                    self._stop.set()
                    return
                else:
                    write_frame(conn, {
                        "v": PROTO_VERSION, "ok": False,
                        "error": f"unknown op {op!r}",
                    })
        except Exception:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- lifecycle -------------------------------------------------------
    # the ONE pidfile-verification rule set (liveness probe + pid-
    # recycling guard), shared with the warm tier's spill-directory
    # claim — the socket takeover and the spill-dir takeover cannot
    # drift (serve/spill.py holds the implementations)
    _pid_alive = staticmethod(spill_mod.pid_alive)
    _pid_looks_like_daemon = staticmethod(spill_mod.pid_looks_like_daemon)

    def _pidfile_owner(self) -> Optional[int]:
        """The pid recorded next to the socket, or None."""
        try:
            with open(pidfile_path(self.socket_path)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _preflight_socket(self) -> Optional[str]:
        """None when the socket path is free (stale files swept), an
        error string when a live daemon already owns it.

        The refusal is PIDFILE-VERIFIED: a socket that answers hello is
        a live daemon (refuse); a socket that does NOT answer is only
        refused when the pidfile's process is still alive (it may be
        mid-startup, wedged, or a different package version — hijacking
        its socket would orphan it). Leftovers from a SIGKILL'd daemon
        — socket + pidfile with a dead pid — are swept and replaced
        instead of blocking the restart."""
        if not os.path.exists(self.socket_path):
            # the socket is gone but a SIGKILL can still leave the
            # pidfile; sweep it so the liveness story stays coherent
            pid = self._pidfile_owner()
            if pid is not None and not self._pid_alive(pid):
                try:
                    os.unlink(pidfile_path(self.socket_path))
                except OSError:
                    pass
            return None
        from kafkabalancer_tpu_torch.serve import client

        hello = client.daemon_alive(self.socket_path, timeout=1.0)
        if hello is not None:
            return (
                f"daemon already running on {self.socket_path} "
                f"(pid {hello.get('pid')})"
            )
        pid = self._pidfile_owner()
        if (
            pid is not None
            and pid != os.getpid()
            and self._pid_alive(pid)
            and self._pid_looks_like_daemon(pid)
        ):
            return (
                f"socket {self.socket_path} is unresponsive but its "
                f"pidfile process {pid} is still alive; refusing to "
                "take it over (kill the process or remove "
                f"{pidfile_path(self.socket_path)} first)"
            )
        for path, what in (
            (self.socket_path, "socket"),
            (pidfile_path(self.socket_path), "pidfile"),
        ):
            try:
                os.unlink(path)
                self._log(
                    f"serve: swept stale {what} {path}"
                    + (f" (pid {pid} dead)" if pid is not None else "")
                )
            except FileNotFoundError:
                pass
            except OSError as exc:
                if what == "socket":
                    return f"cannot remove stale socket {path}: {exc}"
        return None

    # thread-role: accept-loop
    def serve_forever(self) -> int:
        """Run until shutdown/idle-timeout/signal; 0 on a clean exit,
        3 when the socket or spill dir is unusable (live daemon, bind
        failure, live spill-dir owner) or the fault schedule is
        malformed."""
        err = self._preflight_socket()
        if err is not None:
            self._log(f"serve: {err}")
            return 3
        if self.spill_dir:
            # the warm tier claims its directory with the same
            # pidfile-verification rules as the socket: records from a
            # DEAD previous owner are adopted (SIGKILL recovery), its
            # half-written *.tmp orphans swept, a LIVE owner refused
            store = spill_mod.SpillStore(
                self.spill_dir, cap_mb=self.warm_cap_mb, log=self._log,
            )
            err = store.open()
            if err is not None:
                self._log(f"serve: {err}")
                return 3
            self.spill = store
            self.sessions.spill = store
            st = store.stats()
            self._log(
                f"serve: warm session tier on {self.spill_dir} "
                f"(cap {st['cap_bytes'] >> 20}MB, "
                f"{st['warm_entries']} records adopted)"
            )
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            listener.bind(self.socket_path)
        except OSError as exc:
            self._log(f"serve: cannot bind {self.socket_path}: {exc}")
            listener.close()
            if self.spill is not None:
                self.spill.close()
            return 3
        listener.listen(16)
        listener.settimeout(0.5)
        pid_path = pidfile_path(self.socket_path)
        try:
            with open(pid_path, "w") as f:
                f.write(f"{os.getpid()}\n")
        except OSError:
            pid_path = ""

        from kafkabalancer_tpu_torch.ops.tensorize import set_row_cache

        # the always-on live-telemetry feed: every completed span lands
        # in the flight recorder and the per-phase streaming histograms
        # (fixed memory). Histograms reset HERE so they are
        # daemon-lifetime: the stats scrape's reconciliation invariant
        # (serve.request_s count == serve.requests) holds from request 1
        obs.metrics.reset_hists()
        # the tenant dimension resets on the same boundary, and the
        # families are created NOW so the configured cap binds before
        # the first observation (cap applies at first creation)
        obs.metrics.reset_tenants()
        for fam in _TENANT_HIST_FAMILIES:
            obs.metrics.tenant_hist(fam, cap=self.tenant_cap)
        for fam in _TENANT_COUNTER_FAMILIES:
            obs.metrics.tenant_counter(fam, cap=self.tenant_cap)
        obs.tracer.set_observer(self._observe_span)

        old_handlers: List[Tuple[int, Any]] = []
        try:
            # the chaos seam: armed ONLY here, by explicit operator
            # intent (-serve-faults, or the environment variable when
            # the flag is empty); a malformed spec refuses startup — a
            # chaos run with a typo'd schedule must not silently run
            # without its faults
            spec = self.faults_spec or os.environ.get(
                "KAFKABALANCER_TPU_TORCH_FAULTS", ""
            )
            if spec:
                try:
                    plan = faults.arm(spec)
                except ValueError as exc:
                    self._log(f"serve: bad -serve-faults spec: {exc}")
                    return 3
                self._log(f"serve: FAULT INJECTION ARMED: {plan.spec}")
            # speculative plan-ahead worker (idle-priority; no-op thread
            # unless speculation is on) and, with -watch, the continuous
            # controller — both wait out the dispatcher-ready latch
            # before touching planning, so startup order is unchanged
            self.speculator.start()
            if self.speculator.enabled:
                self._log("serve: speculative plan-ahead enabled")
            if self.watch_conn:
                self.watcher = spec_mod.ZkWatcher(
                    self,
                    self.watch_conn,
                    emit=self.watch_emit,
                    poll_s=self.watch_poll,
                    argv=self.watch_argv,
                )
                self.watcher.start()
                self._log(
                    f"serve: watching zookeeper {self.watch_conn} "
                    f"(poll {self.watch_poll:g}s"
                    + (
                        f", emitting plans to {self.watch_emit}"
                        if self.watch_emit else ""
                    )
                    + ")"
                )
            if self.warm:
                # the dispatcher is built on the warm thread (torch
                # import, CUDA context, kernel load) so the accept loop
                # answers hello immediately; plans wait on
                # _dispatcher_ready
                threading.Thread(
                    target=self._warm_body, name="serve-warm", daemon=True
                ).start()
            else:
                self._coalescer = self._make_dispatcher()
                self._dispatcher_ready.set()
                self._warm_done.set()

            if threading.current_thread() is threading.main_thread():
                for sig in (signal.SIGTERM, signal.SIGINT):
                    old_handlers.append((sig, signal.getsignal(sig)))
                    signal.signal(sig, lambda *_a: self._stop.set())

            self._log(
                f"serve: listening on {self.socket_path} "
                f"(pid {os.getpid()}, idle timeout "
                f"{self.idle_timeout:g}s)" if self.idle_timeout > 0 else
                f"serve: listening on {self.socket_path} "
                f"(pid {os.getpid()})"
            )
            self._touch()
            while not self._stop.is_set():
                self.sessions.sweep()
                # overload/health maintenance, every accept tick
                # (~0.5 s): shed queued requests past their deadline,
                # and run the lane watchdog (quarantine / requeue /
                # recover)
                self._admission.sweep()
                tick_disp = self._coalescer
                if tick_disp is not None and hasattr(
                    tick_disp, "health_tick"
                ):
                    tick_disp.health_tick(log=self._log)
                if (
                    self.idle_timeout > 0
                    and self._warm_done.is_set()
                    and self._coalescer is not None
                    and not self._coalescer.busy()
                    and not self._admission.busy()
                    and time.monotonic() - self._last_activity
                    > self.idle_timeout
                ):
                    self._log(
                        f"serve: idle for {self.idle_timeout:g}s, "
                        "shutting down"
                    )
                    break
                try:
                    conn, _addr = listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(
                    target=self._serve_connection,
                    args=(conn,),
                    name="serve-conn",
                    daemon=True,
                ).start()
        finally:
            listener.close()
            # internal producers first: the speculator/watcher stop
            # FEEDING the dispatcher (their in-flight runs abort at the
            # next preemption check and drain through dispatcher stop)
            self.speculator.request_stop()
            if self.watcher is not None:
                self.watcher.request_stop()
            # flush the fair queue FIRST (its waiters would otherwise
            # block their connection threads through dispatcher stop)
            self._admission.stop()
            if self._coalescer is not None:
                self._coalescer.stop()
            self.speculator.join()
            if self.watcher is not None:
                self.watcher.join()
            if self.spill is not None:
                # the SHUTDOWN FLUSH (idle timeout, SIGTERM and the
                # shutdown op all route through here): with the
                # dispatchers drained, every idle resident spills so
                # the next daemon restores instead of re-registering.
                # SIGKILL never reaches this line — that path recovers
                # from the continuous per-request spill instead.
                flushed = self.sessions.flush_spill()
                if flushed:
                    self._log(
                        f"serve: flushed {flushed} resident session"
                        f"{'s' if flushed != 1 else ''} to the warm tier"
                    )
                self.spill.close()
            # every shutdown path restores the process-global seams:
            # a daemon run in a thread of a longer-lived process (the
            # tests, chip_smoke.py) must leave no fault plan, tracer
            # observer, shared registry or row cache behind
            faults.disarm()
            obs.tracer.set_observer(None)
            obs.set_shared_registry(False)
            # ops.tensorize is numpy-only at import — no device attach
            # jaxlint: disable=R8 — clearing a module-global hook
            set_row_cache(None)
            for sig, handler in old_handlers:
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass
            for path in (self.socket_path, pid_path):
                if path:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        with self._lock:
            n, n_coal = self._requests, self._coalesced
        if self._lanes:
            sched = self._coalescer
            s = sched.stats() if hasattr(sched, "stats") else {}
            per_lane = ", ".join(
                f"lane{ln.index}: {ln.requests} req / {ln.busy_s:.1f}s busy"
                for ln in self._lanes
            )
            self._log(
                f"serve: exiting after {n} request"
                f"{'s' if n != 1 else ''} ({n_coal} coalesced, "
                f"{int(s.get('steals', 0))} steals, "
                f"{int(s.get('cache_hits', 0))} tensorize cache hits; "
                f"{per_lane})"
            )
            return 0
        cache_stats = self.tensorize_cache.stats()
        self._log(
            f"serve: exiting after {n} request"
            f"{'s' if n != 1 else ''} ({n_coal} coalesced, "
            f"{cache_stats['hits']} tensorize cache hits)"
        )
        return 0
