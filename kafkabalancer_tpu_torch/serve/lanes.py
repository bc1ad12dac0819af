"""Device lanes: the multi-device request scheduler and cross-request
batching.

- :class:`Lane` — one worker lane per visible GPU, pinned to it: the
  lane's request threads make its device the current CUDA device and
  its default stream the current stream (every request of a lane runs
  on that one stream: the whole-session kernel is a cooperative launch
  whose blocks spin on each other, and a second request's kernels on
  another stream must not share its SMs mid-session), and keep a
  private digest-keyed tensorize row cache (``ops.tensorize
  .set_thread_row_cache``) and a shared residency pool of device
  tensors (serve/residency.py, ``ops.tensorize.set_staging_cache``);
- the stage-ahead pipeline: while a lane runs request N, a stage thread
  host-encodes the lane's next queued request (parse → settle →
  tensorize, priming the row cache) and copies its dense arrays into the
  lane's pool, so N+1's upload finds them resident. On a CUDA lane the
  copies run on the lane's own COPY stream, from pinned host memory and
  without a kernel, so they overlap N's kernels on the lane stream; the
  first use on the lane stream waits on the copies' event. At most one
  request per lane is staged ahead; staging is an overlap, never a
  correctness step (a failure or a misprediction costs only misses);
- :class:`LaneScheduler` — routes queued requests across lanes with
  shape-bucket AFFINITY (a bucket sticks to the lane whose row cache it
  primed) plus WORK STEALING when a lane's queue is empty, a lane
  watchdog (quarantine, requeue, restart) and MESH-EXCLUSIVE runs for
  ``-fused-shard`` requests. Same ``submit``/``busy``/``stop``
  interface as the single-lane ``Coalescer`` (serve/daemon.py);
- :class:`ContinuousBatcher` — iteration-level continuous batching
  (Orca, OSDI '22), ``-serve-batch-mode=continuous``: the fused batch
  re-forms at every solver chunk round. A same-bucket request arriving
  while a batch is in flight is admitted at the next round boundary
  into a slot a converged member freed;
- :class:`MicrobatchGroup` — the one-shot fusion barrier (fixed
  membership, run to collective completion), ``-serve-batch-mode=
  oneshot``, and the continuous batcher's base.

Cross-request batching: a lane's concurrent same-bucket requests that
the daemon predicts will reach a batched session (its admission
predicate, the reference's verdict) each run on a member thread of one
batcher. At every chunk round ``solvers.scan._run_chunk`` offers the
member's chunk to the batcher; a round fires when every live member has
offered or left, and the offers of one signature run as ONE
instance-batched session: the move session (``scan.session_batched``,
at any batch and on the colocation objective: one host loop, one launch
of the batched scoring kernel per iteration for all K members at batch
> 1, one read of the K accepted counts) or the polish alternation
(``polish.converge_session_batched``). Each member gets its own packed
move log, bit for bit its solo session's, and its own counters. The
instances are stacked at their exact count K: nothing is padded
(``padded_slots`` stays 0). A member that times out at the barrier, a
singleton signature and a declined offer (another engine, the leader
session, a custom scorer — what the reference declines) run solo;
a failure of the batched session itself fails every member's request,
as a solo kernel failure does. ``-serve-admission-hold=N`` holds a
lane's pop until N batchable requests are queued (or a window passes).

Daemon-internal work (speculative plan-ahead and ``-watch`` re-plans,
serve/speculate.py) goes through the same queues and runs on the same
lane request threads, under the lane's device and default stream: it
never launches from a thread of its own. It starts only when the daemon
is idle and is answered "deferred" when real traffic arrived while it
sat queued (serve/daemon.py ``_handle_plan``).

Layering: this module imports torch and the solvers only lazily inside
methods — constructing a scheduler with ``device=None`` lanes (tests)
touches neither.
"""

from __future__ import annotations

import contextlib
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

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.serve import faults
from kafkabalancer_tpu_torch.serve.admission import overload_response
from kafkabalancer_tpu_torch.serve.protocol import PROTO_VERSION
from kafkabalancer_tpu_torch.serve.residency import ResidencyPool

BucketKey = Tuple[int, int, int, bool]
# handler contract (daemon._handle_plan): sets req.response, never sets
# req.done (the scheduler owns the completion latch); the last argument
# is the batcher the request's thread joins, or None
LaneHandler = Callable[[Any, bool, "Lane", Optional["MicrobatchGroup"]], None]
BucketFn = Callable[[Any], Optional[BucketKey]]
# argv-only request predicate (the daemon's mesh-exclusive test, and its
# admission prediction: will the request reach the batched move session?
# Only such requests join a batcher — a member that never offers a chunk
# would stall its peers until its whole request completed)
RequestPred = Callable[[Any], bool]
# the daemon's host-encode stage of one queued request onto its lane
StageFn = Callable[[Any, "Lane"], None]


def probe_bucket(req: Any, bucket_of: BucketFn) -> Optional[BucketKey]:
    """The memoized shape-bucket probe shared by the Coalescer and the
    LaneScheduler (one definition: the memo-ordering subtleties must not
    drift between the two dispatchers). None is a valid 'no bucket'."""
    if not req.bucketed:
        req.bucketed = True
        try:
            req.bucket = bucket_of(req)
        except Exception:
            req.bucket = None
    bucket: Optional[BucketKey] = req.bucket
    return bucket


# a member waiting on the fusion barrier gives up and runs solo past
# this — the barrier fills as fast as the slowest member's host-side head
# (parse + settle + tensorize), seconds at 10k-partition scale
MICROBATCH_WAIT_S = 120.0

# -serve-admission-hold: how long a lane holds its pop waiting for the
# requested batch depth to queue before dispatching what it has — the
# bound that keeps a deterministic-batching daemon from wedging when
# fewer clients than the hold depth ever arrive
ADMISSION_HOLD_WINDOW_S = 5.0

# continuous admission tick: how often the drain loop re-polls the lane
# queue for newly queued same-bucket requests while members are in
# flight (retirements notify the batcher's condition immediately; the
# tick only bounds the queue-poll latency)
ADMISSION_TICK_S = 0.02


class Lane:
    """One device lane: identity, pinned device, row cache, residency
    pool and counters. The worker thread lives in :class:`LaneScheduler`."""

    __slots__ = (
        "index", "device", "row_cache", "stage_cache", "busy_s", "requests",
        "quarantined", "quarantined_at", "last_beat", "stage_log",
        "_copy_stream", "_stream_lock",
    )

    def __init__(self, index: int, device: Any = None) -> None:
        self.index = index
        self.device = device
        # lane health (the daemon's watchdog — LaneScheduler.health_tick):
        # last_beat is touched at every pop and retire; a lane with
        # active work and a stale beat is presumed wedged and
        # quarantined (excluded from routing) until it beats again
        self.quarantined = False
        self.quarantined_at = 0.0
        self.last_beat = time.monotonic()
        self.row_cache: Any = None  # TensorizeRowCache, daemon-installed
        # the lane's SHARED residency pool: digest-keyed device tensors
        # uploaded once per lane, shared by every request over the same
        # content, refcount-evicted (serve/residency.py)
        self.stage_cache = ResidencyPool()
        # the latest stage records (arrays, bytes and, on CUDA, the copy
        # stream's timing events), newest last
        self.stage_log: Deque[Dict[str, Any]] = deque(maxlen=32)
        self.busy_s = 0.0
        self.requests = 0
        self._copy_stream: Any = None
        self._stream_lock = threading.Lock()

    def is_cuda(self) -> bool:
        return getattr(self.device, "type", None) == "cuda"

    def copy_stream(self) -> Any:
        """The lane's copy stream (CUDA lanes; None otherwise), made on
        first use: a stream of PyTorch's pool, non-blocking towards the
        lane's default stream, that carries only the stage thread's
        host-to-device copies."""
        if not self.is_cuda():
            return None
        with self._stream_lock:
            if self._copy_stream is None:
                import torch

                self._copy_stream = torch.cuda.Stream(device=self.device)
            return self._copy_stream

    @contextlib.contextmanager
    def context(self) -> Iterator[None]:
        """Pin the calling thread to this lane: on a CUDA lane its device
        becomes the current device and its default stream the current
        stream (the current device and stream are per thread, so every
        thread that runs a lane's work enters this), tensorize uses the
        lane's row cache, and uploads go through the lane's pool."""
        from kafkabalancer_tpu_torch.ops.tensorize import (
            set_staging_cache,
            set_thread_row_cache,
        )

        set_thread_row_cache(self.row_cache)
        set_staging_cache(self.stage_cache)
        try:
            with contextlib.ExitStack() as st:
                if self.is_cuda():
                    import torch

                    st.enter_context(torch.cuda.device(self.device))
                    st.enter_context(
                        torch.cuda.stream(torch.cuda.default_stream(self.device))
                    )
                yield
        finally:
            set_thread_row_cache(None)
            set_staging_cache(None)
            # one serving thread is one in-flight request: drop its pins
            # so a retired request's tensors become evictable
            self.stage_cache.release_thread()

    def cache_stats(self) -> Dict[str, int]:
        if self.row_cache is None:
            return {"hits": 0, "misses": 0, "rows_reused": 0}
        stats: Dict[str, int] = self.row_cache.stats()
        return stats

    def residency_stats(self) -> Dict[str, int]:
        return self.stage_cache.stats()


class _MbEntry:
    """One member's pending chunk offer at the batching barrier."""

    __slots__ = ("args", "statics", "result", "done", "solo", "error")

    def __init__(self, args: Tuple, statics: Dict[str, Any]) -> None:
        self.args = args
        self.statics = statics
        self.result: Any = None
        self.done = False
        self.solo = False
        self.error: Optional[BaseException] = None


def _mb_sig(args: Tuple, statics: Dict[str, Any]) -> Tuple[Any, ...]:
    """Fusion signature: each tensor's shape, dtype and device (None-ness
    included; a plain number counts by its type only), plus the statics —
    two offers fuse only when they would run the same batched session."""
    leaves = tuple(
        None if a is None
        else (tuple(a.shape), str(a.dtype), str(a.device))
        if hasattr(a, "shape") else type(a).__name__
        for a in args
    )
    return (leaves, tuple(sorted((k, repr(v)) for k, v in statics.items())))


def _fusible(statics: Dict[str, Any]) -> bool:
    """Does an offer with these statics run in a batched session? What
    the reference fuses: the torch engine's move sessions (any batch,
    the colocation objective) and its polish alternation; another
    engine, the leader session and a custom scorer decline to solo."""
    return (
        statics.get("engine") == "xla"
        and statics.get("mode") in ("move", "polish")
        and not statics.get("scorer")
    )


class MicrobatchGroup:
    """The ONE-SHOT fusion barrier for K concurrently running same-bucket
    requests — fixed membership decided at formation, run to collective
    completion (``-serve-batch-mode=oneshot``) — and the continuous
    batcher's base.

    Each member's request thread installs the group via :meth:`member`;
    ``solvers.scan._run_chunk`` then offers every chunk here. A round
    completes when every LIVE member has either offered a chunk or
    finished its request; offers sharing a signature run as ONE
    ``scan.session_batched`` or ``polish.converge_session_batched``
    call, each member receiving its own packed move log (bit-identical
    to its solo session's). Declines (another engine, the leader
    session, a custom scorer), singleton
    signatures and a timed-out wait return None and the caller runs its
    ordinary solo session. An exception of the batched session is raised
    in every member's offer: their requests fail as a solo kernel
    failure fails one.
    """

    def __init__(self, size: int, wait_s: float = MICROBATCH_WAIT_S) -> None:
        self._cv = threading.Condition()
        self._live = size
        self._pending: List[_MbEntry] = []
        self._wait_s = wait_s
        self.fused_requests = 0
        self.fused_dispatches = 0
        # occupancy histogram (live members per fused dispatch) and the
        # padded-slot count, which stays 0: instances are stacked at
        # their exact count
        self.occupancy: Dict[int, int] = {}
        self.padded_slots = 0
        # stats sink (the owning scheduler): called (occupancy, padded)
        # right after each fused dispatch commits, BEFORE the members'
        # responses return — a stats() read taken the instant a client
        # sees its response must already include its fusion
        self.sink: Optional[Callable[[int, int], None]] = None

    @contextlib.contextmanager
    def member(self, req: Any = None) -> Iterator[None]:
        """Install this group on the calling request thread; on exit the
        member leaves the barrier (so stragglers stop waiting for it).
        ``req`` (when given) is marked entered, so the scheduler can
        tell a member that died BEFORE joining from one that joined and
        left — see :meth:`abandon`."""
        from kafkabalancer_tpu_torch.solvers import scan

        if req is not None:
            req.mb_entered = True
        scan.set_microbatcher(self)
        try:
            yield
        finally:
            scan.set_microbatcher(None)
            self._leave()

    def abandon(self) -> None:
        """A member failed before ever entering :meth:`member` (thread
        start failure, context-entry crash): release its barrier slot so
        the live peers' round can still complete instead of stalling to
        the timeout."""
        self._leave()

    def _leave(self) -> None:
        with self._cv:
            self._live -= 1
            batch = self._take_round_locked()
        if batch:
            self._execute(batch)

    def _take_round_locked(self) -> Optional[List[_MbEntry]]:
        if self._pending and len(self._pending) >= self._live:
            batch = self._pending
            self._pending = []
            return batch
        return None

    def dispatch(self, args: Tuple, statics: Dict[str, Any]) -> Optional[Any]:
        """Offer one chunk for fusion; this member's ``(packed move log,
        counters)``, or None to run solo (declined / timed
        out / singleton round). Raises when the batched session failed."""
        if not _fusible(statics):
            return None
        e = _MbEntry(args, statics)
        with self._cv:
            self._pending.append(e)
            batch = self._take_round_locked()
        if batch:
            self._execute(batch)
        deadline = time.monotonic() + self._wait_s
        with self._cv:
            while not e.done and not e.solo:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(left):
                    if e in self._pending:
                        self._pending.remove(e)
                    e.solo = True
        if e.error is not None:
            raise RuntimeError(
                f"fused session failed: {type(e.error).__name__}: {e.error}"
            ) from e.error
        return None if e.solo else e.result

    def _execute(self, batch: List[_MbEntry]) -> None:
        """Run one round: the offers grouped by signature, each group of
        two or more as one batched session (on the calling thread — a
        member's, under its lane's context), singletons solo. Never
        raises: a failure is handed to the members it concerns."""
        by_sig: Dict[Tuple[Any, ...], List[_MbEntry]] = {}
        for e in batch:
            try:
                by_sig.setdefault(_mb_sig(e.args, e.statics), []).append(e)
            except Exception:
                with self._cv:
                    e.solo = True
        for entries in by_sig.values():
            if len(entries) == 1:
                with self._cv:
                    entries[0].solo = True
            else:
                self._run_fused(entries)
        with self._cv:
            self._cv.notify_all()

    def _run_fused(self, entries: List[_MbEntry]) -> None:
        n = len(entries)
        try:
            import torch

            from kafkabalancer_tpu_torch.solvers import scan

            st = entries[0].statics
            n_t = scan.OFFER_TENSORS
            tensors = [
                None if entries[0].args[i] is None
                else torch.stack([e.args[i] for e in entries])
                for i in range(n_t)
            ]
            min_rep, min_unb, budget, lam = (
                [e.args[i] for e in entries] for i in range(n_t, n_t + 4)
            )
            loads, rep, mem, alw, *rest = tensors[:11]
            kw = dict(
                max_moves=st["max_moves"], allow_leader=st["allow_leader"],
                batch=st["batch"], topic_id=tensors[15],
                lam=lam if st["n_topics"] else None, n_topics=st["n_topics"],
            )
            with obs.span("serve.microbatch_dispatch", k=n, padded_k=n,
                          mode=st["mode"]):
                if st["mode"] == "polish":
                    from kafkabalancer_tpu_torch.solvers.polish import (
                        converge_session_batched,
                    )

                    packed, counts = converge_session_batched(
                        loads, rep, alw, *rest, min_rep, min_unb, budget,
                        *tensors[11:15], **kw,
                    )
                else:
                    packed, iters, secs = scan.session_batched(
                        *tensors[:11], min_rep, min_unb, budget, **kw,
                    )
                    counts = [
                        {"solver.session_seconds": secs[k],
                         "solver.session_iterations": iters[k]}
                        for k in range(n)
                    ]
                host = packed.cpu().numpy()
        except Exception as exc:
            # no solo retry: the members' requests fail with the error
            with self._cv:
                for e in entries:
                    if not e.done and not e.solo:
                        e.error = exc
                        e.done = True
            return
        with self._cv:
            for k, e in enumerate(entries):
                if not e.solo:  # a timed-out member already went solo
                    e.result = (host[k], counts[k])
                    e.done = True
            self.fused_requests += n
            self.fused_dispatches += 1
            self.occupancy[n] = self.occupancy.get(n, 0) + 1
        obs.metrics.count("serve.microbatched", n)
        if self.sink is not None:
            # members are still parked at the barrier (the round's
            # notify_all fires after this returns), so the sink's
            # accounting is visible before any response is
            try:
                self.sink(n, 0)
            except Exception:
                pass


class ContinuousBatcher(MicrobatchGroup):
    """Iteration-level continuous batching: the one-shot barrier with
    DYNAMIC membership.

    Rounds work exactly like the base barrier — a round fires when every
    live member has offered or left — but membership is not fixed at
    formation: the lane's drain loop :meth:`admit`\\ s a newly queued
    same-bucket request the moment a slot frees (a converged member
    leaving shrinks ``live``; the admit grows it back), so the next round
    re-forms with the new member's chunk 1 fused into its peers' chunk
    ``i+1`` instead of the request waiting out the whole batch.
    Occupancy therefore varies round to round; each round runs at its
    exact occupancy.
    """

    def __init__(self, max_k: int, wait_s: float = MICROBATCH_WAIT_S) -> None:
        super().__init__(0, wait_s)
        self._max_k = max(1, max_k)
        self.admitted = 0
        # occupancy-adaptive fast path: offers declined at occupancy 1
        # without paying the round machinery
        self.solo_fast = 0

    def dispatch(self, args: Tuple, statics: Dict[str, Any]) -> Optional[Any]:
        with self._cv:
            if self._live == 1 and not self._pending:
                # sole live member and nothing offered to fuse with: a
                # round would only classify this entry solo after the
                # signature and two condition round-trips. Decline
                # immediately — the caller's solo session is
                # bit-identical, and the next admission re-enables
                # fusion at the very next chunk boundary.
                self.solo_fast += 1
                return None
        return super().dispatch(args, statics)

    def admit(self) -> None:
        """Grow the live membership by one — called by the lane's drain
        loop BEFORE the member's request thread starts, so no round can
        fire without the newcomer (it either offers into the next round
        or leaves)."""
        with self._cv:
            self._live += 1
            self.admitted += 1

    def wait_change(self, timeout: float) -> None:
        """Block until membership/round state changes (a member leaves
        or offers) or ``timeout`` elapses — the drain loop's tick."""
        with self._cv:
            self._cv.wait(timeout)

    def _leave(self) -> None:
        super()._leave()
        # wake the drain loop promptly: a departure frees a slot the
        # next queued request can be admitted into
        with self._cv:
            self._cv.notify_all()


class LaneScheduler:
    """Multi-lane dispatcher with bucket affinity, work stealing, a lane
    watchdog, mesh-exclusive runs and cross-request batching;
    Coalescer-compatible interface.

    ``microbatch`` (above 1) is the most members one batcher holds;
    ``admissible`` predicts which requests may join one. ``batch_mode``
    ``"continuous"`` (the default) runs them through a
    :class:`ContinuousBatcher` — mid-flight admission into freed slots;
    ``"oneshot"`` through fixed-membership :class:`MicrobatchGroup`\\ s.
    ``admission_hold`` (``-serve-admission-hold``) makes a lane hold its
    pop until that many admissible requests are queued — or the hold
    window expires — so tests and benchmarks can form a full batch
    without scheduler-timing luck."""

    def __init__(
        self,
        handle: LaneHandler,
        bucket_of: BucketFn,
        lanes: Sequence[Lane],
        microbatch: int = 1,
        stage: Optional[StageFn] = None,
        admissible: Optional[RequestPred] = None,
        batch_mode: str = "continuous",
        admission_hold: int = 0,
        watchdog_s: float = 0.0,
        exclusive: Optional[RequestPred] = None,
    ) -> None:
        self._handle = handle
        self._bucket_of = bucket_of
        self.lanes = list(lanes)
        self._microbatch = max(1, microbatch)
        self._stage = stage
        self._admissible = admissible
        self._batch_mode = batch_mode
        # MESH-EXCLUSIVE predicate (daemon: -fused-shard requests): a
        # matching request owns EVERY attached device (the sharded
        # session shard_maps over the whole mesh), so its lane first
        # DRAINS the fleet — waits until no other lane has in-flight
        # work — and holds every pop loop closed while it runs; nothing
        # lane-pinned can race the mesh collectives. Sequential by
        # construction: a second exclusive parks until the first
        # releases ownership.
        self._exclusive = exclusive
        self._cv = threading.Condition()
        self._queues: List[Deque[Any]] = [deque() for _ in self.lanes]
        self._active = [0] * len(self.lanes)
        # lane index currently owning the mesh, and per-lane count of
        # popped-but-parked exclusive requests (parked = waiting for the
        # drain, deliberately NOT counted as busy by the drain check so
        # two concurrent exclusives cannot deadlock waiting on each
        # other's active slot)
        self._mesh_owner: Optional[int] = None
        self._excl_parked = [0] * len(self.lanes)
        self.mesh_exclusive = 0
        # per-lane claimed-but-unfinished requests — what the health
        # monitor answers with a structured error when the lane dies
        self._current: List[List[Any]] = [[] for _ in self.lanes]
        self._affinity: Dict[BucketKey, int] = {}
        self._stop = False
        # lane health: 0 disables the
        # watchdog; quarantine/requeue/recovery counters feed the
        # scrape's "lane_health" block
        self._watchdog_s = max(0.0, watchdog_s)
        self.quarantines = 0
        self.requeues = 0
        self.recoveries = 0
        # requests answered with a structured error because their lane
        # died/wedged under them (never requeued: an in-flight request
        # may have side effects — only queued-but-unstarted work moves)
        self.abandoned = 0
        self._hold_n = max(0, admission_hold)
        self._hold_window_s = ADMISSION_HOLD_WINDOW_S
        self._hold_since: List[Optional[float]] = [None] * len(self.lanes)
        self._admission_tick_s = ADMISSION_TICK_S
        self.steals = 0
        self.microbatched = 0
        self.padded_slots = 0
        # occupancy-adaptive fast-path engagements (solo inline runs that
        # skipped the continuous machinery)
        self.solo_fast = 0
        self._occupancy: Dict[int, int] = {}
        self._workers = [
            threading.Thread(
                target=self._worker, args=(i,), name=f"serve-lane-{i}",
                daemon=True,
            )
            for i in range(len(self.lanes))
        ]
        for t in self._workers:
            t.start()

    # -- Coalescer-compatible surface ------------------------------------
    def busy(self) -> bool:
        """Queued or in-flight work on ANY lane — the daemon's
        idle-timeout check must not shut down under a long-running plan
        on one lane while the others sit empty."""
        with self._cv:
            return any(self._queues) or any(self._active)

    def submit(self, req: Any) -> Dict[str, Any]:
        # the routing probe runs OUTSIDE the lock (it parses the input)
        # and only when there is more than one lane to route between —
        # the single-lane scheduler keeps the Coalescer's probe-only-
        # under-contention economy (group assembly probes on demand).
        # Memoized on the request so group assembly never re-pays it.
        b = self._bucket(req) if len(self.lanes) > 1 else None
        with self._cv:
            if self._stop:
                return {
                    "v": PROTO_VERSION, "ok": False,
                    "error": "daemon shutting down",
                }
            if all(ln.quarantined for ln in self.lanes):
                # nothing can serve this request right now — a wedged
                # fleet must answer a structured retry-after shed, not
                # park the submitter on a queue nothing drains (the
                # client backs off, retries, and falls back; the
                # in-flight gauge would otherwise keep its progress
                # probe waiting the full budget). The request passed
                # admission and never begins handling: it is abandoned,
                # or admitted == requests + abandoned breaks (a crashed
                # worker's restart holds its lane quarantined for a
                # moment, and an arrival then lands here)
                if getattr(req, "internal", None) is None:
                    self.abandoned += 1
                return overload_response(
                    "quarantine", 1000,
                    detail="every lane is quarantined",
                )
            i = self._route_locked(b)
            self._queues[i].append(req)
            busy = self._active[i] > 0
            self._cv.notify_all()
        if busy:
            # the lane is running a request: stage this one ahead now,
            # while that request's kernels run, not only when the lane
            # next starts a group
            self._stage_ahead(self.lanes[i])
        req.done.wait()
        return req.response or {
            "v": PROTO_VERSION, "ok": False, "error": "request dropped",
        }

    def stop(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout)

    def stats(self) -> Dict[str, float]:
        with self._cv:
            residency = [ln.residency_stats() for ln in self.lanes]
            return {
                "lanes": float(len(self.lanes)),
                "steals": float(self.steals),
                "mesh_exclusive": float(self.mesh_exclusive),
                "microbatched": float(self.microbatched),
                "padded_slots": float(self.padded_slots),
                "solo_fast": float(self.solo_fast),
                "occupancy_max": float(max(self._occupancy, default=0)),
                "residency_hits": float(sum(r["hits"] for r in residency)),
                "residency_misses": float(
                    sum(r["misses"] for r in residency)
                ),
                "lane_busy_s": float(sum(ln.busy_s for ln in self.lanes)),
                "cache_hits": float(
                    sum(ln.cache_stats()["hits"] for ln in self.lanes)
                ),
            }

    def occupancy_hist(self) -> Dict[str, int]:
        """Fused dispatches by live occupancy (string keys: the dict
        rides JSON hello responses)."""
        with self._cv:
            return {str(k): v for k, v in sorted(self._occupancy.items())}

    def _note_fused(self, occupancy: int, padded: int) -> None:
        """The batchers' stats sink: one fused dispatch of ``occupancy``
        live members and ``padded`` dead slots landed. Called before the
        members' responses release, so a stats() read racing a client's
        completion already counts its fusion."""
        with self._cv:
            self.microbatched += occupancy
            self.padded_slots += padded
            self._occupancy[occupancy] = (
                self._occupancy.get(occupancy, 0) + 1
            )
        # dispatch-time distributions: one observation per fused
        # dispatch, recorded as the dispatch lands
        obs.metrics.hist_observe(
            "serve.dispatch_occupancy", float(occupancy)
        )
        obs.metrics.hist_observe("serve.dispatch_padded", float(padded))

    # -- lane health -------------------------------------------------------
    def health_stats(self) -> Dict[str, Any]:
        """The scrape's ``lane_health`` block (serve-stats/5)."""
        with self._cv:
            return {
                "watchdog_s": self._watchdog_s,
                "quarantined": [
                    ln.index for ln in self.lanes if ln.quarantined
                ],
                "quarantines": self.quarantines,
                "requeues": self.requeues,
                "recoveries": self.recoveries,
                "abandoned": self.abandoned,
            }

    def health_tick(
        self, log: Optional[Callable[[str], None]] = None
    ) -> None:
        """The lane watchdog (called from the daemon's accept-loop
        tick). Three verdicts per lane:

        - **crashed** — the worker thread is dead: quarantine, answer
          its claimed in-flight requests with a structured error (never
          a wrong plan), requeue its queued-but-unstarted work onto
          healthy lanes, then RESTART a fresh worker and re-admit the
          lane (the recovery re-probe for a dead worker is a restart);
        - **wedged** — the worker is alive but its lane has active work
          and no heartbeat for ``watchdog_s``: quarantine (routing and
          stealing exclude it), answer the stuck in-flight requests,
          requeue its queue — the wedged call may still be executing,
          so the thread is left alone;
        - **recovered** — a wedged-quarantined lane beat again (the
          stuck call finally finished) and has drained: re-admit it.
        """
        if self._watchdog_s <= 0 or self._stop:
            return
        now = time.monotonic()
        for i, lane in enumerate(self.lanes):
            worker = self._workers[i]
            if not worker.is_alive():
                self._quarantine(i, "crashed", log, restarting=True)
                # restart: the dead worker's active count can never be
                # decremented by it, so reset the lane's slate first —
                # including any mesh hold it died holding (a stuck
                # owner/parked flag would freeze every other lane's pop
                # loop forever)
                with self._cv:
                    self._active[i] = 0
                    self._current[i] = []
                    self._excl_parked[i] = 0
                    if self._mesh_owner == i:
                        self._mesh_owner = None
                nt = threading.Thread(
                    target=self._worker, args=(i,),
                    name=f"serve-lane-{i}", daemon=True,
                )
                try:
                    nt.start()
                except Exception:
                    continue  # no thread to spare; retried next tick
                with self._cv:
                    self._workers[i] = nt
                    lane.quarantined = False
                    lane.last_beat = time.monotonic()
                    self.recoveries += 1
                    self._cv.notify_all()
                if log is not None:
                    log(f"serve: lane {i} worker restarted (recovered)")
                obs.metrics.event("serve_lane_recovered", lane=i)
            elif lane.quarantined:
                # drain anything that slipped onto the quarantined
                # lane's queue in a race window — nothing else will
                self._drain_quarantined(i, log)
                with self._cv:
                    drained = (
                        self._active[i] == 0 and not self._current[i]
                    )
                    beat_since = lane.last_beat > lane.quarantined_at
                if drained or beat_since:
                    with self._cv:
                        lane.quarantined = False
                        lane.last_beat = time.monotonic()
                        self.recoveries += 1
                        self._cv.notify_all()
                    if log is not None:
                        log(f"serve: lane {i} recovered from quarantine")
                    obs.metrics.event("serve_lane_recovered", lane=i)
            else:
                with self._cv:
                    active = self._active[i] > 0 or bool(self._current[i])
                if active and now - lane.last_beat > self._watchdog_s:
                    self._quarantine(i, "wedged", log)

    def _drain_quarantined(
        self, i: int, log: Optional[Callable[[str], None]]
    ) -> None:
        """Move (or answer) work that landed on a STILL-quarantined
        lane's queue after its quarantine flush — the routing guard in
        :meth:`submit` makes this a race-window case, but a queued
        request must never sit where nothing drains it."""
        with self._cv:
            if not self._queues[i]:
                return
            queued = list(self._queues[i])
            self._queues[i].clear()
            healthy = [
                j for j, ln in enumerate(self.lanes)
                if j != i
                and not ln.quarantined
                and self._workers[j].is_alive()
            ]
            moved = 0
            orphaned: List[Any] = []
            for r in queued:
                if healthy:
                    j = min(
                        healthy,
                        key=lambda k: len(self._queues[k])
                        + self._active[k],
                    )
                    self._queues[j].append(r)
                    moved += 1
                else:
                    orphaned.append(r)
            self.requeues += moved
            # internal (speculative/watch) requests never passed
            # admission: excluded from `abandoned` so the identity
            # admitted == requests + abandoned stays exact
            self.abandoned += sum(
                1 for r in orphaned
                if getattr(r, "internal", None) is None
            )
            if moved:
                self._cv.notify_all()
        for r in orphaned:
            r.response = overload_response(
                "quarantine", 1000,
                detail=f"lane {i} quarantined and no healthy peer",
            )
            r.done.set()
        if (moved or orphaned) and log is not None:
            log(
                f"serve: drained {moved + len(orphaned)} request(s) "
                f"off quarantined lane {i} "
                f"({moved} requeued, {len(orphaned)} answered)"
            )

    def _quarantine(
        self,
        i: int,
        why: str,
        log: Optional[Callable[[str], None]],
        restarting: bool = False,
    ) -> None:
        """Quarantine lane ``i``: answer its claimed in-flight requests
        with a structured error, move its queued-but-unstarted work to
        healthy lanes — or, with no healthy lane, answer it too (an
        answered error beats an un-served queue) UNLESS ``restarting``
        (the crashed-worker path): a fresh worker is about to take over
        this very lane, so its queue stays in place and is served
        moments later instead of stampeding every client into the
        in-process fallback. Excluded from routing until health_tick
        re-admits it."""
        lane = self.lanes[i]
        with self._cv:
            if lane.quarantined:
                return
            lane.quarantined = True
            lane.quarantined_at = time.monotonic()
            self.quarantines += 1
            stuck = [
                r for r in self._current[i] if not r.done.is_set()
            ]
            healthy = [
                j for j, ln in enumerate(self.lanes)
                if j != i
                and not ln.quarantined
                and self._workers[j].is_alive()
            ]
            if healthy or not restarting:
                queued = list(self._queues[i])
                self._queues[i].clear()
            else:
                queued = []  # kept for the restarted worker
            requeued: List[Any] = []
            orphaned: List[Any] = []
            for r in queued:
                if healthy:
                    j = min(
                        healthy,
                        key=lambda k: len(self._queues[k])
                        + self._active[k],
                    )
                    self._queues[j].append(r)
                    requeued.append(r)
                else:
                    orphaned.append(r)
            self.requeues += len(requeued)
            # abandoned = admitted work that never BEGAN handling and
            # got an error instead; a request wedged mid-handling still
            # reaches the requests counter, so counting it here too
            # would double-book the conservation identity — and
            # internal (speculative/watch) requests never passed
            # admission at all, so they are excluded outright
            self.abandoned += len([
                r for r in stuck
                if not getattr(r, "started", False)
                and getattr(r, "internal", None) is None
            ]) + sum(
                1 for r in orphaned
                if getattr(r, "internal", None) is None
            )
            # affinity for buckets owned by the sick lane re-resolves
            # on the next route (a healthy lane takes ownership)
            self._affinity = {
                b: j for b, j in self._affinity.items() if j != i
            }
            self._cv.notify_all()
        # responses OUTSIDE the lock: a late-finishing wedged thread
        # setting req.response afterwards is harmless — done is already
        # set and the client has the structured error, never a plan
        for r in stuck:
            r.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": (
                    f"lane {i} {why}: in-flight request abandoned "
                    "(lane quarantined)"
                ),
            }
            r.done.set()
        for r in orphaned:
            r.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": (
                    f"lane {i} {why} and no healthy lane to requeue to"
                ),
            }
            r.done.set()
        obs.metrics.count("serve.quarantines")
        if requeued:
            obs.metrics.count("serve.requeues", len(requeued))
        obs.metrics.event(
            "serve_lane_quarantined", lane=i, why=why,
            stuck=len(stuck), requeued=len(requeued),
            orphaned=len(orphaned),
        )
        if log is not None:
            log(
                f"serve: lane {i} {why} — quarantined "
                f"({len(stuck)} in-flight answered, "
                f"{len(requeued)} requeued, {len(orphaned)} orphaned)"
            )

    # -- routing ----------------------------------------------------------
    def _bucket(self, req: Any) -> Optional[BucketKey]:
        return probe_bucket(req, self._bucket_of)

    def _route_locked(self, b: Optional[BucketKey]) -> int:
        healthy = [
            i for i, ln in enumerate(self.lanes) if not ln.quarantined
        ]
        if not healthy:
            # every lane quarantined: least-loaded of all is still the
            # best bet (recovery/restart re-drains the queue)
            healthy = list(range(len(self.lanes)))
        if b is not None:
            owner = self._affinity.get(b)
            if owner is not None and owner in healthy:
                return owner
        i = min(
            healthy,
            key=lambda j: len(self._queues[j]) + self._active[j],
        )
        if b is not None:
            self._affinity[b] = i
        return i

    def _steal_locked(self, i: int) -> Optional[Any]:
        """One request from the tail of the longest other queue. A
        victim's lone queued request with a shape bucket stays: its
        bucket is routed there by affinity, the lane whose row cache it
        primed. A quarantined lane never steals (its worker is dead or
        wedged); stealing FROM a quarantined lane is allowed and
        desirable — it drains work the victim can no longer serve."""
        if self.lanes[i].quarantined:
            return None
        best, best_len = -1, 0
        for j, q in enumerate(self._queues):
            if j != i and len(q) > best_len:
                best, best_len = j, len(q)
        if best < 0:
            return None
        q = self._queues[best]
        if len(q) == 1 and q[0].bucketed and q[0].bucket is not None:
            return None
        self.steals += 1
        obs.metrics.count("serve.steals")
        return q.pop()

    # -- the lane worker ---------------------------------------------------
    def _is_exclusive(self, req: Any) -> bool:
        """Does ``req`` take the whole mesh? argv-only predicate,
        lock-safe, fail-closed (an erroring predicate means a normal
        lane-pinned run)."""
        if self._exclusive is None:
            return False
        try:
            return bool(self._exclusive(req))
        except Exception:
            return False

    # thread-role: lane-worker
    def _worker(self, i: int) -> None:
        lane = self.lanes[i]
        while True:
            first: Any = None
            contended = False
            with self._cv:
                while True:
                    # mesh hold: while an exclusive request owns (or is
                    # draining toward) the mesh, no lane starts NEW
                    # work — in-flight requests finish, pops wait
                    if not self._stop and (
                        self._mesh_owner is not None
                        or any(self._excl_parked)
                    ):
                        self._cv.wait(0.1)
                        continue
                    if self._queues[i]:
                        if self._hold_locked(i):
                            self._cv.wait(self._admission_tick_s)
                            continue
                        first = self._queues[i].popleft()
                        contended = bool(self._queues[i])
                        break
                    stolen = self._steal_locked(i)
                    if stolen is not None:
                        first = stolen
                        break
                    if self._stop:
                        return
                    self._cv.wait()
                self._active[i] += 1
            excl = self._is_exclusive(first)
            if excl:
                contended = False  # never grouped: it runs the mesh alone
            group = [first]
            if contended:
                # same-bucket group assembly, probes OUTSIDE the lock
                # (the probe parses the request's input) — exactly the
                # Coalescer's contention-only economy. Snapshot, probe,
                # then re-check membership under the lock: a stealer may
                # have taken a snapshotted request in between.
                b0 = self._bucket(first)
                if b0 is not None:
                    with self._cv:
                        pending = list(self._queues[i])
                    same = [r for r in pending if self._bucket(r) == b0]
                    if same:
                        with self._cv:
                            taken = [
                                r for r in same if r in self._queues[i]
                            ]
                            for r in taken:
                                self._queues[i].remove(r)
                            self._active[i] += len(taken)
                        group.extend(taken)
            # ``claimed`` tracks every request this turn is responsible
            # for — continuous admission pulls MORE from the queue while
            # the batch runs, and each pull must ride the same answer-
            # everything / active-count guarantees as the initial group
            claimed = list(group)
            with self._cv:
                self._current[i] = claimed
                lane.last_beat = time.monotonic()
            # the chaos seam's worker-death injection (serve/faults.py):
            # LaneCrash is a BaseException — it skips the except/finally
            # nets below exactly like a real thread death, leaving the
            # claimed work for health_tick to answer and requeue
            faults.fire("lane_crash")
            t0 = time.monotonic()
            try:
                if excl:
                    self._run_exclusive(lane, first)
                else:
                    self._run_group(lane, group, claimed)
            except Exception as exc:
                # the worker must SURVIVE anything a group throws (thread
                # exhaustion in a fused run): answer every unanswered
                # member and keep serving — a dead worker would wedge its
                # queue's clients forever (submit blocks on req.done with
                # no timeout, and affinity keeps routing here)
                obs.metrics.event(
                    "serve_lane_group_failed",
                    lane=lane.index,
                    error=type(exc).__name__,
                )
                for req in claimed:
                    if not req.done.is_set():
                        req.response = {
                            "v": PROTO_VERSION, "ok": False,
                            "error": (
                                f"lane dispatch failed: "
                                f"{type(exc).__name__}: {exc}"
                            ),
                        }
                        req.done.set()
            finally:
                with self._cv:
                    self._active[i] -= len(claimed)
                    self._current[i] = []
                    lane.busy_s += time.monotonic() - t0
                    lane.requests += len(claimed)
                    lane.last_beat = time.monotonic()
                    self._cv.notify_all()

    def _run_exclusive(self, lane: Lane, req: Any) -> None:
        """Run one mesh-exclusive request: park until every OTHER lane
        has zero in-flight work (their pops are already held closed by
        the parked flag, so the fleet drains monotonically), claim mesh
        ownership, run the request solo on this lane's thread, release.
        Parked peers on other lanes do not count as busy — they are
        waiting on this same drain, and counting them would deadlock
        two concurrent exclusives; ownership arbitration under the lock
        serializes them instead. Shutdown mid-park NEVER runs the
        request without ownership — dispatching a mesh-wide session
        beside still-in-flight lane work is exactly the race this
        mechanism exists to prevent; the parked request is answered
        with a structured shutdown error instead."""
        i = lane.index
        owned = False
        with self._cv:
            self._excl_parked[i] += 1
            self._cv.notify_all()
            try:
                while not self._stop:
                    if self._mesh_owner is None and all(
                        self._active[j] - self._excl_parked[j] <= 0
                        for j in range(len(self.lanes))
                        if j != i
                    ):
                        self._mesh_owner = i
                        owned = True
                        break
                    self._cv.wait(0.05)
            finally:
                self._excl_parked[i] -= 1
            if owned:
                self.mesh_exclusive += 1
        if not owned:
            req.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": (
                    "daemon shutting down (mesh-exclusive request "
                    "not dispatched)"
                ),
            }
            req.done.set()
            return
        obs.metrics.count("serve.mesh_exclusive")
        try:
            self._run_one(lane, req, coalesced=False, mb=None)
        finally:
            with self._cv:
                self._mesh_owner = None
                self._cv.notify_all()

    def _hold_locked(self, i: int) -> bool:
        """The deterministic admission latch: True while lane ``i`` must
        keep its queue intact waiting for ``_hold_n`` admissible
        (batchable) requests — or the hold window — only when the queue
        HEAD is itself admissible, so a plain request (greedy solver,
        malformed input) never waits behind the latch, and only
        BATCHABLE requests count toward the target (a greedy request
        interleaving must not release a partial batch). Bucket equality
        is NOT checked (the probe parses input; this runs under the
        lock) — the deterministic-forming use case feeds same-shape
        clients by construction, and the window bounds any mix-up.
        Caller holds the lock; the argv-only admissibility predicate is
        lock-safe."""
        if self._hold_n <= 1 or self._stop or self._admissible is None:
            self._hold_since[i] = None
            return False
        q = self._queues[i]
        if not self._is_admissible(q[0]):
            self._hold_since[i] = None
            return False
        now = time.monotonic()
        since = self._hold_since[i]
        if since is None:
            self._hold_since[i] = since = now
        n_batchable = sum(1 for r in q if self._is_admissible(r))
        if n_batchable >= self._hold_n or now - since >= self._hold_window_s:
            self._hold_since[i] = None
            return False
        return True

    def _is_admissible(self, req: Any) -> bool:
        """The admission predicate, fail-closed: an erroring predicate
        (a malformed flag value) means a solo run."""
        if self._admissible is None:
            return False
        try:
            return bool(self._admissible(req))
        except Exception:
            return False

    def _stage_ahead(self, lane: Lane) -> None:
        """Start the host-encode stage of this lane's NEXT queued request
        on a stage thread. At most one stage per request (the ``staged``
        memo on the request); a failing stage is counted and swallowed:
        staging is an overlap, never a correctness step."""
        if self._stage is None:
            return
        with self._cv:
            q = self._queues[lane.index]
            nxt = q[0] if q else None
            if nxt is None or getattr(nxt, "staged", False):
                return
            nxt.staged = True
        stage = self._stage

        def body() -> None:  # thread-role: lane-worker
            try:
                stage(nxt, lane)
            except Exception as exc:
                obs.metrics.count("serve.stage_failures")
                obs.metrics.event(
                    "serve_stage_failed", lane=lane.index,
                    error=type(exc).__name__,
                )

        try:
            threading.Thread(
                target=body, name=f"serve-lane-{lane.index}-stage",
                daemon=True,
            ).start()
        except Exception:
            pass  # no thread to spare: the overlap is skipped, that's all

    def _run_group(
        self, lane: Lane, group: List[Any], claimed: List[Any]
    ) -> None:
        self._stage_ahead(lane)
        k = self._microbatch
        if k > 1 and len(group) > 1 and self._admissible is not None:
            # only ADMISSIBLE requests join a batcher: a member that never
            # offers a chunk (greedy solver, kernel engine, leader
            # session) would stall its peers until its entire request
            # completed. Everything else runs serially after, still
            # coalesced in the window.
            fusible = [r for r in group if self._is_admissible(r)]
            rest = [r for r in group if r not in fusible]
            first = True
            if fusible and self._batch_mode != "oneshot":
                solo_run = False
                if len(fusible) == 1:
                    # occupancy-adaptive batch mode: one fusible request
                    # and an empty lane queue at dispatch time means the
                    # continuous machinery (batcher, member thread, drain
                    # loop, admission ticks) can only ever produce
                    # occupancy-1 rounds — run it inline instead
                    with self._cv:
                        if not self._queues[lane.index]:
                            solo_run = True
                            self.solo_fast += 1
                if solo_run:
                    self._run_one(lane, fusible[0], coalesced=not first)
                else:
                    # non-batchable riders waiting in this window gate
                    # the feed: with `rest` pending, no new arrivals are
                    # pulled (the batch drains, the riders run, the
                    # worker re-pops) — mid-flight admission must never
                    # starve them
                    self._run_continuous(
                        lane, fusible, claimed, first=first,
                        feed=not rest,
                    )
                first = False
            else:
                # the one-shot mode: fixed-membership barriers of up to
                # k members, each run to completion
                for j in range(0, len(fusible), k):
                    run = fusible[j : j + k]
                    if len(run) == 1:
                        self._run_one(lane, run[0], coalesced=not first)
                    else:
                        self._run_fused(lane, run, first=first)
                    first = False
            for req in rest:
                self._run_one(lane, req, coalesced=not first)
                first = False
        else:
            for idx, req in enumerate(group):
                self._run_one(lane, req, coalesced=idx > 0)
                lane.last_beat = time.monotonic()

    def _pull_admissible(
        self, lane: Lane, bucket: Optional[BucketKey]
    ) -> List[Any]:
        """Claim the queue-HEAD PREFIX of same-bucket admissible requests
        from this lane's queue — the continuous batcher's mid-flight
        admission feed. Prefix only, never a leapfrog: the first
        non-batchable or different-bucket request stops the feed, so
        under sustained fused traffic an older queued greedy/other-bucket
        request is reached the moment the current batch drains instead
        of starving behind newer admissions. Probes run OUTSIDE the lock
        (they parse the request's input; memoized per request),
        membership re-checked under it (a stealer may have taken a
        snapshotted request — stealing only removes, so the prefix
        property survives)."""
        if bucket is None:
            return []
        i = lane.index
        with self._cv:
            if (
                self._stop
                or self._mesh_owner is not None
                or any(self._excl_parked)
                or not self._queues[i]
            ):
                # a draining/held mesh also stops the continuous feed:
                # mid-flight admission is new work too
                return []
            pending = list(self._queues[i])
        want = []
        for r in pending:
            if self._bucket(r) == bucket and self._is_admissible(r):
                want.append(r)
            else:
                break
        if not want:
            return []
        with self._cv:
            taken = [r for r in want if r in self._queues[i]]
            for r in taken:
                self._queues[i].remove(r)
            self._active[i] += len(taken)
        return taken

    def _run_continuous(
        self, lane: Lane, fusible: List[Any], claimed: List[Any],
        first: bool, feed: bool = True,
    ) -> None:
        """The continuous-batching drain loop: admit up to K members into
        one :class:`ContinuousBatcher`, reap members as their requests
        retire (their slots free immediately), and — with ``feed`` — keep
        admitting newly queued same-bucket requests into the freed slots
        until both the batch and the feed drain (prefix pulls only;
        ``feed=False`` when non-batchable riders wait in this window).
        The batcher's rounds re-form at every solver chunk boundary, so
        an admission mid-way through its peers' sessions fuses its chunk
        1 with their chunk i+1. Each member runs on a thread of its own
        (its request thread enters the lane's context); the batched
        session runs on the thread of the member that completes a
        round."""
        cb = ContinuousBatcher(self._microbatch)
        cb.sink = self._note_fused
        waiting: Deque[Any] = deque(fusible)
        bucket = (
            fusible[0].bucket if feed and fusible[0].bucketed else None
        )
        running: Dict[Any, threading.Thread] = {}
        n_started = 0
        while True:
            # per-round live samples: this lane's queue depth and the
            # batcher's live occupancy. Each round is also a watchdog
            # heartbeat: a healthy continuous batch must never read as a
            # wedged lane
            lane.last_beat = time.monotonic()
            with self._cv:
                depth = len(self._queues[lane.index])
            obs.metrics.hist_observe(
                f"serve.lane{lane.index}.queue_depth", float(depth)
            )
            obs.metrics.hist_observe(
                "serve.cb_occupancy", float(len(running))
            )
            obs.metrics.hist_observe(
                f"serve.lane{lane.index}.occupancy", float(len(running))
            )
            # admit the whole wave before any of its threads starts: a
            # member started before its peers' admission could find
            # itself alone at the barrier and round without them (the
            # reference admits and starts one member at a time)
            wave: List[Any] = []
            while waiting and len(running) + len(wave) < self._microbatch:
                wave.append(waiting.popleft())
                cb.admit()
            inline: List[Tuple[Any, bool]] = []
            for req in wave:
                coalesced = n_started > 0 or not first
                t = threading.Thread(
                    target=self._run_one,
                    args=(lane, req, coalesced, cb),
                    name=f"serve-lane-{lane.index}-cb{n_started}",
                )
                n_started += 1
                try:
                    t.start()
                except Exception:
                    # can't start the member thread (thread exhaustion):
                    # release its batcher slot so the live members'
                    # rounds still complete, and run it inline, solo,
                    # once the rest of the wave has started
                    cb.abandon()
                    inline.append((req, coalesced))
                    continue
                running[req] = t
            for req, coalesced in inline:
                self._run_one(lane, req, coalesced, None)
            for req in [r for r in running if r.done.is_set()]:
                running.pop(req).join()
            if (
                len(running) + len(waiting) < self._microbatch
                and not self._stop
            ):
                pulled = self._pull_admissible(lane, bucket)
                if pulled:
                    claimed.extend(pulled)
                    waiting.extend(pulled)
                    continue
            if not running and not waiting:
                break
            if waiting and len(running) < self._microbatch:
                continue
            # members in flight and no free work to admit: wait for a
            # retirement (notified by the batcher) or the next poll tick
            cb.wait_change(self._admission_tick_s)

    # thread-role: lane-worker
    def _run_one(
        self,
        lane: Lane,
        req: Any,
        coalesced: bool,
        mb: Optional[MicrobatchGroup] = None,
    ) -> None:
        try:
            self._handle(req, coalesced, lane, mb)
        except Exception as exc:  # never wedge a waiter
            req.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": f"{type(exc).__name__}: {exc}",
            }
            if mb is not None and not getattr(req, "mb_entered", False):
                # the member died before joining the barrier: its slot
                # must not leave the live peers waiting for a join that
                # will never come
                mb.abandon()
        finally:
            req.done.set()

    def _run_fused(self, lane: Lane, run: List[Any], first: bool) -> None:
        """One one-shot batch: a :class:`MicrobatchGroup` of ``run``'s
        requests, each on a member thread of its own, joined."""
        mb = MicrobatchGroup(len(run))
        mb.sink = self._note_fused
        started: List[threading.Thread] = []
        inline: List[Tuple[Any, bool]] = []
        for idx, req in enumerate(run):
            coalesced = idx > 0 or not first
            t = threading.Thread(
                target=self._run_one,
                args=(lane, req, coalesced, mb),
                name=f"serve-lane-{lane.index}-mb{idx}",
            )
            try:
                t.start()
            except Exception:
                # can't start the member thread (thread exhaustion):
                # release its barrier slot so the started peers' rounds
                # still complete, and run it inline after them, solo
                mb.abandon()
                inline.append((req, coalesced))
                continue
            started.append(t)
        for t in started:
            t.join()
        for req, coalesced in inline:
            self._run_one(lane, req, coalesced, None)
