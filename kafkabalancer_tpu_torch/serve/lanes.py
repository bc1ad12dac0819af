"""Device lanes: the multi-device request scheduler.

- :class:`Lane` — one worker lane per visible GPU, pinned to it: the
  lane's request threads make its device the current CUDA device and
  its default stream the current stream (every request of a lane runs
  on that one stream: the whole-session kernel is a cooperative launch
  whose blocks spin on each other, and a second request's kernels on
  another stream must not share its SMs mid-session), and keep a
  private digest-keyed tensorize row cache (``ops.tensorize
  .set_thread_row_cache``);
- :class:`LaneScheduler` — routes queued requests across lanes with
  shape-bucket AFFINITY (a bucket sticks to the lane whose row cache it
  primed) plus WORK STEALING when a lane's queue is empty, a lane
  watchdog (quarantine, requeue, restart) and MESH-EXCLUSIVE runs for
  ``-fused-shard`` requests. Same ``submit``/``busy``/``stop``
  interface as the single-lane ``Coalescer`` (serve/daemon.py), which
  the daemon keeps when it has one device.

Each lane runs its requests one at a time, each as a solo session.
The reference package fuses concurrent same-shape requests of a lane
into one batched device dispatch (continuous batching); its batched
dispatch runs the instances one after another, which on the card saves
no device work and holds every member's answer until the whole round
has run, so this package does not batch: ``-serve-microbatch``,
``-serve-batch-mode`` and ``-serve-admission-hold`` are accepted and
have no effect.

Daemon-internal work (speculative plan-ahead and ``-watch`` re-plans,
serve/speculate.py) goes through the same queues and runs on the same
lane request threads, under the lane's device and default stream: it
never launches from a thread of its own. It starts only when the daemon
is idle and is answered "deferred" when real traffic arrived while it
sat queued (serve/daemon.py ``_handle_plan``).

Layering: this module imports torch only lazily inside
:meth:`Lane.context` — constructing a scheduler with ``device=None``
lanes (tests) touches it not at all.
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

BucketKey = Tuple[int, int, int, bool]
# handler contract (daemon._handle_plan): sets req.response, never sets
# req.done (the scheduler owns the completion latch)
LaneHandler = Callable[[Any, bool, "Lane"], None]
BucketFn = Callable[[Any], Optional[BucketKey]]
# argv-only request predicate (the daemon's mesh-exclusive test)
RequestPred = Callable[[Any], bool]


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


class Lane:
    """One device lane: identity, pinned device, row cache and counters.
    The worker thread lives in :class:`LaneScheduler`."""

    __slots__ = (
        "index", "device", "row_cache", "busy_s", "requests",
        "quarantined", "quarantined_at", "last_beat",
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
        self.busy_s = 0.0
        self.requests = 0

    @contextlib.contextmanager
    def context(self) -> Iterator[None]:
        """Pin the calling thread to this lane: on a CUDA lane its device
        becomes the current device and its default stream the current
        stream (the current device and stream are per thread, so every
        thread that runs a lane's work enters this), and tensorize uses
        the lane's row cache."""
        from kafkabalancer_tpu_torch.ops.tensorize import set_thread_row_cache

        set_thread_row_cache(self.row_cache)
        try:
            with contextlib.ExitStack() as st:
                dev = self.device
                if dev is not None and getattr(dev, "type", None) == "cuda":
                    import torch

                    st.enter_context(torch.cuda.device(dev))
                    st.enter_context(
                        torch.cuda.stream(torch.cuda.default_stream(dev))
                    )
                yield
        finally:
            set_thread_row_cache(None)

    def cache_stats(self) -> Dict[str, int]:
        if self.row_cache is None:
            return {"hits": 0, "misses": 0, "rows_reused": 0}
        stats: Dict[str, int] = self.row_cache.stats()
        return stats


class LaneScheduler:
    """Multi-lane dispatcher with bucket affinity, work stealing, a lane
    watchdog and mesh-exclusive runs; Coalescer-compatible interface.
    Each lane serves its requests one at a time."""

    def __init__(
        self,
        handle: LaneHandler,
        bucket_of: BucketFn,
        lanes: Sequence[Lane],
        watchdog_s: float = 0.0,
        exclusive: Optional[RequestPred] = None,
    ) -> None:
        self._handle = handle
        self._bucket_of = bucket_of
        self.lanes = list(lanes)
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
        self.steals = 0
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
                # probe waiting the full budget)
                return overload_response(
                    "quarantine", 1000,
                    detail="every lane is quarantined",
                )
            i = self._route_locked(b)
            self._queues[i].append(req)
            self._cv.notify_all()
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
            return {
                "lanes": float(len(self.lanes)),
                "steals": float(self.steals),
                "mesh_exclusive": float(self.mesh_exclusive),
                "lane_busy_s": float(sum(ln.busy_s for ln in self.lanes)),
                "cache_hits": float(
                    sum(ln.cache_stats()["hits"] for ln in self.lanes)
                ),
            }

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
            with self._cv:
                self._current[i] = list(group)
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
                    for idx, req in enumerate(group):
                        self._run_one(lane, req, coalesced=idx > 0)
                        lane.last_beat = time.monotonic()
            except Exception as exc:
                # the worker must SURVIVE anything a group throws: answer
                # every unanswered member and keep serving — a dead
                # worker would wedge its queue's clients forever (submit
                # blocks on req.done with no timeout, and affinity keeps
                # routing here)
                obs.metrics.event(
                    "serve_lane_group_failed",
                    lane=lane.index,
                    error=type(exc).__name__,
                )
                for req in group:
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
                    self._active[i] -= len(group)
                    self._current[i] = []
                    lane.busy_s += time.monotonic() - t0
                    lane.requests += len(group)
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
            self._run_one(lane, req, coalesced=False)
        finally:
            with self._cv:
                self._mesh_owner = None
                self._cv.notify_all()

    # thread-role: lane-worker
    def _run_one(self, lane: Lane, req: Any, coalesced: bool) -> None:
        try:
            self._handle(req, coalesced, lane)
        except Exception as exc:  # never wedge a waiter
            req.response = {
                "v": PROTO_VERSION, "ok": False,
                "error": f"{type(exc).__name__}: {exc}",
            }
        finally:
            req.done.set()
