"""Ragged → dense encoding of a partition assignment.

The reference operates on ragged Go slices (``Partition.Replicas`` of
varying length, per-partition allowed-broker sets, sparse broker-ID space —
kafkabalancer.go:49-58). The device path wants fixed shapes, so this module losslessly
encodes a :class:`PartitionList` into padded dense arrays plus a broker-ID ↔
dense-index mapping, and decodes solver results back to the ragged form.

Conventions:

- The broker *universe* is the sorted union of observed replica brokers
  (utils.go:49-64 "auto" discovery) and any configured/extra broker IDs —
  configured brokers with no observed load are valid move targets
  (steps.go:151-155), so they must exist in the dense space.
- ``replicas[p, r]`` holds dense broker indices; slot 0 is the leader
  (Kafka convention, utils.go:96-101). Padding is ``-1``.
- All arrays are padded to power-of-two buckets (see
  :func:`kafkabalancer_tpu_torch.ops.runtime.next_bucket`) with validity
  masks, so the device sees one shape per bucket, not per input size.
- Padded partitions have zero weight, no replicas, and all-false allowed
  masks; padded brokers are never allowed targets and hold zero load.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.models import Partition, PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import HOST_FLOAT_DTYPE
from kafkabalancer_tpu_torch.ops.runtime import next_bucket


@dataclass
class DensePlan:
    """Dense encoding of a partition assignment (see module docstring).

    Shapes: P = partition bucket, R = replica-slot bucket, B = broker bucket.
    The arrays are numpy, field for field the reference package's
    ``DensePlan``; :func:`to_device` turns them into torch tensors.
    """

    broker_ids: np.ndarray  # [nb] int64 — universe, sorted ascending
    weights: np.ndarray  # [P] f64
    replicas: np.ndarray  # [P, R] int32 dense broker idx, -1 pad
    nrep_cur: np.ndarray  # [P] int32 — len(partition.replicas)
    nrep_tgt: np.ndarray  # [P] int32 — partition.num_replicas
    ncons: np.ndarray  # [P] f64 — partition.num_consumers
    allowed: np.ndarray  # [P, B] bool — per-partition allowed brokers
    # [P, B] bool — broker currently holds a replica; None under the lean
    # encode (tensorize(build_member=False)), whose sharded session
    # rebuilds each shard's membership from its replica rows
    member: Optional[np.ndarray]
    pvalid: np.ndarray  # [P] bool
    bvalid: np.ndarray  # [B] bool
    topic_id: np.ndarray  # [P] int32 — dense topic index (pad rows: 0)
    topics: List[str]  # topic names, index-aligned with topic_id values
    partitions: List[Partition]  # originals, index-aligned with rows

    @property
    def np_(self) -> int:
        """Number of real partitions."""
        return len(self.partitions)

    @property
    def nb(self) -> int:
        """Number of real brokers."""
        return len(self.broker_ids)

    def broker_index(self, broker_id: int) -> int:
        idx = int(np.searchsorted(self.broker_ids, broker_id))
        if idx >= len(self.broker_ids) or self.broker_ids[idx] != broker_id:
            raise KeyError(f"broker {broker_id} not in dense universe")
        return idx

    def decode_replicas(
        self, replicas: np.ndarray, nrep_cur: np.ndarray
    ) -> List[List[int]]:
        """Dense replica matrix → per-partition broker-ID lists (real rows)."""
        out: List[List[int]] = []
        for p in range(self.np_):
            n = int(nrep_cur[p])
            out.append([int(self.broker_ids[int(replicas[p, s])]) for s in range(n)])
        return out


def all_allowed_of(dp: "DensePlan") -> bool:
    """True when the [P, B] allowed matrix is just the broker-validity
    row broadcast (the default FillDefaults outcome) — the detection the
    all-allowed session and kernel modes key on (the kernel then reads
    no [P, B] allowed matrix at all)."""
    return bool(dp.allowed[:, : dp.nb].all(axis=1)[: dp.np_].all())


def broker_universe(
    pl: PartitionList,
    cfg: Optional[RebalanceConfig] = None,
    extra_brokers: Iterable[int] = (),
) -> np.ndarray:
    """Sorted broker universe: observed ∪ cfg.brokers ∪ extra.

    Deliberately does NOT include per-partition ``p.brokers`` entries: the
    reference's ``move()`` builds its load table from observed brokers plus
    ``cfg.Brokers`` zero-fill only (steps.go:150-155), so a broker allowed
    solely by a partition's own broker list but holding no replica never
    appears in ``bl`` and can never be a move target. Per-partition allowed
    brokers outside this universe are likewise dropped from the dense
    ``allowed`` mask.
    """
    seen = set(int(b) for b in extra_brokers)
    for p in pl.iter_partitions():
        seen.update(p.replicas)
    if cfg is not None and cfg.brokers:
        seen.update(cfg.brokers)
    return np.asarray(sorted(seen), dtype=np.int64)


def encode_allowed_row(
    brokers: Optional[Sequence[int]],
    ids: np.ndarray,
    nb: int,
    B: int,
) -> np.ndarray:
    """Dense allowed-brokers mask for ONE partition row.

    The single definition of the allowed-row semantics (None ⇒ every
    real broker; allowed-but-unobserved IDs drop out, see
    :func:`broker_universe`).
    """
    row = np.zeros(B, dtype=bool)
    if brokers is None:
        row[:nb] = True
    elif nb:
        want = np.asarray(list(brokers), dtype=np.int64)
        pos = np.searchsorted(ids, want)
        pos = pos[(pos < nb) & (ids[np.minimum(pos, nb - 1)] == want)]
        row[pos] = True
    return row


def dense_replica_row(
    replicas: Sequence[int], ids: np.ndarray
) -> Optional[np.ndarray]:
    """Broker IDs → dense universe indices for ONE partition's replica
    list, or None when any ID is outside the universe. The per-row spec
    of the id→index rule; the full encode's vectorized searchsorted pass
    implements the same mapping, and the incremental patch path of the
    daemon's row cache (serve/cache.py) uses the None case to detect
    vocabulary drift and fall back to the full encode."""
    nb = len(ids)
    want = np.asarray(replicas, dtype=np.int64)
    pos = np.searchsorted(ids, want)
    if want.size and (
        np.any(pos >= nb) or np.any(ids[np.minimum(pos, nb - 1)] != want)
    ):
        return None
    return pos.astype(np.int32)


# Optional incremental row cache (serve/cache.py TensorizeRowCache or any
# duck-typed equivalent), installed by the planning daemon so the outer
# loop's mostly-unchanged input re-encodes only its changed rows. Typed
# Any to keep the layering: ops/ does not import serve/.
_row_cache: Optional[Any] = None
# per-thread override: each lane of a multi-lane daemon (serve/lanes.py)
# and each resident session installs its own; everything else falls
# through to the process-wide cache
_tls = threading.local()


def set_row_cache(cache: Optional[Any]) -> None:
    """Install (or, with None, remove) the process-wide incremental
    tensorize cache. The CLI never installs one; the daemon does."""
    global _row_cache
    _row_cache = cache


def set_thread_row_cache(cache: Optional[Any]) -> None:
    """Install (or clear) THIS thread's row cache, overriding the
    process-wide one."""
    _tls.row_cache = cache


def row_cache() -> Optional[Any]:
    cache = getattr(_tls, "row_cache", None)
    return cache if cache is not None else _row_cache


# The staging seam: a serve lane installs its shared residency pool
# (serve/residency.py ResidencyPool, or any object with its lookup / put /
# pop_fence surface) on each thread that runs the lane's work;
# :func:`to_device` then looks every array up by content and publishes
# what it uploads, and the lane's stage thread fills the pool ahead of
# the next request (:func:`stage_host_arrays`). Per thread only: the
# stateless CLI never sees a pool.


def set_staging_cache(cache: Optional[Any]) -> None:
    """Install (or, with None, clear) THIS thread's residency pool."""
    _tls.stage_cache = cache


def staging_cache() -> Optional[Any]:
    return getattr(_tls, "stage_cache", None)


def _device_slot(device: Any) -> str:
    """``type:index`` of ``device`` (a bare ``cuda`` resolves to the
    current CUDA device), the last field of a pool key: a lane is one
    device, and a key never matches a tensor on another."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def stage_key(a: np.ndarray, device: Any) -> Tuple[Any, ...]:
    """The pool key of host array ``a`` on ``device``: (shape, dtype
    string, md5 digest of the bytes, device)."""
    arr = np.ascontiguousarray(a)
    digest = hashlib.md5(arr.reshape(-1).view(np.uint8)).digest()
    return (arr.shape, arr.dtype.str, digest, _device_slot(device))


# pinned host copies of staged arrays, each with the event that ends its
# copy: a host buffer stays referenced until its copy completed
_inflight: List[Tuple[Any, List[Any]]] = []
_inflight_lock = threading.Lock()


def _prune_inflight() -> None:
    with _inflight_lock:
        _inflight[:] = [(ev, h) for ev, h in _inflight if not ev.query()]


def stage_host_arrays(
    cache: Any,
    arrays: Iterable[Optional[np.ndarray]],
    device: Any,
    copy_stream: Any = None,
    record: Optional[Dict[str, Any]] = None,
) -> int:
    """The stage thread's half of the lane pipeline: upload each host
    array the pool does not hold yet to ``device`` and insert it
    UNPINNED (the stage thread serves no request; the request that reads
    the entry pins it at lookup). Returns the number staged.

    On a CUDA device the bytes travel from pinned host memory (the
    caching host allocator's ``pin_memory``) with ``non_blocking``
    copies on ``copy_stream``, a stream other than the lane's, so they
    overlap the session the lane is running. Only raw bytes move there,
    no kernel (float casts happen at use, on the lane's stream); one
    event recorded after the copies is each entry's fence. On another
    device the entry is an owned copy of the array. ``record``, when
    given, receives the bytes staged and, on CUDA, a timing event pair
    around the copies (``start``, ``end``)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and copy_stream is None:
        raise ValueError("stage_host_arrays: a CUDA device needs a copy stream")
    # the host side first (digests, pinned copies), so the copies go to
    # the copy stream back to back and its events time them alone
    todo: List[Tuple[Tuple[Any, ...], Any]] = []
    for a in arrays:
        if a is None:
            continue
        arr = np.ascontiguousarray(a)
        key = stage_key(arr, dev)
        if key in cache or any(k == key for k, _ in todo):
            continue
        src = torch.from_numpy(arr)
        todo.append((key, src.pin_memory() if cuda else src))
    nbytes = sum(int(h.numel()) * h.element_size() for _k, h in todo)
    staged: List[Tuple[Tuple[Any, ...], Any]] = []
    start = end = None
    if cuda and todo:
        with torch.cuda.stream(copy_stream):
            # allocated on the copy stream: a block it frees unused goes
            # back to that stream's pool, ordered after its copy
            staged = [
                (key, torch.empty(h.shape, dtype=h.dtype, device=dev))
                for key, h in todo
            ]
            start = torch.cuda.Event(enable_timing=True)
            start.record(copy_stream)
            for (_key, t), (_k, host) in zip(staged, todo):
                t.copy_(host, non_blocking=True)
    else:
        staged = [(key, src.clone()) for key, src in todo]
    fence = None
    if cuda and staged:
        end = torch.cuda.Event(enable_timing=True)
        end.record(copy_stream)
        fence = end
        _prune_inflight()
        with _inflight_lock:
            _inflight.append((end, [h for _k, h in todo]))
    for key, t in staged:
        cache.put(key, t, retain=False, fence=fence)
    if record is not None:
        record.update(arrays=len(staged), bytes=nbytes, start=start, end=end)
    if staged:
        obs.metrics.count("serve.staged_arrays", len(staged))
        obs.metrics.count("serve.staged_bytes", nbytes)
    return len(staged)


# serializes a staged entry's first use: the fence is popped and waited
# on under this lock, so a second reader on the lane's stream is queued
# after the wait, never before it
_fence_lock = threading.Lock()


def _pooled(pool: Any, a: np.ndarray, device: Any) -> Any:
    """``a`` as a tensor on ``device`` through ``pool``: the resident
    tensor on a hit (its first use on this thread's stream waits on its
    copy and marks the tensor used there, so the caching allocator
    cannot hand its block out while this stream may still read it), else
    an owned upload published to the pool."""
    import torch

    key = stage_key(a, device)
    t = pool.lookup(key)
    if t is None:
        src = torch.from_numpy(np.ascontiguousarray(a))
        t = src.to(device)
        if t.data_ptr() == src.data_ptr():
            t = t.clone()  # the pool must not alias a host array
        pool.put(key, t)
        return t
    if t.is_cuda:
        with _fence_lock:
            fence = pool.pop_fence(key)
            if fence is not None:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(fence)
                t.record_stream(stream)
        if fence is not None:
            _prune_inflight()
    return t


def tensorize(
    pl: PartitionList,
    cfg: Optional[RebalanceConfig] = None,
    extra_brokers: Sequence[int] = (),
    min_bucket: int = 8,
    min_replica_bucket: int = 2,
    p_bucket: Optional[int] = None,
    build_member: bool = True,
) -> DensePlan:
    """Encode ``pl`` (post-``fill_defaults``: weights, brokers, num_replicas
    populated) into a :class:`DensePlan`.

    ``extra_brokers`` extends the universe with IDs that appear in no
    replica list and no config (what-if sweeps that add brokers).
    ``min_bucket`` floors the partition bucket (the sharded session takes
    a multiple of its shard count); ``min_replica_bucket`` floors the
    replica-slot bucket, so per-scenario encodings of a sweep stack.
    ``p_bucket`` replaces the power-of-two partition bucket with an
    explicit row count (the scale tier's fine ladder,
    ``ops.runtime.scale_bucket``); it must cover the real partitions.
    ``build_member=False`` skips the ``[P, B]`` membership table
    (``member=None``): the sharded session rebuilds each shard's slice
    from its replica rows.
    """
    parts = list(pl.iter_partitions())
    ids = broker_universe(pl, cfg, extra_brokers)
    nb = len(ids)
    np_real = len(parts)

    rmax = max((len(p.replicas) for p in parts), default=0)
    # replica slots can grow by at most the add-missing repair; solvers never
    # extend past num_replicas, so bucket on the max of both
    rmax = max(rmax, max((p.num_replicas for p in parts), default=0))

    P = next_bucket(np_real, min_bucket)
    if p_bucket is not None:
        if p_bucket < np_real:
            raise ValueError(f"p_bucket {p_bucket} < {np_real} real partitions")
        P = p_bucket
    R = next_bucket(rmax, max(2, min_replica_bucket))
    B = next_bucket(nb, 8)

    cache = row_cache()
    if cache is not None and build_member:
        cached = cache.lookup(parts, ids, P, R, B)
        if cached is not None:
            a = cached["arrays"]
            return DensePlan(
                broker_ids=ids,
                weights=a["weights"],
                replicas=a["replicas"],
                nrep_cur=a["nrep_cur"],
                nrep_tgt=a["nrep_tgt"],
                ncons=a["ncons"],
                allowed=a["allowed"],
                member=a["member"],
                pvalid=a["pvalid"],
                bvalid=a["bvalid"],
                topic_id=a["topic_id"],
                topics=cached["topics"],
                partitions=parts,
            )

    weights = np.zeros(P, dtype=HOST_FLOAT_DTYPE)
    replicas = np.full((P, R), -1, dtype=np.int32)
    nrep_cur = np.zeros(P, dtype=np.int32)
    nrep_tgt = np.zeros(P, dtype=np.int32)
    ncons = np.zeros(P, dtype=HOST_FLOAT_DTYPE)
    allowed = np.zeros((P, B), dtype=bool)
    member = np.zeros((P, B), dtype=bool) if build_member else None
    pvalid = np.zeros(P, dtype=bool)
    bvalid = np.zeros(B, dtype=bool)
    bvalid[:nb] = True

    topics: List[str] = []
    topic_idx = {}
    topic_id = np.zeros(P, dtype=np.int32)

    if np_real:
        pvalid[:np_real] = True

        # ONE Python pass over the partition objects collects every
        # scalar column, the flat replica-ID stream, the interned topic
        # ids, and the allowed-row identity groups; everything after is
        # numpy.
        flat_l: List[int] = []
        scalars = np.empty((np_real, 4), dtype=HOST_FLOAT_DTYPE)
        groups: dict = {}
        tid_arr = topic_id  # local alias: one global load per row saved
        for i, p in enumerate(parts):
            reps = p.replicas
            scalars[i, 0] = p.weight
            scalars[i, 1] = len(reps)
            scalars[i, 2] = p.num_replicas
            scalars[i, 3] = p.num_consumers
            flat_l.extend(reps)
            topic = p.topic
            tid = topic_idx.get(topic)
            if tid is None:
                tid = topic_idx[topic] = len(topics)
                topics.append(topic)
            tid_arr[i] = tid
            brokers = p.brokers
            groups.setdefault(
                None if brokers is None else id(brokers), (brokers, [])
            )[1].append(i)

        weights[:np_real] = scalars[:, 0]
        # int-valued float64 columns convert exactly (counts < 2**53)
        lens = scalars[:, 1].astype(np.int32)
        nrep_cur[:np_real] = lens
        nrep_tgt[:np_real] = scalars[:, 2].astype(np.int32)
        ncons[:np_real] = scalars[:, 3]

        # replica broker IDs → dense indices in one vectorized pass (the
        # universe is sorted, so searchsorted IS the id→index map)
        flat = np.asarray(flat_l, dtype=np.int64)
        if flat.size:
            rows = np.repeat(np.arange(np_real, dtype=np.int64), lens)
            ends = np.cumsum(lens, dtype=np.int64)
            slots = np.arange(flat.size, dtype=np.int64) - (ends - lens)[rows]
            replicas[rows, slots] = np.searchsorted(ids, flat)

        # after FillDefaults most partitions share one brokers list object
        # (steps.go:47-56 assigns the same slice) — fill each distinct
        # allowed row ONCE and broadcast it per group
        for brokers, rows_i in groups.values():
            row = encode_allowed_row(brokers, ids, nb, B)
            allowed[np.asarray(rows_i, dtype=np.int64)] = row

    if member is not None:
        rows, cols = np.nonzero(replicas >= 0)
        member[rows, replicas[rows, cols]] = True

    if cache is not None and member is not None:
        cache.prime(
            parts, ids, P, R, B,
            {
                "weights": weights,
                "replicas": replicas,
                "nrep_cur": nrep_cur,
                "nrep_tgt": nrep_tgt,
                "ncons": ncons,
                "allowed": allowed,
                "member": member,
                "pvalid": pvalid,
                "bvalid": bvalid,
                "topic_id": topic_id,
            },
            topics,
        )

    return DensePlan(
        broker_ids=ids,
        weights=weights,
        replicas=replicas,
        nrep_cur=nrep_cur,
        nrep_tgt=nrep_tgt,
        ncons=ncons,
        allowed=allowed,
        member=member,
        pvalid=pvalid,
        bvalid=bvalid,
        topic_id=topic_id,
        topics=topics,
        partitions=parts,
    )


@dataclass
class DeviceArrays:
    """A :class:`DensePlan`'s arrays as torch tensors on one device.

    Integer and mask columns keep their types (int32 / bool); the float
    columns (weights, consumer counts) take the session dtype. ``allowed``
    is None in the all-allowed mode (:func:`all_allowed_of`), where the
    session and the kernel read the broker-validity row instead.
    """

    replicas: Any  # [P, R] int32
    weights: Any  # [P] dtype
    nrep_cur: Any  # [P] int32
    nrep_tgt: Any  # [P] int32
    ncons: Any  # [P] dtype
    allowed: Any  # [P, B] bool, or None (all-allowed)
    member: Any  # [P, B] bool, or None (lean encode)
    pvalid: Any  # [P] bool
    bvalid: Any  # [B] bool


def to_device(
    dp: DensePlan, device: Any, dtype: Any, all_allowed: bool = False
) -> DeviceArrays:
    """Upload ``dp`` to ``device`` with float columns cast to ``dtype``.

    This is where the reference package's numpy encoding crosses into
    the port: one encoding feeds both, so a test can hand the same
    ``DensePlan`` arrays to the JAX functions and to their torch
    counterparts. The casts round exactly like the reference's on-device
    ``astype`` (float64 → float32, round to nearest).

    With a residency pool installed on this thread (a serve lane's,
    :func:`set_staging_cache`) each array is looked up by content and
    an upload is published to the pool; the casts then run at use, on
    this thread's stream. The result's tensors may be SHARED with other
    requests (a cast to the array's own dtype returns the pooled tensor
    itself): callers never write them in place.
    """
    import torch

    pool = staging_cache()

    def up(a: np.ndarray, dt: Any = None) -> Any:
        if pool is None:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        else:
            t = _pooled(pool, a, device)
        return t if dt is None else t.to(dt)

    return DeviceArrays(
        replicas=up(dp.replicas),
        weights=up(dp.weights, dtype),
        nrep_cur=up(dp.nrep_cur),
        nrep_tgt=up(dp.nrep_tgt),
        ncons=up(dp.ncons, dtype),
        allowed=None if all_allowed else up(dp.allowed),
        member=None if dp.member is None else up(dp.member),
        pvalid=up(dp.pvalid),
        bvalid=up(dp.bvalid),
    )
