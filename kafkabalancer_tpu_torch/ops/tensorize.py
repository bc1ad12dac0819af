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

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np

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
    """
    import torch

    def up(a: np.ndarray, dt: Any = None) -> Any:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
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
