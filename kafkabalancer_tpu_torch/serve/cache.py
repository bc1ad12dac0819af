"""Digest-keyed incremental tensorize cache for the planning daemon.

The outer automation loop re-reads cluster state and re-invokes the
planner once per move, so consecutive requests differ by ONE partition's
replica list (plus whatever drifted in between). A fresh tensorize pass
re-encodes every row from Python objects — O(P) list comprehensions and
per-row dict work that costs a visible slice of the warm-request budget
at 10k-partition scale. This cache keeps the previous dense encoding and
its per-row content keys; when the next request matches the same broker
universe and bucket shapes, only rows whose key changed are re-encoded
and everything else is a vectorized array copy.

Correctness model: a row's key covers every field the dense encoding
reads (topic, partition id, replicas, weight, num_replicas,
num_consumers, the allowed-brokers content), and the reuse precondition
pins the broker universe and the (P, R, B) buckets byte-for-byte — any
mismatch, a new topic, an unexpected broker, or too much churn falls
back to the full encode (which re-primes the cache). The cache returns
fresh copies and keeps its masters private, so callers may do anything
with the arrays.

Installed by the daemon via ``ops.tensorize.set_row_cache``; the
stateless CLI path never constructs one. Thread-safe (the daemon's
dispatcher serializes plans, but probe threads may race it).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.models import Partition
from kafkabalancer_tpu_torch.ops.tensorize import (
    dense_replica_row,
    encode_allowed_row,
)

RowKey = Tuple[Any, ...]

# past this churn fraction the patch loop stops beating the vectorized
# full encode; fall back (and re-prime) instead
_MAX_CHANGED_FRACTION = 0.25
_MIN_CHANGED_ALLOWANCE = 64

_ARRAY_FIELDS = (
    "weights",
    "replicas",
    "nrep_cur",
    "nrep_tgt",
    "ncons",
    "allowed",
    "member",
    "pvalid",
    "bvalid",
    "topic_id",
)


def row_key_of(
    p: Partition, brokers_fp: Dict[int, Tuple[int, ...]]
) -> RowKey:
    """One partition's content key (see :func:`row_keys`); the
    ``brokers_fp`` identity memo is shared across calls so the shared
    post-FillDefaults brokers list tuple-ifies once."""
    if p.brokers is None:
        bfp: Optional[Tuple[int, ...]] = None
    else:
        ident = id(p.brokers)
        bfp = brokers_fp.get(ident)
        if bfp is None:
            bfp = brokers_fp[ident] = tuple(p.brokers)
    return (
        p.topic,
        p.partition,
        tuple(p.replicas),
        p.weight,
        p.num_replicas,
        p.num_consumers,
        bfp,
    )


def row_keys(parts: List[Partition]) -> List[RowKey]:
    """Per-partition content keys over every field tensorize encodes.

    The allowed-brokers term memoizes by list identity: after
    FillDefaults most partitions share ONE brokers-list object, so the
    tuple-ification cost is paid once per distinct list, not per row.
    """
    brokers_fp: Dict[int, Tuple[int, ...]] = {}
    return [row_key_of(p, brokers_fp) for p in parts]


class TensorizeRowCache:
    """Previous dense encoding + per-row keys; see module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._meta: Optional[Tuple[bytes, int, int, int]] = None
        self._ids: Optional[np.ndarray] = None
        self._keys: List[RowKey] = []
        self._arrays: Dict[str, np.ndarray] = {}
        self._topics: List[str] = []
        self._topic_idx: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.rows_reused = 0
        # trusted-delta mode (resident sessions, serve/sessions.py):
        # when enabled, the owner promises to mark_changed() every row
        # mutated since the last prime/patch, and lookup() skips the
        # O(P) key scan entirely — at 10k partitions the scan costs
        # MORE than the full encode, so the resident steady state must
        # not pay it. None = disabled (every pre-existing caller).
        self._pending: Optional[set] = None

    def enable_trusted_deltas(self) -> None:
        """Turn on the trusted changed-row feed. Only the resident
        session machinery calls this — it owns the ONLY mutation sites
        (cli._apply_replicas / scan._decode_packed taps) and serializes
        requests per session, so the promise holds by construction."""
        with self._lock:
            if self._pending is None:
                self._pending = set()

    def mark_changed(self, idx: int) -> None:
        """Note that row ``idx`` of the cached encoding's partition
        list has been mutated since the last prime/patch."""
        with self._lock:
            if self._pending is not None:
                self._pending.add(idx)

    def approx_bytes(self) -> int:
        """Rough resident footprint of the cached encoding (the numpy
        masters dominate; keys estimated per row) — feeds the session
        memory accounting in the stats scrape."""
        with self._lock:
            total = sum(int(a.nbytes) for a in self._arrays.values())
            total += len(self._keys) * 120
            if self._ids is not None:
                total += int(self._ids.nbytes)
            return total

    def _encode_row(
        self, p: Partition, ids: np.ndarray, B: int
    ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """(topic_id, dense_replicas, allowed_row) for one changed
        partition, or None when it cannot be expressed in the cached
        vocabulary (new topic / out-of-universe broker). Encoding
        semantics live in ops/tensorize's shared per-row helpers — the
        patch path cannot drift from the full encode."""
        tid = self._topic_idx.get(p.topic)
        if tid is None:
            return None
        dense = dense_replica_row(p.replicas, ids)
        if dense is None:
            return None
        allowed_row = encode_allowed_row(p.brokers, ids, len(ids), B)
        return tid, dense, allowed_row

    def lookup(
        self,
        parts: List[Partition],
        ids: np.ndarray,
        P: int,
        R: int,
        B: int,
    ) -> Optional[Dict[str, Any]]:
        """Incrementally re-encode against the cached pass — the entry
        point ``ops.tensorize`` calls before its full encode.

        Returns ``{"arrays": {...}, "topics": [...]}`` (fresh copies)
        when the cached encoding covers this input, else None (caller
        runs the full encode and calls :meth:`prime`).
        """
        with self._lock:
            meta = (ids.tobytes(), P, R, B)
            if (
                self._meta != meta
                or len(parts) != len(self._keys)
                or self._ids is None
            ):
                self.misses += 1
                return None
            nrows = len(parts)
            if self._pending is not None:
                # trusted-delta mode: the owner marked every mutated
                # row, so the per-row key scan (which at 10k rows costs
                # more than the full encode) is skipped; only the
                # marked rows re-key and patch
                changed = sorted(self._pending)
                if changed and changed[-1] >= nrows:
                    self.misses += 1
                    return None
                brokers_fp: Dict[int, Tuple[int, ...]] = {}
                keys: Dict[int, RowKey] = {
                    i: row_key_of(parts[i], brokers_fp) for i in changed
                }
            else:
                full = row_keys(parts)
                changed = [
                    i for i, k in enumerate(full) if k != self._keys[i]
                ]
                keys = {i: full[i] for i in changed}
            if len(changed) > max(
                _MIN_CHANGED_ALLOWANCE,
                int(nrows * _MAX_CHANGED_FRACTION),
            ):
                self.misses += 1
                return None
            # validate EVERY changed row before mutating the masters —
            # a mid-patch bail would leave the cache half-updated
            patches = []
            for i in changed:
                enc = self._encode_row(parts[i], self._ids, B)
                if enc is None:
                    self.misses += 1
                    return None
                patches.append((i, parts[i], enc))
            a = self._arrays
            for i, p, (tid, dense, allowed_row) in patches:
                a["weights"][i] = p.weight
                a["nrep_cur"][i] = len(p.replicas)
                a["nrep_tgt"][i] = p.num_replicas
                a["ncons"][i] = p.num_consumers
                a["replicas"][i, :] = -1
                a["replicas"][i, : dense.size] = dense
                a["member"][i, :] = False
                a["member"][i, dense] = True
                a["allowed"][i, :] = allowed_row
                a["topic_id"][i] = tid
                self._keys[i] = keys[i]
            if self._pending is not None:
                self._pending = set()
            self.hits += 1
            self.rows_reused += nrows - len(changed)
            obs.metrics.count("tensorize.cache_hits")
            obs.metrics.count(
                "tensorize.rows_reused", nrows - len(changed)
            )
            return {
                "arrays": {f: a[f].copy() for f in _ARRAY_FIELDS},
                "topics": list(self._topics),
            }

    def prime(
        self,
        parts: List[Partition],
        ids: np.ndarray,
        P: int,
        R: int,
        B: int,
        arrays: Dict[str, np.ndarray],
        topics: List[str],
    ) -> None:
        """Prime the cache from a completed full encode (copies taken —
        the caller keeps exclusive ownership of its arrays)."""
        keys = row_keys(parts)
        with self._lock:
            self._meta = (ids.tobytes(), P, R, B)
            self._ids = np.array(ids, copy=True)
            self._keys = list(keys)
            self._arrays = {f: arrays[f].copy() for f in _ARRAY_FIELDS}
            self._topics = list(topics)
            self._topic_idx = {t: i for i, t in enumerate(topics)}
            if self._pending is not None:
                # a full encode re-primed everything; the trusted
                # changed-set starts fresh
                self._pending = set()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "rows_reused": self.rows_reused,
            }
