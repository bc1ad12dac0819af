"""Streaming log-bucketed histograms: daemon-lifetime latency/occupancy
distributions with a windowed recent view.

The serving daemon (serve/daemon.py) is a long-lived multi-lane process;
"what did requests cost" is a DISTRIBUTION question (Clipper, NSDI '17:
batching is only a safe throughput knob while tail latency is
continuously measured), not the single-invocation phase timings the
``-metrics-json`` trio answers. A :class:`StreamingHist` holds:

- **lifetime** state: count / sum / min / max plus log-bucketed counts
  (``SUBBUCKETS`` buckets per octave — ~19% relative resolution at the
  default 4 — in a sparse dict, so a hist over any value range stays a
  few hundred ints);
- a **windowed** view: a ring of ``ring`` sub-epoch bucket dicts, each
  covering ``window_s / ring`` seconds; reads merge the live slots, so
  "p95 over the last minute" survives hours of uptime without ever
  storing samples;
- **percentile extraction** (p50/p95/p99) from the bucket counts: the
  reported value is the matched bucket's upper bound, so percentiles
  are conservative within one bucket's relative error.

Everything is O(1) per observation behind one per-hist lock, allocates
no per-sample memory, and imports no jax — histograms ride the always-on
``obs.metrics`` registry (``hist_observe``) and are scraped live through
the daemon's ``stats`` op (docs/observability.md).

:class:`HistFamily` adds the LABEL dimension with a hard memory bound:
one streaming histogram per label for the top-``cap`` most-recently
active labels, every label past the cap LRU-demoted into a single
``other`` rollup histogram (lifetime + windowed state merged in, so
family-wide totals stay monotone across demotion). This is what makes
per-tenant attribution safe at fleet scale — a million-tenant daemon
holds ``cap`` live histograms plus one rollup, never a million
(docs/observability.md § Per-tenant attribution).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# buckets per octave (power of two): 4 gives bucket upper bounds at
# 2^(i/4) — ~19% relative width, 40 buckets per 1000x of dynamic range
SUBBUCKETS = 4

# the windowed view: a ring of RING sub-epochs spanning WINDOW_S seconds
WINDOW_S = 60.0
RING = 6

# the underflow bucket: values <= 0 (occupancy hists legitimately
# observe 0) land here; its upper bound reports as 0.0
UNDERFLOW = -(1 << 30)

# the label families' rollup label: demoted (and never-tracked) labels
# aggregate here. Reserved — observing it directly feeds the rollup.
OTHER_LABEL = "other"

# default live-label bound of a HistFamily/CounterFamily: top-K labels
# by recent activity stay individually tracked, the rest roll up
FAMILY_CAP = 32


def bucket_index(value: float) -> int:
    """The sparse bucket for ``value``: the smallest ``i`` with
    ``value <= 2**(i / SUBBUCKETS)``; ``UNDERFLOW`` for values <= 0."""
    if value <= 0.0 or value != value:  # 0, negatives, NaN
        return UNDERFLOW
    return math.ceil(math.log2(value) * SUBBUCKETS)


def bucket_le(index: int) -> float:
    """The inclusive upper bound of bucket ``index`` (0.0 for the
    underflow bucket)."""
    if index == UNDERFLOW:
        return 0.0
    return 2.0 ** (index / SUBBUCKETS)


def merge_buckets(parts: Iterable[Dict[int, int]]) -> Dict[int, int]:
    """Sum sparse bucket dicts — the aggregation primitive behind the
    windowed view and any cross-lane rollup."""
    out: Dict[int, int] = {}
    for part in parts:
        for idx, n in part.items():
            out[idx] = out.get(idx, 0) + n
    return out


def percentile_from_buckets(buckets: Dict[int, int], q: float) -> float:
    """The ``q``-quantile (0..1) from sparse bucket counts: the upper
    bound of the first bucket whose cumulative count reaches the rank.
    0.0 for an empty histogram."""
    total = sum(buckets.values())
    if total <= 0:
        return 0.0
    rank = max(1, math.ceil(q * total))
    seen = 0
    for idx in sorted(buckets):
        seen += buckets[idx]
        if seen >= rank:
            return bucket_le(idx)
    return bucket_le(max(buckets))


class StreamingHist:
    """One thread-safe streaming histogram; see the module docstring."""

    __slots__ = (
        "_lock", "_count", "_sum", "_min", "_max", "_buckets",
        "_ring", "_slot_s", "_ring_n", "_now",
    )

    def __init__(
        self,
        window_s: float = WINDOW_S,
        ring: int = RING,
        now: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._ring_n = max(1, int(ring))
        self._slot_s = max(1e-9, float(window_s)) / self._ring_n
        # each slot: [epoch, sparse bucket dict, count]
        self._ring: List[List[Any]] = [
            [-1, {}, 0] for _ in range(self._ring_n)
        ]
        self._now = now

    # -- writers ---------------------------------------------------------
    def observe(self, value: float) -> None:
        idx = bucket_index(value)
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            slot = self._slot_locked(int(self._now() / self._slot_s))
            slot[1][idx] = slot[1].get(idx, 0) + 1
            slot[2] += 1

    def _slot_locked(self, epoch: int) -> List[Any]:
        slot = self._ring[epoch % self._ring_n]
        if slot[0] != epoch:  # slot aged a full ring out: recycle it
            slot[0] = epoch
            slot[1] = {}
            slot[2] = 0
        return slot

    # -- readers ---------------------------------------------------------
    def _window_locked(self) -> Tuple[Dict[int, int], int]:
        """Merged buckets + count of the slots still inside the window."""
        epoch = int(self._now() / self._slot_s)
        live = [
            s for s in self._ring if 0 <= epoch - s[0] < self._ring_n
        ]
        return merge_buckets(s[1] for s in live), sum(s[2] for s in live)

    def percentile(self, q: float) -> float:
        with self._lock:
            buckets = dict(self._buckets)
        return percentile_from_buckets(buckets, q)

    def count(self) -> int:
        with self._lock:
            return self._count

    def merge_from(self, other: "StreamingHist") -> None:
        """Fold ``other``'s whole state — lifetime AND windowed — into
        this hist: the label-demotion primitive behind
        :class:`HistFamily`. Acquisition is id-ordered: HistFamily only
        ever merges INTO its one rollup hist, but nothing enforces that
        for other callers — two hists merged in opposite directions on
        two threads must never deadlock on the lock pair."""
        if other is self:
            return  # self-merge is a no-op (and _lock is not reentrant)
        first, second = (
            (self._lock, other._lock)
            if id(self._lock) <= id(other._lock)
            else (other._lock, self._lock)
        )
        with first, second:
            self._count += other._count
            self._sum += other._sum
            if other._count:
                if other._min < self._min:
                    self._min = other._min
                if other._max > self._max:
                    self._max = other._max
            for idx, n in other._buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n
            # windowed state aligns by sub-epoch — a source slot lands
            # only when the destination position holds the same or an
            # older epoch (recycling away NEWER data would un-count
            # observations the window already has)
            if (
                other._slot_s == self._slot_s
                and other._ring_n == self._ring_n
            ):
                for s in other._ring:
                    epoch = s[0]
                    if epoch < 0 or not s[2]:
                        continue
                    dst = self._ring[epoch % self._ring_n]
                    if dst[0] > epoch:
                        continue
                    if dst[0] != epoch:
                        dst[0] = epoch
                        dst[1] = {}
                        dst[2] = 0
                    for idx, n in s[1].items():
                        dst[1][idx] = dst[1].get(idx, 0) + n
                    dst[2] += s[2]

    def snapshot(self) -> Dict[str, Any]:
        """The export/scrape view: lifetime stats + percentiles, the
        windowed recent view, and the sparse buckets as [le, count]
        pairs (sorted, underflow first)."""
        with self._lock:
            buckets = dict(self._buckets)
            count, total = self._count, self._sum
            lo = self._min if self._count else 0.0
            hi = self._max if self._count else 0.0
            wbuckets, wcount = self._window_locked()
        return {
            "count": count,
            "sum": round(total, 6),
            "min": round(lo, 9),
            "max": round(hi, 9),
            "p50": round(percentile_from_buckets(buckets, 0.50), 9),
            "p95": round(percentile_from_buckets(buckets, 0.95), 9),
            "p99": round(percentile_from_buckets(buckets, 0.99), 9),
            "window": {
                "count": wcount,
                "span_s": round(self._slot_s * self._ring_n, 3),
                "p50": round(percentile_from_buckets(wbuckets, 0.50), 9),
                "p95": round(percentile_from_buckets(wbuckets, 0.95), 9),
                "p99": round(percentile_from_buckets(wbuckets, 0.99), 9),
            },
            "buckets": [
                [bucket_le(idx), buckets[idx]] for idx in sorted(buckets)
            ],
        }


class HistFamily:
    """A bounded label-dimensioned histogram family (module docstring).

    At most ``cap`` labels hold live histograms; admitting label
    ``cap+1`` demotes the least-recently-ACTIVE label (activity =
    observation, not read) into the ``other`` rollup via
    :meth:`StreamingHist.merge_from`, so the family-wide observation
    total is preserved exactly across any amount of label churn. A
    demoted label that comes back starts a fresh histogram — its
    history stays in ``other`` (totals monotone, per-label views
    best-effort past the cap, exactly the Prometheus top-K contract
    documented in docs/observability.md)."""

    def __init__(
        self,
        cap: int = FAMILY_CAP,
        window_s: float = WINDOW_S,
        ring: int = RING,
        now: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._cap = max(1, int(cap))
        self._labels: "OrderedDict[str, StreamingHist]" = OrderedDict()
        self._window_s = window_s
        self._ring = ring
        self._now = now
        self._other = StreamingHist(window_s, ring, now)
        self._demoted = 0

    def observe(self, label: str, value: float) -> None:
        """Record one observation for ``label``, creating/demoting as
        needed. The WHOLE operation — lookup, any demotion merge, and
        the observation itself — runs under the family lock: were the
        observation outside it, a concurrent demotion could merge the
        label's hist into the rollup between lookup and observe and
        the sample would land in an orphaned object, breaking the
        exact-total invariant. The per-observation cost is one dict
        lookup plus the hist's O(1) bucket write; demotion (the merge)
        is the rare path."""
        if label == OTHER_LABEL:
            self._other.observe(value)
            return
        with self._lock:
            h = self._labels.get(label)
            if h is not None:
                self._labels.move_to_end(label)
            else:
                if len(self._labels) >= self._cap:
                    # demote the LRU label into the rollup, also under
                    # the family lock: a concurrent total_count/snapshot
                    # must never see the victim's observations
                    # gone-but-not-yet-rolled-up (the monotone pin)
                    _victim, vh = self._labels.popitem(last=False)
                    self._demoted += 1
                    self._other.merge_from(vh)
                h = self._labels[label] = StreamingHist(
                    self._window_s, self._ring, self._now
                )
            h.observe(value)

    def get(self, label: str) -> Optional[StreamingHist]:
        """Read-only lookup: no recency bump, no creation."""
        if label == OTHER_LABEL:
            return self._other
        with self._lock:
            return self._labels.get(label)

    def labels(self) -> List[str]:
        """Live labels, most-recently-active last."""
        with self._lock:
            return list(self._labels)

    def total_count(self) -> int:
        """Family-wide observation count (live labels + rollup) — the
        monotone total the demotion tests pin. Read under the family
        lock so a mid-read demotion can neither drop nor double-count
        the victim."""
        with self._lock:
            return (
                sum(h.count() for h in self._labels.values())
                + self._other.count()
            )

    def snapshot(self) -> Dict[str, Any]:
        """The scrape view: per-live-label hist snapshots plus the
        rollup (null until anything demoted/observed into it). Built
        under the family lock so one snapshot is internally consistent
        — a racing demotion cannot show a label both live AND already
        rolled up."""
        with self._lock:
            other = self._other.snapshot()
            return {
                "cap": self._cap,
                "demoted": self._demoted,
                "other": other if other["count"] else None,
                "labels": {
                    label: h.snapshot()
                    for label, h in sorted(self._labels.items())
                },
            }
