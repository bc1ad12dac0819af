"""Shared device residency: one pool of device-resident tensors per lane.

K concurrent requests over the same broker universe share most of their
dense encoding byte for byte (weights, allowed masks, broker validity),
and a lane's next request over a cluster it already planned shares
nearly all of it. The pool keys device tensors by content digest
(``ops.tensorize.stage_key``: shape, dtype, md5 digest and device), so
each content is uploaded once per lane and shared by every request that
reads it: ``ops.tensorize.to_device`` looks each array up in the
calling thread's installed pool and publishes what it uploads on a
miss, and the lane's stage thread (``ops.tensorize.stage_host_arrays``)
inserts the NEXT request's arrays ahead of its dispatch.

Eviction is refcounted: every lookup/insert on a request thread pins the
entry for that thread (one serving thread is one in-flight request), and
``release_thread``, called when the lane context unwinds, drops the
pins. Only UNREFERENCED entries are evicted, LRU past the cap, so a
tensor is never dropped from under an in-flight request's next chunk.
A tensor a running session already holds stays alive through that
reference regardless; the refcount keeps the SHARED copies hot while
any request of the lane still plans over them.

A pooled tensor is shared, so nothing may write it in place: every
session copies its mutable state (replicas, membership, loads) before
its first write.

A tensor staged on a CUDA lane's copy stream carries a FENCE: the event
recorded after its copy. The first use on the lane's stream waits on it
(``ops.tensorize``); :meth:`ResidencyPool.pop_fence` hands it out once.

Layering: torch-free at import (entries are opaque objects put here by
the callers); safe to construct in tests with no device at all.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Set, Tuple

from kafkabalancer_tpu_torch import obs

# entries with no holder beyond this many are evicted oldest-first; the
# working set of a lane is a handful of arrays per shape bucket, so the
# default is generous without letting a bucket-churning daemon pin
# unbounded device memory through the pool (64 entries of the
# 131072 x 256 bucket's [P, B] masks are about 2 GiB)
DEFAULT_POOL_CAP = 64

# one request thread pins at most this many entries at a time; past it
# the OLDEST pins release (the entries stay pooled, merely evictable).
# A session's shared arrays (weights, allowed, validity) stay pinned
# because every chunk's lookup refreshes them, while per-chunk
# transients (post-commit replicas and membership) age out of the pinned
# set instead of accumulating unevictable device memory for the whole
# request
THREAD_PIN_CAP = 16

# (shape, dtype.str, content digest, device) — ops.tensorize.stage_key
PoolKey = Tuple[Any, ...]


class ResidencyPool:
    """Digest-keyed, refcounted pool of device-resident tensors.

    Lookups do NOT consume (the next request over the same content is
    the point), and inserts from the upload path mean request 2 skips
    the copy request 1 already paid. Counters feed the
    ``serve.residency_hits`` gauge and the stats doc's ``residency``
    block.
    """

    def __init__(self, cap: int = DEFAULT_POOL_CAP) -> None:
        self._lock = threading.RLock()
        # key -> device tensor; insertion order doubles as recency
        self._entries: "OrderedDict[PoolKey, Any]" = OrderedDict()
        # key -> thread idents currently pinning the entry
        self._refs: Dict[PoolKey, Set[int]] = {}
        # thread ident -> its pinned keys in pin order (the per-thread
        # pin LRU behind THREAD_PIN_CAP)
        self._pins: Dict[int, "OrderedDict[PoolKey, None]"] = {}
        # key -> the copy-complete event of a staged entry not yet used
        self._fences: Dict[PoolKey, Any] = {}
        self._cap = cap
        self.hits = 0
        self.misses = 0
        self.uploads = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: PoolKey) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._refs.clear()
            self._pins.clear()
            self._fences.clear()

    def items(self) -> list:
        """A snapshot of ``(key, tensor)`` pairs, oldest first."""
        with self._lock:
            return list(self._entries.items())

    # -- the shared-residency protocol ----------------------------------
    def _pin_locked(self, key: PoolKey) -> None:
        """Pin ``key`` for the calling thread, releasing the thread's
        OLDEST pins past ``THREAD_PIN_CAP``."""
        ident = threading.get_ident()
        pins = self._pins.setdefault(ident, OrderedDict())
        pins.pop(key, None)
        pins[key] = None  # most-recent pin position
        self._refs.setdefault(key, set()).add(ident)
        while len(pins) > THREAD_PIN_CAP:
            old, _ = pins.popitem(last=False)
            self._unref_locked(old, ident)

    def _unref_locked(self, key: PoolKey, ident: int) -> None:
        refs = self._refs.get(key)
        if refs is not None:
            refs.discard(ident)
            if not refs:
                del self._refs[key]

    def lookup(self, key: PoolKey, retain: bool = True) -> Any:
        """The resident tensor for ``key`` (refreshing recency and, with
        ``retain``, pinning it for the calling thread), or None."""
        with self._lock:
            buf = self._entries.pop(key, None)
            if buf is None:
                self.misses += 1
                obs.metrics.count("serve.residency_misses")
                return None
            self._entries[key] = buf  # most-recent position
            if retain:
                self._pin_locked(key)
            self.hits += 1
        obs.metrics.count("serve.residency_hits")
        return buf

    def put(
        self, key: PoolKey, buf: Any, retain: bool = True, fence: Any = None
    ) -> None:
        """Insert (or refresh) a device-resident tensor, pinning it for
        the calling thread when ``retain``; evicts unreferenced entries
        LRU past the cap. ``fence`` is the event that completes the
        tensor's copy (a staged entry), handed out by :meth:`pop_fence`."""
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = buf
            self._fences.pop(key, None)
            if fence is not None:
                self._fences[key] = fence
            if retain:
                self._pin_locked(key)
            self.uploads += 1
            self._evict_locked()
        obs.metrics.count("serve.residency_uploads")

    def pop_fence(self, key: PoolKey) -> Any:
        """The copy-complete event of ``key``'s staged tensor, once: the
        first user waits on it; later users are ordered after that wait
        on the same lane stream. None when there is none (left)."""
        with self._lock:
            return self._fences.pop(key, None)

    def release_thread(self) -> None:
        """Drop every pin held by the calling thread (the lane context's
        unwind) and evict past the cap."""
        ident = threading.get_ident()
        with self._lock:
            for key in self._pins.pop(ident, {}):
                self._unref_locked(key, ident)
            self._evict_locked()

    def _evict_locked(self) -> None:
        if self._cap <= 0:
            return
        for key in list(self._entries):
            if len(self._entries) <= self._cap:
                break
            if self._refs.get(key):
                continue  # pinned by an in-flight request
            del self._entries[key]
            self._fences.pop(key, None)
            self.evictions += 1

    def device_bytes(self) -> int:
        """Total device bytes held by pooled entries (a tensor counts
        ``numel() * element_size()``; an opaque test buffer counts 0) —
        the pool's half of the per-lane memory attribution."""
        with self._lock:
            total = 0
            for buf in self._entries.values():
                numel = getattr(buf, "numel", None)
                size = getattr(buf, "element_size", None)
                if callable(numel) and callable(size):
                    total += int(numel()) * int(size())
            return total

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "uploads": self.uploads,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "referenced": sum(1 for r in self._refs.values() if r),
            }

    def hit_rate(self) -> float:
        with self._lock:
            seen = self.hits + self.misses
            return self.hits / seen if seen else 0.0
