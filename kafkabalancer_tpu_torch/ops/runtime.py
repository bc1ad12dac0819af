"""Shape-bucket ladders shared by the encoding, the sessions and the
planning daemon.

Buckets keep the set of shapes a long-running process sees small: the
scoring kernel and the session's tensors are sized per bucket, not per
input, and the daemon coalesces requests of one bucket.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def next_bucket(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to a power-of-two bucket (≥ ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# where the fine partition-bucket ladder takes over from the doubling
# ladder: above it one doubling step wastes up to the whole instance
# again (131072 -> 262144 pads 131071 rows)
SCALE_LADDER_THRESHOLD = 65536


def scale_bucket(n: int, step: int = 8) -> int:
    """Partition bucket on the SCALE-tier fine ladder.

    Below :data:`SCALE_LADDER_THRESHOLD` this is exactly
    :func:`next_bucket` on a ``step`` minimum. Above it the ladder
    switches to multiples of ``step``, so padding is bounded by
    ``step - 1`` rows.
    """
    n = max(1, n)
    b = next_bucket(n, step)
    if b <= SCALE_LADDER_THRESHOLD:
        return b
    return -(-n // step) * step


def prefetch_hints(pl: Any, brokers: Optional[List[int]]) -> Dict[str, Any]:
    """An O(P) scan of a freshly parsed partition list predicting the
    dense encoding's buckets (``ops.tensorize`` conventions) without
    encoding it: ``P``, ``R``, ``B``, whether every partition will be
    allowed every broker (``all_allowed``), and the counts behind them.
    The planning daemon keys its request coalescing on
    ``(P, R, B, all_allowed)``. Run it before ``fill_defaults`` or a
    repair mutates the list."""
    parts = list(pl.iter_partitions())
    n = len(parts)
    rmax = 0
    movable = 0
    observed = set()
    explicit = False
    topics = set()
    for p in parts:
        lr = len(p.replicas)
        nr = p.num_replicas or lr
        rmax = max(rmax, lr, nr)
        movable += max(0, lr - 1)
        observed.update(p.replicas)
        if p.brokers is not None:
            explicit = True
        topics.add(p.topic)
    universe = observed | set(int(b) for b in (brokers or ()))
    # all-allowed iff fill_defaults hands every partition the full
    # universe: no explicit per-partition broker lists, and an explicit
    # broker set (if any) covering every observed broker
    all_allowed = not explicit and (
        not brokers or observed <= set(int(b) for b in brokers)
    )
    return {
        "n_parts": n,
        "nb": len(universe),
        "P": next_bucket(n, 8),
        "R": next_bucket(rmax, 2),
        "B": next_bucket(len(universe), 8),
        "n_topics": len(topics),
        "movable": movable,
        "all_allowed": all_allowed,
    }
