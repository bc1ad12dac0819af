"""Host-side (pure Python) cost model — the parity oracle.

Reference: utils.go. Float accumulation order is preserved exactly
(sorted broker order, utils.go:108-109) so results are bit-identical with
the Go implementation; the torch cost model in ``kafkabalancer_tpu_torch.ops.cost``
is tested against this oracle.

Broker load model (utils.go:92-105, rationale README.md:14-19): for each
partition, the leader broker (``replicas[0]``) accrues
``weight * (len(replicas) + num_consumers)``; every follower accrues
``weight``. ``num_consumers`` defaults to 0 (code behaviour, not the stale
comment — SURVEY.md §2.1).

Objective (utils.go:119-147): with ``rel_b = load_b/avg - 1``, the unbalance
is ``sum(rel^2)`` over overloaded brokers plus ``sum(rel^2)/2`` over
underloaded brokers — the asymmetric penalty (overload counts double) is
part of the contract.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# numpy is imported lazily inside get_broker_load: costmodel sits on the
# import path of the daemon's jax-free forwarding client, and a
# module-level numpy import would cost every forwarded invocation ~0.1 s
# of startup
from kafkabalancer_tpu_torch.models import PartitionList
from kafkabalancer_tpu_torch.models.config import HOST_FLOAT_DTYPE

# A broker-load table sorted ascending by (load, broker-ID). The ID tie-break
# (utils.go:23-28) is part of observable output determinism.
BrokerLoadList = List[List]  # [[broker_id, load], ...] (mutable load cells)


def get_broker_load(pl: PartitionList) -> Dict[int, float]:
    """Per-broker load map (utils.go:92-105).

    Accumulated via ``np.add.at`` over the flat (partition, slot)-order
    accrual sequence: each broker's cell receives exactly the additions
    the reference's dict loop would apply to it, in the same order, so
    per-broker sums are bit-identical (``ufunc.at`` is unbuffered and
    applies repeated indices sequentially). This runs 4x per planning
    request (three repair steps + the move oracle) over every replica
    slot, which made the dict loop a measurable slice of the warm-daemon
    request budget at 10k-partition scale (the scalar loop is kept as
    ``_get_broker_load_ref``, pinned by tests/test_steps.py).
    """
    import numpy as np  # deferred: keep the jax-free client import-light

    bid_seq: List[int] = []
    w_seq: List[float] = []
    for p in pl.iter_partitions():
        reps = p.replicas
        if not reps:
            continue
        bid_seq.append(reps[0])
        w_seq.append(p.weight * (len(reps) + p.num_consumers))
        for r in reps[1:]:
            bid_seq.append(r)
            w_seq.append(p.weight)
    if not bid_seq:
        return {}
    bids = np.asarray(bid_seq, dtype=np.int64)
    ws = np.asarray(w_seq, dtype=HOST_FLOAT_DTYPE)
    uniq, inv = np.unique(bids, return_inverse=True)
    acc = np.zeros(len(uniq), dtype=HOST_FLOAT_DTYPE)
    np.add.at(acc, inv, ws)
    return {int(b): float(v) for b, v in zip(uniq, acc)}


def _get_broker_load_ref(pl: PartitionList) -> Dict[int, float]:
    """The reference transcription of getBrokerLoad — the scalar oracle
    :func:`get_broker_load` is differentially pinned against."""
    loads: Dict[int, float] = {}
    for p in pl.iter_partitions():
        for idx, r in enumerate(p.replicas):
            if idx == 0:
                loads[r] = loads.get(r, 0.0) + p.weight * (
                    len(p.replicas) + p.num_consumers
                )
            else:
                loads[r] = loads.get(r, 0.0) + p.weight
    return loads


def get_bl(loads: Dict[int, float]) -> BrokerLoadList:
    """Map -> list sorted by (load, ID) (utils.go:107-117); the sort fixes the
    float accumulation order of the objective."""
    return [
        [bid, load]
        for bid, load in sorted(loads.items(), key=lambda kv: (kv[1], kv[0]))
    ]


def _ieee_div(x: float, y: float) -> float:
    """Float division with Go/IEEE-754 semantics: 0/0 = NaN, x/0 = ±inf.

    Python raises ZeroDivisionError instead; the reference relies on NaN
    propagation when all broker loads are zero (every comparison against the
    NaN objective is false, so the planner reports "no candidate changes"
    and exits 0 — reproduced for parity)."""
    if y != 0.0:
        return x / y
    if x == 0.0 or x != x:
        return float("nan")
    return float("inf") if x > 0 else float("-inf")


def get_unbalance_bl(bl: BrokerLoadList) -> float:
    """The objective (utils.go:119-147); iterates in ``bl`` order so float
    results match the reference bit-for-bit (including NaN propagation on
    degenerate all-zero loads and 0.0 on an empty table)."""
    sum_load = 0.0
    for _bid, load in bl:
        sum_load += load
    avg = _ieee_div(sum_load, float(len(bl)))

    unbalance = 0.0
    for _bid, load in bl:
        rel = _ieee_div(load, avg) - 1.0
        if rel > 0:
            unbalance += rel * rel
        else:
            unbalance += rel * rel / 2
    return unbalance


def get_broker_list(pl: PartitionList) -> List[int]:
    """Sorted union of brokers observed in any replica list — the "auto"
    broker discovery (utils.go:49-64)."""
    seen = set()
    for p in pl.iter_partitions():
        seen.update(p.replicas)
    return sorted(seen)


def get_broker_list_by_load(
    loads: Dict[int, float], brokers: Optional[List[int]]
) -> List[int]:
    """``brokers`` ordered ascending by (load, ID); brokers absent from
    ``loads`` count as load 0 (utils.go:66-79). Such brokers *can* be
    targets here (used by Add/Remove repairs), unlike the BL variant below."""
    pairs = [(loads.get(bid, 0.0), bid) for bid in (brokers or [])]
    pairs.sort()
    return [bid for _load, bid in pairs]


def get_broker_list_by_load_bl(
    bl: BrokerLoadList, brokers: Optional[List[int]]
) -> List[int]:
    """Filter an existing (load, ID)-sorted table to an allowed set
    (utils.go:81-90). Note the asymmetry with :func:`get_broker_list_by_load`:
    brokers not present in ``bl`` (i.e. observed nowhere) are dropped — a
    brand-new empty broker can never be the target of a disallowed-replica
    move (steps.go:122, SURVEY.md §2.5)."""
    allowed = brokers or []
    return [bid for bid, _load in bl if bid in allowed]
