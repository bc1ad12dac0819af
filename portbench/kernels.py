"""Bytes that the scoring kernel K1 needs, and the card's peaks.

K1 (``kafkabalancer_tpu_torch/csrc/shard_score.cu``) scores every
(partition, target broker) cell of one instance per launch. Counted once
each, at the cluster's real sizes (no padding of the program's layout):
the ``[P, B]`` member mask (1 byte a cell), the ``[P, R]`` replicas
(int32), five float32 row columns, the broker vectors (``loads``, ``F`` float32, ``bvalid`` one byte, the pair
frame ``s_i``, ``t_i`` int32 and ``live`` one byte over ``B // 2`` pairs)
and the eight outputs (four float32 and four int32 vectors, two over
``B`` and two over the pairs each). Every broker is allowed in these
clusters, so no allowed mask is read. A batched launch does this for each
of its instances. Only the plain variant is counted: its colocation
variant, which also reads ``[P, B]`` counts rows, runs in no cell.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

# published peaks, NVIDIA H100 SXM data sheet (dense, without sparsity)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def k1_bytes(partitions: int, brokers: int, rf: int) -> int:
    """Bytes one instance of a plain K1 launch reads and writes."""
    P, B, R = partitions, brokers, rf
    B2 = max(1, B // 2)
    rows = P * B + P * (4 * R + 20)
    vectors = B * (4 + 4 + 1) + B2 * (4 + 4 + 1) + 12
    outputs = 2 * (4 + 4) * B + 2 * (4 + 4) * B2
    return rows + vectors + outputs


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


# score_blocks<kAlw, kColo, kLead, kTgt>: the K1 kernel's device name
K1_NAME = re.compile(r"score_blocks<\s*(\w+),\s*(\w+),")


def k1_roofline(ctx: Dict[str, Any]) -> Optional[float]:
    """The window's plain K1 launches: the bytes their instances
    needed over the card's bandwidth, as a percentage of their summed
    device time. A launch's instance count is its grid's y dimension,
    read from the profiler's metadata, else the window's mean occupancy.
    None when the window has no such launch or the card has no entry in
    ``PEAKS``."""
    bw = peak(ctx["device_kind"], "hbm_bytes_per_s")
    if bw is None:
        return None
    cfg = ctx["cell"].config
    per = k1_bytes(int(cfg["partitions"]), int(cfg["brokers"]),
                   int(cfg["replication_factor"]))
    occ = ctx.get("occupancy") or 1.0
    need = secs = 0.0
    for name, a, b, meta in ctx["trace"].ops:
        m = K1_NAME.search(name)
        if not m or m.group(2) == "true":
            continue
        grid = grid_of(meta)
        need += (grid[1] if grid else occ) * per
        secs += (b - a) / 1e9
    if secs <= 0:
        return None
    return 100.0 * need / bw / secs


def grid_of(meta: str) -> Optional[List[int]]:
    """A kernel event's grid from the profiler's metadata, if it has one."""
    m = re.search(r'"grid"\s*:\s*\[\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)', meta or "")
    return [int(g) for g in m.groups()] if m else None
