"""The per-move window scorer behind ``-solver=tpu``, on the GPU.

Counterpart of the reference package's ``solvers/tpu.py`` (the flag keeps
the reference's spelling, so an argv stays valid for both packages). It
replaces the greedy scalar scan (``move``, steps.go:145-232) for one move
per ``Balance()`` call: every candidate ``(partition p, movable replica r,
target broker t)`` is scored on the device with the rank-1 objective
update

    u(move) = Σ_b f(load_b) − f(load_s) − f(load_t)
                            + f(load_s − w) + f(load_t + w)

(a move leaves the total load, and so the average, unchanged), and only
the per-partition minima come back to the host.

**Exact parity.** The reference's O(B) recompute per candidate adds floats
in ``bl`` order, so tied candidates are separated by last-ulp rounding
that an order-free reduction cannot reproduce. The host therefore flags
the partitions whose minimum lies within a tolerance of the global
minimum and replays the oracle's own per-partition scan
(``balancer/steps.py`` ``scan_moves``) over just those rows: plans are
byte-identical to the greedy oracle.

The device pass is tiered by precision (:func:`find_best_move`): float32
first (the filter only bounds the window, so a wider tolerance costs host
re-scan rows, never correctness), float64 when the float32 window
overflows the host re-scan budget, and the full greedy scan only when even
that window does (``MAX_WINDOW_CANDIDATES``). Instances below
``MIN_DEVICE_CANDIDATES`` candidates take the greedy scan directly: the
result is the same by contract, and the host is faster there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.balancer import costmodel
from kafkabalancer_tpu_torch.balancer.steps import (
    greedy_move,
    replace_replica,
    scan_moves,
)
from kafkabalancer_tpu_torch.models import PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import HOST_FLOAT_DTYPE
from kafkabalancer_tpu_torch.obs import convergence
from kafkabalancer_tpu_torch.ops.cost import (
    move_candidate_scores,
    ordered_sum,
    overload_penalty,
    rank_brokers,
)
from kafkabalancer_tpu_torch.ops.tensorize import (
    DensePlan,
    all_allowed_of,
    broker_universe,
    tensorize,
)

Tensor = torch.Tensor

# host re-scan budget: the oracle scan over the window's partitions covers
# at most this many (slot x target) candidate evaluations; a wider window
# (pervasive exact ties) falls back to the full greedy scan
MAX_WINDOW_CANDIDATES = 32768

# below this candidate count the greedy scan beats a device pass; the
# solver is byte-identical to greedy by contract, so routing tiny
# instances to the host scan changes nothing but wall-clock
MIN_DEVICE_CANDIDATES = 20_000


def score_moves(
    loads: Tensor,
    replicas: Tensor,
    allowed: Tensor,
    member: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    pvalid: Tensor,
    bvalid: Tensor,
    nb: Tensor,
    min_replicas: int,
    *,
    leaders: bool,
    tie_k: int = 0,
) -> Tuple[Tensor, ...]:
    """Score every candidate move of one class with the rank-1 update over
    the full ``[P, R, B]`` candidate tensor.

    Returns ``(u_min, flat_idx, su, perm)`` and, when ``tie_k > 0``, the
    per-partition minima ``perpart`` too. ``flat_idx`` indexes the
    candidates flattened in ``(partition, replica slot, target bl-rank)``
    order; ``perm`` maps bl rank to dense broker index. :func:`score_window`
    computes the same per-partition minima without the ``[P, R, B]``
    tensor.
    """
    R = replicas.shape[1]
    _, perm, rank_of = rank_brokers(loads, bvalid)
    u, su = move_candidate_scores(
        loads, replicas, allowed[:, perm], member[:, perm], bvalid,
        bvalid[perm], perm, rank_of, weights, nrep_cur, nrep_tgt, pvalid, nb,
        min_replicas,
    )
    slot = torch.arange(R, device=loads.device)[None, :]
    movable = (slot == 0) if leaders else (slot >= 1)
    masked = torch.where(movable[:, :, None], u, torch.full_like(u, float("inf")))
    flat = masked.reshape(-1)
    idx = flat.argmin()
    if tie_k <= 0:
        return flat[idx], idx, su, perm
    return flat[idx], idx, su, perm, masked.amin(dim=(1, 2))


def score_window(
    ints: Tensor, floats: Tensor, allowed: Optional[Tensor],
    *, leaders: bool, all_allowed: bool,
) -> Tensor:
    """Per-partition candidate minima of one move class, on the device the
    inputs live on, in the reference's packed layout.

    ``ints [P, R+3]`` carries ``replicas | nrep_cur | nrep_tgt | pvalid``;
    ``floats [P+B+2]`` carries ``weights | loads | nb | min_replicas``,
    and its dtype is the scoring precision. ``allowed [P, B]`` is None in
    the all-allowed mode. The objective factors as ``u = su + A(p, slot) +
    C(p, target)``, so a partition's minimum is ``su + min A + min C``:
    ``[P, R] + [P, B]`` work. Returns ``[u_min, su, relmax, wrel,
    perpart...]``; ``relmax`` (the largest ``|load/avg - 1|`` over valid
    brokers) and ``wrel`` (the largest weight over ``|avg|``) bound the
    rounding error the host's window tolerance must cover.
    """
    from kafkabalancer_tpu_torch.solvers.scan import member_from

    P, W = ints.shape
    R = W - 3
    replicas = ints[:, :R]
    nrep_cur = ints[:, R]
    nrep_tgt = ints[:, R + 1]
    pvalid = ints[:, R + 2] > 0
    B = floats.shape[0] - P - 2
    dev = floats.device
    inf = float("inf")
    weights = floats[:P]
    loads = floats[P : P + B]
    nb = floats[P + B]
    min_replicas = floats[P + B + 1].to(torch.int32)
    # tensorize packs the real brokers first (bvalid[:nb])
    bvalid = torch.arange(B, device=dev) < nb.to(torch.int32)
    slot = torch.arange(R, device=dev)[None, :]
    valid = (slot < nrep_cur[:, None]) & pvalid[:, None]
    member = member_from(replicas, nrep_cur, pvalid, B)
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    F = torch.where(bvalid, overload_penalty(loads, avg), zero)
    su = ordered_sum(F)
    w = weights[:, None]
    s = replicas.clamp(min=0).long()
    movable = (slot == 0) if leaders else (slot >= 1)
    srcok = movable & valid & (nrep_tgt >= min_replicas)[:, None]
    A = overload_penalty(loads[s] - w, avg) - F[s]
    Amin = torch.where(srcok, A, torch.full_like(A, inf)).amin(1)
    tmask = ~member & bvalid[None, :]
    if not all_allowed:
        tmask = allowed & tmask
    C = overload_penalty(loads[None, :] + w, avg) - F[None, :]
    Cmin = torch.where(tmask, C, torch.full_like(C, inf)).amin(1)
    perpart = su + Amin + Cmin
    u_min = perpart.amin()
    rel = loads / avg - 1.0
    relmax = torch.where(bvalid, rel.abs(), zero).amax()
    wrel = torch.where(pvalid, weights, torch.zeros_like(weights)).amax() / avg.abs()
    return torch.cat(
        [u_min.reshape(1), su.reshape(1), relmax.reshape(1),
         wrel.reshape(1), perpart]
    )


def pack_window_args(
    dp: DensePlan, loads_np: Any, cfg: RebalanceConfig
) -> Tuple[Any, Any, Any, bool]:
    """The window scorer's packed layout (see :func:`score_window`):
    ``(ints, floats64, allowed_or_None, all_allowed)``; the caller casts
    ``floats64`` to the tier's dtype."""
    ints = np.concatenate(
        [
            dp.replicas,
            dp.nrep_cur[:, None],
            dp.nrep_tgt[:, None],
            dp.pvalid[:, None].astype(np.int32),
        ],
        axis=1,
    ).astype(np.int32)
    floats64 = np.concatenate(
        [
            dp.weights,
            loads_np,
            [float(dp.nb), float(cfg.min_replicas_for_rebalancing)],
        ]
    )
    all_allowed = all_allowed_of(dp)
    return ints, floats64, None if all_allowed else dp.allowed, all_allowed


def oracle_loads(pl: PartitionList, cfg: RebalanceConfig) -> Dict[int, float]:
    """Broker loads in the oracle's accumulation order, with the reference
    ``move()`` zero-fill of configured brokers (steps.go:150-155)."""
    loads = costmodel.get_broker_load(pl)
    for bid in cfg.brokers or []:
        if bid not in loads:
            loads[bid] = 0.0
    return loads


class TieOverflow(Exception):
    """The near-minimal candidate window spans more partitions than the
    host re-scan budget covers: resolve with the full exact scan."""


def find_best_move(
    dp: DensePlan,
    cfg: RebalanceConfig,
    leaders: bool,
    loads_map: Optional[Dict[int, float]] = None,
    *,
    device: Any,
) -> Optional[Tuple[int, int, int]]:
    """Best accepted move on a dense plan: ``(partition row, source broker
    ID, target broker ID)``, or ``None`` when no candidate improves by more
    than ``cfg.min_unbalance``. Raises :class:`TieOverflow` when even the
    float64 window is too wide for the host re-scan.

    Each device pass adds one to the ``solver.window_passes`` counter; the
    rows re-scanned on the host go to ``solver.window_rows``.
    """
    nb = dp.nb
    B = dp.bvalid.shape[0]
    R = dp.replicas.shape[1]
    if loads_map is None:
        loads_map = oracle_loads(
            PartitionList(version=1, partitions=dp.partitions), cfg
        )
    loads_np = np.zeros(B, dtype=HOST_FLOAT_DTYPE)
    for bid, load in loads_map.items():
        loads_np[dp.broker_index(bid)] = load

    ints, floats64, allowed_np, all_allowed = pack_window_args(
        dp, loads_np, cfg
    )
    rec = convergence.recorder()
    if rec is not None:
        # -explain candidate-space statistics from the dense encoding
        # this pass built (one numpy pass, no device sync)
        rec.note_round(dp, cfg, chunk=1, engine="tpu-score")
    ints_d = torch.from_numpy(ints).to(device)
    allowed_d = None if allowed_np is None else torch.from_numpy(allowed_np).to(device)

    # tiered scoring: float32 filters; float64 retries on window overflow.
    # The device pass only filters candidates; acceptance and order come
    # from the host-exact oracle re-scan below.
    rows = None
    for npdt in (np.float32, np.float64):  # jaxlint: disable=R4 — tier ladder
        out = score_window(
            ints_d, torch.from_numpy(floats64.astype(npdt)).to(device),
            allowed_d, leaders=leaders, all_allowed=all_allowed,
        ).cpu().numpy()
        obs.metrics.count("solver.window_passes")
        u_min, su_dev = float(out[0]), float(out[1])
        relmax, wrel = float(out[2]), float(out[3])
        perpart = out[4:]
        if not np.isfinite(u_min):
            # no candidate, or a NaN objective (zero loads); only the
            # float64 tier may conclude that: loads representable in
            # float64 can underflow the float32 cast to a spurious 0/0
            if npdt is np.float64:  # jaxlint: disable=R4 — tier ladder
                convergence.note_outcome(
                    "no_feasible_candidate" if np.isinf(u_min)
                    else "already_balanced",
                    unbalance=float(su_dev),
                )
                return None
            continue
        # window tolerance: a sound bound on the tier's per-partition error
        # relative to its own u_min — summation rounding (~B·eps·scale)
        # plus the cancellation in rel = load/avg - 1, with
        # rho = relmax + wrel bounding any |rel| a candidate reaches
        rho = 1.0 + (relmax + wrel if np.isfinite(relmax + wrel) else 0.0)
        if npdt is np.float32:  # jaxlint: disable=R4 — tier ladder
            eps = float(np.finfo(np.float32).eps)  # jaxlint: disable=R4 — tier ladder
            tol = eps * (
                4.0 * B * max(abs(u_min), abs(su_dev)) + 32.0 * rho * rho
            )
        else:
            eps = float(np.finfo(np.float64).eps)  # jaxlint: disable=R4 — tier ladder
            tol = (
                1e-9 * max(1.0, abs(u_min), abs(su_dev))
                + 64.0 * eps * rho * rho
                + 1e-12
            )
        cand = np.nonzero(perpart <= u_min + tol)[0]
        if len(cand) * R * nb <= MAX_WINDOW_CANDIDATES:
            rows = cand
            break
    if rows is None:
        raise TieOverflow
    if rec is not None:
        rec.note_tie_window(int(len(rows)))
    obs.metrics.count("solver.window_rows", len(rows))

    # replay the oracle's own per-partition scan over just the flagged
    # rows: same bl table, same candidate order, same first-strict-improver
    # rule, so the same move to the last bit
    bl = costmodel.get_bl(loads_map)
    su = costmodel.get_unbalance_bl(bl)
    cu, best, wpos = scan_moves(
        [dp.partitions[int(row)] for row in rows], bl, su, None, cfg, leaders
    )
    best_row = int(rows[wpos]) if wpos >= 0 else -1
    if best is None or not (cu < su - cfg.min_unbalance):
        if best is not None and cu < su:
            convergence.note_outcome(
                "below_threshold", unbalance=su, best_unbalance=cu,
                min_unbalance=cfg.min_unbalance,
            )
        else:
            convergence.note_outcome(
                "already_balanced", unbalance=su,
                min_unbalance=cfg.min_unbalance,
            )
        return None
    _p, r_id, t_id = best
    return best_row, int(r_id), int(t_id)


def _tpu_move(
    pl: PartitionList, cfg: RebalanceConfig, leaders: bool, device: Any
) -> Optional[PartitionList]:
    # the real (unpadded, movable-slot-aware) candidate count, without
    # tensorizing, so the host path pays no encoding cost
    movable = (
        len(pl.partitions or ())
        if leaders
        else sum(max(0, len(p.replicas) - 1) for p in pl.iter_partitions())
    )
    if movable * len(broker_universe(pl, cfg)) < MIN_DEVICE_CANDIDATES:
        return greedy_move(pl, cfg, leaders)
    from kafkabalancer_tpu_torch.solvers.scan import resolve_device

    device = resolve_device(device)
    dp = tensorize(pl, cfg)
    try:
        best = find_best_move(dp, cfg, leaders, device=device)
    except TieOverflow:
        return greedy_move(pl, cfg, leaders)
    if best is None:
        return None
    p, s_id, t_id = best
    return replace_replica(dp.partitions[p], s_id, t_id)


def tpu_move_leaders(
    pl: PartitionList, cfg: RebalanceConfig, device: Any = None
) -> Optional[PartitionList]:
    """Leader moves, gated like the reference (steps.go:292-298)."""
    if not cfg.allow_leader_rebalancing:
        return None
    return _tpu_move(pl, cfg, True, device)


def tpu_move_non_leaders(
    pl: PartitionList, cfg: RebalanceConfig, device: Any = None
) -> Optional[PartitionList]:
    """Follower moves, always enabled (steps.go:286-288)."""
    return _tpu_move(pl, cfg, False, device)
