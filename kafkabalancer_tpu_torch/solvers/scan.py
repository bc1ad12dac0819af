"""Multi-move planning sessions on the device.

The counterpart of the reference package's ``solvers/scan.py``. The
reference applies one move per ``Balance()`` call and loops on the host
(``-max-reassign`` outer loop, kafkabalancer.go:177-221). Here a whole
k-move session runs on the device: per iteration the candidates are
scored, the accepted moves are applied to the device state, and the loop
exits once no candidate clears the ``min_unbalance`` threshold.

- ``batch > 1`` (the throughput mode, ``-fused-batch``): per iteration
  the scoring kernel (``parallel/shard_kernel.py``) finds the best
  candidate per target broker and per hot/cold broker pair; a
  gain-ordered prefix of them is accepted with exact sequential deltas
  (:func:`prefix_accept`) and committed together.
- ``batch == 1``: strict one-move-at-a-time greedy over the full
  ``[P, R, B]`` candidate tensor, leader moves first — the
  pipeline-parity trajectory.

The loop is a Python loop over torch operations with one host read per
iteration (the accepted count). The session's state lives on the device
and is updated in place. ``plan(engine="pallas")`` runs the whole session
as one kernel launch per chunk instead (``solvers/pallas_session.py``),
sharing this module's candidate pool (:func:`batch_pool`) and acceptance
(:func:`prefix_accept`) through its plain version.

``plan`` wraps the session like the reference's: host repairs first,
then chunked sessions that re-encode the live assignment between chunks,
then the move log is replayed onto the partition objects. Two other
sessions run under the same wrapper: ``polish=True`` alternates move
sessions with pair-swap phases (``solvers/polish.py``), and
``rebalance_leaders`` runs the fused leader session
(``solvers/leader.py``), whose leadership exchanges the log carries as
``leader.SWAP_SLOT`` entries. ``anti_colocation=λ`` runs the batched
session (and polish) on the combined objective ``u + λ·colocations``
with per-(topic, broker) counts as session state.

:func:`session_batched` runs K independent move sessions as one (with
``polish.converge_session_batched``, the counterpart of the reference's
``session_packed_batched``): one host loop, at batch > 1 one launch of
the batched scoring kernel for all K per iteration (its colocation
variant on the combined objective), one read of the K accepted counts.
The planning daemon's batchers (serve/lanes.py) reach both through the
seam in :func:`_run_chunk` (:func:`set_microbatcher`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.balancer.pipeline import _COMMON_HEAD
from kafkabalancer_tpu_torch.balancer.steps import BalanceError
from kafkabalancer_tpu_torch.models import Partition, PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import ENGINES, default_dtype, kernel_dtype
from kafkabalancer_tpu_torch.models.partition import empty_partition_list
from kafkabalancer_tpu_torch.obs import convergence
from kafkabalancer_tpu_torch.ops.cost import (
    broker_loads,
    colo_terms,
    move_candidate_scores,
    ordered_sum,
    overload_penalty,
    pair_finish,
    pair_frame,
    rank_brokers,
    scalar,
    scatter_add_,
    unbalance,
)
from kafkabalancer_tpu_torch.ops.runtime import next_bucket
from kafkabalancer_tpu_torch.ops.tensorize import all_allowed_of, tensorize, to_device
from kafkabalancer_tpu_torch.parallel.shard_kernel import (
    pack_cols,
    shard_score,
    shard_score_batched,
)

Tensor = torch.Tensor

# batched-commit churn gate default: only commit moves whose gain is within
# this factor of the iteration's best (the reference's swept default)
DEFAULT_CHURN_GATE = 1.5


def auto_chunk_moves(npart: int) -> int:
    """Per-session move budget scaled to the instance: sessions up to
    convergence scale stay in one chunk (moves-to-converge tracks about
    P/8), small instances keep the 8192 floor, and a chunk never exceeds
    2**20 moves (the move-log buffers are sized from it)."""
    return min(max(8192, 1 << (npart // 4).bit_length()), 1 << 20)


def resolve_engine(engine: str) -> str:
    """``"auto"`` resolves to ``"xla"``, the name the reference gives its
    converge session; in this package that is the torch session with
    the hand-written scoring kernel."""
    return "xla" if engine == "auto" else engine


def resolve_device(device: Any = None) -> torch.device:
    """The device a session runs on: CUDA unless the caller asks for
    another. A CUDA request without a usable card raises — planning
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to plan on "
            "the CPU"
        )
    return dev


def anti_colocation_requested(
    cfg: RebalanceConfig, anti_colocation: Optional[float], batch: int,
) -> Tuple[float, bool]:
    """The engine-independent half of the activation convention: the
    penalty that would activate under the ``xla`` engine, and whether it
    was an explicit request. Returns ``(lam, explicit)``."""
    if anti_colocation is None:
        lam = getattr(cfg, "anti_colocation", 0.0) or 0.0
        if lam and (batch <= 1 or cfg.rebalance_leaders):
            lam = 0.0
        return max(0.0, lam), False
    return max(0.0, anti_colocation), True


def resolve_anti_colocation(
    cfg: RebalanceConfig,
    anti_colocation: Optional[float],
    batch: int,
    engine: str,
    what: str = "colocation session",
) -> Tuple[float, str]:
    """When an anti-colocation penalty activates; returns ``(lam,
    engine)``.

    The argument overrides ``cfg.anti_colocation``, which is the default.
    A cfg-derived penalty activates only where it changes nothing for
    other callers: it drops at ``batch <= 1``, with ``rebalance_leaders``
    and under an explicit kernel engine. An explicit request validates:
    ``batch > 1`` and no ``rebalance_leaders`` (the leader session has no
    colocation state), and a non-``xla`` engine is overridden with a
    warning (the whole-session kernel has no colocation state either).
    """
    lam, explicit = anti_colocation_requested(cfg, anti_colocation, batch)
    if not explicit and lam and engine != "xla":
        lam = 0.0
    if lam and batch <= 1:
        raise ValueError("anti_colocation requires batch > 1")
    if lam and cfg.rebalance_leaders:
        raise ValueError(
            "anti_colocation is not supported with rebalance_leaders "
            "(the fused leader session has no colocation state)"
        )
    if lam and engine != "xla":
        import warnings

        warnings.warn(
            f"anti_colocation runs the XLA {what}; explicit "
            f"engine={engine!r} request is overridden",
            UserWarning,
            stacklevel=3,
        )
        engine = "xla"
    return lam, engine


def prefix_accept(
    vals: Tensor,
    p: Tensor,
    s_: Tensor,
    t: Tensor,
    w_k: Tensor,
    loads: Tensor,
    avg: Tensor,
    su: Tensor,
    min_unbalance: Tensor,
    churn_gate: Tensor,
    n: int,
    batch: int,
    budget: int,
    max_moves: int,
    topic: Optional[Tensor] = None,
    colo_d: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """PREFIX-EXACT batched-commit acceptance over a candidate pool.

    Order claimants by (gain, index) — ``E[j, k]`` = "j strictly
    earlier" — claim partitions first-claimant, then compute each
    candidate's source/target load *as of its turn* via per-broker net
    prefix sums over earlier survivors. ``d_k`` is then the EXACT
    sequential delta of move k even when candidates share brokers, and
    accepting the longest prefix of improving candidates keeps every
    committed move improving the objective by precisely its delta. The
    pool's rank-0 candidate is the globally best single move, so the
    loop stops exactly when one-at-a-time greedy would.

    Inputs are [K] candidate tensors (``vals`` ABSOLUTE su-based scores,
    +inf for dead candidates) plus the scalars. Returns ``(ok, pos,
    cnt)``: the accepted mask, each candidate's move-log position, and
    the accepted count.

    ``topic``/``colo_d`` (both [K], together) extend the contract to the
    anti-colocation objective: ``colo_d`` is each candidate's colocation
    delta ±λ from the pass-START counts, and it stays exact because an
    earlier same-topic claimant sharing either broker first-claims the
    candidate like a partition — no two accepted moves of a pass touch
    the same (topic, broker) cell. ``d_k`` then scores the combined
    objective (load delta + ``colo_d``).

    Claims are made by every IMPROVING candidate, not only by the finally
    accepted set (the reference's deliberate, conservative
    approximation): a candidate can lose its claim to an earlier
    claimant that is later rejected; the next iteration re-offers it.
    """
    dtype = loads.dtype
    K = vals.shape[0]
    kk = torch.arange(K, device=vals.device)

    improving = torch.isfinite(vals) & (vals < su - min_unbalance) & (vals < su)
    # churn gate: only commit candidates whose improvement is within
    # ``churn_gate``x of this iteration's best; the best always passes
    best_gain = su - vals.amin()
    improving &= (su - vals) * churn_gate >= best_gain

    E = (vals[:, None] < vals[None, :]) | (
        (vals[:, None] == vals[None, :]) & (kk[:, None] < kk[None, :])
    )
    claimed = E & improving[:, None] & (p[:, None] == p[None, :])
    if topic is not None:
        # (topic, broker) first-claim: keeps each ±λ constant exact
        bshare = (
            (s_[:, None] == s_[None, :])
            | (s_[:, None] == t[None, :])
            | (t[:, None] == s_[None, :])
            | (t[:, None] == t[None, :])
        )
        claimed |= (
            E & improving[:, None] & (topic[:, None] == topic[None, :]) & bshare
        )
    surv = improving & ~claimed.any(0)

    Ej = (E & surv[:, None]).to(dtype)  # [K, K] j earlier & survives
    wEj = Ej * w_k[:, None]
    to_s = (t[:, None] == s_[None, :]).to(dtype) - (
        s_[:, None] == s_[None, :]
    ).to(dtype)
    to_t = (t[:, None] == t[None, :]).to(dtype) - (
        s_[:, None] == t[None, :]
    ).to(dtype)
    Ls = loads[s_] + ordered_sum(wEj * to_s, 0)
    Lt = loads[t] + ordered_sum(wEj * to_t, 0)
    d_k = (
        overload_penalty(Ls - w_k, avg)
        - overload_penalty(Ls, avg)
        + overload_penalty(Lt + w_k, avg)
        - overload_penalty(Lt, avg)
    )
    if colo_d is not None:
        d_k = d_k + colo_d
    ok = surv & (d_k < -min_unbalance) & (d_k < 0)
    # cut at the first survivor whose sequential delta fails — nets for
    # later candidates would assume commits that never happen
    ok &= ~(E & (surv & ~ok)[:, None]).any(0)
    # cap at the batch width and the remaining budget, best-first
    pos = n + (E & ok[:, None]).sum(0)
    ok &= (pos < n + batch) & (pos < budget) & (pos < max_moves)
    return ok, pos, ok.sum()


def pool_frame(
    loads: Tensor, bvalid: Tensor, nb: Tensor
) -> Tuple[Tensor, ...]:
    """The ``[B]``-sized inputs of one scoring pass: ``(avg, F, su, s_i,
    t_i, live)`` — the average load, each broker's penalty (0 on invalid
    brokers), the objective and the hot/cold pair frame."""
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    F = torch.where(bvalid, overload_penalty(loads, avg), zero)
    s_i, t_i, live = pair_frame(loads, bvalid)
    return avg, F, ordered_sum(F), s_i, t_i, live


def rows_pool(
    frame: Tuple[Tensor, ...],
    loads: Tensor,
    bvalid: Tensor,
    rep: Tensor,
    mem: Tensor,
    allowed: Optional[Tensor],
    cols: Tensor,
    minrep: Tensor,
    score: Callable[..., Tuple[Tensor, ...]],
    *,
    allow_leader: bool,
    c_rows: Optional[Tensor] = None,
    lam: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """The candidate pool of the rows ``rep`` holds, on their device.

    Scores the rows with ``score`` (``shard_score`` or its plain version)
    against ``frame`` (:func:`pool_frame`), merges the leader winners
    (strict <, follower wins ties), recovers the follower slots and
    finishes the pair winners. Returns ``(vals_raw, p, slot, s_)`` over
    the ``K = B + B//2`` pool — per-target winners, then the hot/cold
    pair winners — with ``vals_raw`` the scores without ``su`` (+inf for
    dead candidates) and ``p`` a row of ``rep``. A block of rows of a
    larger table (a shard, a row chunk) gives the winners among its own
    rows; the sharded session combines blocks with
    :func:`~kafkabalancer_tpu_torch.parallel.shard_session.combine_pools`
    before ``su`` is added, so the combined pool is the whole table's.

    ``c_rows`` (with the 0-d ``lam``) switches on the scorer's ±λ
    colocation terms; the winners' slot recovery subtracts the same
    source term, so it finds the slot the scorer scored the winner on.
    """
    avg, F, su, s_i, t_i, live = frame
    dev = loads.device
    R = rep.shape[1]
    inf = float("inf")
    weights = cols[:, 0]
    nrep_cur = cols[:, 1]
    lam_s = torch.zeros_like(minrep) if lam is None else lam
    vf, pf, vl, pl_, vpf, ppf, vpl, ppl = score(
        rep, cols, mem, allowed, loads, F, bvalid,
        torch.stack([avg, minrep, lam_s]),
        s_i.to(torch.int32), t_i.to(torch.int32), live, c_rows=c_rows,
        allow_leader=allow_leader,
    )
    pf = pf.long()
    # follower slot recovery for the [B] winners only, ascending-slot
    # ties (cost.factored_target_best's slot_of)
    slot_iota = torch.arange(R, device=dev)[None, :]
    rowsA = (
        overload_penalty(loads[None, :] - weights[pf][:, None], avg)
        - F[None, :]
    )  # [B, B]
    if c_rows is not None:
        rowsA = rowsA - colo_terms(c_rows[pf], lam)[0]
    slot_vals = rowsA.gather(1, rep[pf].clamp(min=0).long())
    valids = (slot_iota >= 1) & (slot_iota < nrep_cur[pf][:, None])
    slot_f = torch.where(
        valids, slot_vals, torch.full_like(slot_vals, inf)
    ).argmin(1)
    if allow_leader:
        lead_better = vl < vf  # strict: follower wins ties
        vals_t = torch.where(lead_better, vl, vf)
        p_t = torch.where(lead_better, pl_.long(), pf)
        slot_t = torch.where(lead_better, torch.zeros_like(slot_f), slot_f)
    else:
        vals_t, p_t, slot_t = vf, pf, slot_f
    vals_p, p_p, slot_p = pair_finish(
        rep, nrep_cur, s_i, live, vpf, ppf,
        vpl if allow_leader else None, ppl if allow_leader else None,
        allow_leader=allow_leader,
    )
    vals_raw = torch.cat([vals_t, vals_p])
    p = torch.cat([p_t, p_p])
    slot = torch.cat([slot_t, slot_p])
    s_ = torch.cat([rep[p_t, slot_t].long(), s_i])
    return vals_raw, p, slot, s_


def finish_pool(
    frame: Tuple[Tensor, ...], vals_raw: Tensor, p: Tensor, slot: Tensor,
    s_: Tensor, weights: Tensor, nrep_cur: Tensor, ncons: Tensor,
) -> Tuple[Tensor, ...]:
    """A whole table's :func:`rows_pool` as :func:`prefix_accept` takes it:
    ``(vals, p, slot, s_, t, w_k, avg, su)`` with ``vals`` absolute
    (su-based, +inf for dead candidates), ``t`` the targets and ``w_k``
    each candidate's applied load shift — the leader premium travels with
    slot 0 (utils.go:96-101). ``weights``, ``nrep_cur`` and ``ncons``
    are indexed by ``p``."""
    avg, _F, su, _s_i, t_i, _live = frame
    t = torch.cat([torch.arange(vals_raw.shape[0] - t_i.shape[0],
                                device=t_i.device), t_i])
    w_k = torch.where(
        slot == 0,
        weights[p] * (nrep_cur[p].to(weights.dtype) + ncons[p]),
        weights[p],
    )
    return su + vals_raw, p, slot, s_, t, w_k, avg, su


def batch_pool(
    loads: Tensor,
    bvalid: Tensor,
    nb: Tensor,
    rep: Tensor,
    mem: Tensor,
    allowed: Optional[Tensor],
    cols: Tensor,
    minrep: Tensor,
    score: Callable[..., Tuple[Tensor, ...]],
    *,
    allow_leader: bool,
    c_rows: Optional[Tensor] = None,
    lam: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """One batched iteration's candidate pool, before acceptance:
    :func:`pool_frame`, :func:`rows_pool` over the whole table and
    :func:`finish_pool`.

    Returns ``(vals, p, slot, s_, t, w_k, avg, su)`` over the ``K = B +
    B//2`` pool — per-target winners, whose rank-0 candidate keeps the
    exact termination criterion, then the hot/cold pair winners, which
    supply distinct partitions, sources and targets. Shared by
    :func:`session` and the whole-session kernel's plain version
    (``solvers/pallas_session.py``).
    """
    frame = pool_frame(loads, bvalid, nb)
    return finish_pool(
        frame,
        *rows_pool(
            frame, loads, bvalid, rep, mem, allowed, cols, minrep, score,
            allow_leader=allow_leader, c_rows=c_rows, lam=lam,
        ),
        cols[:, 0], cols[:, 1], cols[:, 3],
    )


def single_move(
    loads: Tensor,
    rep: Tensor,
    mem: Tensor,
    allowed: Optional[Tensor],
    bvalid: Tensor,
    nb: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    pvalid: Tensor,
    universe_valid: Tensor,
    min_replicas: int,
    mu: Tensor,
    *,
    allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """The strict one-move-at-a-time greedy step over the full ``[P, R,
    B]`` candidate tensor, leader moves first (balancer.go:42-43): the
    body of :func:`session` at ``batch == 1`` and the move step of the
    leader session (``solvers/leader.py``). Returns ``(accept, p, slot,
    s_dense, t_dense)`` as 0-d tensors; the caller reads ``accept``."""
    P, R = rep.shape
    B = loads.shape[0]
    inf = float("inf")
    # (load, ID) target ordering for reference-style tie-breaks
    _, perm, rank_of = rank_brokers(loads, bvalid)
    alw = universe_valid[None, :].expand(P, B) if allowed is None else allowed
    u, su = move_candidate_scores(
        loads, rep, alw[:, perm], mem[:, perm], bvalid, bvalid[perm],
        perm, rank_of, weights, nrep_cur, nrep_tgt, pvalid, nb, min_replicas,
    )
    slot_iota = torch.arange(R, device=loads.device)

    def best(mask_slots: Tensor) -> Tuple[Tensor, Tensor]:
        flat = torch.where(
            mask_slots[None, :, None], u, torch.full_like(u, inf)
        ).reshape(-1)
        i = flat.argmin()
        return flat[i], i

    fol_u, fol_i = best(slot_iota >= 1)
    accept = (fol_u < su - mu) & (fol_u < su)
    chosen = fol_i
    if allow_leader:
        lead_u, lead_i = best(slot_iota == 0)
        accept_lead = (lead_u < su - mu) & (lead_u < su)
        chosen = torch.where(accept_lead, lead_i, fol_i)
        accept = accept | accept_lead
    p, rem = chosen // (R * B), chosen % (R * B)
    slot, t_rank = rem // B, rem % B
    return accept, p, slot, rep[p, slot].long(), perm[t_rank]


def commit_single(
    loads: Tensor, rep: Tensor, mem: Tensor, bcount: Tensor, weights: Tensor,
    nrep_cur: Tensor, ncons: Tensor, p: Tensor, slot: Tensor, s_dense: Tensor,
    t_dense: Tensor,
) -> None:
    """Apply one :func:`single_move` move to the session state in place;
    the leader premium travels with slot 0 (utils.go:96-101)."""
    delta = torch.where(
        slot == 0, weights[p] * (nrep_cur[p].to(loads.dtype) + ncons[p]),
        weights[p],
    )
    loads[s_dense] -= delta
    loads[t_dense] += delta
    rep[p, slot] = t_dense.to(rep.dtype)
    # jaxlint: disable=R3 — stray: the constant is copied to the card first
    mem[p, s_dense] = False
    # jaxlint: disable=R3 — stray: the constant is copied to the card first
    mem[p, t_dense] = True
    bcount[s_dense] -= 1
    bcount[t_dense] += 1


def member_from(
    replicas: Tensor, nrep_cur: Tensor, pvalid: Tensor, B: int
) -> Tensor:
    """The ``[P, B]`` membership mask of a replica matrix (valid slots of
    valid partitions)."""
    P, R = replicas.shape
    slot = torch.arange(R, device=replicas.device)[None, :]
    valid = (slot < nrep_cur[:, None]) & pvalid[:, None]
    flat = torch.where(
        valid, torch.arange(P, device=replicas.device)[:, None] * B
        + replicas.long(), P * B,
    )
    mem = torch.zeros(P * B + 1, dtype=torch.bool, device=replicas.device)
    mem[flat.reshape(-1)] = True
    return mem[: P * B].view(P, B)


def accept_commit(
    pool: Tuple[Tensor, ...],
    loads: Tensor,
    bcount: Tensor,
    log: Tensor,
    n: int,
    batch: int,
    budget: int,
    max_moves: int,
    mu: Tensor,
    cg: Tensor,
    colo: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Accept a prefix of a :func:`batch_pool` pool (:func:`prefix_accept`)
    and commit it to the broker-side state in place: ``loads``, the
    per-broker replica counts ``bcount``, the colocation counts and the
    move log (rows p | slot | src | tgt, trash column at ``max_moves``).
    ``colo`` is ``(topic_id [P], counts_flat [T·B], lam)`` for the
    anti-colocation objective. Returns ``(ok, cnt)``; the caller writes
    the accepted moves into its replica and membership rows."""
    vals, p, slot, s_, t, w_k, avg, su = pool
    dtype = loads.dtype
    B = loads.shape[0]
    tid_k = colo_d = None
    if colo is not None:
        # each candidate's colocation delta from the pass-start counts;
        # prefix_accept's (topic, broker) claims keep it exact
        tid, counts_flat, lam_t = colo
        tid_k = tid[p]
        sub_s, _ = colo_terms(counts_flat[tid_k * B + s_], lam_t)
        _, add_t = colo_terms(counts_flat[tid_k * B + t], lam_t)
        colo_d = add_t - sub_s
    ok, pos, cnt = prefix_accept(
        vals, p, s_, t, w_k, loads, avg, su, mu, cg, n, batch, budget,
        max_moves, topic=tid_k, colo_d=colo_d,
    )
    # commit; rejected candidates add zeros
    delta = w_k * ok.to(dtype)
    scatter_add_(loads, s_, -delta)
    scatter_add_(loads, t, delta)
    oki = ok.to(torch.int32)
    scatter_add_(bcount, s_, -oki)
    scatter_add_(bcount, t, oki)
    if colo is not None:
        okd = ok.to(dtype)
        scatter_add_(counts_flat, tid_k * B + s_, -okd)
        scatter_add_(counts_flat, tid_k * B + t, okd)
    logpos = torch.where(ok, pos, max_moves)
    log[:, logpos] = torch.where(
        ok, torch.stack([p, slot, s_, t]), torch.full_like(log[:, :1], -1)
    )
    return ok, cnt


def session(
    loads: Tensor,
    replicas: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_replicas: int,
    min_unbalance: float,
    budget: int,
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int = 1,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    topic_id: Optional[Tensor] = None,
    lam: Optional[float] = None,
    n_topics: int = 0,
) -> Tuple[Tensor, ...]:
    """Run up to ``min(budget, max_moves)`` accepted moves on the device
    the inputs live on (all on one device; float inputs in the session
    dtype).

    ``allowed`` is None in the all-allowed mode (every broker of the
    universe is allowed everywhere). Broker-table membership is dynamic,
    like the reference: each iteration the table is the brokers currently
    holding a replica plus the ``always_valid`` configured set
    (steps.go:150-155); ``universe_valid`` masks padded broker columns.

    ``scorer`` replaces the scoring pass of the batched mode (default
    :func:`~kafkabalancer_tpu_torch.parallel.shard_kernel.shard_score`);
    it exists so a check on the card can run the same session with
    ``shard_score_plain`` and compare move logs.

    ``n_topics > 0`` (with ``topic_id [P]`` and ``lam``) runs the
    anti-colocation session on the combined objective ``u + λ·Σ max(0,
    c - 1)``: per-(topic, broker) replica counts ride as float state
    (built once from the membership, updated per commit), the scorer
    gets each partition's counts row, and every candidate carries its
    ±λ colocation delta from the pass-start counts into
    :func:`prefix_accept`. It needs ``batch > 1``.

    Returns ``(replicas, loads, n_moves, move_p, move_slot, move_src,
    move_tgt, final_su)``; the ``move_*`` logs (int32, length
    ``max_moves``) hold the accepted moves in order, -1 past ``n_moves``.
    The inputs are not modified.
    """
    P, R = replicas.shape
    B = loads.shape[0]
    dtype = loads.dtype
    dev = loads.device
    inf = float("inf")
    score = shard_score if scorer is None else scorer
    if n_topics and batch <= 1:
        raise ValueError(
            "the anti-colocation session requires batch > 1 "
            "(the pooled batched selection)"
        )
    mu = scalar(min_unbalance, dtype, dev)
    cg = scalar(DEFAULT_CHURN_GATE, dtype, dev)

    # session state, updated in place each iteration (no per-iteration
    # copies of the [P, B] table). replicas and member carry one trash
    # element past the end: rejected candidates' writes go there, so the
    # accepted writes (distinct partitions) never collide with them.
    loads = loads.clone()
    rep_buf = torch.cat([replicas.reshape(-1), replicas.new_full((1,), -1)])
    rep = rep_buf[: P * R].view(P, R)
    mem_buf = torch.cat([member.reshape(-1), member.new_zeros(1)])
    mem = mem_buf[: P * B].view(P, B)
    # per-broker replica counts: observed-broker tracking in O(1) per move
    bcount = (mem & pvalid[:, None]).sum(0).to(torch.int32)
    # move log rows p | slot | src | tgt, trash column at max_moves
    log = torch.full((4, max_moves + 1), -1, dtype=torch.long, device=dev)
    if n_topics:
        # per-(topic, broker) replica counts; integer-valued floats, so
        # every summation order gives the same bits
        tid = topic_id.long()
        counts = torch.zeros((n_topics, B), dtype=dtype, device=dev)
        scatter_add_(counts, tid, (member & pvalid[:, None]).to(dtype))
        counts_flat = counts.view(-1)
        lam_t = scalar(lam, dtype, dev)

    def table() -> Tuple[Tensor, Tensor]:  # device-loop: the broker table of every iteration
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        return bvalid, bvalid.sum().to(dtype)

    cols = pack_cols(weights, nrep_cur, nrep_tgt, ncons, pvalid)
    minrep = scalar(min_replicas, dtype, dev)

    def step_batch(n: int) -> int:  # device-loop: one batched session iteration
        bvalid, nb = table()
        colo = dict(c_rows=counts[tid], lam=lam_t) if n_topics else {}
        pool = batch_pool(
            loads, bvalid, nb, rep, mem, allowed, cols, minrep, score,
            allow_leader=allow_leader, **colo,
        )
        ok, cnt = accept_commit(
            pool, loads, bcount, log, n, batch, budget, max_moves, mu, cg,
            colo=(tid, counts_flat, lam_t) if n_topics else None,
        )
        # rejected candidates write to the trash element
        _, p, slot, s_, t = pool[:5]
        rep_buf[torch.where(ok, p * R + slot, P * R)] = t.to(rep_buf.dtype)
        # jaxlint: disable=R3 — stray: the constant is copied to the card first
        mem_buf[torch.where(ok, p * B + s_, P * B)] = False
        # jaxlint: disable=R3 — stray: the constant is copied to the card first
        mem_buf[torch.where(ok, p * B + t, P * B)] = True
        # jaxlint: disable=R1 — the designed read: the accepted count ends the iteration
        return int(cnt)

    def step_single(n: int) -> int:  # device-loop: one single-move session iteration
        bvalid, nb = table()
        accept, p, slot, s_dense, t_dense = single_move(
            loads, rep, mem, allowed, bvalid, nb, weights, nrep_cur,
            nrep_tgt, pvalid, universe_valid, min_replicas, mu,
            allow_leader=allow_leader,
        )
        # jaxlint: disable=R1 — the designed read: whether the best move is taken
        if not bool(accept):
            return 0
        commit_single(
            loads, rep, mem, bcount, weights, nrep_cur, ncons, p, slot,
            s_dense, t_dense,
        )
        log[:, n] = torch.stack([p, slot, s_dense, t_dense])
        return 1

    step = step_batch if batch > 1 else step_single
    n = 0
    iters = 0
    t0 = time.perf_counter()
    while n < budget and n < max_moves:
        cnt = step(n)  # ends in the designed read of the accepted count
        iters += 1
        if cnt == 0:
            break
        n += cnt
    # host-clock loop time; every iteration ended in a device sync
    obs.metrics.count("solver.session_seconds", time.perf_counter() - t0)
    obs.metrics.count("solver.session_iterations", iters)
    bvalid, nb = table()
    final_su = unbalance(loads, bvalid, nb)
    mp, mslot, msrc, mtgt = log[:, :max_moves].to(torch.int32)
    return rep.clone(), loads, n, mp, mslot, msrc, mtgt, final_su


def _pair_frame_k(loads: Tensor, bvalid: Tensor) -> Tuple[Tensor, ...]:
    """:func:`~kafkabalancer_tpu_torch.ops.cost.pair_frame` of each row of
    ``loads [K, B]``: ``(s_i, t_i, live)``, each ``[K, B2]``."""
    K, B = loads.shape
    B2 = max(1, B // 2)
    nb_i = bvalid.sum(1)
    sort_load = torch.where(bvalid, loads, torch.full_like(loads, float("inf")))
    perm = torch.sort(sort_load, dim=1, stable=True).indices
    i2 = torch.arange(B2, device=loads.device)[None, :]
    live = i2 < (nb_i // 2)[:, None]
    zero = torch.zeros_like(live, dtype=perm.dtype)
    s_at = (nb_i[:, None] - 1 - i2).clamp(0, B - 1)
    s_i = torch.where(live, perm.gather(1, s_at), zero)
    t_i = torch.where(live, perm.gather(1, i2.clamp(max=B - 1).expand(K, B2)),
                      zero)
    return s_i, t_i, live


def _rows_of(x: Tensor, idx: Tensor) -> Tensor:
    """``x[k, idx[k]]`` for ``x [K, P, ...]`` and ``idx [K, N]``."""
    tail = x.shape[2:]
    return x.gather(
        1, idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    )


def _at(x: Tensor, idx: Tensor) -> Tensor:
    """``x[k].reshape(-1)[idx[k]]`` for ``x [K, ...]`` and ``idx [K,
    ...]``: flat positions within each instance."""
    K = x.shape[0]
    return x.reshape(K, -1).gather(1, idx.reshape(K, -1)).view(idx.shape)


def member_from_k(
    replicas: Tensor, nrep_cur: Tensor, pvalid: Tensor, B: int
) -> Tensor:
    """:func:`member_from` of each of ``K`` instances (``replicas [K, P,
    R]``): the ``[K, P, B]`` membership masks."""
    K, P, R = replicas.shape
    return member_from(
        replicas.reshape(K * P, R), nrep_cur.reshape(-1), pvalid.reshape(-1),
        B,
    ).view(K, P, B)


def _batch_pool_k(
    loads: Tensor, bvalid: Tensor, nb: Tensor, rep: Tensor, mem: Tensor,
    allowed: Optional[Tensor], cols: Tensor, minrep: Tensor,
    score: Callable[..., Tuple[Tensor, ...]], *, allow_leader: bool,
    c_rows: Optional[Tensor] = None, lam: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """:func:`batch_pool` of each of ``K`` instances (every input with a
    leading instance axis), with one call of the batched scorer: each
    instance's pool has the bits of a :func:`batch_pool` call on it
    (element-wise expressions term for term, every reduction per instance
    in the same order). ``c_rows [K, P, B]`` with ``lam [K]`` switches on
    the scorer's colocation variant, as in :func:`rows_pool`."""
    K, P, R = rep.shape
    B = loads.shape[1]
    dev = loads.device
    inf = float("inf")
    # pool_frame
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero), 1) / nb
    F = torch.where(bvalid, overload_penalty(loads, avg[:, None]), zero)
    s_i, t_i, live = _pair_frame_k(loads, bvalid)
    su = ordered_sum(F, 1)
    # rows_pool
    weights = cols[..., 0]
    nrep_cur = cols[..., 1]
    lam_s = torch.zeros_like(minrep) if lam is None else lam
    vf, pf, vl, pl_, vpf, ppf, vpl, ppl = score(
        rep, cols, mem, allowed, loads, F, bvalid,
        torch.stack([avg, minrep, lam_s], 1),
        s_i.to(torch.int32), t_i.to(torch.int32), live, c_rows=c_rows,
        allow_leader=allow_leader,
    )
    pf = pf.long()
    slot_iota = torch.arange(R, device=dev)[None, None, :]
    rowsA = (
        overload_penalty(
            loads[:, None, :] - weights.gather(1, pf)[:, :, None],
            avg[:, None, None],
        )
        - F[:, None, :]
    )  # [K, B, B]
    if c_rows is not None:
        rowsA = rowsA - colo_terms(_rows_of(c_rows, pf), lam[:, None, None])[0]
    slot_vals = rowsA.gather(2, _rows_of(rep, pf).clamp(min=0).long())
    valids = (slot_iota >= 1) & (slot_iota < nrep_cur.gather(1, pf)[:, :, None])
    slot_f = torch.where(
        valids, slot_vals, torch.full_like(slot_vals, inf)
    ).argmin(2)
    if allow_leader:
        lead_better = vl < vf  # strict: follower wins ties
        vals_t = torch.where(lead_better, vl, vf)
        p_t = torch.where(lead_better, pl_.long(), pf)
        slot_t = torch.where(lead_better, torch.zeros_like(slot_f), slot_f)
    else:
        vals_t, p_t, slot_t = vf, pf, slot_f
    # pair_finish
    ppf = ppf.long()
    hit = (
        (_rows_of(rep, ppf) == s_i[:, :, None].to(rep.dtype))
        & (slot_iota >= 1)
        & (slot_iota < nrep_cur.gather(1, ppf)[:, :, None])
    )
    slot_pf = torch.where(
        hit, slot_iota, torch.full_like(slot_iota, R)
    ).argmin(2)
    vals_p, p_p, slot_p = vpf, ppf, slot_pf
    if allow_leader:
        lead_better = vpl < vals_p  # strict: follower wins ties
        vals_p = torch.where(lead_better, vpl, vals_p)
        p_p = torch.where(lead_better, ppl.long(), p_p)
        slot_p = torch.where(lead_better, torch.zeros_like(slot_p), slot_p)
    vals_p = torch.where(live, vals_p, torch.full_like(vals_p, inf))
    vals_raw = torch.cat([vals_t, vals_p], 1)
    p = torch.cat([p_t, p_p], 1)
    slot = torch.cat([slot_t, slot_p], 1)
    s_t = _rows_of(rep, p_t).gather(2, slot_t[:, :, None])[:, :, 0].long()
    s_ = torch.cat([s_t, s_i], 1)
    # finish_pool
    t = torch.cat([torch.arange(B, device=dev)[None, :].expand(K, B), t_i], 1)
    w_p = weights.gather(1, p)
    w_k = torch.where(
        slot == 0,
        w_p * (nrep_cur.gather(1, p).to(weights.dtype)
               + cols[..., 3].gather(1, p)),
        w_p,
    )
    return su[:, None] + vals_raw, p, slot, s_, t, w_k, avg, su


def _prefix_accept_k(
    vals: Tensor, p: Tensor, s_: Tensor, t: Tensor, w_k: Tensor,
    loads: Tensor, avg: Tensor, su: Tensor, mu: Tensor, churn_gate: Tensor,
    n: Tensor, batch: int, budget: Tensor, max_moves: int,
    topic: Optional[Tensor] = None, colo_d: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """:func:`prefix_accept` of each of ``K`` instances (candidates ``[K,
    N]``, ``loads [K, B]``; ``avg``, ``su``, ``mu``, ``n`` and ``budget``
    ``[K]``; ``topic`` and ``colo_d`` ``[K, N]`` on the colocation
    objective): no reduction crosses the instance axis. Returns ``(ok,
    pos)``."""
    dtype = loads.dtype
    N = vals.shape[1]
    kk = torch.arange(N, device=vals.device)
    su_ = su[:, None]
    improving = (
        torch.isfinite(vals) & (vals < (su - mu)[:, None]) & (vals < su_)
    )
    best_gain = su - vals.amin(1)
    improving &= (su_ - vals) * churn_gate >= best_gain[:, None]

    E = (vals[:, :, None] < vals[:, None, :]) | (
        (vals[:, :, None] == vals[:, None, :]) & (kk[:, None] < kk[None, :])
    )
    claimed = E & improving[:, :, None] & (p[:, :, None] == p[:, None, :])
    if topic is not None:
        # (topic, broker) first-claim: keeps each ±λ constant exact
        bshare = (
            (s_[:, :, None] == s_[:, None, :])
            | (s_[:, :, None] == t[:, None, :])
            | (t[:, :, None] == s_[:, None, :])
            | (t[:, :, None] == t[:, None, :])
        )
        claimed |= (
            E & improving[:, :, None]
            & (topic[:, :, None] == topic[:, None, :]) & bshare
        )
    surv = improving & ~claimed.any(1)

    Ej = (E & surv[:, :, None]).to(dtype)
    wEj = Ej * w_k[:, :, None]
    to_s = (t[:, :, None] == s_[:, None, :]).to(dtype) - (
        s_[:, :, None] == s_[:, None, :]
    ).to(dtype)
    to_t = (t[:, :, None] == t[:, None, :]).to(dtype) - (
        s_[:, :, None] == t[:, None, :]
    ).to(dtype)
    Ls = loads.gather(1, s_) + ordered_sum(wEj * to_s, 1)
    Lt = loads.gather(1, t) + ordered_sum(wEj * to_t, 1)
    a = avg[:, None]
    d_k = (
        overload_penalty(Ls - w_k, a)
        - overload_penalty(Ls, a)
        + overload_penalty(Lt + w_k, a)
        - overload_penalty(Lt, a)
    )
    if colo_d is not None:
        d_k = d_k + colo_d
    ok = surv & (d_k < -mu[:, None]) & (d_k < 0)
    ok &= ~(E & (surv & ~ok)[:, :, None]).any(1)
    pos = n[:, None] + (E & ok[:, :, None]).sum(1)
    ok &= (
        (pos < n[:, None] + batch) & (pos < budget[:, None]) & (pos < max_moves)
    )
    return ok, pos


def _single_move_k(
    loads: Tensor, rep: Tensor, mem: Tensor, allowed: Optional[Tensor],
    bvalid: Tensor, nb: Tensor, weights: Tensor, nrep_cur: Tensor,
    nrep_tgt: Tensor, pvalid: Tensor, universe_valid: Tensor,
    minrep: Tensor, mu: Tensor, *, allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """:func:`single_move` of each of ``K`` instances (every input with a
    leading instance axis; ``nb``, ``minrep`` and ``mu`` ``[K]``): each
    instance's ``[P, R, B]`` candidate scores term for term, its targets
    ranked with :func:`~kafkabalancer_tpu_torch.ops.cost.rank_brokers`'
    stable sort, and its first flat argmin. Returns ``(accept, p, slot,
    s_dense, t_dense)``, each ``[K]``."""
    K, P, R = rep.shape
    B = loads.shape[1]
    dev = loads.device
    inf = float("inf")
    # rank_brokers per instance: (load, index) order, padded brokers last
    sort_load = torch.where(bvalid, loads, torch.full_like(loads, inf))
    perm = torch.sort(sort_load, dim=1, stable=True).indices
    rank_of = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(B, device=dev)[None, :].expand(K, B)
    )
    alw = (universe_valid[:, None, :].expand(K, P, B) if allowed is None
           else allowed)
    perm_p = perm[:, None, :].expand(K, P, B)
    bvalid_rank = bvalid.gather(1, perm)
    # move_candidate_scores per instance
    loads_rank = loads.gather(1, perm)
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero), 1) / nb
    F = torch.where(bvalid_rank, overload_penalty(loads_rank, avg[:, None]),
                    zero)
    su = ordered_sum(F, 1)
    a3 = avg[:, None, None]
    w = weights[:, :, None]  # [K, P, 1]
    s = rep.clamp(min=0).long()  # [K, P, R]
    F_s = _at(F, _at(rank_of, s))
    f_s_new = overload_penalty(_at(loads, s) - w, a3)
    f_t_new = overload_penalty(loads_rank[:, None, :] + w, a3)
    u = (
        su[:, None, None, None]
        - F_s[..., None]
        - F[:, None, None, :]
        + f_s_new[..., None]
        + f_t_new[:, :, None, :]
    )  # [K, P, R, B]
    slot_iota = torch.arange(R, device=dev)
    srcmask = (
        (slot_iota[None, None, :] < nrep_cur[:, :, None])
        & pvalid[:, :, None]
        & (nrep_tgt >= minrep[:, None])[:, :, None]
    )
    tmask = (
        alw.gather(2, perm_p) & ~mem.gather(2, perm_p) & bvalid_rank[:, None, :]
    )
    u = torch.where(
        srcmask[..., None] & tmask[:, :, None, :], u, torch.full_like(u, inf)
    )

    def best(mask_slots: Tensor) -> Tuple[Tensor, Tensor]:
        flat = torch.where(
            mask_slots[None, None, :, None], u, torch.full_like(u, inf)
        ).reshape(K, -1)
        i = flat.argmin(1)
        return flat.gather(1, i[:, None])[:, 0], i

    fol_u, fol_i = best(slot_iota >= 1)
    accept = (fol_u < su - mu) & (fol_u < su)
    chosen = fol_i
    if allow_leader:
        lead_u, lead_i = best(slot_iota == 0)
        accept_lead = (lead_u < su - mu) & (lead_u < su)
        chosen = torch.where(accept_lead, lead_i, fol_i)
        accept = accept | accept_lead
    p, rem = chosen // (R * B), chosen % (R * B)
    slot, t_rank = rem // B, rem % B
    s_dense = _at(rep, p * R + slot).long()
    return accept, p, slot, s_dense, perm.gather(1, t_rank[:, None])[:, 0]


def _on_device(values: List[Any], dt: Any, dev: torch.device) -> Tensor:
    """``values`` as a ``[K]`` tensor filled on the device (no copy from
    the host, no sync); each value rounded to ``dt`` as
    :func:`~kafkabalancer_tpu_torch.ops.cost.scalar` rounds it."""
    return torch.stack(
        [torch.full((), v, dtype=dt, device=dev) for v in values]
    )


# device-loop: the K sessions' shared host loop, one designed read per iteration
def _moves_batched(
    loads: Tensor,
    replicas: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_replicas: List[int],
    min_unbalance: List[float],
    budget: List[int],
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    topic_id: Optional[Tensor] = None,
    lam: Optional[List[float]] = None,
    n_topics: int = 0,
) -> Tuple[Any, ...]:
    """:func:`session_batched`'s loop. Returns ``(replicas, loads, log,
    n, iterations, seconds)``: the final ``[K, P, R]`` assignments and
    ``[K, B]`` loads, the ``[K, 4, max_moves + 1]`` move logs (rows p |
    slot | src | tgt, int64, a trash column at ``max_moves``) and the
    per-instance lists."""
    if n_topics and batch <= 1:
        raise ValueError(
            "the anti-colocation session requires batch > 1 "
            "(the pooled batched selection)"
        )
    K, P, R = replicas.shape
    B = loads.shape[1]
    dtype = loads.dtype
    dev = loads.device
    score = shard_score_batched if scorer is None else scorer
    mu = _on_device(list(min_unbalance), dtype, dev)
    minrep = _on_device(list(min_replicas), dtype, dev)
    cg = torch.full((), DEFAULT_CHURN_GATE, dtype=dtype, device=dev)
    budgets = list(budget)
    budget_t = _on_device(budgets, torch.long, dev)
    inst = torch.arange(K, device=dev)[:, None]

    # session state, updated in place; one trash element past the end of
    # the flattened loads, replicas and membership takes every rejected
    # write
    loads_buf = torch.cat([loads.reshape(-1), loads.new_zeros(1)])
    loads = loads_buf[: K * B].view(K, B)
    rep_buf = torch.cat([replicas.reshape(-1), replicas.new_full((1,), -1)])
    rep = rep_buf[: K * P * R].view(K, P, R)
    mem_buf = torch.cat([member.reshape(-1), member.new_zeros(1)])
    mem = mem_buf[: K * P * B].view(K, P, B)
    bcount = (mem & pvalid[:, :, None]).sum(1).to(torch.int32)
    # move logs rows p | slot | src | tgt, trash column at max_moves
    log = torch.full((K, 4, max_moves + 1), -1, dtype=torch.long, device=dev)
    log_row = (inst[:, :, None] * 4 + torch.arange(4, device=dev)[None, :, None]
               ) * (max_moves + 1)
    cols = pack_cols(weights, nrep_cur, nrep_tgt, ncons, pvalid)
    n_dev = torch.zeros(K, dtype=torch.long, device=dev)
    if n_topics:
        # per-instance (topic, broker) replica counts; integer-valued
        # floats, so every summation order gives the same bits
        tid = topic_id.long()
        counts = torch.zeros((K, n_topics, B), dtype=dtype, device=dev)
        scatter_add_(
            counts.view(K * n_topics, B), (tid + inst * n_topics).reshape(-1),
            (member & pvalid[:, :, None]).to(dtype).reshape(K * P, B),
        )
        counts_flat = counts.view(-1)
        lam_t = _on_device(list(lam or [0.0] * K), dtype, dev)
    # which instances still run; the host keeps the same mask
    n = [0] * K
    live = [b > 0 and max_moves > 0 for b in budgets]
    active = budget_t > 0
    iters = [0] * K
    seconds = [0.0] * K

    def commit_rows(ok: Tensor, pos: Tensor, p: Tensor, slot: Tensor,
                    s_: Tensor, t: Tensor) -> None:
        # the accepted moves (``ok [K, N]``) into the move logs at ``pos``,
        # the replicas and the membership; rejected ones write to the
        # trash column and the trash elements
        logpos = torch.where(ok, pos, max_moves)
        entries = torch.stack([p, slot, s_, t], 1)
        log.view(-1).index_put_(
            ((log_row + logpos[:, None, :]).reshape(-1),),
            torch.where(ok[:, None, :], entries, torch.full_like(entries, -1))
            .reshape(-1),
        )
        rep_buf.index_put_(
            (torch.where(ok, inst * (P * R) + p * R + slot, K * P * R)
             .reshape(-1),),
            t.to(rep_buf.dtype).reshape(-1),
        )
        mem_buf.index_fill_(
            0, torch.where(ok, inst * (P * B) + p * B + s_, K * P * B)
            .reshape(-1), False,
        )
        mem_buf.index_fill_(
            0, torch.where(ok, inst * (P * B) + p * B + t, K * P * B)
            .reshape(-1), True,
        )

    def step_batch(bvalid: Tensor, nb: Tensor) -> Tensor:  # device-loop: one batched iteration of the K sessions
        colo = {}
        if n_topics:
            colo = dict(c_rows=_rows_of(counts, tid), lam=lam_t)
        vals, p, slot, s_, t, w_k, avg, su = _batch_pool_k(
            loads, bvalid, nb, rep, mem, allowed, cols, minrep, score,
            allow_leader=allow_leader, **colo,
        )
        tid_k = colo_d = None
        if n_topics:
            # each candidate's colocation delta from the pass-start
            # counts; the (topic, broker) claims keep it exact
            tid_k = tid.gather(1, p)
            cell = (inst * n_topics + tid_k) * B
            sub_s, _ = colo_terms(counts_flat[cell + s_], lam_t[:, None])
            _, add_t = colo_terms(counts_flat[cell + t], lam_t[:, None])
            colo_d = add_t - sub_s
        ok, pos = _prefix_accept_k(
            vals, p, s_, t, w_k, loads, avg, su, mu, cg, n_dev, batch,
            budget_t, max_moves, topic=tid_k, colo_d=colo_d,
        )
        ok &= active[:, None]
        # commit; rejected candidates add zeros
        delta = w_k * ok.to(dtype)
        flat_s = (s_ + inst * B).reshape(-1)
        flat_t = (t + inst * B).reshape(-1)
        lf = loads.view(-1)
        scatter_add_(lf, flat_s, -delta.reshape(-1))
        scatter_add_(lf, flat_t, delta.reshape(-1))
        oki = ok.to(torch.int32).reshape(-1)
        bf = bcount.view(-1)
        scatter_add_(bf, flat_s, -oki)
        scatter_add_(bf, flat_t, oki)
        if n_topics:
            okd = ok.to(dtype).reshape(-1)
            scatter_add_(counts_flat, (cell + s_).reshape(-1), -okd)
            scatter_add_(counts_flat, (cell + t).reshape(-1), okd)
        commit_rows(ok, pos, p, slot, s_, t)
        return ok.sum(1)

    def step_single(bvalid: Tensor, nb: Tensor) -> Tensor:  # device-loop: one single-move iteration of the K sessions
        accept, p, slot, s_d, t_d = _single_move_k(
            loads, rep, mem, allowed, bvalid, nb, weights, nrep_cur,
            nrep_tgt, pvalid, universe_valid, minrep, mu,
            allow_leader=allow_leader,
        )
        ok = accept & active
        # commit_single's updates for the accepted instances (the others
        # write to the trash element); the target's load is read after
        # the source's write, as commit_single's in-place updates do
        w_p = weights.gather(1, p[:, None])[:, 0]
        delta = torch.where(
            slot == 0,
            w_p * (nrep_cur.gather(1, p[:, None])[:, 0].to(dtype)
                   + ncons.gather(1, p[:, None])[:, 0]),
            w_p,
        )
        at_s, at_t = inst[:, 0] * B + s_d, inst[:, 0] * B + t_d
        loads_buf.index_put_(
            (torch.where(ok, at_s, K * B),), loads_buf[at_s] - delta
        )
        loads_buf.index_put_(
            (torch.where(ok, at_t, K * B),), loads_buf[at_t] + delta
        )
        oki = ok.to(torch.int32)
        bf = bcount.view(-1)
        scatter_add_(bf, at_s, -oki)
        scatter_add_(bf, at_t, oki)
        commit_rows(ok[:, None], n_dev[:, None], p[:, None], slot[:, None],
                    s_d[:, None], t_d[:, None])
        return ok.long()

    step_of = step_batch if batch > 1 else step_single

    def step() -> Tensor:  # device-loop: one iteration of the K sessions
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        cnt = step_of(bvalid, bvalid.sum(1).to(dtype))
        n_dev.add_(cnt)
        active.logical_and_(
            (cnt > 0) & (n_dev < budget_t) & (n_dev < max_moves)
        )
        return cnt

    t0 = time.perf_counter()
    while any(live):
        # jaxlint: disable=R3 — the designed read: the [K] accepted counts end the iteration
        cnts = step().tolist()
        now = time.perf_counter() - t0
        for k in range(K):
            if not live[k]:
                continue
            iters[k] += 1
            seconds[k] = now
            n[k] += cnts[k]
            live[k] = cnts[k] > 0 and n[k] < budgets[k] and n[k] < max_moves
    return rep, loads, log, n, iters, seconds


def session_batched(
    loads: Tensor,
    replicas: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_replicas: List[int],
    min_unbalance: List[float],
    budget: List[int],
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    topic_id: Optional[Tensor] = None,
    lam: Optional[List[float]] = None,
    n_topics: int = 0,
) -> Tuple[Tensor, List[int], List[float]]:
    """``K`` independent move sessions (:func:`session`) as one: every
    tensor of :func:`session` with a leading instance axis ``[K, ...]``
    (one device, one dtype), and each instance's ``min_replicas``,
    ``min_unbalance`` and move ``budget`` in a list.

    One host loop runs them together, with one read of the ``[K]``
    accepted counts per iteration. At ``batch > 1`` each iteration makes
    one launch of the batched scoring kernel (``shard_score_batched``;
    ``scorer`` replaces it, e.g. with ``shard_score_batched_plain``); at
    ``batch == 1`` each instance takes :func:`single_move`'s best move
    (:func:`_single_move_k`; no kernel, as in the solo session).
    ``n_topics > 0`` (with ``topic_id [K, P]`` and one ``lam`` per
    instance in a list) runs the anti-colocation session: per-instance
    ``[K, n_topics, B]`` counts, the kernel's colocation variant over the
    instance axis and each instance's (topic, broker) claims. λ is a
    value, not part of the signature: instances that differ only in λ
    run together.

    An instance that has stopped (a count of 0, or its budget reached)
    commits nothing more: its acceptance mask is cleared on the device
    while the loop runs on for the others. Every float reduction stays
    within its instance, in :func:`session`'s order, so each instance's
    moves are bit for bit those of a :func:`session` call on it alone.

    Returns ``(packed, iterations, seconds)``: the packed move logs ``[K,
    3 * max_moves + 1]`` in :func:`_run_chunk`'s layout (``move_p |
    move_slot | move_tgt | n``, int32), each instance's iteration count
    (those of its solo session) and the loop's seconds until it stopped.
    The inputs are not modified.
    """
    _rep, _loads, log, n, iters, seconds = _moves_batched(
        loads, replicas, member, allowed, weights, nrep_cur, nrep_tgt, ncons,
        pvalid, always_valid, universe_valid, min_replicas, min_unbalance,
        budget, max_moves=max_moves, allow_leader=allow_leader, batch=batch,
        scorer=scorer, topic_id=topic_id, lam=lam, n_topics=n_topics,
    )
    mp, mslot, _msrc, mtgt = log[:, :, :max_moves].to(torch.int32).unbind(1)
    n_t = _on_device(n, torch.int32, loads.device)[:, None]
    return torch.cat([mp, mslot, mtgt, n_t], 1), iters, seconds


def _cfg_broker_mask(dp: Any, cfg: RebalanceConfig) -> "np.ndarray":
    """Dense mask of the configured always-in-table brokers
    (``cfg.Brokers`` zero-fill, steps.go:150-155)."""
    mask = np.zeros(dp.bvalid.shape[0], dtype=bool)
    for bid in cfg.brokers or []:
        mask[dp.broker_index(bid)] = True
    return mask


# --- the serve batching seam ---------------------------------------------
# A lane of the planning daemon (serve/lanes.py) fuses concurrent
# same-bucket requests into one instance-batched session
# (:func:`session_batched`). The fusion point is here: each member's
# request thread installs its batcher, and _run_chunk offers the batcher
# every chunk — the round boundary continuous batching re-forms the
# batch at. Thread-local, so the stateless CLI and a solo request never
# see it.
_mb_tls = threading.local()


# the offer's layout (:func:`_run_chunk`): the session's tensors —
# loads, replicas, member, allowed, weights, nrep_cur, nrep_tgt, ncons,
# pvalid, always_valid, universe_valid, the polish entry table ew, ep,
# er, evalid and topic_id, None where a mode has none — then the values
# min_replicas, min_unbalance, budget and lam
OFFER_TENSORS = 16


def set_microbatcher(mb: Optional[Any]) -> None:
    """Install (or, with None, clear) THIS thread's batcher — an object
    with ``dispatch(args, statics)`` returning ``(packed move log,
    counters)`` for this caller's chunk (the counters its solo session
    would count, by name), or None to run it solo."""
    _mb_tls.mb = mb


def microbatcher() -> Optional[Any]:
    return getattr(_mb_tls, "mb", None)


def _run_chunk(
    dp: Any,
    cfg: RebalanceConfig,
    chunk: int,
    dtype: Any,
    batch: int,
    device: torch.device,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]],
    engine: str = "xla",
    mode: str = "move",
    lam: float = 0.0,
) -> "np.ndarray":
    """One session over ``dp`` on ``device``; returns the packed move log
    ``[move_p | move_slot | move_tgt | n]`` as one host array.

    ``mode`` ``"move"`` runs the move session: with ``engine`` ``"xla"``
    :func:`session`; ``"pallas"`` the whole-session kernel
    (``solvers/pallas_session.py``, its plain version on CPU tensors);
    ``"pallas-interpret"`` that kernel's plain version on ``device``.
    ``"polish"`` runs the move/swap alternation of ``solvers/polish.py``
    (log length ``2 * max_moves``) and ``"leader"`` the rebalance-leaders
    session of ``solvers/leader.py``. ``lam > 0`` runs the move and
    polish sessions on the anti-colocation objective (``xla`` only).

    A SPECULATIVE daemon run (serve/speculate.py) checks its preemption
    flag here, once per chunk round: real traffic aborts idle plan-ahead
    work before the next chunk reaches the device. A thread with a
    batcher (:func:`set_microbatcher`) then offers the chunk — its
    device tensors, its scalars and its signature — for a fused run; a
    declined offer runs solo."""
    from kafkabalancer_tpu_torch.serve.speculate import maybe_abort_dispatch

    maybe_abort_dispatch()
    all_allowed = all_allowed_of(dp)
    d = to_device(dp, device, dtype, all_allowed=all_allowed)
    B = dp.bvalid.shape[0]
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    max_moves = next_bucket(chunk, 128)
    always = torch.from_numpy(_cfg_broker_mask(dp, cfg)).to(device)
    common = (
        d.weights, d.nrep_cur, d.nrep_tgt, d.ncons, d.pvalid, always,
        d.bvalid, cfg.min_replicas_for_rebalancing, cfg.min_unbalance, chunk,
    )
    colo = {}
    if lam:
        # the topic-count bucket: counts rows past the real count stay 0
        colo = dict(
            topic_id=torch.from_numpy(dp.topic_id).to(device, torch.long),
            lam=lam, n_topics=next_bucket(max(1, len(dp.topics)), 64),
        )
    entries: Tuple[Optional[Tensor], ...] = (None,) * 4
    if mode == "polish":
        from kafkabalancer_tpu_torch.solvers.polish import entry_table

        ew, ep, er, evalid = entry_table(dp, cfg.min_replicas_for_rebalancing)
        entries = (
            torch.from_numpy(ew).to(device, dtype),
            torch.from_numpy(ep).to(device, torch.long),
            torch.from_numpy(er).to(device, torch.long),
            torch.from_numpy(evalid).to(device),
        )
    obs.metrics.count("solver.chunks")
    mb = microbatcher()
    if mb is not None:
        # the offer: the session's tensors (OFFER_TENSORS of them, None
        # where a mode has none), then its per-instance values
        fused = mb.dispatch(
            (loads, d.replicas, d.member, d.allowed, *common[:7], *entries,
             colo.get("topic_id"), *common[7:], lam),
            dict(
                P=dp.replicas.shape[0], B=B, R=dp.replicas.shape[1],
                dtype=str(dtype), all_allowed=all_allowed,
                max_moves=max_moves,
                allow_leader=cfg.allow_leader_rebalancing,
                batch=max(1, batch), mode=mode, engine=engine,
                n_topics=colo.get("n_topics", 0), device=str(device),
                scorer=scorer is not None,
            ),
        )
        if fused is not None:
            packed, counts = fused
            obs.metrics.count("solver.microbatched_chunks")
            # this request's own counters: its iterations and phases in
            # the fused loop are those of its solo session
            for name, value in counts.items():
                obs.metrics.count(name, value)
            return packed
    with obs.span(
        "solver.dispatch_chunk", max_moves=max_moves, batch=batch,
        engine=engine, mode=mode,
    ):
        if mode == "polish":
            from kafkabalancer_tpu_torch.solvers.polish import converge_session

            packed = converge_session(
                loads, d.replicas, d.allowed, *common, *entries,
                max_moves=max_moves, allow_leader=cfg.allow_leader_rebalancing,
                batch=max(1, batch), engine=engine, all_allowed=all_allowed,
                scorer=scorer, **colo,
            )
            return packed.cpu().numpy()
        if mode == "leader":
            from kafkabalancer_tpu_torch.solvers.leader import leader_session

            _rep, _loads, n, mp, mslot, mtgt = leader_session(
                loads, d.replicas, d.member, d.allowed, *common,
                max_moves=max_moves, allow_leader=cfg.allow_leader_rebalancing,
                batch=max(1, batch),
            )
        elif engine == "xla":
            _rep, _loads, n, mp, mslot, _msrc, mtgt, _su = session(
                loads, d.replicas, d.member, d.allowed, *common,
                max_moves=max_moves,
                allow_leader=cfg.allow_leader_rebalancing, batch=max(1, batch),
                scorer=scorer, **colo,
            )
        else:
            from kafkabalancer_tpu_torch.solvers.pallas_session import (
                pallas_session,
                pallas_session_plain,
            )

            run = (
                pallas_session_plain if engine == "pallas-interpret"
                else pallas_session
            )
            _rep, _loads, n, mp, mslot, _msrc, mtgt = run(
                loads, d.replicas, None, d.allowed, *common,
                max(1, batch), DEFAULT_CHURN_GATE, max_moves=max_moves,
                allow_leader=cfg.allow_leader_rebalancing,
                all_allowed=all_allowed,
            )
        n_t = torch.tensor([n], dtype=torch.int32, device=mp.device)
        return torch.cat([mp, mslot, mtgt, n_t]).cpu().numpy()


def _superseded_mask(mp: Any, mslot: Any) -> "np.ndarray":
    """``keep`` mask collapsing consecutive same-slot runs per partition.

    A batched session can re-move a (partition, slot) cell a later
    iteration overwrites; each emitted entry is real Kafka data movement
    (kafkabalancer.go:177-221), so the intermediate write is pure churn.
    Dropping is exact only within a consecutive run of moves on the same
    (partition, slot): nothing reads the partition's state in between.
    Leadership exchanges (slot == ``leader.SWAP_SLOT``) read positions
    through ``replicas.index``: they are never dropped and break runs.
    """
    n = len(mp)
    keep = np.ones(n, dtype=bool)
    last_by_p: dict = {}
    for i in range(n):
        p, s = int(mp[i]), int(mslot[i])
        prev = last_by_p.get(p)
        if prev is not None and s >= 0 and prev[1] == s:
            keep[prev[0]] = False
        last_by_p[p] = (i, s)
    return keep


def _decode_packed(
    packed: "np.ndarray", dp: Any, opl: PartitionList,
    drop_superseded: bool = False,
) -> int:
    """Replay a packed ``[move_p | move_slot | move_tgt | n]`` move log
    onto the live partitions, appending each to ``opl`` in move order
    (the CLI main-loop output contract, kafkabalancer.go:177-221).

    A slot of ``leader.SWAP_SLOT`` is a leadership exchange (``replacepl``
    swap branch, utils.go:181-188): the target broker, already a
    follower, trades positions with the leader. Returns the move count
    CONSUMED from the session budget (the raw commit count, even when
    ``drop_superseded`` elides emissions)."""
    from kafkabalancer_tpu_torch.solvers.leader import SWAP_SLOT

    n = int(packed[-1])
    ml = (packed.shape[0] - 1) // 3
    mp = packed[:n]
    mslot = packed[ml : ml + n]
    mtgt = packed[2 * ml : 2 * ml + n]
    keep = _superseded_mask(mp, mslot) if drop_superseded else None
    rec = convergence.recorder()  # -explain provenance (thread-local)
    tap = convergence.mutation_tap()  # a resident session's raw-row shadow
    emitted = 0
    for i in range(n):
        part = dp.partitions[int(mp[i])]
        slot = int(mslot[i])
        tgt = int(dp.broker_ids[int(mtgt[i])])
        if keep is not None and not keep[i]:
            continue
        if keep is not None and slot >= 0 and part.replicas[slot] == tgt:
            # a collapsed run whose final write restores the original
            # broker is a net no-op
            continue
        old = list(part.replicas) if rec is not None else None
        if slot == SWAP_SLOT:
            j = part.replicas.index(tgt)
            part.replicas[j] = part.replicas[0]
            part.replicas[0] = tgt
        else:
            part.replicas[slot] = tgt
        if rec is not None:
            # O(1) append; the trajectory replay happens at finalize,
            # outside the planning wall
            rec.record_change(part, old, list(part.replicas), "session")
        if tap is not None:
            tap.change(part)
        opl.append(part)
        emitted += 1
    obs.metrics.count("solver.moves_committed", n)
    obs.metrics.count("solver.moves_emitted", emitted)
    return n


def _repairs_possible(pl: PartitionList, cfg: RebalanceConfig) -> bool:
    """Cheap O(P·R) prescreen: can any repair step (remove-extra,
    add-missing, move-disallowed — steps.go:70-143) fire at all?"""
    full_ok: dict = {}
    for p in pl.iter_partitions():
        if p.num_replicas != len(p.replicas):
            return True
        key = id(p.brokers)
        bset = full_ok.get(key)
        if bset is None:
            bset = full_ok[key] = set(p.brokers)
        if not bset.issuperset(p.replicas):
            return True
    return False


def _settle_head(
    pl: PartitionList,
    cfg: RebalanceConfig,
    budget: int,
    include_reassign_leaders: bool = True,
) -> Tuple[List[Partition], int]:
    """Run the pipeline head (validations, defaults, repairs) until no step
    fires, applying each repair like the CLI loop does. Returns the applied
    live partitions (each counts against the reassignment budget).

    ``include_reassign_leaders=False`` settles only the repair steps that
    precede ``ReassignLeaders`` in the pipeline order: the fused leader
    session (``solvers/leader.py``) replays that step on the device, and
    repairs strictly precede it (balancer.go:34-44)."""
    from kafkabalancer_tpu_torch.balancer.pipeline import _HEAD_VALIDATE
    from kafkabalancer_tpu_torch.cli import apply_assignment

    # validations + defaults always run once (exact error behavior);
    # the repair loop is skipped entirely when no repair can fire
    for _name, step in _HEAD_VALIDATE:
        step(pl, cfg)
    leaders_live = include_reassign_leaders and cfg.rebalance_leaders
    if not leaders_live and not _repairs_possible(pl, cfg):
        return [], budget

    head = (
        _COMMON_HEAD
        if include_reassign_leaders
        else [s for s in _COMMON_HEAD if s[0] != "ReassignLeaders"]
    )
    out: List[Partition] = []
    while budget > 0:
        fired = None
        for _name, step in head:
            fired = step(pl, cfg)
            if fired is not None:
                break
        if fired is None:
            break
        for changed in fired.partitions:
            out.append(apply_assignment(pl, changed))
        budget -= 1
    return out, budget


def plan(
    pl: PartitionList,
    cfg: RebalanceConfig,
    max_reassign: int,
    dtype: Any = None,
    batch: int = 1,
    engine: str = "auto",
    polish: bool = False,
    *,
    chunk_moves: Optional[int] = None,
    device: Any = None,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    anti_colocation: Optional[float] = None,
) -> PartitionList:
    """Full multi-move planning session: host-side repairs, then the
    device session in chunks. The output accumulates live partitions in
    move order exactly like the CLI main loop's ``opl`` (entries reflect
    the final assignment, kafkabalancer.go:177-221); ``pl`` is mutated in
    place like the reference's aliasing does.

    ``device`` defaults to CUDA (and raises without a card); ``dtype``
    defaults per device (``models.config.default_dtype``: float32 on
    CUDA, float64 on the CPU). ``engine`` takes the reference's names:
    ``auto``/``xla`` run :func:`session`; ``pallas`` runs the
    whole-session kernel (``solvers/pallas_session.py``: float32 only,
    the pooled batched selection even at ``batch=1``, one launch per
    chunk), and ``pallas-interpret`` that kernel's plain version on
    ``device``. ``scorer`` is passed to every :func:`session`.

    ``polish=True`` alternates move phases with pair-swap and (with
    ``allow_leader``) leadership-shuffle phases until neither commits
    (``solvers/polish.py``); with a ``pallas`` engine the whole-session
    kernel runs once up front. With ``rebalance_leaders`` the whole
    Balance loop runs as the fused leader session (``solvers/leader.py``;
    ``engine`` and ``polish`` do not apply). ``chunk_moves`` overrides
    the per-session move budget (:func:`auto_chunk_moves`).

    ``anti_colocation=λ > 0`` plans on the combined objective ``u +
    λ·Σ_{topic,broker} max(0, c-1)`` (the objective the beam solver
    searches, ``solvers/beam.py``) in the batched session, the scoring
    kernel's colocation variant in every iteration, and in every polish
    phase with ``polish``. The activation rules are
    :func:`resolve_anti_colocation`'s: it needs ``batch > 1``, excludes
    ``rebalance_leaders`` and runs the ``xla`` engine whatever engine was
    asked for.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    # "auto" resolves before the colocation rules: it is not an explicit
    # kernel request
    engine = resolve_engine(engine)
    lam, engine = resolve_anti_colocation(cfg, anti_colocation, batch, engine)
    opl = empty_partition_list()
    if max_reassign <= 0:
        return opl
    device = resolve_device(device)
    if chunk_moves is None:
        chunk_moves = auto_chunk_moves(len(pl.partitions or []))
    chunk_moves = max(1, min(chunk_moves, 1 << 20))

    if cfg.rebalance_leaders:
        return _leader_plan(
            pl, cfg, max_reassign, dtype, chunk_moves, opl, batch,
            device=device,
        )

    with obs.span("settle"):
        repaired, budget = _settle_head(pl, cfg, max_reassign)
    opl.append(*repaired)
    use_kernel = engine in ("pallas", "pallas-interpret")
    if use_kernel:
        dtype = kernel_dtype()
    elif dtype is None:
        dtype = default_dtype(device)

    # sessions chunk at ``chunk_moves`` and re-enter with the mutated
    # assignment until converged or exhausted
    remaining = budget
    while remaining > 0:
        with obs.span("tensorize"):
            dp = tensorize(pl, cfg)
        chunk = min(remaining, chunk_moves)
        rec = convergence.recorder()
        if rec is not None:
            # -explain candidate-space statistics, from the dense
            # encoding this round built (one numpy pass, no device sync)
            rec.note_round(dp, cfg, chunk=chunk, engine=engine)
        try:
            packed = _run_chunk(
                dp, cfg, chunk, dtype, batch, device, scorer, engine,
                mode="polish" if polish else "move", lam=lam,
            )
        except (RuntimeError, ValueError) as exc:
            if not use_kernel and device.type != "cuda":
                raise
            # a kernel (the whole-session kernel, or the scoring kernel
            # of the torch session on the card) that does not build,
            # launch or take these shapes is a planning failure (CLI exit
            # 3); nothing falls back
            raise BalanceError(f"{engine} engine failed ({exc})") from exc
        # polish interleaves swap and shuffle phases, and neither the
        # batched mode nor the whole-session kernel (pooled selection at
        # any batch) is the batch=1 parity trajectory: their superseded
        # writes elide
        n = _decode_packed(
            packed, dp, opl, drop_superseded=polish or batch > 1 or use_kernel
        )
        remaining -= n
        if n < chunk:
            break
    _note_session_outcome(opl, remaining)
    return opl


def _leader_plan(
    pl: PartitionList,
    cfg: RebalanceConfig,
    max_reassign: int,
    dtype: Any,
    chunk_moves: int,
    opl: PartitionList,
    batch: int = 1,
    *,
    device: torch.device,
) -> PartitionList:
    """Fused ``rebalance_leaders`` planning: host repairs (strictly before
    ReassignLeaders in the pipeline order), then the device Balance loop
    of ``solvers/leader.py``, chunked and decoded like the move sessions.
    ``batch > 1`` selects the batched-transfer extension; ``batch=1``
    replays the reference trajectory."""
    with obs.span("settle"):
        repaired, budget = _settle_head(
            pl, cfg, max_reassign, include_reassign_leaders=False
        )
    opl.append(*repaired)
    if dtype is None:
        dtype = default_dtype(device)

    remaining = budget
    while remaining > 0:
        with obs.span("tensorize"):
            dp = tensorize(pl, cfg)
        chunk = min(remaining, chunk_moves)
        rec = convergence.recorder()
        if rec is not None:
            rec.note_round(dp, cfg, chunk=chunk, engine="leader")
        packed = _run_chunk(
            dp, cfg, chunk, dtype, batch, device, None, mode="leader"
        )
        n = _decode_packed(packed, dp, opl, drop_superseded=batch > 1)
        remaining -= n
        if n < chunk:
            break
    _note_leader_outcome(pl, cfg, opl, remaining)
    return opl


def _note_leader_outcome(
    pl: PartitionList, cfg: RebalanceConfig, opl: PartitionList,
    remaining: int,
) -> None:
    """Outcome note for the fused leader session (the reference's
    ``distributeLeaders`` gate, steps.go:249-253: it bails outright when
    the total unbalance is below ``min_unbalance``)."""
    if opl.partitions:
        convergence.note_outcome(
            "budget_exhausted" if remaining <= 0 else "converged"
        )
        return
    from kafkabalancer_tpu_torch.balancer.costmodel import (
        get_bl,
        get_broker_load,
        get_unbalance_bl,
    )

    loads = get_broker_load(pl)
    for bid in cfg.brokers or []:
        if bid not in loads:
            loads[bid] = 0.0
    su = get_unbalance_bl(get_bl(loads))
    if su != su:  # NaN objective (all-zero loads): Go's no-candidate exit
        convergence.note_outcome("already_balanced", unbalance=su)
    elif su < cfg.min_unbalance:
        convergence.note_outcome(
            "below_threshold", unbalance=su, min_unbalance=cfg.min_unbalance,
        )
    else:
        convergence.note_outcome("no_feasible_candidate", unbalance=su)


def _note_session_outcome(opl: PartitionList, remaining: int) -> None:
    """Record WHY the session stopped (the convergence outcome slot)."""
    if not opl.partitions:
        convergence.note_outcome("converged", classify_pending=True)
    elif remaining <= 0:
        convergence.note_outcome("budget_exhausted")
    else:
        convergence.note_outcome("converged")
