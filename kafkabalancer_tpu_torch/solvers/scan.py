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
and is updated in place.

``plan`` wraps the session like the reference's: host repairs first,
then chunked sessions that re-encode the live assignment between chunks,
then the move log is replayed onto the partition objects.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.balancer.pipeline import _COMMON_HEAD
from kafkabalancer_tpu_torch.balancer.steps import BalanceError
from kafkabalancer_tpu_torch.models import Partition, PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import ENGINES, default_dtype
from kafkabalancer_tpu_torch.models.partition import empty_partition_list
from kafkabalancer_tpu_torch.obs import convergence
from kafkabalancer_tpu_torch.ops.cost import (
    broker_loads,
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
from kafkabalancer_tpu_torch.parallel.shard_kernel import pack_cols, shard_score

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
    ok = surv & (d_k < -min_unbalance) & (d_k < 0)
    # cut at the first survivor whose sequential delta fails — nets for
    # later candidates would assume commits that never happen
    ok &= ~(E & (surv & ~ok)[:, None]).any(0)
    # cap at the batch width and the remaining budget, best-first
    pos = n + (E & ok[:, None]).sum(0)
    ok &= (pos < n + batch) & (pos < budget) & (pos < max_moves)
    return ok, pos, ok.sum()


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

    slot_iota = torch.arange(R, device=dev)[None, :]
    iota_b = torch.arange(B, device=dev)

    def table() -> Tuple[Tensor, Tensor]:
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        return bvalid, bvalid.sum().to(dtype)

    def applied_delta(p: Tensor, slot: Tensor) -> Tensor:
        # applied load delta: the leader premium travels with slot 0
        # (utils.go:96-101)
        return torch.where(
            slot == 0, weights[p] * (nrep_cur[p].to(dtype) + ncons[p]),
            weights[p],
        )

    cols = pack_cols(weights, nrep_cur, nrep_tgt, ncons, pvalid)
    minrep = scalar(min_replicas, dtype, dev)
    zero = torch.zeros_like(minrep)

    def step_batch(n: int) -> int:
        bvalid, nb = table()
        avg = ordered_sum(torch.where(bvalid, loads, torch.zeros_like(loads))) / nb
        F = torch.where(
            bvalid, overload_penalty(loads, avg), torch.zeros_like(loads)
        )
        su = ordered_sum(F)
        s_i, t_i, live = pair_frame(loads, bvalid)
        vf, pf, vl, pl_, vpf, ppf, vpl, ppl = score(
            rep, cols, mem, allowed, loads, F, bvalid,
            torch.stack([avg, minrep, zero]), s_i.to(torch.int32),
            t_i.to(torch.int32), live, allow_leader=allow_leader,
        )
        pf = pf.long()
        # follower slot recovery for the [B] winners only, ascending-slot
        # ties (cost.factored_target_best's slot_of)
        rowsA = (
            overload_penalty(loads[None, :] - weights[pf][:, None], avg)
            - F[None, :]
        )  # [B, B]
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

        # the union pool, K = B + B//2 candidates: per-target winners keep
        # the exact termination criterion, pair winners supply distinct
        # partitions, sources and targets
        vals = torch.cat([su + vals_t, su + vals_p])
        p = torch.cat([p_t, p_p])
        slot = torch.cat([slot_t, slot_p])
        s_ = torch.cat([rep[p_t, slot_t].long(), s_i])
        t = torch.cat([iota_b, t_i])
        w_k = applied_delta(p, slot)
        ok, pos, cnt = prefix_accept(
            vals, p, s_, t, w_k, loads, avg, su, mu, cg, n, batch, budget,
            max_moves,
        )

        # commit; rejected candidates add zeros and write to the trash
        delta = w_k * ok.to(dtype)
        scatter_add_(loads, s_, -delta)
        scatter_add_(loads, t, delta)
        oki = ok.to(torch.int32)
        scatter_add_(bcount, s_, -oki)
        scatter_add_(bcount, t, oki)
        rep_buf[torch.where(ok, p * R + slot, P * R)] = t.to(rep_buf.dtype)
        mem_buf[torch.where(ok, p * B + s_, P * B)] = False
        mem_buf[torch.where(ok, p * B + t, P * B)] = True
        logpos = torch.where(ok, pos, max_moves)
        log[:, logpos] = torch.where(
            ok, torch.stack([p, slot, s_, t]), torch.full_like(log[:, :1], -1)
        )
        return int(cnt)

    def step_single(n: int) -> int:
        bvalid, nb = table()
        # (load, ID) target ordering for reference-style tie-breaks
        _, perm, rank_of = rank_brokers(loads, bvalid)
        alw = universe_valid[None, :].expand(P, B) if allowed is None else allowed
        u, su = move_candidate_scores(
            loads, rep, alw[:, perm], mem[:, perm], bvalid, bvalid[perm],
            perm, rank_of, weights, nrep_cur, nrep_tgt, pvalid, nb,
            min_replicas,
        )

        def best(mask_slots: Tensor) -> Tuple[Tensor, Tensor]:
            flat = torch.where(
                mask_slots[None, :, None], u, torch.full_like(u, inf)
            ).reshape(-1)
            i = flat.argmin()
            return flat[i], i

        fol_u, fol_i = best(slot_iota[0] >= 1)
        accept = (fol_u < su - mu) & (fol_u < su)
        chosen = fol_i
        if allow_leader:
            # MoveLeaders before MoveNonLeaders (balancer.go:42-43)
            lead_u, lead_i = best(slot_iota[0] == 0)
            accept_lead = (lead_u < su - mu) & (lead_u < su)
            chosen = torch.where(accept_lead, lead_i, fol_i)
            accept = accept | accept_lead
        if not bool(accept):
            return 0
        p, rem = chosen // (R * B), chosen % (R * B)
        slot, t_rank = rem // B, rem % B
        t_dense = perm[t_rank]
        s_dense = rep[p, slot].long()
        delta = applied_delta(p, slot)
        loads[s_dense] -= delta
        loads[t_dense] += delta
        rep[p, slot] = t_dense.to(rep.dtype)
        mem[p, s_dense] = False
        mem[p, t_dense] = True
        bcount[s_dense] -= 1
        bcount[t_dense] += 1
        log[:, n] = torch.stack([p, slot, s_dense, t_dense])
        return 1

    step = step_batch if batch > 1 else step_single
    n = 0
    iters = 0
    t0 = time.perf_counter()
    while n < budget and n < max_moves:
        cnt = step(n)  # reads the accepted count back: one sync per step
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


def _cfg_broker_mask(dp: Any, cfg: RebalanceConfig) -> "np.ndarray":
    """Dense mask of the configured always-in-table brokers
    (``cfg.Brokers`` zero-fill, steps.go:150-155)."""
    mask = np.zeros(dp.bvalid.shape[0], dtype=bool)
    for bid in cfg.brokers or []:
        mask[dp.broker_index(bid)] = True
    return mask


def _run_chunk(
    dp: Any,
    cfg: RebalanceConfig,
    chunk: int,
    dtype: Any,
    batch: int,
    device: torch.device,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]],
) -> "np.ndarray":
    """One session over ``dp`` on ``device``; returns the packed move log
    ``[move_p | move_slot | move_tgt | n]`` as one host array."""
    all_allowed = all_allowed_of(dp)
    d = to_device(dp, device, dtype, all_allowed=all_allowed)
    B = dp.bvalid.shape[0]
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    max_moves = next_bucket(chunk, 128)
    obs.metrics.count("solver.chunks")
    with obs.span("solver.dispatch_chunk", max_moves=max_moves, batch=batch):
        _rep, _loads, n, mp, mslot, _msrc, mtgt, _su = session(
            loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
            d.nrep_tgt, d.ncons, d.pvalid,
            torch.from_numpy(_cfg_broker_mask(dp, cfg)).to(device), d.bvalid,
            cfg.min_replicas_for_rebalancing, cfg.min_unbalance, chunk,
            max_moves=max_moves,
            allow_leader=cfg.allow_leader_rebalancing, batch=max(1, batch),
            scorer=scorer,
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
    Returns the move count CONSUMED from the session budget (the raw
    commit count, even when ``drop_superseded`` elides emissions)."""
    n = int(packed[-1])
    ml = (packed.shape[0] - 1) // 3
    mp = packed[:n]
    mslot = packed[ml : ml + n]
    mtgt = packed[2 * ml : 2 * ml + n]
    keep = _superseded_mask(mp, mslot) if drop_superseded else None
    emitted = 0
    for i in range(n):
        part = dp.partitions[int(mp[i])]
        slot = int(mslot[i])
        tgt = int(dp.broker_ids[int(mtgt[i])])
        if keep is not None and not keep[i]:
            continue
        if keep is not None and part.replicas[slot] == tgt:
            # a collapsed run whose final write restores the original
            # broker is a net no-op
            continue
        part.replicas[slot] = tgt
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
    pl: PartitionList, cfg: RebalanceConfig, budget: int
) -> Tuple[List[Partition], int]:
    """Run the pipeline head (validations, defaults, repairs) until no step
    fires, applying each repair like the CLI loop does. Returns the applied
    live partitions (each counts against the reassignment budget)."""
    from kafkabalancer_tpu_torch.balancer.pipeline import _HEAD_VALIDATE
    from kafkabalancer_tpu_torch.cli import apply_assignment

    # validations + defaults always run once (exact error behavior);
    # the repair loop is skipped entirely when no repair can fire
    for _name, step in _HEAD_VALIDATE:
        step(pl, cfg)
    if not cfg.rebalance_leaders and not _repairs_possible(pl, cfg):
        return [], budget

    out: List[Partition] = []
    while budget > 0:
        fired = None
        for _name, step in _COMMON_HEAD:
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
    *,
    device: Any = None,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
) -> PartitionList:
    """Full multi-move planning session: host-side repairs, then the
    device session in chunks. The output accumulates live partitions in
    move order exactly like the CLI main loop's ``opl`` (entries reflect
    the final assignment, kafkabalancer.go:177-221); ``pl`` is mutated in
    place like the reference's aliasing does.

    ``device`` defaults to CUDA (and raises without a card); ``dtype``
    defaults per device (``models.config.default_dtype``: float32 on
    CUDA, float64 on the CPU). ``engine`` takes the reference's names:
    ``auto``/``xla`` run this session; the whole-session kernel
    (``pallas``) is not ported yet. ``scorer`` is passed to
    :func:`session`.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    engine = resolve_engine(engine)
    opl = empty_partition_list()
    if max_reassign <= 0:
        return opl
    if engine != "xla":
        raise BalanceError(
            f"engine {engine!r} (the whole-session kernel) is not yet ported"
        )
    if cfg.rebalance_leaders:
        raise BalanceError(
            "the fused leader session (rebalance_leaders) is not yet ported"
        )
    if cfg.anti_colocation and batch > 1:
        raise BalanceError("the anti-colocation session is not yet ported")
    device = resolve_device(device)
    chunk_moves = auto_chunk_moves(len(pl.partitions or []))

    with obs.span("settle"):
        repaired, budget = _settle_head(pl, cfg, max_reassign)
    opl.append(*repaired)
    if dtype is None:
        dtype = default_dtype(device)

    # sessions chunk at ``chunk_moves`` and re-enter with the mutated
    # assignment until converged or exhausted
    remaining = budget
    while remaining > 0:
        with obs.span("tensorize"):
            dp = tensorize(pl, cfg)
        chunk = min(remaining, chunk_moves)
        packed = _run_chunk(dp, cfg, chunk, dtype, batch, device, scorer)
        # the batched mode is not the batch=1 parity trajectory, so its
        # superseded writes elide
        n = _decode_packed(packed, dp, opl, drop_superseded=batch > 1)
        remaining -= n
        if n < chunk:
            break
    _note_session_outcome(opl, remaining)
    return opl


def _note_session_outcome(opl: PartitionList, remaining: int) -> None:
    """Record WHY the session stopped (the convergence outcome slot)."""
    if not opl.partitions:
        convergence.note_outcome("converged", classify_pending=True)
    elif remaining <= 0:
        convergence.note_outcome("budget_exhausted")
    else:
        convergence.note_outcome("converged")
