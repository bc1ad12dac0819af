"""Beam search over move sequences (``-solver=beam``).

Counterpart of the reference package's ``solvers/beam.py``. The upstream
project lists "N-way swaps" and a same-topic anti-colocation objective as
planned but never built (README.md:94-100); the beam solver ships both:
a width-W beam explores D-move lookahead sequences on the device, so
compound rebalances a single greedy move cannot see (an uphill move that
unlocks a large improvement, a 2-way swap expressed as two moves) are
found and applied together.

- The objective is the reference unbalance (utils.go:119-147) plus, with
  ``cfg.anti_colocation > 0``, ``λ·Σ_{topic,broker} max(0, c-1)``, where
  ``c`` counts same-topic replicas sharing a broker.
- Each depth expands every live beam through the factorized per-target
  scorer (``ops/cost.factored_target_best``; with ``beam_siblings`` its
  second best per target too), and the W best of the frontier survive.
  Sequences may go uphill; acceptance is per sequence: the best state
  seen at any depth must beat the start by ``min_unbalance``.
- Leader moves are candidates whenever ``allow_leader_rebalancing`` is
  set and score with their true applied delta ``w·(replicas+consumers)``.
- Each beam's state (loads, replicas, membership, per-broker replica
  counts, per-(topic, broker) counts and the colocation total) is
  updated per applied move, never rebuilt.

The W beams are a leading batch dimension of the state; the scorer runs
once per live beam, so every reduction of a beam is exactly one call's
(``ordered_sum`` per row). The depth loop and the receding-horizon loop
of :func:`beam_session` are Python loops over torch operations.

``beam_plan`` repeats search-and-apply rounds until no sequence improves
or the budget runs out; ``beam_move`` is the pipeline step that emits
the first move of the best sequence.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.models import PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import default_dtype
from kafkabalancer_tpu_torch.models.partition import empty_partition_list
from kafkabalancer_tpu_torch.ops import cost
from kafkabalancer_tpu_torch.ops.cost import scalar
from kafkabalancer_tpu_torch.ops.runtime import next_bucket
from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device
from kafkabalancer_tpu_torch.solvers.scan import (
    _cfg_broker_mask,
    _settle_head,
    resolve_device,
)

Tensor = torch.Tensor


def _frontier(vals: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` smallest of ``vals [N]`` in the reference's
    top-k order (its ``top_k`` of ``-vals``): the IEEE total order, in
    which dead beams' +inf rank after every finite value, a NaN ranks by
    its sign bit and -0.0 after +0.0, and equal values by lower index. A
    stable sort of the order-preserving integer key keeps that order;
    ``torch.topk`` promises none among ties."""
    neg = -vals
    if neg.dtype == torch.float64:
        bits, low = neg.view(torch.int64), 0x7FFF_FFFF_FFFF_FFFF
    else:
        bits, low = neg.view(torch.int32), 0x7FFF_FFFF
    key = torch.where(bits < 0, bits ^ low, bits)
    return torch.sort(key, descending=True, stable=True).indices[:k]


def _scan_factory(
    allowed: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    topic_id: Tensor,
    min_replicas: int,
    lam: Tensor,
    dtype: Any,
    P: int,
    R: int,
    B: int,
    *, width: int, depth: int, allow_leader: bool, n_topics: int,
    siblings: bool = False,
) -> Callable[..., Tuple[Tensor, ...]]:
    """Build the depth loop ``run(loads, replicas, member, depth_cap)``
    shared by :func:`beam_search` (one search) and :func:`beam_session`
    (the receding-horizon loop).

    ``depth_cap`` limits which depths may win the best-so-far tracking,
    so a caller with a small remaining budget never adopts a sequence
    longer than it can afford. ``run`` returns ``(su0, best_u,
    best_beam, best_depth, parents [D, W], move_p/slot/tgt [D, W],
    best_loads [B], best_replicas [P, R], best_member [P, B])`` (0-d
    tensors for the scalars); the snapshots are the winning beam's state
    at its winning depth.
    """
    W, D = width, depth
    dev = weights.device
    inf = float("inf")
    tid_all = topic_id.long()
    w_arange = torch.arange(W, device=dev)

    def state_cost(loads: Tensor, bcount: Tensor, colo: Tensor) -> Tensor:
        """True objective of each beam ``[W]`` from its incremental state:
        the broker table from the per-broker replica counts and the
        colocation total as the tracked scalar."""
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        u = cost.unbalance(loads, bvalid, bvalid.sum(-1).to(dtype))
        return u + colo if n_topics else u

    def expand(
        loads: Tensor, replicas: Tensor, member: Tensor,
        counts: Optional[Tensor], bcount: Tensor, colo: Tensor,
        last_p: Tensor, last_t: Tensor,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """One live beam's best candidate per TARGET broker (and with
        ``siblings`` the second best, another partition): ``(vals [C, B],
        p, slot)`` with ``vals`` absolute, the beam's colocation total
        included, so the frontier ranks across beams without bias.

        ``(last_p, last_t)`` bars the beam's immediate re-move: the
        replica the previous depth placed on ``last_t`` may not be a
        source now. Re-moving it is dominated by the direct move, and on
        uphill plateaus the reversal is otherwise every beam's best
        child; only that replica is barred, so sequences that move the
        partition's other replica onto a just-vacated broker stay
        reachable."""
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        nb = bvalid.sum().to(dtype)
        c_rows = counts[tid_all] if n_topics else None
        colo_now = colo if n_topics else 0.0
        out = cost.factored_target_best(
            loads, replicas, allowed, member, bvalid, weights, nrep_cur,
            nrep_tgt, ncons, pvalid, nb, min_replicas,
            allow_leader=allow_leader, c_rows=c_rows, lam=lam,
            exclude_src=(last_p, last_t), top2=siblings,
        )
        vals = torch.stack(out[1::3])
        p = torch.stack(out[2::3])
        slot = torch.stack(out[3::3])
        return vals + colo_now, p, slot

    def apply_moves(
        loads: Tensor, replicas: Tensor, member: Tensor,
        counts: Optional[Tensor], bcount: Tensor, colo: Tensor,
        p: Tensor, slot: Tensor, t: Tensor, ok: Tensor,
    ) -> Tensor:
        """Apply each beam's chosen move in place, as a no-op where ``ok``
        is false (the mask folded into the arithmetic); every write lands
        in the beam's own row. Returns the updated colocation totals."""
        okf = ok.to(dtype)
        oki = ok.to(torch.int32)
        p = p.clamp(min=0)
        s = replicas[w_arange, p, slot].long()
        delta = torch.where(
            slot == 0,
            weights[p] * (nrep_cur[p].to(dtype) + ncons[p]),
            weights[p],
        ) * okf
        loads[w_arange, s] = loads[w_arange, s] + (-delta)
        loads[w_arange, t] = loads[w_arange, t] + delta
        replicas[w_arange, p, slot] += ((t - s) * oki).to(replicas.dtype)
        member[w_arange, p, s] = member[w_arange, p, s] & ~ok
        member[w_arange, p, t] = member[w_arange, p, t] | ok
        bcount[w_arange, s] -= oki
        bcount[w_arange, t] += oki
        if n_topics:
            tid = tid_all[p]
            # the colocation delta in O(1): the indicators are the ±λ
            # terms the candidate was scored with
            c_s = counts[w_arange, tid, s]
            c_t = counts[w_arange, tid, t]
            colo = colo + lam * okf * (
                (c_t >= 1).to(dtype) - (c_s >= 2).to(dtype)
            )
            counts[w_arange, tid, s] = c_s + (-okf)
            counts[w_arange, tid, t] = counts[w_arange, tid, t] + okf
        return colo

    def run(
        loads: Tensor, replicas: Tensor, member: Tensor, depth_cap: int,
    ) -> Tuple[Tensor, ...]:
        # the colocation counts and per-broker replica counts are built
        # once per search, then updated per applied move
        if n_topics:
            counts0 = torch.zeros((n_topics, B), dtype=dtype, device=dev)
            cost.scatter_add_(counts0, tid_all, member.to(dtype))
            # integer-valued floats summed (exact in any order), then one
            # multiply
            colo0 = lam * (counts0 - 1).clamp(min=0).sum()
        else:
            counts0 = None
            colo0 = scalar(0.0, dtype, dev)
        bcount0 = (member & pvalid[:, None]).sum(0).to(torch.int32)
        su0 = state_cost(loads[None], bcount0[None], colo0[None])[0]

        # beam state [W, ...]: beam 0 is the start, the others are dead
        loads_b = loads[None].repeat(W, 1)
        replicas_b = replicas[None].repeat(W, 1, 1)
        member_b = member[None].repeat(W, 1, 1)
        counts_b = counts0[None].repeat(W, 1, 1) if n_topics else None
        bcount_b = bcount0[None].repeat(W, 1)
        colo_b = colo0[None].repeat(W)
        alive = w_arange == 0
        last_p = torch.full((W,), -1, dtype=torch.long, device=dev)
        last_t = torch.full((W,), -1, dtype=torch.long, device=dev)

        best_u, best_beam = su0, torch.tensor(-1, device=dev)
        best_depth = torch.tensor(-1, device=dev)
        bs_loads, bs_replicas, bs_member = loads, replicas, member
        C = 2 if siblings else 1
        logs = []
        for d in range(D):
            vals = torch.full((W, C, B), inf, dtype=dtype, device=dev)
            cp = torch.zeros((W, C, B), dtype=torch.long, device=dev)
            cslot = torch.zeros((W, C, B), dtype=torch.long, device=dev)
            # a dead beam has no candidates: its row stays +inf, as the
            # reference's masked expansion leaves it
            for w in torch.nonzero(alive).flatten().tolist():
                vals[w], cp[w], cslot[w] = expand(
                    loads_b[w], replicas_b[w], member_b[w],
                    counts_b[w] if n_topics else None, bcount_b[w],
                    colo_b[w], last_p[w], last_t[w],
                )

            # the W best of the frontier; equal values (dead beams' +inf,
            # duplicate states) in index order
            flat = vals.reshape(-1)
            pick = _frontier(flat, W)
            new_u = flat[pick]
            parent = pick // (C * B)
            rem = pick % (C * B)
            which = rem // B
            child = rem % B  # the target broker

            ok = torch.isfinite(new_u)
            p_sel = torch.where(ok, cp[parent, which, child], -1)
            slot_sel = torch.where(ok, cslot[parent, which, child], 0)
            t_sel = torch.where(ok, child, 0)

            loads_b = loads_b[parent]
            replicas_b = replicas_b[parent]
            member_b = member_b[parent]
            bcount_b = bcount_b[parent]
            colo_b = colo_b[parent]
            if n_topics:
                counts_b = counts_b[parent]
            # the next depth bars re-moving the replica placed here
            last_p = torch.where(ok, p_sel, -1)
            last_t = torch.where(ok, t_sel, -1)
            colo_b = apply_moves(
                loads_b, replicas_b, member_b, counts_b, bcount_b, colo_b,
                p_sel, slot_sel, t_sel, ok,
            )
            alive = ok
            # the true post-move objective ranks the states (candidate
            # scores are incremental estimates)
            su_b = torch.where(
                ok, state_cost(loads_b, bcount_b, colo_b),
                torch.full_like(new_u, inf),
            )
            m = su_b.amin()
            arg = su_b.argmin()
            better = (m < best_u) & (d < depth_cap)
            best_u = torch.where(better, m, best_u)
            best_beam = torch.where(better, arg, best_beam)
            best_depth = torch.where(better, d, best_depth)
            bs_loads = torch.where(better, loads_b[arg], bs_loads)
            bs_replicas = torch.where(better, replicas_b[arg], bs_replicas)
            bs_member = torch.where(better, member_b[arg], bs_member)
            logs.append((parent, p_sel, slot_sel, t_sel))
        obs.metrics.count("beam.depth_steps", D)
        parents, mp, mslot, mtgt = (torch.stack(x) for x in zip(*logs))
        return (
            su0, best_u, best_beam, best_depth, parents, mp, mslot, mtgt,
            bs_loads, bs_replicas, bs_member,
        )

    return run


def beam_search(
    loads: Tensor,
    replicas: Tensor,
    member: Tensor,
    allowed: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    topic_id: Tensor,
    min_replicas: int,
    lam: Tensor,
    *,
    width: int,
    depth: int,
    allow_leader: bool,
    n_topics: int,
    siblings: bool = False,
) -> Tuple[Tensor, ...]:
    """One beam search from a single start state, on the device the
    inputs live on. Returns ``(su0, best_u, best_beam, best_depth,
    parents [D, W], move_p/slot/tgt [D, W])``; the logs reconstruct the
    best sequence on the host. Dead or no-op expansions log ``move_p ==
    -1``."""
    P, R = replicas.shape
    B = loads.shape[0]
    run = _scan_factory(
        allowed, weights, nrep_cur, nrep_tgt, ncons, pvalid, always_valid,
        universe_valid, topic_id, min_replicas, lam, loads.dtype, P, R, B,
        width=width, depth=depth, allow_leader=allow_leader,
        n_topics=n_topics, siblings=siblings,
    )
    return run(loads, replicas, member, depth)[:8]


def beam_session(
    loads: Tensor,
    replicas: Tensor,
    member: Tensor,
    allowed: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    topic_id: Tensor,
    min_replicas: int,
    lam: Tensor,
    min_unbalance: Tensor,
    budget: int,
    *,
    width: int,
    depth: int,
    allow_leader: bool,
    n_topics: int,
    max_moves: int,
    siblings: bool = False,
) -> Tensor:
    """Receding-horizon beam planning: rounds of depth-``depth`` search,
    each adopting the winning sequence's state, until a round finds no
    improving sequence or the budget is spent. One host read per round.

    Returns the packed int32 ``[move_p | move_slot | move_tgt | n]``
    (each log ``max_moves`` long, -1 past ``n``). The depth cap per round
    is ``min(depth, budget - n)``, so a sequence never overruns the
    budget (a truncated prefix could end on an uphill move).
    """
    P, R = replicas.shape
    B = loads.shape[0]
    ML = max_moves
    dev = loads.device
    run = _scan_factory(
        allowed, weights, nrep_cur, nrep_tgt, ncons, pvalid, always_valid,
        universe_valid, topic_id, min_replicas, lam, loads.dtype, P, R, B,
        width=width, depth=depth, allow_leader=allow_leader,
        n_topics=n_topics, siblings=siblings,
    )
    log = torch.full((3, ML), -1, dtype=torch.long, device=dev)
    n = 0
    while n < budget:
        t0 = time.perf_counter()
        (su0, best_u, best_beam, best_depth, parents, smp, sslot, smtgt,
         bs_loads, bs_replicas, bs_member) = run(
            loads, replicas, member, min(depth, budget - n)
        )
        accept = bool((best_u < su0 - min_unbalance) & (best_u < su0))
        # host clock; the read above waited for the search
        obs.metrics.count("beam.search_seconds", time.perf_counter() - t0)
        if not accept:
            break
        # walk the parent chain from the winning depth back to 0
        bd = int(best_depth)
        beam = best_beam
        for i in range(bd, -1, -1):
            pos = min(n + i, ML - 1)
            log[:, pos] = torch.stack([smp[i, beam], sslot[i, beam], smtgt[i, beam]])
            beam = parents[i, beam]
        loads, replicas, member = bs_loads, bs_replicas, bs_member
        n += bd + 1
    n_t = torch.tensor([n], dtype=torch.int32, device=dev)
    return torch.cat([log.to(torch.int32).reshape(-1), n_t])


def _reconstruct(
    best_beam: Any, best_depth: Any, parents: Any, mp: Any, mslot: Any,
    mtgt: Any,
) -> List[Tuple[int, int, int]]:
    """Walk the parent pointers back to depth 0; returns ``[(p, slot,
    t_dense)]`` in application order."""
    seq = []
    beam = int(best_beam)
    for d in range(int(best_depth), -1, -1):
        p = int(mp[d, beam])
        if p >= 0:
            seq.append((p, int(mslot[d, beam]), int(mtgt[d, beam])))
        beam = int(parents[d, beam])
    seq.reverse()
    return seq


def _device_setup(
    pl: PartitionList, cfg: RebalanceConfig, dtype: Any, device: torch.device,
) -> Tuple[Any, ...]:
    """One search's or round's inputs: the dense plan, its arrays on
    ``device`` (floats in ``dtype``, defaulting per device), the broker
    loads, the penalty and the topic-count bucket. Shared by
    :func:`_search_once` and :func:`_beam_round`."""
    dp = tensorize(pl, cfg)
    if dtype is None:
        dtype = default_dtype(device)
    d = to_device(dp, device, dtype)
    loads = cost.broker_loads(
        d.replicas, d.weights, d.nrep_cur, d.ncons, dp.bvalid.shape[0]
    )
    lam = float(cfg.anti_colocation)
    n_topics = next_bucket(len(dp.topics), 2) if lam > 0 else 0
    inputs = (
        loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
        d.nrep_tgt, d.ncons, d.pvalid,
        torch.from_numpy(_cfg_broker_mask(dp, cfg)).to(device), d.bvalid,
        torch.from_numpy(dp.topic_id).to(device),
        cfg.min_replicas_for_rebalancing, scalar(lam, dtype, device),
    )
    statics = dict(
        width=max(1, int(cfg.beam_width)),
        allow_leader=cfg.allow_leader_rebalancing, n_topics=n_topics,
        siblings=bool(getattr(cfg, "beam_siblings", False)),
    )
    return dp, dtype, inputs, statics


def _search_once(
    pl: PartitionList,
    cfg: RebalanceConfig,
    depth: int,
    dtype: Any = None,
    *,
    device: Any = None,
) -> Optional[Tuple[Any, List[Tuple[int, int, int]]]]:
    """One beam search on the live list; returns its DensePlan and the
    accepted sequence ``[(partition row, slot, target dense index)]``,
    or ``None`` when no sequence clears ``min_unbalance``."""
    dp, dtype, inputs, statics = _device_setup(
        pl, cfg, dtype, resolve_device(device)
    )
    t0 = time.perf_counter()
    su0, best_u, best_beam, best_depth, parents, mp, mslot, mtgt = beam_search(
        *inputs, depth=max(1, depth), **statics
    )
    su0, best_u = float(su0), float(best_u)
    obs.metrics.count("beam.search_seconds", time.perf_counter() - t0)
    if not (best_u < su0 - cfg.min_unbalance and best_u < su0):
        return None
    seq = _reconstruct(
        best_beam, best_depth, parents.cpu().numpy(), mp.cpu().numpy(),
        mslot.cpu().numpy(), mtgt.cpu().numpy(),
    )
    return dp, seq


def _auto_chunk(npart: int) -> int:
    """Beam moves per session, scaled down with the instance (a beam
    round costs about W scoring passes per depth): about 40M
    partition-moves per session, between 64 and 4096 moves."""
    return min(
        4096, max(64, 1 << (40_000_000 // max(npart, 1)).bit_length())
    )


def beam_plan(
    pl: PartitionList,
    cfg: RebalanceConfig,
    max_reassign: int,
    dtype: Any = None,
    chunk_moves: Optional[int] = None,
    *,
    device: Any = None,
) -> PartitionList:
    """Receding-horizon beam planning: rounds of ``beam_depth`` lookahead,
    each adopting the best sequence (:func:`beam_session`), on ``device``
    (CUDA unless the caller asks for another; without a card it raises).
    The output and mutation contract is ``solvers.scan.plan``'s (live
    partitions accumulated in move order). Sessions chunk at
    ``chunk_moves`` (default :func:`_auto_chunk`) and re-enter on the
    mutated assignment until converged or the budget is spent."""
    opl = empty_partition_list()
    if max_reassign <= 0:
        return opl
    device = resolve_device(device)
    repaired, budget = _settle_head(pl, cfg, max_reassign)
    opl.append(*repaired)
    if chunk_moves is None:
        chunk_moves = _auto_chunk(len(pl.partitions or []))
    chunk_moves = max(1, min(chunk_moves, 1 << 16))

    depth = max(1, int(cfg.beam_depth))
    # a chunk smaller than the lookahead could never search at full depth
    chunk_moves = max(chunk_moves, depth)

    remaining = budget
    while remaining > 0:
        chunk_cap = min(remaining, chunk_moves)
        n = _beam_round(pl, cfg, opl, chunk_cap, dtype, device)
        remaining -= n
        # converged only if the session stopped with full lookahead still
        # affordable: near the chunk's end the depth cap may have cut an
        # improving sequence, so re-enter
        if n == 0 or n + depth <= chunk_cap:
            break
    return opl


def _beam_round(
    pl: PartitionList,
    cfg: RebalanceConfig,
    opl: PartitionList,
    budget: int,
    dtype: Any,
    device: torch.device,
) -> int:
    """One beam session of up to 2^16 moves; applies the moves to the
    live list, appends them to ``opl`` and returns the move count."""
    from kafkabalancer_tpu_torch.solvers.scan import _decode_packed

    dp, dtype, inputs, statics = _device_setup(pl, cfg, dtype, device)
    ML = next_bucket(min(budget, 1 << 16), 64)
    packed = beam_session(
        *inputs, scalar(cfg.min_unbalance, dtype, device), min(budget, ML),
        depth=max(1, int(cfg.beam_depth)), max_moves=ML, **statics,
    )
    # beam is never a batch=1 parity trajectory, so superseded same-slot
    # writes always elide
    return _decode_packed(packed.cpu().numpy(), dp, opl, drop_superseded=True)


def beam_move(
    pl: PartitionList, cfg: RebalanceConfig, device: Any = None
) -> Optional[PartitionList]:
    """Pipeline step of ``-solver=beam``: the first move of the best
    ``beam_depth``-lookahead sequence, emitted like any Move step so the
    CLI loop, complete-partition logic and logging apply unchanged.

    The reference loop's invariant — every emitted reassignment improves
    the objective by ``min_unbalance`` on its own (steps.go:227) — holds:
    when the best sequence starts with an uphill move, the search is
    retried at depth 1, which yields an improving move or nothing."""
    from kafkabalancer_tpu_torch.balancer import costmodel
    from kafkabalancer_tpu_torch.balancer.steps import replace_replica
    from kafkabalancer_tpu_torch.obs import convergence

    def _decline() -> None:
        # beam does not tell below-threshold from balanced: the generic
        # note, refined by the CLI when a telemetry consumer asks
        convergence.note_outcome(
            "converged", min_unbalance=cfg.min_unbalance,
            feasible_unknown=True,
        )

    for depth in (int(cfg.beam_depth), 1):
        found = _search_once(pl, cfg, depth=depth, device=device)
        if found is None:
            _decline()
            return None
        dp, seq = found
        if not seq:
            _decline()
            return None
        p_row, slot, t_dense = seq[0]
        part = dp.partitions[p_row]
        t_id = int(dp.broker_ids[t_dense])
        if depth == 1:
            break
        # exact host check that the first move improves on its own
        loads = costmodel.get_broker_load(pl)
        for bid in cfg.brokers or []:
            loads.setdefault(bid, 0.0)
        bl = costmodel.get_bl(loads)
        su = costmodel.get_unbalance_bl(bl)
        rank = {bid: i for i, (bid, _) in enumerate(bl)}
        s_id = part.replicas[slot]
        bl[rank[s_id]][1] -= part.weight
        bl[rank[t_id]][1] += part.weight
        if costmodel.get_unbalance_bl(bl) < su - cfg.min_unbalance:
            break
    return replace_replica(part, part.replicas[slot], t_id)
