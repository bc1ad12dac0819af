"""Pair-swap polish: escaping single-move local optima.

Counterpart of the reference package's ``solvers/polish.py``. The greedy
neighborhood (one replica, one target, steps.go:145-232) stalls when every
single move overshoots. The exit is a *pair swap*: partition p1 moves a
replica from broker a to broker b while p2 moves one from b to a. The
objective only sees the net transfer ``d = w1 - w2`` between the two
brokers, and

    g(d) = pen(L_a - d) + pen(L_b + d)

is convex in ``d``, so per broker pair the ideal transfer has the closed
form

    d* = (c_a (L_a - avg) - c_b (L_b - avg)) / (c_a + c_b)

with the current over/under coefficients; the best swap uses the replica
weights whose difference brackets ``d*``.

- Follower replica entries are compacted on the host once, sorted by
  weight (:func:`entry_table`; weights never change during a session).
- Per iteration the valid brokers are ranked by load and the hottest half
  is paired with a rotation of the coldest half (the rotation cycles so
  other pairings are tried before the phase gives up).
- Per entry held by a hot broker: ``w1 - d*`` is looked up in the static
  weight order (one ``searchsorted``), then mapped to the nearest entries
  the paired cold broker holds (:func:`nearest_occupied`).
- The two bracketing candidates are scored exactly, masked for
  feasibility, reduced to the best swap per pair, claimed per partition
  and committed together; every accepted swap improves the objective by
  exactly its scored delta.

:func:`converge_session` alternates move phases (``scan.session``, whose
batched scoring pass is the hand-written kernel, or the whole-session
kernel once up front with a ``pallas`` engine) with swap phases and, with
``allow_leader``, leadership-shuffle phases until none commits. Every
loop condition is a host read; the state stays on the device.
:func:`converge_session_batched` runs K of them as one (``xla`` engine),
each phase kind once per round for the instances still live; the
planning daemon's batchers fuse concurrent polish requests through it.

This is an extension beyond the reference's greedy loop (its upstream
lists N-way swaps as planned but never built, README.md:94-100); swaps
only exchange follower slots, so leader premiums never enter the swap
delta.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.ops.cost import (
    colo_terms,
    ordered_sum,
    overload_penalty,
    rank_brokers,
    scalar,
    scatter_add_,
)
from kafkabalancer_tpu_torch.ops.runtime import next_bucket

Tensor = torch.Tensor

# swap-phase convergence: shift rotations tried without progress before
# declaring the pairing exhausted
N_SHIFTS = 4
# adaptive acceptance floor: gains below su * SWAP_REL_EPS are noise-level
# churn, not progress
SWAP_REL_EPS = 1e-4


def nearest_occupied(
    holder: Tensor, tgt_b: Tensor, pair_live: Tensor, pe_c: Tensor,
    rq: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Per-query nearest entries held by the query's paired cold broker,
    in the static weight order. With ``occ[k, j] = (holder[j] ==
    tgt_b[k]) & pair_live[k]`` and ``k = pe_c[q]``:

        j_above[q] = min{ j >= min(rq[q], Nc-1) : occ[k, j] }   (else Nc+1)
        j_below[q] = max{ j <= clip(rq[q]-1, 0, Nc-1) : occ[k, j] }  (else -1)

    Per-pair next/prev occupied-rank tables (a reverse running minimum and
    a running maximum over the ``[pairs, Nc]`` occupancy), then two
    gathers per query. Integer work only, so exact in any order.
    """
    Nc = holder.shape[0]
    iota_e = torch.arange(Nc, dtype=torch.int32, device=holder.device)
    occ = (holder[None, :] == tgt_b[:, None]) & pair_live[:, None]
    nxt = torch.where(occ, iota_e[None, :], Nc + 1).flip(1)
    nxt = torch.cummin(nxt, 1).values.flip(1)
    j_above = nxt[pe_c, rq.clamp(0, Nc - 1)].long()
    del nxt
    prv = torch.cummax(torch.where(occ, iota_e[None, :], -1), 1).values
    j_below = prv[pe_c, (rq - 1).clamp(0, Nc - 1)].long()
    return j_above, j_below


def entry_table(
    dp: Any, min_replicas: int, min_bucket: int = 256
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static weight-sorted follower-entry table for the swap search.

    Returns ``(ew, ep, er, evalid)``: weights ascending (+inf padding),
    partition row, replica slot, validity. Only follower slots (slot >= 1;
    leader premiums never enter swap deltas) of eligible partitions
    (steps.go:168-170 min-replicas gate) take part. Weights are immutable
    during a session, so the table is built once per chunk.
    """
    P, R = dp.replicas.shape
    slot = np.arange(R)[None, :]
    mask = (
        (slot >= 1)
        & (slot < dp.nrep_cur[:, None])
        & dp.pvalid[:, None]
        & (dp.nrep_tgt >= min_replicas)[:, None]
    )
    p_idx, r_idx = np.nonzero(mask)
    w = dp.weights[p_idx]
    order = np.argsort(w, kind="stable")
    n = len(order)
    Nc = next_bucket(max(n, 1), min_bucket)
    ew = np.full(Nc, np.inf)
    ep = np.zeros(Nc, np.int32)
    er = np.zeros(Nc, np.int32)
    evalid = np.zeros(Nc, bool)
    ew[:n] = w[order]
    ep[:n] = p_idx[order]
    er[:n] = r_idx[order]
    evalid[:n] = True
    return ew, ep, er, evalid


class _State:
    """The alternation's working state on the device: the assignment, the
    loads, membership, and the merged move logs (rows p | slot | tgt, a
    trash column at ``ML``)."""

    def __init__(self, loads: Tensor, replicas: Tensor, ML: int) -> None:
        self.loads = loads
        self.rep = replicas
        self.mem = torch.empty(0, dtype=torch.bool)
        self.n = 0
        self.log = torch.full(
            (3, ML + 1), -1, dtype=torch.long, device=loads.device
        )

    def merge(self, n0: int, mp: Tensor, mslot: Tensor, mtgt: Tensor) -> None:
        """A phase's logs (length ``max_moves``) merged at offset ``n0``;
        entries past the phase's count are -1 and get overwritten by the
        next merge or ignored by the decode."""
        k = mp.shape[0]
        self.log[:, n0 : n0 + k] = torch.stack([mp, mslot, mtgt]).long()


def _table(
    st: _State, pvalid: Tensor, always_valid: Tensor, universe_valid: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The broker table of the current membership: ``(bvalid, nb, avg)``
    (dynamic membership, steps.go:150-155)."""
    bcount = (st.mem & pvalid[:, None]).sum(0)
    bvalid = (always_valid | (bcount > 0)) & universe_valid
    nb = bvalid.sum()
    zero = torch.zeros_like(st.loads)
    avg = ordered_sum(torch.where(bvalid, st.loads, zero)) / nb.to(
        st.loads.dtype
    )
    return bvalid, nb, avg


# device-loop: the pair-swap phase, one swap iteration per pass
def _swap_loop(
    st: _State,
    *,
    ew: Tensor,
    ep: Tensor,
    er: Tensor,
    evalid: Tensor,
    allowed: Optional[Tensor],
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_unbalance: Tensor,
    budget: int,
    ML: int,
    tid: Optional[Tensor] = None,
    lam: Optional[Tensor] = None,
    n_topics: int = 0,
) -> int:
    """The pair-swap loop (see the module docstring). Mutates ``st``; logs
    each swap as its two constituent moves. Returns its iteration count.

    ``n_topics > 0`` (with ``tid [P]`` and the 0-d ``lam``) scores swaps
    on the combined objective ``u + λ·Σ max(0, c-1)``: each candidate
    adds the colocation delta of its two membership changes (zero when
    both partitions share a topic: the cells cancel). The per-(topic,
    broker) counts are rebuilt from the live membership each iteration;
    pairs are broker-disjoint, so no two accepted swaps touch one cell.
    """
    P, R = st.rep.shape
    B = st.loads.shape[0]
    Nc = ew.shape[0]
    dtype = st.loads.dtype
    dev = st.loads.device
    inf = float("inf")
    nh = B // 2
    iota_e = torch.arange(Nc, device=dev)
    i_pair = torch.arange(nh, device=dev)
    BIGI = Nc + 1
    one = scalar(1.0, dtype, dev)
    half = scalar(0.5, dtype, dev)
    rel_eps = scalar(SWAP_REL_EPS, dtype, dev)
    rep_flat = st.rep.view(-1)
    streak = 0
    it = 0
    while streak < N_SHIFTS and st.n + 2 <= budget and st.n + 2 <= ML:
        loads, rep, mem, n = st.loads, st.rep, st.mem, st.n
        bvalid, nb, avg = _table(st, pvalid, always_valid, universe_valid)
        F = torch.where(bvalid, overload_penalty(loads, avg), torch.zeros_like(loads))
        su = ordered_sum(F)
        eps = torch.maximum(min_unbalance, su * rel_eps)
        if n_topics:
            # integer-valued floats: exact in any summation order
            counts = torch.zeros((n_topics, B), dtype=dtype, device=dev)
            scatter_add_(counts, tid, (mem & pvalid[:, None]).to(dtype))

        # hottest half paired with a rotation of the coldest half; the
        # halves are disjoint rank ranges, so pairs are broker-disjoint
        _, perm, _ = rank_brokers(loads, bvalid)
        npair = nb // 2
        cold_rank = (i_pair + it % N_SHIFTS) % npair.clamp(min=1)
        hot_rank = nb - 1 - i_pair
        src_b = perm[hot_rank.clamp(0, B - 1)]
        tgt_b = perm[cold_rank.clamp(0, B - 1)]
        pair_live = i_pair < npair

        La = loads[src_b]
        Lb = loads[tgt_b]
        ca = torch.where(La > avg, one, half)
        cb = torch.where(Lb > avg, one, half)
        dstar = (ca * (La - avg) - cb * (Lb - avg)) / (ca + cb)  # [nh]

        # entry -> its holder's pair (via a trash slot at broker index B)
        pair_of_src = torch.full((B + 1,), -1, dtype=torch.long, device=dev)
        pair_of_src[torch.where(pair_live, src_b, B)] = torch.where(
            pair_live, i_pair, -1
        )
        holder = torch.where(evalid, rep[ep, er].long(), B)
        pe = pair_of_src[holder]  # [Nc] pair index or -1
        pe_c = pe.clamp(min=0)
        live_e = pe >= 0
        t_e = tgt_b[pe_c]
        hb = holder % B

        def ok_at(p: Tensor, b: Tensor) -> Tensor:
            alw = universe_valid[b] if allowed is None else allowed[p, b]
            return alw & ~mem[p, b]

        feas1 = live_e & ok_at(ep, t_e)

        # nearest cold-broker entries by weight around w1 - d*: one
        # searchsorted into the static weight order, then the per-pair
        # occupied-rank lookup
        wq = ew - dstar[pe_c]
        rq = torch.searchsorted(ew, wq)
        j_above, j_below = nearest_occupied(holder, tgt_b, pair_live, pe_c, rq)
        va = (rq < Nc) & (j_above < BIGI)
        vb = (rq > 0) & (j_below >= 0)

        def cand_score(j2: Tensor, ok2: Tensor) -> Tuple[Tensor, Tensor]:
            j2c = j2.clamp(0, Nc - 1)
            feas2 = ok2 & ok_at(ep[j2c], hb)
            d = ew - ew[j2c]
            delta = (
                overload_penalty(La[pe_c] - d, avg)
                + overload_penalty(Lb[pe_c] + d, avg)
                - F[hb]
                - F[t_e]
            )
            if n_topics:
                # entry 1 (topic t1) moves hot -> cold, entry 2 (topic t2)
                # cold -> hot; one topic means the cells cancel exactly
                t1 = tid[ep]
                t2 = t1[j2c]
                sub1, _ = colo_terms(counts[t1, hb], lam)
                _, add1 = colo_terms(counts[t1, t_e], lam)
                sub2, _ = colo_terms(counts[t2, t_e], lam)
                _, add2 = colo_terms(counts[t2, hb], lam)
                delta = delta + torch.where(
                    t1 == t2, torch.zeros_like(delta), add1 - sub1 + add2 - sub2
                )
            return torch.where(feas1 & feas2, delta, torch.full_like(delta, inf)), j2c

        sa, ja = cand_score(j_above, va)
        sb, jb = cand_score(j_below, vb)
        score = torch.minimum(sa, sb)
        jsel = torch.where(sa <= sb, ja, jb)

        # best entry per pair: scatter-min, then the lowest-index winner
        improving = score < -eps
        best = torch.full((nh + 1,), inf, dtype=dtype, device=dev).scatter_reduce(
            0, torch.where(improving, pe_c, nh), score, "amin"
        )
        is_win = improving & (score <= best[pe_c])
        win_e = torch.full((nh + 1,), BIGI, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(is_win, pe_c, nh), torch.where(is_win, iota_e, BIGI),
            "amin",
        )[:nh]
        ok = (win_e < BIGI) & pair_live  # [nh]
        e1 = win_e.clamp(0, Nc - 1)
        e2 = jsel[e1]
        p1w, r1w = ep[e1], er[e1]
        p2w, r2w = ep[e2], er[e2]
        # dead or rejected pairs index the +inf weight padding; their
        # transfer must be exactly zero before the masked add below
        # (inf * 0 is NaN)
        dw = torch.where(ok, ew[e1] - ew[e2], torch.zeros_like(ew[e1]))

        # partition claims: the same partition may hold replicas in two
        # pairs; the first claimant (lowest pair index) wins
        bigp = nh + 1
        prio = torch.where(ok, i_pair, bigp)
        first_p = torch.full((P + 1,), bigp, dtype=torch.long, device=dev)
        first_p = first_p.scatter_reduce(0, torch.where(ok, p1w, P), prio, "amin")
        first_p = first_p.scatter_reduce(0, torch.where(ok, p2w, P), prio, "amin")
        ok &= (first_p[p1w] == i_pair) & (first_p[p2w] == i_pair)

        # budget cap (2 log slots per swap)
        rank = torch.cumsum(ok.long(), 0) - 1
        ok &= (n + 2 * rank + 2 <= budget) & (n + 2 * rank + 2 <= ML)
        # jaxlint: disable=R1 — the designed read: the swaps the iteration commits
        cnt = int(ok.sum())

        if cnt:
            # pairs are broker-disjoint and partitions claimed: rejected
            # candidates add zeros, so the scatters cannot collide
            okf = ok.to(dtype)
            scatter_add_(loads, src_b, -dw * okf)
            scatter_add_(loads, tgt_b, dw * okf)
            oki = ok.long()
            rep_flat.index_put_(
                (p1w * R + r1w,), ((tgt_b - src_b) * oki).to(rep_flat.dtype),
                accumulate=True,
            )
            rep_flat.index_put_(
                (p2w * R + r2w,), ((src_b - tgt_b) * oki).to(rep_flat.dtype),
                accumulate=True,
            )
            # membership flips at the four cells of each accepted swap;
            # p1 != p2 and claimed partitions make every cell distinct
            q1, q2, bs, bt = p1w[ok], p2w[ok], src_b[ok], tgt_b[ok]
            cells = torch.cat([q1 * B + bs, q1 * B + bt, q2 * B + bt, q2 * B + bs])
            mem_flat = mem.view(-1)
            mem_flat[cells] = ~mem_flat[cells]
            pos1 = torch.where(ok, n + 2 * rank, ML)
            pos2 = torch.where(ok, n + 2 * rank + 1, ML)
            neg = torch.full_like(p1w, -1)
            st.log[:, pos1] = torch.where(
                ok, torch.stack([p1w, r1w, tgt_b]), neg
            )
            st.log[:, pos2] = torch.where(
                ok, torch.stack([p2w, r2w, src_b]), neg
            )
        st.n = n + 2 * cnt
        streak = streak + 1 if cnt == 0 else 0
        it += 1
    return it


# device-loop: the leader-shuffle phase, one shuffle per pass
def _leader_shuffle_loop(
    st: _State,
    *,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_replicas: int,
    min_unbalance: Tensor,
    budget: int,
    ML: int,
) -> int:
    """Intra-partition leadership transfers: hand the leader role to one
    of the partition's own followers. This shifts exactly the leader
    premium ``w*(replicas+consumers) - w`` between two member brokers with
    no data movement and no membership change, a neighborhood neither the
    reference's ``move()`` (targets must be non-members, steps.go:199-201)
    nor the swap phase (followers only) can express. Logged with
    ``leader.SWAP_SLOT`` (decoded as the ``replacepl`` position exchange,
    utils.go:181-188). Mutates ``st``; returns its iteration count."""
    from kafkabalancer_tpu_torch.solvers.leader import SWAP_SLOT

    P, R = st.rep.shape
    dtype = st.loads.dtype
    dev = st.loads.device
    inf = float("inf")
    slot_iota = torch.arange(R, device=dev)[None, :]
    rel_eps = scalar(SWAP_REL_EPS, dtype, dev)
    extra = weights * (nrep_cur.to(dtype) + ncons) - weights  # [P]
    valid0 = (
        (slot_iota >= 1)
        & (slot_iota < nrep_cur[:, None])
        & pvalid[:, None]
        & (nrep_tgt >= min_replicas)[:, None]
        & (extra > 0)[:, None]
    )
    it = 0
    while st.n + 1 <= budget and st.n + 1 <= ML:
        loads, rep = st.loads, st.rep
        bvalid, _nb, avg = _table(st, pvalid, always_valid, universe_valid)
        F = overload_penalty(loads, avg)
        su = ordered_sum(torch.where(bvalid, F, torch.zeros_like(F)))
        eps = torch.maximum(min_unbalance, su * rel_eps)

        lead = rep[:, 0].long().clamp(min=0)  # [P]
        fol = rep.long().clamp(min=0)  # [P, R]
        ex = extra[:, None]
        delta = (
            overload_penalty(loads[lead][:, None] - ex, avg)
            + overload_penalty(loads[fol] + ex, avg)
            - F[lead][:, None]
            - F[fol]
        )
        flat = torch.where(valid0, delta, torch.full_like(delta, inf)).reshape(-1)
        i = flat.argmin()
        it += 1
        # jaxlint: disable=R1 — the designed read: whether the best shuffle improves
        if not bool(flat[i] < -eps):
            break
        p, r = i // R, i % R
        l_b = lead[p]
        f_b = rep[p, r].long()
        loads[l_b] = loads[l_b] + (-extra[p])
        loads[f_b] = loads[f_b] + extra[p]
        rep[p, 0] = f_b.to(rep.dtype)
        rep[p, r] = l_b.to(rep.dtype)
        st.log[:, st.n] = torch.stack([p, torch.full_like(p, SWAP_SLOT), f_b])
        st.n += 1
    return it


def converge_session(
    loads: Tensor,
    replicas: Tensor,
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
    ew: Tensor,
    ep: Tensor,
    er: Tensor,
    evalid: Tensor,
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int,
    engine: str = "xla",
    all_allowed: bool = False,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    topic_id: Optional[Tensor] = None,
    lam: Optional[float] = None,
    n_topics: int = 0,
) -> Tensor:
    """Move phases and swap phases alternated until neither commits, on
    the device the inputs live on (float inputs in the session dtype;
    ``ep``/``er`` int64; ``allowed`` None in the all-allowed mode).

    With ``engine`` ``"pallas"`` the whole-session kernel runs once up
    front (``pallas_session``; its plain version with
    ``"pallas-interpret"``); the alternation then interleaves
    ``scan.session`` move phases (after a swap phase only a handful of
    single moves reopen) with swap phases and, with ``allow_leader``,
    leadership-shuffle phases. ``scorer`` is passed to every move phase.

    ``n_topics > 0`` (with ``topic_id`` and ``lam``) runs every phase on
    the combined anti-colocation objective: the move phases are the
    colocation session (``scan.session``'s counts state), the swap phase
    adds the ±λ pair terms, and the leadership shuffle needs nothing (a
    leadership transfer moves no membership, so the counts do not
    change). ``xla`` engine only: the whole-session kernel has no
    colocation state.

    Returns ``packed``, the int32 concatenation ``[move_p | move_slot |
    move_tgt | n]`` sized ``3 * (2 * max_moves) + 1``. The host-clock time
    and count of each phase kind go to the ``polish.*`` counters.
    """
    from kafkabalancer_tpu_torch.solvers.scan import member_from, session

    if n_topics and engine != "xla":
        raise ValueError(
            "the colocation-aware polish session runs the xla engine only "
            "(the whole-session kernel has no colocation state)"
        )

    B = loads.shape[0]
    dtype = loads.dtype
    dev = loads.device
    ML = 2 * max_moves  # phase logs merge into double-size global logs
    # phase logs (length max_moves) merge at offsets n <= budget; the
    # clamp keeps a budget past max_moves inside the global log
    budget = min(budget, max_moves)
    mu = scalar(min_unbalance, dtype, dev)
    st = _State(loads.clone(), replicas.clone(), ML)
    inputs = (
        weights, nrep_cur, nrep_tgt, ncons, pvalid, always_valid,
        universe_valid, min_replicas, min_unbalance,
    )

    def timed(kind: str, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        out = fn()
        obs.metrics.count(f"polish.{kind}_seconds", time.perf_counter() - t0)
        obs.metrics.count(f"polish.{kind}_phases")
        return out

    if engine in ("pallas", "pallas-interpret"):
        from kafkabalancer_tpu_torch.solvers.pallas_session import (
            pallas_session,
            pallas_session_plain,
        )

        run = pallas_session_plain if engine == "pallas-interpret" else pallas_session
        st.rep, st.loads, st.n, pmp, pmslot, _pmsrc, pmtgt = timed(
            "kernel", lambda: run(
                st.loads, st.rep, None, allowed, *inputs, budget,
                max(1, batch), max_moves=max_moves, allow_leader=allow_leader,
                all_allowed=all_allowed,
            ),
        )
        st.merge(0, pmp, pmslot, pmtgt)

    st.mem = member_from(st.rep, nrep_cur, pvalid, B)
    swap_kw = dict(
        ew=ew, ep=ep, er=er, evalid=evalid, allowed=allowed, pvalid=pvalid,
        always_valid=always_valid, universe_valid=universe_valid,
        min_unbalance=mu, budget=budget, ML=ML,
    )
    colo = {}
    if n_topics:
        colo = dict(topic_id=topic_id, lam=lam, n_topics=n_topics)
        swap_kw.update(
            tid=topic_id, lam=scalar(lam, dtype, dev), n_topics=n_topics
        )
    shuffle_kw = dict(
        weights=weights, nrep_cur=nrep_cur, nrep_tgt=nrep_tgt, ncons=ncons,
        pvalid=pvalid, always_valid=always_valid,
        universe_valid=universe_valid, min_replicas=min_replicas,
        min_unbalance=mu, budget=budget, ML=ML,
    )
    while st.n + 1 <= budget:
        n0 = st.n

        # --- move phase (a no-op pass after the kernel's pre-phase) ------
        rep, loads, nm, pmp, pmslot, _pmsrc, pmtgt, _su = timed(
            "move", lambda: session(
                st.loads, st.rep, st.mem, allowed, *inputs, budget - st.n,
                max_moves=max_moves, allow_leader=allow_leader, batch=batch,
                scorer=scorer, **colo,
            ),
        )
        st.merge(st.n, pmp, pmslot, pmtgt)
        st.rep, st.loads, st.n = rep, loads, st.n + nm
        st.mem = member_from(st.rep, nrep_cur, pvalid, B)

        # --- swap phase --------------------------------------------------
        iters = timed("swap", lambda: _swap_loop(st, **swap_kw))
        obs.metrics.count("polish.swap_iterations", iters)

        # --- leadership-shuffle phase (allow_leader only) ----------------
        if allow_leader:
            iters = timed(
                "shuffle", lambda: _leader_shuffle_loop(st, **shuffle_kw)
            )
            obs.metrics.count("polish.shuffle_iterations", iters)
        if st.n == n0:
            break
    n_t = torch.tensor([st.n], dtype=torch.int32, device=dev)
    log = st.log[:, :ML].to(torch.int32)
    return torch.cat([log[0], log[1], log[2], n_t])


# --- K instances as one ------------------------------------------------------


class _StateK:
    """:class:`_State` of ``K`` instances: ``loads [K, B]``, ``rep [K, P,
    R]``, the membership with one trash element past its end (``mem`` a
    ``[K, P, B]`` view of ``mem_buf``), the merged move logs ``[K, 3, ML
    + 1]``, each instance's count on the host (``n``) and on the device
    (``n_dev``)."""

    def __init__(self, loads: Tensor, replicas: Tensor, ML: int) -> None:
        K = loads.shape[0]
        dev = loads.device
        self.loads = loads
        self.rep = replicas
        self.mem_buf = torch.empty(0, dtype=torch.bool, device=dev)
        self.mem = self.mem_buf
        self.n = [0] * K
        self.n_dev = torch.zeros(K, dtype=torch.long, device=dev)
        self.log = torch.full((K, 3, ML + 1), -1, dtype=torch.long, device=dev)

    def set_member(self, mem: Tensor) -> None:
        K, P, B = mem.shape
        self.mem_buf = torch.cat([mem.reshape(-1), mem.new_zeros(1)])
        self.mem = self.mem_buf[: K * P * B].view(K, P, B)


def _table_k(
    st: _StateK, pvalid: Tensor, always_valid: Tensor, universe_valid: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`_table` of each instance: ``(bvalid [K, B], nb [K], avg
    [K])``."""
    bcount = (st.mem & pvalid[:, :, None]).sum(1)
    bvalid = (always_valid | (bcount > 0)) & universe_valid
    nb = bvalid.sum(1)
    zero = torch.zeros_like(st.loads)
    avg = ordered_sum(torch.where(bvalid, st.loads, zero), 1) / nb.to(
        st.loads.dtype
    )
    return bvalid, nb, avg


# device-loop: the pair-swap phase of K instances, one swap iteration of each per pass
def _swap_loop_k(
    st: _StateK,
    live: List[bool],
    *,
    ew: Tensor,
    ep: Tensor,
    er: Tensor,
    evalid: Tensor,
    allowed: Optional[Tensor],
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_unbalance: Tensor,
    budget: List[int],
    budget_t: Tensor,
    ML: int,
    tid: Optional[Tensor] = None,
    lam: Optional[Tensor] = None,
    n_topics: int = 0,
) -> List[int]:
    """:func:`_swap_loop` of the instances ``live`` marks (entry tables
    ``[K, Nc]``, ``min_unbalance``/``budget_t``/``lam`` ``[K]``): one
    pass per iteration computes every instance's swaps, each instance
    keeps its own streak and rotation, and one read of the ``[K]`` swap
    counts ends the pass. An instance whose loop has ended commits
    nothing more (its swaps are masked on the device). Returns each
    instance's iteration count."""
    from kafkabalancer_tpu_torch.solvers.scan import _at, _on_device

    K, P, R = st.rep.shape
    B = st.loads.shape[1]
    Nc = ew.shape[1]
    dtype = st.loads.dtype
    dev = st.loads.device
    inf = float("inf")
    nh = B // 2
    iota_e = torch.arange(Nc, device=dev)[None, :]
    i_pair = torch.arange(nh, device=dev)[None, :]
    inst = torch.arange(K, device=dev)[:, None]
    BIGI = Nc + 1
    one = scalar(1.0, dtype, dev)
    half = scalar(0.5, dtype, dev)
    rel_eps = scalar(SWAP_REL_EPS, dtype, dev)
    loads_flat = st.loads.view(-1)
    rep_flat = st.rep.view(-1)
    log_row = (inst[:, :, None] * 3 + torch.arange(3, device=dev)[None, :, None]
               ) * (ML + 1)

    def running(streak: int, k: int) -> bool:
        return (streak < N_SHIFTS and st.n[k] + 2 <= budget[k]
                and st.n[k] + 2 <= ML)

    streak = [0] * K
    its = [0] * K
    run = [live[k] and running(0, k) for k in range(K)]
    active = _on_device(run, torch.bool, dev)
    it_dev = torch.zeros(K, dtype=torch.long, device=dev)
    streak_dev = torch.zeros(K, dtype=torch.long, device=dev)
    while any(run):
        loads, rep, mem, n = st.loads, st.rep, st.mem, st.n_dev
        bvalid, nb, avg = _table_k(st, pvalid, always_valid, universe_valid)
        a = avg[:, None]
        F = torch.where(bvalid, overload_penalty(loads, a),
                        torch.zeros_like(loads))
        su = ordered_sum(F, 1)
        eps = torch.maximum(min_unbalance, su * rel_eps)
        if n_topics:
            # integer-valued floats: exact in any summation order
            counts = torch.zeros((K * n_topics, B), dtype=dtype, device=dev)
            scatter_add_(
                counts, (tid + inst * n_topics).reshape(-1),
                (mem & pvalid[:, :, None]).to(dtype).reshape(K * P, B),
            )
            counts = counts.view(K, n_topics * B)

        # hottest half paired with a rotation of the coldest half
        sort_load = torch.where(bvalid, loads, torch.full_like(loads, inf))
        perm = torch.sort(sort_load, dim=1, stable=True).indices
        npair = (nb // 2)[:, None]
        cold_rank = (i_pair + (it_dev % N_SHIFTS)[:, None]) % npair.clamp(min=1)
        hot_rank = nb[:, None] - 1 - i_pair
        src_b = perm.gather(1, hot_rank.clamp(0, B - 1))
        tgt_b = perm.gather(1, cold_rank.clamp(0, B - 1))
        pair_live = i_pair < npair

        La = loads.gather(1, src_b)
        Lb = loads.gather(1, tgt_b)
        ca = torch.where(La > a, one, half)
        cb = torch.where(Lb > a, one, half)
        dstar = (ca * (La - a) - cb * (Lb - a)) / (ca + cb)  # [K, nh]

        # entry -> its holder's pair (via a trash slot at broker index B)
        pair_of_src = torch.full((K, B + 1), -1, dtype=torch.long, device=dev)
        pair_of_src.view(-1)[
            (torch.where(pair_live, src_b, B) + inst * (B + 1)).reshape(-1)
        ] = torch.where(pair_live, i_pair, -1).reshape(-1)
        holder = torch.where(evalid, _at(rep, ep * R + er).long(), B)
        pe = pair_of_src.gather(1, holder)  # [K, Nc] pair index or -1
        pe_c = pe.clamp(min=0)
        live_e = pe >= 0
        t_e = tgt_b.gather(1, pe_c)
        hb = holder % B

        def ok_at(p: Tensor, b: Tensor) -> Tensor:
            alw = (universe_valid.gather(1, b) if allowed is None
                   else _at(allowed, p * B + b))
            return alw & ~_at(mem, p * B + b)

        feas1 = live_e & ok_at(ep, t_e)

        wq = ew - dstar.gather(1, pe_c)
        rq = torch.searchsorted(ew, wq)
        # nearest_occupied per instance
        occ = (holder[:, None, :] == tgt_b[:, :, None]) & pair_live[:, :, None]
        iota_i = iota_e.to(torch.int32)[:, None, :]
        nxt = torch.where(occ, iota_i, Nc + 1).flip(2)
        nxt = torch.cummin(nxt, 2).values.flip(2)
        j_above = _at(nxt, pe_c * Nc + rq.clamp(0, Nc - 1)).long()
        del nxt
        prv = torch.cummax(torch.where(occ, iota_i, -1), 2).values
        j_below = _at(prv, pe_c * Nc + (rq - 1).clamp(0, Nc - 1)).long()
        del prv, occ
        va = (rq < Nc) & (j_above < BIGI)
        vb = (rq > 0) & (j_below >= 0)
        La_e, Lb_e = La.gather(1, pe_c), Lb.gather(1, pe_c)
        F_h, F_t = F.gather(1, hb), F.gather(1, t_e)

        def cand_score(j2: Tensor, ok2: Tensor) -> Tuple[Tensor, Tensor]:
            j2c = j2.clamp(0, Nc - 1)
            feas2 = ok2 & ok_at(ep.gather(1, j2c), hb)
            d = ew - ew.gather(1, j2c)
            delta = (
                overload_penalty(La_e - d, a)
                + overload_penalty(Lb_e + d, a)
                - F_h
                - F_t
            )
            if n_topics:
                # entry 1 (topic t1) moves hot -> cold, entry 2 (topic t2)
                # cold -> hot; one topic means the cells cancel exactly
                t1 = tid.gather(1, ep)
                t2 = t1.gather(1, j2c)
                lam_k = lam[:, None]
                sub1, _ = colo_terms(counts.gather(1, t1 * B + hb), lam_k)
                _, add1 = colo_terms(counts.gather(1, t1 * B + t_e), lam_k)
                sub2, _ = colo_terms(counts.gather(1, t2 * B + t_e), lam_k)
                _, add2 = colo_terms(counts.gather(1, t2 * B + hb), lam_k)
                delta = delta + torch.where(
                    t1 == t2, torch.zeros_like(delta), add1 - sub1 + add2 - sub2
                )
            return torch.where(feas1 & feas2, delta,
                               torch.full_like(delta, inf)), j2c

        sa, ja = cand_score(j_above, va)
        sb, jb = cand_score(j_below, vb)
        score = torch.minimum(sa, sb)
        jsel = torch.where(sa <= sb, ja, jb)

        # best entry per pair: scatter-min, then the lowest-index winner
        improving = score < -eps[:, None]
        best = torch.full((K, nh + 1), inf, dtype=dtype, device=dev)
        best = best.scatter_reduce(1, torch.where(improving, pe_c, nh), score,
                                   "amin")
        is_win = improving & (score <= best.gather(1, pe_c))
        win_e = torch.full((K, nh + 1), BIGI, dtype=torch.long, device=dev)
        win_e = win_e.scatter_reduce(
            1, torch.where(is_win, pe_c, nh),
            torch.where(is_win, iota_e, BIGI), "amin",
        )[:, :nh]
        ok = (win_e < BIGI) & pair_live  # [K, nh]
        e1 = win_e.clamp(0, Nc - 1)
        e2 = jsel.gather(1, e1)
        p1w, r1w = ep.gather(1, e1), er.gather(1, e1)
        p2w, r2w = ep.gather(1, e2), er.gather(1, e2)
        w1 = ew.gather(1, e1)
        dw = torch.where(ok, w1 - ew.gather(1, e2), torch.zeros_like(w1))

        # partition claims: the first claimant (lowest pair index) wins
        bigp = nh + 1
        prio = torch.where(ok, i_pair, bigp)
        first_p = torch.full((K, P + 1), bigp, dtype=torch.long, device=dev)
        first_p = first_p.scatter_reduce(1, torch.where(ok, p1w, P), prio,
                                         "amin")
        first_p = first_p.scatter_reduce(1, torch.where(ok, p2w, P), prio,
                                         "amin")
        ok &= (first_p.gather(1, p1w) == i_pair) & (
            first_p.gather(1, p2w) == i_pair
        )

        # budget cap (2 log slots per swap); stopped instances commit none
        rank = torch.cumsum(ok.long(), 1) - 1
        pos1 = n[:, None] + 2 * rank
        ok &= (pos1 + 2 <= budget_t[:, None]) & (pos1 + 2 <= ML)
        ok &= active[:, None]
        cnt = ok.sum(1)

        # pairs are broker-disjoint and partitions claimed: rejected
        # candidates add zeros and write to the trash elements
        okf = ok.to(dtype)
        bs = (src_b + inst * B).reshape(-1)
        bt = (tgt_b + inst * B).reshape(-1)
        scatter_add_(loads_flat, bs, (-dw * okf).reshape(-1))
        scatter_add_(loads_flat, bt, (dw * okf).reshape(-1))
        oki = ok.long()
        base = inst * (P * R)
        rep_flat.index_put_(
            ((base + p1w * R + r1w).reshape(-1),),
            ((tgt_b - src_b) * oki).to(rep_flat.dtype).reshape(-1),
            accumulate=True,
        )
        rep_flat.index_put_(
            ((base + p2w * R + r2w).reshape(-1),),
            ((src_b - tgt_b) * oki).to(rep_flat.dtype).reshape(-1),
            accumulate=True,
        )
        # membership flips at the four cells of each accepted swap
        mbase = inst * (P * B)
        cells = torch.where(
            ok.repeat(1, 4),
            torch.cat([mbase + p1w * B + src_b, mbase + p1w * B + tgt_b,
                       mbase + p2w * B + tgt_b, mbase + p2w * B + src_b], 1),
            K * P * B,
        ).reshape(-1)
        st.mem_buf[cells] = ~st.mem_buf[cells]
        neg = torch.full_like(p1w, -1)
        for pos, entry in ((pos1, (p1w, r1w, tgt_b)),
                           (pos1 + 1, (p2w, r2w, src_b))):
            at = torch.where(ok, pos, ML)
            st.log.view(-1).index_put_(
                ((log_row + at[:, None, :]).reshape(-1),),
                torch.where(ok[:, None, :], torch.stack(entry, 1),
                            neg[:, None, :]).reshape(-1),
            )
        n.add_(2 * cnt)
        it_dev.add_(active.long())
        streak_dev = torch.where(
            active, torch.where(cnt == 0, streak_dev + 1, 0), streak_dev
        )
        active &= (streak_dev < N_SHIFTS) & (n + 2 <= budget_t) & (n + 2 <= ML)
        # jaxlint: disable=R3 — the designed read: the [K] swap counts end the pass
        cnts = cnt.tolist()
        for k in range(K):
            if not run[k]:
                continue
            st.n[k] += 2 * cnts[k]
            streak[k] = streak[k] + 1 if cnts[k] == 0 else 0
            its[k] += 1
            run[k] = running(streak[k], k)
    return its


# device-loop: the leader-shuffle phase of K instances, one shuffle of each per pass
def _leader_shuffle_loop_k(
    st: _StateK,
    live: List[bool],
    *,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    always_valid: Tensor,
    universe_valid: Tensor,
    min_replicas: Tensor,
    min_unbalance: Tensor,
    budget: List[int],
    budget_t: Tensor,
    ML: int,
) -> List[int]:
    """:func:`_leader_shuffle_loop` of the instances ``live`` marks
    (``min_replicas``/``min_unbalance`` ``[K]``): one pass per
    iteration, each instance's first flat argmin, one read of the ``[K]``
    accept flags; an instance that stopped commits nothing more. Returns
    each instance's iteration count."""
    from kafkabalancer_tpu_torch.solvers.leader import SWAP_SLOT
    from kafkabalancer_tpu_torch.solvers.scan import _at, _on_device

    K, P, R = st.rep.shape
    B = st.loads.shape[1]
    dtype = st.loads.dtype
    dev = st.loads.device
    inf = float("inf")
    inst = torch.arange(K, device=dev)
    slot_iota = torch.arange(R, device=dev)[None, None, :]
    rel_eps = scalar(SWAP_REL_EPS, dtype, dev)
    extra = weights * (nrep_cur.to(dtype) + ncons) - weights  # [K, P]
    valid0 = (
        (slot_iota >= 1)
        & (slot_iota < nrep_cur[:, :, None])
        & pvalid[:, :, None]
        & (nrep_tgt >= min_replicas[:, None])[:, :, None]
        & (extra > 0)[:, :, None]
    )
    loads_buf = torch.cat([st.loads.reshape(-1), st.loads.new_zeros(1)])
    st.loads = loads_buf[: K * B].view(K, B)
    rep_buf = torch.cat([st.rep.reshape(-1), st.rep.new_full((1,), -1)])
    st.rep = rep_buf[: K * P * R].view(K, P, R)
    log_flat = st.log.view(-1)
    log_row = (inst[:, None] * 3 + torch.arange(3, device=dev)[None, :]) * (ML + 1)

    def running(k: int) -> bool:
        return st.n[k] + 1 <= budget[k] and st.n[k] + 1 <= ML

    its = [0] * K
    run = [live[k] and running(k) for k in range(K)]
    active = _on_device(run, torch.bool, dev)
    while any(run):
        loads, rep = st.loads, st.rep
        bvalid, _nb, avg = _table_k(st, pvalid, always_valid, universe_valid)
        a = avg[:, None]
        F = overload_penalty(loads, a)
        su = ordered_sum(torch.where(bvalid, F, torch.zeros_like(F)), 1)
        eps = torch.maximum(min_unbalance, su * rel_eps)

        lead = rep[:, :, 0].long().clamp(min=0)  # [K, P]
        fol = rep.long().clamp(min=0)  # [K, P, R]
        ex = extra[:, :, None]
        a3 = avg[:, None, None]
        delta = (
            overload_penalty(loads.gather(1, lead)[:, :, None] - ex, a3)
            + overload_penalty(_at(loads, fol) + ex, a3)
            - F.gather(1, lead)[:, :, None]
            - _at(F, fol)
        )
        flat = torch.where(valid0, delta, torch.full_like(delta, inf))
        flat = flat.reshape(K, -1)
        i = flat.argmin(1)
        ok = (flat.gather(1, i[:, None])[:, 0] < -eps) & active
        p, r = i // R, i % R
        l_b = lead.gather(1, p[:, None])[:, 0]
        f_b = _at(rep, p * R + r).long()
        e_p = extra.gather(1, p[:, None])[:, 0]
        # the two load updates in order (the second reads the first's
        # write); rejected instances write to the trash element
        at_l, at_f = inst * B + l_b, inst * B + f_b
        loads_buf.index_put_(
            (torch.where(ok, at_l, K * B),), loads_buf[at_l] + (-e_p)
        )
        loads_buf.index_put_(
            (torch.where(ok, at_f, K * B),), loads_buf[at_f] + e_p
        )
        base = inst * (P * R) + p * R
        rep_buf.index_put_(
            (torch.where(ok, base, K * P * R),), f_b.to(rep_buf.dtype)
        )
        rep_buf.index_put_(
            (torch.where(ok, base + r, K * P * R),), l_b.to(rep_buf.dtype)
        )
        entry = torch.stack([p, torch.full_like(p, SWAP_SLOT), f_b], 1)
        at = torch.where(ok, st.n_dev, ML)
        log_flat.index_put_(
            ((log_row + at[:, None]).reshape(-1),),
            torch.where(ok[:, None], entry, torch.full_like(entry, -1))
            .reshape(-1),
        )
        st.n_dev.add_(ok.long())
        active = ok & (st.n_dev + 1 <= budget_t) & (st.n_dev + 1 <= ML)
        # jaxlint: disable=R3 — the designed read: whether each best shuffle improves
        oks = ok.tolist()
        for k in range(K):
            if not run[k]:
                continue
            its[k] += 1
            if oks[k]:
                st.n[k] += 1
            run[k] = oks[k] and running(k)
    return its


def converge_session_batched(
    loads: Tensor,
    replicas: Tensor,
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
    ew: Tensor,
    ep: Tensor,
    er: Tensor,
    evalid: Tensor,
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
    topic_id: Optional[Tensor] = None,
    lam: Optional[List[float]] = None,
    n_topics: int = 0,
) -> Tuple[Tensor, List[Dict[str, float]]]:
    """``K`` independent alternations (:func:`converge_session`, ``xla``
    engine) as one: every tensor with a leading instance axis (the entry
    tables ``[K, Nc]``, ``topic_id [K, P]``), and each instance's
    ``min_replicas``, ``min_unbalance``, ``budget`` and ``lam`` in a
    list.

    Each instance keeps its own alternation state: its count, its merged
    log of length ``2 * max_moves``, its budget clamp ``min(budget,
    max_moves)`` and its stop when a round commits nothing. Each phase
    kind runs once per round for the instances still live: the move
    phase as one instance-batched session (``scan._moves_batched``: one
    batched kernel launch per iteration at ``batch > 1``), the swap phase
    and, with ``allow_leader``, the leadership-shuffle phase with one
    read of the ``[K]`` counts per pass. An instance that has stopped
    commits nothing more. Every float reduction stays within its
    instance, in the solo order, so each packed log is bit for bit its
    :func:`converge_session`'s.

    Returns ``(packed, counters)``: the ``[K, 3 * (2 * max_moves) + 1]``
    packed logs and, per instance, the counters its solo alternation
    would count — its own phases' counts (``polish.*_phases``,
    ``polish.*_iterations``, ``solver.session_iterations``) and the fused
    phases' host seconds (``polish.*_seconds``, and
    ``solver.session_seconds`` up to its move session's stop). The inputs
    are not modified.
    """
    from kafkabalancer_tpu_torch.solvers.scan import (
        _moves_batched,
        _on_device,
        member_from_k,
    )

    K = loads.shape[0]
    B = loads.shape[1]
    dtype = loads.dtype
    dev = loads.device
    ML = 2 * max_moves
    budgets = [min(b, max_moves) for b in budget]
    mu = _on_device(list(min_unbalance), dtype, dev)
    budget_t = _on_device(budgets, torch.long, dev)
    st = _StateK(loads.clone(), replicas.clone(), ML)
    st.set_member(member_from_k(st.rep, nrep_cur, pvalid, B))
    counters: List[Dict[str, float]] = [{} for _ in range(K)]

    def add(k: int, name: str, value: float) -> None:
        counters[k][name] = counters[k].get(name, 0.0) + value

    colo = {}
    swap_kw = dict(
        ew=ew, ep=ep, er=er, evalid=evalid, allowed=allowed, pvalid=pvalid,
        always_valid=always_valid, universe_valid=universe_valid,
        min_unbalance=mu, budget=budgets, budget_t=budget_t, ML=ML,
    )
    if n_topics:
        colo = dict(topic_id=topic_id, lam=lam, n_topics=n_topics)
        swap_kw.update(tid=topic_id.long(), lam=_on_device(list(lam), dtype, dev),
                       n_topics=n_topics)
    shuffle_kw = dict(
        weights=weights, nrep_cur=nrep_cur, nrep_tgt=nrep_tgt, ncons=ncons,
        pvalid=pvalid, always_valid=always_valid,
        universe_valid=universe_valid,
        min_replicas=_on_device(list(min_replicas), torch.long, dev),
        min_unbalance=mu, budget=budgets, budget_t=budget_t, ML=ML,
    )
    live = [st.n[k] + 1 <= budgets[k] for k in range(K)]
    while any(live):
        n0 = list(st.n)
        ks = [k for k in range(K) if live[k]]

        # --- move phase --------------------------------------------------
        t0 = time.perf_counter()
        rep, lds, log, nm, iters, secs = _moves_batched(
            st.loads, st.rep, st.mem, allowed, weights, nrep_cur, nrep_tgt,
            ncons, pvalid, always_valid, universe_valid, min_replicas,
            min_unbalance,
            [budgets[k] - st.n[k] if live[k] else 0 for k in range(K)],
            max_moves=max_moves, allow_leader=allow_leader, batch=batch,
            scorer=scorer, **colo,
        )
        dt = time.perf_counter() - t0
        # rows p | slot | tgt of the phase's logs
        plog = torch.stack([log[:, 0], log[:, 1], log[:, 3]], 1)
        for k in ks:
            # the phase's log merged at the instance's offset (entries
            # past its count are -1)
            st.log[k, :, st.n[k]: st.n[k] + max_moves] = plog[k, :, :max_moves]
            st.n[k] += nm[k]
            add(k, "polish.move_seconds", dt)
            add(k, "polish.move_phases", 1)
            add(k, "solver.session_seconds", secs[k])
            add(k, "solver.session_iterations", iters[k])
        st.rep, st.loads = rep, lds
        st.n_dev = _on_device(st.n, torch.long, dev)
        st.set_member(member_from_k(st.rep, nrep_cur, pvalid, B))

        # --- swap phase --------------------------------------------------
        t0 = time.perf_counter()
        its = _swap_loop_k(st, live, **swap_kw)
        dt = time.perf_counter() - t0
        for k in ks:
            add(k, "polish.swap_seconds", dt)
            add(k, "polish.swap_phases", 1)
            add(k, "polish.swap_iterations", its[k])

        # --- leadership-shuffle phase (allow_leader only) ----------------
        if allow_leader:
            t0 = time.perf_counter()
            its = _leader_shuffle_loop_k(st, live, **shuffle_kw)
            dt = time.perf_counter() - t0
            for k in ks:
                add(k, "polish.shuffle_seconds", dt)
                add(k, "polish.shuffle_phases", 1)
                add(k, "polish.shuffle_iterations", its[k])
        for k in ks:
            live[k] = st.n[k] != n0[k] and st.n[k] + 1 <= budgets[k]
    log = st.log[:, :, :ML].to(torch.int32)
    n_t = _on_device(st.n, torch.int32, dev)[:, None]
    return torch.cat([log[:, 0], log[:, 1], log[:, 2], n_t], 1), counters
