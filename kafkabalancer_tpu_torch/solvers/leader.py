"""Fused ``-rebalance-leader`` session: the full Balance loop on the device.

Counterpart of the reference package's ``solvers/leader.py``. With
``rebalance_leaders`` set, every reference ``Balance()`` call tries
``distributeLeaders`` first (steps.go:301-307 -> 234-282) and only falls
through to the Move steps when it does not fire; the CLI loop repeats this
per reassignment (kafkabalancer.go:177-221). Each iteration here replays
one ``Balance()`` call with exact step precedence:

1. **distributeLeaders** (steps.go:234-282): gate on the TOTAL unbalance
   >= ``min_unbalance`` (steps.go:249-253, a threshold on the state, not
   on the gain); take the most-loaded broker (ascending (load, ID) table,
   ties to the highest ID, utils.go:14-28), find the first partition in
   list order it leads with ``num_replicas >= min_replicas_for_
   rebalancing`` (steps.go:258-266), and hand its leadership to the
   least-loaded broker. If that broker is already a follower the slots
   are exchanged in place (``replacepl`` swap branch, utils.go:181-188),
   logged with ``move_slot ==`` :data:`SWAP_SLOT`; otherwise slot 0 is
   overwritten and the full leader load ``weight * (replicas +
   consumers)`` moves (utils.go:96-101).
2. **MoveLeaders / MoveNonLeaders** (steps.go:286-298): when the leader
   step does not fire, one greedy move exactly like ``scan.session``'s
   ``batch == 1`` step (``scan.single_move``).

The session ends when neither step fires or the budget is exhausted.

``batch > 1`` is the batched-transfer extension: per iteration the K =
min(batch, B) heaviest brokers pair with the K lightest, and each pair
hands over the led partition whose transfer gains most on the exact pair
objective; a round lands exactly the sum of its scored gains, because the
pairs are broker-disjoint. Two deliberate departures from the reference
trajectory (which ``batch=1`` replays): the partition is chosen by gain,
not first in list order, and only strictly improving transfers fire.

The loop runs on the host with one or two host reads per iteration (which
step fires, whether the move is accepted); the state stays on the device
and is updated in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kafkabalancer_tpu_torch.ops.cost import (
    ordered_cumsum,
    ordered_sum,
    overload_penalty,
    rank_brokers,
    scalar,
    unbalance,
)

Tensor = torch.Tensor

# move_slot sentinel: leadership handed to a broker already in the replica
# set — decoded as an in-place position exchange, not a slot overwrite
SWAP_SLOT = -2


def leader_session(
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
) -> Tuple[Tensor, ...]:
    """The fused rebalance-leaders Balance loop (see the module docstring)
    on the device the inputs live on. ``allowed`` is None in the
    all-allowed mode.

    Returns ``(replicas, loads, n, move_p, move_slot, move_tgt)``; log
    entries with ``move_slot == SWAP_SLOT`` are leadership exchanges
    toward ``move_tgt``, all others plain slot overwrites (int32 logs of
    length ``max_moves``, -1 past ``n``). The inputs are not modified.
    """
    from kafkabalancer_tpu_torch.solvers.scan import commit_single, single_move

    P, R = replicas.shape
    B = loads.shape[0]
    dtype = loads.dtype
    dev = loads.device
    inf = float("inf")
    K = max(1, min(batch, B))
    mu = scalar(min_unbalance, dtype, dev)

    loads = loads.clone()
    rep = replicas.clone()
    mem = member.clone()
    bcount = (mem & pvalid[:, None]).sum(0).to(torch.int32)
    # move log rows p | slot | tgt, trash column at max_moves
    log = torch.full((3, max_moves + 1), -1, dtype=torch.long, device=dev)
    iota_p = torch.arange(P, device=dev)
    iota_r = torch.arange(R, device=dev)
    ii = torch.arange(K, device=dev)
    eligible_p = pvalid & (nrep_tgt >= min_replicas) & (nrep_cur >= 1)
    fullw = weights * (nrep_cur.to(dtype) + ncons)  # leader load
    extraw = fullw - weights  # premium over a follower
    pen = overload_penalty

    def transfer(p: Tensor, light: Tensor, pos: Tensor) -> None:
        """Hand leadership of partitions ``p`` to brokers ``light`` (the
        replacepl analog, utils.go:166-197): swap branch when ``light`` is
        already a follower (positions exchange, only the premium moves),
        set branch otherwise (slot 0 overwritten, the full leader load
        moves, membership updates). The partitions are distinct and the
        broker pairs disjoint, so the transfers are independent."""
        row = rep[p]  # [k, R]
        old = row[:, 0].long()
        eqj = (row.long() == light[:, None]) & (iota_r[None, :] < nrep_cur[p][:, None])
        has = eqj.any(1)
        j = torch.where(eqj, iota_r[None, :], R).amin(1)
        rep[p] = torch.where(
            iota_r[None, :] == 0, light[:, None],
            torch.where(
                has[:, None] & (iota_r[None, :] == j[:, None]), old[:, None],
                row.long(),
            ),
        ).to(rep.dtype)
        delta = torch.where(has, extraw[p], fullw[p])
        loads[old] = loads[old] + (-delta)
        loads[light] = loads[light] + delta
        mem[p, old] = mem[p, old] & has
        mem[p, light] = True
        one = (~has).to(torch.int32)
        bcount[old] -= one
        bcount[light] += one
        log[:, pos] = torch.stack(
            [p, torch.where(has, SWAP_SLOT, 0), light]
        )

    n = 0
    while n < budget and n < max_moves:
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        nb = bvalid.sum()
        nbf = nb.to(dtype)
        su = unbalance(loads, bvalid, nbf)
        _, perm, _ = rank_brokers(loads, bvalid)
        if batch > 1:
            # pair the K heaviest with the K lightest valid brokers; pick
            # each pair's best-gain led partition; fire improving pairs only
            hk = perm[(nb - 1 - ii).clamp(0, B - 1)]
            lk = perm[ii.clamp(0, B - 1)]
            valid_pair = (nb - 1 - ii) > ii
            elig = (rep[:, 0].long()[None, :] == hk[:, None]) & eligible_p[None, :]
            is_fol = mem[:, lk].T  # [K, P]: light already a follower -> swap
            delta = torch.where(is_fol, extraw[None, :], fullw[None, :])
            zero = torch.zeros_like(loads)
            avg = ordered_sum(torch.where(bvalid, loads, zero)) / nbf
            lh = loads[hk][:, None]
            ll = loads[lk][:, None]
            # exact pair gain: transfers conserve total load, so only the
            # two brokers' penalty terms change (avg is invariant)
            gain = (pen(lh, avg) + pen(ll, avg)) - (
                pen(lh - delta, avg) + pen(ll + delta, avg)
            )
            gain = torch.where(elig, gain, torch.full_like(gain, -inf))
            p_star = gain.argmax(1)
            g_star = gain.amax(1)
            fire0 = valid_pair & (g_star > 0) & (hk != lk) & (su >= mu)
            # the reference gate (steps.go:249-253) within the round: a
            # pair fires only while the objective net of the gains of the
            # pairs before it is still >= min_unbalance
            g0 = torch.where(fire0, g_star, torch.zeros_like(g_star))
            su_before = su - (ordered_cumsum(g0) - g0)
            fire1 = fire0 & (su_before >= mu)
            cap = min(budget, max_moves)
            fire = fire1 & (n + torch.cumsum(fire1.to(torch.int32), 0) <= cap)
            cnt = int(fire.sum())
            if cnt:
                ks = torch.nonzero(fire).flatten()
                transfer(p_star[ks], lk[ks], n + torch.arange(cnt, device=dev))
                n += cnt
                continue
        else:
            heavy = perm[(nb - 1).clamp(0, B - 1)]
            lead_mask = (rep[:, 0].long() == heavy) & eligible_p
            if bool((su >= mu) & lead_mask.any()):
                p = torch.where(lead_mask, iota_p, P).amin().clamp(0, P - 1)
                transfer(p[None], perm[:1], torch.full((1,), n, device=dev))
                n += 1
                continue
        accept, p, slot, s_dense, t_dense = single_move(
            loads, rep, mem, allowed, bvalid, nbf, weights, nrep_cur,
            nrep_tgt, pvalid, universe_valid, min_replicas, mu,
            allow_leader=allow_leader,
        )
        if not bool(accept):
            break
        commit_single(
            loads, rep, mem, bcount, weights, nrep_cur, ncons, p, slot,
            s_dense, t_dense,
        )
        log[:, n] = torch.stack([p, slot, t_dense])
        n += 1
    mp, mslot, mtgt = log[:, :max_moves].to(torch.int32)
    return rep, loads, n, mp, mslot, mtgt
