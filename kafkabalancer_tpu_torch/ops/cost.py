"""Torch cost model: broker loads and the asymmetric unbalance objective.

The counterpart of the reference package's ``ops/cost.py``, function for
function, as plain functions on tensors of any device:

- **Load model** (utils.go:92-105): per partition, the leader broker
  (``replicas[0]``) accrues ``weight * (len(replicas) + num_consumers)``;
  every follower accrues ``weight``.
- **Objective** (utils.go:119-147): with ``rel_b = load_b/avg - 1``, the
  unbalance is ``Σ rel²`` over overloaded brokers plus ``Σ rel²/2`` over
  underloaded brokers. Degenerate inputs follow IEEE semantics like Go:
  all-zero loads give a NaN objective, which the sessions reject as "no
  improvement".
- **Broker ordering** (utils.go:14-28): ascending by (load, broker-ID).

Exactness. The port's CPU sessions are held move for move against the
reference at float64 and float32, so every float reduction here follows
the reference's summation order (:func:`ordered_sum`) and every
scatter-add its update order (:func:`scatter_add_`). Element-wise
expressions keep the reference's operation order term for term.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Scalar = Union[Tensor, float, int]

# block width of the reference's float reductions (see ordered_sum)
_SUM_BLOCK = 32


def ordered_sum(x: Tensor, dim: int = 0) -> Tensor:
    """Sum over ``dim`` in the reference's order.

    The reference's CPU reductions add up to 32 terms left to right from
    zero. A longer axis is zero-padded symmetrically (the low side gets
    the smaller half of the padding) to a multiple of 32, each block of
    32 is summed left to right, and the block sums are reduced the same
    way, recursively. Reproducing that order makes ``su``, ``avg`` and
    the per-broker prefix sums bit-identical to the reference at both
    precisions; ``torch.sum`` (pairwise, vectorised) is not. The blocks
    are summed side by side, so the cost is 32 element-wise adds per
    level, whatever the other dimensions.
    """
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n > _SUM_BLOCK:
        nblk = -(-n // _SUM_BLOCK)
        pad = nblk * _SUM_BLOCK - n
        lo = pad // 2
        rest = x.shape[1:]
        x = torch.cat(
            [x.new_zeros((lo,) + rest), x, x.new_zeros((pad - lo,) + rest)]
        )
        xb = x.reshape((nblk, _SUM_BLOCK) + rest)
        acc = torch.zeros_like(xb[:, 0])
        for j in range(_SUM_BLOCK):
            acc = acc + xb[:, j]
        return ordered_sum(acc, 0)
    acc = torch.zeros_like(x[0]) if n else x.new_zeros(x.shape[1:])
    for j in range(n):
        acc = acc + x[j]
    return acc


def scatter_add_(dst: Tensor, idx: Tensor, src: Tensor) -> Tensor:
    """``dst[idx[i]] += src[i]`` in place, deterministically.

    On the CPU ``index_add_`` applies the updates one at a time in index
    order — the reference's scatter order, so float sums match it bit for
    bit. On CUDA ``index_add_`` uses float atomics, whose order changes
    from run to run; ``index_put_(accumulate=True)`` sorts the indices
    first and sums each index's updates in a fixed order instead, so two
    runs on the same inputs give the same bits.
    """
    if dst.device.type == "cpu":
        return dst.index_add_(0, idx.long(), src)
    return dst.index_put_((idx.long(),), src, accumulate=True)


def broker_loads(
    replicas: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    ncons: Tensor,
    num_brokers: int,
) -> Tensor:
    """Per-broker load vector ``[B]`` (utils.go:92-105).

    ``replicas``: [P, R] dense broker indices (-1 pad); ``weights``: [P];
    ``nrep_cur``: [P] replica counts; ``ncons``: [P] num_consumers.
    """
    P, R = replicas.shape
    slot = torch.arange(R, device=replicas.device)[None, :]
    valid = slot < nrep_cur[:, None]
    # leader premium: slot 0 carries weight*(len+num_consumers), others weight
    w = torch.where(
        slot == 0,
        weights[:, None] * (nrep_cur[:, None].to(weights.dtype) + ncons[:, None]),
        weights[:, None],
    )
    w = torch.where(valid, w, torch.zeros_like(w))
    idx = torch.where(valid, replicas, torch.zeros_like(replicas))
    out = torch.zeros(num_brokers, dtype=weights.dtype, device=weights.device)
    return scatter_add_(out, idx.reshape(-1), w.reshape(-1))


def overload_penalty(loads: Tensor, avg: Scalar) -> Tensor:
    """Per-broker objective term: ``rel²`` if overloaded else ``rel²/2``
    (utils.go:134-143)."""
    rel = loads / avg - 1.0
    return rel * rel * torch.where(
        rel > 0, torch.ones_like(rel), torch.full_like(rel, 0.5)
    )


def unbalance(loads: Tensor, bvalid: Tensor, nb: Scalar) -> Tensor:
    """The scalar objective over the valid brokers (utils.go:119-147).

    ``nb`` is the real broker count (padded entries excluded). NaN/inf
    propagate per IEEE like the Go code's float64 division.
    """
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    pen = overload_penalty(loads, avg)
    return ordered_sum(torch.where(bvalid, pen, zero))


def rank_brokers(
    loads: Tensor, bvalid: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Ascending (load, broker-index) ranking of the valid brokers
    (utils.go:14-28, utils.go:107-117).

    Returns ``(loads_rank, perm, rank_of)`` where ``perm[rank] = broker
    index`` and ``rank_of[broker index] = rank``. Padded brokers sort to
    the end (load forced to +inf). A stable sort on the load keeps equal
    loads in index order, which is the two-key (load, index) order.
    """
    B = loads.shape[0]
    iota = torch.arange(B, device=loads.device)
    sort_load = torch.where(bvalid, loads, torch.full_like(loads, float("inf")))
    perm = torch.sort(sort_load, stable=True).indices
    rank_of = torch.empty_like(iota)
    rank_of[perm] = iota
    return loads[perm], perm, rank_of


def move_candidate_scores(
    loads: Tensor,
    replicas: Tensor,
    allowed_rank: Tensor,
    member_rank: Tensor,
    bvalid: Tensor,
    bvalid_rank: Tensor,
    perm: Tensor,
    rank_of: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    pvalid: Tensor,
    nb: Scalar,
    min_replicas: Scalar,
) -> Tuple[Tensor, Tensor]:
    """Rank-1 what-if scores for every ``(partition, replica slot,
    target)`` move candidate:

        u = Σ_b f(load_b) − f(load_s) − f(load_t)
                          + f(load_s − w) + f(load_t + w)

    with ``f`` the asymmetric penalty; the what-if delta uses the plain
    follower weight even for leader moves (steps.go:185/:207). The
    target axis is in ascending (load, ID) rank order (``perm`` /
    ``rank_of`` from :func:`rank_brokers`). Returns ``(u_masked [P, R,
    B], su)`` with ineligible candidates at +inf.
    """
    inf = float("inf")
    loads_rank = loads[perm]
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    F = torch.where(bvalid_rank, overload_penalty(loads_rank, avg), zero)
    su = ordered_sum(F)

    w = weights[:, None]  # [P, 1]
    s = replicas.clamp(min=0).long()  # [P, R] dense idx (pad-safe)
    F_s = F[rank_of[s]]  # [P, R]
    f_s_new = overload_penalty(loads[s] - w, avg)  # [P, R]
    f_t_new = overload_penalty(loads_rank[None, :] + w, avg)  # [P, B]

    u = (
        su
        - F_s[:, :, None]
        - F[None, None, :]
        + f_s_new[:, :, None]
        + f_t_new[:, None, :]
    )  # [P, R, B]

    R = replicas.shape[1]
    slot = torch.arange(R, device=replicas.device)[None, :]
    srcmask = (
        (slot < nrep_cur[:, None])
        & pvalid[:, None]
        & (nrep_tgt >= min_replicas)[:, None]
    )  # [P, R]
    tmask = allowed_rank & ~member_rank & bvalid_rank  # [P, B]
    mask = srcmask[:, :, None] & tmask[:, None, :]
    return torch.where(mask, u, torch.full_like(u, inf)), su


def colo_terms(c: Tensor, lam: Scalar) -> Tuple[Tensor, Tensor]:
    """The anti-colocation delta rule: removing a replica from a broker
    holding ``c >= 2`` same-topic replicas changes lam*max(0, c-1) by
    -lam; adding to one holding ``c >= 1`` changes it by +lam. Returns
    ``(sub, add)``."""
    lam_t = torch.as_tensor(lam, dtype=c.dtype, device=c.device)
    zero = torch.zeros_like(c)
    return torch.where(c >= 2, lam_t, zero), torch.where(c >= 1, lam_t, zero)


def argmin_rows(V: Tensor) -> Tuple[Tensor, Tensor]:
    """Column-wise ``(min, lowest row attaining it)`` of ``V [P, N]``.

    A NaN entry is never selected (it compares false, as in the scoring
    kernel's strict-< scan); a column with no finite candidate returns
    ``(+inf, 0)``.
    """
    V = torch.where(torch.isnan(V), torch.full_like(V, float("inf")), V)
    vmin = V.amin(0)
    rows = torch.arange(V.shape[0], device=V.device, dtype=torch.int32)[:, None]
    arg = torch.where(V == vmin[None, :], rows, V.shape[0]).amin(0)
    return vmin, arg


def pair_frame(loads: Tensor, bvalid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Hot/cold rank-pairing frame: pair ``i`` moves OFF the broker at
    ascending-(load, ID) rank ``nb-1-i`` INTO the broker at rank ``i``.
    Returns ``(s_i [B2], t_i [B2], live [B2])`` with ``B2 = max(1,
    B // 2)``; dead columns (``i >= nb // 2``) carry ``s_i = t_i = 0``.

    The reference builds ``[B, B2]`` one-hot columns here for its TPU
    matmul selection; the port gathers by index instead.
    """
    B = loads.shape[0]
    B2 = max(1, B // 2)
    nb_i = bvalid.sum()
    _, perm, _ = rank_brokers(loads, bvalid)
    i2 = torch.arange(B2, device=loads.device)
    live = i2 < nb_i // 2
    zero = torch.zeros_like(i2)
    s_i = torch.where(live, perm[(nb_i - 1 - i2).clamp(0, B - 1)], zero)
    t_i = torch.where(live, perm[i2.clamp(max=B - 1)], zero)
    return s_i, t_i, live


def pair_finish(
    replicas: Tensor,
    nrep_cur: Tensor,
    s_i: Tensor,
    live: Tensor,
    vals_f: Tensor,
    p_f: Tensor,
    vals_l: Optional[Tensor],
    p_l: Optional[Tensor],
    *,
    allow_leader: bool,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pair-winner epilogue: recover the (unique) follower slot holding
    the pair's hot broker on the winner partition, merge the leader
    winners (strict <, follower wins ties), and kill dead pairs. Returns
    ``(vals_raw, p, slot)`` with ``vals_raw`` su-less (+inf dead)."""
    R = replicas.shape[1]
    p_f = p_f.long()
    rp = replicas[p_f]  # [B2, R]
    slot_iota = torch.arange(R, device=replicas.device)[None, :]
    hit = (
        (rp == s_i[:, None].to(rp.dtype))
        & (slot_iota >= 1)
        & (slot_iota < nrep_cur[p_f][:, None])
    )
    slot_f = torch.where(hit, slot_iota, torch.full_like(slot_iota, R)).argmin(1)

    vals, p, slot = vals_f, p_f, slot_f
    if allow_leader:
        lead_better = vals_l < vals  # strict: follower wins ties
        vals = torch.where(lead_better, vals_l, vals)
        p = torch.where(lead_better, p_l.long(), p)
        slot = torch.where(lead_better, torch.zeros_like(slot), slot)
    return torch.where(live, vals, torch.full_like(vals, float("inf"))), p, slot


def _src_terms(
    loads: Tensor, w: Tensor, avg: Tensor, F: Tensor, colo_sub: Optional[Tensor]
) -> Tensor:
    A = overload_penalty(loads[None, :] - w, avg) - F[None, :]
    return A if colo_sub is None else A - colo_sub


def _tgt_terms(
    loads: Tensor, w: Tensor, avg: Tensor, F: Tensor, colo_add: Optional[Tensor]
) -> Tensor:
    C = overload_penalty(loads[None, :] + w, avg) - F[None, :]
    return C if colo_add is None else C + colo_add


def factored_target_best(
    loads: Tensor,
    replicas: Tensor,
    allowed: Tensor,
    member: Tensor,
    bvalid: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    nb: Scalar,
    min_replicas: Scalar,
    *,
    allow_leader: bool,
    c_rows: Optional[Tensor] = None,
    lam: Optional[Scalar] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Best candidate per TARGET broker via the factorized rank-1
    objective ``u = su + A[source] + C[target]``: only [P, B] work, the
    [P, R, B] tensor never materializes.

    Followers (slots ≥ 1) score with the plain weight; with
    ``allow_leader`` slot 0 scores with its TRUE applied delta
    ``w·(replicas+consumers)`` and wins a target only when strictly
    better. ``c_rows [P, B]`` (with ``lam``) adds the anti-colocation
    terms. Returns ``(su, vals [B], p [B], slot [B])`` with ``vals``
    ABSOLUTE (``su``-based) and ineligible targets at +inf. This is the
    dense formulation of what the scoring kernel
    (``parallel/shard_kernel.py``) computes in one streaming pass.
    """
    P, R = replicas.shape
    B = loads.shape[0]
    dev = loads.device
    inf = float("inf")
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    F = torch.where(bvalid, overload_penalty(loads, avg), zero)  # [B]
    su = ordered_sum(F)

    w = weights[:, None]
    eligible = pvalid & (nrep_tgt >= min_replicas)  # [P]
    tmask = allowed & ~member & bvalid[None, :]
    lead_oh = replicas[:, 0:1] == torch.arange(B, device=dev)[None, :]
    colo_sub = colo_add = None
    if c_rows is not None:
        colo_sub, colo_add = colo_terms(c_rows, lam)

    # follower pass (member brokers minus the leader, delta = w)
    srcmask_f = member & ~lead_oh & eligible[:, None]
    A_f = _src_terms(loads, w, avg, F, colo_sub)
    A_f = torch.where(srcmask_f, A_f, torch.full_like(A_f, inf))
    A_star = A_f.amin(1)
    C_f = _tgt_terms(loads, w, avg, F, colo_add)
    V = torch.where(
        tmask & torch.isfinite(A_star)[:, None], A_star[:, None] + C_f,
        torch.full_like(C_f, inf),
    )
    vals, p = V.amin(0), V.argmin(0)

    # source slot recovery for the [B] winners only, ascending-slot ties
    rows = A_f[p]  # [B, B]
    rp = replicas[p]  # [B, R]
    slot_vals = rows.gather(1, rp.clamp(min=0).long())
    slot_iota = torch.arange(R, device=dev)[None, :]
    valid = (slot_iota >= 1) & (slot_iota < nrep_cur[p][:, None])
    slot = torch.where(valid, slot_vals, torch.full_like(slot_vals, inf)).argmin(1)

    if allow_leader:
        # leader pass (slot 0, delta = w·(replicas+consumers))
        wl = weights * (nrep_cur.to(loads.dtype) + ncons)
        ok_l = (nrep_cur >= 1) & eligible
        A_l_pb = _src_terms(loads, wl[:, None], avg, F, colo_sub)
        A_l = torch.where(
            lead_oh & ok_l[:, None], A_l_pb, torch.full_like(A_l_pb, inf)
        ).amin(1)
        C_l = _tgt_terms(loads, wl[:, None], avg, F, colo_add)
        V_l = torch.where(
            tmask & torch.isfinite(A_l)[:, None], A_l[:, None] + C_l,
            torch.full_like(C_l, inf),
        )
        vals_l, p_l = V_l.amin(0), V_l.argmin(0)
        lead_better = vals_l < vals
        vals = torch.where(lead_better, vals_l, vals)
        p = torch.where(lead_better, p_l, p)
        slot = torch.where(lead_better, torch.zeros_like(slot), slot)
    return su, su + vals, p, slot


def paired_best(
    loads: Tensor,
    replicas: Tensor,
    allowed: Tensor,
    member: Tensor,
    bvalid: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
    min_replicas: Scalar,
    *,
    allow_leader: bool,
    c_rows: Optional[Tensor] = None,
    lam: Optional[Scalar] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Best candidate per hot/cold broker-rank PAIR (:func:`pair_frame`):
    the best (partition, slot) moving OFF each pair's hot broker INTO its
    cold broker. Per-target winners alone degenerate in a batched session
    (one globally best partition wins every target); the pair winners
    have distinct sources and targets by construction.

    The math mirrors :func:`factored_target_best` term for term. Returns
    ``(vals [B2], p, slot, s, t, live)`` with ``vals`` ABSOLUTE (su-based)
    and dead/ineligible pairs at +inf.
    """
    B = loads.shape[0]
    dev = loads.device
    inf = float("inf")
    dtype = loads.dtype
    nb = bvalid.sum().to(dtype)
    zero = torch.zeros_like(loads)
    avg = ordered_sum(torch.where(bvalid, loads, zero)) / nb
    F = torch.where(bvalid, overload_penalty(loads, avg), zero)
    su = ordered_sum(F)

    s_i, t_i, live = pair_frame(loads, bvalid)

    w = weights[:, None]
    eligible = pvalid & (nrep_tgt >= min_replicas)  # [P]
    tmask = allowed & ~member & bvalid[None, :]
    lead_oh = replicas[:, 0:1] == torch.arange(B, device=dev)[None, :]
    colo_sub = colo_add = None
    if c_rows is not None:
        colo_sub, colo_add = colo_terms(c_rows, lam)

    def cols(values: Tensor, mask: Tensor, idx: Tensor) -> Tensor:
        v = values[:, idx]
        return torch.where(mask[:, idx] & live[None, :], v, torch.full_like(v, inf))

    # follower pass
    srcmask_f = member & ~lead_oh & eligible[:, None]
    A_f = _src_terms(loads, w, avg, F, colo_sub)
    C_f = _tgt_terms(loads, w, avg, F, colo_add)
    vals_f, p_f = argmin_rows(cols(A_f, srcmask_f, s_i) + cols(C_f, tmask, t_i))

    vals_l = p_l = None
    if allow_leader:
        wl = (weights * (nrep_cur.to(dtype) + ncons))[:, None]
        ok_l = (nrep_cur >= 1) & eligible
        A_l = _src_terms(loads, wl, avg, F, colo_sub)
        C_l = _tgt_terms(loads, wl, avg, F, colo_add)
        vals_l, p_l = argmin_rows(
            cols(A_l, lead_oh & ok_l[:, None], s_i) + cols(C_l, tmask, t_i)
        )

    vals, p, slot = pair_finish(
        replicas, nrep_cur, s_i, live, vals_f, p_f, vals_l, p_l,
        allow_leader=allow_leader,
    )
    return su + vals, p, slot, s_i, t_i, live


def scalar(x: Any, dtype: Any, device: Any) -> Tensor:
    """A 0-d tensor holding ``x`` rounded to ``dtype`` — how the session
    receives its float knobs (the reference rounds them to the session
    dtype on the host the same way)."""
    return torch.tensor(x, dtype=dtype, device=device)
