"""The whole-session kernel's acceptance in rank form, against
``scan.prefix_accept``.

``csrc/pallas_session.cu`` cannot run here, but the algorithm its
acceptance uses can. This file holds a small mirror of it (here, not in the
package): the ranks of the improving candidates' keys ``(order-preserving
value bits, index)``, partition claims as the lowest rank of each
partition, per-broker lists of the survivors, each survivor's net
prefix sums through those lists, added into
``ordered_sum``'s blocks of 32 level by level, the cut at the lowest
failing rank and the cap by a prefix count over the survivors in rank
order. It is held under ``==`` against ``scan.prefix_accept`` on seeded
numpy pools at float32 and float64: the accepted mask, the count, and the
log position of every accepted candidate (the kernel writes a position
only for those). Its net prefix sums are held against the lines of
``prefix_accept`` that compute them, and a crafted pool shows that a plain
left-to-right sum over the same sparse terms gives other bits.
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

from kafkabalancer_tpu_torch.ops.cost import ordered_sum
from kafkabalancer_tpu_torch.solvers.scan import prefix_accept
import torch_helpers  # noqa: F401  (torch CPU thread setting)

DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


def order_bits(v, dt):
    """The unsigned key whose order is the float order, -0.0 as +0.0 (the
    kernel's ``score::pack``)."""
    if v == 0:
        v = 0.0
    if dt is np.float32:
        u, top, mask = int(np.array(v, np.float32).view(np.uint32)), 1 << 31, (1 << 32) - 1
    else:
        u, top, mask = int(np.array(v, np.float64).view(np.uint64)), 1 << 63, (1 << 64) - 1
    return (~u & mask) if u & top else (u | top)


def levels(K):
    """ordered_sum's levels over K terms: (depth, lo1, lo2)."""
    if K <= 32:
        return 0, 0, 0
    nblk = -(-K // 32)
    lo1 = (nblk * 32 - K) // 2
    if nblk <= 32:
        return 1, lo1, 0
    nblk2 = -(-nblk // 32)
    return 2, lo1, (nblk2 * 32 - nblk) // 2


def sparse_ordered_sum(terms, K, dt):
    """ordered_sum over j = 0..K-1 of a vector that is zero but at
    ``terms`` ((j, value), ascending j): each term goes into its block of
    32's accumulator, a block is closed into the next level when the walk
    leaves it, and empty blocks are skipped."""
    depth, lo1, lo2 = levels(K)
    zero = dt(0.0)
    acc0, acc1, acc2 = zero, zero, zero
    cur1 = cur2 = -1

    def close1(bs, q1):
        nonlocal acc1, acc2, cur2
        if depth == 1:
            acc1 = acc1 + bs
            return
        q2 = (q1 + lo2) >> 5
        if q2 != cur2:
            if cur2 >= 0:
                acc2 = acc2 + acc1
            acc1, cur2 = zero, q2
        acc1 = acc1 + bs

    for j, v in terms:
        if depth == 0:
            acc0 = acc0 + v
            continue
        q1 = (j + lo1) >> 5
        if q1 != cur1:
            if cur1 >= 0:
                close1(acc0, cur1)
            acc0, cur1 = zero, q1
        acc0 = acc0 + v
    if depth == 0:
        return acc0
    if cur1 >= 0:
        close1(acc0, cur1)
    if depth == 1:
        return acc1
    if cur2 >= 0:
        acc2 = acc2 + acc1
    return acc2


def ltr_sum(terms, K, dt):
    """The same sparse terms added left to right: NOT ordered_sum."""
    acc = dt(0.0)
    for _, v in terms:
        acc = acc + v
    return acc


def penalty(load, avg, dt):
    rel = load / avg - dt(1.0)
    return rel * rel * (dt(1.0) if rel > 0 else dt(0.5))


def rank_accept(pool, *, summer=sparse_ordered_sum):
    """The kernel's acceptance on numpy scalars of the pool's type:
    ``(ok, pos, cnt, nets)`` with ``nets[k] = (Ls, Lt)`` per survivor."""
    vals, p, s_, t, w, loads = (pool[k] for k in ("vals", "p", "s", "t", "w", "loads"))
    avg, su, mu, churn = (pool[k] for k in ("avg", "su", "mu", "churn"))
    n, batch, budget, max_moves = (pool[k] for k in ("n", "batch", "budget", "max_moves"))
    dt = vals.dtype.type
    K, B = len(vals), len(loads)
    with np.errstate(all="ignore"):
        best = dt(np.nan) if np.isnan(vals).any() else su - vals.min()
        imp = [bool(np.isfinite(v) and v < su - mu and v < su
                    and (su - v) * churn >= best) for v in vals]
        ordk = [k for _, k in sorted((order_bits(vals[k], dt), k)
                                     for k in range(K) if imp[k])]
        rank = {k: i for i, k in enumerate(ordk)}
        surv, prev = set(), None
        for pk, r in sorted((int(p[k]), rank[k]) for k in ordk):
            if pk != prev:
                surv.add(ordk[r])
            prev = pk
        lists = defaultdict(list)
        for x, j, tgt in sorted((int(x), j, tgt) for j in surv
                                for x, tgt in ((s_[j], 0), (t[j], 1))):
            if 0 <= x < B:
                lists[x].append((j, tgt))
        nonfinite = int((~np.isfinite(w)).sum())

        def net(x, rk):
            terms, added_nf = [], 0
            for j, tgt in lists[x]:
                if rank[j] >= rk or s_[j] == t[j]:
                    continue
                added_nf += not np.isfinite(w[j])
                terms.append((j, w[j] if tgt else w[j] * dt(-1.0)))
            return dt(np.nan) if added_nf < nonfinite else summer(terms, K, dt)

        nets, passed, first_fail = {}, {}, K
        for k in surv:
            Ls = loads[s_[k]] + net(int(s_[k]), rank[k])
            Lt = loads[t[k]] + net(int(t[k]), rank[k])
            nets[k] = (Ls, Lt)
            d = (penalty(Ls - w[k], avg, dt) - penalty(Ls, avg, dt)
                 + penalty(Lt + w[k], avg, dt) - penalty(Lt, avg, dt))
            passed[k] = bool(d < -mu and d < 0)
            if not passed[k]:
                first_fail = min(first_fail, rank[k])
    ok = np.zeros(K, bool)
    pos = np.full(K, -1)
    before = 0
    for i, k in enumerate(ordk):
        if k not in surv:
            continue
        if passed[k]:
            pos[k] = n + before
            ok[k] = (i < first_fail and pos[k] < n + batch and pos[k] < budget
                     and pos[k] < max_moves)
        before += 1
    return ok, pos, int(ok.sum()), nets


def tensors(pool):
    tdt = DTYPES[pool["vals"].dtype.type]
    f = {k: torch.tensor(pool[k], dtype=tdt) for k in ("vals", "w", "loads", "avg", "su", "mu", "churn")}
    i = {k: torch.tensor(pool[k], dtype=torch.long) for k in ("p", "s", "t")}
    return f, i


def plain_accept(pool):
    f, i = tensors(pool)
    ok, pos, cnt = prefix_accept(
        f["vals"], i["p"], i["s"], i["t"], f["w"], f["loads"], f["avg"],
        f["su"], f["mu"], f["churn"], pool["n"], pool["batch"],
        pool["budget"], pool["max_moves"],
    )
    return ok.numpy(), pos.numpy(), int(cnt)


def plain_nets(pool):
    """``Ls`` and ``Lt`` as ``scan.prefix_accept`` computes them (its own
    lines, scan.py:139-160)."""
    f, i = tensors(pool)
    vals, w_k, loads, su, mu = f["vals"], f["w"], f["loads"], f["su"], f["mu"]
    p, s_, t = i["p"], i["s"], i["t"]
    kk = torch.arange(vals.shape[0])
    improving = torch.isfinite(vals) & (vals < su - mu) & (vals < su)
    improving &= (su - vals) * f["churn"] >= su - vals.amin()
    E = (vals[:, None] < vals[None, :]) | (
        (vals[:, None] == vals[None, :]) & (kk[:, None] < kk[None, :]))
    claimed = E & improving[:, None] & (p[:, None] == p[None, :])
    surv = improving & ~claimed.any(0)
    wEj = (E & surv[:, None]).to(vals.dtype) * w_k[:, None]
    to_s = (t[:, None] == s_[None, :]).to(vals.dtype) - (s_[:, None] == s_[None, :]).to(vals.dtype)
    to_t = (t[:, None] == t[None, :]).to(vals.dtype) - (s_[:, None] == t[None, :]).to(vals.dtype)
    Ls = loads[s_] + ordered_sum(wEj * to_s, 0)
    Lt = loads[t] + ordered_sum(wEj * to_t, 0)
    return surv.numpy(), Ls.numpy(), Lt.numpy()


def make_pool(seed, K, dt, *, ties=False, hot=False, reps=False,
              zeros=False, nonfinite_vals=False, nonfinite_w=False,
              caps=False, churn=1.5):
    """A seeded pool: loads over B brokers, candidates that move load from
    the upper brokers to the lower ones, values below su."""
    rng = np.random.default_rng(seed)
    B = max(2, (2 * K) // 3)
    loads = np.sort(rng.uniform(50.0, 150.0, B))[::-1].astype(dt)
    avg = dt(loads.mean())
    su = dt(rng.uniform(1.0, 2.0))
    if ties:
        gains = rng.integers(1, 5, K) * 0.125
    else:
        gains = rng.uniform(0.0, 0.5, K)
    vals = (su - gains).astype(dt)
    vals[rng.random(K) < 0.1] = np.inf  # dead candidates
    half = max(1, B // 2)
    s_ = rng.integers(0, half, K)
    t = rng.integers(half, B, K)
    if hot:
        s_[rng.random(K) < 0.8] = 0
    P = max(1, K // 4) if reps else 10 * K
    p = rng.integers(0, P, K)
    w = rng.uniform(0.1, 3.0, K).astype(dt)
    if zeros:
        z = rng.random(K)
        w[z < 0.15] = 0.0
        w[(z >= 0.15) & (z < 0.3)] = -0.0
    if nonfinite_vals:
        vals[rng.integers(0, K, 2)] = [np.nan, -np.inf][rng.integers(0, 2)]
    if nonfinite_w:
        w[rng.integers(0, K)] = np.inf
    n = int(rng.integers(0, 50))
    batch, budget, max_moves = K, 1 << 20, 1 << 20
    if caps:
        batch, budget, max_moves = 3, n + 5, n + 4
    return dict(vals=vals, p=p, s=s_, t=t, w=w, loads=loads, avg=avg, su=su,
                mu=dt(1e-7), churn=dt(churn), n=n, batch=batch,
                budget=budget, max_moves=max_moves)


CASES = {
    "plain": {},
    "ties": dict(ties=True),
    "hot": dict(hot=True),
    "repeated_partitions": dict(reps=True),
    "zero_weights": dict(zeros=True),
    "nonfinite_values": dict(nonfinite_vals=True),
    "nonfinite_weight": dict(nonfinite_w=True),
    "caps": dict(caps=True),
    "wide_gate": dict(churn=1e9),
    "wide_gate_ties_hot": dict(churn=1e9, ties=True, hot=True, zeros=True),
}


def check(pool):
    ok, pos, cnt, nets = rank_accept(pool)
    ok_p, pos_p, cnt_p = plain_accept(pool)
    assert cnt == cnt_p
    assert np.array_equal(ok, ok_p)
    assert np.array_equal(pos[ok], pos_p[ok])
    surv, Ls, Lt = plain_nets(pool)
    assert sorted(nets) == list(np.flatnonzero(surv))
    for k, (ls, lt) in nets.items():
        np.testing.assert_array_equal([ls, lt], [Ls[k], Lt[k]])
    return cnt


# K = 1536 (ordered_sum's second level) on the cases whose lists stay
# short: a hot broker's list walk is K^2 steps in Python
WIDE_CASES = ("caps", "plain", "repeated_partitions", "ties", "wide_gate",
              "zero_weights")


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("K,case", [
    (K, case) for K in (3, 48, 100, 192, 384, 1536) for case in sorted(CASES)
    if K < 1536 or case in WIDE_CASES
])
def test_rank_accept_matches_prefix_accept(K, case, dt):
    cnt = check(make_pool(K * 31 + sorted(CASES).index(case), K, dt, **CASES[case]))
    if case in ("plain", "wide_gate") and K >= 48:
        assert cnt > 1  # the pools accept something to compare


def crafted_pool(dt):
    """64 candidates (two blocks of 32, no pad): survivors 0, 33 and 34
    put +1, +1e8 and -1e8 on broker 0 before candidate 40 targets it."""
    K = 64
    vals = np.full(K, np.inf, dt)
    p = np.arange(K)
    s_ = np.full(K, 2)
    t = np.full(K, 1)
    w = np.ones(K, dt)
    for j, (val, src, tgt, wt) in {
        0: (-4.0, 2, 0, 1.0), 33: (-3.0, 2, 0, 1e8), 34: (-2.0, 0, 3, 1e8),
        40: (-1.0, 2, 0, 1.0),
    }.items():
        vals[j], s_[j], t[j], w[j] = val, src, tgt, wt
    loads = np.array([10.0, 20.0, 30.0, 40.0], dt)
    return dict(vals=vals, p=p, s=s_, t=t, w=w, loads=loads, avg=dt(25.0),
                su=dt(0.0), mu=dt(0.0), churn=dt(1e9), n=0, batch=K,
                budget=1 << 20, max_moves=1 << 20)


def test_left_to_right_sparse_sum_differs():
    """The terms at broker 0 before candidate 40 are +1 (block 0), +1e8
    and -1e8 (block 1): ordered_sum gives 1 + (1e8 - 1e8) = 1, left to
    right (1 + 1e8) - 1e8 = 0 at float32. The mirror reproduces
    prefix_accept's Lt; the left-to-right variant does not."""
    pool = crafted_pool(np.float32)
    check(pool)
    _, Ls, Lt = plain_nets(pool)
    nets = rank_accept(pool)[3]
    wrong = rank_accept(pool, summer=ltr_sum)[3]
    assert nets[40][1] == Lt[40] == np.float32(11.0)
    assert wrong[40][1] == np.float32(10.0) != Lt[40]
