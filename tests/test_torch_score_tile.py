"""The scoring pass's block schedule (``csrc/score_tile.cuh``) against
``shard_score_plain``.

The CUDA kernel cannot run here, but its schedule can. This file holds a
small mirror of it (here, not in the package), at float32:

- the persistent split: each block takes a contiguous chunk of rows (a
  multiple of 16) and walks it in tiles (``score::split_rows``);
- per tile, the row pass: every row's source minima A* and A_l, and its
  pair candidates offered to the keys by packed-key minimum;
- per tile, the ascending list of the live rows (finite A*, or A_l with
  leaders); dead rows are never scanned;
- the target pass: target groups of ``kT`` adjacent brokers (2 up to
  B = 128, 4 above, as the kernels choose) × row groups,
  each (group, row group) scanning its share of the list (entries rg, rg +
  RG, ...) with a strict < and keeping its running minima across all the
  block's tiles, merged by packed key once per block; with more groups
  than threads, every group scans every live row and merges per tile;
- the block's keys offered once to the device keys, then unpacked.

It is held under ``==`` against ``shard_score_plain`` on seeded numpy
inputs in all eight variants (allowed × colocation × leader), with ties,
signed zeros, a NaN source, fully padded tiles, P not a multiple of the
tile, more tiles than blocks, B not a multiple of 4 and more target groups
than threads.

The kernel divides by ``avg`` through its rounded reciprocal and one FMA
correction (``score::quot``). That sequence is emulated here exactly
(``fractions.Fraction`` results rounded to binary32) and held against
numpy's float32 division on seeded and edge inputs; the card checks it for
every finite float32 x (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from kafkabalancer_tpu_torch.parallel.shard_kernel import shard_score_plain
from torch_helpers import synthetic

EMPTY = np.uint64((1 << 64) - 1)
F32 = np.float32


def round16(n):
    return (n + 15) & ~15


def split_rows(P, resident, max_rows):
    """``score::split_rows``: (chunk, tile, blocks)."""
    chunk = max(16, round16(-(-P // max(1, resident))))
    return chunk, min(max_rows, chunk), (-(-P // chunk) if P > 0 else 1)


def pack(v, rows):
    """``score::pack`` over arrays: (order-preserving bits << 32 | row),
    -0.0 as +0.0."""
    v = np.where(v == 0, F32(0), v).astype(F32)
    u = v.view(np.uint32).astype(np.uint64)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xFFFFFFFF),
                 u | np.uint64(0x80000000))
    return (u << np.uint64(32)) | np.asarray(rows).astype(np.uint64)


def unpack(k):
    v = np.full(k.shape, np.inf, F32)
    row = np.zeros(k.shape, np.int32)
    full = k != EMPTY
    u = (k[full] >> np.uint64(32)).astype(np.uint32)
    u = np.where(u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF), ~u)
    v[full] = u.astype(np.uint32).view(F32)
    row[full] = (k[full] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return v, row


def offer(keys, idx, v, rows):
    """atomicMin of (v, row) into keys[idx] where v < +inf."""
    idx, v, rows = np.atleast_1d(idx), np.atleast_1d(v), np.atleast_1d(rows)
    ok = v < np.inf
    np.minimum.at(keys, idx[ok], pack(v[ok], rows[ok]))


def penalty(x, avg):
    rel = x / avg - F32(1)
    return rel * rel * np.where(rel > 0, F32(1), F32(0.5))


def mirror(args, allow_leader, resident, max_tile=64, threads=256, kT=None):
    """The kernel's schedule over ``shard_score``'s 12 arguments (numpy,
    float32); returns its eight outputs. ``kT`` defaults to the kernels'
    choice for the broker bucket."""
    (replicas, cols, member, allowed, loads, F, bvalid, scal, s_i, t_i,
     live, crows) = [None if a is None else a.cpu().numpy() for a in args]
    P, B = member.shape
    B2 = s_i.shape[0]
    avg, minrep, lam = scal
    ncol = 2 * B + 2 * B2
    gkeys = np.full(ncol, EMPTY, np.uint64)
    if kT is None:
        kT = 2 if B <= 128 else 4
    chunk, tile, blocks = split_rows(P, resident, max_tile)
    G = -(-B // kT)
    persist = G <= threads
    RG = threads // G if persist else 1
    Bp = G * kT  # targets padded to whole groups; the pad is never valid
    L = np.zeros(Bp, F32)
    Fp = np.zeros(Bp, F32)
    valid = np.zeros(Bp, bool)
    L[:B], Fp[:B], valid[:B] = loads, F, bvalid
    hot = [np.flatnonzero(live & (s_i == b)) for b in range(B)]

    def row_pass(p, bkeys):
        """(A*, A_l, w, wl) of row p; its pair candidates into bkeys."""
        w, ncur, ntgt, ncons, pv = cols[p]
        elig = pv > 0 and ntgt >= minrep
        lead = int(replicas[p, 0])
        tmask = bvalid & ~member[p]
        if allowed is not None:
            tmask = tmask & allowed[p]

        def pair_target(t, delta):
            C = penalty(loads[t] + delta, avg) - F[t]
            if crows is not None:
                C = C + np.where(crows[p, t] >= 1, lam, F32(0))
            return np.where(tmask[t], C, F32(np.inf))

        def sources(bs, delta, off):
            A = penalty(loads[bs] - delta, avg) - F[bs]
            if crows is not None:
                A = A - np.where(crows[p, bs] >= 2, lam, F32(0))
            for b, a in zip(bs, A):
                pcs = hot[b]
                if len(pcs):
                    offer(bkeys, off + pcs, a + pair_target(t_i[pcs], delta), p)
            return A

        src = np.flatnonzero(member[p] & (np.arange(B) != lead)) if elig else []
        A = sources(np.asarray(src, int), w, 2 * B)
        astar = F32(np.nan) if np.isnan(A).any() else (
            A.min() if len(A) else F32(np.inf))
        wl = w * (ncur + ncons)
        al = F32(np.inf)
        if allow_leader and ncur >= 1 and elig and 0 <= lead < B:
            al = sources(np.asarray([lead]), wl, 2 * B + B2)[0]
        return astar, al, w, wl

    def scan(acc, r_rows, terms, p0):
        """One (row group, all target groups) strict-< scan over rows."""
        vf, rf, vl, rl = acc
        for r in r_rows:
            p = p0 + r
            astar, al, w, wl = terms[r]
            ok = valid.copy()
            ok[:B] &= ~member[p]
            if allowed is not None:
                ok[:B] &= allowed[p]
            add = F32(0)
            if crows is not None:
                add = np.zeros(Bp, F32)
                add[:B] = np.where(crows[p] >= 1, lam, F32(0))
            for a, d, v_, r_ in ((astar, w, vf, rf), (al, wl, vl, rl)):
                if v_ is vl and not allow_leader:
                    continue
                C = penalty(L + d, avg) - Fp
                if crows is not None:
                    C = C + add
                v = a + C
                take = ok & np.isfinite(a) & (v < v_)
                v_[take] = v[take]
                r_[take] = p

    def fresh(n):
        return [np.full((n, Bp), np.inf, F32), np.zeros((n, Bp), np.int64),
                np.full((n, Bp), np.inf, F32), np.zeros((n, Bp), np.int64)]

    def flush(acc, bkeys, i):
        vf, rf, vl, rl = acc
        offer(bkeys, np.arange(B), vf[i, :B], rf[i, :B])
        if allow_leader:
            offer(bkeys, B + np.arange(B), vl[i, :B], rl[i, :B])

    with np.errstate(all="ignore"):
        for blk in range(blocks):
            r0, r1 = blk * chunk, min(P, (blk + 1) * chunk)
            if r0 >= r1:
                continue
            bkeys = np.full(ncol, EMPTY, np.uint64)
            acc = fresh(RG)
            for p0 in range(r0, r1, tile):
                nrows = min(tile, r1 - p0)
                terms = [row_pass(p0 + r, bkeys) for r in range(nrows)]
                lst = [r for r in range(nrows) if np.isfinite(terms[r][0])
                       or (allow_leader and np.isfinite(terms[r][1]))]
                if persist:
                    for rg in range(RG):
                        scan([a[rg] for a in acc], lst[rg::RG], terms, p0)
                else:
                    part = fresh(1)
                    scan([a[0] for a in part], lst, terms, p0)
                    flush(part, bkeys, 0)
            if persist:
                for rg in range(RG):
                    flush(acc, bkeys, rg)
            np.minimum(gkeys, bkeys, out=gkeys)
    vf, pf = unpack(gkeys[:B])
    vl, pl = unpack(gkeys[B:2 * B])
    vpf, ppf = unpack(gkeys[2 * B:2 * B + B2])
    vpl, ppl = unpack(gkeys[2 * B + B2:])
    return vf, pf, vl, pl, vpf, ppf, vpl, ppl


NAMES = ("vf", "pf", "vl", "pl", "vpf", "ppf", "vpl", "ppl")


def variants(full, restricted, colo):
    args = list(full)
    if not restricted:
        args[3] = None
    if not colo:
        args[11] = None
        args[7] = args[7].clone()
        args[7][2] = 0.0
    return args


def assert_mirror_equals_plain(full, resident, **kw):
    for restricted in (False, True):
        for colo in (False, True):
            args = variants(full, restricted, colo)
            for lead in (False, True):
                got = mirror(args, lead, resident, **kw)
                ref = shard_score_plain(*args, allow_leader=lead)
                for name, a, b in zip(NAMES, got, ref):
                    b = b.numpy()
                    assert np.array_equal(a == a, b == b), name
                    assert np.array_equal(a, b), (
                        name, restricted, colo, lead,
                        np.flatnonzero(a != b)[:8])
                assert np.isfinite(got[0]).any()


# (P, B, real rows, resident blocks, extra mirror settings)
CASES = [
    (200, 20, 200, 4, {}),  # one tile per block, 16-row chunks
    (300, 24, 300, 2, {"max_tile": 32}),  # more tiles than blocks
    (333, 13, 333, 3, {}),  # P not a multiple of the tile; B % 4 != 0
    (256, 30, 100, 2, {"max_tile": 16}),  # fully padded tiles; B % 4 != 0
    (150, 40, 150, 2, {"threads": 8}),  # more target groups than threads
    (96, 9, 96, 1, {"threads": 32, "kT": 4}),  # four targets, 3 groups
    (96, 150, 80, 2, {}),  # four targets per thread (B > 128), B % 4 != 0
]


@pytest.mark.parametrize("equal_weights", [False, True])
@pytest.mark.parametrize("P,B,n_real,resident,kw", CASES)
def test_mirror_matches_plain(P, B, n_real, resident, kw, equal_weights):
    full = synthetic(P, B, "cpu", seed=P + B, n_real=n_real,
                     equal_weights=equal_weights)
    chunk, tile, blocks = split_rows(P, resident, kw.get("max_tile", 64))
    assert blocks <= resident
    assert_mirror_equals_plain(full, resident, **kw)


def test_mirror_skips_dead_rows_and_walks_many_tiles():
    """The split's shape for the cases above: several tiles per block,
    ragged last tiles, and whole tiles of padding."""
    assert split_rows(300, 2, 32) == (160, 32, 2)
    assert split_rows(333, 3, 64) == (112, 64, 3)
    assert split_rows(16384, 528, 64) == (32, 32, 512)
    assert split_rows(131072, 528, 64) == (256, 64, 512)
    assert split_rows(0, 528, 64) == (16, 16, 1)


def test_mirror_with_a_nan_source_and_signed_zeros():
    """A NaN penalty at one broker (its rows drop out as sources, its cells
    never win), -0.0 penalties of invalid brokers and a -0.0 lambda."""
    full = synthetic(200, 24, "cpu", seed=3, n_real=180)
    F = full[5].clone()
    F[~full[6]] = -0.0
    F[2] = float("nan")
    full[5] = F
    full[7] = full[7].clone()
    full[7][2] = -0.0
    for lead in (False, True):
        args = variants(full, True, True)
        ref = shard_score_plain(*args, allow_leader=lead)
        got = mirror(args, lead, 3)
        for name, a, b in zip(NAMES, got, ref):
            assert np.array_equal(a, b.numpy()), name
    assert_mirror_equals_plain(full, 3)


def test_packed_keys_order_signed_zeros_as_one_value():
    """-0.0 and +0.0 pack alike, so the lowest row wins between them, as a
    strict-< scan over ascending rows keeps the first of equal values."""
    keys = np.full(1, EMPTY, np.uint64)
    offer(keys, [0, 0, 0], np.array([0.0, -0.0, 0.0], F32), [9, 4, 7])
    v, row = unpack(keys)
    assert row[0] == 4 and v[0] == 0 and not np.signbit(v[0])
    order = pack(np.array([-np.inf, -1, -0.0, 0.0, 1e-45, 1, np.inf], F32),
                 np.zeros(7, np.int64))
    assert (np.diff(order.astype(object)) >= 0).all()
    assert order[2] == order[3]


# ---- the reciprocal division -------------------------------------------


def rn32(fr):
    """A rational rounded to the nearest binary32, ties to even (with
    subnormals and overflow to infinity)."""
    if fr == 0:
        return F32(0.0)
    sign = -1 if fr < 0 else 1
    a = abs(fr)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n = a / quantum
    q, rem = divmod(n.numerator, n.denominator)
    if 2 * rem > n.denominator or (2 * rem == n.denominator and q & 1):
        q += 1
    val = q * quantum
    if val >= Fraction(2) ** 128:
        return F32(sign * np.inf)
    return F32(sign * float(val))


def quot(x, avg):
    """``score::quot`` emulated exactly: for avg in [2^-40, 2^40] and |x|
    in [2^-60, 2^60], y = RN(1/avg), q = RN(x*y), r = RN(x - avg*q),
    RN(q + r*y) (each FMA rounds once); else the IEEE division."""
    x, avg = F32(x), F32(avg)
    if 2.0**-40 <= avg <= 2.0**40 and 2.0**-60 <= abs(x) <= 2.0**60:
        fx, fa = Fraction(float(x)), Fraction(float(avg))
        y = Fraction(float(rn32(1 / fa)))
        q = Fraction(float(rn32(fx * y)))
        r = Fraction(float(rn32(fx - fa * q)))
        return rn32(q + r * y)
    with np.errstate(all="ignore"):
        return x / avg


def from_bits(u):
    return np.asarray(u, np.uint32).view(F32)


def test_rn32_agrees_with_numpy_on_its_own_results():
    rng = np.random.default_rng(1)
    for v in np.concatenate([rng.standard_normal(200).astype(F32) * 1e3,
                             from_bits([1, 0x7FFFFF, 0x800000, 0x7F7FFFFF])]):
        assert rn32(Fraction(float(v))) == v
    half_ulp = Fraction(1, 2**24)
    assert rn32(1 + half_ulp) == F32(1)  # a tie goes to even
    assert rn32(1 + 3 * half_ulp) == F32(1 + 2.0**-22)


@pytest.mark.parametrize("seed", range(4))
def test_reciprocal_division_matches_numpy(seed):
    """Seeded x over many binades and avgs from sessions' range, plus
    subnormal, huge, power-of-two and all-ones-significand inputs, at
    avgs that include powers of two and all-ones significands."""
    rng = np.random.default_rng(seed)
    ones = [from_bits(e << 23 | 0x7FFFFF) for e in (100, 127, 130, 150)]
    avgs = [F32(1), F32(2.0**-39), F32(2.0**39), F32(3), *ones,
            *(F32(v) for v in 10.0 ** rng.uniform(-3, 7, 6))]
    xs = np.concatenate([
        (rng.standard_normal(150) * 10.0 ** rng.uniform(-8, 8, 150)).astype(F32),
        from_bits(rng.integers(0, 2**32, 100, dtype=np.uint64)),
        from_bits([1, 2, 0x7FFFFF, 0x800000, 0x7F7FFFFF, 0xFF7FFFFF,
                   0x80000001]),
        np.array([0.0, -0.0, 2.0**-60, 2.0**60, 2.0**61, 2.0**-61, 1.0,
                  -2.0, 0.5], F32),
        *([o, -o] for o in ones),
    ])
    xs = xs[np.isfinite(xs)]
    for avg in avgs:
        with np.errstate(all="ignore"):
            ref = xs / avg
        got = np.array([quot(x, avg) for x in xs], F32)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), (
            avg, xs[got.view(np.uint32) != ref.view(np.uint32)][:4])
