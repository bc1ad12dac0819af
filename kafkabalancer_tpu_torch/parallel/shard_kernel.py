"""The converge session's scoring pass: the hand-written Hopper kernel
(``csrc/shard_score.cu``), its plain torch version, and the build.

Counterpart of the reference package's ``parallel/shard_kernel.py``. Per
session iteration the scoring pass is the only O(P·B) work: for every
target broker the best (lowest ``A* + C``) source partition, for every
hot/cold broker pair the best partition moving off the hot broker into
the cold one, each for followers and — with ``allow_leader`` — for
leaders. The caller does the leader merges and the winners' slot
recovery (``solvers/scan.py``), exactly as the reference's shard body
does around its Pallas kernel.

:func:`shard_score` dispatches on the tensors' device: a CPU tensor runs
:func:`shard_score_plain`, a CUDA tensor launches the kernel or raises.
There is no fallback between the two. The kernel is built with ``nvcc``
into a shared library with a plain C interface at first use
(:mod:`kafkabalancer_tpu_torch.ops.nvcc`) and loaded with ``ctypes``.

:func:`shard_score_batched` scores K same-shape instances stacked on a
leading axis in ONE launch (the grid's y dimension is the instance),
each instance's outputs bit for bit a solo launch's; its plain version
:func:`shard_score_batched_plain` is a loop over
:func:`shard_score_plain`. The instance-batched session
(``solvers/scan.py`` ``session_batched``) calls it every iteration.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from kafkabalancer_tpu_torch.models.config import kernel_dtype
from kafkabalancer_tpu_torch.ops import nvcc
from kafkabalancer_tpu_torch.ops.cost import argmin_rows, colo_terms, overload_penalty

Tensor = torch.Tensor


def pack_cols(
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    ncons: Tensor,
    pvalid: Tensor,
) -> Tensor:
    """The session-static per-partition vectors as one ``[P, 5]`` input
    in the weights' dtype (w | ncur | ntgt | ncons | pvalid); every value
    is exact in float32 (weights are float32 there, the rest small
    integers). Leading dimensions are instances (``[K, P]`` inputs give
    ``[K, P, 5]``)."""
    dtype = weights.dtype
    return torch.stack(
        [weights, nrep_cur.to(dtype), nrep_tgt.to(dtype), ncons.to(dtype),
         pvalid.to(dtype)],
        dim=-1,
    )


def shard_score_plain(
    replicas: Tensor,  # [P, R] int32
    cols: Tensor,  # [P, 5] (pack_cols)
    member: Tensor,  # [P, B] bool
    allowed: Optional[Tensor],  # [P, B] bool; None = every broker allowed
    loads: Tensor,  # [B]
    F: Tensor,  # [B] per-broker penalty (0 on invalid brokers)
    bvalid: Tensor,  # [B] bool
    scal: Tensor,  # [3]: avg | min_replicas | lam
    s_i: Tensor,  # [B2] int32 hot broker of each pair (cost.pair_frame)
    t_i: Tensor,  # [B2] int32 cold broker of each pair
    live: Tensor,  # [B2] bool
    c_rows: Optional[Tensor] = None,  # [P, B] same-topic counts (colocation)
    *,
    allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """The kernel's function in plain torch, at the dtype of ``loads``
    (the kernel itself is float32 only).

    Returns ``(vals_f [B], p_f [B], vals_l [B], p_l [B], vals_pf [B2],
    p_pf [B2], vals_pl [B2], p_pl [B2])``: raw ``A + C`` minima (no ``su``
    offset) with their lowest global row, +inf and row 0 where a column
    has no candidate (every leader output, when ``allow_leader`` is
    off).
    """
    inf = float("inf")
    P, B = member.shape
    dev = loads.device
    w = cols[:, 0:1]
    ncur = cols[:, 1:2]
    ntgt = cols[:, 2:3]
    ncons = cols[:, 3:4]
    pvalid = cols[:, 4:5] > 0
    avg, minrep, lam = scal[0], scal[1], scal[2]
    colo_sub = colo_add = None
    if c_rows is not None:
        colo_sub, colo_add = colo_terms(c_rows, lam)

    lead_oh = replicas[:, 0:1] == torch.arange(B, device=dev)[None, :]
    eligible = pvalid & (ntgt >= minrep)
    tmask = ~member & bvalid[None, :]
    if allowed is not None:
        tmask = tmask & allowed
    live_row = live[None, :]
    s_idx, t_idx = s_i.long(), t_i.long()

    def src(delta: Tensor) -> Tensor:
        A = overload_penalty(loads[None, :] - delta, avg) - F[None, :]
        return A if colo_sub is None else A - colo_sub

    def tgt(delta: Tensor) -> Tensor:
        C = overload_penalty(loads[None, :] + delta, avg) - F[None, :]
        return C if colo_add is None else C + colo_add

    def targets(A_src: Tensor, C: Tensor) -> Tuple[Tensor, Tensor]:
        ok = tmask & torch.isfinite(A_src)
        return argmin_rows(torch.where(ok, A_src + C, torch.full_like(C, inf)))

    def pairs(A: Tensor, srcmask: Tensor, C: Tensor) -> Tuple[Tensor, Tensor]:
        ok = srcmask[:, s_idx] & tmask[:, t_idx] & live_row
        v = A[:, s_idx] + C[:, t_idx]
        return argmin_rows(torch.where(ok, v, torch.full_like(v, inf)))

    srcmask = member & ~lead_oh & eligible
    A0 = src(w)
    A_star = torch.where(srcmask, A0, torch.full_like(A0, inf)).amin(1, keepdim=True)
    C = tgt(w)
    vf, pf = targets(A_star, C)
    vpf, ppf = pairs(A0, srcmask, C)

    if allow_leader:
        wl = w * (ncur + ncons)
        srcmask_l = lead_oh & (ncur >= 1) & eligible
        A_l0 = src(wl)
        A_l = torch.where(srcmask_l, A_l0, torch.full_like(A_l0, inf)).amin(
            1, keepdim=True
        )
        C_l = tgt(wl)
        vl, pl_ = targets(A_l, C_l)
        vpl, ppl = pairs(A_l0, srcmask_l, C_l)
    else:
        vl = torch.full_like(vf, inf)
        pl_ = torch.zeros_like(pf)
        vpl = torch.full_like(vpf, inf)
        ppl = torch.zeros_like(ppf)
    return vf, pf, vl, pl_, vpf, ppf, vpl, ppl


SOURCE = "shard_score.cu"


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.c_void_p
    I = ctypes.c_int
    lib.shard_score_launch.argtypes = [P] * 12 + [I] * 5 + [P] * 10
    lib.shard_score_launch.restype = I
    lib.shard_score_batched_launch.argtypes = [P] * 12 + [I] * 6 + [P] * 10
    lib.shard_score_batched_launch.restype = I
    lib.shard_score_scratch_words.argtypes = [I, I]
    lib.shard_score_scratch_words.restype = ctypes.c_longlong
    lib.shard_score_div_check.argtypes = [P, I, P, P]
    lib.shard_score_div_check.restype = I
    lib.shard_score_error_string.argtypes = [I]
    lib.shard_score_error_string.restype = ctypes.c_char_p


def _load() -> ctypes.CDLL:
    return nvcc.load(SOURCE, _bind)


def _check(t: Tensor, name: str, dtype: Any, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"shard_score: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"shard_score: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"shard_score: {name} shape {tuple(t.shape)} != {shape}"
        )
    if not t.is_contiguous():
        raise ValueError(f"shard_score: {name} must be contiguous")


def _launch(
    replicas: Tensor, cols: Tensor, member: Tensor, allowed: Optional[Tensor],
    loads: Tensor, F: Tensor, bvalid: Tensor, scal: Tensor, s_i: Tensor,
    t_i: Tensor, live: Tensor, c_rows: Optional[Tensor], allow_leader: bool,
    K: Optional[int] = None,
) -> Tuple[Tensor, ...]:
    """One launch over ``K`` instances stacked on a leading axis, or over
    one instance without that axis (``K`` None)."""
    lead: Tuple[int, ...] = () if K is None else (K,)
    n = len(lead)
    P, R = replicas.shape[n:]
    B = member.shape[n + 1]
    B2 = s_i.shape[n]
    f32, i32 = kernel_dtype(), torch.int32
    _check(replicas, "replicas", i32, lead + (P, R))
    _check(cols, "cols", f32, lead + (P, 5))
    _check(member, "member", torch.bool, lead + (P, B))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, lead + (P, B))
    if c_rows is not None:
        _check(c_rows, "c_rows", f32, lead + (P, B))
    _check(loads, "loads", f32, lead + (B,))
    _check(F, "F", f32, lead + (B,))
    _check(bvalid, "bvalid", torch.bool, lead + (B,))
    _check(scal, "scal", f32, lead + (3,))
    _check(s_i, "s_i", i32, lead + (B2,))
    _check(t_i, "t_i", i32, lead + (B2,))
    _check(live, "live", torch.bool, lead + (B2,))
    if len({t.device for t in (replicas, member, loads, s_i)}) != 1:
        raise ValueError("shard_score: inputs on different devices")

    lib = _load()
    dev = loads.device
    # scratch, cleared by the launch: per instance, copies of one 64-bit
    # (value, row) key per output column, then the kernel's count of
    # finished blocks
    scratch = torch.empty(
        (K or 1) * lib.shard_score_scratch_words(B, B2), dtype=torch.int64,
        device=dev,
    )
    vf = torch.empty(lead + (B,), dtype=f32, device=dev)
    vl = torch.empty(lead + (B,), dtype=f32, device=dev)
    pf = torch.empty(lead + (B,), dtype=i32, device=dev)
    pl_ = torch.empty(lead + (B,), dtype=i32, device=dev)
    vpf = torch.empty(lead + (B2,), dtype=f32, device=dev)
    vpl = torch.empty(lead + (B2,), dtype=f32, device=dev)
    ppf = torch.empty(lead + (B2,), dtype=i32, device=dev)
    ppl = torch.empty(lead + (B2,), dtype=i32, device=dev)

    def ptr(t: Optional[Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.shard_score_batched_launch(
            ptr(replicas), ptr(cols), ptr(member), ptr(allowed), ptr(c_rows),
            ptr(loads), ptr(F), ptr(bvalid), ptr(scal), ptr(s_i), ptr(t_i),
            ptr(live), K or 1, P, R, B, B2, int(bool(allow_leader)),
            ptr(scratch),
            ptr(vf), ptr(pf), ptr(vl), ptr(pl_), ptr(vpf), ptr(ppf),
            ptr(vpl), ptr(ppl), stream,
        )
    if err != 0:
        msg = lib.shard_score_error_string(err).decode()
        raise RuntimeError(f"shard_score kernel launch failed: {msg} ({err})")
    nvcc.count_launch(shard_score if K is None else shard_score_batched)
    return vf, pf, vl, pl_, vpf, ppf, vpl, ppl


def div_mismatches(avgs: Tensor) -> Tensor:
    """The kernel's division check, on the card: for each ``avgs[j]``
    (float32, CUDA), how many finite float32 ``x`` give a quotient in the
    scoring pass (``x / avg`` through the rounded reciprocal and one FMA
    correction, ``score::quot``) whose bits differ from the IEEE ``x /
    avg``. Every one of the 2**32 bit patterns is tried; all zeros means
    the two divisions agree for that ``avg``. Returns int64 counts."""
    _check(avgs, "avgs", kernel_dtype(), (avgs.shape[0],))
    lib = _load()
    bad = torch.empty(avgs.shape[0], dtype=torch.int64, device=avgs.device)
    with torch.cuda.device(avgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.shard_score_div_check(
            avgs.data_ptr(), avgs.shape[0], bad.data_ptr(), stream
        )
    if err != 0:
        msg = lib.shard_score_error_string(err).decode()
        raise RuntimeError(f"shard_score division check failed: {msg} ({err})")
    return bad


# device-loop: the scoring kernel's wrapper, called by every session iteration
def shard_score(
    replicas: Tensor,
    cols: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    loads: Tensor,
    F: Tensor,
    bvalid: Tensor,
    scal: Tensor,
    s_i: Tensor,
    t_i: Tensor,
    live: Tensor,
    c_rows: Optional[Tensor] = None,
    *,
    allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """One scoring pass (see :func:`shard_score_plain` for the contract).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 only; anything it does not take raises). ``shard_score.
    launches`` counts kernel launches."""
    if loads.device.type == "cpu":
        return shard_score_plain(
            replicas, cols, member, allowed, loads, F, bvalid, scal, s_i,
            t_i, live, c_rows, allow_leader=allow_leader,
        )
    return _launch(
        replicas, cols, member, allowed, loads, F, bvalid, scal, s_i, t_i,
        live, c_rows, allow_leader,
    )


shard_score.launches = 0  # type: ignore[attr-defined]


def shard_score_batched_plain(
    replicas: Tensor,
    cols: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    loads: Tensor,
    F: Tensor,
    bvalid: Tensor,
    scal: Tensor,
    s_i: Tensor,
    t_i: Tensor,
    live: Tensor,
    c_rows: Optional[Tensor] = None,
    *,
    allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """:func:`shard_score_plain` over ``K`` instances stacked on a leading
    axis (every input ``[K, ...]``), one instance after another; the eight
    outputs stacked the same way."""
    outs = [
        shard_score_plain(
            replicas[k], cols[k], member[k],
            None if allowed is None else allowed[k], loads[k], F[k],
            bvalid[k], scal[k], s_i[k], t_i[k], live[k],
            None if c_rows is None else c_rows[k], allow_leader=allow_leader,
        )
        for k in range(loads.shape[0])
    ]
    return tuple(torch.stack(list(col)) for col in zip(*outs))


# device-loop: the batched scoring kernel's wrapper, called by every iteration of the instance-batched session
def shard_score_batched(
    replicas: Tensor,
    cols: Tensor,
    member: Tensor,
    allowed: Optional[Tensor],
    loads: Tensor,
    F: Tensor,
    bvalid: Tensor,
    scal: Tensor,
    s_i: Tensor,
    t_i: Tensor,
    live: Tensor,
    c_rows: Optional[Tensor] = None,
    *,
    allow_leader: bool,
) -> Tuple[Tensor, ...]:
    """One scoring pass over ``K`` same-shape instances stacked on a
    leading axis (``replicas [K, P, R]``, ..., ``live [K, B2]``; the
    outputs ``[K, B]`` / ``[K, B2]``): instance ``k``'s outputs are
    :func:`shard_score` of instance ``k``'s inputs, bit for bit.

    CPU tensors take :func:`shard_score_batched_plain`; CUDA tensors make
    ONE kernel launch for all ``K`` (float32 only; anything it does not
    take raises). ``shard_score_batched.launches`` counts kernel
    launches."""
    if loads.device.type == "cpu":
        return shard_score_batched_plain(
            replicas, cols, member, allowed, loads, F, bvalid, scal, s_i,
            t_i, live, c_rows, allow_leader=allow_leader,
        )
    return _launch(
        replicas, cols, member, allowed, loads, F, bvalid, scal, s_i, t_i,
        live, c_rows, allow_leader, K=loads.shape[0],
    )


shard_score_batched.launches = 0  # type: ignore[attr-defined]
