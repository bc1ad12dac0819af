"""The whole batched session in one launch: the hand-written Hopper kernel
(``csrc/pallas_session.cu``), its plain torch version, and the wrapper.

Counterpart of the reference package's ``solvers/pallas_session.py``. The
torch session (``solvers/scan.py`` ``session``) runs each iteration as a
host loop of small launches with one host read of the accepted count; this
kernel runs the whole session — scoring, the candidate pool, prefix-exact
acceptance with the churn gate, the commit, the move log and the
convergence test — as one persistent launch, and the host reads the result
once.

It is the reference kernel's algorithm, which differs from the torch
session's batched path in two ways:

- the pooled selection always, even at ``batch=1`` (no leader-first
  precedence; the torch session's ``batch == 1`` path is ``step_single``);
- the commit writes ``loads + Σ(target deltas) − Σ(source deltas)``, each
  sum in ascending candidate order (``pallas_session.py:627-630`` in the
  reference), where the torch session scatters sources first, then
  targets. The two differ in float32 when a broker takes part in more
  than one accepted move of an iteration.

:func:`pallas_session` dispatches on the tensors' device: CPU tensors run
:func:`pallas_session_plain`, CUDA tensors launch the kernel or raise.
There is no fallback between the two. Membership is derived from the
replica matrix (the ``member`` argument is ignored, as in the reference).
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Optional, Tuple

import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.models.config import kernel_dtype
from kafkabalancer_tpu_torch.ops import nvcc
from kafkabalancer_tpu_torch.ops.cost import scalar, scatter_add_
from kafkabalancer_tpu_torch.parallel.shard_kernel import pack_cols, shard_score_plain
from kafkabalancer_tpu_torch.solvers.scan import (
    DEFAULT_CHURN_GATE,
    batch_pool,
    prefix_accept,
)

Tensor = torch.Tensor
SOURCE = "pallas_session.cu"
# the phases of an iteration whose ends the kernel stamps (``launch``'s
# ``stamps``), in order; the last is the next iteration's release
STAMP_PHASES = (
    "table", "own_scoring", "barrier", "fold_pool", "accept", "commit",
    "release",
)


class SessionState:
    """The session's inputs in the kernel's types, and its working state
    (copies; the caller's tensors are not modified)."""

    def __init__(
        self,
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
        all_allowed: bool,
    ) -> None:
        if replicas.dim() != 2 or loads.dim() != 1:
            raise ValueError("pallas_session: replicas must be [P, R], loads [B]")
        P, R = replicas.shape
        B = loads.shape[0]
        if R < 1 or B < 1:
            raise ValueError(f"pallas_session: empty replica ({R}) or broker ({B}) axis")
        dev = loads.device
        shapes = {
            "replicas": (replicas, (P, R)), "weights": (weights, (P,)),
            "nrep_cur": (nrep_cur, (P,)), "nrep_tgt": (nrep_tgt, (P,)),
            "ncons": (ncons, (P,)), "pvalid": (pvalid, (P,)),
            "always_valid": (always_valid, (B,)),
            "universe_valid": (universe_valid, (B,)),
        }
        if allowed is not None and not all_allowed:
            shapes["allowed"] = (allowed, (P, B))
        for name, (t, shape) in shapes.items():
            if t.device != dev:
                raise ValueError(
                    f"pallas_session: {name} is on {t.device}, loads on {dev}"
                )
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"pallas_session: {name} shape {tuple(t.shape)} != {shape}"
                )
        f32 = kernel_dtype()
        self.P, self.R, self.B = P, R, B
        self.device = dev
        dense = torch.contiguous_format
        self.loads = loads.to(f32).clone(memory_format=dense)
        self.replicas = replicas.to(torch.int32).clone(memory_format=dense)
        pv = pvalid.to(torch.bool)
        self.cols = pack_cols(
            weights.to(f32), nrep_cur.to(torch.int32), nrep_tgt.to(torch.int32),
            ncons.to(f32), pv,
        ).contiguous()
        # membership over the valid slots of valid rows, as the reference's
        # kernel derives it (scan.member_from)
        slot = torch.arange(R, device=dev)[None, :]
        valid = (slot < nrep_cur[:, None]) & pv[:, None] & (self.replicas >= 0)
        rows = torch.arange(P, device=dev)[:, None] * B
        idx = torch.where(valid, rows + self.replicas.long(), P * B)
        # one trash element past the end takes the writes of rejected
        # candidates in the plain version
        self.member_buf = torch.zeros(P * B + 1, dtype=torch.bool, device=dev)
        self.member_buf[idx.reshape(-1)] = True
        self.member_buf[P * B] = False
        self.member = self.member_buf[: P * B].view(P, B)
        self.bcount = self.member.sum(0, dtype=torch.int32)
        self.allowed = (
            None if all_allowed or allowed is None
            else allowed.to(torch.bool).contiguous()
        )
        self.always = always_valid.to(torch.bool).contiguous()
        self.universe = universe_valid.to(torch.bool).contiguous()


def _check_scalars(budget: int, batch: int, max_moves: int) -> None:
    if batch < 1:
        raise ValueError(f"pallas_session: batch {batch} < 1")
    if max_moves < 1:
        raise ValueError(f"pallas_session: max_moves {max_moves} < 1")
    if not 0 <= budget < 2**31:
        raise ValueError(f"pallas_session: budget {budget} out of range")


def _count(iters: int, seconds: float) -> None:
    obs.metrics.count("solver.session_seconds", seconds)
    obs.metrics.count("solver.session_iterations", iters)


def _ordered_scatter(idx: Tensor, vals: Tensor, ok: Tensor, B: int) -> Tensor:
    """``out[b] = Σ vals[k]`` over the accepted ``k`` with ``idx[k] == b``,
    each sum taken from zero in ascending ``k`` (the reference kernel's
    one-hot contraction; its zero terms change no bit). Deterministic on
    every device: round ``r`` adds each broker's ``r``-th accepted term,
    so no round has two updates of one broker."""
    K = idx.shape[0]
    kk = torch.arange(K, device=idx.device)
    before = (
        (idx[:, None] == idx[None, :]) & ok[:, None] & (kk[:, None] < kk[None, :])
    )
    occ = before.sum(0)  # accepted terms of the same broker before k
    out = torch.zeros(B, dtype=vals.dtype, device=vals.device)
    rounds = int(torch.where(ok, occ, -1).max()) + 1 if K else 0
    for r in range(rounds):
        sel = ok & (occ == r)
        out.index_put_((idx[sel].long(),), vals[sel], accumulate=True)
    return out


def pallas_session_plain(
    loads: Tensor,
    replicas: Tensor,
    member: Optional[Tensor],
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
    batch: int,
    churn_gate: float = DEFAULT_CHURN_GATE,
    *,
    max_moves: int,
    allow_leader: bool,
    all_allowed: bool = False,
) -> Tuple[Any, ...]:
    """The kernel's function in plain torch at float32, on the device the
    inputs live on (see :func:`pallas_session` for the contract): the
    batched step of the torch session (``scan.batch_pool`` with
    ``shard_score_plain``, ``scan.prefix_accept``) with the pooled
    selection at every ``batch``, the churn gate as given, and the commit
    in the reference kernel's form."""
    _check_scalars(budget, batch, max_moves)
    st = SessionState(
        loads, replicas, allowed, weights, nrep_cur, nrep_tgt, ncons, pvalid,
        always_valid, universe_valid, all_allowed,
    )
    P, R, B = st.P, st.R, st.B
    dev = st.device
    f32 = kernel_dtype()
    mu = scalar(min_unbalance, f32, dev)
    cg = scalar(churn_gate, f32, dev)
    minrep = scalar(min_replicas, f32, dev)
    loads = st.loads
    rep_buf = torch.cat([st.replicas.reshape(-1), st.replicas.new_full((1,), -1)])
    rep = rep_buf[: P * R].view(P, R)
    mem_buf = st.member_buf
    mem = st.member
    bcount = st.bcount
    log = torch.full((4, max_moves + 1), -1, dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    n = 0
    iters = 0
    t0 = time.perf_counter()
    while n < budget and n < max_moves:
        bvalid = (st.always | (bcount > 0)) & st.universe
        nb = bvalid.sum().to(f32)
        vals, p, slot, s_, t, w_k, avg, su = batch_pool(
            loads, bvalid, nb, rep, mem, st.allowed, st.cols, minrep,
            shard_score_plain, allow_leader=allow_leader,
        )
        ok, pos, cnt = prefix_accept(
            vals, p, s_, t, w_k, loads, avg, su, mu, cg, n, batch, budget,
            max_moves,
        )
        # commit: loads + Σ targets − Σ sources (the reference kernel's
        # form); rejected candidates write to the trash elements
        d = torch.where(ok, w_k, zero)
        loads = (loads + _ordered_scatter(t, d, ok, B)) - _ordered_scatter(
            s_, d, ok, B
        )
        oki = ok.to(torch.int32)
        scatter_add_(bcount, torch.where(ok, s_, 0), -oki)
        scatter_add_(bcount, t, oki)
        rep_buf[torch.where(ok, p * R + slot, P * R)] = t.to(rep_buf.dtype)
        mem_buf[torch.where(ok, p * B + s_, P * B)] = False
        mem_buf[torch.where(ok, p * B + t, P * B)] = True
        logpos = torch.where(ok, pos, max_moves)
        log[:, logpos] = torch.where(
            ok, torch.stack([p, slot, s_, t]), torch.full_like(log[:, :1], -1)
        )
        cnt = int(cnt)
        iters += 1
        if cnt == 0:
            break
        n += cnt
    _count(iters, time.perf_counter() - t0)
    mp, mslot, msrc, mtgt = log[:, :max_moves].to(torch.int32)
    return rep.clone(), loads, n, mp, mslot, msrc, mtgt


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.c_void_p
    I = ctypes.c_int
    Fl = ctypes.c_float
    lib.pallas_session_launch.argtypes = [P] * 8 + [I] * 7 + [Fl] * 3 + [P] * 5
    lib.pallas_session_launch.restype = I
    lib.pallas_session_scratch_words.argtypes = [I]
    lib.pallas_session_scratch_words.restype = ctypes.c_longlong
    lib.pallas_session_max_brokers.argtypes = []
    lib.pallas_session_max_brokers.restype = I
    lib.pallas_session_error_string.argtypes = [I]
    lib.pallas_session_error_string.restype = ctypes.c_char_p


def stamp_rows(budget: int, max_moves: int) -> int:
    """Rows of a ``stamps`` tensor: the most iterations a launch can run
    (every iteration but the last accepts a move)."""
    return min(budget, max_moves) + 1


def _load() -> ctypes.CDLL:
    return nvcc.load(SOURCE, _bind)


# device-loop: the whole-session kernel's wrapper; the caller reads the counts
def launch(
    st: SessionState,
    min_replicas: int,
    min_unbalance: float,
    budget: int,
    batch: int,
    churn_gate: float,
    max_moves: int,
    allow_leader: bool,
    stamps: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch the kernel on ``st`` (CUDA tensors), updating its state in
    place; returns ``(log [4, max_moves], counts [3]: n | iterations |
    done)`` without waiting for the card. Anything the kernel does not
    take, and any build or launch failure, raises.

    ``stamps``, when given, is a contiguous int64 tensor on the card of
    ``[stamp_rows(budget, max_moves), len(STAMP_PHASES)]``: row ``i``
    receives block 0's ``clock64()`` at the end of each phase of iteration
    ``i`` (rows past the iteration count are left as they were)."""
    lib = _load()
    if st.device.type != "cuda":
        raise ValueError(
            f"pallas_session: the kernel takes CUDA tensors, got {st.device}"
        )
    P, R, B = st.P, st.R, st.B
    if B > lib.pallas_session_max_brokers():
        raise ValueError(
            f"pallas_session: broker bucket {B} exceeds the kernel's "
            f"{lib.pallas_session_max_brokers()}"
        )
    if P * max(R, B) >= 2**31:
        raise ValueError(f"pallas_session: {P} x {B} rows exceed int32 indexing")
    if stamps is not None:
        shape = (stamp_rows(budget, max_moves), len(STAMP_PHASES))
        if (stamps.device != st.device or stamps.dtype != torch.int64
                or tuple(stamps.shape) != shape or not stamps.is_contiguous()):
            raise ValueError(
                f"pallas_session: stamps must be a contiguous int64 {shape} "
                f"tensor on {st.device}"
            )
    dev = st.device
    scratch = torch.empty(
        lib.pallas_session_scratch_words(B), dtype=torch.int64, device=dev
    )
    log = torch.empty((4, max_moves), dtype=torch.int32, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    u8 = torch.uint8

    def ptr(t: Optional[Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pallas_session_launch(
            ptr(st.replicas), ptr(st.cols), ptr(st.member_buf.view(u8)),
            ptr(None if st.allowed is None else st.allowed.view(u8)),
            ptr(st.loads), ptr(st.bcount), ptr(st.always.view(u8)),
            ptr(st.universe.view(u8)), P, R, B, budget, batch, max_moves,
            int(bool(allow_leader)), float(min_replicas), float(min_unbalance),
            float(churn_gate), ptr(scratch), ptr(log), ptr(counts),
            ptr(stamps), stream,
        )
    if err != 0:
        msg = lib.pallas_session_error_string(err).decode()
        raise RuntimeError(f"pallas_session kernel launch failed: {msg} ({err})")
    nvcc.count_launch(pallas_session)
    return log, counts


def pallas_session(
    loads: Tensor,
    replicas: Tensor,
    member: Optional[Tensor],
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
    batch: int,
    churn_gate: float = DEFAULT_CHURN_GATE,
    *,
    max_moves: int,
    allow_leader: bool,
    all_allowed: bool = False,
) -> Tuple[Any, ...]:
    """Run up to ``min(budget, max_moves)`` accepted moves as one session;
    the reference's arguments and return tuple ``(replicas, loads, n,
    move_p, move_slot, move_src, move_tgt)``: the final ``[P, R]`` int32
    assignment and ``[B]`` float32 loads, the move count, and four int32
    logs of length ``max_moves`` (-1 past ``n``). The inputs are not
    modified.

    ``member`` is ignored (membership is derived from ``replicas``);
    ``allowed`` is ignored when ``all_allowed`` (or None). Float inputs
    are taken at float32. CPU tensors run :func:`pallas_session_plain`;
    CUDA tensors launch the kernel (anything it does not take raises).
    ``pallas_session.launches`` counts kernel launches; every run adds
    its iterations to the ``solver.session_iterations`` counter.
    """
    if loads.device.type == "cpu":
        return pallas_session_plain(
            loads, replicas, member, allowed, weights, nrep_cur, nrep_tgt,
            ncons, pvalid, always_valid, universe_valid, min_replicas,
            min_unbalance, budget, batch, churn_gate, max_moves=max_moves,
            allow_leader=allow_leader, all_allowed=all_allowed,
        )
    _check_scalars(budget, batch, max_moves)
    st = SessionState(
        loads, replicas, allowed, weights, nrep_cur, nrep_tgt, ncons, pvalid,
        always_valid, universe_valid, all_allowed,
    )
    t0 = time.perf_counter()
    log, counts = launch(
        st, min_replicas, min_unbalance, budget, batch, churn_gate, max_moves,
        allow_leader,
    )
    # the session's one host read of its counts (the log stays on the card)
    n, iters, _done = counts.tolist()
    _count(iters, time.perf_counter() - t0)
    return st.replicas, st.loads, n, log[0], log[1], log[2], log[3]


pallas_session.launches = 0  # type: ignore[attr-defined]
