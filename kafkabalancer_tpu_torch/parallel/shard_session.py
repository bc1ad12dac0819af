"""The partition-sharded converge session: the batched move loop over a
mesh.

Counterpart of the reference package's ``parallel/shard_session.py``.
Each ``part`` device of the mesh owns ``P/S`` partition rows — their
``[P/S, R]`` replicas, ``[P/S, B]`` membership and allowed rows — and
scores them itself; nothing of another shard's rows ever reaches it.
The replicated state lives once, on the lead device (``mesh.lead``):
broker loads, per-broker replica counts, the colocation counts, the
acceptance and the move log. Per iteration:

- the lead computes the ``[B]`` frame of the scoring pass
  (``scan.pool_frame``) and hands it to every shard;
- every shard scores its rows (``scan.rows_pool``: the scoring kernel,
  the leader merge, the winners' slot recovery, the pair finish), with
  the scale tier's row chunks combined on the shard;
- :func:`gather_pool` brings the ``[S, K]`` pools (``K = B + B//2``) to
  the lead and combines them under the total-order key ``(value,
  is_leader, global row)``;
- ``scan.accept_commit`` — the single-device session's acceptance and
  commit — runs once on the combined pool, and each accepted move is
  written into the rows of the shard that owns its partition.

Across processes (a mesh whose ``part`` axis spans several, see
``parallel/distributed.py``) each process keeps the shards of its own
devices only; :func:`gather_pool` all-gathers every process's stacked
pools in global shard order and every process runs the same combine,
acceptance and commit on the same pool, so the replicated state and the
move log are identical on every process. The integer counts summed over
shards at the start are summed over processes too.

Exactness: under that key the single-device selections (the scoring
kernel's lowest-row argmin per column, then the strict-< leader merge)
are associative minima, and the combine follows the kernel's own rules —
``-0.0`` ranks as ``+0.0``, a NaN never wins, and a column empty on
every shard is shard 0's ``(+inf, row 0)`` — on the scores before
``su`` is added. So the combined pool is the single-device pool, bit for
bit, and so are the move logs and loads (the float state is computed by
the single-device code on the lead; only integer-valued counts are
summed across shards). Pinned against the single-device plan and the
reference in ``tests/test_torch_parallel.py``.

Engines keep the reference's names: ``xla``, ``pallas`` and ``auto``
score with the hand-written kernel (``parallel/shard_kernel.py``; its
plain version on CPU tensors), ``pallas-interpret`` with the plain
version on any device. The reference's TPU-specific rules (the
engine-``auto`` crossover, the crash-bucket hand-over, its upload cache)
are not carried over.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.balancer.steps import BalanceError
from kafkabalancer_tpu_torch.models import PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import ENGINES, default_dtype, kernel_dtype
from kafkabalancer_tpu_torch.models.partition import empty_partition_list
from kafkabalancer_tpu_torch.obs import convergence
from kafkabalancer_tpu_torch.ops.cost import broker_loads, scalar, scatter_add_, unbalance
from kafkabalancer_tpu_torch.ops.runtime import next_bucket, scale_bucket
from kafkabalancer_tpu_torch.ops.tensorize import all_allowed_of, tensorize
from kafkabalancer_tpu_torch.parallel import distributed
from kafkabalancer_tpu_torch.parallel.mesh import PART_AXIS, Mesh, shard_put, to_devices
from kafkabalancer_tpu_torch.parallel.shard_kernel import (
    pack_cols,
    shard_score,
    shard_score_plain,
)
from kafkabalancer_tpu_torch.solvers import scan

Tensor = torch.Tensor
Shards = Union[Tensor, Sequence[Tensor]]

# the scale tier's default row chunk: a shard's rows are scored in blocks
# of about this many rows, which bounds the plain scorer's [rows, B]
# intermediates regardless of the cluster size
SCALE_ROW_CHUNK = 8192

# the key's leader bit sits above any row index
_LEAD_BIT = 1 << 40


def combine_pools(
    vals: Tensor, p: Tensor, slot: Tensor, *rest: Tensor
) -> Tuple[Tensor, ...]:
    """Combine ``N`` candidate pools, ``[N, K]`` each, into one ``[K]``
    pool: per column the entry with the least ``(value, is_leader,
    row)``, ``is_leader`` being ``slot == 0`` and ``p`` the global row.
    ``vals`` are the raw scores (``scan.rows_pool``), and the rules are
    the scoring kernel's: ``-0.0`` equals ``+0.0``, a NaN never wins,
    and a column without a finite value anywhere takes pool 0's entry —
    what the kernel returns for an empty column of the whole table. The
    ``rest`` tensors follow the winner."""
    inf = float("inf")
    key_v = torch.where(torch.isnan(vals), torch.full_like(vals, inf), vals)
    vmin = key_v.amin(0)
    key = (slot == 0).long() * _LEAD_BIT + p.long()
    key = torch.where(
        key_v == vmin[None, :], key, torch.full_like(key, torch.iinfo(torch.int64).max)
    )
    k = torch.where(vmin == inf, torch.zeros_like(vmin, dtype=torch.long),
                    key.argmin(0))[None, :]
    return tuple(t.gather(0, k)[0] for t in (vals, p, slot) + rest)


def gather_pool(
    mesh: Mesh, pools: Sequence[Tuple[Tensor, ...]]
) -> Tuple[Tensor, ...]:
    """The cross-shard combine: bring each shard's pool ``(vals_raw,
    global row, slot, source, ...)`` to the lead device and combine them
    with :func:`combine_pools`. The only place where shards meet.
    ``pools`` are this process's shards in axis order; when the axis
    spans processes, every process's ``[S_local, K]`` stacks are
    gathered in global shard order first (through the host)."""
    lead = mesh.lead
    cols = [torch.stack([t.to(lead) for t in c]) for c in zip(*pools)]
    if mesh.spans_processes(PART_AXIS):
        owners = mesh.axis_owners(PART_AXIS)
        t0 = time.perf_counter()
        cols = [distributed.gather_rows(c, owners) for c in cols]
        obs.metrics.count("shard.cross_process_seconds",
                          time.perf_counter() - t0)
        obs.metrics.count("shard.cross_process_gathers")
    return combine_pools(*cols)


def _per_shard(x: Shards, mesh: Mesh, what: str) -> List[Tensor]:
    """``x`` as one tensor per ``part`` device of this process: a list
    (one entry per shard of the axis, ``None`` allowed for other
    processes' shards) is taken as given, a whole tensor is split by
    rows."""
    S = len(mesh.part)
    local = mesh.local_axis(PART_AXIS)
    if isinstance(x, (list, tuple)):
        if len(x) != S:
            raise ValueError(f"{what}: {len(x)} shards for {S} devices")
        return [x[i].to(d) for i, d in local]
    P = x.shape[0]
    if P % S:
        raise ValueError(
            f"partition bucket {P} not divisible by part axis {S}; "
            f"tensorize with min_bucket a multiple of {S}"
        )
    n = P // S
    return [x[i * n:(i + 1) * n].to(d) for i, d in local]


class _Shard:
    """One shard's rows and their session state on its device: replicas
    and membership carry one trash element past the end, as in
    ``scan.session``, so rejected candidates' writes never collide with
    accepted ones."""

    def __init__(
        self, dev: torch.device, off: int, rep: Tensor, mem: Optional[Tensor],
        allowed: Optional[Tensor], cols: Tensor, ncur: Tensor,
        pvalid: Tensor, tid: Optional[Tensor], B: int, row_chunk: int,
    ):
        self.dev, self.off = dev, off
        P_l, R = rep.shape
        self.P_l, self.R, self.B = P_l, R, B
        self.rep_buf = torch.cat([rep.reshape(-1), rep.new_full((1,), -1)])
        self.rep = self.rep_buf[: P_l * R].view(P_l, R)
        if mem is None:
            # lean: the exact membership the host encode would build, from
            # this shard's replica rows
            mem = scan.member_from(self.rep, ncur, pvalid, B)
        self.mem_buf = torch.cat([mem.reshape(-1), mem.new_zeros(1)])
        self.mem = self.mem_buf[: P_l * B].view(P_l, B)
        self.allowed, self.cols, self.tid = allowed, cols, tid
        self.pvalid = pvalid
        step = row_chunk if row_chunk else P_l
        self.chunks = [(a, min(a + step, P_l)) for a in range(0, P_l, step)]

    # device-loop: this shard's pool, once per sharded iteration
    def pool(
        self, frame, loads, bvalid, minrep, score, allow_leader, counts, lam,
    ) -> Tuple[Tensor, ...]:
        """This shard's pool with global rows: each row chunk scored on
        its own, chunk winners combined under the same key."""
        parts = []
        for a, b in self.chunks:
            c_rows = None if counts is None else counts[self.tid[a:b]]
            v, p, slot, s_ = scan.rows_pool(
                frame, loads, bvalid, self.rep[a:b], self.mem[a:b],
                None if self.allowed is None else self.allowed[a:b],
                self.cols[a:b], minrep, score, allow_leader=allow_leader,
                c_rows=c_rows, lam=lam,
            )
            parts.append((v, p + a, slot, s_))
        if len(parts) > 1:
            parts = [combine_pools(*(torch.stack(c) for c in zip(*parts)))]
        v, p, slot, s_ = parts[0]
        return v, p + self.off, slot, s_

    # device-loop: this shard's commit, once per sharded iteration
    def commit(self, ok: Tensor, p: Tensor, slot: Tensor, s_: Tensor, t: Tensor) -> None:
        """Write the accepted moves of this shard's partitions."""
        ok, p, slot, s_, t = (x.to(self.dev) for x in (ok, p, slot, s_, t))
        P_l, R, B = self.P_l, self.R, self.B
        mine = ok & (p >= self.off) & (p < self.off + P_l)
        pl = p - self.off
        self.rep_buf[torch.where(mine, pl * R + slot, P_l * R)] = t.to(self.rep_buf.dtype)
        # jaxlint: disable=R3 — stray: the constant is copied to the card first
        self.mem_buf[torch.where(mine, pl * B + s_, P_l * B)] = False
        # jaxlint: disable=R3 — stray: the constant is copied to the card first
        self.mem_buf[torch.where(mine, pl * B + t, P_l * B)] = True


# device-loop: the sharded session; each pass of its while loop is one iteration
def sharded_session(
    loads: Tensor,
    replicas: Shards,
    member: Optional[Shards],
    allowed: Optional[Shards],
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
    churn_gate: float = scan.DEFAULT_CHURN_GATE,
    topic_id: Optional[Tensor] = None,
    lam: Optional[float] = None,
    *,
    max_moves: int,
    allow_leader: bool,
    batch: int,
    mesh: Mesh,
    engine: str = "xla",
    n_topics: int = 0,
    row_chunk: int = 0,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
) -> Tuple[Any, ...]:
    """``scan.session``'s batched mode with the partition rows sharded over
    ``mesh``'s ``part`` axis (see the module docstring). Returns
    ``(replicas, loads, n_moves, move_p, move_slot, move_src, move_tgt,
    final_su)`` like ``scan.session``, with ``replicas`` the list of
    per-shard ``[P/S, R]`` results (this process's shards) and
    everything else on the lead.

    ``replicas``, ``member`` and ``allowed`` are per-shard lists
    (``mesh.shard_put``) or whole ``[P, ...]`` tensors, split here.
    ``member=None`` rebuilds each shard's membership from its replica
    rows (the scale tier's lean state); ``allowed=None`` is the
    all-allowed mode. The ``[P]`` vectors, ``loads`` and the broker
    masks are taken on the lead device. The partition bucket must divide
    by the shard count. The selection is always the pooled batched one
    (``batch=1`` commits one move per iteration), as in the reference.

    ``row_chunk > 0`` scores each shard's rows in blocks of that many
    rows (the plain scorer's intermediates are ``[row_chunk, B]``);
    ``n_topics > 0`` with ``topic_id``/``lam`` runs the anti-colocation
    objective (needs ``batch > 1``). ``scorer`` replaces the engine's
    scoring pass, as in ``scan.session``.
    """
    lead = mesh.lead
    dtype = loads.dtype
    B = loads.shape[0]
    use_kernel = engine in ("pallas", "pallas-interpret")
    if engine not in ("xla", "pallas", "pallas-interpret"):
        raise ValueError(f"unknown shard engine {engine!r}")
    if use_kernel and dtype != kernel_dtype():
        raise ValueError("the pallas shard engine is float32 only")
    if n_topics and batch <= 1:
        raise ValueError(
            "the sharded anti-colocation session requires batch > 1 "
            "(the pooled batched selection)"
        )
    if row_chunk and use_kernel:
        raise ValueError(
            "row_chunk applies to the xla shard engine (the reference "
            "streams the pallas engine's rows instead)"
        )
    score = scorer or (shard_score_plain if engine == "pallas-interpret" else shard_score)
    local = mesh.local_axis(PART_AXIS)
    reps = _per_shard(replicas, mesh, "replicas")
    mems = [None] * len(local) if member is None else _per_shard(
        member, mesh, "member")
    alws = [None] * len(local) if allowed is None else _per_shard(
        allowed, mesh, "allowed")
    P_l = reps[0].shape[0]
    if row_chunk >= P_l or row_chunk < 0:
        row_chunk = 0  # one chunk covers the shard

    loads = loads.to(lead).clone()
    weights, nrep_cur, ncons = (x.to(lead) for x in (weights, nrep_cur, ncons))
    pvalid = pvalid.to(lead)
    always_valid, universe_valid = always_valid.to(lead), universe_valid.to(lead)
    cols = pack_cols(weights, nrep_cur, nrep_tgt.to(lead), ncons, pvalid)
    tid = topic_id.to(lead).long() if n_topics else None
    shards = []
    for k, (i, dev) in enumerate(local):
        rows = slice(i * P_l, (i + 1) * P_l)
        shards.append(_Shard(
            dev, i * P_l, reps[k], mems[k], alws[k], cols[rows].to(dev),
            nrep_cur[rows].to(dev), pvalid[rows].to(dev),
            None if tid is None else tid[rows].to(dev), B, row_chunk,
        ))

    # replicated state: per-broker replica counts and colocation counts
    # are integer sums of the shards' parts, exact in any order (over
    # the processes too)
    spans = mesh.spans_processes(PART_AXIS)
    bcount = torch.zeros(B, dtype=torch.int32, device=lead)
    for sh in shards:
        bcount += (sh.mem & sh.pvalid[:, None]).sum(0).to(torch.int32).to(lead)
    if spans:
        bcount = distributed.all_reduce_sum(bcount)
    colo = None
    if n_topics:
        counts = torch.zeros((n_topics, B), dtype=dtype, device=lead)
        for sh in shards:
            part = torch.zeros((n_topics, B), dtype=dtype, device=sh.dev)
            scatter_add_(part, sh.tid, (sh.mem & sh.pvalid[:, None]).to(dtype))
            counts += part.to(lead)
        if spans:
            counts = distributed.all_reduce_sum(counts)
        lam_t = scalar(lam, dtype, lead)
        colo = (tid, counts.view(-1), lam_t)
    log = torch.full((4, max_moves + 1), -1, dtype=torch.long, device=lead)
    mu = scalar(min_unbalance, dtype, lead)
    cg = scalar(churn_gate, dtype, lead)
    minrep = scalar(min_replicas, dtype, lead)
    devs = [d for _, d in local]

    def table() -> Tuple[Tensor, Tensor]:
        bvalid = (always_valid | (bcount > 0)) & universe_valid
        return bvalid, bvalid.sum().to(dtype)

    n = 0
    iters = 0
    t0 = time.perf_counter()
    while n < budget and n < max_moves:
        bvalid, nb = table()
        frame = scan.pool_frame(loads, bvalid, nb)
        # the [B]-sized inputs of the scoring pass, once per device
        lead_in = [*frame, loads, bvalid, minrep]
        if n_topics:
            lead_in += [counts, lam_t]
        moved = [to_devices(x, devs) for x in lead_in]
        pools = []
        for i, sh in enumerate(shards):
            xs = [m[i] for m in moved]
            pools.append(sh.pool(
                tuple(xs[:6]), xs[6], xs[7], xs[8], score, allow_leader,
                *(xs[9:] if n_topics else (None, None)),
            ))
        pool = scan.finish_pool(
            frame, *gather_pool(mesh, pools), weights, nrep_cur, ncons
        )
        ok, cnt = scan.accept_commit(
            pool, loads, bcount, log, n, batch, budget, max_moves, mu, cg,
            colo=colo,
        )
        for sh in shards:
            sh.commit(ok, *pool[1:5])
        # jaxlint: disable=R1 — the designed read: the accepted count ends the iteration
        c = int(cnt)
        iters += 1
        if c == 0:
            break
        n += c
    obs.metrics.count("shard.session_seconds", time.perf_counter() - t0)
    obs.metrics.count("shard.session_iterations", iters)
    bvalid, nb = table()
    final_su = unbalance(loads, bvalid, nb)
    mp, mslot, msrc, mtgt = log[:, :max_moves].to(torch.int32)
    return [sh.rep.clone() for sh in shards], loads, n, mp, mslot, msrc, mtgt, final_su


def _resolve_row_chunk(requested: Optional[int], P_l: int) -> int:
    """The scale tier's row chunk for a ``P_l``-row shard: the requested
    bound balanced across equal chunks and rounded up to a multiple of 8,
    as the reference resolves it. 0 = one chunk."""
    rc = SCALE_ROW_CHUNK if requested is None else int(requested)
    if rc <= 0 or rc >= P_l:
        return 0
    n_chunks = -(-P_l // rc)
    even = -(-P_l // n_chunks)
    rc = -(-even // 8) * 8
    return 0 if rc >= P_l else rc


def plan_sharded(
    pl: PartitionList,
    cfg: RebalanceConfig,
    max_reassign: int,
    mesh: Mesh,
    dtype: Any = None,
    batch: int = 128,
    chunk_moves: Optional[int] = None,
    churn_gate: Optional[float] = None,
    engine: str = "auto",
    polish: bool = False,
    anti_colocation: Optional[float] = None,
    scale: bool = False,
    row_chunk: Optional[int] = None,
    *,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
) -> PartitionList:
    """Mesh-sharded ``scan.plan``: host repairs settle first, then sharded
    move sessions in chunks that re-enter with the mutated assignment.
    The output and mutation contract is ``plan``'s, with its
    ``chunk_moves`` heuristic; ``churn_gate`` tunes the sharded
    sessions (default ``scan.DEFAULT_CHURN_GATE``). The session runs on
    ``mesh``'s ``part`` devices and its replicated state on ``mesh.lead``;
    ``dtype`` defaults per lead device (float32 on CUDA, float64 on the
    CPU), and the pallas engines take float32.

    - ``polish=True``: once the sharded sessions converge, the rest of
      the budget runs ``plan``'s move/swap alternation
      (``solvers/polish.py``) on the lead device.
    - ``rebalance_leaders`` hands over to ``plan``'s fused leader session
      on the lead device (sequential by contract); with ``scale`` it
      warns that the cluster must fit one device.
    - ``anti_colocation=λ`` runs the combined objective sharded, with the
      activation rules of ``scan.anti_colocation_requested`` (the kwarg
      overrides the config; it needs ``batch > 1`` and excludes
      ``rebalance_leaders``); every engine carries it.
    - ``scale=True``, the scale tier: the partition bucket rides
      ``ops.runtime.scale_bucket`` (a multiple of ``8 × S``), the encode
      builds no ``[P, B]`` membership (each shard rebuilds its own), and
      each shard scores its rows in chunks of about ``row_chunk`` rows
      (default :data:`SCALE_ROW_CHUNK`; the xla engine only, as in the
      reference). Plans stay those of ``scan.plan``.

    ``scorer`` replaces the scoring pass of every session, the polish
    tail's included (a check on the card runs the plain version).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    engine = scan.resolve_engine(engine)
    lam, _explicit = scan.anti_colocation_requested(cfg, anti_colocation, batch)
    if lam and batch <= 1:
        raise ValueError("anti_colocation requires batch > 1")
    if lam and cfg.rebalance_leaders:
        raise ValueError(
            "anti_colocation is not supported with rebalance_leaders "
            "(the fused leader session has no colocation state)"
        )
    lead = mesh.lead
    if cfg.rebalance_leaders:
        if scale:
            warnings.warn(
                "-shard-scale with rebalance_leaders hands over to the "
                "single-device fused leader session (sequential by "
                "contract): the cluster must fit one device on this path",
                UserWarning,
                stacklevel=2,
            )
        return scan.plan(
            pl, cfg, max_reassign, dtype=dtype, batch=batch,
            chunk_moves=chunk_moves, device=lead,
        )
    opl = empty_partition_list()
    if max_reassign <= 0:
        return opl
    with obs.span("settle"):
        repaired, budget = scan._settle_head(pl, cfg, max_reassign)
    opl.append(*repaired)
    use_kernel = engine in ("pallas", "pallas-interpret")
    if use_kernel:
        dtype = kernel_dtype()
    elif dtype is None:
        dtype = default_dtype(lead)
    if chunk_moves is None:
        chunk_moves = scan.auto_chunk_moves(len(pl.partitions or []))
    chunk_moves = max(1, min(chunk_moves, 1 << 20))
    if churn_gate is None:
        churn_gate = scan.DEFAULT_CHURN_GATE
    if scorer is None and engine == "pallas-interpret":
        scorer = shard_score_plain
    S = mesh.shape[PART_AXIS]
    # power-of-two buckets of a multiple of S stay divisible by S
    min_bucket = 8 * S

    def failed(exc: Exception) -> BalanceError:
        # a kernel that does not build, launch or take these shapes, on
        # any shard, is a planning failure (CLI exit 3); nothing falls back
        return BalanceError(f"{engine} shard engine failed ({exc})")

    remaining = budget
    while remaining > 0:
        with obs.span("tensorize", scale=scale):
            if scale:
                dp = tensorize(
                    pl, cfg, min_bucket=min_bucket,
                    p_bucket=scale_bucket(max(1, len(pl.partitions or [])), min_bucket),
                    build_member=False,
                )
            else:
                dp = tensorize(pl, cfg, min_bucket=min_bucket)
        rc = (
            _resolve_row_chunk(row_chunk, dp.replicas.shape[0] // S)
            if scale and not use_kernel else 0
        )
        chunk = min(remaining, chunk_moves)
        rec = convergence.recorder()
        if rec is not None and dp.member is not None:
            # -explain candidate-space statistics (the dense encoding the
            # sharded round scores; one numpy pass, no device sync). The
            # lean scale encode has no member table, so the scale tier
            # skips this sample rather than build one
            rec.note_round(dp, cfg, chunk=chunk, engine=f"shard-{engine}")
        colo = {}
        if lam:
            colo = dict(
                topic_id=torch.from_numpy(dp.topic_id),
                lam=lam, n_topics=next_bucket(max(1, len(dp.topics)), 64),
            )
        B = dp.bvalid.shape[0]

        def up(a: np.ndarray, dt: Any = None) -> Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(lead)
            return t if dt is None else t.to(dt)

        w, nc, ncur = up(dp.weights, dtype), up(dp.ncons, dtype), up(dp.nrep_cur)
        # the loads of the single-device plan, by the same function on
        # the lead device (the [P, R] replicas pass through it once)
        loads = broker_loads(up(dp.replicas), w, ncur, nc, B)
        obs.metrics.count("solver.chunks")
        try:
            with obs.span(
                "shard.dispatch_chunk", shards=S, row_chunk=rc, engine=engine,
            ):
                _rep, _loads, n, mp, mslot, _msrc, mtgt, _su = sharded_session(
                    loads, shard_put(dp.replicas, mesh),
                    None if dp.member is None else shard_put(dp.member, mesh),
                    None if all_allowed_of(dp) else shard_put(dp.allowed, mesh),
                    w, ncur, up(dp.nrep_tgt), nc, up(dp.pvalid),
                    up(scan._cfg_broker_mask(dp, cfg)), up(dp.bvalid),
                    cfg.min_replicas_for_rebalancing, cfg.min_unbalance, chunk,
                    churn_gate, max_moves=next_bucket(chunk, 128),
                    allow_leader=cfg.allow_leader_rebalancing,
                    batch=max(1, batch), mesh=mesh, engine=engine,
                    row_chunk=rc, scorer=scorer, **colo,
                )
        except (RuntimeError, ValueError) as exc:
            if not use_kernel and all(d.type != "cuda" for d in mesh.part):
                raise
            raise failed(exc) from exc
        n_t = torch.tensor([n], dtype=torch.int32, device=mp.device)
        packed = torch.cat([mp, mslot, mtgt, n_t]).cpu().numpy()
        n = scan._decode_packed(packed, dp, opl, drop_superseded=True)
        remaining -= n
        if n < chunk:
            break

    # polish tail on the lead device, on the sharded sessions' move floor
    while polish and remaining > 0:
        dp = tensorize(pl, cfg)
        chunk = min(remaining, chunk_moves)
        try:
            packed = scan._run_chunk(
                dp, cfg, chunk, dtype, batch, lead, scorer, "xla",
                mode="polish", lam=lam,
            )
        except (RuntimeError, ValueError) as exc:
            if lead.type != "cuda":
                raise
            raise failed(exc) from exc
        n = scan._decode_packed(packed, dp, opl, drop_superseded=True)
        remaining -= n
        if n < chunk:
            break
    scan._note_session_outcome(opl, remaining)
    return opl
