"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card: ``nvidia-smi`` name and power limit, the torch device name;
   build every kernel from ``kafkabalancer_tpu_torch/csrc`` with nvcc
   (sm_90a), one process per source, all started together, and print
   each build's seconds and ptxas resource lines.
2. The scoring kernel (``shard_score``) against its plain torch version
   on the card, on the inputs the main path gives it (captured from a
   one-iteration session) at the 10k x 100 bucket and at 131072 x 256,
   sweeping allow_leader, restricted ``allowed`` and the colocation
   counts, then the same sweep on an unweighted cluster (equal weights:
   values tie often and the lowest row decides) at both shapes.
   Tolerance: zero — all eight outputs equal under ``==``. Device times
   (CUDA events, L2 flushed, the host's per-call cost kept out by a spin
   kernel), host times per call, the plain version's times and the
   bound.
2b. The whole-session kernel (``pallas_session``) against its plain
   version on the card, on the first chunk of ``plan(engine="pallas")``
   at the 10k x 100 bucket (budget: the whole chunk) and at 131072 x 256
   (budget 4000), over allow_leader, restricted ``allowed`` and batch 1
   and 100 (128 at scale). Tolerance: zero — all seven outputs equal
   under ``==``, and two launches give identical bits. Device time per
   launch, iterations, ms per iteration, the torch session's ms per
   iteration on the same inputs, the plain version's time and the bound.
   Then one launch with phase stamps (its outputs equal to an unstamped
   launch's): each phase's share of an iteration, the median iteration in
   cycles and in us at the SM clock. Last, an unweighted cluster (ties
   decided by index) at the 10k x 100 bucket, batch 100, leaders off and
   on, equal to the plain version.
3. The main path through the CLI: a 10k-partition x 100-broker synthetic
   cluster planned by ``kafkabalancer_tpu_torch.cli.run`` with
   ``-fused -fused-batch=100``; rc 0, a parseable plan, the scoring
   kernel's launch count > 0, the final unbalance (host oracle) below
   the input's; then the same session with the plain scorer must emit
   the identical plan.
3b. The same cluster through ``cli.run -fused -fused-engine=pallas
   -fused-batch=100``: rc 0, a parseable plan, the whole-session kernel's
   launch count > 0, the final unbalance below the input's, and a plan
   byte-identical to ``plan(engine="pallas-interpret")`` on the card.
   Whether it equals phase 3's plan is printed (a finding, not a check).
4. Scale: a 131072 x 256 cluster through ``plan`` for a bounded number of
   moves; time per session iteration. 4b: the same with
   ``engine="pallas"``.
5. The scoring pass's division (``score::quot``: the rounded reciprocal
   and one FMA correction) against the IEEE division for every finite
   float32 x, at every avg the run's scoring passes met (recorded from the
   plain versions, which compute the kernels' avgs with the same bits, and
   from phase 4's kernel calls) and at a seeded sweep that includes powers
   of two and all-ones significands. A single mismatch fails the run.

6. The headline configuration of the reference (``-fused -fused-batch=100
   -allow-leader -fused-polish``, here with ``-min-unbalance=1e-7``) through
   ``cli.run`` on phase 3's cluster, with the torch session (the scoring
   kernel in every move phase) and with ``-fused-engine=pallas`` (one
   whole-session launch up front); each plan byte-identical to the same
   alternation with the kernel's plain version (``scorer=
   shard_score_plain``, ``engine="pallas-interpret"``). Prints the wall,
   the moves, the final unbalance beside phase 3's, the host time and
   count of the move, swap and shuffle phases, and the launches.
7. The fused ``-rebalance-leader`` session through ``cli.run`` at 10k x
   100: batch 1 for a bounded budget (its plan against the same float32
   session on CPU tensors is printed, a finding) and batch 100 to
   convergence.
8. ``-solver=tpu`` through ``cli.run``: byte-identical stdout to
   ``-solver=greedy`` for 10 moves on a 1000 x 40 cluster (above
   ``MIN_DEVICE_CANDIDATES``, so the device pass runs), then one move at
   10k x 100 with its device passes and re-scanned window rows.

9. The JAX package's benchmark configuration 4b (``synth_cluster(10000,
   100, rf=3, seed=42, weighted=True, zipf_topics=True)``, λ = 1e-3,
   ``-min-unbalance=1e-6``): the scoring kernel's colocation variant on
   the session's own first-iteration inputs (equal to the plain version,
   timed, bound), then ``cli.run -fused -fused-batch=128 -allow-leader
   -anti-colocation=0.001`` without and with ``-fused-polish`` and with
   ``-fused-engine=pallas`` (the override must be logged and the plan
   equal the torch session's); each other plan equal to the same session
   with ``scorer=shard_score_plain``, every assignment duplicate-free,
   the combined objective ``u + λ·colocations`` (host oracle) below the
   input's. Prints colocations against the pigeonhole floor (a finding).
10. ``-solver=beam -anti-colocation=0.001 -beam-siblings -max-reassign=4
   -min-unbalance=1e-6`` through ``cli.run`` on the same cluster, every
   emitted move checked on its own (it improves the unbalance, or at the
   step's depth-1 retry the combined objective, by ``min_unbalance``);
   then ``beam_plan`` (width 8, depth 4, siblings) with a budget of
   ``BEAM_BUDGET`` moves, whose combined objective must fall. Prints ms
   per depth step.

11. The sharded converge session: ``cli.run`` with phase 3's flags and
   ``-fused-shard`` (one shard per card) must print phase 3's plan;
   ``plan_sharded`` on meshes naming the card 2 and 4 times must plan it
   too, and on 2 shards with ``scorer=shard_score_plain``; the scoring
   kernel against its plain version (all variants, timed, bound) on the
   inputs of one of 4 shards and of one row chunk of the scale tier; the
   scale tier with polish (``scale=True, polish=True``, batch 128,
   ``-allow-leader``) at 160000 x 250 on 4 shards must equal
   ``scan.plan(polish=True)``. Each run's K1 launches must equal shards x
   row chunks x sharded iterations (plus the polish tail's move-phase
   iterations); prints wall, iterations and ms per iteration.
12. The what-if sweep (``parallel/sweep.py``) of the JAX suite's six
   scenarios (status quo, +1, +2, +4 brokers, -1, -2) on phase 3's
   cluster, batch 100, budget 2000: engine ``pallas`` (one whole-session
   launch per scenario) must equal ``pallas-interpret`` and engine
   ``xla`` (K1 per iteration) the same with the plain scorer; prints
   each scenario's feasibility, evacuations, moves and unbalance, the
   best scenario, the wall and the launches.

Each path's launch counts are set to 0 just before it runs and read just
after. Phases 6-12 run after 3b and before 4. The last two stdout lines are the kernels JSON line and
``{"ok": true, "device": {...}}``. Without a CUDA device (or outside the
repository) the script exits non-zero before printing either.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

SEED = 20261016
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
# the spin kernel's clock (cycles per ms at the H100's 1.98 GHz boost)
SPIN_CYCLES_PER_MS = 1_980_000
MAIN_SHAPE = (10000, 100)
SCALE_SHAPE = (131072, 256)
SCALE_MOVES = 4000
MAIN_REASSIGN = 1000000  # the CLI runs' -max-reassign
KERNEL_SOURCES = ("shard_score.cu", "pallas_session.cu")
B2_NAMES = ("replicas", "loads", "n", "move_p", "move_slot", "move_src",
            "move_tgt")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, flush):
    """``(device ms, host ms)`` of one call of ``fn()``, medians over
    ``reps`` runs after two warm-up calls.

    Device: a CUDA event pair around one call with a cold L2 (``flush()``
    first). A spin kernel queued before the first event keeps the card
    busy while the host checks the arguments, allocates and launches, so
    the events hold the call's device work and not its host cost. Host:
    the host clock around the same call, which returns once its work is
    queued."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    spin = int(SPIN_CYCLES_PER_MS * 4 * max(1.0, max(host)))
    for _ in range(reps):
        flush()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), statistics.median(host)


def capture_inputs(n_parts, n_brokers, dev, weighted=True):
    """The scoring kernel's inputs at the first iteration of the main
    path's session on a synthetic cluster (cloned at the call;
    ``weighted=False``: every partition weighs the same)."""
    import torch

    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    seen = []

    def capture(*args, **kw):
        if not seen:
            seen.append(
                ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
            )
        return shard_kernel.shard_score(*args, **kw)

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=SEED, weighted=weighted)
    plan(pl, cfg, 1, batch=100, device=dev, scorer=capture)
    if not seen:
        fail(f"no scoring call captured at {n_parts}x{n_brokers}")
    return seen[0][0]


def variant(args, restricted, colo):
    """Main-path inputs with a restricted allowed matrix and/or
    colocation counts switched on (seeded)."""
    import torch

    (rep, cols, mem, allowed, loads, F, bvalid, scal, s_i, t_i, live) = args
    g = torch.Generator(device=mem.device).manual_seed(SEED)
    P, B = mem.shape
    if restricted:
        allowed = (torch.rand((P, B), generator=g, device=mem.device) < 0.6) & (
            bvalid[None, :]
        )
    crows = None
    scal = scal.clone()
    if colo:
        crows = torch.randint(
            0, 4, (P, B), generator=g, device=mem.device
        ).to(torch.float32)
        scal[2] = 0.375
    return (rep, cols, mem, allowed, loads, F, bvalid, scal, s_i, t_i, live,
            crows)


def k1_bytes(args, allow_leader):
    """Bytes the scoring pass must move: each input read once, each
    output written once."""
    (rep, cols, mem, allowed, loads, F, bvalid, scal, s_i, t_i, live,
     crows) = args
    ins = [rep, cols, mem, loads, F, bvalid, scal, s_i, t_i, live]
    ins += [t for t in (allowed, crows) if t is not None]
    B, B2 = mem.shape[1], s_i.shape[0]
    return sum(t.numel() * t.element_size() for t in ins) + 8 * (2 * B + 2 * B2)


def k1_ops(args, allow_leader):
    """Float32 operations the scoring pass does on these inputs (an add,
    multiply, divide or compare each), counted over the cells this data
    makes live: a source term (7: sub, div, sub, mul, mul, sub, min) per
    eligible non-leader member cell; a target term plus the sum and the
    compare (9) per allowed target cell of a row with a finite source;
    a pair candidate (2 x 6 + 2) per row and live pair column whose
    source and target both qualify; the same for leader cells."""
    import torch

    (rep, cols, mem, allowed, loads, F, bvalid, scal, s_i, t_i, live,
     crows) = args
    P, B = mem.shape
    lead = rep[:, :1].long() == torch.arange(B, device=mem.device)[None, :]
    elig = (cols[:, 4:5] > 0) & (cols[:, 2:3] >= scal[1])
    tmask = ~mem & bvalid[None, :]
    if allowed is not None:
        tmask &= allowed
    src = mem & ~lead & elig
    has_src = src.any(1, keepdim=True)
    si, ti = s_i.long(), t_i.long()
    pair = src[:, si] & tmask[:, ti] & live[None, :]
    ops = 7 * src.sum() + 9 * (tmask & has_src).sum() + 14 * pair.sum()
    if allow_leader:
        src_l = lead & elig & (cols[:, 1:2] >= 1)
        ops += 7 * src_l.sum() + 9 * (tmask & src_l.any(1, keepdim=True)).sum()
        ops += 14 * (src_l[:, si] & tmask[:, ti] & live[None, :]).sum()
    return int(ops)


def k1_bound_ms(args, allow_leader):
    t_bytes = k1_bytes(args, allow_leader) / PEAK_BYTES_PER_S
    t_ops = k1_ops(args, allow_leader) / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_k1(base, label, timed=True):
    """Phase 2 at one shape: every variant equal to the plain version;
    returns the timing of the main path's own variant (``timed``)."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    main = None
    for restricted in (False, True):
        for colo in (False, True):
            args = variant(base, restricted, colo)
            for allow_leader in (False, True):
                kw = dict(allow_leader=allow_leader)
                got = sk.shard_score(*args, **kw)
                again = sk.shard_score(*args, **kw)
                ref = sk.shard_score_plain(*args, **kw)
                torch.cuda.synchronize()
                err = 0.0
                for name, a, b, c in zip(
                    ("vf", "pf", "vl", "pl", "vpf", "ppf", "vpl", "ppl"),
                    got, again, ref,
                ):
                    if not (torch.equal(a, b) and bool((a == c).all())):
                        fail(
                            f"shard_score {label} restricted={restricted} "
                            f"colo={colo} allow_leader={allow_leader}: output "
                            f"{name} differs from the plain version"
                        )
                    if a.is_floating_point():
                        fin = torch.isfinite(c)
                        if fin.any():
                            err = max(err, float((a[fin] - c[fin]).abs().max()))
                log(
                    f"shard_score {label} restricted={restricted} colo={colo} "
                    f"allow_leader={allow_leader}: equal (8 outputs, "
                    f"max_abs_err {err})"
                )
                if not restricted and not colo and not allow_leader:
                    main = (args, err)
    if not timed:
        return None
    args, err = main
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    ms, host_ms = cuda_ms(
        lambda: sk.shard_score(*args, allow_leader=False), 20, flush
    )
    plain_ms, plain_host_ms = cuda_ms(
        lambda: sk.shard_score_plain(*args, allow_leader=False), 5, flush
    )
    bound_ms, bound_by = k1_bound_ms(args, False)
    P, B = args[2].shape
    log(
        f"shard_score {label} (P={P} B={B} R={args[0].shape[1]}, main-path "
        f"variant): kernel {ms} ms on the device ({host_ms} ms host per "
        f"call), plain {plain_ms} ms on the device ({plain_host_ms} ms host "
        f"per call), bound {bound_ms} ms ({bound_by}), "
        f"{k1_bytes(args, False)} bytes, {k1_ops(args, False)} ops"
    )
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)


class _Captured(Exception):
    """Stops a plan once its first chunk's session arguments are seen."""


def capture_session(n_parts, n_brokers, budget, seed, dev, weighted=True):
    """The whole-session kernel's arguments at the first chunk of
    ``plan(engine="pallas")`` on a synthetic cluster (``weighted=False``:
    every partition weighs the same, so candidate values tie often)."""
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    seen = []
    real = ps.pallas_session

    def capture(*args, **kw):
        seen.append((list(args), dict(kw)))
        raise _Captured()

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=seed, weighted=weighted)
    ps.pallas_session = capture
    try:
        plan(pl, cfg, budget, batch=100, engine="pallas", device=dev)
    except _Captured:
        pass
    finally:
        ps.pallas_session = real
    if not seen:
        fail(f"no session call captured at {n_parts}x{n_brokers}")
    return seen[0]


def b2_variant(args, kw, allow_leader, restricted, batch):
    import torch

    a, k = list(args), dict(kw)
    a[14] = batch
    k["allow_leader"] = allow_leader
    if restricted:
        P, B = a[1].shape[0], a[0].shape[0]
        g = torch.Generator(device=a[0].device).manual_seed(SEED)
        a[3] = torch.rand((P, B), generator=g, device=a[0].device) < 0.6
        k["all_allowed"] = False
    return a, k


def b2_state(a, k):
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    return ps.SessionState(a[0], a[1], a[3], *a[4:11], k["all_allowed"])


def k1_session_bytes(P, R, B, has_allowed):
    """Bytes one scoring pass must move at the session's shapes: replicas,
    row columns, member (and allowed) masks, the broker vectors and the
    pair frame read once, the key words written once."""
    B2 = max(1, B // 2)
    return (P * R * 4 + P * 5 * 4 + P * B * (2 if has_allowed else 1)
            + B * 9 + 12 + B2 * 9 + 8 * (2 * B + 2 * B2))


def b2_bound_ms(P, R, B, has_allowed, iters, n):
    """iterations x the scoring pass's bytes + the commit's bytes (per
    move: a replica cell, two member bytes, four log words; per iteration:
    the loads and broker counts), over the HBM rate."""
    by = iters * k1_session_bytes(P, R, B, has_allowed) + n * 22 + iters * 8 * B
    return 1e3 * by / PEAK_BYTES_PER_S, by


def sm_clock_mhz():
    """The SM clock nvidia-smi reads now, in MHz, or None."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        return float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def b2_split(a, k, label):
    """Phase 2b's split of an iteration: one launch of the main-path
    variant with phase stamps, whose seven outputs must equal an unstamped
    launch's. Prints each phase's share of the iterations' cycles, its
    median and its sum over iterations (iterations 1.. — the first has no
    start stamp), and the median iteration in cycles and in us at the SM
    clock nvidia-smi reads right after the launch; returns the shares."""
    import torch

    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    largs = (*a[11:16], k["max_moves"], False)
    ref_st = b2_state(a, k)
    ref_log, ref_counts = ps.launch(ref_st, *largs)
    st = b2_state(a, k)
    stamps = torch.zeros(
        (ps.stamp_rows(a[13], k["max_moves"]), len(ps.STAMP_PHASES)),
        dtype=torch.int64, device=st.device,
    )
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    log_, counts = ps.launch(st, *largs, stamps=stamps)
    ev1.record()
    torch.cuda.synchronize()
    mhz = sm_clock_mhz()
    ms = ev0.elapsed_time(ev1)
    n, iters = int(counts[0]), int(counts[1])
    for name, x, y in zip(
        B2_NAMES,
        (st.replicas, st.loads, counts[0], *log_),
        (ref_st.replicas, ref_st.loads, ref_counts[0], *ref_log),
    ):
        if not torch.equal(x, y):
            fail(f"pallas_session {label}: the stamped launch's {name} differs "
                 f"from the unstamped launch's")
    if iters < 2:
        fail(f"pallas_session {label}: {iters} iterations, no split")
    s = stamps[:iters].cpu()
    d = torch.empty((iters - 1, len(ps.STAMP_PHASES)), dtype=torch.int64)
    d[:, 0] = s[1:, 0] - s[:-1, -1]
    d[:, 1:] = s[1:, 1:] - s[1:, :-1]
    if bool((d < 0).any()):
        fail(f"pallas_session {label}: phase stamps out of order")
    total = int(d.sum())
    per_it = d.sum(1)
    med_it = float(per_it.double().median())
    shares = {}
    for i, name in enumerate(ps.STAMP_PHASES):
        col = d[:, i]
        shares[name] = int(col.sum()) / total
        log(f"  split {label} {name}: {100 * shares[name]:.2f} % of the cycles, "
            f"median {float(col.double().median())} cycles, sum {int(col.sum())} "
            f"cycles over {iters - 1} iterations")
    span = int(s[-1, -1] - s[0, 0])
    log(
        f"pallas_session {label} split (stamped main-path launch, {n} moves in "
        f"{iters} iterations, {ms} ms by events): median iteration {med_it} "
        f"cycles = {med_it / mhz if mhz else 'n/a'} us at the SM clock "
        f"nvidia-smi reads, {mhz} MHz; the stamps span {span} cycles, "
        f"{span / (1e3 * ms)} MHz against the event time; scoring "
        f"(table + own scoring + barrier) {100 * (shares['table'] + shares['own_scoring'] + shares['barrier']):.2f} %"
    )
    return shares


def check_b2(args, kw, label, main_batch, flush):
    """Phase 2b at one shape: every variant equal to the plain version and
    repeatable; returns the main variant's timings."""
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers import scan

    for allow_leader in (False, True):
        for restricted in (False, True):
            for batch in (1, main_batch):
                a, k = b2_variant(args, kw, allow_leader, restricted, batch)
                i0 = obs.REGISTRY.counter_get("solver.session_iterations")
                t0 = time.perf_counter()
                got = ps.pallas_session(*a, **k)
                wall = time.perf_counter() - t0
                iters = int(obs.REGISTRY.counter_get("solver.session_iterations") - i0)
                again = ps.pallas_session(*a, **k)
                t0 = time.perf_counter()
                ref = ps.pallas_session_plain(*a, **k)
                torch.cuda.synchronize()
                plain_wall = time.perf_counter() - t0
                for name, x, y, z in zip(B2_NAMES, got, again, ref):
                    same = (
                        x == y == z if not torch.is_tensor(x)
                        else torch.equal(x, y) and torch.equal(x, z)
                    )
                    if not same:
                        fail(
                            f"pallas_session {label} allow_leader={allow_leader} "
                            f"restricted={restricted} batch={batch}: output "
                            f"{name} differs from the plain version or between "
                            f"launches"
                        )
                log(
                    f"pallas_session {label} allow_leader={allow_leader} "
                    f"restricted={restricted} batch={batch}: equal (7 outputs, "
                    f"two launches identical), {got[2]} moves in {iters} "
                    f"iterations, {1e3 * wall} ms host wall per call, plain "
                    f"{1e3 * plain_wall} ms host wall"
                )
    a, k = b2_variant(args, kw, False, False, main_batch)
    P, R = a[1].shape
    B = a[0].shape[0]
    i0 = obs.REGISTRY.counter_get("solver.session_iterations")
    n = ps.pallas_session(*a, **k)[2]
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations") - i0)
    reps = 5
    states = iter([b2_state(a, k) for _ in range(2 + 2 * reps)])
    ms, host_ms = cuda_ms(
        lambda: ps.launch(next(states), *a[11:16], k["max_moves"], False),
        reps, flush,
    )
    plain_ms, _ = cuda_ms(lambda: ps.pallas_session_plain(*a, **k), 1, flush)
    # the torch session (engine="xla") on the same inputs, host clock
    member = b2_state(a, k).member
    s0 = obs.REGISTRY.counter_get("solver.session_seconds")
    i0 = obs.REGISTRY.counter_get("solver.session_iterations")
    scan.session(
        a[0], a[1], member, None, *a[4:14], max_moves=k["max_moves"],
        allow_leader=False, batch=main_batch,
    )
    torch.cuda.synchronize()
    xla_s = obs.REGISTRY.counter_get("solver.session_seconds") - s0
    xla_it = obs.REGISTRY.counter_get("solver.session_iterations") - i0
    bound_ms, by = b2_bound_ms(P, R, B, False, iters, n)
    log(
        f"pallas_session {label} (P={P} B={B} R={R}, batch={main_batch}, "
        f"budget={a[13]}, main-path variant): {n} moves in {iters} iterations; kernel {ms} ms per launch "
        f"on the device ({ms / iters} ms per iteration, {host_ms} ms host to "
        f"launch); torch session {1e3 * xla_s / xla_it} ms per iteration "
        f"({xla_it} iterations, host clock); plain {plain_ms} ms on the "
        f"device; bound {bound_ms} ms (bytes: {iters} iterations x "
        f"{k1_session_bytes(P, R, B, False)} B per scoring pass + {n} moves x "
        f"22 B + {iters} x 8 x {B} B = {by} B at {PEAK_BYTES_PER_S} B/s)"
    )
    split = b2_split(a, k, label)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                max_abs_err=0.0, split=split)


def check_b2_ties(dev):
    """Phase 2b's tie case: an unweighted cluster (equal partition
    weights, so candidate values tie often and the index decides) at the
    10k x 100 bucket, batch 100, leaders off and on; all seven outputs
    equal to the plain version's under ``==``."""
    import torch

    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    args, kw = capture_session(*MAIN_SHAPE, MAIN_REASSIGN, SEED, dev,
                               weighted=False)
    for allow_leader in (False, True):
        a, k = b2_variant(args, kw, allow_leader, False, 100)
        got = ps.pallas_session(*a, **k)
        ref = ps.pallas_session_plain(*a, **k)
        torch.cuda.synchronize()
        for name, x, z in zip(B2_NAMES, got, ref):
            same = x == z if not torch.is_tensor(x) else torch.equal(x, z)
            if not same:
                fail(f"pallas_session unweighted 10k x 100 allow_leader="
                     f"{allow_leader}: output {name} differs from the plain "
                     f"version")
        log(f"pallas_session unweighted 10k x 100 allow_leader={allow_leader} "
            f"batch=100: equal (7 outputs), {got[2]} moves")


NO_MOVES = '{"partitions": null}'


def planned(text, plan):
    """The cluster ``text`` with every move of the reassignment document
    ``plan`` applied, and the document's rows."""
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader

    final = get_partition_list_from_reader(text, True)
    by_key = {(p.topic, p.partition): p for p in final.partitions}
    rows = json.loads(plan).get("partitions") or []
    for row in rows:
        by_key[(row["topic"], row["partition"])].replicas = list(row["replicas"])
    return final, rows


def unbalance_of(pl):
    """The host oracle's unbalance (``balancer/costmodel.py``)."""
    from kafkabalancer_tpu_torch.balancer.costmodel import (
        get_bl,
        get_broker_load,
        get_unbalance_bl,
    )

    return get_unbalance_bl(get_bl(get_broker_load(pl)))


def planned_unbalance(text, plan):
    """The host oracle's unbalance of the cluster ``text`` with every move
    of the reassignment document ``plan`` applied."""
    return unbalance_of(planned(text, plan)[0])


def phase_main_path(dev):
    """Phase 3: the CLI's -fused path on the card, then the same session
    with the plain scorer."""
    import torch

    from kafkabalancer_tpu_torch import cli, obs
    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    n_parts, n_brokers = MAIN_SHAPE
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=SEED, weighted=True)
    buf = io.StringIO()
    write_partition_list(buf, pl)
    text = buf.getvalue()
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "smoke_cluster.json")
    with open(path, "w") as fh:
        fh.write(text)

    u0 = planned_unbalance(text, NO_MOVES)
    args = ["kafkabalancer", "-input-json", "-input", path, "-fused",
            "-fused-batch=100", "-max-reassign=1000000",
            "-min-unbalance=1e-7"]
    out, err = io.StringIO(), io.StringIO()
    sk.shard_score.launches = 0
    t0 = time.perf_counter()
    rc = cli.run(io.StringIO(""), out, err, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.shard_score.launches
    if rc != 0:
        fail(f"cli.run returned {rc}: {err.getvalue()[-2000:]}")
    doc = json.loads(out.getvalue())
    if doc.get("version") != 1 or not doc.get("partitions"):
        fail("the plan is not a non-empty reassignment document")
    if launches <= 0:
        fail("the main path did not launch the shard_score kernel")
    u1 = planned_unbalance(text, out.getvalue())
    if not u1 < u0:
        fail(f"final unbalance {u1} is not below the input's {u0}")
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations"))
    sess_s = obs.REGISTRY.counter_get("solver.session_seconds")
    log(
        f"main path: cli.run -fused -fused-batch=100 on {n_parts}x{n_brokers}: "
        f"rc 0, {len(doc['partitions'])} moves emitted, {wall} s wall "
        f"({sess_s} s in the session loop, {iters} iterations), "
        f"shard_score launches {launches}, unbalance {u0} -> {u1}"
    )

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    pl2 = get_partition_list_from_reader(text, True)
    opl = plan(pl2, cfg, 1000000, batch=100, device=dev,
               scorer=sk.shard_score_plain)
    out2 = io.StringIO()
    write_partition_list(out2, opl)
    if out2.getvalue() != out.getvalue():
        fail("the plain scorer's session emitted a different plan")
    log("main path: the plain scorer's session emitted the identical plan")
    return launches, out.getvalue(), path, u1


# every avg the run's scoring passes meet (phase 5), as [1] float32 tensors
AVGS = []


def record_avgs():
    """From here on, every call of the scoring pass's plain version records
    its avg (scal[0]; the callers build a new scal per call): the plain
    versions compute every avg the kernels meet on the same inputs, with
    the same bits."""
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    plain = sk.shard_score_plain

    def recording(*args, **kw):
        AVGS.append(args[7][:1])  # a view: no device work
        return plain(*args, **kw)

    sk.shard_score_plain = recording
    ps.shard_score_plain = recording


def avg_sweep():
    """Phase 5's seeded avgs: powers of two and all-ones significands from
    2^-41 to 2^41 (the reciprocal's range and one binade beyond), the two
    floats just outside the range, and 200 log-uniform values over
    [1e-3, 1e9]."""
    import numpy as np

    exps = np.arange(-41, 42)
    pow2 = np.ldexp(np.float32(1), exps).astype(np.float32)
    ones = ((exps + 127).astype(np.uint32) << 23 | 0x7FFFFF).view(np.float32)
    edge = np.array([np.nextafter(np.float32(2.0**-40), np.float32(0)),
                     np.nextafter(np.float32(2.0**40), np.float32(np.inf))],
                    np.float32)
    rng = np.random.default_rng(SEED)
    logu = (10.0 ** rng.uniform(-3, 9, 200)).astype(np.float32)
    return np.concatenate([pow2, ones, edge, logu])


def phase_division(dev):
    """Phase 5: the reciprocal division against the IEEE division for every
    finite float32 x at every avg met and at the sweep."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    met = torch.unique(torch.cat([a.to(dev, torch.float32) for a in AVGS]))
    sweep = torch.tensor(avg_sweep(), device=dev)
    avgs = torch.cat([met, sweep])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bad = sk.div_mismatches(avgs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    wrong = torch.nonzero(bad).flatten()
    if wrong.numel():
        fail(f"division check: {int(bad.sum())} mismatches at "
             f"{wrong.numel()} avgs, e.g. avg {avgs[wrong[:4]].tolist()}")
    log(f"division check: the reciprocal quotient equals the IEEE quotient "
        f"for every finite float32 x at {avgs.numel()} avgs ({met.numel()} "
        f"met by this run's scoring passes, range {float(met.min())} .. "
        f"{float(met.max())}; {sweep.numel()} in the sweep): 0 mismatches "
        f"in {avgs.numel()} x 2^32 - 2^25 quotients, {secs} s")


def phase_scale(dev):
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    n_parts, n_brokers = SCALE_SHAPE
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=SEED + 1, weighted=True)
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    def scorer(*args, **kw):
        AVGS.append(args[7][:1])  # a view: no device work
        return sk.shard_score(*args, **kw)

    obs.begin_invocation()
    sk.shard_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opl = plan(pl, cfg, SCALE_MOVES, batch=128, device=dev, scorer=scorer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations"))
    sess_s = obs.REGISTRY.counter_get("solver.session_seconds")
    if not opl.partitions or iters <= 0:
        fail("the scale session planned nothing")
    log(
        f"scale: plan {n_parts}x{n_brokers} batch=128 max_reassign="
        f"{SCALE_MOVES}: {len(opl)} moves, {iters} session iterations, "
        f"{wall} s wall ({sess_s} s in the session loop, "
        f"{1e3 * sess_s / iters} ms per iteration), shard_score "
        f"launches {sk.shard_score.launches}"
    )


def phase_pallas_path(dev, xla_plan, path):
    """Phase 3b: the CLI's -fused -fused-engine=pallas path on the card on
    phase 3's cluster file, then ``plan(engine="pallas-interpret")`` on
    the card."""
    import torch

    from kafkabalancer_tpu_torch import cli, obs
    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers.scan import plan

    with open(path) as fh:
        text = fh.read()
    u0 = planned_unbalance(text, NO_MOVES)
    args = ["kafkabalancer", "-input-json", "-input", path, "-fused",
            "-fused-engine=pallas", "-fused-batch=100",
            f"-max-reassign={MAIN_REASSIGN}", "-min-unbalance=1e-7"]
    out, err = io.StringIO(), io.StringIO()
    ps.pallas_session.launches = 0
    sk.shard_score.launches = 0
    t0 = time.perf_counter()
    rc = cli.run(io.StringIO(""), out, err, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ps.pallas_session.launches
    k1_launches = sk.shard_score.launches
    if rc != 0:
        fail(f"cli.run -fused-engine=pallas returned {rc}: {err.getvalue()[-2000:]}")
    doc = json.loads(out.getvalue())
    if doc.get("version") != 1 or not doc.get("partitions"):
        fail("the pallas plan is not a non-empty reassignment document")
    if launches <= 0:
        fail("the pallas path did not launch the pallas_session kernel")
    u1 = planned_unbalance(text, out.getvalue())
    if not u1 < u0:
        fail(f"pallas path: final unbalance {u1} is not below the input's {u0}")
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations"))
    sess_s = obs.REGISTRY.counter_get("solver.session_seconds")
    log(
        f"pallas path: cli.run -fused -fused-engine=pallas -fused-batch=100 on "
        f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: rc 0, {len(doc['partitions'])} moves "
        f"emitted, {wall} s wall ({sess_s} s in session launches and reads, "
        f"{iters} iterations), pallas_session launches {launches}, "
        f"shard_score launches {k1_launches}, unbalance {u0} -> {u1}"
    )
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    opl = plan(get_partition_list_from_reader(text, True), cfg, MAIN_REASSIGN,
               batch=100, engine="pallas-interpret", device=dev)
    out2 = io.StringIO()
    write_partition_list(out2, opl)
    if out2.getvalue() != out.getvalue():
        fail("plan(engine='pallas-interpret') emitted a different plan")
    log("pallas path: plan(engine='pallas-interpret') on the card emitted the "
        "identical plan")
    log(f"pallas path: the plan equals the -fused-engine=xla plan: "
        f"{out.getvalue() == xla_plan}")
    return launches


def phase_scale_pallas(dev):
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    n_parts, n_brokers = SCALE_SHAPE
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=SEED + 1, weighted=True)
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    obs.begin_invocation()
    ps.pallas_session.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opl = plan(pl, cfg, SCALE_MOVES, batch=128, engine="pallas", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations"))
    sess_s = obs.REGISTRY.counter_get("solver.session_seconds")
    if not opl.partitions or iters <= 0:
        fail("the pallas scale session planned nothing")
    log(
        f"scale pallas: plan {n_parts}x{n_brokers} batch=128 engine=pallas "
        f"max_reassign={SCALE_MOVES}: {len(opl)} moves, {iters} session "
        f"iterations, {wall} s wall ({sess_s} s in session launches and "
        f"reads, {1e3 * sess_s / iters} ms per iteration), pallas_session "
        f"launches {ps.pallas_session.launches}"
    )


def run_cli(args, device=None):
    """``cli.run(args)`` on the card: ``(rc, stdout, stderr, wall s)``; the
    wall ends with a device sync."""
    import torch

    from kafkabalancer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    rc = cli.run(io.StringIO(""), out, err, ["kafkabalancer"] + args,
                 device=device)
    torch.cuda.synchronize()
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def plan_text(opl):
    from kafkabalancer_tpu_torch.codecs import write_partition_list

    buf = io.StringIO()
    write_partition_list(buf, opl)
    return buf.getvalue()


def counters(prefix):
    from kafkabalancer_tpu_torch import obs

    snap = obs.REGISTRY.snapshot().get("counters", {})
    return {k: v for k, v in sorted(snap.items()) if k.startswith(prefix)}


# the headline planning configuration of the reference (its README and
# benchmark suite lead with it): -allow-leader, batch 100, pair-swap polish
HEADLINE = ["-fused", "-fused-batch=100", "-allow-leader", "-fused-polish",
            f"-max-reassign={MAIN_REASSIGN}", "-min-unbalance=1e-7"]


def phase_headline(dev, path, u_move):
    """Phase 6: the headline configuration through the CLI on phase 3's
    cluster, with the torch session (K1 in every move phase) and with
    ``-fused-engine=pallas`` (one B2 launch up front); each plan equal to
    the same alternation with the kernel's plain version. Returns the
    launch counts per path."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers.scan import plan

    with open(path) as fh:
        text = fh.read()
    u0 = planned_unbalance(text, NO_MOVES)
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    cfg.allow_leader_rebalancing = True
    launches = {}
    for engine, plain in (("xla", dict(scorer=sk.shard_score_plain)),
                          ("pallas", dict(engine="pallas-interpret"))):
        args = ["-input-json", "-input", path] + HEADLINE + [
            f"-fused-engine={engine}"]
        sk.shard_score.launches = 0
        ps.pallas_session.launches = 0
        obs.begin_invocation()
        rc, out, err, wall = run_cli(args)
        k1, b2 = sk.shard_score.launches, ps.pallas_session.launches
        if rc != 0:
            fail(f"headline -fused-engine={engine} returned {rc}: {err[-2000:]}")
        doc = json.loads(out)
        if not doc.get("partitions"):
            fail(f"headline -fused-engine={engine}: an empty plan")
        if k1 <= 0 or (engine == "pallas" and b2 != 1):
            fail(f"headline -fused-engine={engine}: shard_score launches {k1}, "
                 f"pallas_session launches {b2}")
        pol = counters("polish.")
        sess = counters("solver.session_")
        u = planned_unbalance(text, out)
        if not u < u0:
            fail(f"headline -fused-engine={engine}: unbalance {u} is not below "
                 f"the input's {u0}")
        log(f"headline -fused-engine={engine} on {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} "
            f"({' '.join(HEADLINE)}): rc 0, {len(doc['partitions'])} moves "
            f"emitted, {wall} s wall, unbalance {u} (phase 3's move session "
            f"alone: {u_move}), shard_score launches {k1}, pallas_session "
            f"launches {b2}")
        log(f"headline -fused-engine={engine} split: {json.dumps(pol)} "
            f"{json.dumps(sess)}")
        launches[engine] = (k1, b2)
        opl = plan(get_partition_list_from_reader(text, True), cfg,
                   MAIN_REASSIGN, batch=100, polish=True, device=dev, **plain)
        if plan_text(opl) != out:
            fail(f"headline -fused-engine={engine}: the plan differs from the "
                 f"same alternation with {plain}")
        log(f"headline -fused-engine={engine}: the plan equals the same "
            f"alternation with the kernel's plain version")
    return launches


LEADER_B1_BUDGET = 2000


def phase_leader(dev, path):
    """Phase 7: the fused -rebalance-leader session at 10k x 100, batch 1
    for a bounded budget (the reference trajectory; compared with the same
    session on CPU tensors, a finding) and batch 100 to convergence."""
    import torch

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers.scan import plan

    with open(path) as fh:
        text = fh.read()
    u0 = planned_unbalance(text, NO_MOVES)
    for batch, budget in ((1, LEADER_B1_BUDGET), (100, MAIN_REASSIGN)):
        args = ["-input-json", "-input", path, "-fused", "-rebalance-leader",
                f"-fused-batch={batch}", f"-max-reassign={budget}",
                "-min-unbalance=1e-7", "-complete-partition=false"]
        rc, out, err, wall = run_cli(args)
        if rc != 0:
            fail(f"-rebalance-leader batch {batch} returned {rc}: {err[-2000:]}")
        doc = json.loads(out)
        if not doc.get("partitions"):
            fail(f"-rebalance-leader batch {batch}: an empty plan")
        u = planned_unbalance(text, out)
        log(f"leader -fused -rebalance-leader -fused-batch={batch} "
            f"-max-reassign={budget} on {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: rc 0, "
            f"{len(doc['partitions'])} moves emitted, {wall} s wall, "
            f"unbalance {u0} -> {u}")
        if batch == 1:
            cfg = default_rebalance_config()
            cfg.min_unbalance = 1e-7
            cfg.rebalance_leaders = True
            t0 = time.perf_counter()
            opl = plan(get_partition_list_from_reader(text, True), cfg, budget,
                       batch=1, dtype=torch.float32, device="cpu")
            cpu_s = time.perf_counter() - t0
            cpu_out = plan_text(opl)
            log(f"leader batch 1: the card's plan equals the same float32 "
                f"session on CPU tensors: {cpu_out == out} (CPU run "
                f"{cpu_s} s)")
            if cpu_out != out:
                a = json.loads(out)["partitions"]
                b = json.loads(cpu_out).get("partitions") or []
                first = next((i for i, (x, y) in enumerate(zip(a, b))
                              if x != y), min(len(a), len(b)))
                log(f"leader batch 1: the plans part at entry {first} of "
                    f"{len(a)} (card) / {len(b)} (CPU); "
                    f"{loads_on_both(text, dev)}")


def loads_on_both(text, dev):
    """Whether the float32 broker loads of the cluster ``text`` come out
    equal from ``cost.broker_loads`` on the card and on the CPU (the
    scatter-add order differs: ``index_put_`` on CUDA, ``index_add_`` on
    the CPU)."""
    import torch

    from kafkabalancer_tpu_torch.balancer import steps
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device

    pl = get_partition_list_from_reader(text, True)
    cfg = default_rebalance_config()
    steps.validate_weights(pl, cfg)
    steps.fill_defaults(pl, cfg)
    dp = tensorize(pl, cfg)
    loads = []
    for d in (dev, "cpu"):
        a = to_device(dp, d, torch.float32)
        loads.append(broker_loads(a.replicas, a.weights, a.nrep_cur, a.ncons,
                                  dp.bvalid.shape[0]).cpu())
    diff = int((loads[0] != loads[1]).sum())
    return (f"initial broker loads equal on the card and the CPU: "
            f"{diff == 0} ({diff} of {dp.nb} brokers differ, max abs "
            f"difference {float((loads[0] - loads[1]).abs().max())})")


TPU_SMALL = (1000, 40)


def phase_solver_tpu(dev, path):
    """Phase 8: -solver=tpu byte-identical to -solver=greedy on a cluster
    where the device pass runs, then one move at 10k x 100 (the reference's
    deployment loop: one move per invocation)."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import write_partition_list
    from kafkabalancer_tpu_torch.solvers import tpu
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    n_parts, n_brokers = TPU_SMALL
    small = os.path.join("chiprun_out", "smoke_cluster_small.json")
    with open(small, "w") as fh:
        write_partition_list(fh, synth_cluster(n_parts, n_brokers, rf=3,
                                               seed=SEED + 2, weighted=True))
    cands = n_parts * 2 * n_brokers
    if cands < tpu.MIN_DEVICE_CANDIDATES:
        fail(f"the -solver=tpu cluster has {cands} candidates, below "
             f"{tpu.MIN_DEVICE_CANDIDATES}")
    outs = {}
    for solver in ("greedy", "tpu"):
        obs.begin_invocation()
        rc, out, err, wall = run_cli(["-input-json", "-input", small,
                                      f"-solver={solver}", "-max-reassign=10"])
        if rc != 0:
            fail(f"-solver={solver} returned {rc}: {err[-2000:]}")
        outs[solver] = out
        c = counters("solver.window_")
        log(f"solver: -solver={solver} -max-reassign=10 on {n_parts}x"
            f"{n_brokers} ({cands} follower candidates): rc 0, "
            f"{len(json.loads(out).get('partitions') or [])} moves, {wall} s, "
            f"{json.dumps(c)}")
        if solver == "tpu" and c.get("solver.window_passes", 0) <= 0:
            fail("-solver=tpu made no device pass")
    if outs["tpu"] != outs["greedy"]:
        fail("-solver=tpu emitted another plan than -solver=greedy")
    log("solver: -solver=tpu stdout is byte-identical to -solver=greedy")

    obs.begin_invocation()
    rc, out, err, wall = run_cli(["-input-json", "-input", path,
                                  "-solver=tpu", "-max-reassign=1",
                                  "-min-unbalance=1e-7"])
    c = counters("solver.window_")
    if rc != 0:
        fail(f"-solver=tpu at {MAIN_SHAPE} returned {rc}: {err[-2000:]}")
    if c.get("solver.window_passes", 0) <= 0:
        fail("-solver=tpu at 10k x 100 made no device pass")
    if not json.loads(out).get("partitions"):
        fail("-solver=tpu at 10k x 100 emitted no move")
    log(f"solver: -solver=tpu -max-reassign=1 -min-unbalance=1e-7 on "
        f"{MAIN_SHAPE[0]}x"
        f"{MAIN_SHAPE[1]}: rc 0, {len(json.loads(out).get('partitions') or [])} "
        f"moves, {wall} s wall (input parse, pipeline head, one device pass "
        f"per tier, host re-scan), device passes "
        f"{int(c.get('solver.window_passes', 0))}, window rows re-scanned "
        f"{int(c.get('solver.window_rows', 0))}")


# the JAX package's benchmark configuration 4b (benchmarks/suite.py:349-362):
# 10k partitions x 100 brokers, weighted, power-law topic sizes, seed 42,
# lambda 1e-3, min_unbalance 1e-6, the session at batch 128, beam width 8,
# depth 4 with siblings
COLO_SEED = 42
COLO_LAM = 0.001
COLO_FLAGS = ["-fused", "-fused-batch=128", "-allow-leader",
              f"-anti-colocation={COLO_LAM}", "-min-unbalance=1e-6",
              "-max-reassign=524288"]
# the suite plans 4096 beam moves; cut to fit the script's time limit
BEAM_BUDGET = 256


def colocations(pl):
    """Same-topic replicas sharing a broker beyond the first:
    sum over (topic, broker) of max(0, count - 1)."""
    per = {}
    for p in pl.partitions:
        for b in p.replicas:
            per[(p.topic, b)] = per.get((p.topic, b), 0) + 1
    return sum(max(0, c - 1) for c in per.values())


def colocation_floor(pl, n_brokers):
    """The pigeonhole floor: a topic with s replicas in all on B brokers
    keeps at least max(0, s - B) colocations."""
    per = {}
    for p in pl.partitions:
        per[p.topic] = per.get(p.topic, 0) + len(p.replicas)
    return sum(max(0, c - n_brokers) for c in per.values())


def capture_colo_inputs(pl, dev):
    """The scoring kernel's inputs (counts rows included) at the first
    iteration of the colocation session with -allow-leader."""
    import torch

    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel
    from kafkabalancer_tpu_torch.solvers.scan import plan

    seen = []

    def capture(*args, **kw):
        if not seen:
            seen.append([a.clone() if torch.is_tensor(a) else a
                         for a in (*args, kw.get("c_rows"))])
        return shard_kernel.shard_score(*args, **kw)

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-6
    cfg.allow_leader_rebalancing = True
    plan(pl, cfg, 1, batch=128, device=dev, scorer=capture,
         anti_colocation=COLO_LAM)
    if not seen or seen[0][11] is None:
        fail("no colocation scoring call captured")
    return seen[0]


def check_k1_colo(args):
    """K1's colocation variant on the colocation session's own inputs:
    the eight outputs equal to the plain version's, then device times
    and the bound."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    got = sk.shard_score(*args, allow_leader=True)
    ref = sk.shard_score_plain(*args, allow_leader=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, c in zip(("vf", "pf", "vl", "pl", "vpf", "ppf", "vpl", "ppl"),
                          got, ref):
        if not bool((a == c).all()):
            fail(f"shard_score colocation variant: output {name} differs from "
                 f"the plain version")
        if a.is_floating_point():
            fin = torch.isfinite(c)
            if fin.any():
                err = max(err, float((a[fin] - c[fin]).abs().max()))
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms, host_ms = cuda_ms(lambda: sk.shard_score(*args, allow_leader=True), 20,
                          flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: sk.shard_score_plain(*args, allow_leader=True),
                          5, flush_buf.zero_)
    bound_ms, bound_by = k1_bound_ms(args, True)
    P, B = args[2].shape
    log(f"shard_score colocation variant (P={P} B={B}, allow_leader, the "
        f"phase 9 session's first iteration): equal (8 outputs, max_abs_err "
        f"{err}); kernel {ms} ms on the device ({host_ms} ms host per call), "
        f"plain {plain_ms} ms, bound {bound_ms} ms ({bound_by}: "
        f"{k1_bytes(args, True)} bytes incl. {args[11].numel() * 4} of counts "
        f"rows, {k1_ops(args, True)} ops)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)


def phase_colocation(dev):
    """Phase 9: the colocation session on config 4b's cluster through
    ``cli.run``, without and with -fused-polish and with
    -fused-engine=pallas (overridden to the torch session). Each plan
    equals the same session with the kernel's plain version; the pallas
    request's plan equals the torch session's; every assignment is
    duplicate-free and the combined objective fell."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import (
        get_partition_list_from_reader,
        write_partition_list,
    )
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    n_parts, n_brokers = MAIN_SHAPE
    pl0 = synth_cluster(n_parts, n_brokers, rf=3, seed=COLO_SEED,
                        weighted=True, zipf_topics=True)
    path = os.path.join("chiprun_out", "smoke_colo_cluster.json")
    with open(path, "w") as fh:
        write_partition_list(fh, pl0)
    with open(path) as fh:
        text = fh.read()
    u0, c0, floor = unbalance_of(pl0), colocations(pl0), colocation_floor(
        pl0, n_brokers)
    j0 = u0 + COLO_LAM * c0
    k1 = check_k1_colo(capture_colo_inputs(
        get_partition_list_from_reader(text, True), dev))
    launches, plans = {}, {}
    for name, extra in (("session", []), ("polish", ["-fused-polish"]),
                        ("pallas", ["-fused-engine=pallas"])):
        sk.shard_score.launches = 0
        ps.pallas_session.launches = 0
        obs.begin_invocation()
        rc, out, err, wall = run_cli(["-input-json", "-input", path]
                                     + COLO_FLAGS + extra)
        n_k1, n_b2 = sk.shard_score.launches, ps.pallas_session.launches
        if rc != 0:
            fail(f"colocation {name} returned {rc}: {err[-2000:]}")
        final, rows = planned(text, out)
        if not rows:
            fail(f"colocation {name}: an empty plan")
        if n_k1 <= 0 or n_b2 != 0:
            fail(f"colocation {name}: shard_score launches {n_k1}, "
                 f"pallas_session launches {n_b2}")
        for row in rows:
            if len(set(row["replicas"])) != len(row["replicas"]):
                fail(f"colocation {name}: duplicate replicas in {row}")
        u1, c1 = unbalance_of(final), colocations(final)
        j1 = u1 + COLO_LAM * c1
        if not j1 < j0:
            fail(f"colocation {name}: the combined objective {j1} is not below "
                 f"the input's {j0}")
        sess = counters("solver.session_")
        log(f"colocation {name} on {n_parts}x{n_brokers} (config 4b: "
            f"{' '.join(COLO_FLAGS + extra)}): rc 0, {len(rows)} moves "
            f"emitted, {wall} s wall, colocations {c0} -> {c1} (floor "
            f"{floor}), unbalance {u0} -> {u1}, objective u+{COLO_LAM}*coloc "
            f"{j0} -> {j1}, shard_score launches {n_k1}, {json.dumps(sess)}"
            + (f" {json.dumps(counters('polish.'))}" if name == "polish"
               else ""))
        log(f"colocation {name}: reached the colocation floor: {c1 == floor} "
            f"({c1 - floor} above it)")
        if name == "pallas":
            if "-fused-engine=pallas is ignored" not in err:
                fail("colocation pallas: the engine override was not logged")
            if out != plans["session"]:
                fail("colocation pallas: the plan differs from the torch "
                     "session's")
            log("colocation pallas: the override was logged and the plan "
                "equals the torch session's")
        else:
            cfg = default_rebalance_config()
            cfg.min_unbalance = 1e-6
            cfg.allow_leader_rebalancing = True
            opl = plan(get_partition_list_from_reader(text, True), cfg, 524288,
                       batch=128, polish=name == "polish", device=dev,
                       scorer=sk.shard_score_plain, anti_colocation=COLO_LAM)
            if plan_text(opl) != out:
                fail(f"colocation {name}: the plan differs from the same "
                     f"session with the kernel's plain version")
            log(f"colocation {name}: the plan equals the same session with "
                f"the kernel's plain version")
        launches[name], plans[name] = n_k1, out
    return launches, k1, path


def objectives(pl):
    u = unbalance_of(pl)
    return u, u + COLO_LAM * colocations(pl)


def phase_beam(dev, path):
    """Phase 10: -solver=beam on config 4b's cluster through ``cli.run``,
    every emitted move checked on its own (the reference step's
    invariant: it improves the unbalance, or at the depth-1 retry the
    combined objective, by min_unbalance); then ``beam_plan`` with a
    budget of BEAM_BUDGET moves."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.solvers import beam

    mu = 1e-6
    with open(path) as fh:
        text = fh.read()
    real = beam.beam_move
    steps = []

    def checked(pl, cfg, device=None):
        before = objectives(pl)
        ppl = real(pl, cfg, device)
        if ppl is not None and ppl.partitions:
            src = ppl.partitions[0]._source
            old = list(src.replicas)
            src.replicas[:] = ppl.partitions[0].replicas
            after = objectives(pl)
            src.replicas[:] = old
            steps.append((before, after))
        return ppl

    beam.beam_move = checked
    obs.begin_invocation()
    try:
        rc, out, err, wall = run_cli(
            ["-input-json", "-input", path, "-solver=beam",
             f"-anti-colocation={COLO_LAM}", "-beam-siblings",
             "-max-reassign=4", f"-min-unbalance={mu}"])
    finally:
        beam.beam_move = real
    if rc != 0:
        fail(f"-solver=beam returned {rc}: {err[-2000:]}")
    rows = json.loads(out).get("partitions") or []
    if not rows or not steps:
        fail("-solver=beam emitted no move")
    for i, ((u0, j0), (u1, j1)) in enumerate(steps):
        if not (u1 < u0 - mu or j1 < j0 - mu):
            fail(f"-solver=beam move {i} improves neither the unbalance "
                 f"({u0} -> {u1}) nor the combined objective ({j0} -> {j1}) "
                 f"by {mu}")
    by_u = sum(u1 < u0 - mu for (u0, _), (u1, _) in steps)
    c = counters("beam.")
    per_step = 1e3 * c.get("beam.search_seconds", 0.0) / max(
        1, c.get("beam.depth_steps", 0))
    log(f"beam: cli.run -solver=beam -anti-colocation={COLO_LAM} "
        f"-beam-siblings -max-reassign=4 -min-unbalance={mu} on "
        f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: rc 0, {len(rows)} moves emitted, "
        f"{wall} s wall, {len(steps)} steps each improving on its own "
        f"({by_u} the unbalance, {len(steps) - by_u} only the combined "
        f"objective), objective {steps[0][0][1]} -> {steps[-1][1][1]}, "
        f"{per_step} ms per depth step (host clock, {json.dumps(c)})")

    cfg = default_rebalance_config()
    cfg.min_unbalance = mu
    cfg.anti_colocation = COLO_LAM
    cfg.beam_width, cfg.beam_depth, cfg.beam_siblings = 8, 4, True
    pl = get_partition_list_from_reader(text, True)
    j0 = objectives(pl)[1]
    c0 = colocations(pl)
    obs.begin_invocation()
    t0 = time.perf_counter()
    opl = beam.beam_plan(pl, cfg, BEAM_BUDGET, device=dev)
    wall = time.perf_counter() - t0
    u1, j1 = objectives(pl)
    if not opl.partitions:
        fail("beam_plan planned nothing")
    if not j1 < j0:
        fail(f"beam_plan: the combined objective {j1} is not below {j0}")
    c = counters("beam.")
    per_step = 1e3 * c.get("beam.search_seconds", 0.0) / max(
        1, c.get("beam.depth_steps", 0))
    log(f"beam: beam_plan width 8 depth 4 siblings, budget {BEAM_BUDGET} "
        f"(config 4b plans 4096; cut for the time limit) on "
        f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: {len(opl)} moves, {wall} s wall, "
        f"objective {j0} -> {j1}, unbalance {u1}, colocations {c0} -> "
        f"{colocations(pl)}, {per_step} ms per depth step (host clock, "
        f"{json.dumps(c)})")


# phase 11: the sharded session. Phase 3's flags with -fused-shard; meshes
# that name the card 2 and 4 times; the scale tier with polish at the
# JAX package's largest sharded row (README.md, 160k x 250)
SHARD_FLAGS = ["-fused", "-fused-shard", "-fused-batch=100",
               f"-max-reassign={MAIN_REASSIGN}", "-min-unbalance=1e-7"]
SHARD_SCALE_SHAPE = (160000, 250)
SHARD_SCALE_S = 4


def counter(name):
    from kafkabalancer_tpu_torch import obs

    return obs.REGISTRY.counter_get(name)


def sharded_run(fn):
    """``fn()`` with the launch counts and counters zeroed just before:
    ``(result, wall s, K1 launches, sharded iterations, sharded session s,
    single-device session iterations)``; the wall ends with a device
    sync."""
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    obs.begin_invocation()
    sk.shard_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, sk.shard_score.launches,
            int(counter("shard.session_iterations")),
            counter("shard.session_seconds"),
            int(counter("solver.session_iterations")))


def capture_shard(pl, S, dev, **kw):
    """The scoring kernel's inputs at the first call of a sharded session
    on ``S`` shards of the card (shard 0's rows, or its first row chunk),
    cloned at the call."""
    import torch

    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.shard_session import plan_sharded

    seen = []

    def capture(*args, **k):
        if not seen:
            seen.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return sk.shard_score(*args, **k)

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    plan_sharded(pl, cfg, 1, make_mesh(devices=[dev] * S, shape=(1, S)),
                 batch=100, scorer=capture, **kw)
    return seen[0]


def phase_sharded(dev, path, xla_plan):
    """Phase 11: the sharded converge session on the card. Returns K1's
    launches per path and its times at the shard shapes."""
    import torch

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.shard_session import (
        _resolve_row_chunk,
        plan_sharded,
    )
    from kafkabalancer_tpu_torch.ops.runtime import scale_bucket
    from kafkabalancer_tpu_torch.solvers.scan import plan
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    with open(path) as fh:
        text = fh.read()
    launches = {}

    def report(key, label, res, S, chunks=1):
        _out, wall, k1, iters, secs, tail = res
        if iters <= 0 or k1 != S * chunks * iters + tail:
            fail(f"{label}: shard_score launches {k1} != {S} shards x "
                 f"{chunks} chunks x {iters} iterations + {tail} tail "
                 f"iterations")
        log(f"{key}, {label}: {wall} s wall, {iters} sharded iterations "
            f"({secs} s, {1e3 * secs / iters} ms per iteration), "
            f"{S} shards x {chunks} row chunks, shard_score launches {k1}"
            + (f" ({tail} in the polish tail's move phases)" if tail else ""))
        launches[key] = k1

    # 11a: the CLI, one shard per visible card
    res = sharded_run(lambda: run_cli(["-input-json", "-input", path]
                                      + SHARD_FLAGS))
    rc, out, err, _wall = res[0]
    if rc != 0:
        fail(f"cli.run -fused-shard returned {rc}: {err[-2000:]}")
    if out != xla_plan:
        fail("cli.run -fused -fused-shard: the plan differs from phase 3's")
    report("11: cli.run -fused -fused-shard",
           f"{' '.join(SHARD_FLAGS)} (equals phase 3's plan)", res,
           torch.cuda.device_count())

    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7

    def sharded(S, **kw):
        mesh = make_mesh(devices=[dev] * S, shape=(1, S))
        return plan_text(plan_sharded(
            get_partition_list_from_reader(text, True), cfg, MAIN_REASSIGN,
            mesh, batch=100, **kw))

    # 11b: meshes naming the card 2 and 4 times; 11c: K1's plain version
    for S in (2, 4):
        res = sharded_run(lambda: sharded(S))
        if res[0] != xla_plan:
            fail(f"plan_sharded S={S}: the plan differs from phase 3's")
        report(f"11: plan_sharded S={S}", f"batch=100 on {MAIN_SHAPE[0]}x"
               f"{MAIN_SHAPE[1]} (equals phase 3's plan)", res, S)
    if sharded(2, scorer=sk.shard_score_plain) != xla_plan:
        fail("plan_sharded S=2 with shard_score_plain: the plan differs")
    log("11: plan_sharded S=2 with shard_score_plain: the identical plan")
    times = {"10k x 100, one of 4 shards": check_k1(capture_shard(
        get_partition_list_from_reader(text, True), 4, dev),
        "10k x 100, one of 4 shards")}

    # 11d: the scale tier with polish, 160k x 250 on 4 shards
    n_parts, n_brokers = SHARD_SCALE_SHAPE
    S = SHARD_SCALE_S
    scfg = default_rebalance_config()
    scfg.min_unbalance = 1e-7
    scfg.allow_leader_rebalancing = True

    def cluster():
        return synth_cluster(n_parts, n_brokers, rf=3, seed=SEED + 2,
                             weighted=True)

    def scale_run(S_, scale=True):
        pl = cluster()
        opl = plan_sharded(pl, scfg, MAIN_REASSIGN,
                           make_mesh(devices=[dev] * S_, shape=(1, S_)),
                           batch=128, scale=scale, polish=True)
        return plan_text(opl), unbalance_of(pl), len(opl)

    P_l = scale_bucket(n_parts, 8 * S) // S
    rc = _resolve_row_chunk(None, P_l)
    label = f"{n_parts} x {n_brokers}, one {rc}-row chunk of 4 shards"
    times[label] = check_k1(capture_shard(cluster(), S, dev, scale=True), label)
    chunks = -(-P_l // rc) if rc else 1
    res = sharded_run(lambda: scale_run(S))
    text4, u4, n4 = res[0]
    pol = counters("polish.")
    report(f"11: plan_sharded scale=True polish=True S={S}",
           f"batch=128 -allow-leader on {n_parts}x{n_brokers} (P/S = {P_l}, "
           f"row chunk {rc}): {n4} moves, unbalance {u4}, polish tail "
           f"{json.dumps(pol)}", res, S, chunks)
    single = sharded_run(lambda: (lambda pl: (plan_text(plan(
        pl, scfg, MAIN_REASSIGN, batch=128, polish=True, device=dev)),
        unbalance_of(pl)))(cluster()))
    text1, u1 = single[0]
    if text1 != text4:
        fail(f"plan_sharded scale=True polish=True S={S}: the plan differs "
             f"from scan.plan(polish=True)'s (unbalance {u4} against {u1})")
    log(f"11: scan.plan(polish=True) batch=128 on {n_parts}x{n_brokers}: "
        f"{single[1]} s wall, {single[5]} session iterations, the identical "
        f"plan")
    return launches, times


# phase 12: the what-if sweep of the JAX package's suite (config 5's six
# scenarios, benchmarks/suite.py) on phase 3's cluster
SWEEP_BUDGET = 2000
SWEEP_BATCH = 100


def phase_sweep(dev, path):
    """Phase 12: ``sweep`` with engine pallas (one B2 launch per scenario)
    against pallas-interpret, and engine xla (K1 per batched iteration)
    against the plain scorer, on the card. Returns the launches per
    engine."""
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
    from kafkabalancer_tpu_torch.parallel.sweep import best_scenario, sweep
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    with open(path) as fh:
        pl = get_partition_list_from_reader(fh.read(), True)
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    hi = max(observed)
    scenarios = [observed, observed + [hi + 1], observed + [hi + 1, hi + 2],
                 observed + [hi + 1, hi + 2, hi + 3, hi + 4], observed[1:],
                 observed[2:]]
    names = ["status quo", "+1", "+2", "+4", "-1", "-2"]
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    mesh = make_mesh(devices=[dev])

    def run(engine, **kw):
        obs.begin_invocation()
        sk.shard_score.launches = 0
        ps.pallas_session.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(pl, cfg, scenarios, max_reassign=SWEEP_BUDGET, mesh=mesh,
                    batch=SWEEP_BATCH, engine=engine, **kw)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, sk.shard_score.launches,
                ps.pallas_session.launches,
                int(counter("solver.session_iterations")))

    def rows(res):
        return [(r.feasible, r.completed, r.n_evacuations, r.n_moves,
                 r.unbalance, r.replicas) for r in res]

    launches = {}
    for engine, plain, kw in (("pallas", "pallas-interpret", {}),
                              ("xla", "xla", {"scorer": sk.shard_score_plain})):
        res, wall, k1, b2, iters = run(engine)
        evac_s = counter("sweep.evacuation_seconds")
        feasible = sum(r.feasible for r in res)
        if engine == "pallas" and b2 != len(scenarios):
            fail(f"sweep engine=pallas: {b2} pallas_session launches for "
                 f"{len(scenarios)} scenarios")
        if engine == "xla" and k1 != iters:
            fail(f"sweep engine=xla: {k1} shard_score launches for {iters} "
                 f"session iterations")
        ref = run(plain, **kw)[0]
        if rows(ref) != rows(res):
            fail(f"sweep engine={engine}: the results differ from "
                 f"engine={plain} {kw or ''}")
        best = best_scenario(res)
        for name, r in zip(names, res):
            log(f"12: sweep engine={engine} {name} ({len(r.brokers)} "
                f"brokers): feasible {r.feasible}, completed {r.completed}, "
                f"{r.n_evacuations} evacuations, {r.n_moves} moves, "
                f"unbalance {r.unbalance}")
        log(f"12: sweep engine={engine} batch={SWEEP_BATCH} max_reassign="
            f"{SWEEP_BUDGET}, {len(scenarios)} scenarios on {MAIN_SHAPE[0]}x"
            f"{MAIN_SHAPE[1]}: {wall} s wall, {feasible} feasible, best "
            f"{names[best]}, pallas_session launches {b2}, shard_score "
            f"launches {k1} ({iters} session iterations), {evac_s} s in "
            f"{int(counter('sweep.evacuations'))} evacuations; equal to "
            f"engine={plain} {list(kw) or ''}")
        launches[engine] = (k1, b2)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
        f"nvidia-smi: {smi.stderr.strip()}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from kafkabalancer_tpu_torch.ops import nvcc

    # phase 1: build every kernel from the checkout's sources, in parallel
    start = time.perf_counter()

    def done(phase):
        log(f"phase {phase} done at {time.perf_counter() - start} s")

    t0 = time.perf_counter()
    libs = nvcc.build(KERNEL_SOURCES, verbose=True)
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0} s")
    for name, lib in zip(KERNEL_SOURCES, libs):
        log(f"build: {name} -> {lib} in {nvcc.build_seconds.get(name)} s")
        for line in nvcc.build_logs.get(name, "").strip().splitlines():
            log(f"  nvcc {name}: {line}")

    done(1)
    record_avgs()
    # phase 2: the scoring kernel against its plain version
    main_t = check_k1(capture_inputs(*MAIN_SHAPE, dev), "10k x 100")
    check_k1(capture_inputs(*SCALE_SHAPE, dev), "131072 x 256")
    check_k1(capture_inputs(*MAIN_SHAPE, dev, weighted=False),
             "10k x 100 unweighted", timed=False)
    check_k1(capture_inputs(*SCALE_SHAPE, dev, weighted=False),
             "131072 x 256 unweighted", timed=False)

    # phase 2b: the whole-session kernel against its plain version
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    b2_t = check_b2(*capture_session(*MAIN_SHAPE, MAIN_REASSIGN, SEED, dev),
                    "10k x 100", 100, flush_buf.zero_)
    b2_scale = check_b2(*capture_session(*SCALE_SHAPE, SCALE_MOVES, SEED + 1,
                                         dev), "131072 x 256", 128,
                        flush_buf.zero_)
    del flush_buf
    check_b2_ties(dev)
    done("2/2b")

    # phase 3: the main path, counts zeroed just before and read just after
    launches, xla_plan, cluster_path, u_move = phase_main_path(dev)
    # phase 3b: the whole-session kernel's path, the same
    b2_launches = phase_pallas_path(dev, xla_plan, cluster_path)
    done("3/3b")

    # phases 6-8: the headline configuration (polish), the fused leader
    # session and -solver=tpu, each path's counts zeroed just before it
    headline = phase_headline(dev, cluster_path, u_move)
    done(6)
    phase_leader(dev, cluster_path)
    done(7)
    phase_solver_tpu(dev, cluster_path)
    done(8)

    # phases 9-10: the colocation session (K1's colocation variant) and
    # beam on config 4b's cluster, each path's counts zeroed just before it
    colo_launches, k1_colo, colo_path = phase_colocation(dev)
    done(9)
    phase_beam(dev, colo_path)
    done(10)

    # phases 11-12: the sharded session and the what-if sweep, each path's
    # counts zeroed just before it
    shard_launches, shard_times = phase_sharded(dev, cluster_path, xla_plan)
    done(11)
    sweep_launches = phase_sweep(dev, cluster_path)
    done(12)

    # phase 4: scale
    phase_scale(dev)
    phase_scale_pallas(dev)
    done(4)

    # phase 5: the division check
    phase_division(dev)
    done(5)

    print(json.dumps({"kernels": [{
        "name": "shard_score",
        "route": "cuda",
        "source": "kafkabalancer_tpu_torch/csrc/shard_score.cu",
        "replaces": "kafkabalancer_tpu/parallel/shard_kernel.py:74",
        "launches": launches,
        "launches_by_path": {
            "3: -fused -fused-batch=100": launches,
            "6: headline, torch session": headline["xla"][0],
            "6: headline, -fused-engine=pallas": headline["pallas"][0],
            "9: -fused -anti-colocation": colo_launches["session"],
            "9: -fused -anti-colocation -fused-polish": colo_launches["polish"],
            "9: -fused -anti-colocation -fused-engine=pallas (overridden)":
                colo_launches["pallas"],
            **shard_launches,
            "12: sweep engine=xla batch=100": sweep_launches["xla"][0],
        },
        "colocation_variant": k1_colo,
        "shard_shapes": shard_times,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "pallas_session",
        "route": "cuda",
        "source": "kafkabalancer_tpu_torch/csrc/pallas_session.cu",
        "replaces": "kafkabalancer_tpu/solvers/pallas_session.py:83",
        "launches": b2_launches,
        "launches_by_path": {
            "3b: -fused -fused-engine=pallas -fused-batch=100": b2_launches,
            "6: headline, -fused-engine=pallas": headline["pallas"][1],
            "12: sweep engine=pallas (one per scenario)":
                sweep_launches["pallas"][1],
        },
        "max_abs_err": b2_t["max_abs_err"],
        "ms": b2_t["ms"],
        "plain_ms": b2_t["plain_ms"],
        "bound_ms": b2_t["bound_ms"],
        "bound_by": b2_t["bound_by"],
        "library_ms": None,
        "split": {"10k x 100": b2_t["split"],
                  "131072 x 256": b2_scale["split"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
