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
   and 100 (128 at scale); the batch-1 variants stop after
   ``B2_BATCH1_BUDGET`` moves. Tolerance: zero — all seven outputs equal
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

13. The planning daemon on the card (``serve/``), on phase 3's cluster:
   a. the daemon (a lane per card; its requests come one at a time, so
   each runs solo) in a thread of this process on a private socket;
   its warm seconds (the kernel libraries are already loaded in this
   process), and the seconds a fresh ``python -m kafkabalancer_tpu_torch
   -serve`` process takes to warm (torch import, CUDA context, kernel
   load from the build cache). b/c. phase 3's and 3b's flags from a
   fresh client process: the plans of phases 3 and 3b byte for byte,
   with phase 3's K1 launches and one B2 launch added by the served
   requests. d. the same two as fresh ``-no-daemon`` processes, wall
   against the served client's wall. e. four fresh clients at once, each
   on another seeded 10k x 100 cluster, against a second daemon with
   ``-serve``'s defaults (``-serve-microbatch=4``): each plan equal to
   that cluster's in-process plan on the card; the fused rounds read
   from its stats doc (``microbatched`` equal to the occupancy
   histogram's members, no padded slot, batched launches exactly when a
   round fused), and the solo plus batched K1 launches between the
   longest in-process run's and the four runs' sum; each client's wall.
   f. five rounds of the
   reference's deployment loop (``-solver=tpu -max-reassign=1
   -min-unbalance=1e-7``, the move
   applied to the file, again) served from a resident session, each move
   equal to the in-process move on the same file; session hits, row
   splices and the served wall per round. g. a served client imports
   neither torch nor numpy. h. the shutdown op ends each daemon thread
   with 0; each daemon's request count equals the requests sent to it,
   its own fallback count holds only the session ladder's expected
   re-syncs, and every fresh client reports ``cli.served`` 1 and no
   in-process fallback. Every fresh client runs ``python -m kafkabalancer_tpu_torch``
   (through ``runpy``, with an exit hook that prints its counters).
   Phase 13's daemons run without speculation and its clients with
   ``-no-edge-cache``, as when the phase was added.

14. The rest of the daemon with ``-serve``'s defaults (speculative
   plan-ahead on, the client edge cache on), on phase 3's cluster:
   a. the deployment loop ``-fused -fused-batch=100 -max-reassign=1
   -min-unbalance=1e-7``, 5 rounds of fresh client processes; an applier
   writes each emitted move into the file and waits on the stats doc for
   a speculative memo; every round's stdout equals ``-no-daemon`` in
   process, rounds 2-5 are memo hits, the speculation identity
   (attempts == hits + misses + poisoned + memos) holds at every scrape;
   per round the client wall and the edge rung; the speculative runs'
   K1 launches (the daemon's per-thread launch tally) must be > 0.
   b. the same loop with ``-fused-engine=pallas``: B2 launches by the
   speculative runs > 0. c. phase 13f's ``-solver=tpu`` loop (5 rounds)
   with the defaults, beside 13f's walls. d. a real request for another
   tenant arriving during a speculative re-plan of the second half of
   phase 3's plan, once in the run's host head and once in its chunk's
   session (the run is held at that point until the daemon's admission
   hook has seen the request, so no wall-clock timing decides where it
   lands): its answer equals in process, the speculative run is
   aborted; its queue wait printed. e. a ``-serve
   -serve-session-spill-dir`` process serves one request and is
   SIGKILLed; a new process on the same directory answers the next move
   byte-identically from the restored record (restore_hits 1, no
   re-register); the times printed. f. ``-watch`` over a
   ``$KAFKABALANCER_TPU_FAKE_ZK`` tree of the cluster: the first plan and
   three more after three applied mutations, each equal to ``-no-daemon
   -from-zk`` on the tree; watch lag and the watch and speculative runs'
   K1 launches (> 0) printed.

15. Every reference flag on the card, on phase 3's cluster: a/b. phase
   3's and 3b's flags through ``cli.run`` with ``-stats -metrics-json
   -trace -explain -jax-profile``: the plan bytes of phases 3 and 3b, the
   metrics line's schema, ``plan.stop_reason`` and move count, the
   explain document's ``moves_emitted``, the lifecycle spans of the
   trace; in the ``torch.profiler`` trace the kernel events of K1
   (``score_blocks``) or B2 (``session_kernel``) inside the ``plan``
   window must number the run's launches, and the device's idle share
   of the window (1 - the union of kernel, copy and fill intervals over
   the window) and the walls with and without the flags are printed. c.
   two fresh ``-no-daemon`` processes with ``-trace``, one with the warm
   thread and one without it (the warm daemon's latch set first): their
   walls, and the first one's span breakdown (the warm thread's torch
   import and CUDA context on its own track; parse, settle, encode,
   session, emit) beside 13d's walls. d. ``python -m kafkabalancer_tpu_torch.prewarm -shapes
   10000x100 -verify``, then a ``-serve -serve-prewarm=10000x100``
   process: its warm seconds and its first request (14e's) against in
   process, beside 14e's. e. ``-serve-stats`` and ``-metrics-prom=-``
   against it: the text parses and its request counter equals the
   requests sent. f. in a process of its own with ``nvcc.BUILD_DIR`` on
   a copy of the cache, ``shard_score``'s library truncated: one rebuild
   and phase 3's plan.

16. The fleet-churn replay harness (``replay/``) on the card, each mode
   against private ``python -m kafkabalancer_tpu_torch -serve`` daemons
   it spawns, ``-solver=tpu`` in the daemons and in this process's
   ``-no-daemon`` oracles, 4 tenants (base 2000 partitions, 50 brokers,
   3 replicas, ``-max-reassign=2``): a. churn, 40 requests with topic
   storms every 11 and broker failures every 13 (per-tenant daemon and
   client p50/p95); b. ``--chaos``, 24 requests (the seeded lane crash
   must fire and no lane stay quarantined); c. ``--restart``, 24 requests
   (SIGKILL at half); d. ``--watch`` at its defaults. Each artifact must
   reconcile with no request error and parity on every checked plan;
   each mode's wall.
17. Two processes on the one card (this script with ``--dist-worker``),
   each naming cuda:0 twice, joined by ``parallel.distributed`` (gloo):
   ``sharded_score_moves`` on a 1 x 4 mesh whose part axis spans both
   (equal to the unsharded scorer), ``plan_sharded`` batch 100 on phase
   3's cluster (phase 11's S = 4 plan on both ranks) and with polish,
   and a four-scenario sweep on a 2 x 2 mesh whose sweep axis spans
   both; each equal on both ranks and to this process's one-process run
   on the same mesh shapes. K1's launches per rank must be 2 shards x
   sharded iterations (+ the polish tail's iterations).
18. The port's static analyzer and its runtime twin. a. ``python -m
   kafkabalancer_tpu_torch.analysis kafkabalancer_tpu_torch/
   chip_smoke.py``, ``--contracts`` and ``--annotations`` over the typed
   subpackages, each a process of its own from the checkout: any finding
   or a non-zero exit fails the run; prints the findings per rule, the
   suppressions per rule and the device-loop functions. b. phase 3's
   ``-fused -fused-batch=100`` session and phase 3b's whole-session
   launch again through ``cli.run``, under
   ``torch.cuda.set_sync_debug_mode("warn")``: every synchronisation the
   card reports is attributed to the innermost line of the checkout on
   the Python stack; prints the syncs per session iteration and the
   count per ``file:line``. A sync from a line of device-loop code (the
   analyzer's marking) that carries no R1/R3/R5 suppression fails the
   run, and so does a plan that differs from phase 3's or 3b's.

19. Cross-request fusion, on phase 13e's four clusters: a. the batched
   scoring kernel (``shard_score_batched``, one launch for K instances)
   at K = 1, 2, 4 on each cluster's first-iteration inputs: each
   instance equal to a solo ``shard_score`` launch and to the plain
   version (zero tolerance), its device time (L2 flushed) against K solo
   launches and the bound (K instances' bytes). b. ``scan.session_batched``
   over the four instances against four solo ``scan.session`` calls:
   every packed move log byte-equal, each instance's iterations its solo
   session's, batched launches equal to the longest's iterations, and
   under the sync monitor exactly one sync per iteration from
   device-loop lines (the designed read); walls. c. a daemon with
   ``-serve-microbatch=4 -serve-admission-hold=4``, in ``continuous``
   and in ``oneshot`` mode, four fresh clients at once: every plan equal
   to 13e's in-process plan, the stats doc's ``microbatched`` 4 and
   ``mb_occupancy`` ``{"4": 1}`` (one fused round of the one chunk),
   ``mb_padded_slots`` 0, no solo K1 launch and the batched launches at
   most the longest member's in-process count; the client walls beside
   13e's.
20. The shared residency pool and the lane's stage-ahead pipeline, on
   13e's clusters and a daemon with -serve's defaults (one lane): a.
   cluster 1, then clusters 2 and 3 started once cluster 1 launches K1
   (the lane holds its turn after cluster 1 until both are queued and
   the one staged at submit has finished staging, so the hit check
   does not race the stage thread): every plan equal to 13e's, staged
   requests and arrays > 0, and every lookup of a staged array a hit;
   the staged copies' device time (events on the copy stream), their
   bytes and, from a CUDA-activity profile of the step, how much of the
   copy stream's time overlapped the lane stream's kernels; the client
   walls beside 13e's. b. cluster 1's input twice: the second request
   hits every array the first looked up. c. the stats doc's
   ``residency`` block, the memory block's ``residency_bytes`` (equal
   to the sum over the pooled tensors) and ``residency_entries`` (at
   most 64), and the request line's ``serve.residency_hits`` /
   ``serve.residency_bytes``. e. a ``-fused-engine=pallas`` request
   through the same lane: 13c's plan. d. every pooled tensor's md5
   still its key's.
21. The kinds the daemon fuses besides the plain move session: a. K1's
   colocation variant batched (``shard_score_batched`` with counts
   rows) at K = 1, 2, 4 on the first-pass arguments of four config-4b
   clusters (seeds ``COLO_SEED`` .. +3): each instance equal to a solo
   launch and to the plain version bit for bit, allow_leader off and
   on; its device time (L2 flushed) against K solo launches and the
   bound. b. ``scan.session_batched`` in colocation mode over those four
   clusters and at batch 1 over 13e's four (at most ``B1_CAP`` moves
   each), and ``polish.converge_session_batched`` with the headline
   flags over 13e's four: every packed log byte-equal to its solo
   session's, each polish member's phase counts its solo run's; the
   batched K1 launches against the solo sum; the syncs per iteration
   under the sync monitor (one per iteration for the move sessions; no
   sync from an unsuppressed device-loop line). c. a daemon with
   ``-serve-microbatch=4 -serve-admission-hold=4`` in ``continuous``
   and in ``oneshot`` mode: four headline clients at once, then four
   colocation clients: every plan equal to its ``-no-daemon`` plan,
   ``microbatched`` and ``mb_occupancy`` per kind those of rounds of the
   members' chunks (one round of 4 for one chunk each), no padded
   slot; the client walls beside the four in-process runs'.

Each path's launch counts are set to 0 just before it runs and read just
after (phase 14 reads the daemon's tally of its internal runs). Phases
6-21 run after 3b and before 4. The last two stdout lines are the kernels JSON line and
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
ROOT = os.path.dirname(os.path.abspath(__file__))
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


def cuda_ms(fn, reps, flush, warmup=2):
    """``(device ms, host ms)`` of one call of ``fn()``, medians over
    ``reps`` runs after ``warmup`` warm-up calls.

    Device: a CUDA event pair around one call with a cold L2 (``flush()``
    first). A spin kernel queued before the first event keeps the card
    busy while the host checks the arguments, allocates and launches, so
    the events hold the call's device work and not its host cost. Host:
    the host clock around the same call, which returns once its work is
    queued."""
    import torch

    for _ in range(warmup):
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

    from kafkabalancer_tpu_torch.models.config import kernel_dtype

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
        ).to(kernel_dtype())
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


# phase 2b's batch-1 variants run at most this many moves: the plain
# version commits one move per torch iteration, and at the whole chunk's
# budget the eight batch-1 checks took ~266 s of the script
B2_BATCH1_BUDGET = 400


def b2_variant(args, kw, allow_leader, restricted, batch):
    import torch

    a, k = list(args), dict(kw)
    a[14] = batch
    if batch == 1:
        a[13] = min(int(a[13]), B2_BATCH1_BUDGET)
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
    med_it = float(per_it.median())
    shares = {}
    for i, name in enumerate(ps.STAMP_PHASES):
        col = d[:, i]
        shares[name] = int(col.sum()) / total
        log(f"  split {label} {name}: {100 * shares[name]:.2f} % of the cycles, "
            f"median {float(col.median())} cycles, sum {int(col.sum())} "
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
    # no warm-up: the check above just ran this very call (seconds each)
    plain_ms, _ = cuda_ms(lambda: ps.pallas_session_plain(*a, **k), 1, flush,
                          warmup=0)
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

    f32 = np.float32  # jaxlint: disable=R4 — the kernel's float32 bit patterns
    exps = np.arange(-41, 42)
    pow2 = np.ldexp(f32(1), exps).astype(f32)
    ones = ((exps + 127).astype(np.uint32) << 23 | 0x7FFFFF).view(f32)
    edge = np.array([np.nextafter(f32(2.0**-40), f32(0)),
                     np.nextafter(f32(2.0**40), f32(np.inf))], f32)
    rng = np.random.default_rng(SEED)
    logu = (10.0 ** rng.uniform(-3, 9, 200)).astype(f32)
    return np.concatenate([pow2, ones, edge, logu])


def phase_division(dev):
    """Phase 5: the reciprocal division against the IEEE division for every
    finite float32 x at every avg met and at the sweep."""
    import torch

    from kafkabalancer_tpu_torch.models.config import kernel_dtype
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    met = torch.unique(torch.cat([a.to(dev, kernel_dtype()) for a in AVGS]))
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
    return launches, out.getvalue()


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
    from kafkabalancer_tpu_torch.models.config import kernel_dtype
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
                       batch=1, dtype=kernel_dtype(), device="cpu")
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
    from kafkabalancer_tpu_torch.models.config import kernel_dtype
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device

    pl = get_partition_list_from_reader(text, True)
    cfg = default_rebalance_config()
    steps.validate_weights(pl, cfg)
    steps.fill_defaults(pl, cfg)
    dp = tensorize(pl, cfg)
    loads = []
    for d in (dev, "cpu"):
        a = to_device(dp, d, kernel_dtype())
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


# phases 13-14: a fresh client process runs the package's entry point as
# ``python -m kafkabalancer_tpu_torch`` does (runpy), and an exit hook
# prints one line on stderr: its serve counters (``cli.served``, the
# ``serve.fallbacks.*`` reasons), the heavy modules it imported and the
# edge-cache rung that answered (stat_hit, content_hit, splice or miss;
# none with -no-edge-cache)
CLIENT = (
    "import atexit, json, runpy, sys\n"
    "from kafkabalancer_tpu_torch.serve import edge_cache as ec\n"
    "rung = []\n"
    "probe_file, resolve_text = ec.probe_file, ec.resolve_text\n"
    "def probe(*a, **kw):\n"
    "    p = probe_file(*a, **kw)\n"
    "    rung.append('stat_hit' if not p.needs_text else 'miss')\n"
    "    return p\n"
    "def resolve(p, text):\n"
    "    state, hit = resolve_text(p, text)\n"
    "    if state is not None:\n"
    "        rung[-1] = 'content_hit' if hit else 'splice'\n"
    "    return state, hit\n"
    "ec.probe_file, ec.resolve_text = probe, resolve\n"
    "def report():\n"
    "    heavy = sorted({m.split('.')[0] for m in sys.modules}\n"
    "                   & {'torch', 'numpy', 'jax'})\n"
    "    from kafkabalancer_tpu_torch import obs\n"
    "    snap = obs.REGISTRY.snapshot().get('counters', {})\n"
    "    c = {k: v for k, v in snap.items()\n"
    "         if k == 'cli.served' or k.startswith('serve.fallbacks.')}\n"
    "    print('CLIENT ' + json.dumps({'counters': c, 'heavy': heavy,\n"
    "                                  'rung': rung}),\n"
    "          file=sys.stderr, flush=True)\n"
    "atexit.register(report)\n"
    "sys.argv = ['kafkabalancer_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('kafkabalancer_tpu_torch', run_name='__main__',\n"
    "                 alter_sys=True)\n"
)
# the client's fallback reasons that end in planning in process; the
# session ladder's re-sync notes (session_resync_full,
# session_digest_mismatch) are counted on the way to a served answer
LOCAL_FALLBACKS = ("daemon_down", "handshake_mismatch", "frame_cap",
                   "declined", "transport_error", "daemon_wedged", "overload")
CARD = ""
# walls of fresh processes and first requests (13d, 14e), printed beside
# phase 15's
FRESH_WALLS = {}


def start_client(args, served=True):
    """A fresh client process; ``served`` runs it through :data:`CLIENT`."""
    cmd = ([sys.executable, "-c", CLIENT] if served
           else [sys.executable, "-m", "kafkabalancer_tpu_torch"]) + args
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_client(proc, t0, what, timeout=300):
    """Wait for a client started at ``t0``: ``(rc, stdout, stderr, wall s,
    client report or None)``; a client that served must report
    ``cli.served`` 1, no in-process fallback and no torch/numpy import."""
    out, err = proc.communicate(timeout=timeout)
    wall = time.perf_counter() - t0
    report = None
    for line in err.splitlines():
        if line.startswith("CLIENT "):
            report = json.loads(line[len("CLIENT "):])
    if proc.returncode != 0:
        fail(f"{what}: client exited {proc.returncode}: {err[-2000:]}")
    if report is not None:
        c = report["counters"]
        if c.get("cli.served") != 1 or any(
            c.get(f"serve.fallbacks.{r}") for r in LOCAL_FALLBACKS
        ):
            fail(f"{what}: the request was not served: {c}")
        if report["heavy"]:
            fail(f"{what}: the client imported {report['heavy']}")
    return proc.returncode, out, err, wall, report


def finish_clients(procs, t0, what):
    """:func:`finish_client` for clients running at once: each waited on
    by a thread of its own, so each wall ends when that client exits and
    not when the waits before it in the list have returned."""
    import threading

    results = [None] * len(procs)

    def wait(k):
        try:
            results[k] = finish_client(procs[k], t0, f"{what} {k}")
        except SystemExit as exc:
            results[k] = exc

    threads = [threading.Thread(target=wait, args=(k,))
               for k in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in results:
        if isinstance(res, SystemExit):
            raise res
    return results


def run_client(args, what, served=True):
    t0 = time.perf_counter()
    return finish_client(start_client(args, served), t0, what)


def serving_daemon(sock, **kw):
    """The port's daemon on ``sock`` in a thread of this process (CUDA
    lanes, -serve's defaults); returns ``(daemon, thread, rc_box, logs)``
    once it answers hello."""
    import threading

    from kafkabalancer_tpu_torch.serve import client
    from kafkabalancer_tpu_torch.serve.daemon import Daemon

    logs = []
    kw.setdefault("lanes", 0)
    d = Daemon(sock, log=logs.append, idle_timeout=0, **kw)
    rc_box = []
    t = threading.Thread(target=lambda: rc_box.append(d.serve_forever()),
                         name="smoke-daemon", daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while client.daemon_alive(sock) is None:
        if time.monotonic() > deadline or not t.is_alive():
            fail(f"the daemon on {sock} never answered: {logs}")
        time.sleep(0.05)
    return d, t, rc_box, logs


def stop_daemon(sock, d, t, rc_box, logs, sent, fallbacks, what):
    """Phase 13h for one daemon: the shutdown op, the thread's 0, the
    request count against the requests sent, and the daemon's own
    fallback reasons against ``fallbacks``, the session ladder's
    expected re-syncs."""
    from kafkabalancer_tpu_torch.serve import client

    if not client.request_shutdown(sock):
        fail(f"{what}: the shutdown op was not acknowledged")
    t.join(120)
    if t.is_alive() or rc_box != [0]:
        fail(f"{what}: the daemon thread did not exit with 0: {rc_box} {logs}")
    if d._requests != sent:
        fail(f"{what}: the daemon served {d._requests} requests, {sent} sent")
    if d._fallbacks != fallbacks:
        fail(f"{what}: the daemon counted fallbacks {d._fallbacks}, "
             f"expected {fallbacks}")
    log(f"serve {what}: shut down with 0 after {d._requests} requests "
        f"({sent} sent), daemon-side fallbacks {d._fallbacks}")


def phase_serve(path, xla_plan, k1_main, pallas_plan, b2_main):
    """Phase 13: the planning daemon on the card (see the module
    docstring); returns the served paths' launch counts."""
    import shutil
    import tempfile

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.serve import client
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    t_phase = time.perf_counter()
    sock_dir = tempfile.mkdtemp(prefix="kbt-")
    try:
        sock = os.path.join(sock_dir, "a.sock")
        # 13a: a fresh -serve process warms (build cache on disk from
        # phase 1), then the daemon of this process
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
             f"-serve-socket={os.path.join(sock_dir, 'fresh.sock')}",
             "-serve-idle-timeout=300", "-serve-speculate-off"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        fresh_sock = os.path.join(sock_dir, "fresh.sock")
        while True:
            hello = client.daemon_alive(fresh_sock)
            if hello is not None and not hello.get("warming"):
                break
            if proc.poll() is not None or time.perf_counter() - t0 > 240:
                proc.kill()
                fail(f"the -serve process never warmed: "
                     f"{proc.communicate()[1][-2000:]}")
            time.sleep(0.05)
        fresh_warm = time.perf_counter() - t0
        client.request_shutdown(fresh_sock)
        _out, err = proc.communicate(timeout=120)
        if proc.returncode != 0 or "serve: warm in" not in err:
            fail(f"the -serve process exited {proc.returncode}: {err[-2000:]}")
        warm_line = [x for x in err.splitlines() if "serve: warm in" in x][-1]
        log(f"serve 13a [{CARD}]: a fresh -serve process answered warm after "
            f"{fresh_warm} s from its start ({warm_line.split('serve: ')[-1]})")

        d, t, rc_box, logs = serving_daemon(sock)
        if not d._warm_done.wait(240):
            fail("the in-process daemon never finished its warm body")
        log(f"serve 13a [{CARD}]: in-process daemon warm body "
            f"{d.warm_seconds} s (kernel libraries already loaded by phase 1); "
            f"{[m for m in logs if 'lane' in m]}")

        # phase 13's clients run without the edge cache (and its daemons
        # without speculation, the Daemon default), so its numbers and its
        # exact fallback counts stay those of the phase as it was added
        fused_args = ["-input-json", "-input", path, "-fused",
                      "-fused-batch=100", f"-max-reassign={MAIN_REASSIGN}",
                      "-min-unbalance=1e-7", "-no-edge-cache"]
        pallas_args = fused_args + ["-fused-engine=pallas"]
        sent = 0
        # 13b/13c: served from fresh client processes, each path's counts
        # zeroed just before it
        walls = {}
        counts = {}
        for key, args, want, counter, want_n in (
            ("fused", fused_args, xla_plan, sk.shard_score, k1_main),
            ("pallas", pallas_args, pallas_plan, ps.pallas_session, b2_main),
        ):
            counter.launches = 0
            rc, out, _err, wall, _rep = run_client(
                args + [f"-serve-socket={sock}"], f"served {key}")
            sent += 1
            counts[key] = counter.launches
            if out != want:
                fail(f"served {key}: the plan differs from the in-process one")
            if counts[key] != want_n:
                fail(f"served {key}: {counts[key]} {counter.__name__} "
                     f"launches, the in-process path had {want_n}")
            walls[key] = wall
            log(f"serve 13{'b' if key == 'fused' else 'c'} [{CARD}]: served "
                f"{key} plan equals phase {'3' if key == 'fused' else '3b'}'s, "
                f"{counts[key]} {counter.__name__} launches, client wall "
                f"{wall} s")
        # 13d: the same two as fresh -no-daemon processes
        for key, args, want in (("fused", fused_args, xla_plan),
                                ("pallas", pallas_args, pallas_plan)):
            rc, out, _err, wall, _rep = run_client(
                args + ["-no-daemon"], f"fresh {key}", served=False)
            if out != want:
                fail(f"fresh -no-daemon {key}: the plan differs")
            FRESH_WALLS[f"13d {key}"] = wall
            log(f"serve 13d [{CARD}]: {key}: fresh -no-daemon process "
                f"{wall} s, served client process {walls[key]} s")

        # 13f: the deployment loop, five rounds on a copy of the cluster
        loop_path = os.path.join("chiprun_out", "smoke_loop_cluster.json")
        shutil.copyfile(path, loop_path)
        loop_args = ["-input-json", "-input", loop_path, "-solver=tpu",
                     "-max-reassign=1", "-min-unbalance=1e-7"]
        loop_walls = []
        for rnd in range(5):
            rc, want, _e, _w = run_cli(loop_args + ["-no-daemon"])
            _rc, out, _err, wall, _rep = run_client(
                loop_args + [f"-serve-socket={sock}", "-no-edge-cache"],
                f"loop round {rnd}")
            loop_walls.append(wall)
            sent += 1
            if rc != 0 or out != want or not json.loads(out).get("partitions"):
                fail(f"loop round {rnd}: the served move differs from the "
                     f"in-process move (or none)")
            with open(loop_path) as fh:
                text = fh.read()
            pl = get_partition_list_from_reader(io.StringIO(text), True)
            moved = {(r["topic"], r["partition"]): r["replicas"]
                     for r in json.loads(out)["partitions"]}
            for p in pl.partitions:
                p.replicas = moved.get((p.topic, p.partition), p.replicas)
            with open(loop_path, "w") as fh:
                fh.write(plan_text(pl))
            ss = d.sessions.stats()
            cache = d._core_snapshot()["cache"]
            log(f"serve 13f [{CARD}]: round {rnd}: served move equals the "
                f"in-process move, client wall {wall} s; sessions registered "
                f"{ss['registered']}, delta hits {ss['delta_hits']}, row "
                f"resyncs {ss['resyncs_rows']}, tensorize rows reused "
                f"{cache['rows_reused']} (cache hits {cache['hits']})")
        if d.sessions.stats()["delta_hits"] != 4:
            fail("loop: rounds 2-5 were not served from the resident session")

        # 13g: the client path imports neither torch nor numpy (checked by
        # finish_client for every served client; this one says so)
        _rc, out, _err, wall, rep = run_client(
            fused_args + [f"-serve-socket={sock}"], "client path")
        sent += 1
        if out != xla_plan:
            fail("client path: the plan differs")
        log(f"serve 13g: a served client imported {rep['heavy'] or 'neither'} "
            f"torch nor numpy; its counters {rep['counters']}")
        # the session ladder on daemon A (sessions are keyed by the file
        # and the planning flags): 13b, 13c and 13f's first round each
        # find no session; 13g sends 13b's unchanged file again, whose
        # session has already applied the plan it served, so the digest
        # differs and the client re-sends the whole file (served all
        # the same)
        stop_daemon(sock, d, t, rc_box, logs, sent,
                    {"session_absent": 3, "session_digest_mismatch": 1},
                    "(daemon A)")

        # 13e: four clusters of the bucket, four clients at once; the
        # in-process runs' K1 launches counted one by one
        paths, wants, k1_solo = [], [], []
        for k in range(4):
            pk = os.path.join("chiprun_out", f"smoke_batch_{k}.json")
            with open(pk, "w") as fh:
                fh.write(plan_text(synth_cluster(*MAIN_SHAPE, rf=3,
                                                 seed=SEED + 10 + k)))
            sk.shard_score.launches = 0
            rc, want, _e, _w = run_cli(["-input-json", "-input", pk]
                                       + fused_args[3:-1] + ["-no-daemon"])
            k1_solo.append(sk.shard_score.launches)
            if rc != 0:
                fail(f"concurrent cluster {k}: in-process rc {rc}")
            paths.append(pk)
            wants.append(want)
        # daemon B with -serve's defaults (-serve-lanes=0
        # -serve-microbatch=4): the four requests may fuse, in whatever
        # rounds their arrival makes
        sock_b = os.path.join(sock_dir, "b.sock")
        d, t, rc_box, logs = serving_daemon(sock_b, microbatch=4)
        d._warm_done.wait(240)
        sk.shard_score.launches = 0
        sk.shard_score_batched.launches = 0
        t0 = time.perf_counter()
        procs = [start_client(["-input-json", "-input", pk] + fused_args[3:]
                              + [f"-serve-socket={sock_b}"]) for pk in paths]
        results = finish_clients(procs, t0, "concurrent client")
        all_wall = time.perf_counter() - t0
        solo_n = sk.shard_score.launches
        fused_n = sk.shard_score_batched.launches
        counts["concurrent"] = solo_n
        counts["concurrent_batched"] = fused_n
        st = client.fetch_stats(sock_b) or {}
        for k, res in enumerate(results):
            if res[1] != wants[k]:
                fail(f"concurrent client {k}: the served plan differs from "
                     f"the cluster's in-process plan")
        occ = {int(k): v for k, v in (st.get("mb_occupancy") or {}).items()}
        fused_members = sum(k * v for k, v in occ.items())
        if st.get("microbatched") != fused_members or fused_members > 4:
            fail(f"concurrent: stats microbatched {st.get('microbatched')} "
                 f"against the occupancy histogram {occ}")
        if (fused_members > 0) != (fused_n > 0) or st.get("mb_padded_slots"):
            fail(f"concurrent: {fused_members} fused members but "
                 f"{fused_n} batched launches (padded "
                 f"{st.get('mb_padded_slots')})")
        if not max(k1_solo) <= solo_n + fused_n <= sum(k1_solo):
            fail(f"concurrent: the four served requests launched shard_score "
                 f"{solo_n} and shard_score_batched {fused_n} times, the four "
                 f"in-process runs {k1_solo}")
        log(f"serve 13e [{CARD}]: four concurrent clients (-serve-microbatch"
            f"=4), each plan equal to its in-process plan; fused rounds by "
            f"occupancy {occ} ({fused_members} of 4 requests fused); "
            f"shard_score launches {solo_n} + shard_score_batched {fused_n} "
            f"against {' + '.join(str(n) for n in k1_solo)} in process; "
            f"client walls {[r[3] for r in results]} s (all four in {all_wall} "
            f"s)")
        stop_daemon(sock_b, d, t, rc_box, logs, 4, {"session_absent": 4},
                    "(daemon B)")
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    log(f"serve: phase 13 took {time.perf_counter() - t_phase} s")
    batch = dict(paths=paths, wants=wants, k1_solo=k1_solo,
                 walls=[r[3] for r in results], fused_args=fused_args[3:])
    return counts, loop_walls, batch


# phase 14: the rest of the planning daemon with -serve's defaults —
# speculative plan-ahead on (serve/speculate.py), the client edge cache on
# (serve/edge_cache.py) — plus the warm session tier (serve/spill.py) and
# -watch, on phase 3's cluster
# the script's time limit is fixed while phases are added: the loops keep
# four memo rounds after the first
SPEC_ROUNDS = 5
SPEC_FLAGS = ["-fused", "-fused-batch=100", "-max-reassign=1",
              "-min-unbalance=1e-7"]


def apply_plan(path, out):
    """The deployment loop's applier: the emitted moves written into the
    cluster file (the whole file rewritten)."""
    with open(path) as fh:
        text = fh.read()
    final, _rows = planned(text, out)
    with open(path, "w") as fh:
        fh.write(plan_text(final))


def spec_identity(st, what):
    if st["attempts"] != (st["hits"] + st["misses"] + st["poisoned"]
                          + st["memos"]):
        fail(f"{what}: the speculation identity broke: {st}")


def spec_settled(sock, d, what, attempts0, timeout=120):
    """Wait until the speculator of ``d`` has attached a memo past
    ``attempts0`` (its attempts before the request) and is out of flight,
    then return the stats doc; the speculation identity must hold at
    every read."""
    from kafkabalancer_tpu_torch.serve import client

    deadline = time.monotonic() + timeout
    while True:
        st = d.speculator.stats()
        spec_identity(st, what)
        if st["memos"] >= 1 and st["attempts"] > attempts0 and not (
            st["inflight"]
        ):
            break
        if time.monotonic() > deadline:
            fail(f"{what}: no speculative memo after {timeout} s: {st}")
        time.sleep(0.02)
    doc = client.fetch_stats(sock)
    spec_identity(doc["speculation"], what)
    return doc


# the in-process answers of a deployment loop, computed by a process of
# their own while the daemon of this process serves the same loop: each
# round ``cli.run -no-daemon`` on the file, then the applier
ORACLE_CHAIN = (
    "import io, json, sys\n"
    "import chip_smoke\n"
    "from kafkabalancer_tpu_torch import cli\n"
    "path, rounds = sys.argv[1], int(sys.argv[2])\n"
    "args = (['kafkabalancer', '-input-json', '-input', path]\n"
    "        + sys.argv[3:] + ['-no-daemon'])\n"
    "outs = []\n"
    "for _ in range(rounds):\n"
    "    out, err = io.StringIO(), io.StringIO()\n"
    "    rc = cli.run(io.StringIO(''), out, err, args)\n"
    "    outs.append([rc, out.getvalue()])\n"
    "    if rc != 0 or not json.loads(out.getvalue()).get('partitions'):\n"
    "        break\n"
    "    chip_smoke.apply_plan(path, out.getvalue())\n"
    "print(json.dumps(outs))\n"
)


def start_oracle_chain(path, flags, what, rounds):
    """Start the in-process answers of ``rounds`` loop rounds on a copy
    of ``path`` in a process of their own (:data:`ORACLE_CHAIN`)."""
    import shutil

    copy = os.path.join("chiprun_out", f"smoke_{what}_oracle.json")
    shutil.copyfile(path, copy)
    return subprocess.Popen(
        [sys.executable, "-c", ORACLE_CHAIN, copy, str(rounds)] + flags,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def spec_launches(d, kind="spec"):
    with d._lock:
        return dict(d.internal_launches.get(kind, {}))


def spec_loop(d, sock, path, flags, what, rounds, oracle):
    """A deployment loop through the speculating daemon ``d``: per round a
    fresh client process, the applier writes the move, and the next round
    starts once the speculator holds the next memo. Rounds past the first
    must be memo hits; every round's stdout must equal ``-no-daemon`` on
    the same file (``oracle``: :func:`start_oracle_chain`'s process).
    Returns the client walls and the launches the speculative runs made,
    by kernel."""
    import shutil

    loop_path = os.path.join("chiprun_out", f"smoke_{what}_cluster.json")
    shutil.copyfile(path, loop_path)
    args = ["-input-json", "-input", loop_path] + flags
    before = spec_launches(d)
    walls = []
    served = []
    for rnd in range(rounds):
        st0 = d.speculator.stats()
        _rc, out, _err, wall, rep = run_client(
            args + [f"-serve-socket={sock}"], f"{what} round {rnd}")
        served.append(out)
        if not json.loads(out).get("partitions"):
            fail(f"{what} round {rnd}: no move served")
        hit = d.speculator.stats()["hits"] - st0["hits"]
        if rnd > 0 and hit != 1:
            fail(f"{what} round {rnd}: not a memo hit "
                 f"({d.speculator.stats()})")
        apply_plan(loop_path, out)
        doc = spec_settled(sock, d, f"{what} round {rnd}", st0["attempts"])
        walls.append(wall)
        log(f"spec {what} [{CARD}]: round {rnd}: client wall {wall} s, edge "
            f"rung {rep['rung']}, {'memo hit' if hit else 'planned live'}; "
            f"speculation {doc['speculation']}")
    o_out, o_err = oracle.communicate(timeout=600)
    if oracle.returncode != 0:
        fail(f"{what}: the in-process answers failed: {o_err[-2000:]}")
    wants = json.loads(o_out.strip().splitlines()[-1])
    if [w[1] for w in wants] != served or any(w[0] != 0 for w in wants):
        bad = next((k for k, w in enumerate(wants)
                    if k >= len(served) or w != [0, served[k]]), len(wants))
        fail(f"{what}: round {bad}'s served move differs from cli.run "
             f"-no-daemon on the same file")
    log(f"spec {what} [{CARD}]: every round's served move equals cli.run "
        f"-no-daemon on the same file")
    after = spec_launches(d)
    made = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    log(f"spec {what} [{CARD}]: {rounds} rounds, client walls {walls} s; "
        f"kernel launches of the speculative runs {made}")
    return walls, made


def spec_preempt(path, xla_plan, sock_dir):
    """14d: a real request for another tenant arrives while a speculative
    re-plan of the second half of phase 3's plan is in flight: once in
    the run's host head (the run held at the entry of ``scan._run_chunk``,
    before its chunk reaches the card) and once in its chunk's session
    (held at the entry of ``scan.session``). The wall clock decides
    nothing: the speculative (``serve-int-``) thread waits at its hold
    point until the daemon's admission arrival hook
    (``AdmissionController.on_arrival``, which preempts speculation) has
    seen tenant B's request, and B is sent only once the run is held.
    The daemon runs in this process, so both wraps are in place for the
    phase."""
    import shutil
    import threading

    from kafkabalancer_tpu_torch.serve import client
    from kafkabalancer_tpu_torch.solvers import scan

    hold = {"where": None}  # the hold point armed for this round
    held = threading.Event()  # the speculative run waits at it
    admitted = threading.Event()  # the admission hook saw B's request
    stuck = []  # hold points that timed out
    real_chunk, real_session = scan._run_chunk, scan.session

    def wait_at(where):
        if (hold["where"] == where
                and threading.current_thread().name.startswith("serve-int-")
                and not admitted.is_set()):
            held.set()
            if not admitted.wait(120):
                stuck.append(where)

    def run_chunk(*a, **kw):
        wait_at("host head")
        return real_chunk(*a, **kw)

    def session(*a, **kw):
        wait_at("chunk")
        return real_session(*a, **kw)

    moves = len(json.loads(xla_plan)["partitions"])
    b_want = None
    sock = os.path.join(sock_dir, "p.sock")
    d, t, rc_box, logs = serving_daemon(sock, speculate=True)
    d._warm_done.wait(240)
    real_arrival = d._admission.on_arrival

    def on_arrival():
        real_arrival()  # the speculator's preemption first
        if held.is_set():
            admitted.set()

    d._admission.on_arrival = on_arrival
    scan._run_chunk, scan.session = run_chunk, session
    try:
        for k, where in enumerate(("host head", "chunk")):
            a_path = os.path.join("chiprun_out", f"smoke_preempt_a{k}.json")
            b_path = os.path.join("chiprun_out", f"smoke_preempt_b{k}.json")
            for p in (a_path, b_path):
                shutil.copyfile(path, p)
            a_args = ["-input-json", "-input", a_path, "-fused",
                      "-fused-batch=100", f"-max-reassign={moves // 2}",
                      "-min-unbalance=1e-7"]
            b_args = ["-input-json", "-input", b_path] + SPEC_FLAGS
            if b_want is None:
                _rc, b_want, _e, _w = run_cli(b_args + ["-no-daemon"])
            while d.speculator.stats()["inflight"]:
                time.sleep(0.01)
            aborted0 = d.speculator.stats()["aborted"]
            held.clear()
            admitted.clear()
            hold["where"] = where
            rc, _a_out, _e, a_wall = run_cli(
                a_args + [f"-serve-socket={sock}"])
            if rc != 0:
                fail(f"14d: tenant A's request returned {rc}")
            deadline = time.monotonic() + 60
            while not d.speculator.stats()["inflight"]:
                if time.monotonic() > deadline:
                    fail("14d: the speculative run never started")
                time.sleep(0.0005)
            t_spec = time.perf_counter()
            if not held.wait(120):
                fail(f"14d: the speculative run never reached its {where}")
            rc, b_out, _e, b_wall = run_cli(
                b_args + [f"-serve-socket={sock}"])
            since = time.perf_counter() - t_spec - b_wall
            if stuck:
                fail(f"14d: the speculative run waited past 120 s at its "
                     f"{stuck[0]}: the admission hook never saw B")
            if not admitted.is_set():
                fail("14d: tenant B's request was never admitted")
            if rc != 0 or b_out != b_want:
                fail("14d: the preempting request's answer differs from "
                     "in process")
            while d.speculator.stats()["inflight"]:
                time.sleep(0.01)
            hold["where"] = None
            doc = client.fetch_stats(sock)
            st = doc["speculation"]
            spec_identity(st, "14d")
            if st["aborted"] <= aborted0:
                fail(f"14d: the speculative run was not aborted: {st}")
            queue = doc["tenants"]["top"][os.path.abspath(b_path)]["queue_s"]
            log(f"spec 14d [{CARD}]: tenant A served {moves // 2} of phase "
                f"3's {moves} moves in {a_wall} s; a real request for "
                f"tenant B arrived {since} s into the speculative re-plan of "
                f"the rest (held in its {where} until B was admitted): its "
                f"answer equals in process, its wall {b_wall} s, its queue "
                f"wait behind the speculative run {queue['max']} s; "
                f"speculation {st}")
    finally:
        scan._run_chunk, scan.session = real_chunk, real_session
        d._admission.on_arrival = real_arrival
        admitted.set()  # never leave a speculative run held
    stop_daemon(sock, d, t, rc_box, logs, 4, {"session_absent": 4},
                "(daemon 14d)")


def spec_warm_tier(path, sock_dir):
    """14e: the warm tier survives a SIGKILL of a ``-serve`` process."""
    import shutil
    import signal

    from kafkabalancer_tpu_torch.serve import client

    sock = os.path.join(sock_dir, "w.sock")
    spill_dir = os.path.join(sock_dir, "spill")
    e_path = os.path.join("chiprun_out", "smoke_warm_cluster.json")
    shutil.copyfile(path, e_path)
    e_args = ["-input-json", "-input", e_path] + SPEC_FLAGS

    def spawn():
        """Start a ``-serve`` process and, while it warms, the in-process
        answer on the file; returns the process, its seconds to warm and
        the answer."""
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
             f"-serve-socket={sock}", f"-serve-session-spill-dir={spill_dir}",
             "-serve-idle-timeout=300"],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
        _rc, want, _e, _w = run_cli(e_args + ["-no-daemon"])
        while True:
            hello = client.daemon_alive(sock)
            if hello is not None and not hello.get("warming"):
                return proc, time.perf_counter() - t0, want
            if proc.poll() is not None or time.perf_counter() - t0 > 240:
                proc.kill()
                fail(f"14e: the -serve process never warmed: "
                     f"{proc.communicate()[1][-2000:]}")
            time.sleep(0.05)

    proc, warm1, want1 = spawn()
    try:
        _rc, out1, _e, wall1, rep1 = run_client(
            e_args + [f"-serve-socket={sock}"], "14e first request")
        if out1 != want1:
            fail("14e: the first served plan differs from in process")
        FRESH_WALLS["14e first request"] = wall1
        doc1 = client.fetch_stats(sock)
        if doc1["paging"]["spills"] < 1:
            fail(f"14e: nothing spilled: {doc1['paging']}")
        apply_plan(e_path, out1)
        proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
        proc, warm2, want2 = spawn()
        adopted = client.fetch_stats(sock)["paging"]["adopted"]
        _rc, out2, _e, wall2, rep2 = run_client(
            e_args + [f"-serve-socket={sock}"], "14e restore")
        doc2 = client.fetch_stats(sock)
        pg = doc2["paging"]
        if out2 != want2:
            fail("14e: the restored session's plan differs from in process")
        if (pg["restore_hits"], doc2["sessions"]["registered"],
                adopted) != (1, 0, 1):
            fail(f"14e: not a restore hit without a re-register: {pg} "
                 f"{doc2['sessions']} adopted {adopted}")
        log(f"spec 14e [{CARD}]: a -serve process warmed in {warm1} s "
            f"(the in-process answer computed meanwhile), "
            f"served the first request in {wall1} s (client wall; daemon "
            f"{doc1['hists']['serve.request_s']['sum']} s, edge rung "
            f"{rep1['rung']}), spilled it ({doc1['paging']['warm_bytes']} "
            f"bytes) and was SIGKILLed; the next process warmed in {warm2} "
            f"s, adopted {adopted} record and answered the next move "
            f"byte-identically from it in {wall2} s (client wall; daemon, "
            f"restore included, {doc2['hists']['serve.request_s']['sum']} "
            f"s, edge rung {rep2['rung']}); paging {pg}")
        if not client.request_shutdown(sock):
            fail("14e: the shutdown op was not acknowledged")
        proc.communicate(timeout=120)
        if proc.returncode != 0:
            fail(f"14e: the -serve process exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)


def spec_watch(path, sock_dir):
    """14f: ``-watch`` over the file-backed fake ZK of phase 3's cluster;
    returns the watch and speculative runs' launches. The applier writes
    each emitted move into the tree at once (the next tick then finds the
    speculative run of that very state in flight and waits for it); the
    in-process answer of each emitted plan is computed afterwards on a
    copy of the tree it was planned from."""
    import copy

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.serve import client

    def publish(root, tree, topic):
        topics = os.path.join(root, "brokers", "topics")
        os.makedirs(topics, exist_ok=True)
        tmp = os.path.join(topics, topic + ".tmp")
        with open(tmp, "w") as fh:
            json.dump({"version": 1, "partitions": tree[topic]}, fh)
        os.replace(tmp, os.path.join(topics, topic))

    with open(path) as fh:
        pl = get_partition_list_from_reader(fh.read(), True)
    tree = {}
    for p in pl.partitions:
        tree.setdefault(p.topic, {})[str(p.partition)] = list(p.replicas)
    root = os.path.join(sock_dir, "zk")
    for topic in tree:
        publish(root, tree, topic)
    os.environ["KAFKABALANCER_TPU_FAKE_ZK"] = root
    emit = os.path.join(sock_dir, "plans")
    # the ZK tree carries no weights: at the default -min-unbalance (0.01)
    # no single move of the unweighted cluster qualifies, so the watch
    # argv keeps the loop's -min-unbalance=1e-7
    watch_argv = ["-no-daemon=true"] + [
        f + "=true" if "=" not in f else f for f in SPEC_FLAGS
    ]
    sock = os.path.join(sock_dir, "z.sock")
    planned_from = []
    plans = []
    try:
        d, t, rc_box, logs = serving_daemon(
            sock, speculate=True, watch_conn="zk1:2181", watch_emit=emit,
            watch_poll=0.2, watch_argv=watch_argv)
        d._warm_done.wait(240)
        for rnd in range(4):
            deadline = time.monotonic() + 120
            name = os.path.join(emit, f"plan-{rnd + 1:06d}.json")
            while not os.path.exists(name):
                if time.monotonic() > deadline:
                    fail(f"14f: no plan {rnd + 1} emitted: "
                         f"{client.fetch_watch(sock)}")
                time.sleep(0.005)
            with open(name) as fh:
                got = fh.read()
            before = copy.deepcopy(tree)
            if rnd < 3:
                # the applier: the emitted move written to the tree
                for row in json.loads(got)["partitions"]:
                    tree[row["topic"]][str(row["partition"])] = (
                        row["replicas"])
                    publish(root, tree, row["topic"])
            snap = os.path.join(sock_dir, f"zk-{rnd}")
            for topic in before:
                publish(snap, before, topic)
            planned_from.append(snap)
            with open(name[:-len(".json")] + ".meta") as fh:
                meta = json.load(fh)
            w = client.fetch_watch(sock)
            plans.append(got)
            log(f"spec 14f [{CARD}]: plan {rnd + 1}: spec_hit "
                f"{meta['spec_hit']}, event lag {w['watch']['last_event_lag_s']}"
                f" s, plan {w['watch']['last_plan_s']} s")
        w = client.fetch_watch(sock)
        spec_identity(w["speculation"], "14f")
        made = {"watch": spec_launches(d, "watch"),
                "spec": spec_launches(d, "spec")}
        stop_daemon(sock, d, t, rc_box, logs, 0, {}, "(daemon 14f)")
        for rnd, snap in enumerate(planned_from):
            os.environ["KAFKABALANCER_TPU_FAKE_ZK"] = snap
            _rc, want, _e, _w = run_cli(["-from-zk=zk1:2181"] + SPEC_FLAGS
                                        + ["-no-daemon"])
            if plans[rnd] != want:
                fail(f"14f: emitted plan {rnd + 1} differs from -no-daemon "
                     f"on the tree it was planned from")
        k1 = sum(m.get("shard_score", 0) for m in made.values())
        if k1 <= 0:
            fail("14f: the watch path launched no shard_score kernel")
        if w["watch"]["errors"] or w["watch"]["plans_emitted"] < 4:
            fail(f"14f: {w['watch']}")
        log(f"spec 14f [{CARD}]: the 4 emitted plans equal -no-daemon on the "
            f"trees they were planned from; watch {w['watch']}; speculation "
            f"{w['speculation']}; kernel launches {made}")
    finally:
        del os.environ["KAFKABALANCER_TPU_FAKE_ZK"]
    return made


def phase_spec(path, xla_plan, loop13_walls):
    """Phase 14 (see the module docstring); returns the speculative and
    watch runs' launches by path."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    sock_dir = tempfile.mkdtemp(prefix="kbt-")
    out = {}
    loops = (
        ("14a", SPEC_FLAGS, SPEC_ROUNDS),
        ("14b", SPEC_FLAGS + ["-fused-engine=pallas"], SPEC_ROUNDS),
        ("14c", ["-solver=tpu", "-max-reassign=1", "-min-unbalance=1e-7"], 5),
    )
    # the three loops' in-process answers, each in a process of its own,
    # computed while the daemon serves the loops
    oracles = {what: start_oracle_chain(path, flags, what, rounds)
               for what, flags, rounds in loops}
    try:
        # 14a-c: one speculating daemon, three deployment loops
        sock = os.path.join(sock_dir, "s.sock")
        d, t, rc_box, logs = serving_daemon(sock, speculate=True)
        if not d._warm_done.wait(240):
            fail("the speculating daemon never finished its warm body")
        walls = {}
        for what, flags, rounds in loops:
            walls[what], out[what] = spec_loop(d, sock, path, flags, what,
                                               rounds, oracles[what])
        if out["14a"].get("shard_score", 0) <= 0:
            fail("14a: the speculative runs launched no shard_score kernel")
        if out["14b"].get("pallas_session", 0) <= 0:
            fail("14b: the speculative runs launched no pallas_session "
                 "kernel")
        log(f"spec 14c [{CARD}]: -solver=tpu loop client walls "
            f"{walls['14c']} s with speculation and the edge cache; phase "
            f"13f (neither) {loop13_walls} s")
        stop_daemon(sock, d, t, rc_box, logs, 2 * SPEC_ROUNDS + 5,
                    {"session_absent": 3}, "(daemon 14a-c)")
        spec_preempt(path, xla_plan, sock_dir)
        spec_warm_tier(path, sock_dir)
        out["14f"] = spec_watch(path, sock_dir)
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    log(f"spec: phase 14 took {time.perf_counter() - t_phase} s")
    return out


# phase 15: every reference flag on the card — the telemetry exporters,
# -explain, the device profiler (-jax-profile, here torch.profiler), the
# fresh process's span breakdown, prewarm and -serve-prewarm, the scrape
# verbs and the nvcc cache's rebuild of a truncated library, on phase 3's
# cluster
MAIN_FLAGS = ["-fused", "-fused-batch=100", f"-max-reassign={MAIN_REASSIGN}",
              "-min-unbalance=1e-7"]
# the kernels' function names as the profiler reports them
K1_NAME, B2_NAME = "score_blocks", "session_kernel"
# device activity inside the plan window: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_window(pdir, kernel):
    """Read the one Chrome trace ``-jax-profile`` wrote into ``pdir``:
    ``(kernel events named ``kernel`` inside the plan window, the window
    in us, the device's idle share of it, the CUDA event count)``. The
    idle share is 1 - (union of kernel, copy and fill intervals) / window.
    Fails when the trace holds no CUDA activity at all."""
    files = os.listdir(pdir)
    if len(files) != 1:
        fail(f"-jax-profile wrote {files} into {pdir}, not one trace")
    with open(os.path.join(pdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    plans = [ev for ev in events if ev.get("name") == "plan"
             and ev.get("cat") == "user_annotation" and ev.get("ph") == "X"]
    if len(plans) != 1:
        fail(f"the profile holds {len(plans)} plan ranges, not one")
    w0 = float(plans[0]["ts"])
    w1 = w0 + float(plans[0]["dur"])
    dev_evs = [ev for ev in events if ev.get("ph") == "X"
               and ev.get("cat") in DEVICE_CATS]
    if not dev_evs:
        fail("the profiler recorded no CUDA activity on the card")
    inside = [ev for ev in dev_evs
              if w0 <= float(ev["ts"]) and float(ev["ts"]) < w1]
    named = [ev for ev in inside if ev.get("cat") == "kernel"
             and kernel in ev.get("name", "")]
    spans = sorted((max(w0, float(ev["ts"])),
                    min(w1, float(ev["ts"]) + float(ev["dur"])))
                   for ev in inside)
    busy, end = 0.0, w0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return len(named), w1 - w0, 1.0 - busy / (w1 - w0), len(dev_evs)


def telemetry_run(path, flags, label, tag, counter, want_plan, work):
    """15a/15b: ``flags`` through ``cli.run`` on phase 3's cluster without
    and then with every telemetry flag, the files written under ``work``
    (the profile runs to tens of MB); returns the checks' readings."""
    out_dir = os.path.join(work, f"15{tag}")
    os.makedirs(out_dir)
    mpath = os.path.join(out_dir, "metrics.json")
    tpath = os.path.join(out_dir, "trace.json")
    epath = os.path.join(out_dir, "explain.json")
    pdir = os.path.join(out_dir, "profile")
    base = ["-input-json", "-input", path] + flags + ["-no-daemon"]
    rc, out, err, wall_plain = run_cli(base)
    if rc != 0 or out != want_plan:
        fail(f"15{tag}: {label} without telemetry: rc {rc} or another plan")
    counter.launches = 0
    rc, out, err, wall = run_cli(base + [
        "-stats", f"-metrics-json={mpath}", f"-trace={tpath}",
        f"-explain={epath}", f"-jax-profile={pdir}"])
    launches = counter.launches
    if rc != 0:
        fail(f"15{tag}: {label} with telemetry returned {rc}: {err[-2000:]}")
    if out != want_plan:
        fail(f"15{tag}: the telemetry flags changed the plan bytes")
    moves = len(json.loads(out)["partitions"])
    with open(mpath) as fh:
        metrics = json.load(fh)
    if (metrics.get("schema") != "kafkabalancer-tpu.metrics/1"
            or "plan.stop_reason" not in metrics["gauges"]
            or metrics["counters"].get("cli.changes_written") != moves):
        fail(f"15{tag}: the metrics line is not the schema's, or lacks "
             f"plan.stop_reason or the move count: {metrics['gauges']} "
             f"{metrics['counters']}")
    with open(epath) as fh:
        explain = json.load(fh)
    if explain.get("moves_emitted") != moves:
        fail(f"15{tag}: the explain document's moves_emitted "
             f"{explain.get('moves_emitted')} != the plan's {moves} moves")
    with open(tpath) as fh:
        names = {ev["name"] for ev in json.load(fh)["traceEvents"]
                 if ev.get("ph") == "X"}
    if not {"settle", "tensorize", "plan", "emit"} <= names:
        fail(f"15{tag}: the trace lacks a lifecycle span: {sorted(names)}")
    if "invocation telemetry (rc=0)" not in err:
        fail(f"15{tag}: no -stats summary on stderr")
    kernel = K1_NAME if counter.__name__ == "shard_score" else B2_NAME
    n_events, window_us, idle, n_dev = profile_window(pdir, kernel)
    if n_events != launches or launches <= 0:
        fail(f"15{tag}: {n_events} {kernel} kernel events in the plan window, "
             f"the run made {launches} {counter.__name__} launches")
    log(f"telemetry 15{tag} [{CARD}]: {label}: plan equals phase "
        f"{'3' if tag == 'a' else '3b'}'s ({moves} moves, stop reason "
        f"{metrics['gauges']['plan.stop_reason']}, explain moves_emitted "
        f"{explain['moves_emitted']}); {launches} {counter.__name__} launches "
        f"= {n_events} {kernel} events in the profile's plan window "
        f"({window_us / 1e3} ms, {n_dev} CUDA events in the trace); device "
        f"idle share of the window {idle}; wall {wall_plain} s without "
        f"telemetry, {wall} s with -stats -metrics-json -trace -explain "
        f"-jax-profile")
    return dict(launches=launches, idle=idle, window_ms=window_us / 1e3,
                wall=wall, wall_plain=wall_plain)


def span_breakdown(tpath):
    """``{(thread, span): (start s, seconds)}`` of a ``-trace`` file, the
    first occurrence of each, and the end of the last span in s."""
    with open(tpath) as fh:
        events = json.load(fh)["traceEvents"]
    threads = {ev["tid"]: ev["args"]["name"] for ev in events
               if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    spans, end = {}, 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        key = (threads.get(ev["tid"], str(ev["tid"])), ev["name"])
        spans.setdefault(key, (ev["ts"] / 1e6, ev["dur"] / 1e6))
        end = max(end, (ev["ts"] + ev["dur"]) / 1e6)
    return spans, end


# 15c: a fresh process without the warm thread — the latch a warm daemon
# sets (coldstart.mark_process_warm) set before the CLI runs
NO_WARM = (
    "import sys\n"
    "from kafkabalancer_tpu_torch.ops import coldstart\n"
    "coldstart.mark_process_warm()\n"
    "from kafkabalancer_tpu_torch.cli import main\n"
    "main()\n"
)


def phase_fresh_process(path, xla_plan, work):
    """15c: fresh ``-no-daemon`` processes with phase 3's flags and
    ``-trace``, one with the warm thread and one without it: their
    walls, and the first one's span breakdown with the warm thread's
    spans on their own track."""
    walls = {"with": [], "without": []}
    for k, mode in enumerate(("with", "without")):
        tpath = os.path.join(work, f"15c_trace_{k}.json")
        args = (["-input-json", "-input", path] + MAIN_FLAGS
                + ["-no-daemon", f"-trace={tpath}"])
        if mode == "with":
            rc, out, err, wall, _rep = run_client(
                args, f"15c fresh process {k}", served=False)
        else:
            t0 = time.perf_counter()
            rc, out, err, wall, _rep = finish_client(
                subprocess.Popen([sys.executable, "-c", NO_WARM] + args,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
                t0, f"15c fresh process {k} without the warm thread")
        if out != xla_plan:
            fail(f"15c: fresh process {k}'s plan differs from phase 3's")
        spans, end = span_breakdown(tpath)
        warm_spans = [key for key in spans if key[0] == "coldstart-warm"]
        if bool(warm_spans) != (mode == "with"):
            fail(f"15c: fresh process {k} ({mode} the warm thread) traced "
                 f"warm-thread spans {warm_spans}")
        walls[mode].append(wall)
        if k == 0:
            first, first_end, first_wall = spans, end, wall
    want = [("coldstart-warm", "coldstart.torch_import"),
            ("coldstart-warm", "coldstart.cuda_context"),
            ("MainThread", "parse_input"), ("MainThread", "resolve_device"),
            ("MainThread", "settle"), ("MainThread", "tensorize"),
            ("MainThread", "solver.dispatch_chunk"), ("MainThread", "emit")]
    missing = [key for key in want if key not in first]
    if missing:
        fail(f"15c: the fresh process's trace lacks {missing}")
    parts = "; ".join(
        f"{name} ({thread}) at {first[(thread, name)][0]} s for "
        f"{first[(thread, name)][1]} s" for thread, name in want)
    log(f"telemetry 15c [{CARD}]: a fresh -no-daemon process planned phase "
        f"3's plan in {first_wall} s (wall, Python start included); its "
        f"spans, from the tracer's start: {parts}; the last span ends at "
        f"{first_end} s, so {first_wall - first_end} s of the wall is "
        f"before the tracer starts (Python start, the package import) or "
        f"after the last span (exit, the warm thread's join); beside phase "
        f"13d's fresh -no-daemon walls "
        f"{ {k: v for k, v in FRESH_WALLS.items() if k.startswith('13d')} }")
    log(f"telemetry 15c [{CARD}]: fresh -no-daemon walls, with the "
        f"warm thread {walls['with']} s, without it {walls['without']} s")
    return dict(wall=first_wall, walls=walls,
                spans={f"{t}/{n}": v for (t, n), v in first.items()
                       if (t, n) in want})


def phase_prewarm(path, sock_dir):
    """15d-e: ``python -m kafkabalancer_tpu_torch.prewarm -shapes 10000x100
    -verify``, then a ``-serve -serve-prewarm=10000x100`` process: its warm
    seconds and its first request (14e's request: the deployment loop's
    ``-max-reassign=1``) against in process; then ``-serve-stats`` and
    ``-metrics-prom=-`` against it."""
    import re
    import shutil

    from kafkabalancer_tpu_torch.serve import client

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kafkabalancer_tpu_torch.prewarm", "-shapes",
         "10000x100", "-verify"], capture_output=True, text=True, timeout=600)
    pre_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"15d: prewarm exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    if (doc["kernels"], doc["failed"], doc["verified"]) != (2, 0, 4):
        fail(f"15d: prewarm did not load and verify both kernels and both "
             f"sessions: {doc}")
    log(f"telemetry 15d [{CARD}]: prewarm -shapes 10000x100 -verify in "
        f"{pre_wall} s: "
        + ", ".join(f"{k.get('kernel') or k['name']} {k['status']}"
                    + (f" {k['seconds']} s" if 'seconds' in k else "")
                    + f" verified={k.get('verified')}" for k in doc["keys"]))

    sock = os.path.join(sock_dir, "pw.sock")
    d_path = os.path.join("chiprun_out", "smoke_prewarm_cluster.json")
    shutil.copyfile(path, d_path)
    d_args = ["-input-json", "-input", d_path] + SPEC_FLAGS
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
         f"-serve-socket={sock}", "-serve-prewarm=10000x100",
         "-serve-idle-timeout=300"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _rc, want, _e, _w = run_cli(d_args + ["-no-daemon"])
        while True:
            hello = client.daemon_alive(sock)
            if hello is not None and not hello.get("warming"):
                break
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                proc.kill()
                fail(f"15d: the -serve-prewarm process never warmed: "
                     f"{proc.communicate()[1][-2000:]}")
            time.sleep(0.05)
        warm = time.perf_counter() - t0
        _rc, out, _e, wall1, rep = run_client(
            d_args + [f"-serve-socket={sock}"], "15d first request")
        if out != want:
            fail("15d: the prewarmed daemon's first plan differs from in "
                 "process")
        sent = 1
        rc, stats_text, err, stats_wall, _r = run_client(
            ["-serve-stats", f"-serve-socket={sock}"], "15e -serve-stats",
            served=False)
        rc, prom, err, prom_wall, _r = run_client(
            ["-metrics-prom=-", f"-serve-socket={sock}"], "15e -metrics-prom",
            served=False)
        series = {}
        for line in prom.splitlines():
            if not line or line.startswith("#"):
                continue
            m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$',
                         line)
            if m is None:
                fail(f"15e: not a Prometheus text line: {line!r}")
            series[m.group(1) + (m.group(2) or "")] = float(m.group(3))
        if series.get("kafkabalancer_tpu_requests") != sent:
            fail(f"15e: the request counter reads "
                 f"{series.get('kafkabalancer_tpu_requests')}, {sent} sent")
        if f"  requests: {sent} " not in stats_text:
            fail(f"15e: -serve-stats does not show {sent} request(s)")
        if not client.request_shutdown(sock):
            fail("15d: the shutdown op was not acknowledged")
        _o, err = proc.communicate(timeout=120)
        if proc.returncode != 0:
            fail(f"15d: the -serve-prewarm process exited {proc.returncode}")
        lines = [x.split("serve: ")[-1] for x in err.splitlines()
                 if "serve: prewarm" in x or "serve: warm in" in x]
        log(f"telemetry 15d [{CARD}]: a -serve -serve-prewarm=10000x100 "
            f"process answered warm {warm} s after its start ({lines}); its "
            f"first request (the -max-reassign=1 loop's, as 14e's) equals in "
            f"process, client wall {wall1} s (edge rung {rep['rung']}), "
            f"beside 14e's first request of an un-prewarmed -serve "
            f"{FRESH_WALLS.get('14e first request')} s")
        log(f"telemetry 15e [{CARD}]: -serve-stats ({stats_wall} s) and "
            f"-metrics-prom=- ({prom_wall} s, {len(series)} series, parsed) "
            f"against it; kafkabalancer_tpu_requests "
            f"{series['kafkabalancer_tpu_requests']} = requests sent {sent}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
    return dict(prewarm_wall=pre_wall, warm=warm, first=wall1)


# 15f: a process of its own points nvcc.BUILD_DIR at a copy of the build
# cache, truncates shard_score's library there and plans phase 3's flags
REBUILD = (
    "import io, json, os, shutil, sys\n"
    "from kafkabalancer_tpu_torch.ops import nvcc\n"
    "shutil.copytree(nvcc.BUILD_DIR, sys.argv[1])\n"
    "nvcc.BUILD_DIR = sys.argv[1]\n"
    "lib = nvcc.library_path('shard_score.cu')\n"
    "size = os.path.getsize(lib)\n"
    "with open(lib, 'r+b') as fh:\n"
    "    fh.truncate(size // 8)\n"
    "from kafkabalancer_tpu_torch import cli\n"
    "out, err = io.StringIO(), io.StringIO()\n"
    "rc = cli.run(io.StringIO(''), out, err, ['kafkabalancer'] + sys.argv[2:])\n"
    "print(json.dumps({'rc': rc, 'rebuilds': nvcc.rebuilds,\n"
    "                  'build_s': nvcc.build_seconds, 'size': size,\n"
    "                  'rebuilt_size': os.path.getsize(lib),\n"
    "                  'err': err.getvalue()[-2000:]}))\n"
    "sys.stdout.write(out.getvalue())\n"
)


def phase_rebuild(path, xla_plan, sock_dir):
    """15f: a truncated cached library costs one rebuild and the same
    plan."""
    cache = os.path.join(sock_dir, "cache")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", REBUILD, cache, "-input-json", "-input", path]
        + MAIN_FLAGS + ["-no-daemon"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"15f: the rebuild process failed: {proc.stderr[-2000:]}")
    head, _, plan = proc.stdout.partition("\n")
    rep = json.loads(head)
    if rep["rc"] != 0 or rep["rebuilds"] != {"shard_score.cu": 1}:
        fail(f"15f: not exactly one rebuild of shard_score: {rep}")
    if plan != xla_plan:
        fail("15f: the plan after the rebuild differs from phase 3's")
    log(f"telemetry 15f [{CARD}]: shard_score's cached library truncated "
        f"from {rep['size']} bytes to 1/8: one rebuild "
        f"({rep['build_s'].get('shard_score.cu')} s of nvcc, "
        f"{rep['rebuilt_size']} bytes), phase 3's plan, process wall {wall} s")
    return wall


def phase_telemetry(dev, path, xla_plan, pallas_plan):
    """Phase 15 (see the module docstring); returns the launches of 15a
    and 15b by kernel."""
    import shutil
    import tempfile

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    t_phase = time.perf_counter()
    out = {}
    work = tempfile.mkdtemp(prefix="kbt-smoke15-")
    try:
        out["15a"] = telemetry_run(
            path, MAIN_FLAGS, "-fused -fused-batch=100", "a", sk.shard_score,
            xla_plan, work)
        out["15b"] = telemetry_run(
            path, MAIN_FLAGS + ["-fused-engine=pallas"],
            "-fused -fused-engine=pallas", "b", ps.pallas_session,
            pallas_plan, work)
        out["15c"] = phase_fresh_process(path, xla_plan, work)
        out["15d"] = phase_prewarm(path, work)
        out["15f"] = phase_rebuild(path, xla_plan, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"telemetry: phase 15 took {time.perf_counter() - t_phase} s")
    return out


# phase 16: the fleet-churn replay harness (replay/) on the card: private
# daemons of this package spawned by the harness (python -m
# kafkabalancer_tpu_torch -serve), -solver=tpu (the per-move window scorer
# on the device) in the daemon and in this process's -no-daemon oracles,
# on a fleet of 4 tenants whose whale holds 2000 partitions over 50 brokers
REPLAY_FLEET = dict(tenants=4, base_partitions=2000, brokers=50, replicas=3,
                    max_reassign=2, solver="tpu")
REPLAY_MODES = (
    ("16a", "churn", dict(requests=40, topic_storm_every=11,
                          broker_failure_every=13)),
    ("16b", "chaos", dict(requests=24, chaos=True)),
    ("16c", "restart", dict(requests=24, restart=True)),
    ("16d", "watch", dict(watch=True, solver="tpu")),
)


def phase_replay():
    """Phase 16: ``run_replay`` in each mode; every artifact must
    reconcile with no request error and parity on every checked plan.
    Returns each mode's wall."""
    from kafkabalancer_tpu_torch.replay import REPLAY_SCHEMA, ReplayConfig
    from kafkabalancer_tpu_torch.replay import run_replay

    walls = {}
    for tag, mode, kw in REPLAY_MODES:
        cfg = ReplayConfig(seed=SEED, **(kw if mode == "watch"
                                         else {**REPLAY_FLEET, **kw}))
        t0 = time.perf_counter()
        art = run_replay(cfg, log=lambda m, tag=tag: log(f"{tag}: {m}"))
        wall = time.perf_counter() - t0
        walls[tag] = wall
        if art.get("schema") != REPLAY_SCHEMA or art.get("mode") != mode:
            fail(f"{tag}: artifact {art.get('schema')} mode {art.get('mode')}")
        if art.get("request_errors"):
            fail(f"{tag}: request errors {json.dumps(art['request_errors'])}")
        block = art.get(mode) if mode != "churn" else None
        if not art.get("reconciled"):
            fail(f"{tag}: the {mode} replay did not reconcile: "
                 f"{json.dumps(block if block else art, default=str)[:3000]}")
        summary = f"{art['requests_issued']} requests, events {art['events']}"
        if mode == "churn":
            par = art.get("parity") or {}
            if not par.get("ok"):
                fail(f"16a: the parity sample failed: {par}")
            tr = art["trace"]
            if not (tr["checked"] and tr["reconciled"]):
                fail(f"16a: trace ids not reconciled: {tr}")
            for name, e in sorted(art["per_tenant"].items()):
                log(f"16a: {name}: {e['issued']} requests ({e['partitions']} "
                    f"partitions at the end, {e['moves_applied']} moves "
                    f"applied), daemon p50/p95 {e['daemon_p50']} / "
                    f"{e['daemon_p95']} s, client p50/p95 {e['client_p50']} "
                    f"/ {e['client_p95']} s (bucket upper bounds), "
                    f"delta hits {e.get('delta_hits')}, resyncs "
                    f"{e.get('resyncs_rows')} rows / {e.get('resyncs_full')} "
                    f"full")
            summary += (f", parity sample ok at step {par['step']}, "
                        f"{tr['ids_issued']} trace ids matched")
        elif mode == "chaos":
            if block["faults_fired"].get("lane_crash", 0) < 1:
                fail(f"16b: lane_crash never fired: {block['faults_fired']}")
            if not block["identities"]["no_lane_still_quarantined"]:
                fail("16b: a lane is still quarantined")
            summary += (f", {block['answered']} answered (parity on every "
                        f"one), faults fired {block['faults_fired']}, "
                        f"{block['shed_total']} sheds, "
                        f"{block['quarantines']} quarantines / "
                        f"{block['recoveries']} recoveries, identities "
                        f"{block['identities']}")
        elif mode == "restart":
            summary += (f", SIGKILL after {block['kill_after']}, "
                        f"{block['answered']} answered (parity on every "
                        f"one), restores {block['restores']} (hits "
                        f"{block['restore_hits']}, rate "
                        f"{block['restore_hit_rate']}), pre/post p95 "
                        f"{block['pre_restart_p95_s']} / "
                        f"{block['post_restart_p95_s']} s, first request "
                        f"after the restart {block['first_post_restart_max_s']}"
                        f" s, paging identity {block['paging_identity_ok']}")
        else:
            summary = (f"{block['plans_emitted']} plans emitted with no "
                       f"client plan op (parity on {block['parity_checked']}),"
                       f" speculative hits {block['spec_hit_plans']} (rate "
                       f"{block['spec_hit_rate']}), {block['resyncs']} "
                       f"resyncs for {block['drift_events']} drift events, "
                       f"last event lag {block['last_event_lag_s']} s, "
                       f"speculation identity "
                       f"{block['speculation_identity_ok']}")
        log(f"{tag}: {mode} replay, -solver={cfg.solver}, {cfg.tenants} "
            f"tenants (base {cfg.base_partitions} partitions, {cfg.brokers} "
            f"brokers): reconciled, {wall} s wall; {summary}")
    return walls


# phase 17: two processes on the one card. Each runs this script with
# --dist-worker, joins a gloo group through parallel.distributed and names
# cuda:0 twice: a 1 x 4 mesh whose part axis spans both processes (the
# sharded scorer and plan_sharded on phase 3's cluster) and a 2 x 2 mesh
# whose sweep axis does (four scenarios)
DIST_SCENARIOS = ("status quo", "+1", "+2", "-1")
DIST_SWEEP_BUDGET = 500


def dist_inputs(path):
    """Phase 17's shared inputs: phase 3's cluster, its config, the
    sweep's scenarios and the scorer's dense inputs."""
    import numpy as np
    import torch

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize
    from kafkabalancer_tpu_torch.solvers.tpu import oracle_loads

    with open(path) as fh:
        text = fh.read()
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    pl = get_partition_list_from_reader(text, True)
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    hi = max(observed)
    scenarios = [observed, observed + [hi + 1], observed + [hi + 1, hi + 2],
                 observed[1:]]
    dp = tensorize(pl, cfg, min_bucket=8)
    loads = np.zeros(dp.bvalid.shape[0])
    for bid, load in oracle_loads(pl, cfg).items():
        loads[dp.broker_index(bid)] = load

    def score_args(dev):
        return tuple(torch.from_numpy(a).to(dev) for a in (
            loads, dp.replicas, dp.allowed, dp.member, dp.weights,
            dp.nrep_cur, dp.nrep_tgt, dp.pvalid, dp.bvalid)) + (
            torch.tensor(float(dp.nb), device=dev), 2)

    return text, cfg, scenarios, score_args


def dist_results(dev, path, row, grid):
    """The sharded scorer on ``row`` (and unsharded), ``plan_sharded``
    plain and with polish on ``row``, the sweep on ``grid``: plain
    values (floats as ``float.hex``), walls and K1 launches."""
    import copy

    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.parallel.shard_move import sharded_score_moves
    from kafkabalancer_tpu_torch.parallel.shard_session import plan_sharded
    from kafkabalancer_tpu_torch.parallel.sweep import sweep
    from kafkabalancer_tpu_torch.solvers.tpu import score_moves

    text, cfg, scenarios, score_args = dist_inputs(path)
    out = {"score": []}
    args = score_args(dev)
    for leaders in (False, True):
        for u, i, su, perm in (
                sharded_score_moves(*args, leaders=leaders, mesh=row),
                score_moves(*args, leaders=leaders)):
            out["score"].append([float(u).hex(), int(i), float(su).hex(),
                                 perm.reshape(-1).tolist()])
    # one short untimed run first: the kernel library's load and CUDA's
    # lazily loaded modules stay out of the timed runs
    plan_sharded(get_partition_list_from_reader(text, True),
                 copy.deepcopy(cfg), 200, row, batch=100)
    for key, polish in (("plan", False), ("polish", True)):
        obs.begin_invocation()
        sk.shard_score.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opl = plan_sharded(get_partition_list_from_reader(text, True),
                           copy.deepcopy(cfg), MAIN_REASSIGN, row, batch=100,
                           polish=polish)
        torch.cuda.synchronize()
        out[key] = {
            "text": plan_text(opl), "wall": time.perf_counter() - t0,
            "launches": sk.shard_score.launches,
            "iterations": int(counter("shard.session_iterations")),
            "session_s": counter("shard.session_seconds"),
            "cross_s": counter("shard.cross_process_seconds"),
            "gathers": int(counter("shard.cross_process_gathers")),
            "tail": int(counter("solver.session_iterations")),
        }
    t0 = time.perf_counter()
    res = sweep(get_partition_list_from_reader(text, True), cfg, scenarios,
                max_reassign=DIST_SWEEP_BUDGET, mesh=grid, batch=100)
    torch.cuda.synchronize()
    out["sweep"] = [[r.feasible, r.completed, r.n_evacuations, r.n_moves,
                     float(r.unbalance).hex(), r.replicas] for r in res]
    out["sweep_wall"] = time.perf_counter() - t0
    return out


def dist_worker(argv):
    """One process of phase 17: ``--dist-worker RANK PORT CLUSTER OUT``."""
    import torch

    rank, port, path, out_path = int(argv[0]), argv[1], argv[2], argv[3]
    from kafkabalancer_tpu_torch.parallel import distributed
    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank, timeout_s=300)
    dev = torch.device("cuda:0")
    row = make_mesh(4, shape=(1, 4), devices=[dev, dev])
    grid = make_mesh(4, devices=[dev, dev])
    if not (row.spans_processes("part") and grid.spans_processes("sweep")):
        print("the meshes do not span both processes", flush=True)
        return 1
    out = dist_results(dev, path, row, grid)
    out["rank"] = rank
    out["process_s"] = time.perf_counter() - t0
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    distributed.shutdown()
    return 0


def phase_distributed(dev, path, xla_plan):
    """Phase 17: two processes, each on cuda:0 with two shards. Both
    ranks' results must be equal, the sharded scorer equal to the
    unsharded one, plan_sharded's plan equal to phase 11's S = 4 plan
    (phase 3's) and the polish variant and the sweep equal to this
    process's one-process runs on the same mesh shapes. Returns K1's
    launches per rank."""
    import socket
    import tempfile

    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    tmp = tempfile.mkdtemp(prefix="kb-dist-")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         port, os.path.abspath(path), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, txt) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"17: rank {r} exited {p.returncode}: {txt[-3000:]}")
    got = []
    for o in outs:
        with open(o) as fh:
            got.append(json.load(fh))
    log(f"17: two processes on {dev}: {wall} s for both (each process "
        f"{got[0]['process_s']} / {got[1]['process_s']} s after its start)")

    def same(key):
        return got[0][key] == got[1][key]

    for key in ("score", "sweep"):
        if not same(key):
            fail(f"17: the ranks' {key} results differ")
    for key in ("plan", "polish"):
        if got[0][key]["text"] != got[1][key]["text"]:
            fail(f"17: the ranks' plan_sharded {key} plans differ")
    for k in range(0, len(got[0]["score"]), 2):
        if got[0]["score"][k] != got[0]["score"][k + 1]:
            fail(f"17: sharded_score_moves (leaders={k // 2 == 1}) over two "
                 f"processes differs from score_moves")
    log("17: sharded_score_moves over a 1 x 4 mesh of two processes: equal "
        "on both ranks and to the unsharded score_moves, leaders off and on")
    if got[0]["plan"]["text"] != xla_plan:
        fail("17: plan_sharded over two processes differs from phase 11's "
             "S = 4 plan")
    one = dist_results(dev, path, make_mesh(devices=[dev] * 4, shape=(1, 4)),
                       make_mesh(devices=[dev] * 4))
    if one["plan"]["text"] != xla_plan:
        fail("17: one-process plan_sharded S = 4 differs from phase 3's plan")
    if got[0]["polish"]["text"] != one["polish"]["text"]:
        fail("17: plan_sharded polish over two processes differs from one "
             "process's")
    if got[0]["sweep"] != one["sweep"]:
        fail("17: the sweep over two processes differs from one process's")
    if got[0]["score"] != one["score"]:
        fail("17: sharded_score_moves over two processes differs from one "
             "process's")
    for key in ("plan", "polish"):
        for r, g in enumerate(got):
            run = g[key]
            want = 2 * run["iterations"] + run["tail"]
            if run["iterations"] <= 0 or run["launches"] != want:
                fail(f"17: rank {r} {key}: shard_score launches "
                     f"{run['launches']} != 2 shards x {run['iterations']} "
                     f"iterations + {run['tail']} tail iterations")
        log(f"17: plan_sharded{' polish=True' if key == 'polish' else ''} "
            f"batch=100 on {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} over 2 processes "
            f"x 2 shards: walls {got[0][key]['wall']} / {got[1][key]['wall']}"
            f" s against {one[key]['wall']} s in one process (4 shards), "
            f"{got[0][key]['iterations']} sharded iterations, sharded "
            f"session {got[0][key]['session_s']} / {got[1][key]['session_s']}"
            f" s against {one[key]['session_s']} s, of it "
            f"{got[0][key]['cross_s']} / {got[1][key]['cross_s']} s in "
            f"{got[0][key]['gathers']} cross-process gathers, shard_score "
            f"launches {got[0][key]['launches']} / {got[1][key]['launches']} "
            f"per rank against {one[key]['launches']} in one process; "
            + ("phase 11's S = 4 plan" if key == "plan"
               else "the one-process polish plan"))
    for name, r in zip(DIST_SCENARIOS, got[0]["sweep"]):
        log(f"17: sweep {name}: feasible {r[0]}, completed {r[1]}, {r[2]} "
            f"evacuations, {r[3]} moves, unbalance {float.fromhex(r[4])}")
    log(f"17: sweep of {len(DIST_SCENARIOS)} scenarios (max_reassign "
        f"{DIST_SWEEP_BUDGET}, batch 100) over a 2 x 2 mesh of two "
        f"processes: {got[0]['sweep_wall']} / {got[1]['sweep_wall']} s "
        f"against {one['sweep_wall']} s in one process; equal results")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return got[0]["plan"]["launches"], got[1]["plan"]["launches"]


# phase 18: the port's static analyzer (analysis/) from the checkout, then
# its runtime twin: torch's sync monitor over phase 3's and 3b's paths
ANALYZER = "kafkabalancer_tpu_torch.analysis"
TYPED_SUBPACKAGES = ("models", "ops", "codecs", "analysis")
SYNC_RULES = ("R1", "R3", "R5")


def run_analyzer(args, what):
    """One ``python -m kafkabalancer_tpu_torch.analysis`` process from the
    checkout with ``--format json``; fails on a non-zero exit or any
    finding. Returns its wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", ANALYZER, "--format", "json", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    wall = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        doc = None
    if proc.returncode != 0 or doc is None or doc.get("count") != 0:
        fail(f"18a: {what} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    by_rule = {}
    for f in doc["findings"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    log(f"18a: {what}: exit 0, {doc['count']} findings (per rule "
        f"{by_rule}), {wall} s")
    return wall


def suppression_census(paths):
    """Suppressions per rule id and the device-loop functions over the
    lint paths, from the analyzer's own parser."""
    from kafkabalancer_tpu_torch.analysis.context import parse_module
    from kafkabalancer_tpu_torch.analysis.jaxlint import iter_python_files

    per_rule, loop_fns = {}, 0
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            ctx = parse_module(fh.read(), path)
        for rules in ctx.suppressions.values():
            for r in rules:
                per_rule[r] = per_rule.get(r, 0) + 1
        loop_fns += len(ctx.device_loop)
    return dict(sorted(per_rule.items())), loop_fns


def phase_analyzer():
    """Phase 18a: the lint rules over the port and this script, the
    contract passes, the annotation floor over the typed subpackages."""
    lint_paths = ["kafkabalancer_tpu_torch/", "chip_smoke.py"]
    run_analyzer(lint_paths, "R1-R5 over kafkabalancer_tpu_torch/ and "
                 "chip_smoke.py")
    run_analyzer(["--contracts"], "--contracts (R6-R9, SUP)")
    run_analyzer(["--annotations"] + [f"kafkabalancer_tpu_torch/{d}"
                                      for d in TYPED_SUBPACKAGES],
                 "--annotations over " + ", ".join(TYPED_SUBPACKAGES))
    per_rule, loop_fns = suppression_census(
        [os.path.join(ROOT, p) for p in lint_paths])
    log(f"18a: suppressions per rule {per_rule}; {loop_fns} device-loop "
        f"functions (marked and reached)")
    return per_rule


class SyncMonitor:
    """Every synchronisation torch reports under
    ``set_sync_debug_mode("warn")``, attributed to the innermost frame of
    the checkout on the Python stack (``file:line``)."""

    def __init__(self):
        self.sites = {}
        self.unattributed = 0

    def hook(self, message, category, filename, lineno, file=None,
             line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        import traceback

        for fr in reversed(traceback.extract_stack()[:-1]):
            path = os.path.abspath(fr.filename)
            if path.startswith(ROOT + os.sep):
                site = (os.path.relpath(path, ROOT), fr.lineno)
                self.sites[site] = self.sites.get(site, 0) + 1
                return
        self.unattributed += 1

    def run(self, fn):
        import warnings

        import torch

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def total(self):
        return sum(self.sites.values()) + self.unattributed


class LoopLines:
    """Per file: the device-loop lines (the analyzer's marking) and
    whether a line carries an R1/R3/R5 suppression."""

    def __init__(self):
        self.ctx = {}

    def _ctx(self, rel):
        if rel not in self.ctx:
            from kafkabalancer_tpu_torch.analysis.context import parse_module

            with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
                ctx = parse_module(fh.read(), rel)
            self.ctx[rel] = (ctx, ctx.device_loop_lines())
        return self.ctx[rel]

    def in_loop(self, rel, line):
        return line in self._ctx(rel)[1]

    def suppressed(self, rel, line):
        """A directive naming R1, R3, R5 (or all) on the line above the
        innermost statement holding ``line`` through ``line`` (through the
        statement's end for a simple statement)."""
        import ast

        ctx = self._ctx(rel)[0]
        best = None
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.stmt) and node.lineno <= line
                    <= (node.end_lineno or node.lineno)):
                if best is None or node.lineno >= best.lineno:
                    best = node
        start = best.lineno if best is not None else line
        end = line if best is None or hasattr(best, "body") else (
            best.end_lineno or line)
        for ln in range(start - 1, end + 1):
            rules = ctx.suppressions.get(ln, set())
            if "ALL" in rules or rules & set(SYNC_RULES):
                return True
        return False


def synced_run(args, counter, want_plan, what, loops):
    """One ``cli.run`` under the sync monitor; returns the run's syncs, its
    session iterations and its launches of ``counter``'s kernel."""
    import torch

    from kafkabalancer_tpu_torch import cli, obs

    mon = SyncMonitor()
    out, err = io.StringIO(), io.StringIO()
    counter.launches = 0
    t0 = time.perf_counter()
    rc = mon.run(lambda: cli.run(io.StringIO(""), out, err, args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    # cli.run starts from a fresh registry: the counter is this run's
    iters = int(obs.REGISTRY.counter_get("solver.session_iterations"))
    if rc != 0:
        fail(f"18b: {what} returned {rc}: {err.getvalue()[-2000:]}")
    if out.getvalue() != want_plan:
        fail(f"18b: {what} under the sync monitor emitted another plan")
    if mon.total() == 0:
        fail(f"18b: {what}: the sync monitor recorded nothing")
    in_loop = {s: n for s, n in mon.sites.items() if loops.in_loop(*s)}
    stray = sorted(s for s in in_loop if not loops.suppressed(*s))
    loop_syncs = sum(in_loop.values())
    log(f"18b: {what}: plan equal to the unmonitored run's, {wall} s wall, "
        f"{launches} launches, {iters} session iterations, {mon.total()} "
        f"syncs ({loop_syncs} from device-loop lines, "
        f"{loop_syncs / max(iters, 1)} per iteration; "
        f"{mon.total() / max(iters, 1)} per iteration in all; "
        f"{mon.unattributed} outside the checkout)")
    for (rel, line), n in sorted(mon.sites.items(), key=lambda kv: -kv[1]):
        tag = ("device-loop, suppressed" if (rel, line) in in_loop
               and (rel, line) not in stray else
               "device-loop, NOT suppressed" if (rel, line) in in_loop
               else "outside device-loop code")
        log(f"18b:   {n:6d}  {rel}:{line}  ({tag})  "
            f"{linecache_line(rel, line)}")
    if stray:
        fail(f"18b: {what}: syncs from device-loop lines without an "
             f"R1/R3/R5 suppression: {stray}")
    return {"syncs": mon.total(), "loop_syncs": loop_syncs,
            "iterations": iters, "launches": launches, "wall": wall,
            "sites": {f"{r}:{ln}": n for (r, ln), n in mon.sites.items()}}


def linecache_line(rel, line):
    import linecache

    return linecache.getline(os.path.join(ROOT, rel), line).strip()[:100]


def phase_sync_monitor(path, xla_plan, pallas_plan):
    """Phase 18b: phase 3's and 3b's paths under torch's sync monitor."""
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    loops = LoopLines()
    base = ["kafkabalancer", "-input-json", "-input", path, "-fused",
            "-fused-batch=100", f"-max-reassign={MAIN_REASSIGN}",
            "-min-unbalance=1e-7"]
    k1 = synced_run(base, sk.shard_score, xla_plan,
                    "-fused -fused-batch=100 (K1 per iteration)", loops)
    b2 = synced_run(base[:5] + ["-fused-engine=pallas"] + base[5:],
                    ps.pallas_session, pallas_plan,
                    "-fused -fused-engine=pallas -fused-batch=100 (B2)",
                    loops)
    if k1["launches"] <= 0 or b2["launches"] <= 0:
        fail(f"18b: the monitored runs launched K1 {k1['launches']} and "
             f"B2 {b2['launches']} times")
    return {"k1": k1, "b2": b2}


# phase 19: cross-request fusion on the card — the batched scoring pass,
# the instance-batched session and the daemon's batchers, on phase 13e's
# four clusters
BATCH_KS = (1, 2, 4)


def batch_session_inputs(path, dev):
    """One cluster file's settled session inputs on the card (the first
    chunk of ``-fused -min-unbalance=1e-7``): the 11 tensors of
    ``scan.session`` and the knobs ``(min_replicas, min_unbalance,
    budget, max_moves)``."""
    import torch

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.models.config import default_dtype
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.runtime import next_bucket
    from kafkabalancer_tpu_torch.ops.tensorize import (
        all_allowed_of,
        tensorize,
        to_device,
    )
    from kafkabalancer_tpu_torch.solvers import scan

    with open(path) as fh:
        pl = get_partition_list_from_reader(fh, True)
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    _rep, budget = scan._settle_head(pl, cfg, MAIN_REASSIGN)
    dp = tensorize(pl, cfg)
    d = to_device(dp, dev, default_dtype(dev), all_allowed=all_allowed_of(dp))
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                         dp.bvalid.shape[0])
    always = torch.from_numpy(scan._cfg_broker_mask(dp, cfg)).to(dev)
    chunk = min(budget, scan.auto_chunk_moves(len(pl.partitions)))
    return ((loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
             d.nrep_tgt, d.ncons, d.pvalid, always, d.bvalid),
            (cfg.min_replicas_for_rebalancing, cfg.min_unbalance, chunk,
             next_bucket(chunk, 128)))


def first_pass_args(ins):
    """The scoring pass's inputs at a session's first iteration (the
    main-path variant: every broker allowed, no colocation counts)."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    loads, rep, mem, alw, w, nc, nt, ncons, pv, always, uv = ins
    bvalid = (always | ((mem & pv[:, None]).sum(0) > 0)) & uv
    avg, F, _su, s_i, t_i, live = scan.pool_frame(
        loads, bvalid, bvalid.sum().to(loads.dtype))
    scal = torch.stack([avg, torch.full_like(avg, 2.0),
                        torch.zeros_like(avg)])
    return variant((rep, sk.pack_cols(w, nc, nt, ncons, pv), mem, alw, loads,
                    F, bvalid, scal, s_i.int().contiguous(),
                    t_i.int().contiguous(), live.contiguous()), False, False)


def check_k1_batched(per, colo=False):
    """19a (21a with ``colo``: the colocation variant, counts rows
    included): the batched scoring pass at K = 1, 2, 4 against K solo
    launches and its plain version, bit for bit, then timed (with
    allow_leader on the colocation session's own inputs, off on the
    main path's)."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    tag, what = ("21a", "colocation variant") if colo else ("19a", "K1")
    lead_t = colo
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    out = {}
    for K in BATCH_KS:
        st = [None if per[0][j] is None else
              torch.stack([per[k][j] for k in range(K)]).contiguous()
              for j in range(12)]
        for lead in (False, True):
            got = sk.shard_score_batched(*st[:11], c_rows=st[11],
                                         allow_leader=lead)
            again = sk.shard_score_batched(*st[:11], c_rows=st[11],
                                           allow_leader=lead)
            ref = sk.shard_score_batched_plain(*st[:11], c_rows=st[11],
                                               allow_leader=lead)
            for k in range(K):
                solo = sk.shard_score(*per[k][:11], c_rows=per[k][11],
                                      allow_leader=lead)
                for name, a, b, c, d in zip(
                    ("vf", "pf", "vl", "pl", "vpf", "ppf", "vpl", "ppl"),
                    got, again, ref, solo,
                ):
                    if not (torch.equal(a[k], b[k]) and torch.equal(a[k], d)
                            and bool((a[k] == c[k]).all())):
                        fail(f"{tag}: shard_score_batched ({what}) K={K} "
                             f"instance {k} allow_leader={lead}: output "
                             f"{name} differs from a solo launch or the "
                             f"plain version")
        log(f"{tag}: shard_score_batched ({what}) K={K}: each instance equal "
            f"to a solo shard_score launch and to the plain version (8 "
            f"outputs, allow_leader off and on, max_abs_err 0.0)")
        ms, host_ms = cuda_ms(
            lambda: sk.shard_score_batched(*st[:11], c_rows=st[11],
                                           allow_leader=lead_t), 20, flush)
        solo_ms, solo_host = cuda_ms(
            lambda: [sk.shard_score(*per[k][:11], c_rows=per[k][11],
                                    allow_leader=lead_t) for k in range(K)],
            20, flush)
        plain_ms, _ph = cuda_ms(
            lambda: sk.shard_score_batched_plain(
                *st[:11], c_rows=st[11], allow_leader=lead_t), 3, flush)
        n_bytes = sum(k1_bytes(per[k], lead_t) for k in range(K))
        n_ops = sum(k1_ops(per[k], lead_t) for k in range(K))
        t_b, t_o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S
        bound = 1e3 * max(t_b, t_o)
        by = "bytes" if t_b >= t_o else "operations"
        out[K] = dict(ms=ms, host_ms=host_ms, solo_ms=solo_ms,
                      solo_host_ms=solo_host, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops)
        log(f"{tag} [{CARD}]: {what} K={K} at 10k x 100 (P="
            f"{per[0][2].shape[0]} B={per[0][2].shape[1]}, allow_leader="
            f"{lead_t}): one batched launch {ms} ms on the device ({host_ms} "
            f"ms host), {K} solo launches {solo_ms} ms ({solo_host} ms host), "
            f"plain {plain_ms} ms, bound {bound} ms ({by}; {n_bytes} bytes, "
            f"{n_ops} ops)")
    del flush_buf
    return out


def check_session_batched(ins, knobs):
    """19b: ``session_batched`` over the four instances against four solo
    ``session`` calls, byte for byte, under the sync monitor."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    K = len(ins)
    mm = max(k[3] for k in knobs)
    solo, solo_launches, solo_wall = [], [], 0.0
    for k in range(K):
        sk.shard_score.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _r, _l, n, mp, msl, _ms, mt, _su = scan.session(
            *ins[k], knobs[k][0], knobs[k][1], knobs[k][2], max_moves=mm,
            allow_leader=False, batch=100)
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo.append(torch.cat([mp, msl, mt, torch.tensor(
            [n], dtype=torch.int32, device=mp.device)]).cpu())
        solo_launches.append(sk.shard_score.launches)
    stacked = [None if ins[0][j] is None else
               torch.stack([x[j] for x in ins]) for j in range(11)]
    mon = SyncMonitor()
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    t0 = time.perf_counter()
    packed, iters, _secs = mon.run(lambda: scan.session_batched(
        *stacked, [k[0] for k in knobs], [k[1] for k in knobs],
        [k[2] for k in knobs], max_moves=mm, allow_leader=False, batch=100))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.shard_score_batched.launches
    if sk.shard_score.launches:
        fail(f"19b: the batched session launched shard_score "
             f"{sk.shard_score.launches} times")
    for k in range(K):
        if not torch.equal(packed[k].cpu(), solo[k]):
            fail(f"19b: session_batched instance {k}: the move log differs "
                 f"from its solo session's")
    if iters != solo_launches:
        fail(f"19b: per-instance iterations {iters}, the solo sessions "
             f"{solo_launches}")
    if launches != max(iters):
        fail(f"19b: {launches} batched launches for {max(iters)} iterations")
    loops = LoopLines()
    in_loop = {st: n for st, n in mon.sites.items() if loops.in_loop(*st)}
    stray = sorted(st for st in in_loop if not loops.suppressed(*st))
    loop_syncs = sum(in_loop.values())
    if stray or loop_syncs != max(iters):
        fail(f"19b: {loop_syncs} syncs from device-loop lines for "
             f"{max(iters)} iterations (unsuppressed: {stray}); "
             f"{mon.sites}")
    log(f"19b [{CARD}]: session_batched over 4 instances: every move log "
        f"equal to its solo session's ({[int(p[-1]) for p in solo]} moves); "
        f"iterations {iters}, {launches} shard_score_batched launches; "
        f"{loop_syncs} syncs from device-loop lines ("
        f"{loop_syncs / max(iters)} per iteration), {mon.total()} in all; "
        f"wall {wall} s against {solo_wall} s for the four solo sessions "
        f"({sum(solo_launches)} launches)")
    return dict(iterations=iters, launches=launches, wall=wall,
                solo_wall=solo_wall, loop_syncs=loop_syncs,
                syncs=mon.total())


def served_batching(batch, mode, sock_dir):
    """19c: four clients at once against a daemon with
    ``-serve-microbatch=4 -serve-admission-hold=4`` in ``mode``."""
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.serve import client

    sock = os.path.join(sock_dir, f"{mode}.sock")
    d, t, rc_box, logs = serving_daemon(sock, microbatch=4, admission_hold=4,
                                        batch_mode=mode)
    if not d._warm_done.wait(240):
        fail(f"19c {mode}: the daemon never finished its warm body")
    d._coalescer._hold_window_s = 120.0
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    t0 = time.perf_counter()
    procs = [start_client(["-input-json", "-input", pk] + batch["fused_args"]
                          + [f"-serve-socket={sock}"])
             for pk in batch["paths"]]
    results = finish_clients(procs, t0, f"19c {mode} client")
    all_wall = time.perf_counter() - t0
    solo_n = sk.shard_score.launches
    fused_n = sk.shard_score_batched.launches
    st = client.fetch_stats(sock) or {}
    for k, res in enumerate(results):
        if res[1] != batch["wants"][k]:
            fail(f"19c {mode}: client {k}'s plan differs from its cluster's "
                 f"in-process plan")
    if (st.get("microbatched") != 4 or st.get("mb_occupancy") != {"4": 1}
            or st.get("mb_padded_slots") != 0
            or st.get("batch_mode") != mode):
        fail(f"19c {mode}: the four requests did not fuse in one round: "
             f"microbatched {st.get('microbatched')}, occupancy "
             f"{st.get('mb_occupancy')}, padded {st.get('mb_padded_slots')}")
    if solo_n or not 0 < fused_n <= max(batch["k1_solo"]):
        fail(f"19c {mode}: shard_score {solo_n} and shard_score_batched "
             f"{fused_n} launches; the longest member's solo run had "
             f"{max(batch['k1_solo'])}")
    walls = [r[3] for r in results]
    log(f"19c [{CARD}]: {mode}: four concurrent clients, each plan equal to "
        f"its in-process plan; one fused round of 4 (stats microbatched 4, "
        f"occupancy {{'4': 1}}, padded 0); {fused_n} shard_score_batched "
        f"launches and no solo launch, against the longest member's "
        f"{max(batch['k1_solo'])} and {sum(batch['k1_solo'])} for all four "
        f"in process; client walls {walls} s (all four in {all_wall} s; "
        f"13e with the defaults: {batch['walls']} s)")
    stop_daemon(sock, d, t, rc_box, logs, 4, {"session_absent": 4},
                f"(19c {mode})")
    return dict(launches=fused_n, walls=walls, all_wall=all_wall)


def phase_batching(dev, batch):
    """Phase 19: cross-request fusion on the card (see the module
    docstring); returns the K1 timings and each path's launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    loaded = [batch_session_inputs(p, dev) for p in batch["paths"]]
    ins = [x[0] for x in loaded]
    knobs = [x[1] for x in loaded]
    shapes = {tuple(i[2].shape) for i in ins}
    if len(shapes) != 1:
        fail(f"19: the four clusters fall in different buckets: {shapes}")
    k1 = check_k1_batched([first_pass_args(i) for i in ins])
    sess = check_session_batched(ins, knobs)
    del ins, loaded
    sock_dir = tempfile.mkdtemp(prefix="kbt-")
    try:
        served = {mode: served_batching(batch, mode, sock_dir)
                  for mode in ("continuous", "oneshot")}
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    log(f"19: phase 19 took {time.perf_counter() - t_phase} s")
    return dict(k1=k1, session=sess, served=served)


# phase 20: the shared residency pool (serve/residency.py) and the lane's
# stage-ahead pipeline on the card, through a daemon with -serve's
# defaults (one lane, the lane scheduler)


def copy_overlap(events):
    """From a CUDA-activity trace: ``(copies on streams that ran no
    kernel, their summed ms, the ms of them inside a kernel interval of
    another stream, the copy streams, the kernel streams)``."""
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    kstreams = {ev.get("args", {}).get("stream") for ev in kernels}
    copies = [ev for ev in events if ev.get("cat") == "gpu_memcpy"
              and ev.get("args", {}).get("stream") not in kstreams]
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                   for ev in kernels)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = inside = 0.0
    for ev in copies:
        a, b = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        total += b - a
        inside += sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)
    cstreams = {ev.get("args", {}).get("stream") for ev in copies}
    return len(copies), total / 1e3, inside / 1e3, cstreams, kstreams


def pooled_digest(t):
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(t.detach().cpu().numpy())
    return hashlib.md5(a.reshape(-1).view(np.uint8)).digest()


def phase_residency(path, pallas_plan, batch):
    """Phase 20 (see the module docstring); returns the K1 and B2
    launches of its paths and its readings."""
    import shutil
    import tempfile
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.serve import client
    from kafkabalancer_tpu_torch.serve.residency import DEFAULT_POOL_CAP
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    t_phase = time.perf_counter()
    sock_dir = tempfile.mkdtemp(prefix="kbt-")
    work = tempfile.mkdtemp(prefix="kbt-prof-")
    try:
        sock = os.path.join(sock_dir, "r.sock")
        d, t, rc_box, logs = serving_daemon(sock, microbatch=4)
        if not d._warm_done.wait(240):
            fail("20: the daemon never finished its warm body")
        sched = d._coalescer
        if len(d._lanes) != 1 or not hasattr(sched, "lanes"):
            fail(f"20: -serve's defaults did not give one lane of the lane "
                 f"scheduler: {logs}")
        lane = d._lanes[0]
        pool = lane.stage_cache
        # the pool's traffic: lookups (thread, key, hit), puts (thread,
        # key, pinned)
        looks, puts = [], []
        lookup0, put0 = pool.lookup, pool.put

        def lookup(key, retain=True):
            buf = lookup0(key, retain)
            looks.append((threading.current_thread().name, key,
                          buf is not None))
            return buf

        def put(key, buf, retain=True, fence=None):
            puts.append((threading.current_thread().name, key, retain))
            put0(key, buf, retain, fence)

        pool.lookup, pool.put = lookup, put
        # the lane's turn after cluster 1 ends once clusters 2 and 3 are
        # queued and the stage of the one staged at submit has finished
        handle0 = sched._handle
        held = []
        holding = threading.Event()

        def handle(req, coalesced, ln, mb):
            handle0(req, coalesced, ln, mb)
            if held or holding.is_set():
                return
            holding.set()
            t_hold = time.perf_counter()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not (
                len(sched._queues[ln.index]) >= 2 and len(ln.stage_log) >= 1
            ):
                time.sleep(0.005)
            held.append(time.perf_counter() - t_hold)

        sched._handle = handle
        args = batch["fused_args"] + [f"-serve-socket={sock}"]
        paths, wants = batch["paths"], batch["wants"]
        snap0 = obs.metrics.snapshot()["counters"]

        # 20a
        sk.shard_score.launches = 0
        sk.shard_score_batched.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p1 = start_client(["-input-json", "-input", paths[0]] + args)
            # clusters 2 and 3 start once cluster 1 runs its session (or
            # has ended and holds the lane)
            while not (sk.shard_score.launches or holding.is_set()):
                if time.perf_counter() - t0 > 120 or p1.poll() is not None:
                    break
                time.sleep(0.002)
            t1 = time.perf_counter()
            procs = [start_client(["-input-json", "-input", pk] + args)
                     for pk in paths[1:3]]
            r1 = finish_client(p1, t0, "20a cluster 1")
            pair = finish_clients(procs, t1, "20a cluster")
            torch.cuda.synchronize()
        k1_a = sk.shard_score.launches + sk.shard_score_batched.launches
        if k1_a <= 0:
            fail("20a: the served -fused requests launched no K1")
        for k, res in enumerate([r1] + pair):
            if res[1] != wants[k]:
                fail(f"20a: cluster {k + 1}'s served plan differs from 13e's")
        snap1 = obs.metrics.snapshot()["counters"]
        staged_reqs = (snap1.get("serve.staged_requests", 0)
                       - snap0.get("serve.staged_requests", 0))
        staged = [(n, key) for n, key, pinned in puts if not pinned]
        staged_keys = {key for _n, key in staged}
        fails = snap1.get("serve.stage_failures", 0)
        if staged_reqs <= 0 or not staged or fails:
            fail(f"20a: {staged_reqs} staged requests, {len(staged)} staged "
                 f"arrays, {fails} stage failures (hold {held})")
        staged_looks = [(n, h) for n, key, h in looks if key in staged_keys]
        looked = {key for _n, key, _h in looks if key in staged_keys}
        staged_misses = [n for n, h in staged_looks if not h]
        if staged_misses or looked != staged_keys:
            fail(f"20a: the staged request's dispatch missed its staged "
                 f"arrays: {len(staged_misses)} misses, "
                 f"{len(staged_keys - looked)} of {len(staged_keys)} never "
                 f"looked up")
        recs = list(lane.stage_log)
        copy_ms = [r["start"].elapsed_time(r["end"]) for r in recs
                   if r.get("start") is not None]
        staged_bytes = sum(r["bytes"] for r in recs)
        ppath = os.path.join(work, "20a.json")
        prof.export_chrome_trace(ppath)
        with open(ppath) as fh:
            events = [ev for ev in json.load(fh)["traceEvents"]
                      if ev.get("ph") == "X"]
        n_copies, prof_copy_ms, overlap_ms, cstreams, kstreams = copy_overlap(
            events)
        if n_copies and n_copies != len(staged):
            fail(f"20a: {n_copies} copies on kernel-free streams in the "
                 f"profile, {len(staged)} arrays staged")
        overlap = ("not measured (no CUDA activity in the profile)"
                   if not events else
                   f"{overlap_ms} ms of the copy stream's {prof_copy_ms} ms "
                   f"({n_copies} copies on stream {sorted(cstreams)}) inside "
                   f"kernels of stream {sorted(kstreams)}")
        walls = [res[3] for res in pair]
        log(f"20a [{CARD}]: clusters 1-3 served, each plan equal to 13e's; "
            f"{staged_reqs} staged request, {len(staged)} arrays "
            f"({staged_bytes} bytes) staged by "
            f"{sorted({n for n, _k in staged})}, every one of its "
            f"{len(staged_looks)} lookups a hit; the staged copies' device "
            f"time {copy_ms} ms (events on the copy stream); overlap: "
            f"{overlap}; lane held {held} s after cluster 1; K1 launches "
            f"{k1_a} (shard_score + shard_score_batched); client walls of "
            f"clusters 2 and 3 {walls} s under the CUDA-activity profiler "
            f"(13e's four: {batch['walls']} s); cluster 1 {r1[3]} s")

        # 20b
        one = ["-input-json", "-input", paths[0]] + args
        n0 = len(looks)
        _rc, out1, _e, wall1, _r = run_client(one, "20b first")
        n1 = len(looks)
        mpath = os.path.join(work, "20b.json")
        _rc, out2, _e, wall2, _r = run_client(
            one + [f"-metrics-json={mpath}"], "20b second")
        first = {key for _n, key, _h in looks[n0:n1]}
        second = looks[n1:]
        if out1 != wants[0] or out2 != wants[0]:
            fail("20b: cluster 1's repeated plan differs from 13e's")
        misses = [key for _n, key, h in second if not h]
        if not first or misses or not first <= {k for _n, k, _h in second}:
            fail(f"20b: the repeat missed {len(misses)} of {len(second)} "
                 f"lookups (the first request looked up {len(first)})")
        log(f"20b [{CARD}]: cluster 1 twice: the second request hit all "
            f"{len(second)} of its lookups, every array the first looked up "
            f"({len(first)}); client walls {wall1} s, {wall2} s")

        # 20c
        with open(mpath) as fh:
            gauges = json.load(fh)["gauges"]
        st = client.fetch_stats(sock) or {}
        mem = (st.get("memory") or [{}])[0]
        tensors = pool.items()
        held_bytes = sum(x.numel() * x.element_size() for _k, x in tensors)
        if (set(st.get("residency") or {}) != {"hits", "misses"}
                or mem.get("residency_bytes") != held_bytes
                or mem.get("residency_entries") != len(tensors)
                or len(tensors) > DEFAULT_POOL_CAP
                or "serve.residency_hits" not in gauges
                or "serve.residency_bytes" not in gauges):
            fail(f"20c: residency {st.get('residency')}, memory {mem} "
                 f"against {held_bytes} bytes in {len(tensors)} entries, "
                 f"gauges {sorted(k for k in gauges if 'residency' in k)}")
        log(f"20c [{CARD}]: stats residency {st['residency']}, memory "
            f"residency_bytes {mem['residency_bytes']} = the pooled tensors' "
            f"bytes, residency_entries {mem['residency_entries']} (cap "
            f"{DEFAULT_POOL_CAP}); the request line's serve.residency_hits "
            f"{gauges['serve.residency_hits']}, serve.residency_bytes "
            f"{gauges['serve.residency_bytes']}")

        # 20e
        ps.pallas_session.launches = 0
        _rc, out, _e, wall_e, _r = run_client(
            ["-input-json", "-input", path, "-fused", "-fused-batch=100",
             f"-max-reassign={MAIN_REASSIGN}", "-min-unbalance=1e-7",
             "-no-edge-cache", "-fused-engine=pallas",
             f"-serve-socket={sock}"], "20e pallas")
        b2_e = ps.pallas_session.launches
        if out != pallas_plan:
            fail("20e: the served -fused-engine=pallas plan differs from 13c's")
        if b2_e <= 0:
            fail(f"20e: {b2_e} pallas_session launches")
        log(f"20e [{CARD}]: -fused-engine=pallas through the pooled lane: "
            f"13c's plan, {b2_e} pallas_session launch, client wall {wall_e} s")

        # 20d
        changed = [key[:2] for key, x in pool.items()
                   if pooled_digest(x) != key[2]]
        if changed:
            fail(f"20d: {len(changed)} pooled tensors were written: {changed}")
        log(f"20d [{CARD}]: all {len(pool)} pooled tensors still hold the "
            f"bytes their keys digest ({pool.device_bytes()} bytes); pool "
            f"stats {pool.stats()}")
        reasons = set(d._fallbacks)
        if not reasons <= {"session_absent", "session_digest_mismatch"}:
            fail(f"20: daemon-side fallbacks {d._fallbacks}")
        stop_daemon(sock, d, t, rc_box, logs, 6, dict(d._fallbacks), "(20)")
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    log(f"20: phase 20 took {time.perf_counter() - t_phase} s")
    return dict(k1=k1_a, b2=b2_e, copy_ms=copy_ms, bytes=staged_bytes,
                overlap_ms=overlap_ms, walls=walls)


# phase 21: the kinds the daemon fuses besides the plain move session —
# the colocation objective (K1's colocation variant over the instance
# axis), -fused-batch=1 and the polish alternation — on four config-4b
# clusters (seeds COLO_SEED + k) and 13e's four clusters
# 21b's batch-1 sessions run at most this many moves each
B1_CAP = 256


def colo_cluster_paths():
    """Config 4b's cluster at seeds COLO_SEED .. COLO_SEED + 3 (the first
    is phase 9's), one file each."""
    from kafkabalancer_tpu_torch.codecs import write_partition_list
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    paths = []
    for k in range(4):
        pk = os.path.join("chiprun_out", f"smoke_colo_{k}.json")
        with open(pk, "w") as fh:
            write_partition_list(fh, synth_cluster(
                *MAIN_SHAPE, rf=3, seed=COLO_SEED + k, weighted=True,
                zipf_topics=True))
        paths.append(pk)
    return paths


def kind_session_inputs(path, dev, min_unbalance, allow_leader):
    """One cluster file's settled first-chunk session inputs on the card:
    the 11 tensors of ``scan.session``, ``(min_replicas, min_unbalance,
    budget, max_moves)``, the topic ids with their bucket, and the polish
    entry table."""
    import torch

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.models.config import default_dtype
    from kafkabalancer_tpu_torch.ops.cost import broker_loads
    from kafkabalancer_tpu_torch.ops.runtime import next_bucket
    from kafkabalancer_tpu_torch.ops.tensorize import (
        all_allowed_of,
        tensorize,
        to_device,
    )
    from kafkabalancer_tpu_torch.solvers import polish, scan

    with open(path) as fh:
        pl = get_partition_list_from_reader(fh, True)
    cfg = default_rebalance_config()
    cfg.min_unbalance = min_unbalance
    cfg.allow_leader_rebalancing = allow_leader
    _rep, budget = scan._settle_head(pl, cfg, MAIN_REASSIGN)
    dp = tensorize(pl, cfg)
    dt = default_dtype(dev)
    d = to_device(dp, dev, dt, all_allowed=all_allowed_of(dp))
    loads = broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons,
                         dp.bvalid.shape[0])
    always = torch.from_numpy(scan._cfg_broker_mask(dp, cfg)).to(dev)
    chunk = min(budget, scan.auto_chunk_moves(len(pl.partitions)))
    ew, ep, er, ev = polish.entry_table(dp, cfg.min_replicas_for_rebalancing)
    return dict(
        t=(loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
           d.nrep_tgt, d.ncons, d.pvalid, always, d.bvalid),
        knobs=(cfg.min_replicas_for_rebalancing, cfg.min_unbalance, chunk,
               next_bucket(chunk, 128)),
        tid=torch.from_numpy(dp.topic_id).to(dev, torch.long),
        n_topics=next_bucket(max(1, len(dp.topics)), 64),
        table=(torch.from_numpy(ew).to(dev, dt),
               torch.from_numpy(ep).to(dev, torch.long),
               torch.from_numpy(er).to(dev, torch.long),
               torch.from_numpy(ev).to(dev)),
    )


def stack_of(xs):
    import torch

    return [None if xs[0][j] is None else torch.stack([x[j] for x in xs])
            for j in range(len(xs[0]))]


def sync_report(mon, what, iterations):
    """The syncs of a monitored run from device-loop lines; a sync from an
    unsuppressed device-loop line fails the run."""
    loops = LoopLines()
    in_loop = {st: n for st, n in mon.sites.items() if loops.in_loop(*st)}
    stray = sorted(st for st in in_loop if not loops.suppressed(*st))
    loop_syncs = sum(in_loop.values())
    if stray:
        fail(f"21b {what}: syncs from unsuppressed device-loop lines {stray} "
             f"({mon.sites})")
    return loop_syncs, loop_syncs / max(iterations, 1)


def check_kind_session(name, ins, batch, colo, cap=None):
    """21b: ``session_batched`` at ``batch`` (colocation mode with
    ``colo``) over the four instances against four solo sessions, byte
    for byte, the batched run under the sync monitor."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import scan

    K = len(ins)
    budgets = [x["knobs"][2] if cap is None else min(cap, x["knobs"][2])
               for x in ins]
    mm = max(x["knobs"][3] for x in ins)
    lams = [COLO_LAM] * K
    nts = {x["n_topics"] for x in ins}
    if colo and len(nts) != 1:
        fail(f"21b {name}: the clusters fall in different topic buckets {nts}")
    nt = nts.pop()
    solo, solo_launches, solo_wall = [], [], 0.0
    for k in range(K):
        ck = dict(topic_id=ins[k]["tid"], lam=lams[k], n_topics=nt) \
            if colo else {}
        sk.shard_score.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _r, _l, n, mp, msl, _ms, mt, _su = scan.session(
            *ins[k]["t"], ins[k]["knobs"][0], ins[k]["knobs"][1], budgets[k],
            max_moves=mm, allow_leader=True, batch=batch, **ck)
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo.append(torch.cat([mp, msl, mt, torch.tensor(
            [n], dtype=torch.int32, device=mp.device)]).cpu())
        solo_launches.append(sk.shard_score.launches)
    kw = dict(topic_id=torch.stack([x["tid"] for x in ins]), lam=lams,
              n_topics=nt) if colo else {}
    st = stack_of([x["t"] for x in ins])
    mon = SyncMonitor()
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    t0 = time.perf_counter()
    packed, iters, _secs = mon.run(lambda: scan.session_batched(
        *st, [x["knobs"][0] for x in ins], [x["knobs"][1] for x in ins],
        budgets, max_moves=mm, allow_leader=True, batch=batch, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.shard_score_batched.launches
    if sk.shard_score.launches:
        fail(f"21b {name}: the batched session launched shard_score "
             f"{sk.shard_score.launches} times")
    for k in range(K):
        if not torch.equal(packed[k].cpu(), solo[k]):
            fail(f"21b {name}: session_batched instance {k}: the move log "
                 f"differs from its solo session's")
    want = max(iters) if batch > 1 else 0
    if launches != want or (batch == 1 and any(solo_launches)):
        fail(f"21b {name}: {launches} batched launches for {max(iters)} "
             f"iterations (solo {solo_launches})")
    loop_syncs, per_it = sync_report(mon, name, max(iters))
    if loop_syncs != max(iters):
        fail(f"21b {name}: {loop_syncs} syncs from device-loop lines for "
             f"{max(iters)} iterations; {mon.sites}")
    moves = [int(p[-1]) for p in solo]
    log(f"21b [{CARD}]: {name}: session_batched over 4 instances at batch "
        f"{batch}{' (move cap %d)' % cap if cap else ''}: every move log "
        f"equal to its solo session's ({moves} moves); iterations {iters}, "
        f"{launches} shard_score_batched launches against "
        f"{sum(solo_launches)} solo ({solo_launches}); {loop_syncs} syncs "
        f"from device-loop lines ({per_it} per iteration), {mon.total()} in "
        f"all; wall {wall} s against {solo_wall} s for the four solo "
        f"sessions")
    return dict(iterations=iters, launches=launches, solo=solo_launches,
                wall=wall, solo_wall=solo_wall, syncs_per_iteration=per_it,
                moves=moves)


def check_headline_batched(ins):
    """21b: ``converge_session_batched`` with the headline flags over
    13e's four clusters against four solo ``converge_session`` calls,
    byte for byte, the batched run under the sync monitor."""
    import torch

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.solvers import polish

    K = len(ins)
    shapes = {tuple(x["table"][0].shape) for x in ins}
    if len(shapes) != 1:
        fail(f"21b headline: the entry tables differ in size {shapes}")
    mm = max(x["knobs"][3] for x in ins)
    solo, solo_launches, solo_wall, phases = [], [], 0.0, []
    for k in range(K):
        t = ins[k]["t"]
        sk.shard_score.launches = 0
        before = counters("polish.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo.append(polish.converge_session(
            t[0], t[1], t[3], *t[4:11], *ins[k]["knobs"][:3],
            *ins[k]["table"], max_moves=mm, allow_leader=True,
            batch=100).cpu())
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo_launches.append(sk.shard_score.launches)
        phases.append({n: v - before.get(n, 0.0)
                       for n, v in counters("polish.").items()
                       if not n.endswith("_seconds")})
    st = stack_of([x["t"] for x in ins])
    table = stack_of([x["table"] for x in ins])
    mon = SyncMonitor()
    sk.shard_score.launches = 0
    sk.shard_score_batched.launches = 0
    t0 = time.perf_counter()
    packed, cnt = mon.run(lambda: polish.converge_session_batched(
        st[0], st[1], st[3], *st[4:11], *(
            [x["knobs"][j] for x in ins] for j in range(3)),
        *table, max_moves=mm, allow_leader=True, batch=100))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.shard_score_batched.launches
    if sk.shard_score.launches:
        fail(f"21b headline: the batched alternation launched shard_score "
             f"{sk.shard_score.launches} times")
    for k in range(K):
        if not torch.equal(packed[k].cpu(), solo[k]):
            fail(f"21b headline: converge_session_batched instance {k}: the "
                 f"move log differs from its solo alternation's")
        mine = {n: v for n, v in cnt[k].items()
                if n.startswith("polish.") and not n.endswith("_seconds")}
        if mine != phases[k]:
            fail(f"21b headline: instance {k}'s phase counts {mine}, its "
                 f"solo alternation's {phases[k]}")
    if not max(solo_launches) <= launches <= sum(solo_launches):
        fail(f"21b headline: {launches} batched launches against the solo "
             f"alternations' {solo_launches}")
    passes = max(c["solver.session_iterations"] + c["polish.swap_iterations"]
                 + c["polish.shuffle_iterations"] for c in cnt)
    loop_syncs, per_it = sync_report(mon, "headline", passes)
    moves = [int(p[-1]) for p in solo]
    log(f"21b [{CARD}]: headline (-fused-batch=100 -allow-leader "
        f"-fused-polish): converge_session_batched over 4 instances: every "
        f"packed log equal to its solo alternation's ({moves} moves), each "
        f"instance's phase counts its own ({phases}); {launches} "
        f"shard_score_batched launches against {sum(solo_launches)} solo "
        f"({solo_launches}); {loop_syncs} syncs from device-loop lines over "
        f"at most {passes} passes ({per_it} per pass), {mon.total()} in all; "
        f"wall {wall} s against {solo_wall} s for the four solo "
        f"alternations")
    return dict(launches=launches, solo=solo_launches, wall=wall,
                solo_wall=solo_wall, syncs_per_pass=per_it, moves=moves)


def in_process_plans(paths, flags):
    """Each cluster's ``-no-daemon`` plan in this process: ``(plans,
    K1 launches, chunks, walls)``."""
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    if obs.shared_registry():
        fail("21c: the registry is still shared (a daemon left it so)")
    plans, k1, chunks, walls = [], [], [], []
    for pk in paths:
        sk.shard_score.launches = 0
        # cli.run resets the registry: its counters are this run's
        rc, out, err, wall = run_cli(["-input-json", "-input", pk] + flags
                                     + ["-no-daemon"])
        if rc != 0:
            fail(f"21c: in-process {pk} returned {rc}: {err[-2000:]}")
        plans.append(out)
        k1.append(sk.shard_score.launches)
        chunks.append(int(counters("solver.chunks").get("solver.chunks", 0)))
        walls.append(wall)
    return plans, k1, chunks, walls


def expected_rounds(chunks):
    """The fused rounds four members with these chunk counts make: each
    round holds the members with a chunk left; a round of one runs solo.
    Returns ``(microbatched, occupancy histogram)``."""
    hist = {}
    for r in range(max(chunks)):
        occ = sum(1 for c in chunks if c > r)
        if occ > 1:
            hist[str(occ)] = hist.get(str(occ), 0) + 1
    return sum(int(k) * v for k, v in hist.items()), hist


def served_kinds(mode, sock_dir, kinds):
    """21c: a hold-4 daemon in ``mode``; four clients of each kind at
    once, one kind after the other."""
    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
    from kafkabalancer_tpu_torch.serve import client

    sock = os.path.join(sock_dir, f"k21-{mode}.sock")
    d, t, rc_box, logs = serving_daemon(sock, microbatch=4, admission_hold=4,
                                        batch_mode=mode)
    if not d._warm_done.wait(240):
        fail(f"21c {mode}: the daemon never finished its warm body")
    d._coalescer._hold_window_s = 120.0
    out, sent = {}, 0
    st0 = client.fetch_stats(sock) or {}
    for name, kind in kinds.items():
        sk.shard_score.launches = 0
        sk.shard_score_batched.launches = 0
        t0 = time.perf_counter()
        procs = [start_client(["-input-json", "-input", pk] + kind["flags"]
                              + [f"-serve-socket={sock}"])
                 for pk in kind["paths"]]
        results = finish_clients(procs, t0, f"21c {mode} {name} client")
        all_wall = time.perf_counter() - t0
        sent += len(procs)
        solo_n, fused_n = sk.shard_score.launches, sk.shard_score_batched.launches
        st = client.fetch_stats(sock) or {}
        for k, res in enumerate(results):
            if res[1] != kind["wants"][k]:
                fail(f"21c {mode} {name}: client {k}'s plan differs from its "
                     f"-no-daemon plan")
        mb = st.get("microbatched", 0) - st0.get("microbatched", 0)
        occ0 = st0.get("mb_occupancy") or {}
        occ = {k: v - occ0.get(k, 0)
               for k, v in (st.get("mb_occupancy") or {}).items()
               if v - occ0.get(k, 0)}
        want_mb, want_occ = expected_rounds(kind["chunks"])
        if (mb, occ) != (want_mb, want_occ) or st.get("mb_padded_slots"):
            fail(f"21c {mode} {name}: microbatched {mb}, occupancy {occ} "
                 f"(padded {st.get('mb_padded_slots')}); the members' chunks "
                 f"{kind['chunks']} make {want_mb}, {want_occ}")
        walls = [r[3] for r in results]
        log(f"21c [{CARD}]: {mode}: four concurrent {name} clients "
            f"({' '.join(kind['flags'])}), each plan equal to its -no-daemon "
            f"plan; microbatched {mb}, occupancy {occ}, padded 0; "
            f"shard_score_batched {fused_n} and shard_score {solo_n} launches "
            f"against {sum(kind['k1'])} in process ({kind['k1']}); client "
            f"walls {walls} s (all four in {all_wall} s), the four in "
            f"process one after another {kind['walls']} s ("
            f"{sum(kind['walls'])} s)")
        out[name] = dict(launches=fused_n, solo_launches=solo_n, walls=walls,
                         all_wall=all_wall, microbatched=mb, occupancy=occ)
        st0 = st
    stop_daemon(sock, d, t, rc_box, logs, sent, {"session_absent": sent},
                f"(21c {mode})")
    return out


def phase_fused_kinds(dev, batch):
    """Phase 21 (see the module docstring): the batched K1 colocation
    variant, the three batched sessions and the served rounds; returns
    the readings and each path's launches."""
    import shutil
    import tempfile

    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader

    t_phase = time.perf_counter()
    colo_paths = colo_cluster_paths()
    per = []
    for pk in colo_paths:
        with open(pk) as fh:
            per.append(capture_colo_inputs(
                get_partition_list_from_reader(fh, True), dev))
    if len({tuple(a[11].shape) for a in per}) != 1:
        fail("21a: the four config-4b clusters fall in different buckets")
    k1 = check_k1_batched(per, colo=True)
    del per
    done21 = time.perf_counter()
    colo_ins = [kind_session_inputs(pk, dev, 1e-6, True) for pk in colo_paths]
    colo = check_kind_session("colocation (config 4b, batch 128, "
                              f"lambda {COLO_LAM})", colo_ins, 128, True)
    del colo_ins
    head_ins = [kind_session_inputs(pk, dev, 1e-7, True)
                for pk in batch["paths"]]
    b1 = check_kind_session("batch 1 (13e's clusters, -allow-leader)",
                            head_ins, 1, False, cap=B1_CAP)
    head = check_headline_batched(head_ins)
    del head_ins
    log(f"21b: took {time.perf_counter() - done21} s")
    head_flags = HEADLINE + ["-no-edge-cache"]
    colo_flags = COLO_FLAGS + ["-no-edge-cache"]
    kinds = {}
    for name, paths, flags in (("headline", batch["paths"], head_flags),
                               ("colocation", colo_paths, colo_flags)):
        plans, k1n, chunks, walls = in_process_plans(paths, flags)
        kinds[name] = dict(paths=paths, flags=flags, wants=plans, k1=k1n,
                           chunks=chunks, walls=walls)
    sock_dir = tempfile.mkdtemp(prefix="kbt-")
    try:
        served = {mode: served_kinds(mode, sock_dir, kinds)
                  for mode in ("continuous", "oneshot")}
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    log(f"21: phase 21 took {time.perf_counter() - t_phase} s")
    return dict(k1=k1, colo=colo, b1=b1, head=head, served=served)


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
    global CARD
    CARD = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"nvidia-smi: {smi.stderr.strip()}")
    log(CARD)
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
    b2_launches, pallas_plan = phase_pallas_path(dev, xla_plan, cluster_path)
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

    # phase 13: the planning daemon, each served path's counts zeroed just
    # before it
    serve_launches, loop13_walls, batch13 = phase_serve(
        cluster_path, xla_plan, launches, pallas_plan, b2_launches)
    done(13)

    # phase 14: speculation, the edge cache, the warm tier and -watch;
    # the speculative and watch runs' launches counted by the daemon
    spec_made = phase_spec(cluster_path, xla_plan, loop13_walls)
    done(14)

    # phase 15: the telemetry exporters, -explain, the device profiler, a
    # fresh process's spans, prewarm, the scrape verbs, the cache rebuild
    tel = phase_telemetry(dev, cluster_path, xla_plan, pallas_plan)
    done(15)

    # phase 16: the replay harness's four modes against spawned daemons
    phase_replay()
    done(16)

    # phase 17: two processes on the one card; each rank's counts zeroed
    # just before its plan_sharded run
    dist_launches = phase_distributed(dev, cluster_path, xla_plan)
    done(17)

    # phase 18: the static analyzer from the checkout, then phase 3's and
    # 3b's paths under the sync monitor, counts zeroed just before each
    phase_analyzer()
    syncs = phase_sync_monitor(cluster_path, xla_plan, pallas_plan)
    done(18)

    # phase 19: cross-request fusion on phase 13e's clusters, each path's
    # counts zeroed just before it
    fusion = phase_batching(dev, batch13)
    done(19)

    # phase 20: the residency pool and the stage-ahead pipeline on 13e's
    # clusters, each path's counts zeroed just before it
    resid = phase_residency(cluster_path, pallas_plan, batch13)
    done(20)

    # phase 21: the colocation, batch-1 and polish kinds fused, on config
    # 4b's clusters and 13e's, each path's counts zeroed just before it
    kinds21 = phase_fused_kinds(dev, batch13)
    done(21)

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
            "13b: served -fused -fused-batch=100": serve_launches["fused"],
            "13e: four concurrent served 10k x 100 -fused requests "
            "(-serve-microbatch=4; the requests that ran solo)":
                serve_launches["concurrent"],
            "14a: speculative runs of the -fused -max-reassign=1 loop":
                spec_made["14a"].get("shard_score", 0),
            "14f: -watch runs": spec_made["14f"]["watch"].get(
                "shard_score", 0),
            "14f: speculative runs under -watch": spec_made["14f"][
                "spec"].get("shard_score", 0),
            "15a: -fused -fused-batch=100 with every telemetry flag and "
            "-jax-profile": tel["15a"]["launches"],
            "17: plan_sharded over 2 processes (per rank)": dist_launches[0],
            "18b: -fused -fused-batch=100 under the sync monitor":
                syncs["k1"]["launches"],
            "20a: three served 10k x 100 -fused requests through the "
            "pooled lane, one staged (shard_score + shard_score_batched)":
                resid["k1"],
        },
        "syncs_per_iteration_18b": syncs["k1"]["loop_syncs"] / max(
            syncs["k1"]["iterations"], 1),
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
            "13c: served -fused -fused-engine=pallas": serve_launches["pallas"],
            "14b: speculative runs of the -fused-engine=pallas loop":
                spec_made["14b"].get("pallas_session", 0),
            "15b: -fused-engine=pallas with every telemetry flag and "
            "-jax-profile": tel["15b"]["launches"],
            "18b: -fused -fused-engine=pallas under the sync monitor":
                syncs["b2"]["launches"],
            "20e: served -fused-engine=pallas through the pooled lane":
                resid["b2"],
        },
        "syncs_per_iteration_18b": syncs["b2"]["syncs"] / max(
            syncs["b2"]["iterations"], 1),
        "max_abs_err": b2_t["max_abs_err"],
        "ms": b2_t["ms"],
        "plain_ms": b2_t["plain_ms"],
        "bound_ms": b2_t["bound_ms"],
        "bound_by": b2_t["bound_by"],
        "library_ms": None,
        "split": {"10k x 100": b2_t["split"],
                  "131072 x 256": b2_scale["split"]},
    }, {
        "name": "shard_score_batched",
        "route": "cuda",
        "source": "kafkabalancer_tpu_torch/csrc/shard_score.cu",
        "replaces": "kafkabalancer_tpu/parallel/shard_kernel.py:74",
        "launches": fusion["served"]["continuous"]["launches"],
        "launches_by_path": {
            "13e: four concurrent served 10k x 100 -fused requests "
            "(-serve-microbatch=4; the fused rounds)":
                serve_launches["concurrent_batched"],
            "19b: session_batched over four 10k x 100 instances":
                fusion["session"]["launches"],
            "19c: four served -fused clients, -serve-microbatch=4 "
            "-serve-admission-hold=4, continuous":
                fusion["served"]["continuous"]["launches"],
            "19c: the same, -serve-batch-mode=oneshot":
                fusion["served"]["oneshot"]["launches"],
            "21b: session_batched, colocation (config 4b), over four "
            "10k x 100 instances": kinds21["colo"]["launches"],
            "21b: session_batched at batch 1 over four 10k x 100 "
            "instances (no kernel)": kinds21["b1"]["launches"],
            "21b: converge_session_batched, headline flags, over four "
            "10k x 100 instances": kinds21["head"]["launches"],
            "21c: four served headline clients, continuous":
                kinds21["served"]["continuous"]["headline"]["launches"],
            "21c: four served headline clients, oneshot":
                kinds21["served"]["oneshot"]["headline"]["launches"],
            "21c: four served colocation clients, continuous":
                kinds21["served"]["continuous"]["colocation"]["launches"],
            "21c: four served colocation clients, oneshot":
                kinds21["served"]["oneshot"]["colocation"]["launches"],
        },
        "solo_launches_21b": {
            "colocation": kinds21["colo"]["solo"],
            "headline": kinds21["head"]["solo"],
        },
        "syncs_per_iteration_21b": {
            "colocation": kinds21["colo"]["syncs_per_iteration"],
            "batch 1": kinds21["b1"]["syncs_per_iteration"],
            "headline (per move iteration, swap or shuffle pass)":
                kinds21["head"]["syncs_per_pass"],
        },
        "colocation_batched_shapes": {
            f"K={K} x 10k x 100 (config 4b)": {
                k: v for k, v in kinds21["k1"][K].items()
                if k in ("ms", "solo_ms", "plain_ms", "bound_ms",
                         "bound_by")
            } for K in BATCH_KS
        },
        "syncs_per_iteration_19b": fusion["session"]["loop_syncs"] / max(
            max(fusion["session"]["iterations"]), 1),
        "batched_shapes": {
            f"K={K} x 10k x 100": {
                k: v for k, v in fusion["k1"][K].items()
                if k in ("ms", "solo_ms", "plain_ms", "bound_ms",
                         "bound_by")
            } for K in BATCH_KS
        },
        "max_abs_err": 0.0,
        "ms": fusion["k1"][4]["ms"],
        "plain_ms": fusion["k1"][4]["plain_ms"],
        "bound_ms": fusion["k1"][4]["bound_ms"],
        "bound_by": fusion["k1"][4]["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dist-worker"]:
            sys.exit(dist_worker(sys.argv[2:]))
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
