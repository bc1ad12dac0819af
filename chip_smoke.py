"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card: ``nvidia-smi`` name and power limit, the torch device name;
   build every kernel of the main path from ``kafkabalancer_tpu_torch/
   csrc`` with nvcc (sm_90a) and print the build seconds.
2. Each kernel against its plain torch version on the card, on the
   inputs the main path gives it (captured from a one-iteration session)
   at the 10k x 100 bucket and at 131072 x 256, sweeping allow_leader,
   restricted ``allowed`` and the colocation counts. Tolerance: zero —
   all eight outputs equal under ``==``. Device times (CUDA events, L2
   flushed, the host's per-call cost kept out by a spin kernel), host
   times per call, the plain version's times and the bound.
3. The main path through the CLI: a 10k-partition x 100-broker synthetic
   cluster planned by ``kafkabalancer_tpu_torch.cli.run`` with
   ``-fused -fused-batch=100``; rc 0, a parseable plan, the kernel's
   launch count > 0, the final unbalance (host oracle) below the
   input's; then the same session with the plain scorer must emit the
   identical plan.
4. Scale: a 131072 x 256 cluster through ``plan`` for a bounded number of
   moves; time per session iteration.

The last two stdout lines are the kernels JSON line and
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


def capture_inputs(n_parts, n_brokers, dev):
    """The scoring kernel's inputs at the first iteration of the main
    path's session on a synthetic cluster (cloned at the call)."""
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
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=SEED, weighted=True)
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


def check_k1(base, label):
    """Phase 2 at one shape: every variant equal to the plain version;
    returns the timing of the main path's own variant."""
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


def phase_main_path(dev):
    """Phase 3: the CLI's -fused path on the card, then the same session
    with the plain scorer."""
    import torch

    from kafkabalancer_tpu_torch import cli, obs
    from kafkabalancer_tpu_torch.balancer.costmodel import (
        get_bl,
        get_broker_load,
        get_unbalance_bl,
    )
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

    def unbalance(p):
        return get_unbalance_bl(get_bl(get_broker_load(p)))

    u0 = unbalance(get_partition_list_from_reader(text, True))
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
    # the final assignment: the input with every emitted move applied
    final = get_partition_list_from_reader(text, True)
    by_key = {(p.topic, p.partition): p for p in final.partitions}
    for row in doc["partitions"]:
        by_key[(row["topic"], row["partition"])].replicas = list(row["replicas"])
    u1 = unbalance(final)
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
    return launches


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
    obs.begin_invocation()
    sk.shard_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opl = plan(pl, cfg, SCALE_MOVES, batch=128, device=dev)
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

    from kafkabalancer_tpu_torch.parallel import shard_kernel as sk

    # phase 1: build from the checkout's sources
    t0 = time.perf_counter()
    lib = sk.build(verbose=True)
    log(f"build: {lib} in {time.perf_counter() - t0} s")
    for line in sk.build_log.strip().splitlines():
        log(f"  nvcc: {line}")

    # phase 2: the kernel against its plain version at the main path's shapes
    main_t = check_k1(capture_inputs(*MAIN_SHAPE, dev), "10k x 100")
    check_k1(capture_inputs(*SCALE_SHAPE, dev), "131072 x 256")

    # phase 3: the main path, counts zeroed just before and read just after
    launches = phase_main_path(dev)

    # phase 4: scale
    phase_scale(dev)

    print(json.dumps({"kernels": [{
        "name": "shard_score",
        "route": "cuda",
        "source": "kafkabalancer_tpu_torch/csrc/shard_score.cu",
        "replaces": "kafkabalancer_tpu/parallel/shard_kernel.py:74",
        "launches": launches,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
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
