"""``python -m kafkabalancer_tpu_torch.prewarm`` — warm a process for a
shape grid.

The reference's prewarm (``kafkabalancer_tpu/prewarm.py``) compiles and
stores XLA executables ahead of time. This package has no executables to
store: its kernels are CUDA libraries in the nvcc cache (``ops/nvcc.py``),
and what a fresh process or daemon pays before its first plan is the
build (once per source digest), the library load, the CUDA context,
CUDA's lazily loaded modules and the caching allocator's first
allocations. This module pays all of them ahead of time: it builds and
loads both kernels, then runs one throw-away session per shape bucket of
the grid on a synthetic cluster (``utils/synth.py``): the torch session
with the scoring kernel (``-fused``), the whole-session kernel (on a card
only: it has no CPU kernel), and the per-move window scorer
(``-solver=tpu``). Nothing it plans is kept.

Typical use::

    # once per software roll, on the machine with the card: the nvcc
    # cache is then filled and checked
    python -m kafkabalancer_tpu_torch.prewarm -shapes 10000x100,50000x200 -verify
    # a daemon that warms the same grid before its first request
    python -m kafkabalancer_tpu_torch -serve -serve-prewarm=10000x100

``-verify`` holds each bucket's kernel sessions against their plain
versions (equal move logs) and checks each cached library against its
seal (ops/nvcc.py).
Prints one JSON summary line on stdout (per-entry detail on stderr);
exit 0 on success, 1 on a shape-grid argument error or a failed entry,
2 when no CUDA device is available (the programmatic seam takes
``device="cpu"``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

def _parse_shapes(spec: str) -> List[Tuple[int, int]]:
    shapes = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        p, _, b = tok.partition("x")
        shapes.append((int(p), int(b)))
    if not shapes:
        raise ValueError("empty shape grid")
    return shapes


def _sync(dev: Any) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _programs_for_shape(
    n_parts: int,
    n_brokers: int,
    ns: argparse.Namespace,
    dev: Any,
) -> List[Tuple[str, str, Callable[[], Any], Optional[Callable[[], Any]]]]:
    """``(name, bucket, run, plain)`` for every program this shape's
    invocations run: ``run`` runs it once on ``dev``, ``plain`` runs its
    plain version on the same inputs (None when the program has no
    kernel to hold against one)."""
    import numpy as np

    from kafkabalancer_tpu_torch.models import default_rebalance_config
    from kafkabalancer_tpu_torch.models.config import default_dtype, kernel_dtype
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize
    from kafkabalancer_tpu_torch.parallel.shard_kernel import shard_score_plain
    from kafkabalancer_tpu_torch.solvers import scan, tpu
    from kafkabalancer_tpu_torch.utils.synth import synth_cluster

    cfg = default_rebalance_config()
    cfg.allow_leader_rebalancing = ns.allow_leader
    cfg.min_unbalance = 0.0
    pl = synth_cluster(n_parts, n_brokers, rf=ns.rf, seed=42, weighted=True)
    # validations and defaults only (budget 0 skips the repairs): the
    # synthetic cluster is consistent, and nothing here is planned for use
    scan._settle_head(pl, cfg, 0)
    dp = tensorize(pl, cfg)
    bucket = "P{}xR{}xB{}".format(
        dp.replicas.shape[0], dp.replicas.shape[1], dp.bvalid.shape[0]
    )
    chunk = min(
        ns.max_reassign,
        max(1, min(scan.auto_chunk_moves(len(pl.partitions or [])), 1 << 20)),
    )
    batch = max(1, ns.batch)
    mode = "polish" if ns.polish else "move"
    out: List[Tuple[str, str, Callable[[], Any], Optional[Callable[[], Any]]]] = []

    def chunk_run(engine: str, dtype: Any, scorer: Any = None) -> Callable[[], Any]:
        def run() -> Any:
            packed = scan._run_chunk(
                dp, cfg, chunk, dtype, batch, dev, scorer, engine, mode=mode,
            )
            _sync(dev)
            return np.asarray(packed)

        return run

    if ns.fused:
        dtype = default_dtype(dev)
        out.append((
            "session_xla", bucket, chunk_run("xla", dtype),
            chunk_run("xla", dtype, shard_score_plain),
        ))
        if dev.type == "cuda":  # the whole-session kernel has no CPU kernel
            out.append((
                "session_pallas", bucket,
                chunk_run("pallas", kernel_dtype()),
                chunk_run("pallas-interpret", kernel_dtype()),
            ))
    if ns.single_move:
        def window() -> Any:
            # MoveLeaders precedes MoveNonLeaders in the pipeline
            for leaders in (True, False) if ns.allow_leader else (False,):
                try:
                    tpu.find_best_move(dp, cfg, leaders, device=dev)
                except tpu.TieOverflow:
                    pass  # the host scan answers such a move
            _sync(dev)

        out.append(("score_window", bucket, window, None))
    return out


def warm_store(
    shapes: str,
    *,
    batch: int = 100,
    polish: bool = False,
    allow_leader: bool = False,
    max_reassign: int = 1 << 19,
    rf: int = 3,
    single_move: bool = True,
    fused: bool = True,
    device: Any = None,
    verify: bool = False,
    details: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, int]:
    """Warm this process for a shape grid — the library seam behind
    ``-serve-prewarm`` (serve/daemon.py) and the counterpart of the
    reference's ``prewarm.warm_store``: on a CUDA ``device`` (the
    default) build and load both kernels, then run every program of
    every bucket once (:func:`_programs_for_shape`). ``verify`` also
    holds each kernel program against its plain version. Returns
    ``{"kernels", "warmed", "failed", "verified"}`` counts and appends
    one record per entry to ``details`` when given; a failed entry is
    counted, never raised (a warm failure costs latency on the first
    request, not availability; the request that needs a broken kernel
    fails on its own)."""
    import torch

    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.ops import nvcc
    from kafkabalancer_tpu_torch.ops.coldstart import KERNELS, load_kernel

    dev = torch.device("cuda" if device is None else device)
    counts = {"kernels": 0, "warmed": 0, "failed": 0, "verified": 0}
    ns = argparse.Namespace(
        rf=rf, max_reassign=max_reassign, batch=batch, polish=polish,
        allow_leader=allow_leader, single_move=single_move, fused=fused,
    )
    if dev.type == "cuda":
        with obs.span("prewarm.kernels"):
            for name in KERNELS:
                rec: Dict[str, Any] = {"kernel": name}
                try:
                    load_kernel(name)
                    counts["kernels"] += 1
                    rec["status"] = "loaded"
                    rec["path"] = nvcc.library_path(name + ".cu")
                    if verify:
                        # the cached bytes still match their seal
                        rec["verified"] = nvcc.intact(rec["path"])
                        counts["verified" if rec["verified"] else "failed"] += 1
                except Exception as exc:
                    counts["failed"] += 1
                    rec["status"] = f"failed: {exc}"
                if details is not None:
                    details.append(rec)
    for n_parts, n_brokers in _parse_shapes(shapes):
        with obs.span("prewarm.shape", shape=f"{n_parts}x{n_brokers}"):
            for name, bucket, run, plain in _programs_for_shape(
                n_parts, n_brokers, ns, dev
            ):
                rec = {"shape": f"{n_parts}x{n_brokers}", "bucket": bucket,
                       "name": name}
                t0 = time.perf_counter()
                try:
                    got = run()
                    rec["seconds"] = time.perf_counter() - t0
                    rec["status"] = "warmed"
                    counts["warmed"] += 1
                    if verify and plain is not None:
                        ok = bool((got == plain()).all())
                        rec["verified"] = ok
                        if ok:
                            counts["verified"] += 1
                        else:
                            counts["failed"] += 1
                except Exception as exc:
                    counts["failed"] += 1
                    rec["status"] = f"failed: {exc}"
                obs.metrics.count(f"prewarm.{rec['status'].split(':')[0]}")
                if details is not None:
                    details.append(rec)
    return counts


def run(argv: List[str], device: Any = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kafkabalancer_tpu_torch.prewarm",
        description="Build and load the kernels and run one throw-away "
        "session per shape bucket so a process starts warm.",
    )
    # single-dash long options, as the CLI's Go-style flags
    ap.add_argument(
        "-shapes", default="10000x100",
        help="comma-separated PARTITIONSxBROKERS grid (default %(default)s)",
    )
    ap.add_argument("-rf", type=int, default=3, help="replication factor")
    ap.add_argument(
        "-max-reassign", dest="max_reassign", type=int, default=1 << 19,
        help="session budget the throw-away session is sized for",
    )
    ap.add_argument("-batch", type=int, default=100)
    ap.add_argument("-polish", action="store_true")
    ap.add_argument("-allow-leader", dest="allow_leader", action="store_true")
    ap.add_argument(
        "-no-single-move", dest="single_move", action="store_false",
        help="skip the per-move window scorer",
    )
    ap.add_argument(
        "-no-fused", dest="fused", action="store_false",
        help="skip the fused sessions",
    )
    ap.add_argument(
        "-verify", action="store_true",
        help="hold every kernel session against its plain version and "
        "check every cached library against its seal",
    )
    ap.add_argument(
        "-stats", action="store_true",
        help="print a telemetry summary (spans, counters) to stderr when "
        "done",
    )
    ns = ap.parse_args(argv)
    from kafkabalancer_tpu_torch import obs

    obs.begin_invocation(enabled=ns.stats)
    try:
        _parse_shapes(ns.shapes)
    except ValueError as exc:
        print(f"bad -shapes: {exc}", file=sys.stderr)
        return 1

    import torch

    if device is None and not torch.cuda.is_available():
        print(
            "no CUDA device: nothing to prewarm (the kernels and the "
            "sessions warm on the card)",
            file=sys.stderr,
        )
        return 2
    dev = torch.device("cuda" if device is None else device)
    details: List[Dict[str, Any]] = []
    counts = warm_store(
        ns.shapes, batch=ns.batch, polish=ns.polish,
        allow_leader=ns.allow_leader, max_reassign=ns.max_reassign, rf=ns.rf,
        single_move=ns.single_move, fused=ns.fused, device=dev,
        verify=ns.verify, details=details,
    )
    for rec in details:
        what = rec.get("kernel") or f"{rec['shape']} {rec['name']}"
        print(
            f"prewarm {what}: {rec['status']}"
            + (f" verified={rec.get('verified')}" if ns.verify else ""),
            file=sys.stderr,
        )
    print(json.dumps({
        "device": str(dev),
        "entries": len(details),
        **counts,
        "keys": details,
    }))
    if ns.stats:
        from kafkabalancer_tpu_torch.obs import export as obs_export

        sys.stderr.write(obs_export.render_stats(obs.REGISTRY, obs.tracer))
    return 0 if counts["failed"] == 0 else 1


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
