"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, in one fresh directory made with ``tempfile.mkdtemp`` under
``TMPDIR`` and removed at the end whatever happens:

1. starts the port's planning daemon in a thread of this process with the
   cell's flags (``-serve-prewarm`` of the configuration's shape), and
   meanwhile writes the run's fleet of distinct clusters, drawn from
   ``--seed``;
2. plays one round of the cell's clients, not counted, so that every
   shape the window uses has run once;
3. plays rounds for ``--seconds`` under the CUDA-only profiler (with the
   port's spans), counting whole rounds only; the device's busy time over
   the window's plans is the end-to-end ``device_ms_per_plan``, the same
   in both trace modes;
4. stops the daemon, then judges a sample of the window's plans with the
   plain reference (``correct.py``);
5. prints the compared numbers on standard error and, last on standard
   output, one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the end-to-end ones, or with ``--trace 1`` the per-layer
   ones), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.

It exits 2 without a CUDA card, and 1 when a module named ``jax``,
``jaxlib``, ``flax`` or ``kafkabalancer_tpu`` is loaded at the end.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Any, Callable, Dict, List, Optional, Sequence  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import correct, fleet, spec  # noqa: E402
from portbench.load import Clients, Plan, Round, client_env  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kafkabalancer_tpu")
# build and kernel caches of the program and its libraries: fixed
# directories inside the checkout, so that a checkout's later runs hit
CACHE = os.path.join(ROOT, ".portbench-cache")
# the first run in a checkout builds the kernels
WARM_TIMEOUT_S = 900.0
# the fleet's writers take seconds; a stuck one fails the run early
FLEET_TIMEOUT_S = 300.0


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's (compared whole: ``kafkabalancer_tpu_torch`` is not
    ``kafkabalancer_tpu``)."""
    tops = {n.split(".", 1)[0] for n in (names or list(sys.modules))}
    return sorted(t for t in tops if t in FORBIDDEN)


def quantile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def host_probe_ms() -> str:
    """Milliseconds that a fixed loop of plain Python takes, the least and
    the median of five: how fast the host runs this process's interpreter
    just now, and how much others take of it."""
    times = []
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(100000):
            acc += i * i
        times.append((time.perf_counter() - t) * 1000.0)
    times.sort()
    return f"{times[0]:.2f}/{times[2]:.2f}"


def device_ms_per_plan(trace: Any, plans: int) -> Optional[float]:
    """Milliseconds in which the card ran a kernel, a copy or a set in
    the window, over the plans the window completed; None with neither."""
    if not trace.ops or plans <= 0:
        return None
    return trace.busy_s * 1000.0 / plans


def host_times() -> Dict[str, Any]:
    """CPU seconds of this process (the daemon) and of its ended
    children (the clients), the load average, and the probe."""
    import resource

    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return {"cpu_s": me.ru_utime + me.ru_stime,
            "children_cpu_s": kids.ru_utime + kids.ru_stime,
            "loadavg_1m": os.getloadavg()[0], "probe_ms": host_probe_ms()}


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = os.path.join(CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def counters() -> Dict[str, float]:
    from kafkabalancer_tpu_torch import obs

    return dict(obs.REGISTRY.snapshot()["counters"])


def launches() -> Dict[str, int]:
    from kafkabalancer_tpu_torch.parallel import shard_kernel

    return {"shard_score": shard_kernel.shard_score.launches,
            "shard_score_batched": shard_kernel.shard_score_batched.launches}


def occupancy(s0: Dict[str, Any], s1: Dict[str, Any]) -> Optional[float]:
    """Mean members per fused round between two stats documents."""
    o0, o1 = s0.get("mb_occupancy") or {}, s1.get("mb_occupancy") or {}
    n = sum(v - o0.get(k, 0) for k, v in o1.items())
    m = sum(int(k) * (v - o0.get(k, 0)) for k, v in o1.items())
    return m / n if n > 0 else None


def run(argv: Sequence[str], *, device: Any = None,
        client_command: Optional[Sequence[str]] = None,
        cell: Optional[spec.Cell] = None,
        inspect: Optional[Callable[[List[Plan], List[str]], None]] = None,
        ) -> int:
    """The run; returns the exit code. The keywords are for the tests and
    ``control.py``: ``device`` a CPU daemon, ``client_command`` another
    client program, ``cell`` a cell of small sizes, ``inspect`` called
    with the window's plans and the clients' flags once they are judged,
    while their cluster files still exist."""
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cell or spec.Cell(spec.benchmark(), args.workload)
    set_cache_dirs()
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, device_count "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        kind = torch.cuda.get_device_name(0)
    else:
        kind = str(device)

    tr = cell.traffic
    cfg = cell.config
    n_clients = int(tr["clients"])
    n_fleet = int(tr["fleet"])
    flags = cell.client_flags()
    old_cwd = os.getcwd()
    rundir = tempfile.mkdtemp(prefix="portbench-")
    # the daemon and the clients share this directory as their working
    # directory, so that the socket's path stays short whatever TMPDIR is
    os.chdir(rundir)
    sock = "d.sock"
    fleet_dir = os.path.join(rundir, "fleet")
    os.makedirs(fleet_dir)
    daemon = None
    clients = None
    writers = None
    try:
        from portbench.server import DaemonThread

        writers = fleet.Writers(cfg, args.seed, fleet_dir, n_fleet + n_clients,
                                int(tr["fleet_workers"]))
        prewarm = f"-serve-prewarm={cfg['partitions']}x{cfg['brokers']}"
        daemon = DaemonThread(sock, [prewarm, *tr["daemon_flags"]],
                              os.path.join(rundir, "daemon.log"),
                              device=device)
        daemon.start(WARM_TIMEOUT_S)
        t_daemon = time.monotonic() - T_START
        paths = writers.paths(FLEET_TIMEOUT_S)
        t_fleet = time.monotonic() - T_START
        clients = Clients(flags, sock, rundir, client_env(ROOT),
                          command=client_command)

        # the warm-up round: the fleet's last n_clients clusters
        warm = clients.round(paths[n_fleet:])
        bad = [p for p in warm.plans if p.rc != 0]
        if bad:
            log(f"a warm-up client exited {bad[0].rc}: {bad[0].stderr[-2000:]}")

        # the set-up ends with the warm round; the profiler's start is the
        # benchmark's own
        setup_s = time.monotonic() - T_START
        trace = None
        if device is None:
            from portbench.devtrace import DeviceTrace

            trace = DeviceTrace()
        stats0, counters0, launches0 = daemon.stats(), counters(), launches()
        host0 = host_times()
        if trace is not None:
            trace.start()
        log(f"setup: daemon ready at {t_daemon:.3f} s, fleet written at "
            f"{t_fleet:.3f} s, warm round {warm.t1 - warm.t0:.3f} s, set-up "
            f"{setup_s:.3f} s, window opens at "
            f"{time.monotonic() - T_START:.3f} s")
        rounds: List[Round] = []
        k = 0
        while not rounds or rounds[-1].t1 - rounds[0].t0 < args.seconds:
            batch = [paths[(k + i) % n_fleet] for i in range(n_clients)]
            k += n_clients
            rounds.append(clients.round(batch))
        if trace is not None:
            trace.stop()
        stats1, counters1, launches1 = daemon.stats(), counters(), launches()
        host1 = host_times()
        if k > n_fleet:
            log(f"the window sent {k} requests to a fleet of {n_fleet}: "
                "clusters repeated")

        plans = [p for r in rounds for p in r.plans]
        span_s = rounds[-1].t1 - rounds[0].t0
        plans_per_s = len(plans) / span_s
        dev_ms = (device_ms_per_plan(trace, len(plans))
                  if trace is not None else None)
        walls = [p.wall_s for p in plans]
        log(f"{len(rounds)} rounds, {len(plans)} plans in {span_s:.3f} s: "
            f"{plans_per_s:.4f} plans/s, p50 {quantile(walls, 0.5):.3f} s, "
            f"p90 {quantile(walls, 0.9):.3f} s over {len(walls)} walls"
            + (f" (under the profiler), device busy {trace.busy_s:.6f} s: "
               f"{dev_ms} ms/plan" if trace is not None else ""))
        log(f"host: probe ms (least/median) {host0['probe_ms']} then "
            f"{host1['probe_ms']}, load {host0['loadavg_1m']:.2f} / "
            f"{host1['loadavg_1m']:.2f}, window cpu s: daemon process "
            f"{host1['cpu_s'] - host0['cpu_s']:.3f}, clients "
            f"{host1['children_cpu_s'] - host0['children_cpu_s']:.3f}")
        log("round seconds " + " ".join(f"{r.t1 - r.t0:.3f}" for r in rounds))
        log("speculation " + json.dumps(stats1.get("speculation", {}),
                                        sort_keys=True))
        log(f"mb_occupancy {json.dumps(stats1.get('mb_occupancy'))}, "
            f"requests {stats1.get('requests')}, fallbacks "
            f"{json.dumps(stats1.get('fallbacks'))}")

        mem_peak = (torch.cuda.max_memory_allocated(0)
                    if device is None else 0)
        rc_d = daemon.stop()
        if rc_d != 0:
            log(f"the daemon exited {rc_d}: {daemon.log_tail()}")
        daemon = None
        if device is None:
            torch.cuda.empty_cache()

        checks, failed, notes = correct.judge(
            plans, flags, args.seed, int(tr["check_sample"]), cfg["limits"])
        if inspect is not None:
            inspect(plans, flags)
        if rc_d != 0:
            # a daemon that failed, or did not stop (None), fails the run
            checks["daemon_exit"] = {"value": 1, "limit": 0}

        ctx = dict(stats0=stats0, stats1=stats1, counters0=counters0,
                   counters1=counters1, plans=len(plans), span_s=span_s,
                   walls=walls,
                   cell=cell, device_kind=kind, trace=trace,
                   occupancy=occupancy(stats0, stats1),
                   launches={n: launches1[n] - launches0[n]
                             for n in launches1})
        metrics: Dict[str, Dict[str, Any]] = {}
        if not args.trace:
            # a CPU run has no device, and so no device metric
            e2e = {"setup_s": setup_s, "device_ms_per_plan": dev_ms}
            for m in cell.end_to_end:
                if e2e.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
        else:
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        dev: Dict[str, Any] = {"platform": "gpu" if device is None
                               else str(device),
                               "kind": kind, "count": cell.chips,
                               "memory_peak_bytes": mem_peak}
        result: Dict[str, Any] = {}
        found = forbidden_modules()
        if found:
            log(f"modules of JAX or of the JAX package are loaded: {found}")
            return 1
        for note in notes[:5]:
            log(note)
        for name, c in checks.items():
            log(f"check {name} {c['value']} limit {c['limit']}")
        ok = correct.passed(checks) and failed == 0
        result["correct"] = ok
        result["attempted"] = len(plans)
        result["failed"] = failed
        result["metrics"] = metrics
        if args.trace and trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
        result["device"] = dev
        if args.trace and trace is not None:
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
        result["checks"] = checks
        print(json.dumps(result), flush=True)
        return 0
    except Exception:
        log("the run failed:\n" + traceback.format_exc())
        if daemon is not None:
            log("daemon log: " + daemon.log_tail())
        return 3
    finally:
        if clients is not None:
            clients.kill()
        if daemon is not None and daemon.alive():
            daemon.stop()
        if writers is not None:
            writers.stop()
        os.chdir(old_cwd)
        shutil.rmtree(rundir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
