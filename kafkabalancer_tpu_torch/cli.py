"""Command-line entry point.

Reference: ``main``/``run`` (kafkabalancer.go:68-242) and the JAX
package's ``cli.py``, whose flag set this module parses in full. The
lifecycle — flag parsing, input acquisition, the main reassignment loop
with complete-partition extension, output filtering and writing — and
the exit-code contract are the reference's:

    0 = ok, 1 = input file open failure, 2 = get-partition-list failure,
    3 = config/balance failure, 4 = output write failure.

Planning paths of this package:

- the default ``-solver=greedy`` host pipeline (no torch import);
- ``-solver=tpu``: the same pipeline with the per-move window scorer of
  ``solvers/tpu.py`` on the device, byte-identical to greedy;
- ``-solver=beam`` (with ``-beam-width``, ``-beam-depth``,
  ``-beam-siblings`` and ``-anti-colocation``): the pipeline with the
  lookahead search of ``solvers/beam.py`` as its one Move step;
- ``-fused`` (with ``-fused-batch`` and ``-fused-engine``): the device
  converge session of ``solvers/scan.py`` with the hand-written kernels;
  ``-fused-polish`` adds the pair-swap alternation (``solvers/polish.py``),
  ``-rebalance-leader`` runs the fused leader session
  (``solvers/leader.py``) and ``-anti-colocation=λ`` the colocation
  session (the scoring kernel's colocation variant; it composes with
  ``-fused-polish``); ``-fused-shard`` (with ``-shard-scale``) shards
  that session over every visible GPU (``parallel/shard_session.py``).

``-fused``, ``-solver=tpu`` and ``-solver=beam`` run on CUDA. Without a
GPU they exit 3; they never plan on the CPU by themselves (``run(...,
device="cpu")`` asks for that).

``-serve`` runs the planning daemon (``serve/daemon.py``) on
``-serve-socket``. Every other invocation forwards to a live daemon of
this package on the resolved socket (``serve/client.py``) and relays
its stdout, stderr and exit code; with no such daemon it plans in
process, byte-identical. ``-no-daemon``, ``-pprof`` and an explicit
``run(..., device=...)`` always plan in process. As in the reference, the
daemon speculates the next move by default (``-serve-speculate``), keeps
evicted sessions on disk with ``-serve-session-spill-dir``, and with
``-watch`` plans from ZooKeeper itself; the forwarding client keeps its
edge cache beside the socket (``-edge-cache``).

Every flag of the reference is parsed and runs. The telemetry flags
are the reference's: ``-stats`` (a human summary on stderr),
``-metrics-json`` (one schema-versioned JSON line), ``-trace`` (a Chrome
trace-event timeline, merged with the daemon's spans on a served
invocation), ``-explain`` (the plan-explanation document after the plan)
and ``-jax-profile`` (here a ``torch.profiler`` Chrome trace of CPU and
CUDA activity over the planning region, written into the directory; it
never forwards); ``-serve-stats`` and ``-metrics-prom`` scrape a live
daemon. ``-serve-prewarm`` runs ``prewarm.warm_store`` on the daemon's
warm thread. A fresh ``-fused``, ``-solver=tpu`` or ``-solver=beam``
process overlaps the torch import and the CUDA context with its host
work on a bounded warm thread (``ops/coldstart.py``).

State threading: the reference carries moves across ``Balance`` calls via
slice aliasing (SURVEY.md §2.2); accepted changes are applied to the live
list in place and the output accumulates references to the live
partitions.
"""

from __future__ import annotations

import io
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.codecs import (
    CodecError,
    filter_partition_list,
    get_partition_list_from_reader,
    get_partition_list_from_zookeeper,
    write_partition_list,
)
from kafkabalancer_tpu_torch.models import (
    Partition,
    PartitionList,
    RebalanceConfig,
    default_rebalance_config,
)
from kafkabalancer_tpu_torch.models.config import ENGINES
from kafkabalancer_tpu_torch.models.partition import empty_partition_list
from kafkabalancer_tpu_torch.obs import convergence
from kafkabalancer_tpu_torch.utils import BufferingWriter, FlagSet, Logger
from kafkabalancer_tpu_torch.utils.flags import go_atoi

# the file ``-jax-profile=<dir>`` writes into the directory; the process
# id keeps concurrent profiled runs into one directory apart
_PROFILE_FILE = "kafkabalancer-{pid}.trace.json"


def _fmt_cfg(cfg: RebalanceConfig) -> str:
    """Go ``%+v`` of RebalanceConfig (kafkabalancer.go:175)."""
    brokers = "[]" if not cfg.brokers else "[" + " ".join(map(str, cfg.brokers)) + "]"
    return (
        "{AllowLeaderRebalancing:%s RebalanceLeaders:%s "
        "MinReplicasForRebalancing:%d MinUnbalance:%s CompletePartition:%s "
        "Brokers:%s}"
        % (
            str(cfg.allow_leader_rebalancing).lower(),
            str(cfg.rebalance_leaders).lower(),
            cfg.min_replicas_for_rebalancing,
            cfg.min_unbalance,
            str(cfg.complete_partition).lower(),
            brokers,
        )
    )


def apply_assignment(pl: PartitionList, changed: Partition) -> Partition:
    """Apply an accepted change to the live list in place; returns the live
    partition so the output list can alias it (see module docstring).

    Matches by object identity via the ``_source`` reference the solver
    attaches to its proposal; duplicate topic+partition entries are legal
    input, so a key-based match would be ambiguous.
    """
    from kafkabalancer_tpu_torch.balancer import BalanceError

    src = getattr(changed, "_source", None)
    if src is not None:
        for p in pl.iter_partitions():
            if p is src:
                return _apply_replicas(p, changed)
    for p in pl.iter_partitions():
        if p.compare(changed):
            return _apply_replicas(p, changed)
    raise BalanceError(f"changed partition {changed} not in input list")


def _apply_replicas(p: Partition, changed: Partition) -> Partition:
    """The one mutation point for per-move and repair changes, and the
    ``-explain`` provenance hook: with a convergence recorder installed on
    this thread the old and new replica lists are recorded around the
    write (O(1); the scoring happens at finalize). A daemon's resident
    session (serve/sessions.py) mirrors each change through the
    convergence mutation tap."""
    rec = convergence.recorder()
    old = list(p.replicas) if rec is not None else None
    p.replicas[:] = changed.replicas
    if rec is not None:
        rec.record_change(p, old, list(p.replicas), origin="step")
    tap = convergence.mutation_tap()
    if tap is not None:
        tap.change(p)
    return p


class _TelemetryFlags:
    """Export targets of the ``-stats``/``-metrics-json``/``-trace`` flag
    trio, filled by ``_run_impl`` once the flags parse, so that the
    exporter tail in :func:`run` fires on every exit path (the exit-3 and
    exit-4 invocations are the ones an operator debugs).

    ``attrs`` carries this invocation's attribution gauges, overlaid at
    export time: in the multi-lane daemon's shared-registry mode a
    concurrent request's gauge writes would otherwise clobber this
    request's between stamping and export. ``refresh`` (when the caller
    gives one) is called at export time and its result overlays
    ``attrs``: the daemon re-reads the lane's device memory as the
    request ends."""

    __slots__ = ("stats", "metrics_path", "trace_path", "attrs", "refresh")

    def __init__(self) -> None:
        self.stats = False
        self.metrics_path = ""
        self.trace_path = ""
        self.attrs: Dict[str, Any] = {}
        self.refresh: Optional[Callable[[], Dict[str, Any]]] = None

    def any(self) -> bool:
        return bool(self.stats or self.metrics_path or self.trace_path)


def _export_telemetry(
    tel: _TelemetryFlags, rc: int, o, be: BufferingWriter, logger: Logger
) -> None:
    """The exporter tail; a telemetry failure is logged and never masks
    ``rc`` (the exit-code contract outranks observability)."""
    if not tel.any():
        return
    from kafkabalancer_tpu_torch.obs import export as obs_export

    if tel.refresh is not None:
        try:
            tel.attrs = {**tel.attrs, **tel.refresh()}
        except Exception as exc:
            logger.printf(f"failed refreshing attribution gauges: {exc}")
    if tel.stats:
        try:
            be.write(obs_export.render_stats(obs.REGISTRY, obs.tracer, rc=rc))
        except Exception as exc:
            logger.printf(f"failed rendering -stats summary: {exc}")
    if tel.metrics_path:
        try:
            payload = obs_export.metrics_payload(obs.REGISTRY, obs.tracer, rc=rc)
            if tel.attrs:
                # this request's attribution wins over a concurrent
                # request's writes to the shared registry
                payload["gauges"] = {**payload.get("gauges", {}), **tel.attrs}
            obs_export.write_metrics_json(tel.metrics_path, payload, o)
        except Exception as exc:
            logger.printf(
                f"failed writing metrics JSON to {tel.metrics_path}: {exc}"
            )
    if tel.trace_path:
        try:
            obs_export.write_trace(tel.trace_path, obs.tracer)
        except Exception as exc:
            logger.printf(f"failed writing trace to {tel.trace_path}: {exc}")


class _DeviceProfile:
    """``-jax-profile <dir>`` in this package: ``torch.profiler`` over the
    planning region (CPU activity, and CUDA activity when a card is
    present), with the region itself as one ``plan`` range
    (``record_function``), so the trace carries its own window. One
    Chrome-trace JSON file is written into the directory when the region
    ends (:data:`_PROFILE_FILE`)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self.path = os.path.join(
            directory, _PROFILE_FILE.format(pid=os.getpid())
        )
        self._prof: Any = None
        self._range: Any = None

    def start(self) -> None:
        """Create the directory (``OSError`` when it cannot be) and start
        profiling."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        os.makedirs(self.directory, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._range = record_function("plan")
        self._range.__enter__()

    def stop(self, log: Callable[[str], None]) -> None:
        """End the range and the profile and write the trace; a failure is
        logged, never raised (the plan outranks its profile)."""
        import torch

        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            self._range.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(self.path)
        except Exception as exc:
            log(f"failed writing device profile to {self.path}: {exc}")


# live warm threads awaiting their bounded exit-time join. One atexit
# registration for the whole process: the planning daemon runs many
# invocations per process, and one atexit entry per request would grow
# without bound (dead threads are dropped as new ones register)
_warm_threads: List[Any] = []
_warm_atexit_registered = False
# seconds the exit-time join waits for each warm thread: a healthy warm
# (the torch import, the CUDA context) ends in seconds; past this the
# thread is presumed stuck in a driver call, where teardown is safe.
WARM_JOIN_S = 30.0


def _track_warm_thread(t: Any) -> None:
    global _warm_atexit_registered
    _warm_threads[:] = [w for w in _warm_threads if w.is_alive()]
    _warm_threads.append(t)
    if not _warm_atexit_registered:
        _warm_atexit_registered = True
        import atexit

        atexit.register(_join_warm)


def _join_warm(timeout: Optional[float] = None) -> None:
    """Join every live warm thread, each for at most ``timeout`` seconds
    (default :data:`WARM_JOIN_S`)."""
    for w in list(_warm_threads):
        w.join(WARM_JOIN_S if timeout is None else timeout)


# flags that describe THIS process (daemon wiring, local profiling) and
# do not travel with a forwarded request. "input" rides as inlined
# request stdin instead of as a flag: the client reads the file itself,
# so the daemon needs no filesystem access and open-failure errors keep
# naming the path exactly as the user spelled it
_NO_FORWARD_FLAGS = frozenset((
    "serve", "serve-socket", "serve-idle-timeout", "serve-prewarm",
    "serve-lanes", "serve-microbatch", "serve-batch-mode",
    "serve-admission-hold", "serve-slow-ms", "serve-tenant-cap",
    "serve-max-queue", "serve-tenant-inflight", "serve-watchdog",
    "serve-faults", "serve-client-timeout",
    "serve-session-spill-dir", "serve-warm-cap-mb",
    "serve-speculate", "serve-speculate-off",
    "watch", "watch-emit", "watch-poll",
    "serve-stats", "serve-stats-json", "serve-dump-trace", "metrics-prom",
    "serve-session", "serve-no-session", "edge-cache", "no-edge-cache",
    "no-daemon", "help", "pprof", "pprof-path", "jax-profile", "input",
    # -trace is answered by the client on a forwarded invocation: the
    # daemon's reply footer (its span subtree) merges with the client's
    # own spans into one document (obs/export.py merged_trace)
    "trace",
))
# flags whose value names a path the daemon writes: made absolute against
# the client's working directory ("-" = stdout stays as it is)
_PATH_VALUE_FLAGS = frozenset(("metrics-json", "explain"))


def _forward_argv(f: FlagSet) -> List[str]:
    """The canonical argv for one forwarded invocation: every non-default
    parsed flag as ``-name=value`` (semantics, not raw text — duplicate
    flags already collapsed, parse errors already surfaced locally), path
    values made absolute, and ``-no-daemon`` pinned first so the daemon
    never re-forwards."""
    argv = ["-no-daemon=true"]
    for name in sorted(f.flags):
        if name in _NO_FORWARD_FLAGS:
            continue
        fl = f.flags[name]
        if fl.value == fl.default:
            continue
        v: Any = fl.value
        if (
            name in _PATH_VALUE_FLAGS
            and isinstance(v, str)
            and v not in ("", "-")
        ):
            v = os.path.abspath(v)
        if fl.kind == "bool":
            v = "true" if v else "false"
        argv.append(f"-{name}={v}")
    return argv


def _write_text(o, path: str, text: str) -> bool:
    """Scrape output to ``path`` (``-`` = stdout); False on a write
    failure (the caller logs and error-exits)."""
    if path == "-":
        o.write(text)
        return True
    try:
        with open(path, "w") as f:
            f.write(text)
    except OSError:
        return False
    return True


def _run_scrape(
    o, log, socket_flag: str,
    stats: bool, stats_json: bool, dump_path: str, prom_path: str,
) -> int:
    """The live-daemon scrape verbs: ``-serve-stats`` and
    ``-serve-stats-json`` (human text and one-line JSON of the daemon's
    ``stats`` document), ``-metrics-prom`` (Prometheus text exposition of
    the same scrape) and ``-serve-dump-trace`` (the flight recorder's
    Perfetto export). Pure protocol clients (serve/client.py,
    obs/export.py): no torch, no numpy, and they never pause planning.
    Exit 3 when no live daemon of this package answers; exit 4 when the
    daemon answered but the local output path is unwritable."""
    import json as json_mod

    from kafkabalancer_tpu_torch.obs import export as obs_export
    from kafkabalancer_tpu_torch.serve import client as serve_client
    from kafkabalancer_tpu_torch.serve.protocol import resolve_socket_path

    sock = resolve_socket_path(socket_flag)
    if stats or stats_json or prom_path:
        doc = serve_client.fetch_stats(sock)
        if doc is None:
            log(f"no live daemon on {sock}")
            return 3
        if stats_json:
            o.write(
                json_mod.dumps(
                    doc, sort_keys=True, separators=(",", ":"), default=str,
                )
                + "\n"
            )
        if stats:
            o.write(obs_export.render_serve_stats(doc))
        if prom_path:
            if not _write_text(o, prom_path, obs_export.render_prometheus(doc)):
                log(f"failed writing Prometheus exposition to {prom_path}")
                return 4
    if dump_path:
        resp = serve_client.fetch_trace(sock)
        if resp is None or not isinstance(resp.get("trace"), dict):
            log(f"no live daemon on {sock}")
            return 3
        text = json_mod.dumps(resp["trace"], default=str)
        if not _write_text(o, dump_path, text + "\n"):
            log(f"failed writing flight trace to {dump_path}")
            return 4
        if dump_path != "-":
            log(f"flight trace written to {dump_path}")
    return 0


def _forward(
    i, f: FlagSet, log: Callable[[str], None], trace_path: str = "",
) -> tuple:
    """Forward one parsed invocation to a live daemon (serve/client.py).
    Returns ``(served, stdin_text)``: the daemon's result or None (plan
    in process), and the input read from ``i`` when it was read. With
    ``trace_path`` (``-trace``), a served invocation writes one merged
    document there: the client's spans and the daemon's reply-footer
    subtree, aligned by the handshake's clock-offset estimate.

    The edge residency cache (serve/edge_cache.py, on unless
    ``-no-edge-cache``/``-edge-cache=false``/``-serve-no-session``): the
    per-tenant shadow digest cache beside the socket. A stable stat hit
    skips the input read entirely; a changed file pays an
    O(changed-rows) splice instead of the O(P) full parse; a ``-from-zk``
    invocation consumes row-level change events. All rungs degrade to
    the full read on any doubt — the cache can cost a fallback, never a
    wrong digest."""
    from kafkabalancer_tpu_torch.serve import client as serve_client
    from kafkabalancer_tpu_torch.serve.protocol import resolve_socket_path

    fl = f.flags
    sock = resolve_socket_path(fl["serve-socket"].value)
    if not serve_client.socket_exists(sock):
        return None, None
    input_path, zk = fl["input"].value, fl["from-zk"].value
    is_json = fl["input-json"].value
    topics = [t for t in fl["topics"].value.split(",") if t]
    no_session = fl["serve-no-session"].value
    ec_on = (
        fl["edge-cache"].value
        and not fl["no-edge-cache"].value
        and not no_session
    )
    if ec_on:
        from kafkabalancer_tpu_torch.serve import edge_cache as serve_ec
    ec_probe = None
    ec_state = None
    ec_hit: Optional[bool] = None
    ec_zk_fast = False
    stdin_text: Optional[str] = None
    # the edge recorder (obs/edge.py) times the client phase chain and
    # carries the trace context the daemon stamps into its telemetry
    edge_rec = obs.edge.EdgeContext()
    with edge_rec.install():
        if input_path != "":
            if ec_on:
                with edge_rec.phase("cache_probe"):
                    ec_probe = serve_ec.probe_file(
                        sock,
                        fl["serve-session"].value
                        or os.path.abspath(input_path),
                        input_path, is_json, topics,
                    )
            if ec_probe is not None and not ec_probe.needs_text:
                # rung 1: a stable stat hit — the entry header carries
                # the proven digest, so the read itself is skipped (the
                # text stays lazy for resync/register)
                ec_state = ec_probe.state
                ec_hit = True
            else:
                # the CLIENT reads the file and sends its text: the
                # daemon needs no filesystem access, and an unreadable
                # file falls through to the in-process open, whose error
                # names the path exactly as the user spelled it
                try:
                    with edge_rec.phase("input_read"):
                        with open(input_path, "r") as fh:
                            stdin_text = fh.read()
                except OSError:
                    return None, None
                if ec_probe is not None:
                    # rungs 2+3: content memcmp (proves the cached
                    # digest) or the incremental row-ladder splice
                    with edge_rec.phase("cache_probe"):
                        ec_state, rhit = serve_ec.resolve_text(
                            ec_probe, stdin_text
                        )
                    ec_hit = bool(rhit)
        elif zk == "":
            with edge_rec.phase("input_read"):
                stdin_text = i.read()
        elif ec_on:
            # -from-zk fast path: probe the cached synthesized state
            # against per-topic payload digests; None → forward the flag
            # as before, so the daemon reproduces connection errors
            with edge_rec.phase("cache_probe"):
                zk_res = serve_ec.probe_zk(sock, zk, topics)
            if zk_res is not None:
                ec_state = zk_res.state
                ec_hit = zk_res.hit
                ec_zk_fast = True
        with edge_rec.phase("canonicalize"):
            # the tenant: an explicit -serve-session name, else the
            # input path ("-" for stdin, "zk:<conn>" for the zookeeper
            # fast path); a v2 daemon keys its resident sessions by
            # (tenant, planning-flags signature)
            tenant = fl["serve-session"].value or (
                os.path.abspath(input_path) if input_path != ""
                else (
                    "zk:" + zk if ec_zk_fast
                    else ("-" if stdin_text is not None else "")
                )
            )
            fwd_argv = _forward_argv(f)
            if ec_zk_fast:
                # the synthesized JSON state replaces the daemon-side
                # zookeeper read: strip the zk flag and mark the riding
                # input as JSON (an in-process fallback still reads
                # zookeeper directly)
                fwd_argv = [
                    a for a in fwd_argv if not a.startswith("-from-zk=")
                ]
                fwd_argv.append("-input-json=true")
            session_spec = None
            if (
                not no_session
                and (zk == "" or ec_zk_fast)
                and (stdin_text is not None or ec_state is not None)
            ):
                session_spec = serve_client.SessionSpec(
                    tenant=tenant,
                    text=stdin_text if stdin_text is not None else "",
                    is_json=True if ec_zk_fast else is_json,
                    topics=topics,
                )
            if (
                ec_on
                and input_path != ""
                and ec_state is None
                and stdin_text is not None
                and session_spec is not None
                and ec_probe is not None
                and ec_probe.stat is not None
            ):
                # edge-cache miss: pay the O(P) digest HERE (the phase
                # forward_plan would charge) so the canonical state is
                # persisted for the next invocation; the probe's
                # pre-read stat key pins the text to one stat point
                with edge_rec.phase("digest"):
                    from kafkabalancer_tpu_torch.serve import state as sstate

                    ec_state = sstate.client_state(
                        stdin_text, is_json, topics
                    )
                if ec_state is not None:
                    serve_ec.persist_state(
                        sock, tenant, input_path, is_json, topics,
                        stdin_text, ec_state, ec_probe.stat,
                    )
        declined: List[str] = []

        def note(reason: str) -> None:
            # every fallback reason (and each session re-sync on the way
            # to a served answer) lands as a counter in this registry
            obs.metrics.count(f"serve.fallbacks.{reason}")

        if ec_hit is not None:
            # edge-residency attribution: rides the trace context so the
            # daemon stamps client.edge_cache_hit into the served
            # request's gauges; the local gauge serves in-process readers
            edge_rec.cache_hit = ec_hit
            obs.metrics.gauge("client.edge_cache_hit", bool(ec_hit))
        with obs.span(
            "serve.forward", socket=sock, trace_id=edge_rec.trace_id,
        ) as fwd_sp:
            edge_rec.parent_sid = getattr(fwd_sp, "sid", 0)
            served = serve_client.forward_plan(
                sock, fwd_argv, stdin_text,
                on_fallback=declined.append,
                session=session_spec,
                note=note,
                tenant=tenant,
                client_timeout=max(0.0, fl["serve-client-timeout"].value),
                edge=edge_rec,
                cached_state=ec_state,
            )
        if served is None:
            edge_rec.note_fallback()
            if declined:
                # the daemon positively declined: name the reason (the
                # silent modes — daemon down, stale socket — log nothing,
                # so stderr stays that of a daemon-less run)
                log(
                    f"daemon declined request ({declined[0]}); "
                    "planning in-process"
                )
        else:
            obs.metrics.count("cli.served")
            edge_rec.finish(served.trace)
    if served is not None and trace_path:
        try:
            from kafkabalancer_tpu_torch.obs import export as obs_export

            obs_export.write_merged_trace(trace_path, obs.tracer, edge_rec)
        except Exception as exc:
            log(f"failed writing merged trace to {trace_path}: {exc}")
    return served, stdin_text


def run(
    i, o, e, args: List[str], *,
    device: Any = None,
    shard_devices: Optional[List[Any]] = None,
    attrs: Optional[Dict[str, Any]] = None,
    refresh_attrs: Optional[Callable[[], Dict[str, Any]]] = None,
    session: Optional[Any] = None,
) -> int:
    """Testable CLI body; reference ``run`` (kafkabalancer.go:72-242).

    ``device`` pins the device of ``-fused``, ``-solver=tpu`` and
    ``-solver=beam`` (``"cpu"`` in the tests); by default it is CUDA. An
    invocation with ``device`` given plans in this process and never
    forwards to a daemon. ``shard_devices`` are the devices
    ``-fused-shard`` spreads over (default: ``[device]`` when ``device`` is
    given, else every visible GPU); the daemon passes all of its devices.

    The planning daemon (serve/daemon.py) runs each request through this
    function with three more arguments. ``attrs`` seeds the registry with
    the request's attribution gauges (``served``, ``serve.*``);
    ``refresh_attrs`` is called when the telemetry is exported and its
    gauges overlay those (the lane's device memory as the request ends).
    ``session`` is the daemon's resident-session seam
    (serve/sessions.py ``PlanSessionContext``): when it supplies a
    resident partition list, input parsing is skipped; when the CLI
    parses, the session snapshots the raw rows right after the parse.

    The telemetry exporters (``-stats``, ``-metrics-json``, ``-trace``)
    run when the invocation ends, on every exit path."""
    be = BufferingWriter(e)
    logger = Logger(be)
    tel = _TelemetryFlags()
    obs.begin_invocation()
    if attrs:
        tel.attrs = dict(attrs)
        for k, v in attrs.items():
            obs.metrics.gauge(k, v)
    tel.refresh = refresh_attrs
    rc = -1  # an uncaught exception exports rc=-1
    try:
        rc = _run_impl(
            i, o, be, logger, tel, args, device, shard_devices, session
        )
        return rc
    finally:
        try:
            _export_telemetry(tel, rc, o, be, logger)
        except Exception as exc:
            # the per-exporter failures are logged inside; this guards the
            # obs.export import: a telemetry failure must neither mask rc
            # nor skip the stderr flush
            logger.printf(f"telemetry export failed: {exc}")
        finally:
            if tel.any():
                # shared-registry bookkeeping: the last tracing request
                # to finish returns the tracer to its no-op fast path
                obs.end_invocation()
            be.close()


def _run_impl(
    i, o, be: BufferingWriter, logger: Logger, tel: _TelemetryFlags,
    args: List[str], device: Any, shard_devices: Optional[List[Any]],
    session: Optional[Any],
) -> int:
    log = logger.printf
    profiler = None
    devprof: Optional[_DeviceProfile] = None
    explain_installed = False

    try:
        defaults = default_rebalance_config()

        f = FlagSet(args[0] if args else "kafkabalancer", output=be)
        f_json = f.bool("input-json", False, "Parse the input as JSON")
        f_input = f.string(
            "input",
            "",
            "Name of the file to read (if no file is specified read from "
            "stdin, can not be used with -from-zk)",
        )
        f_zk = f.string(
            "from-zk", "", "Zookeeper connection string (can not be used with -input)"
        )
        f_max = f.int("max-reassign", 1, "Maximum number of reassignments to generate")
        f_full = f.bool(
            "full-output",
            False,
            "Output the full partition list: by default only the changes are printed",
        )
        f_unique = f.bool("unique", False, "Output only unique topic+partition")
        f_pprof = f.bool("pprof", False, "Enable CPU profiling")
        f_allow_leader = f.bool(
            "allow-leader",
            defaults.allow_leader_rebalancing,
            "Consider the partition leader eligible for rebalancing",
        )
        f_rebalance_leader = f.bool(
            "rebalance-leader", defaults.rebalance_leaders, "Force rebalance leadership"
        )
        f_complete = f.bool(
            "complete-partition",
            defaults.complete_partition,
            "Force to always complete a topic+partition's replicas to be valid.",
        )
        f_topics = f.string("topics", "", "Only process these commaseparated topics")
        f_min_replicas = f.int(
            "min-replicas",
            defaults.min_replicas_for_rebalancing,
            "Minimum number of replicas for a partition to be eligible for rebalancing",
        )
        f_min_unbalance = f.float(
            "min-unbalance",
            defaults.min_unbalance,
            "Minimum unbalance value required to perform rebalancing",
        )
        f_brokers = f.string("broker-ids", "auto", "Comma-separated list of broker IDs")
        f_solver = f.string(
            "solver",
            "greedy",
            "Optimization backend: greedy (reference parity), tpu (the "
            "per-move window scorer on the GPU, byte-identical to greedy), "
            "beam (N-way beam search)",
        )
        f_beam_width = f.int(
            "beam-width", defaults.beam_width,
            "Beam solver: candidate states kept per lookahead depth",
        )
        f_beam_depth = f.int(
            "beam-depth", defaults.beam_depth,
            "Beam solver: lookahead moves per search",
        )
        f_anti_coloc = f.float(
            "anti-colocation", defaults.anti_colocation,
            "Penalty weight for same-topic replicas sharing a broker "
            "(0 disables). With -solver=beam: lookahead search over the "
            "combined objective; with -fused: the colocation-aware "
            "batched session (greedy in the combined objective)",
        )
        f_beam_siblings = f.bool(
            "beam-siblings", defaults.beam_siblings,
            "Beam solver: also expand the second-best candidate per target",
        )
        f_fused = f.bool(
            "fused",
            False,
            "Run the whole -max-reassign session as one device session on "
            "the GPU (trades per-move logging for throughput; with "
            "-fused-batch>1 the plan trajectory differs from the per-move "
            "pipeline at equal quality)",
        )
        f_batch = f.int(
            "fused-batch",
            128,
            "Fused mode: commit up to this many partition-distinct moves "
            "per device iteration, each exact via sequential-delta "
            "acceptance (1 = strict one-move-at-a-time)",
        )
        f_engine = f.string(
            "fused-engine",
            "auto",
            "Fused mode: device engine (auto and xla run the session with "
            "the hand-written scoring kernel; pallas runs the whole session "
            "as one kernel launch per chunk, pallas-interpret that kernel's "
            "plain torch version)",
        )
        f_polish = f.bool(
            "fused-polish",
            False,
            "Fused mode: alternate pair-swap polish phases with the move "
            "session (compound two-replica exchanges escape single-move "
            "local optima; an extension beyond the reference)",
        )
        f_shard = f.bool(
            "fused-shard",
            False,
            "Fused mode: shard the converge session over all visible GPUs "
            "(each scores its block of partition rows, the winners combine "
            "under one total order; plans identical to the single-device "
            "session). Requires -fused; composes with -fused-polish (a "
            "single-device polish tail), -anti-colocation and "
            "-rebalance-leader (the fused leader session is single-device "
            "by design and runs as such)",
        )
        f_shard_scale = f.bool(
            "shard-scale",
            False,
            "Fused-shard scale tier: fine-ladder partition buckets "
            "(multiples of 8 x device count above 64k rows), per-shard "
            "upload, membership rebuilt on each device and row-chunked "
            "scoring; plans stay identical to the single-device session. "
            "Requires -fused-shard",
        )
        f_jaxprof = f.string(
            "jax-profile",
            "",
            "Write a torch.profiler Chrome trace of the planning region "
            "(CPU and CUDA activity, one 'plan' range) into this "
            "directory (the device counterpart of -pprof; never "
            "forwarded to a daemon)",
        )
        f_pprof_path = f.string(
            "pprof-path",
            "cpu.pprof",
            "Write the -pprof CPU profile to this path",
        )
        f_stats = f.bool(
            "stats",
            False,
            "Print an invocation telemetry summary (lifecycle spans, "
            "phase timings, counters) to stderr",
        )
        f_metrics = f.string(
            "metrics-json",
            "",
            "Write one line of schema-versioned invocation metrics JSON "
            "to this path ('-' = stdout, after the plan)",
        )
        f_trace = f.string(
            "trace",
            "",
            "Write a Chrome trace-event / Perfetto JSON host timeline to "
            "this path (one track per thread; overlay with the "
            "-jax-profile device trace)",
        )
        f_explain = f.string(
            "explain",
            "",
            "Write a schema-versioned plan-explanation document "
            "(kafkabalancer-tpu.explain/1) to this path ('-' = stdout, "
            "after the plan): per-move provenance (loads before/after, "
            "oracle-exact score deltas, top-k alternatives), "
            "masked-candidate breakdown, and an explicit no-move reason; "
            "a human summary prints to stderr",
        )
        f_serve = f.bool(
            "serve",
            False,
            "Run as a persistent planning daemon on -serve-socket: torch, "
            "the CUDA context, the loaded kernels and the tensorize caches "
            "stay resident across requests",
        )
        f_serve_socket = f.string(
            "serve-socket",
            "",
            "Unix socket path for -serve and for client forwarding "
            "(default: $KAFKABALANCER_TPU_TORCH_SOCKET, else "
            "<tmpdir>/kafkabalancer-tpu-torch-<uid>.sock)",
        )
        f_serve_idle = f.float(
            "serve-idle-timeout",
            900.0,
            "Daemon: exit after this many seconds without requests "
            "(<= 0 disables the idle shutdown)",
        )
        f_serve_prewarm = f.string(
            "serve-prewarm",
            "",
            "Daemon: prewarm this PARTITIONSxBROKERS[,...] shape grid at "
            "startup (one throw-away session per shape bucket after the "
            "kernel load: the caching allocator, CUDA's lazily loaded "
            "modules and both kernels warm before request 1)",
        )
        f_serve_lanes = f.int(
            "serve-lanes",
            0,
            "Daemon: worker lanes, one per GPU (0 = one lane per visible "
            "GPU; 1 = the single-lane dispatcher; N caps at the GPU "
            "count). Lanes get bucket-affinity routing and work stealing",
        )
        f_serve_microbatch = f.int(
            "serve-microbatch",
            4,
            "Daemon: MAX OCCUPANCY of one fused device dispatch — up to "
            "this many concurrent same-bucket requests share each "
            "batched dispatch (1 disables; results stay byte-identical "
            "to solo dispatches)",
        )
        f_serve_batch_mode = f.string(
            "serve-batch-mode",
            "continuous",
            "Daemon: cross-request batching discipline — 'continuous' "
            "re-forms the fused batch at every solver chunk round "
            "(mid-flight admission into freed slots); 'oneshot' is the "
            "fixed-membership barrier",
        )
        f_serve_admission_hold = f.int(
            "serve-admission-hold",
            0,
            "Daemon: hold a lane's dispatch until this many same-bucket "
            "batchable requests are queued (or a short window expires) "
            "— deterministic batch forming for tests and benchmarks "
            "(0 disables)",
        )
        f_serve_slow_ms = f.float(
            "serve-slow-ms",
            0.0,
            "Daemon: auto-dump the flight recorder (Perfetto trace + "
            "request log) when a served request exceeds this many "
            "milliseconds (0 disables)",
        )
        f_serve_tenant_cap = f.int(
            "serve-tenant-cap",
            32,
            "Daemon: per-tenant telemetry label bound — the top-K "
            "most-recently-active tenants keep individual latency "
            "histograms and counters; the rest roll up into 'other'",
        )
        f_serve_max_queue = f.int(
            "serve-max-queue",
            256,
            "Daemon: total admission-queue bound — arrivals past it "
            "are shed with a structured retry-after frame instead of "
            "queueing forever (0 disables)",
        )
        f_serve_tenant_inflight = f.int(
            "serve-tenant-inflight",
            64,
            "Daemon: per-tenant queued+inflight cap — one churn-heavy "
            "tenant past it is shed (retry-after frame) while other "
            "tenants keep planning (0 disables)",
        )
        f_serve_watchdog = f.float(
            "serve-watchdog",
            120.0,
            "Daemon: lane health watchdog interval in seconds — a lane "
            "with active work and no progress past it is quarantined, "
            "its queued work requeued onto healthy lanes, its in-flight "
            "work answered with a structured error (0 disables)",
        )
        f_serve_faults = f.string(
            "serve-faults",
            "",
            "Daemon: ARM the fault-injection seam with this schedule "
            "(site@n[,n...][:arg][;...]; sites: lane_crash, "
            "dispatch_delay, socket_drop, transfer_fail) — chaos "
            "testing only, inert by default",
        )
        f_serve_spill_dir = f.string(
            "serve-session-spill-dir",
            "",
            "Daemon: the warm session tier — evicted/expired/shutdown "
            "sessions spill to checksummed records in this directory "
            "and a later digest-matching request restores them without "
            "the client re-sending the cluster; survives SIGKILL via "
            "the continuous per-request spill (empty disables)",
        )
        f_serve_warm_cap = f.float(
            "serve-warm-cap-mb",
            256.0,
            "Daemon: byte budget of the warm session tier in MB — the "
            "least-recently-spilled records are swept past it "
            "(<= 0 disables the sweep)",
        )
        f_serve_speculate = f.bool(
            "serve-speculate",
            True,
            "Daemon: speculative plan-ahead — after a clean "
            "session-backed plan, an idle-priority task plans the NEXT "
            "move on the resident session and memoizes the answer; a "
            "digest-matching next request is answered with zero "
            "dispatch, preempted instantly by any real traffic",
        )
        f_serve_speculate_off = f.bool(
            "serve-speculate-off",
            False,
            "Daemon: force speculative plan-ahead OFF (wins over "
            "-serve-speculate)",
        )
        f_watch = f.string(
            "watch",
            "",
            "Daemon: watch-driven continuous controller — subscribe to "
            "this Zookeeper connection string (kazoo watches with a "
            "-watch-poll fallback), apply change events to a resident "
            "session, re-plan (speculation makes the steady state a "
            "memoized read) and stream plans to -watch-emit; no client "
            "process in the loop (requires -serve)",
        )
        f_watch_emit = f.string(
            "watch-emit",
            "",
            "Watch mode: plan sink — a directory (one "
            "plan-NNNNNN.json + .meta pair per emitted plan) or '-' "
            "for the daemon's stdout",
        )
        f_watch_poll = f.float(
            "watch-poll",
            5.0,
            "Watch mode: poll interval in seconds (the fallback "
            "cadence when the ZK client offers no watch callbacks; "
            "watch events wake the loop early)",
        )
        f_serve_client_timeout = f.float(
            "serve-client-timeout",
            0.0,
            "Client: bound the whole daemon plan wait to this many "
            "seconds (also sent as the request's deadline_ms budget); "
            "0 = progress-aware default — a wedged daemon is detected "
            "by liveness probes and falls back in seconds",
        )
        f_serve_session = f.string(
            "serve-session",
            "",
            "Name the resident cluster session this invocation belongs "
            "to (protocol v2 daemons keep the parsed/settled state "
            "resident per session, so the outer loop's steady-state "
            "request ships a digest instead of the cluster; default: "
            "derived from the input path)",
        )
        f_serve_no_session = f.bool(
            "serve-no-session",
            False,
            "Never use resident cluster sessions when forwarding to a "
            "daemon; every request ships and re-parses the full state",
        )
        f.bool(
            "edge-cache",
            True,
            "Client: keep a per-tenant shadow digest cache beside the "
            "daemon socket so an unchanged input skips the O(P) "
            "read+parse+digest entirely and a changed one pays "
            "O(changed rows) (serve/edge_cache.py)",
        )
        f.bool(
            "no-edge-cache",
            False,
            "Client: disable the edge residency cache for this "
            "invocation (every request re-reads and re-digests the "
            "full input; wins over -edge-cache)",
        )
        f_serve_stats = f.bool(
            "serve-stats",
            False,
            "Scrape a live daemon's telemetry (requests, phase "
            "histograms, lanes, tenants) as human-readable text",
        )
        f_serve_stats_json = f.bool(
            "serve-stats-json",
            False,
            "Scrape a live daemon's telemetry as one line of "
            "schema-versioned JSON",
        )
        f_serve_dump_trace = f.string(
            "serve-dump-trace",
            "",
            "Export a live daemon's flight recorder (recent spans + "
            "request log) as Perfetto-loadable JSON to this path "
            "('-' = stdout)",
        )
        f_metrics_prom = f.string(
            "metrics-prom",
            "",
            "Scrape a live daemon and write Prometheus text exposition "
            "(counters, gauges, histogram summaries) to this path "
            "('-' = stdout)",
        )
        f_no_daemon = f.bool(
            "no-daemon",
            False,
            "Never forward to a planning daemon; always plan in this "
            "process",
        )
        f_help = f.bool("help", False, "Display usage")

        def usage():
            be.write(f"Usage of {args[0] if args else 'kafkabalancer'}:\n")
            f.print_defaults()

        f.usage = usage
        # ContinueOnError semantics: parse errors print the error + usage and
        # execution continues with the flags parsed so far
        # (the reference ignores Parse's return value, kafkabalancer.go:98).
        f.parse(args[1:] if args else [])

        # the telemetry flag trio is known now; tracing stays a no-op (and
        # writes no files) unless one of the three asked for it. obs/
        # imports no torch, so the error exits below stay torch-free with
        # every flag combination
        tel.stats = bool(f_stats.value)
        tel.metrics_path = f_metrics.value
        tel.trace_path = f_trace.value
        if tel.any():
            obs.enable_tracing()

        if f_pprof.value:
            import cProfile

            profiler = cProfile.Profile()
            prof_t0 = time.perf_counter_ns()
            profiler.enable()

        if f_help.value:
            usage()
            return 0

        if (
            f_serve_stats.value
            or f_serve_stats_json.value
            or f_serve_dump_trace.value != ""
            or f_metrics_prom.value != ""
        ):
            # live-daemon scrape verbs, handled before any input or
            # planning machinery; combining them with -serve or an input
            # source is a contradiction
            if f_serve.value:
                log(
                    "the scrape verbs (-serve-stats[-json], "
                    "-serve-dump-trace, -metrics-prom) query a live "
                    "daemon; they cannot be combined with -serve"
                )
                usage()
                return 3
            if f_input.value != "" or f_zk.value != "":
                log(
                    "the scrape verbs take no input: they query a live "
                    "daemon, they do not plan"
                )
                usage()
                return 3
            return _run_scrape(
                o, log, f_serve_socket.value,
                f_serve_stats.value, f_serve_stats_json.value,
                f_serve_dump_trace.value, f_metrics_prom.value,
            )

        with obs.span("validate_flags"):
            brokers: Optional[List[int]] = None
            if f_brokers.value != "auto":
                brokers = []
                for broker in f_brokers.value.split(","):
                    try:
                        brokers.append(go_atoi(broker))
                    except ValueError:
                        log(
                            'failed parsing broker list "%s": strconv.Atoi: '
                            'parsing "%s": invalid syntax'
                            % (f_brokers.value, broker)
                        )
                        usage()
                        return 3

            if f_max.value < 0:
                log('invalid number of max reassignments "%d"' % f_max.value)
                usage()
                return 3

            if f_input.value != "" and f_zk.value != "":
                log("can't specify both -input and -from-zk")
                usage()
                return 3

            if f_serve.value and (f_input.value != "" or f_zk.value != ""):
                log(
                    "-serve takes no input: the daemon plans forwarded "
                    "requests, each carrying its own input"
                )
                usage()
                return 3

            if f_watch.value != "" and not f_serve.value:
                log("-watch requires -serve (the daemon is the watcher)")
                usage()
                return 3

            if f_watch.value != "" and f_watch_emit.value == "":
                # a sink-less watcher would plan a move nobody can ever
                # apply and then wait forever for the cluster to catch
                # up — refuse loudly instead
                log(
                    "-watch requires -watch-emit (a plan nobody "
                    "receives can never be applied; use "
                    "-watch-emit=- for stdout)"
                )
                usage()
                return 3

            if f_watch_emit.value != "" and f_watch.value == "":
                log("-watch-emit requires -watch")
                usage()
                return 3

            if f_serve_batch_mode.value not in ("continuous", "oneshot"):
                log(
                    f"unknown -serve-batch-mode "
                    f"{f_serve_batch_mode.value!r} (continuous|oneshot)"
                )
                usage()
                return 3

            if f_shard.value and not f_fused.value:
                log("-fused-shard requires -fused")
                usage()
                return 3

            if f_shard_scale.value and not f_shard.value:
                log("-shard-scale requires -fused-shard")
                usage()
                return 3

            if f_fused.value:
                if f_engine.value not in ENGINES:
                    log(f"unknown fused engine {f_engine.value!r}")
                    usage()
                    return 3
                if f_anti_coloc.value > 0:
                    # the colocation session's own constraints, as flag
                    # validation instead of a planning failure
                    if f_rebalance_leader.value:
                        log(
                            "-anti-colocation with -fused excludes "
                            "-rebalance-leader"
                        )
                        usage()
                        return 3
                    if f_batch.value <= 1:
                        log("-anti-colocation with -fused requires "
                            "-fused-batch>1")
                        usage()
                        return 3
                    if f_engine.value.startswith("pallas") and not f_shard.value:
                        # plan() runs the torch colocation session: the
                        # whole-session kernel has no colocation state (the
                        # sharded session scores it with every engine)
                        log(
                            "-anti-colocation runs the XLA colocation "
                            f"session; -fused-engine={f_engine.value} is "
                            "ignored"
                        )

        if f_serve.value:
            # daemon mode: serve planning requests until shutdown or the
            # idle timeout. The daemon runs each request through this
            # very run() (with -no-daemon first), so the planning
            # contract is the in-process one by construction.
            from kafkabalancer_tpu_torch.serve.daemon import Daemon
            from kafkabalancer_tpu_torch.serve.protocol import (
                resolve_socket_path,
            )

            idle_timeout = f_serve_idle.value
            if f_watch.value != "" and "serve-idle-timeout" not in f.seen:
                # watch mode's steady state has NO client traffic (that
                # is the point), and watch ticks deliberately never
                # touch the idle clock — the DEFAULT idle timeout would
                # shut the watcher down mid-watch. An EXPLICIT
                # -serve-idle-timeout is honored as given (f.seen — an
                # explicit value EQUAL to the default included).
                log(
                    "watch mode: default -serve-idle-timeout disabled "
                    "(set it explicitly to bound a watch daemon's life)"
                )
                idle_timeout = 0.0
            return Daemon(
                resolve_socket_path(f_serve_socket.value),
                idle_timeout=idle_timeout,
                log=log,
                devices=None if device is None else [device],
                prewarm_shapes=f_serve_prewarm.value,
                lanes=f_serve_lanes.value,
                microbatch=f_serve_microbatch.value,
                batch_mode=f_serve_batch_mode.value,
                admission_hold=f_serve_admission_hold.value,
                slow_ms=f_serve_slow_ms.value,
                tenant_cap=f_serve_tenant_cap.value,
                max_queue=f_serve_max_queue.value,
                tenant_inflight=f_serve_tenant_inflight.value,
                watchdog_s=f_serve_watchdog.value,
                faults_spec=f_serve_faults.value,
                spill_dir=f_serve_spill_dir.value,
                warm_cap_mb=f_serve_warm_cap.value,
                speculate=(
                    f_serve_speculate.value
                    and not f_serve_speculate_off.value
                ),
                watch_conn=f_watch.value,
                watch_emit=f_watch_emit.value,
                watch_poll=f_watch_poll.value,
                # the watcher plans with THIS invocation's planning
                # flags, canonicalized exactly like a forwarded request
                # (daemon/serve flags excluded, -no-daemon pinned)
                watch_argv=(
                    _forward_argv(f) if f_watch.value != "" else None
                ),
            ).serve_forever()

        if (
            not f_no_daemon.value
            and not (f_pprof.value or f_jaxprof.value)
            and device is None
        ):
            # transparent forwarding: when a live daemon of this package
            # owns the resolved socket, relay this invocation and return
            # its verdict verbatim. Profiling runs (-pprof, -jax-profile)
            # pin the work to this process and never forward. Every
            # failure falls through to the in-process path below,
            # byte-identical; a daemon-less host pays one stat().
            served, stdin_text = _forward(i, f, log, tel.trace_path)
            if served is not None:
                o.write(served.stdout)
                be.write(served.stderr)
                # the daemon's own run() exported -stats and
                # -metrics-json (its relayed stdout, stderr and files
                # carry them), and the merged trace is written: the
                # local exporter must not write them again
                tel.stats = False
                tel.metrics_path = ""
                tel.trace_path = ""
                return served.rc
            if stdin_text is not None and f_input.value == "":
                # true-stdin input was consumed by the forward attempt;
                # replay it for the in-process path
                i = io.StringIO(stdin_text)

        topics = [t for t in f_topics.value.split(",") if len(t) >= 1]

        resident_pl = None
        if (
            session is not None
            and session.kind != "register"
            and f_input.value == ""
            and f_zk.value == ""
        ):
            # resident cluster session (serve/sessions.py): the daemon
            # already holds this client's state — the delta fast path
            # skips input transfer AND parse; the rebuild paths
            # reconstruct from the resident raw shadow inside this span
            with obs.span("parse_input", source=f"session-{session.kind}"):
                resident_pl = session.resident()
        if resident_pl is not None:
            pl = resident_pl
        else:
            in_stream = i
            close_input = False
            if f_input.value != "":
                try:
                    in_stream = open(f_input.value, "r")
                    close_input = True
                except OSError as exc:
                    log(f"failed opening file {f_input.value}: {exc}")
                    return 1

            try:
                with obs.span(
                    "parse_input",
                    source="zookeeper" if f_zk.value != "" else "reader",
                ):
                    try:
                        if f_zk.value != "":
                            pl = get_partition_list_from_zookeeper(
                                f_zk.value, topics
                            )
                        else:
                            pl = get_partition_list_from_reader(
                                in_stream, f_json.value, topics
                            )
                    except CodecError as exc:
                        log(f"failed getting partition list: {exc}")
                        return 2
            finally:
                if close_input:
                    in_stream.close()
            if session is not None:
                # register path: shadow the raw rows NOW — after parse,
                # before settle mutates anything
                session.on_parsed(pl)

        if f_fused.value or f_solver.value in ("tpu", "beam"):
            # overlap the one-time device costs (the torch import, the CUDA
            # context) with the host work still
            # to come (pipeline head, repairs, encode): a fresh process,
            # the reference's per-move deployment unit, would otherwise pay
            # them one after another before its first launch. Started only
            # once the flags and the input have parsed, so the exit-1/2/3
            # argument and input errors never import torch, and never on
            # the greedy path. Inside a warm daemon (process_warm) those
            # costs are paid already. The thread never raises and never
            # decides anything: what it fails at, the planning path meets
            # again (exit 3). Daemon thread with a bounded exit-time join
            # (_track_warm_thread).
            import threading

            from kafkabalancer_tpu_torch.ops.coldstart import (
                process_warm,
                warm_backend,
            )

            if not process_warm():
                with obs.span("warm_thread_launch") as launch_sp:
                    warm = threading.Thread(
                        target=warm_backend,
                        kwargs=dict(device=device, trace_parent=launch_sp),
                        name="coldstart-warm",
                        daemon=True,
                    )
                    warm.start()
                _track_warm_thread(warm)

        from kafkabalancer_tpu_torch.balancer import BalanceError, balance

        # complete_partition is deliberately NOT copied into cfg: the
        # reference builds its RebalanceConfig without it
        # (kafkabalancer.go:167-173, so Go logs CompletePartition:false) and
        # acts on the *flag* in the main loop; we mirror both.
        cfg = RebalanceConfig(
            allow_leader_rebalancing=f_allow_leader.value,
            rebalance_leaders=f_rebalance_leader.value,
            min_replicas_for_rebalancing=f_min_replicas.value,
            min_unbalance=f_min_unbalance.value,
            complete_partition=False,
            brokers=brokers,
            solver=f_solver.value,
            beam_width=f_beam_width.value,
            beam_depth=f_beam_depth.value,
            beam_siblings=f_beam_siblings.value,
            anti_colocation=f_anti_coloc.value,
        )

        log(f"rebalance config: {_fmt_cfg(cfg)}")
        # the outcome slot is fresh per invocation: a daemon reuses
        # request threads, and a stale decline must not leak into this
        # invocation's plan.no_move_reason gauge
        convergence.clear_outcome()
        explain_rec: Optional[convergence.ConvergenceRecorder] = None
        if f_explain.value != "":
            explain_rec = convergence.ConvergenceRecorder()
            convergence.install(explain_rec)
            explain_installed = True
            explain_rec.attach(
                pl, cfg,
                mode=(
                    "fused-shard-scale" if f_shard_scale.value
                    else "fused-shard" if f_shard.value
                    else "fused" if f_fused.value
                    else "per-move"
                ),
                solver=f_solver.value,
                engine=f_engine.value if f_fused.value else None,
                batch=f_batch.value if f_fused.value else None,
                max_reassign=f_max.value,
            )

        # --- the main reassignment loop (kafkabalancer.go:177-221) -------
        opl = empty_partition_list()
        completing = False
        c_partition: Optional[Partition] = None
        r = f_max.value

        dev = None
        if f_fused.value or f_solver.value in ("tpu", "beam"):
            # the solver modules import torch here (a warm thread that is
            # importing it holds the import lock until it is done)
            with obs.span("resolve_device"):
                from kafkabalancer_tpu_torch.solvers.scan import resolve_device

            try:
                dev = resolve_device(device)
            except RuntimeError as exc:
                what = "-fused" if f_fused.value else f"-solver={f_solver.value}"
                log(f"{what} needs a CUDA GPU: {exc}")
                return 3

        if f_jaxprof.value:
            # -jax-profile: torch.profiler over the planning region, the
            # same region the reference's jax.profiler trace covers
            devprof = _DeviceProfile(f_jaxprof.value)
            try:
                devprof.start()
            except OSError as exc:
                devprof = None
                log(f"failed creating profile directory {f_jaxprof.value}: {exc}")
                return 4

        if f_fused.value:
            # whole-session device planning (solvers/scan.py) instead of the
            # per-move host loop; consumes the budget so the loop below is
            # skipped and the shared output tail applies unchanged
            from kafkabalancer_tpu_torch.solvers.scan import plan

            if f_solver.value != defaults.solver:
                log(
                    f"-fused implies the tpu session backend; ignoring "
                    f"-solver={f_solver.value}"
                )
            if f_polish.value and f_rebalance_leader.value:
                log(
                    "-fused-polish does not apply to the -rebalance-leader "
                    "session (leadership redistribution has no swap "
                    "neighborhood); ignoring it"
                )
            try:
                if f_shard.value:
                    # the sharded converge session over every visible GPU
                    # (parallel/shard_session.py), or over the one device
                    # the caller pinned
                    from kafkabalancer_tpu_torch.parallel.mesh import make_mesh
                    from kafkabalancer_tpu_torch.parallel.shard_session import (
                        plan_sharded,
                    )

                    if f_rebalance_leader.value:
                        log(
                            "-fused-shard with -rebalance-leader runs the "
                            "fused leader session single-device (its "
                            "Balance loop is sequential by contract)"
                        )
                    import torch

                    devices = (
                        [torch.device(d) for d in shard_devices]
                        if shard_devices else
                        [dev] if device is not None else
                        [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
                    )
                    # every device on the part axis: one session, S shards
                    mesh = make_mesh(devices=devices, shape=(1, len(devices)))
                    with obs.span(
                        "plan", mode="fused-shard", engine=f_engine.value,
                        polish=f_polish.value, scale=f_shard_scale.value,
                    ):
                        opl = plan_sharded(
                            pl, cfg, r, mesh,
                            batch=max(1, f_batch.value),
                            engine=f_engine.value,
                            polish=f_polish.value,
                            anti_colocation=max(0.0, f_anti_coloc.value),
                            scale=f_shard_scale.value,
                        )
                else:
                    with obs.span(
                        "plan", mode="fused", engine=f_engine.value,
                        polish=f_polish.value,
                    ):
                        opl = plan(
                            pl, cfg, r,
                            batch=max(1, f_batch.value),
                            engine=f_engine.value,
                            polish=f_polish.value,
                            device=dev,
                            anti_colocation=max(0.0, f_anti_coloc.value),
                        )
            except BalanceError as exc:
                log(f"failed optimizing distribution: {exc}")
                return 3
            log(f"fused session: {len(opl)} reassignments")
            r = 0
            # complete-partition extension (kafkabalancer.go:212-220): when
            # the budget was exhausted mid-stream, keep granting one extra
            # move while it still targets the same topic+partition as the
            # last budgeted one
            if (
                f_complete.value
                and len(opl) >= f_max.value
                and opl.partitions
            ):
                c_partition = opl.partitions[-1]
                completing = True
                log(f"Forcing complete of Partition: {c_partition}")
                r = 1

        with (
            obs.span("plan", mode="per-move", solver=f_solver.value)
            if r > 0
            else obs.NOOP_SPAN
        ):
            while r > 0:
                try:
                    ppl = balance(pl, cfg, log=log, device=dev)
                except BalanceError as exc:
                    log(f"failed optimizing distribution: {exc}")
                    return 3

                obs.metrics.count("cli.balance_calls")
                if len(ppl) == 0:
                    break

                # Apply every accepted change to the live list first: in the
                # reference the change is already applied (through slice
                # aliasing) before the loop inspects it, so even a move that
                # fails the complete-partition comparison below is visible in
                # -full-output (kafkabalancer.go:193-207 + SURVEY.md §2.2).
                lives = [
                    apply_assignment(pl, changed) for changed in ppl.partitions
                ]
                obs.metrics.count("cli.moves", len(lives))
                convergence.clear_outcome()

                if not completing:
                    opl.append(*lives)
                else:
                    stop = False
                    for idx, (changed, live) in enumerate(
                        zip(ppl.partitions, lives)
                    ):
                        if c_partition.compare(changed):
                            opl.append(live)
                        else:
                            log(f"Partition {changed} did not compare.")
                            # the probe move WAS applied to the live list
                            # (reference aliasing) but stays out of the
                            # plan: flag it, and any peers applied after
                            # it, so the explain document's emitted count
                            # matches the plan, and so a resident session
                            # reverts it, since the cluster never sees it
                            # (serve/sessions.py)
                            if explain_rec is not None:
                                explain_rec.mark_last_unemitted(
                                    len(lives) - idx
                                )
                            if session is not None:
                                session.mark_last_unemitted(
                                    len(lives) - idx
                                )
                            stop = True
                            break
                    if stop:
                        break

                r -= 1
                # when the budget is exhausted, keep granting one extra
                # iteration as long as each next move still targets the same
                # topic+partition (complete-partition mode,
                # kafkabalancer.go:212-220)
                if r == 0 and f_complete.value:
                    r = 1
                    if not completing:
                        c_partition = ppl.partitions[-1]
                        completing = True
                        log(f"Forcing complete of Partition: {c_partition}")

        # plan outcome attribution (the plan.stop_reason and
        # plan.no_move_reason gauges): the solver steps note why they
        # declined (obs/convergence.py's outcome slot); a below-threshold
        # exit is told apart from a converged one in -stats and
        # -metrics-json
        n_planned = len(opl)
        outcome = convergence.last_outcome()
        if outcome is None:
            stop_reason = (
                "no_budget" if f_max.value == 0
                else "budget_exhausted" if n_planned else "converged"
            )
        else:
            stop_reason = str(outcome.get("reason", "converged"))
            if outcome.get("classify_pending") and (
                tel.any() or explain_rec is not None
            ):
                # the fused session deferred the zero-move classification
                # (scan._note_session_outcome): resolved once, and only
                # because a telemetry consumer exists — the served steady
                # state of a converged cluster must not pay a host
                # candidate scan per request for gauges nobody exports
                from kafkabalancer_tpu_torch.balancer.steps import (
                    classify_no_move,
                )

                refined = classify_no_move(pl, cfg)
                stop_reason = str(refined["reason"])
                convergence.note_outcome(**refined)
                outcome = convergence.last_outcome()
            if outcome.get("feasible_unknown") and n_planned == 0:
                # the per-move decline sites note cheaply (they fire
                # every iteration); the O(P) existence pass runs once,
                # here, and only for the zero-move exit
                from kafkabalancer_tpu_torch.balancer.steps import (
                    _any_feasible_candidate,
                )

                feasible = _any_feasible_candidate(pl, cfg, False) or (
                    cfg.allow_leader_rebalancing
                    and _any_feasible_candidate(pl, cfg, True)
                )
                if not feasible:
                    stop_reason = "no_feasible_candidate"
                detail = {
                    k: v for k, v in outcome.items()
                    if k not in ("reason", "feasible_unknown")
                }
                if stop_reason == "no_feasible_candidate":
                    detail.pop("min_unbalance", None)
                convergence.note_outcome(stop_reason, **detail)
        obs.metrics.gauge("plan.stop_reason", stop_reason)
        tel.attrs.setdefault("plan.stop_reason", stop_reason)
        if n_planned == 0:
            obs.metrics.gauge("plan.no_move_reason", stop_reason)
            tel.attrs.setdefault("plan.no_move_reason", stop_reason)

        if devprof is not None:
            prof, devprof = devprof, None
            prof.stop(log)

        be.flush(True)

        with obs.span("emit", full=f_full.value, unique=f_unique.value):
            if f_full.value:
                opl = pl

            if f_unique.value:
                opl = filter_partition_list(opl)

            log("Writing %d changes." % len(opl))
            obs.metrics.count("cli.changes_written", len(opl))

            try:
                write_partition_list(o, opl)
            except CodecError as exc:
                log(f"failed writing partition list: {exc}")
                return 4

        if explain_rec is not None:
            # the explain document rides after the plan (the plan's bytes
            # are unchanged); the replay and the ranking happen here in
            # finalize, outside the planning wall
            import json as json_mod

            with obs.span("explain"):
                explain_doc = explain_rec.finalize()
            line = json_mod.dumps(
                explain_doc, sort_keys=True, separators=(",", ":"),
                default=str,
            ) + "\n"
            if f_explain.value == "-":
                o.write(line)
            else:
                try:
                    with open(f_explain.value, "w") as fh:
                        fh.write(line)
                except OSError as exc:
                    log(
                        "failed writing explain document to "
                        f"{f_explain.value}: {exc}"
                    )
                    return 4
            be.write(convergence.render_explain(explain_doc))

        return 0
    finally:
        if explain_installed:
            # never leak a recorder into the next request on this thread
            # (a daemon reuses request threads)
            convergence.uninstall()
        if devprof is not None:  # an early return inside the region
            devprof.stop(logger.printf)
        if profiler is not None:
            profiler.disable()
            # pprof-format output like the reference's pkg/profile
            # (kafkabalancer.go:100-102): go tool pprof cpu.pprof works
            from kafkabalancer_tpu_torch.utils.pprof import write_pprof

            try:
                write_pprof(
                    profiler, f_pprof_path.value,
                    duration_ns=time.perf_counter_ns() - prof_t0,
                )
            except OSError as exc:
                logger.printf(
                    "failed writing cpu profile to "
                    f"{f_pprof_path.value}: {exc}"
                )


def main() -> None:
    sys.exit(run(sys.stdin, sys.stdout, sys.stderr, ["kafkabalancer"] + sys.argv[1:]))


if __name__ == "__main__":
    main()
