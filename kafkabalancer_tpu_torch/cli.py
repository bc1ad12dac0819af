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
- ``-fused`` (with ``-fused-batch`` and ``-fused-engine=auto|xla``): the
  device converge session of ``solvers/scan.py`` with the hand-written
  scoring kernel, on CUDA. Without a GPU ``-fused`` exits 3; it never
  plans on the CPU by itself (``run(..., device="cpu")`` asks for that).

Every other flag of the reference is parsed; a flag whose feature is not
ported yet exits 3 with a one-line message naming its ROADMAP.md item
when it is given a non-default value.

State threading: the reference carries moves across ``Balance`` calls via
slice aliasing (SURVEY.md §2.2); accepted changes are applied to the live
list in place and the output accumulates references to the live
partitions.
"""

from __future__ import annotations

import sys
import time
from typing import Any, List, Optional

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
                p.replicas[:] = changed.replicas
                return p
    for p in pl.iter_partitions():
        if p.compare(changed):
            p.replicas[:] = changed.replicas
            return p
    raise BalanceError(f"changed partition {changed} not in input list")


# the reference's flags whose feature this package does not have yet,
# with the ROADMAP.md item that ports each: (name, kind, default, usage,
# item). They are parsed like the reference's; given a non-default value,
# each one exits 3 before any input is read.
_SERVING = "A7 (serving)"
_EXPORTERS = "A1 (telemetry exporters)"
_NOT_PORTED = [
    ("fused-polish", "bool", False, "Fused mode: pair-swap polish phases",
     "A5 (polish)"),
    ("fused-shard", "bool", False, "Fused mode: shard the session over "
     "devices", "A6 (multi-GPU)"),
    ("shard-scale", "bool", False, "Fused-shard scale tier", "A6 (multi-GPU)"),
    ("jax-profile", "string", "", "Device trace directory", "A9 (tooling)"),
    ("stats", "bool", False, "Invocation telemetry summary", _EXPORTERS),
    ("metrics-json", "string", "", "Invocation metrics JSON path", _EXPORTERS),
    ("trace", "string", "", "Perfetto host timeline path", _EXPORTERS),
    ("explain", "string", "", "Plan-explanation document path", _EXPORTERS),
    ("serve", "bool", False, "Run as a planning daemon", _SERVING),
    ("serve-socket", "string", "", "Daemon socket path", _SERVING),
    ("serve-idle-timeout", "float", 900.0, "Daemon idle shutdown seconds",
     _SERVING),
    ("serve-prewarm", "string", "", "Daemon prewarm shape grid", _SERVING),
    ("serve-lanes", "int", 0, "Daemon worker lanes", _SERVING),
    ("serve-microbatch", "int", 4, "Daemon fused-dispatch occupancy",
     _SERVING),
    ("serve-batch-mode", "string", "continuous", "Daemon batching "
     "discipline", _SERVING),
    ("serve-admission-hold", "int", 0, "Daemon admission hold", _SERVING),
    ("serve-slow-ms", "float", 0.0, "Daemon slow-request dump threshold",
     _SERVING),
    ("serve-tenant-cap", "int", 32, "Daemon per-tenant label bound",
     _SERVING),
    ("serve-max-queue", "int", 256, "Daemon admission-queue bound", _SERVING),
    ("serve-tenant-inflight", "int", 64, "Daemon per-tenant inflight cap",
     _SERVING),
    ("serve-watchdog", "float", 120.0, "Daemon lane watchdog seconds",
     _SERVING),
    ("serve-faults", "string", "", "Daemon fault-injection schedule",
     _SERVING),
    ("serve-session-spill-dir", "string", "", "Daemon warm session tier",
     _SERVING),
    ("serve-warm-cap-mb", "float", 256.0, "Daemon warm tier budget MB",
     _SERVING),
    ("serve-speculate", "bool", True, "Daemon speculative plan-ahead",
     _SERVING),
    ("serve-speculate-off", "bool", False, "Daemon: speculation off",
     _SERVING),
    ("watch", "string", "", "Daemon watch-driven controller", _SERVING),
    ("watch-emit", "string", "", "Watch mode plan sink", _SERVING),
    ("watch-poll", "float", 5.0, "Watch mode poll seconds", _SERVING),
    ("serve-client-timeout", "float", 0.0, "Client daemon wait bound",
     _SERVING),
    ("serve-session", "string", "", "Resident cluster session name",
     _SERVING),
    ("serve-no-session", "bool", False, "Never use resident sessions",
     _SERVING),
    ("edge-cache", "bool", True, "Client edge residency cache", _SERVING),
    ("no-edge-cache", "bool", False, "Client: disable the edge cache",
     _SERVING),
    ("serve-stats", "bool", False, "Scrape a daemon's telemetry", _SERVING),
    ("serve-stats-json", "bool", False, "Scrape a daemon's telemetry as JSON",
     _SERVING),
    ("serve-dump-trace", "string", "", "Export a daemon's flight recorder",
     _SERVING),
    ("metrics-prom", "string", "", "Scrape a daemon as Prometheus text",
     _SERVING),
]


def run(i, o, e, args: List[str], *, device: Any = None) -> int:
    """Testable CLI body; reference ``run`` (kafkabalancer.go:72-242).

    ``device`` pins the ``-fused`` session's device (``"cpu"`` in the
    tests); by default it is CUDA."""
    be = BufferingWriter(e)
    logger = Logger(be)
    obs.begin_invocation()
    try:
        return _run_impl(i, o, be, logger, args, device)
    finally:
        be.close()


def _run_impl(
    i, o, be: BufferingWriter, logger: Logger, args: List[str], device: Any
) -> int:
    log = logger.printf
    profiler = None

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
            "Optimization backend: greedy (reference parity); tpu and beam "
            "are not ported yet",
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
            "(0 disables; the -fused colocation session is not ported yet)",
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
            "the hand-written scoring kernel; pallas is not ported yet)",
        )
        f_pprof_path = f.string(
            "pprof-path",
            "cpu.pprof",
            "Write the -pprof CPU profile to this path",
        )
        f.bool(
            "no-daemon",
            False,
            "Never forward to a planning daemon (this package always plans "
            "in process)",
        )
        for name, kind, default, usage, _item in _NOT_PORTED:
            getattr(f, kind)(name, default, f"{usage} (not yet ported)")
        f_help = f.bool("help", False, "Display usage")

        def usage():
            be.write(f"Usage of {args[0] if args else 'kafkabalancer'}:\n")
            f.print_defaults()

        f.usage = usage
        # ContinueOnError semantics: parse errors print the error + usage and
        # execution continues with the flags parsed so far
        # (the reference ignores Parse's return value, kafkabalancer.go:98).
        f.parse(args[1:] if args else [])

        if f_pprof.value:
            import cProfile

            profiler = cProfile.Profile()
            prof_t0 = time.perf_counter_ns()
            profiler.enable()

        if f_help.value:
            usage()
            return 0

        with obs.span("validate_flags"):
            for name, _kind, _default, _usage, item in _NOT_PORTED:
                fl = f.flags[name]
                if fl.value != fl.default:
                    log(f"-{name} is not yet ported (ROADMAP.md {item})")
                    return 3

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

            if f_fused.value:
                if f_engine.value not in ENGINES:
                    log(f"unknown fused engine {f_engine.value!r}")
                    usage()
                    return 3
                for what, item, given in (
                    (f"-fused-engine={f_engine.value}",
                     "B2 (whole-session kernel)",
                     f_engine.value.startswith("pallas")),
                    ("-rebalance-leader with -fused",
                     "A5 (fused leader session)", f_rebalance_leader.value),
                    ("-anti-colocation with -fused",
                     "A4 (anti-colocation session)", f_anti_coloc.value > 0),
                ):
                    if given:
                        log(f"{what} is not yet ported (ROADMAP.md {item})")
                        return 3
            elif f_solver.value in ("tpu", "beam"):
                item = "A3" if f_solver.value == "tpu" else "A5"
                log(
                    f"-solver={f_solver.value} is not yet ported "
                    f"(ROADMAP.md {item})"
                )
                return 3

        topics = [t for t in f_topics.value.split(",") if len(t) >= 1]

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
        convergence.clear_outcome()

        # --- the main reassignment loop (kafkabalancer.go:177-221) -------
        opl = empty_partition_list()
        completing = False
        c_partition: Optional[Partition] = None
        r = f_max.value

        if f_fused.value:
            # whole-session device planning (solvers/scan.py) instead of the
            # per-move host loop; consumes the budget so the loop below is
            # skipped and the shared output tail applies unchanged
            from kafkabalancer_tpu_torch.solvers.scan import plan, resolve_device

            try:
                dev = resolve_device(device)
            except RuntimeError as exc:
                log(f"-fused needs a CUDA GPU: {exc}")
                return 3
            if f_solver.value != defaults.solver:
                log(
                    f"-fused implies the tpu session backend; ignoring "
                    f"-solver={f_solver.value}"
                )
            try:
                with obs.span("plan", mode="fused", engine=f_engine.value):
                    opl = plan(
                        pl, cfg, r,
                        batch=max(1, f_batch.value),
                        engine=f_engine.value,
                        device=dev,
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
                    ppl = balance(pl, cfg, log=log)
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
                    for changed, live in zip(ppl.partitions, lives):
                        if c_partition.compare(changed):
                            opl.append(live)
                        else:
                            log(f"Partition {changed} did not compare.")
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

        return 0
    finally:
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
