"""``python -m kafkabalancer_tpu_torch.replay`` — run one seeded fleet-churn
replay against a live (or private, self-spawned) planning daemon of this
package and write the ``kafkabalancer-tpu.replay/5`` artifact. The flags
are the reference's (``python -m kafkabalancer_tpu.replay``).

Examples::

    # smoke: 3 tenants, 30 requests, private daemon, artifact to stdout
    python -m kafkabalancer_tpu_torch.replay

    # a real round: more tenants + churn, against an existing daemon
    python -m kafkabalancer_tpu_torch.replay --tenants 16 --requests 400 \\
        --topic-storm-every 40 --broker-failure-every 80 \\
        --socket /tmp/kafkabalancer-tpu-torch-0.sock --out replay.json

Exit codes: 0 = ran (artifact written; check ``reconciled`` yourself),
2 = ``--check`` was given and reconciliation failed, 3 = no daemon
could be reached/spawned.
"""

from __future__ import annotations

import argparse
import json
import sys

from kafkabalancer_tpu_torch.replay.harness import (
    ReplayConfig,
    ReplayError,
    render_summary,
    run_replay,
)


def main(argv: list) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kafkabalancer_tpu_torch.replay",
        description="seeded multi-tenant churn replay harness",
    )
    d = ReplayConfig()
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--tenants", type=int, default=d.tenants)
    p.add_argument("--requests", type=int, default=d.requests)
    p.add_argument(
        "--base-partitions", type=int, default=d.base_partitions,
        help="whale-tenant partition count (tail tenants scale down "
        "by the zipf skew)",
    )
    p.add_argument("--brokers", type=int, default=d.brokers)
    p.add_argument("--replicas", type=int, default=d.replicas)
    p.add_argument("--skew", type=float, default=d.skew)
    p.add_argument(
        "--arrival", choices=("weighted", "uniform"), default=d.arrival,
    )
    p.add_argument(
        "--diurnal-period", type=int, default=d.diurnal_period,
    )
    p.add_argument(
        "--diurnal-amplitude", type=float, default=d.diurnal_amplitude,
    )
    p.add_argument(
        "--weight-shift-every", type=int, default=d.weight_shift_every,
    )
    p.add_argument(
        "--weight-shift-frac", type=float, default=d.weight_shift_frac,
    )
    p.add_argument(
        "--broker-failure-every", type=int,
        default=d.broker_failure_every,
    )
    p.add_argument(
        "--topic-storm-every", type=int, default=d.topic_storm_every,
    )
    p.add_argument("--storm-size", type=int, default=d.storm_size)
    p.add_argument("--max-reassign", type=int, default=d.max_reassign)
    p.add_argument("--solver", default=d.solver)
    p.add_argument(
        "--socket", default="",
        help="existing daemon socket (default: spawn a private daemon)",
    )
    p.add_argument(
        "--no-spawn", action="store_true",
        help="never spawn a daemon (requires --socket)",
    )
    p.add_argument(
        "--latency-tolerance-buckets", type=int,
        default=d.latency_tolerance_buckets,
    )
    p.add_argument(
        "--no-parity", action="store_true",
        help="skip the -no-daemon plan byte-parity sample",
    )
    p.add_argument(
        "--chaos", action="store_true",
        help="fault-injection mode: arm a seeded fault schedule "
        "(lane crash, dispatch delays, socket drops, transfer "
        "failure) on a private daemon with tight admission caps, "
        "drive it from concurrent clients, and check plan-byte "
        "parity on EVERY answered request",
    )
    p.add_argument(
        "--chaos-faults", default="",
        help="override the seeded fault schedule "
        "(site@n[,n...][:arg];... — see -serve-faults)",
    )
    p.add_argument(
        "--concurrency", type=int, default=d.concurrency,
        help="chaos mode: concurrent client threads (the overload "
        "pressure)",
    )
    p.add_argument(
        "--restart", action="store_true",
        help="restart-recovery mode: SIGKILL the private daemon "
        "mid-churn and restart it on the same socket + warm spill "
        "dir — plan-byte parity on every answered request, "
        "restore-hit rate + pre/post-restart percentiles in the "
        "artifact (docs/serving.md § Session durability)",
    )
    p.add_argument(
        "--kill-after", type=int, default=d.restart_kill_after,
        help="restart mode: SIGKILL after this many requests "
        "(0 = half the run)",
    )
    p.add_argument(
        "--restart-faults", default=d.restart_faults,
        help="restart mode: fault schedule armed on the RESTARTED "
        "daemon (default: one restore_delay; '' disables). Use "
        "--chaos-faults for the pre-kill daemon (e.g. "
        "spill_corrupt@1)",
    )
    p.add_argument(
        "--watch", action="store_true",
        help="watch-mode scenario: spawn a -watch daemon against a "
        "fake Zookeeper tree, apply each emitted plan back (zero "
        "client plan ops), inject out-of-band drift, and assert "
        "plan-byte parity vs -no-daemon on every emitted plan plus "
        "the speculative hit rate (docs/serving.md § Watch mode)",
    )
    p.add_argument(
        "--watch-topics", type=int, default=d.watch_topics,
    )
    p.add_argument(
        "--watch-partitions", type=int, default=d.watch_partitions,
    )
    p.add_argument(
        "--watch-poll", type=float, default=d.watch_poll_s,
        help="watch mode: the daemon's -watch-poll interval",
    )
    p.add_argument(
        "--watch-flips", type=int, default=d.watch_flips,
        help="watch mode: out-of-band replica flips to inject",
    )
    p.add_argument(
        "--watch-creates", type=int, default=d.watch_creates,
        help="watch mode: topic creations to inject",
    )
    p.add_argument(
        "--out", default="-",
        help="artifact path ('-' = stdout, the default)",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 2 unless the run reconciled (counts exact, "
        "latencies within tolerance, parity sample ok)",
    )
    a = p.parse_args(argv)
    cfg = ReplayConfig(
        seed=a.seed, tenants=a.tenants, requests=a.requests,
        base_partitions=a.base_partitions, brokers=a.brokers,
        replicas=a.replicas, skew=a.skew, arrival=a.arrival,
        diurnal_period=a.diurnal_period,
        diurnal_amplitude=a.diurnal_amplitude,
        weight_shift_every=a.weight_shift_every,
        weight_shift_frac=a.weight_shift_frac,
        broker_failure_every=a.broker_failure_every,
        topic_storm_every=a.topic_storm_every,
        storm_size=a.storm_size, max_reassign=a.max_reassign,
        solver=a.solver, socket=a.socket, spawn=not a.no_spawn,
        latency_tolerance_buckets=a.latency_tolerance_buckets,
        parity_sample=not a.no_parity,
        chaos=a.chaos, chaos_faults=a.chaos_faults,
        concurrency=a.concurrency,
        restart=a.restart, restart_kill_after=a.kill_after,
        restart_faults=a.restart_faults,
        watch=a.watch, watch_topics=a.watch_topics,
        watch_partitions=a.watch_partitions,
        watch_poll_s=a.watch_poll,
        watch_flips=a.watch_flips, watch_creates=a.watch_creates,
    )
    try:
        artifact = run_replay(cfg)
    except ReplayError as exc:
        print(f"replay: {exc}", file=sys.stderr)
        return 3
    line = json.dumps(
        artifact, sort_keys=True, separators=(",", ":"), default=str,
    ) + "\n"
    if a.out == "-":
        sys.stdout.write(line)
    else:
        with open(a.out, "w") as f:
            f.write(line)
    if artifact.get("mode") == "chaos":
        sys.stderr.write(render_chaos_summary(artifact))
    elif artifact.get("mode") == "restart":
        sys.stderr.write(render_restart_summary(artifact))
    elif artifact.get("mode") == "watch":
        sys.stderr.write(render_watch_summary(artifact))
    else:
        sys.stderr.write(render_summary(artifact))
    if a.check:
        parity = artifact.get("parity")
        parity_ok = parity is None or bool(parity.get("ok"))
        if not (artifact.get("reconciled") and parity_ok):
            print("replay: reconciliation FAILED", file=sys.stderr)
            return 2
    return 0


def render_chaos_summary(artifact: dict) -> str:
    ch = artifact.get("chaos") or {}
    return (
        f"-- chaos replay (seed {artifact.get('seed')}): "
        f"{artifact.get('requests_issued')} requests, "
        f"{ch.get('answered')} answered (parity checked on every one), "
        f"{len(ch.get('wrong_plans') or [])} wrong plans, "
        f"{ch.get('shed_total')} sheds {ch.get('sheds')}, "
        f"{ch.get('quarantines')} quarantines / "
        f"{ch.get('requeues')} requeues / "
        f"{ch.get('recoveries')} recoveries, "
        f"faults fired {ch.get('faults_fired')}, "
        f"daemon alive {ch.get('daemon_alive_at_end')}, "
        f"ok={ch.get('ok')}\n"
    )


def render_watch_summary(artifact: dict) -> str:
    w = artifact.get("watch") or {}
    rate = w.get("spec_hit_rate")
    return (
        f"-- watch replay (seed {artifact.get('seed')}): "
        f"{w.get('plans_emitted')} plans emitted with ZERO client plan "
        f"ops (parity checked on every one), "
        f"{len(w.get('wrong_plans') or [])} wrong plans; speculative "
        f"hits {w.get('spec_hit_plans')} "
        f"({'n/a' if rate is None else f'{rate:.0%}'}), "
        f"{w.get('resyncs')} resyncs / {w.get('drift_events')} drift "
        f"events, {w.get('errors')} errors, identity "
        f"{w.get('speculation_identity_ok')}, ok={w.get('ok')}\n"
    )


def render_restart_summary(artifact: dict) -> str:
    r = artifact.get("restart") or {}
    rate = r.get("restore_hit_rate")
    return (
        f"-- restart replay (seed {artifact.get('seed')}): "
        f"{artifact.get('requests_issued')} requests, SIGKILL after "
        f"{r.get('kill_after')}, {r.get('answered')} answered "
        f"(parity checked on every one), "
        f"{len(r.get('wrong_plans') or [])} wrong plans; "
        f"restores {r.get('restores')} "
        f"(hits {r.get('restore_hits')}, rate "
        f"{'n/a' if rate is None else f'{rate:.0%}'}), "
        f"corrupt drops {r.get('corrupt_drops')}, "
        f"p95 pre {r.get('pre_restart_p95_s')}s / post "
        f"{r.get('post_restart_p95_s')}s, "
        f"paging identity {r.get('paging_identity_ok')}, "
        f"ok={r.get('ok')}\n"
    )


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
