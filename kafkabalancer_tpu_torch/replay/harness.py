"""The fleet-churn replay harness: drive a live daemon closed-loop and
reconcile client-side truth against the daemon's per-tenant scrape.

Counterpart of the reference package's ``replay/harness.py``, driving
this package's daemon (``python -m kafkabalancer_tpu_torch -serve``)
through this package's forwarding client. A seeded
:class:`~kafkabalancer_tpu_torch.replay.synth.FleetSynth` generates
multi-tenant churn, every request runs through the REAL forwarding
client (``cli.run`` with a ``-serve-socket`` — the same code path the
production outer loop uses, resident-session ladder included), the
emitted plan is applied back to the tenant's state (the closed loop),
and at the end the harness fetches the daemon's ``serve-stats/8``
scrape and reconciles:

- per-tenant REQUEST COUNTS: the harness's issued counts must equal the
  daemon's ``tenants.top[t].requests`` EXACTLY (minus any pre-existing
  baseline when pointed at a shared daemon);
- per-tenant LATENCY: the scrape's per-tenant p50/p95/p99 must land
  within ``latency_tolerance_buckets`` histogram buckets of the same
  percentiles recomputed from the flight recorder's tenant-labeled
  request log — two INDEPENDENT daemon-side stores (bounded top-K
  family vs request ring) that agree only when every request landed in
  the right tenant's histogram with the right value. Client-side walls
  are recorded per tenant too (with their bucket distance from the
  daemon view) and sanity-bounded — the daemon percentile may not
  exceed the client's, since the client wall CONTAINS the daemon wall
  — but they are deliberately not held to one bucket: a converged
  delta-path tenant's daemon wall is near zero (that is the feature)
  while the client still pays its own O(P) parse + digest;
- optionally, PLAN BYTES: one sampled request re-planned ``-no-daemon``
  from identical input must produce byte-identical stdout (the serving
  layer's oldest pin, exercised under churn).

The result is one schema-versioned artifact
(``kafkabalancer-tpu.replay/5``, the reference's schema and keys, so
one reader serves both packages) with per-tenant tails, session-thrash
and fallback rates, and padded-slot waste. The harness itself imports
no torch: it is a client of the daemon, plus the in-process CLI for the
``-no-daemon`` oracles (which import torch only for the device paths:
``-solver=tpu``, ``-fused``). Those oracles plan on the card unless
:func:`run_replay` is given ``device`` (``"cpu"`` in the tests); a
spawned daemon always takes the card's devices, so on a machine without
one only the greedy solver runs through the spawned modes.
"""

from __future__ import annotations

import io
import json
import math
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from kafkabalancer_tpu_torch.obs.hist import (
    SUBBUCKETS,
    bucket_index,
    percentile_from_buckets,
)
from kafkabalancer_tpu_torch.replay.synth import FleetSynth

# v2: + "mode" ("churn" | "chaos") and the "chaos" block (null on churn
# runs) — the --chaos closed-loop fault-injection run: seeded fault
# schedule, concurrent clients driving sustained overload, plan-byte
# parity checked on EVERY answered request, and the daemon's
# shed/requeue/quarantine accounting reconciled exactly from the scrape
# v3: + mode "restart" and the "restart" block (null otherwise) — the
# --restart run SIGKILLs the daemon mid-churn and restarts it on the
# same socket + spill dir, asserting plan-byte parity on every answered
# request, reporting the restore-hit rate and the pre/post-restart p95,
# and reconciling the warm tier's conservation identity (spills +
# adopted == restores + corrupt_drops + evictions + warm_entries) from
# the serve-stats/8 "paging" block
# v4: + mode "watch" and the "watch" block (null otherwise) — the
# --watch run drives a ``-watch`` daemon through the fake-ZK seam
# ($KAFKABALANCER_TPU_FAKE_ZK): the synthesizer publishes ZK-shaped
# change events and applies each emitted plan back (the operator role),
# with ZERO client plan ops; asserts plan-byte parity vs -no-daemon on
# EVERY emitted plan (oracled against the exact state the watcher
# planned from, via the emit-sidecar digest), the speculative hit rate,
# external-drift resyncs, and the exact speculation identity
# hits + misses + poisoned (+ live memos) == attempts
# v5: + the "trace" block — end-to-end trace-id reconciliation: every
# served request's daemon flight record must carry the client's trace
# id EXACTLY (the client publishes each invocation's id via the
# ``client.trace_id`` gauge; the harness matches them one-to-one
# against the flight log's per-request ``trace`` keys), and the
# reconciliation verdict folds into the top-level ``reconciled``
REPLAY_SCHEMA_VERSION = 5
REPLAY_SCHEMA = f"kafkabalancer-tpu.replay/{REPLAY_SCHEMA_VERSION}"

LogFn = Callable[[str], None]


def _paging_count(paging: Dict[str, Any], key: str) -> int:
    """One int-coerced counter from the scrape's ``paging`` block."""
    v = paging.get(key, 0)
    return int(v) if isinstance(v, (int, float)) else 0


def _paging_identity_ok(paging: Dict[str, Any]) -> bool:
    """The warm tier's conservation identity: every record that entered the tier left it
    exactly once — restore, corrupt prune, or eviction — or is still
    resident. Asserted by BOTH the chaos and restart reconciliations,
    so the formula lives in one place."""
    return _paging_count(paging, "spills") + _paging_count(
        paging, "adopted"
    ) == (
        _paging_count(paging, "restores")
        + _paging_count(paging, "corrupt_drops")
        + _paging_count(paging, "evictions")
        + _paging_count(paging, "warm_entries")
    )


class ReplayError(RuntimeError):
    """The harness could not run at all (no daemon, spawn failure) —
    distinct from a run that completed but failed reconciliation."""


@dataclass
class ReplayConfig:
    """One replay run's knobs; defaults are smoke scale (seconds on a
    laptop CPU). Every field is a plain value — the artifact embeds the
    config verbatim, with the reference's fields and no others."""

    seed: int = 0
    tenants: int = 3
    requests: int = 30
    base_partitions: int = 48
    brokers: int = 8
    replicas: int = 3
    skew: float = 1.5
    arrival: str = "weighted"  # or "uniform"
    diurnal_period: int = 64
    diurnal_amplitude: float = 0.6
    weight_shift_every: int = 7
    weight_shift_frac: float = 0.1
    broker_failure_every: int = 0
    topic_storm_every: int = 0
    storm_size: int = 4
    max_reassign: int = 2
    solver: str = "greedy"
    # empty socket = spawn a private daemon (spawn=True) in a private
    # tempdir; a named socket targets an existing daemon and the
    # harness subtracts its pre-run per-tenant baseline from the counts
    socket: str = ""
    spawn: bool = True
    daemon_args: Tuple[str, ...] = field(default_factory=tuple)
    latency_tolerance_buckets: int = 1
    parity_sample: bool = True
    # chaos mode (--chaos): arm the daemon's fault seam with a seeded
    # schedule (chaos_faults, auto-derived from the seed when empty),
    # drive the fleet from `concurrency` concurrent clients against
    # tight admission caps (sustained overload -> sheds -> client
    # backoff -> in-process fallback), and check plan-byte parity vs
    # -no-daemon on EVERY answered request
    chaos: bool = False
    chaos_faults: str = ""
    concurrency: int = 8
    # restart mode (--restart): spawn a private daemon with a warm
    # spill dir, SIGKILL it after `restart_kill_after` requests (0 =
    # half the run), restart it on the same socket + spill dir, and
    # finish the churn — plan-byte parity on EVERY answered request,
    # restore-hit rate + post-restart p95 in the artifact. chaos_faults
    # arms the PRE-kill daemon (e.g. a seeded spill_corrupt); the
    # restarted daemon is armed with restart_faults (default: one
    # restore_delay, so the recovery-path chaos site is exercised in
    # every run)
    restart: bool = False
    restart_kill_after: int = 0
    restart_faults: str = "restore_delay@1:0.01"
    # watch mode (--watch): spawn a -watch daemon against a fake-ZK
    # directory tree ($KAFKABALANCER_TPU_FAKE_ZK), let it emit
    # `requests` plans closed-loop (the harness applies each plan back
    # to the fake cluster — zero client plan ops), and inject seeded
    # ZK-shaped change events: `watch_flips` out-of-band replica flips
    # and `watch_creates` topic creations, spread through the run
    watch: bool = False
    watch_topics: int = 3
    watch_partitions: int = 6
    watch_poll_s: float = 0.15
    watch_flips: int = 1
    watch_creates: int = 1


def _percentile_via_buckets(walls: List[float], q: float) -> float:
    """Client-side percentile folded through the SAME log buckets the
    daemon's streaming hists use, reported as the bucket upper bound —
    so daemon-vs-client comparison is bucket-index arithmetic, not
    float-noise comparison."""
    buckets: Dict[int, int] = {}
    for w in walls:
        i = bucket_index(w)
        buckets[i] = buckets.get(i, 0) + 1
    return percentile_from_buckets(buckets, q)


def edge_index(le: float) -> int:
    """The bucket whose upper edge ``le`` is, read by the NEAREST edge.

    A scraped percentile is an edge ``2**(i / SUBBUCKETS)`` rounded to 9
    digits in the stats doc (``obs/hist.py``), and for about half of the
    inexact edges that rounding lands just above the edge, where
    ``bucket_index`` (a ceiling) reads the next bucket.
    Edges lie a quarter octave apart, so the nearest one is the bucket
    whatever the rounding."""
    return round(math.log2(le) * SUBBUCKETS)


def _bucket_delta(client_le: float, daemon_le: float) -> Optional[int]:
    """Signed distance in log-bucket indexes between two bucket upper
    bounds (positive = client slower); None when either side is
    empty/zero."""
    if client_le <= 0.0 or daemon_le <= 0.0:
        return None
    return edge_index(client_le) - edge_index(daemon_le)


def chaos_fault_spec(seed: int, requests: int) -> str:
    """A seeded fault schedule sized to one chaos run: a lane crash
    mid-run, dispatch delays sprinkled through the first half (they
    build the overload queue), socket drops, and one device-transfer
    failure. Deterministic in the seed; the exact request each firing
    lands on still depends on scheduling, which is the point — parity
    must hold regardless."""
    import random as random_mod

    rng = random_mod.Random(seed ^ 0xC4A05)
    n = max(12, requests)
    crash_at = rng.randint(3, max(4, n // 3))
    # the overload phase: a run of slow dispatches jams the (single)
    # lane so the concurrent clients overflow the admission queue —
    # sustained overload by construction, not by luck
    pool = list(range(2, max(12, 2 * n // 3)))
    delays = sorted(rng.sample(pool, min(6, len(pool))))
    drops = sorted(rng.sample(range(2, max(6, n - 2)), 2))
    xfer_at = rng.randint(2, max(3, n - 2))
    spill_fail_at = rng.randint(2, max(3, n // 2))
    return (
        f"lane_crash@{crash_at}"
        f";dispatch_delay@{','.join(str(d) for d in delays)}:0.5"
        f";socket_drop@{','.join(str(d) for d in drops)}"
        f";transfer_fail@{xfer_at}"
        # the warm tier's write path under chaos: one continuous-spill
        # write dies like a full disk (paging.write_failures) — the
        # request's answer and the hot session are untouched
        f";spill_write_fail@{spill_fail_at}"
    )


def _spawn_daemon(
    sock: str,
    tenants: int,
    extra: Tuple[str, ...],
    log: LogFn,
    lane_args: Tuple[str, ...] = ("-serve-lanes=1",),
    env: Optional[Dict[str, str]] = None,
) -> Any:
    """Start a private daemon subprocess (``python -m
    kafkabalancer_tpu_torch -serve``) on ``sock`` and wait for its
    hello. ``-serve-lanes=1`` keeps the single-lane Coalescer, and the
    tenant-label cap is sized to the fleet — a 40-tenant replay against
    the default cap of 32 would demote early tenants into ``other``
    and the count reconciliation could never succeed. (When targeting
    an EXISTING daemon via ``socket=``, its ``-serve-tenant-cap`` must
    be >= the replay's tenant count for the same reason.)"""
    import subprocess
    import sys

    from kafkabalancer_tpu_torch.serve import client as sclient

    args = [
        sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
        f"-serve-socket={sock}", "-serve-idle-timeout=300",
        *lane_args,
        f"-serve-tenant-cap={max(32, tenants)}", *extra,
    ]
    proc = subprocess.Popen(
        args,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        env={**os.environ, **env} if env else None,
    )
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise ReplayError(
                f"replay daemon exited rc={proc.returncode} during startup"
            )
        if sclient.daemon_alive(sock) is not None:
            log(f"replay: private daemon up on {sock} (pid {proc.pid})")
            return proc
        time.sleep(0.05)
    proc.terminate()
    raise ReplayError("replay daemon never became ready")


def _tenant_scrape_counts(doc: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """Per-tenant daemon request counts from a scrape doc ({} when the
    daemon has no tenants block — e.g. a pre-v4 daemon)."""
    out: Dict[str, int] = {}
    if not isinstance(doc, dict):
        return out
    tenants = doc.get("tenants")
    if not isinstance(tenants, dict):
        return out
    top = tenants.get("top")
    if isinstance(top, dict):
        for name, e in top.items():
            if isinstance(e, dict):
                out[name] = int(e.get("requests", 0))
    return out


def _make_synth(cfg: ReplayConfig) -> FleetSynth:
    """One FleetSynth wired from the config — every replay mode
    (plain, --chaos, --restart) must drive the identical seeded
    churn, so the knob wiring lives in one place."""
    return FleetSynth(
        seed=cfg.seed,
        tenants=cfg.tenants,
        base_partitions=cfg.base_partitions,
        brokers=cfg.brokers,
        replicas=cfg.replicas,
        skew=cfg.skew,
        arrival=cfg.arrival,
        diurnal_period=cfg.diurnal_period,
        diurnal_amplitude=cfg.diurnal_amplitude,
        weight_shift_every=cfg.weight_shift_every,
        weight_shift_frac=cfg.weight_shift_frac,
        broker_failure_every=cfg.broker_failure_every,
        topic_storm_every=cfg.topic_storm_every,
        storm_size=cfg.storm_size,
    )


def _oracle_kw(device: Any) -> Dict[str, Any]:
    """``cli.run``'s keyword arguments for an in-process ``-no-daemon``
    oracle: the device to plan on, when one was given (else the card)."""
    return {} if device is None else {"device": device}


def run_replay(
    cfg: ReplayConfig, log: Optional[LogFn] = None, device: Any = None
) -> Dict[str, Any]:
    """Run one seeded replay; returns the ``kafkabalancer-tpu.replay/5``
    artifact (see the module docstring). Raises :class:`ReplayError`
    only when no daemon could be reached/spawned — a reconciliation
    failure is DATA (``reconciled: false``), not an exception, so a
    benchmark lands the evidence instead of dying. ``device`` pins the
    in-process ``-no-daemon`` oracles' device (default: the card)."""
    import sys

    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.obs import metrics as obs_metrics
    from kafkabalancer_tpu_torch.serve import client as sclient

    _log: LogFn = log or (
        lambda msg: print(msg, file=sys.stderr, flush=True)
    )
    if cfg.chaos:
        return _run_chaos(cfg, _log, device)
    if cfg.restart:
        return _run_restart(cfg, _log, device)
    if cfg.watch:
        return _run_watch(cfg, _log, device)
    tmpdir = None
    sock = cfg.socket
    spawned = None
    if not sock:
        # unix socket paths cap at ~104 bytes: a short private tempdir
        tmpdir = tempfile.mkdtemp(prefix="kb-replay-")
        sock = os.path.join(tmpdir, "kb.sock")
        if cfg.spawn:
            spawned = _spawn_daemon(
                sock, cfg.tenants, cfg.daemon_args, _log
            )
    try:
        hello = sclient.daemon_alive(sock)
        if hello is None:
            raise ReplayError(f"no live daemon on {sock}")
        baseline = _tenant_scrape_counts(sclient.fetch_stats(sock))

        synth = _make_synth(cfg)
        base_argv = [
            "kafkabalancer", "-input-json",
            f"-serve-socket={sock}",
            f"-max-reassign={cfg.max_reassign}",
        ]
        if cfg.solver != "greedy":
            base_argv.append(f"-solver={cfg.solver}")

        walls: Dict[str, List[float]] = {
            t.name: [] for t in synth.tenants
        }
        issued: Dict[str, int] = {t.name: 0 for t in synth.tenants}
        # one entry per SUCCESSFUL step: the trace id the client minted
        # for that forwarded invocation (None when the forward fell back
        # in-process — then no daemon flight record exists to match)
        trace_ids: List[Optional[str]] = []
        errors: List[Dict[str, Any]] = []
        parity: Optional[Dict[str, Any]] = None
        parity_step = cfg.requests // 2 if cfg.parity_sample else -1
        t_run0 = time.perf_counter()
        for step in range(cfg.requests):
            tenant, fired = synth.step(step)
            text = tenant.text()
            argv = base_argv + [f"-serve-session={tenant.name}"]
            if step == parity_step:
                # the parity sample: the SAME input planned in-process
                # (-no-daemon) must emit byte-identical plan stdout —
                # run it FIRST (it mutates nothing), then the served one
                out_l, err_l = io.StringIO(), io.StringIO()
                rc_l = cli.run(
                    io.StringIO(text), out_l, err_l,
                    argv + ["-no-daemon"], **_oracle_kw(device),
                )
                parity = {
                    "step": step, "tenant": tenant.name,
                    "rc_local": rc_l, "stdout_local": out_l.getvalue(),
                }
            out, err = io.StringIO(), io.StringIO()
            # clear any stale trace id first: against an in-process
            # multi-lane daemon the registry is SHARED (daemon-lifetime
            # stores, no begin_invocation reset), so without this a
            # fallback step would re-read the previous step's id
            obs_metrics.gauge("client.trace_id", None)
            t0 = time.perf_counter()
            rc = cli.run(io.StringIO(text), out, err, argv)
            wall = time.perf_counter() - t0
            if parity is not None and parity.get("step") == step:
                # resolve the sample NOW, before any early continue,
                # and pop BOTH blobs unconditionally — the raw plan
                # text must never ride into the artifact/summary
                stdout_l = parity.pop("stdout_local", None)
                rc_l = parity.pop("rc_local", None)
                parity["ok"] = (
                    rc == 0
                    and rc_l == rc
                    and stdout_l == out.getvalue()
                )
            if rc != 0:
                errors.append({
                    "step": step, "tenant": tenant.name, "rc": rc,
                    "stderr_tail": err.getvalue()[-400:],
                })
                continue
            walls[tenant.name].append(wall)
            issued[tenant.name] += 1
            # the served invocation's trace id: the edge recorder
            # published it as a gauge right before cli.run returned
            # (the registry is only reset by the NEXT invocation's
            # begin_invocation, so the read-after-return is safe)
            tid = obs_metrics.snapshot()["gauges"].get("client.trace_id")
            trace_ids.append(tid if isinstance(tid, str) and tid else None)
            tenant.apply_plan(out.getvalue())
        wall_s = time.perf_counter() - t_run0

        doc = sclient.fetch_stats(sock)
        # the daemon's own per-request evidence: the flight recorder's
        # tenant-labeled request log (wall_s per request) — the
        # independent store the scrape's per-tenant hists reconcile
        # against
        trace = sclient.fetch_trace(sock)
        flight_requests: List[Dict[str, Any]] = []
        if isinstance(trace, dict):
            td = trace.get("trace")
            if isinstance(td, dict):
                od = td.get("otherData")
                if isinstance(od, dict) and isinstance(
                    od.get("requests"), list
                ):
                    flight_requests = [
                        r for r in od["requests"] if isinstance(r, dict)
                    ]
        return _build_artifact(
            cfg, synth, walls, issued, errors, parity, baseline, doc,
            flight_requests, wall_s, trace_ids,
        )
    finally:
        if spawned is not None:
            try:
                sclient.request_shutdown(sock)
                spawned.wait(15)
            except Exception:
                spawned.terminate()
        if tmpdir is not None:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)


def _run_chaos(
    cfg: ReplayConfig, _log: LogFn, device: Any = None
) -> Dict[str, Any]:
    """The ``--chaos`` closed loop: a private daemon armed with a
    seeded fault schedule and TIGHT admission caps, driven by
    ``cfg.concurrency`` concurrent clients (sustained overload by
    construction). Every answered request's plan is compared
    byte-for-byte against a fresh ``-no-daemon`` run of the identical
    input — lane crashes, dispatch delays, socket drops, transfer
    failures and sheds may slow requests or push them to the
    in-process fallback, but NEVER change a plan's bytes. At the end
    the daemon must still be alive, and its shed/requeue/quarantine
    accounting must reconcile exactly inside the scrape:

    - ``admission.shed_total == sum(admission.sheds.values())``
      ``== sum(per-tenant sheds incl. other)``;
    - ``admission.arrivals == admitted + shed_total``;
    - ``admitted == requests + lane_health.abandoned`` (every admitted
      request either ran to an answer or was structurally abandoned by
      the health monitor — nothing vanished);
    - no lane still quarantined (every crash/wedge recovered).
    """
    import threading

    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.serve import client as sclient

    spec = cfg.chaos_faults or chaos_fault_spec(cfg.seed, cfg.requests)
    tmpdir = tempfile.mkdtemp(prefix="kb-chaos-")
    sock = os.path.join(tmpdir, "kb.sock")
    # -serve-lanes=0 -serve-microbatch=2 forces the LaneScheduler even
    # on one device (the lane_crash site lives in its workers); tight
    # caps make the concurrent clients overflow the queue; the high
    # watchdog never false-triggers on a slow CI box but still arms
    # crashed-worker detection (interval-independent)
    daemon_args: Tuple[str, ...] = (
        "-serve-microbatch=2",
        f"-serve-faults={spec}",
        "-serve-max-queue=2",
        "-serve-tenant-inflight=8",
        "-serve-watchdog=30",
        # the warm tier rides the chaos run too: the seeded
        # spill_write_fail exercises its failure path, and the paging
        # identity below must reconcile exactly THROUGH the chaos
        f"-serve-session-spill-dir={os.path.join(tmpdir, 'spill')}",
        "-serve-warm-cap-mb=64",
        *cfg.daemon_args,
    )
    spawned = _spawn_daemon(
        sock, cfg.tenants, daemon_args, _log,
        lane_args=("-serve-lanes=0",),
    )
    try:
        synth = _make_synth(cfg)
        base_argv = [
            "kafkabalancer", "-input-json",
            f"-serve-socket={sock}",
            f"-max-reassign={cfg.max_reassign}",
            # a bounded, deadline-carrying wait: sheds travel as
            # retry_after frames, the backoff ladder runs, and a
            # wedged daemon can cost at most this per request
            "-serve-client-timeout=30",
        ]
        if cfg.solver != "greedy":
            base_argv.append(f"-solver={cfg.solver}")

        synth_lock = threading.Lock()
        tenant_locks = {t.name: threading.Lock() for t in synth.tenants}
        issued: Dict[str, int] = {t.name: 0 for t in synth.tenants}
        answered = 0
        wrong: List[Dict[str, Any]] = []
        errors: List[Dict[str, Any]] = []
        step_box = [0]
        stats_lock = threading.Lock()

        def worker() -> None:
            nonlocal answered
            while True:
                with synth_lock:
                    step = step_box[0]
                    if step >= cfg.requests:
                        return
                    step_box[0] = step + 1
                    tenant, _fired = synth.step(step)
                with tenant_locks[tenant.name]:
                    text = tenant.text()
                    argv = base_argv + [
                        f"-serve-session={tenant.name}"
                    ]
                    # the oracle FIRST (mutates nothing): the same
                    # input planned in-process is the byte truth every
                    # answered plan must match
                    out_l, err_l = io.StringIO(), io.StringIO()
                    rc_l = cli.run(
                        io.StringIO(text), out_l, err_l,
                        argv + ["-no-daemon"], **_oracle_kw(device),
                    )
                    out_s, err_s = io.StringIO(), io.StringIO()
                    rc_s = cli.run(io.StringIO(text), out_s, err_s, argv)
                    with stats_lock:
                        issued[tenant.name] += 1
                        if rc_s != rc_l:
                            errors.append({
                                "step": step, "tenant": tenant.name,
                                "rc": rc_s, "rc_local": rc_l,
                                "stderr_tail": err_s.getvalue()[-300:],
                            })
                        elif rc_s == 0:
                            answered += 1
                            if out_s.getvalue() != out_l.getvalue():
                                wrong.append({
                                    "step": step,
                                    "tenant": tenant.name,
                                })
                    if rc_s == 0:
                        tenant.apply_plan(out_s.getvalue())

        t_run0 = time.perf_counter()
        threads = [
            threading.Thread(target=worker, name=f"chaos-{i}", daemon=True)
            for i in range(max(1, cfg.concurrency))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        # -- the SUSTAINED-OVERLOAD phase (deterministic, not timing
        # luck): one deliberately slow request occupies the single lane
        # while a burst of concurrent clients arrives — arrivals past
        # the admission window + -serve-max-queue MUST shed, the shed
        # clients back off honoring retry_after_ms, and every one of
        # them still ends with a byte-correct answer (a later admit or
        # the in-process fallback). Locals run AFTER the burst (the
        # inputs are static) so the burst's arrival concurrency is real.
        import random as random_mod

        ovl_rng = random_mod.Random(cfg.seed ^ 0x0F10AD)
        from kafkabalancer_tpu_torch.replay.synth import TenantState

        blocker = TenantState(
            "chaos-blocker", ovl_rng, partitions=4000,
            brokers=cfg.brokers, replicas=cfg.replicas,
            arrival_weight=1.0, diurnal_phase=0.0,
        )
        burst_tenants = [
            TenantState(
                f"chaos-burst-{i:02d}", ovl_rng, partitions=16,
                brokers=cfg.brokers, replicas=cfg.replicas,
                arrival_weight=1.0, diurnal_phase=0.0,
            )
            for i in range(12)
        ]
        ovl_results: Dict[str, Tuple[int, str]] = {}
        ovl_lock = threading.Lock()

        def fire(t: "TenantState") -> None:
            out, err = io.StringIO(), io.StringIO()
            rc = cli.run(
                io.StringIO(t.text()), out, err,
                base_argv + [f"-serve-session={t.name}"],
            )
            with ovl_lock:
                ovl_results[t.name] = (rc, out.getvalue())

        blocker_t = threading.Thread(target=fire, args=(blocker,))
        blocker_t.start()
        time.sleep(0.5)  # the blocker holds the lane before the burst
        burst_threads = [
            threading.Thread(target=fire, args=(t,))
            for t in burst_tenants
        ]
        for t in burst_threads:
            t.start()
        for t in burst_threads:
            t.join()
        blocker_t.join()
        for t in [blocker] + burst_tenants:
            out_l, err_l = io.StringIO(), io.StringIO()
            rc_l = cli.run(
                io.StringIO(t.text()), out_l, err_l,
                base_argv + [
                    f"-serve-session={t.name}", "-no-daemon",
                ],
                **_oracle_kw(device),
            )
            rc_s, stdout_s = ovl_results.get(t.name, (None, ""))
            with stats_lock:
                issued.setdefault(t.name, 0)
                issued[t.name] += 1
                if rc_s != rc_l:
                    errors.append({
                        "phase": "overload", "tenant": t.name,
                        "rc": rc_s, "rc_local": rc_l,
                    })
                elif rc_s == 0:
                    answered += 1
                    if stdout_s != out_l.getvalue():
                        wrong.append({
                            "phase": "overload", "tenant": t.name,
                        })
        wall_s = time.perf_counter() - t_run0

        alive = sclient.daemon_alive(sock) is not None
        doc = sclient.fetch_stats(sock) or {}
        adm = doc.get("admission") or {}
        lh = doc.get("lane_health") or {}
        flt = doc.get("faults") or {}
        tenants_block = doc.get("tenants") or {}
        sheds_by_reason = adm.get("sheds") or {}
        shed_total = int(adm.get("shed_total", 0))
        tenant_sheds = sum(
            int(e.get("sheds", 0))
            for e in (tenants_block.get("top") or {}).values()
            if isinstance(e, dict)
        ) + int((tenants_block.get("other") or {}).get("sheds", 0) or 0)
        paging = doc.get("paging") or {}

        identities = {
            "sheds_sum_matches": shed_total == sum(
                int(v) for v in sheds_by_reason.values()
            ),
            "tenant_sheds_match": tenant_sheds == shed_total,
            "arrivals_conserved": int(adm.get("arrivals", -1)) == (
                int(adm.get("admitted", 0)) + shed_total
            ),
            "admitted_conserved": int(adm.get("admitted", -1)) == (
                int(doc.get("requests", 0))
                + int(lh.get("abandoned", 0))
            ),
            "no_lane_still_quarantined": not lh.get("quarantined"),
            # the warm tier's conservation identity holds THROUGH the
            # chaos (the seeded spill_write_fail sits outside it by
            # construction — a failed write never entered the tier)
            "paging_conserved": _paging_identity_ok(paging),
        }
        chaos_ok = (
            alive
            and not wrong
            and all(identities.values())
            and shed_total >= 1  # the overload phase actually happened
        )
        chaos_block = {
            "faults_spec": spec,
            "faults_fired": flt.get("fired") or {},
            "concurrency": max(1, cfg.concurrency),
            "answered": answered,
            "parity_checked": answered,
            "wrong_plans": wrong,
            "sheds": sheds_by_reason,
            "shed_total": shed_total,
            # the live estimate the shed frames carried (scrape view);
            # the frame-level pin (retry_after_ms >= 1 on every shed)
            # is tests/test_overload.py's job
            "retry_after_ms_estimate": int(adm.get("retry_after_ms", 0)),
            "quarantines": int(lh.get("quarantines", 0)),
            "requeues": int(lh.get("requeues", 0)),
            "recoveries": int(lh.get("recoveries", 0)),
            "abandoned": int(lh.get("abandoned", 0)),
            # the warm tier under chaos: the seeded spill_write_fail
            # lands here, and the spill/restore counters prove the
            # tier kept its books through the storm
            "spill_write_failures": _paging_count(paging, "write_failures"),
            "spills": _paging_count(paging, "spills"),
            "daemon_alive_at_end": alive,
            "identities": identities,
            "ok": chaos_ok,
        }
        total = sum(issued.values())
        return {
            "schema": REPLAY_SCHEMA,
            "scrape_schema": doc.get("schema"),
            "mode": "chaos",
            "chaos": chaos_block,
            "restart": None,
            "watch": None,
            "seed": cfg.seed,
            "config": asdict(cfg),
            "requests_issued": total,
            "request_errors": errors,
            "wall_s": round(wall_s, 3),
            "throughput_rps": (
                round(total / wall_s, 3) if wall_s > 0 else None
            ),
            "events": dict(synth.events),
            "per_tenant": {
                t.name: {
                    "issued": issued[t.name],
                    # daemon-SERVED count from the scrape: the fairness
                    # signal (a tenant the daemon shed into oblivion
                    # shows issued > 0 but daemon_requests == 0)
                    "daemon_requests": int(
                        (
                            (tenants_block.get("top") or {})
                            .get(t.name) or {}
                        ).get("requests", 0)
                    ),
                    "moves_applied": t.moves_applied,
                    "partitions": len(t.rows),
                }
                for t in synth.tenants
            },
            "reconciled": chaos_ok and not errors,
        }
    finally:
        if spawned is not None:
            try:
                sclient.request_shutdown(sock)
                spawned.wait(15)
            except Exception:
                spawned.terminate()
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)


def _run_restart(
    cfg: ReplayConfig, _log: LogFn, device: Any = None
) -> Dict[str, Any]:
    """The ``--restart`` closed loop: a private daemon with a warm
    spill dir is SIGKILLed after ``restart_kill_after`` requests (no
    shutdown flush — recovery must work from the CONTINUOUS per-request
    spill alone), restarted on the same socket + spill dir (the
    stale-socket takeover sweeps the dead pidfile; the spill-dir claim
    adopts the orphaned records), and the churn finishes through it.

    Every request, both phases, is checked byte-for-byte against a
    fresh ``-no-daemon`` oracle of the identical input — a restore may
    be slow, cold, or corrupt-dropped, but NEVER wrong. The artifact's
    ``restart`` block reports the restore-hit rate (digest-matching
    requests answered from spill, i.e. no re-register storm), the
    pre/post-restart latency percentiles (the restart-recovery curve),
    and the warm tier's conservation identity
    reconciled exactly from the serve-stats/8 ``paging`` scrape.

    ``chaos_faults`` arms the PRE-kill daemon (a seeded
    ``spill_corrupt`` makes a tenant's recovery a cold-but-correct
    miss); ``restart_faults`` arms the restarted one (default: one
    ``restore_delay``, so the recovery path's chaos site fires in
    every run)."""
    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.serve import client as sclient

    tmpdir = tempfile.mkdtemp(prefix="kb-restart-")
    sock = os.path.join(tmpdir, "kb.sock")
    spill_dir = os.path.join(tmpdir, "spill")
    spill_args: Tuple[str, ...] = (
        f"-serve-session-spill-dir={spill_dir}",
        "-serve-warm-cap-mb=64",
    )
    pre_args = spill_args + cfg.daemon_args
    if cfg.chaos_faults:
        pre_args += (f"-serve-faults={cfg.chaos_faults}",)
    spawned = _spawn_daemon(sock, cfg.tenants, pre_args, _log)
    kill_after = cfg.restart_kill_after or max(1, cfg.requests // 2)
    kill_after = min(kill_after, max(1, cfg.requests - 1))
    try:
        synth = _make_synth(cfg)
        base_argv = [
            "kafkabalancer", "-input-json",
            f"-serve-socket={sock}",
            f"-max-reassign={cfg.max_reassign}",
            # bounded per-request wait: the mid-churn kill must cost
            # one fallback at worst, never an hour of hanging
            "-serve-client-timeout=30",
        ]
        if cfg.solver != "greedy":
            base_argv.append(f"-solver={cfg.solver}")

        issued: Dict[str, int] = {t.name: 0 for t in synth.tenants}
        wrong: List[Dict[str, Any]] = []
        errors: List[Dict[str, Any]] = []
        walls_pre: List[float] = []
        walls_post: List[float] = []
        first_post: Dict[str, float] = {}
        pre_tenants: set = set()
        post_tenants: set = set()
        answered = 0

        def one_step(step: int) -> Tuple[str, float, int]:
            nonlocal answered
            tenant, _fired = synth.step(step)
            text = tenant.text()
            argv = base_argv + [f"-serve-session={tenant.name}"]
            # the oracle FIRST (mutates nothing): the same input
            # planned in-process is the byte truth the served answer
            # must match — through spill, restore, corruption and all
            out_l, err_l = io.StringIO(), io.StringIO()
            rc_l = cli.run(
                io.StringIO(text), out_l, err_l, argv + ["-no-daemon"],
                **_oracle_kw(device),
            )
            out_s, err_s = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            rc_s = cli.run(io.StringIO(text), out_s, err_s, argv)
            wall = time.perf_counter() - t0
            issued[tenant.name] += 1
            if rc_s != rc_l:
                errors.append({
                    "step": step, "tenant": tenant.name,
                    "rc": rc_s, "rc_local": rc_l,
                    "stderr_tail": err_s.getvalue()[-300:],
                })
            elif rc_s == 0:
                answered += 1
                if out_s.getvalue() != out_l.getvalue():
                    wrong.append({"step": step, "tenant": tenant.name})
                tenant.apply_plan(out_s.getvalue())
            return tenant.name, wall, rc_s

        t_run0 = time.perf_counter()
        for step in range(kill_after):
            name, wall, _rc = one_step(step)
            walls_pre.append(wall)
            pre_tenants.add(name)

        # SIGKILL — no shutdown op, no flush, no pidfile cleanup: the
        # restart must recover from the continuous spill plus the
        # stale-socket takeover rules alone
        pid = spawned.pid
        spawned.kill()
        spawned.wait(15)
        _log(f"replay: SIGKILLed daemon pid {pid} after {kill_after} requests")
        post_args = spill_args + cfg.daemon_args
        if cfg.restart_faults:
            post_args += (f"-serve-faults={cfg.restart_faults}",)
        spawned = _spawn_daemon(sock, cfg.tenants, post_args, _log)

        for step in range(kill_after, cfg.requests):
            name, wall, rc = one_step(step)
            walls_post.append(wall)
            post_tenants.add(name)
            if rc == 0:
                first_post.setdefault(name, wall)
        wall_s = time.perf_counter() - t_run0

        doc = sclient.fetch_stats(sock) or {}
        paging = doc.get("paging") or {}
        tenants_block = doc.get("tenants") or {}
        sessions = doc.get("sessions") or {}
        flt = doc.get("faults") or {}

        def pg(key: str) -> int:
            return _paging_count(paging, key)

        identity_ok = _paging_identity_ok(paging)
        # every post-restart tenant that had pre-kill traffic owns a
        # spilled record, so its first post-restart request attempts
        # exactly one restore: a validated read (restores) or a pruned
        # corrupt one (corrupt_drops)
        expected = len(pre_tenants & post_tenants)
        attempts = pg("restores") + pg("corrupt_drops")
        restore_hits = pg("restore_hits")
        ok = (
            not wrong
            and not errors
            and identity_ok
            and sclient.daemon_alive(sock) is not None
        )
        restart_block = {
            "kill_after": kill_after,
            "spill_dir_reused": True,
            "faults_pre": cfg.chaos_faults or None,
            "faults_post": cfg.restart_faults or None,
            "faults_fired_post": flt.get("fired") or {},
            "answered": answered,
            "parity_checked": answered,
            "wrong_plans": wrong,
            "spills": pg("spills"),
            "adopted": pg("adopted"),
            "restores": pg("restores"),
            "restore_hits": restore_hits,
            "corrupt_drops": pg("corrupt_drops"),
            "evictions": pg("evictions"),
            "write_failures": pg("write_failures"),
            "warm_entries": pg("warm_entries"),
            "warm_bytes": pg("warm_bytes"),
            "paging_identity_ok": identity_ok,
            "expected_restore_attempts": expected,
            "restore_attempts": attempts,
            "restore_attempts_ok": attempts == expected,
            # the headline: digest-matching requests answered from
            # spill — 1.0 means the whole fleet came back without a
            # single re-register
            "restore_hit_rate": (
                round(restore_hits / expected, 4) if expected else None
            ),
            # re-register storm indicators on the restarted daemon: a
            # cold miss (absent/corrupt record) answers the plan-delta
            # with resync:full and the client re-registers — counted
            # as a session_absent fallback + a register
            "resyncs_full_post": int(sessions.get("resyncs_full", 0)),
            "cold_misses_post": int(
                (doc.get("fallbacks") or {}).get("session_absent", 0)
            ),
            "registered_post": int(sessions.get("registered", 0)),
            # the restart-recovery curve: client-side percentiles
            # before the kill vs after it (the first post-restart
            # request per tenant pays the restore + re-settle)
            "pre_restart_p50_s": round(
                _percentile_via_buckets(walls_pre, 0.50), 9
            ) if walls_pre else None,
            "pre_restart_p95_s": round(
                _percentile_via_buckets(walls_pre, 0.95), 9
            ) if walls_pre else None,
            "post_restart_p50_s": round(
                _percentile_via_buckets(walls_post, 0.50), 9
            ) if walls_post else None,
            "post_restart_p95_s": round(
                _percentile_via_buckets(walls_post, 0.95), 9
            ) if walls_post else None,
            "first_post_restart_max_s": (
                round(max(first_post.values()), 6) if first_post else None
            ),
            "daemon_alive_at_end": sclient.daemon_alive(sock) is not None,
            "ok": ok,
        }
        total = sum(issued.values())
        return {
            "schema": REPLAY_SCHEMA,
            "scrape_schema": doc.get("schema"),
            "mode": "restart",
            "chaos": None,
            "restart": restart_block,
            "watch": None,
            "seed": cfg.seed,
            "config": asdict(cfg),
            "requests_issued": total,
            "request_errors": errors,
            "wall_s": round(wall_s, 3),
            "throughput_rps": (
                round(total / wall_s, 3) if wall_s > 0 else None
            ),
            "events": dict(synth.events),
            "per_tenant": {
                t.name: {
                    "issued": issued[t.name],
                    "daemon_requests": int(
                        (
                            (tenants_block.get("top") or {})
                            .get(t.name) or {}
                        ).get("requests", 0)
                    ),
                    "restores": int(
                        (
                            (tenants_block.get("top") or {})
                            .get(t.name) or {}
                        ).get("restores", 0)
                    ),
                    "moves_applied": t.moves_applied,
                    "partitions": len(t.rows),
                }
                for t in synth.tenants
            },
            "reconciled": ok,
        }
    finally:
        if spawned is not None:
            try:
                sclient.request_shutdown(sock)
                spawned.wait(15)
            except Exception:
                spawned.terminate()
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)


def _run_watch(
    cfg: ReplayConfig, _log: LogFn, device: Any = None
) -> Dict[str, Any]:
    """The ``--watch`` closed loop: a private ``-watch`` daemon reads a
    fake Zookeeper tree (``$KAFKABALANCER_TPU_FAKE_ZK`` — the
    codecs/zookeeper.py ``FileZkClient`` seam works across processes),
    plans continuously, and emits plans to a directory sink; the
    harness plays the OPERATOR — it applies each emitted plan back to
    the fake cluster and injects seeded out-of-band change events
    (replica flips, topic creations) — and issues ZERO client plan ops
    (asserted from the scrape's ``requests``). Every emitted plan is
    byte-compared against a ``-no-daemon`` oracle of the EXACT state
    the watcher planned from (the emit sidecar's digest indexes the
    synthesizer's snapshot mirror, so read/mutation interleavings
    cannot confuse the oracle). The watch run is ``-max-reassign=1``
    by construction: one emitted move touches one topic file, so every
    state a concurrent watch read can observe is one the mirror knows.

    Reconciles, exactly: the speculation identity
    ``attempts == hits + misses + poisoned + memos``, resyncs >= the
    injected drift events, zero watch errors, and the speculative hit
    rate (the steady state should be memo reads)."""
    import glob as glob_mod

    from kafkabalancer_tpu_torch import cli
    from kafkabalancer_tpu_torch.replay.synth import ZkClusterSynth
    from kafkabalancer_tpu_torch.serve import client as sclient

    tmpdir = tempfile.mkdtemp(prefix="kb-watch-")
    sock = os.path.join(tmpdir, "kb.sock")
    zk_root = os.path.join(tmpdir, "zk")
    emit_dir = os.path.join(tmpdir, "plans")
    synth = ZkClusterSynth(
        cfg.seed, zk_root,
        topics=cfg.watch_topics,
        partitions_per=cfg.watch_partitions,
        brokers=cfg.brokers,
        replicas=cfg.replicas,
    )
    spawned = _spawn_daemon(
        sock, cfg.tenants,
        (
            "-watch=fake:2181",
            f"-watch-emit={emit_dir}",
            f"-watch-poll={cfg.watch_poll_s}",
            "-serve-idle-timeout=300",
            "-max-reassign=1",
            *(() if cfg.solver == "greedy" else (f"-solver={cfg.solver}",)),
            *cfg.daemon_args,
        ),
        _log,
        env={"KAFKABALANCER_TPU_FAKE_ZK": zk_root},
    )
    try:
        if sclient.daemon_alive(sock) is None:
            raise ReplayError(f"no live watch daemon on {sock}")
        target = max(4, cfg.requests)
        flip_at = sorted(
            max(2, (i + 1) * target // (cfg.watch_flips + 1))
            for i in range(max(0, cfg.watch_flips))
        )
        create_at = sorted(
            max(3, (i + 1) * target // (cfg.watch_creates + 1)) + 1
            for i in range(max(0, cfg.watch_creates))
        )
        wrong: List[Dict[str, Any]] = []
        oracle_missing = 0
        spec_hit_plans = 0
        seen = 0
        converged = False
        t_run0 = time.perf_counter()
        last_progress = time.monotonic()
        while seen < target:
            files = sorted(
                glob_mod.glob(os.path.join(emit_dir, "plan-*.json"))
            )
            if len(files) <= seen:
                if time.monotonic() - last_progress > 30.0:
                    break  # wedged or converged: reconcile what we have
                w = (sclient.fetch_watch(sock) or {}).get("watch") or {}
                if (
                    w.get("state_digest") == synth.digest()
                    and int(w.get("noop_plans", 0) or 0) >= 1
                ):
                    converged = True
                    break
                time.sleep(min(0.05, cfg.watch_poll_s))
                continue
            last_progress = time.monotonic()
            path = files[seen]
            plan_text = open(path).read()
            try:
                meta = json.load(open(path[: -len(".json")] + ".meta"))
            except (OSError, ValueError):
                meta = {}
            if meta.get("spec_hit"):
                spec_hit_plans += 1
            # oracle the plan against the EXACT state it was computed
            # from (the sidecar digest indexes the snapshot mirror)
            oracle_text = synth.snapshots.get(str(meta.get("digest")))
            if oracle_text is None:
                oracle_missing += 1
            else:
                out_l, err_l = io.StringIO(), io.StringIO()
                rc_l = cli.run(
                    io.StringIO(oracle_text), out_l, err_l,
                    [
                        "kafkabalancer", "-input-json",
                        "-max-reassign=1", "-no-daemon",
                    ] + (
                        [] if cfg.solver == "greedy"
                        else [f"-solver={cfg.solver}"]
                    ),
                    **_oracle_kw(device),
                )
                if rc_l != 0 or out_l.getvalue() != plan_text:
                    wrong.append({"plan": seen + 1, "rc_local": rc_l})
            synth.apply_plan(plan_text)
            seen += 1
            if seen in flip_at:
                synth.external_flip()
            if seen in create_at:
                synth.create_topic()
        wall_s = time.perf_counter() - t_run0

        doc = sclient.fetch_stats(sock) or {}
        watch = doc.get("watch") or {}
        spec = doc.get("speculation") or {}
        ident_ok = int(spec.get("attempts", -1)) == (
            int(spec.get("hits", 0)) + int(spec.get("misses", 0))
            + int(spec.get("poisoned", 0)) + int(spec.get("memos", 0))
        )
        drift_events = sum(synth.events.values())
        zero_client_ops = int(doc.get("requests", -1)) == 0
        spec_hits = int(watch.get("spec_hits", 0) or 0)
        hit_rate = round(spec_hit_plans / seen, 4) if seen else None
        ok = (
            seen >= 3
            and not wrong
            and oracle_missing == 0
            and ident_ok
            and zero_client_ops
            and int(watch.get("errors", 0) or 0) == 0
            # drift was noticed: back-to-back events can coalesce into
            # one watcher read, so >= 1 resync per run with any drift
            # (parity after each drift is covered per emitted plan)
            and (
                drift_events == 0
                or int(watch.get("resyncs", 0) or 0) >= 1
            )
            and spec_hits >= 1
        )
        watch_block = {
            "plans_emitted": seen,
            "daemon_plans_emitted": int(watch.get("plans_emitted", 0) or 0),
            "parity_checked": seen - oracle_missing,
            "oracle_missing": oracle_missing,
            "wrong_plans": wrong,
            "spec_hit_plans": spec_hit_plans,
            "spec_hit_rate": hit_rate,
            "resyncs": int(watch.get("resyncs", 0) or 0),
            "drift_events": drift_events,
            "noop_plans": int(watch.get("noop_plans", 0) or 0),
            "errors": int(watch.get("errors", 0) or 0),
            "reads": int(watch.get("reads", 0) or 0),
            "ticks": int(watch.get("ticks", 0) or 0),
            "converged": converged,
            "last_event_lag_s": watch.get("last_event_lag_s"),
            "last_plan_s": watch.get("last_plan_s"),
            "speculation": spec,
            "speculation_identity_ok": ident_ok,
            "zero_client_plan_ops": zero_client_ops,
            "ok": ok,
        }
        return {
            "schema": REPLAY_SCHEMA,
            "scrape_schema": doc.get("schema"),
            "mode": "watch",
            "chaos": None,
            "restart": None,
            "watch": watch_block,
            "seed": cfg.seed,
            "config": asdict(cfg),
            # the whole point: the plans above required NO client
            # plan-family requests at all
            "requests_issued": 0,
            "request_errors": [],
            "wall_s": round(wall_s, 3),
            "throughput_rps": (
                round(seen / wall_s, 3) if wall_s > 0 else None
            ),
            "events": dict(synth.events),
            "per_tenant": {},
            "reconciled": ok,
        }
    finally:
        if spawned is not None:
            try:
                sclient.request_shutdown(sock)
                spawned.wait(15)
            except Exception:
                spawned.terminate()
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)


def _build_artifact(
    cfg: ReplayConfig,
    synth: FleetSynth,
    walls: Dict[str, List[float]],
    issued: Dict[str, int],
    errors: List[Dict[str, Any]],
    parity: Optional[Dict[str, Any]],
    baseline: Dict[str, int],
    doc: Optional[Dict[str, Any]],
    flight_requests: List[Dict[str, Any]],
    wall_s: float,
    trace_ids: Optional[List[Optional[str]]] = None,
) -> Dict[str, Any]:
    tenants_block = (
        doc.get("tenants") if isinstance(doc, dict) else None
    ) or {}
    top = tenants_block.get("top") or {}
    flight_walls: Dict[str, List[float]] = {}
    for r in flight_requests:
        t_name = r.get("tenant")
        w_s = r.get("wall_s")
        if isinstance(t_name, str) and isinstance(w_s, (int, float)):
            flight_walls.setdefault(t_name, []).append(float(w_s))
    per_tenant: Dict[str, Any] = {}
    counts_ok = True
    latency_ok = True
    for t in synth.tenants:
        name = t.name
        entry = top.get(name) if isinstance(top, dict) else None
        w = sorted(walls[name])
        fw = sorted(flight_walls.get(name, []))
        # a tenant the scrape has never seen reports 0 — correct when
        # the arrival process never picked it, a miss when it did (a
        # demotion past the cap, or lost attribution)
        daemon_requests = (
            int(entry.get("requests", 0)) - baseline.get(name, 0)
            if isinstance(entry, dict) else 0
        )
        t_counts_ok = daemon_requests == issued[name]
        counts_ok = counts_ok and t_counts_ok
        rec: Dict[str, Any] = {
            "issued": issued[name],
            "daemon_requests": daemon_requests,
            "counts_ok": t_counts_ok,
            "moves_applied": t.moves_applied,
            "partitions": len(t.rows),
        }
        dh = entry.get("request_s") if isinstance(entry, dict) else None
        # latency is VERIFIABLE for this tenant only when the daemon's
        # request ring still holds exactly this tenant's requests (the
        # 512-entry ring truncates long runs, and a shared daemon's
        # foreign traffic evicts replay entries) and no pre-run
        # baseline pollutes the hist. Unverifiable latency is reported
        # as unchecked — never conflated with a reconciliation failure.
        fresh = (
            baseline.get(name, 0) == 0
            and isinstance(dh, dict)
            and len(fw) == issued[name]
        )
        lat_deltas: Dict[str, Optional[int]] = {}
        client_deltas: Dict[str, Optional[int]] = {}
        covers = True
        for qname, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            client_le = _percentile_via_buckets(w, q) if w else 0.0
            flight_le = _percentile_via_buckets(fw, q) if fw else 0.0
            daemon_le = (
                float(dh.get(qname, 0.0)) if isinstance(dh, dict) else 0.0
            )
            rec[f"client_{qname}"] = round(client_le, 9)
            rec[f"daemon_{qname}"] = round(daemon_le, 9)
            rec[f"flight_{qname}"] = round(flight_le, 9)
            # the gate: scrape hist vs flight log, two independent
            # daemon-side stores of the same per-request walls
            lat_deltas[qname] = (
                _bucket_delta(daemon_le, flight_le) if fresh else None
            )
            # reported, not gated: how far the end-to-end client view
            # sits above the daemon view (the delta/steady-state gap)
            client_deltas[qname] = _bucket_delta(client_le, daemon_le)
            # compared by bucket index, never by float: the scraped
            # edge may sit a rounding above the client's exact one
            if (client_deltas[qname] or 0) < 0:
                covers = False
        rec["latency_bucket_delta"] = lat_deltas
        rec["client_bucket_delta"] = client_deltas
        # sanity bound: the client wall CONTAINS the daemon wall, so a
        # daemon percentile above the client's means mis-attribution
        rec["client_covers_daemon"] = covers
        checked = fresh and bool(w)
        rec["latency_checked"] = checked
        if checked:
            t_lat_ok = covers and all(
                d is not None and abs(d) <= cfg.latency_tolerance_buckets
                for d in lat_deltas.values()
            )
        else:
            # unverifiable (ring overflow / shared daemon / no
            # requests): vacuously ok, flagged unchecked above
            t_lat_ok = True
        rec["latency_ok"] = t_lat_ok
        latency_ok = latency_ok and t_lat_ok
        if isinstance(entry, dict):
            rec.update({
                "delta_hits": int(entry.get("delta_hits", 0)),
                "resyncs_rows": int(entry.get("resyncs_rows", 0)),
                "resyncs_full": int(entry.get("resyncs_full", 0)),
                "fallbacks": int(entry.get("fallbacks", 0)),
                "session_bytes": int(entry.get("session_bytes", 0)),
            })
            n = issued[name]
            rec["delta_hit_rate"] = (
                round(rec["delta_hits"] / n, 4) if n else 0.0
            )
        per_tenant[name] = rec

    # -- end-to-end trace-id reconciliation (replay/5): every served
    # request's daemon flight record must carry the client's trace id,
    # EXACTLY. The client minted one id per forwarded invocation (read
    # back from the ``client.trace_id`` gauge); the daemon stamped it
    # into the flight ring's per-request record. Verifiable only when
    # every successful step actually forwarded (no fallbacks — a
    # fallback leaves no flight record to match) and the ring still
    # holds one record per issued request (512-entry ring, shared
    # daemons pollute it). Unverifiable is flagged unchecked, never
    # conflated with a reconciliation failure.
    captured = [t for t in (trace_ids or []) if isinstance(t, str)]
    flight_trace_counts: Dict[str, int] = {}
    flight_tagged = 0
    for r in flight_requests:
        rt = r.get("trace")
        if isinstance(rt, str):
            flight_tagged += 1
            flight_trace_counts[rt] = flight_trace_counts.get(rt, 0) + 1
    n_issued_total = sum(issued.values())
    trace_checked = (
        n_issued_total > 0
        and len(captured) == n_issued_total
        and len(flight_requests) == n_issued_total
    )
    if trace_checked:
        trace_ok = (
            len(set(captured)) == len(captured)
            and flight_tagged == n_issued_total
            and all(
                flight_trace_counts.get(t, 0) == 1 for t in captured
            )
        )
    else:
        trace_ok = True  # vacuous; flagged via "checked" below
    trace_block = {
        "ids_issued": len(captured),
        "ids_unique": len(set(captured)) == len(captured),
        "flight_tagged": flight_tagged,
        "flight_records": len(flight_requests),
        "checked": trace_checked,
        "reconciled": trace_ok,
    }

    sessions = (doc or {}).get("sessions") or {}
    total = sum(issued.values())
    fallbacks_total = sum(
        e.get("fallbacks", 0) for e in per_tenant.values()
        if isinstance(e, dict)
    )
    reconciled = counts_ok and latency_ok and trace_ok and not errors
    if parity is not None and "ok" not in parity:
        # safety net: never let the raw plan text reach the artifact
        parity.pop("stdout_local", None)
        parity.pop("rc_local", None)
        parity["ok"] = False
    return {
        "schema": REPLAY_SCHEMA,
        "scrape_schema": (doc or {}).get("schema"),
        "mode": "churn",
        "chaos": None,
        "restart": None,
        "watch": None,
        "seed": cfg.seed,
        "config": asdict(cfg),
        "requests_issued": total,
        "request_errors": errors,
        "wall_s": round(wall_s, 3),
        "throughput_rps": round(total / wall_s, 3) if wall_s > 0 else None,
        "events": dict(synth.events),
        "per_tenant": per_tenant,
        "session_thrash": {
            "evicted_lru": int(sessions.get("evicted_lru", 0)),
            "expired_idle": int(sessions.get("expired_idle", 0)),
            "resyncs_rows": int(sessions.get("resyncs_rows", 0)),
            "resyncs_full": int(sessions.get("resyncs_full", 0)),
            "rate": (
                round(
                    (
                        int(sessions.get("resyncs_rows", 0))
                        + int(sessions.get("resyncs_full", 0))
                        + int(sessions.get("evicted_lru", 0))
                    ) / total,
                    4,
                ) if total else None
            ),
        },
        "fallback_rate": (
            round(fallbacks_total / total, 4) if total else None
        ),
        # padded-slot waste under mixed buckets: only a lane-scheduler
        # daemon (microbatch > 1) reports nonzero here — the smoke
        # single-lane daemon pins the schema with zeros
        "padded_slots": int((doc or {}).get("mb_padded_slots", 0)),
        "microbatched": int((doc or {}).get("microbatched", 0)),
        "tenant_cap": int(tenants_block.get("cap", 0)),
        "tenants_demoted": int(tenants_block.get("demoted", 0)),
        "parity": parity,
        "reconciled_counts": counts_ok,
        # latency_checked: every tenant with traffic was actually
        # verifiable (fresh hist + complete flight log); when False,
        # reconciled_latency is (partly) vacuous — consumers that need
        # the strong claim (the gate) assert both
        "latency_checked": all(
            e["latency_checked"]
            for e in per_tenant.values() if e["issued"]
        ),
        "reconciled_latency": latency_ok,
        # the trace-id reconciliation evidence (see the block above);
        # its verdict participates in "reconciled"
        "trace": trace_block,
        "reconciled": reconciled,
    }


def render_summary(artifact: Dict[str, Any]) -> str:
    """A short human summary of one replay artifact (stderr of the
    ``python -m kafkabalancer_tpu_torch.replay`` entry point)."""
    lines = [
        f"-- replay {artifact['schema']} (seed {artifact['seed']}): "
        f"{artifact['requests_issued']} requests, "
        f"{artifact['wall_s']}s wall, "
        f"reconciled={artifact['reconciled']}",
        f"  events: {artifact['events']}",
    ]
    for name, e in sorted(artifact.get("per_tenant", {}).items()):
        lines.append(
            f"  {name}: {e['issued']} req "
            f"(daemon {e['daemon_requests']}, counts_ok {e['counts_ok']}) "
            f"client p50/p95/p99 {e['client_p50']:.4g}/"
            f"{e['client_p95']:.4g}/{e['client_p99']:.4g}s "
            f"delta-hit {e.get('delta_hit_rate', 0):.0%} "
            f"resyncs {e.get('resyncs_rows', 0)}r/"
            f"{e.get('resyncs_full', 0)}f "
            f"latency_ok {e['latency_ok']}"
        )
    if artifact.get("parity") is not None:
        lines.append(f"  parity sample: {artifact['parity']}")
    return "\n".join(lines) + "\n"
