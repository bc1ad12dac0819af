"""The port's fleet-churn replay harness (kafkabalancer_tpu_torch/replay/)
held against the reference's (kafkabalancer_tpu/replay/) on the CPU.

The pins:

- the port's synthesizers are copies: for several seeds the same trail
  of tenants, events and state text as the reference's ``FleetSynth``,
  and the same published states, digests and oracle texts as its
  ``ZkClusterSynth``;
- a churn replay through the port's forwarding client against the port's
  daemon equals the reference's replay against the reference's daemon
  (both in this process, on the CPU): the same issued counts, events,
  per-tenant counts, reconciliation, parity sample and final tenant
  states, with ``-solver=greedy`` and with ``-solver=tpu`` (every move
  through the device pass);
- the spawned modes on ``python -m kafkabalancer_tpu_torch -serve``:
  SIGKILL restart from the warm tier, a corrupt record as a cold miss,
  ``-watch`` over the fake-ZK seam, and ``--chaos`` with the seeded lane
  crash fired (the one-lane scheduler, as in the reference);
- no daemon is an error, and the entry point's ``--check`` exits 0 on a
  reconciled run;
- the bucket-edge read: a scraped percentile (an edge rounded to 9
  digits) goes back to its bucket by the nearest edge in the port, where
  the reference's ceiling read lands one bucket up for every edge whose
  rounding goes up (pinned as the reference's flaw).
"""

import json
import math
import os
import shutil
import tempfile

import pytest

from kafkabalancer_tpu.obs import hist as jhist
from kafkabalancer_tpu.replay import harness as jharness
from kafkabalancer_tpu.replay import synth as jsynth
from kafkabalancer_tpu_torch.replay import (
    REPLAY_SCHEMA,
    ReplayConfig,
    ReplayError,
    run_replay,
)
from kafkabalancer_tpu_torch.obs import hist as thist
from kafkabalancer_tpu_torch.replay import harness as tharness
from kafkabalancer_tpu_torch.replay import synth as tsynth
from torch_helpers import PkgDaemon, package

QUIET = dict(log=lambda _m: None)


# --- the synthesizers ---------------------------------------------------------


def _fleet_trail(mod, seed, steps):
    synth = mod.FleetSynth(
        seed, tenants=4, base_partitions=40, brokers=7,
        weight_shift_every=5, topic_storm_every=7, broker_failure_every=9,
    )
    trail = []
    for step in range(steps):
        tenant, fired = synth.step(step)
        trail.append((tenant.name, tuple(fired), tenant.text()))
    return trail, dict(synth.events), [t.text() for t in synth.tenants]


@pytest.mark.parametrize("seed", [0, 7, 42, 1234])
def test_fleet_synth_trail_equals_the_reference(seed):
    assert _fleet_trail(tsynth, seed, 40) == _fleet_trail(jsynth, seed, 40)


def _zk_trail(mod, seed):
    root = tempfile.mkdtemp(prefix="kbz-")
    try:
        z = mod.ZkClusterSynth(seed, root, topics=3, partitions_per=5,
                               brokers=6, replicas=2)
        trail = [(z.digest(), z.input_text())]
        for i in range(4):
            trail.append(z.external_flip() if i % 2 == 0 else z.create_topic())
        files = {}
        tdir = os.path.join(root, "brokers", "topics")
        for name in sorted(os.listdir(tdir)):
            with open(os.path.join(tdir, name)) as fh:
                files[name] = fh.read()
        return trail, dict(z.snapshots), dict(z.events), files
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_zk_synth_states_and_digests_equal_the_reference(seed):
    assert _zk_trail(tsynth, seed) == _zk_trail(jsynth, seed)


# --- the churn replay against each package's daemon ---------------------------


def _churn(pkg_name, harness_mod, cfg_kw, monkeypatch, **run_kw):
    """One churn replay of ``pkg_name``'s harness against its daemon in
    this process; returns the artifact and the synthesizer it drove."""
    seen = []
    make = harness_mod._make_synth

    def capture(cfg):
        seen.append(make(cfg))
        return seen[-1]

    monkeypatch.setattr(harness_mod, "_make_synth", capture)
    pkg = package(pkg_name)
    d = tempfile.mkdtemp(prefix="kbr-")
    daemon = PkgDaemon(pkg, os.path.join(d, "kb.sock"))
    daemon.start()
    try:
        cfg = harness_mod.ReplayConfig(
            socket=daemon.sock, spawn=False, **cfg_kw
        )
        art = harness_mod.run_replay(cfg, **QUIET, **run_kw)
    finally:
        daemon.stop()
        shutil.rmtree(d, ignore_errors=True)
    return art, seen[0]


CHURN = {
    "greedy": dict(seed=7, tenants=3, requests=30, topic_storm_every=11,
                   broker_failure_every=13),
    "tpu": dict(seed=3, tenants=3, requests=12, topic_storm_every=5,
                broker_failure_every=7, solver="tpu"),
}


def _nearest_edge_latency_verdict(art):
    """The reference artifact's latency verdict recomputed from its own
    per-tenant ``daemon_p*`` / ``flight_p*`` / ``client_p*`` fields, each
    read back to its bucket by the NEAREST edge: the scrape-vs-flight
    deltas within the configured tolerance and the client covering the
    daemon, on every checked tenant."""
    tol = art["config"]["latency_tolerance_buckets"]

    def idx(le):
        return round(math.log2(le) * jhist.SUBBUCKETS)

    ok = True
    for e in art["per_tenant"].values():
        if not e["latency_checked"]:
            continue
        for q in ("p50", "p95", "p99"):
            d, f, c = e[f"daemon_{q}"], e[f"flight_{q}"], e[f"client_{q}"]
            ok = ok and d > 0 and f > 0 and abs(idx(d) - idx(f)) <= tol
            if c > 0 and d > 0:
                ok = ok and idx(c) >= idx(d)
    return ok


@pytest.mark.parametrize("solver", sorted(CHURN))
def test_churn_replay_equals_the_reference(solver, monkeypatch):
    if solver == "tpu":
        from kafkabalancer_tpu.solvers import tpu as jtpu
        from kafkabalancer_tpu_torch.solvers import tpu as ttpu

        monkeypatch.setattr(jtpu, "MIN_DEVICE_CANDIDATES", 0)
        monkeypatch.setattr(ttpu, "MIN_DEVICE_CANDIDATES", 0)
    cfg_kw = CHURN[solver]
    ja, jsyn = _churn("jax", jharness, cfg_kw, monkeypatch)
    ta, tsyn = _churn("torch", tharness, cfg_kw, monkeypatch, device="cpu")
    assert ta["schema"] == ja["schema"] == REPLAY_SCHEMA
    assert ta["scrape_schema"] == ja["scrape_schema"]
    assert set(ta) == set(ja)
    assert dict(ta["config"], socket="") == dict(ja["config"], socket="")
    assert ta["request_errors"] == ja["request_errors"] == []
    assert ta["requests_issued"] == ja["requests_issued"] == cfg_kw["requests"]
    assert ta["events"] == ja["events"]
    assert ta["events"]["topic_storm"] >= 1
    assert ta["events"]["broker_failure"] >= 1
    for name, je in ja["per_tenant"].items():
        te = ta["per_tenant"][name]
        for key in ("issued", "daemon_requests", "counts_ok",
                    "moves_applied", "partitions"):
            assert te[key] == je[key], (name, key)
    assert sorted(ta["per_tenant"]) == sorted(ja["per_tenant"])
    assert ta["reconciled"] is True
    # the reference's verdict with its bucket-edge flaw taken out: its
    # counts and trace ids as before, its latency recomputed with the
    # nearest-edge read (a tenant's one request in an upward-rounding
    # bucket fails its ceiling read; see the edge tests below)
    assert ja["reconciled_counts"] is True
    assert ja["trace"]["checked"] and ja["trace"]["reconciled"]
    assert ja["latency_checked"] is True
    assert _nearest_edge_latency_verdict(ja) is True
    assert ta["latency_checked"] is True
    assert ta["trace"]["checked"] and ta["trace"]["reconciled"]
    assert ta["parity"] == ja["parity"]
    assert ta["parity"]["ok"] is True
    # the closed loop left every tenant in the same state in both packages
    assert [t.text() for t in tsyn.tenants] == [t.text() for t in jsyn.tenants]
    assert sum(t.moves_applied for t in tsyn.tenants) >= 1


def test_artifact_keys_equal_the_reference():
    """The artifact's top-level and per-tenant keys are the reference's
    replay/5 schema (one reader serves both packages)."""
    from torch_helpers import running_daemon

    with running_daemon() as (sock, _d, _logs):
        art = run_replay(
            ReplayConfig(seed=1, tenants=2, requests=6, socket=sock,
                         spawn=False, parity_sample=False),
            **QUIET, device="cpu",
        )
    assert set(art) == {
        "schema", "scrape_schema", "mode", "chaos", "restart", "watch",
        "seed", "config",
        "requests_issued", "request_errors", "wall_s", "throughput_rps",
        "events", "per_tenant", "session_thrash", "fallback_rate",
        "padded_slots", "microbatched", "tenant_cap", "tenants_demoted",
        "parity", "reconciled_counts", "latency_checked",
        "reconciled_latency", "trace", "reconciled",
    }
    assert art["mode"] == "churn" and art["parity"] is None
    assert art["config"] == jharness.asdict(jharness.ReplayConfig(
        seed=1, tenants=2, requests=6, socket=sock, spawn=False,
        parity_sample=False,
    ))
    entry = art["per_tenant"]["tenant-00"]
    for key in (
        "issued", "daemon_requests", "counts_ok", "moves_applied",
        "partitions", "client_p50", "client_p95", "client_p99",
        "daemon_p50", "daemon_p95", "daemon_p99", "flight_p50",
        "flight_p95", "flight_p99", "latency_bucket_delta",
        "client_bucket_delta", "client_covers_daemon",
        "latency_checked", "latency_ok",
        "delta_hits", "resyncs_rows", "resyncs_full", "fallbacks",
        "session_bytes", "delta_hit_rate",
    ):
        assert key in entry, key


# --- the bucket-edge read -----------------------------------------------------


def _upward_edges():
    """Every bucket edge from 1e-4 s to 100 s whose 9-digit rounding (the
    stats doc's) lands above the edge."""
    lo = math.ceil(math.log2(1e-4) * thist.SUBBUCKETS)
    hi = math.floor(math.log2(100.0) * thist.SUBBUCKETS)
    edges = (2.0 ** (i / thist.SUBBUCKETS) for i in range(lo, hi + 1))
    return [e for e in edges if round(e, 9) > e]


UPWARD_EDGES = _upward_edges()


def test_upward_rounding_edges_exist():
    # the flaw is common: about half the edges in the range round up
    assert len(UPWARD_EDGES) >= 30
    assert 2.0 ** (-5 / 4) in UPWARD_EDGES  # 0.420448208 > 0.4204482076...


@pytest.mark.parametrize("edge", UPWARD_EDGES, ids=lambda e: f"{e:.9g}")
def test_scraped_edge_reads_back_to_its_bucket(edge):
    scraped = round(edge, 9)
    # the reference's ceiling read lands one bucket up: its flaw, pinned
    assert jharness._bucket_delta(scraped, edge) == 1
    # the port's nearest-edge read gives the bucket back, so the client
    # (at the exact edge) covers the daemon (at the scraped one)
    assert tharness._bucket_delta(scraped, edge) == 0
    assert tharness._bucket_delta(edge, scraped) == 0
    assert tharness.edge_index(scraped) == thist.bucket_index(edge)


def _one_request_artifact(harness_mod, hist_mod, edge):
    """The artifact of one tenant's one request whose daemon and client
    walls both lie in the bucket of ``edge`` (the daemon's a little
    shorter), with the stats doc's percentiles as a streaming hist of
    the package renders them."""
    cfg = harness_mod.ReplayConfig(seed=1, tenants=1, requests=1,
                                   parity_sample=False)
    synth = harness_mod._make_synth(cfg)
    name = synth.tenants[0].name
    daemon_wall, client_wall = edge * 0.93, edge * 0.97
    h = hist_mod.StreamingHist()
    h.observe(daemon_wall)
    doc = {"tenants": {"top": {name: {"requests": 1,
                                      "request_s": h.snapshot()}}}}
    flight = [{"tenant": name, "wall_s": daemon_wall, "trace": "t0"}]
    return harness_mod._build_artifact(
        cfg, synth, {name: [client_wall]}, {name: 1}, [], None, {}, doc,
        flight, 1.0, trace_ids=["t0"],
    ), name


def test_one_request_in_an_upward_bucket_reconciles():
    """The harness-level case: one request whose walls lie in the bucket
    of 2**(-5/4), whose 9-digit rounding goes up. The port's artifact
    reconciles; the reference's, with its ceiling read, does not."""
    edge = 2.0 ** (-5 / 4)
    ta, name = _one_request_artifact(tharness, thist, edge)
    te = ta["per_tenant"][name]
    assert te["daemon_p50"] == te["client_p50"] == round(edge, 9) > edge
    assert te["latency_checked"] is True
    assert te["latency_bucket_delta"] == {"p50": 0, "p95": 0, "p99": 0}
    assert te["client_covers_daemon"] is True
    assert ta["reconciled_latency"] is True and ta["reconciled"] is True
    ja, _ = _one_request_artifact(jharness, jhist, edge)
    je = ja["per_tenant"][name]
    assert je["latency_bucket_delta"] == {"p50": 1, "p95": 1, "p99": 1}
    assert je["client_covers_daemon"] is False
    assert ja["reconciled"] is False


# --- the spawned modes (python -m kafkabalancer_tpu_torch -serve) -------------


def test_restart_replay_recovers_from_spill():
    """SIGKILL mid-churn, restart on the same socket and spill
    directory: every answer byte-identical to -no-daemon, both tenants'
    first post-restart request restored from the warm tier, the
    restore_delay site fired, the paging identity exact."""
    cfg = ReplayConfig(
        seed=11, tenants=2, requests=10, arrival="uniform",
        weight_shift_every=0, restart=True,
    )
    art = run_replay(cfg, **QUIET, device="cpu")
    assert art["schema"] == REPLAY_SCHEMA and art["mode"] == "restart"
    assert art["scrape_schema"] == "kafkabalancer-tpu.serve-stats/8"
    assert art["request_errors"] == []
    r = art["restart"]
    assert r["ok"] is True and art["reconciled"] is True
    assert r["wrong_plans"] == []
    assert r["answered"] == r["parity_checked"] == 10
    assert r["kill_after"] == 5
    assert r["expected_restore_attempts"] == 2
    assert r["restore_attempts_ok"] is True
    assert r["restores"] == r["restore_hits"] == 2
    assert r["restore_hit_rate"] == 1.0
    assert r["corrupt_drops"] == 0 and r["cold_misses_post"] == 0
    assert r["paging_identity_ok"] is True
    assert r["faults_fired_post"].get("restore_delay", 0) == 1
    assert r["post_restart_p95_s"] > 0.0
    assert sum(e["restores"] for e in art["per_tenant"].values()) == 2


def test_restart_replay_corrupt_record_is_cold_but_correct():
    """A seeded spill_corrupt on the pre-kill daemon: the restarted
    daemon prunes the record and re-registers; the answer stays
    byte-identical."""
    cfg = ReplayConfig(
        seed=3, tenants=1, requests=3, arrival="uniform",
        weight_shift_every=0, restart=True, restart_kill_after=1,
        chaos_faults="spill_corrupt@1",
    )
    art = run_replay(cfg, **QUIET, device="cpu")
    r = art["restart"]
    assert r["ok"] is True and r["wrong_plans"] == []
    assert r["corrupt_drops"] == 1
    assert r["restores"] == 0 and r["restore_hits"] == 0
    assert r["cold_misses_post"] == 1
    assert r["paging_identity_ok"] is True
    assert art["request_errors"] == []


def test_watch_replay_zero_client_plan_ops():
    """A private -watch daemon over the fake-ZK seam plans closed-loop:
    no client plan op, every emitted plan byte-identical to -no-daemon
    on the state it was planned from, speculative memo hits, drift
    noticed, the speculation identity exact."""
    art = run_replay(ReplayConfig(seed=7, requests=8, watch=True), **QUIET,
                     device="cpu")
    assert art["schema"] == REPLAY_SCHEMA and art["mode"] == "watch"
    assert art["scrape_schema"] == "kafkabalancer-tpu.serve-stats/8"
    assert art["chaos"] is None and art["restart"] is None
    w = art["watch"]
    assert w["ok"] is True and art["reconciled"] is True, w
    assert w["wrong_plans"] == [] and w["oracle_missing"] == 0
    assert w["plans_emitted"] >= 3
    assert w["parity_checked"] == w["plans_emitted"]
    assert w["zero_client_plan_ops"] is True
    assert art["requests_issued"] == 0
    assert w["spec_hit_plans"] >= 1 and w["errors"] == 0
    assert w["drift_events"] >= 1 and w["resyncs"] >= 1
    s = w["speculation"]
    assert s["attempts"] == (
        s["hits"] + s["misses"] + s["poisoned"] + s["memos"]
    ), s
    assert w["last_event_lag_s"] is not None


def test_chaos_replay_fires_the_lane_crash_and_reconciles():
    """--chaos spawns -serve-lanes=0 -serve-microbatch=2: the one-lane
    scheduler, whose worker holds the lane_crash site. The seeded crash
    fires, the lane recovers, every answered plan is byte-identical and
    the admission and paging identities hold."""
    art = run_replay(
        ReplayConfig(seed=5, tenants=3, requests=12, chaos=True,
                     concurrency=4),
        **QUIET, device="cpu",
    )
    assert art["mode"] == "chaos" and art["request_errors"] == []
    c = art["chaos"]
    assert c["ok"] is True and art["reconciled"] is True, c
    assert c["faults_fired"].get("lane_crash", 0) == 1
    assert c["quarantines"] >= 1 and c["recoveries"] >= 1
    assert all(c["identities"].values()), c["identities"]
    assert c["wrong_plans"] == [] and c["shed_total"] >= 1
    assert c["answered"] == c["parity_checked"] == art["requests_issued"]


def test_replay_requires_a_daemon():
    d0 = tempfile.mkdtemp(prefix="kbr-")
    try:
        cfg = ReplayConfig(socket=os.path.join(d0, "absent.sock"),
                           spawn=False, requests=2)
        with pytest.raises(ReplayError):
            run_replay(cfg, **QUIET)
    finally:
        shutil.rmtree(d0, ignore_errors=True)


def test_entry_point_check_on_a_reconciled_run(capsys):
    """``python -m kafkabalancer_tpu_torch.replay --check`` against a
    running daemon: exit 0, one artifact line on stdout."""
    from kafkabalancer_tpu_torch.replay.__main__ import main
    from torch_helpers import running_daemon

    with running_daemon() as (sock, _d, _logs):
        rc = main(["--tenants", "2", "--requests", "6", "--socket", sock,
                   "--no-spawn", "--check"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    art = json.loads(out.out)
    assert art["reconciled"] is True and art["requests_issued"] == 6
    assert "reconciled=True" in out.err
