"""``-explain`` and the plan-outcome gauges of the port against the
reference's, through both CLIs on the CPU.

The same argument vector and input go through ``kafkabalancer_tpu.cli.run``
and ``kafkabalancer_tpu_torch.cli.run(..., device="cpu")`` (the port at
float64 on the CPU, the reference at x64 as tests/conftest.py sets it).
The explain documents must be equal with the timestamp masked (tolerance:
none — every float in them is computed by the host oracle from the same
moves), as must the ``plan.stop_reason`` and ``plan.no_move_reason``
gauges of ``-metrics-json``. Covered: the fixture with the default
complete-partition (a move applied but not emitted), a seeded 200 x 12
``-fused -fused-batch=4`` run, ``-solver=tpu`` (host scan and forced
device pass), ``-fused -fused-shard``, the fused leader session and the
no-move matrix. Also: ``-explain`` changes no plan bytes, the document
rides between the plan and the metrics line, and an unwritable path exits
4.
"""

import io
import json
import os

import pytest

from kafkabalancer_tpu.cli import run as jrun
from kafkabalancer_tpu.utils.synth import synth_cluster
from kafkabalancer_tpu_torch.cli import run as trun
import torch_helpers  # noqa: F401  (torch CPU thread setting)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "test.json")
EXPLAIN = "kafkabalancer-tpu.explain/1"
METRICS = "kafkabalancer-tpu.metrics/1"


@pytest.fixture(autouse=True)
def tracers_off():
    """Either CLI leaves its process-global tracer enabled after a
    ``-stats``, ``-metrics-json`` or ``-trace`` invocation until its next
    invocation resets it; the other test files of this worker expect it
    off, so each test here ends with both reset."""
    yield
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs

    jobs.begin_invocation()
    tobs.begin_invocation()


def cluster_text(n_parts, n_brokers, seed):
    from kafkabalancer_tpu.codecs import write_partition_list

    buf = io.StringIO()
    write_partition_list(
        buf, synth_cluster(n_parts, n_brokers, rf=3, seed=seed, weighted=True)
    )
    return buf.getvalue()


def run_pkg(run, argv, stdin="", **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = run(io.StringIO(stdin), out, err, ["kafkabalancer"] + argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def both(argv, stdin=""):
    """``(rc, stdout, stderr)`` of the reference, then of the port."""
    argv = argv + ["-no-daemon"]
    return (
        run_pkg(jrun, argv, stdin),
        run_pkg(trun, argv, stdin, device="cpu"),
    )


def masked(doc):
    doc = dict(doc)
    doc.pop("ts_epoch")
    return doc


def explain_of(out):
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["schema"] == EXPLAIN
    return doc


def force_device_window(monkeypatch):
    """``-solver=tpu`` routes clusters below MIN_DEVICE_CANDIDATES to the
    host scan in both packages; 0 forces the device pass."""
    from kafkabalancer_tpu.solvers import tpu as jtpu
    from kafkabalancer_tpu_torch.solvers import tpu as ttpu

    monkeypatch.setattr(jtpu, "MIN_DEVICE_CANDIDATES", 0)
    monkeypatch.setattr(ttpu, "MIN_DEVICE_CANDIDATES", 0)


CASES = {
    # the default complete-partition: the probe move is applied, not emitted
    "fixture-greedy": (["-input-json", f"-input={FIXTURE}"], None),
    "fixture-greedy-3": (
        ["-input-json", f"-input={FIXTURE}", "-max-reassign=3"], None),
    "fixture-fused": (
        ["-input-json", f"-input={FIXTURE}", "-fused", "-fused-batch=4",
         "-max-reassign=3"], None),
    "seeded-fused": (
        ["-input-json", "-fused", "-fused-batch=4", "-max-reassign=60",
         "-complete-partition=false"], (200, 12, 7)),
    "seeded-fused-leader": (
        ["-input-json", "-fused", "-fused-batch=4", "-allow-leader",
         "-max-reassign=40", "-complete-partition=false"], (200, 12, 8)),
    "fixture-tpu": (
        ["-input-json", f"-input={FIXTURE}", "-solver=tpu",
         "-max-reassign=3"], None),
    "seeded-shard": (
        ["-input-json", "-fused", "-fused-shard", "-fused-batch=4",
         "-max-reassign=60", "-complete-partition=false"], (200, 12, 9)),
    "fixture-rebalance-leader": (
        ["-input-json", f"-input={FIXTURE}", "-fused", "-rebalance-leader",
         "-fused-batch=4", "-max-reassign=4"], None),
    "below-threshold": (
        ["-input-json", f"-input={FIXTURE}", "-min-unbalance=999999"], None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_document_equals_reference(name):
    argv, seeded = CASES[name]
    stdin = cluster_text(*seeded) if seeded else ""
    (jrc, jout, jerr), (trc, tout, terr) = both(argv + ["-explain=-"], stdin)
    assert (trc, tout.splitlines()[0]) == (jrc, jout.splitlines()[0]), terr
    jdoc, tdoc = explain_of(jout), explain_of(tout)
    assert masked(tdoc) == masked(jdoc)
    # the human rendering on stderr is the reference's too
    assert terr[terr.index("-- plan explanation"):] == (
        jerr[jerr.index("-- plan explanation"):]
    )


def test_explain_tpu_device_pass_equals_reference(monkeypatch):
    force_device_window(monkeypatch)
    stdin = cluster_text(120, 10, 3)
    (jrc, jout, _), (trc, tout, terr) = both(
        ["-input-json", "-solver=tpu", "-max-reassign=4", "-explain=-"], stdin
    )
    assert (trc, tout.splitlines()[0]) == (jrc, jout.splitlines()[0]), terr
    tdoc = explain_of(tout)
    assert tdoc["rounds"]["count"] >= 1 and tdoc["rounds"]["tie_windows"]
    assert masked(tdoc) == masked(explain_of(jout))


def test_complete_partition_probe_applied_not_emitted():
    (_j, (rc, out, err)) = both(
        ["-input-json", f"-input={FIXTURE}", "-explain=-"]
    )
    assert rc == 0
    doc = explain_of(out)
    assert doc["moves_applied"] > doc["moves_emitted"] == 1
    assert [m["emitted"] for m in doc["moves"]] == [True, False]
    assert "[applied, not emitted]" in err
    assert len(json.loads(out.splitlines()[0])["partitions"]) == 1


def test_seeded_fused_moves_emitted_equals_plan():
    stdin = cluster_text(200, 12, 7)
    _j, (rc, out, _err) = both(
        ["-input-json", "-fused", "-fused-batch=4", "-max-reassign=60",
         "-complete-partition=false", "-explain=-"], stdin,
    )
    assert rc == 0
    doc = explain_of(out)
    plan = json.loads(out.splitlines()[0])["partitions"]
    assert doc["moves_emitted"] == len(plan) > 0
    assert doc["mode"] == "fused" and doc["rounds"]["count"] >= 1


@pytest.mark.parametrize(
    "extra",
    [[], ["-fused", "-fused-batch=4"], ["-solver=tpu"],
     ["-fused", "-fused-shard"]],
    ids=["greedy", "fused", "tpu", "shard"],
)
def test_explain_changes_no_plan_bytes(tmp_path, extra):
    args = ["-input-json", f"-input={FIXTURE}", "-max-reassign=3",
            "-no-daemon"] + extra
    rc1, out1, _ = run_pkg(trun, args, device="cpu")
    path = str(tmp_path / "explain.json")
    rc2, out2, err2 = run_pkg(trun, args + [f"-explain={path}"], device="cpu")
    assert (rc1, out1) == (rc2, out2)
    assert "plan explanation" in err2
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["moves_emitted"] == sum(m["emitted"] for m in doc["moves"])
    rc3, out3, _ = run_pkg(trun, args + ["-explain=-"], device="cpu")
    assert rc3 == rc1 and out3.startswith(out1)
    assert json.loads(out3[len(out1):])["schema"] == EXPLAIN


def test_explain_line_rides_before_the_metrics_line():
    rc, out, _ = run_pkg(
        trun,
        ["-input-json", f"-input={FIXTURE}", "-fused", "-max-reassign=2",
         "-no-daemon", "-explain=-", "-metrics-json", "-"],
        device="cpu",
    )
    assert rc == 0
    lines = out.strip().splitlines()
    assert json.loads(lines[0])["version"] == 1
    assert json.loads(lines[-2])["schema"] == EXPLAIN
    assert json.loads(lines[-1])["schema"] == METRICS


def test_explain_unwritable_path_exits_4(tmp_path):
    argv = ["-input-json", f"-input={FIXTURE}", "-fused", "-max-reassign=2",
            f"-explain={tmp_path}/no/such/dir/x.json"]
    (jrc, jout, _), (trc, tout, terr) = both(argv)
    assert trc == jrc == 4
    assert tout == jout
    assert "failed writing explain document" in terr


def test_recorder_uninstalled_after_each_run():
    from kafkabalancer_tpu_torch.obs import convergence

    run_pkg(trun, ["-input-json", f"-input={FIXTURE}", "-no-daemon",
                   "-explain=-"], device="cpu")
    assert convergence.recorder() is None


# --- the outcome gauges ----------------------------------------------------


def gauges(out):
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["schema"] == METRICS
    return doc["gauges"]


MODES = {
    "greedy": [],
    "fused": ["-fused"],
    "fused-batch": ["-fused", "-fused-batch=4"],
    "tpu": ["-solver=tpu"],
    "beam": ["-solver=beam"],
    "shard": ["-fused", "-fused-shard"],
    "leader": ["-fused", "-rebalance-leader", "-complete-partition=false"],
    "pallas": ["-fused", "-fused-engine=pallas-interpret"],
}
OUTCOMES = {
    "below_threshold": ["-max-reassign=2", "-min-unbalance=999999"],
    "no_feasible": ["-max-reassign=2", "-min-replicas=9"],
    "budget": ["-max-reassign=1"],
    "converged": ["-max-reassign=50"],
    "no_budget": ["-max-reassign=0"],
}


@pytest.mark.parametrize("outcome", sorted(OUTCOMES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_outcome_gauges_equal_reference(mode, outcome):
    argv = (["-input-json", f"-input={FIXTURE}", "-metrics-json=-"]
            + MODES[mode] + OUTCOMES[outcome])
    (jrc, jout, _), (trc, tout, terr) = both(argv)
    assert trc == jrc, terr
    assert tout.splitlines()[:-1] == jout.splitlines()[:-1]
    jg, tg = gauges(jout), gauges(tout)
    for key in ("plan.stop_reason", "plan.no_move_reason"):
        assert tg.get(key) == jg.get(key), (key, tg, jg)


def test_below_threshold_in_document_and_gauge():
    _j, (rc, out, _err) = both(
        ["-input-json", f"-input={FIXTURE}", "-min-unbalance=999999",
         "-explain=-", "-metrics-json=-"]
    )
    assert rc == 0
    lines = out.strip().splitlines()
    doc = json.loads(lines[-2])
    assert doc["no_move_reason"]["reason"] == "below_threshold"
    assert gauges(out)["plan.no_move_reason"] == "below_threshold"
