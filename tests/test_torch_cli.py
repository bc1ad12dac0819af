"""The port's CLI against the reference's, byte for byte.

``kafkabalancer_tpu_torch.cli.run`` and ``kafkabalancer_tpu.cli.run`` get
the same argument vectors and inputs — the golden inputs of
tests/test_cli.py and the 16+ table cases of tests/test_balancer.py — and
must return the same exit code and write the same stdout, for the greedy
pipeline and for ``-fused -fused-batch=4`` (the port on the CPU via
``device="cpu"``, the reference at float64 as tests/conftest.py sets it),
with ``-fused-engine=pallas`` against the reference's
``-fused-engine=pallas-interpret`` (both at float32), and for
``-fused -fused-polish`` (with and without ``-allow-leader``, batch 1, 4
and the default), ``-fused -rebalance-leader`` (batch 1 and 4),
``-solver=tpu``, ``-solver=beam`` (with and without ``-anti-colocation``)
and ``-fused -fused-batch=4 -anti-colocation`` (with and without
``-fused-polish``) and ``-fused -fused-shard`` (with ``-shard-scale``,
``-fused-polish``, ``-rebalance-leader`` and ``-anti-colocation``) over
the golden inputs.

Also pinned here: the port imports neither jax nor the JAX package
(subprocess check), ``-fused``, ``-fused-polish``, ``-fused
-rebalance-leader``, ``-fused -anti-colocation``, ``-solver=tpu`` and
``-solver=beam`` without a GPU exit 3, the colocation session's flag
checks and the shard flags' checks exit 3 as the reference's do, a
failure on a shard exits 3, and flags whose feature is not ported exit 3
naming their ROADMAP.md item.
"""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from test_balancer import CASES, cfg_3replicas, cfg_6brokers, cfg_leader

from kafkabalancer_tpu.cli import run as jrun
from kafkabalancer_tpu_torch.cli import run as trun
import torch_helpers  # noqa: F401  (torch CPU thread setting)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "test.json")


def fixture_text():
    with open(FIXTURE) as fh:
        return fh.read()


def case_input(idx):
    """tests/test_balancer.py CASES[idx] as reassignment JSON plus the
    flags that select its config."""
    parts, _expected, _err, factory = CASES[idx]
    rows = []
    for p in parts:
        row = {"topic": p.topic, "partition": p.partition, "replicas": p.replicas}
        if p.weight:
            row["weight"] = p.weight
        if p.num_replicas:
            row["num_replicas"] = p.num_replicas
        if p.brokers is not None:
            row["brokers"] = p.brokers
        if p.num_consumers:
            row["num_consumers"] = p.num_consumers
        rows.append(row)
    flags = {
        None: [],
        cfg_leader: ["-allow-leader"],
        cfg_3replicas: ["-min-replicas=3"],
        cfg_6brokers: ["-broker-ids=1,2,3,4,5,6"],
    }[factory]
    return json.dumps({"version": 1, "partitions": rows}), ["-input-json"] + flags


TEXT = (
    "\tTopic: keep\tPartition: 0\tLeader: 1\tReplicas: 1,2\tIsr: 1,2\n"
    "\tTopic: keep\tPartition: 1\tLeader: 1\tReplicas: 1,3\tIsr: 1,3\n"
    "\tTopic: drop\tPartition: 0\tLeader: 1\tReplicas: 1,2\tIsr: 1,2\n"
)

# (argv after the program name, stdin) from tests/test_cli.py
GOLDEN = [
    (["-input-json"], fixture_text()),
    (["-input-json", f"-input={FIXTURE}"], ""),
    (["-input-json", f"-input={FIXTURE}", "-from-zk=localhost:2282"], ""),
    (["-input-json"], ""),
    (["-input-json"], "::malformed::"),
    (["-input-json", "-input=tests/data/missing.json"], ""),
    (["-input-json", f"-input={FIXTURE}", "-broker-ids=1,2,3"], ""),
    (["-input-json", f"-input={FIXTURE}", "-broker-ids=malformed"], ""),
    (["-input-json", f"-input={FIXTURE}", "-max-reassign=-1"], ""),
    (["-input-json", f"-input={FIXTURE}", "-max-reassign=1000"], ""),
    (["-input-json", f"-input={FIXTURE}", "-full-output"], ""),
    (["-from-zk=."], ""),
    (["-input-json"], '{"version":1,"partitions":[{"topic":"foo1","partition":1,'
                      '"replicas":[1,2],"num_replicas":3}]}'),
    (["-input-json", "-unique", "-max-reassign=10"], fixture_text()),
    (["-input-json", "-max-reassign=0"], fixture_text()),
    (["-input-json", "-max-reassign=50"], fixture_text()),
    (["-topics=keep", "-full-output"], TEXT),
    (["-topics=keep", "-max-reassign=5"], TEXT),
]

FUSED = ["-fused", "-fused-batch=4"]


def both(argv, stdin):
    out = []
    for run, kw in ((jrun, {}), (trun, {"device": "cpu"})):
        o, e = io.StringIO(), io.StringIO()
        rc = run(io.StringIO(stdin), o, e, ["kafkabalancer"] + argv, **kw)
        out.append((rc, o.getvalue()))
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("idx", range(len(GOLDEN)))
def test_golden_cli_inputs(idx, fused):
    argv, stdin = GOLDEN[idx]
    ref, got = both(argv + (FUSED if fused else []), stdin)
    assert got == ref


@pytest.mark.parametrize("extra", [[], ["-max-reassign=20", "-unique"]])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("idx", range(len(CASES)))
def test_balancer_table_cases(idx, fused, extra):
    stdin, argv = case_input(idx)
    ref, got = both(argv + extra + (FUSED if fused else []), stdin)
    assert got == ref


@pytest.mark.parametrize("idx", range(len(GOLDEN)))
def test_golden_cli_inputs_whole_session_kernel(idx):
    """``-fused -fused-engine=pallas`` (on the CPU, the kernel's plain
    version) against the reference's ``-fused-engine=pallas-interpret``
    (its Pallas kernel in interpret mode): same rc, same stdout bytes."""
    argv, stdin = GOLDEN[idx]
    ref = jrun_out(argv + FUSED + ["-fused-engine=pallas-interpret"], stdin)
    got = trun_out(argv + FUSED + ["-fused-engine=pallas"], stdin)
    assert got == ref


# flag sets of the paths ported after the first slice; the batch=1 leader
# session with the default -complete-partition loops forever in both
# packages on inputs whose budget it exhausts (ROADMAP.md C), so that set
# turns the extension off
NEW_PATHS = {
    "polish": ["-fused", "-fused-polish"],
    "polish-b4": ["-fused", "-fused-polish", "-fused-batch=4"],
    "polish-b1": ["-fused", "-fused-polish", "-fused-batch=1"],
    "polish-leader": ["-fused", "-fused-polish", "-allow-leader"],
    "polish-leader-b4": ["-fused", "-fused-polish", "-allow-leader",
                         "-fused-batch=4"],
    "polish-leader-b1": ["-fused", "-fused-polish", "-allow-leader",
                         "-fused-batch=1"],
    "leader-b1": ["-fused", "-rebalance-leader", "-fused-batch=1",
                  "-complete-partition=false"],
    "leader-b4": ["-fused", "-rebalance-leader", "-fused-batch=4"],
    "solver-tpu": ["-solver=tpu"],
    "solver-beam": ["-solver=beam"],
    "solver-beam-colo": ["-solver=beam", "-anti-colocation=0.001",
                         "-beam-siblings"],
    "colo-b4": ["-fused", "-fused-batch=4", "-anti-colocation=0.001"],
    "colo-polish-b4": ["-fused", "-fused-batch=4", "-anti-colocation=0.001",
                       "-fused-polish"],
}


@pytest.mark.parametrize("path", sorted(NEW_PATHS))
@pytest.mark.parametrize("idx", range(len(GOLDEN)))
def test_golden_cli_inputs_new_paths(idx, path, monkeypatch):
    """Same rc and stdout bytes as the reference CLI; ``-solver=tpu`` with
    ``MIN_DEVICE_CANDIDATES`` at 0 in both packages, so every move takes
    the device pass."""
    from kafkabalancer_tpu.solvers import tpu as jtpu
    from kafkabalancer_tpu_torch.solvers import tpu as ttpu

    monkeypatch.setattr(jtpu, "MIN_DEVICE_CANDIDATES", 0)
    monkeypatch.setattr(ttpu, "MIN_DEVICE_CANDIDATES", 0)
    argv, stdin = GOLDEN[idx]
    ref, got = both(argv + NEW_PATHS[path], stdin)
    assert got == ref


# the sharded session (-fused-shard: one shard per device, the CPU here
# and the reference's 8 virtual devices) and its scale tier; each flag set
# also equals the port's plan without the shard flags
SHARD_PATHS = {
    "shard": ["-fused", "-fused-shard"],
    "shard-b4": ["-fused", "-fused-shard", "-fused-batch=4"],
    "shard-scale": ["-fused", "-fused-shard", "-shard-scale"],
    "shard-scale-b4": ["-fused", "-fused-shard", "-shard-scale",
                       "-fused-batch=4"],
    "shard-polish-leader": ["-fused", "-fused-shard", "-fused-polish",
                            "-allow-leader", "-fused-batch=4"],
    "shard-rebalance-leader": ["-fused", "-fused-shard", "-rebalance-leader",
                               "-fused-batch=4"],
    "shard-colo": ["-fused", "-fused-shard", "-fused-batch=4",
                   "-anti-colocation=0.001"],
}


@pytest.mark.parametrize("path", sorted(SHARD_PATHS))
@pytest.mark.parametrize("idx", range(len(GOLDEN)))
def test_golden_cli_inputs_sharded(idx, path):
    argv, stdin = GOLDEN[idx]
    flags = SHARD_PATHS[path]
    ref, got = both(argv + flags, stdin)
    assert got == ref
    unsharded = [f for f in flags if f not in ("-fused-shard", "-shard-scale")]
    if "-fused-polish" not in flags:  # polish after the move floor differs
        assert trun_out(argv + unsharded, stdin) == got


def jrun_out(argv, stdin):
    o, e = io.StringIO(), io.StringIO()
    return jrun(io.StringIO(stdin), o, e, ["kafkabalancer"] + argv), o.getvalue()


def trun_out(argv, stdin):
    o, e = io.StringIO(), io.StringIO()
    rc = trun(io.StringIO(stdin), o, e, ["kafkabalancer"] + argv, device="cpu")
    return rc, o.getvalue()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import kafkabalancer_tpu_torch, kafkabalancer_tpu_torch.cli\n"
        "import kafkabalancer_tpu_torch.solvers.scan\n"
        "import kafkabalancer_tpu_torch.parallel.shard_kernel\n"
        "import kafkabalancer_tpu_torch.solvers.pallas_session\n"
        "import kafkabalancer_tpu_torch.solvers.polish\n"
        "import kafkabalancer_tpu_torch.solvers.leader\n"
        "import kafkabalancer_tpu_torch.solvers.tpu\n"
        "import kafkabalancer_tpu_torch.solvers.beam\n"
        "import kafkabalancer_tpu_torch.balancer.pipeline\n"
        "import kafkabalancer_tpu_torch.ops.nvcc\n"
        "import kafkabalancer_tpu_torch.parallel\n"
        "import kafkabalancer_tpu_torch.parallel.mesh\n"
        "import kafkabalancer_tpu_torch.parallel.shard_move\n"
        "import kafkabalancer_tpu_torch.parallel.shard_session\n"
        "import kafkabalancer_tpu_torch.parallel.sweep\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'kafkabalancer_tpu' or m.startswith('kafkabalancer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_fused_without_a_gpu_exits_3(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json", "-fused"],
    )
    assert rc == 3
    assert "-fused needs a CUDA GPU" in e.getvalue()
    assert o.getvalue() == ""


@pytest.mark.parametrize(
    "flags,what",
    [
        (["-fused", "-fused-polish"], "-fused"),
        (["-fused", "-fused-polish", "-fused-engine=pallas"], "-fused"),
        (["-fused", "-rebalance-leader"], "-fused"),
        (["-fused", "-anti-colocation=0.001"], "-fused"),
        (["-solver=tpu"], "-solver=tpu"),
        (["-solver=beam"], "-solver=beam"),
        (["-fused", "-fused-shard"], "-fused"),
        (["-fused", "-fused-shard", "-shard-scale"], "-fused"),
    ],
)
def test_new_paths_without_a_gpu_exit_3(monkeypatch, flags, what):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json"] + flags,
    )
    assert rc == 3
    assert f"{what} needs a CUDA GPU" in e.getvalue()
    assert o.getvalue() == ""


def test_whole_session_kernel_failure_under_polish_exits_3(monkeypatch):
    """A failure of the whole-session kernel in the polish pre-phase is a
    planning failure (exit 3), as with ``-fused-engine=pallas`` alone;
    nothing falls back."""
    from kafkabalancer_tpu_torch.solvers import pallas_session as ps

    def broken(*a, **k):
        raise RuntimeError("pallas_session kernel launch failed: test")

    monkeypatch.setattr(ps, "pallas_session", broken)
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json", "-fused", "-fused-polish",
         "-fused-engine=pallas"], device="cpu",
    )
    assert rc == 3
    assert "pallas engine failed" in e.getvalue()
    assert o.getvalue() == ""


def test_polish_with_rebalance_leader_says_it_is_ignored():
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json", "-fused", "-fused-polish",
         "-rebalance-leader", "-fused-batch=4"], device="cpu",
    )
    assert rc == 0
    assert "-fused-polish does not apply to the -rebalance-leader" in e.getvalue()


@pytest.mark.parametrize(
    "flag,item",
    [
        ("-metrics-json=m.json", "A1"),
        ("-stats", "A1"),
        ("-explain=-", "A1"),
        ("-serve", "A7"),
        ("-jax-profile=prof", "A9"),
    ],
)
def test_unported_flags_exit_3(flag, item):
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e, ["kafkabalancer", "-input-json", flag]
    )
    assert rc == 3
    assert "not yet ported" in e.getvalue() and f"ROADMAP.md {item}" in e.getvalue()


@pytest.mark.parametrize(
    "flags,says",
    [
        (["-fused-shard"], "-fused-shard requires -fused"),
        (["-fused", "-shard-scale"], "-shard-scale requires -fused-shard"),
    ],
)
def test_shard_flag_checks_exit_3(flags, says):
    """The reference's flag checks: the same rc and stdout, exit 3."""
    argv = ["-input-json", f"-input={FIXTURE}"] + flags
    ref = jrun_out(argv, "")
    o, e = io.StringIO(), io.StringIO()
    got = trun(io.StringIO(""), o, e, ["kafkabalancer"] + argv, device="cpu")
    assert (got, o.getvalue()) == ref
    assert got == 3 and says in e.getvalue()


def test_shard_engine_failure_exits_3(monkeypatch):
    """A scoring failure on a shard is a planning failure: exit 3 and no
    plan (on the CPU through the plain scorer of ``pallas-interpret``)."""
    from kafkabalancer_tpu_torch.parallel import shard_session

    def broken(*a, **k):
        raise RuntimeError("scoring failed: test")

    monkeypatch.setattr(shard_session, "shard_score_plain", broken)
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json", "-fused", "-fused-shard",
         "-fused-engine=pallas-interpret"], device="cpu",
    )
    assert rc == 3
    assert "shard engine failed" in e.getvalue()
    assert o.getvalue() == ""


@pytest.mark.parametrize(
    "extra,rc,says",
    [
        (["-anti-colocation=0.001", "-rebalance-leader"], 3, "excludes"),
        (["-anti-colocation=0.001", "-fused-batch=1"], 3,
         "requires -fused-batch>1"),
        (["-anti-colocation=0.001", "-fused-engine=pallas"], 0,
         "-fused-engine=pallas is ignored"),
    ],
)
def test_fused_anti_colocation_flag_checks(extra, rc, says):
    """tests/test_cli.py::test_fused_anti_colocation's exits: the same rc
    and stdout as the reference CLI, and its diagnostic."""
    argv = ["-input-json", f"-input={FIXTURE}", "-fused", "-max-reassign=64",
            "-min-unbalance=0"] + extra
    ref = jrun_out(argv, "")
    o, e = io.StringIO(), io.StringIO()
    got = trun(io.StringIO(""), o, e, ["kafkabalancer"] + argv, device="cpu")
    assert (got, o.getvalue()) == ref
    assert got == rc and says in e.getvalue()
