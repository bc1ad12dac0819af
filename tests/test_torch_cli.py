"""The port's CLI against the reference's, byte for byte.

``kafkabalancer_tpu_torch.cli.run`` and ``kafkabalancer_tpu.cli.run`` get
the same argument vectors and inputs — the golden inputs of
tests/test_cli.py and the 16+ table cases of tests/test_balancer.py — and
must return the same exit code and write the same stdout, for the greedy
pipeline and for ``-fused -fused-batch=4`` (the port on the CPU via
``device="cpu"``, the reference at float64 as tests/conftest.py sets it).

Also pinned here: the port imports neither jax nor the JAX package
(subprocess check), ``-fused`` without a GPU exits 3, and flags whose
feature is not ported exit 3 naming their ROADMAP.md item.
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


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import kafkabalancer_tpu_torch, kafkabalancer_tpu_torch.cli\n"
        "import kafkabalancer_tpu_torch.solvers.scan\n"
        "import kafkabalancer_tpu_torch.parallel.shard_kernel\n"
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
    "flag,item",
    [
        ("-fused-polish", "A5"),
        ("-fused-shard", "A6"),
        ("-stats", "A1"),
        ("-explain=-", "A1"),
        ("-serve", "A7"),
        ("-solver=tpu", "A3"),
        ("-solver=beam", "A5"),
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
    "extra,item",
    [
        (["-fused-engine=pallas"], "B2"),
        (["-rebalance-leader"], "A5"),
        (["-anti-colocation=0.5"], "A4"),
    ],
)
def test_unported_fused_modes_exit_3(extra, item):
    o, e = io.StringIO(), io.StringIO()
    rc = trun(
        io.StringIO(fixture_text()), o, e,
        ["kafkabalancer", "-input-json", "-fused"] + extra, device="cpu",
    )
    assert rc == 3
    assert f"ROADMAP.md {item}" in e.getvalue()
