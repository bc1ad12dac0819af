"""A whole run on the CPU at a tiny size: the last line's keys, the
compared numbers on standard error, and the refusals."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.tests import tiny
from portbench.tests.tiny import SEED, run_tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", tiny.NAMES)
def test_last_line_of_a_run(capsys, name):
    rc, result, err = run_tiny(capsys, name)
    assert rc == 0, err[-20:]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 3 and result["attempted"] % 3 == 0
    # a CPU run has no device: only the host's metrics
    assert set(result["metrics"]) == {
        m["name"] for m in spec.benchmark()["end_to_end"]
        if m["source"] == "host_clock"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    checks = result["checks"]
    assert set(checks) == {"client_errors", "invalid_entries",
                           "objective_worse", "residual_ratio"}
    tail = err[-len(checks):]
    for (name, c), line in zip(checks.items(), tail):
        assert line == f"portbench: check {name} {c['value']} limit {c['limit']}"


def test_a_run_leaves_nothing_behind(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    cwd = os.getcwd()
    rc, _, err = run_tiny(capsys, CELLS[0])
    assert rc == 0, err[-20:]
    assert os.listdir(tmp_path) == []
    assert os.getcwd() == cwd


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.run(["--workload", CELLS[0], "--seed", str(SEED), "--seconds",
                  "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == ""
    assert "CUDA" in err


def test_a_directory_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
