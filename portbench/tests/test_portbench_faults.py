"""The timed path broken underneath a run: ``correct`` comes out false.

The daemon runs in the test's process, so replacing the port's plan
writer (``cli.write_partition_list``, where a served plan's bytes are
made) breaks every plan the window serves, one fault at a time: the state
returned unchanged, half of the moves left out, one move altered."""

import pytest

from portbench.tests.tiny import NAMES, run_tiny


def broken_writer(fault, write):
    from kafkabalancer_tpu_torch.models import PartitionList

    def writer(out, pl):
        parts = list(pl.partitions or [])
        if fault == "unchanged":
            parts = []
        elif fault == "half":
            parts = parts[: len(parts) // 2]
        elif fault == "altered" and parts:
            p = parts[-1]
            spare = next(b for b in range(1, 1000) if b not in p.replicas)
            p.replicas = list(p.replicas[:-1]) + [spare]
        return write(out, PartitionList(version=1, partitions=parts or None))

    return writer


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_plan_is_not_correct(capsys, monkeypatch, fault, name):
    from kafkabalancer_tpu_torch import cli

    monkeypatch.setattr(cli, "write_partition_list",
                        broken_writer(fault, cli.write_partition_list))
    rc, result, err = run_tiny(capsys, name)
    assert rc == 0, err[-20:]
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_a_client_that_fails_is_not_correct(capsys, name):
    import sys

    rc, result, err = run_tiny(
        capsys, name,
        client_command=[sys.executable, "-c", "import sys; sys.exit(3)"])
    assert rc == 0, err[-20:]
    assert result["correct"] is False
    assert result["checks"]["client_errors"]["value"] == result["attempted"]
