"""The control: plans cut short fail the limit that sound plans meet.

On the CPU at a tiny size here; on the card at the cell's own size with
``-m cuda`` (the readings in PERF.md come from that test's runs)."""

import pytest

from portbench import control, spec
from portbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", tiny.NAMES)
def test_control_fails_where_sound_plans_pass(capsys, name):
    import torch

    torch.set_num_threads(1)
    cell = tiny.cell(name)
    r = control.readings(name, tiny.SEED, 2.0, device="cpu", cell=cell)
    capsys.readouterr()
    limit = cell.config["limits"]["residual_ratio"]
    assert r["rc"] == 0 and r["plans"] > 0
    assert r["sound_max"] <= limit < r["control_min"]
    assert r["control_correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(capsys, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    limit = spec.config(spec.Cell(spec.benchmark(), name).config_name)[
        "limits"]["residual_ratio"]
    readings = []
    for seed in (4294967401, 4294967402, 4294967403):
        r = control.readings(name, seed, 15.0)
        out = capsys.readouterr()
        readings.append(r)
        assert r["rc"] == 0, out.err[-3000:]
    with capsys.disabled():
        for r in readings:
            print(f"control {name} seed {r['seed']}: plans {r['plans']} "
                  f"sound max {r['sound_max']} control min "
                  f"{r['control_min']} control correct "
                  f"{r['control_correct']} {r['control_checks']}")
    for r in readings:
        assert r["sound_max"] <= limit < r["control_min"]
        assert r["control_correct"] is False
