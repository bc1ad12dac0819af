"""The traced run's readers on a made-up timeline: names, idle gaps and
the K1 roofline."""

import pytest

from portbench import kernels, run, spec
from portbench.devtrace import DeviceTrace, short_name, union

K1 = "void (anonymous namespace)::score_blocks<false, false, true, 2>(float const*, int)"
K1_COLO = "void (anonymous namespace)::score_blocks<false, true, true, 2>(float const*, int)"


def test_short_names():
    assert short_name(K1) == "score_blocks<false, false, true, 2>"
    assert short_name("void at::native::k<4, f<int>(x)>(int, float)") == \
        "at::native::k<4, f<int>(x)>"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def timeline():
    tr = DeviceTrace()
    tr.t0_ns, tr.t1_ns = 0, 1000
    tr.ops = [(K1, 100, 200, '{"grid": [40, 8, 1]}'),
              ("void at::native::fill<float>(float)", 150, 300, ""),
              (K1_COLO, 900, 950, "")]
    tr.spans = [("serve.microbatch_dispatch", 0, 1000, "lane"),
                ("parse_input", 350, 850, "lane")]
    return tr


def test_busy_and_idle_gaps_named_by_the_innermost_span():
    tr = timeline()
    assert tr.busy() == [(100, 300), (900, 950)]
    assert tr.busy_s == pytest.approx(250e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["parse_input", pytest.approx(600e-9)]
    assert [g[0] for g in gaps[1:]] == ["serve.microbatch_dispatch"] * 2
    tr.spans = []
    assert tr.idle_gaps()[0][0] == "after at::native::fill<float>"
    ops = dict(tr.device_ops())
    assert ops["score_blocks<false, false, true, 2>"] == pytest.approx(100e-9)


def test_k1_roofline_counts_each_instance_once():
    cell = spec.Cell(spec.benchmark(), spec.benchmark()["workloads"][0]["name"])
    ctx = dict(device_kind="NVIDIA H100 80GB HBM3", cell=cell,
               occupancy=4.0, trace=timeline())
    per = kernels.k1_bytes(10000, 100, 3)
    # the plain launch carries its grid (8 instances); the colocation
    # variant's launch is not counted
    assert kernels.k1_roofline(ctx) == pytest.approx(
        100.0 * 8 * per / 3.35e12 / 100e-9)
    no_grid = timeline()
    no_grid.ops[0] = (K1, 100, 200, "")
    # without a grid the window's occupancy (4) counts
    assert kernels.k1_roofline(dict(ctx, trace=no_grid)) == pytest.approx(
        100.0 * 4 * per / 3.35e12 / 100e-9)
    assert kernels.k1_roofline(dict(ctx, device_kind="other")) is None


def test_k1_bytes_at_the_configured_size():
    # member mask, replicas and five row columns, then broker vectors
    # and outputs
    assert kernels.k1_bytes(10000, 100, 3) == 10000 * 100 + 10000 * 32 \
        + 100 * 9 + 50 * 9 + 12 + 16 * 100 + 16 * 50


def test_held_tail_is_the_nearest_rank_p90_of_the_walls():
    reader = spec.metric_reader("plan_p90_s.held")
    walls = [float(w) for w in range(1, 21)]
    assert reader.read({"walls": walls}) == 18.0
    assert reader.read({"walls": []}) is None


def test_device_ms_per_plan_is_the_busy_time_over_the_plans():
    tr = timeline()
    assert run.device_ms_per_plan(tr, 5) == pytest.approx(250e-9 * 1e3 / 5)
    assert run.device_ms_per_plan(tr, 0) is None
    tr.ops = []
    assert run.device_ms_per_plan(tr, 5) is None


def test_held_rate_is_the_plans_over_the_rounds_span():
    reader = spec.metric_reader("plans_per_s.held")
    assert reader.read({"plans": 80, "span_s": 50.0}) == 1.6
    assert reader.read({"plans": 0, "span_s": 50.0}) is None
