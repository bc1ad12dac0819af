"""The plain reference judges plans: sound ones pass, broken ones fail."""

import io
import itertools
import json

import numpy as np
import pytest

from portbench import fleet, spec
from portbench.reference import check


def plan_on_cpu(path, flags):
    import torch

    from kafkabalancer_tpu_torch import cli

    torch.set_num_threads(1)
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(), out, err,
                 ["kafkabalancer-tpu", *flags, "-input-json", f"-input={path}"],
                 device="cpu")
    assert rc == 0, err.getvalue()
    return out.getvalue()


# the cells' modes, and the anti-colocation objective the reference also
# judges
CASES = {
    "fused": ["-fused", "-fused-batch=100"],
    "coloc": ["-fused", "-fused-batch=100", "-anti-colocation=1e-3"],
    "headline": ["-fused", "-fused-batch=100", "-allow-leader",
                 "-fused-polish"],
}


def tiny_config():
    return dict(spec.config("kafka-10k-expand"), partitions=160, brokers=10,
                original_brokers=8, topic_partitions=8)


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request, tmp_path_factory):
    cfg = tiny_config()
    flags = CASES[request.param] + cfg["planner_flags"] + [
        fleet.broker_ids_flag(cfg)]
    (path,) = fleet.write_fleet(cfg, 4294967311, [0],
                                str(tmp_path_factory.mktemp(request.param)))
    opts = check.planner_options(flags)
    return check.Cluster.from_file(path, opts["broker_ids"]), \
        plan_on_cpu(path, flags), opts


def test_a_converged_plan_passes(served):
    c, text, opts = served
    r = check.check_plan(c, text, opts)
    assert r["invalid"] == 0, r["reasons"]
    assert r["entries"] > 0
    assert r["residual_ratio"] <= 1.0
    assert r["unbalance_after"] < r["unbalance_before"]
    assert r["objective_after"] < r["objective_before"]
    # the added brokers took replicas
    loads = check.broker_loads(c, np.vectorize(
        {int(b): i for i, b in enumerate(c.brokers)}.__getitem__)(c.replicas))
    assert len(c.brokers) == 10 and (loads[-2:] == 0).all()


def test_the_plan_of_another_cluster_fails(served):
    # a plan valid for another cluster of the fleet leaves this one where
    # it was: its entries break the move rules, or it settles nowhere
    c, text, opts = served
    other = check.Cluster({"version": 1, "partitions": fleet.expanded_cluster(
        seed=99, **fleet.fleet_params(tiny_config()))}, opts["broker_ids"])
    r = check.check_plan(other, text, opts)
    assert r["invalid"] > 0 or r["residual_ratio"] > 1.0


def test_unbalance_is_judged_from_the_loads():
    # weights default to 1 when no partition has one; added brokers count
    # in the mean load
    parts = [{"topic": "a", "partition": 0, "replicas": [1, 2]},
             {"topic": "a", "partition": 1, "replicas": [2, 1]}]
    c = check.Cluster({"version": 1, "partitions": parts}, [3])
    assert c.weight.tolist() == [1.0, 1.0] and c.brokers.tolist() == [1, 2, 3]
    u, _ = check.objective(c, np.array([[0, 1], [1, 0]]), 0.0)
    # loads 3, 3, 0 around a mean of 2
    assert u == pytest.approx(2 * 0.25 + 0.5)
    with pytest.raises(ValueError):
        check.Cluster({"version": 1, "partitions": [dict(parts[0], weight=2),
                                                    parts[1]]})


def test_a_plan_cut_short_fails(served):
    c, text, opts = served
    r = check.check_plan(c, check.truncate_plan(text, 0.75), opts)
    assert r["invalid"] == 0
    assert r["residual_ratio"] > 100.0


def test_one_corrupted_move_fails(served):
    c, text, opts = served
    doc = json.loads(text)
    e = doc["partitions"][-1]
    spare = next(b for b in c.brokers.tolist() if b not in e["replicas"])
    e["replicas"][-1] = int(spare)
    r = check.check_plan(c, json.dumps(doc), opts)
    assert r["invalid"] > 0 or r["residual_ratio"] > 1.0


def test_broken_constraints_are_invalid(served):
    c, text, opts = served
    doc = json.loads(text)
    first = doc["partitions"][0]
    p = c.index[(first["topic"], first["partition"])]
    start = c.replicas[p].tolist()
    spare = [b for b in c.brokers.tolist() if b not in start][0]
    breaks = [
        dict(first, replicas=[start[0]] * c.rf),          # repeated broker
        dict(first, replicas=start[:-1] + [10 ** 6]),      # unknown broker
        dict(first, partition=10 ** 6),                    # no such partition
        dict(first, replicas=[spare, start[0]]),           # replicas dropped
        dict(first, replicas=[spare, start[2], start[1]]),  # three changed
    ]
    if not opts["allow_leader"]:
        breaks.append(dict(first, replicas=[spare] + start[1:]))  # leader
    for e in breaks:
        alone = {"version": 1, "partitions": [e]}
        assert check.check_plan(c, json.dumps(alone), opts)["invalid"] > 0, e
    over = dict(opts, max_reassign=len(doc["partitions"]) - 1)
    assert check.check_plan(c, text, over)["invalid"] > 0
    assert check.check_plan(c, "{}", opts)["invalid"] > 0
    assert check.check_plan(c, "not json", opts)["invalid"] > 0


def brute_residual(c, bix, opts):
    """Every single move enumerated, the objective recomputed each time."""
    lam = opts["anti_colocation"]

    def obj(b):
        u, colo = check.objective(c, b, lam)
        return u + lam * colo

    base = obj(bix)
    best = 0.0
    slots = range(0 if opts["allow_leader"] else 1, c.rf)
    for p, s, t in itertools.product(range(len(bix)), slots,
                                     range(len(c.brokers))):
        if t in bix[p]:
            continue
        b = bix.copy()
        b[p, s] = t
        best = max(best, base - obj(b))
    return best


@pytest.mark.parametrize("allow_leader,lam", [(False, 0.0), (True, 0.0),
                                              (False, 0.05)])
def test_residual_equals_enumerating_every_move(allow_leader, lam):
    import random

    parts = fleet.expanded_cluster(40, 6, 5, 3, 7, seed=3)
    rng = random.Random(5)
    for p in parts:
        p["weight"] = round(rng.uniform(0.5, 2.0), 3)
    c = check.Cluster({"version": 1, "partitions": parts}, [6])
    ix = {int(b): i for i, b in enumerate(c.brokers)}
    bix = np.vectorize(ix.__getitem__)(c.replicas)
    opts = dict(check.planner_options([]), allow_leader=allow_leader,
                anti_colocation=lam)
    assert len(c.brokers) == 6
    assert check.residual(c, bix, opts) == pytest.approx(
        brute_residual(c, bix, opts), rel=1e-9, abs=1e-12)
