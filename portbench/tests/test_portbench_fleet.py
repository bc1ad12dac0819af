"""The fleet generator: Kafka's default assignment on the original
brokers, the added brokers empty; deterministic from the seed, distinct
clusters."""

import collections
import json
import os

from portbench import fleet, spec


def small(cfg):
    return dict(cfg, partitions=300, brokers=20, original_brokers=15,
                topic_partitions=15)


def test_default_assignment_matches_kafkas_documented_example():
    # AdminUtils.assignReplicasToBrokers' own example: 10 partitions, RF 3
    # on brokers 0..4, start index 0 and replica shift 0
    got = fleet.default_assignment(10, [0, 1, 2, 3, 4], 3, 0, 0)
    assert got == [[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 0], [4, 0, 1],
                   [0, 2, 3], [1, 3, 4], [2, 4, 0], [3, 0, 1], [4, 1, 2]]


def test_same_seed_same_fleet_and_distinct_clusters(tmp_path):
    cfg = small(spec.config("kafka-10k-expand"))
    a = fleet.write_fleet(cfg, 4294967311, range(6), str(tmp_path / "a"))
    b = fleet.write_fleet(cfg, 4294967311, range(6), str(tmp_path / "b"))
    texts_a = [open(p).read() for p in a]
    assert texts_a == [open(p).read() for p in b]
    assert len(set(texts_a)) == 6
    c = fleet.write_fleet(cfg, 4294967312, range(6), str(tmp_path / "c"))
    assert not set(texts_a) & {open(p).read() for p in c}


def test_original_brokers_even_and_added_brokers_empty(tmp_path):
    cfg = small(spec.config("kafka-10k-expand"))
    (path,) = fleet.write_fleet(cfg, 7, [3], str(tmp_path))
    parts = json.load(open(path))["partitions"]
    assert len(parts) == 300
    assert {len(set(p["replicas"])) for p in parts} == {3}
    assert all("weight" not in p for p in parts)
    assert len({p["topic"] for p in parts}) == 300 // 15
    leaders = collections.Counter(p["replicas"][0] for p in parts)
    followers = collections.Counter(b for p in parts for b in p["replicas"][1:])
    assert set(leaders) == set(followers) == set(range(1, 16))
    assert set(leaders.values()) == {20} and set(followers.values()) == {40}
    assert fleet.broker_ids_flag(cfg) == "-broker-ids=" + ",".join(
        map(str, range(1, 21)))


def test_the_configuration_at_its_size():
    cfg = spec.config("kafka-10k-expand")
    parts = fleet.expanded_cluster(seed=1, **fleet.fleet_params(cfg))
    assert len(parts) == 10000
    load = collections.Counter()
    for p in parts:
        load[p["replicas"][0]] += 3
        for b in p["replicas"][1:]:
            load[b] += 1
    assert set(load) == set(range(1, 81)) and set(load.values()) == {625}
    assert sum(load.values()) / cfg["brokers"] == 500


def test_slices_of_a_fleet_match_the_whole(tmp_path):
    cfg = small(spec.config("kafka-10k-expand"))
    whole = fleet.write_fleet(cfg, 11, range(4), str(tmp_path / "w"))
    parts = (fleet.write_fleet(cfg, 11, range(2), str(tmp_path / "p"))
             + fleet.write_fleet(cfg, 11, range(2, 4), str(tmp_path / "p")))
    assert [os.path.basename(p) for p in whole] == \
        [os.path.basename(p) for p in parts]
    assert [open(p).read() for p in whole] == [open(p).read() for p in parts]
