"""The fleet of clusters a run plans: a cluster just expanded with brokers.

Each cluster is the one Apache Kafka's documentation describes under
"Expanding your cluster": its topics were created on the original
brokers by Kafka's default replica assignment, then brokers were added,
and the added brokers hold no replica until partitions are moved to them.

The default assignment, rack-unaware (``AdminUtils.assignReplicasToBrokers``,
KIP-36), runs once per topic with its own random start index and replica
shift: the first replica of partition ``i`` is broker ``(i + start) % n``
of the broker list; replica ``j >= 1`` is ``(first + 1 + (shift + j - 1) %
(n - 1)) % n``, and the shift grows by one after every ``n`` partitions.
Partitions carry no ``weight``, as in the reassignment JSON Kafka's tools
write, so the planner weighs them equally. Brokers are numbered ``1 ..
brokers``, the added ones last. It uses only ``random`` and ``json``.

A run writes its fleet in a few processes of this file while the daemon
warms up (``Writers``); each writes one slice of the fleet:

    python3 portbench/fleet.py <config.json> <run seed> <first> <end> <directory>
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
from typing import Any, Dict, Iterable, List, Sequence


def default_assignment(n_partitions: int, brokers: Sequence[int], rf: int,
                       start: int, shift: int) -> List[List[int]]:
    """One topic's replica lists as Kafka's rack-unaware default
    assignment makes them on ``brokers`` from its start index and its
    replica shift (both drawn at random, per topic, by Kafka)."""
    n = len(brokers)
    out = []
    for i in range(n_partitions):
        if i > 0 and i % n == 0:
            shift += 1
        first = (i + start) % n
        reps = [brokers[first]]
        for j in range(rf - 1):
            reps.append(brokers[(first + 1 + (shift + j) % (n - 1)) % n])
        out.append(reps)
    return out


def expanded_cluster(n_partitions: int, n_brokers: int,
                     original_brokers: int, rf: int, topic_partitions: int,
                     seed: int) -> List[Dict[str, Any]]:
    """Topics of ``topic_partitions`` partitions (the last one shorter if
    need be) placed by the default assignment on brokers ``1 ..
    original_brokers``, in a cluster of ``n_brokers``: the partition dicts
    (``topic``, ``partition``, ``replicas``)."""
    if not 1 < original_brokers <= n_brokers:
        raise ValueError("the original brokers must be 2 .. n_brokers")
    rng = random.Random(seed)
    original = list(range(1, original_brokers + 1))
    parts: List[Dict[str, Any]] = []
    t = 0
    while len(parts) < n_partitions:
        size = min(topic_partitions, n_partitions - len(parts))
        start, shift = rng.randrange(original_brokers), \
            rng.randrange(original_brokers)
        for i, reps in enumerate(
                default_assignment(size, original, rf, start, shift)):
            parts.append({"topic": f"t{t}", "partition": i,
                          "replicas": reps})
        t += 1
    return parts


def cluster_seed(run_seed: int, index: int) -> int:
    """The seed of the ``index``-th cluster of a run's fleet."""
    return (int(run_seed) * 1000003 + 7919 * index) % (2 ** 61 - 1)


def fleet_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """``expanded_cluster``'s keyword arguments from a configuration."""
    return dict(
        n_partitions=int(config["partitions"]),
        n_brokers=int(config["brokers"]),
        original_brokers=int(config["original_brokers"]),
        rf=int(config["replication_factor"]),
        topic_partitions=int(config["topic_partitions"]),
    )


def broker_ids_flag(config: Dict[str, Any]) -> str:
    """The planner's ``-broker-ids``: every broker of the cluster, the
    added ones too, which no replica names yet."""
    return "-broker-ids=" + ",".join(
        str(b) for b in range(1, int(config["brokers"]) + 1))


def write_fleet(
    config: Dict[str, Any], run_seed: int, indices: Iterable[int],
    directory: str,
) -> List[str]:
    """Write the fleet's clusters ``indices``, drawn from ``run_seed``, as
    ``-input-json`` files under ``directory``; returns their paths."""
    params = fleet_params(config)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for k in indices:
        parts = expanded_cluster(seed=cluster_seed(run_seed, k), **params)
        path = cluster_path(directory, k)
        with open(path, "w") as f:
            json.dump({"version": 1, "partitions": parts}, f,
                      separators=(",", ":"))
        paths.append(path)
    return paths


def cluster_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"cluster-{index:03d}.json")


class Writers:
    """Processes that write clusters ``0 .. count - 1`` of a run's fleet
    into ``directory``; ``paths`` waits for them."""

    def __init__(self, config: Dict[str, Any], run_seed: int, directory: str,
                 count: int, workers: int) -> None:
        os.makedirs(directory, exist_ok=True)
        cfg_path = os.path.join(directory, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        self.directory = directory
        self.count = count
        per = -(-count // workers)
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), cfg_path,
                 str(run_seed), str(lo), str(min(count, lo + per)), directory],
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE)
            for lo in range(0, count, per)]

    def paths(self, timeout: float) -> List[str]:
        for proc in self.procs:
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"a fleet writer exited {proc.returncode}: "
                                   f"{err.decode(errors='replace')[-2000:]}")
        return [cluster_path(self.directory, k) for k in range(self.count)]

    def stop(self) -> None:
        """End every writer still running and wait for it."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main(argv: Sequence[str]) -> int:
    cfg_path, run_seed, lo, hi, directory = argv
    with open(cfg_path) as f:
        config = json.load(f)
    write_fleet(config, int(run_seed), range(int(lo), int(hi)), directory)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
