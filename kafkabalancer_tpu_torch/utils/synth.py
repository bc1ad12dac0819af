"""Synthetic cluster generation for benchmarks and dry runs.

Produces deliberately unbalanced assignments in the shape of the reference's
fixture (test/test.json: a few brokers hot, most cold) scaled to arbitrary
partition/broker counts. Deterministic per seed.
"""

from __future__ import annotations

import random
from typing import List, Optional

from kafkabalancer_tpu_torch.models import Partition, PartitionList


def synth_cluster(
    n_partitions: int,
    n_brokers: int,
    rf: int = 3,
    seed: int = 0,
    weighted: bool = True,
    skew: float = 3.0,
    num_consumers_max: int = 0,
    zipf_topics: bool = False,
) -> PartitionList:
    """An unbalanced ``n_partitions`` × ``n_brokers`` assignment.

    Brokers are skewed: low-ID brokers are ``skew``× likelier to hold
    replicas, mimicking a cluster that grew by adding brokers (the
    README.md:109-124 scenario at scale).

    ``zipf_topics`` replaces the uniform 50-partition topic blocks with
    power-law topic sizes (a few huge topics, a long tail of small ones
    — the shape real Kafka clusters have) and gives each topic a base
    throughput so partitions of one topic carry similar weights. This is
    the realistic instance shape for the anti-colocation objective: big
    topics are exactly the ones whose replicas crowd onto hot brokers.
    """
    rng = random.Random(seed)
    brokers = list(range(1, n_brokers + 1))
    # population weights: broker i gets weight skew..1 linearly
    bw = [skew - (skew - 1.0) * i / max(1, n_brokers - 1) for i in range(n_brokers)]

    if zipf_topics and n_partitions > 0:
        # ~n/32 topics with power-law sizes normalized to sum to
        # n_partitions: a few hundred-partition topics, a long tail of
        # small ones (floor 2, shrunk when the instance is tiny so the
        # remainder distribution below always terminates)
        n_topics = max(1, min(n_partitions // 2, max(4, n_partitions // 32)))
        floor = 2 if n_partitions >= 2 * n_topics else 1
        raw = [1.0 / (t + 1) ** 0.9 for t in range(n_topics)]
        scale = n_partitions / sum(raw)
        sizes = [max(floor, int(r * scale)) for r in raw]
        total = sum(sizes)
        # distribute the rounding remainder over the largest topics
        t = 0
        while total != n_partitions:
            step = 1 if total < n_partitions else -1
            if sizes[t % n_topics] + step >= floor:
                sizes[t % n_topics] += step
                total += step
            t += 1
        topic_of = []
        for t, s in enumerate(sizes):
            base = rng.uniform(0.5, 2.0)
            topic_of.extend([(f"t{t}", i, base) for i in range(s)])
        rng.shuffle(topic_of)
    else:
        topic_of = [
            (f"t{i % max(1, n_partitions // 50)}", i, None)
            for i in range(n_partitions)
        ]

    parts = []
    for i in range(n_partitions):
        replicas: list = []
        while len(replicas) < min(rf, n_brokers):
            (b,) = rng.choices(brokers, weights=bw)
            if b not in replicas:
                replicas.append(b)
        topic, pid, base = topic_of[i]
        if weighted:
            if base is not None:
                # same-topic partitions carry similar throughput
                weight = round(base * rng.uniform(0.8, 1.25), 3)
            else:
                weight = round(rng.uniform(0.5, 2.0), 3)
        else:
            weight = 0.0
        parts.append(
            Partition(
                topic=topic,
                partition=pid,
                replicas=replicas,
                weight=weight,
                num_consumers=(
                    rng.randint(0, num_consumers_max) if num_consumers_max else 0
                ),
            )
        )
    return PartitionList(version=1, partitions=parts)


def rotation_locked_cluster(
    n_groups: int, weight: float = 1.0
) -> PartitionList:
    """Anti-colocation instances whose only improvements are 3-move
    ROTATIONS — the workload class where beam search's uphill sequences
    are provably necessary (benchmarks/RESULTS.md round-5 beam note).

    Each group owns three brokers (x, y, z) and three topics (A, B, C),
    six rf=2 partitions arranged so that per group (weights all equal,
    every broker's load exactly 6w, num_consumers 0):

    - three colocations are RESOLVABLE only by the follower rotation
      ``A2f: x->y, B2f: y->z, C2f: z->x`` (restricted broker lists allow
      exactly one foreign target per movable follower; the other three
      partitions are frozen — their only allowed targets are already
      members);
    - each rotation step alone is UPHILL for the combined objective
      (perfect load balance means any single move costs
      pen(5w)+pen(7w)-2*pen(6w) = 1/24 in rel^2 units; pick
      λ < 1/24 ≈ 0.0417 — e.g. 0.015 — so no single follower move and
      no broker-disjoint PAIR SWAP improves: the swap partners the
      polish phase would need are blocked by membership or the
      restricted lists);
    - the full 3-cycle returns every load to 6w and removes 3
      colocations: net -3λ, reachable ONLY through sequence-level
      acceptance of uphill prefixes (beam depth >= 3).

    Groups are independent and identical, so the certified gap between
    the greedy-session+polish floor and beam's floor is exactly
    3λ·n_groups.
    """
    parts = []
    for g in range(n_groups):
        x, y, z = 3 * g + 1, 3 * g + 2, 3 * g + 3
        A, B, C = f"rotA{g}", f"rotB{g}", f"rotC{g}"

        def part(
            topic: str, pid: int, leader: int, follower: int,
            allowed: Optional[List[int]],
        ) -> None:
            parts.append(
                Partition(
                    topic=topic,
                    partition=pid,
                    replicas=[leader, follower],
                    weight=weight,
                    brokers=sorted(allowed),
                    num_consumers=0,
                )
            )

        part(A, 1, x, z, [x, z])        # frozen
        part(A, 2, z, x, [z, x, y])     # movable follower x -> y
        part(B, 1, y, x, [y, x])        # frozen
        part(B, 2, x, y, [x, y, z])     # movable follower y -> z
        part(C, 1, z, y, [z, y])        # frozen
        part(C, 2, y, z, [y, z, x])     # movable follower z -> x
    return PartitionList(version=1, partitions=parts)
