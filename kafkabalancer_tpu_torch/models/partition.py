"""Data model for partition assignments.

Mirrors the reference's data model (kafkabalancer.go:16-66) with the same JSON
schema and semantic defaults, but as plain Python dataclasses. Broker IDs and
partition IDs are ints; topics are strings.

Conventions preserved from the reference:

- ``replicas[0]`` is the partition leader (implicit Kafka convention, relied
  on at utils.go:96-101 and steps.go:172-175).
- A ``PartitionList`` with ``partitions is None`` serializes to
  ``"partitions":null`` exactly like the reference's nil slice (Go
  ``encoding/json`` marshals a nil slice as ``null``; observable when no
  reassignment is produced, kafkabalancer.go:177 + codecs.go:84-93).
- Extension fields ``weight``, ``num_replicas``, ``brokers``,
  ``num_consumers`` all carry ``omitempty`` semantics (kafkabalancer.go:54-57):
  zero values are omitted on output.
- ``num_consumers`` is *not* defaulted anywhere: the reference comment claims
  "default: 1" (kafkabalancer.go:57) but no code ever sets it, so it is 0
  unless present in the input. We reproduce the code's behaviour, not the
  comment (SURVEY.md §2.1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional


def _fmt_replicas(replicas: List[int]) -> str:
    """Format a replica list like Go's ``%+v`` on ``[]BrokerID``: ``[1 2 3]``."""
    return "[" + " ".join(str(r) for r in replicas) + "]"


@dataclass
class Partition:
    """One partition's assignment plus rebalance extension fields.

    Reference: ``Partition`` struct, kafkabalancer.go:49-66.
    """

    topic: str = ""
    partition: int = 0
    replicas: List[int] = field(default_factory=list)
    # extension fields (all omitempty on output)
    weight: float = 0.0  # default applied by fill_defaults: 1.0
    num_replicas: int = 0  # default applied by fill_defaults: len(replicas)
    brokers: Optional[List[int]] = None  # default applied by fill_defaults
    num_consumers: int = 0  # never defaulted (see module docstring)

    def compare(self, other: "Partition") -> bool:
        """Identity on topic+partition only (kafkabalancer.go:60-62)."""
        return self.topic == other.topic and self.partition == other.partition

    def copy(self) -> "Partition":
        return Partition(
            topic=self.topic,
            partition=self.partition,
            replicas=list(self.replicas),
            weight=self.weight,
            num_replicas=self.num_replicas,
            brokers=None if self.brokers is None else list(self.brokers),
            num_consumers=self.num_consumers,
        )

    def __str__(self) -> str:
        # Matches Go's Stringer: "Partition(%s,%d,%+v)" (kafkabalancer.go:64-66)
        reps = _fmt_replicas(self.replicas)
        return f"Partition({self.topic},{self.partition},{reps})"


@dataclass
class PartitionList:
    """A versioned list of partitions (kafkabalancer.go:40-47).

    ``partitions`` may be ``None`` to mirror Go's nil slice (serialized as
    ``null``); use :func:`empty_partition_list` for the reference's
    ``emptypl()`` (utils.go:149-151).
    """

    version: int = 0
    partitions: Optional[List[Partition]] = None

    def iter_partitions(self) -> Iterator[Partition]:
        return iter(self.partitions or ())

    def __len__(self) -> int:
        return len(self.partitions or ())

    def append(self, *parts: Partition) -> None:
        if self.partitions is None:
            self.partitions = []
        self.partitions.extend(parts)

    def __str__(self) -> str:
        inner = " ".join(str(p) for p in (self.partitions or ()))
        return f"PartitionList([{inner}])"


def empty_partition_list() -> PartitionList:
    """Reference ``emptypl()``: version 1, nil partitions (utils.go:149-151)."""
    return PartitionList(version=1, partitions=None)


def single_partition_list(p: Partition) -> PartitionList:
    """Reference ``singlepl()`` (utils.go:153-155)."""
    return PartitionList(version=1, partitions=[p])
