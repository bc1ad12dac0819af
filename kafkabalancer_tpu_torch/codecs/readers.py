"""Input codecs.

Reference: ``GetPartitionListFromReader`` (codecs.go:15-64). Two formats:

- reassignment JSON (``-input-json``), with a strict ``version == 1`` check
  (codecs.go:24-26);
- ``kafka-topics.sh --describe`` text output, parsed line-by-line with the
  same regex as the reference (codecs.go:29); non-matching lines are silently
  skipped, and the optional topic filter is applied per line
  (codecs.go:36-38). ``Leader:`` and ``Isr:`` fields are captured by the
  regex but ignored — the leader is taken to be ``replicas[0]``.

Both paths reject an empty partition list (codecs.go:59-61).
"""

from __future__ import annotations

import io
import json
import re
from typing import List, Optional, TextIO, Union

from kafkabalancer_tpu_torch.models import Partition, PartitionList


class CodecError(Exception):
    """Raised for any input/output codec failure (maps to CLI exit code 2/4)."""


# Same pattern as the reference (codecs.go:29).
_DESCRIBE_RE = re.compile(
    "^\tTopic: ([^\t]*)\tPartition: ([0-9]*)\tLeader: ([0-9]*)"
    "\tReplicas: ([0-9,]*)\tIsr: ([0-9,]*)"
)


def _atoi(s: str) -> int:
    """Go ``strconv.Atoi`` with the error ignored (codecs.go:40,44): 0 on failure."""
    try:
        return int(s)
    except ValueError:
        return 0


def _partition_from_obj(obj: object) -> Partition:
    if not isinstance(obj, dict):
        raise CodecError(
            "failed parsing json: partition entry is not an object"
        )
    p = Partition()
    try:
        if "topic" in obj:
            if not isinstance(obj["topic"], str):
                raise TypeError("topic")
            p.topic = obj["topic"]
        if "partition" in obj:
            p.partition = _require_int(obj["partition"], "partition")
        if "replicas" in obj:
            p.replicas = _require_int_list(obj["replicas"], "replicas")
        if "weight" in obj:
            w = obj["weight"]
            if isinstance(w, bool) or not isinstance(w, (int, float)):
                raise TypeError("weight")
            p.weight = float(w)
        if "num_replicas" in obj:
            p.num_replicas = _require_int(obj["num_replicas"], "num_replicas")
        if "brokers" in obj:
            p.brokers = _require_int_list(obj["brokers"], "brokers")
        if "num_consumers" in obj:
            p.num_consumers = _require_int(obj["num_consumers"], "num_consumers")
    except TypeError as exc:
        raise CodecError(
            f"failed parsing json: invalid value for field {exc}"
        ) from None
    return p


def _require_int(v: object, name: str) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError(name)
    return v


def _require_int_list(v: object, name: str) -> List[int]:
    if v is None:
        return []
    if not isinstance(v, list):
        raise TypeError(name)
    out = []
    for item in v:
        if isinstance(item, bool) or not isinstance(item, int):
            raise TypeError(name)
        out.append(item)
    return out


def get_partition_list_from_reader(
    stream: Union[TextIO, str, bytes],
    is_json: bool,
    topics: Optional[List[str]] = None,
) -> PartitionList:
    """Parse a partition list from a text stream or string.

    Behavioural contract: reference codecs.go:15-64 (see module docstring).
    Raises :class:`CodecError` with a message whose prefix matches the
    reference's error strings.
    """
    topics = topics or []
    if isinstance(stream, (str, bytes)):
        if isinstance(stream, bytes):
            stream = stream.decode("utf-8", errors="replace")
        stream = io.StringIO(stream)

    pl = PartitionList()

    if is_json:
        try:
            obj = json.load(stream)
        except ValueError as exc:
            raise CodecError(f"failed parsing json: {exc}") from None
        if not isinstance(obj, dict):
            raise CodecError("failed parsing json: top-level value is not an object")
        version = obj.get("version", 0)
        if isinstance(version, bool) or not isinstance(version, int):
            raise CodecError("failed parsing json: invalid value for field version")
        pl.version = version
        if pl.version != 1:
            raise CodecError(
                f"wrong partition list version: expected 1, got {pl.version}"
            )
        raw_parts = obj.get("partitions")
        if raw_parts is not None:
            if not isinstance(raw_parts, list):
                raise CodecError(
                    "failed parsing json: invalid value for field partitions"
                )
            pl.partitions = [_partition_from_obj(o) for o in raw_parts]
    else:
        try:
            for line in stream:
                m = _DESCRIBE_RE.match(line)
                if m is None:
                    continue
                if topics and m.group(1) not in topics:
                    continue
                partition = _atoi(m.group(2))
                replicas = [_atoi(s) for s in m.group(4).split(",")]
                pl.append(
                    Partition(
                        topic=m.group(1),
                        partition=partition,
                        replicas=replicas,
                    )
                )
        except OSError as exc:
            raise CodecError(f"failed reading file: {exc}") from None

    if len(pl) == 0:
        raise CodecError("empty partition list")

    return pl
