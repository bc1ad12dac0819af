"""Output codec: Kafka reassignment-JSON writer and unique filter.

Reference: ``WritePartitionList`` (codecs.go:84-93) and
``FilterPartitionList`` (codecs.go:67-82).

The writer is byte-compatible with Go's ``encoding/json`` encoder for this
schema:

- compact encoding, struct field order (``topic``, ``partition``,
  ``replicas``, then the ``omitempty`` extension fields ``weight``,
  ``num_replicas``, ``brokers``, ``num_consumers``), trailing newline
  (``json.Encoder.Encode``);
- ``omitempty`` drops zero values (0, 0.0, empty/nil lists);
- a nil top-level ``partitions`` slice encodes as ``null``
  (``partitions`` has no omitempty tag, kafkabalancer.go:42);
- floats use Go's shortest-round-trip formatting (``1`` not ``1.0``,
  ``0.00005`` not ``5e-05``, e-notation only below 1e-6 / at or above 1e21);
- HTML-unsafe characters in strings are escaped like Go's default
  ``SetEscapeHTML(true)`` (``<``, ``>``, ``&`` to ``\\u003c`` etc.);
- ``version`` is forced to 1 on output (codecs.go:86).
"""

from __future__ import annotations

import json
import math
from typing import List, TextIO

from kafkabalancer_tpu_torch.codecs.readers import CodecError
from kafkabalancer_tpu_torch.models import Partition, PartitionList


def format_go_float(f: float) -> str:
    """Format a float the way Go's ``encoding/json`` does.

    Go uses ``strconv.AppendFloat`` with shortest round-trip precision, in
    ``'f'`` style unless ``abs(f) < 1e-6`` or ``abs(f) >= 1e21`` where it
    switches to ``'e'`` style with a two-digit exponent
    (encoding/json floatEncoder semantics).
    """
    if math.isnan(f) or math.isinf(f):
        raise CodecError(
            f"failed serializing json: unsupported value: {f}"
        )
    if f == 0:
        return "-0" if math.copysign(1.0, f) < 0 else "0"

    # Shortest round-trip digits via Python's repr, then re-render.
    r = repr(float(f))
    neg = r.startswith("-")
    if neg:
        r = r[1:]
    if "e" in r:
        mant, _, exps = r.partition("e")
        exp = int(exps)
    else:
        mant, exp = r, 0
    if "." in mant:
        int_part, frac = mant.split(".")
    else:
        int_part, frac = mant, ""
    raw_digits = int_part + frac
    # Decimal point position measured in digits from the left of raw_digits.
    point = len(int_part) + exp
    stripped = raw_digits.lstrip("0")
    point -= len(raw_digits) - len(stripped)
    digits = (stripped.rstrip("0") or "0")
    # Now value = 0.<digits> * 10**point  (digits has no leading/trailing zeros)

    sign = "-" if neg else ""
    abs_f = abs(f)
    if abs_f < 1e-6 or abs_f >= 1e21:
        # 'e' style: d[.ddd]e±XX with at least a two-digit exponent, then
        # Go's json floatEncoder cleanup: "e-0X" is rewritten to "e-X"
        # (negative two-digit exponents only — "clean up e-09 to e-9").
        e = point - 1
        head = digits[0]
        tail = digits[1:]
        mant_s = head + ("." + tail if tail else "")
        out = f"{sign}{mant_s}e{'+' if e >= 0 else '-'}{abs(e):02d}"
        if len(out) >= 4 and out[-4] == "e" and out[-3] == "-" and out[-2] == "0":
            out = out[:-2] + out[-1]
        return out
    # 'f' style: plain decimal expansion.
    if point <= 0:
        return sign + "0." + "0" * (-point) + digits
    if point >= len(digits):
        return sign + digits + "0" * (point - len(digits))
    return sign + digits[:point] + "." + digits[point:]


def _json_string(s: str) -> str:
    """JSON-encode a string with Go's default HTML escaping."""
    out = json.dumps(s, ensure_ascii=False)
    return (
        out.replace("&", "\\u0026").replace("<", "\\u003c").replace(">", "\\u003e")
    )


def _encode_int_list(lst: List[int]) -> str:
    return "[" + ",".join(str(i) for i in lst) + "]"


def _encode_partition(p: Partition) -> str:
    # An empty replicas list encodes as [] like Go's non-nil empty slice.
    # (The absent-key -> nil -> null case is not representable here; such
    # degenerate partitions crash the reference planner before any output.)
    parts = [
        f'"topic":{_json_string(p.topic)}',
        f'"partition":{p.partition}',
        f'"replicas":{_encode_int_list(p.replicas)}',
    ]
    # omitempty extension fields (kafkabalancer.go:54-57)
    if p.weight != 0:
        parts.append(f'"weight":{format_go_float(p.weight)}')
    if p.num_replicas != 0:
        parts.append(f'"num_replicas":{p.num_replicas}')
    if p.brokers:
        parts.append(f'"brokers":{_encode_int_list(p.brokers)}')
    if p.num_consumers != 0:
        parts.append(f'"num_consumers":{p.num_consumers}')
    return "{" + ",".join(parts) + "}"


def encode_partition_list(pl: PartitionList) -> str:
    """Encode ``pl`` exactly as the reference writer would (without I/O)."""
    pl.version = 1  # forced, codecs.go:86
    if pl.partitions is None:
        body = "null"
    else:
        body = "[" + ",".join(_encode_partition(p) for p in pl.partitions) + "]"
    return f'{{"version":{pl.version},"partitions":{body}}}\n'


def write_partition_list(out: TextIO, pl: PartitionList) -> None:
    """Reference ``WritePartitionList`` (codecs.go:84-93); raises CodecError
    with the reference's message prefix on write failure (exit code 4)."""
    data = encode_partition_list(pl)
    try:
        out.write(data)
    except Exception as exc:  # any sink failure maps to the reference's error
        raise CodecError(f"failed serializing json: {exc}") from None


def filter_partition_list(pl: PartitionList) -> PartitionList:
    """Keep only the first occurrence of each topic+partition.

    Reference ``FilterPartitionList`` (codecs.go:67-82): first occurrence
    wins; the output version mirrors the input's.
    """
    ppl = PartitionList(version=pl.version)
    seen = set()
    for p in pl.iter_partitions():
        key = (p.topic, p.partition)
        if key not in seen:
            seen.add(key)
            ppl.append(p)
    return ppl
