"""pprof-format CPU profiles from cProfile data.

The reference's ``-pprof`` flag (via ``github.com/pkg/profile``,
kafkabalancer.go:85, :100-102) writes a profile that ``go tool pprof``
can read: a gzipped protobuf in the ``perftools.profiles.Profile``
schema. Python's cProfile speaks neither, so this module hand-encodes
the small subset of profile.proto the converter needs — varint/
length-delimited wire format only, no protobuf dependency.

Mapping: one sample per profiled function with a single-frame stack and
values ``(calls, self-time ns)``; sample types ``samples/count`` and
``cpu/nanoseconds`` (the conventional pair pprof's CPU view expects).
cProfile keeps caller→callee edges but not full stacks, so flame-graph
depth is inherently one frame — flat ``-top`` views are exact. Checked
against ``go tool pprof -raw/-top``.

profile.proto field numbers (github.com/google/pprof):
Profile{1 sample_type, 2 sample, 4 location, 5 function, 6 string_table,
9 time_nanos, 10 duration_nanos, 11 period_type, 12 period};
Sample{1 location_id*, 2 value*}; Location{1 id, 4 line};
Line{1 function_id, 2 line}; Function{1 id, 2 name, 3 system_name,
4 filename, 5 start_line}; ValueType{1 type, 2 unit}.
"""

from __future__ import annotations

import cProfile
import gzip
import time
from typing import Any, Iterable, List, Sequence


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # proto uint64 wrap for negatives
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _packed(field: int, values: Iterable[int]) -> bytes:
    body = b"".join(_varint(v) for v in values)
    return _field_bytes(field, body)


def _value_type(type_idx: int, unit_idx: int) -> bytes:
    return _field_varint(1, type_idx) + _field_varint(2, unit_idx)


def encode_profile(entries: Sequence[Any], duration_ns: int) -> bytes:
    """Encode ``cProfile.Profile.getstats()`` entries as an uncompressed
    profile.proto message."""
    strings: List[str] = [""]
    str_idx = {"": 0}

    def s(text: str) -> int:
        idx = str_idx.get(text)
        if idx is None:
            idx = str_idx[text] = len(strings)
            strings.append(text)
        return idx

    samples = b""
    functions = b""
    locations = b""
    for i, entry in enumerate(entries):
        code = entry.code
        if isinstance(code, str):  # builtin: '<built-in ...>' description
            name, filename, line = code, "~", 0
        else:
            name = code.co_name
            filename = code.co_filename
            line = code.co_firstlineno
        fid = i + 1
        functions += _field_bytes(
            5,
            _field_varint(1, fid)
            + _field_varint(2, s(name))
            + _field_varint(3, s(name))
            + _field_varint(4, s(filename))
            + _field_varint(5, line),
        )
        locations += _field_bytes(
            4,
            _field_varint(1, fid)
            + _field_bytes(
                4, _field_varint(1, fid) + _field_varint(2, line)
            ),
        )
        samples += _field_bytes(
            2,
            _packed(1, [fid])
            + _packed(
                2,
                [entry.callcount, int(entry.inlinetime * 1e9)],
            ),
        )

    sample_types = _field_bytes(
        1, _value_type(s("samples"), s("count"))
    ) + _field_bytes(1, _value_type(s("cpu"), s("nanoseconds")))
    period_type = _field_bytes(11, _value_type(s("cpu"), s("nanoseconds")))
    string_table = b"".join(
        _field_bytes(6, t.encode("utf-8")) for t in strings
    )
    return (
        sample_types
        + samples
        + locations
        + functions
        + string_table
        + _field_varint(9, time.time_ns())
        + _field_varint(10, max(0, duration_ns))
        + period_type
        + _field_varint(12, 1)
    )


def write_pprof(
    profiler: cProfile.Profile, path: str, duration_ns: int = 0
) -> None:
    """Write ``profiler`` (a ``cProfile.Profile``) as a gzipped pprof
    profile readable by ``go tool pprof``."""
    data = encode_profile(profiler.getstats(), duration_ns)
    with gzip.open(path, "wb") as f:
        f.write(data)
