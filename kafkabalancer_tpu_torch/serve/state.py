"""Canonical cluster-state digests and binary row records (protocol v2).

The resident-session machinery (serve/sessions.py) needs
BOTH ends of the wire to agree on one question: "is the cluster state the
client just read exactly the state the daemon predicts?" — without the
client shipping the state. The answer is a content digest over the RAW
PARSED rows (pre-settle: exactly what ``codecs.get_partition_list_from_
reader`` produces, before ``fill_defaults`` touches anything), order
sensitive because row order shapes the dense encoding and therefore the
plan.

Three layers, all torch- and numpy-free (the forwarding client imports
this module, and its no-torch/no-numpy pin extends here):

- **canonical row bytes** (:func:`canonical_row_bytes`): one partition's
  digest-relevant fields in a fixed rendering. The ONE definition both
  the client (from its freshly parsed input) and the daemon (from its
  resident raw rows, moves applied) hash — they cannot drift because
  they share this function, and the client parses through the very same
  codecs reader the daemon would use (pinned by tests/test_sessions.py).
- **per-row hashes + state digest** (:func:`row_hash`,
  :func:`rows_digest`): 8-byte blake2b per row, sha256 over the
  concatenation (plus the list version) for the whole state. The row
  hashes double as the resync diff unit: on a digest mismatch the daemon
  ships its row-hash table (``ROW_HASH_BYTES`` per row) and the client
  ships only the rows whose hashes differ.
- **packed row records** (:func:`pack_rows` / :func:`unpack_rows`): the
  pre-encoded binary payload of a ``plan-rows`` resync — struct-packed,
  no JSON escaping, so a one-row drift ships ~tens of bytes instead of a
  re-serialized full cluster.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

ROW_HASH_BYTES = 8

# one parsed row's digest-relevant fields, in codecs-reader semantics:
# (topic, partition, replicas, weight, num_replicas, brokers, n_consumers)
RowFields = Tuple[
    str, int, List[int], float, int, Optional[List[int]], int
]


class ClientState(NamedTuple):
    """The client side's view of its input, ready for the session
    exchange: the state digest, the canonical row bytes (per-row
    hashes derive from them lazily — only the rare resync diff needs
    them), the raw row fields (for packing changed rows), and the
    parsed list version."""

    digest: str
    canon: List[bytes]
    rows: List[RowFields]
    version: int


def canonical_row_bytes(
    topic: str,
    partition: int,
    replicas: Sequence[int],
    weight: float,
    num_replicas: int,
    brokers: Optional[Sequence[int]],
    num_consumers: int,
) -> bytes:
    """One row's canonical digest rendering. ``repr`` of a tuple of
    primitives is deterministic across processes (no hash
    randomization applies to ints/floats/str contents)."""
    return repr((
        topic,
        partition,
        tuple(replicas),
        float(weight),
        num_replicas,
        None if brokers is None else tuple(brokers),
        num_consumers,
    )).encode("utf-8")


def row_hash(canonical: bytes) -> bytes:
    return hashlib.blake2b(canonical, digest_size=ROW_HASH_BYTES).digest()


def fields_row_hash(fields: RowFields) -> bytes:
    return row_hash(canonical_row_bytes(*fields))


def partition_fields(p: object) -> RowFields:
    """A ``models.Partition``-shaped object's digest fields. Duck-typed
    (``object``) so this module stays importable without the models
    package loaded — the daemon passes real Partitions."""
    return (
        p.topic,  # type: ignore[attr-defined]
        p.partition,  # type: ignore[attr-defined]
        list(p.replicas),  # type: ignore[attr-defined]
        p.weight,  # type: ignore[attr-defined]
        p.num_replicas,  # type: ignore[attr-defined]
        (
            None
            if p.brokers is None  # type: ignore[attr-defined]
            else list(p.brokers)  # type: ignore[attr-defined]
        ),
        p.num_consumers,  # type: ignore[attr-defined]
    )


def rows_digest(version: int, canon: Sequence[bytes]) -> str:
    """The whole-state digest: list version + every canonical row
    (length-prefixed — no concatenation ambiguity), order sensitive.
    Defined over the canonical BYTES, not per-row hashes, so the
    steady-state client pays one sha256 pass instead of a per-row
    hash."""
    h = hashlib.sha256()
    h.update(f"v{version}:{len(canon)}:".encode("ascii"))
    for b in canon:
        h.update(len(b).to_bytes(4, "big"))
        h.update(b)
    return h.hexdigest()


def hashes_of(canon: Sequence[bytes]) -> List[bytes]:
    """Per-row hashes of canonical row bytes — the resync diff unit,
    computed lazily (only a digest mismatch needs them)."""
    return [row_hash(b) for b in canon]


def pack_hash_table(hashes: Sequence[bytes]) -> bytes:
    """The daemon's resync diff table: row hashes concatenated in row
    order (``ROW_HASH_BYTES`` each)."""
    return b"".join(hashes)


def unpack_hash_table(blob: bytes) -> List[bytes]:
    if len(blob) % ROW_HASH_BYTES:
        raise ValueError(
            f"row-hash table length {len(blob)} is not a multiple of "
            f"{ROW_HASH_BYTES}"
        )
    return [
        blob[i: i + ROW_HASH_BYTES]
        for i in range(0, len(blob), ROW_HASH_BYTES)
    ]


class _BadField(Exception):
    """A field shape the codecs reader would reject (CodecError)."""


def _json_int_list(v: object) -> List[int]:
    """Mirror of ``codecs.readers._require_int_list``: None is an
    empty list, non-int (or bool) members are a parse error."""
    if v is None:
        return []
    if not isinstance(v, list):
        raise _BadField()
    for item in v:
        if isinstance(item, bool) or not isinstance(item, int):
            raise _BadField()
    return list(v)


_ABSENT = object()


def row_fields_from_obj(o: object) -> RowFields:
    """One raw partition dict's digest fields, in codecs-reader
    semantics (absent-vs-null brokers, bool-is-not-int, float
    coercion…). Raises :class:`_BadField` on any shape the reader
    would reject — shared by :func:`_json_state`'s full pass and the
    edge cache's incremental re-parse (serve/edge_cache.py), which
    must agree field for field or the incremental digest would
    drift."""
    if not isinstance(o, dict):
        raise _BadField()
    topic = o.get("topic", "")
    if not isinstance(topic, str):
        raise _BadField()
    partition = o.get("partition", 0)
    if isinstance(partition, bool) or not isinstance(partition, int):
        raise _BadField()
    replicas = _json_int_list(o.get("replicas"))
    w = o.get("weight", _ABSENT)
    if w is _ABSENT:
        weight = 0.0
    elif isinstance(w, bool) or not isinstance(w, (int, float)):
        raise _BadField()
    else:
        weight = float(w)
    nrep = o.get("num_replicas", 0)
    if isinstance(nrep, bool) or not isinstance(nrep, int):
        raise _BadField()
    b = o.get("brokers", _ABSENT)
    brokers = None if b is _ABSENT else _json_int_list(b)
    ncons = o.get("num_consumers", 0)
    if isinstance(ncons, bool) or not isinstance(ncons, int):
        raise _BadField()
    return (topic, partition, replicas, weight, nrep, brokers, ncons)


def _json_state(text: str) -> Optional[ClientState]:
    """The JSON-format canonicalizer, WITHOUT building Partition
    objects: one ``json.loads`` plus a single pass over the raw dicts,
    mirroring ``codecs.readers._partition_from_obj`` field for field
    (absent-vs-null brokers, bool-is-not-int, float coercion…) — the
    equivalence is pinned by tests/test_sessions.py against the real
    reader. At 10k rows this halves the client's digest cost, which is
    the dominant client-side term of the delta fast path. None
    wherever the reader would raise."""
    try:
        obj = json.loads(text)
    except ValueError:
        return None
    if not isinstance(obj, dict):
        return None
    version = obj.get("version", 0)
    if isinstance(version, bool) or not isinstance(version, int):
        return None
    if version != 1:
        return None
    raw = obj.get("partitions")
    if raw is None:
        return None  # empty partition list: reader raises
    if not isinstance(raw, list):
        return None
    rows: List[RowFields] = []
    canon: List[bytes] = []
    try:
        for o in raw:
            fields = row_fields_from_obj(o)
            rows.append(fields)
            canon.append(canonical_row_bytes(*fields))
    except _BadField:
        return None
    if not rows:
        return None  # reader: "empty partition list"
    return ClientState(
        digest=rows_digest(version, canon),
        canon=canon,
        rows=rows,
        version=version,
    )


def client_state(
    text: str, is_json: bool, topics: Optional[List[str]]
) -> Optional[ClientState]:
    """Canonicalize + digest the client's input. JSON takes the fast
    raw-dict path above (the reader ignores the topics filter for
    JSON, and so does it); the describe format goes through the shared
    codecs reader. None when the input does not parse or is otherwise
    unusual — the caller falls back to shipping the full state and the
    daemon surfaces any real input error through the ordinary planning
    path, byte-identical to ``-no-daemon``."""
    if is_json:
        return _json_state(text)
    from kafkabalancer_tpu_torch.codecs.readers import (
        CodecError,
        get_partition_list_from_reader,
    )

    try:
        pl = get_partition_list_from_reader(text, is_json, topics)
    except CodecError:
        return None
    except Exception:
        return None
    rows = []
    canon = []
    for p in pl.iter_partitions():
        fields = partition_fields(p)
        rows.append(fields)
        canon.append(canonical_row_bytes(*fields))
    return ClientState(
        digest=rows_digest(pl.version, canon),
        canon=canon,
        rows=rows,
        version=pl.version,
    )


# --- packed row records ----------------------------------------------------
#
# One record:
#   u32 row_index | u16 topic_len | topic utf-8 | i64 partition
#   | f64 weight | i32 num_replicas | i32 num_consumers
#   | u16 n_replicas | n x i64 replica broker IDs
#   | i32 n_brokers (-1 = None)   | n x i64 allowed broker IDs
#
# Raw struct-packed integers — the daemon reads the replica/broker runs
# straight into its resident rows with zero JSON escaping or per-field
# object decode.

_HEAD = struct.Struct(">IH")
_MID = struct.Struct(">qdiiH")
_NBROKERS = struct.Struct(">i")
_I64 = struct.Struct(">q")


def pack_rows(changed: Sequence[Tuple[int, RowFields]]) -> bytes:
    """Pack ``(row_index, fields)`` records into one resync payload."""
    parts: List[bytes] = []
    for idx, (topic, partition, replicas, weight, nrep, brokers, ncons) in (
        changed
    ):
        t = topic.encode("utf-8")
        parts.append(_HEAD.pack(idx, len(t)))
        parts.append(t)
        parts.append(_MID.pack(
            partition, float(weight), nrep, ncons, len(replicas)
        ))
        for r in replicas:
            parts.append(_I64.pack(r))
        if brokers is None:
            parts.append(_NBROKERS.pack(-1))
        else:
            parts.append(_NBROKERS.pack(len(brokers)))
            for b in brokers:
                parts.append(_I64.pack(b))
    return b"".join(parts)


def unpack_rows(blob: bytes) -> List[Tuple[int, RowFields]]:
    """Inverse of :func:`pack_rows`; raises ``ValueError`` on a
    malformed payload (truncation, absurd lengths)."""
    out: List[Tuple[int, RowFields]] = []
    off = 0
    n = len(blob)
    while off < n:
        if off + _HEAD.size > n:
            raise ValueError("truncated row record header")
        idx, tlen = _HEAD.unpack_from(blob, off)
        off += _HEAD.size
        if off + tlen + _MID.size > n:
            raise ValueError("truncated row record topic/body")
        topic = blob[off: off + tlen].decode("utf-8")
        off += tlen
        partition, weight, nrep, ncons, n_reps = _MID.unpack_from(blob, off)
        off += _MID.size
        if off + n_reps * _I64.size + _NBROKERS.size > n:
            raise ValueError("truncated replica run")
        replicas = [
            _I64.unpack_from(blob, off + i * _I64.size)[0]
            for i in range(n_reps)
        ]
        off += n_reps * _I64.size
        (n_brokers,) = _NBROKERS.unpack_from(blob, off)
        off += _NBROKERS.size
        brokers: Optional[List[int]]
        if n_brokers < 0:
            brokers = None
        else:
            if off + n_brokers * _I64.size > n:
                raise ValueError("truncated broker run")
            brokers = [
                _I64.unpack_from(blob, off + i * _I64.size)[0]
                for i in range(n_brokers)
            ]
            off += n_brokers * _I64.size
        out.append((
            idx, (topic, partition, replicas, weight, nrep, brokers, ncons)
        ))
    return out


def diff_rows(
    mine: Sequence[bytes], theirs: Sequence[bytes]
) -> Optional[List[int]]:
    """Row indices where ``mine`` (the client's hashes) differ from
    ``theirs`` (the daemon's table), or None when the shapes are
    incompatible (row count changed — structural drift takes the full
    re-sync path)."""
    if len(mine) != len(theirs):
        return None
    return [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]


# --- spill records (the warm session tier) ---------------------------------
#
# A spilled session is one self-contained, versioned, CHECKSUMMED file:
#
#   magic "KBSP" | u32 format version | u32 header_len | header JSON
#   | u64 blob_len | blob (pack_rows of every raw row, indexes 0..n-1)
#   | 32-byte sha256 over everything before it
#
# The header carries the session identity (tenant, flags signature), the
# predicted state digest, the list version, the row count, and the
# writer's platform fingerprint (byte order + package version). The
# correctness contract is the session invariant extended to disk: a
# record that is truncated, bit-flipped, format-version-skewed, or
# written by a foreign platform/package NEVER restores — it raises
# :class:`SpillCorrupt` (or fails the header gate) and the caller
# treats it as a clean cold miss. The digest gate in serve/sessions.py
# then guarantees a restored-but-stale record can still never produce
# a wrong plan: a non-matching digest degrades to a row/full resync.

SPILL_MAGIC = b"KBSP"
SPILL_FORMAT_VERSION = 1

_SPILL_HEAD = struct.Struct(">4sII")
_SPILL_BLOB_LEN = struct.Struct(">Q")
_SPILL_SUM_BYTES = 32
# a single record header has no business being megabytes
_SPILL_MAX_HEADER = 1 << 20


class SpillCorrupt(ValueError):
    """A spill record that must not restore: truncated, checksum
    mismatch, bad magic/format version, or malformed row payload."""


def spill_platform() -> str:
    """The writer fingerprint embedded in every record. The row codec
    packs explicit big-endian, so byte order is technically inert —
    but a record written by a different build is a clean cold miss BY
    POLICY (the restore path must never have to reason about foreign
    encodings), so the package version rides along too. This package's
    version carries ``+torch``: a record of the JAX package is a clean
    cold miss here, and the other way round."""
    import sys

    from kafkabalancer_tpu_torch import __version__

    return f"{sys.byteorder}:{__version__}"


def pack_spill_record(
    meta: Dict[str, object], rows: Sequence[RowFields]
) -> bytes:
    """One session's raw rows as a spill record. ``meta`` is the
    caller's header dict (identity + digest); the row count and
    platform fingerprint are stamped here so they cannot be forgotten."""
    hdr = dict(meta)
    hdr["rows"] = len(rows)
    hdr["platform"] = spill_platform()
    header = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
    blob = pack_rows(list(enumerate(rows)))
    body = b"".join((
        _SPILL_HEAD.pack(SPILL_MAGIC, SPILL_FORMAT_VERSION, len(header)),
        header,
        _SPILL_BLOB_LEN.pack(len(blob)),
        blob,
    ))
    return body + hashlib.sha256(body).digest()


def read_spill_header(buf: bytes) -> Dict[str, object]:
    """Just the header of a spill record (no checksum pass) — the
    warm-tier INDEX scan uses this to attribute records to tenants
    without reading whole payloads. Raises :class:`SpillCorrupt` on
    anything that is not a well-formed record head."""
    if len(buf) < _SPILL_HEAD.size:
        raise SpillCorrupt("truncated spill record head")
    magic, fmt, hlen = _SPILL_HEAD.unpack_from(buf, 0)
    if magic != SPILL_MAGIC:
        raise SpillCorrupt(f"bad spill magic {magic!r}")
    if fmt != SPILL_FORMAT_VERSION:
        raise SpillCorrupt(
            f"spill format version {fmt} (want {SPILL_FORMAT_VERSION})"
        )
    if hlen > _SPILL_MAX_HEADER:
        raise SpillCorrupt(f"spill header length {hlen} is absurd")
    if len(buf) < _SPILL_HEAD.size + hlen:
        raise SpillCorrupt("truncated spill header")
    try:
        hdr = json.loads(
            buf[_SPILL_HEAD.size: _SPILL_HEAD.size + hlen].decode("utf-8")
        )
    except ValueError as exc:
        raise SpillCorrupt(f"spill header is not JSON: {exc}") from None
    if not isinstance(hdr, dict):
        raise SpillCorrupt("spill header is not a JSON object")
    return hdr


def unpack_spill_record(
    buf: bytes,
) -> Tuple[Dict[str, object], List[RowFields]]:
    """The full validated read: header + rows, or :class:`SpillCorrupt`.
    The checksum is verified BEFORE any row decode — a bit-flipped
    payload is rejected wholesale, never partially trusted."""
    hdr = read_spill_header(buf)
    if len(buf) < _SPILL_SUM_BYTES:
        raise SpillCorrupt("truncated spill record (no checksum)")
    body, want = buf[:-_SPILL_SUM_BYTES], buf[-_SPILL_SUM_BYTES:]
    if hashlib.sha256(body).digest() != want:
        raise SpillCorrupt("spill checksum mismatch")
    if hdr.get("platform") != spill_platform():
        raise SpillCorrupt(
            f"foreign-platform spill record ({hdr.get('platform')!r} "
            f"vs {spill_platform()!r})"
        )
    _magic, _fmt, hlen = _SPILL_HEAD.unpack_from(buf, 0)
    off = _SPILL_HEAD.size + hlen
    if off + _SPILL_BLOB_LEN.size > len(body):
        raise SpillCorrupt("truncated spill record (no blob length)")
    (blen,) = _SPILL_BLOB_LEN.unpack_from(buf, off)
    off += _SPILL_BLOB_LEN.size
    if off + blen != len(body):
        raise SpillCorrupt(
            f"spill blob length {blen} disagrees with record size"
        )
    try:
        packed = unpack_rows(buf[off: off + blen])
    except ValueError as exc:
        raise SpillCorrupt(f"spill row payload: {exc}") from None
    n = hdr.get("rows")
    if not isinstance(n, int) or n != len(packed):
        raise SpillCorrupt(
            f"spill row count {len(packed)} != header {n!r}"
        )
    rows: List[Optional[RowFields]] = [None] * n
    for idx, fields in packed:
        if idx >= n or rows[idx] is not None:
            raise SpillCorrupt(f"spill row index {idx} out of order")
        rows[idx] = fields
    if any(r is None for r in rows):
        raise SpillCorrupt("spill row indexes are not contiguous")
    return hdr, rows  # type: ignore[return-value]


def diff_rows(
    mine: Sequence[bytes], theirs: Sequence[bytes]
) -> Optional[List[int]]:
    """Row indices where ``mine`` (the client's hashes) differ from
    ``theirs`` (the daemon's table), or None when the shapes are
    incompatible (row count changed — structural drift takes the full
    re-sync path)."""
    if len(mine) != len(theirs):
        return None
    return [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
