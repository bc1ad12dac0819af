"""Client-side edge residency: the shadow digest cache (protocol v2).

Once a speculative memo answers a request with no dispatch, the
daemon is no longer the hot path: every steady-state request still
re-reads, re-canonicalizes and re-digests the FULL cluster client-side
(O(P) at 10k rows). This module makes the
client resident too: a per-tenant cache entry persisted beside the
daemon socket remembers the last input's identity, canonical rows and
digest, so an outer-loop process tree shares it across invocations.

Three rungs, strongest first (cli.py walks them top to bottom):

1. **stat hit** — the input file's ``(st_dev, st_ino, st_mtime_ns,
   st_size)`` matches the entry and the entry is *stable* (written
   safely outside the file's mtime tick): the client skips
   read+canonicalize+digest entirely and goes straight to the
   ``plan-delta`` op with the cached digest. O(1).
2. **content hit** — the stat key is doubtful (*unstable* entry: the
   write landed within one mtime tick of the entry's own persist — a
   same-tick rewrite the stat key cannot see — or the stat key
   changed but the bytes may not have): the client reads the input and
   memcmp's it against the cached text. Equal ⇒ the cached digest is
   proven; an unstable entry re-verified after the tick closes is
   promoted to stable. O(P) read, zero parse.
3. **incremental splice** — the text changed: the entry's per-row
   character offsets let the client align the common prefix/suffix of
   old and new text to row boundaries and re-parse ONLY the middle
   region, splicing cached canonical rows around it. The digest is one
   sha256 pass over the spliced frames — O(changed) parse instead of
   O(P). Any structural surprise (header/footer drift, separator
   soup, a field the codecs reader would reject) degrades to the full
   parse.

The correctness contract mirrors the spill tier (serve/state.py KBSP):
an entry that is truncated, bit-flipped, format-skewed or written by a
foreign platform or package (the fingerprint carries this package's
``+torch`` version) NEVER resolves — every read is checksummed before
trust, and every degradation lands on the full read+parse path. The
cache can cost a re-read; it can never produce a wrong digest. Even a
hypothetically wrong digest could not produce a wrong plan: the
daemon's session digest gate (serve/sessions.py) degrades a mismatch
to a row or full resync, and the resync rows are re-derived from real
content.

The ``-from-zk`` fast path (:func:`probe_zk`) applies the same idea to
the watcher's seam (serve/speculate.py ``ZkWatcher``): the client
reads ``/brokers/topics`` itself
(FileZkClient or kazoo), keeps a per-topic payload-hash index in the
entry, and on a change re-decodes ONLY the changed topics, splicing
the synthesized version-1 JSON (codecs/writer.py byte-compatible
encoder) around the cached row spans. The synthesized text then rides
the ordinary session ladder — tenant ``zk:<conn>`` — so a steady
cluster costs one digest exchange instead of a daemon-side ZK walk.

Entry format (one file per tenant, ``<socket>.edge/<sha-24>.kbec``):

    magic "KBEC" | u32 format version | u32 header_len | header JSON
    | 32-byte sha256 over everything before it   (header checksum)
    | text utf-8 | row offsets (2 x u64 per row, character indices)
    | canonical frames (u32 len + bytes per row) | row-hash table
    | 32-byte sha256 over everything before it   (full checksum)

The doubled checksum is what makes rung 1 cheap: a stat hit reads and
verifies ONLY the head (~4 KB) — digest, row count and version live in
the header — while anything that needs the body (resync, splice,
register) verifies the full trailer first.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from kafkabalancer_tpu_torch.serve import state as sstate

EC_MAGIC = b"KBEC"
EC_FORMAT_VERSION = 1

_EC_HEAD = struct.Struct(">4sII")
_EC_OFF = struct.Struct(">QQ")
_EC_SUM_BYTES = 32
_EC_MAX_HEADER = 1 << 20
# how much of the entry head to read for a stat probe before deciding
# whether the header needs more bytes
_EC_PROBE_BYTES = 4096

# A persist that lands within this window of the input's mtime cannot
# rule out a later same-tick rewrite (coarse filesystem timestamps,
# in-place writers): the entry is marked unstable and rung 1 degrades
# to a content memcmp until a later probe re-proves it after the tick
# closed.
UNSTABLE_WINDOW_NS = 2_000_000_000

_WS = " \t\n\r"


class EdgeCacheError(Exception):
    """A lazy body load that could not be satisfied from the entry OR
    from re-reading the input source — the caller degrades to the
    non-cached path."""


class _Corrupt(ValueError):
    """An entry that must not resolve (internal)."""


def cache_dir(sock: str) -> str:
    """The per-daemon cache directory, beside the socket like the
    spill directory — same lifecycle, same tenancy."""
    return sock + ".edge"


def entry_path(sock: str, tenant: str) -> str:
    name = hashlib.sha256(tenant.encode("utf-8")).hexdigest()[:24]
    return os.path.join(cache_dir(sock), name + ".kbec")


def _now_ns() -> int:
    return time.time_ns()


# --- entry codec -----------------------------------------------------------


class _Entry:
    """One loaded cache entry. The header is always present and
    checksum-verified; the body (text / offsets / canon / hashes) is
    loaded lazily and verified against the full-file trailer before
    first use."""

    __slots__ = (
        "path", "header", "text", "offsets", "canon", "hashes",
        "_body_loaded",
    )

    def __init__(self, path: str, header: Dict[str, object]) -> None:
        self.path = path
        self.header = header
        self.text: Optional[str] = None
        self.offsets: Optional[List[Tuple[int, int]]] = None
        self.canon: Optional[List[bytes]] = None
        self.hashes: Optional[List[bytes]] = None
        self._body_loaded = False

    # typed header accessors (validated in _check_header)
    @property
    def digest(self) -> str:
        return self.header["digest"]  # type: ignore[return-value]

    @property
    def version(self) -> int:
        return self.header["version"]  # type: ignore[return-value]

    @property
    def nrows(self) -> int:
        return self.header["rows"]  # type: ignore[return-value]

    def stat_key(self) -> Tuple[int, int, int, int]:
        h = self.header
        return (
            h.get("dev", 0), h.get("ino", 0),
            h.get("mtime_ns", 0), h.get("size", 0),
        )  # type: ignore[return-value]

    def load_body(self) -> None:
        if self._body_loaded:
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        text, offsets, canon, hashes = _unpack_body(buf, self.header)
        self.text = text
        self.offsets = offsets
        self.canon = canon
        self.hashes = hashes
        self._body_loaded = True


def _check_header(hdr: object) -> Dict[str, object]:
    if not isinstance(hdr, dict):
        raise _Corrupt("entry header is not a JSON object")
    if hdr.get("platform") != sstate.spill_platform():
        raise _Corrupt("foreign-platform entry")
    digest = hdr.get("digest")
    if not isinstance(digest, str) or len(digest) != 64:
        raise _Corrupt("entry header digest is malformed")
    for key in ("version", "rows", "text_len", "offsets_len",
                "canon_len", "hashes_len"):
        v = hdr.get(key)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise _Corrupt(f"entry header {key} is malformed")
    n = hdr["rows"]
    if hdr["hashes_len"] != n * sstate.ROW_HASH_BYTES:
        raise _Corrupt("entry hash table length disagrees with row count")
    if hdr["offsets_len"] not in (0, n * _EC_OFF.size):
        raise _Corrupt("entry offsets length disagrees with row count")
    return hdr


def _parse_head(buf: bytes) -> Tuple[Dict[str, object], int]:
    """Validate the entry head from an initial read; returns
    (header, body_offset). Raises :class:`_Corrupt` if ``buf`` is not
    a well-formed, checksummed head (callers re-read with more bytes
    when ``buf`` was merely too short — that surfaces as truncation
    here, so they check the needed length first)."""
    if len(buf) < _EC_HEAD.size:
        raise _Corrupt("truncated entry head")
    magic, fmt, hlen = _EC_HEAD.unpack_from(buf, 0)
    if magic != EC_MAGIC:
        raise _Corrupt(f"bad entry magic {magic!r}")
    if fmt != EC_FORMAT_VERSION:
        raise _Corrupt(f"entry format version {fmt}")
    if hlen > _EC_MAX_HEADER:
        raise _Corrupt(f"entry header length {hlen} is absurd")
    need = _EC_HEAD.size + hlen + _EC_SUM_BYTES
    if len(buf) < need:
        raise _Corrupt("truncated entry header")
    body = buf[:_EC_HEAD.size + hlen]
    want = buf[_EC_HEAD.size + hlen: need]
    if hashlib.sha256(body).digest() != want:
        raise _Corrupt("entry header checksum mismatch")
    try:
        hdr = json.loads(buf[_EC_HEAD.size: _EC_HEAD.size + hlen])
    except ValueError as exc:
        raise _Corrupt(f"entry header is not JSON: {exc}") from None
    return _check_header(hdr), need


def _header_need(buf: bytes) -> int:
    """How many bytes a complete head needs, from a partial read."""
    if len(buf) < _EC_HEAD.size:
        raise _Corrupt("truncated entry head")
    magic, fmt, hlen = _EC_HEAD.unpack_from(buf, 0)
    if magic != EC_MAGIC or fmt != EC_FORMAT_VERSION:
        raise _Corrupt("bad entry head")
    if hlen > _EC_MAX_HEADER:
        raise _Corrupt("entry header length is absurd")
    return _EC_HEAD.size + hlen + _EC_SUM_BYTES


def _unpack_body(
    buf: bytes, header: Dict[str, object]
) -> Tuple[str, Optional[List[Tuple[int, int]]], List[bytes], List[bytes]]:
    """Full-file verification + section slicing. The trailer checksum
    is verified BEFORE any decode — a bit-flipped body is rejected
    wholesale, never partially trusted."""
    hdr2, off = _parse_head(buf)
    if hdr2 != header:
        raise _Corrupt("entry header changed between probe and body load")
    if len(buf) < off + _EC_SUM_BYTES:
        raise _Corrupt("truncated entry (no trailer)")
    body, want = buf[:-_EC_SUM_BYTES], buf[-_EC_SUM_BYTES:]
    if hashlib.sha256(body).digest() != want:
        raise _Corrupt("entry checksum mismatch")
    tl = header["text_len"]
    ol = header["offsets_len"]
    cl = header["canon_len"]
    hl = header["hashes_len"]
    if off + tl + ol + cl + hl != len(body):  # type: ignore[operator]
        raise _Corrupt("entry section lengths disagree with record size")
    try:
        text = buf[off: off + tl].decode("utf-8")  # type: ignore[misc]
    except UnicodeDecodeError as exc:
        raise _Corrupt(f"entry text is not utf-8: {exc}") from None
    p = off + tl  # type: ignore[operator]
    offsets: Optional[List[Tuple[int, int]]] = None
    if ol:
        offsets = [
            _EC_OFF.unpack_from(buf, p + i * _EC_OFF.size)
            for i in range(ol // _EC_OFF.size)  # type: ignore[operator]
        ]
    p += ol  # type: ignore[operator]
    canon: List[bytes] = []
    end = p + cl  # type: ignore[operator]
    n = header["rows"]
    while p < end:
        if p + 4 > end:
            raise _Corrupt("truncated canonical frame header")
        flen = int.from_bytes(buf[p: p + 4], "big")
        p += 4
        if p + flen > end:
            raise _Corrupt("truncated canonical frame")
        canon.append(buf[p: p + flen])
        p += flen
    if len(canon) != n:
        raise _Corrupt("canonical frame count disagrees with row count")
    hashes = [
        buf[end + i * sstate.ROW_HASH_BYTES:
            end + (i + 1) * sstate.ROW_HASH_BYTES]
        for i in range(n)  # type: ignore[arg-type]
    ]
    if offsets is not None:
        tlen = len(text)
        last = 0
        for (s, e) in offsets:
            if not (last <= s < e <= tlen):
                raise _Corrupt("entry row offsets are not monotonic")
            last = e
    return text, offsets, canon, hashes


def _pack_entry(
    header: Dict[str, object],
    text: str,
    offsets: Optional[Sequence[Tuple[int, int]]],
    canon: Sequence[bytes],
    hashes: Sequence[bytes],
) -> bytes:
    tb = text.encode("utf-8")
    ob = (
        b"".join(_EC_OFF.pack(s, e) for (s, e) in offsets)
        if offsets else b""
    )
    cb = b"".join(len(c).to_bytes(4, "big") + c for c in canon)
    hb = b"".join(hashes)
    hdr = dict(header)
    hdr["rows"] = len(canon)
    hdr["platform"] = sstate.spill_platform()
    hdr["text_len"] = len(tb)
    hdr["offsets_len"] = len(ob)
    hdr["canon_len"] = len(cb)
    hdr["hashes_len"] = len(hb)
    hj = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
    head = _EC_HEAD.pack(EC_MAGIC, EC_FORMAT_VERSION, len(hj))
    body = b"".join((
        head, hj, hashlib.sha256(head + hj).digest(), tb, ob, cb, hb,
    ))
    return body + hashlib.sha256(body).digest()


# --- in-memory layer -------------------------------------------------------
#
# In-process outer loops (tests, a driver that embeds the CLI) call
# cli.run repeatedly in one process; re-reading and re-verifying the
# entry file every step would dominate the stat-hit budget. The memory
# layer caches parsed entries keyed by entry path, validated against
# the entry FILE's own stat on every probe so a cross-process update
# is always observed.

_mem_lock = threading.Lock()
_mem: Dict[str, Tuple[Tuple[int, int, int], _Entry]] = {}


def _entry_file_key(path: str) -> Optional[Tuple[int, int, int]]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_mtime_ns, st.st_size)


def _load_entry(path: str) -> Optional[_Entry]:
    """Header-verified entry at ``path`` (memory layer first), or None
    when absent/corrupt — corruption is silently a miss."""
    fkey = _entry_file_key(path)
    if fkey is None:
        return None
    with _mem_lock:
        hit = _mem.get(path)
        if hit is not None and hit[0] == fkey:
            return hit[1]
    try:
        with open(path, "rb") as f:
            buf = f.read(_EC_PROBE_BYTES)
            try:
                need = _header_need(buf)
            except _Corrupt:
                return None
            if need > len(buf):
                buf += f.read(need - len(buf))
        header, _off = _parse_head(buf)
    except (OSError, _Corrupt):
        return None
    entry = _Entry(path, header)
    with _mem_lock:
        _mem[path] = (fkey, entry)
    return entry


def _store_entry(
    sock: str,
    tenant: str,
    header: Dict[str, object],
    text: str,
    offsets: Optional[Sequence[Tuple[int, int]]],
    canon: Sequence[bytes],
    hashes: Sequence[bytes],
) -> None:
    """Atomic tmp+rename persist; failures are silent (the cache is an
    optimization, never a correctness dependency)."""
    path = entry_path(sock, tenant)
    try:
        d = cache_dir(sock)
        os.makedirs(d, mode=0o700, exist_ok=True)
        blob = _pack_entry(header, text, offsets, canon, hashes)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except OSError:
        return
    # re-parse our own blob's header for the memory layer (cheap, and
    # guarantees the cached object matches what a fresh load would see)
    fkey = _entry_file_key(path)
    if fkey is None:
        return
    try:
        header2, _off = _parse_head(blob)
    except _Corrupt:
        return
    entry = _Entry(path, header2)
    entry.text = text
    entry.offsets = list(offsets) if offsets is not None else None
    entry.canon = list(canon)
    entry.hashes = list(hashes)
    entry._body_loaded = True
    with _mem_lock:
        _mem[path] = (fkey, entry)


def reset_memory_layer() -> None:
    """Test hook: drop the in-process layer (disk entries survive)."""
    with _mem_lock:
        _mem.clear()


# --- lazy client-state view ------------------------------------------------


class _LazyRows:
    """``state.rows`` for a cached state: row ``i`` parses on demand
    from the text via its character offsets (JSON entries), with a
    one-shot full-parse fallback for describe-format entries."""

    def __init__(self, owner: "CachedState") -> None:
        self._owner = owner
        self._cache: Dict[int, sstate.RowFields] = {}
        self._full: Optional[List[sstate.RowFields]] = None

    def seed(self, idx: int, fields: sstate.RowFields) -> None:
        self._cache[idx] = fields

    def __len__(self) -> int:
        return self._owner.nrows

    def __getitem__(self, idx: int) -> sstate.RowFields:
        got = self._cache.get(idx)
        if got is not None:
            return got
        if self._full is not None:
            return self._full[idx]
        owner = self._owner
        offsets = owner._offsets()
        if offsets is not None:
            text = owner.load_text()
            s, e = offsets[idx]
            try:
                fields = sstate.row_fields_from_obj(json.loads(text[s:e]))
            except (ValueError, sstate._BadField) as exc:
                raise EdgeCacheError(f"cached row {idx}: {exc}") from None
            self._cache[idx] = fields
            return fields
        full = sstate.client_state(
            owner.load_text(), owner.is_json, owner.topics
        )
        if full is None or full.digest != owner.digest:
            raise EdgeCacheError("cached text no longer parses to digest")
        self._full = full.rows
        return full.rows[idx]


class CachedState:
    """Duck-type of :class:`serve.state.ClientState` whose expensive
    members load lazily. A pure stat hit materializes ONLY the digest,
    version and row count (from the checksummed entry header); canon,
    rows, row hashes and text load on first touch — which only the
    rare resync/register paths ever do. Every lazy load falls back to
    re-reading the input source itself before giving up with
    :class:`EdgeCacheError`."""

    __slots__ = (
        "digest", "version", "nrows", "is_json", "topics", "_entry",
        "_path", "_text", "_canon", "_hashes", "_offs", "rows",
    )

    def __init__(
        self,
        digest: str,
        version: int,
        nrows: int,
        is_json: bool,
        topics: Optional[List[str]],
        entry: Optional[_Entry] = None,
        path: str = "",
        text: Optional[str] = None,
        canon: Optional[List[bytes]] = None,
        hashes: Optional[List[bytes]] = None,
        offsets: Optional[List[Tuple[int, int]]] = None,
    ) -> None:
        self.digest = digest
        self.version = version
        self.nrows = nrows
        self.is_json = is_json
        self.topics = topics
        self._entry = entry
        self._path = path
        self._text = text
        self._canon = canon
        self._hashes = hashes
        self._offs = offsets
        self.rows = _LazyRows(self)

    def _load_entry_body(self) -> Optional[_Entry]:
        e = self._entry
        if e is None:
            return None
        try:
            e.load_body()
        except (OSError, _Corrupt):
            return None
        return e

    def _full_reparse(self) -> None:
        """Last resort: the entry body is gone/corrupt — re-read the
        input file and recompute. Content is re-derived from the real
        source, so a corrupt cache can cost a read but never a wrong
        row."""
        if self._path == "":
            raise EdgeCacheError("entry body unavailable and no source path")
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError) as exc:
            raise EdgeCacheError(f"re-read failed: {exc}") from None
        full = sstate.client_state(text, self.is_json, self.topics)
        if full is None:
            raise EdgeCacheError("re-read input no longer parses")
        self._text = text
        self._canon = full.canon
        self._hashes = None
        self._offs = None
        self.rows._full = full.rows
        # NOTE: if the file changed since the stat probe, this digest
        # may differ from the one already sent; the daemon's digest
        # gate turns that into a resync against these (real) rows.
        self.digest = full.digest
        self.version = full.version
        self.nrows = len(full.canon)

    def load_text(self) -> str:
        if self._text is not None:
            return self._text
        e = self._load_entry_body()
        if e is not None and e.text is not None:
            self._text = e.text
            return e.text
        self._full_reparse()
        assert self._text is not None
        return self._text

    def _offsets(self) -> Optional[List[Tuple[int, int]]]:
        if self._offs is not None:
            return self._offs
        e = self._load_entry_body()
        if e is not None:
            self._offs = e.offsets
            return e.offsets
        return None

    @property
    def canon(self) -> List[bytes]:
        if self._canon is not None:
            return self._canon
        e = self._load_entry_body()
        if e is not None and e.canon is not None:
            self._canon = e.canon
            return e.canon
        self._full_reparse()
        assert self._canon is not None
        return self._canon

    @property
    def row_hashes(self) -> List[bytes]:
        if self._hashes is not None:
            return self._hashes
        e = self._load_entry_body()
        if e is not None and e.hashes is not None:
            self._hashes = e.hashes
            return e.hashes
        self._hashes = sstate.hashes_of(self.canon)
        return self._hashes


# --- row-offset construction (JSON inputs) ---------------------------------


def build_offsets(
    text: str, canon: Sequence[bytes]
) -> Optional[List[Tuple[int, int]]]:
    """Character offsets of every partition object in ``text``,
    verified row-for-row against the authoritative ``canon`` (the full
    parse's output). None on ANY structural doubt — an entry without
    offsets still serves stat/content hits, it just cannot splice."""
    if not canon:
        return None
    if text.count('"partitions"') != 1:
        return None
    dec = json.JSONDecoder()
    p = text.find('"partitions"') + len('"partitions"')
    n = len(text)
    try:
        while p < n and text[p] in _WS:
            p += 1
        if p >= n or text[p] != ":":
            return None
        p += 1
        while p < n and text[p] in _WS:
            p += 1
        if p >= n or text[p] != "[":
            return None
        p += 1
        offsets: List[Tuple[int, int]] = []
        need_obj = True  # '[' just opened: object or ']' next
        while True:
            while p < n and text[p] in _WS:
                p += 1
            if p >= n:
                return None
            c = text[p]
            if c == "]":
                if offsets and need_obj:
                    return None  # trailing comma
                break
            if c == ",":
                if need_obj:
                    return None
                need_obj = True
                p += 1
                continue
            if not need_obj:
                return None
            i = len(offsets)
            if i >= len(canon):
                return None
            obj, end = dec.raw_decode(text, p)
            fields = sstate.row_fields_from_obj(obj)
            if sstate.canonical_row_bytes(*fields) != canon[i]:
                return None
            offsets.append((p, end))
            p = end
            need_obj = False
    except (ValueError, sstate._BadField):
        return None
    if len(offsets) != len(canon):
        return None
    return offsets


# --- incremental splice ----------------------------------------------------


def _common_prefix(a: str, b: str) -> int:
    n = min(len(a), len(b))
    p = 0
    step = 1 << 16
    while p < n:
        q = min(p + step, n)
        if a[p:q] == b[p:q]:
            p = q
            continue
        lo, hi = p, q
        while lo < hi:
            mid = (lo + hi) // 2
            if a[p:mid + 1] == b[p:mid + 1]:
                lo = mid + 1
            else:
                hi = mid
        return lo
    return n


def _common_suffix(a: str, b: str, limit: int) -> int:
    n = min(len(a), len(b), limit)
    s = 0
    step = 1 << 16
    while s < n:
        q = min(s + step, n)
        if a[len(a) - q:len(a) - s or None] == b[len(b) - q:len(b) - s or None]:
            s = q
            continue
        lo, hi = s, q
        while lo < hi:
            mid = (lo + hi) // 2
            if a[len(a) - mid - 1:len(a) - s or None] == (
                b[len(b) - mid - 1:len(b) - s or None]
            ):
                lo = mid + 1
            else:
                hi = mid
        return lo
    return n


def _scan_middle(
    text: str, m0: int, m1: int, items_before: bool, items_after: bool
) -> Optional[Tuple[List[object], List[Tuple[int, int]]]]:
    """Strictly validate the changed region of the new text as a
    partial partitions-array body: objects and separating commas only,
    comma placement consistent with the surrounding unchanged rows.
    None on any doubt — the caller degrades to the full parse."""
    dec = json.JSONDecoder()
    p = m0
    objs: List[object] = []
    offs: List[Tuple[int, int]] = []
    have_prev = items_before
    need_obj = False  # a comma was consumed and awaits its object
    while True:
        while p < m1 and text[p] in _WS:
            p += 1
        if p >= m1:
            break
        c = text[p]
        if c == ",":
            if not have_prev or need_obj:
                return None
            need_obj = True
            p += 1
            continue
        if have_prev and not need_obj:
            return None
        try:
            obj, end = dec.raw_decode(text, p)
        except ValueError:
            return None
        if end > m1:
            return None
        objs.append(obj)
        offs.append((p, end))
        p = end
        have_prev = True
        need_obj = False
    if items_after:
        if not need_obj:
            return None
    else:
        if need_obj:
            return None
    return objs, offs


def splice_state(
    entry: _Entry,
    new_text: str,
    is_json: bool,
    topics: Optional[List[str]],
    path: str,
) -> Optional[CachedState]:
    """The O(changed) rung: align old and new text on the common
    prefix/suffix, re-parse only the middle, splice cached canonical
    rows around it. None whenever ANY invariant is in doubt; the
    result's digest is then provably what the full parse would
    compute, because byte-identical prefix/suffix rows parse
    identically and the middle went through the very same
    ``row_fields_from_obj`` the full pass uses."""
    try:
        entry.load_body()
    except (OSError, _Corrupt):
        return None
    old = entry.text
    offsets = entry.offsets
    old_canon = entry.canon
    old_hashes = entry.hashes
    if old is None or offsets is None or old_canon is None or (
        old_hashes is None
    ):
        return None
    n = len(offsets)
    if n == 0:
        return None
    pre = _common_prefix(old, new_text)
    suf = _common_suffix(old, new_text, min(len(old), len(new_text)) - pre)
    # header (everything before row 0) must sit inside the common
    # prefix, footer (everything after the last row) inside the common
    # suffix: then the new document's top-level structure is
    # byte-identical and only array members changed.
    if offsets[0][0] > pre:
        return None
    if len(old) - offsets[-1][1] > suf:
        return None
    delta = len(new_text) - len(old)
    # rows fully inside the prefix / suffix
    ends = [e for (_s, e) in offsets]
    starts = [s for (s, _e) in offsets]
    i0 = bisect.bisect_right(ends, pre)
    j0 = bisect.bisect_left(starts, len(old) - suf)
    if j0 < i0:
        return None
    m0 = offsets[i0 - 1][1] if i0 > 0 else offsets[0][0]
    m1 = (offsets[j0][0] + delta) if j0 < n else (offsets[n - 1][1] + delta)
    if m1 < m0:
        return None
    scanned = _scan_middle(new_text, m0, m1, i0 > 0, j0 < n)
    if scanned is None:
        return None
    objs, mid_offs = scanned
    try:
        mid_fields = [sstate.row_fields_from_obj(o) for o in objs]
    except sstate._BadField:
        return None
    mid_canon = [sstate.canonical_row_bytes(*f) for f in mid_fields]
    new_canon = old_canon[:i0] + mid_canon + old_canon[j0:]
    if not new_canon:
        return None  # the reader rejects an empty partition list
    new_offsets = (
        offsets[:i0]
        + mid_offs
        + [(s + delta, e + delta) for (s, e) in offsets[j0:]]
    )
    new_hashes = (
        old_hashes[:i0]
        + [sstate.row_hash(c) for c in mid_canon]
        + old_hashes[j0:]
    )
    version = entry.version
    state = CachedState(
        digest=sstate.rows_digest(version, new_canon),
        version=version,
        nrows=len(new_canon),
        is_json=is_json,
        topics=topics,
        entry=None,
        path=path,
        text=new_text,
        canon=new_canon,
        hashes=new_hashes,
        offsets=new_offsets,
    )
    for k, f in enumerate(mid_fields):
        state.rows.seed(i0 + k, f)
    return state


# --- file probe / resolve / persist ----------------------------------------


class FileProbe:
    """The result of rung-1 classification for one input file."""

    __slots__ = (
        "sock", "tenant", "path", "is_json", "topics", "stat",
        "entry", "state", "hit", "needs_text", "note",
    )

    def __init__(
        self, sock: str, tenant: str, path: str,
        is_json: bool, topics: Optional[List[str]],
    ) -> None:
        self.sock = sock
        self.tenant = tenant
        self.path = path
        self.is_json = is_json
        self.topics = topics
        self.stat: Optional[Tuple[int, int, int, int]] = None
        self.entry: Optional[_Entry] = None
        self.state: Optional[CachedState] = None
        self.hit = False
        self.needs_text = True
        self.note = "miss"


def _stat_key(path: str) -> Optional[Tuple[int, int, int, int]]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_dev, st.st_ino, st.st_mtime_ns, st.st_size)


def _entry_matches(
    entry: _Entry, tenant: str, is_json: bool, topics: Optional[List[str]]
) -> bool:
    h = entry.header
    return (
        h.get("tenant") == tenant
        and h.get("is_json") == is_json
        and h.get("topics") == (topics or [])
        and "zk" not in h
    )


def probe_file(
    sock: str,
    tenant: str,
    path: str,
    is_json: bool,
    topics: Optional[List[str]],
) -> FileProbe:
    """Rung 1: stat the input, load the entry header, classify.

    ``probe.needs_text == False`` means a proven stat hit: the caller
    may skip the input read entirely and use ``probe.state``.
    Otherwise the caller reads the text and calls
    :func:`resolve_text`."""
    probe = FileProbe(sock, tenant, path, is_json, topics)
    try:
        probe.stat = _stat_key(path)
        entry = _load_entry(entry_path(sock, tenant))
        if entry is not None and not _entry_matches(
            entry, tenant, is_json, topics
        ):
            entry = None
        probe.entry = entry
        if probe.stat is None or entry is None:
            return probe
        if entry.stat_key() != probe.stat:
            probe.note = "stat_changed"
            return probe
        state = CachedState(
            digest=entry.digest,
            version=entry.version,
            nrows=entry.nrows,
            is_json=is_json,
            topics=topics,
            entry=entry,
            path=path,
        )
        if entry.header.get("unstable"):
            # same-tick persist: the stat key cannot prove content
            # identity — verify by memcmp (rung 2)
            probe.state = state
            probe.note = "unstable"
            return probe
        probe.state = state
        probe.hit = True
        probe.needs_text = False
        probe.note = "stat_hit"
        return probe
    except Exception:
        return FileProbe(sock, tenant, path, is_json, topics)


def resolve_text(
    probe: FileProbe, text: str
) -> Tuple[Optional[CachedState], bool]:
    """Rungs 2 and 3, with the text in hand: content memcmp against
    the cached text (proves the cached digest; promotes a stable
    entry), else the incremental splice. ``(None, False)`` sends the
    caller to the full parse."""
    entry = probe.entry
    if entry is None:
        return None, False
    try:
        try:
            entry.load_body()
        except (OSError, _Corrupt):
            return None, False
        if entry.text == text:
            state = probe.state or CachedState(
                digest=entry.digest,
                version=entry.version,
                nrows=entry.nrows,
                is_json=probe.is_json,
                topics=probe.topics,
                entry=entry,
                path=probe.path,
            )
            state._text = text
            if probe.stat is not None and (
                entry.stat_key() != probe.stat
                or entry.header.get("unstable")
            ):
                # same bytes under a new/unproven stat key: re-persist
                # so the next probe can stat-hit
                persist_state(
                    probe.sock, probe.tenant, probe.path,
                    probe.is_json, probe.topics, text, state,
                    pre_stat=probe.stat,
                )
            return state, True
        if not probe.is_json:
            return None, False
        state = splice_state(
            entry, text, probe.is_json, probe.topics, probe.path
        )
        if state is None:
            return None, False
        persist_state(
            probe.sock, probe.tenant, probe.path, probe.is_json,
            probe.topics, text, state, pre_stat=probe.stat,
        )
        return state, False
    except Exception:
        return None, False


def persist_state(
    sock: str,
    tenant: str,
    path: str,
    is_json: bool,
    topics: Optional[List[str]],
    text: str,
    state: object,
    pre_stat: Optional[Tuple[int, int, int, int]],
) -> None:
    """Persist a computed state for the NEXT invocation. The stat key
    is re-taken now and the entry only lands if it matches the probe's
    (the text provably belongs to one stable stat point); a persist
    within the mtime tick is marked unstable so rung 1 keeps
    re-verifying content until the tick closes."""
    try:
        st = _stat_key(path)
        # pre_stat is REQUIRED: the caller stats before reading the
        # text, and the entry only lands when the file provably sat
        # still across the read — otherwise a rewrite between read and
        # persist would key someone else's bytes to the new stat point
        # and the next probe would serve a wrong digest.
        if st is None or pre_stat is None or st != pre_stat:
            return
        canon = list(state.canon)  # type: ignore[attr-defined]
        version = int(state.version)  # type: ignore[attr-defined]
        digest = state.digest  # type: ignore[attr-defined]
        hashes = getattr(state, "row_hashes", None)
        if hashes is None:
            hashes = sstate.hashes_of(canon)
        else:
            hashes = list(hashes)
        offsets = None
        if is_json:
            offsets = getattr(state, "_offs", None)
            if offsets is None:
                # a content-hit promotion re-persists the SAME text the
                # entry already indexed — reuse its offsets instead of
                # paying the O(P) raw_decode walk again (guarded by
                # byte equality, the same proof the hit itself used)
                ent = getattr(state, "_entry", None)
                if ent is not None:
                    try:
                        ent.load_body()
                        if ent.text == text:
                            offsets = ent.offsets
                    except (OSError, _Corrupt):
                        offsets = None
            if offsets is None:
                offsets = build_offsets(text, canon)
        unstable = (_now_ns() - st[2]) <= UNSTABLE_WINDOW_NS
        header: Dict[str, object] = {
            "tenant": tenant,
            "path": path,
            "dev": st[0],
            "ino": st[1],
            "mtime_ns": st[2],
            "size": st[3],
            "is_json": is_json,
            "topics": topics or [],
            "digest": digest,
            "version": version,
            "unstable": bool(unstable),
        }
        _store_entry(sock, tenant, header, text, offsets, canon, hashes)
    except Exception:
        return


# --- the -from-zk fast path ------------------------------------------------


class ZkResult:
    """A successful client-side ZK read: the synthesized version-1
    JSON text (byte-identical to ``encode_partition_list`` over
    ``read_cluster``'s rows), its state, and whether the per-topic
    payload index proved the whole cluster unchanged."""

    __slots__ = ("state", "hit", "changed_topics")

    def __init__(
        self, state: CachedState, hit: bool, changed_topics: int
    ) -> None:
        self.state = state
        self.hit = hit
        self.changed_topics = changed_topics


_ZK_TEXT_HEAD = '{"version":1,"partitions":['
_ZK_TEXT_TAIL = ']}\n'


def _zk_rows_for_topic(
    topic: str, data: bytes
) -> Tuple[List[str], List[sstate.RowFields]]:
    """Decode one topic payload into per-row JSON texts + fields,
    byte-compatible with ``codecs.writer._encode_partition`` over
    ``decode_topic_state``'s partitions."""
    from kafkabalancer_tpu_torch.codecs import writer as _writer
    from kafkabalancer_tpu_torch.codecs.zookeeper import decode_topic_state

    parts = decode_topic_state(topic, data)
    texts = [_writer._encode_partition(p) for p in parts]
    fields = [sstate.partition_fields(p) for p in parts]
    return texts, fields


def probe_zk(
    sock: str, conn: str, topics: Optional[List[str]]
) -> Optional[ZkResult]:
    """Client-side ``-from-zk`` read through the watcher seam
    (FileZkClient / kazoo / installed factory), with per-topic
    payload-hash change detection: an unchanged cluster resolves to
    the cached digest without decoding a single topic; a changed one
    re-decodes ONLY the changed topics and splices text/canon around
    the cached row spans. None on ANY doubt (connect failure, decode
    error, topic-set drift with an unusable cache…) — the caller
    degrades to forwarding ``-from-zk`` for the daemon to read,
    byte-identical behaviour."""
    from kafkabalancer_tpu_torch.codecs.zookeeper import make_zk_client

    tenant = f"zk:{conn}"
    try:
        zk = make_zk_client(conn)
    except Exception:
        return None
    payloads: List[Tuple[str, bytes]] = []
    try:
        names = sorted(zk.get_children("/brokers/topics"))
        for t in names:
            if topics and t not in topics:
                continue
            data, _st = zk.get(f"/brokers/topics/{t}")
            payloads.append((t, data))
    except Exception:
        return None
    finally:
        try:
            zk.stop()
            zk.close()
        except Exception:
            pass
    try:
        return _resolve_zk(sock, conn, tenant, topics, payloads)
    except Exception:
        return None


def _zk_entry_index(entry: _Entry) -> Optional[List[Tuple[str, str, int, int]]]:
    zki = entry.header.get("zk")
    if not isinstance(zki, dict) or not isinstance(zki.get("topics"), list):
        return None
    out: List[Tuple[str, str, int, int]] = []
    for item in zki["topics"]:  # type: ignore[index]
        if not (isinstance(item, list) and len(item) == 4):
            return None
        t, sha, r0, r1 = item
        if not (isinstance(t, str) and isinstance(sha, str)
                and isinstance(r0, int) and isinstance(r1, int)):
            return None
        out.append((t, sha, r0, r1))
    return out


def _resolve_zk(
    sock: str,
    conn: str,
    tenant: str,
    topics: Optional[List[str]],
    payloads: List[Tuple[str, bytes]],
) -> Optional[ZkResult]:
    cur = [
        (t, hashlib.sha256(data).hexdigest()) for (t, data) in payloads
    ]
    entry = _load_entry(entry_path(sock, tenant))
    index = None
    if entry is not None:
        h = entry.header
        if (
            h.get("tenant") == tenant
            and h.get("topics") == (topics or [])
            and h.get("is_json") is True
        ):
            index = _zk_entry_index(entry)
        if index is None:
            entry = None

    if entry is not None and index is not None and (
        [(t, sha) for (t, sha, _r0, _r1) in index] == cur
    ):
        # whole cluster unchanged: digest from the verified header,
        # body stays lazy
        state = CachedState(
            digest=entry.digest,
            version=entry.version,
            nrows=entry.nrows,
            is_json=True,
            topics=topics,
            entry=entry,
        )
        return ZkResult(state, hit=True, changed_topics=0)

    reuse: Dict[str, Tuple[str, int, int]] = {}
    if entry is not None and index is not None and (
        [t for (t, _sha, _r0, _r1) in index] == [t for (t, _sha) in cur]
    ):
        try:
            entry.load_body()
        except (OSError, _Corrupt):
            entry = None
        if entry is not None and entry.text is not None and (
            entry.offsets is not None and entry.canon is not None
            and entry.hashes is not None
        ):
            for (t, sha, r0, r1) in index:
                reuse[t] = (sha, r0, r1)

    row_texts: List[str] = []
    canon: List[bytes] = []
    hashes: List[bytes] = []
    fields_seed: List[Tuple[int, sstate.RowFields]] = []
    zk_index: List[List[object]] = []
    changed = 0
    for (t, sha) in cur:
        r0 = len(canon)
        hit = reuse.get(t)
        if hit is not None and hit[0] == sha:
            _sha, o0, o1 = hit
            assert entry is not None
            text0 = entry.text
            offs0 = entry.offsets
            assert text0 is not None and offs0 is not None
            for k in range(o0, o1):
                s, e = offs0[k]
                row_texts.append(text0[s:e])
            canon.extend(entry.canon[o0:o1])  # type: ignore[index]
            hashes.extend(entry.hashes[o0:o1])  # type: ignore[index]
        else:
            changed += 1
            data = next(d for (tt, d) in payloads if tt == t)
            texts_t, fields_t = _zk_rows_for_topic(t, data)
            row_texts.extend(texts_t)
            for ft in fields_t:
                fields_seed.append((len(canon), ft))
                cb = sstate.canonical_row_bytes(*ft)
                canon.append(cb)
                hashes.append(sstate.row_hash(cb))
        zk_index.append([t, sha, r0, len(canon)])
    if not canon:
        return None  # empty cluster: the reference errors; not ours to mask
    # assemble the synthesized document + fresh offsets
    parts: List[str] = [_ZK_TEXT_HEAD]
    offsets: List[Tuple[int, int]] = []
    pos = len(_ZK_TEXT_HEAD)
    for i, rt in enumerate(row_texts):
        if i:
            parts.append(",")
            pos += 1
        parts.append(rt)
        offsets.append((pos, pos + len(rt)))
        pos += len(rt)
    parts.append(_ZK_TEXT_TAIL)
    text = "".join(parts)
    digest = sstate.rows_digest(1, canon)
    state = CachedState(
        digest=digest,
        version=1,
        nrows=len(canon),
        is_json=True,
        topics=topics,
        text=text,
        canon=canon,
        hashes=hashes,
        offsets=offsets,
    )
    for idx, ft in fields_seed:
        state.rows.seed(idx, ft)
    header: Dict[str, object] = {
        "tenant": tenant,
        "path": "",
        "dev": 0,
        "ino": 0,
        "mtime_ns": 0,
        "size": 0,
        "is_json": True,
        "topics": topics or [],
        "digest": digest,
        "version": 1,
        "unstable": False,
        "zk": {"conn": conn, "topics": zk_index},
    }
    _store_entry(sock, tenant, header, text, offsets, canon, hashes)
    return ZkResult(state, hit=False, changed_topics=changed)
