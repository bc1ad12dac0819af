"""The daemon wire protocol: versioned length-prefixed frames.

**v1** (the baseline every peer speaks): one frame = a 4-byte big-endian
payload length followed by that many bytes of UTF-8 JSON. Every message
carries ``{"v": PROTO_VERSION}``; a peer speaking a different version is
treated as unreachable (the client falls back to the in-process path
rather than risk a half-understood plan).

**v2** (negotiated at hello, see below): one frame = an 8-byte header
(two 4-byte big-endian lengths: JSON header, raw blob) followed by the
UTF-8 JSON header and then the raw binary blob. The blob carries bulk
payloads — the full input text on ``register``/``plan``, the packed
changed-row records on ``plan-rows``, the plan stdout on responses —
WITHOUT JSON string escaping, so a megabyte of cluster state costs one
memcpy instead of an escape/unescape pass on each side.

Negotiation: a v2-capable client adds ``"max_v": PROTO_V2`` to its v1
``hello``; the daemon always answers with its own ``max_v``. When BOTH
sides advertised v2, every subsequent frame on that connection (both
directions) is a v2 frame. A v1 client never sends ``max_v``, so the
daemon keeps v1 framing for it and every pre-v2 byte sequence means
exactly what it always did.

Requests carry ``"op"``:

- ``hello``    — liveness/identity handshake; the response carries the
  daemon pid, package version, uptime and request counters, and is what
  distinguishes a live daemon from a stale socket file;
- ``plan``     — one CLI invocation: ``argv`` (the canonical flag list
  the client built, ``-no-daemon`` included so the daemon never
  re-forwards) plus ``stdin`` (the input text when no ``-input``/
  ``-from-zk`` names a source). v2 plan headers may carry ``tenant``
  (the client's session identity) purely for telemetry attribution —
  an untenanted request lands in the scrape's ``other`` rollup. The
  response carries ``rc``/``stdout``/``stderr`` verbatim;
- ``stats``    — live telemetry scrape: the daemon's shared snapshot
  (requests/inflight/lane attribution) plus every streaming histogram's
  lifetime + windowed percentiles, as a schema-versioned document
  (``STATS_SCHEMA``). Answered on the connection thread, NEVER through
  the plan dispatcher — a scrape must not pause planning;
- ``dump-trace`` — the flight recorder's span ring + request log as a
  Perfetto-loadable Chrome trace document (the client writes the file);
- ``watch``    — the watch-mode lag scrape (serve/speculate.py
  ``ZkWatcher``): ticks/reads/errors, emitted-plan and speculation-hit
  counts, ``last_read_age_s`` / ``last_event_lag_s`` staleness, and
  the watcher's current state digest — answered on the connection
  thread like ``stats`` and equally passive for the idle clock; the
  same block also rides the ``stats`` document;
- ``shutdown`` — orderly daemon exit (acknowledged before the listener
  closes).

Overload protection (serve/admission.py):
a ``plan``-family request may carry ``deadline_ms`` — the client's
remaining wait budget. The daemon sheds a QUEUED request whose deadline
has passed (never one already dispatched), and sheds arrivals past its
queue/tenant caps, answering a structured

    ``{"ok": false, "op": "overload", "reason": <overload|tenant|
    deadline|quarantine|shutdown>, "retry_after_ms": N, "error": ...}``

frame instead of queueing forever. ``retry_after_ms`` is the daemon's
live estimate of when a retry could be admitted; the client honors it
with capped, jittered exponential backoff before taking its
byte-identical in-process fallback. Both framings carry the same keys
(v1: the JSON frame verbatim; v2: in the response header).

v2-only session ops (serve/sessions.py):

- ``register``   — create/replace a resident cluster session for
  ``(tenant, flags signature)``: the blob is the raw input text; the
  daemon parses it once, plans, and keeps the parsed + settled state
  resident. The response IS the plan result.
- ``plan-delta`` — the steady-state request: tenant + the client's
  state digest + argv, NO state payload. On a digest match the daemon
  plans from the resident session (parse/settle/encode all skipped);
  on a mismatch it answers ``resync: "rows"`` with its row-hash table
  (or ``resync: "full"`` when no compatible session exists).
- ``plan-rows``  — the row-level re-sync: the blob is the packed
  changed-row records (serve/state.py); the daemon patches its
  resident raw rows, re-settles, and plans.
- ``release``    — drop a tenant's resident sessions, hot AND warm
  (the response reports both: ``released`` / ``released_warm``).

End-to-end tracing (obs/edge.py): a plan-family **v2** header may carry ``"trace"`` — the
client's compact trace context ``{"id": <16 hex>, "parent": <client
forward-span sid>, "phases": {<pre-send client phase>: seconds},
"edge_pre_ms": N, "rtt_ns": N}``. The daemon adopts the remote trace:
its request span attribution carries the trace id, its flight record
stores it, and the client's pre-send phases land in the served
request's metrics export as ``client.phase.*`` gauges. The matching
**reply footer** rides the v2 response header as ``"trace"``: ``{"id",
"wall_s", "spans": [<= FOOTER span records from the request thread's
flight ring, raw daemon perf_counter_ns stamps]}`` — bounded, so a
footer can never dominate a reply. Clock alignment: a client hello may
carry ``"clock": true``; ONLY then does the hello response add
``"clock": {"recv_ns", "send_ns"}`` (daemon ``perf_counter_ns`` at
hello receipt/reply), giving the client one NTP-style 4-stamp sample
per handshake (obs/edge.py ``estimate_offset``). v1 frames NEVER carry
any of this — a v1 exchange stays byte-identical to every prior
release, and scrape hellos that omit the clock key get the exact
pre-v8 hello document.

Session durability (serve/spill.py): with ``-serve-session-spill-dir``
set, evicted/expired/flushed sessions persist as checksummed disk
records, and a ``plan-delta``/``plan-rows`` for an absent session first
tries to RESTORE the spilled record — the ``resync: "full"`` answer only
remains for true cold misses (no record, corrupt record, foreign
record). The wire shapes above are unchanged; durability is invisible
to the client except as fewer full resyncs.

Nothing in this module (or ``serve.client``) imports torch or numpy:
the client side of a forwarded invocation must stay as light as an
error exit — and that pin extends to the scrape verbs
(``-serve-stats-json``, ``-serve-dump-trace``), which are pure protocol
clients.

The default socket name and its environment variable are this
package's own (``kafkabalancer-tpu-torch-<uid>.sock``,
``$KAFKABALANCER_TPU_TORCH_SOCKET``), so a daemon of the JAX package on
the same host never shares a path with one of this package; the
version string in ``hello`` (``__version__``, ``+torch``) makes each
package's client refuse the other's daemon in any case.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

PROTO_VERSION = 1
# the binary-frame extension, negotiated per connection at hello; the
# baseline PROTO_VERSION stays 1 so every existing peer's handshake and
# plan exchange is byte-identical (see module docstring)
PROTO_V2 = 2

# the stats scrape document's schema id — versioned independently of the
# wire protocol (adding a scrape field bumps this, not PROTO_VERSION).
# v2: + "memory" (per-lane HBM/residency-pool attribution)
# v3: + "sessions" (resident cluster sessions: count/bytes/delta hits)
#     + "fallbacks" (daemon-observed client fallback/resync reasons)
# v4: + "tenants" (per-tenant attribution: bounded top-K label families
#     — request counts, latency hists, session/fallback attribution,
#     with demoted tenants rolled into "other")
# v5: + "admission" (fair-queue occupancy, caps, shed counts by reason,
#     the live retry_after estimate), "lane_health" (quarantines /
#     requeues / recoveries, quarantined lane list), "faults" (the
#     chaos seam's armed spec + fired counts), per-tenant "sheds", and
#     the flight recorder's "autodumps_suppressed"
# v6: + "paging" (the warm session tier, serve/spill.py: spills /
#     adopted / restores / restore_hits / corrupt_drops / evictions /
#     write_failures under the conservation identity spills + adopted
#     == restores + corrupt_drops + evictions + warm_entries, plus the
#     live warm_bytes/warm_entries footprint; same key set with the
#     tier disabled), and per-tenant "restores" / "warm_sessions" /
#     "warm_bytes" in the tenants block
# v7: + "speculation" (speculative plan-ahead, serve/speculate.py:
#     attempts / hits / misses / poisoned / aborted / deferred /
#     wasted_dispatches / memos / inflight under the exact identity
#     attempts == hits + misses + poisoned + memos), "watch" (the
#     -watch continuous controller: ticks / reads / events / resyncs /
#     plans_emitted / lag fields; same key set with the mode off), and
#     per-tenant "spec_hits" in the tenants block
# v8: + per-tenant "edge_ms" in the tenants block (the client-reported
#     edge cost — pre-send phase wall + wire RTT — as a streaming hist
#     per top-K tenant, from each request's trace context; null for
#     tenants whose clients never sent one)
STATS_SCHEMA_VERSION = 8
STATS_SCHEMA = f"kafkabalancer-tpu.serve-stats/{STATS_SCHEMA_VERSION}"

# a frame larger than this is a protocol error, not a payload: the
# biggest legitimate frame is a -full-output plan for a very large
# cluster (tens of MB), and an unframed/garbage peer must not make the
# reader allocate gigabytes from four random length bytes
MAX_FRAME_BYTES = 1 << 28

_LEN = struct.Struct(">I")


# this package's own default socket variable and name (see the module
# docstring: never the JAX package's)
SOCKET_ENV = "KAFKABALANCER_TPU_TORCH_SOCKET"
SOCKET_STEM = "kafkabalancer-tpu-torch"


def default_socket_path() -> str:
    """The per-user default socket: ``$KAFKABALANCER_TPU_TORCH_SOCKET``
    when set, else ``<tmpdir>/kafkabalancer-tpu-torch-<uid>.sock``
    (per-uid so two operators on one host get independent daemons)."""
    env = os.environ.get(SOCKET_ENV, "")
    if env:
        return env
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"{SOCKET_STEM}-{uid}.sock")


def resolve_socket_path(flag_value: str = "") -> str:
    """The one precedence rule shared by daemon and client:
    ``-serve-socket`` flag > ``$KAFKABALANCER_TPU_TORCH_SOCKET`` >
    default."""
    return flag_value or default_socket_path()


def pidfile_path(socket_path: str) -> str:
    """The liveness pidfile rides next to the socket."""
    return socket_path + ".pid"


def write_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame too large: {len(payload)} bytes")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes, or None on a clean EOF at a frame
    boundary (mid-frame EOF raises — that is a truncation, not a
    close)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ConnectionError(f"EOF mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(
    sock: socket.socket,
    on_first: Optional[Callable[[], None]] = None,
) -> Optional[Dict[str, Any]]:
    """One frame as a dict, or None on clean EOF. Raises on truncation,
    an oversized length prefix, or non-JSON payload. ``on_first`` (when
    given) fires once the length prefix has arrived — the seam the edge
    recorder uses to split ``wait_first_byte`` from ``receive`` without
    a second syscall layer; it must not raise."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    if on_first is not None:
        on_first()
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    body = _recv_exact(sock, n) if n else b""
    if body is None:
        raise ConnectionError("EOF after frame header")
    obj = json.loads(body.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("frame payload is not a JSON object")
    return obj


# --- v2 binary frames ------------------------------------------------------

_LEN2 = struct.Struct(">II")


def write_frame2(
    sock: socket.socket, obj: Dict[str, Any], blob: bytes = b""
) -> None:
    """One v2 frame: JSON header + raw binary blob, each length-capped
    like a v1 frame. The blob is shipped as-is — no JSON escaping."""
    header = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(header) > MAX_FRAME_BYTES:
        raise ValueError(f"frame header too large: {len(header)} bytes")
    if len(blob) > MAX_FRAME_BYTES:
        raise ValueError(f"frame blob too large: {len(blob)} bytes")
    # the blob is sent as-is, never concatenated: a register payload is
    # the whole cluster text, and building one joined bytes object
    # would re-copy the very megabytes this framing exists not to touch
    sock.sendall(_LEN2.pack(len(header), len(blob)) + header)
    if blob:
        sock.sendall(blob)


def read_frame2(
    sock: socket.socket,
    on_first: Optional[Callable[[], None]] = None,
) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """One v2 frame as ``(header, blob)``, or None on clean EOF at a
    frame boundary. Raises on truncation, oversized lengths, or a
    non-JSON header — exactly the v1 error model. ``on_first`` is the
    same first-byte seam as :func:`read_frame`."""
    head = _recv_exact(sock, _LEN2.size)
    if head is None:
        return None
    if on_first is not None:
        on_first()
    hn, bn = _LEN2.unpack(head)
    if hn > MAX_FRAME_BYTES or bn > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame lengths {hn}+{bn} exceed {MAX_FRAME_BYTES}"
        )
    header = _recv_exact(sock, hn) if hn else b""
    if header is None:
        raise ConnectionError("EOF after v2 frame header lengths")
    blob = _recv_exact(sock, bn) if bn else b""
    if blob is None:
        raise ConnectionError("EOF inside v2 frame blob")
    obj = json.loads(header.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("v2 frame header is not a JSON object")
    return obj, blob
