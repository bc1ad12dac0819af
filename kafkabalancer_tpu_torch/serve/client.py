"""The forwarding client embedded in the CLI (no torch, no numpy).

Every normal CLI invocation asks this module whether a live daemon is
reachable on the resolved socket; if so, the parsed flags + input text
are forwarded and the daemon's stdout/stderr/exit code are relayed
verbatim. EVERY failure mode — no socket, stale socket, version skew,
truncated response, daemon death mid-plan — returns ``None`` and the CLI
falls back to the ordinary in-process path, byte-identical to a build
without a daemon (pinned by tests/test_torch_serve.py).

Nothing here may import torch or numpy (directly or transitively): a
forwarded invocation must stay as light as an error exit — the whole
point of the daemon is that the client process never pays the torch
import, the CUDA context or the kernel load.

A daemon answers only a client of its own package and version
(:func:`_hello_ok`): this package's ``__version__`` carries a ``+torch``
suffix, so a client of this package refuses a daemon of the JAX package
and the other way round, and each falls back in process.
"""

from __future__ import annotations

import contextlib
import os
import random
import socket
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from kafkabalancer_tpu_torch import __version__
from kafkabalancer_tpu_torch.serve.protocol import (
    PROTO_V2,
    PROTO_VERSION,
    read_frame,
    read_frame2,
    resolve_socket_path,  # noqa: F401  — re-exported for the CLI
    write_frame,
    write_frame2,
)

# connect + handshake must be near-free when a daemon exists and exactly
# one failed connect() when it does not; the plan response itself gets a
# generous HARD ceiling (a convergence-scale session runs minutes) —
# but the wait is no longer one blind 3600 s read: see _await_reply
CONNECT_TIMEOUT_S = 2.0
PLAN_TIMEOUT_S = 3600.0

# the progress-aware plan wait (the -serve-client-timeout=0 default):
# while no reply byte has arrived, the client wakes every tick and
# probes the daemon's hello on a fresh connection. A daemon that stops
# answering hello — or answers but holds NO in-flight work and makes no
# progress (it accepted our frame and lost it) — is presumed wedged
# after PROGRESS_GRACE_PROBES consecutive bad probes, and the client
# takes its byte-identical in-process fallback in seconds instead of an
# hour, attributed serve.fallbacks.daemon_wedged. (A daemon-side wedged
# LANE is the daemon watchdog's job — it answers a structured error;
# this ladder only has to catch process-level wedges.)
PROGRESS_TICK_S = 5.0
PROGRESS_GRACE_PROBES = 2
# once the first reply byte is visible the frame is in flight; draining
# it gets a plain bounded timeout (generous: a -full-output plan for a
# very large cluster is tens of MB)
REPLY_DRAIN_TIMEOUT_S = 600.0

# the overload backoff ladder: a daemon shedding under load answers a
# structured {op:"overload", retry_after_ms} frame; the client sleeps
# max(retry_after, base*2^attempt) — capped, jittered — and retries on
# the same connection before giving up to the in-process fallback
RETRY_MAX_ATTEMPTS = 4
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 2.0


class _Wedged(Exception):
    """The daemon accepted the request but is presumed wedged (stopped
    answering hello / lost the request) or the wait budget ran out."""


class _Overload(Exception):
    """The daemon shed the request with a structured overload frame."""

    def __init__(self, retry_after_ms: int) -> None:
        super().__init__(f"shed; retry after {retry_after_ms}ms")
        self.retry_after_ms = max(0, int(retry_after_ms))


class ServedResult(NamedTuple):
    """One forwarded invocation's outcome, relayed verbatim.

    ``trace`` is the daemon's reply footer when the request carried a
    trace context (v2 only): the request's trace id, daemon wall and
    the bounded daemon span subtree — raw daemon ``perf_counter_ns``
    stamps the caller maps through its clock-offset estimate
    (obs/edge.py). None on v1 exchanges and for trace-less requests."""

    rc: int
    stdout: str
    stderr: str
    trace: Optional[Dict[str, Any]] = None


class SessionSpec(NamedTuple):
    """What the client needs for the resident-session exchange with a
    protocol-v2 daemon: the session identity plus the raw input (for
    the digest and, on a full re-sync, the register payload)."""

    tenant: str
    text: str
    is_json: bool
    topics: List[str]


# a row-resync whose diff exceeds this never beats re-registering: past
# ~25% changed rows the daemon's patch path falls back to a full encode
# anyway (serve/cache.py), so ship the whole state once instead
_MAX_RESYNC_ROWS_FRACTION = 0.25
_MIN_RESYNC_ROWS = 64


def socket_exists(path: str) -> bool:
    """Cheap pre-check (one stat) so invocations on daemon-less hosts
    pay nothing at all."""
    try:
        return os.path.exists(path)
    except OSError:
        return False


def _connect(path: str, timeout: float) -> Optional[socket.socket]:
    try:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(path)
        return sock
    except OSError:
        return None


def _hello_ok(resp: Optional[Dict[str, Any]]) -> bool:
    """A usable daemon: right protocol AND right package version — a
    daemon left over from an older install must not answer for a newer
    client (its plans could silently differ from the in-process path)."""
    return (
        isinstance(resp, dict)
        and bool(resp.get("ok"))
        and resp.get("v") == PROTO_VERSION
        and resp.get("version") == __version__
    )


def _await_reply(
    sock: socket.socket,
    path: str,
    deadline: float,
    progress: bool,
) -> None:
    """Block until the daemon's reply starts arriving (first byte
    visible via ``MSG_PEEK`` — probing can never desynchronize a frame
    already in flight), then set the drain timeout. Raises
    :class:`_Wedged` when the budget runs out or — in progress-aware
    mode — the daemon is presumed wedged; ``ConnectionError`` on EOF
    before any reply byte (dead peer)."""
    probes_dead = 0
    stalls = 0
    last_done: Any = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise _Wedged("plan wait budget exhausted")
        sock.settimeout(min(PROGRESS_TICK_S, remaining))
        try:
            head = sock.recv(1, socket.MSG_PEEK)
        except socket.timeout:
            if not progress:
                continue  # explicit -serve-client-timeout: budget only
            hello = daemon_alive(path, timeout=2.0)
            if hello is None:
                probes_dead += 1
                if probes_dead >= PROGRESS_GRACE_PROBES:
                    raise _Wedged("daemon stopped answering hello")
                continue
            probes_dead = 0
            inflight = hello.get("requests_inflight")
            done = hello.get("requests")
            if hello.get("warming") or (
                isinstance(inflight, int) and inflight > 0
            ):
                # our request is plausibly queued/running (or the
                # daemon is still building its dispatcher): keep
                # waiting — slow is not wedged
                stalls = 0
                last_done = done
                continue
            # alive, warm, and holding NO in-flight work while we wait:
            # the daemon lost our request. Two consecutive such probes
            # (with no completions in between) confirm it.
            if done == last_done:
                stalls += 1
            else:
                stalls = 0
            last_done = done
            if stalls >= PROGRESS_GRACE_PROBES:
                raise _Wedged("request lost daemon-side")
            continue
        if head == b"":
            raise ConnectionError("EOF before reply")
        sock.settimeout(
            max(CONNECT_TIMEOUT_S, min(remaining, REPLY_DRAIN_TIMEOUT_S))
        )
        return


def _overload_sleep(
    attempt: int, retry_after_ms: int, deadline: float
) -> Optional[float]:
    """The backoff ladder's next sleep: the daemon's ``retry_after_ms``
    is a FLOOR (retrying earlier would arrive at a still-full queue and
    burn an attempt), the exponential term is capped, and jitter goes
    UP (0–50%) so a thundering herd of shed clients decorrelates
    without ever undercutting the advertised earliest-admit time.
    None when the remaining budget cannot cover the sleep (give up and
    fall back in-process)."""
    base = min(RETRY_BACKOFF_BASE_S * (2 ** attempt), RETRY_BACKOFF_CAP_S)
    sleep = max(retry_after_ms / 1000.0, base)
    sleep *= 1.0 + 0.5 * random.random()
    if deadline - time.monotonic() <= sleep:
        return None
    return sleep


def daemon_alive(
    path: str, timeout: float = CONNECT_TIMEOUT_S
) -> Optional[Dict[str, Any]]:
    """Handshake with the daemon at ``path``; its hello response dict
    when live and compatible, else None (absent, stale, or skewed)."""
    sock = _connect(path, timeout)
    if sock is None:
        return None
    try:
        write_frame(sock, {"v": PROTO_VERSION, "op": "hello"})
        resp = read_frame(sock)
        return resp if _hello_ok(resp) else None
    except Exception:
        return None
    finally:
        sock.close()


def _remaining_ms(deadline: float) -> int:
    return max(1, int((deadline - time.monotonic()) * 1000.0))


def forward_plan(
    path: str,
    argv: List[str],
    stdin_text: Optional[str],
    connect_timeout: float = CONNECT_TIMEOUT_S,
    plan_timeout: float = PLAN_TIMEOUT_S,
    on_fallback: Optional[Callable[[str], None]] = None,
    session: Optional[SessionSpec] = None,
    note: Optional[Callable[[str], None]] = None,
    tenant: str = "",
    client_timeout: float = 0.0,
    edge: Any = None,
    cached_state: Any = None,
) -> Optional[ServedResult]:
    """Forward one invocation to the daemon at ``path``.

    ``argv`` is the canonical flag list the CLI built (``-no-daemon``
    included); ``stdin_text`` is the raw input when no ``-input``/
    ``-from-zk`` names a source. Returns the daemon's result, or None on
    ANY failure — the caller falls back in-process.

    ``on_fallback`` receives the REASON when the daemon positively
    declined the request (a structured ``op: "error"`` frame — oversized
    payload, unparseable frame) or the payload exceeds the protocol's
    frame cap client-side, so the CLI can log why it planned in-process
    instead of a generic silent fallback. Silent failure modes (no
    daemon, dead socket, version skew) deliberately stay silent on
    stderr — the daemon-down path must remain byte-identical to a build
    without a daemon — but every one of them reports its reason through
    ``note`` (daemon_down, handshake_mismatch, frame_cap, declined,
    transport_error, session_digest_mismatch), which the CLI turns into
    ``serve.fallbacks.<reason>`` counters so a degraded fleet is
    diagnosable from metrics instead of log archaeology.

    ``session`` opts this invocation into the resident-session exchange
    when the daemon negotiates protocol v2: steady state sends only a
    state digest (``plan-delta``); a mismatch ships just the changed
    rows (``plan-rows``); structural drift re-registers the full state.
    A v1 daemon — or ``session=None`` — gets the exact v1 byte sequence
    this function always sent.

    ``tenant`` is a pure telemetry label: a v2 daemon attributes the
    request's latency/counters to it in its per-tenant scrape block. It
    defaults to
    the session's tenant when a session spec is given; it never
    affects planning, and v1 framing never carries it.

    ``client_timeout`` bounds the whole plan wait (``-serve-client-
    timeout``). The default 0 keeps the generous ``plan_timeout``
    ceiling but waits PROGRESS-AWARE (see ``_await_reply``): a daemon
    that accepts the request and then wedges is detected in seconds
    and falls back, attributed ``daemon_wedged``. An explicit timeout
    is also SENT as the request's ``deadline_ms`` budget so the daemon
    can shed it from the queue once it can no longer be useful. Shed
    (``op: "overload"``) responses are retried with capped, jittered
    exponential backoff honoring ``retry_after_ms`` before the
    in-process fallback (attributed ``overload``).

    ``edge`` is the CLI's edge recorder (obs/edge.py ``EdgeContext``),
    DUCK-TYPED so this module never imports ``obs``: when given, the
    connect/handshake/digest/send/wait/receive phases are timed, the
    hello requests the daemon's clock stamps (one NTP-style offset
    sample per handshake), and every plan-family v2 header carries the
    recorder's trace context. ``edge=None`` (every pre-existing caller)
    changes nothing — and a v1 exchange stays byte-identical either
    way except for the opt-in ``clock`` hello key.

    ``cached_state`` is an edge-residency state (serve/edge_cache.py
    ``CachedState``, duck-typing ``ClientState``): when given alongside
    ``session``, the O(P) parse+digest is skipped entirely — the digest
    ships from the cache, and canon/rows/text materialize lazily only
    on the rare resync/register rungs. ``stdin_text`` may then be None
    even for session requests; any path that genuinely needs the raw
    input (a v1 daemon, a register) loads it from the cached state and
    degrades to the in-process fallback if the cache cannot deliver.
    """

    def _declined(reason: str) -> None:
        if on_fallback is not None:
            try:
                on_fallback(reason)
            except Exception:
                pass

    def _note(reason: str) -> None:
        if note is not None:
            try:
                note(reason)
            except Exception:
                pass

    def _phase(name: str) -> "contextlib.AbstractContextManager[Any]":
        if edge is not None:
            return edge.phase(name)
        return contextlib.nullcontext()

    with _phase("connect"):
        sock = _connect(path, connect_timeout)
    if sock is None:
        _note("daemon_down")
        return None
    # the plan-wait budget: an explicit -serve-client-timeout bounds
    # everything (and travels as the request's deadline_ms); the
    # default keeps the generous ceiling but waits progress-aware
    progress = client_timeout <= 0
    budget = client_timeout if client_timeout > 0 else plan_timeout
    deadline = time.monotonic() + budget
    try:
        hello_req: Dict[str, Any] = {
            "v": PROTO_VERSION, "op": "hello", "max_v": PROTO_V2,
        }
        if edge is not None:
            # opt-in clock handshake: ONLY a hello carrying this key
            # gets monotonic stamps back, so scrape hellos (and their
            # hello-vs-stats key parity pin) are untouched
            hello_req["clock"] = True
        with _phase("handshake"):
            t_hello0 = time.perf_counter_ns()
            write_frame(sock, hello_req)
            hello = read_frame(sock)
            t_hello1 = time.perf_counter_ns()
        if not _hello_ok(hello):
            _note("handshake_mismatch")
            return None
        assert isinstance(hello, dict)
        if edge is not None:
            edge.note_clock_sample(
                t_hello0, hello.get("clock"), t_hello1
            )
        max_v = hello.get("max_v")
        v2 = isinstance(max_v, int) and max_v >= PROTO_V2
        # writes need a generous timeout too: a multi-MB register blob
        # to a GIL-saturated daemon can take longer than the 2 s
        # connect timeout to drain into the socket buffer (reads set
        # their own timeouts per _await_reply call)
        sock.settimeout(
            max(CONNECT_TIMEOUT_S, min(budget, REPLY_DRAIN_TIMEOUT_S))
        )
        # the session digest is attempt-invariant: compute it once and
        # share across overload retries (a multi-MB parse must not be
        # re-paid 4 times in the middle of an overload storm). An
        # edge-residency hit pre-seeds it — the parse never happens.
        state_cache: Dict[str, Any] = {}
        if cached_state is not None and session is not None:
            state_cache["state"] = cached_state
        attempt = 0
        while True:
            try:
                if v2:
                    return _forward_v2(
                        sock, argv, stdin_text, session,
                        tenant or (
                            session.tenant if session is not None else ""
                        ),
                        _declined, _note,
                        path=path, deadline=deadline, progress=progress,
                        send_deadline=not progress,
                        state_cache=state_cache,
                        edge=edge,
                    )
                req: Dict[str, Any] = {
                    "v": PROTO_VERSION, "op": "plan", "argv": argv,
                }
                if not progress:
                    req["deadline_ms"] = _remaining_ms(deadline)
                if stdin_text is None and cached_state is not None:
                    # a v1 daemon cannot use the digest: materialize
                    # the raw input from the cache (or degrade)
                    try:
                        stdin_text = cached_state.load_text()
                    except Exception:
                        _note("edge_cache_error")
                        return None
                if stdin_text is not None:
                    req["stdin"] = stdin_text
                try:
                    with _phase("send"):
                        write_frame(sock, req)
                except ValueError as exc:
                    # the input is too large for one protocol frame — a
                    # positive local refusal, not a daemon failure
                    _declined(
                        f"request exceeds the protocol frame cap: {exc}"
                    )
                    _note("frame_cap")
                    return None
                with _phase("wait_first_byte"):
                    _await_reply(sock, path, deadline, progress)
                with _phase("receive"):
                    resp = read_frame(sock)
                if (
                    isinstance(resp, dict)
                    and resp.get("op") == "overload"
                    and resp.get("reason") != "shutdown"
                ):
                    # a "shutdown" shed falls through to the declined
                    # path below — retrying against a dying daemon
                    # only delays the in-process fallback
                    raise _Overload(
                        int(resp.get("retry_after_ms", 0) or 0)
                    )
                if (
                    not isinstance(resp, dict)
                    or not resp.get("ok")
                    or resp.get("v") != PROTO_VERSION
                ):
                    if isinstance(resp, dict) and resp.get("error"):
                        _declined(str(resp["error"]))
                        _note("declined")
                    else:
                        _note("transport_error")
                    return None
                return ServedResult(
                    rc=int(resp["rc"]),
                    stdout=str(resp.get("stdout", "")),
                    stderr=str(resp.get("stderr", "")),
                )
            except _Overload as ov:
                # the backoff ladder: honor retry_after_ms (capped,
                # jittered), retry on the same connection, give up to
                # the in-process fallback when attempts/budget run out
                sleep = _overload_sleep(
                    attempt, ov.retry_after_ms, deadline
                )
                attempt += 1
                if sleep is None or attempt > RETRY_MAX_ATTEMPTS:
                    _note("overload")
                    return None
                time.sleep(sleep)
    except _Wedged:
        _note("daemon_wedged")
        return None
    except Exception:
        _note("transport_error")
        return None
    finally:
        sock.close()


def _v2_result(
    resp: "Optional[Tuple[Dict[str, Any], bytes]]",
    _declined: Callable[[str], None],
    _note: Callable[[str], None],
) -> Optional[ServedResult]:
    """Decode a v2 plan response (stdout rides in the blob, everything
    else in the header); None on any shape the caller must fall back
    from; raises :class:`_Overload` on a structured shed frame (the
    caller's backoff ladder owns the retry)."""
    if resp is None:
        _note("transport_error")
        return None
    hdr, blob = resp
    if hdr.get("op") == "overload" and hdr.get("reason") != "shutdown":
        raise _Overload(int(hdr.get("retry_after_ms", 0) or 0))
    if not hdr.get("ok") or hdr.get("v") != PROTO_V2:
        if hdr.get("error"):
            _declined(str(hdr["error"]))
            _note("declined")
        else:
            _note("transport_error")
        return None
    footer = hdr.get("trace")
    return ServedResult(
        rc=int(hdr["rc"]),
        stdout=blob.decode("utf-8", errors="replace"),
        stderr=str(hdr.get("stderr", "")),
        trace=footer if isinstance(footer, dict) else None,
    )


def _forward_v2(
    sock: socket.socket,
    argv: List[str],
    stdin_text: Optional[str],
    session: Optional[SessionSpec],
    tenant: str,
    _declined: Callable[[str], None],
    _note: Callable[[str], None],
    *,
    path: str,
    deadline: float,
    progress: bool,
    send_deadline: bool,
    state_cache: Dict[str, Any],
    edge: Any = None,
) -> Optional[ServedResult]:
    """The v2 exchange after a successful hello negotiation: the
    session ladder (plan-delta -> plan-rows -> register) when a session
    spec is usable, else a plain v2 ``plan`` with the input as a raw
    blob (no JSON string escaping either way). Every plan-family read
    waits through ``_await_reply`` (progress-aware wedge detection);
    ``send_deadline`` adds the remaining budget as ``deadline_ms``.
    The wait-contract parameters are keyword-REQUIRED: a caller that
    forgot them would silently disable wedge detection and deadlines."""
    def _phase(name: str) -> "contextlib.AbstractContextManager[Any]":
        if edge is not None:
            return edge.phase(name)
        return contextlib.nullcontext()

    # loading serve/state pulls in the codecs readers — a multi-ms
    # one-time cost that is digest machinery, so on the session path it
    # must land in the digest phase rather than an unattributed gap
    with (_phase("digest") if session is not None
          else contextlib.nullcontext()):
        from kafkabalancer_tpu_torch.serve import state as sstate
        from kafkabalancer_tpu_torch.serve.edge_cache import EdgeCacheError

    def _read2() -> "Optional[Tuple[Dict[str, Any], bytes]]":
        with _phase("wait_first_byte"):
            _await_reply(sock, path, deadline, progress)
        with _phase("receive"):
            return read_frame2(sock)

    def _stamp(hdr: Dict[str, Any]) -> Dict[str, Any]:
        if send_deadline:
            hdr["deadline_ms"] = _remaining_ms(deadline)
        if edge is not None:
            # the trace context rides EVERY plan-family v2 header (the
            # pre-send client phases are final by the first send; a
            # ladder follow-up or overload retry re-stamps the same id)
            hdr["trace"] = edge.trace_context()
        return hdr

    state = None
    if session is not None:
        # parse + digest through the very codecs reader the planner
        # uses; None (unusual input) falls through to the full-state
        # path and the daemon surfaces any real error normally. The
        # caller's cache shares the result across overload retries —
        # the input is attempt-invariant.
        if "state" in state_cache:
            state = state_cache["state"]
        else:
            with _phase("digest"):
                state = state_cache["state"] = sstate.client_state(
                    session.text, session.is_json, session.topics
                )
    if state is None or session is None:
        hdr: Dict[str, Any] = {
            "v": PROTO_V2, "op": "plan", "argv": argv,
            "has_stdin": stdin_text is not None,
        }
        if tenant:
            # telemetry-only: the daemon's per-tenant attribution for
            # requests that skip the session ladder
            hdr["tenant"] = tenant
        blob = stdin_text.encode("utf-8") if stdin_text is not None else b""
        try:
            with _phase("send"):
                write_frame2(sock, _stamp(hdr), blob)
        except ValueError as exc:
            _declined(f"request exceeds the protocol frame cap: {exc}")
            _note("frame_cap")
            return None
        return _v2_result(_read2(), _declined, _note)

    # an edge-residency state knows its row count without materializing
    # the canonical rows (the whole point of the stat-hit rung)
    nrows = getattr(state, "nrows", None)
    if not isinstance(nrows, int):
        nrows = len(state.canon)
    with _phase("send"):
        write_frame2(sock, _stamp({
            "v": PROTO_V2, "op": "plan-delta", "tenant": session.tenant,
            "digest": state.digest, "nrows": nrows,
            "argv": argv,
        }))
    resp = _read2()
    if resp is None:
        _note("transport_error")
        return None
    hdr2, blob2 = resp
    resync = hdr2.get("resync")
    try:
        if resync == "rows":
            _note("session_digest_mismatch")
            try:
                theirs = sstate.unpack_hash_table(blob2)
            except ValueError:
                theirs = None
            # per-row hashes are computed HERE, lazily: only a mismatch
            # pays them (the steady state digests the canonical bytes
            # once) — and an edge-residency state already carries its
            # row-hash ladder, so even a resync pays O(changed)
            mine = getattr(state, "row_hashes", None)
            if mine is None:
                mine = sstate.hashes_of(state.canon)
            changed = (
                sstate.diff_rows(mine, theirs)
                if theirs is not None else None
            )
            if changed is not None and len(changed) <= max(
                _MIN_RESYNC_ROWS,
                int(nrows * _MAX_RESYNC_ROWS_FRACTION),
            ):
                rows_blob = sstate.pack_rows(
                    [(i, state.rows[i]) for i in changed]
                )
                try:
                    with _phase("send"):
                        write_frame2(sock, _stamp({
                            "v": PROTO_V2, "op": "plan-rows",
                            "tenant": session.tenant,
                            "digest": state.digest,
                            "argv": argv,
                        }), rows_blob)
                except ValueError as exc:
                    _declined(
                        f"request exceeds the protocol frame cap: {exc}"
                    )
                    _note("frame_cap")
                    return None
                resp = _read2()
                if resp is None:
                    _note("transport_error")
                    return None
                hdr2, blob2 = resp
                if not hdr2.get("resync"):
                    return _v2_result((hdr2, blob2), _declined, _note)
            resync = "full"
        if resync:
            # structural drift (or the daemon could not use the rows):
            # re-register the full state — the blob is the raw text, so
            # even this worst case skips the JSON escape pass
            _note("session_resync_full")
            reg_text = session.text
            if reg_text == "" and hasattr(state, "load_text"):
                reg_text = state.load_text()
            try:
                with _phase("send"):
                    write_frame2(sock, _stamp({
                        "v": PROTO_V2, "op": "register",
                        "tenant": session.tenant,
                        "argv": argv, "has_stdin": True,
                    }), reg_text.encode("utf-8"))
            except ValueError as exc:
                _declined(
                    f"request exceeds the protocol frame cap: {exc}"
                )
                _note("frame_cap")
                return None
            return _v2_result(_read2(), _declined, _note)
    except EdgeCacheError:
        # the cached body could not be materialized for a resync —
        # degrade to the in-process fallback (content is then re-read
        # from the real source; never a wrong plan, only a slower one)
        _note("edge_cache_error")
        return None
    return _v2_result((hdr2, blob2), _declined, _note)


def _scrape(
    path: str, op: str, timeout: float
) -> Optional[Dict[str, Any]]:
    """One non-plan op round trip (``stats`` / ``dump-trace``) with the
    same hello version gate as forwarding — None on any failure (the
    caller reports "no live daemon")."""
    sock = _connect(path, CONNECT_TIMEOUT_S)
    if sock is None:
        return None
    try:
        write_frame(sock, {"v": PROTO_VERSION, "op": "hello"})
        if not _hello_ok(read_frame(sock)):
            return None
        sock.settimeout(timeout)
        write_frame(sock, {"v": PROTO_VERSION, "op": op})
        resp = read_frame(sock)
        if (
            not isinstance(resp, dict)
            or not resp.get("ok")
            or resp.get("v") != PROTO_VERSION
        ):
            return None
        return resp
    except Exception:
        return None
    finally:
        sock.close()


def fetch_stats(
    path: str, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """The live telemetry scrape (``-serve-stats[-json]`` /
    ``-metrics-prom``): the daemon's stats document, or None when no
    live, version-compatible daemon answers on ``path``."""
    return _scrape(path, "stats", timeout)


def fetch_trace(
    path: str, timeout: float = 60.0
) -> Optional[Dict[str, Any]]:
    """The flight-recorder export (``-serve-dump-trace``): a response
    whose ``trace`` key is a Perfetto-loadable document, or None."""
    return _scrape(path, "dump-trace", timeout)


def fetch_watch(
    path: str, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """The watch-lag scrape (the ``watch`` protocol op): a response
    carrying the daemon's ``watch`` block (ticks/reads/lag/emitted
    plans) and its ``speculation`` block, or None when no live,
    version-compatible daemon answers. Much cheaper than ``stats`` — a
    driver polls it between fake-ZK mutations."""
    return _scrape(path, "watch", timeout)


def release_session(
    path: str, tenant: str, timeout: float = 10.0
) -> Optional[int]:
    """Drop a tenant's resident sessions on a live v2 daemon — hot
    residents AND warm spill records (a released tenant must not be
    silently restorable from disk); the total number released across
    both tiers, or None when no v2 daemon answers."""
    sock = _connect(path, CONNECT_TIMEOUT_S)
    if sock is None:
        return None
    try:
        write_frame(
            sock, {"v": PROTO_VERSION, "op": "hello", "max_v": PROTO_V2}
        )
        hello = read_frame(sock)
        if not _hello_ok(hello):
            return None
        assert isinstance(hello, dict)
        max_v = hello.get("max_v")
        if not (isinstance(max_v, int) and max_v >= PROTO_V2):
            return None
        sock.settimeout(timeout)
        write_frame2(
            sock, {"v": PROTO_V2, "op": "release", "tenant": tenant}
        )
        resp = read_frame2(sock)
        if resp is None or not resp[0].get("ok"):
            return None
        return int(resp[0].get("released", 0)) + int(
            resp[0].get("released_warm", 0) or 0
        )
    except Exception:
        return None
    finally:
        sock.close()


def request_shutdown(path: str, timeout: float = 10.0) -> bool:
    """Ask the daemon at ``path`` to exit; True when acknowledged."""
    sock = _connect(path, timeout)
    if sock is None:
        return False
    try:
        write_frame(sock, {"v": PROTO_VERSION, "op": "shutdown"})
        resp = read_frame(sock)
        return isinstance(resp, dict) and bool(resp.get("ok"))
    except Exception:
        return False
    finally:
        sock.close()
