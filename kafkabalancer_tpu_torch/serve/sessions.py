"""Resident cluster sessions for the planning daemon.

The paper's deployment model re-invokes the planner once per move with
freshly read cluster state (PAPER.md §0); consecutive requests therefore
differ by exactly the move the planner itself emitted, and a served
request would otherwise spend its time re-materializing that state:
protocol transfer + parse + settle + tensorize of a cluster the daemon
already knows. A resident
session keeps everything the next request needs live in the daemon —
vLLM's state-residency argument applied to planning state, with
Clipper's per-tenant session structure for isolation (PAPERS.md).

One :class:`ClusterSession` per ``(tenant, flags-signature)`` holds:

- ``raw``      — the parsed, PRE-settle partition rows (copies), the
  shadow of what the client's outer loop observes. Every replica
  mutation the planner applies is mirrored here through the
  ``obs.convergence`` mutation tap, so after a request completes the
  session can predict the digest of the client's NEXT read (base state
  + the moves the outer loop will apply).
- ``pl``       — the SETTLED live list the previous plan ran on, moves
  applied in place (the reference's slice-aliasing state threading).
  On a digest match the next request plans directly on it: no parse,
  no text transfer, and settle degenerates to its no-repair prescreen.
- ``row_cache``— a trusted-delta :class:`~kafkabalancer_tpu_torch.serve.cache.
  TensorizeRowCache`: the tap marks exactly the mutated rows, so the
  steady-state tensorize patches those rows without the O(P) key scan.

Correctness model — "never wrong answers": the ONLY fast path is gated
on the client's state digest equalling the digest of the session's
predicted raw state (serve/state.py, order-sensitive, every parsed
field). Anything else — a mutation the tap missed, an applied-but-
unemitted complete-partition probe move, external drift, a daemon
restart — makes the digests differ and degrades to a row-level or full
re-sync that rebuilds from ground truth. The one prediction-adjacent
subtlety handled explicitly: ``fill_defaults`` derives default
allowed-broker lists from the OBSERVED broker set, so when a session
whose rows use defaulted brokers sees that set change (a move vacating
a broker's last replica), the resident settled list is discarded and
rebuilt from raw even on a digest match (``universe_dirty``).

The :class:`SessionStore` is per-tenant, LRU-capped with idle expiry,
and reports bytes + hit/resync counters into the stats scrape's
``sessions`` block.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from kafkabalancer_tpu_torch.models import Partition, PartitionList
from kafkabalancer_tpu_torch.serve import speculate, state as sstate

SessionKey = Tuple[str, str]

# flags that do not change planning-state evolution: two invocations
# differing only in these share one resident session. Everything else
# (solver, budgets, constraint knobs, input format, topics filter…)
# keys a separate session — conservative on purpose.
_SIG_EXCLUDE = (
    "-metrics-json=", "-trace=", "-explain=", "-stats=",
    "-full-output=", "-unique=", "-no-daemon=",
)


def flags_signature(argv: Iterable[str]) -> str:
    """The planning-relevant flag signature of a canonical forwarded
    argv (client argvs are sorted, so this is deterministic)."""
    return "\x00".join(
        a for a in argv if not a.startswith(_SIG_EXCLUDE)
    )


def _fields_of(p: Partition) -> sstate.RowFields:
    return sstate.partition_fields(p)


def _partition_from_fields(f: sstate.RowFields) -> Partition:
    topic, partition, replicas, weight, nrep, brokers, ncons = f
    return Partition(
        topic=topic,
        partition=partition,
        replicas=list(replicas),
        weight=weight,
        num_replicas=nrep,
        brokers=None if brokers is None else list(brokers),
        num_consumers=ncons,
    )


class ClusterSession:
    """One tenant's resident planning state; see the module docstring.

    Not internally locked: the owning daemon holds :attr:`lock` (via
    the store checkout) for the whole request that touches it."""

    def __init__(self, tenant: str, sig: str) -> None:
        self.tenant = tenant
        self.sig = sig
        self.lock = threading.Lock()
        self.in_use = False
        # set by SessionStore.release: an explicitly forgotten session
        # must not be re-persisted by an in-flight request's continuous
        # spill (the spill layer refuses released sessions)
        self.released = False
        self.last_used = time.monotonic()
        self.version = 1
        # the raw-row shadow + its canonical row bytes; digest is None
        # until the first request completes cleanly (and after any event
        # that makes prediction unsafe — a crashed request, a tap miss)
        self.raw: List[Partition] = []
        self.canon: List[bytes] = []
        self.digest: Optional[str] = None
        self._dirty: Set[int] = set()
        # the settled live list + identity map (live object -> row)
        self.pl: Optional[PartitionList] = None
        self._idmap: Dict[int, int] = {}
        # observed-broker multiset over raw replicas, for the
        # universe_dirty detection (only meaningful when any row's
        # allowed brokers were defaulted at parse)
        self._broker_counts: Dict[int, int] = {}
        self.default_brokers = False
        self.universe_dirty = False
        self.bucket: Optional[Any] = None
        self.approx_bytes = 0
        # speculative plan-ahead (serve/speculate.py): the canonical
        # argv of the last clean session request (what the speculator
        # re-plans with) and the live memoized answer, if any — the
        # memo is owned/retired through the Speculator's counters
        self.last_argv: Optional[List[str]] = None
        self.spec_memo: Optional[Any] = None
        from kafkabalancer_tpu_torch.serve.cache import TensorizeRowCache

        self.row_cache = TensorizeRowCache()
        self.row_cache.enable_trusted_deltas()

    # -- snapshots --------------------------------------------------------
    def snapshot_from(self, pl: PartitionList) -> None:
        """Adopt ``pl`` as this session's live list and shadow its raw
        (pre-settle) rows. Called at parse time, BEFORE fill_defaults
        touches anything — the shadow must capture what the CLIENT
        read, not what settle derived."""
        parts = list(pl.iter_partitions())
        self.version = pl.version
        self.raw = [p.copy() for p in parts]
        self.canon = [
            sstate.canonical_row_bytes(*_fields_of(p)) for p in self.raw
        ]
        self._dirty = set()
        self.pl = pl
        self._idmap = {id(p): i for i, p in enumerate(parts)}
        self._rebuild_broker_counts()
        self.universe_dirty = False
        self.digest = sstate.rows_digest(self.version, self.canon)

    def _rebuild_broker_counts(self) -> None:
        """Recompute the observed-broker multiset (and whether any row
        relies on defaulted allowed brokers) from the raw shadow — the
        ONE definition shared by snapshot and row-patch paths."""
        counts: Dict[int, int] = {}
        default_brokers = False
        for p in self.raw:
            if p.brokers is None:
                default_brokers = True
            for b in p.replicas:
                counts[b] = counts.get(b, 0) + 1
        self._broker_counts = counts
        self.default_brokers = default_brokers

    def rebuild_pl(self) -> PartitionList:
        """A fresh pre-settle list from the raw shadow (the row-resync
        path): new Partition copies, new identity map. The caller runs
        the ordinary settle+plan pipeline on it, which re-derives every
        default — including the observed-broker universe — from ground
        truth, clearing :attr:`universe_dirty`."""
        parts = [p.copy() for p in self.raw]
        pl = PartitionList(version=self.version, partitions=parts)
        self.pl = pl
        self._idmap = {id(p): i for i, p in enumerate(parts)}
        self.universe_dirty = False
        return pl

    # -- the mutation tap -------------------------------------------------
    def _update_counts(
        self, old: List[int], new: List[int]
    ) -> None:
        """Maintain the observed-broker multiset across one replica
        change; flags ``universe_dirty`` whenever MEMBERSHIP changes
        (a vacated or brand-new broker — the defaulted allowed lists
        a fresh settle would derive are different then)."""
        counts = self._broker_counts
        for b in old:
            c = counts.get(b, 0) - 1
            if c <= 0:
                counts.pop(b, None)
                # a broker lost its last replica: the next fresh
                # settle would drop it from every defaulted allowed
                # list — the resident settled state is stale even if
                # the digest matches
                self.universe_dirty = True
            else:
                counts[b] = c
        for b in new:
            c = counts.get(b, 0)
            if c == 0:
                self.universe_dirty = True
            counts[b] = c + 1

    def change(self, part: Partition) -> "Optional[Tuple[int, List[int]]]":
        """Mirror one applied replica mutation into the raw shadow
        (the ``obs.convergence`` tap target). O(1) plus the replica
        lists' length. Returns ``(row, previous replicas)`` so the
        per-request context can revert an applied-but-unemitted probe
        move; None when the mutated object is untracked (prediction
        poisoned — the next request re-syncs instead of fast-pathing)."""
        i = self._idmap.get(id(part))
        if i is None:
            self.digest = None
            return None
        old = self.raw[i].replicas
        new = list(part.replicas)
        if self.default_brokers:
            self._update_counts(old, new)
        self.raw[i].replicas = new
        self._dirty.add(i)
        self.row_cache.mark_changed(i)
        return i, old

    def revert_change(self, i: int, old: List[int]) -> None:
        """Undo one mirrored mutation on BOTH the raw shadow and the
        settled live row — the complete-partition probe move is applied
        to the live list but never emitted, so the cluster will not see
        it; keeping it resident would force a re-sync on every
        steady-state step under the DEFAULT flag set."""
        if self.pl is None or self.pl.partitions is None:
            self.digest = None
            return
        live = self.pl.partitions[i]
        if self.default_brokers:
            self._update_counts(self.raw[i].replicas, old)
        live.replicas[:] = old
        self.raw[i].replicas = list(old)
        self._dirty.add(i)
        self.row_cache.mark_changed(i)

    # -- row patches (resync) ---------------------------------------------
    def apply_row_patches(
        self, patches: List[Tuple[int, sstate.RowFields]]
    ) -> bool:
        """Overwrite raw rows from client-shipped records; False when
        any index is out of range (structural drift — the caller falls
        back to a full re-sync)."""
        n = len(self.raw)
        for idx, _f in patches:
            if idx < 0 or idx >= n:
                return False
        for idx, fields in patches:
            self.raw[idx] = _partition_from_fields(fields)
            self.canon[idx] = sstate.canonical_row_bytes(*fields)
            self._dirty.discard(idx)
            self.row_cache.mark_changed(idx)
        # broker counts are rebuilt wholesale — patches are the rare
        # path and the incremental bookkeeping is not worth the risk
        self._rebuild_broker_counts()
        self._refresh_digest()
        return True

    # -- request lifecycle ------------------------------------------------
    def _refresh_digest(self) -> None:
        for i in self._dirty:
            self.canon[i] = sstate.canonical_row_bytes(
                *_fields_of(self.raw[i])
            )
        self._dirty = set()
        self.digest = sstate.rows_digest(self.version, self.canon)

    def finish(self, rc: Optional[int]) -> None:
        """Request end: on a clean exit, fold the tapped mutations into
        the per-row hashes and predict the client's next digest; on any
        failure, poison the prediction (the planner may have mutated
        state partway) — the next request re-syncs from ground truth."""
        if rc == 0 and self.digest is not None:
            self._refresh_digest()
        else:
            self.digest = None
        self.last_used = time.monotonic()
        self.approx_bytes = self._approx_bytes()

    def _approx_bytes(self) -> int:
        rows = 0
        for p in self.raw:
            rows += 120 + 16 * len(p.replicas)
            if p.brokers is not None:
                rows += 8 * len(p.brokers)
        # raw shadow + settled live list are comparable in size
        return (
            2 * rows
            + sum(len(b) for b in self.canon)
            + self.row_cache.approx_bytes()
        )

    def hash_table(self) -> bytes:
        """The resync diff table of the CURRENT raw shadow (dirty rows
        re-canonicalized first, so a poisoned session still diffs
        truthfully). Per-row hashes are derived here, lazily — only a
        resync pays them."""
        for i in self._dirty:
            self.canon[i] = sstate.canonical_row_bytes(
                *_fields_of(self.raw[i])
            )
        self._dirty = set()
        return sstate.pack_hash_table(sstate.hashes_of(self.canon))


def session_from_rows(
    tenant: str, sig: str, version: int, rows: List[sstate.RowFields]
) -> ClusterSession:
    """Rebuild a session from spilled raw rows (serve/spill.py): the
    raw shadow, canonical bytes, broker multiset and predicted digest
    are all re-derived from the record — the settled live list and the
    trusted-delta cache re-prime on the restored session's FIRST
    request (the ``rebuild`` kind re-settles from raw), after which
    the tenant is back on the delta fast path."""
    sess = ClusterSession(tenant, sig)
    sess.version = version
    sess.raw = [_partition_from_fields(f) for f in rows]
    sess.canon = [sstate.canonical_row_bytes(*f) for f in rows]
    sess._rebuild_broker_counts()
    sess.digest = sstate.rows_digest(version, sess.canon)
    sess.approx_bytes = sess._approx_bytes()
    return sess


class SessionStore:
    """The daemon's resident sessions: per-tenant, LRU-capped, idle
    expiry, bytes accounted. All methods thread-safe; sessions checked
    out ``in_use`` are never evicted.

    With a warm tier attached (:attr:`spill`, serve/spill.py), the hot
    cap stops being a discard boundary: LRU eviction and idle expiry
    DEMOTE the session to a disk record instead of dropping it, and
    explicit :meth:`release` forgets both tiers. The spill writes run
    inside the store lock — demotion is the rare path, and a spill
    racing a concurrent restore of the same key would be worse."""

    def __init__(
        self,
        cap: int = 64,
        idle_s: float = 3600.0,
        spill: Optional[Any] = None,
    ) -> None:
        self.cap = max(1, cap)
        self.idle_s = idle_s
        self.spill = spill
        # the daemon's Speculator (serve/speculate.py), when one is
        # attached: session removal retires any live memo as poisoned
        self.spec: Optional[Any] = None
        self._lock = threading.Lock()
        self._sessions: Dict[SessionKey, ClusterSession] = {}
        self.registered = 0
        self.delta_hits = 0
        self.resyncs_rows = 0
        self.resyncs_full = 0
        self.released = 0
        self.evicted_lru = 0
        self.expired_idle = 0
        # tensorize-cache attribution of sessions that no longer exist:
        # folded in at removal so the daemon's aggregate cache counters
        # are monotone (a scraper's rate() must never see them rewind).
        # A removed-but-still-checked-out session parks in _zombies
        # until its in-flight request checks in — retiring it early
        # would snapshot the cache BEFORE that request's lookups land
        # and under-count forever.
        self._retired_cache = {"hits": 0, "misses": 0, "rows_reused": 0}
        self._zombies: List[ClusterSession] = []
        # per-tenant release generations (see release/release_gen)
        self._release_gens: Dict[str, int] = {}

    def _retire(self, sess: ClusterSession) -> None:
        # a removed/replaced session's memoized answer can never be
        # served: retire it as poisoned BEFORE the zombie park (the
        # state it predicts is superseded either way)
        if sess.spec_memo is not None:
            if self.spec is not None:
                self.spec.poison_session(sess)
            else:
                sess.spec_memo = None
        if sess.in_use:
            self._zombies.append(sess)
            return
        st = sess.row_cache.stats()
        for k in self._retired_cache:
            self._retired_cache[k] += st.get(k, 0)

    def cache_stats(self) -> Dict[str, int]:
        """Aggregate tensorize-cache attribution across live, zombie
        (removed but still checked out) AND retired sessions."""
        with self._lock:
            out = dict(self._retired_cache)
            for s in list(self._sessions.values()) + self._zombies:
                st = s.row_cache.stats()
                for k in out:
                    out[k] += st.get(k, 0)
            return out

    def get(self, key: SessionKey) -> Optional[ClusterSession]:
        with self._lock:
            return self._sessions.get(key)

    def count_delta_hit(self) -> None:
        with self._lock:
            self.delta_hits += 1

    def count_resync_rows(self) -> None:
        with self._lock:
            self.resyncs_rows += 1

    def count_resync_full(self) -> None:
        with self._lock:
            self.resyncs_full += 1

    def checkout(
        self, key: SessionKey
    ) -> Tuple[Optional[ClusterSession], bool]:
        """Look up AND exclusively claim a session; ``(session, False)``
        on success (the caller must :meth:`checkin` after its request),
        ``(None, True)`` when the session exists but another request
        holds it, ``(None, False)`` when there is none.

        NON-blocking on purpose: a second concurrent request for the
        same tenant must not queue behind the first — the daemon
        answers it ``resync: full`` and it plans through the stateless
        register path, which coalesces like any other
        request. Sessions accelerate the sequential outer loop; they
        must never serialize a concurrent burst."""
        with self._lock:
            sess = self._sessions.get(key)
        if sess is None:
            return None, False
        if not sess.lock.acquire(blocking=False):
            return None, True
        with self._lock:
            # re-validate: the session may have been released/evicted
            # between the lookup and the claim
            if self._sessions.get(key) is not sess:
                sess.lock.release()
                return None, False
            sess.in_use = True
        return sess, False

    def checkin(self, sess: ClusterSession) -> None:
        with self._lock:
            sess.in_use = False
            if sess in self._zombies:
                # removed (replaced/released) while this request held
                # it: fold its final cache counters now that they are
                # complete
                self._zombies.remove(sess)
                self._retire(sess)
        sess.lock.release()

    def _spill_locked(self, key: SessionKey, sess: ClusterSession) -> None:
        """Demote one session to the warm tier (no-op without one, or
        for a session whose prediction is poisoned — the spill layer
        refuses untrustworthy state itself). A session with a LIVE
        speculative memo is deliberately NOT re-spilled: its in-memory
        state has advanced past the answer the client has seen, while
        the continuous spill of the last REAL request already persisted
        exactly the state the client will describe next — overwriting
        that record would turn the next restore into a resync."""
        if self.spill is not None and sess.spec_memo is None:
            self.spill.spill(key, sess)

    def put(self, key: SessionKey, sess: ClusterSession) -> None:
        """Insert/replace a freshly registered session, demoting the
        least-recently-used idle sessions past the cap to the warm
        tier (or discarding them when no spill dir is configured)."""
        self._insert(key, sess, registered=True)

    def adopt(self, key: SessionKey, sess: ClusterSession) -> bool:
        """Insert a session RESTORED from the warm tier — same LRU
        discipline as :meth:`put`, but not counted as a register (the
        client never re-sent the cluster; that is the point). Returns
        False — nothing inserted — when the key is already occupied: a
        concurrent register that won the restore window holds newer
        state and must survive, never be clobbered by the older
        spilled record."""
        return self._insert(
            key, sess, registered=False, only_if_absent=True
        )

    def _insert(
        self, key: SessionKey, sess: ClusterSession, registered: bool,
        only_if_absent: bool = False,
    ) -> bool:
        with self._lock:
            prev = self._sessions.get(key)
            if only_if_absent and prev is not None:
                return False
            if registered:
                self.registered += 1
            sess.last_used = time.monotonic()
            if prev is not None and prev is not sess:
                self._retire(prev)
            self._sessions[key] = sess
            if len(self._sessions) > self.cap:
                idle = sorted(
                    (
                        (s.last_used, k)
                        for k, s in self._sessions.items()
                        if not s.in_use and s is not sess
                    ),
                )
                for _ts, k in idle[: len(self._sessions) - self.cap]:
                    victim = self._sessions[k]
                    self._spill_locked(k, victim)
                    self._retire(victim)
                    del self._sessions[k]
                    self.evicted_lru += 1
        return True

    def release(self, tenant: str) -> int:
        """Drop every session of ``tenant`` (all flag signatures) from
        the HOT tier — an explicit forget, never a demotion; the
        caller (the daemon's ``release`` op) drops the warm tier's
        records separately (warm FIRST, so no new restore can begin
        once the hot sweep runs). Returns how many were dropped.

        Every dropped session — zombies of the tenant included — is
        marked ``released`` so an in-flight request's continuous spill
        cannot resurrect it to disk, and the tenant's release
        GENERATION bumps so a restore racing this call is detected and
        dropped (daemon._checkout_or_restore)."""
        with self._lock:
            self._release_gens[tenant] = (
                self._release_gens.get(tenant, 0) + 1
            )
            keys = [k for k in self._sessions if k[0] == tenant]
            for k in keys:
                self._sessions[k].released = True
                self._retire(self._sessions[k])
                del self._sessions[k]
            for z in self._zombies:
                if z.tenant == tenant:
                    z.released = True
                    if z.spec_memo is not None:
                        if self.spec is not None:
                            self.spec.poison_session(z)
                        else:
                            z.spec_memo = None
            self.released += len(keys)
            return len(keys)

    def discard(self, key: SessionKey, sess: ClusterSession) -> None:
        """Drop ONE just-adopted session from the hot tier — the
        restore-vs-release race unwind (daemon._checkout_or_restore).
        Only the exact ``sess`` is swept: a fresh session registered
        under the same key while the restore was in flight must
        survive. Nothing is counted as a client-issued release — no
        generation bump, no ``released`` fold — but the session is
        marked ``released`` so its continuous spill cannot resurrect
        the forgotten state to disk."""
        with self._lock:
            sess.released = True
            if self._sessions.get(key) is sess:
                self._retire(sess)
                del self._sessions[key]

    def release_gen(self, tenant: str) -> int:
        """How many times ``tenant`` has been released — the restore
        path snapshots this before reading a warm record and drops the
        restored session when it moved underneath."""
        with self._lock:
            return self._release_gens.get(tenant, 0)

    def sweep(self, now: Optional[float] = None) -> int:
        """Expire idle sessions (demoting them to the warm tier when
        one is attached); called from the daemon's accept-loop tick.
        Returns how many expired."""
        if self.idle_s <= 0:
            return 0
        t = time.monotonic() if now is None else now
        with self._lock:
            expired = [
                k for k, s in self._sessions.items()
                if not s.in_use and t - s.last_used > self.idle_s
            ]
            for k in expired:
                self._spill_locked(k, self._sessions[k])
                self._retire(self._sessions[k])
                del self._sessions[k]
            self.expired_idle += len(expired)
            return len(expired)

    def flush_spill(self) -> int:
        """The shutdown flush: spill every idle resident session (the
        daemon calls this after its dispatchers drained, so in-use
        sessions are stragglers of crashed connections — skipped, the
        continuous spill already persisted their last clean state).
        Sessions STAY hot; only the disk copy is refreshed. Returns
        how many records were written."""
        if self.spill is None:
            return 0
        with self._lock:
            flushed = 0
            for k, s in self._sessions.items():
                # spec-memo sessions keep their last REAL spill record
                # (see _spill_locked) — flushing the advanced state
                # would break the next restore's digest match
                if (
                    not s.in_use
                    and s.spec_memo is None
                    and self.spill.spill(k, s)
                ):
                    flushed += 1
            return flushed

    def stats_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant footprint across BOTH tiers (hot session count +
        approx bytes, warm record count + bytes), summed across flag
        signatures — the scrape's ``tenants`` block reads session
        attribution through this. The warm half is the demotion-
        accounting fix: a tenant whose sessions were all demoted keeps
        its byte attribution visible (the top-tenants table shows a
        hot/warm tier column) instead of silently vanishing, while its
        delta-hit/latency counters live on in the label families."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (tenant, _sig), s in self._sessions.items():
                e = out.setdefault(tenant, {
                    "sessions": 0, "bytes": 0,
                    "warm_sessions": 0, "warm_bytes": 0,
                })
                e["sessions"] += 1
                e["bytes"] += s.approx_bytes
        if self.spill is not None:
            for tenant, w in self.spill.stats_by_tenant().items():
                e = out.setdefault(tenant, {
                    "sessions": 0, "bytes": 0,
                    "warm_sessions": 0, "warm_bytes": 0,
                })
                e["warm_sessions"] += w["warm_sessions"]
                e["warm_bytes"] += w["warm_bytes"]
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "count": len(self._sessions),
                "bytes": sum(
                    s.approx_bytes for s in self._sessions.values()
                ),
                "cap": self.cap,
                "registered": self.registered,
                "delta_hits": self.delta_hits,
                "resyncs_rows": self.resyncs_rows,
                "resyncs_full": self.resyncs_full,
                "released": self.released,
                "evicted_lru": self.evicted_lru,
                "expired_idle": self.expired_idle,
            }


class PlanSessionContext:
    """The per-request seam handed to ``cli.run(session=...)`` AND
    installed as the convergence mutation tap.

    - ``kind`` — ``"register"`` (parse + snapshot), ``"delta"``
      (resident fast path: :attr:`resident_pl` set, parse skipped) or
      ``"rows"`` (rebuild from the patched raw shadow).
    - :meth:`on_parsed` — called by the CLI right after a successful
      parse, before settle mutates anything.
    - :meth:`change` — the mutation tap target.
    """

    def __init__(
        self,
        kind: str,
        session: ClusterSession,
        resident_pl: Optional[PartitionList] = None,
        restored: bool = False,
    ) -> None:
        # kind: "register" (parse+snapshot) | "delta" (resident fast
        # path) | "rebuild" (digest matched but the settled list is
        # stale — universe_dirty, or the session was just restored
        # from a warm spill record and has no settled list yet — so
        # re-derive it from the raw shadow) | "rows" (client-shipped
        # row patches applied, then rebuild)
        self.kind = kind
        self.session = session
        self.resident_pl = resident_pl
        # this request re-homed the session from the warm tier (the
        # daemon attributes it serve.restore_hit)
        self.restored = restored
        self.snapshotted = False
        # this request's mirrored-mutation log, for probe-move reverts
        self._log: List[Tuple[int, List[int]]] = []
        self._unemitted = 0

    def resident(self) -> Optional[PartitionList]:
        """The list the CLI should plan on instead of parsing input —
        None for ``register`` (the CLI parses, then snapshots via
        :meth:`on_parsed`). The ``rows``/``rebuild`` paths rebuild
        lazily HERE so the O(P) copy lands inside the CLI's parse span
        (honest phase attribution) on the request thread."""
        if self.kind == "delta":
            return self.resident_pl
        if self.kind in ("rows", "rebuild"):
            if self.resident_pl is None:
                self.resident_pl = self.session.rebuild_pl()
            return self.resident_pl
        return None

    def on_parsed(self, pl: PartitionList) -> None:
        if self.kind == "register":
            self.session.snapshot_from(pl)
            self.snapshotted = True

    def change(self, part: Partition) -> None:
        # per-applied-move preemption seam: a speculative run aborts
        # here (one getattr for every real request — see
        # serve/speculate.py maybe_abort_dispatch)
        speculate.maybe_abort_dispatch()
        rec = self.session.change(part)
        if rec is not None:
            self._log.append(rec)

    def mark_last_unemitted(self, k: int) -> None:
        """The CLI's complete-partition break: the last ``k`` applied
        moves will NOT reach the plan (the probe move and any
        applied-after peers). Only RECORDED here — the actual revert
        runs in :meth:`apply_unemitted_reverts`, AFTER ``cli.run`` has
        written its output: an emitted entry can alias the probe
        partition (the reference's slice aliasing), so reverting
        before the write would change the emitted bytes."""
        if k > 0:
            self._unemitted += k

    def apply_unemitted_reverts(self) -> None:
        """Undo the recorded unemitted applies (daemon-side, post-run,
        pre-``finish``) so the session still predicts the client's
        next read — the cluster only ever sees the emitted plan."""
        k = self._unemitted
        self._unemitted = 0
        if k <= 0:
            return
        if k > len(self._log):
            # fewer mirrored mutations than unemitted applies: some
            # mutation escaped the tap — prediction is untrustworthy
            self.session.digest = None
            return
        for i, old in reversed(self._log[-k:]):
            self.session.revert_change(i, old)
        del self._log[-k:]

    @contextmanager
    def activate(self) -> Iterator[None]:
        """Install this session on the calling request thread: its
        trusted-delta row cache (overriding any lane cache) and the
        convergence mutation tap. Always uninstalled on exit — daemon
        request threads are reused."""
        from kafkabalancer_tpu_torch.obs import convergence
        from kafkabalancer_tpu_torch.ops.tensorize import set_thread_row_cache

        set_thread_row_cache(self.session.row_cache)
        convergence.set_mutation_tap(self)
        try:
            yield
        finally:
            convergence.set_mutation_tap(None)
            set_thread_row_cache(None)
