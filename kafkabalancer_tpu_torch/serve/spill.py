"""The warm session tier: durable, bounded spill of resident sessions.

The hot tier (serve/sessions.py ``SessionStore``) is LRU-capped at a
few dozen residents; before this module, eviction, idle expiry, and any
daemon restart simply discarded a tenant's session — the whole fleet
then re-paid the cold path (full cluster transfer + parse + tensorize)
exactly when the daemon was most fragile. The warm tier is the
paging argument applied to session state: a demoted session
spills to disk as one versioned, checksummed record
(serve/state.py ``pack_spill_record``), and a later ``plan-delta``
whose digest matches the spilled state restores it WITHOUT the client
re-sending the cluster.

Durability model:

- **continuous spill** — after every clean session request the daemon
  re-spills the session (skipped when the digest has not moved since
  the last write), so a SIGKILL loses at most the in-flight request;
- **shutdown flush** — idle timeout, SIGTERM and the ``shutdown`` op
  flush every idle resident before exit;
- **crash-safe writes** — records are written tmp + rename (atomic on
  POSIX), and the reader validates magic/format/platform/checksum
  before trusting a byte: a torn, truncated, bit-flipped or foreign
  record is PRUNED and counted (``corrupt_drops``), never restored —
  the sessions' "never a wrong plan" invariant extended to disk;
- **single writer** — the spill directory carries a pidfile; a second
  live daemon is refused at startup (the socket-takeover rules),
  while a dead owner's records are ADOPTED (that is the SIGKILL
  recovery) and its ``*.tmp`` write orphans swept.

Accounting is conservation-exact, scraped as the ``paging`` block of
``serve-stats/8``::

    spills + adopted == restores + corrupt_drops + evictions
                        + warm_entries

Every record that ever entered the warm tier (written this lifetime,
or adopted from a dead daemon at startup) is either still resident
(``warm_entries``), restored to hot, dropped as corrupt, or evicted
(LRU byte-budget sweep, replaced by a newer spill of the same session,
or released with its tenant). ``write_failures`` counts spill attempts
that never produced a record and sits outside the identity.

Nothing here imports torch or numpy; the fault seam (serve/faults.py
``spill_write_fail`` / ``spill_corrupt`` / ``restore_delay``) is inert
unless the daemon armed it.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from kafkabalancer_tpu_torch.serve import faults
from kafkabalancer_tpu_torch.serve import state as sstate

SessionKey = Tuple[str, str]

SPILL_SUFFIX = ".kbsp"
PIDFILE_NAME = "_spill.pid"
DEFAULT_WARM_CAP_MB = 256.0


def pid_alive(pid: int) -> bool:
    """Is ``pid`` a live process? (signal 0 probe; a process we may
    not signal still counts as alive). A ZOMBIE is dead for our
    purposes — a SIGKILL'd daemon whose parent never reaped it
    (containers without an init reaper) still answers the signal
    probe but cannot own a socket or a spill dir, and must not block
    a restart."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            # field 3, after the parenthesized comm (which may itself
            # contain spaces/parens): parse from the LAST ')'
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        return True  # no procfs: the signal probe's verdict stands


def pid_looks_like_daemon(pid: int) -> bool:
    """Does ``pid``'s command line look like one of OUR daemons?
    Guards the takeover refusal against PID RECYCLING: a SIGKILL'd
    daemon's recorded pid can be reborn as an unrelated process, and
    refusing forever over a stranger would re-create the
    manual-cleanup failure mode this preflight exists to remove.
    Unreadable cmdline (no procfs, permissions) says True — refusing
    when unsure beats hijacking a live daemon."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmd = f.read()
    except OSError:
        return True
    return b"kafkabalancer" in cmd or b"-serve" in cmd


def record_name(key: SessionKey) -> str:
    """The record filename for one ``(tenant, flags-signature)`` —
    a content hash, so arbitrary tenant strings (paths, unicode)
    cannot escape the directory or collide on case-folding."""
    h = hashlib.sha256()
    tenant, sig = key
    t = tenant.encode("utf-8")
    h.update(len(t).to_bytes(4, "big"))
    h.update(t)
    h.update(sig.encode("utf-8"))
    return h.hexdigest() + SPILL_SUFFIX


class SpillStore:
    """The on-disk warm tier: one record per spilled session, an
    in-memory index for byte accounting, and the conservation-exact
    counter set the ``paging`` scrape block reports. Thread-safe; the
    file I/O itself runs outside any lock the dispatcher holds."""

    def __init__(
        self,
        directory: str,
        cap_mb: float = DEFAULT_WARM_CAP_MB,
        log: Optional[Any] = None,
    ) -> None:
        self.dir = directory
        self.cap_bytes = max(0, int(cap_mb * (1 << 20)))
        self._log = log or (lambda _m: None)
        self._lock = threading.Lock()
        # key -> {"bytes": int, "tenant": str, "seq": int} — seq is a
        # monotone touch counter (the LRU axis; mtime granularity is
        # too coarse for sub-second churn)
        self._index: Dict[SessionKey, Dict[str, Any]] = {}
        # running byte total of the index — the cap sweep and stats
        # must not re-sum a 10^5-entry index on every request's
        # continuous spill
        self._warm_bytes = 0
        self._seq = 0
        # the digest last written per key: the continuous spill skips
        # a re-write when the session state has not moved — and a
        # chaos-corrupted record is not silently healed by the next
        # no-op spill of the same digest
        self._last_digest: Dict[SessionKey, str] = {}
        # records popped from the index whose restore is still in
        # flight (disk read + validation): counted as resident by
        # stats() so the conservation identity holds at EVERY instant
        # a scrape can observe, not just between requests
        self._loading = 0
        self.spills = 0
        self.adopted = 0
        self.restores = 0
        self.restore_hits = 0
        self.corrupt_drops = 0
        self.evictions = 0
        self.write_failures = 0

    # -- lifecycle -------------------------------------------------------
    def _pidfile(self) -> str:
        return os.path.join(self.dir, PIDFILE_NAME)

    def open(self) -> Optional[str]:
        """Claim the spill directory: None on success (records from a
        dead previous owner adopted, ``*.tmp`` write orphans swept),
        an error string when a LIVE daemon already owns it — two
        writers would corrupt each other's warm tier, so the refusal
        mirrors the socket-takeover rules exactly."""
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as exc:
            return f"cannot create spill dir {self.dir}: {exc}"
        owner: Optional[int] = None
        try:
            with open(self._pidfile()) as f:
                owner = int(f.read().strip())
        except (OSError, ValueError):
            owner = None
        if (
            owner is not None
            and owner != os.getpid()
            and pid_alive(owner)
            and pid_looks_like_daemon(owner)
        ):
            return (
                f"spill dir {self.dir} is owned by live daemon pid "
                f"{owner}; refusing to share it (kill the process or "
                f"remove {self._pidfile()} first)"
            )
        try:
            with open(self._pidfile(), "w") as f:
                f.write(f"{os.getpid()}\n")
        except OSError as exc:
            return f"cannot write spill pidfile in {self.dir}: {exc}"
        swept = 0
        adopted = 0
        pruned = 0
        try:
            names = sorted(os.listdir(self.dir))
        except OSError as exc:
            return f"cannot list spill dir {self.dir}: {exc}"
        for name in names:
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                # a write the dead owner never completed: the rename
                # never happened, so no reader can have trusted it
                try:
                    os.unlink(path)
                    swept += 1
                except OSError:
                    pass
                continue
            if not name.endswith(SPILL_SUFFIX):
                continue
            # index by header only (tenant + size); the checksum pass
            # runs at restore time — an adopted record that later
            # fails validation is counted corrupt_drops THERE, keeping
            # the conservation identity exact either way
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    head = f.read(sstate._SPILL_MAX_HEADER)
                hdr = sstate.read_spill_header(head)
                tenant = str(hdr.get("tenant", ""))
                sig = str(hdr.get("sig", ""))
                if record_name((tenant, sig)) != name:
                    raise sstate.SpillCorrupt(
                        "record name does not match its identity"
                    )
            except (OSError, sstate.SpillCorrupt):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                pruned += 1
                continue
            with self._lock:
                self._seq += 1
                self._index[(tenant, sig)] = {
                    "bytes": size, "tenant": tenant, "seq": self._seq,
                }
                self._warm_bytes += size
                self.adopted += 1
                adopted += 1
        if swept or adopted or pruned:
            self._log(
                f"serve: spill dir {self.dir}: adopted {adopted} warm "
                f"record{'s' if adopted != 1 else ''}, swept {swept} "
                f"write orphan{'s' if swept != 1 else ''}, pruned "
                f"{pruned} unreadable"
            )
        self._sweep_to_cap()
        return None

    def close(self) -> None:
        """Release the directory claim (records stay — they ARE the
        durability). Only OUR claim is released: a daemon that lost a
        startup race (both wrote the pidfile, the socket bind decided
        the winner) must not delete the winner's claim and open the
        dir to a third writer."""
        try:
            with open(self._pidfile()) as f:
                if int(f.read().strip()) != os.getpid():
                    return
            os.unlink(self._pidfile())
        except (OSError, ValueError):
            pass

    # -- the write path --------------------------------------------------
    def spill(self, key: SessionKey, sess: Any) -> bool:
        """Write one session's raw rows as a warm record; False when
        the session is unspillable (poisoned prediction, empty) or the
        write failed. An overwrite of an existing key counts the
        replaced record as an eviction, so the conservation identity
        stays exact under the continuous spill."""
        digest = getattr(sess, "digest", None)
        raw = getattr(sess, "raw", None)
        if digest is None or not raw:
            return False  # nothing trustworthy to persist
        if getattr(sess, "released", False):
            # an explicitly released session (SessionStore.release) —
            # an in-flight request's continuous spill must not
            # resurrect state the operator just forgot
            return False
        if self._last_digest.get(key) == digest and key in self._index:
            return True  # state unchanged since the last write
        meta = {
            "tenant": key[0],
            "sig": key[1],
            "digest": digest,
            "version": getattr(sess, "version", 1),
        }
        path = os.path.join(self.dir, record_name(key))
        tmp: Optional[str] = None
        try:
            # chaos seam: a scheduled spill_write_fail dies HERE, like
            # a full disk — the hot session is untouched, the tier
            # just does not grow
            faults.fire("spill_write_fail")
            rows = [sstate.partition_fields(p) for p in raw]
            record = sstate.pack_spill_record(meta, rows)
            if faults.should("spill_corrupt"):
                # chaos seam: flip one payload byte AFTER the checksum
                # was computed — the record lands on disk plausible
                # but invalid, exactly like media corruption
                mid = len(record) // 2
                record = (
                    record[:mid]
                    + bytes([record[mid] ^ 0x40])
                    + record[mid + 1:]
                )
            # a UNIQUE tmp per write: two spills of the same key (a
            # same-tenant burst's second live session) must never
            # share a tmp file, or the rename publishes interleaved
            # bytes; the name still ends ".tmp" so a crash leaves a
            # sweepable orphan
            fd, tmp = tempfile.mkstemp(
                dir=self.dir, prefix=record_name(key) + ".",
                suffix=".tmp",
            )
            with os.fdopen(fd, "w+b") as f:
                f.write(record)
            with self._lock:
                # publish + index as ONE step so the record on disk
                # and its index entry always describe the same bytes
                # (and load()'s locked unlink check stays race-free)
                os.replace(tmp, path)
                tmp = None
                self._seq += 1
                prev = self._index.get(key)
                if prev is not None:
                    # the replaced record left the tier
                    self.evictions += 1
                    self._warm_bytes -= int(prev["bytes"])
                self._index[key] = {
                    "bytes": len(record), "tenant": key[0],
                    "seq": self._seq,
                }
                self._warm_bytes += len(record)
                self._last_digest[key] = digest
                self.spills += 1
        except Exception as exc:
            # a failed spill only ever costs durability, never the
            # answer — disk errors, the armed spill_write_fail fault,
            # AND codec bounds (struct.error on a >u16 field count,
            # encoding errors) all land here as a counted write
            # failure instead of escaping into the request path
            with self._lock:
                self.write_failures += 1
            self._log(f"serve: spill write failed for {key[0]!r}: {exc}")
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return False
        self._sweep_to_cap()
        if getattr(sess, "released", False):
            # the tenant was released while this write was in flight
            # (the entry check above passed before the hot sweep
            # marked the session): unwind the record. Paired with the
            # release op's second warm sweep, every interleaving ends
            # with the forgotten state off disk
            self.release(key[0])
            return False
        return True

    # -- the read path ---------------------------------------------------
    def load(
        self, key: SessionKey
    ) -> Optional[Tuple[Dict[str, Any], List[sstate.RowFields]]]:
        """Consume one warm record: ``(header, rows)`` on a validated
        read, None on absence OR any corruption (the record is pruned
        and counted — a cold miss, never a wrong restore). A restored
        record leaves the tier either way: success re-homes the state
        in the hot store, failure destroys it."""
        with self._lock:
            entry = self._index.pop(key, None)
            self._last_digest.pop(key, None)
            if entry is not None:
                self._warm_bytes -= int(entry["bytes"])
                self._loading += 1
        if entry is None:
            return None
        path = os.path.join(self.dir, record_name(key))
        try:
            # chaos seam: a scheduled restore_delay sleeps HERE — a
            # slow disk on the restore path, observable by the
            # client's progress probes (requests_inflight covers the
            # session op)
            faults.fire("restore_delay")
            with open(path, "rb") as f:
                buf = f.read()
            hdr, rows = sstate.unpack_spill_record(buf)
        except (OSError, sstate.SpillCorrupt) as exc:
            with self._lock:
                self.corrupt_drops += 1
                self._loading -= 1
            self._unlink_unless_reindexed(key, path)
            self._log(
                f"serve: warm record for {key[0]!r} dropped: {exc}"
            )
            return None
        except BaseException:
            # anything else (an unexpectedly raising fault site, a
            # worker shutdown) must not leak the in-flight marker —
            # the identity would be off by one forever
            with self._lock:
                self._loading -= 1
            raise
        self._unlink_unless_reindexed(key, path)
        with self._lock:
            self.restores += 1
            self._loading -= 1
        return hdr, rows

    def _unlink_unless_reindexed(self, key: SessionKey, path: str) -> None:
        """Remove a consumed (or corrupt) record's file — unless a
        concurrent spill re-published the key while the read was in
        flight (the ``restore_delay`` seam widens exactly this
        window), in which case the path now holds THAT record and must
        stay. Runs under the store lock, which also serializes
        spill()'s publish+index step, so the check cannot go stale."""
        with self._lock:
            if key in self._index:
                return
            try:
                os.unlink(path)
            except OSError:
                pass

    def note_restore_hit(self) -> None:
        """The restored session answered a digest-matching request
        directly (no resync, no re-register) — the tier's headline
        acceptance counter."""
        with self._lock:
            self.restore_hits += 1

    # -- eviction / release ----------------------------------------------
    def _sweep_to_cap(self) -> None:
        """LRU-sweep the tier down to the byte budget (oldest touch
        first)."""
        if self.cap_bytes <= 0:
            return
        victims: List[SessionKey] = []
        with self._lock:
            if self._warm_bytes <= self.cap_bytes:
                return
            total = self._warm_bytes
            for key, e in sorted(
                self._index.items(), key=lambda kv: kv[1]["seq"]
            ):
                if total <= self.cap_bytes:
                    break
                victims.append(key)
                total -= int(e["bytes"])
            for key in victims:
                self._warm_bytes -= int(self._index[key]["bytes"])
                del self._index[key]
                self._last_digest.pop(key, None)
                self.evictions += 1
        for key in victims:
            self._unlink_unless_reindexed(
                key, os.path.join(self.dir, record_name(key))
            )
        if victims:
            self._log(
                f"serve: warm tier swept {len(victims)} record"
                f"{'s' if len(victims) != 1 else ''} past the "
                f"{self.cap_bytes} byte cap"
            )

    def release(self, tenant: str) -> int:
        """Drop every warm record of ``tenant`` (the ``release`` op's
        warm half — an explicit forget must cover both tiers)."""
        with self._lock:
            keys = [k for k in self._index if k[0] == tenant]
            for k in keys:
                self._warm_bytes -= int(self._index[k]["bytes"])
                del self._index[k]
                self._last_digest.pop(k, None)
                self.evictions += 1
        for k in keys:
            self._unlink_unless_reindexed(
                k, os.path.join(self.dir, record_name(k))
            )
        return len(keys)

    # -- accounting ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The scrape's ``paging`` block (serve-stats/8)."""
        with self._lock:
            return {
                "enabled": True,
                "dir": self.dir,
                "cap_bytes": self.cap_bytes,
                "spills": self.spills,
                "adopted": self.adopted,
                "restores": self.restores,
                "restore_hits": self.restore_hits,
                "corrupt_drops": self.corrupt_drops,
                "evictions": self.evictions,
                "write_failures": self.write_failures,
                # an in-flight restore (index entry popped, outcome
                # not yet counted) is still resident for the identity
                "warm_entries": len(self._index) + self._loading,
                "warm_bytes": self._warm_bytes,
            }

    @staticmethod
    def disabled_stats() -> Dict[str, Any]:
        """The same block shape with the tier off — the scrape schema
        must not change key sets with configuration."""
        return {
            "enabled": False, "dir": "", "cap_bytes": 0,
            "spills": 0, "adopted": 0, "restores": 0, "restore_hits": 0,
            "corrupt_drops": 0, "evictions": 0, "write_failures": 0,
            "warm_entries": 0, "warm_bytes": 0,
        }

    def stats_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant warm footprint — the demotion-accounting fix:
        a tenant whose sessions were all demoted to warm still shows
        its byte attribution in the top-tenants table instead of
        silently vanishing."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (tenant, _sig), e in self._index.items():
                rec = out.setdefault(
                    tenant, {"warm_sessions": 0, "warm_bytes": 0}
                )
                rec["warm_sessions"] += 1
                rec["warm_bytes"] += int(e["bytes"])
            return out
