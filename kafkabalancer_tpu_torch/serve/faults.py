"""Fault injection for the serving layer — the chaos seam.

The overload/fault-tolerance layer (serve/admission.py, the lane health
monitor in serve/lanes.py, the client's backoff ladder) exists for
failure modes that never occur on a healthy dev box: a lane worker
dying mid-batch, a dispatch wedging, a peer vanishing mid-frame, a
device transfer failing. This module makes those failures INJECTABLE so
the failure-path tests can exercise the whole layer closed-loop, with
plan-byte parity asserted on every answered request.

**Inert by default, by construction.** The seam is armed ONLY by the
daemon's ``-serve-faults`` flag (or ``$KAFKABALANCER_TPU_TORCH_FAULTS`` when
the flag is empty). Unarmed, every :func:`fire`/:func:`should` call is
one module-global ``is None`` check — the hot path carries no schedule,
no lock, no branch beyond that (pinned by
tests/test_torch_serve.py).

**Spec grammar** (deterministic — a seeded chaos run replays exactly)::

    site@n1,n2,...[:arg][;site@...]

Each ``n`` is the 1-based occurrence index of that SITE (every
``fire(site)`` call increments the site's counter; matching indexes
act). ``arg`` is a site-specific float (currently: the
``dispatch_delay`` sleep in seconds, default 0.05).

Sites (where the daemon calls in):

- ``lane_crash``     — a lane worker pop raises :class:`LaneCrash`
  (a ``BaseException``: it ESCAPES the worker's ``except Exception``
  nets exactly like a real thread death, so the health monitor — not a
  catch-all — must recover);
- ``dispatch_delay`` — a plan dispatch sleeps ``arg`` seconds before
  running (a wedged-lane simulacrum the watchdog can observe);
- ``socket_drop``    — the daemon closes the connection INSTEAD of
  writing a plan response (mid-frame peer death from the client's view;
  the caller checks :func:`should` and acts);
- ``transfer_fail``  — lane-context entry raises :class:`FaultError`
  (a failed device transfer/pin: the request crashes server-side and is
  answered with a structured error, never a wrong plan);
- ``spill_write_fail`` — a warm-tier session spill (serve/spill.py)
  raises :class:`FaultError` mid-write, like a full disk: the hot
  session is untouched, the record is simply not persisted
  (``paging.write_failures`` counts it);
- ``spill_corrupt``  — the spill write lands a BIT-FLIPPED record on
  disk (flipped after the checksum was computed, like media
  corruption); the later restore must detect it, prune, count
  ``paging.corrupt_drops``, and answer the request cold-but-correct.
  Acts through :func:`should` (the writer performs the flip);
- ``restore_delay``  — a warm-tier restore sleeps ``arg`` seconds
  before reading the record (a slow disk on the recovery path; the
  client's progress probes must ride it out, not misread it as a
  wedge).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

SITES = (
    "lane_crash", "dispatch_delay", "socket_drop", "transfer_fail",
    "spill_write_fail", "spill_corrupt", "restore_delay",
)

# the dispatch_delay default sleep when the spec names no arg
DEFAULT_DELAY_S = 0.05


class FaultError(RuntimeError):
    """An injected request-scoped fault (device transfer, dispatch)."""


class LaneCrash(BaseException):
    """An injected lane-worker death. Deliberately a BaseException: the
    lane worker's ``except Exception`` survival nets must NOT absorb it
    — the point is to kill the worker thread the way a real interpreter
    -level failure would, and prove the health monitor recovers."""


class FaultPlan:
    """One parsed ``-serve-faults`` schedule plus its firing state."""

    def __init__(
        self, schedule: Dict[str, Tuple[List[int], float]], spec: str
    ) -> None:
        self._lock = threading.Lock()
        # site -> (sorted occurrence indexes, arg)
        self._schedule = schedule
        self._counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []
        self.spec = spec

    def _hit(self, site: str) -> Optional[float]:
        """Count one occurrence of ``site``; the site arg when this
        occurrence is scheduled to act, else None."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            sched = self._schedule.get(site)
            if sched is None or n not in sched[0]:
                return None
            self.fired.append((site, n))
            return sched[1]

    def fired_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for site, _n in self.fired:
                out[site] = out.get(site, 0) + 1
            return out


def parse_spec(spec: str) -> FaultPlan:
    """Parse one spec string (module docstring grammar); raises
    ``ValueError`` on an unknown site or malformed entry — a chaos run
    with a typo'd schedule must refuse loudly, not run un-chaos'd."""
    schedule: Dict[str, Tuple[List[int], float]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"fault spec entry {part!r}: expected site@n[,n...]")
        site, rest = part.split("@", 1)
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {', '.join(SITES)})"
            )
        arg = DEFAULT_DELAY_S
        if ":" in rest:
            rest, arg_s = rest.rsplit(":", 1)
            arg = float(arg_s)
        try:
            idxs = sorted(int(n) for n in rest.split(",") if n.strip())
        except ValueError as exc:
            raise ValueError(f"fault spec entry {part!r}: {exc}") from None
        if not idxs or idxs[0] < 1:
            raise ValueError(
                f"fault spec entry {part!r}: occurrence indexes are 1-based"
            )
        schedule[site] = (idxs, arg)
    return FaultPlan(schedule, spec)


# the one module global the hot path reads; None == inert
_PLAN: Optional[FaultPlan] = None


def arm(spec: str) -> FaultPlan:
    """Install a schedule (daemon startup, under ``-serve-faults``)."""
    global _PLAN
    plan = parse_spec(spec)
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str) -> None:
    """The injection point: no-op unless armed AND this occurrence of
    ``site`` is scheduled — then raise/delay per the site contract."""
    plan = _PLAN
    if plan is None:
        return
    arg = plan._hit(site)
    if arg is None:
        return
    if site == "lane_crash":
        raise LaneCrash("injected lane crash (occurrence scheduled)")
    if site in ("dispatch_delay", "restore_delay"):
        import time

        time.sleep(arg)
        return
    if site == "transfer_fail":
        raise FaultError("injected device-transfer failure")
    if site == "spill_write_fail":
        raise FaultError("injected spill write failure")
    # socket_drop/spill_corrupt act through should(); reaching here
    # means a caller mis-used fire() — act as a request fault, not pass
    raise FaultError(f"injected fault at {site}")


def should(site: str) -> bool:
    """Non-raising twin of :func:`fire` for sites where the CALLER
    performs the fault (``socket_drop``: the connection loop closes the
    socket instead of replying)."""
    plan = _PLAN
    if plan is None:
        return False
    return plan._hit(site) is not None
