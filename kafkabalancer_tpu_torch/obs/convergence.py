"""Solver convergence telemetry — the ``-explain`` recorder.

Span telemetry makes the *process* observable; the solver itself
stays a black box without this module: an operator sees that a plan
converged, not WHY each move was chosen, how the unbalance trajectory
descended, or which constraints masked which candidates. This module is
the audit trail the paper's deployment model demands — an outer loop
trusting one emitted move per invocation (PAPER.md §0) can now ask the
planner to show its work.

Design constraints, in order:

1. **Near-zero overhead inside the converge wall.** The recorder's
   in-plan feeds are O(1) appends (``record_change`` stores the old/new
   replica lists the solver already has in hand) plus one gated numpy
   pass per chunk round for the candidate-space stats. EVERYTHING
   expensive — the load/unbalance trajectory replay, the top-k
   alternative ranking, the stop-reason refinement — happens in
   :meth:`ConvergenceRecorder.finalize`, which the CLI calls *after*
   the plan is written. With no recorder installed every feed site is a
   single thread-local read.
2. **No plan-byte changes.** Feeds only read solver state; the document
   rides after the plan (``-explain -``) or in its own file.
3. **Oracle-exact scores.** The per-move ``unbalance_before/after``
   values come from a replay that mirrors the session's own load
   semantics — per-partition contributions subtracted/added in replica-
   slot order (leader premium ``w·(len+ncons)`` on slot 0,
   utils.go:96-101), broker-table membership dynamic exactly like
   ``getBrokerLoad``'s map — each step scored by the scalar oracle's
   :func:`~kafkabalancer_tpu_torch.balancer.costmodel.get_unbalance_bl`. The
   differential pin (tests/test_explain.py) replays the emitted moves
   independently and requires bit-exact agreement.
4. **Jax-free.** Like everything under ``obs/``; numpy is imported
   lazily inside finalize/feed bodies so the forwarding client's
   no-numpy pin survives the flag merely being *parsed*.

The module also owns the always-on **outcome slot** (thread-local, no
recorder needed): the planning steps note WHY they declined to move
(``already_balanced`` / ``below_threshold`` / ``no_feasible_candidate``
/ ``budget_exhausted``), and the CLI surfaces it as the
``plan.no_move_reason`` / ``plan.stop_reason`` gauges in ``-stats`` and
``-metrics-json`` — a below-threshold exit is no longer
indistinguishable from a converged one in the metrics line.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

EXPLAIN_SCHEMA_VERSION = 1
EXPLAIN_SCHEMA = f"kafkabalancer-tpu.explain/{EXPLAIN_SCHEMA_VERSION}"

# top-k alternative moves reported per emitted move
EXPLAIN_TOPK = 3

# total candidate-cells budget for the finalize-time alternative ranking:
# each move costs ~P·B cells, so at the 10000x100 flagship the first
# handful of moves carry alternatives and the rest are marked truncated
# (no silent caps: the document records coverage explicitly). Tests and
# operator-scale instances are covered in full.
ALT_CANDIDATE_BUDGET = 8_000_000

# bounded per-round samples / tie-window entries kept in the document
MAX_ROUND_SAMPLES = 64
MAX_TIE_WINDOWS = 256

# masked-candidate reason vocabulary (docs/observability.md glossary)
MASK_REASONS = (
    "min_replicas", "broker_allowlist", "replica_count", "min_unbalance",
)

_tls = threading.local()


# --- thread-local installation seam ---------------------------------------


def install(rec: "ConvergenceRecorder") -> None:
    """Install THIS thread's recorder (the CLI does this when
    ``-explain`` is set; solver feed sites look it up per call)."""
    _tls.rec = rec


def uninstall() -> None:
    _tls.rec = None


def recorder() -> "Optional[ConvergenceRecorder]":
    return getattr(_tls, "rec", None)


# --- the mutation tap ------------------------------------------------------
#
# A second, lighter thread-local hook on the SAME two emit sites the
# recorder instruments (cli._apply_replicas, scan._decode_packed): the
# planning daemon's resident cluster sessions (serve/sessions.py)
# install a tap to mirror every applied replica change into the
# session's raw-row shadow — that shadow is what predicts the client's
# next observed state. O(1) per move; None (the default) costs one
# attribute read at the emit site. Fail-safe by design: a mutation the
# tap misses makes the session's next digest comparison MISMATCH, which
# degrades to a re-sync, never to a wrong plan.


def set_mutation_tap(tap: "Optional[Any]") -> None:
    """Install (or, with None, clear) THIS thread's mutation tap — an
    object with a ``change(partition)`` method called after every
    applied replica mutation."""
    _tls.tap = tap


def mutation_tap() -> "Optional[Any]":
    return getattr(_tls, "tap", None)


# --- the always-on outcome slot -------------------------------------------


def note_outcome(reason: str, **detail: Any) -> None:
    """Record WHY planning stopped (or declined to move) on this thread.

    Always on — the cost is one small dict store — because the
    ``plan.no_move_reason`` satellite must work without ``-explain``.
    Last write wins; the CLI clears the slot per ``balance()`` call so
    the surviving note is the final decline."""
    out = {"reason": reason}
    out.update(detail)
    _tls.outcome = out


def last_outcome() -> Optional[Dict[str, Any]]:
    return getattr(_tls, "outcome", None)


def clear_outcome() -> None:
    _tls.outcome = None


# --- the recorder ----------------------------------------------------------


class ConvergenceRecorder:
    """Collects per-move provenance during one planning invocation and
    assembles the ``kafkabalancer-tpu.explain/1`` document at finalize.

    Feed sites (all gated on :func:`recorder` returning non-None):

    - ``record_change(part, old, new, origin)`` — every emitted
      assignment change (repairs, per-move steps, fused session moves);
      O(1): two small list copies.
    - ``note_round(dp, cfg, ...)`` — once per fused chunk round (and
      per tpu-solver device pass): candidate-space stats from the dense
      encoding the solver already materialized.
    - ``note_scan(...)`` / ``note_scores(...)`` — the host scan's
      masked-candidate and threshold counts (greedy path; also fired by
      the tie-window rescans).
    - ``note_tie_window(rows)`` — the tpu solver's tie-window sizes.
    """

    def __init__(
        self,
        topk: int = EXPLAIN_TOPK,
        alt_budget: int = ALT_CANDIDATE_BUDGET,
    ) -> None:
        self.topk = max(0, int(topk))
        self.alt_budget = max(0, int(alt_budget))
        self._pl: Any = None
        self._cfg: Any = None
        self._meta: Dict[str, Any] = {}
        # [partition object, old replicas, new replicas, origin, emitted]
        self._records: List[List[Any]] = []
        self._rounds: List[Dict[str, Any]] = []
        self._round_count = 0
        self._has_rounds = False
        self._scored = 0
        self._masked: Dict[str, int] = {r: 0 for r in MASK_REASONS}
        self._tie_windows: List[int] = []
        self._tie_window_count = 0

    # -- in-plan feeds (cheap by contract) -------------------------------
    def attach(self, pl: Any, cfg: Any, **meta: Any) -> None:
        """Bind the live partition list + config (the CLI calls this
        once, before planning; ``meta`` carries mode/solver/engine)."""
        self._pl = pl
        self._cfg = cfg
        self._meta = dict(meta)

    def record_change(
        self,
        part: Any,
        old: Sequence[int],
        new: Sequence[int],
        origin: str,
    ) -> None:
        """One APPLIED assignment change, captured BEFORE/AFTER apply.
        O(1) — scoring happens at finalize. Applied ≠ emitted: the
        complete-partition probe move is applied to the live list
        (reference aliasing, kafkabalancer.go:193-207) even when the
        compare failure keeps it out of the plan — the CLI flags those
        via :meth:`mark_last_unemitted` and the document reports both
        counts."""
        self._records.append(
            [part, tuple(int(b) for b in old), tuple(int(b) for b in new),
             origin, True]
        )

    def mark_last_unemitted(self, n: int) -> None:
        """Flag the last ``n`` recorded changes as applied-but-not-
        emitted (complete-partition compare failures)."""
        for rec in self._records[max(0, len(self._records) - n):]:
            rec[4] = False

    def note_round(
        self, dp: Any, cfg: Any, chunk: int = 0, engine: str = ""
    ) -> None:
        """Candidate-space stats for one device round, from the dense
        encoding (``dp``) the solver already built — one vectorized
        numpy pass over the [P, B] masks, never a device sync."""
        import numpy as np

        P = dp.np_
        nb = dp.nb
        if P == 0 or nb == 0:
            return
        nrep = dp.nrep_cur[:P].astype(np.int64)
        lead = 1 if bool(cfg.allow_leader_rebalancing) else 0
        movable = np.maximum(nrep - 1, 0) + lead * (nrep > 0)
        eligible = (
            dp.nrep_tgt[:P] >= int(cfg.min_replicas_for_rebalancing)
        )
        allowed = dp.allowed[:P, :nb]
        member = dp.member[:P, :nb]
        not_allowed = (~allowed).sum(axis=1)
        already = (allowed & member).sum(axis=1)
        open_t = nb - not_allowed - already
        m_ok = movable * eligible
        sample = {
            "chunk": int(chunk),
            "engine": str(engine),
            "scored": int((m_ok * open_t).sum()),
            "masked": {
                "min_replicas": int((movable * ~eligible).sum()) * nb,
                "broker_allowlist": int((m_ok * not_allowed).sum()),
                "replica_count": int((m_ok * already).sum()),
            },
        }
        self._has_rounds = True
        self._round_count += 1
        self._scored += sample["scored"]
        for key, v in sample["masked"].items():
            self._masked[key] += v
        if len(self._rounds) < MAX_ROUND_SAMPLES:
            self._rounds.append(sample)

    def note_scan(
        self,
        scored: int,
        masked_allowlist: int,
        masked_replica: int,
        masked_min_replicas: int,
    ) -> None:
        """The host scan's candidate accounting (greedy path). Skipped
        when device rounds already supplied the full-space numbers —
        the tie-window rescans cover only flagged rows and would
        double-count."""
        if self._has_rounds:
            return
        self._round_count += 1
        self._scored += int(scored)
        self._masked["broker_allowlist"] += int(masked_allowlist)
        self._masked["replica_count"] += int(masked_replica)
        self._masked["min_replicas"] += int(masked_min_replicas)

    def note_scores(self, improving: int, clearing: int) -> None:
        """Threshold accounting from a scored candidate set: candidates
        that improve but do not clear ``min_unbalance`` are masked by
        the threshold."""
        self._masked["min_unbalance"] += max(0, int(improving) - int(clearing))

    def note_tie_window(self, rows: int) -> None:
        self._tie_window_count += 1
        if len(self._tie_windows) < MAX_TIE_WINDOWS:
            self._tie_windows.append(int(rows))

    # -- finalize (all the real work; runs after the plan is written) ----
    def _shift(
        self,
        loads: Dict[int, float],
        counts: Dict[int, int],
        reps: Sequence[int],
        w: float,
        ncons: float,
        sign: int,
    ) -> None:
        """Apply one partition contribution to the load table, in
        replica-slot order: the leader accrues ``w·(len+ncons)``
        (utils.go:96-101), followers ``w``. This IS the replay's exact
        float-op sequence — the differential pin replicates it."""
        n = len(reps)
        for i, b in enumerate(reps):
            c = w * (n + ncons) if i == 0 else w
            loads[b] = loads.get(b, 0.0) + (sign * c)
            counts[b] = counts.get(b, 0) + sign

    def _unbalance(
        self,
        loads: Dict[int, float],
        counts: Dict[int, int],
        always: "set[int]",
    ) -> float:
        """The scalar oracle's objective over the CURRENT broker table:
        brokers holding a replica plus the configured always-in-table
        set, exactly the reference's dynamic membership
        (steps.go:150-155 / utils.go:92-105)."""
        from kafkabalancer_tpu_torch.balancer.costmodel import (
            get_bl,
            get_unbalance_bl,
        )

        live = {
            b: v for b, v in loads.items()
            if counts.get(b, 0) > 0 or b in always
        }
        return get_unbalance_bl(get_bl(live))

    def _classify_change(
        self, old: Tuple[int, ...], new: Tuple[int, ...]
    ) -> Tuple[str, int, Optional[int], Optional[int]]:
        """``(kind, slot, src, dst)`` from the replica diff: plain slot
        write, leadership swap (same set, positions exchanged), replica
        add, or replica remove."""
        so, sn = set(old), set(new)
        if len(new) > len(old):
            dst = next(iter(sn - so), None)
            slot = new.index(dst) if dst is not None else -1
            return "add", slot, None, dst
        if len(new) < len(old):
            src = next(iter(so - sn), None)
            return "remove", -1, src, None
        if so == sn and old != new:
            slot = next(i for i in range(len(old)) if old[i] != new[i])
            return "swap", slot, old[slot], new[slot]
        slot = next(
            (i for i in range(len(old)) if old[i] != new[i]), -1
        )
        if slot < 0:
            return "noop", -1, None, None
        return "move", slot, old[slot], new[slot]

    def finalize(self) -> Dict[str, Any]:
        """Assemble the explain document. Runs AFTER the plan is
        emitted — the trajectory replay, alternative ranking and stop
        classification all live here, outside the converge wall."""
        import time

        pl, cfg = self._pl, self._cfg
        parts: List[Any] = (
            list(pl.iter_partitions()) if pl is not None else []
        )
        rows: Dict[int, int] = {id(p): i for i, p in enumerate(parts)}
        always: "set[int]" = set(
            int(b) for b in (getattr(cfg, "brokers", None) or [])
        )

        # reconstruct the INITIAL assignment: unchanged partitions read
        # final==initial from the live list; changed partitions take the
        # old side of their FIRST record
        initial: Dict[int, Tuple[int, ...]] = {}
        for part, old, _new, _origin, _emitted in self._records:
            initial.setdefault(id(part), old)

        loads: Dict[int, float] = {}
        counts: Dict[int, int] = {}
        for p in parts:
            reps = initial.get(id(p), tuple(p.replicas))
            self._shift(loads, counts, reps, p.weight, p.num_consumers, 1)
        for b in always:
            loads.setdefault(b, 0.0)  # cfg zero-fill (steps.go:151-155)

        alt = None
        if self.topk > 0 and self.alt_budget > 0 and self._records:
            alt = _AlternativeRanker(
                parts, initial, loads, cfg, self.topk, self.alt_budget
            )

        u = self._unbalance(loads, counts, always)
        u_initial = u
        moves: List[Dict[str, Any]] = []
        alternatives_covered = 0
        for i, (part, old, new, origin, emitted) in enumerate(
            self._records
        ):
            kind, slot, src, dst = self._classify_change(old, new)
            alts: Optional[List[Dict[str, Any]]] = None
            if alt is not None:
                alts = alt.rank(loads, counts, always)
                if alts is not None:
                    alternatives_covered += 1
            u_before = u
            src_before = loads.get(src) if src is not None else None
            dst_before = loads.get(dst, 0.0) if dst is not None else None
            self._shift(
                loads, counts, old, part.weight, part.num_consumers, -1
            )
            self._shift(
                loads, counts, new, part.weight, part.num_consumers, 1
            )
            u = self._unbalance(loads, counts, always)
            row = rows.get(id(part), -1)
            moves.append({
                "i": i,
                "row": row,
                "topic": part.topic,
                "partition": part.partition,
                "kind": kind,
                "slot": slot,
                "origin": origin,
                "emitted": emitted,
                "src": src,
                "dst": dst,
                "src_load_before": src_before,
                "src_load_after": (
                    loads.get(src) if src is not None else None
                ),
                "dst_load_before": dst_before,
                "dst_load_after": (
                    loads.get(dst) if dst is not None else None
                ),
                "unbalance_before": u_before,
                "unbalance_after": u,
                "score_delta": u - u_before,
                "alternatives": alts,
            })
            if alt is not None:
                alt.apply(part, old, new)

        outcome = last_outcome()
        if outcome is not None and outcome.get("reason") == "converged":
            # refine a bare "converged" to already_balanced vs
            # below_threshold with a full host scan of the FINAL state —
            # deliberately here, outside the converge wall. The recorder
            # is UNINSTALLED around the scan: this diagnostic pass was
            # never part of planning and must not pollute the document's
            # candidate/threshold accounting (scan_moves feeds whatever
            # recorder is installed).
            try:
                from kafkabalancer_tpu_torch.balancer.steps import classify_no_move

                if pl is not None and cfg is not None:
                    was = recorder()
                    uninstall()
                    try:
                        outcome = classify_no_move(pl, cfg)
                    finally:
                        if was is not None:
                            install(was)
            except Exception:
                pass
        if outcome is not None:
            # internal lazy-refinement markers (balancer/steps
            # greedy_move's feasible_unknown, scan's classify_pending)
            # are CLI plumbing, never part of the document
            outcome = {
                k: v for k, v in outcome.items()
                if k not in ("feasible_unknown", "classify_pending")
            }
        no_move = outcome if not moves else None
        stop = outcome or {
            "reason": "budget_exhausted" if moves else "converged"
        }
        n_emitted = sum(1 for m in moves if m["emitted"])

        return {
            "schema": EXPLAIN_SCHEMA,
            "ts_epoch": round(time.time(), 3),
            "mode": self._meta.get("mode", ""),
            "solver": self._meta.get("solver", ""),
            "engine": self._meta.get("engine"),
            "batch": self._meta.get("batch"),
            "config": {
                "min_unbalance": float(cfg.min_unbalance),
                "min_replicas": int(cfg.min_replicas_for_rebalancing),
                "allow_leader": bool(cfg.allow_leader_rebalancing),
                "rebalance_leaders": bool(cfg.rebalance_leaders),
                "max_reassign": int(self._meta.get("max_reassign", 0)),
                "brokers": sorted(always) if always else None,
            } if cfg is not None else {},
            "unbalance_initial": u_initial,
            "unbalance_final": u,
            # applied ≥ emitted: a complete-partition probe move is
            # applied to the live list (reference aliasing) but kept
            # out of the plan when its compare fails — the replayed
            # trajectory needs it, the plan does not contain it
            "moves_applied": len(moves),
            "moves_emitted": n_emitted,
            "moves": moves,
            "rounds": {
                "count": self._round_count,
                "samples": self._rounds,
                "tie_windows": self._tie_windows,
                "tie_window_count": self._tie_window_count,
            },
            "candidates": {
                "scored": self._scored,
                "masked": dict(self._masked),
            },
            "no_move_reason": no_move,
            "stop": stop,
            "alternatives_basis": "rank1-best-source",
            "alternatives_topk": self.topk,
            "alternatives_budget": self.alt_budget,
            "alternatives_moves_covered": alternatives_covered,
            "alternatives_truncated": bool(
                self._records
            ) and alternatives_covered < len(self._records),
        }


class _AlternativeRanker:
    """Finalize-time top-k alternative ranking via rank-1 objective
    deltas (the vectorized solver's decomposition, solvers/tpu.py):
    ``Δ(p, s, t) = pen(L_s − w) − pen(L_s) + pen(L_t + w) − pen(L_t)``
    with the best source broker per partition — so each reported
    alternative is the best-delta move of its (partition, target) pair.
    Rank-1 deltas are a RANKING basis, not the oracle trajectory (the
    document labels this ``alternatives_basis``); the per-move
    ``score_delta`` values remain oracle-exact.

    Budgeted: each ranked move costs ~P·B candidate cells; past
    ``budget`` later moves carry ``alternatives: null`` and the
    document sets ``alternatives_truncated``.
    """

    def __init__(
        self,
        parts: List[Any],
        initial: Dict[int, Tuple[int, ...]],
        loads: Dict[int, float],
        cfg: Any,
        topk: int,
        budget: int,
    ) -> None:
        import numpy as np

        from kafkabalancer_tpu_torch.models.config import HOST_FLOAT_DTYPE

        self._np = np
        self._parts = parts
        self._rows = {id(p): i for i, p in enumerate(parts)}
        self.universe = np.asarray(sorted(loads), dtype=np.int64)
        self._bindex = {int(b): i for i, b in enumerate(self.universe)}
        P, B = len(parts), len(self.universe)
        self._dtype = HOST_FLOAT_DTYPE
        self.weights = np.asarray(
            [p.weight for p in parts], dtype=HOST_FLOAT_DTYPE
        )
        self.eligible = np.asarray(
            [
                p.num_replicas >= cfg.min_replicas_for_rebalancing
                for p in parts
            ],
            dtype=bool,
        )
        allowed_memo: Dict[int, Any] = {}
        self.allowed = np.zeros((P, B), dtype=bool)
        for i, p in enumerate(parts):
            key = id(p.brokers)
            row = allowed_memo.get(key)
            if row is None:
                row = np.isin(
                    self.universe,
                    np.asarray(list(p.brokers or ()), dtype=np.int64),
                )
                allowed_memo[key] = row
            self.allowed[i] = row
        self.member = np.zeros((P, B), dtype=bool)
        self.leader = np.full(P, -1, dtype=np.int64)
        self._replicas: List[List[int]] = []
        for i, p in enumerate(parts):
            reps = list(initial.get(id(p), tuple(p.replicas)))
            self._replicas.append(reps)
            for b in reps:
                j = self._bindex.get(b)
                if j is not None:
                    self.member[i, j] = True
            if reps:
                self.leader[i] = self._bindex.get(reps[0], -1)
        self.allow_leader = bool(cfg.allow_leader_rebalancing)
        self.topk = topk
        self.budget = budget
        self.spent = 0

    def rank(
        self,
        loads: Dict[int, float],
        counts: Dict[int, int],
        always: "set[int]",
    ) -> Optional[List[Dict[str, Any]]]:
        np = self._np
        P, B = self.member.shape
        cost = P * B
        if self.spent + cost > self.budget:
            return None
        self.spent += cost
        L = np.zeros(B, dtype=self._dtype)
        valid = np.zeros(B, dtype=bool)
        for b, j in self._bindex.items():
            L[j] = loads.get(b, 0.0)
            valid[j] = counts.get(b, 0) > 0 or b in always
        nb = int(valid.sum())
        if nb == 0:
            return []
        with np.errstate(divide="ignore", invalid="ignore"):
            avg = L[valid].sum() / nb

            def pen(x: Any) -> Any:
                rel = x / avg - 1.0
                sq = rel * rel
                return np.where(rel > 0, sq, sq / 2)

            pen_l = pen(L)
            w = self.weights[:, None]
            src_ok = self.member & valid[None, :]
            if not self.allow_leader:
                lead_ok = self.leader >= 0
                src_ok[lead_ok, self.leader[lead_ok]] = False
            a_mat = np.where(
                src_ok, pen(L[None, :] - w) - pen_l[None, :], np.inf
            )
            a_best = a_mat.min(axis=1)
            a_src = a_mat.argmin(axis=1)
            tgt_ok = self.allowed & ~self.member & valid[None, :]
            c_mat = np.where(
                tgt_ok, pen(L[None, :] + w) - pen_l[None, :], np.inf
            )
            delta = a_best[:, None] + c_mat
            delta = np.where(self.eligible[:, None], delta, np.inf)
        flat = delta.reshape(-1)
        k = min(self.topk, flat.shape[0])
        if k <= 0:
            return []
        idx = np.argpartition(flat, k - 1)[:k]
        idx = idx[np.argsort(flat[idx], kind="stable")]
        out: List[Dict[str, Any]] = []
        for fi in idx:
            d = float(flat[fi])
            if not np.isfinite(d):
                break
            p, t = divmod(int(fi), B)
            part = self._parts[p]
            out.append({
                "row": p,
                "topic": part.topic,
                "partition": part.partition,
                "src": int(self.universe[int(a_src[p])]),
                "dst": int(self.universe[t]),
                "delta": d,
            })
        return out

    def apply(
        self, part: Any, old: Tuple[int, ...], new: Tuple[int, ...]
    ) -> None:
        """Advance the membership state past one applied change."""
        i = self._rows.get(id(part))
        if i is None:
            return
        reps = list(new)
        self._replicas[i] = reps
        self.member[i, :] = False
        for b in reps:
            j = self._bindex.get(b)
            if j is not None:
                self.member[i, j] = True
        self.leader[i] = (
            self._bindex.get(reps[0], -1) if reps else -1
        )


# --- human rendering -------------------------------------------------------

_RENDER_MOVES = 10


def render_explain(doc: Dict[str, Any]) -> str:
    """Compact stderr rendering of an explain document: the trajectory
    headline, candidate masking, a move excerpt, and the stop/no-move
    stanza."""
    napplied = doc.get("moves_applied", 0)
    nemitted = doc.get("moves_emitted", 0)
    applied_note = (
        f" ({napplied} applied)" if napplied != nemitted else ""
    )
    lines = [
        f"-- plan explanation ({doc.get('schema')})",
        f"  unbalance: {doc.get('unbalance_initial')} -> "
        f"{doc.get('unbalance_final')} over {nemitted} "
        f"move(s){applied_note}, {doc.get('rounds', {}).get('count', 0)} "
        f"round(s)",
    ]
    cand = doc.get("candidates", {})
    masked = cand.get("masked", {})
    lines.append(
        f"  candidates: {cand.get('scored', 0)} scored; masked: "
        + ", ".join(f"{k}={masked.get(k, 0)}" for k in MASK_REASONS)
    )
    tw = doc.get("rounds", {}).get("tie_windows", [])
    if tw:
        lines.append(
            f"  tie windows: {len(tw)} (sizes {tw[:8]}"
            + ("…)" if len(tw) > 8 else ")")
        )
    for m in doc.get("moves", [])[:_RENDER_MOVES]:
        src = "-" if m.get("src") is None else m["src"]
        dst = "-" if m.get("dst") is None else m["dst"]
        alt_n = len(m.get("alternatives") or [])
        lines.append(
            f"  #{m['i']} {m['topic']}:{m['partition']} {m['kind']} "
            f"slot{m['slot']} {src}->{dst} du={m['score_delta']:.6g}"
            + ("" if m.get("emitted", True) else " [applied, not emitted]")
            + (f" ({alt_n} alternatives)" if alt_n else "")
        )
    extra = doc.get("moves_applied", 0) - _RENDER_MOVES
    if extra > 0:
        lines.append(f"  … {extra} more move(s) in the document")
    nm = doc.get("no_move_reason")
    if nm is not None:
        detail = " ".join(
            f"{k}={v}" for k, v in nm.items() if k != "reason"
        )
        lines.append(
            f"  no move emitted: {nm.get('reason')}"
            + (f" ({detail})" if detail else "")
        )
    else:
        stop = doc.get("stop", {})
        lines.append(f"  stop: {stop.get('reason', 'converged')}")
    if doc.get("alternatives_truncated"):
        lines.append(
            "  alternatives truncated: "
            f"{doc.get('alternatives_moves_covered', 0)}/"
            f"{doc.get('moves_applied', 0)} moves within the "
            f"{doc.get('alternatives_budget', 0)}-cell budget"
        )
    return "\n".join(lines) + "\n"
