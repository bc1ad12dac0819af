"""Plain NumPy judge of one served plan.

It reads the cluster file a client read and the reassignment JSON the
client printed, and works out everything else again from them, in
float64, with no code of the program:

- **format**: the document is ``{"version": 1, "partitions": [...]}``
  (``null`` for an empty plan); each entry names an input partition by
  ``topic`` and ``partition`` and gives its ``replicas``;
- **moves**: a partition moved k times appears in k entries, each with
  its final replicas (the reference CLI appends the live partition once
  per move); they agree, name known and distinct brokers, differ from the
  input in at most k positions, and without ``-allow-leader`` keep the
  leader (position 0); the plan holds at most ``-max-reassign`` entries;
- **brokers**: those the input's replicas name and those of
  ``-broker-ids`` (brokers added to the cluster hold no replica yet);
- **loads and objective**: a partition weighs its ``weight``, or 1 when
  no partition of the input has one (the upstream planner's default); the
  leader carries ``weight * (replicas + consumers)``, each follower
  ``weight``; with ``rel = load / avg - 1``
  the unbalance is the sum of ``rel**2`` over overloaded brokers and
  ``rel**2 / 2`` over the others; ``-anti-colocation=lam`` adds
  ``lam * sum(max(0, c - 1))`` over (topic, broker) replica counts ``c``;
  the planned objective may not exceed the input's;
- **convergence**: the planner stops only when no single replica move
  lowers the objective by more than ``-min-unbalance``. ``residual`` is
  the largest drop any single move would still give from the final
  state (followers move with their weight, leaders, under
  ``-allow-leader``, with the leader's). ``residual_ratio`` is it over
  ``-min-unbalance``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

ENTRY_KEYS = {"topic", "partition", "replicas", "weight", "num_replicas",
              "brokers", "num_consumers"}


class Cluster:
    """One input cluster as arrays: ``replicas [P, R]`` broker ids,
    ``weight [P]``, ``ncons [P]``, ``topic [P]`` topic index, and the
    sorted ``brokers``: the replicas' and ``extra``."""

    def __init__(self, doc: Dict[str, Any],
                 extra: Sequence[int] = ()) -> None:
        parts = doc["partitions"]
        self.keys = [(p["topic"], int(p["partition"])) for p in parts]
        self.index = {k: i for i, k in enumerate(self.keys)}
        if len(self.index) != len(self.keys):
            raise ValueError("duplicate topic+partition in the cluster")
        rf = {len(p["replicas"]) for p in parts}
        if len(rf) != 1:
            raise ValueError("the reference expects one replication factor")
        self.rf = rf.pop()
        self.replicas = np.array([p["replicas"] for p in parts], np.int64)
        weighted = {"weight" in p for p in parts}
        if len(weighted) != 1:
            raise ValueError("some partitions have a weight and some not")
        self.weight = np.array([float(p.get("weight", 1.0)) for p in parts])
        self.ncons = np.array([float(p.get("num_consumers", 0))
                               for p in parts])
        names = sorted({p["topic"] for p in parts})
        tix = {t: i for i, t in enumerate(names)}
        self.topic = np.array([tix[p["topic"]] for p in parts], np.int64)
        self.n_topics = len(names)
        self.brokers = np.unique(np.concatenate(
            [self.replicas.ravel(), np.asarray(list(extra), np.int64)]))

    @classmethod
    def from_file(cls, path: str, extra: Sequence[int] = ()) -> "Cluster":
        with open(path) as f:
            return cls(json.load(f), extra)


def planner_options(argv: Sequence[str]) -> Dict[str, Any]:
    """The options of a client's argv that the judgement depends on, read
    the way the Go ``flag`` package reads them (``-name=value``, a bare
    boolean ``-name``)."""
    opts: Dict[str, Any] = dict(allow_leader=False, min_unbalance=0.01,
                                max_reassign=1, anti_colocation=0.0,
                                min_replicas=2, broker_ids=[])
    for a in argv:
        name, _, value = a.lstrip("-").partition("=")
        if name == "allow-leader":
            opts["allow_leader"] = value.lower() not in ("false", "0")
        elif name == "min-unbalance":
            opts["min_unbalance"] = float(value)
        elif name == "max-reassign":
            opts["max_reassign"] = int(value)
        elif name == "anti-colocation":
            opts["anti_colocation"] = float(value)
        elif name == "min-replicas":
            opts["min_replicas"] = int(value)
        elif name == "broker-ids" and value != "auto":
            opts["broker_ids"] = [int(b) for b in value.split(",")]
    return opts


def broker_loads(c: Cluster, bix: np.ndarray) -> np.ndarray:
    """Per-broker load (indexed like ``c.brokers``) of an assignment given
    as broker indices ``bix [P, R]``."""
    nb = len(c.brokers)
    lead = c.weight * (bix.shape[1] + c.ncons)
    loads = np.bincount(bix[:, 0], weights=lead, minlength=nb)
    for s in range(1, bix.shape[1]):
        loads += np.bincount(bix[:, s], weights=c.weight, minlength=nb)
    return loads


def penalty(loads: np.ndarray, avg: float) -> np.ndarray:
    rel = loads / avg - 1.0
    return rel * rel * np.where(rel > 0, 1.0, 0.5)


def colo_counts(c: Cluster, bix: np.ndarray) -> np.ndarray:
    """``[n_topics, brokers]`` replica counts."""
    nb = len(c.brokers)
    flat = (c.topic[:, None] * nb + bix).ravel()
    return np.bincount(flat, minlength=c.n_topics * nb).reshape(
        c.n_topics, nb).astype(np.float64)


def objective(c: Cluster, bix: np.ndarray, lam: float) -> Tuple[float, float]:
    """``(unbalance, colocations)`` of an assignment."""
    loads = broker_loads(c, bix)
    avg = loads.sum() / len(loads)
    u = float(penalty(loads, avg).sum())
    colo = float(np.maximum(colo_counts(c, bix) - 1.0, 0.0).sum())
    return u, colo


def residual(c: Cluster, bix: np.ndarray, opts: Dict[str, Any]) -> float:
    """The largest objective drop one replica move still gives."""
    lam = float(opts["anti_colocation"])
    loads = broker_loads(c, bix)
    avg = loads.sum() / len(loads)
    F = penalty(loads, avg)
    P, R = bix.shape
    nb = len(loads)
    member = np.zeros((P, nb), bool)
    np.put_along_axis(member, bix, True, axis=1)
    counts = colo_counts(c, bix) if lam else None
    eligible = R >= opts["min_replicas"]
    if not eligible:
        return 0.0

    def best(w: np.ndarray, slots: Sequence[int]) -> float:
        # source terms per (partition, slot), target terms per (partition,
        # broker); a move's delta is their sum, target not a replica
        src = np.stack([penalty(loads[bix[:, s]] - w, avg) - F[bix[:, s]]
                        for s in slots], 1)
        tgt = penalty(loads[None, :] + w[:, None], avg) - F[None, :]
        if lam:
            ct = counts[c.topic]  # [P, nb]
            src = src - lam * np.stack(
                [ct[np.arange(P), bix[:, s]] >= 2 for s in slots], 1)
            tgt = tgt + lam * (ct >= 1)
        tgt = np.where(member, np.inf, tgt)
        return float((src.min(1) + tgt.min(1)).min())

    deltas = [best(c.weight, range(1, R))] if R > 1 else []
    if opts["allow_leader"]:
        deltas.append(best(c.weight * (R + c.ncons), [0]))
    return max(0.0, -min(deltas)) if deltas else 0.0


def check_plan(c: Cluster, text: str, opts: Dict[str, Any]) -> Dict[str, Any]:
    """Judge one plan. ``invalid`` counts the entries (and a malformed
    document) that break the format or a move rule; the rest describe the
    assignment the plan leads to."""
    out: Dict[str, Any] = dict(entries=0, invalid=0, reasons=[])

    def bad(why: str) -> None:
        out["invalid"] += 1
        if len(out["reasons"]) < 5:
            out["reasons"].append(why)

    try:
        doc = json.loads(text)
    except ValueError:
        bad("not JSON")
        return out
    if not isinstance(doc, dict) or set(doc) != {"version", "partitions"} \
            or doc["version"] != 1:
        bad("not a version-1 reassignment document")
        return out
    entries = doc["partitions"] or []
    if not isinstance(entries, list):
        bad("partitions is not a list")
        return out
    out["entries"] = len(entries)
    if len(entries) > opts["max_reassign"]:
        bad(f"{len(entries)} entries over -max-reassign")
    broker_ix = {int(b): i for i, b in enumerate(c.brokers)}
    bix = np.vectorize(broker_ix.__getitem__)(c.replicas)
    start = bix.copy()
    # a partition moved k times appears k times, each entry with its final
    # replicas (the reference CLI appends the live partition per move)
    seen: Dict[int, Tuple[List[int], int]] = {}
    for e in entries:
        if not isinstance(e, dict) or not set(e) <= ENTRY_KEYS:
            bad("entry with unknown keys")
            continue
        p = c.index.get((e.get("topic"), e.get("partition")))
        reps = e.get("replicas")
        if p is None or not isinstance(reps, list) or len(reps) != c.rf:
            bad(f"entry {e.get('topic')}/{e.get('partition')}: no such "
                "partition or wrong replica count")
            continue
        if any(not isinstance(b, int) or b not in broker_ix for b in reps) \
                or len(set(reps)) != len(reps):
            bad(f"entry {e['topic']}/{e['partition']}: unknown or repeated "
                "broker")
            continue
        if "weight" in e and float(e["weight"]) != c.weight[p]:
            bad(f"entry {e['topic']}/{e['partition']}: weight changed")
            continue
        if p in seen and seen[p][0] != reps:
            bad(f"entry {e['topic']}/{e['partition']}: entries disagree")
            continue
        seen[p] = (reps, seen[p][1] + 1 if p in seen else 1)
    for p, (reps, k) in seen.items():
        new = np.array([broker_ix[b] for b in reps])
        key = f"{c.keys[p][0]}/{c.keys[p][1]}"
        if int((new != start[p]).sum()) > k:
            bad(f"entry {key}: more replicas changed than moves")
        elif new[0] != start[p][0] and not opts["allow_leader"]:
            bad(f"entry {key}: leader moved")
        else:
            bix[p] = new
    lam = float(opts["anti_colocation"])
    u0, colo0 = objective(c, start, lam)
    u1, colo1 = objective(c, bix, lam)
    res = residual(c, bix, opts)
    out.update(
        unbalance_before=u0, unbalance_after=u1,
        colocations_before=colo0, colocations_after=colo1,
        objective_before=u0 + lam * colo0,
        objective_after=u1 + lam * colo1,
        residual=res,
        residual_ratio=res / float(opts["min_unbalance"]),
        moved=int((bix != start).any(1).sum()),
    )
    return out


def truncate_plan(text: str, keep: float) -> str:
    """The control's plan: a session stopped early. The partitions whose
    last move falls in the first ``keep`` share of the entries keep all
    their entries; the others are left as they were."""
    doc = json.loads(text)
    parts: Optional[List[Any]] = doc["partitions"]
    if parts:
        cut = int(len(parts) * keep)
        last = {(e["topic"], e["partition"]): i for i, e in enumerate(parts)}
        kept = [e for e in parts if last[(e["topic"], e["partition"])] < cut]
        doc["partitions"] = kept or None
    return json.dumps(doc, separators=(",", ":"))
