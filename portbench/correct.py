"""Decides ``correct``: the window's plans against the plain reference.

Every client of the window has to exit 0. A sample of the window's plans,
drawn from the seed and always holding the plan with the most entries,
goes to ``reference/check.py`` with the cluster file its client read and
the flags it passed. The numbers compared, each with its limit:

- ``client_errors``: clients of the window that did not exit 0 or printed
  nothing (limit 0);
- ``invalid_entries``: entries of the sampled plans that break the format
  or a move rule (limit 0);
- ``objective_worse``: sampled plans whose planned objective (the
  unbalance of the final broker loads, with colocations under
  ``-anti-colocation``) is above the input's (limit 0);
- ``residual_ratio``: the largest single-move drop left after a sampled
  plan, over ``-min-unbalance`` (the configuration's limit).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence, Tuple

from portbench.load import Plan
from portbench.reference import check


def sample(plans: Sequence[Plan], seed: int, size: int) -> List[Plan]:
    ok = [p for p in plans if p.rc == 0 and p.out_bytes > 0]
    if not ok:
        return []
    longest = max(ok, key=lambda p: p.out_bytes)
    rest = [p for p in ok if p is not longest]
    random.Random(seed).shuffle(rest)
    return [longest] + rest[: max(0, size - 1)]


def judge(plans: Sequence[Plan], flags: Sequence[str], seed: int,
          size: int, limits: Dict[str, float]
          ) -> Tuple[Dict[str, Dict[str, float]], int, List[str]]:
    """``(checks, failed, notes)``: each compared number with its limit,
    the count of plans that failed, and a few lines on what failed."""
    opts = check.planner_options(flags)
    errors = [p for p in plans if p.rc != 0 or p.out_bytes == 0]
    notes = [f"client rc {p.rc} on {p.path}: {p.stderr[-300:]}"
             for p in errors[:3]]
    invalid = 0
    worse = 0
    worst = 0.0
    failed = len(errors)
    clusters: Dict[str, check.Cluster] = {}
    for p in sample(plans, seed, size):
        c = clusters.get(p.path) or check.Cluster.from_file(
            p.path, opts["broker_ids"])
        clusters[p.path] = c
        r = check.check_plan(c, p.stdout, opts)
        invalid += r["invalid"]
        ratio = r.get("residual_ratio", float("inf"))
        up = int(r.get("objective_after", float("inf"))
                 > r.get("objective_before", float("-inf")))
        worse += up
        worst = max(worst, ratio)
        if r["invalid"] or up or ratio > limits["residual_ratio"]:
            failed += 1
            notes.append(f"{p.path}: {r['invalid']} invalid "
                         f"{r['reasons']}, objective "
                         f"{r.get('objective_before')} -> "
                         f"{r.get('objective_after')}, residual ratio {ratio}")
    checks = {
        "client_errors": {"value": len(errors), "limit": 0},
        "invalid_entries": {"value": invalid, "limit": 0},
        "objective_worse": {"value": worse,
                            "limit": limits["objective_worse"]},
        "residual_ratio": {"value": worst,
                           "limit": limits["residual_ratio"]},
    }
    return checks, failed, notes


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
