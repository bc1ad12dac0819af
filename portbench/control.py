"""The control of ``correct``: sound plans against plans cut short.

The configuration states that a plan is converged: from the planned
assignment no single move lowers the objective by more than
``-min-unbalance``. The control breaks that guarantee the way a session
stopped early would: each plan of the window loses its last quarter of
moves. For each window it prints, as one JSON line, the
``residual_ratio`` of every plan as served (the sound readings) and of
every plan cut short (the control's), from which the limit in the
configuration's ``limits`` is set, and the verdict that ``correct.judge``
gives the cut plans in the run's place (``control_correct``, which has to
be false).

    python3 portbench/control.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import correct, run, spec  # noqa: E402
from portbench.load import Plan  # noqa: E402
from portbench.reference import check  # noqa: E402

KEEP = 0.75


def readings(workload: str, seed: int, seconds: float,
             **kw: Any) -> Dict[str, Any]:
    """One run of the cell with the control applied to its window."""
    cell = kw.get("cell") or spec.Cell(spec.benchmark(), workload)
    out: Dict[str, Any] = {"workload": workload, "seed": seed}

    def inspect(plans: List[Any], flags: List[str]) -> None:
        opts = check.planner_options(flags)
        sound, cut, cut_plans = [], [], []
        for p in plans:
            if p.rc != 0:
                continue
            c = check.Cluster.from_file(p.path, opts["broker_ids"])
            text = check.truncate_plan(p.stdout, KEEP)
            sound.append(check.check_plan(c, p.stdout, opts)["residual_ratio"])
            cut.append(check.check_plan(c, text, opts)["residual_ratio"])
            q = Plan(p.path, p.out_path + ".cut")
            with open(q.out_path, "w") as f:
                f.write(text)
            q.rc = 0
            cut_plans.append(q)
        checks, failed, _ = correct.judge(
            cut_plans, flags, seed, int(cell.traffic["check_sample"]),
            cell.config["limits"])
        out.update(plans=len(sound), sound_max=max(sound, default=None),
                   control_min=min(cut, default=None),
                   control_correct=correct.passed(checks) and failed == 0,
                   control_checks={k: v["value"] for k, v in checks.items()},
                   sound=sound, control=cut)

    out["rc"] = run.run(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        inspect=inspect, **kw)
    return out


def main(argv: Sequence[str]) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
