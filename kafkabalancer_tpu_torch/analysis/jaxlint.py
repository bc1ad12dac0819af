"""jaxlint — driver for the port's device-aware static analysis.

``python -m kafkabalancer_tpu_torch.analysis kafkabalancer_tpu_torch/
chip_smoke.py`` walks the given files/directories, runs the registered
per-file rules (R1–R5, see ``rules/``), subtracts inline suppressions
and the baseline, and reports remaining findings (human or ``--format
json``). ``--contracts [ROOT]`` instead runs the whole-program contract
passes (R6–R9 + SUP, see ``contracts.py``) over the manifest's package.
``--list-rules lint|contracts`` prints the registered rule ids. Exit
code 0 = clean, 1 = findings, 2 = usage/internal error, identical in
both modes — the reference linter's command line and exit codes, so one
gate script drives either package.

Baseline: ``--write-baseline`` snapshots the current findings into a
JSON file of ``(rule, path, source-line)`` fingerprints (line-number
independent, multiset semantics); later runs with ``--baseline`` treat
exactly those as grandfathered. The shipped tree is clean, so no
default baseline (``.jaxlint-torch-baseline.json`` at the working
directory, picked up when present) is checked in — the machinery exists
so a future change can land a new rule without first fixing the world.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kafkabalancer_tpu_torch.analysis.context import Finding, parse_module
from kafkabalancer_tpu_torch.analysis.rules import ALL_RULES

DEFAULT_BASELINE = ".jaxlint-torch-baseline.json"


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one module's source; inline suppressions already applied."""
    ctx = parse_module(source, path)
    if isinstance(ctx, Finding):
        return [ctx]
    if ctx.skip_file:
        return []
    out: List[Finding] = []
    for rule_id, mod in sorted(ALL_RULES.items()):
        if rules is not None and rule_id not in rules:
            continue
        for f in mod.check(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def iter_python_files(paths: Iterable[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d
                    for d in dirs
                    if d not in ("__pycache__", ".git")
                )
                files.extend(
                    os.path.join(root, n)
                    for n in sorted(names)
                    if n.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
        else:
            raise FileNotFoundError(f"not a python file or directory: {p}")
    return files


def lint_paths(
    paths: Iterable[str], rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    out: List[Finding] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), path=path, rules=rules))
    return out


# ---- baseline -----------------------------------------------------------


def load_baseline(path: str) -> Counter:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", data) if isinstance(data, dict) else data
    return Counter(
        (e["rule"], e["path"].replace("\\", "/"), e["snippet"])
        for e in entries
    )


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    entries = [
        {"rule": f.rule, "path": f.path.replace("\\", "/"), "snippet": f.snippet}
        for f in findings
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"findings": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def subtract_baseline(
    findings: Sequence[Finding], baseline: Counter
) -> List[Finding]:
    """Multiset subtraction: N grandfathered copies absorb N findings."""
    remaining = Counter(baseline)
    out: List[Finding] = []
    for f in findings:
        key = f.fingerprint()
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
        else:
            out.append(f)
    return out


# ---- output -------------------------------------------------------------


def format_human(findings: Sequence[Finding]) -> str:
    if not findings:
        return "jaxlint: clean"
    lines = [
        f"{f.path}:{f.line}:{f.col + 1}: [{f.rule}] {f.message}"
        + (f"\n    {f.snippet}" if f.snippet else "")
        for f in findings
    ]
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items()))
    lines.append(f"jaxlint: {len(findings)} finding(s) ({summary})")
    return "\n".join(lines)


def format_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {
            "findings": [
                {
                    "rule": f.rule,
                    "path": f.path.replace("\\", "/"),
                    "line": f.line,
                    "col": f.col,
                    "message": f.message,
                    "snippet": f.snippet,
                }
                for f in findings
            ],
            "count": len(findings),
        },
        indent=2,
    )


# ---- CLI ----------------------------------------------------------------


def _rule_list() -> str:
    from kafkabalancer_tpu_torch.analysis.contracts import (
        SUP_RULE_ID,
        SUP_TITLE,
    )
    from kafkabalancer_tpu_torch.analysis.rules import CONTRACT_RULES

    lines = [
        f"  {rid}  {mod.TITLE}" for rid, mod in sorted(ALL_RULES.items())
    ]
    lines.append("contract rules (--contracts):")
    lines.extend(
        f"  {rid}  {mod.TITLE}"
        for rid, mod in sorted(CONTRACT_RULES.items())
    )
    lines.append(f"  {SUP_RULE_ID}  {SUP_TITLE}")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m kafkabalancer_tpu_torch.analysis",
        description=(
            "Device-aware static analysis for the PyTorch/CUDA port of "
            "kafkabalancer-tpu."
        ),
        epilog="rules:\n" + _rule_list(),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help=(
            "files or directories to lint; with --contracts, at most "
            "one tree root (default: .)"
        ),
    )
    ap.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        dest="fmt",
    )
    ap.add_argument(
        "--select",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help=(
            "baseline JSON of grandfathered findings "
            f"(default: {DEFAULT_BASELINE} when it exists)"
        ),
    )
    ap.add_argument(
        "--write-baseline",
        metavar="PATH",
        default=None,
        help="write current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--annotations",
        action="store_true",
        help=(
            "run the strict-annotation coverage check instead of the "
            "lint rules (the no-mypy fallback half of the typing gate)"
        ),
    )
    ap.add_argument(
        "--contracts",
        action="store_true",
        help=(
            "run the whole-program contract passes (R6-R9 + SUP) over "
            "the manifest's package under the given root"
        ),
    )
    ap.add_argument(
        "--list-rules",
        choices=("lint", "contracts"),
        default=None,
        help=(
            "print the registered rule ids for the given mode and "
            "exit — the single list gate stages label themselves from"
        ),
    )
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        from kafkabalancer_tpu_torch.analysis.contracts import SUP_RULE_ID
        from kafkabalancer_tpu_torch.analysis.rules import CONTRACT_RULES

        ids = (
            sorted(ALL_RULES)
            if args.list_rules == "lint"
            else sorted(CONTRACT_RULES) + [SUP_RULE_ID]
        )
        print(" ".join(ids))
        return 0

    if args.contracts:
        from kafkabalancer_tpu_torch.analysis.contracts import SUP_RULE_ID
        from kafkabalancer_tpu_torch.analysis.rules import CONTRACT_RULES

        valid = set(CONTRACT_RULES) | {SUP_RULE_ID}
    else:
        valid = set(ALL_RULES)
        if not args.paths:
            print("jaxlint: no paths given", file=sys.stderr)
            return 2

    rules: Optional[Tuple[str, ...]] = None
    if args.select:
        rules = tuple(
            r.strip().upper() for r in args.select.split(",") if r.strip()
        )
        unknown = [r for r in rules if r not in valid]
        if unknown:
            print(
                f"jaxlint: unknown rule(s): {', '.join(unknown)}",
                file=sys.stderr,
            )
            return 2
    try:
        if args.contracts:
            from kafkabalancer_tpu_torch.analysis.contracts import run_contracts

            if len(args.paths) > 1:
                print(
                    "jaxlint: --contracts takes at most one tree root",
                    file=sys.stderr,
                )
                return 2
            root = args.paths[0] if args.paths else "."
            findings: List[Finding] = run_contracts(root, rules=rules)
        elif args.annotations:
            from kafkabalancer_tpu_torch.analysis.annotations import check_paths

            findings = check_paths(args.paths)
        else:
            findings = lint_paths(args.paths, rules=rules)
    except (OSError, UnicodeDecodeError) as exc:
        # unreadable tree (missing path, permissions, non-UTF-8 source)
        # is the internal-error contract (exit 2), never "findings"
        print(f"jaxlint: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(findings, args.write_baseline)
        print(
            f"jaxlint: wrote {len(findings)} finding(s) to "
            f"{args.write_baseline}"
        )
        return 0

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    if baseline_path:
        try:
            findings = subtract_baseline(
                findings, load_baseline(baseline_path)
            )
        except (OSError, ValueError, KeyError, TypeError) as exc:
            print(
                f"jaxlint: unreadable baseline {baseline_path}: {exc!r}",
                file=sys.stderr,
            )
            return 2

    print(format_json(findings) if args.fmt == "json" else format_human(findings))
    return 1 if findings else 0
