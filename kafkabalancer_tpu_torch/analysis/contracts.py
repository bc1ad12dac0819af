"""Driver for the whole-program contract passes (R6–R9 + SUP).

``python -m kafkabalancer_tpu_torch.analysis --contracts [ROOT]`` builds one
``Program`` over the manifest's package (plus ``extra_files``) and runs
the registered contract rules against ``analysis/manifest.py``'s
declarations, reusing the per-file linter's Finding/suppression/
baseline machinery and output formats. Fixture tests call
``run_contracts`` with a throwaway root and their own manifest.

SUP is the suppression-hygiene check the acceptance bar requires:
every ``# jaxlint: disable=…`` directive in the analyzed tree must
carry a reason after the rule list (``disable=R6 — why``), and every
id it names must be a known rule — a directive like
``disable=R6 stale import`` parses "STALE"/"IMPORT" as rule ids (the
comma/whitespace grammar), which SUP surfaces instead of silently
suppressing nothing. A ``# device-loop:`` marker (``context.py``) must
carry its reason the same way.
"""

from __future__ import annotations

import io
import re
import tokenize
from typing import Iterator, List, Optional, Sequence, Set

from kafkabalancer_tpu_torch.analysis.context import DEVICE_LOOP_RE, Finding
from kafkabalancer_tpu_torch.analysis.manifest import (
    ContractManifest,
    default_manifest,
)
from kafkabalancer_tpu_torch.analysis.program import Program
from kafkabalancer_tpu_torch.analysis.rules import ALL_RULES, CONTRACT_RULES

SUP_RULE_ID = "SUP"
SUP_TITLE = "every suppression carries a reason and names real rules"

_DIRECTIVE_RE = re.compile(
    r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\s]+)(.*)$"
)


def known_rule_ids() -> Set[str]:
    return (
        set(ALL_RULES)
        | set(CONTRACT_RULES)
        | {"ALL", "ANN", "E0", SUP_RULE_ID}
    )


def check_suppression_reasons(program: Program) -> Iterator[Finding]:
    known = known_rule_ids()
    for name in sorted(program.modules):
        info = program.modules[name]
        try:
            tokens = list(
                tokenize.generate_tokens(
                    io.StringIO(info.ctx.source).readline
                )
            )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            continue
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            mark = DEVICE_LOOP_RE.search(tok.string)
            if mark is not None and not mark.group(1).strip():
                yield Finding(
                    rule=SUP_RULE_ID,
                    path=info.path,
                    line=tok.start[0],
                    col=tok.start[1],
                    message=(
                        "device-loop marker carries no reason — say why "
                        "the function runs once per iteration "
                        "(`# device-loop: why`)"
                    ),
                    snippet=info.ctx.snippet_at(tok.start[0]),
                )
            m = _DIRECTIVE_RE.search(tok.string)
            if m is None:
                continue
            ids = {
                r.upper()
                for r in re.split(r"[,\s]+", m.group(1))
                if r
            }
            reason = m.group(2).strip().lstrip("—–-:,;").strip()
            line = tok.start[0]
            unknown = sorted(ids - known)
            if unknown:
                yield Finding(
                    rule=SUP_RULE_ID,
                    path=info.path,
                    line=line,
                    col=tok.start[1],
                    message=(
                        "suppression names unknown rule id(s) "
                        f"{', '.join(unknown)} — rule lists are "
                        "comma/whitespace separated, so the reason "
                        "must be set off with punctuation "
                        "(`disable=R6 — reason`)"
                    ),
                    snippet=info.ctx.snippet_at(line),
                )
            elif not reason:
                yield Finding(
                    rule=SUP_RULE_ID,
                    path=info.path,
                    line=line,
                    col=tok.start[1],
                    message=(
                        f"suppression of {', '.join(sorted(ids))} "
                        "carries no reason — every exception is part "
                        "of the diff (`disable=… — reason`)"
                    ),
                    snippet=info.ctx.snippet_at(line),
                )


def load_program(
    root: str = ".", manifest: Optional[ContractManifest] = None
) -> Program:
    manifest = manifest or default_manifest()
    return Program(
        root, manifest.package, extra_files=manifest.extra_files
    )


def run_contracts(
    root: str = ".",
    manifest: Optional[ContractManifest] = None,
    rules: Optional[Sequence[str]] = None,
    program: Optional[Program] = None,
) -> List[Finding]:
    manifest = manifest or default_manifest()
    if program is None:
        program = load_program(root, manifest)
    findings: List[Finding] = list(program.errors)
    for rid in sorted(CONTRACT_RULES):
        if rules is not None and rid not in rules:
            continue
        findings.extend(
            CONTRACT_RULES[rid].check_program(program, manifest)
        )
    if rules is None or SUP_RULE_ID in rules:
        findings.extend(check_suppression_reasons(program))
    by_path = {
        info.path: info.ctx for info in program.modules.values()
    }
    out = [
        f
        for f in findings
        if not (f.path in by_path and by_path[f.path].suppressed(f))
    ]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out
