"""R8 — thread-role forbidden-call lint.

Functions carry ``# thread-role: <role>`` comments (vocabulary in
``analysis/manifest.py``). From every function annotated with a role
that has rules, R8 walks the intra-package call graph — thread
factories (``threading.Thread(target=…)``) are not edges, so the walk
stays on ONE physical thread — and flags any reachable call matching
the role's forbidden patterns, with the full call chain named.

Manifest ``boundaries`` are guarded seams the walk does not descend
into (e.g. the devmem query latched behind the warm-done event); each
carries its justification and the boundary call itself is still
checked against the forbidden patterns.

``any`` documents a thread-agnostic helper: it is not a root, and the
walk passes straight through it under the caller's role — the physical
thread is what matters, not the annotation on the way.
"""

from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Dict, Iterator, List, Set, Tuple

from kafkabalancer_tpu_torch.analysis.context import Finding
from kafkabalancer_tpu_torch.analysis.manifest import ContractManifest
from kafkabalancer_tpu_torch.analysis.program import Program

RULE_ID = "R8"
TITLE = "thread roles must not reach their forbidden calls"


def _matches(name: str, patterns: Tuple[str, ...]) -> bool:
    return any(fnmatchcase(name, p) for p in patterns)


def check_program(
    program: Program, manifest: ContractManifest
) -> Iterator[Finding]:
    boundary_pats = tuple(b.pattern for b in manifest.boundaries)
    rules = {r.role: r for r in manifest.role_rules}

    for fi in sorted(program.functions.values(), key=lambda f: f.key):
        if fi.role is None:
            continue
        if fi.role not in manifest.roles:
            info = program.modules[fi.module]
            yield Finding(
                rule=RULE_ID,
                path=info.path,
                line=fi.role_line or fi.lineno,
                col=0,
                message=(
                    f"unknown thread-role '{fi.role}' on {fi.key}; "
                    f"vocabulary: {', '.join(manifest.roles)}"
                ),
                snippet=info.ctx.snippet_at(fi.role_line or fi.lineno),
            )
            continue
        rule = rules.get(fi.role)
        if rule is None:
            continue

        # BFS from the role root over one physical thread's calls
        parents: Dict[str, Tuple[str, int]] = {fi.key: ("", 0)}
        queue = [fi.key]
        reported: Set[Tuple[str, int]] = set()
        while queue:
            cur = queue.pop(0)
            cfi = program.functions.get(cur)
            if cfi is None:
                continue
            cinfo = program.modules[cfi.module]

            def chain_to(site_line: int) -> str:
                hops: List[str] = []
                node = cur
                while node and node != fi.key:
                    prev, line = parents[node]
                    src = program.functions.get(prev)
                    at = (
                        f"{program.modules[src.module].path}:{line}"
                        if src
                        else "?"
                    )
                    hops.append(f"{node} (called at {at})")
                    node = prev
                hops.append(fi.key)
                hops.reverse()
                hops.append(f"forbidden call at line {site_line}")
                return " → ".join(hops)

            for ext, line in cfi.external_calls:
                if _matches(ext, rule.forbidden):
                    if (cinfo.path, line) in reported:
                        continue
                    reported.add((cinfo.path, line))
                    yield Finding(
                        rule=RULE_ID,
                        path=cinfo.path,
                        line=line,
                        col=0,
                        message=(
                            f"thread-role '{fi.role}' reaches forbidden "
                            f"call '{ext}': {chain_to(line)} — "
                            f"{rule.why}"
                        ),
                        snippet=cinfo.ctx.snippet_at(line),
                    )
            for callee, line in cfi.internal_calls:
                if _matches(callee, rule.forbidden):
                    if (cinfo.path, line) not in reported:
                        reported.add((cinfo.path, line))
                        yield Finding(
                            rule=RULE_ID,
                            path=cinfo.path,
                            line=line,
                            col=0,
                            message=(
                                f"thread-role '{fi.role}' reaches "
                                f"forbidden call '{callee}': "
                                f"{chain_to(line)} — {rule.why}"
                            ),
                            snippet=cinfo.ctx.snippet_at(line),
                        )
                    continue  # do not descend past a violation
                if _matches(callee, boundary_pats):
                    continue  # guarded seam; reason lives in manifest
                if callee not in parents:
                    parents[callee] = (cur, line)
                    queue.append(callee)
