"""R6 — import-purity reachability.

The manifest declares module sets that must stay free of given
third-party imports: torch and numpy on the forwarding client's path,
torch and numpy in the host-side machinery, and jax, jaxlib and the
JAX package itself everywhere in the port. R6 walks the transitive
*module-level* import graph from each member: any reachable ``import
torch`` fails with the full chain printed, anchored at the import
statement that pulls the forbidden module in — the one place a fix
(make it lazy) or a reasoned suppression belongs.

A forbidden name matches the first dotted component of an import for
equality, so ``kafkabalancer_tpu_torch`` is never an import of
``kafkabalancer_tpu``. Function-local lazy imports never enter the graph
(they are the sanctioned escape hatch), and PEP-562 lazy re-exports only
contribute when a module-level ``from pkg import <lazy name>`` actually
triggers them — see ``analysis/program.py``. The runtime oracle for the
same property is tests/test_torch_cli.py's no-torch / no-jax subprocess
pins; R6 is their static twin, differentially pinned in
tests/test_torch_contracts.py.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

from kafkabalancer_tpu_torch.analysis.context import Finding
from kafkabalancer_tpu_torch.analysis.manifest import ContractManifest
from kafkabalancer_tpu_torch.analysis.program import ImportEdge, Program

RULE_ID = "R6"
TITLE = "declared-pure modules must not reach a forbidden import"


def expand_members(program: Program, patterns: Tuple[str, ...]) -> List[str]:
    """Exact names plus ``pkg.sub.*`` globs (the glob includes
    ``pkg.sub`` itself)."""
    out: List[str] = []
    for pat in patterns:
        if pat.endswith(".*"):
            base = pat[:-2]
            out.extend(
                m
                for m in sorted(program.modules)
                if m == base or m.startswith(base + ".")
            )
        else:
            out.append(pat)
    return list(dict.fromkeys(out))


def _chain_text(program: Program, chain: Tuple[ImportEdge, ...]) -> str:
    hops = []
    for e in chain:
        src = program.modules[e.src]
        where = f"{src.path}:{e.line}" if e.line else f"{src.path} (package)"
        dest = e.dest[4:] if e.dest.startswith("ext:") else e.dest
        hops.append(f"{e.src} → {dest} ({where})")
    return "; ".join(hops)


def check_program(
    program: Program, manifest: ContractManifest
) -> Iterator[Finding]:
    # (anchor path, line, forbidden) -> shortest chain already reported
    reported: Dict[Tuple[str, int, str], int] = {}
    pending: List[Tuple[Tuple[str, int, str], Finding, int]] = []
    for pset in manifest.purity:
        for member in expand_members(program, pset.members):
            if member not in program.modules:
                info_path = "<manifest>"
                yield Finding(
                    rule=RULE_ID,
                    path=info_path,
                    line=0,
                    col=0,
                    message=(
                        f"purity set '{pset.name}' names unknown module "
                        f"'{member}' — the manifest has drifted from "
                        "the tree"
                    ),
                    snippet="",
                )
                continue
            closure = program.import_closure(member)
            for forb in pset.forbidden:
                chain = closure.get("ext:" + forb)
                if chain is None:
                    continue
                last = chain[-1]
                src = program.modules[last.src]
                key = (src.path, last.line, forb)
                prev = reported.get(key)
                if prev is not None and prev <= len(chain):
                    continue
                reported[key] = len(chain)
                f = Finding(
                    rule=RULE_ID,
                    path=src.path,
                    line=last.line,
                    col=0,
                    message=(
                        f"'{member}' (purity set '{pset.name}') reaches "
                        f"a module-level import of '{forb}': "
                        + _chain_text(program, chain)
                    ),
                    snippet=src.ctx.snippet_at(last.line),
                )
                pending.append((key, f, len(chain)))
    # emit only the shortest chain per (site, forbidden) — a deeper
    # member's duplicate would just repeat the same anchor
    for key, f, n in pending:
        if reported.get(key) == n:
            reported[key] = -1  # consume
            yield f


def verdict(program: Program, manifest: ContractManifest, module: str) -> bool:
    """True iff ``module`` is clean for every purity set that names it —
    the hook the differential test pins against the subprocess oracle."""
    for pset in manifest.purity:
        if module not in expand_members(program, pset.members):
            continue
        closure = program.import_closure(module)
        if any("ext:" + forb in closure for forb in pset.forbidden):
            return False
    return True
