"""R7 — lock-order consistency across serve/ + obs/.

Every ``with <lock>:`` nested (lexically, or through a call made while
the lock is held) inside another ``with <lock>:`` adds an ordering edge
outer→inner to the program-wide lock graph. A cycle means two code
paths acquire the same pair of locks in opposite orders — a potential
deadlock the hammer tests only catch when the interleaving actually
fires. The finding names both witness paths.

Self-nesting of a non-reentrant lock attribute (``with self._lock,
other._lock:`` — the same *class-level* lock on two instances, or the
same instance twice) is reported too: two instances locked in opposite
directions on two threads are the classic unordered-pair deadlock, and
the same instance twice is an immediate self-deadlock. RLock
attributes (detected from ``self.x = threading.RLock()``) are exempt.
Interprocedural self-edges are NOT reported: the call graph is
path-insensitive, and "method called both under the lock and not"
would dominate the signal with false positives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Set, Tuple

from kafkabalancer_tpu_torch.analysis.context import Finding
from kafkabalancer_tpu_torch.analysis.manifest import ContractManifest
from kafkabalancer_tpu_torch.analysis.program import Program

RULE_ID = "R7"
TITLE = "lock-acquisition order must be globally consistent"


@dataclass(frozen=True)
class _Edge:
    outer: str
    inner: str
    path: str  # witness module path
    line: int
    via: str  # description of how the nesting happens


def _edges(program: Program) -> List[_Edge]:
    out: List[_Edge] = []
    for fi in program.functions.values():
        info = program.modules[fi.module]
        for outer, inner, line in fi.lock_nest:
            out.append(
                _Edge(outer, inner, info.path, line, f"in {fi.key}")
            )
        for outer, callee, line in fi.calls_under_lock:
            for inner in sorted(program.transitive_acquires(callee)):
                if inner == outer:
                    continue  # path-insensitive; see module docstring
                out.append(
                    _Edge(
                        outer,
                        inner,
                        info.path,
                        line,
                        f"in {fi.key} via call to {callee}",
                    )
                )
    return out


def _fmt(e: _Edge) -> str:
    return (
        f"{e.outer} → {e.inner} ({e.path}:{e.line}, {e.via})"
    )


def check_program(
    program: Program, manifest: ContractManifest
) -> Iterator[Finding]:
    edges = _edges(program)
    graph: Dict[str, List[_Edge]] = {}
    for e in edges:
        graph.setdefault(e.outer, []).append(e)

    def first_path(src: str, dst: str) -> List[_Edge]:
        parents: Dict[str, _Edge] = {}
        queue = [src]
        seen = {src}
        while queue:
            cur = queue.pop(0)
            for e in graph.get(cur, ()):
                if e.inner in seen:
                    continue
                seen.add(e.inner)
                parents[e.inner] = e
                if e.inner == dst:
                    chain: List[_Edge] = []
                    node = dst
                    while node != src:
                        pe = parents[node]
                        chain.append(pe)
                        node = pe.outer
                    return list(reversed(chain))
                queue.append(e.inner)
        return []

    reported_pairs: Set[Tuple[str, str]] = set()
    for e in edges:
        if e.outer == e.inner:
            # lexical self-nesting of a non-reentrant lock
            if not program.lock_is_reentrant(e.outer):
                yield Finding(
                    rule=RULE_ID,
                    path=e.path,
                    line=e.line,
                    col=0,
                    message=(
                        f"non-reentrant lock {e.outer} acquired while "
                        f"already held ({e.via}) — same instance "
                        "self-deadlocks; two instances in opposite "
                        "orders deadlock unless acquisition is "
                        "id-ordered"
                    ),
                    snippet=_snippet(program, e),
                )
            continue
        pair = tuple(sorted((e.outer, e.inner)))
        if pair in reported_pairs:
            continue
        back = first_path(e.inner, e.outer)
        if not back:
            continue
        reported_pairs.add(pair)  # type: ignore[arg-type]
        back_text = "; ".join(_fmt(b) for b in back)
        yield Finding(
            rule=RULE_ID,
            path=e.path,
            line=e.line,
            col=0,
            message=(
                f"lock-order cycle: {e.outer} is held while taking "
                f"{e.inner} ({_fmt(e)}), but the reverse order also "
                f"exists: {back_text} — two threads on these paths "
                "deadlock"
            ),
            snippet=_snippet(program, e),
        )


def _snippet(program: Program, e: _Edge) -> str:
    for info in program.modules.values():
        if info.path == e.path:
            return info.ctx.snippet_at(e.line)
    return ""
