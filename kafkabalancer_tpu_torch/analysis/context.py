"""Shared AST machinery for the port's device-aware linter.

Three facilities every rule builds on:

- **Import-alias resolution**: ``import torch.nn.functional as F`` /
  ``from torch import cuda`` / ``from functools import partial`` are
  mapped back to canonical dotted names, so a rule asks "does this
  expression resolve to ``torch.cuda.synchronize``?" instead of
  pattern-matching local spellings.
- **Device-loop analysis**: the set of function definitions whose
  bodies run once per iteration of a loop over CUDA tensors — a session
  iteration, a kernel wrapper. On CUDA every host read of a device
  tensor is a synchronisation, so these bodies must not read the device
  except where the design says so. A function is device-loop code when
  its ``def`` line (or a decorator line, or the line above it) carries a
  ``# device-loop: <why>`` comment — the same comment style as the
  ``# thread-role:`` marker R8 reads; every function lexically nested in
  one is device-loop code too, and (one fixpoint pass) so is every
  module-level function CALLED by name from device-loop code in the
  same module. The propagation is module-local by design: a helper in
  another module (``ops/cost.py``) is device-loop code only where its
  own module marks it.
- **Suppression parsing**: ``# jaxlint: disable=R2`` (comma list or
  ``all``) on the finding's line or the line above suppresses it;
  ``# jaxlint: skip-file`` in the first ten lines skips the module. The
  directive keeps the reference linter's spelling, so one reader finds
  the exceptions of both packages.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

# the marker of a device-loop function; the text after the colon is
# its reason (SUP reports a marker without one)
DEVICE_LOOP_RE = re.compile(r"#\s*device-loop:(.*)$")
_SUPPRESS_RE = re.compile(r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\s]+)")
_SKIP_FILE_RE = re.compile(r"#\s*jaxlint:\s*skip-file")


@dataclass(frozen=True)
class Finding:
    """One linter finding; ``snippet`` (the stripped source line) is the
    line-number-independent half of the baseline fingerprint.

    ``end_line`` spans the flagged construct (a multi-line call flagged
    at its head still honours a suppression comment on any of its
    lines); 0 means "same as line"."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str
    end_line: int = 0

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path.replace("\\", "/"), self.snippet)


def parse_module(source: str, path: str) -> "Finding | ModuleContext":
    """Parse one module; a ``Finding`` (rule ``E0``) on syntax error.

    The ONE definition of the syntax-error contract, shared by the lint
    driver and the annotation checker."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return Finding(
            rule="E0",
            path=path,
            line=exc.lineno or 0,
            col=exc.offset or 0,
            message=f"syntax error: {exc.msg}",
            snippet="",
        )
    return ModuleContext(path, source, tree)


class ModuleContext:
    """Everything the rules need to know about one parsed module."""

    def __init__(self, path: str, source: str, tree: ast.Module) -> None:
        self.path = path
        self.source = source
        self.lines: List[str] = source.splitlines()
        self.tree = tree
        self.aliases: Dict[str, str] = {}
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.suppressions: Dict[int, Set[str]] = {}
        self.skip_file = False
        # line -> the reason text of a ``# device-loop:`` comment there
        self.device_loop_marks: Dict[int, str] = {}
        self._build_parents()
        self._build_aliases()
        self._build_suppressions()
        # the device-loop fixpoint is the expensive half of the analysis
        # and the annotation checker never needs it — computed lazily on
        # first access
        self._device_loop: Optional[Set[ast.AST]] = None

    @property
    def device_loop(self) -> Set[ast.AST]:
        if self._device_loop is None:
            self._device_loop = self._find_device_loop_functions()
        return self._device_loop

    # ---- construction ---------------------------------------------------

    def _build_parents(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def _build_aliases(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:
                        root = a.name.split(".", 1)[0]
                        self.aliases.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue  # relative imports: not a jax/numpy source
                for a in node.names:
                    local = a.asname or a.name
                    self.aliases[local] = f"{node.module}.{a.name}"

    def _build_suppressions(self) -> None:
        """Directives live in COMMENT tokens only — a docstring quoting
        '# jaxlint: disable=…' must not register a live suppression."""
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.source).readline)
            )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return  # ast.parse succeeded, so this is effectively dead
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            lineno = tok.start[0]
            if lineno <= 10 and _SKIP_FILE_RE.search(tok.string):
                self.skip_file = True
            mark = DEVICE_LOOP_RE.search(tok.string)
            if mark:
                self.device_loop_marks[lineno] = mark.group(1).strip()
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                # commas or whitespace both separate rule ids, so
                # "disable=R1 R2" suppresses what it reads as saying
                rules = {
                    r.upper()
                    for r in re.split(r"[,\s]+", m.group(1))
                    if r
                }
                self.suppressions[lineno] = rules

    # ---- name resolution ------------------------------------------------

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    def resolves_to(self, node: ast.AST, *names: str) -> bool:
        resolved = self.resolve(node)
        return resolved is not None and resolved in names

    # ---- device-loop analysis -------------------------------------------

    def marked(self, node: ast.AST) -> bool:
        """Does a ``# device-loop:`` comment sit on ``node``'s ``def``
        line, a decorator line, a continuation line of the signature or
        the line above?"""
        start = min(
            [node.lineno]  # type: ignore[attr-defined]
            + [d.lineno for d in getattr(node, "decorator_list", [])]
        )
        body = getattr(node, "body", [])
        def_line: int = node.lineno  # type: ignore[attr-defined]
        stop = max(body[0].lineno if body else def_line, def_line + 1)
        return any(
            line in self.device_loop_marks for line in range(start - 1, stop)
        )

    def _find_device_loop_functions(self) -> Set[ast.AST]:
        defs: Dict[str, List[ast.AST]] = {}
        loop: Set[ast.AST] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
                if self.marked(node):
                    loop.add(node)

        # lexical nesting: a def inside a device-loop def runs with it;
        # then one module-local call-graph fixpoint — a module-level
        # function CALLED from device-loop code is device-loop code too
        def under_loop(node: ast.AST) -> bool:
            cur = self.parents.get(node)
            while cur is not None:
                if cur in loop:
                    return True
                cur = self.parents.get(cur)
            return False

        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.tree):
                if (
                    isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)
                    )
                    and node not in loop
                    and under_loop(node)
                ):
                    loop.add(node)
                    changed = True
            for fn in list(loop):
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    if not isinstance(call.func, ast.Name):
                        continue
                    for cand in defs.get(call.func.id, ()):
                        # only module-level defs propagate by name —
                        # a local name may be rebound arbitrarily
                        if cand not in loop and isinstance(
                            self.parents.get(cand), ast.Module
                        ):
                            loop.add(cand)
                            changed = True
        return loop

    def device_loop_functions(self) -> Iterator[ast.AST]:
        return iter(self.device_loop)

    def device_loop_lines(self) -> Set[int]:
        """Every source line of every device-loop function (the lines a
        runtime sync monitor holds against the markings)."""
        lines: Set[int] = set()
        for fn in self.device_loop:
            end = getattr(fn, "end_lineno", None) or fn.lineno  # type: ignore[attr-defined]
            lines.update(range(fn.lineno, end + 1))  # type: ignore[attr-defined]
        return lines

    # ---- findings -------------------------------------------------------

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(
        self, rule: str, node: ast.AST, message: str, span: bool = True
    ) -> Finding:
        """``span=False`` pins the suppression window to the anchor line
        only — used for findings anchored on large constructs (a whole
        FunctionDef) where honouring interior comments would let an
        unrelated disable deep in the body exempt the enclosing
        finding."""
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule,
            path=self.path,
            line=line,
            col=col,
            message=message,
            snippet=self.snippet_at(line),
            end_line=(getattr(node, "end_lineno", None) or line)
            if span
            else line,
        )

    def suppressed(self, f: Finding) -> bool:
        """A disable comment on the line above the construct or on ANY
        of its lines suppresses — multi-line calls flagged at their head
        stay suppressible at the literal's line and vice versa."""
        last = max(f.end_line, f.line)
        for line in range(f.line - 1, last + 1):
            rules = self.suppressions.get(line)
            if rules and (f.rule.upper() in rules or "ALL" in rules):
                return True
        return False
