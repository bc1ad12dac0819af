"""Strict-annotation coverage — the no-mypy floor of the typing check.

The port's typed subpackages (``models/``, ``ops/``, ``codecs/``) keep
the reference's contract: every function parameter and return annotated
(``self``/``cls`` exempt, per mypy's strict mode). mypy is not installed
everywhere the port builds, so this AST check enforces the strict mode's
*coverage* half, the part that silently rots without tooling. Type
*correctness* still comes from real mypy wherever it is installed.

Findings carry rule id ``ANN`` and honour the same inline suppression
(``# jaxlint: disable=ANN``) as the lint rules.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Sequence

from kafkabalancer_tpu_torch.analysis.context import (
    Finding,
    ModuleContext,
    parse_module,
)

RULE_ID = "ANN"
TITLE = "every function fully annotated (mypy --strict coverage floor)"


def _missing_annotations(
    fn: ast.AST, in_class: bool
) -> Iterator[str]:
    assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    a = fn.args
    positional = list(a.posonlyargs) + list(a.args)
    skip_first = (
        in_class
        and positional
        and positional[0].arg in ("self", "cls")
        and not any(
            isinstance(d, ast.Name) and d.id == "staticmethod"
            for d in fn.decorator_list
        )
    )
    if skip_first:
        positional = positional[1:]
    for arg in positional + list(a.kwonlyargs):
        if arg.annotation is None:
            yield f"parameter {arg.arg!r}"
    if a.vararg is not None and a.vararg.annotation is None:
        yield f"parameter *{a.vararg.arg}"
    if a.kwarg is not None and a.kwarg.annotation is None:
        yield f"parameter **{a.kwarg.arg}"
    if fn.returns is None and fn.name != "__init__":
        yield "return type"


def check_module(ctx: ModuleContext) -> List[Finding]:
    if ctx.skip_file:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        in_class = isinstance(ctx.parents.get(node), ast.ClassDef)
        missing = list(_missing_annotations(node, in_class))
        if missing:
            # span=False: the finding anchors on the whole FunctionDef —
            # a disable comment buried in the body must not exempt it
            f = ctx.finding(
                RULE_ID,
                node,
                f"function {node.name!r} missing annotations: "
                + ", ".join(missing),
                span=False,
            )
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line))
    return out


def check_paths(paths: Sequence[str]) -> List[Finding]:
    from kafkabalancer_tpu_torch.analysis.jaxlint import iter_python_files

    out: List[Finding] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        ctx = parse_module(source, path)
        if isinstance(ctx, Finding):
            out.append(ctx)
            continue
        out.extend(check_module(ctx))
    return out
