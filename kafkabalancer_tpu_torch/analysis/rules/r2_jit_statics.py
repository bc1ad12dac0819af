"""R2 — every ctypes kernel wrapper binds its signature and counts its
launches; nothing compiles torch code behind the kernels' backs.

The port's kernels are hand-written CUDA libraries loaded through
``ops/nvcc.load(source, bind)``. ctypes calls an unbound entry point
with every argument as a C ``int`` and reads its result as one, so a
pointer, a ``float`` or a ``long long`` passes silently truncated. Each
library's ``bind`` function (``_bind`` by convention) must therefore set
``argtypes`` AND ``restype`` for every entry point the module calls. A
function that calls a ``*_launch`` entry point must also register the
launch with ``nvcc.count_launch`` — the counts ``chip_smoke.py`` reads
to prove the main path ran the kernels.

``torch.compile`` and ``torch.jit`` (``script``, ``trace``, a
decorator or a call) are findings anywhere: a compiled plain version is
not a port of a kernel, and its recompiles are the silent cost the
reference's R2 (the same id and module name: every ``jax.jit`` site
declares its statics) exists to expose.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext

RULE_ID = "R2"
TITLE = (
    "ctypes kernel wrappers bind argtypes/restype and count launches; "
    "no torch.compile / torch.jit"
)

_LOAD = "kafkabalancer_tpu_torch.ops.nvcc.load"
_COUNT = "kafkabalancer_tpu_torch.ops.nvcc.count_launch"
_COMPILERS = ("torch.compile", "torch.jit")


def _compiler(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    resolved = ctx.resolve(node)
    if resolved is None:
        return None
    for name in _COMPILERS:
        if resolved == name or resolved.startswith(name + "."):
            return resolved
    return None


def _bound_names(fn: ast.AST) -> Dict[str, Set[str]]:
    """``lib.F.argtypes = …`` / ``lib.F.restype = …`` in a bind
    function: F -> the attributes set."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Attribute)
                and tgt.attr in ("argtypes", "restype")
                and isinstance(tgt.value, ast.Attribute)
                and isinstance(tgt.value.value, ast.Name)
            ):
                out.setdefault(tgt.value.attr, set()).add(tgt.attr)
    return out


def _check_wrappers(ctx: ModuleContext) -> Iterator[Finding]:
    defs: Dict[str, ast.AST] = {
        st.name: st
        for st in ctx.tree.body
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    load_calls: List[ast.Call] = [
        n
        for n in ast.walk(ctx.tree)
        if isinstance(n, ast.Call) and ctx.resolve(n.func) == _LOAD
    ]
    if not load_calls:
        return
    bound: Dict[str, Set[str]] = {}
    for call in load_calls:
        bind = call.args[1] if len(call.args) > 1 else None
        if bind is None:
            bind = next(
                (kw.value for kw in call.keywords if kw.arg == "bind"), None
            )
        if not (isinstance(bind, ast.Name) and bind.id in defs):
            yield ctx.finding(
                RULE_ID,
                call,
                "nvcc.load without a module-level bind function: the "
                "library's entry points would run with ctypes' int "
                "defaults",
            )
            continue
        for name, attrs in _bound_names(defs[bind.id]).items():
            bound.setdefault(name, set()).update(attrs)

    # the module's loaders: functions that return nvcc.load(...)
    loaders = {
        name
        for name, fn in defs.items()
        if any(
            isinstance(r, ast.Return)
            and isinstance(r.value, ast.Call)
            and ctx.resolve(r.value.func) == _LOAD
            for r in ast.walk(fn)
        )
    }
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        libs: Set[str] = set()
        for st in ast.walk(fn):
            if (
                isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and isinstance(st.value, ast.Call)
                and (
                    ctx.resolve(st.value.func) == _LOAD
                    or (
                        isinstance(st.value.func, ast.Name)
                        and st.value.func.id in loaders
                    )
                )
            ):
                libs.add(st.targets[0].id)
        if not libs:
            continue
        launches: List[ast.Call] = []
        counted = False
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            if ctx.resolve(call.func) == _COUNT:
                counted = True
            f = call.func
            if not (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id in libs
            ):
                continue
            missing = {"argtypes", "restype"} - bound.get(f.attr, set())
            if missing:
                yield ctx.finding(
                    RULE_ID,
                    call,
                    f"ctypes entry point {f.attr} is called without "
                    f"{' and '.join(sorted(missing))} bound in the "
                    "library's bind function",
                )
            if f.attr.endswith("_launch"):
                launches.append(call)
        if launches and not counted:
            yield ctx.finding(
                RULE_ID,
                launches[0],
                f"{fn.name} launches a kernel "  # type: ignore[attr-defined]
                f"({launches[0].func.attr}) without "  # type: ignore[attr-defined]
                "nvcc.count_launch: the launch counts would miss it",
            )


def check(ctx: ModuleContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = _compiler(ctx, node.func)
            if name is not None:
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f"{name}: the port compiles no torch code — a kernel "
                    "is hand-written CUDA behind a ctypes wrapper",
                )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    name = _compiler(ctx, dec)
                    if name is not None:
                        yield ctx.finding(
                            RULE_ID,
                            dec,
                            f"@{name}: the port compiles no torch code",
                        )
    yield from _check_wrappers(ctx)
