"""R1 — no host coercion of a device tensor inside device-loop code.

``float(x)`` / ``int(x)`` / ``bool(x)`` / ``complex(x)`` / ``x.item()``
on a CUDA tensor copies the value to the host and waits for every
kernel queued before it: a synchronisation. Inside device-loop code (a
session iteration, a kernel wrapper; see ``context.py``) that wait
happens once per iteration and idles the card while the host catches
up. The designed reads — the one count a session iteration ends in —
carry a reasoned suppression; any other is a stray.

The reference's R1 (the same id and module name) flags the same calls
inside JAX-traced code, where they concretize a tracer. ``.tolist()``
is R3's here (a host copy, like ``.cpu()``).

Static-safe arguments are exempt: literals, ``len(...)``, shape / ndim /
dtype attribute chains, ``.numel()`` / ``.dim()`` / ``.size()`` /
``.element_size()`` calls and the parameters of an enclosing function
annotated ``int`` / ``float`` / ``bool`` are host values by
construction.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext

RULE_ID = "R1"
TITLE = (
    "no float()/int()/bool()/.item() of a tensor in device-loop code"
)

_COERCERS = ("float", "int", "bool", "complex")
_ITEM_METHODS = ("item",)
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda")
_STATIC_METHODS = ("numel", "dim", "size", "element_size", "nelement")
_SCALAR_TYPES = ("int", "float", "bool", "complex")


def _scalar_params(ctx: ModuleContext, node: ast.AST) -> Set[str]:
    """Parameters annotated with a Python scalar type in the functions
    that enclose ``node`` (a parameter of an inner function shadows the
    outer one's)."""
    out: Set[str] = set()
    shadowed: Set[str] = set()
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = cur.args
            for arg in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
                if arg.arg in shadowed:
                    continue
                shadowed.add(arg.arg)
                ann = arg.annotation
                if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                    name: Optional[str] = ann.value
                elif isinstance(ann, ast.Name):
                    name = ann.id
                else:
                    name = None
                if name in _SCALAR_TYPES:
                    out.add(arg.arg)
        cur = ctx.parents.get(cur)
    return out


def _static_safe(ctx: ModuleContext, node: ast.AST) -> bool:
    """Expressions that are plain host values whatever the device."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in _scalar_params(ctx, node)
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return True
    if isinstance(node, ast.Subscript):
        # x.shape[0] and friends
        return _static_safe(ctx, node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _STATIC_METHODS
        ):
            return True
        if isinstance(node.func, ast.Name) and node.func.id in _COERCERS:
            return all(_static_safe(ctx, a) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return _static_safe(ctx, node.left) and _static_safe(ctx, node.right)
    if isinstance(node, ast.UnaryOp):
        return _static_safe(ctx, node.operand)
    if isinstance(node, ast.IfExp):
        return all(
            _static_safe(ctx, n) for n in (node.test, node.body, node.orelse)
        )
    return False


def check(ctx: ModuleContext) -> Iterator[Finding]:
    seen = set()
    for fn in ctx.device_loop_functions():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            seen.add(id(node))
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _COERCERS
                and node.args
                and not node.keywords
                and not _static_safe(ctx, node.args[0])
            ):
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f"{node.func.id}() of a (potentially) device value "
                    "inside device-loop code reads the card and waits for "
                    "it — a sync per iteration; keep it a tensor "
                    "(torch.where, a masked reduction) or read it once "
                    "outside the loop",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _ITEM_METHODS
                and not node.args
                and not node.keywords
            ):
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f".{node.func.attr}() inside device-loop code is a "
                    "device->host copy and a sync; return the tensor and "
                    "read it outside the loop",
                )
