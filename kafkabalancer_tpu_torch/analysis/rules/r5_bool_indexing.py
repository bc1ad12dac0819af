"""R5 — no boolean-mask indexing of tensors inside device-loop code.

``x[x > 0]`` has a data-dependent size: on CUDA, torch counts the mask's
true elements on the card and copies the count back before it can
allocate the result — a synchronisation per iteration inside
device-loop code (see ``context.py``). ``torch.nonzero`` /
``.nonzero()``, ``torch.argwhere``, ``masked_select`` and the one-
argument ``torch.where(mask)`` size their result the same way.
Device-loop code selects with ``torch.where`` (a same-shape blend), a
masked reduction, or writes through a trash element (``solvers/scan``'s
session).

The rule flags subscripts whose index is a comparison / boolean
combination — the spellings that are unambiguously masks in source form
— and the calls above. The reference's R5 (the same id and module name)
flags the same subscripts inside JAX-traced code.
"""

from __future__ import annotations

import ast
from typing import Iterator

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext

RULE_ID = "R5"
TITLE = (
    "no boolean-mask indexing of tensors in device-loop code (use "
    "torch.where)"
)

_MSG = (
    "boolean-mask indexing inside device-loop code has a data-dependent "
    "size: on CUDA it syncs to count the mask; use torch.where / a masked "
    "reduction, or write through a trash index"
)

_SIZING_CALLS = (
    "torch.nonzero",
    "torch.argwhere",
    "torch.masked_select",
)
_SIZING_METHODS = ("nonzero", "argwhere", "masked_select")


def _is_mask_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.BoolOp):
        return any(_is_mask_expr(v) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask_expr(node.operand)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _is_mask_expr(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _is_mask_expr(node.left) or _is_mask_expr(node.right)
    return False


def _sizes_by_data(ctx: ModuleContext, node: ast.Call) -> bool:
    resolved = ctx.resolve(node.func)
    if resolved in _SIZING_CALLS:
        return True
    if resolved == "torch.where":
        return len(node.args) == 1 and not node.keywords
    return (
        resolved is None
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _SIZING_METHODS
    )


def check(ctx: ModuleContext) -> Iterator[Finding]:
    seen = set()
    for fn in ctx.device_loop_functions():
        for node in ast.walk(fn):
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, ast.Subscript):
                idx = node.slice
                elements = (
                    idx.elts if isinstance(idx, ast.Tuple) else (idx,)
                )
                if any(_is_mask_expr(e) for e in elements):
                    yield ctx.finding(RULE_ID, node, _MSG)
            elif isinstance(node, ast.Call) and _sizes_by_data(ctx, node):
                yield ctx.finding(RULE_ID, node, _MSG)
