"""R3 — no host copy or explicit synchronisation inside device-loop code.

``.cpu()``, ``.numpy()``, ``.tolist()`` and ``.to("cpu")`` copy a CUDA
tensor to the host and wait for the queue to drain;
``torch.cuda.synchronize()`` (and ``.synchronize()`` on a stream or an
event) waits without copying. A Python constant written into a tensor
element (``mem[torch.where(ok, i, trash)] = False``, ``buf[n] = 0``)
goes the other way: torch makes it a host tensor and copies it to the
card before the write, and that copy synchronises too. Inside
device-loop code (a session
iteration, a kernel wrapper; see ``context.py``) each one idles the card
once per iteration. Host work that needs device values belongs after the
loop (the chunk driver decodes the move log once per chunk).

The reference's R3 (the same id and module name) flags host numpy,
``jax.device_get`` and ``block_until_ready`` inside traced code; these
are their torch spellings.
"""

from __future__ import annotations

import ast
from typing import Iterator

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext

RULE_ID = "R3"
TITLE = (
    "no .cpu()/.numpy()/.tolist()/torch.cuda.synchronize() in "
    "device-loop code"
)

_SYNC_CALLS = ("torch.cuda.synchronize",)
_COPY_METHODS = ("cpu", "numpy", "tolist")
_SYNC_METHODS = ("synchronize",)


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    values = list(node.args) + [
        kw.value for kw in node.keywords if kw.arg == "device"
    ]
    return any(
        isinstance(v, ast.Constant)
        and isinstance(v.value, str)
        and v.value.split(":", 1)[0] == "cpu"
        for v in values
    )


def _constant_into_element(node: ast.Assign) -> bool:
    """``x[...] = <Python constant>``: a bool / int / float literal written
    through a subscript (in device-loop code the subscripted value is a
    tensor)."""
    value = node.value
    if isinstance(value, ast.UnaryOp):
        value = value.operand
    return (
        isinstance(value, ast.Constant)
        and isinstance(value.value, (bool, int, float))
        and any(isinstance(t, ast.Subscript) for t in node.targets)
    )


def check(ctx: ModuleContext) -> Iterator[Finding]:
    seen = set()
    for fn in ctx.device_loop_functions():
        for node in ast.walk(fn):
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, ast.Assign):
                if _constant_into_element(node):
                    yield ctx.finding(
                        RULE_ID,
                        node,
                        "a Python constant written into a tensor inside "
                        "device-loop code is copied host->device first, "
                        "and the copy syncs; write a device tensor (a "
                        "preallocated one, or index_fill_)",
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func)
            if resolved in _SYNC_CALLS:
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f"{resolved}() inside device-loop code waits for the "
                    "card once per iteration; synchronise outside the loop",
                )
            elif isinstance(node.func, ast.Attribute) and (
                node.func.attr in _COPY_METHODS and not node.args
            ):
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f".{node.func.attr}() inside device-loop code copies "
                    "a device tensor to the host and syncs; keep it on "
                    "the card and read it after the loop",
                )
            elif _to_host(node):
                yield ctx.finding(
                    RULE_ID,
                    node,
                    ".to('cpu') inside device-loop code copies a device "
                    "tensor to the host and syncs; read it after the loop",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
                and not node.args
            ):
                yield ctx.finding(
                    RULE_ID,
                    node,
                    f".{node.func.attr}() inside device-loop code waits "
                    "for the card; synchronise outside the loop",
                )
