"""R4 — float dtype literals route through the central dtype policy.

Precision decisions scattered as bare ``torch.float64`` / ``np.float32``
literals drift apart: the port computes at float64 on the CPU (the
oracle-parity mode the tests hold against the reference) and at float32
on the card (the kernels take nothing else), and a path that hard-codes
one of them silently leaves its twin. The one place precision is decided
is ``kafkabalancer_tpu_torch/models/config.py`` (``default_dtype`` /
``kernel_dtype`` / ``HOST_FLOAT_DTYPE``); every other float-dtype
literal — attribute form (``torch.float32``, ``torch.double``,
``np.float64``), the conversion methods ``.double()`` / ``.half()`` /
``.bfloat16()`` / ``.float()``, ``astype("float64")`` string form, or a
``dtype=`` string keyword — is a finding. Integer/bool dtypes are
structural (indices, masks) and exempt.

The reference's R4 (the same id and module name) holds its JAX package
to the same policy module.
"""

from __future__ import annotations

import ast
from typing import Iterator

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext

RULE_ID = "R4"
TITLE = "float dtype literals route through models/config.py's policy"

_FLOAT_ATTRS = (
    "torch.float64",
    "torch.float32",
    "torch.float16",
    "torch.bfloat16",
    "torch.double",
    "torch.float",
    "torch.half",
    "numpy.float64",
    "numpy.float32",
    "numpy.float16",
)
_FLOAT_STRINGS = ("float64", "float32", "float16", "bfloat16")
# tensor conversion methods that pick a float precision
_FLOAT_METHODS = ("double", "half", "bfloat16", "float")

# the policy module itself is the one legitimate home for the literals
# (paths are /-normalized before the check)
_EXEMPT_SUFFIX = "models/config.py"

_MSG = (
    "bare float dtype literal — route through the central dtype policy "
    "(kafkabalancer_tpu_torch.models.config: default_dtype() / "
    "kernel_dtype() / HOST_FLOAT_DTYPE) or suppress with a reason"
)


def _is_float_string(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value in _FLOAT_STRINGS
    )


def _is_array_api_call(ctx: ModuleContext, node: ast.Call) -> bool:
    """Calls where a positional float-dtype string IS a dtype decision:
    numpy / torch constructors and ``.astype(...)``. Keeps R4 off
    non-dtype string uses (logging, startswith) that merely mention a
    dtype name."""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
        return True
    resolved = ctx.resolve(node.func)
    return resolved is not None and resolved.startswith(("numpy.", "torch."))


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if ctx.path.replace("\\", "/").endswith(_EXEMPT_SUFFIX):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute):
            if ctx.resolve(node) in _FLOAT_ATTRS and not isinstance(
                ctx.parents.get(node), ast.Attribute
            ):
                yield ctx.finding(RULE_ID, node, _MSG)
        elif isinstance(node, ast.Name):
            # the from-import spelling: `from torch import float64`
            if ctx.resolve(node) in _FLOAT_ATTRS:
                yield ctx.finding(RULE_ID, node, _MSG)
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _FLOAT_METHODS
                and not node.args
                and not node.keywords
                and ctx.resolve(node.func) is None
            ):
                # x.double(): a tensor conversion, not a module function
                yield ctx.finding(RULE_ID, node, _MSG)
                continue
            # a float dtype STRING as a dtype argument —
            # np.zeros(3, "float64"), x.astype("float32"),
            # np.asarray(x, dtype="float64") — is the same bare
            # precision decision as the attribute spelling; positional
            # strings only count in array-API calls so non-dtype uses
            # (logging, startswith) stay clean
            flagged = False
            if _is_array_api_call(ctx, node):
                for arg in node.args:
                    if _is_float_string(arg):
                        yield ctx.finding(RULE_ID, node, _MSG)
                        flagged = True
                        break
            if not flagged:
                for kw in node.keywords:
                    if kw.arg == "dtype" and _is_float_string(kw.value):
                        # anchored at the CALL so suppression works the
                        # same for keyword and positional spellings
                        yield ctx.finding(RULE_ID, node, _MSG)
                        break
