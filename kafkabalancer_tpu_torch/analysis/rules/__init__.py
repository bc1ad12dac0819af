"""Rule registry for the port's linter and contract analyzer.

Each per-file rule module exposes ``RULE_ID`` (``"R1"``…), ``TITLE``
(one line), and ``check(ctx: ModuleContext) -> Iterator[Finding]``;
each whole-program contract rule exposes ``RULE_ID`` (``"R6"``…),
``TITLE``, and ``check_program(program, manifest)``. Registration is
explicit — a rule the registry doesn't name does not run — so the
check's behaviour is reviewable in one place, and ``--list-rules``
(which ``chip_smoke.py`` phase 18 and the tests read) reads these two
dicts rather than a second copy of the list. The ids and module names
are the reference linter's; each module states its rule's torch
meaning.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from kafkabalancer_tpu_torch.analysis.rules import (
    r1_traced_coercion,
    r2_jit_statics,
    r3_host_sync,
    r4_dtype_policy,
    r5_bool_indexing,
    r6_import_purity,
    r7_lock_order,
    r8_thread_roles,
    r9_schema_drift,
)

ALL_RULES: Dict[str, ModuleType] = {
    mod.RULE_ID: mod
    for mod in (
        r1_traced_coercion,
        r2_jit_statics,
        r3_host_sync,
        r4_dtype_policy,
        r5_bool_indexing,
    )
}

CONTRACT_RULES: Dict[str, ModuleType] = {
    mod.RULE_ID: mod
    for mod in (
        r6_import_purity,
        r7_lock_order,
        r8_thread_roles,
        r9_schema_drift,
    )
}

__all__ = ["ALL_RULES", "CONTRACT_RULES"]
