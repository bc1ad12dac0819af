"""Device-aware static analysis for the PyTorch/CUDA port.

The port's twin of ``kafkabalancer_tpu/analysis/``: the same AST-based
linter, contract passes, command line, exit codes, module names and
``# jaxlint: disable=Rn — reason`` directive, with each rule given its
meaning for torch on a CUDA card, where every host read of a device
tensor is a synchronisation. Pure stdlib — importing this package
imports neither torch nor numpy, and nothing of the JAX package.

Run it::

    python -m kafkabalancer_tpu_torch.analysis kafkabalancer_tpu_torch/ \\
        chip_smoke.py
    python -m kafkabalancer_tpu_torch.analysis --contracts
    python -m kafkabalancer_tpu_torch.analysis --annotations \\
        kafkabalancer_tpu_torch/models kafkabalancer_tpu_torch/ops \\
        kafkabalancer_tpu_torch/codecs

Per-file rules, over device-loop code (functions marked ``# device-loop:
<why>`` and what they reach in their module; see ``context.py``) or the
whole tree:

- **R1** no ``float()``/``int()``/``bool()``/``.item()`` of a tensor in
  device-loop code;
- **R2** every ctypes kernel wrapper binds ``argtypes``/``restype`` and
  counts its launches with ``nvcc.count_launch``; no ``torch.compile``
  or ``torch.jit``;
- **R3** no ``.cpu()``/``.numpy()``/``.tolist()``/
  ``torch.cuda.synchronize()`` in device-loop code;
- **R4** float dtype literals route through the central dtype policy
  (``models/config.py``);
- **R5** no boolean-mask indexing (or ``nonzero``) in device-loop code.

Contract rules (``--contracts``): R6 import purity, R7 lock order, R8
thread roles, R9 schema drift, SUP suppression hygiene.

Suppress a finding inline with ``# jaxlint: disable=R1 — reason``;
grandfather a set of findings with ``--write-baseline`` /
``--baseline``.
"""

from kafkabalancer_tpu_torch.analysis.context import Finding, ModuleContext
from kafkabalancer_tpu_torch.analysis.jaxlint import (
    format_human,
    format_json,
    lint_paths,
    lint_source,
    load_baseline,
    main,
    subtract_baseline,
    write_baseline,
)
from kafkabalancer_tpu_torch.analysis.rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "Finding",
    "ModuleContext",
    "format_human",
    "format_json",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "main",
    "subtract_baseline",
    "write_baseline",
]
