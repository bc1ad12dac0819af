"""Device compute ops: the dense encoding of the ragged partition model
(numpy, plus the upload to torch tensors) and the torch cost model
(broker loads + unbalance objective, ``ops/cost.py``).

The package imports no torch itself, so that the modules here that need
none (``coldstart``, ``nvcc``, ``runtime``, ``tensorize``) import without
it: a fresh process's warm thread (ops/coldstart.py) is then the one that
imports torch."""

from kafkabalancer_tpu_torch.ops.tensorize import DensePlan, tensorize

__all__ = ["DensePlan", "tensorize"]
