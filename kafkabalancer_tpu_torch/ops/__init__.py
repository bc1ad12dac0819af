"""Device compute ops: the dense encoding of the ragged partition model
(numpy, plus the upload to torch tensors) and the torch cost model
(broker loads + unbalance objective)."""

from kafkabalancer_tpu_torch.ops.tensorize import DensePlan, tensorize
from kafkabalancer_tpu_torch.ops import cost

__all__ = ["DensePlan", "tensorize", "cost"]
