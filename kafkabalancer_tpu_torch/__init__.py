"""kafkabalancer_tpu_torch — the PyTorch/CUDA port of kafkabalancer_tpu.

The same Kafka partition rebalancer as the JAX package beside it, with
the device path written in PyTorch for an NVIDIA H100 and the scoring
kernel hand-written in CUDA C++ for Hopper (``csrc/``). The layout
mirrors the JAX package module for module:

- ``models``   — ``Partition``, ``PartitionList``, ``RebalanceConfig`` and
  the dtype policy;
- ``codecs``   — input/output codecs (reference: codecs.go);
- ``balancer`` — the step pipeline and the greedy host oracle;
- ``ops``      — the dense encoding (numpy) and the torch cost model;
- ``parallel`` — ``shard_kernel``: the scoring kernel's wrapper, its
  plain torch version and the nvcc build;
- ``solvers``  — ``scan``: the fused batched converge session;
- ``utils``    — Go-style flags, the buffered logger, synthetic clusters;
- ``cli``      — the command-line entry point with the reference's flag
  set and exit-code contract.

This package never imports jax or the JAX package. torch is imported
lazily, so the greedy CLI path does not pay for it.
"""

from typing import Any

from kafkabalancer_tpu_torch.models import (  # noqa: F401
    Partition,
    PartitionList,
    RebalanceConfig,
    default_rebalance_config,
)

# the "+torch" suffix keeps this package's planning daemon and clients
# apart from the JAX package's: each client answers only to a daemon of
# its own version (serve/client.py)
__version__ = "0.1.0+torch"

__all__ = [
    "Balance",
    "BalanceError",
    "Partition",
    "PartitionList",
    "RebalanceConfig",
    "default_rebalance_config",
]


def __getattr__(name: str) -> Any:
    """Lazy re-exports (PEP 562) of ``Balance``/``BalanceError``."""
    if name in ("Balance", "BalanceError"):
        from kafkabalancer_tpu_torch import balancer

        return getattr(balancer, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
