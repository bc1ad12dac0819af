from kafkabalancer_tpu_torch.models.config import (
    RebalanceConfig,
    default_rebalance_config,
)
from kafkabalancer_tpu_torch.models.partition import (
    Partition,
    PartitionList,
)

__all__ = [
    "Partition",
    "PartitionList",
    "RebalanceConfig",
    "default_rebalance_config",
]
