from kafkabalancer_tpu_torch.balancer.pipeline import Balance, balance  # noqa: F401
from kafkabalancer_tpu_torch.balancer.steps import BalanceError  # noqa: F401
