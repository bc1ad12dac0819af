from kafkabalancer_tpu_torch.utils.flags import FlagSet  # noqa: F401
from kafkabalancer_tpu_torch.utils.logbuf import BufferingWriter, Logger  # noqa: F401
