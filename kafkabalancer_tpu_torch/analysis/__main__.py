"""``python -m kafkabalancer_tpu_torch.analysis`` — the port's jaxlint entry point."""

import sys

from kafkabalancer_tpu_torch.analysis.jaxlint import main

sys.exit(main())
