"""``python -m kafkabalancer_tpu_torch`` — the CLI entry point."""

from kafkabalancer_tpu_torch.cli import main

main()
