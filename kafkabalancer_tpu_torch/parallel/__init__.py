"""Multi-device and kernel layer; ``shard_kernel`` holds the scoring
kernel's wrapper."""
