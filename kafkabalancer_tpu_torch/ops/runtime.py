"""Shape-bucket ladders shared by the encoding and the sessions.

Buckets keep the set of shapes a long-running process sees small: the
scoring kernel and the session's tensors are sized per bucket, not per
input.
"""

from __future__ import annotations


def next_bucket(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to a power-of-two bucket (≥ ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# where the fine partition-bucket ladder takes over from the doubling
# ladder: above it one doubling step wastes up to the whole instance
# again (131072 -> 262144 pads 131071 rows)
SCALE_LADDER_THRESHOLD = 65536


def scale_bucket(n: int, step: int = 8) -> int:
    """Partition bucket on the SCALE-tier fine ladder.

    Below :data:`SCALE_LADDER_THRESHOLD` this is exactly
    :func:`next_bucket` on a ``step`` minimum. Above it the ladder
    switches to multiples of ``step``, so padding is bounded by
    ``step - 1`` rows.
    """
    n = max(1, n)
    b = next_bucket(n, step)
    if b <= SCALE_LADDER_THRESHOLD:
        return b
    return -(-n // step) * step
