"""Share of the bandwidth roofline that the scoring kernel K1 reaches in
the window: its launches' needed bytes (``kernels.k1_bytes``, every
instance of a batched launch) over 3.35 TB/s, over their device time."""

from portbench import kernels

UNIT = "%"


def read(ctx):
    return kernels.k1_roofline(ctx)
