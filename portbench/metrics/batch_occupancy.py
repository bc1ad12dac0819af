"""Mean members per fused round over the window: the stats document's
``mb_occupancy`` (fused dispatches by live occupancy), counted over the
window only (``run.occupancy``)."""

UNIT = "requests"


def read(ctx):
    return ctx["occupancy"]
