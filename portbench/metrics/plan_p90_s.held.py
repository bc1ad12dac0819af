"""The 90th percentile (nearest rank) of the window's client walls, in a
cell whose rounds are held: a held round's eight walls agree within a
tenth of a second, so this is the slowest or second-slowest round of the
window, an order statistic of a few rounds. Read in the traced run, so
under the profiler's stretch (the run prints it beside the rate)."""

import math

UNIT = "s"


def read(ctx):
    walls = sorted(ctx["walls"])
    if not walls:
        return None
    return walls[max(0, math.ceil(0.9 * len(walls)) - 1)]
