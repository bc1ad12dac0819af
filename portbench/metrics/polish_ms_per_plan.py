"""Host milliseconds of the polish alternation per plan: the port's
``polish.move_seconds``, ``polish.swap_seconds`` and
``polish.shuffle_seconds`` counters over the window, over the plans of
the window. Each member of a fused round counts the round's phases, so
this is the time a plan spends in polish phases."""

UNIT = "ms"

NAMES = ("polish.move_seconds", "polish.swap_seconds",
         "polish.shuffle_seconds")


def read(ctx):
    c0, c1 = ctx["counters0"], ctx["counters1"]
    secs = sum(c1.get(n, 0.0) - c0.get(n, 0.0) for n in NAMES)
    plans = ctx["plans"]
    if secs <= 0 or plans <= 0:
        return None
    return secs * 1000.0 / plans
