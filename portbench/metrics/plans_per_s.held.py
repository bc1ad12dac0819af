"""Plans completed per second in the window, on the host's clock: the
plans of the window's whole held rounds over the time from the first
counted client's start to the last one's exit. Read in the traced run,
so under the profiler's CUDA-only recording (the untraced run records
the same). A per-layer metric here because the host's speed moves it
by more than a bound may allow: PERF.md."""

UNIT = "plans/s"


def read(ctx):
    if ctx["plans"] <= 0 or ctx["span_s"] <= 0:
        return None
    return ctx["plans"] / ctx["span_s"]
