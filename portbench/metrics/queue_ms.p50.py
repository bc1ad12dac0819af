"""Median wait of a request in the daemon's queue, in milliseconds: the
``serve.phase.queue`` histogram of the stats document (accept to
dispatcher pickup), its buckets counted over the window only. The value
is the upper edge of the bucket that holds the median (buckets are
2**(1/4) wide)."""

import math

UNIT = "ms"


def read(ctx):
    def buckets(doc):
        h = doc.get("hists", {}).get("serve.phase.queue")
        return {le: n for le, n in (h or {}).get("buckets", [])}

    b0, b1 = buckets(ctx["stats0"]), buckets(ctx["stats1"])
    delta = sorted((le, n - b0.get(le, 0)) for le, n in b1.items())
    total = sum(n for _, n in delta)
    if total <= 0:
        return None
    rank, seen = max(1, math.ceil(0.5 * total)), 0
    for le, n in delta:
        seen += n
        if seen >= rank:
            return le * 1000.0
    return None
