"""delivery_p95_ms: the 95th percentile, over every batch of the window,
of the time from the consumer asking the loader for its next batch to
that batch's pixels and ``ok`` being complete on the card (host clock;
numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    ms = ctx.delivery_ms()
    return float(np.percentile(ms, 95)) if ms else None
