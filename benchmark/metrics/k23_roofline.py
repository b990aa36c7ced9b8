"""k23_roofline: K23's share of its roofline, in %: the least time the
card needs for the window's batches' QOI decode (``roofline.k23``: each op
stream read once, each RGBA byte written once, at 3.35 TB/s) over the
device time of K23's kernel (``qoi_spec`` in its name) in the traced
window.  Nothing where the window ran no such kernel."""

from benchmark.roofline import k23, peaks


def read(ctx):
    tr = ctx.win.trace
    if tr is None:
        return None
    s = tr.op_seconds(lambda name: "qoi_spec" in name)
    if s <= 0:
        return None
    nbytes = sum(k23.bytes_moved([ctx.corpus[i] for i in idx]) for idx in ctx.window_batches())
    return 100.0 * peaks.bound_ms(nbytes)[0] / (s * 1e3)
