"""mpix_s: the megapixels of every window batch delivered with ``ok`` True,
over the window's wall time (host clock, from the first ask to the last
batch complete on the card)."""


def read(ctx):
    return ctx.ok_mpix / ctx.win.seconds if ctx.win.asks else None
