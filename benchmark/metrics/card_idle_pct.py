"""card_idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card (``torch.profiler``: one minus the union of the
card's ops over the window), in %."""


def read(ctx):
    tr = ctx.win.trace
    if tr is None or not tr.dev or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
