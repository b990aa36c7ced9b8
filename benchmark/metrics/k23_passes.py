"""k23_passes: the mean, over the window's images, of K23's passes
(``BatchQoiDecoder.last_rounds`` after each batch's ``run``): a count the
program keeps, read once the window has closed."""


def read(ctx):
    rounds = ctx.timed.rounds
    if not rounds:
        return None
    import torch

    allr = torch.cat([r.reshape(-1).to("cpu", torch.float64) for r in rounds])
    return float(allr.mean())
