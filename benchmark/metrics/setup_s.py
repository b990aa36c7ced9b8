"""setup_s: from the process's start (the first line of ``run.py``) to the
window's start: imports, the card's set-up, the corpus, the program's
kernel build where the checkout has none, and the warm-up batches."""


def read(ctx):
    return ctx.setup_s
