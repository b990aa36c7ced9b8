"""kernel_ms: the mean, over the window's batches, of the card's time in
the batch's hand-written kernels: the pairs of CUDA events the program
records around each kernel launch (``runtime.launch``; the C entry records
both itself, ``csrc/timing.cuh``, so they hold its kernels and, on an idle
stream, the card's wait for the entry to issue them, and no host thread's
wait for the interpreter; the span ``launch.<entry>.card``'s
``card_ms``), summed a batch; read with no profiler.  Nothing on the CPU."""

from benchmark.metrics import _program


def read(ctx):
    return _program.mean_a_batch(
        ctx, lambda n: n.startswith("launch.") and n.endswith(".card"),
        lambda spans: sum(s.counts["card_ms"] for s in spans))
