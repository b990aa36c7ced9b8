"""Overlapped decode: the next batch's host prep beside this one's upload and
kernels.

The port of zpix_tpu/parallel/pipeline.py.  A decode is three stages
(``prep`` on the host, ``upload``, ``run``: the kernels), and the card
works only in the last two, so a serial loop leaves it idle while the
host preps.  ``DecodePipeline`` preps up to ``prefetch`` batches ahead on
a pool of threads while the caller's thread uploads and launches the
batch before them:

    prep(i+1), prep(i+2)   [pool threads]
    upload(i) + run(i)     [caller's thread, enqueued without a sync]
    kernels of i - 1       [card]

Each plan owns its staging buffer (``PinnedUpload``, the native JPEG
front-end's flat buffer), so a prep never rewrites a batch still waiting
for its copy, and the copies run on a side stream of their own.  An
exception raised by a prep reaches the caller at that batch's turn; nothing
is retried or run elsewhere.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


class DecodePipeline:
    """Overlap host prep with upload and kernels across batches.

    ``decoder``: an object with ``prep(datas) -> plan``, ``upload(plan) ->
    device buffers`` and ``run(plan, bufs) -> result``; or pass ``prep``
    and ``run`` (``run(plan) -> result``) callables instead.  ``workers``
    threads prep (default: ``prefetch``)."""

    def __init__(self, decoder=None, *, prep: Callable | None = None,
                 run: Callable | None = None, prefetch: int = 2, workers: int | None = None):
        if decoder is not None and prep is None:
            prep = decoder.prep
            run = lambda plan: decoder.run(plan, decoder.upload(plan))  # noqa: E731
        if prep is None or run is None:
            raise ValueError("need a decoder or explicit prep/run callables")
        self._prep = prep
        self._run = run
        self._prefetch = max(1, prefetch)
        self._workers = max(1, workers if workers is not None else prefetch)

    def map(self, batches: Iterable[list]) -> Iterator:
        """Yield each batch's result in order, on the device and not
        synchronised (tensors, or the decoder's (pixels, ok) tuples).  Prep
        runs ``prefetch`` batches ahead; upload and kernels stay on the
        caller's thread."""
        it = iter(batches)
        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            pending = deque()
            for b in it:
                pending.append(pool.submit(self._prep, b))
                if len(pending) >= self._prefetch:
                    break
            while pending:
                plan = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._prep, nxt))
                yield self._run(plan)


def jpeg_onchip_pipeline(decoder=None, prefetch: int = 2) -> DecodePipeline:
    """Pipeline over ``DeviceJpegDecoder`` (baseline JPEG with restart
    markers), a new one on the card where none is given."""
    from .device_entropy import DeviceJpegDecoder

    return DecodePipeline(decoder or DeviceJpegDecoder(), prefetch=prefetch)


def qoi_onchip_pipeline(decoder=None, prefetch: int = 2) -> DecodePipeline:
    """Pipeline over ``HostIndexQoiDecoder`` (the JAX version drives the
    speculative ``BatchQoiDecoder``, which the port does not carry), a new
    one on the card where none is given."""
    from .qoi_batch import HostIndexQoiDecoder

    return DecodePipeline(decoder or HostIndexQoiDecoder(), prefetch=prefetch)
