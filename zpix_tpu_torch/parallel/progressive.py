"""Progressive JPEG with a coefficient store on the card, fed by the host.

The PyTorch/CUDA counterpart of zpix_tpu/parallel/progressive.py.  Each
image is decoded scan by scan on the host (the port's host decoder,
codecs/jpeg/decoder.py, a thread an image); after every scan the change
of its coefficients is recorded sparsely (``_ScanRecorder``).  The card
holds one int32 store a component ([B, bv, bh, 64], natural order); the
scans are replayed in lockstep, each image's (index, delta) pairs added
into it by one K22 launch for every (scan, component) update
(ops/prog_spec.py::delta_add_segments; padding pairs add 0 at index 0),
and K6 (ops/planes.py, its int32 arm, per-image quant rows) turns the
store into pixels.  The store after scan s equals the host decoder's, so
the pixels are the host decoder's.

zpix_tpu pads each scan's pairs to a power of two (``_bucket``) to bound
its compiles; the port pads them to the longest row, with the same output.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..codecs.jpeg.decoder import Decoder
from ..codecs.jpeg.tables import UNZIG
from ..errors import UnsupportedError
from ..ops import prog_spec as _spec
from .batch import FrontEndResult, decode_batch_planes, parse_coefficients
from .device_entropy import PinnedUpload, resolve_device


class _ScanRecorder(Decoder):
    """The host decoder, recording the coefficient deltas of every scan:
    ``scan_events[s]`` holds (component, flat indices int32, values int32)
    for each component the scan changed."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.collect_only = True
        self.scan_events: list = []
        self._prev: dict = {}

    def process_sos(self, n: int) -> None:
        super().process_sos(n)
        ev = []
        for c in range(self.num_components):
            cur = self.coeff[c]
            if cur is None:
                continue
            cur = cur.astype(np.int32, copy=False)
            prev = self._prev.get(c)
            flat = np.ascontiguousarray(cur if prev is None else cur - prev).reshape(-1)
            idx = np.flatnonzero(flat).astype(np.int32)
            if idx.size:
                ev.append((c, idx, flat[idx].astype(np.int32)))
            self._prev[c] = cur.copy()
        self.scan_events.append(ev)


def _record(data: bytes) -> _ScanRecorder:
    r = _ScanRecorder(data)
    r.decode_inner(False)
    return r


class DeviceProgressiveDecoder:
    """Same-geometry progressive JPEG batch -> pixels u8 [B, H, W, 3] (gray
    [B, H, W]) on the decoder's device, equal to the host decoder's.

    Raises as zpix_tpu's does: ValueError on an empty batch,
    UnsupportedError on a stream that is not progressive, on CMYK or RGB,
    and on a batch whose geometry differs; the host decoder's errors
    propagate.  One thread pool for the host decodes lives until
    ``close``."""

    def __init__(self, *, device=None, n_threads: int | None = None):
        self.device = resolve_device(device)
        self._pool = ThreadPoolExecutor(n_threads or os.cpu_count() or 2)
        self._upload = PinnedUpload(self.device)

    def record(self, datas: list[bytes]) -> list:
        """The host half: each image decoded scan by scan, checked in order
        -> its ``_ScanRecorder``."""
        if not datas:
            raise ValueError("jpeg: empty batch")
        futures = [self._pool.submit(_record, d) for d in datas]
        recs = []
        for f in futures:
            r = f.result()
            if not r.progressive:
                raise UnsupportedError(
                    "jpeg: DeviceProgressiveDecoder is for SOF2 streams; "
                    "use BatchJpegDecoder / DeviceJpegDecoder for baseline")
            if r.num_components == 4 or r.is_rgb():
                raise UnsupportedError(
                    "jpeg: progressive device path covers gray/YCbCr only "
                    "(CMYK/RGB need applyBlack/convertToRGB, decoder.zig:751-902)")
            recs.append(r)
        r0 = recs[0]
        geo = (r0.width, r0.height, r0.num_components,
               tuple((c.h, c.v) for c in r0.component[: r0.num_components]))
        for r in recs[1:]:
            if (r.width, r.height, r.num_components,
                    tuple((c.h, c.v) for c in r.component[: r.num_components])) != geo:
                raise UnsupportedError("jpeg: batch must share geometry")
        return recs

    def decode(self, datas: list[bytes]):
        recs = self.record(datas)
        r0, B = recs[0], len(recs)
        ncomp = r0.num_components
        shapes = [r0.coeff[c].shape for c in range(ncomp)]
        quants = []
        for c in range(ncomp):
            q = np.empty((B, 64), np.int32)
            for b, r in enumerate(recs):
                q[b, UNZIG] = r.quant[r.component[c].tq]
            quants.append(q)
        # each scan's pairs a component, padded to the longest row
        n_scans = max(len(r.scan_events) for r in recs)
        updates = []
        for s in range(n_scans):
            for c in range(ncomp):
                pairs = []
                for r in recs:
                    ev = r.scan_events[s] if s < len(r.scan_events) else []
                    hit = [(i, v) for cc, i, v in ev if cc == c]
                    pairs.append(hit[0] if hit else (None, None))
                k = max((i.size for i, _ in pairs if i is not None), default=0)
                if k == 0:
                    continue
                idx = np.zeros((B, k), np.int32)
                val = np.zeros((B, k), np.int32)
                for b, (i, v) in enumerate(pairs):
                    if i is not None:
                        idx[b, : i.size] = i
                        val[b, : i.size] = v
                updates.append((c, idx, val))
        parts = iter(self._upload(quants + [a for _, i, v in updates for a in (i, v)]))
        dev_quants = [next(parts) for _ in range(ncomp)]
        store = torch.zeros(sum(B * int(np.prod(sh)) for sh in shapes), dtype=torch.int32,
                            device=dev_quants[0].device)
        flat = torch.split(store, [B * int(np.prod(sh)) for sh in shapes])
        _spec.delta_add_segments([(flat[c].view(B, -1), next(parts), next(parts))
                                  for c, _idx, _val in updates])
        grids = [f.view(B, *sh) for f, sh in zip(flat, shapes)]
        if ncomp == 1:
            return decode_batch_planes(grids, dev_quants, color="gray", height=r0.height,
                                       width=r0.width)
        return decode_batch_planes(grids, dev_quants, color="ycbcr", height=r0.height,
                                   width=r0.width, ratio=r0._subsample_ratio())

    def reference_frontends(self, datas: list[bytes]) -> list[FrontEndResult]:
        """Host coefficient tensors for differential testing."""
        return [parse_coefficients(d) for d in datas]

    def close(self) -> None:
        """Shut the host decodes' thread pool down."""
        self._pool.shutdown()
