"""Batched BMP decode: host header parse -> device unpack (K18).

The port of zpix_tpu/parallel/bmp_batch.py (:61-120).  BMP is raw pixels
behind a header (the reference's src/bmp/decoder.zig:42-307), so the card
does the whole decode: bit unpack and palette gather for 1/2/4/8 bpp,
BGR(A) -> RGBA for 24/32, the bottom-up row flip and the exact premultiply
of the V4/V5 alpha arm (ops/bmp.py).  Output: premultiplied RGBA8
[B, H, W, 4] on the decoder's device.  ``mesh`` is not ported.
"""

from __future__ import annotations

import numpy as np

from ..codecs.bmp.decode import _read_header, row_bytes
from ..errors import UnexpectedEof, UnsupportedError
from ..ops.bmp import bmp_unpack
from .device_entropy import PinnedUpload, resolve_device


class BatchBmpDecoder:
    """Same-shape batched BMP -> premultiplied RGBA8 [B, H, W, 4]."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._upload = PinnedUpload(self.device)

    def prep(self, datas: list[bytes]):
        """-> (rows u8 [B, H, row_bytes], palettes u8 [B, 256, 4], header
        fields (width, height, top_down, bpp, allow_alpha))."""
        if not datas:
            raise ValueError("bmp: empty batch")
        heads = [_read_header(d) for d in datas]
        key = heads[0][:5]
        if any(hh[:5] != key for hh in heads[1:]):
            raise UnsupportedError(
                "bmp: batch must share (width, height, orientation, bpp, header version)")
        width, height, _top_down, bpp, _allow_alpha = key
        stride = row_bytes(width, bpp)
        need = stride * height
        rows = np.empty((len(datas), height, stride), np.uint8)
        pal = np.zeros((len(datas), 256, 4), np.uint8)
        for i, (d, hh) in enumerate(zip(datas, heads)):
            body = d[hh[6]:]
            if len(body) < need:
                raise UnexpectedEof("bmp: truncated pixel data")
            rows[i] = np.frombuffer(body[:need], np.uint8).reshape(height, stride)
            if hh[5] is not None:
                pal[i, : len(hh[5])] = hh[5]
        return rows, pal, key

    def upload(self, rows, pal) -> list:
        """The rows and palettes -> device tensors, in one pinned copy."""
        return self._upload([rows, pal])

    def decode(self, datas: list[bytes]):
        rows, pal, (width, _h, top_down, bpp, allow_alpha) = self.prep(datas)
        return bmp_unpack(*self.upload(rows, pal), bpp=bpp, width=width, top_down=top_down,
                          allow_alpha=allow_alpha)
