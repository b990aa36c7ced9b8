"""Batched BMP decode: host header parse -> device unpack (K18).

The port of zpix_tpu/parallel/bmp_batch.py (:61-120).  BMP is raw pixels
behind a header (the reference's src/bmp/decoder.zig:42-307), so the card
does the whole decode: bit unpack and palette gather for 1/2/4/8 bpp,
BGR(A) -> RGBA for 24/32, the bottom-up row flip and the exact premultiply
of the V4/V5 alpha arm (ops/bmp.py).  Output: premultiplied RGBA8
[B, H, W, 4] on the decoder's device; with ``mesh``, a ``Sharded`` batch
split into equal runs of images over the mesh's batch axis, as zpix_tpu
shards its rows and palettes (K18 on each run, on its own device).
"""

from __future__ import annotations

import numpy as np

from ..codecs.bmp.decode import _read_header, row_bytes
from ..errors import UnexpectedEof, UnsupportedError
from ..ops.bmp import bmp_unpack
from .device_entropy import PinnedUpload
from .mesh import DeviceUploads, Sharded, mesh_device


class BatchBmpDecoder:
    """Same-shape batched BMP -> premultiplied RGBA8 [B, H, W, 4]."""

    def __init__(self, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self._upload = PinnedUpload(self.device)
        self._uploads = DeviceUploads(self._upload)

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

    def upload(self, plan) -> list:
        """The plan's rows and palettes -> device tensors, in one pinned
        copy; with a mesh, a list of those a batch position (ValueError
        where the mesh does not divide the batch)."""
        if self.mesh is None:
            return self._upload(list(plan[:2]))
        return self._uploads.runs(self.mesh, plan[:2], f"bmp: the batch ({len(plan[0])} images)")

    def run(self, plan, bufs):
        """K18 on the uploaded rows and palettes -> RGBA8 [B, H, W, 4]
        (``Sharded`` with a mesh)."""
        width, _h, top_down, bpp, allow_alpha = plan[2]

        def k18(b):
            return bmp_unpack(*b, bpp=bpp, width=width, top_down=top_down,
                              allow_alpha=allow_alpha)

        return k18(bufs) if self.mesh is None else Sharded.stack(k18(b) for b in bufs)

    def decode(self, datas: list[bytes]):
        plan = self.prep(datas)
        return self.run(plan, self.upload(plan))
