"""Fused YCbCr -> RGBA blit.

The reference's ``util.drawYCbCr`` (zpix src/image/util.zig:10-291)
is the JPEG upsample+color-convert hot path, hand-unrolled per subsample
ratio with the branchless clamp.  Here it is one vectorized gather + the
exact integer conversion.  (The reference's Zig loops carry an off-by-one —
they pre-increment indices, never writing row/col 0 and overrunning the last
pixel, which traps in safe builds; the path is unreachable from its tests.
We implement the documented Go-draw semantics.)
"""

from __future__ import annotations

import numpy as np

from ..color import ycbcr_to_rgb8
from .model import RGBAImage, YCbCrImage


def draw_ycbcr(dst: RGBAImage, src: YCbCrImage) -> None:
    """Convert the whole YCbCr image into dst's RGBA8 pixels (alpha=255)."""
    cb, cr = src.upsampled_cbcr()
    r, g, b = ycbcr_to_rgb8(src.y, cb, cr)
    dst.pix[..., 0] = r
    dst.pix[..., 1] = g
    dst.pix[..., 2] = b
    dst.pix[..., 3] = 255
