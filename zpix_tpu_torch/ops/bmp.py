"""K18, the BMP unpack: stored rows and palettes -> premultiplied RGBA8.

``bmp_unpack`` wraps K18 (csrc/bmp_unpack.cu), the port of
zpix_tpu/parallel/bmp_batch.py::_bmp_graph (:21).  ``bmp_unpack_plain``
is the same function in plain PyTorch, written as the JAX graph is (bit
unpack, palette gather, BGR(A) swizzle, exact premultiply, row flip); the
dispatch takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from .. import runtime
from ..codecs.bmp.decode import row_bytes


def bmp_unpack_plain(rows, palette, *, bpp: int, width: int, top_down: bool,
                     allow_alpha: bool):
    B, H = rows.shape[:2]
    if bpp in (1, 2, 4, 8):
        if bpp == 8:
            idx = rows[:, :, :width].long()
        else:
            shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=rows.device)
            bits = (rows.to(torch.int32)[..., None] >> shifts) & 1  # MSB first
            grouped = bits.reshape(B, H, -1, bpp)
            weights = 1 << torch.arange(bpp - 1, -1, -1, dtype=torch.int32, device=rows.device)
            idx = (grouped * weights).sum(-1)[:, :, :width].long()
        out = palette[torch.arange(B, device=rows.device)[:, None, None], idx]
    elif bpp == 24:
        bgr = rows[:, :, : 3 * width].reshape(B, H, width, 3)
        out = torch.cat([bgr.flip(-1), torch.full_like(bgr[..., :1], 255)], -1)
    else:  # 32
        px = rows.reshape(B, H, width, 4)
        rgb = px[..., :3].flip(-1)
        if allow_alpha:  # NRGBA -> premultiplied, the exact rgba_pixels math
            a = px[..., 3:4].to(torch.int32)
            wide = rgb.to(torch.int32)
            wide = wide | (wide << 8)
            pre = ((wide * a) // 0xFF >> 8).to(torch.uint8)
            out = torch.cat([pre, px[..., 3:4]], -1)
        else:
            out = torch.cat([rgb, torch.full_like(px[..., :1], 255)], -1)
    return out if top_down else out.flip(1)


def bmp_unpack(rows, palette, *, bpp: int, width: int, top_down: bool, allow_alpha: bool):
    """K18: rows u8 [B, H, row_bytes], palette u8 [B, 256, 4] RGBA -> RGBA8
    [B, H, width, 4], premultiplied (32 bpp with a V4/V5 header)."""
    if rows.dtype != torch.uint8 or palette.dtype != torch.uint8:
        raise TypeError("bmp unpack: expected u8 rows and palette")
    if bpp not in (1, 2, 4, 8, 24, 32):
        raise ValueError(f"bmp unpack: unsupported bit depth {bpp}")
    if rows.dim() != 3 or rows.shape[2] != row_bytes(width, bpp):
        raise ValueError("bmp unpack: rows must be [B, H, row_bytes]")
    if tuple(palette.shape) != (rows.shape[0], 256, 4):
        raise ValueError("bmp unpack: palette must be [B, 256, 4]")
    if rows.device.type == "cpu":
        return bmp_unpack_plain(rows, palette, bpp=bpp, width=width, top_down=top_down,
                                allow_alpha=allow_alpha)
    runtime.require_cuda(rows, palette)
    if rows.data_ptr() % 4 or palette.data_ptr() % 4:
        raise ValueError("bmp unpack: rows and palette must be 4-byte aligned")
    B, H = rows.shape[:2]
    out = torch.empty(B, H, width, 4, dtype=torch.uint8, device=rows.device)
    if out.numel():
        runtime.launch("bmp_unpack", rows.device, "zpix_bmp_unpack", "pppliiiiii",
                       rows.data_ptr(), palette.data_ptr(), out.data_ptr(), B, H, width,
                       rows.shape[2], bpp, int(top_down), int(allow_alpha))
    return out
