"""K15, the PNG defilter: filtered rows and filter bytes -> decoded rows.

``png_defilter`` wraps K15 (csrc/png_defilter.cu), the port of
zpix_tpu/ops/defilter.py::defilter_jnp (:35): a register wavefront, a warp
a band of 32 rows, 4 bands a block and further blocks of an image below
them.  ``png_defilter_plain`` is the same function in plain PyTorch,
on the anti-diagonal schedule: at step c every row r decodes its pixel
c - r from pixels of steps c - 1 and c - 2.  The dispatch takes it for
CPU tensors only.

Semantics (the reference's src/png/decoder.zig:806-842, Paeth :1152-1182),
per row, mod 256, out-of-image neighbours 0, on decoded bytes: None raw,
Sub raw + left, Up raw + up, Average raw + ((left + up) >> 1), Paeth
raw + paeth(left, up, up-left) with the tie order left, up, up-left; a
type above 4 predicts 0, as the JAX graph does.  ``bad``, an int32 [1]
tensor, is set to 1 when any row's type is above 4.
"""

from __future__ import annotations

import torch

from .. import runtime

BPPS = (1, 2, 3, 4, 6, 8)
WARPS = 4  # bands (warps) a block of K15 (csrc/png_defilter.cu kWarps)


def png_defilter_plain(raw, ftypes, *, bpp: int, bad=None):
    B, H, Wb = raw.shape
    W = Wb // bpp
    dev = raw.device
    x = raw.reshape(B, H, W, bpp).to(torch.int32)
    f = ftypes.to(torch.int32)
    out = torch.zeros(B, H, W, bpp, dtype=torch.int32, device=dev)
    for c in range(H + W - 1):
        r = torch.arange(max(0, c - W + 1), min(H - 1, c) + 1, device=dev)
        p = c - r
        has_left = (p >= 1)[None, :, None]
        has_up = (r >= 1)[None, :, None]
        pl, ru = (p - 1).clamp(min=0), (r - 1).clamp(min=0)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        left = torch.where(has_left, out[:, r, pl], zero)
        up = torch.where(has_up, out[:, ru, p], zero)
        ul = torch.where(has_left & has_up, out[:, ru, pl], zero)
        pp = left + up - ul
        pa, pb, pc = (pp - left).abs(), (pp - up).abs(), (pp - ul).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), left, torch.where(pb <= pc, up, ul))
        ft = f[:, r][..., None]
        pred = torch.where(ft == 1, left, torch.where(ft == 2, up, torch.where(
            ft == 3, (left + up) >> 1, torch.where(ft == 4, paeth, zero))))
        out[:, r, p] = (x[:, r, p] + pred) & 0xFF
    if bad is not None:
        bad |= (ftypes > 4).any().to(torch.int32)
    return out.to(torch.uint8).reshape(B, H, Wb)


def scratch_words(batch: int, H: int, W: int) -> int:
    """K15's scratch (csrc/png_defilter.cu scratch_words): a ticket and a
    word of padding, and for each (image, part of up to WARPS bands) the
    part's last row of W pixels, two 64-bit slots a pixel, which the part
    below reads."""
    bands = -(-H // 32)
    parts = -(-bands // min(WARPS, bands))
    return 2 + batch * parts * W * 4


def png_defilter(raw, ftypes, *, bpp: int, bad=None):
    """K15: raw u8 [B, H, Wb] (rows may be strided views, e.g. of the
    inflated stream [B, H, 1 + Wb]), ftypes u8 [B, H] -> decoded u8
    [B, H, Wb]; ``bad`` int32 [1] or None."""
    if raw.dtype != torch.uint8 or ftypes.dtype != torch.uint8:
        raise TypeError("png defilter: expected u8 rows and filter types")
    if bpp not in BPPS:
        raise ValueError(f"png defilter: unsupported bytes per pixel {bpp}")
    if raw.dim() != 3 or tuple(ftypes.shape) != tuple(raw.shape[:2]):
        raise ValueError("png defilter: rows must be [B, H, Wb], filter types [B, H]")
    B, H, Wb = raw.shape
    if Wb % bpp:
        raise ValueError(f"defilter: row bytes {Wb} not a multiple of bpp {bpp}")
    if bad is not None and (bad.dtype != torch.int32 or bad.numel() != 1):
        raise ValueError("png defilter: bad must be an int32 [1] tensor")
    if raw.device.type == "cpu":
        return png_defilter_plain(raw, ftypes, bpp=bpp, bad=bad)
    runtime.require_cuda(raw, rows=True)
    if ftypes.device != raw.device or (bad is not None and bad.device != raw.device):
        raise ValueError("png defilter: rows, filter types and flag on one CUDA device")
    out = torch.empty(B, H, Wb, dtype=torch.uint8, device=raw.device)
    if out.numel():
        scratch = torch.empty(scratch_words(B, H, Wb // bpp), dtype=torch.int32,
                              device=raw.device)
        runtime.launch("png_defilter", raw.device, "zpix_png_defilter", "pllpllpiiiipp",
                       raw.data_ptr(), raw.stride(0), raw.stride(1), ftypes.data_ptr(),
                       ftypes.stride(0), ftypes.stride(1), out.data_ptr(), B, H, Wb, bpp,
                       0 if bad is None else bad.data_ptr(), scratch.data_ptr())
    return out
