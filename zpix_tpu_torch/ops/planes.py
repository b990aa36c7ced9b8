"""K6, component planes and colour: coefficient grids -> pixels.

``component_planes`` wraps K6 (csrc/planes.cu), the port of
zpix_tpu/parallel/batch.py::_component_plane (:84) and the colour graphs
(:107-173): per-image dequant, exact Wang IDCT, +128 and clamp, planes,
chroma replication and the gray, ycbcr, rgb, ycck or cmyk arm, into an
interleaved [B, H, W, C] u8 tensor ([B, H, W] for gray).

``component_planes_plain`` follows the JAX graphs' structure (full-size
planes, then upsample and colour), so it checks the kernel's per-MCU
mapping independently; the dispatch takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from .. import runtime
from .idct import idct_plain
from .ycbcr import upsample_chroma, ycbcr_to_rgb8

MODES = {"gray": 0, "ycbcr": 1, "rgb": 2, "cmyk": 3, "ycck": 4}
CHANNELS = {"gray": 1, "ycbcr": 3, "rgb": 3, "cmyk": 4, "ycck": 4}


def component_plane_plain(coeff, quant):
    """Dequant + IDCT + level shift of one component:
    [B, bv, bh, 64] int16 or int32 + [B, 64] int32 -> [B, 8*bv, 8*bh] u8."""
    B, bv, bh = coeff.shape[:3]
    deq = coeff.to(torch.int32) * quant.to(torch.int32)[:, None, None, :]
    pix = (idct_plain(deq.view(B, bv, bh, 8, 8)) + 128).clamp(0, 255).to(torch.uint8)
    return pix.permute(0, 1, 3, 2, 4).reshape(B, bv * 8, bh * 8)


def component_planes_plain(grids, quants, *, color: str, height: int, width: int,
                           factors):
    H, W = height, width
    chans = [upsample_chroma(component_plane_plain(g, q), fh, fv, H, W)
             for g, q, (fh, fv) in zip(grids, quants, factors)]
    if color == "gray":
        return chans[0].contiguous()
    if color == "rgb":
        return torch.stack(chans, -1)
    if color == "cmyk":
        return torch.stack([255 - c for c in chans], -1)
    out = list(ycbcr_to_rgb8(*chans[:3]))
    if color == "ycck":
        out.append(255 - chans[3])
    return torch.stack(out, -1)


def mcu_layout(grids, factors):
    """Per component, the blocks (h, v) it has in one MCU, and the MCU grid
    (mxx, myy): the component replicated most has one block per MCU, the
    others as many as their replication is finer.  Raises if the grids do
    not tile one MCU grid (the kernel's per-MCU mapping needs it)."""
    fh_max = max(f[0] for f in factors)
    fv_max = max(f[1] for f in factors)
    if tuple(factors[0]) != (1, 1):
        raise ValueError("component_planes: the first component is never replicated")
    hv, mxx, myy = [], None, None
    for g, (fh, fv) in zip(grids, factors):
        if fh_max % fh or fv_max % fv:
            raise ValueError("component_planes: replication factors do not nest")
        h, v = fh_max // fh, fv_max // fv
        if g.shape[1] % v or g.shape[2] % h:
            raise ValueError("component_planes: grids do not tile one MCU grid")
        if mxx is None:
            mxx, myy = g.shape[2] // h, g.shape[1] // v
        elif (g.shape[2] // h, g.shape[1] // v) != (mxx, myy):
            raise ValueError("component_planes: grids do not tile one MCU grid")
        hv.append((h, v))
    return hv, mxx, myy


def component_planes(grids, quants, *, color: str, height: int, width: int, factors):
    """K6: per component a grid [B, bv, bh, 64] (natural order; int16, or
    int32 for the progressive store, every grid of one type) and the
    images' quant rows [B, 64] int32, and the replication (fh, fv) that
    maps an output pixel (y, x) to the component's sample
    (y // fv, x // fh) -> u8 [B, H, W, C], or [B, H, W] for gray."""
    if color not in MODES or not (len(grids) == len(quants) == len(factors)
                                  == CHANNELS[color]):
        raise ValueError("component_planes: components do not match the colour arm")
    B = grids[0].shape[0]
    coef_dtype = grids[0].dtype
    for g, q, (fh, fv) in zip(grids, quants, factors):
        if (g.dtype != coef_dtype or coef_dtype not in (torch.int16, torch.int32)
                or q.dtype != torch.int32):
            raise TypeError("component_planes: expected int16 or int32 grids (one type) "
                            "and int32 quants")
        if g.dim() != 4 or g.shape[0] != B or g.shape[3] != 64 or tuple(q.shape) != (B, 64):
            raise ValueError("component_planes: grids must be [B, bv, bh, 64], quants [B, 64]")
        if 8 * g.shape[1] * fv < height or 8 * g.shape[2] * fh < width:
            raise ValueError("component_planes: a grid does not cover the image")
    hv, mxx, myy = mcu_layout(grids, factors)
    if grids[0].device.type == "cpu":
        return component_planes_plain(grids, quants, color=color, height=height,
                                      width=width, factors=factors)
    runtime.require_cuda(*grids, *quants)
    nchan = CHANNELS[color]
    shape = (B, height, width) if nchan == 1 else (B, height, width, nchan)
    out = torch.empty(shape, dtype=torch.uint8, device=grids[0].device)
    packed = [h | v << 4 | fh << 8 | fv << 12 for (h, v), (fh, fv) in zip(hv, factors)]
    pad = 4 - len(grids)
    runtime.launch(
        "component_planes", out.device, "zpix_component_planes", "p" * 9 + "i" * 14,
        *[g.data_ptr() for g in grids], *[0] * pad,
        *[q.data_ptr() for q in quants], *[0] * pad, out.data_ptr(),
        B, mxx, myy, sum(h * v for h, v in hv), height, width, len(grids),
        *packed, *[0] * pad, MODES[color], nchan, int(coef_dtype == torch.int32),
    )
    return out
