"""K17, the PNG expansion: defiltered rows -> premultiplied RGBA8, placed
on the canvas.

``png_expand`` wraps K17 (csrc/png_expand.cu), the port of
zpix_tpu/parallel/png_batch.py::_expand_graph (:299) with its arms
(:129-276) and the strided scatter of ``_interlaced_graph`` (:278): a pass
of Adam7 lands at (yo + y * yf, xo + x * xf) of the canvas, written by the
kernel itself.  ``png_expand_plain`` is the same function in plain
PyTorch, written as the JAX graph is; the dispatch takes it for CPU
tensors only.

One difference from the JAX graph, deliberate: tca16 and ga16 premultiply
``(c * a // 0xFFFF) >> 8`` without wrapping.  The JAX graph multiplies in
int32, which wraps for c * a >= 2^31 and then gives, for example, 128
where the host decoder's rgba_pixels gives 129 (c = 33024, a = 65535);
the port gives the host decoder's value (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from .. import runtime
from ..codecs.png.decode import _BITS_PER_PIXEL

# depth code -> (arm of csrc/png_expand.cu, bits a sample)
ARMS = {"g1": (0, 1), "g2": (0, 2), "g4": (0, 4), "g8": (0, 8), "g16": (1, 16),
        "tc8": (2, 8), "tc16": (3, 16), "tca8": (4, 8), "tca16": (5, 16), "ga8": (6, 8),
        "ga16": (7, 16), "p1": (8, 1), "p2": (8, 2), "p4": (8, 4), "p8": (8, 8)}
GRAY_SCALE = {1: 0xFF, 2: 0x55, 4: 0x11, 8: 1}
WHOLE = (0, 0, 1, 1)  # the placement of a whole image: (xo, yo, xf, yf)


def row_bytes(cd: str, width: int) -> int:
    return (_BITS_PER_PIXEL[cd] * width + 7) // 8


def _samples(rows, width: int, depth: int):
    """[B, h, row_bytes] -> [B, h, width] int64 samples: bytes, MSB-first
    bit fields, or big-endian words."""
    r = rows.to(torch.int64)
    if depth == 8:
        return r
    if depth == 16:
        return (r[..., 0::2] << 8) | r[..., 1::2]
    shifts = torch.arange(8 - depth, -1, -depth, device=rows.device)
    v = (r[..., None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(*rows.shape[:2], -1)[..., :width]


def _keyed(px, key, samples, n: int):
    """Zero the pixels whose first ``n`` samples all equal the image's key
    (the JAX graph's _keyed: a tRNS colour key premultiplies to 0)."""
    if key is None:
        return px
    match = (samples == key.to(torch.int64)[:, None, None, :n]).all(-1)
    return torch.where(match[..., None], torch.zeros_like(px), px)


def _expand(rows, palette, key, cd: str, width: int):
    """_expand_graph: [B, h, row_bytes] u8 -> [B, h, width, 4] u8."""
    B, h = rows.shape[:2]
    arm, depth = ARMS[cd]
    if arm == 8:  # palette
        idx = _samples(rows, width, depth)[..., :width]
        return palette[torch.arange(B, device=rows.device)[:, None, None], idx]
    if arm in (0, 1):  # gray
        y = _samples(rows, width, depth)[..., :width]
        g = (y * GRAY_SCALE[depth]) & 0xFF if depth < 16 else y >> 8
        px = torch.stack([g, g, g, torch.full_like(g, 255)], -1)
        return _keyed(px, key, y[..., None] if depth == 16 else g[..., None], 1).to(torch.uint8)
    nch = {2: 3, 3: 3, 4: 4, 5: 4, 6: 2, 7: 2}[arm]
    c = _samples(rows, width * nch, depth)[..., : width * nch].reshape(B, h, width, nch)
    if arm in (2, 3):  # truecolour
        rgb = c if depth == 8 else c >> 8
        px = torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], -1)
        return _keyed(px, key, c, 3).to(torch.uint8)
    a = c[..., -1:]
    col = c[..., :-1]
    if depth == 8:
        pre = ((col | (col << 8)) * a) // 0xFF >> 8
        alpha = a
    else:
        pre = (col * a) // 0xFFFF >> 8
        alpha = a >> 8
    if nch == 2:
        pre = pre.expand(B, h, width, 3)
    return torch.cat([pre, alpha], -1).to(torch.uint8)


def png_expand_plain(rows, palette, key, *, cd: str, width: int, out=None, place=WHOLE):
    px = _expand(rows, palette, key, cd, width)
    if out is None:
        return px
    xo, yo, xf, yf = place
    h = rows.shape[1]
    out[:, yo : yo + h * yf : yf, xo : xo + width * xf : xf] = px
    return out


def png_expand(rows, palette, key, *, cd: str, width: int, out=None, place=WHOLE):
    """K17: rows u8 [B, h, row_bytes], palette u8 [B, 256, 4] (paletted
    depths; else None), key int32 [B, 3] (-1 = none) or None -> RGBA8
    [B, h, width, 4]; or, with ``out`` [B, H, W, 4] u8 and ``place`` =
    (xo, yo, xf, yf), written at (yo + y * yf, xo + x * xf) of ``out``."""
    if cd not in ARMS:
        raise ValueError(f"png expand: unknown depth {cd}")
    if rows.dtype != torch.uint8 or rows.dim() != 3 or rows.shape[2] != row_bytes(cd, width):
        raise ValueError("png expand: rows must be u8 [B, h, row_bytes]")
    B, h = rows.shape[:2]
    arm, depth = ARMS[cd]
    if arm == 8:
        if palette is None or palette.dtype != torch.uint8 or tuple(palette.shape) != (B, 256, 4):
            raise ValueError("png expand: a paletted depth needs a u8 [B, 256, 4] palette")
    if key is not None and (key.dtype != torch.int32 or tuple(key.shape) != (B, 3)):
        raise ValueError("png expand: key must be int32 [B, 3]")
    xo, yo, xf, yf = place
    if out is None:
        if rows.device.type == "cpu":
            return png_expand_plain(rows, palette, key, cd=cd, width=width)
        out = torch.empty(B, h, width, 4, dtype=torch.uint8, device=rows.device)
    if (out.dtype != torch.uint8 or out.dim() != 4 or out.shape[0] != B or out.shape[3] != 4
            or (h and yo + (h - 1) * yf >= out.shape[1])
            or (width and xo + (width - 1) * xf >= out.shape[2])):
        raise ValueError("png expand: the pass does not fit the canvas")
    if rows.device.type == "cpu":
        return png_expand_plain(rows, palette, key, cd=cd, width=width, out=out, place=place)
    extra = [t for t in (palette, key) if t is not None]
    runtime.require_cuda(rows, out, *extra)
    if out.data_ptr() % 4 or (palette is not None and palette.data_ptr() % 4):
        raise ValueError("png expand: out and palette must be 4-byte aligned")
    if B * h * width:
        runtime.launch("png_expand", rows.device, "zpix_png_expand", "ppppliiiiiiiiiii",
                       rows.data_ptr(), 0 if palette is None else palette.data_ptr(),
                       0 if key is None else key.data_ptr(), out.data_ptr(), B, h, width,
                       rows.shape[2], arm, depth, out.shape[1], out.shape[2], xo, yo, xf, yf)
    return out
