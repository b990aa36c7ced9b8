"""Scanline bytes -> image arrays: a copy of zpix_tpu/codecs/png/expand.py.

Vectorizes the reference's conversion matrix a ColorBitDepth
(src/png/decoder.zig:845-1140): bit unpacking for 1/2/4-bit depths,
big-endian u16 assembly for 16-bit, RGB -> RGBA opaque expand, tRNS colour
key -> NRGBA/NRGBA64 alpha-0 rewrite, palette auto-extension for
out-of-range indices.  The output image type follows decoder.zig:713-775.
"""

from __future__ import annotations

import numpy as np

from ...errors import FormatError
from ...image import (
    GrayImage,
    Gray16Image,
    NRGBAImage,
    NRGBA64Image,
    PalettedImage,
    RGBAImage,
    RGBA64Image,
)
from ...image.model import PALETTE_RGBA


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, row_bytes) packed MSB-first -> (h, width) sample values."""
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1)
    if depth == 1:
        vals = bits
    else:
        per = 8 // depth
        usable = rows.shape[1] * per
        grouped = bits.reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (grouped * weights).sum(axis=2).astype(np.uint8)
        vals = vals[:, :usable]
    return vals[:, :width]


_GRAY_SCALE = {1: 0xFF, 2: 0x55, 4: 0x11, 8: 1}


def _be16(rows: np.ndarray, h: int, n: int) -> np.ndarray:
    """(h, 2n) big-endian byte pairs -> (h, n) uint16."""
    b = rows[:, : 2 * n].reshape(h, n, 2).astype(np.uint16)
    return (b[:, :, 0] << 8) | b[:, :, 1]


def expand_pass(
    rows: np.ndarray,
    width: int,
    height: int,
    color_depth: str,
    use_transparent: bool,
    transparent: bytes,
    palette: np.ndarray | None,
    palette_kinds: np.ndarray | None,
):
    """Expand defiltered scanline bytes into the output image for one pass.

    Returns (image, palette, palette_kinds) — the palette may have been
    auto-extended (decoder.zig:1086-1130 / Go semantics: extended entries are
    opaque black).
    """
    cd = color_depth

    if cd in ("g1", "g2", "g4", "g8"):
        depth = {"g1": 1, "g2": 2, "g4": 4, "g8": 8}[cd]
        vals = rows[:, :width] if depth == 8 else _unpack_bits(rows, width, depth)
        y = (vals.astype(np.uint16) * _GRAY_SCALE[depth]).astype(np.uint8)
        if use_transparent:
            ty = transparent[1]
            a = np.where(y == ty, 0, 0xFF).astype(np.uint8)
            pix = np.stack([y, y, y, a], axis=-1)
            return NRGBAImage(np.ascontiguousarray(pix)), palette, palette_kinds
        return GrayImage(y.copy()), palette, palette_kinds

    if cd == "g16":
        y = _be16(rows, height, width)
        if use_transparent:
            ty = (transparent[0] << 8) | transparent[1]
            a = np.where(y == ty, 0, 0xFFFF).astype(np.uint16)
            pix = np.stack([y, y, y, a], axis=-1)
            return NRGBA64Image(np.ascontiguousarray(pix)), palette, palette_kinds
        return Gray16Image(y), palette, palette_kinds

    if cd == "tc8":
        rgb = rows[:, : width * 3].reshape(height, width, 3)
        if use_transparent:
            tr, tg, tb = transparent[1], transparent[3], transparent[5]
            key = (rgb[..., 0] == tr) & (rgb[..., 1] == tg) & (rgb[..., 2] == tb)
            a = np.where(key, 0, 0xFF).astype(np.uint8)
            pix = np.concatenate([rgb, a[..., None]], axis=-1)
            return NRGBAImage(np.ascontiguousarray(pix)), palette, palette_kinds
        pix = np.concatenate(
            [rgb, np.full((height, width, 1), 0xFF, np.uint8)], axis=-1
        )
        return RGBAImage(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd == "tc16":
        flat = _be16(rows, height, width * 3).reshape(height, width, 3)
        if use_transparent:
            tr = (transparent[0] << 8) | transparent[1]
            tg = (transparent[2] << 8) | transparent[3]
            tb = (transparent[4] << 8) | transparent[5]
            key = (flat[..., 0] == tr) & (flat[..., 1] == tg) & (flat[..., 2] == tb)
            a = np.where(key, 0, 0xFFFF).astype(np.uint16)
            pix = np.concatenate([flat, a[..., None]], axis=-1)
            return NRGBA64Image(np.ascontiguousarray(pix)), palette, palette_kinds
        pix = np.concatenate(
            [flat, np.full((height, width, 1), 0xFFFF, np.uint16)], axis=-1
        )
        return RGBA64Image(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd == "ga8":
        d = rows[:, : width * 2].reshape(height, width, 2)
        y = d[..., 0]
        pix = np.stack([y, y, y, d[..., 1]], axis=-1)
        return NRGBAImage(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd == "ga16":
        d = _be16(rows, height, width * 2).reshape(height, width, 2)
        y = d[..., 0]
        pix = np.stack([y, y, y, d[..., 1]], axis=-1)
        return NRGBA64Image(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd == "tca8":
        pix = rows[:, : width * 4].reshape(height, width, 4)
        return NRGBAImage(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd == "tca16":
        pix = _be16(rows, height, width * 4).reshape(height, width, 4)
        return NRGBA64Image(np.ascontiguousarray(pix)), palette, palette_kinds

    if cd in ("p1", "p2", "p4", "p8"):
        depth = {"p1": 1, "p2": 2, "p4": 4, "p8": 8}[cd]
        idx = rows[:, :width] if depth == 8 else _unpack_bits(rows, width, depth)
        if palette is None:
            raise FormatError("png: missing PLTE for paletted image")
        max_idx = int(idx.max()) if idx.size else 0
        if max_idx >= len(palette):
            # Out-of-range pixel values: extend with opaque black, matching
            # libpng 1.5.13 / Go (decoder.zig:1086-1130 keeps the same slice
            # trick; Go pre-fills the backing store with opaque black).
            extra = max_idx + 1 - len(palette)
            palette = np.concatenate(
                [palette, np.tile(np.array([[0, 0, 0, 0xFF]], np.uint8), (extra, 1))]
            )
            palette_kinds = np.concatenate(
                [palette_kinds, np.full(extra, PALETTE_RGBA, np.uint8)]
            )
        return (
            PalettedImage(idx.copy(), palette, palette_kinds),
            palette,
            palette_kinds,
        )

    raise FormatError(f"png: unsupported color depth {cd}")
