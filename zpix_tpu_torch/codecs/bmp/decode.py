"""BMP decoder: a copy of zpix_tpu/codecs/bmp/decode.py, with its error
classes and messages.

Mirrors the reference's src/bmp/decoder.zig:42-307: 'BM' signature,
BITMAPINFOHEADER(40)/V4(108)/V5(124), negative height = top-down,
BI_BITFIELDS with the default masks treated as BI_RGB, palette read as
BGRA -> RGBA (a = 0xff), strict pixel-data-offset validation, 4-byte-aligned
rows, MSB-first bit unpack for paletted, BGR(A) -> RGB(A) swizzle, alpha
honored only for V4/V5 headers.  The batch path (parallel/bmp_batch.py)
shares ``_read_header`` and unpacks the pixels on the card (K18).

One deliberate difference: an index past a short palette reads
(0, 0, 0, 0), as the batch path gives it, where zpix_tpu's host decoder
raises ``IndexError`` (``decode`` pads such a palette with entries that
premultiply to 0).
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError, UnexpectedEof, UnsupportedError
from ...image import Config, NRGBAImage, PalettedImage, RGBAImage
from ...image.model import PALETTE_NRGBA, PALETTE_RGBA

FILE_HEADER_LEN = 14
INFO_HEADER_LEN = 40
V4_INFO_HEADER_LEN = 108
V5_INFO_HEADER_LEN = 124


def probe_buffer(buf: bytes) -> bool:
    return len(buf) >= 2 and buf[:2] == b"BM"


def _read_header(data: bytes):
    """-> (width, height, top_down, bpp, allow_alpha, palette [n, 4] u8 RGBA
    or None, pixel_data_offset)."""
    if len(data) < FILE_HEADER_LEN + 4:
        raise UnexpectedEof("bmp: truncated header")
    if data[:2] != b"BM":
        raise FormatError("bmp: invalid signature")
    pixel_data_offset = struct.unpack_from("<I", data, 10)[0]
    info_len = struct.unpack_from("<I", data, 14)[0]
    if info_len not in (INFO_HEADER_LEN, V4_INFO_HEADER_LEN, V5_INFO_HEADER_LEN):
        raise UnsupportedError("bmp: unsupported header version")
    if len(data) < FILE_HEADER_LEN + info_len:
        raise UnexpectedEof("bmp: truncated info header")

    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    top_down = height < 0
    if top_down:
        height = -height
    if width < 0 or height < 0:
        raise UnsupportedError("bmp: unsupported dimensions")

    planes = struct.unpack_from("<H", data, 26)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    compression = struct.unpack_from("<I", data, 30)[0]

    if compression == 3 and info_len > INFO_HEADER_LEN:
        red_mask, green_mask, blue_mask, alpha_mask = struct.unpack_from("<IIII", data, 54)
        if (
            red_mask == 0xFF0000
            and green_mask == 0x00FF00
            and blue_mask == 0x0000FF
            and alpha_mask == 0xFF000000
        ):
            compression = 0
    if planes != 1 or compression != 0:
        raise UnsupportedError("bmp: unsupported compression")

    allow_alpha = info_len > INFO_HEADER_LEN
    palette = None
    if bpp in (1, 2, 4, 8):
        color_used = struct.unpack_from("<I", data, 46)[0]
        if color_used == 0:
            color_used = 1 << bpp
        elif color_used > (1 << bpp):
            raise UnsupportedError("bmp: unsupported palette size")
        if pixel_data_offset != FILE_HEADER_LEN + info_len + color_used * 4:
            raise UnsupportedError("bmp: unsupported color offset")
        pal_start = FILE_HEADER_LEN + info_len
        pal_bytes = data[pal_start : pal_start + color_used * 4]
        if len(pal_bytes) < color_used * 4:
            raise UnexpectedEof("bmp: truncated palette")
        bgra = np.frombuffer(pal_bytes, np.uint8).reshape(color_used, 4)
        palette = np.empty((color_used, 4), np.uint8)
        palette[:, 0] = bgra[:, 2]
        palette[:, 1] = bgra[:, 1]
        palette[:, 2] = bgra[:, 0]
        palette[:, 3] = 0xFF
    elif bpp in (24, 32):
        if pixel_data_offset != FILE_HEADER_LEN + info_len:
            raise UnsupportedError("bmp: unsupported color offset")
    else:
        raise UnsupportedError(f"bmp: unsupported bit depth {bpp}")

    return width, height, top_down, bpp, allow_alpha, palette, pixel_data_offset


def row_bytes(width: int, bpp: int) -> int:
    """Bytes of one stored row (zpix_tpu/parallel/bmp_batch.py:91-97)."""
    if bpp in (1, 2, 4, 8):
        per_byte = 8 // bpp
        return ((width + per_byte - 1) // per_byte + 3) & ~3
    if bpp == 24:
        return (3 * width + 3) & ~3
    return 4 * width


def decode_config(data: bytes) -> Config:
    width, height, _, bpp, _, _, _ = _read_header(data)
    model = {1: "Paletted", 2: "Paletted", 4: "Paletted", 8: "Paletted", 24: "RGBA", 32: "NRGBA"}[bpp]
    return Config(width, height, model)


def _row_order(height: int, top_down: bool):
    return range(height) if top_down else range(height - 1, -1, -1)


def _paletted(pix: np.ndarray, palette: np.ndarray, bpp: int) -> PalettedImage:
    """The paletted image; a palette that an index passes is padded to
    2^bpp entries with transparent black (kind NRGBA, alpha 0), so those
    indices read (0, 0, 0, 0) -- K18's value -- and the rest are as
    zpix_tpu's."""
    n = len(palette)
    if pix.size == 0 or int(pix.max()) < n:
        return PalettedImage(pix, palette)
    extra = (1 << bpp) - n
    kinds = np.concatenate([np.full(n, PALETTE_RGBA, np.uint8),
                            np.full(extra, PALETTE_NRGBA, np.uint8)])
    return PalettedImage(pix, np.concatenate([palette, np.zeros((extra, 4), np.uint8)]), kinds)


def decode(data: bytes):
    width, height, top_down, bpp, allow_alpha, palette, offset = _read_header(data)
    body = data[offset:]

    if bpp in (1, 2, 4, 8):
        pix = np.zeros((height, width), np.uint8)
        per_byte = 8 // bpp
        row_bytes = ((width + per_byte - 1) // per_byte + 3) & ~3
        need = row_bytes * height if width > 0 and height > 0 else 0
        if len(body) < need:
            raise UnexpectedEof("bmp: truncated pixel data")
        if need:
            rows = np.frombuffer(body[:need], np.uint8).reshape(height, row_bytes)
            if bpp == 8:
                vals = rows[:, :width]
            else:
                bits = np.unpackbits(rows, axis=1)
                grouped = bits.reshape(height, -1, bpp)
                weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
                vals = (grouped * weights).sum(axis=2).astype(np.uint8)[:, :width]
            order = np.array(list(_row_order(height, top_down)))
            pix[order] = vals
        return _paletted(pix, palette, bpp)

    if bpp == 24:
        pix = np.zeros((height, width, 4), np.uint8)
        row_bytes = (3 * width + 3) & ~3
        need = row_bytes * height if width > 0 and height > 0 else 0
        if len(body) < need:
            raise UnexpectedEof("bmp: truncated pixel data")
        if need:
            rows = np.frombuffer(body[:need], np.uint8).reshape(height, row_bytes)
            bgr = rows[:, : 3 * width].reshape(height, width, 3)
            order = np.array(list(_row_order(height, top_down)))
            pix[order, :, 0] = bgr[:, :, 2]
            pix[order, :, 1] = bgr[:, :, 1]
            pix[order, :, 2] = bgr[:, :, 0]
            pix[:, :, 3] = 0xFF
        return RGBAImage(pix)

    # bpp == 32
    pix = np.zeros((height, width, 4), np.uint8)
    row_bytes = 4 * width
    need = row_bytes * height if width > 0 and height > 0 else 0
    if len(body) < need:
        raise UnexpectedEof("bmp: truncated pixel data")
    if need:
        rows = np.frombuffer(body[:need], np.uint8).reshape(height, width, 4)
        order = np.array(list(_row_order(height, top_down)))
        pix[order, :, 0] = rows[:, :, 2]
        pix[order, :, 1] = rows[:, :, 1]
        pix[order, :, 2] = rows[:, :, 0]
        pix[order, :, 3] = rows[:, :, 3] if allow_alpha else 0xFF
    return NRGBAImage(pix)
