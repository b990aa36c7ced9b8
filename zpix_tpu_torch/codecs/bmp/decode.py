"""BMP header parse: a copy of zpix_tpu/codecs/bmp/decode.py::_read_header
(:30-92), with its error classes and messages.

Mirrors the reference's src/bmp/decoder.zig:42-307: 'BM' signature,
BITMAPINFOHEADER(40)/V4(108)/V5(124), negative height = top-down,
BI_BITFIELDS with the default masks treated as BI_RGB, palette read as
BGRA -> RGBA (a = 0xff), strict pixel-data-offset validation, alpha honored
only for V4/V5 headers.  The pixels themselves are unpacked on the card
(parallel/bmp_batch.py, K18).
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError, UnexpectedEof, UnsupportedError

FILE_HEADER_LEN = 14
INFO_HEADER_LEN = 40
V4_INFO_HEADER_LEN = 108
V5_INFO_HEADER_LEN = 124


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
