"""A numpy BMP writer: the inputs of the BMP tests and of ``chip_smoke.py``.

Writes every layout the decoder reads: 1/2/4/8 bpp with a palette of up to
2^bpp entries, 24 and 32 bpp, BITMAPINFOHEADER (40), V4 (108) and V5 (124)
headers, bottom-up or top-down rows, each padded to 4 bytes as
zpix_tpu/codecs/bmp/decode.py reads them.  A 32-bit image with a V4/V5
header is written BI_BITFIELDS with the default masks, which the decoder
takes as BI_RGB with alpha; any other image is written BI_RGB.
"""

from __future__ import annotations

import struct

import numpy as np

from .decode import FILE_HEADER_LEN, INFO_HEADER_LEN, row_bytes


def encode(pixels, *, bpp: int, info_len: int = INFO_HEADER_LEN, top_down: bool = False,
           palette=None) -> bytes:
    """``pixels``: indices [H, W] (bpp 1-8, with ``palette`` [n, 3 or 4] RGB(A),
    n <= 2^bpp; alpha is not stored), RGB [H, W, 3] (24) or RGBA [H, W, 4]
    (32) uint8 -> BMP bytes."""
    pix = np.asarray(pixels, np.uint8)
    height, width = pix.shape[:2]
    stride = row_bytes(width, bpp)
    if bpp in (1, 2, 4, 8):
        pal = np.asarray(palette, np.uint8)
        n_colors = pal.shape[0]
        bits = (pix[..., None] >> np.arange(bpp - 1, -1, -1, dtype=np.uint8)) & 1
        bits = bits.reshape(height, width * bpp)
        rows = np.packbits(np.pad(bits, ((0, 0), (0, stride * 8 - width * bpp))), axis=1)
        table = np.zeros((n_colors, 4), np.uint8)
        table[:, :3] = pal[:, 2::-1]  # stored BGR0
        table = table.tobytes()
    else:
        n_colors, table = 0, b""
        order = [2, 1, 0] if bpp == 24 else [2, 1, 0, 3]
        rows = np.zeros((height, stride), np.uint8)
        rows[:, : width * len(order)] = pix[..., order].reshape(height, -1)
    if not top_down:
        rows = rows[::-1]
    offset = FILE_HEADER_LEN + info_len + len(table)
    bitfields = bpp == 32 and info_len > INFO_HEADER_LEN
    info = struct.pack("<IiiHHIIiiII", info_len, width, -height if top_down else height, 1, bpp,
                       3 if bitfields else 0, stride * height, 2835, 2835, n_colors, 0)
    if info_len > INFO_HEADER_LEN:
        masks = (0xFF0000, 0x00FF00, 0x0000FF, 0xFF000000) if bitfields else (0, 0, 0, 0)
        info += struct.pack("<IIII", *masks)
        info += bytes(info_len - len(info))
    body = np.ascontiguousarray(rows).tobytes()
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + table + body
