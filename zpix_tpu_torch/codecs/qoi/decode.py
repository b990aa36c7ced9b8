"""QOI host decoder: a copy of zpix_tpu/codecs/qoi/decode.py.

Op-stream semantics mirror the reference's src/qoi/decoder.zig:20-147:
OP_RGB/OP_RGBA/OP_INDEX/OP_DIFF/OP_LUMA/OP_RUN over a rolling 64-entry
index keyed by (3r+5g+7b+11a)&63; a stream that runs out before the last
pixel repeats its final pixel (decoder.zig:67-69).  The result is an
``RGBAImage`` of the stream's values, unchanged, as the reference stores
them.

The op walk runs in the port's copy of ``zpix_qoi_decode``
(csrc/host/qoi.cpp), which the host library always builds; there is no
Python op walk.  zpix_tpu walks in Python only without its library or
when the C++ returns a code other than 0 and 2.  The C++ returns 1 only
for a stream shorter than header plus padding, and ``_parse_header``
refuses that first ("qoi: data too short"); 2 is a truncated op stream.
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError, UnexpectedEof
from ...image import Config, Rectangle, RGBAImage

QOI_HEADER_SIZE = 14
QOI_PADDING_SIZE = 8
QOI_PIXELS_MAX = 400_000_000


def probe_buffer(buf: bytes) -> bool:
    return len(buf) >= 4 and buf[:4] == b"qoif"


def _parse_header(data: bytes):
    """-> (width, height, channels, colorspace), as zpix_tpu parses it."""
    if len(data) < QOI_HEADER_SIZE + QOI_PADDING_SIZE:
        raise FormatError("qoi: data too short")
    magic, width, height, channels, colorspace = struct.unpack(">IIIBB", data[:QOI_HEADER_SIZE])
    if magic != 0x716F6966:
        raise FormatError("qoi: bad magic")
    if (
        width == 0
        or height == 0
        or channels not in (3, 4)
        or colorspace > 1
        or height >= QOI_PIXELS_MAX // width
    ):
        raise FormatError("qoi: bad header")
    return width, height, channels, colorspace


def decode_config(data: bytes) -> Config:
    w, h, _, _ = _parse_header(data)
    return Config(w, h, "RGBA")


def decode(data: bytes) -> RGBAImage:
    pix = decode_pixels(data)
    h, w = pix.shape[:2]
    return RGBAImage(pix, Rectangle.init(0, 0, w, h))


def decode_pixels(data: bytes) -> np.ndarray:
    """QOI bytes -> RGBA8 [H, W, 4] uint8 (the stream's values, unchanged)."""
    from ...runtime import host

    width, height, _, _ = _parse_header(data)
    out = np.empty((height, width, 4), np.uint8)
    rc = host.lib().zpix_qoi_decode(data, len(data), width * height, out.ctypes.data)
    if rc == 2:
        raise UnexpectedEof("qoi: truncated op stream")
    if rc:
        raise FormatError(f"qoi: decode failed (rc={rc})")
    return out
