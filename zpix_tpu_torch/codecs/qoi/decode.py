"""QOI host decoder: a copy of zpix_tpu/codecs/qoi/decode.py's header parse
and native decode.

Op-stream semantics mirror the reference's src/qoi/decoder.zig:20-147:
OP_RGB/OP_RGBA/OP_INDEX/OP_DIFF/OP_LUMA/OP_RUN over a rolling 64-entry
index keyed by (3r+5g+7b+11a)&63; a stream that runs out before the last
pixel repeats its final pixel (decoder.zig:67-69).  The op walk runs in the
port's copy of ``zpix_qoi_decode`` (csrc/host/qoi.cpp); there is no Python
fallback.  ``decode`` returns the RGBA8 array itself, not an image object.
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError, UnexpectedEof

QOI_HEADER_SIZE = 14
QOI_PADDING_SIZE = 8
QOI_PIXELS_MAX = 400_000_000


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


def decode(data: bytes) -> np.ndarray:
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
