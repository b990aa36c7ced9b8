"""QOI host encoder: a copy of zpix_tpu/codecs/qoi/encode.py through the
port's copy of ``zpix_qoi_encode`` (csrc/host/qoi.cpp).

Mirrors the reference's src/qoi/encoder.zig:29-151: op priority
run -> index -> diff -> luma -> rgb/rgba, 62-pixel run cap, run also
flushed on the final pixel, 8-byte end padding 0...01.  It is the oracle
of the device encoder (parallel/qoi_batch.py::encode_device) and makes the
content of ``chip_smoke.py``'s QOI phases.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ...errors import FormatError
from .decode import QOI_PIXELS_MAX

PADDING = bytes([0, 0, 0, 0, 0, 0, 0, 1])


@dataclass
class Desc:
    """Encode parameters (the reference's src/qoi/encoder.zig:20-25)."""

    width: int
    height: int
    channels: int  # 3 = RGB, 4 = RGBA
    colorspace: int  # 0 = sRGB + linear alpha, 1 = all linear


def check_desc(desc) -> None:
    if (
        desc.width == 0
        or desc.height == 0
        or desc.channels not in (3, 4)
        or desc.colorspace > 1
        or desc.height >= QOI_PIXELS_MAX // desc.width
    ):
        raise FormatError("qoi: bad encode descriptor")


def header(desc) -> bytes:
    return struct.pack(">IIIBB", 0x716F6966, desc.width, desc.height, desc.channels,
                       desc.colorspace)


def encode(pixels, desc: Desc) -> bytes:
    """Pixels (uint8, ``desc.channels`` a pixel, row-major) -> QOI bytes."""
    from ...runtime import host

    check_desc(desc)
    pix = np.asarray(pixels, np.uint8).reshape(-1)
    n = desc.width * desc.height
    if len(pix) < n * desc.channels:
        raise FormatError("qoi: pixel buffer too small")
    src = np.ascontiguousarray(pix[: n * desc.channels])
    cap = n * (desc.channels + 1) + 22  # the serial encoder's worst case fits
    buf = np.empty(cap, np.uint8)
    written = host.lib().zpix_qoi_encode(src.ctypes.data, n, desc.channels, buf.ctypes.data, cap)
    if written < 0:
        raise RuntimeError("qoi: encode buffer overflow")
    return header(desc) + buf[:written].tobytes() + PADDING
