"""A plain QOI decoder (the QOI specification, qoiformat.org, v1.0): one
op at a time in Python, the raster assembled with NumPy.

It imports nothing of the program.  ``decode(data)`` -> uint8 [H, W, 4]
RGBA (a 3-channel file's alpha reads 255, as the specification's
decoder gives it).  ``restart_every=n`` is the benchmark's control: the
decoder's state (previous pixel and the 64-entry index) is reset at the
first op of every n-byte chunk of the op stream, as a chunk-parallel
decode that trusts its first guess at every chunk start would read it.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER = 14
PADDING = 8


def header(data: bytes) -> tuple[int, int, int, int]:
    """-> (width, height, channels, colorspace)."""
    magic, w, h, ch, cs = struct.unpack(">4sIIBB", data[:HEADER])
    if magic != b"qoif" or w == 0 or h == 0 or ch not in (3, 4):
        raise ValueError("qoi: bad header")
    return w, h, ch, cs


def decode(data: bytes, *, restart_every: int | None = None) -> np.ndarray:
    w, h, _, _ = header(data)
    n = w * h
    end = len(data) - PADDING
    index = [0] * 64  # packed r | g << 8 | b << 16 | a << 24
    r, g, b, a = 0, 0, 0, 255
    colours, counts = [], []
    total = 0
    p = HEADER
    next_restart = HEADER + restart_every if restart_every else end + 1
    while total < n and p < end:
        if p >= next_restart:
            while next_restart <= p:
                next_restart += restart_every
            index = [0] * 64
            r, g, b, a = 0, 0, 0, 255
        b1 = data[p]
        run = 1
        if b1 == 0xFE:
            r, g, b = data[p + 1], data[p + 2], data[p + 3]
            p += 4
        elif b1 == 0xFF:
            r, g, b, a = data[p + 1], data[p + 2], data[p + 3], data[p + 4]
            p += 5
        else:
            tag = b1 >> 6
            if tag == 0:  # QOI_OP_INDEX
                v = index[b1]
                r, g, b, a = v & 255, (v >> 8) & 255, (v >> 16) & 255, v >> 24
                p += 1
            elif tag == 1:  # QOI_OP_DIFF
                r = (r + ((b1 >> 4) & 3) - 2) & 255
                g = (g + ((b1 >> 2) & 3) - 2) & 255
                b = (b + (b1 & 3) - 2) & 255
                p += 1
            elif tag == 2:  # QOI_OP_LUMA
                b2 = data[p + 1]
                dg = (b1 & 63) - 32
                r = (r + dg - 8 + (b2 >> 4)) & 255
                g = (g + dg) & 255
                b = (b + dg - 8 + (b2 & 15)) & 255
                p += 2
            else:  # QOI_OP_RUN
                run = (b1 & 63) + 1
                p += 1
        v = r | g << 8 | b << 16 | a << 24
        index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = v
        run = min(run, n - total)
        colours.append(v)
        counts.append(run)
        total += run
    if total < n:  # the stream ended early: the last pixel fills the rest
        colours.append(r | g << 8 | b << 16 | a << 24)
        counts.append(n - total)
    px = np.repeat(np.asarray(colours, np.uint32), np.asarray(counts, np.int64))
    return px.astype("<u4").view(np.uint8).reshape(h, w, 4)
