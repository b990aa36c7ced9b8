"""PNG row defiltering: a copy of zpix_tpu/codecs/png/defilter.py.

Filter semantics mirror the reference's src/png/decoder.zig:806-842 and
filterPaeth (:1152-1182): a filter byte a row selects None/Sub/Up/Average/
Paeth; all adds wrap mod 256; Paeth ties break a <= b <= c.

``defilter`` runs the port's copy of ``zpix_defilter``
(csrc/host/defilter.cpp), which the host library always builds, so the
decoder has no Python fallback.  ``defilter_plain`` is the numpy row
loop, kept as that function's plain version for the tests.  Each keeps
zpix_tpu's wording of a bad filter byte on its own path: the C++ path
says "png: invalid filter type", the numpy path names the byte.
"""

from __future__ import annotations

import numpy as np

from ...errors import FormatError

FILT_NONE = 0
FILT_SUB = 1
FILT_UP = 2
FILT_AVERAGE = 3
FILT_PAETH = 4


def _paeth_predict(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Vectorized Paeth predictor with the spec's tie-break order."""
    a16 = a.astype(np.int16)
    b16 = b.astype(np.int16)
    c16 = c.astype(np.int16)
    p = a16 + b16 - c16
    pa = np.abs(p - a16)
    pb = np.abs(p - b16)
    pc = np.abs(p - c16)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _check_length(raw, height: int, row_bytes: int) -> int:
    need = height * (1 + row_bytes)
    if len(raw) < need:
        raise FormatError(f"png: not enough image data: have {len(raw)}, want {need}")
    return need


def defilter(raw, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Defilter ``height`` rows of ``1 + row_bytes`` bytes each.

    ``raw`` is the inflated byte stream (1 filter byte + row data per row);
    returns (height, row_bytes) uint8 of reconstructed scanline bytes.
    """
    from ...runtime import host

    need = _check_length(raw, height, row_bytes)
    out = np.empty((height, row_bytes), np.uint8)
    rc = host.lib().zpix_defilter(
        bytes(raw[:need]) if not isinstance(raw, bytes) else raw[:need],
        height, row_bytes, bpp, out.ctypes.data)
    if rc != 0:
        raise FormatError("png: invalid filter type")
    return out


def defilter_plain(raw, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """``defilter`` as a numpy row loop (zpix_tpu's path without its
    library): the same bytes, and the bad filter byte named."""
    need = _check_length(raw, height, row_bytes)
    rows = np.frombuffer(raw[:need], np.uint8).reshape(height, 1 + row_bytes)
    filters = rows[:, 0]
    data = rows[:, 1:].copy()

    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    nsteps = (row_bytes + bpp - 1) // bpp
    for y in range(height):
        f = filters[y]
        cur = data[y]
        if f == FILT_NONE:
            pass
        elif f == FILT_SUB:
            for s in range(1, nsteps):
                lo = s * bpp
                hi = min(lo + bpp, row_bytes)
                cur[lo:hi] += cur[lo - bpp : lo - bpp + (hi - lo)]
        elif f == FILT_UP:
            cur += prev
        elif f == FILT_AVERAGE:
            cur[:bpp] += prev[:bpp] // 2
            for s in range(1, nsteps):
                lo = s * bpp
                hi = min(lo + bpp, row_bytes)
                left = cur[lo - bpp : lo - bpp + (hi - lo)].astype(np.uint16)
                up = prev[lo:hi].astype(np.uint16)
                cur[lo:hi] += ((left + up) // 2).astype(np.uint8)
        elif f == FILT_PAETH:
            cur[:bpp] += prev[:bpp]
            for s in range(1, nsteps):
                lo = s * bpp
                hi = min(lo + bpp, row_bytes)
                a = cur[lo - bpp : lo - bpp + (hi - lo)]
                b = prev[lo:hi]
                c = prev[lo - bpp : lo - bpp + (hi - lo)]
                cur[lo:hi] += _paeth_predict(a, b, c)
        else:
            raise FormatError(f"png: invalid filter type {f}")
        out[y] = cur
        prev = cur
    return out
