"""PNG chunk layer: a copy of zpix_tpu/codecs/png/decode.py's chunk walk,
IHDR/PLTE/tRNS parse and Adam7 pass geometry (:24-73, :80-215), with its
error classes and messages, and of the palette entry kinds of
zpix_tpu/image/model.py (:289-290).

Mirrors the reference's src/png/decoder.zig: IHDR validation with the
(bit depth x color type) -> ColorBitDepth matrix (:326-401), per-chunk
CRC32 over type+data (:1264-1277), the Adam7 pass table (:58-67).  The
host ``decode``, its defilter and its expansion are not copied: the
device path (parallel/png_batch.py) inflates on the host and defilters
and expands on the card.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ...errors import ChecksumError, FormatError, UnexpectedEof

SIGNATURE = b"\x89PNG\r\n\x1a\n"

PALETTE_RGBA = 0  # entry from PLTE: opaque, premultiplied-trivial
PALETTE_NRGBA = 1  # entry rewritten by tRNS: non-premultiplied alpha

# Adam7 passes: (x_offset, y_offset, x_factor, y_factor)
INTERLACING = [
    (0, 0, 8, 8),
    (4, 0, 8, 8),
    (0, 4, 4, 8),
    (2, 0, 4, 4),
    (0, 2, 2, 4),
    (1, 0, 2, 2),
    (0, 1, 1, 2),
]

# (color_type, bit_depth) -> ColorBitDepth
_DEPTHS = {
    (0, 1): "g1",
    (0, 2): "g2",
    (0, 4): "g4",
    (0, 8): "g8",
    (0, 16): "g16",
    (2, 8): "tc8",
    (2, 16): "tc16",
    (3, 1): "p1",
    (3, 2): "p2",
    (3, 4): "p4",
    (3, 8): "p8",
    (4, 8): "ga8",
    (4, 16): "ga16",
    (6, 8): "tca8",
    (6, 16): "tca16",
}

_BITS_PER_PIXEL = {
    "g1": 1,
    "g2": 2,
    "g4": 4,
    "g8": 8,
    "g16": 16,
    "ga8": 16,
    "ga16": 32,
    "tc8": 24,
    "tc16": 48,
    "tca8": 32,
    "tca16": 64,
    "p1": 1,
    "p2": 2,
    "p4": 4,
    "p8": 8,
}


class _State:
    __slots__ = (
        "width",
        "height",
        "depth",
        "color_type",
        "color_depth",
        "interlace",
        "palette",
        "palette_kinds",
        "use_transparent",
        "transparent",
    )

    def __init__(self):
        self.width = 0
        self.height = 0
        self.depth = 0
        self.color_type = 0
        self.color_depth = ""
        self.interlace = False
        self.palette = None
        self.palette_kinds = None
        self.use_transparent = False
        self.transparent = bytearray(6)


def _walk_chunks(data: bytes):
    """Yield (type, payload) with per-chunk CRC verification."""
    pos = 8
    n = len(data)
    while pos < n:
        if pos + 8 > n:
            raise UnexpectedEof("png: truncated chunk header")
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        if pos + 8 + length + 4 > n:
            raise UnexpectedEof("png: truncated chunk")
        payload = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + payload) & 0xFFFFFFFF != crc:
            raise ChecksumError(f"png: CRC mismatch in {ctype!r}")
        yield ctype, payload
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise UnexpectedEof("png: missing IEND")


def _parse_ihdr(st: _State, payload: bytes) -> None:
    if len(payload) != 13:
        raise FormatError("png: bad IHDR length")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if comp != 0:
        raise FormatError("png: unsupported compression method")
    if filt != 0:
        raise FormatError("png: unsupported filter method")
    if interlace not in (0, 1):
        raise FormatError("png: invalid interlace method")
    if w == 0 or h == 0 or w > (1 << 31) - 1 or h > (1 << 31) - 1:
        raise FormatError("png: invalid dimensions")
    # w * h * 8 overflow check (decoder.zig:352-359)
    if w * h * 8 >= 1 << 63:
        raise FormatError("png: dimension overflow")
    key = (ctype, depth)
    if key not in _DEPTHS:
        raise FormatError(f"png: invalid color type/bit depth combination {key}")
    st.width = w
    st.height = h
    st.depth = depth
    st.color_type = ctype
    st.color_depth = _DEPTHS[key]
    st.interlace = interlace == 1


def _parse_plte(st: _State, payload: bytes) -> None:
    if len(payload) % 3 != 0:
        raise FormatError("png: bad PLTE length")
    n = len(payload) // 3
    if n == 0 or n > 256 or n > (1 << st.depth):
        raise FormatError("png: bad PLTE length")
    if st.color_depth in ("p1", "p2", "p4", "p8"):
        rgb = np.frombuffer(payload, np.uint8).reshape(n, 3)
        pal = np.concatenate([rgb, np.full((n, 1), 0xFF, np.uint8)], axis=1)
        st.palette = pal
        st.palette_kinds = np.full(n, PALETTE_RGBA, np.uint8)
    elif st.color_depth in ("tc8", "tca8", "tc16", "tca16"):
        pass  # ignorable for truecolor (decoder.zig:638-641)
    else:
        raise FormatError("png: PLTE color type mismatch")


def _parse_trns(st: _State, payload: bytes) -> None:
    cd = st.color_depth
    if cd in ("g1", "g2", "g4", "g8", "g16"):
        if len(payload) != 2:
            raise FormatError("png: bad tRNS length")
        st.transparent[0:2] = payload
        mult = {"g1": 0xFF, "g2": 0x55, "g4": 0x11}.get(cd, 1)
        st.transparent[1] = (st.transparent[1] * mult) & 0xFF
        st.use_transparent = True
    elif cd in ("tc8", "tc16"):
        if len(payload) != 6:
            raise FormatError("png: bad tRNS length")
        st.transparent[0:6] = payload
        st.use_transparent = True
    elif cd in ("p1", "p2", "p4", "p8"):
        if len(payload) > 256:
            raise FormatError("png: bad tRNS length")
        n = len(payload)
        if st.palette is None:
            raise FormatError("png: tRNS before PLTE")
        if len(st.palette) < n:
            # Go keeps a 256-entry opaque-black backing store; extending the
            # palette to tRNS length yields black entries (decoder.zig:584-586).
            extra = n - len(st.palette)
            st.palette = np.concatenate(
                [st.palette, np.tile(np.array([[0, 0, 0, 0xFF]], np.uint8), (extra, 1))]
            )
            st.palette_kinds = np.concatenate(
                [st.palette_kinds, np.full(extra, PALETTE_RGBA, np.uint8)]
            )
        alphas = np.frombuffer(payload, np.uint8)
        st.palette = st.palette.copy()
        st.palette[:n, 3] = alphas
        st.palette_kinds = st.palette_kinds.copy()
        st.palette_kinds[:n] = PALETTE_NRGBA
    else:
        raise FormatError("png: tRNS color type mismatch")


def _pass_dims(w: int, h: int, p: int):
    xo, yo, xf, yf = INTERLACING[p]
    pw = (w - xo + xf - 1) // xf if w > xo else 0
    ph = (h - yo + yf - 1) // yf if h > yo else 0
    return pw, ph
