"""PNG decoder: a copy of zpix_tpu/codecs/png/decode.py (chunk walk,
IHDR/PLTE/tRNS, IDAT inflate, Adam7), with its error classes and messages.

Mirrors the reference's src/png/decoder.zig: the chunk-order state machine
(:21-28, :231-324), IHDR validation with the (bit depth x color type) ->
ColorBitDepth matrix (:326-401), per-chunk CRC32 over type+data
(:1264-1277), one zlib stream over the IDATs (:404-545), the 7-pass Adam7
merge (:50-67, :1289-1373).  The host decoder inflates with libdeflate
where the system has it, else ``zlib``, and defilters in the host C++
(``defilter.py``); the batch path (parallel/png_batch.py) shares the
chunk layer and defilters and expands on the card.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ...errors import ChecksumError, FormatError, UnexpectedEof
from ...image import Config
from ...image.model import PALETTE_NRGBA, PALETTE_RGBA
from .defilter import defilter
from .expand import expand_pass

SIGNATURE = b"\x89PNG\r\n\x1a\n"

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


def probe_buffer(buf: bytes) -> bool:
    return buf[:8] == SIGNATURE


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


def decode_config(data: bytes) -> Config:
    if not probe_buffer(data):
        raise FormatError("png: invalid signature")
    for ctype, payload in _walk_chunks(data):
        if ctype == b"IHDR":
            st = _State()
            _parse_ihdr(st, payload)
            model = {
                0: "Gray" if st.depth < 16 else "Gray16",
                2: "RGBA" if st.depth == 8 else "RGBA64",
                3: "Paletted",
                4: "NRGBA" if st.depth == 8 else "NRGBA64",
                6: "NRGBA" if st.depth == 8 else "NRGBA64",
            }[st.color_type]
            return Config(st.width, st.height, model)
        break
    raise FormatError("png: missing IHDR")


def decode(data: bytes):
    if not probe_buffer(data):
        raise FormatError("png: invalid signature")

    st = _State()
    stage = "start"
    idat = bytearray()

    for ctype, payload in _walk_chunks(data):
        if ctype == b"IHDR":
            if stage != "start":
                raise FormatError("png: chunk out of order (IHDR)")
            stage = "seen_ihdr"
            _parse_ihdr(st, payload)
        elif ctype == b"PLTE":
            if stage != "seen_ihdr":
                raise FormatError("png: chunk out of order (PLTE)")
            stage = "seen_plte"
            _parse_plte(st, payload)
        elif ctype == b"tRNS":
            cd = st.color_depth
            if cd in ("p1", "p2", "p4", "p8"):
                if stage != "seen_plte":
                    raise FormatError("png: chunk out of order (tRNS)")
            elif cd in ("tc8", "tc16"):
                if stage not in ("seen_ihdr", "seen_plte"):
                    raise FormatError("png: chunk out of order (tRNS)")
            else:
                if stage != "seen_ihdr":
                    raise FormatError("png: chunk out of order (tRNS)")
            stage = "seen_trns"
            _parse_trns(st, payload)
        elif ctype == b"IDAT":
            if stage in ("start",) or stage == "seen_iend":
                raise FormatError("png: chunk out of order (IDAT)")
            if stage == "seen_ihdr" and st.color_depth.startswith("p"):
                raise FormatError("png: missing PLTE before IDAT")
            stage = "seen_idat"
            idat += payload
        elif ctype == b"IEND":
            if stage != "seen_idat":
                raise FormatError("png: chunk out of order (IEND)")
            stage = "seen_iend"
        # All other chunks are skipped (CRC already verified).

    if stage != "seen_iend":
        raise UnexpectedEof("png: missing IEND")

    bpp_bits = _BITS_PER_PIXEL[st.color_depth]
    bpp = (bpp_bits + 7) // 8

    # the IHDR fixes the inflated size exactly (per pass for Adam7);
    # libdeflate decodes known-size streams 2-3x faster than zlib
    if st.interlace:
        expected = sum(
            ph * (1 + (bpp_bits * pw + 7) // 8)
            for pw, ph in (
                _pass_dims(st.width, st.height, p) for p in range(7)
            )
            if pw > 0 and ph > 0
        )
    else:
        expected = st.height * (1 + (bpp_bits * st.width + 7) // 8)
    from ...runtime import host

    raw = host.zlib_decompress_sized(bytes(idat), expected)
    if raw is None:
        try:
            raw = zlib.decompress(bytes(idat))
        except zlib.error as e:
            raise FormatError(f"png: inflate failed: {e}") from e

    if not st.interlace:
        row_bytes = (bpp_bits * st.width + 7) // 8
        rows = defilter(raw, st.height, row_bytes, bpp)
        img, st.palette, st.palette_kinds = expand_pass(
            rows,
            st.width,
            st.height,
            st.color_depth,
            st.use_transparent,
            bytes(st.transparent),
            st.palette,
            st.palette_kinds,
        )
        return img

    # Adam7: decode 7 sequential sub-images from one stream and scatter.
    full = None
    offset = 0
    for p in range(7):
        pw, ph = _pass_dims(st.width, st.height, p)
        if pw == 0 or ph == 0:
            continue
        row_bytes = (bpp_bits * pw + 7) // 8
        need = ph * (1 + row_bytes)
        rows = defilter(raw[offset : offset + need], ph, row_bytes, bpp)
        offset += need
        pass_img, st.palette, st.palette_kinds = expand_pass(
            rows,
            pw,
            ph,
            st.color_depth,
            st.use_transparent,
            bytes(st.transparent),
            st.palette,
            st.palette_kinds,
        )
        if full is None:
            full = _alloc_like(pass_img, st.width, st.height)
        _merge_pass(full, pass_img, p)
    if full is None:
        raise FormatError("png: no image data")
    if hasattr(full, "palette"):
        # Palette may have been extended during later passes
        # (decoder.zig:1337-1345 reconciles lengths on merge).
        full.palette = st.palette
        full.palette_kinds = st.palette_kinds
    return full


def _alloc_like(pass_img, width: int, height: int):
    """Allocate a full-size zeroed image of pass_img's concrete type."""
    from ...image import PalettedImage

    cls = type(pass_img)
    shape = (height, width) + pass_img.pix.shape[2:]
    pix = np.zeros(shape, pass_img.pix.dtype)
    if isinstance(pass_img, PalettedImage):
        return PalettedImage(pix, pass_img.palette, pass_img.palette_kinds)
    return cls(pix)


def _merge_pass(dst, src, p: int) -> None:
    """Strided scatter of one Adam7 pass (decoder.zig:1289-1373)."""
    xo, yo, xf, yf = INTERLACING[p]
    ph, pw = src.pix.shape[0], src.pix.shape[1]
    dst.pix[yo : yo + ph * yf : yf, xo : xo + pw * xf : xf] = src.pix
