"""Vectorized exact-integer color conversions.

Every function operates on numpy integer arrays (any shape, broadcastable)
and reproduces the reference's fixed-point arithmetic exactly:

* YCbCr -> RGB: coefficients 91881 / 22554 / 46802 / 116130 with the
  branchless sign-trick clamp (zpix src/color/color.zig:95-113 for
  the 16-bit form, zpix src/image/util.zig:45-77 for the 8-bit
  form used on the JPEG hot path).
* RGB -> YCbCr: JFIF forward transform, coefficients 19595/38470/7471 etc.
  (zpix src/color/color.zig:204-251).
* CMYK <-> RGB (zpix src/color/color.zig:115-121, :254-275).

All math is done in int64 where intermediate products can exceed int32 range
is impossible here (|y*0x10101 + 116130*127| < 2^31), so int32 suffices and
matches the reference's i32 semantics including arithmetic right shift.
"""

import numpy as np


def _clamp_shift(v: np.ndarray, shift: int, mask: int) -> np.ndarray:
    """The reference's branchless clamp: if the value fits in 24 bits the
    result is ``v >> shift``; otherwise negatives clamp to 0 and overflows to
    ``mask`` via ``~(v >> 31) & mask``.

    Mirrors zpix src/color/color.zig:100-106 (shift=8, mask=0xffff)
    and zpix src/image/util.zig:58-77 (shift=16, mask=0xff).
    """
    v = v.astype(np.int32, copy=False)
    # (u32)v & 0xff000000 == 0  <=>  0 <= v <= 0xffffff
    in_range = (v.astype(np.int64) & np.int64(0xFF000000)) == 0
    clamped = (~(v >> np.int32(31))) & np.int32(mask)
    return np.where(in_range, v >> np.int32(shift), clamped)


def ycbcr_to_rgb8(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """YCbCr -> 8-bit RGB, exact vs the reference's drawYCbCr kernel.

    Inputs are uint8 arrays (broadcastable); returns three uint8 arrays.
    Reference: zpix src/image/util.zig:40-86.
    """
    yy1 = y.astype(np.int32) * np.int32(0x10101)
    cb1 = cb.astype(np.int32) - np.int32(128)
    cr1 = cr.astype(np.int32) - np.int32(128)

    r = _clamp_shift(yy1 + np.int32(91881) * cr1, 16, 0xFF)
    g = _clamp_shift(yy1 - np.int32(22554) * cb1 - np.int32(46802) * cr1, 16, 0xFF)
    b = _clamp_shift(yy1 + np.int32(116130) * cb1, 16, 0xFF)
    return r.astype(np.uint8), g.astype(np.uint8), b.astype(np.uint8)


def ycbcr_to_rgba16(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """YCbCr -> 16-bit premultiplied RGBA channels (alpha constant 0xffff).

    Reference: Color.toRGBA ycbcr arm zpix src/color/color.zig:90-114.
    Returns int32 arrays in [0, 0xffff].
    """
    yy1 = y.astype(np.int32) * np.int32(0x10101)
    cb1 = cb.astype(np.int32) - np.int32(128)
    cr1 = cr.astype(np.int32) - np.int32(128)

    r = _clamp_shift(yy1 + np.int32(91881) * cr1, 8, 0xFFFF)
    g = _clamp_shift(yy1 - np.int32(22554) * cb1 - np.int32(46802) * cr1, 8, 0xFFFF)
    b = _clamp_shift(yy1 + np.int32(116130) * cb1, 8, 0xFFFF)
    return r, g, b


def rgb_to_ycbcr(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """RGB -> YCbCr, JFIF forward transform.

    Reference: zpix src/color/color.zig:204-251.  The reference's
    literal Zig expression ``sum + 1 << 15`` parses (Zig shift binds looser
    than ``+``) as ``(sum + 1) << 15`` which overflows i32 and traps in safe
    builds — an untested-broken path upstream.  We implement the documented
    intent (Go's image/color semantics, the comment block at color.zig:220-234):
    ``(sum + 1<<15) >> 16`` with the branchless clamp on cb/cr.
    """
    r1 = r.astype(np.int32)
    g1 = g.astype(np.int32)
    b1 = b.astype(np.int32)

    yy = (np.int32(19595) * r1 + np.int32(38470) * g1 + np.int32(7471) * b1 + (np.int32(1) << np.int32(15))) >> np.int32(16)

    cb = np.int32(-11056) * r1 - np.int32(21712) * g1 + np.int32(32768) * b1 + (np.int32(257) << np.int32(15))
    cr = np.int32(32768) * r1 - np.int32(27440) * g1 - np.int32(5328) * b1 + (np.int32(257) << np.int32(15))

    def _fold(v):
        # if (v & 0xff000000 == 0) v >>= 16 else v = ~(v >> 31)  (u8 truncate)
        in_range = (v.astype(np.int64) & np.int64(0xFF000000)) == 0
        return np.where(in_range, v >> np.int32(16), ~(v >> np.int32(31)))

    return (
        yy.astype(np.uint8),
        _fold(cb).astype(np.uint8),
        _fold(cr).astype(np.uint8),
    )


def rgb_to_cmyk(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """RGB -> CMYK. Reference: zpix src/color/color.zig:254-275."""
    rr = r.astype(np.uint32)
    gg = g.astype(np.uint32)
    bb = b.astype(np.uint32)
    w = np.maximum(np.maximum(rr, gg), bb)
    w_safe = np.where(w == 0, np.uint32(1), w)
    c = (w - rr) * np.uint32(0xFF) // w_safe
    m = (w - gg) * np.uint32(0xFF) // w_safe
    y = (w - bb) * np.uint32(0xFF) // w_safe
    k = np.uint32(0xFF) - w
    zero = w == 0
    c = np.where(zero, 0, c).astype(np.uint8)
    m = np.where(zero, 0, m).astype(np.uint8)
    y = np.where(zero, 0, y).astype(np.uint8)
    k = np.where(zero, 0xFF, k).astype(np.uint8)
    return c, m, y, k


def cmyk_to_rgba16(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray):
    """CMYK -> 16-bit RGBA channels.

    Reference: Color.toRGBA cmyk arm zpix src/color/color.zig:115-121.
    """
    w = np.uint32(0xFFFF) - k.astype(np.uint32) * np.uint32(0x101)
    r = (np.uint32(0xFFFF) - c.astype(np.uint32) * np.uint32(0x101)) * w // np.uint32(0xFFFF)
    g = (np.uint32(0xFFFF) - m.astype(np.uint32) * np.uint32(0x101)) * w // np.uint32(0xFFFF)
    b = (np.uint32(0xFFFF) - y.astype(np.uint32) * np.uint32(0x101)) * w // np.uint32(0xFFFF)
    return r.astype(np.int32), g.astype(np.int32), b.astype(np.int32)


def gray_coeff_luma(r16: np.ndarray, g16: np.ndarray, b16: np.ndarray) -> np.ndarray:
    """16-bit premultiplied RGB -> 8-bit gray, Go/zpix coefficients.

    Reference: Model.convert Gray arm zpix src/color/color.zig:190.
    """
    acc = (
        np.int64(19595) * r16.astype(np.int64)
        + np.int64(38470) * g16.astype(np.int64)
        + np.int64(7471) * b16.astype(np.int64)
        + (np.int64(1) << np.int64(15))
    )
    return (acc >> np.int64(24)).astype(np.uint8)
