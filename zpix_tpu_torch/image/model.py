"""Dense-array image types.

Each class wraps numpy arrays in the natural dense layout (uint8/uint16,
row-major, channel-last) instead of the reference's byte-slice + stride
structs.  Parity notes:

* 16-bit images: the reference stores big-endian byte pairs
  (zpix src/image/image.zig:229-307); we store native uint16
  arrays and only byte-swap at serialization boundaries.
* ``YCbCrImage``: the reference keeps padded planes and returns a cropping
  subImage (zpix src/image/image.zig:474-631); we store planes
  already cropped to the logical rect, with chroma plane sizes computed by
  the same ``yCbCrSize`` arithmetic (image.zig:521-555).
* ``rgba_pixels``: universal RGBA8 flatten, per-pixel
  ``at().toRGBA() >> 8`` in the reference (image.zig:103-130), vectorized
  here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .geometry import Rectangle
from ..color import ycbcr_to_rgba16, cmyk_to_rgba16
from ..errors import FormatError


def pixel_buffer_length(bytes_per_pixel: int, rect: Rectangle, image_type: str = "") -> int:
    """Overflow-guarded w*h*bpp sizing.

    Mirrors pixelBufferLength/mul3NonNeg/add2NonNeg
    (zpix src/image/image.zig:896-951) which panic on negative or
    overflowing sizes; we raise FormatError instead.
    """
    w, h = rect.dx, rect.dy
    if w < 0 or h < 0:
        raise FormatError(f"image: {image_type} has negative dimensions")
    total = bytes_per_pixel * w * h
    if total >= 1 << 63:
        raise FormatError(f"image: {image_type} has huge dimensions")
    return total


@dataclass
class Config:
    """Image metadata probe result (zpix src/image/image.zig:16-20)."""

    width: int
    height: int
    color_model: str


class YCbCrSubsample:
    R444 = "444"
    R422 = "422"
    R420 = "420"
    R440 = "440"
    R411 = "411"
    R410 = "410"


def chroma_dims(w: int, h: int, ratio: str):
    """Chroma plane size for a (0,0,w,h) rect.

    Mirrors yCbCrSize (zpix src/image/image.zig:521-555).
    """
    if ratio == YCbCrSubsample.R422:
        return (w + 1) // 2, h
    if ratio == YCbCrSubsample.R420:
        return (w + 1) // 2, (h + 1) // 2
    if ratio == YCbCrSubsample.R440:
        return w, (h + 1) // 2
    if ratio == YCbCrSubsample.R411:
        return (w + 3) // 4, h
    if ratio == YCbCrSubsample.R410:
        return (w + 3) // 4, (h + 1) // 2
    return w, h


def chroma_index_maps(w: int, h: int, ratio: str):
    """(row_map[h], col_map[w]) mapping luma coords to chroma plane coords.

    Encodes cOffset's per-ratio index math
    (zpix src/image/image.zig:594-605) as gather maps.
    """
    ys = np.arange(h)
    xs = np.arange(w)
    if ratio == YCbCrSubsample.R422:
        return ys, xs // 2
    if ratio == YCbCrSubsample.R420:
        return ys // 2, xs // 2
    if ratio == YCbCrSubsample.R440:
        return ys // 2, xs
    if ratio == YCbCrSubsample.R411:
        return ys, xs // 4
    if ratio == YCbCrSubsample.R410:
        return ys // 2, xs // 4
    return ys, xs


class _BaseImage:
    """Shared bounds/shape plumbing."""

    pix: np.ndarray
    rect: Rectangle

    def bounds(self) -> Rectangle:
        return self.rect

    @property
    def width(self) -> int:
        return self.rect.dx

    @property
    def height(self) -> int:
        return self.rect.dy

    # Subclasses implement rgba16() -> (r, g, b, a) int32 arrays (h, w) in
    # [0, 0xffff], premultiplied — the vectorized Color.toRGBA.
    def rgba16(self):
        raise NotImplementedError

    def rgba_pixels(self) -> np.ndarray:
        """Flatten to interleaved RGBA8 (h*w*4,), = at().toRGBA() >> 8."""
        r, g, b, a = self.rgba16()
        out = np.empty((self.height, self.width, 4), np.uint8)
        out[..., 0] = (r >> 8).astype(np.uint8)
        out[..., 1] = (g >> 8).astype(np.uint8)
        out[..., 2] = (b >> 8).astype(np.uint8)
        out[..., 3] = (a >> 8).astype(np.uint8)
        return out.reshape(-1)

    def at(self, x: int, y: int):
        """Premultiplied 16-bit RGBA at (x, y) — the per-type at() +
        Color.toRGBA chain (zpix src/image/image.zig:54-66;
        color.zig:31-132).  Out-of-bounds returns the zero color, as Go
        does."""
        r = self.rect
        if not (r.min.x <= x < r.max.x and r.min.y <= y < r.max.y):
            return (0, 0, 0, 0)
        one = self.sub_image(Rectangle.init(x, y, x + 1, y + 1))
        cr, cg, cb, ca = one.rgba16()
        return (int(cr[0, 0]), int(cg[0, 0]), int(cb[0, 0]), int(ca[0, 0]))

    def set_pixel(self, x: int, y: int, value) -> None:
        """Write one pixel in the type's native channel layout (the
        per-type set* accessors, image.zig: setRGBA/setGray/...).
        No-op out of bounds, like the reference."""
        r = self.rect
        if not (r.min.x <= x < r.max.x and r.min.y <= y < r.max.y):
            return
        self.pix[y - r.min.y, x - r.min.x] = value

    def sub_image(self, r: Rectangle):
        """View of the intersection with ``r``, sharing pixel memory
        (per-type subImage, zpix src/image/image.zig:153-176
        and siblings; empty intersections return a 0-size image)."""
        r2 = self.rect.intersect(r)
        if r2 is None:
            cls = type(self)
            out = cls.__new__(cls)
            out.__dict__.update(self.__dict__)
            out.pix = self.pix[:0, :0]
            out.rect = Rectangle(r.min, r.min)
            return out
        y0 = r2.min.y - self.rect.min.y
        x0 = r2.min.x - self.rect.min.x
        out = type(self).__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.pix = self.pix[y0 : y0 + r2.dy, x0 : x0 + r2.dx]
        out.rect = r2
        return out


def _rect_for(w: int, h: int) -> Rectangle:
    return Rectangle.init(0, 0, w, h)


class GrayImage(_BaseImage):
    """8-bit grayscale (zpix src/image/image.zig:633-695)."""

    def __init__(self, pix: np.ndarray, rect: Rectangle | None = None):
        self.pix = pix
        self.rect = rect or _rect_for(pix.shape[1], pix.shape[0])

    @classmethod
    def init(cls, rect: Rectangle) -> "GrayImage":
        pixel_buffer_length(1, rect, "GrayImage")
        return cls(np.zeros((rect.dy, rect.dx), np.uint8), rect)

    def rgba16(self):
        y = self.pix.astype(np.int32)
        y = y | (y << 8)
        a = np.full_like(y, 0xFFFF)
        return y, y, y, a


class Gray16Image(_BaseImage):
    """16-bit grayscale (zpix src/image/image.zig:697-760)."""

    def __init__(self, pix: np.ndarray, rect: Rectangle | None = None):
        self.pix = pix
        self.rect = rect or _rect_for(pix.shape[1], pix.shape[0])

    @classmethod
    def init(cls, rect: Rectangle) -> "Gray16Image":
        pixel_buffer_length(2, rect, "Gray16Image")
        return cls(np.zeros((rect.dy, rect.dx), np.uint16), rect)

    def rgba16(self):
        y = self.pix.astype(np.int32)
        a = np.full_like(y, 0xFFFF)
        return y, y, y, a


class _Interleaved4(_BaseImage):
    dtype = np.uint8

    def __init__(self, pix: np.ndarray, rect: Rectangle | None = None):
        self.pix = pix
        self.rect = rect or _rect_for(pix.shape[1], pix.shape[0])

    @classmethod
    def init(cls, rect: Rectangle):
        pixel_buffer_length(4 * np.dtype(cls.dtype).itemsize, rect, cls.__name__)
        return cls(np.zeros((rect.dy, rect.dx, 4), cls.dtype), rect)


class RGBAImage(_Interleaved4):
    """Premultiplied RGBA8 (zpix src/image/image.zig:133-227)."""

    def rgba16(self):
        c = self.pix.astype(np.int32)
        c = c | (c << 8)
        return c[..., 0], c[..., 1], c[..., 2], c[..., 3]


class RGBA64Image(_Interleaved4):
    """Premultiplied RGBA16 (zpix src/image/image.zig:229-307)."""

    dtype = np.uint16

    def rgba16(self):
        c = self.pix.astype(np.int32)
        return c[..., 0], c[..., 1], c[..., 2], c[..., 3]


class NRGBAImage(_Interleaved4):
    """Non-premultiplied RGBA8 (zpix src/image/image.zig:309-383)."""

    def rgba16(self):
        c = self.pix.astype(np.uint32)
        a = c[..., 3]
        out = []
        for ch in range(3):
            v = c[..., ch]
            v = v | (v << 8)
            out.append(((v * a) // 0xFF).astype(np.int32))
        a16 = a | (a << 8)
        return out[0], out[1], out[2], a16.astype(np.int32)


class NRGBA64Image(_Interleaved4):
    """Non-premultiplied RGBA16 (zpix src/image/image.zig:385-463)."""

    dtype = np.uint16

    def rgba16(self):
        c = self.pix.astype(np.uint32)
        a = c[..., 3]
        out = []
        for ch in range(3):
            out.append(((c[..., ch] * a) // 0xFFFF).astype(np.int32))
        return out[0], out[1], out[2], a.astype(np.int32)


class CMYKImage(_Interleaved4):
    """CMYK8 (zpix src/image/image.zig:762-823)."""

    def rgba16(self):
        c = self.pix
        r, g, b = cmyk_to_rgba16(c[..., 0], c[..., 1], c[..., 2], c[..., 3])
        a = np.full(r.shape, 0xFFFF, np.int32)
        return r, g, b, a


PALETTE_RGBA = 0  # entry from PLTE: opaque, premultiplied-trivial
PALETTE_NRGBA = 1  # entry rewritten by tRNS: non-premultiplied alpha


class PalettedImage(_BaseImage):
    """Indexed image (zpix src/image/image.zig:825-890).

    ``palette`` is (n, 4) uint8 [r,g,b,a]; ``palette_kinds`` is (n,) uint8 of
    PALETTE_RGBA / PALETTE_NRGBA (the reference's Color union tag, which the
    SNG oracle distinguishes: zpix src/png/sng.zig:111-125).
    """

    def __init__(
        self,
        pix: np.ndarray,
        palette: np.ndarray,
        palette_kinds: np.ndarray | None = None,
        rect: Rectangle | None = None,
    ):
        self.pix = pix
        self.palette = np.asarray(palette, np.uint8).reshape(-1, 4).copy()
        if palette_kinds is None:
            palette_kinds = np.zeros(len(self.palette), np.uint8)
        self.palette_kinds = np.asarray(palette_kinds, np.uint8).copy()
        self.rect = rect or _rect_for(pix.shape[1], pix.shape[0])

    @classmethod
    def init(cls, rect: Rectangle, palette: np.ndarray, palette_kinds=None):
        pixel_buffer_length(1, rect, "PalettedImage")
        return cls(np.zeros((rect.dy, rect.dx), np.uint8), palette, palette_kinds, rect)

    def color_index_at(self, x: int, y: int) -> int:
        return int(self.pix[y, x])

    def palette_rgba16(self):
        """Per-entry toRGBA: rgba entries widen, nrgba entries premultiply."""
        p = self.palette.astype(np.uint32)
        wide = p | (p << 8)
        r, g, b, a = wide[:, 0], wide[:, 1], wide[:, 2], wide[:, 3]
        is_n = self.palette_kinds == PALETTE_NRGBA
        alpha = p[:, 3]
        pr = np.where(is_n, (r * alpha) // 0xFF, r)
        pg = np.where(is_n, (g * alpha) // 0xFF, g)
        pb = np.where(is_n, (b * alpha) // 0xFF, b)
        pa = np.where(is_n, a, np.uint32(0xFFFF))
        # PLTE entries always carry a==0xff so a|a<<8 == 0xffff for both arms.
        return (
            pr.astype(np.int32),
            pg.astype(np.int32),
            pb.astype(np.int32),
            pa.astype(np.int32),
        )

    def rgba16(self):
        pr, pg, pb, pa = self.palette_rgba16()
        idx = self.pix
        return pr[idx], pg[idx], pb[idx], pa[idx]


class YCbCrImage(_BaseImage):
    """Planar YCbCr (zpix src/image/image.zig:474-631).

    Planes are stored cropped to the logical rect: ``y`` is (h, w), ``cb`` and
    ``cr`` are (ch, cw) per ``chroma_dims``.
    """

    def __init__(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray, ratio: str, rect: Rectangle | None = None):
        self.y = y
        self.cb = cb
        self.cr = cr
        self.ratio = ratio
        self.rect = rect or _rect_for(y.shape[1], y.shape[0])

    @classmethod
    def init(cls, rect: Rectangle, ratio: str) -> "YCbCrImage":
        w, h = rect.dx, rect.dy
        cw, ch = chroma_dims(w, h, ratio)
        return cls(
            np.zeros((h, w), np.uint8),
            np.zeros((ch, cw), np.uint8),
            np.zeros((ch, cw), np.uint8),
            ratio,
            rect,
        )

    def set_pixel(self, x: int, y: int, value) -> None:
        """The reference's YCbCr image (like Go's) has no setter; the
        planes are written through y/cb/cr directly."""
        raise TypeError("YCbCrImage has no per-pixel setter")

    @property
    def pix(self):  # pragma: no cover - convenience
        return self.y

    def upsampled_cbcr(self):
        """Full-resolution (h, w) chroma via the cOffset gather maps.

        ``_origin`` (set by sub_image) keeps the chroma grid aligned to
        the parent image's absolute coordinates, mirroring cOffset's use
        of absolute x,y (zpix src/image/image.zig:594-605)."""
        oy, ox = getattr(self, "_origin", (0, 0))
        rm, cm = chroma_index_maps(self.width + ox, self.height + oy, self.ratio)
        rm = rm[oy:] - rm[oy]
        cm = cm[ox:] - cm[ox]
        return self.cb[np.ix_(rm, cm)], self.cr[np.ix_(rm, cm)]

    def sub_image(self, r: Rectangle):
        """Deep-copy crop, like the reference's YCbCr subImage
        (zpix src/image/image.zig:557-583)."""
        r2 = self.rect.intersect(r)
        if r2 is None:
            z = np.zeros((0, 0), np.uint8)
            return YCbCrImage(z, z, z, self.ratio, Rectangle(r.min, r.min))
        oy0, ox0 = getattr(self, "_origin", (0, 0))
        y0 = r2.min.y - self.rect.min.y
        x0 = r2.min.x - self.rect.min.x
        rm_full, cm_full = chroma_index_maps(
            self.width + ox0, self.height + oy0, self.ratio
        )
        cy0 = int(rm_full[oy0 + y0] - rm_full[oy0])
        cx0 = int(cm_full[ox0 + x0] - cm_full[ox0])
        cy1 = int(rm_full[oy0 + y0 + r2.dy - 1] - rm_full[oy0]) + 1
        cx1 = int(cm_full[ox0 + x0 + r2.dx - 1] - cm_full[ox0]) + 1
        out = YCbCrImage(
            self.y[y0 : y0 + r2.dy, x0 : x0 + r2.dx].copy(),
            self.cb[cy0:cy1, cx0:cx1].copy(),
            self.cr[cy0:cy1, cx0:cx1].copy(),
            self.ratio,
            r2,
        )
        out._origin = (oy0 + y0, ox0 + x0)
        return out

    def rgba16(self):
        cb, cr = self.upsampled_cbcr()
        r, g, b = ycbcr_to_rgba16(self.y, cb, cr)
        a = np.full(r.shape, 0xFFFF, np.int32)
        return r, g, b, a
