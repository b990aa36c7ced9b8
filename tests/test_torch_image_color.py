"""The port's copies of zpix_tpu/color and zpix_tpu/image against the
originals: every conversion on zpix_tpu's exhaustive grid
(tests/test_color.py) and on random values, every image class's
``rgba_pixels``, ``at``, ``sub_image`` (YCbCr's chroma alignment too),
``upsampled_cbcr`` at every ratio, ``Drawer``, the geometry and the
overflow guard.  Exact: tolerance 0."""

import numpy as np
import pytest

import zpix_tpu.color as jc
import zpix_tpu.image as ji
import zpix_tpu_torch.color as tc
import zpix_tpu_torch.image as ti
from zpix_tpu.errors import FormatError as JFormatError
from zpix_tpu_torch.errors import FormatError as TFormatError

RATIOS = ["444", "422", "420", "440", "411", "410"]


def _grid():
    ys = np.arange(0, 256, 5, dtype=np.uint8)
    cbs = np.arange(0, 256, 7, dtype=np.uint8)
    crs = np.arange(0, 256, 11, dtype=np.uint8)
    return np.meshgrid(ys, cbs, crs, indexing="ij")


def _equal(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return len(a) == len(b) and all(
        np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
        for x, y in zip(a, b))


@pytest.mark.parametrize("fn", ["ycbcr_to_rgb8", "ycbcr_to_rgba16", "rgb_to_ycbcr",
                                "rgb_to_cmyk"])
def test_three_channel_conversions_on_the_grid(fn):
    Y, CB, CR = _grid()
    assert _equal(getattr(tc, fn)(Y, CB, CR), getattr(jc, fn)(Y, CB, CR))
    full = np.arange(256, dtype=np.uint8)
    assert _equal(getattr(tc, fn)(full, full[::-1], full[::3].repeat(3)[:256]),
                  getattr(jc, fn)(full, full[::-1], full[::3].repeat(3)[:256]))


@pytest.mark.parametrize("fn", ["cmyk_to_rgba16", "gray_coeff_luma"])
def test_four_and_wide_channel_conversions(fn):
    rng = np.random.default_rng(7)
    n = 4 if fn == "cmyk_to_rgba16" else 3
    hi = 256 if fn == "cmyk_to_rgba16" else 0x10000
    args = [rng.integers(0, hi, 5000) for _ in range(n)]
    args = [a.astype(np.uint8) if hi == 256 else a.astype(np.int32) for a in args]
    assert _equal(getattr(tc, fn)(*args), getattr(jc, fn)(*args))
    edge = [np.array([0, hi - 1, 1, hi // 2])] * n
    assert _equal(getattr(tc, fn)(*edge), getattr(jc, fn)(*edge))


def _images(mod, rng, w=13, h=11):
    """One image of each class, same pixels for both packages."""
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    u16 = lambda *s: rng.integers(0, 0x10000, s).astype(np.uint16)  # noqa: E731
    pal = u8(7, 4)
    kinds = rng.integers(0, 2, 7).astype(np.uint8)
    out = {
        "gray": mod.GrayImage(u8(h, w)),
        "gray16": mod.Gray16Image(u16(h, w)),
        "rgba": mod.RGBAImage(u8(h, w, 4)),
        "rgba64": mod.RGBA64Image(u16(h, w, 4)),
        "nrgba": mod.NRGBAImage(u8(h, w, 4)),
        "nrgba64": mod.NRGBA64Image(u16(h, w, 4)),
        "cmyk": mod.CMYKImage(u8(h, w, 4)),
        "paletted": mod.PalettedImage(rng.integers(0, 7, (h, w)).astype(np.uint8), pal, kinds),
    }
    for ratio in RATIOS:
        cw, ch = mod.model.chroma_dims(w, h, ratio) if hasattr(mod, "model") else (w, h)
        out[f"ycbcr{ratio}"] = mod.YCbCrImage(u8(h, w), u8(ch, cw), u8(ch, cw), ratio)
    return out


def _pair(seed=0):
    import zpix_tpu.image.model as jm
    import zpix_tpu_torch.image.model as tm

    ji.model, ti.model = jm, tm
    return _images(ji, np.random.default_rng(seed)), _images(ti, np.random.default_rng(seed))


@pytest.mark.parametrize("kind", ["gray", "gray16", "rgba", "rgba64", "nrgba", "nrgba64",
                                  "cmyk", "paletted"] + [f"ycbcr{r}" for r in RATIOS])
def test_image_classes_match(kind):
    jimgs, timgs = _pair()
    a, b = jimgs[kind], timgs[kind]
    assert type(a).__name__ == type(b).__name__
    assert np.array_equal(a.rgba_pixels(), b.rgba_pixels())
    assert _equal(a.rgba16(), b.rgba16())
    for x, y in ((0, 0), (12, 10), (5, 3), (-1, 2), (13, 0)):
        assert a.at(x, y) == b.at(x, y)
    for rect in ((1, 2, 9, 7), (3, 3, 4, 4), (20, 20, 30, 30), (-5, -5, 6, 6)):
        sa = a.sub_image(ji.Rectangle.init(*rect))
        sb = b.sub_image(ti.Rectangle.init(*rect))
        assert (sa.rect.min.x, sa.rect.min.y, sa.rect.max.x, sa.rect.max.y) == (
            sb.rect.min.x, sb.rect.min.y, sb.rect.max.x, sb.rect.max.y)
        if sa.rect.empty():  # zpix_tpu's YCbCr flatten needs a pixel
            continue
        assert np.array_equal(sa.rgba_pixels(), sb.rgba_pixels())
        if kind.startswith("ycbcr"):
            # a crop of a crop keeps the chroma grid aligned to the parent
            ssa = sa.sub_image(ji.Rectangle.init(rect[0] + 1, rect[1], rect[2], rect[3]))
            ssb = sb.sub_image(ti.Rectangle.init(rect[0] + 1, rect[1], rect[2], rect[3]))
            assert ssa.rect.empty() == ssb.rect.empty()
            if not ssa.rect.empty():
                assert _equal(ssa.upsampled_cbcr(), ssb.upsampled_cbcr())


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("w,h", [(1, 1), (7, 5), (16, 9)])
def test_chroma_maps_and_upsampling(ratio, w, h):
    import zpix_tpu.image.model as jm
    import zpix_tpu_torch.image.model as tm

    assert tm.chroma_dims(w, h, ratio) == jm.chroma_dims(w, h, ratio)
    assert _equal(tm.chroma_index_maps(w, h, ratio), jm.chroma_index_maps(w, h, ratio))
    rng = np.random.default_rng(w * h)
    cw, ch = jm.chroma_dims(w, h, ratio)
    planes = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (ch, cw), (ch, cw))]
    a = ji.YCbCrImage(*planes, ratio)
    b = ti.YCbCrImage(*planes, ratio)
    assert _equal(a.upsampled_cbcr(), b.upsampled_cbcr())
    ra = ji.RGBAImage.init(ji.Rectangle.init(0, 0, w, h))
    rb = ti.RGBAImage.init(ti.Rectangle.init(0, 0, w, h))
    ji.util.draw_ycbcr(ra, a)
    ti.util.draw_ycbcr(rb, b)
    assert np.array_equal(ra.pix, rb.pix)


def test_drawer_matches():
    a = ji.RGBAImage.init(ji.Rectangle.init(0, 0, 23, 17))
    b = ti.RGBAImage.init(ti.Rectangle.init(0, 0, 23, 17))
    da, db = ji.Drawer(a), ti.Drawer(b)
    for d, mod in ((da, ji), (db, ti)):
        d.clear((1, 2, 3, 255))
        d.draw_line(-3, 2, 30, 14, (200, 0, 0, 255))
        d.draw_line(20, 16, 2, 0, (0, 200, 0, 255))
        d.draw_circle(11, 8, 6, (0, 0, 200, 255))
        d.draw_circle(0, 0, 9, (9, 9, 9, 255))
        d.fill_rect(mod.Rectangle.init(18, -4, 40, 5), (7, 8, 9, 10))
        d.set_pixel(22, 16, (255, 255, 255, 255))
        d.set_pixel(23, 16, (1, 1, 1, 1))
    assert np.array_equal(a.pix, b.pix)


def test_geometry_and_guards():
    for x0, y0, x1, y1 in ((5, 6, 1, 2), (0, 0, 0, 0), (-3, 4, 8, -9)):
        ra, rb = ji.Rectangle.init(x0, y0, x1, y1), ti.Rectangle.init(x0, y0, x1, y1)
        assert (ra.dx, ra.dy, ra.empty()) == (rb.dx, rb.dy, rb.empty())
        ia = ra.intersect(ji.Rectangle.init(0, 0, 3, 3))
        ib = rb.intersect(ti.Rectangle.init(0, 0, 3, 3))
        assert (ia is None) == (ib is None)
        assert ji.Point(1, 1).in_rect(ra) == ti.Point(1, 1).in_rect(rb)
    bad = (-1, 0, 0, 0)
    with pytest.raises(JFormatError) as ea:
        ji.pixel_buffer_length(4, ji.Rectangle(ji.Point(*bad[:2]), ji.Point(-5, 3)), "X")
    with pytest.raises(TFormatError) as eb:
        ti.pixel_buffer_length(4, ti.Rectangle(ti.Point(*bad[:2]), ti.Point(-5, 3)), "X")
    assert str(ea.value) == str(eb.value)
    huge = (0, 0, 1 << 31, 1 << 31)
    assert ji.pixel_buffer_length(1, ji.Rectangle.init(*huge)) == ti.pixel_buffer_length(
        1, ti.Rectangle.init(*huge))
    with pytest.raises(TypeError):
        ti.YCbCrImage.init(ti.Rectangle.init(0, 0, 4, 4), "420").set_pixel(0, 0, 1)
    assert ti.model.PALETTE_RGBA == 0 and ti.model.PALETTE_NRGBA == 1
