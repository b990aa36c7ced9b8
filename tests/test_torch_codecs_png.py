"""The port's host PNG decoder (zpix_tpu_torch.codecs.png) against
zpix_tpu's.  Exact: tolerance 0.

* ``decode`` on every colour type and depth, with and without tRNS,
  Adam7 or not, at odd widths, all five filters (a seeded filter a row),
  every deflate mode, IDAT split: the image class, ``pix``, ``palette`` and
  ``palette_kinds``, ``rect``, ``rgba_pixels()``, ``decode_config`` and the
  ``sng`` text (under plain names and the pngsuite names its compensation
  maps key on).
* Errors: the five kinds of damage of the test writer, broken chunk order
  and headers -- the exception's class and message.  zpix_tpu words a bad
  filter byte two ways, by its C++ and its numpy defilter; the port keeps
  each on its own path (``defilter`` and ``defilter_plain``), each held
  against zpix_tpu's with its library on, then off.
* The ``zlib`` inflate route (libdeflate taken away) in both packages.
"""

import struct
import zlib

import numpy as np
import pytest
from _torch_png import DEPTHS, chunk, encode_png, png_batch, random_pixels

import zpix_tpu.codecs.png as jpng
import zpix_tpu.runtime as jrt
from zpix_tpu import errors as jerr
from zpix_tpu.codecs.png import defilter as jdefilter
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.codecs import png as tpng
from zpix_tpu_torch.codecs.png import defilter as tdefilter
from zpix_tpu_torch.codecs.png.decode import decode_config
from zpix_tpu_torch.runtime import host

SNG_NAMES = ("basn.png", "ftbbn0g01.png", "ftbbn0g02.png", "ftbbn0g04.png", "ftbbn2c16.png",
             "ftbrn2c08.png", "ftbwn0g16.png", "ftbbn3p08.png", "ftbwn3p08.png")
TRNS_TYPES = (0, 2, 3)


def _rect(img):
    r = img.rect
    return (r.min.x, r.min.y, r.max.x, r.max.y)


def assert_same_image(got, want):
    """The port's image equals zpix_tpu's: class, arrays, rectangle and the
    premultiplied flatten."""
    assert type(got).__name__ == type(want).__name__
    assert got.pix.dtype == want.pix.dtype and np.array_equal(got.pix, want.pix)
    assert _rect(got) == _rect(want)
    assert np.array_equal(got.rgba_pixels(), want.rgba_pixels())
    assert hasattr(got, "palette") == hasattr(want, "palette")
    if hasattr(want, "palette"):
        assert np.array_equal(got.palette, want.palette)
        assert np.array_equal(got.palette_kinds, want.palette_kinds)


def outcome(fn, *args):
    """fn(*args) -> ("ok", result) or ("raise", class name, message)."""
    try:
        return ("ok", fn(*args))
    except (jerr.ZpixError, terr.ZpixError) as exc:
        return ("raise", type(exc).__name__, str(exc))


def assert_same_outcome(data: bytes):
    got, want = outcome(tpng.decode, data), outcome(jpng.decode, data)
    assert got[0] == want[0], (got, want)
    if want[0] == "raise":
        assert got == want
    else:
        assert_same_image(got[1], want[1])


def _cases():
    out = []
    for cd in DEPTHS:
        for interlace in (False, True):
            trns_opts = (False, True) if DEPTHS[cd][0] in TRNS_TYPES else (False,)
            for trns in trns_opts:
                out.append((cd, interlace, trns))
    return out


@pytest.mark.parametrize("cd,interlace,trns", _cases())
def test_decode_matches(cd, interlace, trns):
    for w, h, seed in ((13, 9, 1), (1, 5, 2), (33, 3, 3)):
        files, _ = png_batch(cd, w, h, batch=1, seed=seed, interlace=interlace, trns=trns)
        got, want = tpng.decode(files[0]), jpng.decode(files[0])
        assert_same_image(got, want)
        gc, wc = decode_config(files[0]), jpng.decode_config(files[0])
        assert (gc.width, gc.height, gc.color_model) == (wc.width, wc.height, wc.color_model)
        for name in SNG_NAMES:
            assert tpng.sng(name, got) == jpng.sng(name, want), name


@pytest.mark.parametrize("cd", ["p1", "p2", "p4", "p8"])
@pytest.mark.parametrize("interlace", [False, True])
def test_short_palette_extends_as_zpix_tpu(cd, interlace):
    """Indices past a short PLTE extend the palette with opaque black, also
    when a later Adam7 pass first passes it (the palette reconciled after
    the merge)."""
    files, _ = png_batch(cd, 17, 11, batch=2, seed=4, interlace=interlace, short=True,
                         trns=True)
    for f in files:
        assert_same_image(tpng.decode(f), jpng.decode(f))


@pytest.mark.parametrize("strategy", ["stored", "fixed", "rle", "default"])
def test_deflate_modes_and_split_idat(strategy):
    rng = np.random.default_rng(5)
    for cd in ("g8", "tc8", "tca16", "p4"):
        pix = random_pixels(rng, cd, 19, 7)
        pal = rng.integers(0, 256, (16, 3), dtype=np.uint8) if cd.startswith("p") else None
        for interlace in (False, True):
            data = encode_png(pix, cd, palette=pal, interlace=interlace, strategy=strategy,
                              idat_chunks=3, seed=7)
            assert_same_image(tpng.decode(data), jpng.decode(data))


@pytest.mark.parametrize("ftype", range(5))
def test_each_filter_alone(ftype):
    rng = np.random.default_rng(6)
    for cd in ("g1", "g16", "tc8", "ga16", "tca8"):
        data = encode_png(random_pixels(rng, cd, 23, 6), cd, filters=[ftype])
        assert_same_image(tpng.decode(data), jpng.decode(data))


def test_ancillary_chunks_are_skipped():
    rng = np.random.default_rng(7)
    data = encode_png(random_pixels(rng, "tc8", 9, 4), "tc8")
    at = data.index(b"IDAT") - 4
    data = data[:at] + chunk(b"tEXt", b"k\x00v") + chunk(b"gAMA", b"\x00\x00\xb1\x8f") + data[at:]
    assert_same_image(tpng.decode(data), jpng.decode(data))


def _ihdr(w, h, depth, ctype, comp=0, filt=0, interlace=0):
    return chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, interlace))


def _idat(rows: bytes):
    return chunk(b"IDAT", zlib.compress(rows))


def _broken():
    """name -> a broken file (or one the order rules refuse)."""
    sig = b"\x89PNG\r\n\x1a\n"
    rng = np.random.default_rng(8)
    good = encode_png(random_pixels(rng, "tc8", 8, 4), "tc8")
    raw = bytes(4 * (1 + 8))
    g8 = _ihdr(8, 4, 8, 0)
    pal = chunk(b"PLTE", bytes(range(12)))
    end = chunk(b"IEND", b"")
    out = {f"damage_{d}": encode_png(random_pixels(rng, "tc8", 16, 8), "tc8", damage=d,
                                     filters=[0, 4])
           for d in ("crc", "short", "filter", "deflate", "adler")}
    out.update({
        "signature": b"\x89PNX" + good[4:],
        "empty": b"",
        "signature_only": sig,
        "cut_header": good[:12],
        "cut_chunk": good[:40],
        "no_iend": good[: -12],
        "idat_first": sig + _idat(raw) + g8 + end,
        "two_ihdr": sig + g8 + g8 + _idat(raw) + end,
        "plte_after_idat": sig + _ihdr(8, 4, 8, 2) + _idat(bytes(4 * 25)) + pal + end,
        "plte_for_gray": sig + g8 + pal + _idat(raw) + end,
        "plte_length": sig + _ihdr(8, 4, 8, 3) + chunk(b"PLTE", bytes(10)) + _idat(raw) + end,
        "plte_too_long": sig + _ihdr(8, 4, 2, 3) + chunk(b"PLTE", bytes(15)) + _idat(raw) + end,
        "no_plte": sig + _ihdr(8, 4, 8, 3) + _idat(raw) + end,
        "trns_before_plte": sig + _ihdr(8, 4, 8, 3) + chunk(b"tRNS", b"\x01") + pal
        + _idat(raw) + end,
        "trns_ga": sig + _ihdr(8, 4, 8, 4) + chunk(b"tRNS", b"\x00\x01") + _idat(raw) + end,
        "trns_gray_length": sig + g8 + chunk(b"tRNS", b"\x00") + _idat(raw) + end,
        "trns_rgb_length": sig + _ihdr(8, 4, 8, 2) + chunk(b"tRNS", b"\x00" * 4)
        + _idat(bytes(4 * 25)) + end,
        "trns_palette_length": sig + _ihdr(8, 4, 8, 3) + pal + chunk(b"tRNS", bytes(257))
        + _idat(raw) + end,
        "iend_first": sig + g8 + end + _idat(raw),
        "ihdr_length": sig + chunk(b"IHDR", bytes(12)) + _idat(raw) + end,
        "ihdr_compression": sig + _ihdr(8, 4, 8, 0, comp=1) + _idat(raw) + end,
        "ihdr_filter": sig + _ihdr(8, 4, 8, 0, filt=1) + _idat(raw) + end,
        "ihdr_interlace": sig + _ihdr(8, 4, 8, 0, interlace=2) + _idat(raw) + end,
        "ihdr_zero_width": sig + _ihdr(0, 4, 8, 0) + _idat(raw) + end,
        "ihdr_depth": sig + _ihdr(8, 4, 4, 2) + _idat(raw) + end,
        "no_idat": sig + g8 + end,
        "deflate_garbage": sig + g8 + chunk(b"IDAT", b"\x78\x9c\xff\xff") + end,
        "crc_ihdr": sig + g8[:-1] + bytes([g8[-1] ^ 1]) + _idat(raw) + end,
    })
    return out


@pytest.mark.parametrize("name", sorted(_broken()))
def test_broken_files_raise_as_zpix_tpu(name):
    data = _broken()[name]
    assert_same_outcome(data)
    got, want = outcome(tpng.decode_config, data), outcome(jpng.decode_config, data)
    assert got[0] == want[0]
    if want[0] == "raise":
        assert got == want
    else:
        assert got[1].__dict__ == want[1].__dict__


def test_filter_damage_keeps_the_library_wording():
    """The decoder defilters in C++ and says what zpix_tpu's C++ says."""
    rng = np.random.default_rng(9)
    data = encode_png(random_pixels(rng, "tc8", 16, 8), "tc8", damage="filter", filters=[0])
    with pytest.raises(terr.FormatError) as got:
        tpng.decode(data)
    assert str(got.value) == "png: invalid filter type"
    assert_same_outcome(data)


def _rows(rng, h, rb, bad_row=None):
    raw = np.empty((h, 1 + rb), np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    raw[:, 1:] = rng.integers(0, 256, (h, rb))
    if bad_row is not None:
        raw[bad_row, 0] = 9
    return raw.tobytes()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("library", ["on", "off"])
def test_defilter_both_paths_match(bpp, library, monkeypatch):
    """``defilter`` (C++) and ``defilter_plain`` (numpy) give zpix_tpu's rows
    with its library on, then off; a bad filter byte raises each path's
    own wording, and a short stream the same message on both."""
    rng = np.random.default_rng(bpp)
    if library == "off":
        monkeypatch.setattr(jrt, "get_lib", lambda: None)
    mine = tdefilter.defilter if library == "on" else tdefilter.defilter_plain
    for h, rb in ((1, bpp), (7, 5 * bpp + 1), (9, 31)):
        raw = _rows(rng, h, rb)
        want = jdefilter.defilter(raw, h, rb, bpp)
        assert np.array_equal(tdefilter.defilter(raw, h, rb, bpp), want)
        assert np.array_equal(tdefilter.defilter_plain(raw, h, rb, bpp), want)
        bad = _rows(rng, h, rb, bad_row=h - 1)
        with pytest.raises(jerr.FormatError) as want_exc:
            jdefilter.defilter(bad, h, rb, bpp)
        with pytest.raises(terr.FormatError) as got_exc:
            mine(bad, h, rb, bpp)
        assert str(got_exc.value) == str(want_exc.value)
        for fn in (tdefilter.defilter, tdefilter.defilter_plain):
            with pytest.raises(terr.FormatError) as got_exc:
                fn(raw[:-1], h, rb, bpp)
            with pytest.raises(jerr.FormatError) as want_exc:
                jdefilter.defilter(raw[:-1], h, rb, bpp)
            assert str(got_exc.value) == str(want_exc.value)
    if library == "off":
        assert str(want_exc.value).startswith("png: not enough image data")


@pytest.mark.parametrize("damage", [None, "deflate", "adler", "short"])
def test_zlib_route_matches(damage, monkeypatch):
    """With libdeflate taken away both packages inflate with ``zlib``."""
    monkeypatch.setattr(host, "zlib_decompress_sized", lambda *a, **k: None)
    monkeypatch.setattr(jrt, "zlib_decompress_sized", lambda *a, **k: None)
    rng = np.random.default_rng(10)
    for cd, interlace in (("tc8", False), ("p2", True), ("ga16", True)):
        pix = random_pixels(rng, cd, 14, 9)
        pal = rng.integers(0, 256, (4, 3), dtype=np.uint8) if cd == "p2" else None
        data = encode_png(pix, cd, palette=pal, interlace=interlace, damage=damage,
                          filters=[0, 1, 2, 3, 4])
        assert_same_outcome(data)


def test_probe_load_and_exports(tmp_path):
    files, _ = png_batch("tc8", 5, 3, batch=1)
    path = tmp_path / "a.png"
    path.write_bytes(files[0])
    assert tpng.probe_path(str(path)) and tpng.probe_buffer(files[0])
    assert not tpng.probe_buffer(b"\x89PNG") and not tpng.probe_buffer(b"")
    assert_same_image(tpng.load(str(path)), jpng.load(str(path)))
    assert tpng.SIGNATURE == jpng.SIGNATURE
    assert set(tpng.__all__) == set(jpng.__all__)
