"""The port's host BMP and QOI decoders and ``encode_vec`` against
zpix_tpu's.  Exact: tolerance 0.

* BMP ``decode`` on every bit depth, header version and orientation, at
  odd widths: the image class, ``pix``, ``palette``, ``palette_kinds``,
  ``rect``, ``rgba_pixels()`` and ``decode_config``; its errors' class and
  message.  The one recorded difference: an index past a short palette.
  zpix_tpu's host decoder raises ``IndexError`` there; the port's reads
  (0, 0, 0, 0), in ``rgba_pixels()`` and in ``at()``, as
  ``BatchBmpDecoder`` and zpix_tpu's batch decoder give it.
* QOI ``decode`` (an ``RGBAImage``), ``decode_config`` and ``probe_buffer``
  with 3 and 4 channels, and the short and truncated streams' errors,
  against zpix_tpu with its library on and off (its Python op walk).
* ``encode_vec``: the bytes of zpix_tpu's ``encode_vec`` and of the
  port's ``encode``, and the same refusals.
"""

import numpy as np
import pytest
import torch
from _torch_raster import bmp_arms, bmp_batch, bmp_image, encode_cases, qoi_enc, qoi_images
from test_torch_bmp import _bad_headers

import zpix_tpu.codecs.bmp as jbmp
import zpix_tpu.codecs.qoi as jqoi
import zpix_tpu.runtime as jrt
from zpix_tpu import errors as jerr
from zpix_tpu.codecs.qoi.encode_vec import encode_vec as jax_encode_vec
from zpix_tpu.parallel.bmp_batch import BatchBmpDecoder as JaxBatchBmpDecoder
from zpix_tpu_torch import BatchBmpDecoder
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.codecs import bmp as tbmp
from zpix_tpu_torch.codecs import qoi as tqoi
from zpix_tpu_torch.codecs.qoi.encode import Desc, encode
from zpix_tpu_torch.codecs.qoi.encode_vec import encode_vec

ARMS = bmp_arms()
ARM_IDS = [f"{b}bpp-{i}-{'td' if t else 'bu'}{'-short' if s else ''}" for b, i, t, s in ARMS]


def _rect(img):
    r = img.rect
    return (r.min.x, r.min.y, r.max.x, r.max.y)


def assert_same_image(got, want, *, pixels=True):
    assert type(got).__name__ == type(want).__name__
    assert got.pix.dtype == want.pix.dtype and np.array_equal(got.pix, want.pix)
    assert _rect(got) == _rect(want)
    if pixels:
        assert np.array_equal(got.rgba_pixels(), want.rgba_pixels())
    assert hasattr(got, "palette") == hasattr(want, "palette")


def assert_same_config(got, want):
    assert (got.width, got.height, got.color_model) == (want.width, want.height,
                                                        want.color_model)


def _passes_palette(data: bytes) -> bool:
    img = jbmp.decode(data)
    return hasattr(img, "palette") and img.pix.size and int(img.pix.max()) >= len(img.palette)


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_bmp_decode_matches(arm):
    for w, h, seed in ((13, 7, 0), (1, 3, 1), (5, 2, 2), (17, 4, 3)):
        for data in bmp_batch(arm, h, w, batch=2, seed=seed):
            got, want = tbmp.decode(data), jbmp.decode(data)
            assert_same_config(tbmp.decode_config(data), jbmp.decode_config(data))
            if _passes_palette(data):  # the recorded difference, below
                assert arm[3]
                assert_same_image(got, want, pixels=False)
                continue
            assert_same_image(got, want)
            if hasattr(want, "palette"):
                assert np.array_equal(got.palette, want.palette)
                assert np.array_equal(got.palette_kinds, want.palette_kinds)


@pytest.mark.parametrize("bpp", [1, 2, 4, 8])
def test_bmp_short_palette_reads_transparent_black(bpp):
    """Indices past a short palette: zpix_tpu's host decoder raises
    IndexError; the port's gives (0, 0, 0, 0) -- BatchBmpDecoder's and
    zpix_tpu's batch decoder's value -- and every other index zpix_tpu's
    colour."""
    rng = np.random.default_rng(bpp)
    n = max(1, (1 << bpp) // 2 - 1)
    datas = [bmp_image(rng, bpp, 6, 11, n_colors=n) for _ in range(3)]
    got = np.stack([tbmp.decode(d).rgba_pixels().reshape(6, 11, 4) for d in datas])
    assert np.array_equal(got, BatchBmpDecoder(device="cpu").decode(datas).numpy())
    assert np.array_equal(got, np.asarray(JaxBatchBmpDecoder().decode(datas)))
    for d, g in zip(datas, got):
        img, want = tbmp.decode(d), jbmp.decode(d)
        past = img.pix >= n
        assert past.any() and not g[past].any()
        with pytest.raises(IndexError):
            want.rgba_pixels()
        ys, xs = np.nonzero(past)
        assert img.at(int(xs[0]), int(ys[0])) == (0, 0, 0, 0)
        ys, xs = np.nonzero(~past)
        assert img.at(int(xs[0]), int(ys[0])) == want.at(int(xs[0]), int(ys[0]))
        assert np.array_equal(img.palette[:n], want.palette)


@pytest.mark.parametrize("name", list(_bad_headers()) + ["truncated_pixels", "truncated_32"])
def test_bmp_errors_match(name):
    if name.startswith("truncated_"):
        arm = (8, 40, False, False) if name == "truncated_pixels" else (32, 124, True, False)
        data = bmp_batch(arm, 5, 9, batch=1)[0][:-3]
    else:
        data = _bad_headers()[name]
    for t_fn, j_fn in ((tbmp.decode, jbmp.decode), (tbmp.decode_config, jbmp.decode_config)):
        if name.startswith("truncated_") and t_fn is tbmp.decode_config:
            assert_same_config(t_fn(data), j_fn(data))
            continue
        with pytest.raises(jerr.ZpixError) as want:
            j_fn(data)
        with pytest.raises(getattr(terr, type(want.value).__name__)) as got:
            t_fn(data)
        assert str(got.value) == str(want.value)


def test_bmp_probe_load_and_exports(tmp_path):
    data = bmp_batch((24, 40, True, False), 3, 4, batch=1)[0]
    path = tmp_path / "a.bmp"
    path.write_bytes(data)
    assert tbmp.probe_path(str(path)) and tbmp.probe_buffer(data)
    assert not tbmp.probe_buffer(b"B") and not tbmp.probe_buffer(b"MB")
    assert_same_image(tbmp.load(str(path)), jbmp.load(str(path)))
    assert set(tbmp.__all__) == set(jbmp.__all__)


def _qoi_streams():
    """name -> QOI bytes: the four contents with 4 and 3 channels, and
    one-pixel, one-row and one-column images."""
    out = {}
    for i, img in enumerate(qoi_images(w=21, h=9, seed=3)):
        out[f"img{i}_rgba"] = qoi_enc(img)
        out[f"img{i}_rgb"] = qoi_enc(img[..., :3], channels=3)
    rng = np.random.default_rng(4)
    for h, w in ((1, 1), (1, 17), (17, 1)):
        out[f"{h}x{w}"] = qoi_enc(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
    return out


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("name", sorted(_qoi_streams()))
def test_qoi_decode_matches(name, library, monkeypatch):
    if library == "off":
        monkeypatch.setattr(jrt, "get_lib", lambda: None)
    data = _qoi_streams()[name]
    got, want = tqoi.decode(data), jqoi.decode(data)
    assert_same_image(got, want)
    assert_same_config(tqoi.decode_config(data), jqoi.decode_config(data))
    assert tqoi.probe_buffer(data) and jqoi.probe_buffer(data)


def _bad_qoi():
    good = _qoi_streams()["img3_rgba"]
    return {"short": good[:21], "header_only": good[:14], "empty": b"",
            "magic": b"qoix" + good[4:], "zero_width": good[:4] + b"\x00" * 4 + good[8:],
            "channels": good[:12] + b"\x05" + good[13:],
            "colorspace": good[:13] + b"\x02" + good[14:],
            "huge": good[:4] + (20000).to_bytes(4, "big") * 2 + good[12:],
            "truncated_ops": good[: len(good) // 2], "truncated_tail": good[:-9],
            "no_padding": good[:-8], "cut_in_op": good[:30]}


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("name", sorted(_bad_qoi()))
def test_qoi_short_and_truncated_streams_match(name, library, monkeypatch):
    """The same error, or the same pixels (a stream that runs out repeats
    its last pixel), with zpix_tpu's library on and off."""
    if library == "off":
        monkeypatch.setattr(jrt, "get_lib", lambda: None)
    data = _bad_qoi()[name]
    try:
        want = jqoi.decode(data)
    except jerr.ZpixError as exc:
        with pytest.raises(getattr(terr, type(exc).__name__)) as got:
            tqoi.decode(data)
        assert str(got.value) == str(exc)
        return
    assert_same_image(tqoi.decode(data), want)


def test_qoi_probe_load_and_exports(tmp_path):
    data = _qoi_streams()["img0_rgba"]
    path = tmp_path / "a.qoi"
    path.write_bytes(data)
    assert tqoi.probe_path(str(path))
    assert not tqoi.probe_buffer(b"qoi") and not tqoi.probe_buffer(b"qoix")
    assert_same_image(tqoi.load(str(path)), jqoi.load(str(path)))
    assert tqoi.MAGIC == jqoi.MAGIC and set(tqoi.__all__) == set(jqoi.__all__)


@pytest.mark.parametrize("case", range(len(encode_cases())))
def test_encode_vec_bytes_match(case):
    img, ch = encode_cases()[case]
    h, w = img.shape[:2]
    desc = Desc(w, h, ch, 0)
    got = encode_vec(img, desc)
    assert got == jax_encode_vec(img, jqoi.Desc(w, h, ch, 0))
    assert got == encode(img, desc)


def test_encode_vec_refusals_match():
    img = np.zeros((2, 3, 4), np.uint8)
    for desc in ((0, 2, 4, 0), (3, 2, 5, 0), (3, 2, 4, 2), (3, 200_000_000, 4, 0), (4, 2, 4, 0)):
        with pytest.raises(jerr.FormatError) as want:
            jax_encode_vec(img, jqoi.Desc(*desc))
        with pytest.raises(terr.FormatError) as got:
            encode_vec(img, Desc(*desc))
        assert str(got.value) == str(want.value)


def test_encode_vec_round_trips_through_the_host_decoder():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 4, (9, 31, 4), dtype=np.uint8) * 60
    data = encode_vec(img, Desc(31, 9, 4, 1))
    assert np.array_equal(tqoi.decode(data).pix, img)
    assert torch.equal(torch.from_numpy(tqoi.decode(data).rgba_pixels()),
                       torch.from_numpy(jqoi.decode(data).rgba_pixels()))
