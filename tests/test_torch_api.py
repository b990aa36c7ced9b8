"""The port's top-level API (``zpix_tpu_torch.from_buffer``, ``decode``,
``from_file_path``, ``load``, ``decode_config``) against zpix_tpu's, on
streams of every codec: the image class, rectangle and premultiplied
RGBA, the config, and the errors' class and message (``UnknownFormat``
for bytes no codec probes).  Exact: tolerance 0."""

import numpy as np
import pytest
from _torch_jpeg import synth_cmyk, synth_jpeg, synth_plain_jpeg, synth_progressive
from _torch_png import encode_png, png_batch
from _torch_raster import bmp_batch, qoi_enc, qoi_images

import zpix_tpu
import zpix_tpu_torch
from zpix_tpu import errors as jerr
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch import image as timage


def _streams():
    """name -> encoded bytes, every codec and a few arms of each."""
    out = {
        "jpeg_420": synth_plain_jpeg(w=37, h=21),
        "jpeg_gray_dri": synth_jpeg(w=24, h=16, mode="gray"),
        "jpeg_444": synth_plain_jpeg(w=16, h=9, mode="444"),
        "jpeg_progressive": synth_progressive(w=33, h=17),
        "jpeg_cmyk": synth_cmyk(None, w=24, h=16),
        "jpeg_ycck": synth_cmyk(2, w=24, h=16),
        "qoi_rgba": qoi_enc(qoi_images(w=9, h=5)[3]),
        "qoi_rgb": qoi_enc(qoi_images(w=9, h=5)[0][..., :3], channels=3),
        "bmp_24": bmp_batch((24, 40, False, False), 5, 7, batch=1)[0],
        "bmp_4_v5": bmp_batch((4, 124, True, False), 5, 7, batch=1)[0],
        "bmp_32_v4": bmp_batch((32, 108, False, False), 5, 7, batch=1)[0],
    }
    for cd, il in (("tc8", False), ("p4", True), ("ga16", False), ("g2", True)):
        out[f"png_{cd}{'_adam7' if il else ''}"] = png_batch(cd, 11, 6, batch=1, interlace=il,
                                                             trns=cd == "p4")[0][0]
    return out


def _outcome(fn, data):
    try:
        img = fn(data)
    except (jerr.ZpixError, terr.ZpixError) as exc:
        return ("raise", type(exc).__name__, str(exc))
    r = img.rect
    return ("ok", type(img).__name__, (r.min.x, r.min.y, r.max.x, r.max.y),
            img.rgba_pixels().tobytes())


@pytest.mark.parametrize("name", sorted(_streams()))
def test_from_buffer_and_decode_config_match(name):
    data = _streams()[name]
    want = _outcome(zpix_tpu.from_buffer, data)
    assert want[0] == "ok"
    assert _outcome(zpix_tpu_torch.from_buffer, data) == want
    assert _outcome(zpix_tpu_torch.decode, data) == want
    got_c, want_c = zpix_tpu_torch.decode_config(data), zpix_tpu.decode_config(data)
    assert (got_c.width, got_c.height, got_c.color_model) == (
        want_c.width, want_c.height, want_c.color_model)


def _bad():
    rng = np.random.default_rng(3)
    png_cut = encode_png(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), "tc8", damage="crc")
    return {"unknown": b"GIF89a" + bytes(20), "empty": b"", "one_byte": b"\xff",
            "png_crc": png_cut, "jpeg_cut": synth_plain_jpeg(w=16, h=16)[:40],
            "qoi_short": b"qoif" + bytes(10), "bmp_header": b"BM" + bytes(10),
            "almost_png": b"\x89PNG\r\n\x1a", "almost_jpeg": b"\xff\xd8"}


@pytest.mark.parametrize("name", sorted(_bad()))
def test_errors_match(name):
    data = _bad()[name]
    for t_fn, j_fn in ((zpix_tpu_torch.from_buffer, zpix_tpu.from_buffer),
                       (zpix_tpu_torch.decode_config, zpix_tpu.decode_config)):
        try:
            j_fn(data)
            want = None
        except jerr.ZpixError as exc:
            want = (type(exc).__name__, str(exc))
        try:
            t_fn(data)
            got = None
        except terr.ZpixError as exc:
            got = (type(exc).__name__, str(exc))
        assert got == want
    if name in ("unknown", "empty", "one_byte", "almost_png", "almost_jpeg"):
        with pytest.raises(terr.UnknownFormat, match="zpix: no codec matched the buffer"):
            zpix_tpu_torch.from_buffer(data)


def test_file_paths(tmp_path):
    for name, data in _streams().items():
        path = tmp_path / name
        path.write_bytes(data)
        want = _outcome(zpix_tpu.from_file_path, str(path))
        assert _outcome(zpix_tpu_torch.from_file_path, str(path)) == want
        assert _outcome(zpix_tpu_torch.load, str(path)) == want


def test_probe_order_and_exports():
    assert [c.__name__.rsplit(".", 1)[1] for c in zpix_tpu_torch._CODECS] == [
        c.__name__.rsplit(".", 1)[1] for c in zpix_tpu._CODECS]
    assert set(zpix_tpu.__all__) <= set(zpix_tpu_torch.__all__)
    assert zpix_tpu_torch.__version__ == zpix_tpu.__version__
    for cls in ("RGBAImage", "PalettedImage", "YCbCrImage", "Config", "Rectangle"):
        assert getattr(zpix_tpu_torch, cls) is getattr(timage, cls)
    assert zpix_tpu_torch.UnknownFormat is terr.UnknownFormat
    for codec in ("png", "jpeg", "qoi", "bmp"):
        mod = getattr(zpix_tpu_torch, codec)
        assert mod.__name__ == f"zpix_tpu_torch.codecs.{codec}"
        assert set(getattr(zpix_tpu, codec).__all__) <= set(mod.__all__)
