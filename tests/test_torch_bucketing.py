"""The port's router (zpix_tpu_torch.parallel.bucketing) on the CPU.

* ``probe_key`` and ``plan_buckets`` against zpix_tpu's.
* ``decode_mixed(device="cpu")`` on a mixed corpus (every codec, several
  geometries and arms a codec) against zpix_tpu's host path,
  ``from_buffer(d).rgba_pixels()``, stream by stream; the short BMP
  palette (the recorded difference: zpix_tpu's host decoder raises) against
  the port's host path and zpix_tpu's batch decoder.
* Once, on a small corpus (two images a bucket, 64 x 48 or smaller),
  against zpix_tpu's own ``decode_mixed``: the same pixels, and the same
  route counts except where the port differs on purpose (a progressive
  bucket of mixed scripts: zpix_tpu's batch raises into ``host-error``,
  the port splits it by ``script_key`` and decodes on the device); a
  3 x 1 sampling every component shares ends in the same error.
* ``min_batch``, ``host-error`` (a decoder patched to raise; a progressive
  group whose ``ok`` is False), a ``RuntimeError`` that propagates, the
  decoder cache and ``close()``, ``UnknownFormat``, the damaged PNGs (the
  host decoder's error), ``load_batch``, the metrics counters and the
  default device.
Exact: tolerance 0.
"""

import io
import logging

import numpy as np
import pytest
import torch
from _torch_jpeg import (synth_cmyk, synth_jpeg, synth_plain_jpeg, synth_progressive,
                         synth_ratio_jpeg)
from _torch_png import DAMAGE, encode_png, png_batch
from _torch_raster import bmp_batch, qoi_enc, qoi_images
from PIL import Image

import zpix_tpu
from zpix_tpu import errors as jerr
from zpix_tpu.parallel import bucketing as jb
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.parallel import bucketing as tb
from zpix_tpu_torch.utils import metrics

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_decoders():
    tb.close()
    yield
    tb.close()


def _prog_cmyk(w=24, h=16, seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).convert("CMYK").save(
        buf, format="JPEG", quality=80, progressive=True)
    return buf.getvalue()


def _corpus():
    """name -> bytes: the mixed corpus (buckets of one to three)."""
    p = synth_progressive(w=40, h=24)
    g = synth_progressive(w=32, h=16, mode="gray")
    out = {"base_a": synth_plain_jpeg(w=40, h=24), "base_b": synth_plain_jpeg(w=40, h=24,
                                                                              phase=0.5),
           "base_444": synth_plain_jpeg(w=24, h=16, mode="444"),
           "dri_gray": synth_jpeg(w=24, h=16, mode="gray"),
           "ratio_411": synth_ratio_jpeg(((4, 1), (1, 1), (1, 1)), 40, 24, 1),
           "cmyk_a": synth_cmyk(None, w=40, h=24, seed=1, dri_blocks=None),
           "cmyk_b": synth_cmyk(None, w=40, h=24, seed=2, dri_blocks=None),
           "ycck": synth_cmyk(2, w=32, h=24, seed=3, dri_blocks=None),
           "prog_a": p, "prog_a_copy": p, "prog_b": synth_progressive(w=40, h=24, phase=0.3),
           "prog_gray": g, "prog_gray_copy": g, "prog_444": synth_progressive(w=16, h=16,
                                                                               mode="444"),
           "prog_cmyk": _prog_cmyk()}
    imgs = qoi_images(w=20, h=12)
    out.update({f"qoi_{i}": qoi_enc(im) for i, im in enumerate(imgs)})
    out["qoi_rgb"] = qoi_enc(imgs[0][..., :3], channels=3)
    for arm in ((24, 40, False, False), (8, 40, False, True), (1, 124, True, False),
                (32, 108, False, False)):
        for i, d in enumerate(bmp_batch(arm, 6, 9, batch=2, seed=arm[0])):
            out[f"bmp_{arm[0]}_{arm[1]}_{i}"] = d
    for cd, il, trns in (("tc8", False, False), ("p4", True, True), ("g16", False, True),
                         ("tca8", True, False), ("p8", False, False)):
        for i, d in enumerate(png_batch(cd, 13, 7, batch=2, interlace=il, trns=trns,
                                        short=cd == "p8")[0]):
            out[f"png_{cd}_{i}"] = d
    return out


def _host(data: bytes) -> np.ndarray:
    img = zpix_tpu.from_buffer(data)
    return np.asarray(img.rgba_pixels(), np.uint8).reshape(img.height, img.width, 4)


def _port_host(data: bytes) -> np.ndarray:
    return tb._host_rgba(data)


def test_probe_key_and_plan_buckets_match():
    corpus = list(_corpus().values())
    corpus += [b"\x89PNG\r\n\x1a\n" + bytes(30), b"\xff\xd8\xff\xe0\x00\x04ab",
               b"BM" + bytes(40), b"qoif" + bytes(12)]
    assert [tb.probe_key(d) for d in corpus] == [jb.probe_key(d) for d in corpus]
    assert tb.plan_buckets(corpus) == jb.plan_buckets(corpus)
    for bad in (b"qoif" + bytes(5), b"GIF8", b""):
        with pytest.raises(jerr.UnknownFormat) as want:
            jb.probe_key(bad)
        with pytest.raises(terr.UnknownFormat) as got:
            tb.probe_key(bad)
        assert str(got.value) == str(want.value)


def test_decode_mixed_matches_the_host_path():
    corpus = _corpus()
    names = list(corpus)
    outs, stats = tb.decode_mixed([corpus[n] for n in names], device="cpu", return_stats=True)
    assert stats == {"device": len(names) - 1, "host-routed": 1}  # progressive CMYK
    for name, out in zip(names, outs):
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 4
        if name.startswith("bmp_8_"):  # the short palette: zpix_tpu's host raises
            with pytest.raises(IndexError):
                _host(corpus[name])
            assert np.array_equal(out, _port_host(corpus[name])), name
            continue
        assert np.array_equal(out, _host(corpus[name])), name


def _small():
    """Two images a bucket, 64 x 48 or smaller; the progressive pair has
    two scripts (Pillow's per-image tables)."""
    rng = np.random.default_rng(5)
    out = [synth_plain_jpeg(w=40, h=24), synth_plain_jpeg(w=40, h=24, phase=0.4),
           synth_cmyk(None, w=32, h=16, seed=1, dri_blocks=None),
           synth_cmyk(None, w=32, h=16, seed=2, dri_blocks=None),
           synth_cmyk(None, w=24, h=16, seed=3, dri_blocks=None),  # one cmyk, one ycck:
           synth_cmyk(2, w=24, h=16, seed=4, dri_blocks=None),     # host-error in both
           synth_progressive(w=40, h=24, phase=0.1), synth_progressive(w=40, h=24, phase=0.6),
           _prog_cmyk(seed=1)]
    out += [qoi_enc(im) for im in qoi_images(w=20, h=12)[:2]]
    out += bmp_batch((24, 40, False, False), 6, 9, batch=2)
    out += bmp_batch((4, 40, True, True), 6, 9, batch=2, seed=1)
    out += png_batch("tc8", 13, 7, batch=2)[0]
    out += [encode_png(rng.integers(0, 256, (9, 11, 4), dtype=np.uint8), "tca8")]
    return out


def test_decode_mixed_matches_zpix_tpu_decode_mixed():
    """The one test that runs zpix_tpu's batch decoders (XLA:CPU)."""
    corpus = _small()
    got, got_stats = tb.decode_mixed(corpus, device="cpu", return_stats=True)
    want, want_stats = jb.decode_mixed(corpus, return_stats=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), i
    # the progressive pair: two scripts, zpix_tpu's batch raises into
    # host-error, the port decodes each script on the device
    assert want_stats == {"device": 13, "host-error": 4, "host-routed": 1}
    assert got_stats == {"device": 15, "host-error": 2, "host-routed": 1}
    # a 3 x 1 sampling shared by every component: zpix_tpu's batch
    # decoder refuses it, then its host decoder; so do the port's
    f3 = [synth_ratio_jpeg(((3, 1),) * 3, 40, 24, s) for s in (0, 1)]
    with pytest.raises(jerr.ZpixError) as want_exc:
        jb.decode_mixed(f3)
    with pytest.raises(terr.ZpixError) as got_exc:
        tb.decode_mixed(f3, device="cpu")
    assert (type(got_exc.value).__name__, str(got_exc.value)) == (
        type(want_exc.value).__name__, str(want_exc.value))


@pytest.mark.parametrize("hv", [((3, 1),) * 3, ((1, 3),) * 3])
def test_factor3_sampling_ends_in_the_host_decoders_error(hv):
    data = [synth_ratio_jpeg(hv, 40, 24, s) for s in (0, 1)]
    with pytest.raises(jerr.ZpixError) as want:
        zpix_tpu.from_buffer(data[0])
    with pytest.raises(terr.ZpixError) as got:
        tb.decode_mixed(data, device="cpu")
    assert (type(got.value).__name__, str(got.value)) == (type(want.value).__name__,
                                                         str(want.value))


def test_min_batch_sends_small_buckets_to_the_host():
    corpus = _corpus()
    datas = [corpus["qoi_0"], corpus["base_a"], corpus["base_b"], corpus["png_tc8_0"],
             corpus["png_tc8_1"], corpus["png_tc8_0"]]
    outs, stats = tb.decode_mixed(datas, device="cpu", min_batch=3, return_stats=True)
    assert stats == {"host-small": 3, "device": 3}
    for d, o in zip(datas, outs):
        assert np.array_equal(o, _host(d))
    _, stats = tb.decode_mixed(datas, device="cpu", min_batch=7, return_stats=True)
    assert stats == {"host-small": 6}


def test_host_keys_are_routed_to_the_host():
    corpus = _corpus()
    bad_bmp = corpus["bmp_24_40_0"][:20]
    for data in (bad_bmp,):
        with pytest.raises(terr.ZpixError) as got:
            tb.decode_mixed([data], device="cpu")
        with pytest.raises(jerr.ZpixError) as want:
            zpix_tpu.from_buffer(data)
        assert str(got.value) == str(want.value)
    outs, stats = tb.decode_mixed([corpus["prog_cmyk"]], device="cpu", return_stats=True)
    assert stats == {"host-routed": 1} and np.array_equal(outs[0], _host(corpus["prog_cmyk"]))


@pytest.mark.parametrize("kind", ["png", "jpeg", "qoi", "bmp", "progressive"])
def test_a_raising_decoder_goes_to_host_error(kind, monkeypatch, caplog):
    corpus = _corpus()
    pick = {"png": "png_tc8_0", "jpeg": "base_a", "qoi": "qoi_1", "bmp": "bmp_24_40_0",
            "progressive": "prog_gray"}[kind]
    dec = tb.decoder(kind, CPU)

    def boom(*a, **k):
        raise terr.FormatError("deliberately broken batched decoder")

    monkeypatch.setattr(dec, "prep_plans" if kind == "progressive" else "decode", boom)
    data = [corpus[pick], corpus["qoi_3"]] if kind != "qoi" else [corpus[pick]]
    with caplog.at_level(logging.ERROR, logger="zpix_tpu_torch"):
        outs, stats = tb.decode_mixed(data, device="cpu", return_stats=True)
    assert stats == ({"host-error": 1, "device": 1} if kind != "qoi" else {"host-error": 1})
    assert any("falling back to the host decoder" in r.getMessage() for r in caplog.records)
    for d, o in zip(data, outs):
        assert np.array_equal(o, _host(d))


def test_a_runtime_error_is_not_routed_to_the_host(monkeypatch):
    """A kernel that fails to build or launch raises RuntimeError: the call
    raises, the card's failure is not hidden behind host pixels."""
    dec = tb.decoder("png", CPU)

    def boom(*a, **k):
        raise RuntimeError("zpix_tpu_torch: png_expand failed: cudaError 719")

    monkeypatch.setattr(dec, "decode", boom)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        tb.decode_mixed([_corpus()["png_tc8_0"]], device="cpu")


def test_progressive_groups_split_by_script_and_ok_false_goes_to_host(monkeypatch, caplog):
    corpus = _corpus()
    datas = [corpus["prog_a"], corpus["prog_b"], corpus["prog_a_copy"]]
    dec = tb.decoder("progressive", CPU)
    sizes = []
    real = dec.prep_plans

    def counting(plans):
        sizes.append(len(plans))
        return real(plans)

    monkeypatch.setattr(dec, "prep_plans", counting)
    outs, stats = tb.decode_mixed(datas, device="cpu", return_stats=True)
    assert stats == {"device": 3} and sorted(sizes) == [1, 2]
    for d, o in zip(datas, outs):
        assert np.array_equal(o, _host(d))
    real_run = dec.run

    def run_not_ok(prep, bufs=None):
        px, ok = real_run(prep, bufs)
        return px, ok & (prep.batch != 2)

    monkeypatch.setattr(dec, "run", run_not_ok)
    with caplog.at_level(logging.WARNING, logger="zpix_tpu_torch"):
        outs, stats = tb.decode_mixed(datas, device="cpu", return_stats=True)
    assert stats == {"device": 1, "host-error": 2}
    assert any("failed verification" in r.getMessage() for r in caplog.records)
    for d, o in zip(datas, outs):
        assert np.array_equal(o, _host(d))


def test_decoders_are_cached_until_close():
    corpus = _corpus()
    datas = [corpus["png_tc8_0"], corpus["base_a"], corpus["qoi_0"], corpus["bmp_24_40_0"],
             corpus["prog_gray"]]
    tb.decode_mixed(datas, device="cpu")
    first = dict(tb._decoders)
    assert set(first) == {(k, CPU) for k in ("png", "jpeg", "qoi", "bmp", "progressive")}
    tb.decode_mixed(datas, device="cpu")
    assert all(tb._decoders[k] is v for k, v in first.items())
    assert tb.decoder("png", CPU) is first[("png", CPU)]
    tb.close()
    assert not tb._decoders
    assert first[("png", CPU)]._pool._shutdown and first[("progressive", CPU)]._pool._shutdown
    tb.decode_mixed(datas, device="cpu")
    assert all(tb._decoders[k] is not v for k, v in first.items())


def test_unknown_format_raises():
    with pytest.raises(jerr.UnknownFormat) as want:
        jb.decode_mixed([b"nothing"])
    with pytest.raises(terr.UnknownFormat) as got:
        tb.decode_mixed([_corpus()["qoi_0"], b"nothing"], device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("damage", DAMAGE)
def test_damaged_png_raises_the_host_decoders_error(damage):
    rng = np.random.default_rng(6)
    pix = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    good, bad = encode_png(pix, "tc8"), encode_png(pix, "tc8", damage=damage, filters=[0])
    with pytest.raises(jerr.ZpixError) as want:
        zpix_tpu.from_buffer(bad)
    with pytest.raises(terr.ZpixError) as got:
        tb.decode_mixed([good, bad], device="cpu")
    assert (type(got.value).__name__, str(got.value)) == (type(want.value).__name__,
                                                         str(want.value))


def test_metrics_count_every_route():
    corpus = _corpus()
    datas = [corpus["base_a"], corpus["base_b"], corpus["qoi_0"], corpus["prog_cmyk"]]
    metrics.reset()
    _, stats = tb.decode_mixed(datas, device="cpu", min_batch=2, return_stats=True)
    assert stats == {"device": 2, "host-small": 2}  # min_batch comes before host-routed
    counters = metrics.snapshot()["counters"]
    assert {k: v for k, v in counters.items() if k.startswith("decode_mixed.")} == {
        f"decode_mixed.{k}": v for k, v in stats.items()}


def test_load_batch(tmp_path):
    corpus = _corpus()
    paths = []
    for name in ("png_p4_0", "base_a", "qoi_2", "bmp_1_124_0", "prog_gray"):
        p = tmp_path / name
        p.write_bytes(corpus[name])
        paths.append(str(p))
    outs = tb.load_batch(paths, device="cpu")
    for p, o in zip(paths, outs):
        assert np.array_equal(o, _host(open(p, "rb").read()))


def test_default_device_is_cuda_or_raises():
    data = [_corpus()["qoi_0"]]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.decode_mixed(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.load_batch([])
