"""The port's BatchJpegDecoder on its Python front-end (the host decoder's
scans -> pack_sparse -> one flat buffer -> K7 -> K6, the kernels' plain
versions on the CPU) against zpix_tpu's BatchJpegDecoder on XLA:CPU: RGB,
YCCK, CMYK (both samplings the SOF admits), multi-scan, progressive and
gray batches; the device half alone on zpix_tpu's own front-end output;
the reference's errors; the routing between the two front-ends; and
OnchipProgressiveDecoder.decode_verified's host fallback.  Exact:
tolerance 0."""

import numpy as np
import pytest
import torch
from _torch_jpeg import (QUAD, synth_cmyk, synth_plain_jpeg, synth_progressive,
                         synth_ratio_jpeg)

import zpix_tpu.codecs.jpeg as jj
from zpix_tpu.color import ycbcr_to_rgb8 as j_ycbcr_to_rgb8
from zpix_tpu.parallel import batch as jb
from zpix_tpu_torch import BatchJpegDecoder, OnchipProgressiveDecoder
from zpix_tpu_torch.parallel import batch as tb
from zpix_tpu_torch.parallel.pipeline import DecodePipeline
from zpix_tpu_torch.utils import metrics

W, H = 43, 27
CASES = {  # name -> make(seed)
    "rgb_444": lambda s: synth_ratio_jpeg(((1, 1),) * 3, W, H, s, adobe=0),
    "rgb_420_dri": lambda s: synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), W, H, s, dri=2,
                                              adobe=0),
    "ycck_444": lambda s: synth_ratio_jpeg(((1, 1),) * 4, W, H, s, adobe=2),
    "ycck_2211": lambda s: synth_ratio_jpeg(QUAD, W, H, s, adobe=2),
    "cmyk_444": lambda s: synth_ratio_jpeg(((1, 1),) * 4, W, H, s, adobe=0),
    "cmyk_2211": lambda s: synth_ratio_jpeg(QUAD, W, H, s, dri=3, adobe=0),
    "cmyk_pillow": lambda s: synth_cmyk(None, seed=s),
    "multi_scan_420": lambda s: synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), W, H, s,
                                                 scans="separate"),
    "multi_scan_411": lambda s: synth_ratio_jpeg(((4, 1), (1, 1), (1, 1)), W, H, s,
                                                 scans="separate"),
    # one component whose SOF says 2 x 2: one block an MCU (decoder.zig:
    # 297-300); a single scan, so the native front-end takes it
    "gray_sof_2x2": lambda s: synth_ratio_jpeg(((2, 2),), W, H, s, scans="separate"),
    "progressive_420": lambda s: synth_progressive(w=W, h=H, phase=s),
    "progressive_444": lambda s: synth_progressive(w=W, h=H, mode="444", phase=s),
    "progressive_gray": lambda s: synth_progressive(w=W, h=H, mode="gray", phase=s),
}


def _cpu(**kw):
    return BatchJpegDecoder(device="cpu", n_threads=2, **kw)


def _batch(name):
    return [CASES[name](s) for s in (0, 1)]


@pytest.fixture(scope="module")
def dec():
    d = _cpu()
    yield d
    d.close()


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_batch_decoder(dec, name):
    datas = _batch(name)
    before = metrics.counters.get("jpeg_batch.python_front_end", 0)
    got = dec.decode(datas)
    python = 0 if name.startswith("gray") else 2
    assert metrics.counters.get("jpeg_batch.python_front_end", 0) == before + python
    assert np.array_equal(got.numpy(), np.asarray(jb.BatchJpegDecoder().decode(datas)))


def jax_packed(datas) -> tb.Packed:
    """zpix_tpu's Python front-end output of a batch as the port's Packed:
    its coefficients packed with the port's pack_sparse, so the device
    halves of the two packages see the same input."""
    fes = [jb.parse_coefficients(d) for d in datas]
    parts = [(fe, [tb.pack_sparse(c) for c in fe.coeffs]) for fe in fes]
    return tb.packed_from_front_ends(parts)


@pytest.mark.parametrize("name", ["rgb_420_dri", "ycck_2211", "cmyk_2211", "cmyk_444",
                                  "multi_scan_411", "progressive_444", "progressive_gray",
                                  "gray_sof_2x2"])
def test_device_half_on_jax_front_end(dec, name):
    datas = _batch(name)
    packed = jax_packed(datas)
    assert packed.perms == [None] * len(packed.hv)
    got = dec.run(packed, dec.upload(packed))
    assert np.array_equal(got.numpy(), np.asarray(jb.BatchJpegDecoder().decode(datas)))
    if name.startswith("gray"):
        return  # the native front-end takes it: another layout
    mine = dec.prep(datas)
    assert (mine.color, mine.sub, mine.hv, mine.layout) == (packed.color, packed.sub,
                                                            packed.hv, packed.layout)
    assert torch.equal(mine.buffer, packed.buffer)


def test_packed_colour_and_sub():
    p = jax_packed(_batch("cmyk_2211"))
    assert p.color == "cmyk" and p.sub == (False, True, True, False)
    p = jax_packed(_batch("ycck_444"))
    assert p.color == "ycck" and p.sub is None and p.ratio == "444"
    p = jax_packed(_batch("rgb_420_dri"))
    assert p.color == "rgb" and p.ratio == "420"
    p = jax_packed(_batch("gray_sof_2x2"))
    assert p.color == "gray" and p.hv == ((1, 1),)


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 -- the comparison is the point
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("batch", [
    [CASES["rgb_444"](0), CASES["ycck_444"](0)],
    [CASES["cmyk_444"](0), CASES["ycck_444"](0)],
    [CASES["multi_scan_420"](0), synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), W + 8, H, 0)],
    [synth_ratio_jpeg(((1, 1),) * 4, W, H, 0), synth_ratio_jpeg(((1, 1),) * 4, W, H, 1)],
    [CASES["progressive_420"](0), CASES["progressive_420"](0)[:300]],
    [synth_plain_jpeg(mode="420"), synth_plain_jpeg(mode="444")],
    [CASES["rgb_444"](0)[:-30] + b"\xff\xd9"],
], ids=["rgb_ycck", "cmyk_ycck", "mixed_size", "cmyk_no_adobe", "truncated_progressive",
        "mixed_ratio_native", "truncated_rgb"])
def test_errors_are_the_references(dec, batch):
    want = _outcome(lambda: jb.BatchJpegDecoder().decode(batch))
    assert want is not None
    assert _outcome(lambda: dec.decode(batch)) == want


def test_routing_native_and_python(dec):
    """Restart-free gray and YCbCr single-scan batches stay on the native
    front-end; a broken batch the native front-end fails on is parsed again
    by the Python front-end, which raises the host decoder's error."""
    ok = [synth_plain_jpeg(w=40, h=24, mode="420", phase=p) for p in (0, 1)]
    before = metrics.counters.get("jpeg_batch.python_front_end", 0)
    dec.decode(ok)
    assert metrics.counters.get("jpeg_batch.python_front_end", 0) == before
    broken = [ok[0], ok[1][: len(ok[1]) // 2] + b"\xff\xd9"]
    want = _outcome(lambda: jb.BatchJpegDecoder().decode(broken))
    refused = metrics.counters.get("jpeg_batch.native_refused", 0)
    assert _outcome(lambda: dec.decode(broken)) == want
    assert metrics.counters.get("jpeg_batch.python_front_end", 0) == before
    assert metrics.counters.get("jpeg_batch.native_refused", 0) == refused


def test_native_failure_that_python_decodes_is_counted(monkeypatch):
    """Where the native front-end fails and the Python front-end decodes,
    the batch is counted under jpeg_batch.native_refused."""
    from zpix_tpu_torch.errors import FormatError

    def refuse(self, datas):
        raise FormatError("jpeg: native front-end failed on image 0")

    monkeypatch.setattr(tb.NativeBatchFrontEnd, "parse", refuse)
    datas = [synth_plain_jpeg(w=40, h=24, mode="420", phase=p) for p in (0, 1)]
    before = metrics.counters.get("jpeg_batch.native_refused", 0)
    d = _cpu()
    got = d.decode(datas)
    d.close()
    assert metrics.counters["jpeg_batch.native_refused"] == before + 2
    assert np.array_equal(got.numpy(), np.asarray(jb.BatchJpegDecoder().decode(datas)))


def test_pipeline_takes_python_front_end_batches(dec):
    batches = [_batch("cmyk_2211"), _batch("progressive_420"), _batch("multi_scan_420")]
    outs = list(DecodePipeline(dec, prefetch=2).map(batches))
    for b, out in zip(batches, outs):
        assert torch.equal(out, dec.decode(b))


def _reference_fallback(datas):
    """zpix_tpu's decode_verified fallback body (progressive_onchip.py:
    2341-2353), on zpix_tpu's host decoder."""
    outs = []
    for d in datas:
        img = jj.decode(d)
        if img.__class__.__name__ == "GrayImage":
            outs.append(img.pix)
        else:
            cb, cr = img.upsampled_cbcr()
            outs.append(np.stack(j_ycbcr_to_rgb8(img.y, cb, cr), axis=-1))
    return np.stack(outs)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_decode_verified(mode, monkeypatch):
    # Pillow writes each image's own Huffman tables: one image twice
    datas = [synth_progressive(w=W, h=H, mode=mode)] * 2
    d = OnchipProgressiveDecoder(device="cpu", n_threads=2)
    px, ok = d.decode(datas)
    assert bool(ok)
    assert np.array_equal(d.decode_verified(datas), px.numpy())
    # ok forced False: the whole batch comes from the host decoder
    run = d.run
    monkeypatch.setattr(d, "run", lambda prep, bufs=None: (run(prep, bufs)[0],
                                                            torch.tensor(False)))
    got = d.decode_verified(datas)
    assert got.dtype == np.uint8
    assert np.array_equal(got, _reference_fallback(datas))
    d.close()


def test_decode_verified_on_a_refused_stream():
    """A stream the index walk refuses (ok False): the fallback decodes the
    batch on the host, raising the host decoder's error where it does."""
    good = synth_progressive(w=W, h=H, phase=0.0)
    sos = good.find(b"\xff\xda")
    at = sos + 2 + ((good[sos + 2] << 8) | good[sos + 3]) + 2
    bad = bytearray(good)
    bad[at : at + 8] = b"\xff\x00" * 4
    bad = bytes(bad)
    d = OnchipProgressiveDecoder(device="cpu", n_threads=2)
    _, ok = d.decode([bad, good])
    assert not bool(ok)
    want = _outcome(lambda: _reference_fallback([bad, good]))
    got = _outcome(lambda: d.decode_verified([bad, good]))
    if want is None:
        assert np.array_equal(d.decode_verified([bad, good]), _reference_fallback([bad, good]))
    else:
        assert got == want
    d.close()


def test_component_without_a_scan_raises(dec):
    """A multi-scan stream whose last component has no scan: the host
    decoder decodes it (a zero plane), the batch path refuses it with a
    FormatError (zpix_tpu's fails stacking a None grid)."""
    from zpix_tpu_torch.errors import FormatError

    data = CASES["multi_scan_420"](0)
    last = data.rindex(b"\xff\xda")
    cut = data[:last] + b"\xff\xd9"
    assert jj.decode(cut) is not None
    with pytest.raises(Exception):  # noqa: B017 -- zpix_tpu fails inside JAX
        jb.BatchJpegDecoder().decode([cut, cut])
    with pytest.raises(FormatError, match="component 2 has no scan"):
        dec.decode([cut, cut])
