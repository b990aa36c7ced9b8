"""The port's DecodePipeline (parallel/pipeline.py) on the CPU: the JPEG
pipeline against zpix_tpu's on XLA:CPU, the QOI pipeline against zpix_tpu's
host decoder, every other decoder through the adapter against its serial
decode, the staging race (every prep of a pipeline done before its first
upload), a stale QOI layout hint, a prep error at its batch's turn, and a
threaded stress run.  Exact: tolerance 0."""

import io
import sys
import threading

import numpy as np
import pytest
import torch
from _torch_jpeg import synth_jpeg, synth_plain_jpeg, synth_progressive
from _torch_png import encode_png, random_pixels
from _torch_raster import bmp_batch, qoi_enc
from PIL import Image

from zpix_tpu.codecs.qoi.decode import decode as jax_qoi_decode
from zpix_tpu.parallel import device_entropy as jde
from zpix_tpu.parallel import pipeline as jpipe
from zpix_tpu_torch import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                            DeviceJpegDecoder, HostIndexJpegDecoder, HostIndexQoiDecoder,
                            OnchipProgressiveDecoder, SyncJpegDecoder)
from zpix_tpu_torch.errors import FormatError
from zpix_tpu_torch.parallel.pipeline import (DecodePipeline, jpeg_onchip_pipeline,
                                              qoi_onchip_pipeline)

WAIT_S = 60  # every wait in these tests ends by then


def _restart_jpeg(seed, w=96, h=64):
    """tests/test_parallel.py's pipeline recipe: noise, q60, 4:2:0, a
    restart marker every 4 MCUs."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(base).save(buf, format="JPEG", quality=60, subsampling=2,
                               restart_marker_blocks=4)
    return buf.getvalue()


def _qoi_batch(seed, n=3, w=64, h=24, density=0.5):
    """n opaque QOI images: runs of flat colour broken by noise at
    ``density`` (a denser batch needs more lane entries)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.repeat(rng.integers(0, 256, (h, w // 8, 4), dtype=np.uint8), 8, axis=1)
        noise = rng.random((h, w)) < density
        img[noise] = rng.integers(0, 256, (int(noise.sum()), 4), dtype=np.uint8)
        img[..., 3] = 255
        out.append(qoi_enc(img))
    return out


def _png_batch(seed, n=3):
    rng = np.random.default_rng(seed)
    return [encode_png(random_pixels(rng, "tc8", 40, 32), "tc8", seed=seed * 7 + i)
            for i in range(n)]


def _decoded(dec, out):
    """A pipelined result as the decoder's ``decode`` gives it: PNG's run
    also returns the inflate route's flag, None on the host route."""
    if isinstance(dec, BatchPngDecoder):
        out, flag = out
        assert flag is None or int(flag) == 0
    return out


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _pixels(out):
    return out[0] if isinstance(out, tuple) else out


# --------------------------------------------------------- against zpix_tpu


def test_jpeg_pipeline_matches_jax():
    """Three batches of two restart JPEGs through the port's
    jpeg_onchip_pipeline and zpix_tpu's: the same pixels and ok, in order."""
    batches = [[_restart_jpeg(3 * s + j) for j in range(2)] for s in range(3)]
    got = list(jpeg_onchip_pipeline(DeviceJpegDecoder(planar=True, device="cpu"))
               .map(batches))
    want = list(jpipe.jpeg_onchip_pipeline(jde.DeviceJpegDecoder(planar=True)).map(batches))
    assert len(got) == len(want) == 3
    for (px, ok), (wpx, wok) in zip(got, want):
        assert bool(ok) == bool(wok) is True
        assert np.array_equal(px.numpy(), np.asarray(wpx))


def test_qoi_pipeline_matches_jax_host_decoder():
    batches = [_qoi_batch(s) for s in range(3)]
    got = list(qoi_onchip_pipeline(HostIndexQoiDecoder(device="cpu")).map(batches))
    assert len(got) == 3
    for px, datas in zip(got, batches):
        assert np.array_equal(px.numpy(), np.stack([jax_qoi_decode(d).pix for d in datas]))


# ---------------------------------------------------- every decoder, adapter


def _decoder_batches(kind):
    """A decoder on the CPU and three batches of distinct content."""
    if kind == "native":
        return (BatchJpegDecoder(device="cpu"),
                [[synth_plain_jpeg(48, 32, phase=3 * s + j) for j in range(2)]
                 for s in range(3)])
    if kind == "host_index":
        return (HostIndexJpegDecoder(device="cpu"),
                [[synth_plain_jpeg(48, 32, phase=3 * s + j) for j in range(2)]
                 for s in range(3)])
    if kind == "sync":
        return (SyncJpegDecoder(device="cpu"),
                [[synth_plain_jpeg(48, 32, phase=3 * s + j) for j in range(2)]
                 for s in range(3)])
    if kind == "progressive":  # one image repeated in a batch (Pillow's tables differ)
        return (OnchipProgressiveDecoder(device="cpu"),
                [[synth_progressive(40, 32, phase=0.3 * s)] * 2 for s in range(3)])
    if kind == "bmp":
        return (BatchBmpDecoder(device="cpu"),
                [bmp_batch((24, 40, False, False), seed=s) for s in range(3)])
    if kind == "png":
        return BatchPngDecoder(device="cpu", n_threads=2), [_png_batch(s) for s in range(3)]
    if kind == "restart":
        return (DeviceJpegDecoder(device="cpu"),
                [[synth_jpeg(48, 32, phase=3 * s + j) for j in range(2)] for s in range(3)])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["native", "host_index", "sync", "progressive", "bmp",
                                  "png", "restart"])
def test_adapter_matches_serial_decode(kind):
    """DecodePipeline(decoder): prep, upload and run overlapped across
    three batches of distinct content equal each batch's serial decode."""
    dec, batches = _decoder_batches(kind)
    got = [_decoded(dec, out) for out in DecodePipeline(dec).map(batches)]
    serial, _ = _decoder_batches(kind)
    assert len(got) == 3
    for out, datas in zip(got, batches):
        assert _same(out, serial.decode(datas))
    assert not torch.equal(_pixels(got[0]), _pixels(got[1]))  # distinct content
    for d in (dec, serial):
        if hasattr(d, "close"):
            d.close()


# ------------------------------------------------------------ staging race


class _Gate:
    """prep wrapped so that every prep of the pipeline has ended before
    its first run starts: the preps all hold their plans at once."""

    def __init__(self, dec, n):
        self.dec, self.n, self.done = dec, n, 0
        self.lock = threading.Lock()
        self.all_prepped = threading.Event()

    def prep(self, datas):
        plan = self.dec.prep(datas)
        with self.lock:
            self.done += 1
            if self.done == self.n:
                self.all_prepped.set()
        return plan

    def run(self, plan):
        assert self.all_prepped.wait(WAIT_S), "the preps did not all end"
        return self.dec.run(plan, self.dec.upload(plan))


def _race_case(kind):
    """A decoder whose preps fill shared-shape staging, three same-shape
    batches of distinct content, and a fresh decoder for the serial run."""
    if kind == "qoi_p4":
        make = lambda: HostIndexQoiDecoder(lane_p=16, lane_fmt="p4", device="cpu")  # noqa: E731
        batches = [_qoi_batch(s) for s in range(3)]
    elif kind == "png_host":
        make = lambda: BatchPngDecoder(device="cpu", n_threads=2)  # noqa: E731
        batches = [_png_batch(s) for s in range(3)]
    else:
        make = lambda: BatchJpegDecoder(device="cpu")  # noqa: E731
        batches = [[synth_plain_jpeg(48, 32, phase=3 * s + j) for j in range(2)]
                   for s in range(3)]
    return make, batches


@pytest.mark.parametrize("kind", ["qoi_p4", "png_host", "native_jpeg"])
def test_staging_race(kind):
    """prefetch=3: the three batches' preps all end before the first
    upload, so a staging buffer shared between plans would send the last
    prep's arrays for every batch.  Each result equals its serial decode."""
    make, batches = _race_case(kind)
    dec = make()
    if kind == "qoi_p4":
        dec.decode(batches[0])  # the R hint set: the lane pass fills staging in place
    gate = _Gate(dec, len(batches))
    got = [_decoded(dec, out) for out in
           DecodePipeline(prep=gate.prep, run=gate.run, prefetch=3, workers=3).map(batches)]
    serial = make()
    for out, datas in zip(got, batches):
        assert _same(out, serial.decode(datas))
    assert not torch.equal(got[0], got[1])


def test_stale_qoi_hint_gives_exact_pixels():
    """A sparse batch sets the lane layout hint; a denser batch prepped
    from the stale hint (before the run that would raise it) grows its
    layout in the host pass and decodes exactly, in the pipeline and
    alone."""
    dec = HostIndexQoiDecoder(lane_p=64, lane_fmt="p4", device="cpu")
    sparse, dense = _qoi_batch(1, density=0.02), _qoi_batch(2, density=0.9)
    dec.decode(sparse)
    hint = dec._r4_hint
    assert dec.prep(dense).R > hint  # the host pass outgrew the hint
    gate = _Gate(dec, 2)
    got = list(DecodePipeline(prep=gate.prep, run=gate.run, prefetch=2)
               .map([_qoi_batch(3, density=0.02), dense]))
    assert np.array_equal(got[1].numpy(), np.stack([jax_qoi_decode(d).pix for d in dense]))
    assert dec._r4_hint > hint
    # a hint larger than a batch needs pads its layout: the same pixels
    again = dec.decode(sparse)
    assert np.array_equal(again.numpy(), np.stack([jax_qoi_decode(d).pix for d in sparse]))


def test_prep_error_reaches_the_caller_at_its_turn():
    """A prep that raises: the batches before it are yielded, then its
    exception, the prep's own, reaches the caller; nothing runs it
    another way."""
    good = _qoi_batch(0)
    bad = good[:1] + [good[1][:20]]
    dec = HostIndexQoiDecoder(device="cpu")
    it = DecodePipeline(dec, prefetch=2).map([good, bad, good])
    first = next(it)
    assert np.array_equal(first.numpy(), np.stack([jax_qoi_decode(d).pix for d in good]))
    with pytest.raises(FormatError):
        next(it)


def test_needs_a_decoder_or_both_callables():
    with pytest.raises(ValueError):
        DecodePipeline(prep=lambda d: d)


def test_threaded_stress():
    """More prep threads than cores, a short switch interval, preps far
    ahead: QOI and native JPEG results equal their serial decodes."""
    import os

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = (os.cpu_count() or 2) + 2
        for make, batches in (_race_case("qoi_p4"), _race_case("native_jpeg")):
            batches = batches * 4
            got = list(DecodePipeline(make(), prefetch=workers, workers=workers)
                       .map(batches))
            serial = make()
            assert len(got) == len(batches)
            assert all(_same(o, serial.decode(d)) for o, d in zip(got, batches))
    finally:
        sys.setswitchinterval(old)
