"""The plain reference decoders against the program's CPU path (the plain
PyTorch versions of its kernels, ``device="cpu"``) on small frames, and
the QOI reference against the rasters the frames were made from."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import jpeg_baseline, qoi
from benchmark.tests import tiny

SEED = 2**31 + 5


def _frames(name, cfg, params, n=4):
    gen = harness.load_module("content", name)
    rasters = [gen.pixels(cfg, params, SEED, i) for i in range(n)]
    return rasters, [gen.encode(cfg, params, r) for r in rasters]


@pytest.mark.parametrize("decoder", ["SyncJpegDecoder", "BatchJpegDecoder"])
@pytest.mark.parametrize("size", [(96, 64), (100, 75), (33, 17)])
def test_jpeg_reference_matches_the_program(decoder, size):
    import zpix_tpu_torch

    cfg = dict(tiny.TINY_JPEG, width=size[0], height=size[1])
    _, frames = _frames("cam_field", cfg, {"noise_levels": 24})
    out = getattr(zpix_tpu_torch, decoder)(device="cpu").decode(frames)
    pixels, ok = out if isinstance(out, tuple) else (out, None)
    assert ok is None or bool(ok)
    for i, f in enumerate(frames):
        want = jpeg_baseline.decode(f)
        assert want.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(pixels[i].numpy(), want)


def test_jpeg_reference_against_pillow_within_its_idct():
    """A second witness: libjpeg's own decode (another IDCT, smooth chroma)
    lies within a few levels of the reference on the whole frame."""
    from io import BytesIO

    from PIL import Image

    _, frames = _frames("cam_field", dict(tiny.TINY_JPEG, width=160, height=96),
                        {"noise_levels": 24}, n=1)
    want = jpeg_baseline.decode(frames[0]).astype(int)
    pil = np.asarray(Image.open(BytesIO(frames[0])).convert("RGB")).astype(int)
    assert np.abs(pil - want).mean() < 3


def test_idct_int_matches_the_program_on_random_blocks():
    from zpix_tpu_torch.codecs.jpeg.idct import idct_batch

    rng = np.random.default_rng(3)
    blocks = rng.integers(-1024, 1024, (500, 8, 8)).astype(np.int32)
    blocks[::3, 4:, :] = 0
    np.testing.assert_array_equal(jpeg_baseline.idct_int(blocks), idct_batch(blocks))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("content,params", [("qoi_screen", {"panels": 24, "speckle": 0.02}),
                                            ("qoi_photo", {"noise": 3, "period_px": 400})])
def test_qoi_reference_matches_the_rasters_and_the_program(content, params, channels):
    from zpix_tpu_torch.parallel import BatchQoiDecoder

    rasters, frames = _frames(content, dict(tiny.TINY_QOI, channels=channels), params)
    rgba, ok = BatchQoiDecoder(device="cpu").decode(frames)
    assert bool(ok)
    for i, f in enumerate(frames):
        assert rasters[i].shape[-1] == channels
        want = harness.widen(rasters[i], 4)  # a 3-channel file decodes with alpha 255
        np.testing.assert_array_equal(qoi.decode(f), want)
        np.testing.assert_array_equal(rgba[i].numpy(), want)


def test_qoi_reference_decodes_every_op():
    """Hand-made pixels that make the encoder emit every op kind, alpha included."""
    from benchmark.native import qoi_encode

    px = np.zeros((4, 20, 4), np.uint8)
    px[..., 3] = 255
    px[0, :5] = [10, 20, 30, 255]  # RGB, then a run
    px[0, 5] = [11, 19, 31, 255]  # DIFF
    px[0, 6] = [30, 40, 45, 255]  # LUMA
    px[0, 7] = [10, 20, 30, 255]  # INDEX
    px[0, 8] = [10, 20, 30, 128]  # RGBA
    px[1] = np.arange(20)[:, None] * 7 % 256
    data = qoi_encode(px)
    assert qoi.header(data) == (20, 4, 4, 0)
    np.testing.assert_array_equal(qoi.decode(data), px)
