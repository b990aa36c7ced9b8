"""The content generators: the same frames from the same seed, other
frames from another, and every frame of a configuration with one geometry
and one set of tables, as a batch decoder needs."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import jpeg_baseline, qoi
from benchmark.tests import tiny

SEED = 2**31 + 3
CASES = [("cam_field", tiny.TINY_JPEG, {"noise_levels": 24}),
         ("qoi_screen", tiny.TINY_QOI, {"panels": 24, "speckle": 0.02}),
         ("qoi_photo", tiny.TINY_QOI, {"noise": 3, "period_px": 400})]


def _frame(gen, cfg, params, seed, i):
    return gen.encode(cfg, params, gen.pixels(cfg, params, seed, i))


@pytest.mark.parametrize("name,cfg,params", CASES, ids=[c[0] for c in CASES])
def test_deterministic_by_seed(name, cfg, params):
    gen = harness.load_module("content", name)
    a = [_frame(gen, cfg, params, SEED, i) for i in range(3)]
    assert a == [_frame(gen, cfg, params, SEED, i) for i in range(3)]
    assert a != [_frame(gen, cfg, params, SEED + 1, i) for i in range(3)]
    assert len(set(a)) == 3  # a batch's images are distinct


@pytest.mark.parametrize("name,cfg,params", CASES, ids=[c[0] for c in CASES])
def test_frames_share_geometry_and_tables(name, cfg, params):
    gen = harness.load_module("content", name)
    frames = [_frame(gen, cfg, params, s, i) for s in (SEED, 7) for i in range(4)]
    if cfg["codec"] == "jpeg":
        heads = {jpeg_baseline._markers(f)[:4].__repr__() for f in frames}
        assert len(heads) == 1  # frame header, quantisation, Huffman, scan
        w, h, comps = jpeg_baseline._markers(frames[0])[0]
        assert (w, h) == (cfg["width"], cfg["height"])
        assert [(c[1], c[2]) for c in comps] == [(2, 2), (1, 1), (1, 1)]  # 4:2:0
        assert all(b"\xff\xdd" not in f[:f.index(b"\xff\xda")] for f in frames)  # no DRI
    else:
        assert {qoi.header(f) for f in frames} == {(cfg["width"], cfg["height"],
                                                    cfg["channels"], 0)}


def test_full_size_jpeg_frames_share_tables():
    """At the configuration's own size (1600 x 900), two seeds' frames have
    the same headers and tables."""
    cell = harness.load_cell("cam_jpeg.sync")
    gen = harness.load_module("content", "cam_field")
    params = cell.mix["content_params"]
    a, b = (_frame(gen, cell.config, params, s, 0) for s in (SEED, 11))
    assert a != b
    assert repr(jpeg_baseline._markers(a)[:4]) == repr(jpeg_baseline._markers(b)[:4])


def test_photo_content_is_mostly_diff_and_luma():
    """Photo-like frames: DIFF and LUMA ops carry most pixels (about 2 bytes a pixel)."""
    gen = harness.load_module("content", "qoi_photo")
    cfg = dict(tiny.TINY_QOI, width=256, height=128)
    data = _frame(gen, cfg, {"noise": 3, "period_px": 400}, SEED, 0)
    ops = np.frombuffer(data[14:-8], np.uint8)
    assert 1.6 < len(ops) / (256 * 128) < 2.6
