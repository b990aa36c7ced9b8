"""The port's BatchJpegDecoder (native front-end -> K7 -> K6) on the CPU
(the kernels' plain versions) against zpix_tpu: decode_batch_ycbcr_flat
fed the JAX front-end's buffer through packed_from_arrays,
decode_batch_ycbcr_packed, BatchJpegDecoder().decode (the JAX package's
Python front-end), and the host decoder.  Exact: tolerance 0."""

import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_jpeg import (host_pixels, jax_native_lib, synth_cmyk,
                         synth_jpeg, synth_plain_jpeg, synth_ratio_jpeg,
                         synth_rgb)
from PIL import Image

from zpix_tpu.parallel import batch as jb
from zpix_tpu_torch import BatchJpegDecoder, HostIndexJpegDecoder, runtime
from zpix_tpu_torch.parallel import batch as tb
from zpix_tpu_torch.runtime import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def batch420():
    return [synth_plain_jpeg(w=51, h=35, mode="420", phase=p) for p in (0.0, 1.0)]


def _cpu():
    return BatchJpegDecoder(device="cpu")


def test_flat_route_matches_jax_flat_graph(batch420):
    jax_native_lib()
    fe = jb.NativeBatchFrontEnd(batch420[0], 2, 2)
    fe.parse(batch420)
    geo = dict(height=fe.height, width=fe.width, ratio=fe.ratio,
               by=fe.myy * fe.hv[0][1], bx=fe.mxx * fe.hv[0][0],
               cby=fe.myy * fe.hv[1][1], cbx=fe.mxx * fe.hv[1][0])
    want = np.asarray(jb.decode_batch_ycbcr_flat(
        jax.device_put(fe.buffer), *fe.quants, layout=tuple(fe.layout), batch=2,
        perm_y=fe.perm_y, perm_c=fe.perm_c, **geo))
    packed = tb.packed_from_arrays(fe.buffer, fe.layout, fe.quants, fe.perm_y, fe.perm_c,
                                   width=fe.width, height=fe.height, hv=fe.hv, batch=2)
    got = tb.decode_uploaded(tb.upload(packed, "cpu"), packed)
    assert np.array_equal(got.numpy(), want)
    flat = tb.decode_batch_ycbcr_flat(
        torch.from_numpy(fe.buffer), *[torch.from_numpy(q) for q in fe.quants],
        layout=fe.layout, batch=2, perm_y=fe.perm_y, perm_c=fe.perm_c, **geo)
    assert np.array_equal(flat.numpy(), want)
    assert np.array_equal(_cpu().decode(batch420).numpy(), want)


def test_packed_route_matches_jax_packed_graph(batch420):
    fes = [jb.parse_coefficients(d) for d in batch420]
    args = []
    for c in range(3):
        packs = [tb.pack_sparse(fe.coeffs[c]) for fe in fes]
        args += [np.stack([p[0] for p in packs]), jb._pad_vals([p[1] for p in packs])]
    quants = [np.stack([fe.quants[c] for fe in fes]) for c in range(3)]
    by, bx = fes[0].coeffs[0].shape[:2]
    cby, cbx = fes[0].coeffs[1].shape[:2]
    geo = dict(height=fes[0].height, width=fes[0].width, ratio=fes[0].ratio,
               by=by, bx=bx, cby=cby, cbx=cbx)
    want = np.asarray(jb.decode_batch_ycbcr_packed(*args, *quants, **geo))
    got = tb.decode_batch_ycbcr_packed(*[torch.from_numpy(a) for a in args + quants], **geo)
    assert np.array_equal(got.numpy(), want)


def test_matches_jax_batch_decoder_and_host(batch420):
    want = np.asarray(jb.BatchJpegDecoder().decode(batch420))
    got = _cpu().decode(batch420).numpy()
    assert np.array_equal(got, want)
    for i, d in enumerate(batch420):
        assert np.array_equal(got[i], host_pixels(d))


def test_gray_matches_jax_batch_decoder():
    datas = [synth_plain_jpeg(w=37, h=29, mode="gray", phase=p) for p in (0.0, 2.0)]
    got = _cpu().decode(datas).numpy()
    assert got.shape == (2, 29, 37)
    assert np.array_equal(got, np.asarray(jb.BatchJpegDecoder().decode(datas)))


@pytest.mark.parametrize("make", [
    lambda p: synth_plain_jpeg(w=37, h=29, mode="444", phase=p),
    lambda p: synth_plain_jpeg(w=37, h=29, mode="422", phase=p),
    lambda p: synth_jpeg(w=64, h=40, mode="420", dri_blocks=3, phase=p),
], ids=["444", "422", "420-dri"])
def test_ratios_match_host_decoder(make):
    datas = [make(p) for p in (0.0, 0.9, 1.8)]
    got = _cpu().decode(datas).numpy()
    for i, d in enumerate(datas):
        assert np.array_equal(got[i], host_pixels(d))


@pytest.mark.parametrize("hv", [[(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
                                [(4, 2), (1, 1), (1, 1)], [(2, 2), (2, 1), (2, 1)]],
                         ids=["440", "411", "410", "420-h2"])
def test_rare_ratios_match_host_decoder(hv):
    """Ratios Pillow does not write, from the tests' own encoder."""
    datas = [synth_ratio_jpeg(hv, width=43, height=27, seed=s) for s in (0, 1)]
    got = _cpu().decode(datas).numpy()
    for i, d in enumerate(datas):
        assert np.array_equal(got[i], host_pixels(d))


def test_dense_images_take_the_full_capacity():
    rng = np.random.default_rng(0)
    datas = []
    for _ in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(
            buf, format="JPEG", quality=100, subsampling=2)
        datas.append(buf.getvalue())
    sparse = synth_plain_jpeg(w=48, h=32, mode="420")
    dec = _cpu()
    dec.decode([sparse, sparse])  # sizes the cached front-end on sparse content
    got = dec.decode(datas).numpy()
    for i, d in enumerate(datas):
        assert np.array_equal(got[i], host_pixels(d))


def test_mixed_geometry_raises():
    with pytest.raises(ValueError):
        _cpu().decode([synth_plain_jpeg(w=48, h=32), synth_plain_jpeg(w=40, h=32)])
    with pytest.raises(ValueError):
        _cpu().decode([synth_plain_jpeg(mode="420"), synth_plain_jpeg(mode="444")])


def _progressive():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, format="JPEG",
                                                          progressive=True)
    return buf.getvalue()


@pytest.mark.parametrize("make", [synth_rgb, synth_cmyk, lambda: synth_cmyk(2), _progressive],
                         ids=["rgb", "cmyk", "ycck", "progressive"])
def test_unsupported_streams_name_the_missing_front_end(make):
    """The streams the native front-end refuses (it raised UnsupportedError
    naming the missing Python front-end before the port had one) now take
    the Python front-end and decode as zpix_tpu's BatchJpegDecoder does."""
    datas = [make(), make()]
    dec = _cpu()
    got = dec.decode(datas).numpy()
    dec.close()
    assert np.array_equal(got, np.asarray(jb.BatchJpegDecoder().decode(datas)))


def test_default_device_is_cuda_or_raises():
    for cls in (BatchJpegDecoder, HostIndexJpegDecoder):
        if torch.cuda.is_available():
            assert cls().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                cls()


def test_failed_builds_raise(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.lib(("-fno-such-option-zpix",))
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        runtime.lib()


def test_chip_smoke_inputs_load_neither_jax_nor_the_jax_package():
    """chip_smoke.py's JPEG inputs (tests/_torch_jpeg_writer.py, loaded by
    path) are made without the JAX package."""
    code = (
        "import sys, chip_smoke\n"
        "w = chip_smoke.jpeg_writer()\n"
        "assert len(w.k1_k2_edges(64)) == 11\n"
        "w.random_limits(w.coded_segments('six_table_pairs', n_segs=2)['tables'])\n"
        "w.synth_ratio_jpeg(((3, 1),) * 3, 40, 24, 0)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax') "
        "or m == 'zpix_tpu' or m.startswith('zpix_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_imports_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys, zpix_tpu_torch.parallel.batch, zpix_tpu_torch.parallel.device_entropy, "
        "zpix_tpu_torch.parallel.progressive_onchip, zpix_tpu_torch.codecs.jpeg, "
        "zpix_tpu_torch.codecs.jpeg.decoder, zpix_tpu_torch.codecs.jpeg.idct, "
        "zpix_tpu_torch.image, zpix_tpu_torch.image.draw, zpix_tpu_torch.image.util, "
        "zpix_tpu_torch.color, chip_smoke, zpix_tpu_torch.codecs.png, "
        "zpix_tpu_torch.codecs.png.sng, zpix_tpu_torch.codecs.bmp, zpix_tpu_torch.codecs.qoi, "
        "zpix_tpu_torch.codecs.qoi.encode_vec, zpix_tpu_torch.parallel.bucketing, "
        "zpix_tpu_torch.parallel.mesh, zpix_tpu_torch.parallel.distributed, "
        "zpix_tpu_torch.utils.roofline\n"
        "import numpy as np\n"
        "from zpix_tpu_torch import decode_config, from_buffer\n"
        "from zpix_tpu_torch.codecs.bmp.encode import encode as bmp\n"
        "from zpix_tpu_torch.codecs.qoi import Desc\n"
        "from zpix_tpu_torch.codecs.qoi.encode_vec import encode_vec\n"
        "from zpix_tpu_torch.parallel import decode_mixed\n"
        "px = np.arange(48, dtype=np.uint8).reshape(3, 4, 4)\n"
        "datas = [encode_vec(px, Desc(4, 3, 4, 0)), bmp(px[..., :3], bpp=24)]\n"
        "outs = decode_mixed(datas, device='cpu')\n"
        "from zpix_tpu_torch.parallel import make_mesh\n"
        "from zpix_tpu_torch.parallel.distributed import host_local_batch\n"
        "mesh = make_mesh(['cpu'] * 2)\n"
        "assert [o.shape for o in decode_mixed(datas * 2, mesh=mesh)] == [(3, 4, 4)] * 4\n"
        "host_local_batch(mesh, px[:2])\n"
        "assert [o.shape for o in outs] == [(3, 4, 4)] * 2\n"
        "assert [decode_config(d).width for d in datas] == [4, 4]\n"
        "from_buffer(datas[0]).rgba_pixels()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax') "
        "or m == 'zpix_tpu' or m.startswith('zpix_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
