"""The port's restart-marker JPEG slice end to end on the CPU (the plain
versions of K1-K4), against the JAX package's DeviceJpegDecoder and its
host decoders.  Exact: tolerance 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_jpeg import host_pixels, synth_cmyk, synth_jpeg

from zpix_tpu.parallel.batch import parse_coefficients
from zpix_tpu.parallel.device_entropy import DeviceJpegDecoder as JaxDecoder
from zpix_tpu_torch import DeviceJpegDecoder, prep_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu(planar=False):
    return DeviceJpegDecoder(planar=planar, device="cpu")


def _grids(plan, coeffs):
    """[B*n_segs, nblk, 64] -> per component [B, bv, bh, 64] (raster)."""
    B = plan.batch
    x = coeffs.reshape(B, plan.n_segs * plan.seg_mcus, plan.bpm, 64)[:, : plan.n_mcu]
    out, s0 = [], 0
    for hc, vc in plan.hv:
        xc = x[:, :, s0 : s0 + hc * vc].reshape(B, plan.myy, plan.mxx, vc, hc, 64)
        out.append(xc.transpose(0, 1, 3, 2, 4, 5).reshape(
            B, plan.myy * vc, plan.mxx * hc, 64))
        s0 += hc * vc
    return out


@pytest.mark.parametrize("make", [
    lambda: synth_jpeg(mode="gray", w=40, h=24, dri_blocks=4),
    lambda: synth_jpeg(mode="444", w=40, h=24, dri_blocks=4),
    lambda: synth_jpeg(mode="422", w=40, h=24, dri_blocks=4),
    lambda: synth_jpeg(mode="420", w=60, h=44, dri_blocks=5),
    lambda: synth_cmyk(None, w=40, h=32),
], ids=["gray", "444", "422", "420", "cmyk"])
def test_coefficients_match_host_parse(make):
    data = make()
    plan = prep_batch([data, data])
    assert plan.n_mcu % plan.seg_mcus, "wants a partial last restart segment"
    coeffs, ok = _cpu().decode_coefficients(plan)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    assert coeffs.dtype == torch.int16
    assert tuple(coeffs.shape) == (2 * plan.n_segs, plan.seg_mcus * plan.bpm, 64)
    ref = parse_coefficients(data)
    for c, grid in enumerate(_grids(plan, coeffs.numpy())):
        for b in range(2):
            assert np.array_equal(grid[b], ref.coeffs[c]), (c, b)


def test_slice_matches_jax_device_decoder():
    datas = [synth_jpeg(mode="420", phase=p) for p in (0.0, 1.0)]
    want, want_ok = JaxDecoder(planar=True).decode(datas)
    got, ok = _cpu(planar=True).decode(datas)
    assert bool(want_ok) and bool(ok)
    assert got.shape == (2, 3, 32, 48)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
@pytest.mark.parametrize("planar", [True, False], ids=["planar", "interleaved"])
def test_ratio_matrix_matches_host_decoder(mode, planar):
    """Non-square, non-multiple-of-MCU sizes, partial last segment."""
    data = synth_jpeg(w=200, h=120, mode=mode, dri_blocks=5, quality=60)
    got, ok = _cpu(planar).decode([data, data])
    assert bool(ok)
    want = host_pixels(data)
    got = got.numpy()
    if planar and mode != "gray":
        got = got.transpose(0, 2, 3, 1)
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)


def test_restart_marker_rows_256():
    data = synth_jpeg(w=256, h=256, mode="420", restart_marker_rows=8, quality=90)
    plan = prep_batch([data])
    assert plan.seg_mcus == 8 * plan.mxx
    got, ok = _cpu().decode([data])
    assert bool(ok)
    assert np.array_equal(got.numpy()[0], host_pixels(data))


def test_invalid_codes_give_not_ok():
    """FF00 pairs destuff to FF bytes; an all-ones code is invalid in
    every table libjpeg writes."""
    data = bytearray(synth_jpeg(w=96, h=64, mode="420", phase=0.3))
    mid = (data.find(b"\xff\xda") + len(data)) // 2
    while data[mid - 1] == 0xFF:
        mid += 1
    data[mid : mid + 8] = b"\xff\x00" * 4
    _, ok = _cpu().decode([bytes(data)])
    assert not bool(ok)


def test_flipped_bytes_never_pass_silently():
    from zpix_tpu_torch.errors import ZpixError

    clean = synth_jpeg(w=200, h=120, mode="420", dri_blocks=5)
    data = bytearray(clean)
    for i in range(len(data) - 600, len(data) - 560):
        data[i] ^= 0x55
    try:
        out, ok = _cpu().decode([bytes(data)])
    except ZpixError:
        return  # the host prep refused the stream
    ref, _ = _cpu().decode([clean])
    assert not bool(ok) or not torch.equal(out, ref)


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert DeviceJpegDecoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            DeviceJpegDecoder()


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, zpix_tpu_torch, zpix_tpu_torch.ops.entropy, "
        "zpix_tpu_torch.ops.backend, zpix_tpu_torch.ops.idct, zpix_tpu_torch.runtime, "
        "zpix_tpu_torch.codecs.jpeg.decoder, zpix_tpu_torch.image.model, "
        "zpix_tpu_torch.color.convert, zpix_tpu_torch.codecs.png.decode, "
        "zpix_tpu_torch.codecs.png.defilter, zpix_tpu_torch.codecs.png.expand, "
        "zpix_tpu_torch.codecs.png.sng, zpix_tpu_torch.codecs.bmp.decode, "
        "zpix_tpu_torch.codecs.qoi.decode, zpix_tpu_torch.codecs.qoi.encode_vec, "
        "zpix_tpu_torch.parallel, zpix_tpu_torch.parallel.bucketing, "
        "zpix_tpu_torch.parallel.mesh, zpix_tpu_torch.parallel.distributed, "
        "zpix_tpu_torch.utils.roofline, zpix_tpu_torch.ops.prog_spec, "
        "zpix_tpu_torch.ops.qoi_spec, zpix_tpu_torch.parallel.progressive\n"
        "from zpix_tpu_torch import decode, decode_config, from_buffer, from_file_path, load\n"
        "from zpix_tpu_torch.parallel import BatchQoiDecoder, DeviceProgressiveDecoder\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'zpix_tpu' or m.startswith('zpix_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
