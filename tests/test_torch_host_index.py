"""The port's HostIndexJpegDecoder (host index scan -> K2 -> K3 -> K4) on
the CPU (the kernels' plain versions) against zpix_tpu's
HostIndexJpegDecoder on XLA:CPU and the host decoder, and K3's plain
version on whole-image chains against _restore_dc_T_split.  Exact:
tolerance 0.  One batch shape for the JAX decoder (its compile is the
slow part)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jpeg import (host_pixels, jax_native_lib, synth_jpeg, synth_plain_jpeg,
                         truncate_scan)

from zpix_tpu.parallel import device_entropy as jde
from zpix_tpu_torch import HostIndexJpegDecoder, prep_batch_host_index
from zpix_tpu_torch.errors import UnsupportedError
from zpix_tpu_torch.ops import entropy as ke


@pytest.fixture(scope="module")
def batch():
    return [synth_plain_jpeg(w=64, h=48, mode="420", phase=p) for p in (0.0, 1.0)]


@pytest.fixture(scope="module")
def jax_decoder():
    jax_native_lib()
    return jde.HostIndexJpegDecoder()


def _cpu(planar=False):
    return HostIndexJpegDecoder(planar=planar, device="cpu")


def test_ends_match_jax_prep(batch):
    jax_native_lib()
    want = jde.prep_batch_host_index(batch)
    got = prep_batch_host_index(batch)
    assert np.array_equal(got.stream, want.stream)
    assert np.array_equal(got.seg_bit_pos, want.seg_bit_pos)
    n = len(want.stream)
    ends = want.packed[n + 4 * len(batch):].view("<i4").reshape(got.ends.shape)
    assert np.array_equal(got.ends, ends)


def test_matches_jax_decoder_and_host(batch, jax_decoder):
    want, want_ok = jax_decoder.decode(batch)
    got, ok = _cpu().decode(batch)
    assert bool(want_ok) and bool(ok)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i, d in enumerate(batch):
        assert np.array_equal(got[i].numpy(), host_pixels(d))


def test_corrupt_stream_gives_not_ok(batch, jax_decoder):
    """Cut 10 bytes from the end of image 0's scan: the host walk reads
    the zero padding after it (5 bits past its end), the card reads the
    next image's bytes there, and K2's agree check fails."""
    bad = [truncate_scan(batch[0], 10)] + batch[1:]
    _, ok = _cpu().decode(bad)
    _, want_ok = jax_decoder.decode(bad)
    assert not bool(ok) and not bool(want_ok)


@pytest.mark.parametrize("mode", ["gray", "444", "422"])
@pytest.mark.parametrize("planar", [False, True], ids=["interleaved", "planar"])
def test_ratios_match_host_decoder(mode, planar):
    datas = [synth_plain_jpeg(w=37, h=29, mode=mode, phase=p) for p in (0.0, 0.8)]
    got, ok = _cpu(planar).decode(datas)
    assert bool(ok)
    got = got.numpy()
    if planar and mode != "gray":
        got = got.transpose(0, 2, 3, 1)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i], host_pixels(d))


def test_restart_streams_are_refused():
    with pytest.raises(UnsupportedError):
        _cpu().decode([synth_jpeg(w=48, h=32, dri_blocks=2)])


@pytest.mark.parametrize("hv,n_mcu", [(((2, 2), (1, 1), (1, 1)), 300),
                                      (((1, 1),), 2000), (((2, 1), (1, 1), (1, 1)), 700)])
def test_whole_image_dc_restore_matches_jax(hv, n_mcu):
    rng = np.random.default_rng(n_mcu)
    B, bpm = 3, sum(h * v for h, v in hv)
    dc = rng.integers(-2**31, 2**31 - 1, B * n_mcu * bpm).astype(np.int32)
    got = ke.dc_restore(torch.from_numpy(dc), hv=hv, seg_mcus=n_mcu)
    # the JAX store is slot-major: [bpm, groups, n_mcu]
    dcv = dc.reshape(B, n_mcu, bpm).transpose(2, 0, 1).reshape(-1)
    want = np.asarray(jde._restore_dc_T_split(
        jnp, jnp.asarray(dcv), groups=B, n_mcu_grp=n_mcu, bpm=bpm, hv=hv, ncomp=len(hv)))
    want = want.reshape(bpm, B, n_mcu).transpose(1, 2, 0).reshape(-1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("hv", [((3, 1),) * 3, ((1, 3),) * 3], ids=["h3", "v3"])
def test_factor3_sampling_matches_jax(hv):
    """Every component sampled 3 x 1 (or 1 x 3): the baseline preps admit
    it (the ratio test sees 1), the host decoder refuses it, and zpix_tpu's
    HostIndexJpegDecoder decodes it.  The port's plain host-index and sync
    paths give zpix_tpu's pixels, and so does the restart route on the
    same coefficients written with restart markers."""
    from _torch_jpeg import synth_ratio_jpeg

    from zpix_tpu_torch import DeviceJpegDecoder, SyncJpegDecoder

    jax_native_lib()
    datas = [synth_ratio_jpeg(hv, 40, 24, s) for s in (0, 1)]
    want, want_ok = jde.HostIndexJpegDecoder().decode(datas)
    want = np.asarray(want)
    assert bool(want_ok) and want.shape == (2, 24, 40, 3)
    for px, ok in (_cpu().decode(datas), SyncJpegDecoder(device="cpu").decode(datas),
                   DeviceJpegDecoder(device="cpu").decode(
                       [synth_ratio_jpeg(hv, 40, 24, s, dri=2) for s in (0, 1)])):
        assert bool(ok)
        assert np.array_equal(px.numpy(), want)
