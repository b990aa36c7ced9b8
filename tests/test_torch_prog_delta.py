"""The port's DeviceProgressiveDecoder on the CPU (K22's and K6's plain
versions) against zpix_tpu's DeviceProgressiveDecoder (XLA:CPU) and the
host decoder.  Exact: tolerance 0; the errors are zpix_tpu's, class and
message."""

import io

import numpy as np
import pytest
from _torch_jpeg import host_pixels, move_scan, synth_jpeg, synth_progressive
from PIL import Image

from zpix_tpu.parallel.progressive import DeviceProgressiveDecoder as JaxDelta
from zpix_tpu_torch.parallel import DeviceProgressiveDecoder


def _port():
    return DeviceProgressiveDecoder(device="cpu", n_threads=2)


CASES = {
    "gray": lambda: [synth_progressive(37, 29, "gray", phase=0.1)] * 2,
    "420": lambda: [synth_progressive(64, 48, "420", phase=0.2),
                    synth_progressive(64, 48, "420", phase=0.9)],
    # one geometry, two qualities: per-image tables and quant rows
    "mixed_quality": lambda: [synth_progressive(64, 48, "444", quality=q, phase=0.3)
                              for q in (30, 95, 60)],
    "moved_scan": lambda: [move_scan(synth_progressive(64, 48, "420"), 3, 5)],
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_zpix_tpu_and_host(name):
    datas = CASES[name]()
    got = _port().decode(datas).numpy()
    want = np.asarray(JaxDelta().decode(datas))
    assert np.array_equal(got, want)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i], host_pixels(d))


def _cmyk_progressive():
    buf = io.BytesIO()
    Image.new("CMYK", (32, 16), (10, 200, 30, 4)).save(buf, format="JPEG", progressive=True)
    return buf.getvalue()


REFUSALS = {
    "empty": lambda: [],
    "baseline": lambda: [synth_jpeg(48, 32, "420")],
    "cmyk": lambda: [_cmyk_progressive()],
    "geometry": lambda: [synth_progressive(64, 48, "420"), synth_progressive(48, 64, "420")],
    "sampling": lambda: [synth_progressive(64, 48, "420"), synth_progressive(64, 48, "444")],
    "truncated": lambda: [synth_progressive(64, 48, "420")[:300]],
}


def _error(fn):
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_zpix_tpu(name):
    """An empty batch, a baseline stream, CMYK, two geometries and a stream
    cut short: the same error class and message as zpix_tpu's."""
    datas = REFUSALS[name]()
    want = _error(lambda: JaxDelta().decode(datas))
    assert want is not None
    assert _error(lambda: _port().decode(datas)) == want


def test_reference_frontends_match_zpix_tpu():
    datas = CASES["420"]()
    got, want = _port().reference_frontends(datas), JaxDelta().reference_frontends(datas)
    for g, w in zip(got, want):
        assert (g.width, g.height, g.ratio, g.ncomp, g.hv, g.color) == (
            w.width, w.height, w.ratio, w.ncomp, list(w.hv) if isinstance(g.hv, list) else w.hv,
            w.color)
        for a, b in zip(g.coeffs, w.coeffs):
            assert np.array_equal(a, np.asarray(b))
