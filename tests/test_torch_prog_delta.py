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


def test_delta_add_segments_plain_matches_sequential_scatter_add():
    """K22's segmented plain version (one call, the updates in turn) equals
    scatter_add_ an update at a time: two updates of one store hitting the
    same coefficients, an empty update, padding pairs (0, 0) meeting a real
    index 0, and values that wrap int32."""
    import torch

    from zpix_tpu_torch.ops import prog_spec as ps

    rng = np.random.default_rng(5)
    B, N = 3, 4000
    stores = [rng.integers(-2**31, 2**31, (B, N)).astype(np.int32) for _ in range(2)]
    ups = []
    for tgt, k in ((0, 700), (1, 33), (0, 0), (0, 1001), (1, 5)):
        idx = np.zeros((B, k), np.int32)
        val = np.zeros((B, k), np.int32)
        for b in range(B):
            n = int(rng.integers(0, k + 1))
            idx[b, :n] = rng.choice(N // 2, n, replace=False)
            val[b, :n] = rng.integers(-2**31, 2**31, n)
        ups.append((tgt, idx, val))
    got = [torch.from_numpy(s.copy()) for s in stores]
    ps.delta_add_segments([(got[t], torch.from_numpy(i), torch.from_numpy(v)) for t, i, v in ups])
    want = [torch.from_numpy(s.copy()) for s in stores]
    for t, i, v in ups:
        want[t].scatter_add_(1, torch.from_numpy(i).long(), torch.from_numpy(v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    hit = np.intersect1d(ups[0][1][ups[0][2] != 0], ups[3][1][ups[3][2] != 0])
    assert hit.size > 0  # updates 0 and 3 add into shared coefficients
    with pytest.raises(ValueError):
        ps.delta_add_segments([(got[0], torch.zeros(2, 3, dtype=torch.int32),
                                torch.zeros(2, 3, dtype=torch.int32))])


@pytest.mark.parametrize("name", ["420", "moved_scan"])
def test_one_delta_call_a_decode_matches_zpix_tpu(name):
    """DeviceProgressiveDecoder adds every (scan, component) update in one
    K22 call (the updates in script order, each [B, k]) and still equals
    zpix_tpu's decoder."""
    from zpix_tpu_torch.ops import prog_spec as ps

    datas = CASES[name]()
    calls, orig = [], ps.delta_add_segments

    def counted(updates):
        calls.append(len(updates))
        return orig(updates)

    ps.delta_add_segments = counted
    try:
        got = _port().decode(datas).numpy()
    finally:
        ps.delta_add_segments = orig
    assert len(calls) == 1 and calls[0] >= 10
    assert np.array_equal(got, np.asarray(JaxDelta().decode(datas)))
