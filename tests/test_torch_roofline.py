"""utils/roofline.py: the H100's peaks and the work of K1-K4 as functions
of the plan, against the tensors a decode really moves and against the
bound arithmetic chip_smoke.py used before the module held it."""

import os
import sys

import pytest
from _torch_jpeg import synth_jpeg

from zpix_tpu_torch import DeviceJpegDecoder, prep_batch
from zpix_tpu_torch.ops import entropy as ke
from zpix_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan(n, mode="420"):
    return prep_batch([synth_jpeg(w=48, h=32, mode=mode, dri_blocks=2, phase=0.1 * i)
                       for i in range(n)])


def test_peaks_are_the_h100s():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT32_OPS_PER_S == 33.5e12
    assert roofline.CARD == "H100 SXM"


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_costs_grow_with_the_batch(mode):
    small = roofline.jpeg_onchip_costs(_plan(2, mode), symbols=100)
    big = roofline.jpeg_onchip_costs(_plan(4, mode), symbols=200)
    assert [c.name for c in small] == ["K1 index pass", "K2 value pass", "K3 DC restore",
                                       "K4 back-end"]
    for s, b in zip(small, big):
        assert b.int_ops > s.int_ops > 0
        assert b.bytes_moved >= s.bytes_moved > 0
    # the per-block and per-pixel terms double with the batch
    assert big[2].bytes_moved == 2 * small[2].bytes_moved
    assert big[3].int_ops == 2 * small[3].int_ops


def test_counts_are_the_tensors_a_decode_moves():
    """K2's rows and DCs, K3's DCs and K4's pixels, as the plain path on
    the CPU makes them."""
    plan = _plan(3)
    dec = DeviceJpegDecoder(device="cpu")
    bufs = dec.upload(plan)
    ac, dc, _ = dec.entropy(plan, bufs)
    px, _ = dec.run(plan, bufs)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    k1, k2, k3, k4 = roofline.jpeg_onchip_costs(plan, stream_bytes=1000)
    L1 = plan.batch * plan.n_segs
    assert k1.bytes_moved == 1000 + 8 * L1 + 4 * ke.TAB_WORDS + 4 * ac.shape[0]
    assert k2.bytes_moved - k1.bytes_moved == nbytes(ac) + nbytes(dc)
    assert k3.bytes_moved == 2 * nbytes(dc)
    assert k4.bytes_moved == nbytes(ac) + nbytes(dc) + nbytes(bufs[3]) + nbytes(px)
    assert roofline.jpeg_onchip_costs(plan)[0].bytes_moved - k1.bytes_moved == (
        plan.stream.shape[0] - 1000)


def test_bounds_equal_chip_smokes_former_arithmetic():
    """chip_smoke.py's with_bound now reads its constants here; its former
    formula (67e12 / 2 int32 ops/s, 3.35e12 B/s) gives the same bounds."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    for nbytes, ops in ((5e8, 1e9), (1e6, 1e12), (0, 3), (7, 0)):
        bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, ops / (67e12 / 2) * 1e3
        want = {"bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        got = chip_smoke.with_bound({"bytes": nbytes, "ops": ops})
        assert {k: got[k] for k in want} == want
        cost = roofline.StageCost("x", nbytes, ops)
        assert (cost.bound_ms, cost.bound_by) == (want["bound_ms"], want["bound_by"])
    # the kernel table's former inline counts for K1-K4
    plan = _plan(2)
    L1 = plan.batch * plan.n_segs
    L2 = L1 * plan.seg_mcus * plan.bpm
    n_syms, used = 1234, 5678
    k1, k2, k3, k4 = roofline.jpeg_onchip_costs(plan, stream_bytes=used, symbols=n_syms)
    assert (k1.bytes_moved, k1.int_ops) == (used + 8 * L1 + 4 * ke.TAB_WORDS + 4 * L2,
                                            chip_smoke.OPS_K1_SYMBOL * n_syms)
    assert (k2.bytes_moved, k2.int_ops) == (
        used + 8 * L1 + 4 * ke.TAB_WORDS + 4 * L2 + 128 * L2 + 4 * L2,
        chip_smoke.OPS_K2_SYMBOL * n_syms)
    assert (k3.bytes_moved, k3.int_ops) == (8 * L2, L2)
    out_bytes = plan.batch * 3 * plan.height * plan.width
    assert (k4.bytes_moved, k4.int_ops) == (
        128 * L2 + 4 * L2 + 4 * ke.TAB_WORDS + out_bytes,
        chip_smoke.OPS_K4_BLOCK * L2 + chip_smoke.OPS_K4_PIXEL * plan.batch * plan.height
        * plan.width + chip_smoke.OPS_K4_CHROMA * 64 * (L2 // plan.bpm))


def test_report_lines():
    costs = roofline.jpeg_onchip_costs(_plan(2), symbols=500)
    text = roofline.report(costs, [0.01, 0.02, None, 0.005], total_ms=0.04,
                           link_bytes=4e6, link_ms=0.2)
    lines = text.splitlines()
    assert "H100 SXM" in lines[0] and "3.35 TB/s" in lines[0] and "33.5 Tops/s" in lines[0]
    assert len(lines) == 1 + 4 + 2
    assert sum("% HBM" in ln for ln in lines) == 4  # three timed stages and the total
    assert "no time measured" in lines[3] and "TOTAL" in lines[5]
    assert lines[6].split()[:2] == ["link", "(H2D)"] and "20.00 GB/s" in lines[6]
    assert roofline.report(costs, [None] * 4).count("\n") == 4

