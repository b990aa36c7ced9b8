"""zpix_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need a CUDA device and skip without one.  On a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py

Exact integer math: tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_jpeg import ARMS, synth_jpeg

from zpix_tpu_torch import DeviceJpegDecoder, prep_batch, runtime
from zpix_tpu_torch.ops import entropy as ke
from zpix_tpu_torch.ops.idct import idct_blocks, idct_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("lo,hi", [(-1024, 1024), (-2**31, 2**31 - 1)])
def test_idct_kernel_matches_plain(cuda, lo, hi):
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.integers(lo, hi, (1000, 8, 8)).astype(np.int32)).to(cuda)
    before = runtime.LAUNCHES["idct_blocks"]
    assert torch.equal(idct_blocks(b), idct_plain(b))
    assert runtime.LAUNCHES["idct_blocks"] == before + 1


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "interleaved"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_decode_matches_plain_path(cuda, arm, planar):
    datas = [ARMS[arm](), ARMS[arm]()]
    got, ok = DeviceJpegDecoder(planar=planar).decode(datas)
    want, want_ok = DeviceJpegDecoder(planar=planar, device="cpu").decode(datas)
    assert got.device.type == "cuda" and ok.device.type == "cuda"
    assert bool(ok) and bool(want_ok)
    assert torch.equal(got.cpu(), want)


def test_coefficients_match_plain_path(cuda):
    plan = prep_batch([synth_jpeg(w=200, h=120, dri_blocks=5, phase=p) for p in (0, 1)])
    got, ok = DeviceJpegDecoder().decode_coefficients(plan)
    want, want_ok = DeviceJpegDecoder(device="cpu").decode_coefficients(plan)
    assert bool(ok) and bool(want_ok)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seed", range(6))
def test_entropy_kernels_match_plain_on_corrupt_streams(cuda, seed):
    """Random damage to the destuffed stream: K1 and K2 must agree with
    their plain versions on every output, ok included, not only on valid
    data."""
    plan = prep_batch([synth_jpeg(w=200, h=120, dri_blocks=5, phase=p) for p in (0, 1)])
    rng = np.random.default_rng(seed)
    plan.stream = plan.stream.copy()
    used = int(plan.seg_bit_pos.max()) // 8 + 64
    at = rng.integers(0, used, 24)
    plan.stream[at] = rng.integers(0, 256, 24, dtype=np.uint8)
    bufs = DeviceJpegDecoder().upload(plan)
    kw = dict(bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)
    ends, ok = ke.index_pass(*bufs, **kw)
    ends_p, ok_p = ke.index_pass_plain(*bufs, **kw)
    assert torch.equal(ends, ends_p) and torch.equal(ok, ok_p)
    ok_k, ok_q = ok.clone(), ok.clone()
    ac, dc = ke.value_pass(*bufs, ends, ok_k, bpm=plan.bpm)
    ac_p, dc_p = ke.value_pass_plain(*bufs, ends, ok_q, bpm=plan.bpm)
    assert torch.equal(ac, ac_p) and torch.equal(dc, dc_p) and torch.equal(ok_k, ok_q)


def test_corrupt_lane_clears_ok(cuda):
    data = synth_jpeg(w=96, h=64, phase=0.3)
    plan = prep_batch([data])
    plan.stream = plan.stream.copy()
    start = int(plan.seg_bit_pos[2]) // 8
    plan.stream[start : start + 4] = 0xFF
    bufs = DeviceJpegDecoder().upload(plan)
    nblk = plan.seg_mcus * plan.bpm
    ends, ok = ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk)
    ends_p, ok_p = ke.index_pass_plain(*bufs, bpm=plan.bpm, nblk=nblk)
    assert not bool(ok) and not bool(ok_p)


# ------------------------------------------------- restart-free slice (K3, K6, K7)


@pytest.mark.parametrize("perm,cap", [(False, None), (True, None), (True, 37)],
                         ids=["grid-order", "perm", "clipped-cap"])
def test_unpack_kernel_matches_plain(cuda, perm, cap):
    from zpix_tpu_torch.ops.sparse import unpack_sparse, unpack_sparse_plain
    from zpix_tpu_torch.parallel.batch import stream_perm

    rng = np.random.default_rng(1)
    bv, bh, B = 6, 10, 3
    bitmap = torch.from_numpy(rng.integers(0, 256, (B, bv * bh, 8), dtype=np.uint8)
                              & rng.integers(0, 256, (B, bv * bh, 8), dtype=np.uint8))
    n = int(np.unpackbits(bitmap.numpy(), axis=-1).reshape(B, -1).sum(1).max())
    vals = torch.from_numpy(rng.integers(-2**15, 2**15, (B, cap or n + 5)).astype(np.int16))
    p = torch.from_numpy(stream_perm(bh // 2, bv // 2, 2, 2)) if perm else None
    kw = dict(bv=bv, bh=bh)
    before = runtime.LAUNCHES["unpack_sparse"]
    got = unpack_sparse(bitmap.to(cuda), vals.to(cuda), perm=None if p is None else p.to(cuda), **kw)
    assert runtime.LAUNCHES["unpack_sparse"] == before + 1
    assert torch.equal(got.cpu(), unpack_sparse_plain(bitmap, vals, perm=p, **kw))


_PLANE_CASES = [("gray", [(1, 1)], None), ("ycbcr", [(2, 2), (1, 1), (1, 1)], "420"),
                ("ycbcr", [(1, 1)] * 3, "444"), ("ycbcr", [(2, 1), (1, 1), (1, 1)], "422"),
                ("ycbcr", [(1, 2), (1, 1), (1, 1)], "440"),
                ("ycbcr", [(4, 1), (1, 1), (1, 1)], "411"),
                ("ycbcr", [(4, 2), (1, 1), (1, 1)], "410"),
                ("rgb", [(2, 1), (1, 1), (1, 1)], "422"),
                ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)], "420"),
                ("cmyk", [(1, 1)] * 4, None), ("cmyk", [(2, 2), (1, 1), (1, 1), (2, 2)], None)]


@pytest.mark.parametrize("wide", [False, True], ids=["jpeg-range", "wrapping"])
@pytest.mark.parametrize("color,hv,ratio", _PLANE_CASES,
                         ids=[f"{c}-{r or len(h)}-{i}" for i, (c, h, r) in enumerate(_PLANE_CASES)])
def test_planes_kernel_matches_plain(cuda, color, hv, ratio, wide):
    from _torch_jpeg import random_grids

    from zpix_tpu_torch.parallel.batch import decode_batch_planes

    rng = np.random.default_rng(2)
    mxx, myy, B = 5, 3, 2
    lo, hi = (-2**15, 2**15) if wide else (-1024, 1024)
    grids = [torch.from_numpy(g) for g in random_grids(rng, hv, mxx, myy, B, lo, hi)]
    quants = [torch.from_numpy(rng.integers(1, 2**16 if wide else 100, (B, 64)).astype(np.int32))
              for _ in hv]
    H, W = 8 * hv[0][1] * myy - 3, 8 * hv[0][0] * mxx - 5
    sub = tuple(x != hv[0] for x in hv)
    kw = dict(color=color, height=H, width=W, ratio=ratio, sub=sub)
    before = runtime.LAUNCHES["component_planes"]
    got = decode_batch_planes([g.to(cuda) for g in grids], [q.to(cuda) for q in quants], **kw)
    assert runtime.LAUNCHES["component_planes"] == before + 1
    assert torch.equal(got.cpu(), decode_batch_planes(grids, quants, **kw))


@pytest.mark.parametrize("form", ["thread", "block"])
@pytest.mark.parametrize("seg_mcus,n_seg", [(8, 40), (1500, 3)], ids=["short", "long"])
def test_dc_restore_forms_match_plain(cuda, form, seg_mcus, n_seg):
    rng = np.random.default_rng(3)
    hv = ((2, 2), (1, 1), (1, 1))
    dc = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n_seg * seg_mcus * 6).astype(np.int32))
    got = ke.dc_restore(dc.to(cuda), hv=hv, seg_mcus=seg_mcus, form=form)
    assert torch.equal(got.cpu(), ke.dc_restore_plain(dc, hv=hv, seg_mcus=seg_mcus))


@pytest.mark.parametrize("mode", ["gray", "420", "422"])
def test_restart_free_routes_agree(cuda, mode):
    from _torch_jpeg import synth_plain_jpeg

    from zpix_tpu_torch import BatchJpegDecoder, HostIndexJpegDecoder

    datas = [synth_plain_jpeg(w=200, h=120, mode=mode, phase=p) for p in (0.0, 1.0, 2.0)]
    runtime.reset_launches()
    native = BatchJpegDecoder().decode(datas)
    assert runtime.LAUNCHES["unpack_sparse"] == (1 if mode == "gray" else 3)
    assert runtime.LAUNCHES["component_planes"] == 1
    runtime.reset_launches()
    px, ok = HostIndexJpegDecoder().decode(datas)
    assert runtime.LAUNCHES["index_pass"] == 0
    assert min(runtime.LAUNCHES[k] for k in ("value_pass", "dc_restore", "backend")) == 1
    assert native.device.type == "cuda" and bool(ok)
    assert torch.equal(native, px)
    assert torch.equal(native.cpu(), BatchJpegDecoder(device="cpu").decode(datas))


# ------------------------------------------------- progressive slice (K8-K11)


def _prog_prep(mode, w, h, batch=3):
    from _torch_jpeg import synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    return OnchipProgressiveDecoder(device="cpu").prep([synth_progressive(w, h, mode)] * batch)


def _prog_stores(prep, n_scans=None):
    """The store after the first n_scans scans (all by default), on the card
    (kernels) and on the CPU (plain versions) -> (grids, ok) each."""
    from zpix_tpu_torch import OnchipProgressiveDecoder

    prep = dataclasses.replace(prep, scans=prep.scans[:n_scans])
    return [OnchipProgressiveDecoder(device=dev).decode_coefficients(prep)
            for dev in ("cuda", "cpu")]


@pytest.mark.parametrize("size", [(64, 48), (37, 29), (200, 120)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_progressive_kernels_match_plain(cuda, mode, size):
    """After every scan prefix, the store and ok of K8-K11 on the card equal
    their plain versions'."""
    prep = _prog_prep(mode, *size)
    for n in range(1, len(prep.scans) + 1):
        (g_k, ok_k), (g_p, ok_p) = _prog_stores(prep, n)
        assert int(ok_k) == int(ok_p) == 1
        for a, b in zip(g_k, g_p):
            assert torch.equal(a.cpu(), b), (n, prep.scans[n - 1].kind)


@pytest.mark.parametrize("seed", range(6))
def test_progressive_kernels_match_plain_on_damaged_streams(cuda, seed):
    """Random bytes written into every scan after the host walked it: the
    kernels and their plain versions agree on the store and on ok."""
    prep = _prog_prep("420", 200, 120)
    rng = np.random.default_rng(seed)
    for sc in prep.scans:
        sc.stream = sc.stream.copy()
        flat = sc.stream.reshape(-1)
        at = rng.integers(0, flat.shape[0], 6)
        flat[at] = rng.integers(0, 256, 6, dtype=np.uint8)
    (g_k, ok_k), (g_p, ok_p) = _prog_stores(prep)
    assert int(ok_k) == int(ok_p)
    for a, b in zip(g_k, g_p):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mode", ["gray", "420"])
def test_progressive_decoder_matches_cpu_run(cuda, mode):
    from _torch_jpeg import host_pixels, synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    datas = [synth_progressive(200, 120, mode, phase=0.4)] * 3
    runtime.reset_launches()
    px, ok = OnchipProgressiveDecoder().decode(datas)
    kinds = ("dc_first", "ac_first", "ac_refine", "dc_refine", "dc_restore", "component_planes")
    assert min(runtime.LAUNCHES[k] for k in kinds) >= 1
    assert px.device.type == "cuda" and ok.device.type == "cuda" and bool(ok)
    want, want_ok = OnchipProgressiveDecoder(device="cpu").decode(datas)
    assert bool(want_ok) and torch.equal(px.cpu(), want)
    assert np.array_equal(want[0].numpy(), host_pixels(datas[0]))


def test_progressive_damaged_upload_clears_ok(cuda):
    """Bytes changed after the host walked the first scan: the DC-first
    kernel's end check clears ok."""
    from zpix_tpu_torch import OnchipProgressiveDecoder

    prep = _prog_prep("420", 200, 120)
    sc = prep.scans[0]
    sc.stream = sc.stream.copy()
    sc.stream[4:12] ^= 0x55
    _, ok = OnchipProgressiveDecoder().run(prep)
    assert not bool(ok)


@pytest.mark.parametrize("hv", [[(1, 1)], [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)]],
                         ids=["gray", "420", "422"])
def test_planes_int32_kernel_matches_plain(cuda, hv):
    """K6's int32 arm: values past the int16 range, products that wrap."""
    from zpix_tpu_torch.ops.planes import component_planes, component_planes_plain

    rng = np.random.default_rng(4)
    mxx, myy, B = 5, 3, 2
    grids = [torch.from_numpy(rng.integers(-2**24, 2**24, (B, myy * v, mxx * h, 64))
                              .astype(np.int32)) for h, v in hv]
    quants = [torch.from_numpy(rng.integers(1, 2**16, (B, 64)).astype(np.int32)) for _ in hv]
    f = {1: (1, 1), 2: (2, 2) if hv[0] == (2, 2) else (2, 1)}[min(len(hv), 2)]
    kw = dict(color="gray" if len(hv) == 1 else "ycbcr", height=8 * hv[0][1] * myy - 3,
              width=8 * hv[0][0] * mxx - 5, factors=[(1, 1)] + [f] * (len(hv) - 1))
    before = runtime.LAUNCHES["component_planes"]
    got = component_planes([g.to(cuda) for g in grids], [q.to(cuda) for q in quants], **kw)
    assert runtime.LAUNCHES["component_planes"] == before + 1
    assert torch.equal(got.cpu(), component_planes_plain(grids, quants, **kw))
    small = [torch.from_numpy(g.numpy().clip(-1024, 1023)) for g in grids]
    a = component_planes([g.to(cuda) for g in small], [q.to(cuda) for q in quants], **kw)
    b = component_planes([g.to(torch.int16).to(cuda) for g in small],
                         [q.to(cuda) for q in quants], **kw)
    assert torch.equal(a, b)
