"""zpix_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need a CUDA device and skip without one.  On a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py

Exact integer math: tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_jpeg import ARMS, random_grids, synth_jpeg
from _torch_raster import K12_CASES

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


# ------------------------------------------------- K1 and K2 on their edges


def _k1_k2_against_plain(plan, *, shift_end=None):
    """K1 and K2 on the card against their plain versions on the same
    device tensors: ends, ok, coefficients and DC diffs, exactly, and one
    counted launch each.  ``shift_end``: the block whose end K2 is given
    one bit late.  -> (ok after K1, ok after K2)."""
    bufs = DeviceJpegDecoder().upload(plan)
    return _k1_k2_on(bufs, bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm, shift_end=shift_end)


def _k1_k2_on(bufs, *, bpm, nblk, shift_end=None):
    """_k1_k2_against_plain on device tensors (stream, seg_pos, seg_nmcu,
    tables)."""
    kw = dict(bpm=bpm, nblk=nblk)
    before = dict(runtime.LAUNCHES)
    ends, ok = ke.index_pass(*bufs, **kw)
    ends_p, ok_p = ke.index_pass_plain(*bufs, **kw)
    assert torch.equal(ends, ends_p) and torch.equal(ok, ok_p)
    if shift_end is not None:
        ends.view(-1)[shift_end] += 1
    ok1 = bool(ok)
    ok_k, ok_q = ok.clone(), ok.clone()
    ac, dc = ke.value_pass(*bufs, ends, ok_k, bpm=bpm)
    ac_p, dc_p = ke.value_pass_plain(*bufs, ends, ok_q, bpm=bpm)
    assert torch.equal(ac, ac_p) and torch.equal(dc, dc_p) and torch.equal(ok_k, ok_q)
    assert runtime.LAUNCHES["index_pass"] == before["index_pass"] + 1
    assert runtime.LAUNCHES["value_pass"] == before["value_pass"] + 1
    return ok1, bool(ok_k)


_EDGES = ["dri1", "partial_last_segment", "q100_noise_444", "zrl_eob_dc11", "optimized_bpm1",
          "optimized_bpm3", "optimized_bpm4", "optimized_bpm6", "bpm10", "factor3_h",
          "factor3_v"]


@pytest.mark.parametrize("case", _EDGES)
def test_entropy_kernels_match_plain_on_edges(cuda, case):
    """K1 and K2 on segments of one MCU, a partial last segment, lane
    counts no multiple of a CTA or a warp group, 63-coefficient blocks,
    ZRL runs, EOB at k = 1, DC sizes up to 11, optimised tables with long
    codes, 1-10 blocks an MCU and factor-3 samplings."""
    from _torch_jpeg import k1_k2_edges

    plan = prep_batch(k1_k2_edges()[case])
    assert _k1_k2_against_plain(plan) == (True, True)


@pytest.mark.parametrize("limits", ["as_coded", "random"])
@pytest.mark.parametrize("case", ["sixteen_bit_codes", "many_second_level_blocks",
                                  "six_table_pairs"])
def test_entropy_kernels_match_plain_on_coded_tables(cuda, case, limits):
    """K1 and K2 on segments coded with tables no Pillow image has: codes
    of 11-16 bits, more second-level blocks than a CTA holds (decoded in
    full past them), six (table, role) pairs (more than the lookahead
    regions); and the same streams under random, unsorted limits (the
    table built by the full decode, ok cleared as the plain version
    clears it).  As coded, the ends and coefficients are the writer's."""
    from _torch_jpeg import coded_segments, random_limits

    c = coded_segments(case, n_segs=1000)
    if limits == "random":
        c["tables"] = random_limits(c["tables"])
    bufs = [torch.from_numpy(c[k]).to(cuda) for k in ("stream", "seg_pos", "seg_nmcu", "tables")]
    ok1, ok2 = _k1_k2_on(bufs, bpm=c["bpm"], nblk=c["nblk"])
    if limits == "as_coded":
        assert ok1 and ok2
        ends, _ = ke.index_pass(*bufs, bpm=c["bpm"], nblk=c["nblk"])
        assert torch.equal(ends.cpu(), torch.from_numpy(c["ends"]))


@pytest.mark.parametrize("kind", ["invalid_code", "past_buffer", "end_off"])
@pytest.mark.parametrize("case", ["dri1", "optimized_bpm6"])
def test_entropy_kernels_match_plain_on_damage(cuda, case, kind):
    """An invalid code, a read past the buffer, and a block that does not
    end where ``ends`` says: ok cleared as the plain version clears it,
    every output equal."""
    from _torch_jpeg import damage_plan, k1_k2_edges

    plan = prep_batch(k1_k2_edges()[case])
    if kind == "end_off":
        assert _k1_k2_against_plain(plan, shift_end=7) == (True, False)
    else:
        assert not any(_k1_k2_against_plain(damage_plan(plan, kind)))


def _bench_jpegs(n, size, dri):
    """n distinct size x size 4:2:0 q50 JPEGs of chip_smoke.py's bench
    content (a sine pattern with seeded noise)."""
    import io

    from PIL import Image

    out = []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        x = np.linspace(0, 20, size)
        base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]) + seed)).astype(np.uint8)
        noise = rng.randint(0, 24, (size, size)).astype(np.uint8)
        buf = io.BytesIO()
        kw = {} if dri is None else {"restart_marker_blocks": dri}
        Image.fromarray(np.stack([base ^ noise, base.T, base // 2 + 64], -1)).save(
            buf, format="JPEG", quality=50, subsampling=2, **kw)
        out.append(buf.getvalue())
    return out


def test_value_pass_matches_plain_on_whole_image_chains(cuda):
    """K2 on 16 x 1024^2 restart-free images, from the host index scan's
    ends and from K19's (the sync route's stream layout)."""
    from zpix_tpu_torch import (HostIndexJpegDecoder, SyncJpegDecoder,
                                prep_batch_host_index)
    from zpix_tpu_torch.ops import sync as ksync

    datas = _bench_jpegs(16, 1024, None)
    hplan = prep_batch_host_index(datas)
    hb = HostIndexJpegDecoder().upload(hplan)
    sdec = SyncJpegDecoder()
    splan = sdec.prep(datas)
    sb = sdec.upload(splan)
    sends = ksync.sync_ends(sb[0], sb[1], sb[4], sb[3], chunk_bytes=splan.chunk_bytes,
                            n_chunks=splan.n_chunks, bpm=splan.bpm,
                            nblk=splan.n_mcu * splan.bpm)[0]
    for b, ends in ((hb, hb[4]), (sb, sends)):
        assert ends.shape == (16, 4096 * 6)
        ok_k = torch.ones(1, dtype=torch.int32, device=cuda)
        ok_q = ok_k.clone()
        ac, dc = ke.value_pass(*b[:4], ends, ok_k, bpm=6)
        ac_p, dc_p = ke.value_pass_plain(*b[:4], ends, ok_q, bpm=6)
        assert torch.equal(ac, ac_p) and torch.equal(dc, dc_p) and torch.equal(ok_k, ok_q)
        assert bool(ok_k)


def test_entropy_kernels_match_plain_at_main_shape(cuda):
    """K1 and K2 on 16 x 1024^2 with a restart marker every 8 MCUs, the
    main path's inputs."""
    plan = prep_batch(_bench_jpegs(16, 1024, 8))
    assert _k1_k2_against_plain(plan) == (True, True)


def test_entropy_kernels_on_an_unaligned_stream(cuda):
    """A stream that starts 1-3 bytes past a 4-byte boundary (a view into
    a larger buffer): the kernels read words from the aligned base."""
    from _torch_jpeg import k1_k2_edges

    plan = prep_batch(k1_k2_edges()["partial_last_segment"])
    bufs = DeviceJpegDecoder().upload(plan)
    kw = dict(bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)
    want = ke.index_pass_plain(*bufs, **kw)
    for off in (1, 2, 3):
        big = torch.zeros(bufs[0].shape[0] + 4, dtype=torch.uint8, device=cuda)
        big[off : off + bufs[0].shape[0]] = bufs[0]
        s = big[off : off + bufs[0].shape[0]]
        ends, ok = ke.index_pass(s, *bufs[1:], **kw)
        assert torch.equal(ends, want[0]) and torch.equal(ok, want[1])
        ok_k, ok_q = ok.clone(), ok.clone()
        ac, dc = ke.value_pass(s, *bufs[1:], ends, ok_k, bpm=plan.bpm)
        ac_p, dc_p = ke.value_pass_plain(*bufs, ends, ok_q, bpm=plan.bpm)
        assert torch.equal(ac, ac_p) and torch.equal(dc, dc_p) and torch.equal(ok_k, ok_q)


@pytest.mark.parametrize("size", [(40, 24), (203, 117)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("hv", [((3, 1),) * 3, ((1, 3),) * 3], ids=["h3", "v3"])
def test_factor3_sampling_decodes_on_every_baseline_route(cuda, hv, size):
    """Every component sampled 3 x 1 (or 1 x 3), which every baseline prep
    admits: HostIndexJpegDecoder, SyncJpegDecoder and DeviceJpegDecoder
    (restart markers) give ok and the plain path's pixels on the card; K6
    takes the same images' coefficient planes (replication 1: its MCU is
    a block)."""
    from _torch_jpeg import synth_ratio_jpeg

    from zpix_tpu_torch import HostIndexJpegDecoder, SyncJpegDecoder
    from zpix_tpu_torch.ops import planes as kp

    w, h = size
    plain = [synth_ratio_jpeg(hv, w, h, s) for s in (0, 1)]
    dri = [synth_ratio_jpeg(hv, w, h, s, dri=2) for s in (0, 1)]
    for make, datas in ((HostIndexJpegDecoder, plain), (SyncJpegDecoder, plain),
                        (DeviceJpegDecoder, dri)):
        runtime.reset_launches()
        got, ok = make(device=cuda).decode(datas)
        assert runtime.LAUNCHES["backend"] == 1
        want, want_ok = make(device="cpu").decode(datas)
        assert bool(ok) and bool(want_ok)
        assert torch.equal(got.cpu(), want)
    plan = prep_batch(dri)
    coeffs, ok = DeviceJpegDecoder(device="cpu").decode_coefficients(plan)
    x = coeffs.numpy().reshape(2, plan.n_segs * plan.seg_mcus, plan.bpm, 64)[:, : plan.n_mcu]
    hc, vc = hv[0]
    grids = [torch.from_numpy(np.ascontiguousarray(
        x[:, :, 3 * c : 3 * c + 3].reshape(2, plan.myy, plan.mxx, vc, hc, 64)
        .transpose(0, 1, 3, 2, 4, 5).reshape(2, plan.myy * vc, plan.mxx * hc, 64)))
        for c in range(3)]
    quants = [torch.from_numpy(np.tile(np.asarray(q, np.int32), (2, 1))) for q in plan.quants]
    kw = dict(color="ycbcr", height=h, width=w, factors=[(1, 1)] * 3)
    want = kp.component_planes_plain(grids, quants, **kw)
    got = kp.component_planes([g.to(cuda) for g in grids], [q.to(cuda) for q in quants], **kw)
    assert torch.equal(got.cpu(), want)


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
    p = stream_perm(bh // 2, bv // 2, 2, 2) if perm else None
    kw = dict(bv=bv, bh=bh)
    before = runtime.LAUNCHES["unpack_sparse"]
    got = unpack_sparse(bitmap.to(cuda), vals.to(cuda), perm=p, **kw)
    assert runtime.LAUNCHES["unpack_sparse"] == before + 1  # one kernel, no memset
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


def _backend_inputs(rng, hv, B, mxx, myy, m_pad, wide):
    """Random K4 inputs: sparse AC int16, DC int32 and quant tables, whose
    products wrap when ``wide``."""
    from zpix_tpu_torch.ops.entropy import TAB_WORDS

    n = B * m_pad * sum(h * v for h, v in hv)
    lim = 2**15 if wide else 1024
    ac = rng.integers(-lim, lim, (n, 64)) * (rng.random((n, 64)) < 0.3)
    dc = rng.integers(-2**31, 2**31 - 1, n) if wide else rng.integers(-2000, 2000, n)
    tables = rng.integers(1, 2**16 if wide else 64, TAB_WORDS)
    return (torch.from_numpy(ac.astype(np.int16)), torch.from_numpy(dc.astype(np.int32)),
            torch.from_numpy(tables.astype(np.int32)))


@pytest.mark.parametrize("wide", [False, True], ids=["jpeg-range", "wrapping"])
@pytest.mark.parametrize("planar", [True, False], ids=["planar", "interleaved"])
@pytest.mark.parametrize("color,hv,ratio", _PLANE_CASES,
                         ids=[f"{c}-{r or len(h)}-{i}" for i, (c, h, r) in enumerate(_PLANE_CASES)])
def test_backend_kernel_matches_plain(cuda, color, hv, ratio, planar, wide):
    """K4 on every arm and ratio, cropped to a size that is no multiple of
    the MCU or of 4, with padding lanes after each image (m_pad > n_mcu)."""
    from zpix_tpu_torch.ops import backend as kb

    rng = np.random.default_rng(5)
    mxx, myy, B = 5, 3, 2
    geom = kb.BackendGeometry(B, 8 * hv[0][0] * mxx - 5, 8 * hv[0][1] * myy - 3, tuple(hv),
                              mxx, myy, mxx * myy + 4, color)
    ac, dc, tables = _backend_inputs(rng, hv, B, mxx, myy, geom.m_pad, wide)
    before = runtime.LAUNCHES["backend"]
    got = kb.backend(ac.to(cuda), dc.to(cuda), tables.to(cuda), geom, planar=planar)
    assert runtime.LAUNCHES["backend"] == before + 1
    assert torch.equal(got.cpu(), kb.backend_plain(ac, dc, tables, geom, planar=planar))


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "interleaved"])
def test_backend_kernel_grid_beyond_resident(cuda, planar):
    """K4 on 8 x 1024^2 4:2:0: 4,096 strips, more than the persistent grid
    holds, so each CTA walks many."""
    from zpix_tpu_torch.ops import backend as kb

    rng = np.random.default_rng(6)
    hv = ((2, 2), (1, 1), (1, 1))
    geom = kb.BackendGeometry(8, 1024, 1024, hv, 64, 64, 64 * 64, "ycbcr")
    ac, dc, tables = (t.to(cuda) for t in _backend_inputs(rng, hv, 8, 64, 64, geom.m_pad, False))
    before = runtime.LAUNCHES["backend"]
    got = kb.backend(ac, dc, tables, geom, planar=planar)
    assert runtime.LAUNCHES["backend"] == before + 1
    assert torch.equal(got, kb.backend_plain(ac, dc, tables, geom, planar=planar))


@pytest.mark.parametrize("hv,color", [(((1, 3), (1, 1), (1, 1)), "ycbcr"),
                                      (((3, 1), (1, 1), (1, 1)), "ycbcr"),
                                      (((2, 2), (1, 1), (2, 2)), "ycbcr")],
                         ids=["v3", "h3", "chroma-unlike"])
def test_strip_kernels_refuse_unsupported_sampling(cuda, hv, color):
    """The strip stage takes replication factors of 1, 2 or 4 and chroma
    planes replicated alike, as every plan does: K4 and K6 refuse any
    other sampling on the card and launch nothing (their plain versions,
    on the CPU, take it)."""
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops.planes import component_planes

    rng = np.random.default_rng(8)
    mxx, myy, B = 5, 3, 2
    geom = kb.BackendGeometry(B, 8 * hv[0][0] * mxx - 5, 8 * hv[0][1] * myy - 3, hv, mxx, myy,
                              mxx * myy + 2, color)
    ac, dc, tables = _backend_inputs(rng, hv, B, mxx, myy, geom.m_pad, False)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(RuntimeError, match="zpix_backend failed"):
        kb.backend(ac.to(cuda), dc.to(cuda), tables.to(cuda), geom, planar=True)
    grids = [torch.from_numpy(g).to(cuda) for g in random_grids(rng, hv, mxx, myy, B)]
    quants = [torch.from_numpy(rng.integers(1, 100, (B, 64)).astype(np.int32)).to(cuda)
              for _ in hv]
    factors = [(hv[0][0] // h, hv[0][1] // v) for h, v in hv]
    with pytest.raises(RuntimeError, match="zpix_component_planes failed"):
        component_planes(grids, quants, color=color, height=geom.height, width=geom.width,
                         factors=factors)
    assert runtime.LAUNCHES == before


def test_strip_kernels_with_unaligned_coefficients(cuda):
    """Coefficients that start 2 bytes past a 16-byte boundary (a
    contiguous view into a larger buffer) take plain loads, not cp.async."""
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops.planes import component_planes, component_planes_plain

    rng = np.random.default_rng(9)
    hv = ((2, 2), (1, 1), (1, 1))
    geom = kb.BackendGeometry(2, 75, 45, hv, 5, 3, 16, "ycbcr")
    ac, dc, tables = _backend_inputs(rng, hv, 2, 5, 3, geom.m_pad, False)
    store = torch.zeros(ac.numel() + 1, dtype=torch.int16, device=cuda)
    ac_view = store[1:].view(ac.shape)
    ac_view.copy_(ac.to(cuda))
    assert ac_view.data_ptr() % 16
    got = kb.backend(ac_view, dc.to(cuda), tables.to(cuda), geom, planar=True)
    assert torch.equal(got.cpu(), kb.backend_plain(ac, dc, tables, geom, planar=True))
    grids = []
    for g in random_grids(rng, hv, 5, 3, 2):
        s16 = torch.zeros(g.size + 1, dtype=torch.int16, device=cuda)
        grids.append(s16[1:].view(g.shape))
        grids[-1].copy_(torch.from_numpy(g).to(cuda))
    quants = [torch.from_numpy(rng.integers(1, 100, (2, 64)).astype(np.int32)) for _ in hv]
    kw = dict(color="ycbcr", height=45, width=75, factors=[(1, 1), (2, 2), (2, 2)])
    got = component_planes(grids, [q.to(cuda) for q in quants], **kw)
    assert torch.equal(got.cpu(), component_planes_plain([g.cpu() for g in grids], quants, **kw))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32], ids=["int16", "int32"])
def test_planes_kernel_grid_beyond_resident(cuda, dtype):
    """K6 on 8 x 1024^2 4:2:0 grids: more strips than the persistent grid
    holds."""
    from zpix_tpu_torch.ops.planes import component_planes, component_planes_plain

    rng = np.random.default_rng(7)
    hv = [(2, 2), (1, 1), (1, 1)]
    grids = [torch.from_numpy(g).to(dtype).to(cuda) for g in random_grids(rng, hv, 64, 64, 8)]
    quants = [torch.from_numpy(rng.integers(1, 100, (8, 64)).astype(np.int32)).to(cuda)
              for _ in hv]
    kw = dict(color="ycbcr", height=1024, width=1024, factors=[(1, 1), (2, 2), (2, 2)])
    before = runtime.LAUNCHES["component_planes"]
    got = component_planes(grids, quants, **kw)
    assert runtime.LAUNCHES["component_planes"] == before + 1
    assert torch.equal(got, component_planes_plain(grids, quants, **kw))


@pytest.mark.parametrize("seg_mcus,n_seg", [(8, 40), (1500, 3)], ids=["short", "long"])
def test_dc_restore_forms_match_plain(cuda, seg_mcus, n_seg):
    """K3's one kernel on short chains (no look-back) and long ones
    (look-back), with wrapping sums; one launch a call."""
    rng = np.random.default_rng(3)
    hv = ((2, 2), (1, 1), (1, 1))
    dc = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n_seg * seg_mcus * 6).astype(np.int32))
    before = runtime.LAUNCHES["dc_restore"]
    got = ke.dc_restore(dc.to(cuda), hv=hv, seg_mcus=seg_mcus)
    assert runtime.LAUNCHES["dc_restore"] == before + 1
    assert torch.equal(got.cpu(), ke.dc_restore_plain(dc, hv=hv, seg_mcus=seg_mcus))


_K3_HV = {"420": ((2, 2), (1, 1), (1, 1)), "gray": ((1, 1),), "422": ((2, 1), (1, 1), (1, 1)),
          "cmyk": ((1, 1),) * 4, "ycck": ((2, 2), (1, 1), (1, 1), (2, 2))}


@pytest.mark.parametrize("delta", [None, -1, 0, 1], ids=["one", "tile-1", "tile", "tile+1"])
@pytest.mark.parametrize("arm", list(_K3_HV))
def test_dc_restore_chain_lengths(cuda, arm, delta):
    """Whole-image chains of 1, tile - 1, tile and tile + 1 MCUs, 3 images,
    diffs over the whole int32 range (sums wrap)."""
    hv = _K3_HV[arm]
    bpm = sum(h * v for h, v in hv)
    n_mcu = 1 if delta is None else ke.K3_TILE_MCUS + delta
    rng = np.random.default_rng(n_mcu + bpm)
    dc = torch.from_numpy(rng.integers(-2**31, 2**31, 3 * n_mcu * bpm).astype(np.int32))
    got = ke.dc_restore(dc.to(cuda), hv=hv, seg_mcus=n_mcu)
    assert torch.equal(got.cpu(), ke.dc_restore_plain(dc, hv=hv, seg_mcus=n_mcu))


@pytest.mark.parametrize("seg_mcus", [3, 5, 7, 100, 300, 1000])
def test_dc_restore_segments_cross_tiles(cuda, seg_mcus):
    """Restart segments that no tile size divides: segments start inside
    tiles and cross tile ends; the wrap of int32 sums on every chain."""
    hv = ((2, 2), (1, 1), (1, 1))
    n_seg = 2000 // seg_mcus + 3
    rng = np.random.default_rng(seg_mcus)
    dc = rng.integers(2**30, 2**31, n_seg * seg_mcus * 6).astype(np.int32)
    dc = torch.from_numpy(dc)
    got = ke.dc_restore(dc.to(cuda), hv=hv, seg_mcus=seg_mcus)
    want = ke.dc_restore_plain(dc, hv=hv, seg_mcus=seg_mcus)
    assert torch.equal(got.cpu(), want)
    assert bool((want < 0).any())  # the sums wrapped


def test_dc_restore_unaligned_views(cuda):
    """Diffs and output not 16-byte aligned take K3's word loads."""
    hv = ((2, 2), (1, 1), (1, 1))
    rng = np.random.default_rng(9)
    base = torch.from_numpy(rng.integers(-2**20, 2**20, 1 + 700 * 6 * 2).astype(np.int32))
    dc = base.to(cuda)[1:]
    got = ke.dc_restore(dc, hv=hv, seg_mcus=700)
    assert torch.equal(got.cpu(), ke.dc_restore_plain(base[1:], hv=hv, seg_mcus=700))


def _sparse_case(rng, bv, bh, batch, cap=None):
    bitmap = (rng.integers(0, 256, (batch, bv * bh, 8))
              & rng.integers(0, 256, (batch, bv * bh, 8))).astype(np.uint8)
    n = int(np.unpackbits(bitmap, axis=-1).reshape(batch, -1).sum(1).max())
    vals = rng.integers(-2**15, 2**15, (batch, cap or n + 5)).astype(np.int16)
    return torch.from_numpy(bitmap), torch.from_numpy(vals)


_K7_HV = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1),
          "410": (4, 2)}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("ratio", list(_K7_HV) + ["gray"])
def test_unpack_components_one_launch(cuda, ratio, batch):
    """K7 over every component of a decode in one launch: grids of 7 x 9
    and 37 x 29 MCUs (block counts no tile divides, and grids below one
    tile), every sampling, gray, batch 1, Cr's cap clipped."""
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel.batch import stream_perm

    hv = (1, 1) if ratio == "gray" else _K7_HV[ratio]
    rng = np.random.default_rng(batch)
    for mxx, myy in ((7, 9), (37, 29)):
        dims = [(myy * hv[1], mxx * hv[0])] + ([] if ratio == "gray" else [(myy, mxx)] * 2)
        perms = [stream_perm(mxx, myy, *hv)] + [None] * (len(dims) - 1)
        comps = []
        for c, ((bv, bh), perm) in enumerate(zip(dims, perms)):
            bm, vals = _sparse_case(rng, bv, bh, batch, cap=37 if c == 2 else None)
            comps.append(ks.SparseComponent(bm, vals, bv, bh, perm))
        want = ks.unpack_components_plain(comps)
        before = runtime.LAUNCHES["unpack_sparse"]
        got = ks.unpack_components([c._replace(bitmap=c.bitmap.to(cuda), vals=c.vals.to(cuda))
                                    for c in comps])
        assert runtime.LAUNCHES["unpack_sparse"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("first_epoch", [0, 2**30 - 2], ids=["fresh", "wrapping"])
def test_look_back_scratch_reused(cuda, first_epoch):
    """K7 and K3 (whole-image chains) share the stream's kept scratch, a
    new epoch a launch and no memset: repeated calls agree, each leaves
    the ticket counter at 0, and the epochs wrap (the scratch zeroed and
    epoch 1 again)."""
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel.batch import stream_perm

    rng = np.random.default_rng(21)
    comps = []
    for c, (bv, bh) in enumerate([(58, 74), (29, 37), (29, 37)]):
        bm, vals = _sparse_case(rng, bv, bh, 2)
        comps.append(ks.SparseComponent(bm.to(cuda), vals.to(cuda), bv, bh,
                                        stream_perm(37, 29, 2, 2) if c == 0 else None))
    hv = ((2, 2), (1, 1), (1, 1))
    dc = torch.from_numpy(rng.integers(-2**31, 2**31, 2 * 1000 * 6).astype(np.int32)).to(cuda)
    k7 = ks.unpack_components_plain([c._replace(bitmap=c.bitmap.cpu(), vals=c.vals.cpu())
                                     for c in comps])
    k3 = ke.dc_restore_plain(dc.cpu(), hv=hv, seg_mcus=1000)
    scratch, epoch = runtime.lookback_scratch(dc.device, 1)
    runtime._scratch[(dc.device.index, torch.cuda.current_stream(dc.device).cuda_stream)][1] = (
        first_epoch or epoch)
    epochs = []
    for _ in range(3):
        got7 = ks.unpack_components(comps)
        got3 = ke.dc_restore(dc, hv=hv, seg_mcus=1000)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got7, k7))
        assert torch.equal(got3.cpu(), k3)
        scratch, epoch = runtime.lookback_scratch(dc.device, 1)
        assert int(scratch[0]) == 0  # the ticket counter
        epochs.append(epoch)
    assert epochs == [2, 5, 8] if first_epoch else len(set(epochs)) == 3


@pytest.mark.parametrize("shift", [1, 3, 7])
def test_unpack_values_at_every_alignment(cuda, shift):
    """Values that start 2 * shift bytes past a 16-byte boundary (K7's
    unaligned head and tail), dense blocks, and a cap of 1."""
    from zpix_tpu_torch.ops import sparse as ks

    rng = np.random.default_rng(shift)
    bv, bh, batch = 20, 30, 2
    bm = torch.full((batch, bv * bh, 8), 255, dtype=torch.uint8)
    bm[:, ::7] = torch.from_numpy(rng.integers(0, 256, (batch, (bv * bh + 6) // 7, 8)
                                               ).astype(np.uint8))
    for cap in (bv * bh * 64, 1000, 1):
        store = torch.from_numpy(rng.integers(-2**15, 2**15, batch * cap + shift)
                                 .astype(np.int16)).to(cuda)
        vals = store[shift:].view(batch, cap)
        got = ks.unpack_sparse(bm.to(cuda), vals, bv=bv, bh=bh)
        assert torch.equal(got.cpu(), ks.unpack_sparse_plain(bm, vals.cpu(), bv=bv, bh=bh))


@pytest.mark.parametrize("mode", ["gray", "420", "422"])
def test_restart_free_routes_agree(cuda, mode):
    from _torch_jpeg import synth_plain_jpeg

    from zpix_tpu_torch import BatchJpegDecoder, HostIndexJpegDecoder

    datas = [synth_plain_jpeg(w=200, h=120, mode=mode, phase=p) for p in (0.0, 1.0, 2.0)]
    runtime.reset_launches()
    native = BatchJpegDecoder().decode(datas)
    assert runtime.LAUNCHES["unpack_sparse"] == 1  # every component, one kernel
    assert runtime.LAUNCHES["component_planes"] == 1
    runtime.reset_launches()
    px, ok = HostIndexJpegDecoder().decode(datas)
    assert runtime.LAUNCHES["index_pass"] == 0
    assert min(runtime.LAUNCHES[k] for k in ("value_pass", "dc_restore", "backend")) == 1
    assert native.device.type == "cuda" and bool(ok)
    assert torch.equal(native, px)
    assert torch.equal(native.cpu(), BatchJpegDecoder(device="cpu").decode(datas))


# ------------------------------------------------- progressive slice (K8-K11)


def _prog_prep(mode, w, h, batch=3, **kw):
    from _torch_jpeg import synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    return OnchipProgressiveDecoder(device="cpu").prep([synth_progressive(w, h, mode, **kw)]
                                                       * batch)


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


@pytest.mark.parametrize("mode,w,h,quality", [("420", 200, 120, 90), ("420", 200, 120, 25),
                                               ("444", 200, 120, 90), ("gray", 200, 120, 25),
                                               ("420", 199, 45, 75), ("444", 301, 37, 90)])
def test_progressive_kernels_match_plain_at_other_qualities(cuda, mode, w, h, quality):
    """K8-K11 at q90 (many refinement corrections) and q25 (few), 4:4:4
    and gray, and crops whose width is not a multiple of 8 with more valid
    blocks a row than a warp's 32 (K10's warps span block rows): the store
    and ok after every scan equal the plain versions'."""
    prep = _prog_prep(mode, w, h, quality=quality)
    assert any(sc.kind == "ac_refine" for sc in prep.scans)
    (g_k, ok_k), (g_p, ok_p) = _prog_stores(prep)
    assert int(ok_k) == int(ok_p) == 1
    for a, b in zip(g_k, g_p):
        assert torch.equal(a.cpu(), b)


def test_progressive_refine_on_unaligned_store(cuda):
    """K10 on a grid whose rows are not 16-byte aligned (a view one word
    into its storage: word loads and stores): the store and ok equal the
    plain version's after every refinement scan."""
    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    prep = _prog_prep("420", 200, 120, quality=90)
    scans, _ = OnchipProgressiveDecoder(device="cpu").upload(prep)
    grids, ok = po.new_store(prep, "cpu")
    n = 0
    for sc, t in zip(prep.scans, scans):
        if sc.kind == "ac_refine":
            c = sc.comps[0]
            kw = dict(valid=po.valid_grid(prep, c), ss=sc.ss, se=sc.se, al=sc.al)
            args = (t["stream"], t["starts"], t["ends"], t["flags"], t["tables"])
            want, want_ok = grids[c].clone(), torch.ones(1, dtype=torch.int32)
            kp.ac_refine_plain(*args, want_ok, want, **kw)
            flat = torch.empty(grids[c].numel() + 1, dtype=torch.int32, device=cuda)
            got = flat[1:].view(grids[c].shape)
            got.copy_(grids[c])
            assert got.data_ptr() % 16
            got_ok = torch.ones(1, dtype=torch.int32, device=cuda)
            kp.ac_refine(*(a.to(cuda) for a in args), got_ok, got, **kw)
            assert torch.equal(got.cpu(), want) and int(got_ok) == int(want_ok) == 1
            n += 1
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
    assert n > 0


@pytest.mark.parametrize("quality", [90, 50])
def test_progressive_refine_streams_cut_short(cuda, quality):
    """Each refinement scan's stream buffer cut at about 48 places over the
    scan's data (its cap moved): blocks stop where a read would pass the
    buffer, inside grouped correction-bit reads among them; K10's store
    and ok equal the plain version's at every cut."""
    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    prep = _prog_prep("420", 96, 64, batch=2, quality=quality)
    scans, _ = OnchipProgressiveDecoder(device="cpu").upload(prep)
    grids, ok = po.new_store(prep, "cpu")
    cuts = 0
    for sc, t in zip(prep.scans, scans):
        if sc.kind == "ac_refine":
            c = sc.comps[0]
            kw = dict(valid=po.valid_grid(prep, c), ss=sc.ss, se=sc.se, al=sc.al)
            lo = int(t["starts"].min()) // 8
            hi = min(int(t["ends"].max()) // 8 + 9, t["stream"].shape[0])
            step = max(1, (hi - lo) // 48)
            for cap in range(max(lo, 5), hi + 1, step):  # the plain window needs 5 bytes
                args = (t["stream"][:cap], t["starts"], t["ends"], t["flags"], t["tables"])
                want, want_ok = grids[c].clone(), torch.ones(1, dtype=torch.int32)
                kp.ac_refine_plain(*args, want_ok, want, **kw)
                got, got_ok = grids[c].to(cuda, copy=True), torch.ones(1, dtype=torch.int32,
                                                                       device=cuda)
                kp.ac_refine(*(a.to(cuda) for a in args), got_ok, got, **kw)
                assert torch.equal(got.cpu(), want) and int(got_ok) == int(want_ok), cap
                cuts += int(want_ok) == 0
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
    assert int(ok) == 1 and cuts > 0


@pytest.mark.parametrize("mode", ["gray", "420"])
def test_progressive_decoder_matches_cpu_run(cuda, mode):
    from _torch_jpeg import host_pixels, synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    datas = [synth_progressive(200, 120, mode, phase=0.4)] * 3
    runtime.reset_launches()
    px, ok = OnchipProgressiveDecoder().decode(datas)
    kinds = ("dc_first", "ac_first", "ac_refine", "dc_refine", "component_planes")
    assert min(runtime.LAUNCHES[k] for k in kinds) >= 1
    assert runtime.LAUNCHES["dc_first"] == 1 and runtime.LAUNCHES["dc_restore"] == 0
    assert px.device.type == "cuda" and ok.device.type == "cuda" and bool(ok)
    want, want_ok = OnchipProgressiveDecoder(device="cpu").decode(datas)
    assert bool(want_ok) and torch.equal(px.cpu(), want)
    assert np.array_equal(want[0].numpy(), host_pixels(datas[0]))


def _first_scan(prep, kind):
    from zpix_tpu_torch import OnchipProgressiveDecoder

    scans, _ = OnchipProgressiveDecoder(device="cpu").upload(prep)
    return [(sc, t) for sc, t in zip(prep.scans, scans) if sc.kind == kind]


def _dc_first_both(cuda, prep, sc, t, stream=None):
    """K8 on the card and its plain version from a zeroed store -> (grids,
    ok) each, on the CPU; the kernel's launches counted."""
    from zpix_tpu_torch.parallel import progressive_onchip as po

    t = dict(t, stream=t["stream"] if stream is None else stream)
    out = []
    for dev in (cuda, "cpu"):
        grids, ok = po.new_store(prep, dev)
        if dev == cuda:
            runtime.reset_launches()
        po.apply_scan(po.SCAN_KERNELS["dc_first"], sc, {k: v.to(dev) for k, v in t.items()},
                      grids, prep, ok)
        if dev == cuda:
            assert runtime.LAUNCHES["dc_first"] == 1 and runtime.LAUNCHES["dc_restore"] == 0
        out.append(([g.cpu() for g in grids], int(ok)))
    return out


@pytest.mark.parametrize("size", [(1024, 768), (1000, 600)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_dc_first_kernel_chains_across_tiles(cuda, mode, size):
    """K8 in one launch on images whose chains cross many tiles (3 images,
    widths a multiple of the MCU or not): the store and ok equal the plain
    decode, prefix and store."""
    prep = _prog_prep(mode, *size)
    (sc, t), = _first_scan(prep, "dc_first")
    (g_k, ok_k), (g_p, ok_p) = _dc_first_both(cuda, prep, sc, t)
    assert ok_k == ok_p == 1
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_p))


@pytest.mark.parametrize("tile", [1, 32, 64, 200, 1024])
@pytest.mark.parametrize("mode", ["gray", "420"])
def test_dc_first_kernel_every_tile(cuda, mode, tile, monkeypatch):
    """K8 at tiles of one MCU up to 1,024 blocks (ops/progressive.py's
    DC_TILE_LANES): every tile size gives the plain store."""
    from zpix_tpu_torch.ops import progressive as kp

    monkeypatch.setattr(kp, "DC_TILE_LANES", tile)
    prep = _prog_prep(mode, 301, 203)
    (sc, t), = _first_scan(prep, "dc_first")
    (g_k, ok_k), (g_p, ok_p) = _dc_first_both(cuda, prep, sc, t)
    assert ok_k == ok_p == 1
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_p))


@pytest.mark.parametrize("seed", range(8))
def test_dc_first_kernel_on_damaged_and_short_streams(cuda, seed):
    """K8 on a stream with random bytes written after the host walk (bad
    codes, symbols > 16, blocks ending off ``ends``) and on the same
    stream cut short (blocks past the cap store diff 0): the same store
    and ok as the plain version."""
    prep = _prog_prep("420" if seed % 2 else "gray", 320, 200)
    (sc, t), = _first_scan(prep, "dc_first")
    rng = np.random.default_rng(seed)
    bad = t["stream"].clone()
    at = torch.from_numpy(rng.integers(0, bad.shape[0], 8))
    bad[at] = torch.from_numpy(rng.integers(0, 256, 8, dtype=np.uint8))
    cut = t["stream"][: int(rng.integers(8, t["stream"].shape[0]))]
    for stream in (bad, cut):
        (g_k, ok_k), (g_p, ok_p) = _dc_first_both(cuda, prep, sc, t, stream)
        assert ok_k == ok_p
        assert all(torch.equal(a, b) for a, b in zip(g_k, g_p))
    assert ok_p == 0  # the cut stream fails


def _ac_first_both(cuda, args, grid, kw, offset=0):
    """K9 on the card (its store ``offset`` words into a buffer) and its
    plain version from the same store -> ((grid, ok) kernel, (grid, ok)
    plain), on the CPU."""
    from zpix_tpu_torch.ops import progressive as kp

    want, want_ok = grid.clone(), torch.ones(1, dtype=torch.int32)
    kp.ac_first_plain(*args, want_ok, want, **kw)
    flat = torch.empty(grid.numel() + offset, dtype=torch.int32, device=cuda)
    got = flat[offset:].view(grid.shape)
    got.copy_(grid)
    got_ok = torch.ones(1, dtype=torch.int32, device=cuda)
    runtime.reset_launches()
    kp.ac_first(*(a.to(cuda) for a in args), got_ok, got, **kw)
    assert runtime.LAUNCHES["ac_first"] == 1
    return (got.cpu(), int(got_ok)), (want, int(want_ok))


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("case", ["band_1_5", "band_6_63", "zrl_heavy", "band_store",
                                  "one_position", "no_eob_bits"])
def test_ac_first_kernel_on_hand_coded_scans(cuda, case, offset):
    """K9 on hand-coded scans (ZRL, the overflow rule, long EOB runs, codes
    past the lookahead, blocks an EOB run covers) on a store that already
    holds values, aligned and not 16-byte aligned: the plain version's
    store and ok, and the coded values added."""
    from _torch_prog import ac_first_scan

    kw = dict(dict(batch=4, nvy=19, nvx=45, bv=20, bh=48), **{
        "band_1_5": dict(ss=1, se=5, al=2), "band_6_63": dict(ss=6, se=63, al=2),
        "zrl_heavy": dict(ss=1, se=63, al=1, zrl=0.5, overflow=0.1),
        "band_store": dict(ss=1, se=63, al=1, store="band"),
        "one_position": dict(ss=9, se=9, al=13),
        "no_eob_bits": dict(ss=1, se=40, al=1, eob_run_bits=False, covered=0.0)}[case])
    sc = ac_first_scan(11, **kw)
    p = sc["prep"]
    args = tuple(torch.from_numpy(a) for a in (p.stream, p.starts, p.ends, p.flags, p.tables))
    (got, ok_k), (want, ok_p) = _ac_first_both(
        cuda, args, torch.from_numpy(sc["grid"]),
        dict(valid=sc["valid"], ss=p.ss, se=p.se, al=p.al), offset)
    assert ok_k == ok_p == 1
    assert torch.equal(got, want) and np.array_equal(want.numpy(), sc["want"])


@pytest.mark.parametrize("ctas", [1, 3])
@pytest.mark.parametrize("quality", [25, 95])
def test_ac_first_kernel_at_qualities(cuda, quality, ctas, monkeypatch):
    """K9's four scans at q25 (long EOB runs) and q95 (many values, ZRL),
    1 and 3 CTAs an SM, on a store of random values: the plain version's
    store and ok, cut short too."""
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    monkeypatch.setattr(kp, "AC_CTAS_PER_SM", ctas)
    prep = _prog_prep("420", 640, 480, quality=quality)
    rng = np.random.default_rng(quality)
    n = 0
    for sc, t in _first_scan(prep, "ac_first"):
        c = sc.comps[0]
        shape = (prep.batch, prep.myy * prep.hv[c][1], prep.mxx * prep.hv[c][0], 64)
        grid = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, shape).astype(np.int32))
        kw = dict(valid=po.valid_grid(prep, c), ss=sc.ss, se=sc.se, al=sc.al)
        for cap in (t["stream"].shape[0], t["stream"].shape[0] * 2 // 3):
            args = (t["stream"][:cap], t["starts"], t["ends"], t["flags"], t["tables"])
            (got, ok_k), (want, ok_p) = _ac_first_both(cuda, args, grid, kw)
            assert ok_k == ok_p and torch.equal(got, want)
            n += 1
    assert n == 8


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


# ------------------------------------------------- QOI and BMP slice (K12-K14, K18)


def _dev(a, dev):
    """numpy -> a tensor on ``dev``; uint32 as the int32 of the same bits."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)


def _qoi_lane_plans(datas, P):
    from zpix_tpu_torch.parallel import qoi_batch as tq

    return tq.prep_qoi_lanes4(datas, P), tq.prep_qoi_lanes(datas, P)


def _lane_counted(fn, *args, **kw):
    before = runtime.LAUNCHES["qoi_lane_expand"]
    out = fn(*args, **kw)
    assert runtime.LAUNCHES["qoi_lane_expand"] == before + 1
    return out


@pytest.mark.parametrize("P", [8, 16, 60, 320])
def test_qoi_lane_expand_matches_plain_on_host_plans(cuda, P):
    """K12, both formats, on the lanes the host fills make (opaque images
    for p4, every image for the wide form)."""
    from _torch_raster import qoi_enc, qoi_images

    from zpix_tpu_torch.ops import qoi as kq

    imgs = qoi_images()
    opaque = [qoi_enc(i) for i in imgs if (i[..., 3] == 255).all()]
    p4, _ = _qoi_lane_plans(opaque, P)
    shape = (p4.batch, p4.height, p4.width)
    t = torch.from_numpy(p4.p4).to(cuda)
    got = _lane_counted(kq.lane_expand_p4, t, P=p4.P, shape=shape)
    assert torch.equal(got, kq.lane_expand_p4_plain(t, P=p4.P, shape=shape))
    _, wide = _qoi_lane_plans([qoi_enc(i) for i in imgs], P)
    cols, s, e = (_dev(a, cuda) for a in (wide.cols, wide.s, wide.e))
    shape = (wide.batch, wide.height, wide.width)
    got = _lane_counted(kq.lane_expand_wide, cols, s, e, P=wide.P, shape=shape)
    assert torch.equal(got, kq.lane_expand_wide_plain(cols, s, e, P=wide.P, shape=shape))


@pytest.mark.parametrize("P,R", [(16, 5), (128, 72), (300, 9), (20, 3000)])
def test_qoi_lane_expand_matches_plain_on_any_entries(cuda, P, R):
    """K12 on hand-built entries that overlap, leave gaps or lie outside
    the lane (wide), and on granules of random bytes (p4, P <= 255): the
    masked sum, wrapping, not a tiling."""
    from _torch_raster import lane_entries, p4_entries

    from zpix_tpu_torch.ops import qoi as kq

    rng = np.random.default_rng(P + R)
    lanes = 3 * 7
    shape = (3, 7, P)
    cols, s, e = (_dev(a, cuda) for a in lane_entries(rng, lanes, R, P))
    got = _lane_counted(kq.lane_expand_wide, cols, s, e, P=P, shape=shape)
    assert torch.equal(got, kq.lane_expand_wide_plain(cols, s, e, P=P, shape=shape))
    if P <= 255:
        p4 = torch.from_numpy(p4_entries(rng, lanes, R)).to(cuda)
        got = _lane_counted(kq.lane_expand_p4, p4, P=P, shape=shape)
        assert torch.equal(got, kq.lane_expand_p4_plain(p4, P=P, shape=shape))


@pytest.mark.parametrize("offset", [0, 4, 8])
@pytest.mark.parametrize("case", list(K12_CASES))
def test_qoi_lane_expand_matches_plain_on_edge_cases(cuda, case, offset):
    """K12 on its edge cases (_torch_raster.K12_CASES: P from 1 to 32,767,
    windows, R = 1 and 2,100, int16 extremes, s >= e, empty and all-pad
    lanes, non-monotone p4 starts, lane counts no multiple of a CTA's),
    the p4 granules a view ``offset`` bytes past a 16-byte boundary; one
    launch a call."""
    from _torch_raster import k12_entries

    from zpix_tpu_torch.ops import qoi as kq

    P, wide, p4 = k12_entries(case)
    lanes = wide[0].shape[0]
    shape = (1, lanes, P)
    cols, s, e = (_dev(a, cuda) for a in wide)
    got = _lane_counted(kq.lane_expand_wide, cols, s, e, P=P, shape=shape)
    assert torch.equal(got, kq.lane_expand_wide_plain(cols, s, e, P=P, shape=shape))
    if p4 is not None:
        big = torch.zeros(p4.size + 64, dtype=torch.uint8, device=cuda)
        base = (-big.data_ptr()) % 16 + offset
        t = big[base : base + p4.size].view(p4.shape)
        t.copy_(torch.from_numpy(p4))
        assert t.data_ptr() % 16 == offset
        got = _lane_counted(kq.lane_expand_p4, t, P=P, shape=shape)
        assert torch.equal(got, kq.lane_expand_p4_plain(t, P=P, shape=shape))


@pytest.mark.parametrize("content", ["noise", "screen", "alpha"])
def test_qoi_lane_expand_matches_plain_on_smoke_content(cuda, content):
    """K12 on two 1024^2 images of chip_smoke.py's QOI content through the
    host lane passes at its lane widths: noise (p4, P = 16), screen (p4,
    lane_p 256, so P = 128) and alpha (wide, P = 16)."""
    from _torch_raster import bench_pixels, qoi_enc

    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel import qoi_batch as tq

    datas = [qoi_enc(bench_pixels(1024, 900 + j, content)) for j in range(2)]
    shape = (2, 1024, 1024)
    if content == "alpha":
        plan = tq.prep_qoi_lanes(datas, 16)
        cols, s, e = (_dev(a, cuda) for a in (plan.cols, plan.s, plan.e))
        got = _lane_counted(kq.lane_expand_wide, cols, s, e, P=plan.P, shape=shape)
        assert torch.equal(got, kq.lane_expand_wide_plain(cols, s, e, P=plan.P, shape=shape))
    else:
        plan = tq.prep_qoi_lanes4(datas, {"noise": 16, "screen": 256}[content])
        assert plan.P == {"noise": 16, "screen": 128}[content]
        t = torch.from_numpy(plan.p4).to(cuda)
        got = _lane_counted(kq.lane_expand_p4, t, P=plan.P, shape=shape)
        assert torch.equal(got, kq.lane_expand_p4_plain(t, P=plan.P, shape=shape))


@pytest.mark.parametrize("case", ["host", "short", "long"])
def test_qoi_sorted_expand_matches_plain(cuda, case):
    """K13 on host records (with a stream cut short) and on hand-built
    records with zero counts anywhere, totals short of and past the pixel
    count, and more than one 4096-count tile."""
    from _torch_raster import qoi_enc, qoi_images, record_entries

    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel import qoi_batch as tq

    if case == "host":
        datas = [qoi_enc(i) for i in qoi_images()]
        datas[3] = datas[3][: len(datas[3]) // 2] + b"\x00" * 8
        plan = tq.prep_qoi_records(datas)
        arrs, shape = (plan.cols, plan.cnts, plan.fill), (plan.batch, plan.height, plan.width)
    else:
        rng = np.random.default_rng(3)
        rcap, shape = (50, (4, 24, 40)) if case == "short" else (9000, (2, 420, 450))
        arrs = record_entries(rng, shape[0], rcap)
    cols, cnts, fill = (_dev(a, cuda) for a in arrs)
    before = runtime.LAUNCHES["qoi_sorted_expand"]
    got = kq.sorted_expand(cols, cnts, fill, shape=shape)
    assert runtime.LAUNCHES["qoi_sorted_expand"] == before + 2  # tile sums, expand
    assert torch.equal(got, kq.sorted_expand_plain(cols, cnts, fill, shape=shape))


def _k13_edge(case):
    """(cols, cnts, fill, shape) of one of K13's edge cases."""
    from _torch_raster import record_entries

    from zpix_tpu_torch.ops.qoi import REC_TILES

    tile = max(REC_TILES)
    rng = np.random.default_rng(len(case))
    if case == "counts_255":  # every count 255: the totals pass the pixel count
        cols, cnts, fill = record_entries(rng, 3, 100)
        return cols, np.full_like(cnts, 255), fill, (3, 60, 100)
    if case == "one_record":  # one record of 255 covers the whole image
        cols, cnts, fill = record_entries(rng, 3, 16)
        cnts[:] = 0
        cnts[:, 0] = 255
        return cols, cnts, fill, (3, 15, 17)
    if case == "past_total":
        cols, cnts, fill = record_entries(rng, 2, 5000)
        return cols, rng.integers(1, 256, cnts.shape).astype(np.uint8), fill, (2, 100, 100)
    if case == "zero_runs":  # zero runs longer than a tile; rcap not a multiple of it
        rcap = 3 * tile + 100
        cols, _, fill = record_entries(rng, 2, rcap)
        cnts = rng.integers(0, 8, (2, rcap)).astype(np.uint8)
        cnts[0, : tile + 7] = 0
        cnts[1, 3000 : 3000 + tile + 900] = 0
        cnts[:, -50:] = 0
        return cols, cnts, fill, (2, 200, 150)
    if case == "all_fill":  # image 1's records are all zero: all fill
        cols, cnts, fill = record_entries(rng, 3, 6000)
        cnts[1] = 0
        return cols, cnts, fill, (3, 90, 100)
    # "odd_sizes": rcap and the pixel count not multiples of 16 or 4 (word
    # loads and stores)
    cols, cnts, fill = record_entries(rng, 3, tile + 1)
    return cols, cnts, fill, (3, 33, 31)


@pytest.mark.parametrize("case", ["counts_255", "one_record", "past_total", "zero_runs",
                                  "all_fill", "odd_sizes", "unaligned"])
def test_qoi_sorted_expand_edges_match_plain(cuda, case):
    """K13 on its edges: counts of 255, one record a whole image, totals
    past the pixel count, zero runs longer than a tile, rcap not a multiple
    of the tile, an image all fill, odd sizes, and records whose rows are
    not 16-byte aligned (a view 4 bytes into its storage)."""
    from zpix_tpu_torch.ops import qoi as kq

    cols, cnts, fill, shape = _k13_edge("zero_runs" if case == "unaligned" else case)
    cols, cnts, fill = (_dev(a, cuda) for a in (cols, cnts, fill))
    if case == "unaligned":
        c4 = torch.empty(cols.numel() + 1, dtype=torch.int32, device=cuda)
        n4 = torch.empty(cnts.numel() + 4, dtype=torch.uint8, device=cuda)
        c4[1:].copy_(cols.view(-1))
        n4[4:].copy_(cnts.view(-1))
        cols, cnts = c4[1:].view(cols.shape), n4[4:].view(cnts.shape)
        assert cols.data_ptr() % 16 and cnts.data_ptr() % 16
    before = runtime.LAUNCHES["qoi_sorted_expand"]
    got = kq.sorted_expand(cols, cnts, fill, shape=shape)
    assert runtime.LAUNCHES["qoi_sorted_expand"] == before + 2
    assert torch.equal(got, kq.sorted_expand_plain(cols, cnts, fill, shape=shape))


@pytest.mark.parametrize("tile", [1024, 2048, 4096])
@pytest.mark.parametrize("case", ["zero_runs", "all_fill", "odd_sizes"])
def test_qoi_sorted_expand_every_tile_matches_plain(cuda, case, tile, monkeypatch):
    """K13 at each record tile it takes (rec_tile chooses among them)."""
    from zpix_tpu_torch.ops import qoi as kq

    monkeypatch.setattr(kq, "rec_tile", lambda rcap, npx: tile)
    cols, cnts, fill, shape = _k13_edge(case)
    cols, cnts, fill = (_dev(a, cuda) for a in (cols, cnts, fill))
    got = kq.sorted_expand(cols, cnts, fill, shape=shape)
    assert torch.equal(got, kq.sorted_expand_plain(cols, cnts, fill, shape=shape))


def test_qoi_sorted_expand_grid_beyond_resident(cuda):
    """K13 on 64 images of 1024^2 with about one record a pixel: 16,384
    record tiles and 1,024 fill tiles, far more than the card holds at
    once."""
    from zpix_tpu_torch.ops import qoi as kq

    g = torch.Generator(device=cuda).manual_seed(5)
    B, n = 64, 1 << 20
    cnts = torch.randint(0, 3, (B, n), generator=g, device=cuda, dtype=torch.uint8)
    cnts[5, n // 2 :] = 0  # a short image: half fill
    cols = torch.randint(-2**31, 2**31 - 1, (B, n), generator=g, device=cuda, dtype=torch.int32)
    fill = torch.randint(-2**31, 2**31 - 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    shape = (B, 1024, 1024)
    got = kq.sorted_expand(cols, cnts, fill, shape=shape)
    assert torch.equal(got, kq.sorted_expand_plain(cols, cnts, fill, shape=shape))


def test_qoi_encode_matches_plain_and_host(cuda):
    """K14 on every encode case: its bytes and totals equal its plain
    version's, and each stream equals the host encoder's."""
    from _torch_raster import encode_cases

    from zpix_tpu_torch import encode_device
    from zpix_tpu_torch.codecs.qoi.encode import Desc, encode
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px

    for i, (img, ch) in enumerate(encode_cases()):
        h, w = img.shape[:2]
        d = Desc(w, h, ch, 0)
        px = torch.stack([_pack_px(img, d, cuda), _pack_px(img[::-1].copy(), d, cuda)])
        before = runtime.LAUNCHES["qoi_encode"]
        out, tot = kq.encode(px)
        assert runtime.LAUNCHES["qoi_encode"] == before + 1  # one pass (and a memset)
        out_p, tot_p = kq.encode_plain(px)
        assert torch.equal(tot, tot_p) and torch.equal(out, out_p), i
        assert encode_device(img, d) == encode(img, d), i


def _k14_against_plain_and_host(cuda, imgs):
    """K14 on RGBA [B, h, w, 4]: its bytes and totals equal encode_plain's,
    and each image's ops the host encoder's (its stream less the 14-byte
    header and the 8-byte padding)."""
    from zpix_tpu_torch.codecs.qoi.encode import Desc, encode
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px

    h, w = imgs.shape[1:3]
    d = Desc(w, h, 4, 0)
    px = torch.stack([_pack_px(torch.from_numpy(im).to(cuda), d, cuda) for im in imgs])
    out, tot = kq.encode(px)
    out_p, tot_p = kq.encode_plain(px)
    assert torch.equal(tot, tot_p) and torch.equal(out, out_p)
    out, tot = out.cpu().numpy(), tot.cpu().numpy()
    for i, im in enumerate(imgs):
        assert out[i, : tot[i]].tobytes() == encode(im, d)[14:-8], i


@pytest.mark.parametrize("shape", [(3, 1, 1), (3, 1, 31), (3, 1, 1025), (3, 1, 2049),
                                   (2, 1024, 1024)],
                         ids=["n1", "n31", "n1025", "n2049", "n1024sq"])
def test_qoi_encode_sizes_match_plain_and_host(cuda, shape):
    """K14 at n = 1, 31, 1,025, 2,049 (a second tile of one pixel) and
    1,024^2: structured content with runs of 1-130 pixels, one of them a
    flat image."""
    from _torch_raster import structured_pixels

    B, h, w = shape
    rng = np.random.default_rng(h * w)
    imgs = np.stack([structured_pixels(rng, h, w) for _ in range(B - 1)]
                    + [np.full((h, w, 4), 200, np.uint8)])
    _k14_against_plain_and_host(cuda, imgs)


@pytest.mark.parametrize("content", ["one_colour", "long_runs", "screen", "noise"])
def test_qoi_encode_content_matches_plain_and_host(cuda, content):
    """K14 on 4 x 1024^2: one colour a image (a run over every tile; the
    first a colour equal to the initial previous pixel), runs of 1-5,000
    pixels across tiles, and the bench's screen and noise content."""
    from _torch_raster import bench_pixels

    rng = np.random.default_rng(11)
    if content == "one_colour":
        imgs = np.zeros((4, 1024, 1024, 4), np.uint8)
        imgs[0, ..., 3] = 255
        imgs[1:] = rng.integers(0, 256, (3, 1, 1, 4), dtype=np.uint8)
    elif content == "long_runs":
        n = 1024 * 1024
        cuts = np.sort(rng.choice(np.arange(1, n), 600, replace=False))
        lengths = np.diff(np.concatenate([[0], cuts, [n]]))
        cols = rng.integers(0, 2**32, (4, lengths.size), dtype=np.uint64).astype(np.uint32)
        px = np.repeat(cols, lengths, axis=1)
        imgs = np.stack([(px >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.uint8)
        imgs = imgs.reshape(4, 1024, 1024, 4)
    else:
        imgs = np.stack([bench_pixels(1024, s, content) for s in range(4)])
    _k14_against_plain_and_host(cuda, imgs)


def test_qoi_encode_grid_beyond_resident(cuda):
    """K14 on 64 x 1024^2 (32,768 tiles, more blocks than the card holds at
    once): tiles are taken by ticket, so every look-back waits on a tile
    already running, and the streams still equal the plain version's and
    the host encoder's."""
    from _torch_raster import bench_pixels

    imgs = np.stack([bench_pixels(1024, s, "screen" if s % 2 else "noise") for s in range(64)])
    _k14_against_plain_and_host(cuda, imgs)


def test_qoi_decoder_and_batch_encode_match_cpu_run(cuda):
    """HostIndexQoiDecoder by every route, and encode_device_batch, on the
    card against the same calls on the CPU."""
    from _torch_raster import qoi_enc, qoi_images

    from zpix_tpu_torch import HostIndexQoiDecoder, encode_device_batch
    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels
    from zpix_tpu_torch.codecs.qoi.encode import Desc

    imgs = qoi_images()
    datas = [qoi_enc(i) for i in imgs]
    want = np.stack([decode_pixels(d) for d in datas])
    for impl, fmt, kernel, n in (("lane", "auto", "qoi_lane_expand", 1),
                                 ("lane", "wide", "qoi_lane_expand", 1),
                                 ("sorted", "auto", "qoi_sorted_expand", 2)):
        runtime.reset_launches()
        got = HostIndexQoiDecoder(impl=impl, lane_fmt=fmt).decode(datas)
        assert runtime.LAUNCHES[kernel] == n and got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), want), (impl, fmt)
    h, w = imgs[0].shape[:2]
    descs = [Desc(w, h, 4, 0)] * len(imgs)
    assert encode_device_batch(np.stack(imgs), descs) == datas
    assert encode_device_batch(torch.from_numpy(np.stack(imgs)).to(cuda), descs) == datas


BMP_SIZES = [(7, 13), (64, 37), (5, 1), (5, 3), (5, 4), (5, 5), (5, 17), (4, 1024)]


@pytest.mark.parametrize("size", BMP_SIZES, ids=[f"{h}x{w}" for h, w in BMP_SIZES])
def test_bmp_unpack_matches_plain(cuda, size):
    """K18 on every arm (bpp, header, orientation, short palette) through
    BatchBmpDecoder, against its plain version on the card; widths 1, 3, 4,
    5 and 17 end a row on every size of the kernel's last 4-pixel group."""
    from _torch_raster import bmp_arms, bmp_batch

    from zpix_tpu_torch import BatchBmpDecoder
    from zpix_tpu_torch.ops.bmp import bmp_unpack_plain

    dec = BatchBmpDecoder()
    for arm in bmp_arms():
        datas = bmp_batch(arm, *size)
        rows, pal, (width, _h, top_down, bpp, allow_alpha) = dec.prep(datas)
        before = runtime.LAUNCHES["bmp_unpack"]
        got = dec.decode(datas)
        assert runtime.LAUNCHES["bmp_unpack"] == before + 1
        want = bmp_unpack_plain(torch.from_numpy(rows).to(cuda), torch.from_numpy(pal).to(cuda),
                                bpp=bpp, width=width, top_down=top_down,
                                allow_alpha=allow_alpha)
        assert torch.equal(got, want), arm


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("bpp", [1, 2, 4, 8, 24, 32])
def test_bmp_unpack_rows_off_16_bytes(cuda, bpp, offset):
    """K18 on rows whose data_ptr lies 0, 4, 8 or 12 bytes past a 16-byte
    boundary (views into a wider buffer), at a width of 1,024 and 5, both
    orientations, against its plain version."""
    from zpix_tpu_torch.codecs.bmp.decode import row_bytes
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    gen = torch.Generator(device=cuda).manual_seed(bpp * 16 + offset)
    pal = torch.randint(0, 256, (3, 256, 4), generator=gen, dtype=torch.uint8, device=cuda)
    for width in (1024, 5):
        rb = row_bytes(width, bpp)
        buf = torch.randint(0, 256, (3 * 6 * rb + 32,), generator=gen, dtype=torch.uint8,
                            device=cuda)
        base = (-buf.data_ptr()) % 16
        rows = buf[base + offset : base + offset + 3 * 6 * rb].view(3, 6, rb)
        assert rows.data_ptr() % 16 == offset
        for td in (False, True):
            kw = dict(bpp=bpp, width=width, top_down=td, allow_alpha=bpp == 32)
            got = _counted("bmp_unpack", 1, bmp_unpack, rows, pal, **kw)
            assert torch.equal(got, bmp_unpack_plain(rows, pal, **kw)), (width, td)


@pytest.mark.parametrize("bpp", [1, 2, 4, 8, 24, 32])
def test_bmp_unpack_past_the_grid_limit(cuda, bpp):
    """70,000 images of 1 x 1, past the 65,535 CTAs of a grid's y: every
    image through the kernel's image loop, against the plain version."""
    from zpix_tpu_torch.codecs.bmp.decode import row_bytes
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    gen = torch.Generator(device=cuda).manual_seed(bpp)
    B = 70_000
    rows = torch.randint(0, 256, (B, 1, row_bytes(1, bpp)), generator=gen, dtype=torch.uint8,
                         device=cuda)
    pal = torch.randint(0, 256, (B, 256, 4), generator=gen, dtype=torch.uint8, device=cuda)
    kw = dict(bpp=bpp, width=1, top_down=False, allow_alpha=bpp == 32)
    got = _counted("bmp_unpack", 1, bmp_unpack, rows, pal, **kw)
    assert torch.equal(got, bmp_unpack_plain(rows, pal, **kw))


# ------------------------------------------------------ PNG slice (K15-K17)

PNG_DEPTHS = ("g1", "g2", "g4", "g8", "g16", "tc8", "tc16", "tca8", "tca16", "ga8", "ga16",
              "p1", "p2", "p4", "p8")
PNG_KEYED = ("g1", "g2", "g4", "g8", "g16", "tc8", "tc16")  # depths a tRNS key applies to
PNG_FRONTS = {"host": {}, "defilter": {"device_defilter": True},
              "inflate": {"device_inflate": True}}


def _counted(kernel, n, fn, *args, **kw):
    before = runtime.LAUNCHES[kernel]
    out = fn(*args, **kw)
    assert runtime.LAUNCHES[kernel] == before + n
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("H,W", [(1, 40), (40, 1), (9, 70), (70, 9), (1500, 3), (31, 13),
                                 (32, 13), (33, 13), (1025, 5)], ids=lambda v: str(v))
def test_png_defilter_matches_plain(cuda, bpp, H, W):
    """K15 on random rows with random filter bytes 0-255, contiguous and
    read in place from a filtered stream [B, H, 1 + Wb] (every row start
    alignment), at the band boundaries (31, 32, 33 rows) and past a block
    of the default bands (1,025, 1,500 rows); the flag of types above 4 as
    well."""
    from zpix_tpu_torch.ops.defilter import png_defilter, png_defilter_plain

    rng = np.random.default_rng(bpp * 1000 + H)
    stream = torch.from_numpy(rng.integers(0, 256, (3, H, 1 + W * bpp), dtype=np.uint8)).to(cuda)
    stream[1, :, 0] %= 5  # image 1: valid types only
    for raw, ft in ((stream[:, :, 1:].contiguous(), stream[:, :, 0].contiguous()),
                    (stream[:, :, 1:], stream[:, :, 0])):
        bad_k = torch.zeros(1, dtype=torch.int32, device=cuda)
        bad_p = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = _counted("png_defilter", 1, png_defilter, raw, ft, bpp=bpp, bad=bad_k)
        assert torch.equal(got, png_defilter_plain(raw, ft, bpp=bpp, bad=bad_p))
        assert torch.equal(bad_k, bad_p)
    good = stream[1:2]
    bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    png_defilter(good[:, :, 1:], good[:, :, 0], bpp=bpp, bad=bad)
    assert int(bad) == 0


@pytest.mark.parametrize("B,H", [(2, 1337), (32, 16384)])
@pytest.mark.parametrize("bpp", [1, 3, 8])
def test_png_defilter_bands_across_blocks(cuda, bpp, B, H):
    """K15's bands hand their last row on within a block (shared ring)
    and between blocks (a whole row in global memory), on rows longer than
    the shared ring (32 pixels): 42 bands in 11 blocks an image, and a grid
    of 4,096 blocks of 128 threads, more than 132 SMs hold at once (16
    blocks an SM at most), so that blocks wait on blocks that started
    before them while later ones cannot start."""
    from zpix_tpu_torch.ops.defilter import png_defilter, png_defilter_plain

    rng = np.random.default_rng(H * 10 + bpp)
    W = 301
    stream = torch.from_numpy(rng.integers(0, 256, (B, H, 1 + W * bpp), dtype=np.uint8)).to(cuda)
    stream[:, :, 0] %= 5
    raw, ft = stream[:, :, 1:], stream[:, :, 0]
    got = _counted("png_defilter", 1, png_defilter, raw, ft, bpp=bpp)
    assert torch.equal(got, png_defilter_plain(raw, ft, bpp=bpp))


@pytest.mark.parametrize("case", ["stored", "fixed", "rle", "default", "hand"])
def test_inflate_resolve_matches_plain(cuda, case):
    """K16 on the tokenizer's output for the four deflate modes (rows read
    through a wider stride, as the decoder's staging layout has them) and
    on hand-built chains: 258-byte distance-1 runs over a whole image,
    overlapping copies, distance 32,768, zero-length padding."""
    from _torch_png import encode_png, hand_tokens, random_pixels, stack_tokens

    from zpix_tpu_torch.ops.inflate import inflate_resolve, inflate_resolve_plain
    from zpix_tpu_torch.parallel.png_batch import parse_tokens

    rng = np.random.default_rng(5)
    if case == "hand":
        per = 70_000
        toks = [hand_tokens(rng, per, k) for k in ("rle", "overlap", "far")]
    else:
        pix = [random_pixels(rng, "tc8", 61, 47, hi=4) for _ in range(2)]
        files = [encode_png(p, "tc8", strategy=case, seed=i) for i, p in enumerate(pix)]
        toks = [parse_tokens(f)[1:] for f in files]
        per = 47 * (1 + 61 * 3)
    lens, dists, lits = (torch.from_numpy(a).to(cuda) for a in stack_tokens(toks))
    nt = max(len(t[0]) for t in toks)
    views = [a[:, : nt + 2] for a in (lens, dists, lits)]  # strided rows
    got = _counted("inflate_resolve", 2, inflate_resolve, *views, per)
    assert torch.equal(got, inflate_resolve_plain(*views, per)[0])
    assert torch.equal(got, inflate_resolve(lens, dists, lits, per))


@pytest.mark.parametrize("off", [-1, 0, 1, 40_001])
@pytest.mark.parametrize("tile", [8192, 16384, 32768])
def test_inflate_resolve_tiles_match_plain(cuda, tile, off):
    """K16 at per = T - 1, T, T + 1 and several tiles: distance-32,768
    copies that start on a tile's first byte, copies straddling tile
    boundaries, images with different token counts in one batch, and the
    "rle" image, whose every byte past the first tile has its root (byte
    0) in an earlier tile."""
    from _torch_png import hand_tokens, stack_tokens

    from zpix_tpu_torch.ops.inflate import inflate_resolve, inflate_resolve_plain

    rng = np.random.default_rng(tile + off)
    per = tile + off
    toks = [hand_tokens(rng, per, k) for k in ("far_edge", "rle", "overlap", "far")]
    lens, dists, lits = (torch.from_numpy(a).to(cuda) for a in stack_tokens(toks))
    got = _counted("inflate_resolve", 2, inflate_resolve, lens, dists, lits, per, tile=tile)
    assert torch.equal(got, inflate_resolve_plain(lens, dists, lits, per)[0])


@pytest.mark.parametrize("cd", PNG_DEPTHS)
def test_png_expand_matches_plain(cuda, cd):
    """K17 on every arm, with and without a tRNS key (keyed and unkeyed
    images in one batch), a short palette, widths that are not a multiple
    of the pixels a byte, and placed on an Adam7 canvas."""
    from _torch_png import first_pixel_keys

    from zpix_tpu_torch.ops.png import png_expand, png_expand_plain, row_bytes

    rng = np.random.default_rng(len(cd))
    for w, h in ((13, 5), (64, 9)):
        rows = torch.from_numpy(rng.integers(0, 256, (3, h, row_bytes(cd, w)),
                                             dtype=np.uint8)).to(cuda)
        pal = torch.from_numpy(rng.integers(0, 256, (3, 256, 4), dtype=np.uint8)).to(cuda)
        keys = [None]
        if cd in PNG_KEYED:
            keys.append(torch.from_numpy(first_pixel_keys(rows.cpu().numpy(), cd)).to(cuda))
        for key in keys:
            got = _counted("png_expand", 1, png_expand, rows, pal, key, cd=cd, width=w)
            assert torch.equal(got, png_expand_plain(rows, pal, key, cd=cd, width=w))
            canvas = torch.zeros(3, 2 * h + 1, 8 * w, 4, dtype=torch.uint8, device=cuda)
            want = png_expand_plain(rows, pal, key, cd=cd, width=w, out=canvas.clone(),
                                    place=(4, 1, 8, 2))
            png_expand(rows, pal, key, cd=cd, width=w, out=canvas, place=(4, 1, 8, 2))
            assert torch.equal(canvas, want)


@pytest.mark.parametrize("cd", PNG_DEPTHS)
def test_png_expand_matches_plain_at_group_tails_and_offsets(cuda, cd):
    """K17 on every arm at widths 1, 3, 4, 5, 17 and 1,024 (the tails of
    a thread's 4-pixel group, and the main width), rows a view 0, 1, 4 or
    8 bytes past a 16-byte boundary of a larger buffer, keys that hit,
    whole images and a placement with xf = 1 off the canvas's 4-pixel
    grid."""
    from _torch_png import first_pixel_keys

    from zpix_tpu_torch.ops.png import png_expand, png_expand_plain, row_bytes

    rng = np.random.default_rng(100 + len(cd))
    pal = torch.from_numpy(rng.integers(0, 256, (2, 256, 4), dtype=np.uint8)).to(cuda)
    for w in (1, 3, 4, 5, 17, 1024):
        h = 6
        rb = row_bytes(cd, w)
        big = torch.from_numpy(rng.integers(0, 256, 2 * h * rb + 64, dtype=np.uint8)).to(cuda)
        for offset in (0, 1, 4, 8):
            base = (-big.data_ptr()) % 16 + offset
            rows = big[base : base + 2 * h * rb].view(2, h, rb)
            keys = [None]
            if cd in PNG_KEYED:
                keys.append(torch.from_numpy(first_pixel_keys(rows.cpu().numpy(), cd)).to(cuda))
            for key in keys:
                got = _counted("png_expand", 1, png_expand, rows, pal, key, cd=cd, width=w)
                assert torch.equal(got, png_expand_plain(rows, pal, key, cd=cd, width=w)), (
                    w, offset, key is not None)
                canvas = torch.zeros(2, h + 1, w + 3, 4, dtype=torch.uint8, device=cuda)
                want = png_expand_plain(rows, pal, key, cd=cd, width=w, out=canvas.clone(),
                                        place=(3, 1, 1, 1))
                png_expand(rows, pal, key, cd=cd, width=w, out=canvas, place=(3, 1, 1, 1))
                assert torch.equal(canvas, want), (w, offset, key is not None)


@pytest.mark.parametrize("cd", ["g1", "g16", "tc8", "tca16", "ga8", "p4", "p8"])
def test_png_expand_adam7_passes_into_one_canvas(cuda, cd):
    """K17 a pass of Adam7, the seven placements of a 37 x 29 and of a
    64 x 64 image into one canvas, against the plain version's canvas;
    every pixel written (the two canvases start apart)."""
    from zpix_tpu_torch.codecs.png.decode import INTERLACING, _pass_dims
    from zpix_tpu_torch.ops.png import png_expand, png_expand_plain, row_bytes

    rng = np.random.default_rng(7 + len(cd))
    pal = torch.from_numpy(rng.integers(0, 256, (3, 256, 4), dtype=np.uint8)).to(cuda)
    for W, H in ((37, 29), (64, 64)):
        canvas = torch.full((3, H, W, 4), 0x5A, dtype=torch.uint8, device=cuda)
        want = torch.full_like(canvas, 0xA5)
        for p in range(7):
            pw, ph = _pass_dims(W, H, p)
            if not pw or not ph:
                continue
            rows = torch.from_numpy(rng.integers(0, 256, (3, ph, row_bytes(cd, pw)),
                                                 dtype=np.uint8)).to(cuda)
            _counted("png_expand", 1, png_expand, rows, pal, None, cd=cd, width=pw, out=canvas,
                     place=INTERLACING[p])
            png_expand_plain(rows, pal, None, cd=cd, width=pw, out=want, place=INTERLACING[p])
        assert torch.equal(canvas, want), (W, H)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("cd", PNG_DEPTHS)
def test_png_routes_match_cpu_run(cuda, cd, interlace):
    """BatchPngDecoder by each front-end on the card against the same
    call on the CPU, keyed images and short palettes included, and the
    kernels each route launches."""
    from _torch_png import png_batch

    from zpix_tpu_torch import BatchPngDecoder

    datas, _ = png_batch(cd, 21, 11, batch=3, seed=3, interlace=interlace,
                         trns=cd in PNG_KEYED or cd.startswith("p"), short=cd.startswith("p"))
    passes = 7 if interlace else 1
    for front, kw in PNG_FRONTS.items():
        want = BatchPngDecoder(device="cpu", **kw).decode(datas)
        runtime.reset_launches()
        got = BatchPngDecoder(**kw).decode(datas)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want), front
        on_card = front != "host" or interlace
        assert runtime.LAUNCHES["png_defilter"] == (passes if on_card else 0), front
        assert runtime.LAUNCHES["png_expand"] == passes, front
        assert (runtime.LAUNCHES["inflate_resolve"] > 0) == (front == "inflate"), front
        assert runtime.LAUNCHES["adler32"] == (front == "inflate"), front


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_png_damaged_streams_raise_as_on_cpu(cuda, interlace):
    """The damaged streams (a wrong adler32 trailer among them) raise the
    same error by every route on the card as on the CPU."""
    from _torch_png import DAMAGE, encode_png, random_pixels

    from zpix_tpu_torch import BatchPngDecoder

    pix = random_pixels(np.random.default_rng(1), "tc8", 16, 8)
    good = encode_png(pix, "tc8", interlace=interlace)
    for damage in DAMAGE:
        bad = encode_png(pix, "tc8", interlace=interlace, filters=[0], damage=damage)
        for front, kw in PNG_FRONTS.items():
            with pytest.raises(Exception) as want:
                BatchPngDecoder(device="cpu", **kw).decode([good, bad])
            with pytest.raises(type(want.value)) as got:
                BatchPngDecoder(**kw).decode([good, bad])
            assert str(got.value) == str(want.value), (damage, front)


ADLER_GPU_PERS = [0, 1, 17, 4096, 65535, 65537, 4 * 65536, 3 * 1024 * 1024 + 7]


@pytest.mark.parametrize("per", ADLER_GPU_PERS)
def test_adler32_kernel_matches_plain(cuda, per):
    """The trailer check on rows of every alignment (odd row lengths move
    each image's start off the 16-byte boundary), runs of 0xFF included,
    at no bytes, a span (``ADLER_SPAN``, 65,536) less or more one byte and
    a multiple of it: the sums, and the flag on a matching and a wrong
    trailer (the last image's)."""
    from zpix_tpu_torch.ops.inflate import ADLER_BAD, adler32_check, adler32_plain

    rng = np.random.default_rng(per % 1000)
    rows = torch.from_numpy(rng.integers(0, 256, (3, per), dtype=np.uint8))
    rows[1] = 0xFF
    want = adler32_plain(rows, torch.zeros(3, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = _counted("adler32", 1, adler32_check, rows.to(cuda), want.to(cuda), bad)
    assert torch.equal(got.cpu(), want) and int(bad) == 0
    off = want.clone()
    off[2] ^= 1 << 20
    adler32_check(rows.to(cuda), off.to(cuda), bad)
    assert int(bad) == ADLER_BAD


@pytest.mark.parametrize("span", [16, 4096, 1 << 17, 1 << 20])
def test_adler32_kernel_every_span(cuda, span, monkeypatch):
    """The check at other spans than the default (the sweep's), on 5
    images of 2.5 spans and 3 bytes, all-0xFF ones among them."""
    from zpix_tpu_torch.ops import inflate as ki

    monkeypatch.setattr(ki, "ADLER_SPAN", span)
    rng = np.random.default_rng(span)
    rows = torch.from_numpy(rng.integers(0, 256, (5, span * 5 // 2 + 3), dtype=np.uint8))
    rows[1::2] = 0xFF
    z = torch.zeros(1, dtype=torch.int32)
    want = ki.adler32_plain(rows, torch.zeros(5, dtype=torch.int32), z)
    bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = _counted("adler32", 1, ki.adler32_check, rows.to(cuda), want.to(cuda), bad)
    assert torch.equal(got.cpu(), want) and int(bad) == 0


def test_adler32_kernel_past_the_grid_limit(cuda):
    """70,000 one-byte images (more CTAs than a grid's y could hold): every
    sum, the flag clear, then set by a wrong trailer in the last image
    only."""
    from zpix_tpu_torch.ops.inflate import ADLER_BAD, adler32_check, adler32_plain

    rng = np.random.default_rng(70)
    rows = torch.from_numpy(rng.integers(0, 256, (70_000, 1), dtype=np.uint8))
    want = adler32_plain(rows, torch.zeros(70_000, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = _counted("adler32", 1, adler32_check, rows.to(cuda), want.to(cuda), bad)
    assert torch.equal(got.cpu(), want) and int(bad) == 0
    off = want.clone()
    off[-1] ^= 1
    adler32_check(rows.to(cuda), off.to(cuda), bad)
    assert int(bad) == ADLER_BAD


# ------------------------------------------------------- K19, the chunk sync


def _sync_batches():
    """Restart-free batches of every sampling the sync route covers, as
    (name, datas, chunk_bytes, sync_bytes)."""
    from _torch_jpeg import synth_cmyk, synth_plain_jpeg, synth_ratio_jpeg, synth_rgb

    def two(mode, w=96, h=72):
        return [synth_plain_jpeg(w=w, h=h, mode=mode, phase=p) for p in (0.0, 0.3)]

    return [("gray_bpm1", two("gray"), 32, None), ("444_bpm3", two("444"), 32, None),
            ("422_bpm4", two("422"), 32, None), ("420_bpm6", two("420"), 32, None),
            ("420_chunk256", two("420", 160, 120), 256, None),
            ("420_links_on_chunks", two("420"), 32, 32),
            ("411_bpm6", [synth_ratio_jpeg(((4, 1), (1, 1), (1, 1)), 64, 32, s) for s in (0, 1)],
             32, None),
            ("cmyk_bpm4", [synth_cmyk(None, 48, 32, s, dri_blocks=None) for s in (0, 1)], 32, None),
            ("rgb_bpm3", [synth_rgb(48, 32, s, dri_blocks=None) for s in (0, 1)], 32, None),
            ("420_sync512", two("420", 160, 120), 32, 512),
            ("one_sync_chunk", two("420", 8, 8), 32, None)]


def _sync_against_plain(cuda, datas, cb, sb):
    """K19 on the card and its plain version on the CPU -> (ends, ok,
    entries, misses) of each, the plan."""
    from zpix_tpu_torch import SyncJpegDecoder, prep_batch_sync
    from zpix_tpu_torch.ops import sync as ksync

    plan = prep_batch_sync(datas, cb)
    kw = dict(chunk_bytes=cb, n_chunks=plan.n_chunks, bpm=plan.bpm,
              nblk=plan.n_mcu * plan.bpm, sync_bytes=sb)
    b = SyncJpegDecoder(chunk_bytes=cb).upload(plan)
    got = ksync.sync_ends(b[0], b[1], b[4], b[3], **kw)
    bc = [x.cpu() for x in b]
    return got, ksync.sync_ends_plain(bc[0], bc[1], bc[4], bc[3], **kw), plan


@pytest.mark.parametrize("case", range(11))
def test_sync_kernel_matches_plain(cuda, case):
    """K19 against its plain version: ends, ok, the entries and the link
    misses, exactly, on bpm 1, 3, 4 and 6, 256-byte chunks, links on the
    32-byte chunks themselves (many misses) and on 512-byte sync chunks,
    and an image of one sync chunk; the launches counted."""
    from zpix_tpu_torch.ops import sync as ksync

    name, datas, cb, sb = _sync_batches()[case]
    before = runtime.LAUNCHES["sync_decode"]
    (ends, ok, entries, misses), (pe, pok, pent, pmisses), plan = _sync_against_plain(
        cuda, datas, cb, sb)
    # guesses and links, resolve, refine and record, assembly
    assert runtime.LAUNCHES["sync_decode"] - before == 4, name
    assert bool(ok) and bool(pok), name
    assert torch.equal(ends.cpu(), pe) and torch.equal(entries.cpu(), pent), name
    assert int(misses) == pmisses, name
    if name == "one_sync_chunk":
        assert -(-plan.n_chunks // ksync.sync_factor(cb, sb)) == 1
    if name == "420_bpm6":
        assert plan.n_chunks % ksync.sync_factor(cb, sb), "n_chunks a multiple of m"


@pytest.mark.parametrize("case", [3, 4, 5])
def test_sync_resolve_in_global_memory(cuda, case, monkeypatch):
    """With no shared memory for the links, the resolve walks them in
    global memory: the same ends, ok, entries and misses as the plain
    version (links on chunks: misses on the walk in global memory)."""
    from zpix_tpu_torch.ops import sync as ksync

    monkeypatch.setattr(ksync, "LINK_SMEM_BYTES", 0)
    name, datas, cb, sb = _sync_batches()[case]
    (ends, ok, entries, misses), (pe, pok, pent, pmisses), _plan = _sync_against_plain(
        cuda, datas, cb, sb)
    assert bool(ok) and bool(pok), name
    assert torch.equal(ends.cpu(), pe) and torch.equal(entries.cpu(), pent), name
    assert int(misses) == pmisses, name


@pytest.mark.parametrize("seed", range(4))
def test_sync_kernel_matches_plain_on_corrupt_streams(cuda, seed):
    """Random damage to the destuffed streams: K19 agrees with its plain
    version on ends, ok and entries, not only on valid data."""
    from zpix_tpu_torch import SyncJpegDecoder, prep_batch_sync
    from zpix_tpu_torch.ops import sync as ksync

    _name, datas, cb, sb = _sync_batches()[3]
    plan = prep_batch_sync(datas, cb)
    rng = np.random.default_rng(seed)
    plan.stream = plan.stream.copy()
    at = rng.integers(0, int(plan.img_bit_end.max()) // 8, 12)
    plan.stream[at] = rng.integers(0, 256, 12, dtype=np.uint8)
    kw = dict(chunk_bytes=cb, n_chunks=plan.n_chunks, bpm=plan.bpm,
              nblk=plan.n_mcu * plan.bpm, sync_bytes=sb)
    b = SyncJpegDecoder().upload(plan)
    ends, ok, entries, misses = ksync.sync_ends(b[0], b[1], b[4], b[3], **kw)
    bc = [x.cpu() for x in b]
    pe, pok, pent, pmisses = ksync.sync_ends_plain(bc[0], bc[1], bc[4], bc[3], **kw)
    assert torch.equal(ends.cpu(), pe) and torch.equal(ok.cpu(), pok)
    assert torch.equal(entries.cpu(), pent) and int(misses) == pmisses


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 7, 8])
def test_sync_decoder_matches_host_index(cuda, case):
    """SyncJpegDecoder on the card: the pixels of HostIndexJpegDecoder
    (interleaved) and of its own run on the CPU, ok True, and the kernels
    of its path (K19, K2, K3, K4; no K1)."""
    from zpix_tpu_torch import HostIndexJpegDecoder, SyncJpegDecoder

    _name, datas, cb, _sb = _sync_batches()[case]
    want, want_ok = HostIndexJpegDecoder(planar=False).decode(datas)
    runtime.reset_launches()
    got, ok = SyncJpegDecoder(chunk_bytes=cb).decode(datas)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    cpu, cpu_ok = SyncJpegDecoder(chunk_bytes=cb, device="cpu").decode(datas)
    assert bool(ok) and bool(want_ok) and bool(cpu_ok)
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    assert launches["index_pass"] == 0 and launches["sync_decode"] > 0
    assert launches["value_pass"] == launches["dc_restore"] == launches["backend"] == 1


def test_sync_decoder_flags_damaged_streams(cuda):
    """Invalid codes, a cut scan and flipped bytes: ok False on the card as
    on the CPU (or the same refusal in prep)."""
    from _torch_jpeg import synth_plain_jpeg, truncate_scan

    from zpix_tpu_torch import SyncJpegDecoder

    good = [synth_plain_jpeg(w=160, h=120, mode="420", phase=p) for p in (0.0, 0.3)]
    sos = good[0].find(b"\xff\xda")
    mid = (sos + len(good[0])) // 2
    inject = bytearray(good[0])
    inject[mid : mid + 8] = b"\xff\x00" * 4
    flipped = bytearray(good[0])
    for i in range(len(flipped) - 300, len(flipped) - 260):
        flipped[i] ^= 0x55
    for bad in (bytes(inject), truncate_scan(good[0], 10), bytes(flipped)):
        outcome = []
        for dec in (SyncJpegDecoder(), SyncJpegDecoder(device="cpu")):
            try:
                outcome.append(bool(dec.decode([bad, good[1]])[1]))
            except Exception as exc:  # noqa: BLE001 -- a refusal, compared below
                outcome.append(type(exc).__name__)
        assert outcome[0] == outcome[1] and outcome[0] is not True


# ------------------------------------------------- K11 (DC refine), PR design


def _k11_cases():
    from _torch_prog import K11_CASES

    return [(c, None) for c in K11_CASES] + [("420", al) for al in (0, 6, 13)]


@pytest.mark.parametrize("case,al", _k11_cases(), ids=lambda x: str(x))
def test_dc_refine_kernel_matches_plain(cuda, case, al):
    """K11 on every interleaved sampling, single-component scans with
    partial MCUs, all and no bits set, rows wider than their bits, Al 0
    to 13, rows at an odd address: one launch, the store equal to the
    plain version's, twice in a row."""
    from _torch_prog import k11_case

    from zpix_tpu_torch.ops import progressive as kp

    rows, grids, hv, valid, al = k11_case(case, 11, mxx=67, myy=41, batch=4, al=al)
    want = [torch.from_numpy(g.copy()) for g in grids]
    kp.dc_refine_plain(torch.from_numpy(rows), want, hv=hv, valid=valid, al=al)
    flat = torch.zeros(rows.size + 1, dtype=torch.uint8, device=cuda)
    rows_d = flat[1:].view(rows.shape)
    rows_d.copy_(torch.from_numpy(rows))
    for _ in range(2):
        got = [torch.from_numpy(g).to(cuda) for g in grids]
        before = runtime.LAUNCHES["dc_refine"]
        kp.dc_refine(rows_d, got, hv=hv, valid=valid, al=al)
        assert runtime.LAUNCHES["dc_refine"] == before + 1
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


# ------------------------------------------------------- pipeline on the card


@pytest.mark.parametrize("kind", ["qoi_p4", "png_host", "native_jpeg", "restart", "bmp"])
def test_pipeline_matches_serial_on_the_card(cuda, kind):
    """Every prep of a prefetch-3 pipeline ends before its first upload
    (the plans' staging buffers all live at once, the copies on the side
    stream): each result equals the serial decode's on the card."""
    import threading

    from _torch_png import encode_png, random_pixels
    from _torch_raster import bmp_batch, qoi_enc

    from zpix_tpu_torch import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                                HostIndexQoiDecoder)
    from zpix_tpu_torch.parallel.pipeline import DecodePipeline

    rng = np.random.default_rng(3)
    if kind == "qoi_p4":
        make = lambda: HostIndexQoiDecoder(lane_p=16, lane_fmt="p4")  # noqa: E731
        imgs = rng.integers(0, 256, (9, 64, 96, 4), dtype=np.uint8)
        imgs[..., 3] = 255
        batches = [[qoi_enc(i) for i in imgs[3 * s : 3 * s + 3]] for s in range(3)]
    elif kind == "png_host":
        make = BatchPngDecoder
        batches = [[encode_png(random_pixels(rng, "tc8", 96, 64), "tc8", seed=3 * s + i)
                    for i in range(3)] for s in range(3)]
    elif kind == "bmp":
        make = BatchBmpDecoder
        batches = [bmp_batch((24, 40, False, False), h=64, w=96, seed=s) for s in range(3)]
    else:
        from _torch_jpeg import synth_plain_jpeg

        make = BatchJpegDecoder if kind == "native_jpeg" else DeviceJpegDecoder
        synth = synth_plain_jpeg if kind == "native_jpeg" else synth_jpeg
        batches = [[synth(160, 120, phase=3 * s + j) for j in range(2)] for s in range(3)]
    dec, done, lock = make(), threading.Event(), threading.Lock()
    count = [0]

    def prep(datas):
        plan = dec.prep(datas)
        with lock:
            count[0] += 1
            if count[0] == len(batches):
                done.set()
        return plan

    def run(plan):
        assert done.wait(60)
        return dec.run(plan, dec.upload(plan))

    got = list(DecodePipeline(prep=prep, run=run, prefetch=3, workers=3).map(batches))
    serial = make()
    for out, datas in zip(got, batches):
        want = serial.decode(datas)
        if kind == "png_host":
            out = out[0]
        if isinstance(want, tuple):
            assert bool(out[1]) and bool(want[1])
            out, want = out[0], want[0]
        assert out.device.type == "cuda" and torch.equal(out, want)


# ------------------------------------------- BatchJpegDecoder's Python front-end


@pytest.mark.parametrize("name", ["rgb_444", "rgb_420_dri", "ycck_444", "ycck_2211",
                                  "cmyk_444", "cmyk_2211", "multi_scan_420",
                                  "progressive_420", "progressive_gray"])
def test_python_front_end_batches_on_the_card(cuda, name, monkeypatch):
    """Each colour arm K6 had only on random grids, multi-scan and
    progressive, from bytes: K7 and K6 once each and no plain version, the
    pixels those of the CPU route and of the port's host decoder."""
    from _torch_jpeg import port_host_pixels, python_front_end_cases

    from zpix_tpu_torch import BatchJpegDecoder
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.utils import metrics

    make = python_front_end_cases(75, 41)[name]
    datas = [make(s) for s in (0, 1, 2)]
    want = BatchJpegDecoder(device="cpu").decode(datas)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ks, "unpack_components_plain", plain)
    monkeypatch.setattr(kp, "component_planes_plain", plain)
    dec = BatchJpegDecoder(n_threads=3)
    before = dict(runtime.LAUNCHES)
    python = metrics.counters.get("jpeg_batch.python_front_end", 0)
    got = dec.decode(datas)
    torch.cuda.synchronize()
    dec.close()
    assert metrics.counters["jpeg_batch.python_front_end"] == python + 3
    assert runtime.LAUNCHES["unpack_sparse"] == before["unpack_sparse"] + 1
    assert runtime.LAUNCHES["component_planes"] == before["component_planes"] + 1
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].cpu().numpy(), port_host_pixels(d))


def test_decode_verified_on_the_card(cuda, monkeypatch):
    """decode_verified: the card's pixels where ok, the port's host
    decoder's where ok is False (forced here), as host numpy arrays."""
    from _torch_jpeg import port_host_pixels, python_front_end_cases

    from zpix_tpu_torch import OnchipProgressiveDecoder

    data = python_front_end_cases(75, 41)["progressive_420"](0)
    dec = OnchipProgressiveDecoder()
    px, ok = dec.decode([data, data])
    assert bool(ok)
    got = dec.decode_verified([data, data])
    assert isinstance(got, np.ndarray) and np.array_equal(got, px.cpu().numpy())
    run = dec.run
    monkeypatch.setattr(dec, "run", lambda prep, bufs=None: (
        run(prep, bufs)[0], torch.zeros((), dtype=torch.bool, device=cuda)))
    host = dec.decode_verified([data, data])
    assert np.array_equal(host, np.stack([port_host_pixels(data)] * 2))
    assert np.array_equal(host, px.cpu().numpy())
    dec.close()


def test_decode_mixed_on_the_card_matches_cpu_run(cuda):
    """A small mixed corpus through decode_mixed on the card: every bucket
    on its batch decoder, equal to the device="cpu" run image by image,
    the same route counts, and each kernel of the router's path launched."""
    import io

    from _torch_jpeg import synth_cmyk, synth_plain_jpeg, synth_progressive
    from _torch_png import png_batch
    from _torch_raster import bmp_batch, qoi_enc, qoi_images
    from PIL import Image

    from zpix_tpu_torch.parallel import bucketing

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).convert("CMYK").save(
        buf, format="JPEG", progressive=True)
    p = synth_progressive(w=40, h=24)
    corpus = ([synth_plain_jpeg(w=40, h=24, phase=s) for s in (0.0, 0.5)]
              + [synth_cmyk(None, w=32, h=16, seed=s, dri_blocks=None) for s in (1, 2)]
              + [p, p, synth_progressive(w=40, h=24, phase=0.3), buf.getvalue()]
              + [qoi_enc(im) for im in qoi_images(w=20, h=12)]
              + bmp_batch((24, 40, False, False), 6, 9, batch=2)
              + bmp_batch((8, 40, False, True), 6, 9, batch=2)
              + png_batch("tc8", 13, 7, batch=2)[0] + png_batch("p4", 13, 7, batch=2,
                                                                 interlace=True)[0])
    try:
        want, want_stats = bucketing.decode_mixed(corpus, device="cpu", return_stats=True)
        runtime.reset_launches()
        got, got_stats = bucketing.decode_mixed(corpus, return_stats=True)
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
    finally:
        bucketing.close()
    assert got_stats == want_stats == {"device": len(corpus) - 1, "host-routed": 1}
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and np.array_equal(g, w)
    for k in ("unpack_sparse", "component_planes", "dc_first", "ac_first", "ac_refine",
              "dc_refine", "qoi_lane_expand", "bmp_unpack", "png_expand"):
        assert launches[k] > 0, k


@pytest.mark.parametrize("dri,batch,owned", [(3, 6, [2, 1, 2, 1]), (2, 8, [2, 2, 2, 2])],
                         ids=["straddle", "whole"])
def test_device_jpeg_on_four_shards_of_one_card(cuda, dri, batch, owned):
    """make_mesh(["cuda:0"] * 4): every shard's K1-K4 on the card, the
    straddling images brought together, equal to the CPU run."""
    from zpix_tpu_torch.parallel import make_mesh

    datas = [synth_jpeg(w=48, h=32, dri_blocks=dri, phase=0.1 * i) for i in range(batch)]
    want, want_ok = DeviceJpegDecoder(device="cpu").decode(datas)
    runtime.reset_launches()
    got, ok = DeviceJpegDecoder(mesh=make_mesh(["cuda:0"] * 4)).decode(datas)
    torch.cuda.synchronize()
    assert bool(want_ok) and bool(ok) and ok.device == torch.device("cuda", 0)
    assert [t.shape[0] for t in got.shards] == owned
    assert all(t.device == torch.device("cuda", 0) for t in got.shards)
    assert torch.equal(got.cpu(), want)
    assert [runtime.LAUNCHES[k] for k in ("index_pass", "value_pass", "dc_restore",
                                          "backend")] == [4, 4, 4, 4]


def test_mesh_decoders_and_router_on_four_shards_of_one_card(cuda):
    from _torch_jpeg import synth_plain_jpeg
    from _torch_png import png_batch
    from _torch_raster import bmp_batch, qoi_enc, qoi_images

    from zpix_tpu_torch.parallel import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                                         HostIndexQoiDecoder, bucketing, make_mesh)

    mesh = make_mesh(["cuda:0"] * 4)
    imgs = qoi_images(w=20, h=12)
    cases = {
        "jpeg": (BatchJpegDecoder, [synth_plain_jpeg(w=40, h=24, phase=0.1 * i)
                                    for i in range(4)]),
        "bmp": (BatchBmpDecoder, bmp_batch((24, 40, False, False), 6, 9, batch=4)),
        "png": (BatchPngDecoder, png_batch("tc8", 13, 7, batch=4)[0]),
        "png_inflate": (lambda **kw: BatchPngDecoder(device_inflate=True, **kw),
                        png_batch("p4", 13, 7, batch=4, interlace=True)[0]),
        "qoi_lane": (HostIndexQoiDecoder, [qoi_enc(im) for im in imgs]),
        "qoi_sorted": (lambda **kw: HostIndexQoiDecoder(impl="sorted", **kw),
                       [qoi_enc(im) for im in imgs]),
    }
    for name, (make, datas) in cases.items():
        want = make(device="cpu").decode(datas)
        got = make(mesh=mesh).decode(datas)
        assert torch.equal(got.cpu(), want), name
    corpus = [d for _, ds in cases.values() for d in ds]
    try:
        want = bucketing.decode_mixed(corpus, device="cpu")
        got = bucketing.decode_mixed(corpus, mesh=mesh)
    finally:
        bucketing.close()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_scratch_and_grid_maps_key_by_the_cards_index(cuda):
    from zpix_tpu_torch.ops import sparse
    from zpix_tpu_torch.parallel.batch import stream_perm

    a, _ = runtime.lookback_scratch("cuda", 64)
    b, _ = runtime.lookback_scratch(torch.device("cuda", torch.cuda.current_device()), 64)
    assert a.data_ptr() == b.data_ptr()
    perm = stream_perm(5, 3, 2, 2)
    m = sparse.grid_map(perm, "cuda")
    assert m.device == torch.device("cuda", torch.cuda.current_device())
    assert sparse.grid_map(perm, torch.device("cuda", torch.cuda.current_device())) is m
    assert sparse.grid_map((5, 3, 2, 2), "cuda").data_ptr() != 0


# ------------------------------------ spec slice (K20-K23): no host index walk


def _spec_first_scans(mode, w, h, batch=3, cb=64, damage=None, **kw):
    """The DC-first and single-component AC-first scans of a batch of one
    progressive image -> (plan, [(scan, numpy inputs, chunks)])."""
    from _torch_jpeg import synth_progressive

    from zpix_tpu_torch.parallel import progressive_onchip as po

    plans = [po.parse_progressive(synth_progressive(w, h, mode, **kw)) for _ in range(batch)]
    p0, out = plans[0], []
    for si, sc in enumerate(p0.scans):
        if sc.kind == "dc_first" or (sc.kind == "ac_first" and len(sc.comps) == 1):
            arrays, F = po.spec_first_inputs(p0, plans, si, cb)
            if damage is not None:
                arrays[0] = damage(arrays[0].copy(), arrays[1], arrays[2])
            out.append((sc, arrays, F))
    return p0, out


def _spec_scan_both(cuda, p0, sc, arrays, F, cb, seed=0):
    """One K20 or K21 scan on the card and plain on the CPU, from the same
    random store -> (kernel's (grids, ok), plain's)."""
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.parallel import progressive_onchip as po

    rng = np.random.default_rng(seed)
    B = arrays[1].shape[0]
    init = [rng.integers(-999, 999, (B, p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64))
            .astype(np.int32) for c in sc.comps]
    res = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        grids = [torch.from_numpy(g.copy()).to(dev) for g in init]
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        kw = dict(valid=po.valid_grid(p0, sc.comps[0]), al=sc.al, chunk_bytes=cb, n_chunks=F)
        kind = "dc_first_spec" if sc.kind == "dc_first" else "ac_first_spec"
        before = runtime.LAUNCHES[kind]
        if sc.kind == "dc_first":
            ps.dc_first_spec(*t, ok, grids, hv=[p0.hv[c] for c in sc.comps], **kw)
        else:
            ps.ac_first_spec(*t, ok, grids[0], ss=sc.ss, se=sc.se, **kw)
        per_call = ps.DC_FIRST_KERNELS if sc.kind == "dc_first" else ps.AC_FIRST_KERNELS
        assert runtime.LAUNCHES[kind] == before + per_call * (dev.type == "cuda")
        res.append(([g.cpu() for g in grids], int(ok)))
    return res


@pytest.mark.parametrize("cb", [16, 64, 256])
@pytest.mark.parametrize("mode,w,h", [("gray", 64, 48), ("444", 37, 29), ("422", 200, 120),
                                      ("420", 200, 120), ("420", 511, 257)])
def test_spec_first_kernels_match_plain(cuda, mode, w, h, cb):
    """K20 and K21 on every DC-first and AC-first scan of a batch, from a
    random store: the store and ok equal their plain versions'."""
    p0, scans = _spec_first_scans(mode, w, h, cb=cb)
    for sc, arrays, F in scans:
        (gk, okk), (gp, okp) = _spec_scan_both(cuda, p0, sc, arrays, F, cb)
        assert okk == okp == 1, sc.kind
        for a, b in zip(gk, gp):
            assert torch.equal(a, b), (sc.kind, sc.comps)


@pytest.mark.parametrize("seed", range(4))
def test_spec_first_kernels_match_plain_on_damaged_streams(cuda, seed):
    """Random bytes written into the scans (image 1 of 3): the kernels and
    their plain versions agree on the store and ok."""
    rng = np.random.default_rng(seed)

    def damage(flat, starts, ends):
        lo, hi = starts[1] // 8, ends[1] // 8
        at = rng.integers(lo, hi, 4)
        flat[at] = rng.integers(0, 256, 4, dtype=np.uint8)
        return flat

    p0, scans = _spec_first_scans("420", 200, 120, cb=16, damage=damage)
    for sc, arrays, F in scans:
        (gk, okk), (gp, okp) = _spec_scan_both(cuda, p0, sc, arrays, F, 16, seed)
        assert okk == okp, sc.kind
        for a, b in zip(gk, gp):
            assert torch.equal(a, b), (sc.kind, sc.comps)


def test_spec_first_kernels_on_hand_coded_scans(cuda):
    """K20 (slots cycling through two tables, a 1-bit-code batch that
    overflows a chunk) and K21 (EOB runs across chunk edges) on scans coded
    by hand (tests/_torch_prog.py) at chunks of 1 to 8 bytes."""
    import _torch_prog as tp

    from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
    from zpix_tpu_torch.ops import prog_spec as ps

    def tables(huffs, tid_of_slot, ac):
        out = []
        for counts, syms in huffs:
            t = HuffTable()
            t.build(list(counts), bytes(syms))
            out.append(t)
        return ke.pack_tables(out, [] if ac else tid_of_slot, [0] if ac else [])

    hv = [(2, 2), (1, 1), (1, 1)]
    for cb, kw in ((1, {}), (2, {}), (1, dict(zero=1.0, tables=(tp.DC_UNARY,)))):
        cases = [tp.spec_dc_scan(cb + 3 * b, hv=hv, **kw) for b in range(3)]
        flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
        tab = tables(cases[0]["huffs"], cases[0]["tid_of_slot"], False)
        res = []
        for dev in (cuda, torch.device("cpu")):
            grids = [torch.zeros(3, 3 * v, 5 * h, 64, dtype=torch.int32, device=dev) for h, v in hv]
            ok = torch.ones(1, dtype=torch.int32, device=dev)
            ps.dc_first_spec(*(torch.from_numpy(a).to(dev) for a in (flat, starts, ends, tab)), ok,
                             grids, hv=hv, valid=(3, 5), al=2, chunk_bytes=cb, n_chunks=F)
            res.append(([g.cpu() for g in grids], int(ok)))
        assert res[0][1] == res[1][1] == int(not kw)
        assert all(torch.equal(a, b) for a, b in zip(res[0][0], res[1][0]))
    for cb in (1, 3, 8):
        cases = [tp.spec_ac_scan(cb + b) for b in range(3)]
        flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
        tab = tables(cases[0]["huffs"], None, True)
        res = []
        for dev in (cuda, torch.device("cpu")):
            grid = torch.zeros(3, 7, 12, 64, dtype=torch.int32, device=dev)
            ok = torch.ones(1, dtype=torch.int32, device=dev)
            ps.ac_first_spec(*(torch.from_numpy(a).to(dev) for a in (flat, starts, ends, tab)), ok,
                             grid, valid=(6, 11), ss=1, se=63, al=1, chunk_bytes=cb, n_chunks=F)
            res.append((grid.cpu(), int(ok)))
        assert res[0][1] == res[1][1] == 1 and torch.equal(res[0][0], res[1][0])
        want = np.zeros((3, 7, 12, 64), np.int64)
        for b, c in enumerate(cases):
            want[b, :6, :11] = (c["vals"] << 1).reshape(6, 11, 64)
        assert np.array_equal(res[0][0].numpy(), want.astype(np.int32))


@pytest.mark.parametrize("B,N,k", [(1, 10, 3), (16, 4096, 1000), (3, 1 << 20, 1 << 18)])
def test_delta_add_matches_scatter_add(cuda, B, N, k):
    """K22 against Tensor.scatter_add_ (its plain version): unique indices a
    row, padding (0, 0) pairs meeting a real index 0, values that wrap."""
    from zpix_tpu_torch.ops import prog_spec as ps

    rng = np.random.default_rng(k)
    state = rng.integers(-2**31, 2**31, (B, N)).astype(np.int32)
    idx = np.zeros((B, k), np.int32)
    val = np.zeros((B, k), np.int32)
    for b in range(B):
        n = int(rng.integers(1, k + 1))
        idx[b, :n] = rng.choice(N, n, replace=False)
        val[b, :n] = rng.integers(-2**31, 2**31, n)
    want = torch.from_numpy(state.copy())
    ps.delta_add(want, torch.from_numpy(idx), torch.from_numpy(val))
    got = torch.from_numpy(state).to(cuda)
    before = runtime.LAUNCHES["delta_add"]
    ps.delta_add(got, torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda))
    assert runtime.LAUNCHES["delta_add"] == before + 1
    assert torch.equal(got.cpu(), want)


def _qoi_spec_both(cuda, datas, cb=None, ops_cap=None):
    from zpix_tpu_torch.parallel import BatchQoiDecoder

    before = runtime.LAUNCHES["qoi_spec"]
    got, ok = BatchQoiDecoder(chunk_bytes=cb, ops_cap=ops_cap, device=cuda).decode(datas)
    assert runtime.LAUNCHES["qoi_spec"] == before + 1
    want, wok = BatchQoiDecoder(chunk_bytes=cb, ops_cap=ops_cap, device="cpu").decode(datas)
    return got.cpu(), bool(ok), want, bool(wok)


@pytest.mark.parametrize("cb", [None, 16, 64, 256])
def test_qoi_spec_kernel_matches_plain_and_host(cuda, cb):
    """K23 on the four QOI op classes, at the adaptive chunk and at 16, 64
    and 256 bytes: pixels and ok equal the plain version's and the host
    decoder's."""
    from _torch_raster import qoi_enc, qoi_images

    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels

    datas = [qoi_enc(a) for a in qoi_images(96, 64)]
    got, ok, want, wok = _qoi_spec_both(cuda, datas, cb)
    assert ok and wok and torch.equal(got, want)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].numpy(), decode_pixels(d))


def test_qoi_spec_kernel_on_bench_content(cuda):
    """K23 on 256^2 screen and noise content of the JAX bench, 4 images each."""
    from _torch_raster import bench_pixels, qoi_enc

    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels

    for content in ("screen", "noise"):
        datas = [qoi_enc(bench_pixels(256, s, content)) for s in range(4)]
        got, ok, want, wok = _qoi_spec_both(cuda, datas)
        assert ok and wok and torch.equal(got, want), content
        assert np.array_equal(got[3].numpy(), decode_pixels(datas[3]))


def test_qoi_spec_kernel_truncated_and_over_cap(cuda):
    """A stream cut short (fill) and an ops_cap under the ops: ok as the plain
    version's, pixels too where ok."""
    from _torch_raster import qoi_enc, qoi_images

    imgs = qoi_images()
    dense = qoi_enc(imgs[3])
    cut = dense[: len(dense) // 2] + b"\x00" * 8
    got, ok, want, wok = _qoi_spec_both(cuda, [cut, dense], cb=32)
    assert ok == wok and (not ok or torch.equal(got, want))
    got, ok, want, wok = _qoi_spec_both(cuda, [dense], cb=32, ops_cap=2)
    assert not ok and not wok


def test_qoi_spec_four_shards(cuda):
    """BatchQoiDecoder over make_mesh(["cuda:0"] * 4): a launch a shard, the
    output equal to the unsharded decode."""
    from _torch_raster import qoi_enc, qoi_images

    from zpix_tpu_torch.parallel import BatchQoiDecoder, make_mesh

    datas = [qoi_enc(a) for a in qoi_images()] * 2
    want, wok = BatchQoiDecoder(chunk_bytes=32, device=cuda).decode(datas)
    before = runtime.LAUNCHES["qoi_spec"]
    got, ok = BatchQoiDecoder(chunk_bytes=32, mesh=make_mesh(["cuda:0"] * 4)).decode(datas)
    assert runtime.LAUNCHES["qoi_spec"] == before + 4
    assert bool(ok) and bool(wok) and np.array_equal(np.asarray(got), want.cpu().numpy())


def _k23_both(cuda, datas, cb, ops_cap=None, cut=None):
    """K23 on the card and plain on the CPU on one QoiPlan (``cut``: bytes
    taken off every image's op stream and its padding, so an op reads past
    the padded end) -> (kernel rgba, ok, rounds, plain rgba, ok, stats)."""
    from zpix_tpu_torch.ops import qoi_spec as qs
    from zpix_tpu_torch.parallel import qoi_batch as tq

    plan = tq.prep_qoi_batch(datas, cb)
    arrays = [plan.stream, plan.img_byte_start, plan.img_byte_end, plan.img_raw_end]
    if cut is not None:
        arrays[2] = arrays[2] - cut
        arrays[3] = arrays[2].copy()
    kw = dict(n_chunks=plan.n_chunks, chunk_bytes=plan.chunk_bytes,
              ops_cap=ops_cap or plan.chunk_bytes, height=plan.height, width=plan.width)
    before = runtime.LAUNCHES["qoi_spec"]
    got, ok, rounds = qs.spec_decode(*(torch.from_numpy(a).to(cuda) for a in arrays), **kw)
    assert runtime.LAUNCHES["qoi_spec"] == before + 1
    stats = {}
    want, wok, _ = qs.spec_decode_plain(*(torch.from_numpy(a) for a in arrays), **kw, stats=stats)
    return got.cpu(), bool(ok), rounds.cpu(), want, bool(wok), stats


def _k23_cases():
    from _torch_raster import bench_pixels, qoi_enc, qoi_images

    rng = np.random.default_rng(21)
    lut = rng.integers(0, 256, (60, 4), dtype=np.uint8)
    few = rng.integers(0, 256, (5, 4), dtype=np.uint8)
    return {
        # at most 64 colours: nearly every op INDEX, source chains deep
        "index_heavy": [qoi_enc(lut[rng.integers(0, 60, (64, 96))]),
                        qoi_enc(few[(np.arange(64 * 96) // 3 % 5)].reshape(64, 96, 4)),
                        qoi_enc(qoi_images(96, 64)[2])],
        "all_run": [qoi_enc(np.full((64, 96, 4), 77, np.uint8))] * 2,
        "all_rgba": [qoi_enc(rng.integers(0, 256, (64, 96, 4), dtype=np.uint8))
                     for _ in range(2)],
        "alpha": [qoi_enc(bench_pixels(96, s, "alpha")[:64]) for s in range(2)],
        # a flat image beside noise: the short stream's chunks past its end
        "unequal": [qoi_enc(np.full((64, 96, 4), 9, np.uint8)),
                    qoi_enc(bench_pixels(96, 5, "noise")[:64]), qoi_enc(qoi_images(96, 64)[0])],
        "bench": [qoi_enc(bench_pixels(128, s, c)) for s, c in ((1, "screen"), (2, "noise"))],
    }


@pytest.mark.parametrize("cb", [16, 4096])
@pytest.mark.parametrize("case", ["index_heavy", "all_run", "all_rgba", "alpha", "unequal"])
def test_qoi_spec_redesign_matches_plain(cuda, case, cb):
    """K23 against its plain version (max_abs_err 0, the same ok) on
    index-heavy, all-RUN, all-RGBA and varying-alpha content and a batch of
    unequal streams, at chunks of 16 bytes and 4 KiB; each image's passes
    at least 1, the most of them the plain version's source passes."""
    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels

    datas = _k23_cases()[case]
    got, ok, rounds, want, wok, stats = _k23_both(cuda, datas, cb)
    assert ok and wok and torch.equal(got, want), case
    assert int(rounds.min()) >= 1 and int(rounds.max()) == stats["passes"]
    assert np.array_equal(got[0].numpy(), decode_pixels(datas[0]))


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_qoi_spec_redesign_stream_cut_inside_an_op(cuda, cut):
    """Streams whose last op reads past the padded end (the padding and 1-3
    op bytes taken off): ok False in both, the pixels (the ops before it,
    then the fill) equal."""
    from _torch_raster import qoi_enc

    rng = np.random.default_rng(cut)
    datas = [qoi_enc(rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)) for _ in range(2)]
    got, ok, _, want, wok, _ = _k23_both(cuda, datas, 16, cut=cut)
    assert not ok and not wok and torch.equal(got, want)


def test_qoi_spec_redesign_ops_cap_overflow(cuda):
    """ops_cap under a chunk's ops: ok False in both, the pixels equal (the
    cap only clears ok)."""
    datas = _k23_cases()["unequal"]
    got, ok, _, want, wok, _ = _k23_both(cuda, datas, 64, ops_cap=3)
    assert not ok and not wok and torch.equal(got, want)


def test_qoi_spec_redesign_on_bench_content_passes(cuda):
    """The JAX bench's screen and noise at 128^2, chunks of 128 bytes and
    the adaptive chunk: equal to the plain version and the host decoder."""
    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels

    datas = _k23_cases()["bench"]
    for cb in (128, None):
        got, ok, rounds, want, wok, stats = _k23_both(cuda, datas, cb)
        assert ok and wok and torch.equal(got, want)
        assert int(rounds.max()) == stats["passes"]
        for i, d in enumerate(datas):
            assert np.array_equal(got[i].numpy(), decode_pixels(d))


K20_HV = {1: ((1, 1),), 3: ((1, 1),) * 3, 6: ((2, 2), (1, 1), (1, 1)),
          10: ((2, 2), (2, 2), (1, 2))}


def _k20_both(cuda, cases, hv, cb, mxx=5, myy=3):
    """K20 on the card and plain on the CPU from one random store ->
    (kernel grids, ok, rounds, plain grids, ok, the links plain's misses)."""
    from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
    from zpix_tpu_torch.ops import prog_spec as ps

    huffs = []
    for counts, syms in cases[0]["huffs"]:
        t = HuffTable()
        t.build(list(counts), bytes(syms))
        huffs.append(t)
    tab = ke.pack_tables(huffs, cases[0]["tid_of_slot"], [])
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    B = len(cases)
    rng = np.random.default_rng(cb)
    shapes = ([(B, myy + 1, mxx + 2, 64)] if len(hv) == 1 else
              [(B, myy * v, mxx * h, 64) for h, v in hv])
    init = [rng.integers(-999, 999, s).astype(np.int32) for s in shapes]
    res = []
    for dev in (cuda, torch.device("cpu")):
        grids = [torch.from_numpy(g.copy()).to(dev) for g in init]
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        before = runtime.LAUNCHES["dc_first_spec"]
        rounds = ps.dc_first_spec(*(torch.from_numpy(a).to(dev) for a in (flat, starts, ends, tab)),
                                  ok, grids, hv=list(hv), valid=(myy, mxx), al=1, chunk_bytes=cb,
                                  n_chunks=F)
        assert runtime.LAUNCHES["dc_first_spec"] == before + ps.DC_FIRST_KERNELS * (
            dev.type == "cuda")
        res.append(([g.cpu() for g in grids], int(ok), rounds.cpu()))
    bpm = sum(h * v for h, v in hv) if len(hv) > 1 else 1
    links = ps.dc_entry_links_plain(*(torch.from_numpy(a) for a in (flat, starts, ends, tab)),
                                    bpm=bpm, chunk_bytes=cb, n_chunks=F)
    return res[0], res[1], links["misses"]


@pytest.mark.parametrize("cb", [1, 2, 7, 64])
@pytest.mark.parametrize("bpm", [1, 3, 6, 10])
def test_dc_first_spec_redesign_matches_plain(cuda, bpm, cb):
    """K20 against its plain version (max_abs_err 0, the same ok) on scans
    coded by hand with 1, 3, 6 and 10 blocks an MCU, two images of unequal
    scan length (their zero shares differ) and a third cut short, at
    chunks of 1, 2, 7 and 64 bytes; each image's misses those of the
    kernels' scheme in plain PyTorch."""
    import _torch_prog as tp

    hv = K20_HV[bpm]
    cases = [tp.spec_dc_scan(100 * bpm + cb + b, hv=hv, zero=z) for b, z in enumerate((0.2, 0.9))]
    cut = tp.spec_dc_scan(7 * bpm + cb, hv=hv)
    cases.append(dict(cut, stream=cut["stream"][: len(cut["stream"]) // 2]))
    (gk, okk, misses), (gp, okp, _), want_misses = _k20_both(cuda, cases, hv, cb)
    assert okk == okp == 0  # the cut image holds fewer symbols than its blocks
    assert all(torch.equal(a, b) for a, b in zip(gk, gp))
    assert torch.equal(misses.to(torch.int64), want_misses)
    (gk, okk, misses), (gp, okp, _), want_misses = _k20_both(cuda, cases[:2], hv, cb)
    assert okk == okp == 1 and all(torch.equal(a, b) for a, b in zip(gk, gp))
    assert torch.equal(misses.to(torch.int64), want_misses)


@pytest.mark.parametrize("seed", range(3))
def test_dc_first_spec_redesign_corrupt_code(cuda, seed):
    """Two 0xFF bytes written into one image's scan (a code past the DC
    tables' or a wrong symbol) and random bytes into another: K20 and its
    plain version agree on the store, ok and the misses."""
    import _torch_prog as tp

    hv = K20_HV[6]
    rng = np.random.default_rng(seed)
    cases = [tp.spec_dc_scan(seed * 5 + b, hv=hv, mxx=9, myy=5) for b in range(3)]
    bad = cases[1]["stream"].copy()
    at = int(rng.integers(2, len(bad) - 2))
    bad[at : at + 2] = 0xFF  # all ones: past every DC table's codes
    cases[1] = dict(cases[1], stream=bad)
    noisy = cases[2]["stream"].copy()
    noisy[rng.integers(0, len(noisy), 3)] = rng.integers(0, 256, 3, dtype=np.uint8)
    cases[2] = dict(cases[2], stream=noisy)
    for cb in (2, 16):
        (gk, okk, misses), (gp, okp, _), want_misses = _k20_both(cuda, cases, hv, cb, 9, 5)
        assert okk == okp and all(torch.equal(a, b) for a, b in zip(gk, gp))
        assert torch.equal(misses.to(torch.int64), want_misses)


@pytest.mark.parametrize("mode,w,h", [("420", 200, 120), ("gray", 37, 29), ("444", 64, 48)])
def test_spec_route_matches_host_decoder(cuda, mode, w, h):
    """OnchipProgressiveDecoder(impl="spec") on the card: ok, no host tail,
    K20 once and K21 once for every AC-first scan, pixels the host
    decoder's and the CPU route's."""
    from _torch_jpeg import port_host_pixels, synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    data = synth_progressive(w, h, mode, phase=0.6)
    runtime.reset_launches()
    dec = OnchipProgressiveDecoder(device=cuda, impl="spec")
    px, ok = dec.decode([data] * 3)
    assert bool(ok) and dec.n_host_tail_scans == 0
    from zpix_tpu_torch.ops import prog_spec as ps

    assert runtime.LAUNCHES["dc_first_spec"] == ps.DC_FIRST_KERNELS
    assert runtime.LAUNCHES["ac_first"] == 0
    assert runtime.LAUNCHES["ac_first_spec"] == ps.AC_FIRST_KERNELS
    assert np.array_equal(px[2].cpu().numpy(), port_host_pixels(data))
    cpu, cok = OnchipProgressiveDecoder(device="cpu", impl="spec").decode([data] * 3)
    assert bool(cok) and torch.equal(px.cpu(), cpu)


def test_spec_tail_and_refused_walk_on_the_card(cuda):
    """The moved Cb scan: the host tail runs (5 scans) and one K22 launch
    writes its deltas back (K21 once for the prefix's 3 AC-first scans); a
    batch a walk refuses takes the spec path in decode()
    (pixels and ok, or the host tail's error, as the CPU route's)."""
    from _torch_jpeg import move_scan, port_host_pixels, synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder

    data = synth_progressive(200, 120, "420", phase=0.3)
    moved = move_scan(data, 3, 5)
    runtime.reset_launches()
    dec = OnchipProgressiveDecoder(device=cuda, impl="spec")
    px, ok = dec.decode([moved] * 2)
    assert bool(ok) and dec.n_host_tail_scans == 5 and runtime.LAUNCHES["delta_add"] == 1
    from zpix_tpu_torch.ops import prog_spec as ps

    assert runtime.LAUNCHES["ac_first_spec"] == ps.AC_FIRST_KERNELS
    assert np.array_equal(px[1].cpu().numpy(), port_host_pixels(data))
    bad = bytearray(data)
    at = -1
    for _ in range(4):
        at = bad.find(b"\xff\xda", at + 1)
    at += 2 + ((bad[at + 2] << 8) | bad[at + 3])
    bad[at : at + 16] = b"\xff\x00" * 8
    for datas in ([data, bytes(bad)], [bytes(bad)] * 2):
        outcomes = []
        for dev in (cuda, "cpu"):
            try:  # the host tail may refuse the stream: the error is the outcome
                px, ok = OnchipProgressiveDecoder(device=dev).decode(datas)
                outcomes.append((px.cpu(), bool(ok)))
            except Exception as exc:
                outcomes.append((type(exc).__name__, str(exc)))
        (a, ak), (b, bk) = outcomes
        assert ak == bk and (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_delta_route_matches_host_decoder(cuda):
    """DeviceProgressiveDecoder on the card: one K22 launch for every
    (scan, component), K6, pixels the host decoder's and the CPU route's."""
    from _torch_jpeg import port_host_pixels, synth_progressive

    from zpix_tpu_torch.parallel import DeviceProgressiveDecoder

    datas = [synth_progressive(200, 120, "420", phase=p) for p in (0.1, 0.5)]
    runtime.reset_launches()
    got = DeviceProgressiveDecoder(device=cuda).decode(datas)
    assert runtime.LAUNCHES["delta_add"] == 1 and runtime.LAUNCHES["component_planes"] == 1
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].cpu().numpy(), port_host_pixels(d))
    assert torch.equal(got.cpu(), DeviceProgressiveDecoder(device="cpu").decode(datas))


# ------------------------------- K21 and K22 redesigned: one call a decode


def _ac_group_both(cuda, scans, cb, seed=0):
    """K21 over ``scans`` [(scan, numpy inputs, chunks)] of one batch in one
    call on the card, and plain on the CPU (a scan at a time), from one
    random store -> (kernel grids, ok, misses [S, B], plain grids, ok)."""
    from zpix_tpu_torch.ops import prog_spec as ps

    rng = np.random.default_rng(seed)
    B = scans[0][1][0][1].shape[0]
    shapes = {}
    for sc, _, _, shape in scans:
        shapes[sc.comps[0]] = shape
    init = {c: rng.integers(-999, 999, s).astype(np.int32) for c, s in shapes.items()}
    res = []
    for dev in (cuda, torch.device("cpu")):
        grids = {c: torch.from_numpy(g.copy()).to(dev) for c, g in init.items()}
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        group = [ps.AcScan(*(torch.from_numpy(a).to(dev) for a in arrays), grids[sc.comps[0]],
                           valid, sc.ss, sc.se, sc.al, F)
                 for sc, (arrays, F, valid), _, _ in scans]
        before = runtime.LAUNCHES["ac_first_spec"]
        misses = ps.ac_first_spec_group(group, ok, chunk_bytes=cb)
        assert runtime.LAUNCHES["ac_first_spec"] == before + ps.AC_FIRST_KERNELS * (
            dev.type == "cuda")
        res.append(({c: g.cpu() for c, g in grids.items()}, int(ok), misses.cpu()))
    return res


def _prog_ac_scans(datas, cb, prefix_only=False, damage=None):
    """The single-component AC-first scans of a batch (those of the spec
    prefix with ``prefix_only``) -> [(scan, (inputs, chunks, valid), index,
    store shape)]."""
    from zpix_tpu_torch.parallel import progressive_onchip as po

    plans = [po.parse_progressive(d) for d in datas]
    p0 = plans[0]
    n = po.spec_prefix(p0) if prefix_only else len(p0.scans)
    out = []
    for si, sc in enumerate(p0.scans[:n]):
        if sc.kind == "ac_first" and len(sc.comps) == 1:
            arrays, F = po.spec_first_inputs(p0, plans, si, cb)
            if damage is not None:
                arrays[0] = damage(arrays[0].copy(), arrays[1], arrays[2])
            h, v = p0.hv[sc.comps[0]]
            out.append((sc, (arrays, F, po.valid_grid(p0, sc.comps[0])), si,
                        (len(datas), p0.myy * v, p0.mxx * h, 64)))
    return out


def _links_misses(scans, cb):
    """Each scan's misses an image as the kernels' scheme makes them, in
    plain PyTorch (ops/prog_spec.py::ac_entry_links_plain) -> int64 [S, B]."""
    from zpix_tpu_torch.ops import prog_spec as ps

    return torch.stack([ps.ac_entry_links_plain(*(torch.from_numpy(a) for a in arrays[:4]),
                                                ss=sc.ss, se=sc.se, chunk_bytes=cb,
                                                n_chunks=F)["misses"]
                        for sc, (arrays, F, _), _, _ in scans])


@pytest.mark.parametrize("cb", [1, 4, 16, 64])
@pytest.mark.parametrize("mode,w,h", [("420", 96, 64), ("444", 64, 48), ("gray", 72, 40)])
def test_ac_first_spec_redesign_matches_plain(cuda, mode, w, h, cb):
    """K21 over every AC-first scan of a 4:2:0, 4:4:4 and gray batch in one
    call against its plain version a scan at a time, from one random
    store: max_abs_err 0, the same ok, each (scan, image)'s misses those of
    ac_entry_links_plain; chunks of 1, 4, 16 and 64 bytes."""
    from _torch_jpeg import synth_progressive

    datas = [synth_progressive(w, h, mode, phase=0.1 + 0.3 * b) for b in range(1)] * 3
    scans = _prog_ac_scans(datas, cb)
    assert len(scans) >= 2
    (gk, okk, misses), (gp, okp, _) = _ac_group_both(cuda, scans, cb)
    assert okk == okp == 1
    assert all(torch.equal(gk[c], gp[c]) for c in gk)
    assert torch.equal(misses.to(torch.int64), _links_misses(scans, cb))


@pytest.mark.parametrize("seed", range(3))
def test_ac_first_spec_redesign_damaged_and_cut(cuda, seed):
    """Random bytes written into one image's scans and another's cut short
    (fewer blocks than its valid grid): K21's one call and its plain
    version agree on the store and ok (cleared), at 2- and 16-byte
    chunks."""
    from _torch_jpeg import synth_progressive

    rng = np.random.default_rng(seed)

    def damage(flat, starts, ends):
        lo, hi = starts[1] // 8, ends[1] // 8
        flat[rng.integers(lo, hi, 4)] = rng.integers(0, 256, 4, dtype=np.uint8)
        mid = (starts[2] + ends[2]) // 16  # image 2 ends half way: zeros on
        flat[mid : ends[2] // 8] = 0
        ends[2] = mid * 8
        return flat

    datas = [synth_progressive(96, 64, "420", phase=0.2)] * 3
    for cb in (2, 16):
        scans = _prog_ac_scans(datas, cb, damage=damage)
        (gk, okk, misses), (gp, okp, _) = _ac_group_both(cuda, scans, cb, seed)
        assert okk == okp == 0
        assert all(torch.equal(gk[c], gp[c]) for c in gk)
        assert torch.equal(misses.to(torch.int64), _links_misses(scans, cb))


def test_ac_first_spec_redesign_chunk_overflow(cuda):
    """A 1-bit EOB code and a stream of zero bits: 8 finished blocks a
    1-byte chunk, more than 4 * chunk_bytes, so ok is cleared by both the
    kernel and its plain version; an EOB run coded by hand over the same
    grid keeps ok."""
    import _torch_prog as tp

    from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
    from zpix_tpu_torch.ops import prog_spec as ps

    counts, syms = [1, 1, 1] + [0] * 13, [0x00, 0x01, 0x11]
    t = HuffTable()
    t.build(counts, bytes(syms))
    tab = ke.pack_tables([t], [], [0])
    streams = [np.zeros(12, np.uint8)] * 2  # 96 EOBs an image: 9 x 10 valid blocks
    flat, starts, ends, F = ps.stack_spec(streams, 1)
    res = []
    for dev in (cuda, torch.device("cpu")):
        grid = torch.ones(2, 10, 11, 64, dtype=torch.int32, device=dev)
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        ps.ac_first_spec_group([ps.AcScan(*(torch.from_numpy(a).to(dev) for a in
                                            (flat, starts, ends, tab)), grid, (9, 10), 1, 63, 0,
                                          F)], ok, chunk_bytes=1)
        res.append((grid.cpu(), int(ok)))
    assert res[0][1] == res[1][1] == 0 and torch.equal(res[0][0], res[1][0])
    cases = [tp.spec_ac_scan(9 + b, nvy=9, nvx=10, runs=0.9) for b in range(2)]
    arrays, F = _hand_inputs(cases, 8)
    (gk, okk, _), (gp, okp, _) = _ac_group_both(
        cuda, [(_Band(1, 63, 1, (0,)), (arrays, F, (9, 10)), 0, (2, 10, 11, 64))], 8)
    assert okk == okp == 1 and torch.equal(gk[0], gp[0])
    want = np.ones((2, 10, 11, 64), np.int64)  # gk and gp started from one random store
    assert not np.array_equal(gk[0].numpy(), want)


class _Band:
    """A hand-coded scan's band, Al and component, as a ProgScan gives them."""

    def __init__(self, ss, se, al, comps):
        self.ss, self.se, self.al, self.comps = ss, se, al, comps


def _hand_inputs(cases, cb):
    from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
    from zpix_tpu_torch.ops import prog_spec as ps

    huffs = []
    for counts, syms in cases[0]["huffs"]:
        t = HuffTable()
        t.build(list(counts), bytes(syms))
        huffs.append(t)
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    return [flat, starts, ends, ke.pack_tables(huffs, [], [0])], F


def test_ac_first_spec_redesign_tail_group(cuda):
    """The moved Cb scan's batch: the spec prefix holds 3 AC-first scans,
    decoded by one K21 call equal to its plain version; the spec route
    then launches K21 once and K22 once."""
    from _torch_jpeg import move_scan, port_host_pixels, synth_progressive

    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.ops import prog_spec as ps

    data = synth_progressive(200, 120, "420", phase=0.7)
    moved = [move_scan(data, 3, 5)] * 2
    scans = _prog_ac_scans(moved, 64, prefix_only=True)
    assert len(scans) == 3
    (gk, okk, misses), (gp, okp, _) = _ac_group_both(cuda, scans, 64)
    assert okk == okp == 1 and all(torch.equal(gk[c], gp[c]) for c in gk)
    assert torch.equal(misses.to(torch.int64), _links_misses(scans, 64))
    runtime.reset_launches()
    px, ok = OnchipProgressiveDecoder(device=cuda, impl="spec").decode(moved)
    assert bool(ok) and runtime.LAUNCHES["ac_first_spec"] == ps.AC_FIRST_KERNELS
    assert runtime.LAUNCHES["delta_add"] == 1
    assert np.array_equal(px[0].cpu().numpy(), port_host_pixels(moved[0]))


def test_delta_add_segments_matches_scatter_add(cuda):
    """K22 over several updates in one launch against scatter_add_ an update
    in turn: two updates of one store hitting the same coefficients, an
    empty update, k not a multiple of 4, indices and values at offsets that
    are and are not 16-byte aligned (alike and unlike), padding pairs,
    int32 wrapping."""
    from zpix_tpu_torch.ops import prog_spec as ps

    rng = np.random.default_rng(22)
    B, N = 5, 200_000
    stores = [rng.integers(-2**31, 2**31, (B, N)).astype(np.int32) for _ in range(2)]
    pool = rng.integers(-2**31, 2**31, 4 * 1_000_000).astype(np.int32)
    pairs, off = [], 0
    for k, shift in ((1001, 1), (4096 * 2 + 3, 0), (0, 0), (7, 2), (30_000, 3), (5, 0)):
        idx = np.zeros((B, k), np.int32)
        for b in range(B):
            n = int(rng.integers(0, k + 1))
            idx[b, :n] = rng.choice(N // 4, n, replace=False)  # a quarter: many repeats
        val = np.where(idx != 0, pool[off : off + B * k].reshape(B, k), 0).astype(np.int32)
        off += B * k
        pairs.append((idx, val, shift))
    targets = [0, 1, 0, 1, 0, 0]
    buf_i = np.zeros(sum(B * k for (i, _, _) in pairs for k in [i.shape[1]]) + 64, np.int32)
    buf_v = np.zeros_like(buf_i)
    for dev in (torch.device("cpu"), cuda):
        st = [torch.from_numpy(s.copy()).to(dev) for s in stores]
        bi, bv = torch.from_numpy(buf_i).to(dev), torch.from_numpy(buf_v).to(dev)
        ups, at = [], 0
        for (idx, val, shift), tgt in zip(pairs, targets):
            n = idx.size
            ti = bi[at + shift : at + shift + n]
            tv = bv[at + (shift * 3 % 4) : at + (shift * 3 % 4) + n]
            ti.copy_(torch.from_numpy(idx.reshape(-1)))
            tv.copy_(torch.from_numpy(val.reshape(-1)))
            ups.append((st[tgt], ti.view(idx.shape), tv.view(val.shape)))
            at += n + 8
        before = runtime.LAUNCHES["delta_add"]
        ps.delta_add_segments(ups)
        assert runtime.LAUNCHES["delta_add"] == before + (dev.type == "cuda")
        if dev.type == "cpu":
            want = [s.clone() for s in st]
        else:
            assert all(torch.equal(a.cpu(), b) for a, b in zip(st, want))
