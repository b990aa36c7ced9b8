"""The port's progressive host half against zpix_tpu's: the three C++ index
walks (the port's copy in zpix_tpu_torch/csrc/host against zpix_tpu's
build) on the same streams, and ``prep`` against zpix_tpu's
OnchipProgressiveDecoder.prep (which compiles nothing), the valid-block
and MCU-order maps against zpix_tpu's.  Exact: tolerance 0.  Inputs from
Pillow ``progressive=True`` (libjpeg's standard script)."""

import ctypes

import numpy as np
import pytest
import torch
from _torch_jpeg import jax_native_lib, synth_progressive

from zpix_tpu import runtime as jrt
from zpix_tpu.parallel import progressive_onchip as jpo
from zpix_tpu_torch.ops import progressive as kp
from zpix_tpu_torch.parallel import progressive_onchip as tpo
from zpix_tpu_torch.runtime import host

MODES = ["gray", "444", "422", "420"]
SIZES = [(64, 48), (37, 29)]
_KW = dict(chunk_bytes=16, k1=4, k2=4, W=4)


def _walk_script(lib, huff_cls, ptr, plan, stream_of=None):
    """Walk every scan of one image with ``lib``'s index walks, masks and
    EOB runs carried in script order -> per scan a dict of outputs."""
    stream_of = stream_of or (lambda s: s.stream)
    masks, eob_run, out = {}, 0, []
    for sc in plan.scans:
        if sc.kind == "dc_refine":
            out.append({})
            continue
        st = np.concatenate([stream_of(sc), np.zeros(8, np.uint8)])
        endb = ctypes.c_int64(0)
        if sc.kind == "dc_first":
            tabs, tids, nblk = tpo._dc_scan_geom(plan, sc)
            arr = (huff_cls * len(tabs))()
            for ct, t in zip(arr, tabs):
                ct.min_codes[:], ct.max_codes[:] = t.min_codes, t.max_codes
                ct.vals_indices[:], ct.vals[:], ct.num_codes = t.vals_indices, t.vals, t.num_codes
            tids = np.asarray(tids, np.int32)
            ends = np.zeros(nblk, np.int32)
            rc = lib.zpix_prog_dc_first_index(ptr(st, ctypes.c_uint8), len(st) - 8, arr,
                                              ptr(tids, ctypes.c_int32), len(tids), nblk,
                                              ptr(ends, ctypes.c_int32), ctypes.byref(endb))
            out.append(dict(rc=rc, ends=ends, endb=endb.value))
            continue
        t = sc.huffs[(1, sc.ta[0])]
        tab = huff_cls()
        tab.min_codes[:], tab.max_codes[:] = t.min_codes, t.max_codes
        tab.vals_indices[:], tab.vals[:], tab.num_codes = t.vals_indices, t.vals, t.num_codes
        c = sc.comps[0]
        nv = int(np.prod(tpo.valid_grid(plan, c)))
        m = masks.setdefault(c, np.zeros((nv, 64), np.uint8))
        a, b = np.zeros(nv, np.int32), np.zeros(nv, np.int32)
        f = np.zeros(nv, np.uint8)
        if sc.kind == "ac_first":
            rc = lib.zpix_prog_ac_first_index(
                ptr(st, ctypes.c_uint8), len(st) - 8, ctypes.byref(tab), sc.ss, sc.se, nv,
                ptr(a, ctypes.c_int32), ptr(b, ctypes.c_int32), ptr(f, ctypes.c_uint8),
                ptr(m, ctypes.c_uint8), ctypes.byref(endb))
            out.append(dict(rc=rc, starts=a, ends=b, hasdata=f, masks=m.copy(),
                            endb=endb.value))
        else:
            ero = ctypes.c_uint16(0)
            rc = lib.zpix_prog_refine_index(
                ptr(st, ctypes.c_uint8), len(st) - 8, ctypes.byref(tab), ptr(m, ctypes.c_uint8),
                nv, sc.ss, sc.se, eob_run, ptr(a, ctypes.c_int32), ptr(f, ctypes.c_uint8),
                ctypes.byref(ero), ctypes.byref(endb))
            eob_run = ero.value
            out.append(dict(rc=rc, starts=a, eob=f, masks=m.copy(), eob_run=eob_run,
                            endb=endb.value))
        if rc:
            break
    return out


def _both_walks(plan, stream_of=None):
    jlib = jax_native_lib()
    port = _walk_script(host.lib(), host.HuffTableC, lambda a, t: a.ctypes.data, plan,
                        stream_of)
    ref = _walk_script(jlib, jrt.HuffTableC, lambda a, t: a.ctypes.data_as(ctypes.POINTER(t)),
                       plan, stream_of)
    return port, ref


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
        for k in p:
            assert np.array_equal(p[k], r[k]), k


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_index_walks_match_zpix_tpu(mode, w, h):
    port, ref = _both_walks(tpo.parse_progressive(synth_progressive(w, h, mode)))
    _assert_same(port, ref)
    assert all(p.get("rc", 0) == 0 for p in port)


@pytest.mark.parametrize("seed", range(4))
def test_index_walks_match_on_damaged_streams(seed):
    """Random bytes written into every scan: the two builds give the same
    return codes and the same outputs up to the first refusal."""
    rng = np.random.default_rng(seed)

    def damaged(sc):
        s = sc.stream.copy()
        at = rng.integers(0, len(s), 3)
        s[at] = rng.integers(0, 256, 3, dtype=np.uint8)
        return s

    plan = tpo.parse_progressive(synth_progressive(64, 48, "420", phase=seed))
    streams = {id(sc): damaged(sc) for sc in plan.scans}
    port, ref = _both_walks(plan, stream_of=lambda sc: streams[id(sc)])
    _assert_same(port, ref)
    assert any(p.get("rc", 0) for p in port)  # the damage reaches a refusal


@pytest.mark.parametrize("ss,se", [(1, 255), (0, 5), (6, 5), (1, 64)])
def test_index_walks_refuse_a_band_outside_the_block(ss, se):
    """The AC walks index each block's 64 mask bytes by the band: one
    outside 1..63 is refused with ERR_FORMAT and nothing is written."""
    plan = tpo.parse_progressive(synth_progressive(64, 48, "gray"))
    sc = next(s for s in plan.scans if s.kind == "ac_first")
    lib = host.lib()
    tab = tpo._huff_c([sc.huffs[(1, sc.ta[0])]])
    st = np.concatenate([sc.stream, np.zeros(8, np.uint8)])
    nv = int(np.prod(tpo.valid_grid(plan, 0)))
    m = np.zeros(nv * 64 + 256, np.uint8)  # a guard past the masks
    a, b, f = np.zeros(nv, np.int32), np.zeros(nv, np.int32), np.zeros(nv, np.uint8)
    endb, ero = ctypes.c_int64(0), ctypes.c_uint16(0)
    rc = lib.zpix_prog_ac_first_index(st.ctypes.data, len(sc.stream), tab, ss, se, nv,
                                      a.ctypes.data, b.ctypes.data, f.ctypes.data,
                                      m.ctypes.data, ctypes.byref(endb))
    assert rc == host.ERR_FORMAT
    rc = lib.zpix_prog_refine_index(st.ctypes.data, len(sc.stream), tab, m.ctypes.data, nv,
                                    ss, se, 0, a.ctypes.data, f.ctypes.data,
                                    ctypes.byref(ero), ctypes.byref(endb))
    assert rc == host.ERR_FORMAT
    assert not m.any() and not f.any()


def _le32(packed, off, n):
    return packed[off : off + 4 * n].view("<i4")


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_prep_matches_zpix_tpu_prep(mode, w, h):
    """Every scan's offsets, flags and bit rows, relative to each image's
    start in the stacked stream, equal zpix_tpu's host-index prep; so do
    the quant rows."""
    jax_native_lib()
    datas = [synth_progressive(w, h, mode)] * 2
    B = len(datas)
    want = jpo.OnchipProgressiveDecoder(**_KW).prep(datas)
    got = tpo.OnchipProgressiveDecoder(device="cpu").prep(datas)
    assert got.okh and want["okh"] and got.failure is None
    assert len(got.scans) == len(want["preps"])
    for si, sc in enumerate(got.scans):
        _, meta = want["preps"][si]
        pk = meta["packed"]
        if sc.kind == "dc_refine":
            assert np.array_equal(sc.stream, pk.reshape(B, meta["rowlen"]))
            continue
        cap = meta["cap"]
        n = sc.starts.shape[0]

        def rel(a):
            a = a.reshape(B, -1).astype(np.int64)
            return a - a[:, :1]

        assert np.array_equal(rel(sc.starts), rel(_le32(pk, cap, n)))
        assert np.array_equal(rel(sc.ends), rel(_le32(pk, cap + 4 * n, n)))
        if sc.flags is not None:
            assert np.array_equal(sc.flags, _le32(pk, cap + 8 * n, n))
        # each image's stream bytes, at its own offset in each layout
        first = sc.starts.reshape(B, -1)[:, 0] // 8
        jfirst = _le32(pk, cap, n).reshape(B, -1)[:, 0] // 8
        for b in range(B):
            ln = len(tpo.parse_progressive(datas[b]).scans[si].stream)
            assert np.array_equal(sc.stream[first[b] : first[b] + ln],
                                  pk[jfirst[b] : jfirst[b] + ln])
    q = want["sup"][want["q_off"] : want["q_off"] + got.quants.nbytes].view("<i4")
    assert np.array_equal(got.quants.reshape(-1), q)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_block_maps_match_zpix_tpu(mode, w, h):
    """valid_grid is zpix_tpu's _valid_idx as a corner, and the plain store
    visits an interleaved scan's blocks in _mcu_grid_idx's order."""
    plan = tpo.parse_progressive(synth_progressive(w, h, mode))
    jdec = jpo.OnchipProgressiveDecoder(**_KW)
    for c in range(plan.ncomp):
        nvy, nvx = tpo.valid_grid(plan, c)
        bh = plan.mxx * plan.hv[c][0]
        corner = (np.arange(nvy)[:, None] * bh + np.arange(nvx)[None, :]).reshape(-1)
        assert np.array_equal(corner, jdec._valid_idx(plan, c))
    for c in range(plan.ncomp):  # a single-component scan: its valid blocks
        h, v = plan.hv[c]
        g = torch.zeros(1, plan.myy * v, plan.mxx * h, 64, dtype=torch.int32)
        vidx = jdec._valid_idx(plan, c)
        nv = len(vidx)
        kp.store_blocks_plain(torch.arange(1, nv + 1, dtype=torch.int32), [g], hv=[(h, v)],
                              valid=tpo.valid_grid(plan, c), al=0, mode="set")
        flat = g[0, ..., 0].reshape(-1).numpy()
        assert np.array_equal(flat[vidx], np.arange(1, nv + 1))
        assert flat.sum() == nv * (nv + 1) // 2
    if plan.ncomp == 1:
        return
    comps = tuple(range(plan.ncomp))  # interleaved: every block, (MCU, slot) order
    hv = [plan.hv[c] for c in comps]
    grids = [torch.zeros(1, plan.myy * v, plan.mxx * h, 64, dtype=torch.int32) for h, v in hv]
    n_mcu = plan.mxx * plan.myy
    nblk = n_mcu * sum(h * v for h, v in hv)
    kp.store_blocks_plain(torch.arange(1, nblk + 1, dtype=torch.int32), grids, hv=hv,
                          valid=None, al=0, mode="set")
    per_mcu = np.concatenate([g[0, ..., 0].reshape(-1).numpy()[idx].reshape(n_mcu, -1)
                              for g, idx in zip(grids, jdec._mcu_grid_idx(plan, comps))], 1)
    assert np.array_equal(per_mcu.reshape(-1), np.arange(1, nblk + 1))


def test_prep_repeat_stress():
    """Repeated preps of one batch on more walker threads than cores, with a
    short switch interval: the walks share each scan's Huffman tables
    (their 16-bit lookup table is built lazily under a lock), and every
    prep must give the same arrays."""
    import sys

    datas = [synth_progressive(64, 48, "420")] * 8
    dec = tpo.OnchipProgressiveDecoder(device="cpu", n_threads=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        preps = [dec.prep(datas) for _ in range(6)]
    finally:
        sys.setswitchinterval(old)
        dec.close()
    for p in preps:
        assert p.okh and p.failure is None
        for a, b in zip(p.scans, preps[0].scans):
            for x, y in zip(a.arrays(), b.arrays()):
                assert np.array_equal(x, y)
