"""The port's OnchipProgressiveDecoder and K8-K11 on the CPU (the kernels'
plain versions) against zpix_tpu and the host decoder.  Exact: tolerance
0.  Inputs from Pillow ``progressive=True`` (libjpeg's standard script,
which runs every scan kind); Pillow gives every image its own Huffman
tables, so a batch repeats one image.

* K8-K10's plain versions, fed zpix_tpu's own prep arrays through
  ``ScanPrep.from_arrays``, against zpix_tpu's value-pass builders
  (jitted, small unrolls), on every scan of two images; K11 against the
  "dcr" arm of zpix_tpu's ``_make_update``.
* The store after each scan prefix against the host Decoder's
  coefficients after as many scans.
* Pixels against the host decoder for every mode and size, and against
  zpix_tpu's OnchipProgressiveDecoder once (its fused program compiles
  for each distinct image, ~25 s on XLA:CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jpeg import host_coeffs, host_pixels, jax_native_lib, synth_progressive

from zpix_tpu.parallel import progressive_onchip as jpo
from zpix_tpu.parallel.device_entropy import CmpTables
from zpix_tpu_torch import OnchipProgressiveDecoder
from zpix_tpu_torch.errors import UnsupportedError
from zpix_tpu_torch.ops import planes as kpl
from zpix_tpu_torch.ops import progressive as kp
from zpix_tpu_torch.parallel import progressive_onchip as tpo

MODES = ["gray", "444", "422", "420"]
SIZES = [(64, 48), (37, 29)]
_KW = dict(chunk_bytes=16, k1=4, k2=4, W=4)  # small unrolls for XLA:CPU


def _cpu():
    return OnchipProgressiveDecoder(device="cpu", n_threads=2)


def _counts_vals(t):
    counts = [t.max_codes[i] - t.min_codes[i] + 1 if t.max_codes[i] >= 0 else 0
              for i in range(16)]
    return counts, t.vals[: t.num_codes]


def _le32(packed, off, n):
    return packed[off : off + 4 * n].view("<i4")


def _scan_from_jax(sc, meta, B):
    """The port's ScanPrep from zpix_tpu's packed prep row of one scan."""
    pk = meta["packed"]
    if meta["kind"] == "dcr":
        return tpo.ScanPrep.from_arrays("dc_refine", comps=sc.comps, ss=0, se=0, al=sc.al,
                                        stream=pk.reshape(B, meta["rowlen"]))
    cap = meta["cap"]
    n = (len(pk) - cap) // (8 if meta["kind"] == "dc" else 12)
    arrays = dict(stream=pk[:cap], starts=_le32(pk, cap, n), ends=_le32(pk, cap + 4 * n, n))
    if meta["kind"] == "dc":
        order = []
        for td in sc.td:
            if (0, td) not in order:
                order.append((0, td))
        return tpo.ScanPrep.from_arrays(
            "dc_first", comps=sc.comps, ss=0, se=0, al=sc.al, **arrays,
            huffs=[_counts_vals(sc.huffs[kk]) for kk in order],
            tid_of_slot=meta["tid_of_slot"])
    return tpo.ScanPrep.from_arrays(
        sc.kind, comps=sc.comps, ss=sc.ss, se=sc.se, al=sc.al, **arrays,
        flags=_le32(pk, cap + 8 * n, n), huffs=[_counts_vals(meta["huff"])])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode,w,h", [("420", 64, 48), ("gray", 37, 29)])
def test_value_passes_match_jax_builders(mode, w, h):
    """Every scan of a batch of two: the port's plain K8-K11 on zpix_tpu's
    prep arrays give zpix_tpu's values and ok; K10 starts from the host
    decoder's store before its scan, K9 from zeros."""
    _value_passes_vs_jax(synth_progressive(w, h, mode))


@pytest.mark.parametrize("mode,quality", [("420", 90), ("444", 75), ("444", 90)])
def test_refine_passes_match_jax_builders(mode, quality):
    """K10's plain version against zpix_tpu's build_ac_refine_fn on every
    refinement scan at q90 (more correction bits) and on 4:4:4."""
    _value_passes_vs_jax(synth_progressive(48, 40, mode, phase=0.2, quality=quality),
                         kinds=("ac_refine",))


def _value_passes_vs_jax(data, kinds=None):
    jax_native_lib()
    B = 2
    jdec = jpo.OnchipProgressiveDecoder(**_KW)
    pr = jdec.prep([data] * B)
    plan = tpo.parse_progressive(data)
    for si, sc in enumerate(plan.scans):
        if kinds is not None and sc.kind not in kinds:
            continue
        ri, meta = pr["preps"][si]
        port = _scan_from_jax(sc, meta, B)
        ok = torch.ones(1, dtype=torch.int32)
        before = [np.stack([g] * B) for g in host_coeffs(data, si)]
        c = sc.comps[0]
        valid = tpo.valid_grid(plan, c)
        if sc.kind == "dc_first":
            want, want_ok = jpo.build_dc_first_value_fn(
                batch=B, nblk=meta["nblk"], cap=meta["cap"], cmp=meta["cmp"],
                tid_of_slot=meta["tid_of_slot"], W=4)(meta["packed"])
            got = kp.dc_first_values_plain(_t(port.stream), _t(port.starts), _t(port.ends),
                                           _t(port.tables), ok, bpm=len(meta["tid_of_slot"]))
            assert np.array_equal(got.numpy(), np.asarray(want).reshape(-1))
        elif sc.kind == "dc_refine":
            upd = jdec._make_update(si, ri, dict(meta, off=0), B, jnp)
            state = [jnp.asarray(g.reshape(B, -1)) for g in before]
            sup = np.concatenate([meta["packed"], np.zeros(64, np.uint8)])
            want_state, want_ok = upd(jnp.asarray(sup), state)
            grids = [_t(g) for g in before]
            kp.dc_refine(_t(port.stream), [grids[k] for k in sc.comps],
                         hv=[plan.hv[k] for k in sc.comps], valid=valid, al=sc.al)
            for g, ws in zip(grids, want_state):
                assert np.array_equal(g.numpy().reshape(B, -1), np.asarray(ws))
        else:
            nvy, nvx = valid
            bh = plan.mxx * plan.hv[c][0]
            vidx = (np.arange(nvy)[:, None] * bh + np.arange(nvx)[None, :]).reshape(-1)
            rows = before[c].reshape(B, -1, 64)[:, vidx]
            grid = _t(before[c])
            args = (_t(port.stream), _t(port.starts), _t(port.ends), _t(port.flags),
                    _t(port.tables), ok, grid)
            kw = dict(valid=valid, ss=sc.ss, se=sc.se, al=sc.al)
            cmp = CmpTables([meta["huff"]])
            if sc.kind == "ac_first":
                curT, want_ok = jpo.build_ac_first_value_fn(
                    batch=B, nvalid=len(vidx), cap=meta["cap"], cmp=cmp, ss=sc.ss, se=sc.se,
                    k2=4, W=4)(meta["packed"])
                want = rows + (np.asarray(curT).T.reshape(rows.shape) << sc.al)
                kp.ac_first_plain(*args, **kw)
            else:
                curT = rows.reshape(-1, 64).T.copy()
                deltaT, want_ok = jpo.build_ac_refine_fn(
                    batch=B, nvalid=len(vidx), cap=meta["cap"], cmp=cmp, ss=sc.ss, se=sc.se,
                    al=sc.al, k_pos=4, W=4)(meta["packed"], curT)
                want = rows + np.asarray(deltaT).T.reshape(rows.shape)
                kp.ac_refine_plain(*args, **kw)
            assert np.array_equal(grid.numpy().reshape(B, -1, 64)[:, vidx], want)
        assert bool(want_ok) and int(ok) == 1, (si, sc.kind)


@pytest.mark.parametrize("mode,quality", [("420", 50), ("420", 90), ("444", 25), ("gray", 75)])
def test_refine_lut_matches_decode_on_every_lookahead(mode, quality):
    """K10's lookahead table (refine_lut_plain, the copy of the kernel's
    builder) for the AC table of every refinement scan of a Pillow image:
    on all 65,536 16-bit lookaheads an entry that is not 0 gives the
    limit-compare decode's length and symbol, or its invalid code."""
    from zpix_tpu_torch.ops.entropy import _Tables

    prep = _cpu().prep([synth_progressive(64, 48, mode, phase=0.5, quality=quality)])
    look = torch.arange(1 << 16, dtype=torch.int64)
    n = 0
    for sc in prep.scans:
        if sc.kind != "ac_refine":
            continue
        tables = _t(sc.tables)
        tab = _Tables(tables)
        ln, sym, bad = tab.decode(look, tab.slot_ac[torch.zeros_like(look)])
        e = kp.refine_lut_plain(tables).to(torch.int64)[look >> (16 - kp.LUT_BITS)]
        inv = e == kp.LUT_BAD
        one = (e != 0) & ~inv
        assert bool(bad[inv].all()) and not bool(bad[one].any())
        assert torch.equal(e[one] >> 8, ln[one]) and torch.equal(e[one] & 255, sym[one])
        n += 1
        assert float(one.double().mean()) > 0.9  # most lookaheads take one lookup
    assert n >= 1


def test_fast_div_matches_floor_division():
    """The kernels' multiply-high division (ops/progressive.py::fast_div, the
    pair csrc/prog_entropy.cu's FastDiv applies) equals // for divisors 1 to
    3,000, powers of two, odd widths and the ends of the range, on 0..4,999,
    random numerators below 2^31 and the values around each multiple."""
    rng = np.random.default_rng(3)
    ds = list(range(1, 3001)) + [1 << k for k in range(31)] + [(1 << 31) - 1, 2**30 + 1]
    ds += [int(d) for d in rng.integers(1, 1 << 31, 500)]
    for d in ds:
        magic, shift = kp.fast_div(d)
        n = np.concatenate([np.arange(5000), rng.integers(0, 1 << 31, 2000),
                            [d - 1, d, d + 1, 2 * d - 1, 2 * d, (1 << 31) - 1]]).astype(np.uint64)
        n = n[n < 1 << 31]
        q = (((n * np.uint64(magic & 0xFFFFFFFF)) >> np.uint64(32)) + n) >> np.uint64(shift)
        assert np.array_equal(q, n // np.uint64(d)), d
    with pytest.raises(ValueError):
        kp.fast_div(0)


@pytest.mark.parametrize("mode", MODES)
def test_dc_lut_matches_decode_on_every_lookahead(mode):
    """K8's lookahead tables (lut_plain, the copy of the kernels' builder)
    for each DC table the slot map of the DC-first scan names: on all
    65,536 16-bit lookaheads an entry that is not 0 gives the
    limit-compare decode's length and symbol, or its invalid code."""
    from zpix_tpu_torch.ops.entropy import MAX_SLOTS, _Tables

    prep = _cpu().prep([synth_progressive(64, 48, mode, phase=0.6, quality=60)])
    sc = next(s for s in prep.scans if s.kind == "dc_first")
    tables = _t(sc.tables)
    tab = _Tables(tables)
    bpm = sum(h * v for h, v in prep.hv) if len(sc.comps) > 1 else 1
    tids = sorted({int(t) for t in tab.slot_dc[:bpm]})
    assert len(tids) == (1 if mode == "gray" else 2) and bpm <= MAX_SLOTS
    look = torch.arange(1 << 16, dtype=torch.int64)
    for tid in tids:
        ln, sym, bad = tab.decode(look, torch.full_like(look, tid))
        e = kp.lut_plain(tables, tid).to(torch.int64)[look >> (16 - kp.LUT_BITS)]
        inv = e == kp.LUT_BAD
        one = (e != 0) & ~inv
        assert bool(bad[inv].all()) and not bool(bad[one].any())
        assert torch.equal(e[one] >> 8, ln[one]) and torch.equal(e[one] & 255, sym[one])
        assert float(one.double().mean()) > 0.5
    assert torch.equal(kp.refine_lut_plain(tables), kp.lut_plain(tables, int(tab.slot_ac[0])))


@pytest.mark.parametrize("mode,w,h", [("420", 199, 45), ("420", 301, 37), ("422", 301, 37),
                                      ("444", 199, 45), ("gray", 199, 45), ("gray", 301, 37)])
def test_first_scans_match_jax_update(mode, w, h):
    """K8's and K9's plain versions, store and ok, against zpix_tpu's
    update of the same scan (its value-pass builder and the "dc" or "ac"
    arm of ``_make_update``) at widths and heights that leave partial
    MCUs, from the host decoder's store before the scan."""
    jax_native_lib()
    B = 2
    data = synth_progressive(w, h, mode, phase=0.9)
    jdec = jpo.OnchipProgressiveDecoder(**_KW)
    pr = jdec.prep([data] * B)
    plan = tpo.parse_progressive(data)
    n = 0
    for si, sc in enumerate(plan.scans):
        if sc.kind not in ("dc_first", "ac_first"):
            continue
        ri, meta = pr["preps"][si]
        port = _scan_from_jax(sc, meta, B)
        before = [np.stack([g] * B) for g in host_coeffs(data, si)]
        upd = jdec._make_update(si, ri, dict(meta, off=0), B, jnp)
        sup = np.concatenate([meta["packed"], np.zeros(64, np.uint8)])
        want, want_ok = upd(jnp.asarray(sup), [jnp.asarray(g.reshape(B, -1)) for g in before])
        grids = [_t(g) for g in before]
        ok = torch.ones(1, dtype=torch.int32)
        valid = tpo.valid_grid(plan, sc.comps[0])
        if sc.kind == "dc_first":
            kp.dc_first(_t(port.stream), _t(port.starts), _t(port.ends), _t(port.tables), ok,
                        [grids[k] for k in sc.comps], hv=[plan.hv[k] for k in sc.comps],
                        valid=valid, al=sc.al)
        else:
            kp.ac_first(_t(port.stream), _t(port.starts), _t(port.ends), _t(port.flags),
                        _t(port.tables), ok, grids[sc.comps[0]], valid=valid, ss=sc.ss,
                        se=sc.se, al=sc.al)
        for g, ws in zip(grids, want):
            assert np.array_equal(g.numpy().reshape(B, -1), np.asarray(ws)), (si, sc.kind)
        assert bool(want_ok) and int(ok) == 1, (si, sc.kind)
        n += 1
    assert n == (3 if mode == "gray" else 5)  # libjpeg's script: one DC first, AC firsts


AC_FIRST_CASES = {  # name -> _torch_prog.ac_first_scan's arguments
    "band_1_5": dict(ss=1, se=5, al=2), "band_6_63": dict(ss=6, se=63, al=2),
    "band_1_63_al0": dict(ss=1, se=63, al=0), "one_position": dict(ss=9, se=9, al=13),
    "zrl_heavy": dict(ss=1, se=63, al=1, zrl=0.5, overflow=0.1),
    "no_eob_bits": dict(ss=1, se=40, al=1, eob_run_bits=False, covered=0.0),
    "band_store": dict(ss=1, se=63, al=1, store="band", nvy=9, nvx=33, bv=10, bh=34),
}


@pytest.mark.parametrize("case", list(AC_FIRST_CASES))
def test_ac_first_plain_on_hand_coded_scans(case):
    """K9's plain version on hand-coded scans (ZRL, EOB runs with their
    bits, the overflow rule, bands ending on a value, codes past the
    9-bit lookahead) adds exactly the coded values, shifted, into a store
    that already holds values, and keeps ok."""
    from _torch_prog import ac_first_scan

    sc = ac_first_scan(7, **AC_FIRST_CASES[case])
    p = sc["prep"]
    assert sc["symbols"] > 300 and sc["eob_runs"] + sc["zrl"] + sc["band_ends"] > 0
    grid, ok = _t(sc["grid"]), torch.ones(1, dtype=torch.int32)
    kp.ac_first(_t(p.stream), _t(p.starts), _t(p.ends), _t(p.flags), _t(p.tables), ok, grid,
                valid=sc["valid"], ss=p.ss, se=p.se, al=p.al)
    assert int(ok) == 1 and np.array_equal(grid.numpy(), sc["want"])


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_store_after_each_scan_matches_host_decoder(mode, w, h):
    data = synth_progressive(w, h, mode, phase=0.3)
    dec = _cpu()
    prep = dec.prep([data, data])
    for n in range(len(prep.scans) + 1):
        grids, ok = dec.decode_coefficients(dataclasses.replace(prep, scans=prep.scans[:n]))
        assert int(ok) == 1
        for g, want in zip(grids, host_coeffs(data, n)):
            assert np.array_equal(g[0].numpy(), want) and np.array_equal(g[1].numpy(), want)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_decode_matches_host_decoder(mode, w, h):
    data = synth_progressive(w, h, mode, phase=0.7)
    px, ok = _cpu().decode([data] * 3)
    assert bool(ok) and px.dtype == torch.uint8
    want = host_pixels(data)
    assert px.shape == (3,) + want.shape
    for i in range(3):
        assert np.array_equal(px[i].numpy(), want)


def test_decode_matches_zpix_tpu():
    jax_native_lib()
    data = synth_progressive(64, 48, "420")
    want, want_ok = jpo.OnchipProgressiveDecoder(**_KW).decode([data, data])
    got, ok = _cpu().decode([data, data])
    assert bool(want_ok) and bool(ok)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["distinct_tables", "baseline", "restarts", "cmyk"])
def test_unsupported_batches_raise(case):
    import io

    from PIL import Image

    if case == "distinct_tables":
        datas = [synth_progressive(phase=0.0), synth_progressive(phase=1.0)]
    elif case == "baseline":
        buf = io.BytesIO()
        Image.new("RGB", (32, 16), (10, 200, 30)).save(buf, format="JPEG")
        datas = [buf.getvalue()]
    elif case == "restarts":
        datas = [synth_progressive(restart_marker_blocks=2)]
    else:
        buf = io.BytesIO()
        Image.new("CMYK", (32, 16), (10, 200, 30, 4)).save(buf, format="JPEG",
                                                          progressive=True)
        datas = [buf.getvalue()]
    with pytest.raises(UnsupportedError):
        _cpu().decode(datas)


def _patch_sos(data: bytes, n: int, field: str, value: int) -> bytes:
    """Set one header field of the n-th SOS segment (0-based): "cs" (its
    first component id), "tables" (its first Td/Ta byte), "ss", "se" or
    "ahal"."""
    out = bytearray(data)
    at = -1
    for _ in range(n + 1):
        at = out.find(b"\xff\xda", at + 1)
    ns = out[at + 4]
    base = at + 5 + 2 * ns
    pos = {"cs": at + 5, "tables": at + 6, "ss": base, "se": base + 1, "ahal": base + 2}[field]
    out[pos] = value
    return bytes(out)


# Pillow's script: SOS 0 is the DC-first scan, SOS 1 AC first Y 1-5.
@pytest.mark.parametrize("n,field,value", [
    (1, "se", 0xFF), (1, "ss", 6), (0, "se", 5), (1, "ahal", 0xE0), (1, "ahal", 0x0E),
    (1, "cs", 0x77), (0, "cs", 0x77), (1, "tables", 0x33), (0, "tables", 0x33),
], ids=["se_ff", "ss_gt_se", "dc_band", "ah_14", "al_14", "ac_unknown_comp",
        "dc_unknown_comp", "ac_missing_table", "dc_missing_table"])
def test_malformed_scan_header_raises_format_error(n, field, value):
    """A scan header the index walks could not hold to (a band past the
    block's 64 coefficients, an unknown component, an undefined table)
    raises FormatError in prep, before any walk runs."""
    from zpix_tpu_torch.errors import FormatError

    data = _patch_sos(synth_progressive(64, 48, "420"), n, field, value)
    with pytest.raises(FormatError):
        tpo.parse_progressive(data)
    with pytest.raises(FormatError):
        _cpu().decode([data, data])


def _corrupt_first_scan(data: bytes) -> bytes:
    """Flip bits inside the first scan's entropy data, never making or
    breaking a marker byte (as tests/test_progressive_onchip.py does)."""
    data = bytearray(data)
    sos = data.find(b"\xff\xda")
    p = sos + 2 + ((data[sos + 2] << 8) | data[sos + 3]) + 4
    for i in range(12):
        b = data[p + i] ^ 0x55
        if b not in (0xFF, 0x00) and data[p + i] not in (0xFF, 0x00):
            data[p + i] = b
    return bytes(data)


def _decode_outcome(decode):
    try:
        px, ok = decode()
    except Exception as exc:  # the host tail may refuse the stream
        return type(exc).__name__, str(exc)
    return np.asarray(px), bool(ok)


@pytest.mark.parametrize("mode", ["gray", "420"])
def test_corrupt_first_scan(mode):
    """A damaged first scan: decode() takes the spec path where the walk
    refuses it, as zpix_tpu's does, with zpix_tpu's outcome (pixels and ok,
    or the error); ok False, or, where the host decoder accepts the stream
    too, its pixels."""
    from zpix_tpu.codecs.jpeg import decoder as host

    jax_native_lib()
    data = _corrupt_first_scan(synth_progressive(96, 64, mode))
    dec = _cpu()
    got = _decode_outcome(lambda: dec.decode([data, data]))
    want = _decode_outcome(lambda: jpo.OnchipProgressiveDecoder(k1=1, k2=1).decode([data, data]))
    assert type(got[0]) is type(want[0]) and got[1] == want[1]
    if isinstance(got[0], str):
        assert got[0] == want[0]
        return
    assert np.array_equal(got[0], want[0])
    px, ok = got
    try:
        host.decode(data)
    except Exception:
        assert not ok
        return
    if ok:
        assert np.array_equal(px[0], host_pixels(data))


def test_refused_walk_names_scan_and_image():
    """An index walk that refuses a stream ends the script at that scan:
    ok False, no exception, the failure names the scan and the image."""
    good = synth_progressive(64, 48, "420")
    bad = bytearray(good)
    at = -1
    for _ in range(4):  # the 4th scan's first entropy bytes
        at = bad.find(b"\xff\xda", at + 1)
    at += 2 + ((bad[at + 2] << 8) | bad[at + 3])
    bad[at : at + 16] = b"\xff\x00" * 8  # destuffs to all-ones: no valid code
    dec = _cpu()
    prep = dec.prep([good, bytes(bad)])
    assert not prep.okh and prep.refused and len(prep.scans) == 3
    assert prep.failure.startswith("scan 3 (ac_first)") and "image 1" in prep.failure
    px, ok = dec.run(prep)
    assert not bool(ok) and px.shape == (2, 48, 64, 3)


@pytest.mark.parametrize("ratio,hv", [("gray", [(1, 1)]), ("420", [(2, 2), (1, 1), (1, 1)]),
                                      ("422", [(2, 1), (1, 1), (1, 1)])])
def test_planes_int32_arm_equals_int16_arm(ratio, hv):
    """K6 on int32 grids gives the int16 arm's pixels on the same values."""
    rng = np.random.default_rng(1)
    B, mxx, myy = 2, 3, 2
    grids = [rng.integers(-1024, 1024, (B, myy * v, mxx * h, 64)) for h, v in hv]
    quants = [torch.from_numpy(rng.integers(1, 64, (B, 64)).astype(np.int32)) for _ in hv]
    color = "gray" if ratio == "gray" else "ycbcr"
    f = {"gray": (1, 1), "420": (2, 2), "422": (2, 1)}[ratio]
    kw = dict(color=color, height=8 * hv[0][1] * myy - 3, width=8 * hv[0][0] * mxx - 5,
              factors=[(1, 1)] + [f] * (len(hv) - 1))
    a = kpl.component_planes([_t(g.astype(np.int16)) for g in grids], quants, **kw)
    b = kpl.component_planes([_t(g.astype(np.int32)) for g in grids], quants, **kw)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ K11


@pytest.mark.parametrize("run", [8, 32])
@pytest.mark.parametrize("case", ["444", "422", "420", "411", "single_partial",
                                  "single_chroma", "all_set", "none_set", "wide_rows"])
def test_dc_refine_kernel_algorithm_matches_plain(case, run):
    """K11's algorithm in numpy (a thread's word of bits, padding bits
    masked, set bits MSB first, the slot table and multiply-high
    divisions; tests/_torch_prog.py::dc_refine_words) at both run lengths
    timed on the card, against the wrapper's plain version, on block
    counts no multiple of 8 or 32 and rows no multiple of 4 bytes."""
    from _torch_prog import dc_refine_words, k11_case

    rows, grids, hv, valid, al = k11_case(case, 7)
    want = [torch.from_numpy(g.copy()) for g in grids]
    kp.dc_refine(torch.from_numpy(rows), want, hv=hv, valid=valid, al=al)
    got = [g.copy() for g in grids]
    dc_refine_words(rows, got, hv, valid, al, run)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    changed = sum(int((g != w).sum()) for g, w in zip(grids, got))
    assert (changed == 0) == (case == "none_set")


@pytest.mark.parametrize("al", range(14))
def test_dc_refine_every_al(al):
    """Al 0..13 on a 4:2:0 interleaved scan: only bit Al of coefficient 0
    changes, where the block's bit is set."""
    from _torch_prog import dc_refine_words, k11_case

    rows, grids, hv, valid, _ = k11_case("420", al, al=al)
    want = [torch.from_numpy(g.copy()) for g in grids]
    kp.dc_refine(torch.from_numpy(rows), want, hv=hv, valid=valid, al=al)
    got = [g.copy() for g in grids]
    dc_refine_words(rows, got, hv, valid, al, 8)
    for g, w, before in zip(got, want, grids):
        assert np.array_equal(g, w.numpy())
        diff = g ^ before
        assert not diff[..., 1:].any() and not (diff[..., 0] & ~(1 << al)).any()
