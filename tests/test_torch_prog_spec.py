"""The port's progressive spec path on the CPU: K20, K21 and K22's plain
versions, and ``OnchipProgressiveDecoder(impl="spec")`` with its host tail,
against zpix_tpu and the host decoder.  Exact: tolerance 0.

* K20 and K21's plain versions on scans coded by hand, serially
  (tests/_torch_prog.py: DC slots cycling through two tables, EOB runs
  whose symbol crosses a chunk's edge, symbols ending on one, chunks of 1
  to 64 bytes), against the store the coding says and against zpix_tpu's
  build_dc_first_fn / build_ac_first_fn (k1 = k2 = 1).
* The decoder against zpix_tpu's ``OnchipProgressiveDecoder(impl="spec",
  k1=1, k2=1)`` (its default unrolls do not return within minutes on
  XLA:CPU; they change no output) on gray, 4:2:0, a stream whose Cb
  AC-first scan moved after Y's first refinement (the host tail) and a
  batch an index walk refuses (``decode()`` in host-index mode); every
  other case against the port's host decoder.
"""

import numpy as np
import pytest
import torch
from _torch_jpeg import host_pixels, jax_native_lib, move_scan, synth_progressive

import _torch_prog as tp
from zpix_tpu.parallel import progressive_onchip as jpo
from zpix_tpu.parallel.device_entropy import CmpTables
from zpix_tpu_torch import OnchipProgressiveDecoder
from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
from zpix_tpu_torch.ops import entropy as ke
from zpix_tpu_torch.ops import prog_spec as ps
from zpix_tpu_torch.parallel import progressive_onchip as tpo


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(huffs):
    out = []
    for counts, syms in huffs:
        t = HuffTable()
        t.build(list(counts), bytes(syms))
        out.append(t)
    return out


def _jax_tables(huffs):
    from zpix_tpu.codecs.jpeg.tables import HuffTable as JHuff

    out = []
    for counts, syms in huffs:
        t = JHuff()
        t.build(list(counts), bytes(syms))
        out.append(t)
    return CmpTables(out)


def _edges(cases, cb):
    """(EOB-run symbols crossing a chunk edge, symbols ending on one), over
    the batch, in each image's own bits."""
    C = 8 * cb
    cross = sum(a // C != (e - 1) // C for c in cases for a, e in c.get("run_spans", []))
    on_edge = sum(e % C == 0 for c in cases for e in c["symbol_ends"])
    return cross, on_edge


DC_HV = {"420": ((2, 2), (1, 1), (1, 1)), "444": ((1, 1),) * 3, "422": ((2, 1), (1, 1), (1, 1)),
         "single": ((1, 1),)}


def _dc_batch(seed, hv, batch=3, **kw):
    return [tp.spec_dc_scan(seed + 7 * b, hv=hv, **kw) for b in range(batch)]


def _dc_spec_store(cases, hv, cb, *, mxx=5, myy=3, al=1):
    """K20 plain on a hand-coded batch -> (grids numpy, ok, the store before,
    the stacked inputs)."""
    B = len(cases)
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    tables = ke.pack_tables(_tables(cases[0]["huffs"]), cases[0]["tid_of_slot"], [])
    rng = np.random.default_rng(0)
    if len(hv) == 1:  # a single-component scan: its valid corner of a larger grid
        init = [rng.integers(-99, 99, (B, myy + 1, mxx + 2, 64)).astype(np.int32)]
    else:
        init = [rng.integers(-99, 99, (B, myy * v, mxx * h, 64)).astype(np.int32)
                for h, v in hv]
    grids = [_t(g.copy()) for g in init]
    ok = torch.ones(1, dtype=torch.int32)
    ps.dc_first_spec(_t(flat), _t(starts), _t(ends), _t(tables), ok, grids, hv=list(hv),
                     valid=(myy, mxx), al=al, chunk_bytes=cb, n_chunks=F)
    return [g.numpy() for g in grids], int(ok), init, (flat, starts, ends, F)


@pytest.mark.parametrize("cb", [1, 2, 5, 64])
@pytest.mark.parametrize("ratio", ["420", "422", "444", "single"])
def test_dc_first_spec_plain_on_hand_coded_scans(ratio, cb):
    """K20 plain: DC slots cycling through two tables (Y's and the
    chroma's), every image its own diffs; the store is the coding's, ok 1;
    at 1- and 2-byte chunks symbols cross chunk edges and end on them."""
    hv = DC_HV[ratio]
    cases = _dc_batch(cb, hv)
    got, ok, init, (flat, starts, ends, F) = _dc_spec_store(cases, hv, cb)
    assert ok == 1
    want = [g.astype(np.int64) for g in init]
    for b, c in enumerate(cases):
        parts = [w[b, :3 * v, :5 * h].copy() for w, (h, v) in zip(want, hv)]
        tp.dc_store(c["diffs"], hv, 5, 3, 1, parts)
        for w, p, (h, v) in zip(want, parts, hv):
            w[b, :3 * v, :5 * h] = p
    for g, w in zip(got, want):
        assert np.array_equal(g, w.astype(np.int32))
    if cb <= 2:
        assert _edges(cases, cb)[1] > 0


def test_dc_first_spec_matches_zpix_tpu_on_hand_coded_scans():
    """K20 plain against zpix_tpu's build_dc_first_fn (raw, k1 = 1) on the
    same stacked batch: the diffs' prefix and ok; and a 1-bit code for
    size 0 on a batch of zero diffs puts more than 4 * chunk_bytes symbols
    in a chunk, which clears ok in both."""
    import jax.numpy as jnp

    hv = DC_HV["420"]
    for cb, zero in ((3, 0.3), (1, 1.0)):
        cases = _dc_batch(11, hv, zero=zero, tables=(tp.DC_SPREAD, tp.DC_SKEWED) if zero < 1
                          else (tp.DC_UNARY,))
        got, ok, init, (flat, starts, ends, F) = _dc_spec_store(cases, hv, cb)
        nblk = len(cases[0]["diffs"])
        fn = jpo.build_dc_first_fn(batch=len(cases), n_chunks=F, chunk_bytes=cb,
                                   cmp=_jax_tables(cases[0]["huffs"]),
                                   tid_of_slot=tuple(cases[0]["tid_of_slot"]), nblk_total=nblk,
                                   k1=1, _raw=True)
        diffs, jok = fn(jnp.asarray(flat), jnp.asarray(starts.astype(np.int64)),
                        jnp.asarray(ends.astype(np.int64)))
        assert ok == int(bool(jok)) == int(zero < 1)
        if zero < 1:
            want = [g.astype(np.int64) for g in init]
            for b in range(len(cases)):
                parts = [w[b] for w in want]
                tp.dc_store(np.asarray(diffs)[b], hv, 5, 3, 1, parts)
            for g, w in zip(got, want):
                assert np.array_equal(g, w.astype(np.int32))


def _links_and_fixed_point(cases, hv, cb):
    """K20's entry search as its kernels make it (dc_entry_links_plain) and
    the plain version's fixed point, on a stacked hand-coded batch."""
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    tab = _t(ke.pack_tables(_tables(cases[0]["huffs"]), cases[0]["tid_of_slot"], []))
    bpm = sum(h * v for h, v in hv) if len(hv) > 1 else 1
    t = [_t(a) for a in (flat, starts, ends)]
    links = ps.dc_entry_links_plain(*t, tab, bpm=bpm, chunk_bytes=cb, n_chunks=F)
    T, s64 = ke._Tables(tab), t[0].to(torch.int64)
    cs, ce = ps._chunks(t[1], t[2], F, 8 * cb)

    def scan(bit, slot, sel):
        return ps._dc_scan(T, s64, s64.shape[0], bit, slot, ce[sel], bpm)

    fixed = ps.fixed_point(scan, cs, torch.zeros_like(cs), ps.entry_sources(t[1], t[2], F, 8 * cb),
                           F + 2)
    return links, fixed, (flat, starts, ends, F, T, s64, ce, bpm)


@pytest.mark.parametrize("cb", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("ratio", ["420", "single"])
def test_dc_entry_links_match_fixed_point(ratio, cb):
    """K20's guesses at every slot, links, put-in misses and resolve give
    every chunk the entry, symbol count and first bad bit the plain
    version's fixed point gives; an image cut short (its last symbol
    broken) among them; at 1- to 5-byte chunks the true path misses."""
    hv = DC_HV[ratio]
    cases = _dc_batch(40 + cb, hv)
    cases[1] = dict(cases[1], stream=cases[1]["stream"][: len(cases[1]["stream"]) * 2 // 3])
    links, (eb, es, res, rounds, settled), _ = _links_and_fixed_point(cases, hv, cb)
    assert settled
    assert torch.equal(links["bit"], eb) and torch.equal(links["slot"], es)
    assert torch.equal(links["count"], res[2]) and torch.equal(links["err"], res[3])
    if cb <= 5 and ratio == "420":
        assert int(links["misses"].sum()) > 0 and rounds > 4
    assert int(links["distinct"].max()) <= (6 if ratio == "420" else 1)


def test_dc_entry_links_diffs_match_zpix_tpu():
    """The diffs recorded from K20's resolved entries equal zpix_tpu's
    build_dc_first_fn (raw, k1 = 1) on the same stacked batch, at chunks
    of 1, 3 and 16 bytes."""
    import jax.numpy as jnp

    hv = DC_HV["420"]
    for cb in (1, 3, 16):
        cases = _dc_batch(60 + cb, hv)
        links, _, (flat, starts, ends, F, T, s64, ce, bpm) = _links_and_fixed_point(cases, hv, cb)
        nblk = len(cases[0]["diffs"])
        cnt = links["count"].view(len(cases), F)
        first = (cnt.cumsum(1) - cnt).reshape(-1)
        img = torch.arange(len(cases) * F) // F
        diffs = torch.zeros(len(cases) * nblk + 1, dtype=torch.int64)
        ps._dc_scan(T, s64, s64.shape[0], links["bit"], links["slot"], ce, bpm,
                    rec=(diffs, img * nblk, first, nblk))
        fn = jpo.build_dc_first_fn(batch=len(cases), n_chunks=F, chunk_bytes=cb,
                                   cmp=_jax_tables(cases[0]["huffs"]),
                                   tid_of_slot=tuple(cases[0]["tid_of_slot"]), nblk_total=nblk,
                                   k1=1, _raw=True)
        want, jok = fn(jnp.asarray(flat), jnp.asarray(starts.astype(np.int64)),
                       jnp.asarray(ends.astype(np.int64)))
        assert bool(jok)
        assert np.array_equal(diffs[:-1].view(len(cases), nblk).numpy(), np.asarray(want))


def _ac_spec_store(cases, cb, *, nvy=6, nvx=11, ss=1, se=63, al=1):
    B = len(cases)
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    tables = ke.pack_tables(_tables(cases[0]["huffs"]), [], [0])
    init = np.random.default_rng(1).integers(-99, 99, (B, nvy + 1, nvx + 1, 64)).astype(np.int32)
    grid = _t(init.copy())
    ok = torch.ones(1, dtype=torch.int32)
    ps.ac_first_spec(_t(flat), _t(starts), _t(ends), _t(tables), ok, grid, valid=(nvy, nvx),
                     ss=ss, se=se, al=al, chunk_bytes=cb, n_chunks=F)
    want = init.astype(np.int64)
    for b, c in enumerate(cases):
        want[b, :nvy, :nvx] += (c["vals"] << al).reshape(nvy, nvx, 64)
    return grid.numpy(), int(ok), want.astype(np.int32), init, (flat, starts, ends, F)


@pytest.mark.parametrize("cb", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("band", [(1, 63), (1, 5), (6, 63)])
def test_ac_first_spec_plain_on_hand_coded_scans(band, cb):
    """K21 plain: EOB runs (with run bits), ZRL, overflow symbols and band
    ends, every image its own blocks; the store is the coding's, ok 1; at
    small chunks an EOB run's symbol crosses a chunk edge and symbols end
    on one."""
    ss, se = band
    cases = [tp.spec_ac_scan(31 * cb + b + ss, ss=ss, se=se) for b in range(3)]
    got, ok, want, _, (flat, starts, ends, F) = _ac_spec_store(cases, cb, ss=ss, se=se)
    assert ok == 1
    assert np.array_equal(got, want)
    if cb <= 3:
        cross, on_edge = _edges(cases, cb)
        assert cross > 0 and on_edge > 0


def test_ac_first_spec_matches_zpix_tpu_on_hand_coded_scans():
    """K21 plain against zpix_tpu's build_ac_first_fn (raw, k1 = k2 = 1): the
    values and ok, on a good batch and on one cut short (fewer blocks than
    the valid grid: ok False in both)."""
    import jax.numpy as jnp

    for cut in (False, True):
        cases = [tp.spec_ac_scan(5 + b) for b in range(2)]
        if cut:
            cases[1] = dict(cases[1], stream=cases[1]["stream"][: len(cases[1]["stream"]) // 2])
        got, ok, _, init, (flat, starts, ends, F) = _ac_spec_store(cases, 4)
        fn = jpo.build_ac_first_fn(batch=2, n_chunks=F, chunk_bytes=4,
                                   cmp=_jax_tables(cases[0]["huffs"]), tid=0, ss=1, se=63,
                                   nvalid=66, k1=1, k2=1, _raw=True)
        curT, jok = fn(jnp.asarray(flat), jnp.asarray(starts.astype(np.int64)),
                       jnp.asarray(ends.astype(np.int64)))
        assert ok == int(bool(jok)) == int(not cut)
        vals = np.asarray(curT).reshape(64, 2, 66).transpose(1, 2, 0).astype(np.int64) << 1
        want = init.astype(np.int64)
        want[:, :6, :11] += vals.reshape(2, 6, 11, 64)
        assert np.array_equal(got, want.astype(np.int32))


def _ac_links_and_fixed_point(cases, cb, ss, se):
    """K21's entry search as its kernels make it (ac_entry_links_plain) and
    the plain version's fixed point, on a stacked hand-coded batch."""
    flat, starts, ends, F = ps.stack_spec([c["stream"] for c in cases], cb)
    tab = _t(ke.pack_tables(_tables(cases[0]["huffs"]), [], [0]))
    t = [_t(a) for a in (flat, starts, ends)]
    links = ps.ac_entry_links_plain(*t, tab, ss=ss, se=se, chunk_bytes=cb, n_chunks=F)
    T, s64 = ke._Tables(tab), t[0].to(torch.int64)
    cs, ce = ps._chunks(t[1], t[2], F, 8 * cb)

    def scan(bit, k, sel):
        return ps._ac_scan(T, T.slot_ac[0], s64, s64.shape[0], bit, k, ce[sel], ss=ss, se=se)

    fixed = ps.fixed_point(scan, cs, torch.full_like(cs, ss),
                           ps.entry_sources(t[1], t[2], F, 8 * cb), F + 2)
    return links, fixed, (flat, starts, ends, F, T, s64, ce)


@pytest.mark.parametrize("cb", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("band", [(1, 63), (1, 5), (6, 63)])
def test_ac_entry_links_match_fixed_point(band, cb):
    """K21's guess at k = Ss, links, put-in misses and resolve give every
    chunk the entry (bit, k), finished blocks, blocks passed, first bad bit
    and symbols the plain version's fixed point gives, on scans coded by
    hand with EOB runs (run bits), ZRL and overflow symbols, one image cut
    short; at 1- to 3-byte chunks the true path misses."""
    ss, se = band
    cases = [tp.spec_ac_scan(17 * cb + b + ss, ss=ss, se=se) for b in range(3)]
    cases[1] = dict(cases[1], stream=cases[1]["stream"][: len(cases[1]["stream"]) * 2 // 3])
    links, (eb, ek, res, rounds, settled), _ = _ac_links_and_fixed_point(cases, cb, ss, se)
    assert settled
    assert torch.equal(links["bit"], eb) and torch.equal(links["k"], ek)
    for i, name in enumerate(("count", "adv", "err", "symbols"), start=2):
        assert torch.equal(links[name], res[i]), name
    if cb <= 3:
        assert int(links["misses"].sum()) > 0 and rounds > 3
    assert int(links["distinct"].max()) == 1


def test_ac_entry_links_values_match_zpix_tpu():
    """The values recorded from K21's resolved entries (each chunk's first
    block the prefix of the blocks passed before it) equal zpix_tpu's
    build_ac_first_fn (raw, k1 = k2 = 1) on the same stacked batch, at
    chunks of 1, 3 and 16 bytes."""
    import jax.numpy as jnp

    for cb in (1, 3, 16):
        cases = [tp.spec_ac_scan(70 + cb + b) for b in range(2)]
        links, _, (flat, starts, ends, F, T, s64, ce) = _ac_links_and_fixed_point(cases, cb, 1, 63)
        B, nvalid = len(cases), 66
        adv = links["adv"].view(B, F)
        first = (adv.cumsum(1) - adv).reshape(-1)
        img = torch.arange(B * F) // F
        lim = torch.minimum(adv.sum(1), torch.tensor(nvalid))[img]
        rows = torch.zeros(B * nvalid + 1, 64, dtype=torch.int64)
        ps._ac_scan(T, T.slot_ac[0], s64, s64.shape[0], links["bit"], links["k"], ce, ss=1, se=63,
                    rec=(rows, img * nvalid, first, lim))
        fn = jpo.build_ac_first_fn(batch=B, n_chunks=F, chunk_bytes=cb,
                                   cmp=_jax_tables(cases[0]["huffs"]), tid=0, ss=1, se=63,
                                   nvalid=nvalid, k1=1, k2=1, _raw=True)
        curT, jok = fn(jnp.asarray(flat), jnp.asarray(starts.astype(np.int64)),
                       jnp.asarray(ends.astype(np.int64)))
        assert bool(jok)
        want = np.asarray(curT).reshape(64, B, nvalid).transpose(1, 2, 0)
        assert np.array_equal(rows[:-1].view(B, nvalid, 64).numpy(), want)


def test_ac_first_spec_group_on_libjpeg_script():
    """K21's grouped plain version over the four AC-first scans of libjpeg's
    script (Pillow's 4:2:0; Y 1-5, Cr, Cb, Y 6-63) equals the four single
    calls and, after K20's DC-first scan, the host decoder's coefficients
    after those five scans; each scan's values are zpix_tpu's
    build_ac_first_fn's (raw, k1 = k2 = 1)."""
    import jax.numpy as jnp
    from _torch_jpeg import host_coeffs

    data = synth_progressive(48, 40, "420", phase=0.3)
    datas, cb = [data] * 2, 16
    plans = [tpo.parse_progressive(d) for d in datas]
    p0, B = plans[0], len(datas)
    acs = [si for si, sc in enumerate(p0.scans[:5]) if sc.kind == "ac_first"]
    assert acs == [1, 2, 3, 4] and p0.scans[0].kind == "dc_first"

    def store():
        return [torch.zeros(B, p0.myy * v, p0.mxx * h, 64, dtype=torch.int32) for h, v in p0.hv]

    inputs = {si: po_inputs for si, po_inputs in
              ((si, tpo.spec_first_inputs(p0, plans, si, cb)) for si in [0] + acs)}
    group, single = store(), store()
    ok_g, ok_s = torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    for grids, ok in ((group, ok_g), (single, ok_s)):
        (arrays, F), sc = inputs[0], p0.scans[0]
        ps.dc_first_spec(*(_t(a) for a in arrays), ok, grids, hv=list(p0.hv),
                         valid=tpo.valid_grid(p0, 0), al=sc.al, chunk_bytes=cb, n_chunks=F)
    rounds = ps.ac_first_spec_group(
        [ps.AcScan(*(_t(a) for a in inputs[si][0]), group[p0.scans[si].comps[0]],
                   tpo.valid_grid(p0, p0.scans[si].comps[0]), p0.scans[si].ss, p0.scans[si].se,
                   p0.scans[si].al, inputs[si][1]) for si in acs], ok_g, chunk_bytes=cb)
    assert rounds.shape == (4, B)
    jpr = jpo.OnchipProgressiveDecoder(k1=1, k2=1).prep(datas)
    for si in acs:
        sc, (arrays, F) = p0.scans[si], inputs[si]
        c = sc.comps[0]
        nvy, nvx = tpo.valid_grid(p0, c)
        ps.ac_first_spec(*(_t(a) for a in arrays), ok_s, single[c], valid=(nvy, nvx), ss=sc.ss,
                         se=sc.se, al=sc.al, chunk_bytes=cb, n_chunks=F)
        meta = jpr["preps"][si][1]
        fn = jpo.build_ac_first_fn(batch=B, n_chunks=F, chunk_bytes=cb,
                                   cmp=CmpTables([meta["huff"]]), tid=0, ss=sc.ss, se=sc.se,
                                   nvalid=nvy * nvx, k1=1, k2=1, _raw=True)
        curT, jok = fn(jnp.asarray(arrays[0]), jnp.asarray(arrays[1].astype(np.int64)),
                       jnp.asarray(arrays[2].astype(np.int64)))
        assert bool(jok)
        band = np.asarray(curT).reshape(64, B, nvy, nvx).transpose(1, 2, 3, 0).astype(np.int64)
        nat = [tpo.UNZIG[k] for k in range(sc.ss, sc.se + 1)]
        assert np.array_equal(group[c].numpy()[:, :nvy, :nvx][..., nat],
                              (band[..., nat] << sc.al).astype(np.int32))
    assert int(ok_g) == int(ok_s) == 1
    for g, s_, want in zip(group, single, host_coeffs(data, 5)):
        assert torch.equal(g, s_)
        assert np.array_equal(g[0].numpy(), want)


def test_delta_add_plain_hand_case():
    """K22 plain: per-row unique indices, padding pairs (0, 0) meeting a real
    index 0, int32 wrapping."""
    state = torch.tensor([[5, 2**31 - 1, 7], [1, 1, 1]], dtype=torch.int32)
    idx = torch.tensor([[1, 0, 0, 0], [2, 0, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[1, -5, 0, 0], [9, 4, 0, 0]], dtype=torch.int32)
    ps.delta_add(state, idx, val)
    assert state.tolist() == [[0, -2**31, 7], [5, 1, 10]]


def test_stack_spec_layout_is_zpix_tpus():
    """stack_spec's offsets, ends and chunk count are zpix_tpu's
    _stack_streams'; its bytes are the same up to 64 zero bytes after the
    last image."""
    streams = [np.arange(n, dtype=np.uint8) for n in (13, 64, 1, 200)]
    flat, starts, ends, F = ps.stack_spec(streams, 16)
    jflat, jstarts, jends, jF = jpo.OnchipProgressiveDecoder(chunk_bytes=16)._stack_streams(
        streams)
    assert list(starts) == list(jstarts) and list(ends) == list(jends) and F == jF
    assert np.array_equal(flat, jflat[: flat.shape[0]]) and not jflat[flat.shape[0]:].any()


# ------------------------------------------------------------ the decoder


def _bad_walk(good: bytes) -> bytes:
    """The 4th scan's first entropy bytes made all ones: the AC-first index
    walk refuses image 1 (test_torch_progressive.py's case)."""
    bad = bytearray(good)
    at = -1
    for _ in range(4):
        at = bad.find(b"\xff\xda", at + 1)
    at += 2 + ((bad[at + 2] << 8) | bad[at + 3])
    bad[at : at + 16] = b"\xff\x00" * 8
    return bytes(bad)


JAX_CASES = {
    "gray": lambda: [synth_progressive(64, 48, "gray")] * 2,
    "420": lambda: [synth_progressive(64, 48, "420")] * 2,
    "tail": lambda: [move_scan(synth_progressive(64, 48, "420"), 3, 5)] * 2,
    "refused": lambda: [synth_progressive(64, 48, "420"),
                        _bad_walk(synth_progressive(64, 48, "420"))],
}


def _outcome(decode):
    try:
        px, ok = decode()
    except Exception as exc:  # the error is part of the outcome
        return type(exc).__name__, str(exc)
    return np.asarray(px), bool(ok)


@pytest.fixture(scope="module")
def jax_outcomes():
    """zpix_tpu's decode of each case, once: spec mode, except the refused
    batch, which takes its default host-index mode (and so the spec path)."""
    jax_native_lib()
    out = {}
    for name, make in JAX_CASES.items():
        datas = make()
        dec = jpo.OnchipProgressiveDecoder(k1=1, k2=1, impl=None if name == "refused"
                                           else "spec")
        out[name] = (_outcome(lambda: dec.decode(datas)), dec.n_host_tail_scans)
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_decoder_matches_zpix_tpu(jax_outcomes, name):
    """Pixels, ok (or the error) and the host tail's scan count equal
    zpix_tpu's: the spec route on gray and 4:2:0 (no tail), the moved Cb
    scan (the tail decodes 5 scans), and decode() in host-index mode on a
    batch a walk refuses."""
    datas = JAX_CASES[name]()
    dec = OnchipProgressiveDecoder(device="cpu", n_threads=2,
                                   impl="hostindex" if name == "refused" else "spec")
    (want, want_tail) = jax_outcomes[name]
    got = _outcome(lambda: dec.decode(datas))
    assert type(got[0]) is type(want[0])
    if isinstance(want[0], str):
        assert got == want
    else:
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
        assert dec.n_host_tail_scans == want_tail
    if name == "tail":
        assert want_tail == 5 and want[1]
        assert np.array_equal(got[0][0], host_pixels(datas[0]))
    if name == "refused":
        assert not dec.prep(datas).okh


@pytest.mark.parametrize("cb", [16, 64, 256])
@pytest.mark.parametrize("mode,w,h", [("420", 64, 48), ("444", 40, 24), ("gray", 37, 29),
                                      ("420", 37, 29), ("422", 96, 64)])
def test_spec_decoder_matches_host_decoder(mode, w, h, cb):
    """impl="spec" at chunks of 16, 64 and 256 bytes, every sampling and a
    crop: ok, no host tail, each image's pixels the host decoder's; the
    flags were fetched once, a bit a coefficient."""
    data = synth_progressive(w, h, mode, phase=0.4)
    dec = OnchipProgressiveDecoder(device="cpu", n_threads=2, impl="spec", chunk_bytes=cb)
    px, ok = dec.decode([data] * 3)
    assert bool(ok) and dec.n_host_tail_scans == 0
    want = host_pixels(data)
    for i in range(3):
        assert np.array_equal(px[i].numpy(), want)
    plans = [tpo.parse_progressive(data)]
    coeffs = sum(3 * plans[0].myy * v * plans[0].mxx * h * 64 for h, v in plans[0].hv)
    assert dec.spec_stats["flag_fetch_bytes"] == coeffs // 8


def test_tail_on_a_moved_scan_matches_host_decoder():
    """The moved Cb AC-first scan at other sizes and chunk: the card decodes
    5 scans, the host tail the other 5, and the pixels are the host
    decoder's (of the moved stream and of the original)."""
    for w, h, cb in ((96, 64, 16), (37, 29, 64)):
        data = synth_progressive(w, h, "420", phase=0.2)
        moved = move_scan(data, 3, 5)
        dec = OnchipProgressiveDecoder(device="cpu", n_threads=2, impl="spec", chunk_bytes=cb)
        px, ok = dec.decode([moved, moved])
        assert bool(ok) and dec.n_host_tail_scans == 5 and dec.spec_stats["prefix"] == 5
        assert np.array_equal(px[1].numpy(), host_pixels(data))
        assert np.array_equal(px[0].numpy(), host_pixels(moved))


def test_hostindex_decode_takes_no_spec_path_on_good_streams():
    """decode() in host-index mode on a batch every walk accepts runs no
    spec scan: n_host_tail_scans 0, no spec stats."""
    data = synth_progressive(64, 48, "420")
    dec = OnchipProgressiveDecoder(device="cpu", n_threads=2)
    px, ok = dec.decode([data, data])
    assert bool(ok) and dec.n_host_tail_scans == 0 and dec.spec_stats == {}
    assert np.array_equal(px[0].numpy(), host_pixels(data))


def test_constructor_refuses_unknown_impl_and_chunk():
    with pytest.raises(ValueError):
        OnchipProgressiveDecoder(device="cpu", impl="fused")
    with pytest.raises(ValueError):
        OnchipProgressiveDecoder(device="cpu", chunk_bytes=0)
