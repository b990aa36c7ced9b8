"""The port's PNG slice on the CPU (K15-K17's plain versions) against
zpix_tpu.  Exact: tolerance 0.

* K15's plain version against ``defilter_jnp``: every bpp, all five
  filters and types above 4, H = 1, W = 1, H > W and W > H.
* K16's plain version against ``resolve_tokens_jnp``: the tokenizer's
  output of the four deflate modes, hand-built chains, padding.
* The adler32 check's span arithmetic (``_torch_png.adler32_span_terms``,
  csrc/adler32.cu's in numpy) against ``zlib.adler32`` and
  ``adler32_plain``, with the accumulator bounds its header states.
* K17's plain version against ``_expand_graph`` on every arm, with and
  without a key, at widths 1, 3, 4, 5, 11 and 17 (the tails of the
  kernel's 4-pixel groups), and against ``_interlaced_graph``.
* ``BatchPngDecoder(device="cpu")`` by all three front-ends, Adam7 or not,
  against ``codecs.png.decode(...).rgba_pixels()`` on the 15 depths, and
  against zpix_tpu's ``BatchPngDecoder``; the colour-key, palette-overflow
  and mixed-interlace cases of tests/test_parallel.py; one 256^2 case of
  the JAX bench's content.

zpix_tpu's tca16 and ga16 arms multiply in int32 and wrap for c * a >=
2^31; the port gives the host decoder's value there (ROADMAP queue 3), so
those arms are held against zpix_tpu's batch path on samples below 46,341
and against the host decoder on the full range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_png import (DEPTHS, adler32_span_terms, adler32_thread_bounds, encode_png,
                        hand_tokens, make_bench_png, pack_samples, png_batch, random_pixels,
                        stack_tokens)

from zpix_tpu import errors as jerr
from zpix_tpu.codecs import png as jax_png
from zpix_tpu.ops.defilter import defilter_jnp
from zpix_tpu.ops.inflate import resolve_tokens_jnp
from zpix_tpu.parallel import png_batch as jpb
from zpix_tpu_torch import BatchPngDecoder
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.ops.defilter import png_defilter, png_defilter_plain
from zpix_tpu_torch.ops.inflate import (ADLER_BAD, ADLER_SPAN, ADLER_THREADS, adler32_check,
                                        adler32_plain, doubling_rounds, inflate_resolve,
                                        inflate_resolve_plain)
from zpix_tpu_torch.ops.png import png_expand
from zpix_tpu_torch.parallel import png_batch as tpb
from zpix_tpu_torch.parallel.png_batch import _segments, palettes, parse_filtered, parse_tokens

torch.set_num_threads(2)  # the suite runs with several workers

CDS = list(DEPTHS)
KEYED = ("g1", "g2", "g4", "g8", "g16", "tc8", "tc16")
SAFE16 = 46341  # c * a < 2^31 below this: zpix_tpu's int32 premultiply does not wrap
FRONTS = {"host": {}, "defilter": {"device_defilter": True}, "inflate": {"device_inflate": True}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- K15


@pytest.mark.parametrize("bpp,H,W", [(1, 1, 19), (2, 17, 1), (3, 11, 4), (4, 4, 11),
                                     (6, 9, 7), (8, 6, 9), (1, 33, 6), (3, 33, 5)])
def test_defilter_plain_matches_jax(bpp, H, W):
    rng = np.random.default_rng(bpp)
    raw = rng.integers(0, 256, (3, H, W * bpp), dtype=np.uint8)
    ft = rng.integers(0, 5, (3, H)).astype(np.uint8)
    ft[2] = rng.integers(0, 256, H)  # image 2: types above 4 too (they predict 0)
    ft[0, : min(H, 5)] = np.arange(min(H, 5))  # every filter on image 0
    want = np.asarray(defilter_jnp(jnp.asarray(raw), jnp.asarray(ft), bpp=bpp))
    bad = torch.zeros(1, dtype=torch.int32)
    got = png_defilter(_t(raw), _t(ft), bpp=bpp, bad=bad)
    assert np.array_equal(got.numpy(), want)
    assert int(bad) == int((ft > 4).any())


def test_defilter_reads_strided_rows():
    """The decoder hands K15 views of the inflated stream [B, H, 1 + Wb]."""
    rng = np.random.default_rng(9)
    stream = _t(rng.integers(0, 256, (2, 7, 1 + 12), dtype=np.uint8))
    stream[:, :, 0] %= 5
    got = png_defilter(stream[:, :, 1:], stream[:, :, 0], bpp=3)
    want = png_defilter_plain(stream[:, :, 1:].contiguous(), stream[:, :, 0].contiguous(),
                              bpp=3)
    assert torch.equal(got, want)


# ------------------------------------------------------------------- K16


def _resolve_jax(toks, per):
    return np.stack([np.asarray(resolve_tokens_jnp(jnp.asarray(l), jnp.asarray(d),
                                                   jnp.asarray(c), per)) for l, d, c in toks])


@pytest.mark.parametrize("case", ["stored", "fixed", "rle", "default", "hand", "edge_32k",
                                  "edge_64k"])
def test_inflate_resolve_plain_matches_jax(case):
    """The edge cases: per around 32 KiB and 64 KiB, distance-32,768 copies
    starting on every 8 KiB boundary, copies straddling the others, images
    with different token counts."""
    rng = np.random.default_rng(len(case))
    if case == "hand":
        per = 40_000
        toks = [hand_tokens(rng, per, k) for k in ("rle", "overlap", "far")]
    elif case.startswith("edge"):
        per = {"edge_32k": 32_769, "edge_64k": 65_535}[case]
        toks = [hand_tokens(rng, per, k) for k in ("far_edge", "rle", "overlap")]
    else:
        flat = np.repeat(random_pixels(rng, "tc8", 5, 13, hi=3), 8, axis=1)
        pix = [flat, random_pixels(rng, "tc8", 40, 13)]
        toks = [parse_tokens(encode_png(p, "tc8", strategy=case, seed=i))[1:]
                for i, p in enumerate(pix)]
        per = 13 * (1 + 40 * 3)
    padded = stack_tokens(toks)
    want = _resolve_jax([tuple(a[i] for a in padded) for i in range(len(toks))], per)
    got, moved = inflate_resolve_plain(*(_t(a) for a in padded), per)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(inflate_resolve(*(_t(a) for a in padded), per), got)
    assert moved.dtype == torch.int32 and moved.numel() == doubling_rounds(per)
    if case in ("rle", "hand", "edge_32k", "edge_64k"):  # runs of copies make chains
        assert int(moved.sum()) >= 1


# ------------------------------------------------------------------- K17


def _keys(rng, cd):
    """[3, 3] int32 keys in the depth's domain, the last image's -1."""
    bits = DEPTHS[cd][1]
    key = rng.integers(0, 1 << bits, (3, 3)).astype(np.int32)
    if bits < 8:
        key *= {1: 0xFF, 2: 0x55, 4: 0x11}[bits]
    key[-1] = -1
    return key


def _expand_matches_jax(cd, w, seed):
    """K17's plain version against _expand_graph on 3 images of 5 rows of
    ``w`` pixels, rows built so that the keys hit, with and without a key."""
    rng = np.random.default_rng(seed)
    h = 5
    bits, n = DEPTHS[cd][1], DEPTHS[cd][2]
    pix = random_pixels(rng, cd, w, h * 3, hi=SAFE16 if bits == 16 else None)
    key = _keys(rng, cd) if cd in KEYED else None
    if key is not None:  # the first pixel of each image carries its key
        for b in range(2):
            raw = key[b, :n] // ({1: 0xFF, 2: 0x55, 4: 0x11}.get(bits, 1))
            pix[b * h, 0] = raw if n > 1 else raw[0]
    rows = pack_samples(pix, cd).reshape(3, h, -1)
    pal = rng.integers(0, 256, (3, 256, 4), dtype=np.uint8)
    for k in (None, key) if key is not None else (None,):
        want = np.asarray(jpb._expand_graph(cd, jnp.asarray(rows), jnp.asarray(pal), width=w,
                                            key=None if k is None else jnp.asarray(k)))
        got = png_expand(_t(rows), _t(pal), None if k is None else _t(k), cd=cd, width=w)
        assert np.array_equal(got.numpy(), want)
        if k is not None:
            assert (want[0, 0, 0] == 0).all() and (want[1, 0, 0] == 0).all()


@pytest.mark.parametrize("cd", CDS)
def test_expand_plain_matches_jax(cd):
    """Every arm at a width that is not a multiple of the pixels a byte,
    rows built so that the keys hit, with and without a key."""
    _expand_matches_jax(cd, 11, len(cd) * 7 + 1)


@pytest.mark.parametrize("cd", CDS)
def test_expand_plain_matches_jax_at_group_tails(cd):
    """Every arm, keyed and not, at the widths where a row ends inside the
    kernel's 4-pixel group or on its edge: 1, 3, 4, 5 and 17."""
    for w in (1, 3, 4, 5, 17):
        _expand_matches_jax(cd, w, len(cd) * 7 + w)


def test_expand_16bit_follows_host_decoder_where_jax_wraps():
    """c = 33024, a = 65535: the host decoder premultiplies to 129, zpix_tpu's
    batch graph to 128 (int32 wrap); the port gives 129."""
    for cd, px in (("tca16", [33024, 33024, 33024, 65535]), ("ga16", [33024, 65535])):
        pix = np.array(px, np.uint16).reshape(1, 1, -1)
        data = encode_png(pix, cd)
        want = jax_png.decode(data).rgba_pixels().reshape(1, 1, 4)
        got = BatchPngDecoder(device="cpu").decode([data]).numpy()[0]
        assert np.array_equal(got, want) and got[0, 0, 0] == 129
        jax_out = np.asarray(jpb.BatchPngDecoder().decode([data]))[0]
        assert jax_out[0, 0, 0] == 128


@pytest.mark.parametrize("cd", ["tc8", "p2"])
def test_interlaced_plain_matches_jax(cd):
    """K15 and K17 a pass, placed on the canvas by K17, against
    _interlaced_graph."""
    datas, _ = png_batch(cd, 13, 11, batch=2, seed=4, interlace=True, trns=cd == "p2")
    parsed = [parse_filtered(d) for d in datas]
    st = parsed[0][0]
    flat = np.stack([np.frombuffer(r, np.uint8) for _s, r in parsed])
    pals = palettes([p[0] for p in parsed]) if cd.startswith("p") else None
    bpp = max(1, DEPTHS[cd][1] * DEPTHS[cd][2] // 8)
    passes, meta, off = [], [], 0
    canvas = torch.zeros(2, st.height, st.width, 4, dtype=torch.uint8)
    for p, pw, ph, rb in _segments(st):
        seg = flat[:, off : off + ph * (1 + rb)].reshape(2, ph, 1 + rb)
        off += ph * (1 + rb)
        passes.append((jnp.asarray(seg[:, :, 1:]), jnp.asarray(seg[:, :, 0])))
        meta.append((p, pw, ph))
        rows = png_defilter(_t(seg[:, :, 1:]), _t(seg[:, :, 0]), bpp=bpp)
        png_expand(rows, None if pals is None else _t(pals), None, cd=cd, width=pw,
                   out=canvas, place=jpb.INTERLACING[p])
    graph = jax.jit(lambda ps, pal: jpb._interlaced_graph(
        cd, ps, pal, bpp=bpp, pass_meta=tuple(meta), width=st.width, height=st.height))
    want = graph(passes, None if pals is None else jnp.asarray(pals))
    assert np.array_equal(canvas.numpy(), np.asarray(want))


# --------------------------------------------------------------- decoder


@functools.cache
def _decoders():
    return {f: BatchPngDecoder(device="cpu", n_threads=2, **kw) for f, kw in FRONTS.items()}


def _host(datas):
    out = []
    for d in datas:
        img = jax_png.decode(d)
        out.append(img.rgba_pixels().reshape(img.height, img.width, 4))
    return np.stack(out)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("cd", CDS)
def test_decoder_matches_host_decode(cd, interlace):
    """Every depth by every front-end: keyed and unkeyed images mixed,
    short palettes, random filters, the four deflate modes."""
    strategy = ("stored", "fixed", "rle", "default")[CDS.index(cd) % 4]
    datas, _ = png_batch(cd, 19, 10, batch=3, seed=CDS.index(cd), interlace=interlace,
                         trns=cd in KEYED or cd.startswith("p"), short=cd.startswith("p"),
                         strategy=strategy)
    want = _host(datas)
    for front, dec in _decoders().items():
        got = dec.decode(datas)
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want), front


@pytest.mark.parametrize("cd,front,interlace", [(cd, "host", False) for cd in CDS] + [
    ("tc8", "defilter", False), ("p4", "defilter", False), ("g16", "inflate", False),
    ("tc8", "inflate", False), ("tc8", "host", True), ("p2", "inflate", True)])
def test_decoder_matches_jax_decoder(cd, front, interlace):
    datas, _ = png_batch(cd, 9, 7, batch=2, seed=1, interlace=interlace,
                         trns=cd in KEYED or cd.startswith("p"),
                         hi=SAFE16 if cd in ("tca16", "ga16") else None)
    want = np.asarray(jpb.BatchPngDecoder(**FRONTS[front]).decode(datas))
    assert np.array_equal(_decoders()[front].decode(datas).numpy(), want)


def _key_cases():
    """tests/test_parallel.py:278's colour keys: g4, g8, g16 (0x12EE
    truncates as 0x1234 does and must stay opaque), tc8, tc16 (same high
    bytes, no match)."""
    rng = np.random.default_rng(7)
    g4 = rng.integers(0, 16, (9, 10)).astype(np.uint8)
    g4[2, :] = 7
    g8 = rng.integers(0, 256, (8, 8)).astype(np.uint8)
    g8[1, :] = 200
    g16 = rng.integers(0, 0x10000, (8, 8)).astype(np.uint16)
    g16[3, :], g16[4, :] = 0x1234, 0x12EE
    tc8 = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    tc8[2, 3] = (10, 20, 30)
    tc16 = rng.integers(0, 0x10000, (8, 8, 3)).astype(np.uint16)
    tc16[5, 1], tc16[5, 2] = (0x0102, 0x0304, 0x0506), (0x0103, 0x0304, 0x0506)
    return [("g4", g4, bytes([0, 7])), ("g8", g8, bytes([0, 200])),
            ("g16", g16, bytes([0x12, 0x34])), ("tc8", tc8, bytes([0, 10, 0, 20, 0, 30])),
            ("tc16", tc16, bytes([1, 2, 3, 4, 5, 6]))]


@pytest.mark.parametrize("front", list(FRONTS))
def test_decoder_colour_keys(front):
    for cd, pix, trns in _key_cases():
        keyed = encode_png(pix, cd, trns=trns, filters=[0])
        plain = encode_png(pix, cd, filters=[0])
        want = _host([keyed, plain])
        assert not np.array_equal(want[0], want[1]), cd
        got = _decoders()[front].decode([keyed, plain]).numpy()
        assert np.array_equal(got, want), cd
        jax_out = np.asarray(jpb.BatchPngDecoder(**FRONTS[front]).decode([keyed, plain]))
        assert np.array_equal(got, jax_out), cd


@pytest.mark.parametrize("front", list(FRONTS))
def test_decoder_palette_overflow(front):
    """tests/test_parallel.py:460: indices past a 2-entry palette read
    opaque black."""
    data = encode_png(np.array([[0, 1, 3, 5]] * 2, np.uint8), "p8",
                      palette=np.array([[255, 0, 0], [0, 255, 0]], np.uint8), filters=[0])
    want = _host([data, data])
    assert tuple(want[0, 0, 2]) == (0, 0, 0, 255)
    assert np.array_equal(_decoders()[front].decode([data, data]).numpy(), want)


def test_decoder_batch_errors():
    """Empty batch, a mixed-interlace batch (tests/test_parallel.py:567),
    mixed depths: zpix_tpu's errors."""
    pix = random_pixels(np.random.default_rng(2), "p4", 31, 31)
    pal = np.zeros((16, 3), np.uint8)
    inter = encode_png(pix, "p4", palette=pal, interlace=True)
    plain = encode_png(pix, "p4", palette=pal)
    dec = _decoders()["host"]
    with pytest.raises(ValueError, match="png: empty batch"):
        dec.decode([])
    with pytest.raises(ValueError, match="interlace"):
        dec.decode([inter, plain])
    with pytest.raises(ValueError, match="interlace"):
        jpb.BatchPngDecoder().decode([inter, plain])
    with pytest.raises(ValueError, match="share"):
        dec.decode([plain, encode_png(pix, "g4")])
    # a paletted image without PLTE: the host decoder's error (zpix_tpu's
    # batch path raises AttributeError on the missing palette)
    no_plte = encode_png(pix, "p4")
    with pytest.raises(jerr.FormatError) as want:
        jax_png.decode(no_plte)
    with pytest.raises(terr.FormatError, match=str(want.value)):
        dec.decode([no_plte])
    with pytest.raises(AttributeError):
        jpb.BatchPngDecoder().decode([no_plte])


def _error(fn, errors):
    with pytest.raises(errors.ZpixError) as exc:
        fn()
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("damage", ["crc", "short", "filter", "deflate", "adler"])
def test_decoder_damaged_streams(damage, interlace):
    """Every front-end raises: the host decoder's error where the port
    repairs zpix_tpu's batch path (a short stream, a filter type above 4, a
    corrupt deflate stream on the host-inflate front-ends; the filter type
    and a wrong adler32 trailer with device_inflate too), zpix_tpu's batch
    path's error elsewhere."""
    pix = random_pixels(np.random.default_rng(1), "tc8", 16, 8)
    good = encode_png(pix, "tc8", interlace=interlace)
    bad = encode_png(pix, "tc8", interlace=interlace, filters=[0], damage=damage)
    for front, dec in _decoders().items():
        got = _error(lambda: dec.decode([good, bad]), terr)
        repaired = damage in ("filter", "adler") or (damage != "crc" and front != "inflate")
        if repaired:
            want = _error(lambda: jax_png.decode(bad), jerr)
        else:
            want = _error(lambda: jpb.BatchPngDecoder(**FRONTS[front]).decode([good, bad]), jerr)
        assert got == want, front


def test_decoder_stages_and_token_rows():
    """prep / upload / run give decode's pixels; the token rows carry from
    batch to batch and hold each batch's tokens."""
    rng = np.random.default_rng(3)
    flat = [encode_png(np.repeat(random_pixels(rng, "tc8", 3, 9, hi=2), 8, axis=1), "tc8")
            for _ in range(2)]
    noisy = [encode_png(random_pixels(rng, "tc8", 24, 9), "tc8", seed=i) for i in range(2)]
    dec = BatchPngDecoder(device="cpu", device_inflate=True)
    for datas in (flat, noisy, flat):
        plan = dec.prep(datas)
        px, bad = dec.run(plan, dec.upload(plan))
        assert int(bad) == 0 and np.array_equal(px.numpy(), _host(datas))
        assert plan.main[0].shape[1] >= plan.nt
    dec.close()


@pytest.mark.parametrize("front", list(FRONTS))
def test_run_reports_each_kernel(front):
    """run's on_kernel hook sees every kernel call, in order, with the
    arguments it was given and its result: the stages chip_smoke.py times
    and the launches it holds against the plain versions."""
    datas, _ = png_batch("tc8", 13, 11, batch=2, seed=6, interlace=True)
    dec = _decoders()[front]
    seen = []
    plan = dec.prep(datas)
    px, _bad = dec.run(plan, dec.upload(plan), on_kernel=lambda *call: seen.append(call))
    names = [name for name, *_ in seen]
    assert names == ["inflate_resolve", "adler32"] * (front == "inflate") + [
        "png_defilter", "png_expand"] * 7
    for name, args, kw, res in seen:
        fn = {"inflate_resolve": inflate_resolve, "adler32": adler32_check,
              "png_defilter": png_defilter, "png_expand": png_expand}[name]
        if name == "adler32":  # each image's sum, equal to its trailer
            assert torch.equal(res, args[1]) and torch.equal(res, fn(*args[:2], args[2].clone()))
        elif name == "png_expand":  # placed on the canvas: this pass's pixels
            xo, yo, xf, yf = kw["place"]
            h, w = args[0].shape[1], kw["width"]
            assert torch.equal(res[:, yo : yo + h * yf : yf, xo : xo + w * xf : xf],
                               fn(*args, **{**kw, "out": None}))
        else:
            assert torch.equal(res, fn(*args, **kw))
    assert res is px and np.array_equal(px.numpy(), _host(datas))


@pytest.mark.parametrize("buffer", ["reused", "grown"])
def test_token_rows_widen_for_one_outlier(monkeypatch, buffer):
    """A batch whose one image needs more tokens than the carried rows
    hold (after a first batch of four images, or of one): only that image
    is tokenized again, every image's tokens move to wider rows in a
    staging buffer of their own, which the upload sends with no packing,
    and every image decodes right."""
    rng = np.random.default_rng(11)
    flat = [encode_png(np.repeat(random_pixels(rng, "tc8", 8, 64, hi=2), 8, axis=1), "tc8",
                       seed=i) for i in range(3)]
    noisy = encode_png(random_pixels(rng, "tc8", 64, 64), "tc8", seed=9)
    dec = BatchPngDecoder(device="cpu", device_inflate=True, n_threads=2)
    # the first batch tokenizes at full room: four images leave a buffer
    # that holds the wide rows, one image a buffer that does not
    dec.decode(flat + flat[:1] if buffer == "reused" else flat[:1])
    assert dec._tok_cap == tpb.TOKEN_ALIGN
    calls = {}
    real = tpb.host.inflate_tokens

    def counted(idat, *a, **kw):
        calls[idat] = calls.get(idat, 0) + 1
        return real(idat, *a, **kw)

    monkeypatch.setattr(tpb.host, "inflate_tokens", counted)
    batch = [flat[0], noisy, flat[1], flat[2]]
    plan = dec.prep(batch)
    assert [calls[tpb._walk_idat(d)[1]] for d in batch] == [1, 2, 1, 1]
    assert plan.nt > tpb.TOKEN_ALIGN and plan.main[0].shape[1] >= plan.nt
    assert dec._upload.staged(plan.parts)
    px, bad = dec.run(plan, dec.upload(plan))
    assert int(bad) == 0 and np.array_equal(px.numpy(), _host(batch))
    dec.close()


def test_decoder_bench_content_256():
    """The JAX bench's content (Paeth-heavy rows) at 256^2, every front-end,
    against the host decoder and Pillow."""
    from io import BytesIO

    from PIL import Image

    datas = [make_bench_png(256, seed) for seed in (0, 1)]
    want = _host(datas)
    pil = np.asarray(Image.open(BytesIO(datas[0])).convert("RGBA"))
    assert np.array_equal(want[0], pil)
    for front, dec in _decoders().items():
        assert np.array_equal(dec.decode(datas).numpy(), want), front


def test_decoder_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchPngDecoder()


# ---------------------------------------------- the adler32 trailer check


def _u32_as_i32(values):
    return torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in values],
                        dtype=torch.int32)


@pytest.mark.parametrize("per", [1, 15, 16, 17, 1000, 65_537])
def test_adler32_plain_matches_zlib(per):
    """The plain adler32 of random streams (and of runs of 0xFF, the largest
    sums) against zlib.adler32; a mismatch sets only ADLER_BAD."""
    import zlib

    rng = np.random.default_rng(per)
    rows = rng.integers(0, 256, (3, per), dtype=np.uint8)
    rows[2] = 0xFF
    want = _u32_as_i32([zlib.adler32(r.tobytes()) for r in rows])
    bad = torch.zeros(1, dtype=torch.int32)
    got = adler32_plain(torch.from_numpy(rows), want, bad)
    assert torch.equal(got, want) and int(bad) == 0
    off = want.clone()
    off[1] ^= 1
    assert torch.equal(adler32_check(torch.from_numpy(rows), off, bad), want)
    assert int(bad) == ADLER_BAD


ADLER_PERS = [0, 1, 15, 16, 17, ADLER_SPAN - 1, ADLER_SPAN, ADLER_SPAN + 1, 3 * ADLER_SPAN + 7]


@pytest.mark.parametrize("content", ["random", "ff"])
@pytest.mark.parametrize("per", ADLER_PERS)
def test_adler32_span_terms_match_zlib(per, content):
    """The kernel's span arithmetic (spans, head, 16-byte groups, tail,
    the (S, T) terms and their mod-65521 sum) on 16 images: row b of a
    16-byte aligned [16, per] tensor for odd ``per`` (every start 0-15
    bytes past a boundary), b bytes past one for even ``per``; all-0xFF
    images, the largest sums, inside the bounds the kernel states."""
    import zlib

    rng = np.random.default_rng(per)
    rows = rng.integers(0, 256, (16, per), dtype=np.uint8)
    if content == "ff":
        rows[:] = 0xFF
    bound = adler32_thread_bounds(ADLER_SPAN, ADLER_THREADS)
    sums = []
    for b, row in enumerate(rows):
        got = adler32_span_terms(row, (b * per) % 16 if per % 2 else b, ADLER_SPAN,
                                 ADLER_THREADS)
        assert got["sum"] == zlib.adler32(row.tobytes()), b
        assert all(got[k] <= v for k, v in bound.items()), (b, got, bound)
        sums.append(got["sum"])
    want = adler32_plain(torch.from_numpy(rows), torch.zeros(16, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    assert torch.equal(_u32_as_i32(sums), want)


@pytest.mark.parametrize("span", [16, 4096, 1 << 17, 1 << 20])
def test_adler32_span_bounds_every_span(span):
    """Two all-0xFF spans and a tail at each span the kernel takes: the sum
    is zlib's and no accumulator passes the stated bound (a thread's w
    passes 2^32 from 2^17 bytes a span, so it is 64 bits wide)."""
    import zlib

    row = np.full(2 * span + 3, 0xFF, np.uint8)
    bound = adler32_thread_bounds(span, ADLER_THREADS)
    got = adler32_span_terms(row, 5, span, ADLER_THREADS)
    assert got["sum"] == zlib.adler32(row.tobytes())
    assert all(got[k] <= v for k, v in bound.items()), (got, bound)
    assert (got["thread_w"] >= 1 << 32) == (span >= 1 << 17)


def test_valid_batch_passes_the_trailer_check():
    """device_inflate on valid files of every deflate mode: the trailers
    uploaded are zlib's adler32 of each image, the flag stays 0, and the
    pixels are the host decoder's."""
    import zlib

    rng = np.random.default_rng(4)
    datas = [encode_png(random_pixels(rng, "tc8", 23, 9), "tc8", strategy=s, seed=i)
             for i, s in enumerate(("stored", "fixed", "rle", "default"))]
    dec = BatchPngDecoder(device="cpu", device_inflate=True, n_threads=2)
    plan = dec.prep(datas)
    want = [zlib.adler32(zlib.decompress(tpb._walk_idat(d)[1])) for d in datas]
    assert plan.main[3].tolist() == want
    px, bad = dec.run(plan, dec.upload(plan))
    assert int(bad) == 0 and np.array_equal(px.numpy(), _host(datas))
    dec.close()


@pytest.mark.parametrize("cut", [1, 3, 4])
def test_short_trailer_raises_as_host(cut):
    """A zlib stream with fewer than four bytes after its final block:
    device_inflate raises the host decoder's error, as the other routes."""
    from _torch_png import chunk

    pix = random_pixels(np.random.default_rng(7), "tc8", 16, 8)
    good = encode_png(pix, "tc8")
    _st, idat, _n = tpb._walk_idat(good)
    bad = good[:33] + chunk(b"IDAT", idat[:-cut]) + chunk(b"IEND", b"")
    want = _error(lambda: jax_png.decode(bad), jerr)
    assert "incomplete or truncated stream" in want[1]
    for front, dec in _decoders().items():
        assert _error(lambda: dec.decode([good, bad]), terr) == want, front
