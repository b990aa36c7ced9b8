"""The port's PNG host side against zpix_tpu's.  Exact: tolerance 0.

* The C++ copies (csrc/host/inflate.cpp, csrc/host/defilter.cpp) against
  zpix_tpu's build of the same sources: ``zpix_inflate_tokens`` on every
  output and return code (-101 on bad streams, -102 on overflow),
  ``zpix_defilter`` and ``zpix_defilter_batch`` outputs and return codes;
  ``inflate_tokens`` and ``zlib_decompress_sized`` against zpix_tpu's.
* The chunk layer and the batch parse (``_walk_chunks``, ``_parse_ihdr``,
  ``_parse_plte``, ``_parse_trns`` through ``_walk_idat``,
  ``parse_filtered``, ``parse_tokens``) against zpix_tpu's, on the test
  writer's files and their damaged variants: the same state, bytes and
  tokens, or the same exception class and message.  The three cases the
  port repairs (a short stream, a filter type above 4, a corrupt deflate
  stream) are held against the host decoder instead.
"""

import ctypes
import functools
import struct

import numpy as np
import pytest
from _torch_jpeg import jax_native_lib
from _torch_png import chunk, encode_png, png_batch, random_pixels

from zpix_tpu import errors as jerr
from zpix_tpu import runtime as jrt
from zpix_tpu.codecs import png as jax_png
from zpix_tpu.codecs.png.decode import _walk_chunks as jax_walk_chunks
from zpix_tpu.parallel import png_batch as jpb
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.codecs.png.decode import _walk_chunks
from zpix_tpu_torch.parallel import png_batch as tpb
from zpix_tpu_torch.runtime import host

STRATEGIES = ("stored", "fixed", "rle", "default")


def _flat(rng, w=40, h=23):
    """Low-entropy tc8 samples: long runs for the copy-heavy modes."""
    return np.repeat(random_pixels(rng, "tc8", w // 8, h, hi=3), 8, axis=1)[:, :w]


@functools.cache
def _token_streams():
    """name -> (zlib stream, inflated size) for the tokenizer."""
    rng = np.random.default_rng(11)
    out = {}
    for s in STRATEGIES:
        for kind, pix in (("noise", random_pixels(rng, "tc8", 40, 23)), ("flat", _flat(rng))):
            data = encode_png(pix, "tc8", strategy=s, idat_chunks=3)
            _st, idat, expected = jpb._walk_idat(data)
            out[f"{s}_{kind}"] = (idat, expected)
    pix = random_pixels(rng, "tc8", 16, 8)
    for dmg in ("deflate", "short"):
        _st, idat, expected = jpb._walk_idat(encode_png(pix, "tc8", damage=dmg, filters=[0]))
        out[dmg] = (idat, expected)
    out["empty"] = (b"", 10)
    out["header_only"] = (b"\x78\x9c", 10)
    return out


def _call_tokens(lib, is_jax, data, wrap, max_tokens, max_out):
    lens, dists = np.full(max_tokens + 1, -7, np.int32), np.full(max_tokens + 1, -7, np.int32)
    lits = np.full(max_tokens + 1, 77, np.uint8)
    ob = ctypes.c_int64(-1)

    def p(a, t):
        return ctypes.cast(a.ctypes.data, ctypes.POINTER(t)) if is_jax else a.ctypes.data

    nt = lib.zpix_inflate_tokens(data, len(data), wrap, p(lens, ctypes.c_int32),
                                 p(dists, ctypes.c_int32), p(lits, ctypes.c_uint8), max_tokens,
                                 max_out, ctypes.byref(ob))
    return nt, ob.value, lens, dists, lits


@pytest.mark.parametrize("room", ["exact", "few_tokens", "small_out"])
@pytest.mark.parametrize("name", ["stored_noise", "stored_flat", "fixed_noise", "fixed_flat",
                                  "rle_noise", "rle_flat", "default_noise", "default_flat",
                                  "deflate", "short", "empty", "header_only"])
def test_inflate_tokens_native_matches(name, room):
    data, expected = _token_streams()[name]
    max_tokens, max_out = {"exact": (expected + 1, expected), "few_tokens": (9, expected),
                           "small_out": (expected + 1, expected // 2)}[room]
    got = _call_tokens(host.lib(), False, data, 1, max_tokens, max_out)
    want = _call_tokens(jax_native_lib(), True, data, 1, max_tokens, max_out)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert np.array_equal(a, b)
    if room != "exact" and name not in ("deflate", "empty", "header_only"):
        assert got[0] == -102
    if name in ("deflate", "empty", "header_only"):
        assert got[0] == -101


def test_inflate_tokens_raw_deflate_matches():
    """zlib_wrap = 0: a raw deflate stream (the zlib header stripped)."""
    data, expected = _token_streams()["default_noise"]
    got = _call_tokens(host.lib(), False, data[2:], 0, expected + 1, expected)
    want = _call_tokens(jax_native_lib(), True, data[2:], 0, expected + 1, expected)
    assert got[0] > 0 and got[:2] == want[:2]
    assert all(np.array_equal(a, b) for a, b in zip(got[2:], want[2:]))


@pytest.mark.parametrize("name", ["default_noise", "rle_flat", "short", "deflate"])
def test_inflate_tokens_wrapper_matches(name):
    data, expected = _token_streams()[name]
    try:
        want = jrt.inflate_tokens(data, expected)
    except jerr.ZpixError as exc:
        with pytest.raises(getattr(terr, type(exc).__name__)) as got:
            host.inflate_tokens(data, expected)
        assert str(got.value) == str(exc)
        return
    got = host.inflate_tokens(data, expected)
    assert got[3] == want[3]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got[:3], want[:3]))
    # into caller arrays: views of them, the same tokens; too short -> None
    out = tuple(np.zeros(expected + 1, dt) for dt in (np.int32, np.int32, np.uint8))
    into = host.inflate_tokens(data, expected, out=out)
    assert all(np.shares_memory(a, o) and np.array_equal(a, b)
               for a, o, b in zip(into[:3], out, want[:3]))
    short = tuple(a[:5] for a in out)
    assert host.inflate_tokens(data, expected, out=short) is None


@pytest.mark.parametrize("name", ["stored_noise", "fixed_flat", "rle_noise", "default_noise"])
def test_inflate_tokens_trailer(name):
    """The trailer the tokenizer returns: zlib's adler32 of the stream
    (the four bytes after the final block, byte-aligned); None when fewer
    than four follow or the stream is raw deflate.  The tokens stay those
    of zpix_tpu's tokenizer."""
    import zlib

    data, expected = _token_streams()[name]
    got = host.inflate_tokens(data, expected)
    assert got[4] == zlib.adler32(zlib.decompress(data))
    want = jrt.inflate_tokens(data, expected)
    assert got[3] == want[3] and all(np.array_equal(a, b) for a, b in zip(got[:3], want[:3]))
    for cut in (1, 3):
        assert host.inflate_tokens(data[:-cut], expected)[4] is None
    assert host.inflate_tokens(data[:-4] + b"\x01\x02\x03\x04\x05", expected)[4] == 0x01020304
    assert host.inflate_tokens(data[2:-4], expected, zlib_wrap=False)[4] is None


def test_zlib_decompress_sized_matches():
    rng = np.random.default_rng(4)
    _st, idat, expected = jpb._walk_idat(encode_png(random_pixels(rng, "tc8", 30, 7), "tc8"))
    for size in (expected, expected - 1, expected + 1):
        assert host.zlib_decompress_sized(idat, size) == jrt.zlib_decompress_sized(idat, size)
    if host.libdeflate_available():
        out = np.zeros(expected, np.uint8)
        assert host.zlib_decompress_sized(idat, expected, out) is out
        assert out.tobytes() == jrt.zlib_decompress_sized(idat, expected)


def _filtered(rng, h, rb, bpp, bad_row=None):
    ft = rng.integers(0, 5, h).astype(np.uint8)
    if bad_row is not None:
        ft[bad_row] = 7
    raw = rng.integers(0, 256, (h, 1 + rb), dtype=np.uint8)
    raw[:, 0] = ft
    return raw.tobytes()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_defilter_native_matches(bpp):
    """Every filter type, every bpp, rows long enough for the SSE2 arms and
    rows shorter than 8 bytes; an invalid type gives rc 1 in both."""
    rng = np.random.default_rng(bpp)
    for h, rb, bad in ((13, 5 * bpp, None), (9, 37 * bpp, None), (6, 4 * bpp, 3)):
        raws = [_filtered(rng, h, rb, bpp, bad) for _ in range(3)]
        outs = {}
        for is_jax, lib in ((True, jax_native_lib()), (False, host.lib())):
            single = [np.zeros((h, rb), np.uint8) for _ in raws]
            rcs = []
            for r, o in zip(raws, single):
                dst = (o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if is_jax
                       else o.ctypes.data)
                rcs.append(lib.zpix_defilter(r, h, rb, bpp, dst))
            batch = [np.zeros((h, rb), np.uint8) for _ in raws]
            if is_jax:
                rp = (ctypes.c_char_p * 3)(*raws)
                op = (ctypes.POINTER(ctypes.c_uint8) * 3)(
                    *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for o in batch])
            else:
                keep = [np.frombuffer(r, np.uint8) for r in raws]
                rp = (ctypes.c_void_p * 3)(*[k.ctypes.data for k in keep])
                op = (ctypes.c_void_p * 3)(*[o.ctypes.data for o in batch])
            brc = lib.zpix_defilter_batch(rp, h, rb, bpp, op, 3, 2)
            outs[is_jax] = (rcs, brc, single, batch)
        (rc_j, brc_j, s_j, b_j), (rc_t, brc_t, s_t, b_t) = outs[True], outs[False]
        assert rc_j == rc_t and brc_j == brc_t and brc_t == (1 if bad is not None else 0)
        if bad is None:
            assert all(np.array_equal(a, b) for a, b in zip(s_j + b_j, s_t + b_t))


# --------------------------------------------------------------- parse layer


def _ihdr(data, **kw):
    """data with IHDR fields replaced (w, h, depth, ctype, comp, filt,
    interlace) and its CRC recomputed."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(kw)
    return data[:8] + chunk(b"IHDR", struct.pack(">IIBBBBB", *vals.values())) + data[33:]


def _insert(data, tag, payload):
    """data with a chunk inserted after IHDR."""
    return data[:33] + chunk(tag, payload) + data[33:]


@functools.cache
def _files():
    rng = np.random.default_rng(21)
    tc8 = random_pixels(rng, "tc8", 16, 8)
    good = encode_png(tc8, "tc8")
    p8, _ = png_batch("p8", 11, 5, batch=1, seed=2, short=True)
    g8 = encode_png(random_pixels(rng, "g8", 9, 4), "g8")
    ga8 = encode_png(random_pixels(rng, "ga8", 9, 4), "ga8")
    out = {}
    for cd in ("g1", "g4", "g16", "tc8", "tc16", "p2", "p8", "tca16", "ga8"):
        for inter in (False, True):
            files, _ = png_batch(cd, 13, 9, batch=1, seed=len(cd), interlace=inter,
                                 trns=cd not in ("tca16", "ga8"), short=cd == "p2")
            out[f"{cd}_{'adam7' if inter else 'plain'}"] = files[0]
    out["idat_split"] = encode_png(tc8, "tc8", idat_chunks=4)
    out.update({
        "signature": b"\x89PNX" + good[4:],
        "crc": encode_png(tc8, "tc8", damage="crc"),
        "truncated_header": good[:8 + 5],
        "truncated_chunk": good[:-20],
        "missing_iend": good[:-12],
        "ihdr_length": good[:8] + chunk(b"IHDR", good[16:28]) + good[33:],
        "color_depth": _ihdr(good, depth=4),
        "compression": _ihdr(good, comp=1),
        "filter_method": _ihdr(good, filt=1),
        "interlace_method": _ihdr(good, interlace=2),
        "zero_width": _ihdr(good, w=0),
        "plte_length": _insert(p8[0], b"PLTE", b"\x01\x02\x03\x04"),
        "plte_gray": _insert(g8, b"PLTE", b"\x01\x02\x03"),
        "trns_length": _insert(good, b"tRNS", b"\x00\x01"),
        "trns_before_plte": _insert(p8[0], b"tRNS", b"\x10\x20"),
        "trns_ga": _insert(ga8, b"tRNS", b"\x00\x01"),
        "plte_too_long": _insert(_ihdr(p8[0], depth=1), b"PLTE", bytes(9)),
        "wider_than_stream": _ihdr(good, w=17),  # the stream is short for the IHDR
    })
    for dmg in ("short", "filter", "deflate"):
        for inter in (False, True):
            out[f"{dmg}_{'adam7' if inter else 'plain'}"] = encode_png(
                tc8, "tc8", damage=dmg, interlace=inter, filters=[0])
    return out


REPAIRED = {"short_plain", "short_adam7", "filter_plain", "filter_adam7", "deflate_plain",
            "deflate_adam7", "wider_than_stream"}
FILE_NAMES = ["g1_plain", "g1_adam7", "g4_plain", "g4_adam7", "g16_plain", "g16_adam7",
              "tc8_plain", "tc8_adam7", "tc16_plain", "tc16_adam7", "p2_plain", "p2_adam7",
              "p8_plain", "p8_adam7", "tca16_plain", "tca16_adam7", "ga8_plain", "ga8_adam7",
              "idat_split", "signature", "crc", "truncated_header", "truncated_chunk",
              "missing_iend", "ihdr_length", "color_depth", "compression", "filter_method",
              "interlace_method", "zero_width", "plte_length", "plte_gray", "trns_length",
              "trns_before_plte", "trns_ga", "plte_too_long", "wider_than_stream", "short_plain",
              "short_adam7", "filter_plain", "filter_adam7", "deflate_plain", "deflate_adam7"]


def _state(st):
    return (st.width, st.height, st.depth, st.color_type, st.color_depth, st.interlace,
            None if st.palette is None else st.palette.tolist(),
            None if st.palette_kinds is None else st.palette_kinds.tolist(),
            st.use_transparent, bytes(st.transparent))


def _outcome(fn, data, errors):
    try:
        return "ok", fn(data)
    except errors.ZpixError as exc:
        return type(exc).__name__, str(exc)


def test_file_names_cover_files():
    assert sorted(FILE_NAMES) == sorted(_files())


@pytest.mark.parametrize("name", FILE_NAMES)
def test_chunk_walk_and_idat_walk_match(name):
    data = _files()[name]
    assert (_outcome(lambda d: list(_walk_chunks(d)), data, terr)
            == _outcome(lambda d: list(jax_walk_chunks(d)), data, jerr))
    got = _outcome(tpb._walk_idat, data, terr)
    want = _outcome(jpb._walk_idat, data, jerr)
    if got[0] == "ok":
        assert want[0] == "ok"
        assert _state(got[1][0]) == _state(want[1][0]) and got[1][1:] == want[1][1:]
    else:
        assert got == want


def _host_error(data):
    with pytest.raises(jerr.ZpixError) as exc:
        jax_png.decode(data)
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("name", FILE_NAMES)
def test_parse_filtered_matches(name):
    """The same state and inflated bytes as zpix_tpu's parse_filtered, or
    the same error; where the port repairs zpix_tpu (a stream short for
    the IHDR, a filter type above 4, a corrupt deflate stream), the host
    decoder's error."""
    data = _files()[name]
    got = _outcome(tpb.parse_filtered, data, terr)
    if name in REPAIRED:
        assert got == _host_error(data)
        return
    want = _outcome(jpb.parse_filtered, data, jerr)
    if got[0] == "ok":
        assert want[0] == "ok"
        assert _state(got[1][0]) == _state(want[1][0]) and got[1][1] == want[1][1]
    else:
        assert got == want


@pytest.mark.parametrize("name", FILE_NAMES)
def test_parse_tokens_matches(name):
    """The same state and tokens as zpix_tpu's parse_tokens, or the same
    error (zpix_tpu's own messages: this route's size check is already
    right, and its filter types are checked on the card)."""
    data = _files()[name]
    got = _outcome(tpb.parse_tokens, data, terr)
    want = _outcome(jpb.parse_tokens, data, jerr)
    if got[0] == "ok":
        assert want[0] == "ok"
        assert _state(got[1][0]) == _state(want[1][0])
        assert all(np.array_equal(a, b) for a, b in zip(got[1][1:], want[1][1:]))
    else:
        assert got == want


def test_png_modules_and_writer_load_neither_jax_nor_the_jax_package():
    """The chip machine has no JAX: the PNG modules and the tests' writer
    (which chip_smoke.py loads by path) import none of it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.path.insert(0, 'tests')\n"
        "import zpix_tpu_torch.parallel.png_batch, zpix_tpu_torch.ops.png, "
        "zpix_tpu_torch.ops.inflate, zpix_tpu_torch.ops.defilter, _torch_png\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'zpix_tpu' or m.startswith('zpix_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
