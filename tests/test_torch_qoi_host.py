"""The port's QOI host C++ (csrc/host/qoi.cpp) and host passes
(parallel/qoi_batch.py) against zpix_tpu's build of the same source and
zpix_tpu's passes, field for field.  Exact: tolerance 0.

Each C entry point is called in both libraries with the same arguments on
valid, truncated and short streams, at lane widths and record capacities
that make it return every code (0 ok, 1 short, 3 overflow, 4 bad P, 5
alpha); then the port's ``prep_qoi_records``, ``prep_qoi_lanes`` and
``prep_qoi_lanes4`` against zpix_tpu's, every array and P, R, rcap, fill.
"""

import ctypes
import functools
import importlib

import numpy as np
import pytest
from _torch_jpeg import jax_native_lib
from _torch_raster import encode_cases, qoi_enc, qoi_images, structured_pixels

from zpix_tpu import errors as jerr
from zpix_tpu.codecs.qoi.decode import decode as jax_decode
from zpix_tpu.codecs.qoi.encode import Desc as JDesc
from zpix_tpu.codecs.qoi.encode import encode as jax_encode
from zpix_tpu.parallel import qoi_batch as jq
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.codecs.qoi.decode import decode_pixels
from zpix_tpu_torch.parallel import qoi_batch as tq
from zpix_tpu_torch.runtime import host

# the port's host encoder module (the package exports its function ``encode``)
te = importlib.import_module("zpix_tpu_torch.codecs.qoi.encode")


def _noise256():
    """The JAX bench's default QOI content ("noise", bench.py
    make_bench_qoi) at 256 x 256."""
    rng = np.random.RandomState(0)
    x = np.linspace(0, 20, 256)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]))).astype(np.uint8)
    noise = rng.randint(0, 8, (256, 256)).astype(np.uint8)
    return np.stack([base ^ noise, base.T, base // 2 + 64, np.full_like(base, 255)], -1)


STREAM_NAMES = ["img0", "img1", "img2", "img3", "truncated", "cut_in_op", "short_count",
                "run_clip", "structured", "noise256", "short"]


@functools.cache
def _streams():
    """name -> (stream, pixel count to pass); made on first use, not at
    import (the port's encoder builds the host library)."""
    imgs = qoi_images()
    datas = [qoi_enc(i) for i in imgs]
    out = {f"img{i}": (d, 960) for i, d in enumerate(datas)}
    out["truncated"] = (datas[3][: len(datas[3]) // 2] + b"\x00" * 8, 960)
    out["cut_in_op"] = (datas[3][:40], 960)
    out["short_count"] = (datas[2], 955)  # records clipped at the pixel count
    out["run_clip"] = (qoi_enc(np.full((6, 11, 4), 200, np.uint8)), 66)
    out["structured"] = (qoi_enc(structured_pixels(np.random.default_rng(1), 30, 64)), 1920)
    out["noise256"] = (qoi_enc(_noise256()), 65536)
    out["short"] = (b"qoif" + b"\x00" * 10, 16)  # header only: rc 1
    assert list(out) == STREAM_NAMES
    return out


def _ptr(lib_is_jax, a, ctype):
    """An array argument: a typed pointer for zpix_tpu's library (its
    argtypes are POINTER types), the address for the port's."""
    return ctypes.cast(a.ctypes.data, ctypes.POINTER(ctype)) if lib_is_jax else a.ctypes.data


def _libs():
    return [(True, jax_native_lib()), (False, host.lib())]


@pytest.mark.parametrize("rcap", [None, 1])
@pytest.mark.parametrize("name", STREAM_NAMES)
def test_record_scan_matches(name, rcap):
    data, npx = _streams()[name]
    res = []
    for is_jax, lib in _libs():
        cap = rcap or max(1, len(data))
        cols = np.zeros(cap, np.uint32)
        cnts = np.zeros(cap, np.uint8)
        n, fill = ctypes.c_int64(), ctypes.c_uint32()
        rc = lib.zpix_qoi_record_scan(data, len(data), npx, _ptr(is_jax, cols, ctypes.c_uint32),
                                      _ptr(is_jax, cnts, ctypes.c_uint8), cap,
                                      ctypes.byref(n), ctypes.byref(fill))
        res.append((rc, n.value, fill.value, cols, cnts))
    (rc, n, fill, cols, cnts), (rc2, n2, fill2, cols2, cnts2) = res
    assert (rc, n, fill) == (rc2, n2, fill2)
    assert np.array_equal(cols, cols2) and np.array_equal(cnts, cnts2)
    if name == "short":
        assert rc == 1
    if rcap == 1 and name != "short":
        assert rc == 3


@pytest.mark.parametrize("P", [8, 16, 48, 960, 40000])
@pytest.mark.parametrize("name", ["img0", "img3", "truncated", "run_clip", "structured", "short"])
def test_lane_scan_matches(name, P):
    data, npx = _streams()[name]
    res = []
    for is_jax, lib in _libs():
        n_lanes = -(-npx // P)
        ecap = max(1, len(data)) + n_lanes + 1
        cols = np.zeros(ecap, np.uint32)
        s = np.zeros(ecap, np.int16)
        e = np.zeros(ecap, np.int16)
        cnt = np.zeros(n_lanes, np.int32)
        m, fill = ctypes.c_int64(), ctypes.c_uint32()
        rc = lib.zpix_qoi_lane_scan(
            data, len(data), npx, P, _ptr(is_jax, cols, ctypes.c_uint32),
            _ptr(is_jax, s, ctypes.c_int16), _ptr(is_jax, e, ctypes.c_int16), ecap,
            _ptr(is_jax, cnt, ctypes.c_int32), n_lanes, ctypes.byref(m), ctypes.byref(fill))
        res.append((rc, m.value, fill.value, cols, s, e, cnt))
    a, b = res
    assert a[:3] == b[:3]
    assert all(np.array_equal(x, y) for x, y in zip(a[3:], b[3:]))
    if P == 40000 and name != "short":
        assert a[0] == 4


@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("name", ["img0", "img1", "img3", "truncated", "structured", "noise256"])
def test_lane_fills_equal_the_lane_scan(name, P):
    """The port's two fills against its own unfused lane scan: each lane's
    entries, in decode order, in its first slots, the rest padded (wide:
    s 1, e 0; p4: start P); fill4 refuses a stream with alpha (rc 5)."""
    data, npx = _streams()[name]
    lib = host.lib()
    n_lanes = npx // P
    ecap = len(data) + n_lanes + 1
    cols, s, e = np.zeros(ecap, np.uint32), np.zeros(ecap, np.int16), np.zeros(ecap, np.int16)
    cnt = np.zeros(n_lanes, np.int32)
    m, fill = ctypes.c_int64(), ctypes.c_uint32()
    assert lib.zpix_qoi_lane_scan(data, len(data), npx, P, cols.ctypes.data, s.ctypes.data,
                                  e.ctypes.data, ecap, cnt.ctypes.data, n_lanes,
                                  ctypes.byref(m), ctypes.byref(fill)) == 0
    m, R = m.value, int(cnt.max())
    cols, s, e = cols[:m], s[:m], e[:m]
    lane = np.repeat(np.arange(n_lanes), cnt)
    slot = np.arange(m) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    want_s, want_e = np.ones((n_lanes, R), np.int16), np.zeros((n_lanes, R), np.int16)
    want_s[lane, slot], want_e[lane, slot] = s, e

    wc = np.zeros((n_lanes, R), np.uint32)
    ws, we = np.zeros((n_lanes, R), np.int16), np.zeros((n_lanes, R), np.int16)
    need, fill2 = ctypes.c_int32(), ctypes.c_uint32()
    assert lib.zpix_qoi_lane_fill(data, len(data), npx, P, R, wc.ctypes.data, ws.ctypes.data,
                                  we.ctypes.data, ctypes.byref(need), ctypes.byref(fill2)) == 0
    assert (need.value, fill2.value) == (R, fill.value)
    assert np.array_equal(ws, want_s) and np.array_equal(we, want_e)
    assert np.array_equal(wc[lane, slot], cols)

    p4 = np.zeros((n_lanes, R * 4), np.uint8)
    rc = lib.zpix_qoi_lane_fill4(data, len(data), npx, P, R, p4.ctypes.data,
                                 ctypes.byref(need), ctypes.byref(fill2))
    opaque = bool(((cols & 0xFF) == 0xFF).all())
    assert rc == (0 if opaque else 5)
    if opaque:
        want = np.zeros((n_lanes, R, 4), np.uint8)
        want[..., 3] = P
        want[lane, slot] = np.stack([cols >> 24, cols >> 16, cols >> 8, s], -1).astype(np.uint8)
        assert np.array_equal(p4.reshape(n_lanes, R, 4), want)


@pytest.mark.parametrize("P,R", [(16, 8), (16, 2), (60, 24), (32767, 600), (40000, 8)])
@pytest.mark.parametrize("name", ["img0", "img2", "img3", "truncated", "short_count",
                                  "structured"])
def test_lane_fill_matches(name, P, R):
    data, npx = _streams()[name]
    if P <= 32767 and npx % P:
        P = next(q for q in range(P, 0, -1) if npx % q == 0)
    n_lanes = -(-npx // P)
    res = []
    for is_jax, lib in _libs():
        cols = np.zeros((n_lanes, R), np.uint32)
        s = np.zeros((n_lanes, R), np.int16)
        e = np.zeros((n_lanes, R), np.int16)
        need, fill = ctypes.c_int32(), ctypes.c_uint32()
        rc = lib.zpix_qoi_lane_fill(data, len(data), npx, P, R,
                                    _ptr(is_jax, cols, ctypes.c_uint32),
                                    _ptr(is_jax, s, ctypes.c_int16),
                                    _ptr(is_jax, e, ctypes.c_int16),
                                    ctypes.byref(need), ctypes.byref(fill))
        res.append((rc, need.value, fill.value, cols, s, e))
    a, b = res
    assert a[:3] == b[:3]
    assert all(np.array_equal(x, y) for x, y in zip(a[3:], b[3:]))
    if P == 40000:
        assert a[0] == 4


@pytest.mark.parametrize("P,R", [(16, 8), (16, 2), (240, 24), (300, 8)])
@pytest.mark.parametrize("name", ["img0", "img1", "img3", "truncated", "structured",
                                  "noise256"])
def test_lane_fill4_matches(name, P, R):
    """rc 0, 3 (R too small), 4 (P past 255) and 5 (alpha in the stream)."""
    data, npx = _streams()[name]
    n_lanes = -(-npx // P)
    res = []
    for is_jax, lib in _libs():
        p4 = np.zeros((n_lanes, R * 4), np.uint8)
        need, fill = ctypes.c_int32(), ctypes.c_uint32()
        rc = lib.zpix_qoi_lane_fill4(data, len(data), npx, P, R,
                                     _ptr(is_jax, p4, ctypes.c_uint8), ctypes.byref(need),
                                     ctypes.byref(fill))
        res.append((rc, need.value, fill.value, p4))
    a, b = res
    assert a[:3] == b[:3] and np.array_equal(a[3], b[3])
    if P == 300:
        assert a[0] == 4
    elif name in ("img3", "truncated", "structured"):
        assert a[0] == 5


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_decode_matches(name):
    data, _ = _streams()[name]
    try:
        want = jax_decode(data).pix
    except jerr.ZpixError as exc:
        with pytest.raises(getattr(terr, type(exc).__name__)):
            decode_pixels(data)
        return
    got = decode_pixels(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_decode_header_errors_match():
    good = _streams()["img0"][0]
    bad = {"short": good[:21], "magic": b"qoix" + good[4:],
           "zero_width": good[:4] + b"\x00" * 4 + good[8:],
           "channels": good[:12] + b"\x05" + good[13:],
           "colorspace": good[:13] + b"\x02" + good[14:]}
    for name, data in bad.items():
        with pytest.raises(jerr.FormatError) as want:
            jax_decode(data)
        with pytest.raises(terr.FormatError) as got:
            decode_pixels(data)
        assert str(got.value) == str(want.value), name


@pytest.mark.parametrize("case", range(len(encode_cases())))
def test_encode_matches(case):
    img, ch = encode_cases()[case]
    h, w = img.shape[:2]
    assert te.encode(img, te.Desc(w, h, ch, 0)) == jax_encode(img, JDesc(w, h, ch, 0))
    assert te.encode(img, te.Desc(w, h, ch, 1)) == jax_encode(img, JDesc(w, h, ch, 1))


def test_encode_descriptor_errors_match():
    img = qoi_images()[0]
    for d in [(0, 24, 4, 0), (40, 24, 2, 0), (40, 24, 4, 2), (40, 10**8, 4, 0)]:
        with pytest.raises(jerr.FormatError):
            jax_encode(img, JDesc(*d))
        with pytest.raises(terr.FormatError):
            te.encode(img, te.Desc(*d))
    with pytest.raises(terr.FormatError):
        te.encode(img[:10], te.Desc(40, 24, 4, 0))  # pixel buffer too small


BATCH_NAMES = ["all", "opaque", "truncated", "noise256"]


@functools.cache
def _batches():
    imgs = qoi_images()
    datas = [qoi_enc(i) for i in imgs]
    opaque = [qoi_enc(i) for i in imgs if (i[..., 3] == 255).all()]
    trunc = _streams()["truncated"][0]
    return {"all": datas, "opaque": opaque, "truncated": [datas[0], trunc],
            "noise256": [_streams()["noise256"][0]] * 2}


@pytest.mark.parametrize("hint", [None, 300000])
@pytest.mark.parametrize("batch", BATCH_NAMES)
def test_prep_records_matches(batch, hint):
    a = jq.prep_qoi_records(_batches()[batch], hint)
    b = tq.prep_qoi_records(_batches()[batch], hint)
    assert (a.width, a.height, a.batch, a.rcap) == (b.width, b.height, b.batch, b.rcap)
    for f in ("cols", "cnts", "fill"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("P,hint", [(None, None), (16, None), (7, None), (16, 40), (60, 3),
                                    (65536, None)])
@pytest.mark.parametrize("batch", BATCH_NAMES)
def test_prep_lanes_matches(batch, P, hint):
    """The wide form: the default P, the shrink of a non-divisor P (7 -> 6
    on 960 pixels), the int16 limit (65536 -> at most 32767, then a
    divisor), an R hint above and below the need."""
    a = jq.prep_qoi_lanes(_batches()[batch], P, hint)
    b = tq.prep_qoi_lanes(_batches()[batch], P, hint)
    assert (a.P, a.R, a.batch, a.fmt) == (b.P, b.R, b.batch, b.fmt)
    assert b.P <= 32767 and (b.width * b.height) % b.P == 0
    assert np.array_equal(a.s, b.s) and np.array_equal(a.e, b.e)
    used = b.s < b.e  # the fill leaves the colours of empty slots unwritten
    assert np.array_equal(a.cols[used], b.cols[used])
    again = tq.prep_qoi_lanes(_batches()[batch], P, b.R, out=(b.cols, b.s, b.e))
    assert again.cols is b.cols and np.array_equal(again.s, a.s)


@pytest.mark.parametrize("P,hint", [(None, None), (16, None), (256, None), (7, 40)])
@pytest.mark.parametrize("batch", BATCH_NAMES)
def test_prep_lanes4_matches(batch, P, hint):
    """The p4 form, or None on alpha content, as zpix_tpu decides."""
    a = jq.prep_qoi_lanes4(_batches()[batch], P, hint)
    b = tq.prep_qoi_lanes4(_batches()[batch], P, hint)
    if a is None:
        assert b is None
        return
    assert (a.P, a.R, a.batch, a.fmt) == (b.P, b.R, b.batch, b.fmt) and b.P <= 255
    assert np.array_equal(a.p4, b.p4)
    again = tq.prep_qoi_lanes4(_batches()[batch], P, b.R, out=b.p4)
    assert again.p4 is b.p4 and np.array_equal(again.p4, a.p4)


def test_prep_rejects_mixed_and_short():
    datas = _batches()["all"]
    other = qoi_enc(qoi_images(w=20)[0])
    for prep in (tq.prep_qoi_records, tq.prep_qoi_lanes, tq.prep_qoi_lanes4):
        with pytest.raises(terr.UnsupportedError):
            prep([datas[0], other])
        with pytest.raises(ValueError):
            prep([])
    with pytest.raises(terr.FormatError):
        tq._record_scan_native(_streams()["short"][0], 16)
