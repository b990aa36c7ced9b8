"""The port's host JPEG decoder (zpix_tpu_torch.codecs.jpeg) against
zpix_tpu's: planes, ``rgba_pixels``, image class and ``decode_config``,
and on damaged streams the exception's type and message; both with the
C++ scan (``zpix_decode_scan``, against zpix_tpu's native scan) and with
the Python scan (``native=False``, against zpix_tpu's Python scan).
Then the two scans of the port against each other on coefficients.
Exact: tolerance 0."""

import numpy as np
import pytest
from _torch_jpeg import (ARMS, encode_baseline, synth_jpeg, synth_plain_jpeg,
                         synth_progressive, synth_ratio_jpeg, truncate_scan)

import zpix_tpu.codecs.jpeg as jj
import zpix_tpu.runtime as jrt
from zpix_tpu.codecs.jpeg import decoder as jdec
from zpix_tpu_torch.codecs import jpeg as tj
from zpix_tpu_torch.codecs.jpeg import decoder as tdec

RATIOS = {"444": ((1, 1),) * 3, "422": ((2, 1), (1, 1), (1, 1)),
          "420": ((2, 2), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
          "411": ((4, 1), (1, 1), (1, 1)), "410": ((4, 2), (1, 1), (1, 1)),
          "420_h2": ((2, 2), (2, 1), (2, 1)), "gray": ((1, 1),),
          "factor3": ((3, 1),) * 3}

# corruption spliced before the first RST1 (the reference's matrix,
# zpix src/jpeg/decoder.zig:2228-2279): findRst resyncs or raises
RST_INFIXES = [b"", b"\x00", b"\x61", b"\x61\x62\x63\xff\x00\x64", b"\xff", b"\xff\x00",
               b"\xff\xff\xff\x00\xff\x00\x00\xff\xff\xff", b"\xff\x03", b"\xff\xd5",
               b"\xff\xff\xd5"]


def _splice_rst(data: bytes, infix: bytes) -> bytes:
    at = data.index(b"\xff\xd1")
    return data[:at] + infix + data[at:]


def _streams():
    """name -> JPEG bytes: every input the comparisons run on."""
    out = {f"arm_{k}": f() for k, f in ARMS.items()}
    for name, hv in RATIOS.items():
        out[f"ratio_{name}"] = synth_ratio_jpeg(hv, width=43, height=27, seed=1)
        out[f"ratio_{name}_dri2"] = synth_ratio_jpeg(hv, width=43, height=27, seed=2, dri=2)
    out["multi_scan_420"] = synth_ratio_jpeg(RATIOS["420"], 43, 27, 3, scans="separate")
    out["multi_scan_gray"] = synth_ratio_jpeg(RATIOS["gray"], 43, 27, 3, scans="separate")
    out["rgb_adobe_422"] = synth_ratio_jpeg(RATIOS["422"], 43, 27, 4, adobe=0)
    quad = ((2, 2), (1, 1), (1, 1), (2, 2))
    out["cmyk_2211"] = synth_ratio_jpeg(quad, 43, 27, 5, adobe=0)
    out["ycck_2211_dri3"] = synth_ratio_jpeg(quad, 43, 27, 6, dri=3, adobe=2)
    out["cmyk_no_adobe"] = synth_ratio_jpeg(((1, 1),) * 4, 43, 27, 7)
    out["plain_420"] = synth_plain_jpeg(w=51, h=35, mode="420")
    out["restart_422"] = synth_jpeg(w=51, h=35, mode="422", dri_blocks=3)
    for mode in ("420", "444", "gray"):
        out[f"progressive_{mode}"] = synth_progressive(w=45, h=37, mode=mode)
    out["progressive_dri"] = synth_progressive(w=45, h=37, restart_marker_blocks=2)
    for n in (1, 7, 40):
        out[f"truncated_{n}"] = truncate_scan(out["plain_420"], n)
        out[f"truncated_progressive_{n}"] = truncate_scan(out["progressive_420"], n)
    out["cut_half"] = out["plain_420"][: len(out["plain_420"]) // 2]
    for i, infix in enumerate(RST_INFIXES):
        out[f"rst_{i}"] = _splice_rst(out["restart_422"], infix)
    out["not_a_jpeg"] = b"\x89PNG\r\n\x1a\n" + bytes(20)
    return out


STREAMS = _streams()


def _outcome(fn, data):
    """(image class, planes) or (exception type, message)."""
    try:
        img = fn(data)
    except Exception as exc:  # noqa: BLE001 -- the comparison is the point
        return ("raised", type(exc).__name__, str(exc))
    if hasattr(img, "cb"):
        planes = [img.y, img.cb, img.cr]
        extra = (img.ratio,)
    else:
        planes = [img.pix]
        extra = ()
    return (type(img).__name__, [p.copy() for p in planes], img.rgba_pixels(), extra)


def _same(a, b):
    if a[0] == "raised" or b[0] == "raised":
        return a == b
    return (a[0] == b[0] and a[3] == b[3] and len(a[1]) == len(b[1])
            and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
            and np.array_equal(a[2], b[2]))


@pytest.fixture
def jax_python_scan(monkeypatch):
    """zpix_tpu's decoder with its Python scan (no native library)."""
    monkeypatch.setattr(jrt, "get_lib", lambda: None)


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_zpix_tpu(name):
    data = STREAMS[name]
    assert _same(_outcome(tj.decode, data), _outcome(jj.decode, data))


@pytest.mark.parametrize("name", list(STREAMS))
def test_python_scan_matches_zpix_tpu_python_scan(name, jax_python_scan):
    data = STREAMS[name]
    got = _outcome(lambda d: tdec.Decoder(d, native=False).decode_inner(False), data)
    assert _same(got, _outcome(jj.decode, data))


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_config_matches_zpix_tpu(name):
    data = STREAMS[name]

    def config(fn):
        try:
            c = fn(data)
        except Exception as exc:  # noqa: BLE001
            return ("raised", type(exc).__name__, str(exc))
        return (c.width, c.height, c.color_model)

    assert config(tj.decode_config) == config(jj.decode_config)


def _coefficients(data, native):
    d = tdec.Decoder(data, native)
    d.collect_only = True
    try:
        d.decode_inner(False)
    except Exception as exc:  # noqa: BLE001
        return type(exc).__name__
    return [None if c is None else c.copy() for c in d.coeff[: d.num_components]], d.eob_run


@pytest.mark.parametrize("name", list(STREAMS))
def test_cpp_scan_matches_python_scan(name):
    """The C++ scan and the Python scan: the same coefficients, or the same
    exception type (zpix_tpu's two scans word a missing FF00 differently,
    and each of the port's follows its own)."""
    a = _coefficients(STREAMS[name], True)
    b = _coefficients(STREAMS[name], False)
    if isinstance(a, str) or isinstance(b, str):
        assert a == b
        return
    assert a[1] == b[1] and len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        assert (x is None and y is None) or np.array_equal(x, y)


def test_every_stream_kind_is_exercised():
    """The inputs above reach each image class and each error the scans
    raise on damage."""
    kinds = {_outcome(tj.decode, d)[0] if _outcome(tj.decode, d)[0] != "raised"
             else _outcome(tj.decode, d)[1] for d in STREAMS.values()}
    assert {"GrayImage", "YCbCrImage", "RGBAImage", "CMYKImage", "UnsupportedError",
            "BadRSTMarker", "UnexpectedEof", "FormatError", "_MissingFF00"} <= kinds


def test_multi_scan_writer_covers_in_image_blocks_only():
    """encode_baseline(scans="separate") writes one scan a component over
    its in-image blocks; the decoded coefficients are the grids given."""
    hv = RATIOS["420"]
    rng = np.random.default_rng(0)
    w, h = 37, 21
    mxx, myy = 3, 2
    grids = []
    for hh, vv in hv:
        g = rng.integers(-30, 30, (myy * vv, mxx * hh, 64))
        g[(np.arange(myy * vv) * 8 >= h)[:, None] | (np.arange(mxx * hh) * 8 >= w)[None, :]] = 0
        grids.append(g)
    data = encode_baseline(grids, hv, w, h, scans="separate")
    assert data.count(b"\xff\xda") == 3
    coeffs, _ = _coefficients(data, True)
    for got, want in zip(coeffs, grids):
        assert np.array_equal(got, want)


def test_codec_namespace_matches_zpix_tpu():
    data = STREAMS["arm_ycbcr"]
    assert tj.MAGIC == jj.MAGIC
    assert tj.probe_buffer(data) and not tj.probe_buffer(b"\xff\xd8")
    assert set(tj.__all__) == set(jj.__all__)


def test_probe_and_load_read_files(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(STREAMS["arm_gray"])
    assert tj.probe_path(str(path)) == jj.probe_path(str(path))
    assert np.array_equal(tj.load(str(path)).pix, jj.load(str(path)).pix)


def test_decoder_has_no_silent_fallback(monkeypatch):
    """With the host library failing to build, the decoder raises (the
    C++ scan is its path); only ``native=False`` runs the Python scan."""
    from zpix_tpu_torch.runtime import host

    def broken():
        raise RuntimeError("zpix_tpu_torch: g++ failed")

    monkeypatch.setattr(host, "lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tj.decode(STREAMS["arm_ycbcr"])
    assert tdec.Decoder(STREAMS["arm_ycbcr"], native=False).decode_inner(False) is not None


def test_jax_python_scan_fixture_reaches_the_python_scan(jax_python_scan):
    """The fixture really turns zpix_tpu's native scan off: its message for
    a missing FF00 is then the Python scan's (empty)."""
    with pytest.raises(jdec._MissingFF00) as info:
        jj.decode(STREAMS["truncated_40"])
    assert str(info.value) == ""
