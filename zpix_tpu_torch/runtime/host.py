"""Host library: the C++ under zpix_tpu_torch/csrc/host, built on demand.

The counterpart of zpix_tpu/runtime/__init__.py for the port.  Every
``csrc/host/*.cpp`` is compiled by one ``g++ -O3 -std=c++17 -fPIC -shared
-lpthread`` into ``build/zpix_tpu_torch/``, under a name that carries a
hash of the sources and flags (like the kernel library), and loaded with
ctypes on first use.  There is no Python fallback: if ``g++`` fails, the
call raises.  ctypes releases the GIL during each call, so a thread pool
of callers runs in parallel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from . import BUILD_DIR, CSRC

HOST_SRC = os.path.join(CSRC, "host")
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

# Return codes of csrc/host/entropy.cpp.
OK = 0
ERR_EOF = 1
ERR_MISSING_FF00 = 2
ERR_BAD_HUFFMAN = 3
ERR_UNINIT_TABLE = 4
ERR_EXCESSIVE_DC = 5
ERR_BAD_RST = 6
ERR_UNEXPECTED_CODE = 7
ERR_TOO_MANY_COEFFS = 8
ERR_UNSUPPORTED = 100
ERR_FORMAT = 101

ERROR_NAMES = {ERR_EOF: "ERR_EOF", ERR_MISSING_FF00: "ERR_MISSING_FF00",
               ERR_BAD_HUFFMAN: "ERR_BAD_HUFFMAN", ERR_UNINIT_TABLE: "ERR_UNINIT_TABLE",
               ERR_EXCESSIVE_DC: "ERR_EXCESSIVE_DC", ERR_BAD_RST: "ERR_BAD_RST",
               ERR_UNEXPECTED_CODE: "ERR_UNEXPECTED_CODE",
               ERR_TOO_MANY_COEFFS: "ERR_TOO_MANY_COEFFS",
               ERR_UNSUPPORTED: "ERR_UNSUPPORTED", ERR_FORMAT: "ERR_FORMAT"}


def error_name(rc: int) -> str:
    """A return code of csrc/host/entropy.cpp as its name."""
    return ERROR_NAMES.get(rc, f"rc={rc}")


class HuffTableC(ctypes.Structure):
    """csrc/host/entropy.cpp's HuffTable; callers fill the canonical
    fields and leave the rest zeroed (the C side builds ``lut16``)."""

    _fields_ = [
        ("lut", ctypes.c_uint16 * 256),
        ("min_codes", ctypes.c_int32 * 16),
        ("max_codes", ctypes.c_int32 * 16),
        ("vals_indices", ctypes.c_int32 * 16),
        ("vals", ctypes.c_uint8 * 256),
        ("num_codes", ctypes.c_int32),
        ("lut16_ready", ctypes.c_int32),
        ("lut16", ctypes.c_uint16 * 65536),
    ]


class ScanCompC(ctypes.Structure):
    """csrc/host/entropy.cpp's ScanComp: one component of a scan."""

    _fields_ = [
        ("c_index", ctypes.c_int32),
        ("dc_table", ctypes.c_int32),
        ("ac_table", ctypes.c_int32),
        ("h", ctypes.c_int32),
        ("v", ctypes.c_int32),
        ("bh", ctypes.c_int32),
    ]


_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    # data, len, pos, huff[8], scan, n_comp, mxx, myy, width, height,
    # restart_interval, zig_start, zig_end, ah, al, progressive, coeff_out,
    # eob_run_io, pos_out, bits_n_out, num_unreadable_out
    "zpix_decode_scan": (_I32, [ctypes.c_char_p, _I64, _I64, _P, _P, _I32, _I32, _I32,
                                _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P,
                                _P, _P, _P]),
    "zpix_pack_sparse": (_I64, [_P, _I64, _P, _P, _I64]),
    "zpix_parse_baseline": (_I32, [ctypes.c_char_p, _I64, _I32, _I32, _P, _P, _P,
                                   _P, _P, _I32]),
    "zpix_parse_baseline_batch": (_I32, [_P, _P, _I32, _I32, _I32, _I32, _P, _P,
                                         _P, _P, _P, _P, _P, _I32]),
    "zpix_baseline_index_scan": (_I32, [_P, _I64, _P, _P, _P, _I32, _I64, _P, _P]),
    "zpix_prog_dc_first_index": (_I32, [_P, _I64, _P, _P, _I32, _I64, _P, _P]),
    "zpix_prog_ac_first_index": (_I32, [_P, _I64, _P, _I32, _I32, _I64, _P, _P, _P,
                                        _P, _P]),
    "zpix_prog_refine_index": (_I32, [_P, _I64, _P, _P, _I64, _I32, _I32,
                                      ctypes.c_uint16, _P, _P, _P, _P]),
    # csrc/host/qoi.cpp
    "zpix_qoi_decode": (_I32, [ctypes.c_char_p, _I64, _I64, _P]),
    "zpix_qoi_record_scan": (_I32, [ctypes.c_char_p, _I64, _I64, _P, _P, _I64, _P, _P]),
    # no decoder calls the lane scan (the lane fill writes the same entries
    # in place); it stays as the unfused form the tests check the fill by
    "zpix_qoi_lane_scan": (_I32, [ctypes.c_char_p, _I64, _I64, _I32, _P, _P, _P, _I64,
                                  _P, _I64, _P, _P]),
    "zpix_qoi_lane_fill": (_I32, [ctypes.c_char_p, _I64, _I64, _I32, _I32, _P, _P, _P,
                                  _P, _P]),
    "zpix_qoi_lane_fill4": (_I32, [ctypes.c_char_p, _I64, _I64, _I32, _I32, _P, _P, _P]),
    "zpix_qoi_encode": (_I64, [_P, _I64, _I32, _P, _I64]),
    # csrc/host/inflate.cpp and csrc/host/defilter.cpp
    "zpix_inflate_tokens": (_I64, [_P, _I64, _I32, _P, _P, _P, _I64, _I64, _P]),
    "zpix_inflate_tokens_trailer": (_I64, [_P, _I64, _I32, _P, _P, _P, _I64, _I64, _P, _P]),
    "zpix_defilter": (_I32, [_P, _I64, _I64, _I32, _P]),
    "zpix_defilter_batch": (_I32, [_P, _I64, _I64, _I32, _P, _I32, _I32]),
}

_lock = threading.Lock()
_libs: dict = {}


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(glob.glob(os.path.join(HOST_SRC, "*.cpp"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(so_path: str, flags) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("zpix_tpu_torch: g++ not found (needed for the host library)")
    tmp = f"{so_path}.tmp{os.getpid()}"
    srcs = sorted(glob.glob(os.path.join(HOST_SRC, "*.cpp")))
    res = subprocess.run([gxx, *flags, "-o", tmp, *srcs, "-lpthread"],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"zpix_tpu_torch: g++ failed\n{res.stdout}{res.stderr}")
    # atomic: a process building at the same time never loads a torn file
    os.replace(tmp, so_path)


def lib(extra_flags: tuple = ()) -> ctypes.CDLL:
    """The host library, built from csrc/host on first use.  ``extra_flags``
    builds a variant (the tests build the AVX-512 arm of pack_sparse)."""
    key = tuple(extra_flags)
    if key in _libs:
        return _libs[key]
    with _lock:
        if key not in _libs:
            flags = GXX_FLAGS + list(key)
            so_path = os.path.join(BUILD_DIR, f"libzpix_host_{_digest(flags)}.so")
            if not os.path.exists(so_path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                _compile(so_path, flags)
            cdll = ctypes.CDLL(so_path)
            for name, (res, args) in _SIGNATURES.items():
                f = getattr(cdll, name)
                f.restype, f.argtypes = res, args
            _libs[key] = cdll
    return _libs[key]


def inflate_tokens(data: bytes, expected_out: int, zlib_wrap: bool = True, out=None):
    """DEFLATE symbol-resolve pass: bitstream -> LZ77 token arrays (the port
    of zpix_tpu/runtime/__init__.py::inflate_tokens).

    Returns (lens int32[nt], dists int32[nt], lits uint8[nt], out_bytes,
    adler): ``adler`` is the zlib trailer, the big-endian uint32 in the four
    bytes after the final block, or None when fewer than four follow (or
    the stream is raw deflate); nothing here checks it.
    ``out``: (lens, dists, lits) numpy arrays to write into (pinned
    staging); the returned arrays are views of them, and None is returned
    when they are shorter than expected_out + 1 and too short for this
    stream.  Raises FormatError on a malformed stream or when the stream
    inflates past expected_out (PNG's IHDR fixes the exact size, so an
    overflow is corruption).  The copy resolve runs on the card (K16)."""
    import numpy as np

    from ..errors import FormatError

    # Every token produces >= 1 byte, so expected_out bounds the count.
    max_tokens = expected_out + 1
    if out is None:
        out = (np.empty(max_tokens, np.int32), np.empty(max_tokens, np.int32),
               np.empty(max_tokens, np.uint8))
    lens, dists, lits = out
    room = min(len(lens), len(dists), len(lits), max_tokens)
    out_bytes, trailer = ctypes.c_int64(0), ctypes.c_int64(0)
    nt = lib().zpix_inflate_tokens_trailer(
        data, len(data), 1 if zlib_wrap else 0, lens.ctypes.data, dists.ctypes.data,
        lits.ctypes.data, room, expected_out, ctypes.byref(out_bytes), ctypes.byref(trailer))
    if nt == -102 and room < max_tokens:
        return None  # out of room, or past expected_out: the caller retries at full room
    if nt < 0:
        raise FormatError(f"zlib: invalid deflate stream (code {-nt})")
    at = trailer.value
    adler = (int.from_bytes(data[at : at + 4], "big")
             if zlib_wrap and len(data) - at >= 4 else None)
    return lens[:nt], dists[:nt], lits[:nt], out_bytes.value, adler


_libdeflate = None
_libdeflate_local = threading.local()


def _get_libdeflate():
    global _libdeflate
    if _libdeflate is None:
        try:
            cdll = ctypes.CDLL("libdeflate.so.0")
            cdll.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
            cdll.libdeflate_zlib_decompress.restype = ctypes.c_int
            cdll.libdeflate_zlib_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
            _libdeflate = cdll
        except OSError:
            _libdeflate = False
    return _libdeflate or None


def libdeflate_available() -> bool:
    return _get_libdeflate() is not None


def zlib_decompress_sized(data: bytes, out_size: int, out=None):
    """Inflate a zlib stream of known decompressed size with the system's
    libdeflate (the port of zpix_tpu/runtime/__init__.py::
    zlib_decompress_sized).

    Returns the bytes -- or ``out``, a writable uint8 numpy array of
    ``out_size`` bytes (pinned staging) inflated in place -- or None when
    libdeflate is not installed, the stream is refused or its size differs
    (the caller then inflates with the standard library's ``zlib``, the
    same bytes).  One decompressor a thread; ctypes releases the GIL."""
    cdll = _get_libdeflate()
    if cdll is None:
        return None
    dec = getattr(_libdeflate_local, "dec", None)
    if dec is None:
        dec = cdll.libdeflate_alloc_decompressor()
        if not dec:
            return None
        _libdeflate_local.dec = dec
    if out is not None and (out.nbytes != out_size or not out.flags.c_contiguous):
        raise ValueError("zlib_decompress_sized: out must be out_size contiguous bytes")
    buf = ctypes.create_string_buffer(out_size) if out is None else None
    actual = ctypes.c_size_t(0)
    rc = cdll.libdeflate_zlib_decompress(dec, data, len(data),
                                         buf if out is None else out.ctypes.data, out_size,
                                         ctypes.byref(actual))
    if rc != 0 or actual.value != out_size:
        return None
    return buf.raw if out is None else out
