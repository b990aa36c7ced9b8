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
ERR_BAD_HUFFMAN = 3
ERR_EXCESSIVE_DC = 5
ERR_UNEXPECTED_CODE = 7
ERR_TOO_MANY_COEFFS = 8
ERR_UNSUPPORTED = 100
ERR_FORMAT = 101

ERROR_NAMES = {ERR_EOF: "ERR_EOF", ERR_BAD_HUFFMAN: "ERR_BAD_HUFFMAN",
               ERR_EXCESSIVE_DC: "ERR_EXCESSIVE_DC",
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


_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
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
