"""The benchmark's native helpers: the frozen QOI encoder
(``qoi_encode.cpp``), built with g++ on first use into the benchmark's own
cache directory, ``benchmark/.cache/`` (a fixed path inside the checkout,
under a name that carries a hash of the source and flags)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".cache")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
PADDING = bytes([0, 0, 0, 0, 0, 0, 0, 1])

_lock = threading.Lock()
_lib = None


def _build() -> ctypes.CDLL:
    src = os.path.join(HERE, "qoi_encode.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(CACHE, f"libbench_qoi_{digest}.so")
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("benchmark: g++ not found (builds the frozen QOI encoder)")
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        res = subprocess.run([gxx, *FLAGS, "-o", tmp, src], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"benchmark: g++ failed\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: another process never loads a torn file
    lib = ctypes.CDLL(so)
    lib.bench_qoi_encode.restype = ctypes.c_int64
    lib.bench_qoi_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_void_p, ctypes.c_int64]
    return lib


def qoi_encode(rgba: np.ndarray, colorspace: int = 0) -> bytes:
    """uint8 [H, W, 3 or 4] -> a QOI file (header, ops, padding)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    h, w, ch = rgba.shape
    src = np.ascontiguousarray(rgba, np.uint8)
    n = h * w
    cap = n * (ch + 1) + 22
    out = np.empty(cap, np.uint8)
    written = _lib.bench_qoi_encode(src.ctypes.data, n, ch, out.ctypes.data, cap)
    if written < 0:
        raise RuntimeError("qoi: encode buffer overflow")
    head = struct.pack(">4sIIBB", b"qoif", w, h, ch, colorspace)
    return head + out[:written].tobytes() + PADDING
