"""Kernel build: the CUDA sources under zpix_tpu_torch/csrc, built on demand.

The counterpart of zpix_tpu/runtime/__init__.py, which compiles its C++
with g++ and versions it by ``_ABI_VERSION``.  Here every ``csrc/*.cu``
is compiled by its own ``nvcc`` (all started together) for ``sm_90a``
and linked into one shared library with a plain C interface, loaded with
ctypes.  The library's name carries a hash of the sources and flags, so
an edit rebuilds it and a stale build is never loaded.  Nothing is built
at import: the first kernel call (or ``lib()``) does it.

Each C entry point launches on the caller's CUDA stream and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.  The host
C++ (``csrc/host``) is a second library, built with g++ by ``host.py``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zpix_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# CUDA kernel launches, by kernel name: each wrapper adds the number of
# kernels its C entry launches, where it launches them.
LAUNCHES = {"index_pass": 0, "value_pass": 0, "dc_restore": 0,
            "backend": 0, "idct_blocks": 0, "unpack_sparse": 0,
            "component_planes": 0, "dc_first": 0, "ac_first": 0,
            "ac_refine": 0, "dc_refine": 0, "qoi_lane_expand": 0,
            "qoi_sorted_expand": 0, "qoi_encode": 0, "bmp_unpack": 0,
            "png_defilter": 0, "inflate_resolve": 0, "adler32": 0, "png_expand": 0,
            "sync_decode": 0}

_lock = threading.Lock()
_lib = None
_fns: dict = {}
build_seconds = None  # wall time of this process's build, None if loaded


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))), sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _digest() -> str:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + hdrs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("zpix_tpu_torch: nvcc not found (needs the CUDA toolkit)")


def _compile(so_path: str) -> None:
    nvcc = _nvcc()
    cus, _ = _sources()
    work = so_path + f".tmp{os.getpid()}"
    os.makedirs(work, exist_ok=True)
    objs, procs = [], []
    for cu in cus:  # one nvcc per source, all running together
        obj = os.path.join(work, os.path.basename(cu)[:-3] + ".o")
        objs.append(obj)
        procs.append((cu, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", cu, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for cu, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            failed.append(f"{cu}:\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("zpix_tpu_torch: nvcc failed\n" + "\n".join(failed))
    tmp_so = os.path.join(work, "lib.so")
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *objs],
                   check=True, capture_output=True)
    os.replace(tmp_so, so_path)
    shutil.rmtree(work, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The kernel library, built from csrc/ on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so_path = os.path.join(BUILD_DIR, f"libzpix_kernels_{_digest()}.so")
            if not os.path.exists(so_path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                t0 = time.perf_counter()
                _compile(so_path)
                build_seconds = time.perf_counter() - t0
            _lib = ctypes.CDLL(so_path)
    return _lib


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = {"p": _P, "i": _I, "l": _L}


def fn(name: str, sig: str):
    """C entry ``name`` with argument types from ``sig`` (p = pointer or
    stream, i = int, l = int64); returns int (a cudaError_t)."""
    f = _fns.get(name)
    if f is None:
        f = getattr(lib(), name)
        f.argtypes = [_ARGS[c] for c in sig]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def launch(kernel: str, device, name: str, sig: str, *args, kernels: int = 1) -> None:
    """Launch C entry ``name`` on ``device``'s current stream, count its
    ``kernels`` CUDA kernel launches under ``kernel``, and raise if the
    launch was refused."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(name, sig + "p")(*args, stream)
    if err:
        raise RuntimeError(f"zpix_tpu_torch: {name} failed: cudaError {err}")
    LAUNCHES[kernel] += kernels


_EPOCHS = (1 << 30) - 1  # look-back epochs 1 .. 2^30 - 1 (csrc/lookback.cuh)
_scratch: dict = {}


def lookback_scratch(device, words: int):
    """-> (an int64 tensor of at least ``words`` on ``device``, an epoch)
    for one launch of a kernel with decoupled look-back (K3, K7;
    csrc/lookback.cuh).  One tensor a CUDA stream, kept between calls and
    zeroed when made and after 2^30 - 1 epochs, keyed by the card's index
    and the stream: each launch gets a new epoch, so the words an
    earlier launch left read as unset, and the launch leaves word 0 (its
    ticket counter) at 0.  A call allocates nothing and needs no memset."""
    import torch

    dev = torch.device(device)
    if dev.index is None:  # "cuda" and "cuda:0" are one device and one stream
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _lock:
        ent = _scratch.get(key)
        if ent is None or ent[0].numel() < words:
            size = max(words, 2 * (0 if ent is None else ent[0].numel()))
            ent = [torch.zeros(size, dtype=torch.int64, device=dev), 0]
            _scratch[key] = ent
        ent[1] += 1
        if ent[1] > _EPOCHS:  # every epoch used: start again from zeros
            ent[0].zero_()
            ent[1] = 1
        return ent[0], ent[1]


def require_cuda(*tensors, rows: bool = False) -> None:
    """Kernel inputs must be contiguous CUDA tensors on one device; with
    ``rows``, only their last dimension (a kernel that reads rows through
    strides)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"zpix_tpu_torch: kernel input on {t.device}, expected one CUDA device"
            )
        if not (t.stride(-1) == 1 if rows else t.is_contiguous()):
            raise ValueError("zpix_tpu_torch: kernel input is not contiguous")
