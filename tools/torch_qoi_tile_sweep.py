#!/usr/bin/env python3
"""K14 (zpix_tpu_torch's QOI encoder) at other tile sizes and warps a tile.

    python3 tools/torch_qoi_tile_sweep.py

Builds csrc/qoi_encode.cu with kTile and kWarps replaced, for each setting
below, into build/qoi_tile_sweep/ (nvcc, sm_90a), and times each on
chip_smoke.py's noise and screen batches (16 distinct 1024x1024 images,
decoded by the port's host decoder and packed on the card): the kernel and
its memset, mean of 20 behind a spin kernel, less the zero fill of the
output that every call makes.  Each setting's bytes are checked against
the package's build.  Prints one line a setting; needs a CUDA device and
nvcc, exits 1 without a device.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = ((512, 4), (1024, 4), (1024, 8), (2048, 4), (2048, 8))  # (pixels, warps) a tile


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_qoi_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("cs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.codecs.qoi.encode import Desc
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    d = Desc(cs.SIZE, cs.SIZE, 4, 0)
    batches = {}
    for content in ("noise", "screen"):
        px = torch.from_numpy(cs.qoi_host_pixels(cs.make_qoi_batches(content, [0])[0])).to(dev)
        batches[content] = torch.stack([_pack_px(px[i], d, dev) for i in range(px.shape[0])])
    ref = {c: kq.encode(p) for c, p in batches.items()}
    src = open(os.path.join(runtime.CSRC, "qoi_encode.cu")).read()
    out_dir = os.path.join(HERE, "build", "qoi_tile_sweep")
    os.makedirs(out_dir, exist_ok=True)
    P, L = ctypes.c_void_p, ctypes.c_int64
    for tile, warps in SETTINGS:
        code = re.sub(r"constexpr int kTile = \d+;", f"constexpr int kTile = {tile};", src)
        code = re.sub(r"constexpr int kWarps = \d+;", f"constexpr int kWarps = {warps};", code)
        base = os.path.join(out_dir, f"qoi_{tile}_{warps}")
        with open(base + ".cu", "w") as f:
            f.write(code)
        subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", base + ".so",
                        base + ".cu"], check=True, capture_output=True)
        fn = ctypes.CDLL(base + ".so").zpix_qoi_encode_batch
        fn.argtypes = [P, P, P, P, L, L, L, P]
        row = []
        for content, pk in batches.items():
            B, n = pk.shape
            cap = kq.encode_cap(n)
            scratch = torch.empty(B * -(-n // tile) * 135 + 2, dtype=torch.int32, device=dev)
            out = torch.zeros(B, cap, dtype=torch.uint8, device=dev)
            total = torch.empty(B, dtype=torch.int32, device=dev)

            def call(out=out, total=total, scratch=scratch, pk=pk, B=B, n=n, cap=cap):
                out.zero_()
                err = fn(pk.data_ptr(), out.data_ptr(), total.data_ptr(), scratch.data_ptr(), B,
                         n, cap, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"zpix_qoi_encode_batch: cudaError {err}")

            call()
            torch.cuda.synchronize()
            same = torch.equal(out, ref[content][0]) and torch.equal(total, ref[content][1])
            ms = cs.cuda_ms(call, 20) - cs.cuda_ms(out.zero_, 20)
            row.append(f"{content} {ms:.4f} ms equal {same}")
        print(f"tile {tile} warps {warps}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
