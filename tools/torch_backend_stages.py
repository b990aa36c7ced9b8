#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's JPEG pixel back-ends K4 (csrc/backend.cu)
and K6 (csrc/planes.cu) at chip_smoke.py's main shapes.

    python3 tools/torch_backend_stages.py [--root CHECKOUT] [--tag NAME]
                                          [--variants] [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py: 16
distinct 1024x1024 4:2:0 q50 JPEGs a batch.

K4 on the DRI 8 batch 0 (its coefficients from K1-K3), planar and
interleaved; K6 on the restart-free batch 0's native grids (K7), int16
and the same grids as int32 (the progressive store's type).  Each: the
time of a call (CUDA events, mean of 20 behind a spin kernel, as
chip_smoke.py times kernels), its launches, and whether it equals its
plain version.

``--variants`` is the record of the split that chose the strip design,
kept so that its numbers can be made again; it has no use on a checkout
with the strip design (it exits with an error there).  On a checkout
with the per-MCU design that came before (128 threads an MCU) it builds
tools/torch_backend_variants.cu against that checkout's csrc/ into
build/backend_variants/ and times K4's variants on the same inputs: the
kernel as it was, without its pixel stage, its pixel stage alone, its
loads and dequant alone, and two MCUs a 256-thread block.

``--sweep`` (a checkout with the strip design) rebuilds csrc/backend.cu
and csrc/planes.cu with ``kStripBlocks`` (mcu_pixels.cuh: the most
blocks a strip) replaced, for each value below, into build/backend_sweep/
(nvcc, sm_90a, all builds together), and times K4 planar and K6 int16
through their wrappers on each build, each checked against its plain
version.

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"full": (0, 1), "no_store": (1, 1), "no_idct": (2, 1), "load_only": (3, 1),
            "two_mcus_256_threads": (0, 2)}
SWEEP_BLOCKS = (16, 32, 64, 128, 256)
STRIP_CONST = re.compile(r"constexpr int kStripBlocks = \d+;")


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(cs, dev):
    """K4's arguments on the DRI 8 batch, K6's on the native grids."""
    from zpix_tpu_torch import DeviceJpegDecoder, prep_batch
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb

    plan = prep_batch(cs.make_batch(0))
    bufs = DeviceJpegDecoder(planar=True).upload(plan)
    ends, ok = ke.index_pass(*bufs, bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)
    ac, dc = ke.value_pass(*bufs, ends, ok, bpm=plan.bpm)
    dc = ke.dc_restore(dc, hv=plan.hv, seg_mcus=plan.seg_mcus)
    k4 = (ac, dc, bufs[3], kb.BackendGeometry.of(plan))
    datas = cs.make_batch(100, dri=None)
    fe = pb.NativeBatchFrontEnd(datas[0], cs.BATCH, pin=True)
    packed = fe.parse(datas)
    flat = pb.upload(packed, dev)
    grids = [ks.unpack_sparse(pb.carve(flat, packed.layout, "bm", c, cs.BATCH),
                              pb.carve(flat, packed.layout, "val", c, cs.BATCH), bv=bv, bh=bh,
                              perm=p)
             for c, ((bv, bh), p) in enumerate(zip(packed.dims, packed.perms))]
    quants = [pb.carve(flat, packed.layout, "q", c, cs.BATCH) for c in range(3)]
    kw = dict(color="ycbcr", height=cs.SIZE, width=cs.SIZE,
              factors=[(1, 1)] + [pb.RATIO_FACTORS[packed.ratio]] * 2)
    torch.cuda.synchronize()
    return k4, (grids, quants, kw)


def time_kernels(cs, k4, k6) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import planes as kp

    ac, dc, tables, geom = k4
    grids, quants, kw = k6
    g32 = [g.to(torch.int32) for g in grids]
    plain4 = kb.backend_plain(ac, dc, tables, geom, planar=True)
    plain6 = kp.component_planes_plain(grids, quants, **kw)
    calls = {
        "k4_planar": ("backend", lambda: kb.backend(ac, dc, tables, geom, planar=True), plain4),
        "k4_interleaved": ("backend", lambda: kb.backend(ac, dc, tables, geom, planar=False),
                           plain4.permute(0, 2, 3, 1)),
        "k6_int16": ("component_planes", lambda: kp.component_planes(grids, quants, **kw), plain6),
        "k6_int32": ("component_planes", lambda: kp.component_planes(g32, quants, **kw), plain6),
    }
    out = {}
    for name, (kname, fn, want) in calls.items():
        before = runtime.LAUNCHES[kname]
        got = fn()
        launches = runtime.LAUNCHES[kname] - before
        torch.cuda.synchronize()
        out[name] = {"ms": cs.cuda_ms(fn, 20), "launches": launches,
                     "equal_plain": bool(torch.equal(got, want))}
    return out


def variants(cs, root, k4, tag) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import backend as kb

    out_dir = os.path.join(HERE, "build", "backend_variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"variants_{tag}.so")
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-I",
                    os.path.join(root, "zpix_tpu_torch", "csrc"), "-o", so,
                    os.path.join(HERE, "tools", "torch_backend_variants.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).zpix_backend_variant
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ac, dc, tables, geom = k4
    out = torch.empty(geom.out_shape(True), dtype=torch.uint8, device=ac.device)
    sink = torch.zeros(1, dtype=torch.int32, device=ac.device)
    packed = [h | v << 4 | fh << 8 | fv << 12 for (h, v), (fh, fv) in zip(geom.hv, geom.factors())]
    packed += [0] * (4 - len(packed))
    res = {}
    for name, (variant, mcus) in VARIANTS.items():
        def call(variant=variant, mcus=mcus):
            err = fn(variant, mcus, ac.data_ptr(), dc.data_ptr(), tables.data_ptr(),
                     out.data_ptr(), sink.data_ptr(), geom.batch, geom.mxx * geom.myy,
                     geom.m_pad, geom.mxx, geom.bpm, geom.height, geom.width, len(geom.hv),
                     *packed, {"ycbcr": 1}[geom.color], geom.channels, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"zpix_backend_variant {name}: cudaError {err}")

        out.zero_()
        call()
        torch.cuda.synchronize()
        row = {"ms": cs.cuda_ms(call, 20)}
        if variant == 0:
            row["equal_kernel"] = bool(torch.equal(out, kb.backend(ac, dc, tables, geom,
                                                                    planar=True)))
        res[name] = row
    return res


def strip_mcus(bpm: int, mxx: int, blocks: int) -> int:
    """MCUs a strip at ``kStripBlocks`` = ``blocks``, as make_strip_geo
    (mcu_pixels.cuh) picks them."""
    s = 1
    while 2 * s * bpm <= blocks and s < mxx:
        s *= 2
    return s


def sweep_builds(csrc: str) -> dict:
    """{blocks: path of a library holding zpix_backend and
    zpix_component_planes built with kStripBlocks = blocks}."""
    from zpix_tpu_torch import runtime

    header = open(os.path.join(csrc, "mcu_pixels.cuh")).read()
    procs = {}
    for blocks in SWEEP_BLOCKS:
        work = os.path.join(HERE, "build", "backend_sweep", f"blocks_{blocks}")
        os.makedirs(work, exist_ok=True)
        for name in os.listdir(csrc):
            if name.endswith(".cuh") or name in ("backend.cu", "planes.cu"):
                shutil.copy(os.path.join(csrc, name), work)
        with open(os.path.join(work, "mcu_pixels.cuh"), "w") as f:
            f.write(STRIP_CONST.sub(f"constexpr int kStripBlocks = {blocks};", header))
        so = os.path.join(work, "lib.so")
        procs[blocks] = (so, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(work, "backend.cu"), os.path.join(work, "planes.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for blocks, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc (kStripBlocks {blocks}) failed:\n{out.decode()}")
    return {blocks: so for blocks, (so, _) in procs.items()}


def sweep(cs, k4, k6) -> list:
    """K4 planar and K6 int16 on each sweep build, through their wrappers
    (the runtime's library swapped for the build's while it is timed)."""
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import planes as kp

    ac, dc, tables, geom = k4
    grids, quants, kw = k6
    want4 = kb.backend_plain(ac, dc, tables, geom, planar=True)
    want6 = kp.component_planes_plain(grids, quants, **kw)
    builds = sweep_builds(runtime.CSRC)
    keep = runtime.lib(), runtime._fns
    rows = []
    try:
        for blocks, so in builds.items():
            runtime._lib, runtime._fns = ctypes.CDLL(so), {}
            f4 = lambda: kb.backend(ac, dc, tables, geom, planar=True)  # noqa: E731
            f6 = lambda: kp.component_planes(grids, quants, **kw)  # noqa: E731
            ok = torch.equal(f4(), want4) and torch.equal(f6(), want6)
            rows.append({"strip_blocks": blocks,
                         "strip_mcus": strip_mcus(geom.bpm, geom.mxx, blocks),
                         "k4_planar_ms": cs.cuda_ms(f4, 20), "k6_int16_ms": cs.cuda_ms(f6, 20),
                         "equal_plain": ok})
    finally:
        runtime._lib, runtime._fns = keep
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_backend_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_backend_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    k4, k6 = inputs(cs, dev)
    ac, _, _, geom = k4
    blocks = ac.shape[0]
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC,
           "k4_blocks": blocks, "k4_mcus": geom.batch * geom.mxx * geom.myy,
           "pixels": geom.batch * geom.width * geom.height,
           "kernels": time_kernels(cs, k4, k6)}
    header = open(os.path.join(runtime.CSRC, "mcu_pixels.cuh")).read()
    if args.variants:
        if "write_mcu(" not in header:
            raise SystemExit("torch_backend_stages: --variants needs the per-MCU design")
        res["k4_variants"] = variants(cs, root, k4, args.tag)
    if args.sweep:
        if not STRIP_CONST.search(header):
            raise SystemExit("torch_backend_stages: --sweep needs the strip design")
        res["sweep"] = sweep(cs, k4, k6)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
