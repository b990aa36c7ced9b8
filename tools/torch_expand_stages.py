#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's K12 (QOI lane expansion,
csrc/qoi_expand.cu), K17 (PNG expansion, csrc/png_expand.cu) and K18 (BMP
unpack, csrc/bmp_unpack.cu, K17's sibling) on chip_smoke.py's content,
with the work each does and its bound.

    python3 tools/torch_expand_stages.py [--root CHECKOUT] [--tag NAME] [--parts k18,...]
                                         [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py.

K12 on batch 0 of chip_smoke.py's qoi phase (16 images of 1024x1024):
the noise and screen content through the host p4 lane pass at chip_smoke's
lane widths (P = 16 and 128), and the alpha content through the wide pass
(P = 16); then hand-built wide entries of a lane wider than one window of
the kernel (P = 8,192, R = 64, 2,048 lanes).  Each: P, R, lanes, entry
slots and the slots that cover a pixel, the time of a call (CUDA events,
mean of 20 behind a spin kernel, as chip_smoke.py times kernels), ns a
pixel and an entry slot, the bound (bytes in and out over the memory
rate, operations over the int32 rate, as chip_smoke.py counts them) and
its share of the time, each CUDA kernel of one call with its device time
(``torch.profiler``), and whether it equals its plain version.

K17 on every arm at 16 x 1024^2 (random rows, a random palette for the
paletted arms, no key), then both Adam7 batches of chip_smoke.py's png
phase (tc8, and p8 with tRNS) decoded by ``device_inflate``: each of the
seven passes' launch, with its rows as the decoder gave them, timed and
bounded alone, and the sums.

K18 on every arm at 16 x 1024^2: 1, 2, 4 and 8 bpp (random rows, a random
palette), 24 bpp, 32 bpp with and without the V4/V5 alpha, bottom-up rows
as BatchBmpDecoder uploads them; the bound counts the rows, the palettes
of the paletted arms and 4 bytes a pixel out, and chip_smoke.py's
operations a pixel.  ``--sweep`` rebuilds csrc/bmp_unpack.cu alone with
``kRowSteps`` (the rows a thread takes in turn) replaced by each of
``ROW_STEPS`` into build/bmp_sweep/ (nvcc, sm_90a, all builds together)
and times K18's arms through the wrapper on each build.

Prints one JSON object, with the card's name and power limit; needs a
CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K12_WINDOW_LANE = (8192, 64, 2048)  # P, R, lanes of the hand-built wide entries
K18_ARMS = (("1bpp", 1, False), ("2bpp", 2, False), ("4bpp", 4, False), ("8bpp", 8, False),
            ("24bpp", 24, False), ("32bpp", 32, False), ("32bpp_alpha", 32, True))
ROW_STEPS = (1, 2, 4, 8)  # K18's kRowSteps values of --sweep
STEPS_CONST = re.compile(r"constexpr int kRowSteps = \d+;")


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launches(fn) -> list:
    """[(name, device us)] of one call's kernels and memsets, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in dev]


def timed(cs, call, same: bool, nbytes: int, ops: int) -> dict:
    """A kernel call's time, bound and launches; ``same``: its output
    equals its plain version's."""
    ms = cs.cuda_ms(call, 20)
    b = cs.with_bound({"bytes": nbytes, "ops": ops})
    return {"ms": ms, "equal_plain": same, "bytes": nbytes, "ops": ops,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "share_of_bound": b["bound_ms"] / ms, "launches": launches(call)}


def equal(a, b) -> bool:
    return bool(torch.equal(a, b))


# ------------------------------------------------------------------- K12


def k12(cs, dev) -> dict:
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel import qoi_batch as tq

    shape = (cs.BATCH, cs.SIZE, cs.SIZE)
    npx = cs.BATCH * cs.SIZE * cs.SIZE
    out_bytes = 4 * npx
    res = {}
    for content in ("noise", "screen", "alpha"):
        datas = cs.make_qoi_batches(content, [50 if content == "alpha" else 0])[0]
        if content == "alpha":
            plan = tq.prep_qoi_lanes(datas, cs.QOI_PROFILES["noise"])
            ins = [cs.dev_t(a, dev) for a in (plan.cols, plan.s, plan.e)]
            s, e = plan.s.astype(np.int64), plan.e.astype(np.int64)
            call = lambda ins=ins, P=plan.P: kq.lane_expand_wide(*ins, P=P, shape=shape)  # noqa
            plain = lambda ins=ins, P=plan.P: kq.lane_expand_wide_plain(*ins, P=P, shape=shape)  # noqa
        else:
            plan = tq.prep_qoi_lanes4(datas, cs.QOI_PROFILES[content])
            ins = [cs.dev_t(plan.p4, dev)]
            s = plan.p4[:, 3::4].astype(np.int64)
            e = np.concatenate([s[:, 1:], np.full_like(s[:, :1], plan.P)], 1)
            call = lambda ins=ins, P=plan.P: kq.lane_expand_p4(*ins, P=P, shape=shape)  # noqa
            plain = lambda ins=ins, P=plan.P: kq.lane_expand_p4_plain(*ins, P=P, shape=shape)  # noqa
        lanes, R = s.shape
        nbytes = sum(x.numel() * x.element_size() for x in ins) + out_bytes
        row = timed(cs, call, equal(call(), plain()), nbytes,
                    cs.OPS_K12_SLOT * R * lanes + cs.OPS_K12_PIXEL * npx)
        row.update({"fmt": plan.fmt, "P": plan.P, "R": R, "lanes": lanes, "slots": lanes * R,
                    "slots_covering": int((np.maximum(s, 0) < np.minimum(e, plan.P)).sum()),
                    "ns_per_pixel": row["ms"] * 1e6 / npx,
                    "ns_per_slot": row["ms"] * 1e6 / (lanes * R)})
        res[f"{content}_{plan.fmt}"] = row
        del ins
    # a lane wider than one of the kernel's windows: random spans, a third
    # of them empty
    P, R, lanes = K12_WINDOW_LANE
    gen = np.random.default_rng(12)
    s = np.sort(gen.integers(-4, P + 4, (lanes, R)), 1).astype(np.int16)
    e = np.concatenate([s[:, 1:], np.full((lanes, 1), P, np.int16)], 1)
    e[gen.random(e.shape) < 0.33] = -5
    cols = gen.integers(0, 2**32, (lanes, R), dtype=np.uint64).astype(np.uint32)
    ins = [cs.dev_t(a, dev) for a in (cols, s, e)]
    wshape = (1, lanes, P)
    row = timed(cs, lambda: kq.lane_expand_wide(*ins, P=P, shape=wshape),
                equal(kq.lane_expand_wide(*ins, P=P, shape=wshape),
                      kq.lane_expand_wide_plain(*ins, P=P, shape=wshape)),
                sum(x.numel() * x.element_size() for x in ins) + 4 * lanes * P,
                cs.OPS_K12_SLOT * R * lanes + cs.OPS_K12_PIXEL * lanes * P)
    row.update({"fmt": "wide", "P": P, "R": R, "lanes": lanes, "slots": lanes * R,
                "ns_per_pixel": row["ms"] * 1e6 / (lanes * P)})
    res["window_lane_wide"] = row
    return res


# ------------------------------------------------------------------- K17


def k17_arms(cs, dev) -> dict:
    from zpix_tpu_torch.ops.png import ARMS, png_expand, png_expand_plain, row_bytes

    B, H, W = cs.BATCH, cs.SIZE, cs.SIZE
    gen = torch.Generator(device=dev).manual_seed(17)
    pal = torch.randint(0, 256, (B, 256, 4), generator=gen, dtype=torch.uint8, device=dev)
    res = {}
    for cd, (arm, _depth) in ARMS.items():
        rows = torch.randint(0, 256, (B, H, row_bytes(cd, W)), generator=gen,
                             dtype=torch.uint8, device=dev)
        p = pal if arm == 8 else None
        nbytes = rows.numel() + (pal.numel() if p is not None else 0) + 4 * B * H * W
        ops = cs.OPS_K17_PIXEL * B * H * W if cd == "tc8" else 0
        same = equal(png_expand(rows, p, None, cd=cd, width=W),
                     png_expand_plain(rows, p, None, cd=cd, width=W))
        res[cd] = timed(cs, lambda rows=rows, p=p, cd=cd: png_expand(rows, p, None, cd=cd, width=W),
                        same, nbytes, ops)
        del rows
    return res


def k17_adam7(cs, dev) -> dict:
    """Both Adam7 batches by device_inflate: each pass's K17 launch, with
    the rows, palette, key, canvas and placement the decoder gave it."""
    from zpix_tpu_torch import BatchPngDecoder
    from zpix_tpu_torch.ops.png import png_expand, png_expand_plain

    writer = cs.png_writer()
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        batches = cs.make_adam7_batches(writer, ex)
    dec = BatchPngDecoder(device_inflate=True)
    res = {}
    for kind, (datas, src) in batches.items():
        calls = []

        def keep(name, args, kw, _res, calls=calls):
            if name == "png_expand":
                calls.append((args, dict(kw)))

        plan = dec.prep(datas)
        px, _bad = dec.run(plan, dec.upload(plan), on_kernel=keep)
        torch.cuda.synchronize()
        passes = []
        for (rows, pal, key), kw in calls:
            xo, yo, xf, yf = kw["place"]
            w, h = kw["width"], rows.shape[1]
            out = kw["out"]

            def call(rows=rows, pal=pal, key=key, kw=kw):
                return png_expand(rows, pal, key, **kw)

            got = call()[:, yo : yo + h * yf : yf, xo : xo + w * xf : xf]
            same = equal(got, png_expand_plain(rows, pal, key, cd=kw["cd"], width=w))
            nbytes = (rows.numel() + (pal.numel() if pal is not None else 0)
                      + 4 * rows.shape[0] * h * w)
            row = timed(cs, call, same, nbytes, 0)
            row.update({"width": w, "rows": h, "place": [xo, yo, xf, yf],
                        "canvas": list(out.shape)})
            passes.append(row)
        res[kind] = {"equal_source": bool(torch.equal(px, torch.from_numpy(src).to(dev))),
                     "passes": passes, "ms_sum": sum(p["ms"] for p in passes),
                     "bound_ms_sum": sum(p["bound_ms"] for p in passes)}
        del px, calls
    dec.close()
    return res


# ------------------------------------------------------------------- K18


def k18_inputs(cs, dev) -> dict:
    """{arm: (rows, palettes, bmp_unpack keywords)} at 16 x 1024^2."""
    from zpix_tpu_torch.codecs.bmp.decode import row_bytes

    B, H, W = cs.BATCH, cs.SIZE, cs.SIZE
    gen = torch.Generator(device=dev).manual_seed(18)
    pal = torch.randint(0, 256, (B, 256, 4), generator=gen, dtype=torch.uint8, device=dev)
    return {name: (torch.randint(0, 256, (B, H, row_bytes(W, bpp)), generator=gen,
                                 dtype=torch.uint8, device=dev), pal,
                   dict(bpp=bpp, width=W, top_down=False, allow_alpha=alpha))
            for name, bpp, alpha in K18_ARMS}


def k18_arms(cs, dev) -> dict:
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    npx = cs.BATCH * cs.SIZE * cs.SIZE
    res = {}
    for name, (rows, pal, kw) in k18_inputs(cs, dev).items():
        bpp = kw["bpp"]
        nbytes = rows.numel() + (pal.numel() if bpp <= 8 else 0) + 4 * npx
        ops = cs.OPS_K18_PIXEL[bpp] * npx if kw["allow_alpha"] or bpp != 32 else npx
        same = equal(bmp_unpack(rows, pal, **kw), bmp_unpack_plain(rows, pal, **kw))
        res[name] = timed(cs, lambda rows=rows, pal=pal, kw=kw: bmp_unpack(rows, pal, **kw),
                          same, nbytes, ops)
        res[name]["ns_per_pixel"] = res[name]["ms"] * 1e6 / npx
    return res


def k18_sweep(cs, dev) -> list:
    """K18's arms on a build of bmp_unpack.cu for each of ROW_STEPS, through
    the wrapper (the runtime's library swapped for the build's)."""
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    source = open(os.path.join(runtime.CSRC, "bmp_unpack.cu")).read()
    if not STEPS_CONST.search(source):
        raise SystemExit("torch_expand_stages: --sweep needs bmp_unpack.cu's kRowSteps")
    procs = {}
    for steps in ROW_STEPS:
        work = os.path.join(HERE, "build", "bmp_sweep", f"steps_{steps}")
        os.makedirs(work, exist_ok=True)
        with open(os.path.join(work, "bmp_unpack.cu"), "w") as f:
            f.write(STEPS_CONST.sub(f"constexpr int kRowSteps = {steps};", source))
        so = os.path.join(work, "lib.so")
        procs[steps] = (so, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(work, "bmp_unpack.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for steps, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc (kRowSteps {steps}) failed:\n{out.decode()}")
    ins = k18_inputs(cs, dev)
    want = {name: bmp_unpack_plain(rows, pal, **kw) for name, (rows, pal, kw) in ins.items()}
    out = []
    keep = runtime.lib(), runtime._fns
    try:
        for steps, (so, _) in procs.items():
            runtime._lib, runtime._fns = ctypes.CDLL(so), {}
            row = {"row_steps": steps}
            for name, (rows, pal, kw) in ins.items():
                call = lambda rows=rows, pal=pal, kw=kw: bmp_unpack(rows, pal, **kw)  # noqa
                row[f"{name}_equal_plain"] = equal(call(), want[name])
                row[f"{name}_ms"] = cs.cuda_ms(call, 20)
            out.append(row)
    finally:
        runtime._lib, runtime._fns = keep
    return out


PARTS = {"k12": k12, "k17": k17_arms, "k17_adam7": k17_adam7, "k18": k18_arms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to time, of " + ", ".join(PARTS))
    ap.add_argument("--sweep", action="store_true", help="time K18 at each of ROW_STEPS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_expand_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_expand_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    runtime.lib()
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "torch": torch.__version__,
           **{part: PARTS[part](cs, dev) for part in args.parts.split(",")}}
    if args.sweep:
        res["k18_row_steps"] = k18_sweep(cs, dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
