#!/usr/bin/env python3
"""Device time of zpix_tpu_torch's DC refinement kernel K11
(csrc/prog_store.cu) on chip_smoke.py's progressive batch, with its
bounds.

    python3 tools/torch_dc_refine_stages.py [--root CHECKOUT] [--tag NAME] [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernel can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py: 16 copies
of one 1024x1024 4:2:0 q50 progressive JPEG (libjpeg's script: one DC
refinement scan, interleaved, 393,216 blocks).

For each DC refinement scan of the batch: the time of a call (CUDA
events, mean of 20 behind a spin kernel, as chip_smoke.py times kernels;
OR is idempotent, so every rep does the same work on the same store),
the host time to enqueue it (mean of 20 calls with no sync between
them), each CUDA kernel of one call with its device time
(``torch.profiler``), its counted launches, equality with the plain
version, the blocks and set bits, and its bounds: bytes (the bit rows,
and 8 bytes a set bit: a 4-byte read and write of coefficient 0) and
sectors (a 32-byte sector read and written a set bit), over 3.35 TB/s.
No single PyTorch call unpacks the bits and ORs them into scattered rows:
no library time.

``--sweep`` times K11 at 8 and 32 scan positions a thread (``kRun``),
each a copy of the checkout's ``zpix_tpu_torch`` under its
``build/k11_sweep/`` with ``kRun`` rewritten, built and timed by this tool
in a process of its own.

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_RUNS = (8, 32)
REPS = 20


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_kernels(fn) -> list:
    """[(name, device us)] of one call's kernels, in launch order."""
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


def host_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / REPS * 1e3


def k11(cs) -> list:
    """Each DC refinement scan of the progressive batch 0, timed."""
    from zpix_tpu_torch import OnchipProgressiveDecoder, runtime
    from zpix_tpu_torch.parallel import progressive_onchip as po

    dec = OnchipProgressiveDecoder()
    prep = dec.prep(cs.make_prog_batches([0])[0])
    scans, _quants = dec.upload(prep)
    grids, _ok = dec.decode_coefficients(prep, (scans, _quants))
    ok = torch.ones(1, dtype=torch.int32, device=grids[0].device)
    out = []
    for sc, t in zip(prep.scans, scans):
        if sc.kind != "dc_refine":
            continue
        store = [g.clone() for g in grids]
        plain = [g.clone() for g in grids]

        def call(fn=po.SCAN_KERNELS["dc_refine"], st=store):
            po.apply_scan(fn, sc, t, st, prep, ok)

        call()
        po.apply_scan(plain_fn(), sc, t, plain, prep, ok)
        torch.cuda.synchronize()
        runtime.reset_launches()
        call()
        torch.cuda.synchronize()
        launches = runtime.LAUNCHES["dc_refine"]
        nblk = sum(prep.batch * prep.mxx * prep.myy * h * v
                   for h, v in (prep.hv[c] for c in sc.comps)) if len(sc.comps) > 1 else (
            prep.batch * int(np.prod(po.valid_grid(prep, sc.comps[0]))))
        per = nblk // prep.batch
        bits = np.unpackbits(sc.stream, axis=1)[:, :per]
        set_bits = int(bits.sum())
        out.append({
            "comps": list(sc.comps), "al": sc.al, "blocks": nblk, "set_bits": set_bits,
            "ms": cs.cuda_ms(call, REPS), "host_ms": host_ms(call),
            "kernels": device_kernels(call), "launches_counted": launches,
            "equal_plain": all(torch.equal(a, b) for a, b in zip(store, plain)),
            "bytes_bound_ms": (sc.stream.nbytes + 8 * set_bits) / cs.HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": 64 * set_bits / cs.HBM_BYTES_PER_S * 1e3})
    return out


def plain_fn():
    from zpix_tpu_torch.ops import progressive as kp

    return kp.dc_refine_plain


def sweep_copy(root: str, run: int) -> str:
    """A copy of ``root``'s zpix_tpu_torch under its build/k11_sweep/ with
    K11's ``kRun`` set to ``run``; -> the copy's root."""
    dst = os.path.join(root, "build", "k11_sweep", f"r{run}")
    pkg = os.path.join(dst, "zpix_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "zpix_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "csrc", "prog_store.cu")
    with open(path) as f:
        src, n = re.subn(r"^(constexpr int kRun = )\d+;", lambda m: f"{m.group(1)}{run};",
                         f.read(), flags=re.M)
    if n != 1:
        raise SystemExit(f"torch_dc_refine_stages: no single kRun in {path}")
    with open(path, "w") as f:
        f.write(src)
    return dst


def sweep(root: str) -> list:
    out = []
    for run in SWEEP_RUNS:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                              sweep_copy(root, run), "--tag", f"r{run}"],
                             capture_output=True, text=True, check=True)
        r = json.loads(res.stdout.strip().splitlines()[-1])
        out.append({"run": run, **{k: r["k11"][0][k] for k in ("ms", "equal_plain")}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dc_refine_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_dc_refine_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runtime.lib()
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "k11": k11(cs)}
    if args.sweep:
        res["sweep"] = sweep(root)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
