#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's K13 (QOI sorted expansion,
csrc/qoi_expand.cu) and K10 (progressive AC refinement,
csrc/prog_entropy.cu) on chip_smoke.py's content, with the work each does.

    python3 tools/torch_refine_sorted_stages.py [--root CHECKOUT] [--tag NAME]
                                                [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py.

K13 on three record sets of 16 images of 1024x1024: the noise batch 0 of
chip_smoke.py's qoi phase through the host record pass (about one record
a pixel), the screen batch 0 (run-heavy), and hand-built records
(chip_smoke.k13_hand_records: counts 0-62, a third zero, half the images
short of the pixel count).  Each: the time of a call (CUDA events, mean
of 20 behind a spin kernel, as chip_smoke.py times kernels), its counted
launches, every CUDA kernel and memset of one call in launch order with
its device time (``torch.profiler``), its peak memory, and whether it
equals its plain version.

K10 on the progressive batch 0 of chip_smoke.py (16 copies of one
1024x1024 4:2:0 q50 progressive JPEG; libjpeg's script has four
refinement scans): the store before each refinement scan is saved from a
run of every scan in order; each scan is timed as the restore of its
input and the scan, less the restore alone (means of 20), and checked
against its plain version.  Its work: lanes (valid blocks), lanes that
start inside an EOB run, band positions (lanes x band width), nonzero
band positions before the scan (each reads one correction bit), Huffman
symbols (counted by a lane-parallel walk in plain PyTorch), positions the
scan changed, and stream bits walked.

``--sweep`` (a checkout whose K13 takes its record tile at run time,
``ops/qoi.py::rec_tile``) times K13 through its wrapper at each tile it
takes on the three record sets, each checked against the plain version.

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# ------------------------------------------------------------------- K13


def k13_inputs(cs, dev) -> dict:
    """{name: ((cols, cnts, fill) on the card, shape)}."""
    from zpix_tpu_torch.parallel import qoi_batch as tq

    shape = (cs.BATCH, cs.SIZE, cs.SIZE)
    out = {}
    for content in ("noise", "screen"):
        plan = tq.prep_qoi_records(cs.make_qoi_batches(content, [0])[0])
        out[content] = (tuple(cs.dev_t(a, dev) for a in (plan.cols, plan.cnts, plan.fill)),
                        shape)
    out["hand_built"] = (cs.k13_hand_records(np.random.default_rng(2), dev), shape)
    return out


def k13(cs, ins) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import qoi as kq

    res = {}
    for name, (rec, shape) in ins.items():
        call = lambda rec=rec, shape=shape: kq.sorted_expand(*rec, shape=shape)  # noqa: E731
        runtime.reset_launches()
        got = call()
        torch.cuda.synchronize()
        n_launch = runtime.LAUNCHES["qoi_sorted_expand"]
        same = bool(torch.equal(got, kq.sorted_expand_plain(*rec, shape=shape)))
        del got
        cnts = rec[1].long()
        res[name] = {"ms": cs.cuda_ms(call, 20), "launches_counted": n_launch,
                     "launches": launches(call), "peak_mem_bytes": peak_bytes(call),
                     "equal_plain": same, "rcap": rec[0].shape[1],
                     "records_nonzero": int((cnts > 0).sum()), "pixels_covered": int(
                         cnts.sum(1).clamp(max=shape[1] * shape[2]).sum()),
                     "input_bytes": sum(x.numel() * x.element_size() for x in rec),
                     "output_bytes": shape[0] * shape[1] * shape[2] * 4}
    return res


def k13_sweep(cs, ins) -> list:
    """K13 at each record tile it takes (ops/qoi.py::rec_tile swapped
    while it is timed), on the noise, screen and hand-built records, each
    checked against the plain version."""
    from zpix_tpu_torch.ops import qoi as kq

    keep = kq.rec_tile
    rows = []
    try:
        for tile in kq.REC_TILES:
            kq.rec_tile = lambda rcap, npx, tile=tile: tile  # noqa: E731
            row = {"tile": tile}
            for name, (rec, shape) in ins.items():
                call = lambda rec=rec, shape=shape: kq.sorted_expand(*rec, shape=shape)  # noqa
                row[f"{name}_equal_plain"] = bool(torch.equal(
                    call(), kq.sorted_expand_plain(*rec, shape=shape)))
                row[f"{name}_ms"] = cs.cuda_ms(call, 20)
            rows.append(row)
    finally:
        kq.rec_tile = keep
    return rows


# ------------------------------------------------------------------- K10


def refine_symbols(stream, starts, eob_entry, tables, zig, ss: int, se: int) -> int:
    """Huffman symbols one AC refinement scan decodes, by the walk of
    ops/progressive.py's plain version (lane-parallel, plain PyTorch; a
    lane stops at its first error as the kernel does)."""
    from zpix_tpu_torch.ops.entropy import _bits, _Tables, _window

    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n = starts.shape[0]
    tid = tab.slot_ac[torch.zeros(n, dtype=torch.int64, device=stream.device)]
    pos = starts.to(torch.int64)
    in_eob = eob_entry != 0
    need = ~in_eob
    err = torch.zeros(n, dtype=torch.bool, device=stream.device)
    nz = torch.zeros(n, dtype=torch.int64, device=stream.device)
    symbols = 0
    for kz in range(ss, se + 1):
        want = need & ~err
        err |= want & ((pos >> 3) + 8 > cap)
        want &= ~err
        symbols += int(want.sum())
        v, off = _window(s64, pos)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        r, s = sym >> 4, sym & 15
        err |= want & (bad | (s > 1))
        want &= ~err
        is_eob = (s == 0) & (r < 15)
        pos = torch.where(want, pos + ln + torch.where(s == 1, 1, torch.where(is_eob, r, 0)),
                          pos)
        nz = torch.where(want, torch.where(s == 1, r, torch.where(is_eob, 0, 15)), nz)
        in_eob |= want & is_eob
        need &= ~want
        coef = zig[:, kz]
        corr = ~err & (coef != 0)
        err |= corr & ((pos >> 3) + 8 > cap)
        pos = torch.where(corr & ~err, pos + 1, pos)
        zero = ~err & (coef == 0) & ~in_eob
        place = zero & (nz == 0)
        nz = torch.where(zero & (nz > 0), nz - 1, nz)
        need |= place
    return symbols


def k10(cs, dev) -> dict:
    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    dec = OnchipProgressiveDecoder()
    prep = dec.prep(cs.make_prog_batches([0])[0])
    scans, _ = dec.upload(prep)
    grids, ok = po.new_store(prep, dev)
    inputs = {}
    for si, (sc, t) in enumerate(zip(prep.scans, scans)):
        if sc.kind == "ac_refine":
            inputs[si] = grids[sc.comps[0]].clone()
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
    torch.cuda.synchronize()
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=dev)
    tok = torch.ones(1, dtype=torch.int32, device=dev)
    rows, total = [], {"ms": 0.0, "restore_ms": 0.0}
    for si, before in inputs.items():
        sc, t = prep.scans[si], scans[si]
        g = before.clone()
        valid = po.valid_grid(prep, sc.comps[0])
        args = (t["stream"], t["starts"], t["ends"], t["flags"], t["tables"])
        kw = dict(valid=valid, ss=sc.ss, se=sc.se, al=sc.al)

        def restore(g=g, before=before):
            g.copy_(before)

        def scan(g=g, before=before, args=args, kw=kw):
            g.copy_(before)
            kp.ac_refine(*args, tok, g, **kw)

        scan()
        got_ok = tok.clone()
        want = before.clone()
        want_ok = torch.ones(1, dtype=torch.int32, device=dev)
        kp.ac_refine_plain(*args, want_ok, want, **kw)
        equal = bool(torch.equal(g, want) and torch.equal(got_ok, want_ok))
        restore_ms = cs.cuda_ms(restore, 20)
        ms = cs.cuda_ms(scan, 20) - restore_ms
        nvy, nvx = valid
        zig = before[:, :nvy, :nvx].reshape(-1, 64)[:, unzig]
        band = zig[:, sc.ss : sc.se + 1]
        lanes = int(t["starts"].shape[0])
        symbols = refine_symbols(t["stream"], t["starts"], t["flags"], t["tables"], zig,
                                 sc.ss, sc.se)
        starts = sc.starts.reshape(prep.batch, -1).astype(np.int64)
        ends = sc.ends.reshape(prep.batch, -1).astype(np.int64)
        rows.append({
            "scan": si, "comp": sc.comps[0], "band": [sc.ss, sc.se], "al": sc.al,
            "ms": ms, "restore_ms": restore_ms, "equal_plain": equal, "ok": int(got_ok),
            "lanes": lanes, "eob_entry_lanes": int((t["flags"] != 0).sum()),
            "band_positions": lanes * (sc.se - sc.ss + 1),
            "correction_bits": int((band != 0).sum()), "symbols": symbols,
            "changed": int((g != before).sum()),
            "stream_bits": int((ends[:, -1] - starts[:, 0]).sum()),
            "row_bytes": lanes * 256})
        total["ms"] += ms
        total["restore_ms"] += restore_ms
        del g, want
    return {"scans": rows, **total}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_refine_sorted_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_refine_sorted_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    runtime.lib()
    ins = k13_inputs(cs, dev)
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "torch": torch.__version__,
           "k13": k13(cs, ins), "k10": k10(cs, dev)}
    if args.sweep:
        from zpix_tpu_torch.ops import qoi as kq

        if not hasattr(kq, "rec_tile"):
            raise SystemExit("torch_refine_sorted_stages: --sweep needs ops/qoi.py::rec_tile")
        res["k13_sweep"] = k13_sweep(cs, ins)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
