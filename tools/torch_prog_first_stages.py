#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's progressive first-scan value passes, K8
(DC first) and K9 (AC first, csrc/prog_entropy.cu), on chip_smoke.py's
progressive batch 0, with the work each does.

    python3 tools/torch_prog_first_stages.py [--root CHECKOUT] [--tag NAME]
                                              [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py: 16 copies
of one 1024x1024 4:2:0 q50 progressive JPEG, libjpeg's script of 10 scans
(one DC first, four AC first).

K8: every CUDA kernel and memset of one ``dc_first`` call in launch order
with its device time (``torch.profiler``), the call's time (CUDA events,
mean of 20 behind a spin kernel, as chip_smoke.py times kernels), its
counted launches, lanes, stream bits, the 32-byte store sectors it writes
(one a block: coefficient 0), peak memory, and whether store and ok equal
the plain version's; beside it, PyTorch's strided copy into coefficient 0
of every block of the three grids (``row0_copy``: the scattered writes
alone, three launches).

K9, each of the four AC-first scans alone, on the store as the scans
before it left it: its time and launches as above, lanes (valid blocks),
data lanes (blocks with bits: the rest lie in an EOB run), Huffman
symbols (counted by a lane-parallel walk in plain PyTorch), positions
changed, 32-byte sectors of the store touched (each read and written),
CTAs of the launch and the SMs they reach (computed from the grid the
wrapper picks), peak memory, equality with the plain version, and the
time of the same launch with every hasdata flag 0 (``floor_ms``: the
launch, the table build and the flag sweep, no block decoded).

``--sweep`` (a checkout whose wrappers take their launch shape from
``ops/progressive.py``: ``DC_TILE_LANES``, ``AC_CTAS_PER_SM``) times K8
at each tile size and K9's four scans at each count of CTAs an SM, each
point checked against the plain version.

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
SWEEP_TILES = (128, 256, 512, 1024)
SWEEP_CTAS = (1, 2, 4, 8)


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


def sectors(after, before) -> int:
    """32-byte sectors (8 int32 of a 64-word row) that differ."""
    return int((after != before).view(-1, 8, 8).any(-1).sum())


def ac_first_symbols(stream, starts, hasdata, tables, ss: int, se: int) -> int:
    """Huffman symbols one AC-first scan decodes, by the walk of
    ops/progressive.py's plain version (a lane stops at its first error)."""
    from zpix_tpu_torch.ops.entropy import _bits, _Tables, _window

    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n = starts.shape[0]
    dev = stream.device
    tid = tab.slot_ac[torch.zeros(n, dtype=torch.int64, device=dev)]
    pos = starts.to(torch.int64)
    k = torch.full((n,), ss, dtype=torch.int64, device=dev)
    done = hasdata == 0
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    symbols = 0
    for _ in range(64):
        act = ~done & ~err
        if not bool(act.any()):
            break
        err |= act & ((pos >> 3) + 8 > cap)
        act &= ~err
        symbols += int(act.sum())
        v, off = _window(s64, pos)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        err |= act & bad
        act &= ~bad
        r, size = sym >> 4, sym & 15
        eob = (size == 0) & (r < 15)
        zrl = (size == 0) & (r == 15)
        over = (size > 0) & (k + r > se)
        consume = torch.where(eob, ln + r, torch.where(zrl | over, ln, ln + size))
        new_k = torch.where(zrl, k + 16, torch.where(eob | over, k, k + r + 1))
        pos = torch.where(act, pos + consume, pos)
        k = torch.where(act, new_k, k)
        done |= act & (eob | over | (new_k > se))
    return symbols


def batch(cs, dev):
    """-> (prep, device arrays of each scan, the store before each scan)."""
    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.parallel import progressive_onchip as po

    dec = OnchipProgressiveDecoder()
    prep = dec.prep(cs.make_prog_batches([0])[0])
    scans, _ = dec.upload(prep)
    grids, ok = po.new_store(prep, dev)
    before = []
    for sc, t in zip(prep.scans, scans):
        before.append([g.clone() for g in grids])
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
    torch.cuda.synchronize()
    dec.close()
    return prep, scans, before


def scan_call(prep, sc, t, grids, ok, fn=None):
    from zpix_tpu_torch.parallel import progressive_onchip as po

    return lambda: po.apply_scan(fn or po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)


def equal_plain(prep, sc, t, start) -> tuple:
    """The kernel and the plain version from the same store -> (equal, ok)."""
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    plain = {"dc_first": kp.dc_first_plain, "ac_first": kp.ac_first_plain}[sc.kind]
    got, want = [g.clone() for g in start], [g.clone() for g in start]
    ok_k = torch.ones(1, dtype=torch.int32, device=start[0].device)
    ok_p = ok_k.clone()
    po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, got, prep, ok_k)
    po.apply_scan(plain, sc, t, want, prep, ok_p)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(ok_k, ok_p)
    return same, int(ok_k), got


def k8(cs, prep, scans, before) -> dict:
    from zpix_tpu_torch import runtime

    si = next(i for i, sc in enumerate(prep.scans) if sc.kind == "dc_first")
    sc, t = prep.scans[si], scans[si]
    grids = [g.clone() for g in before[si]]
    tok = torch.ones(1, dtype=torch.int32, device=grids[0].device)
    call = scan_call(prep, sc, t, grids, tok)
    runtime.reset_launches()
    call()
    torch.cuda.synchronize()
    counted = {k: v for k, v in runtime.LAUNCHES.items() if v}
    same, ok, got = equal_plain(prep, sc, t, before[si])
    starts = sc.starts.reshape(prep.batch, -1).astype(np.int64)
    ends = sc.ends.reshape(prep.batch, -1).astype(np.int64)
    lanes = int(sc.starts.shape[0])
    src = [torch.zeros_like(x[..., 0]) for x in grids]

    def row0_copy():
        for x, y in zip(grids, src):
            x[..., 0] = y

    return {"scan": si, "comps": list(sc.comps), "al": sc.al, "ms": cs.cuda_ms(call, 20),
            "row0_copy_ms": cs.cuda_ms(row0_copy, 20), "row0_copy_launches": launches(row0_copy),
            "launches_counted": counted, "launches": launches(call),
            "peak_mem_bytes": peak_bytes(call), "equal_plain": same, "ok": ok, "lanes": lanes,
            "stream_bits": int((ends[:, -1] - starts[:, 0]).sum()),
            "row0_sectors": lanes, "changed": sum(int((a != b).sum())
                                                  for a, b in zip(got, before[si]))}


def k9_grid(n_lanes: int) -> int:
    """CTAs of one K9 launch: the wrapper's own count where it has one,
    else the thread-per-lane grid of 128-thread CTAs."""
    from zpix_tpu_torch.ops import progressive as kp

    grid = getattr(kp, "ac_first_grid", None)
    return grid(n_lanes, torch.device("cuda")) if grid else (n_lanes + 127) // 128


def k9(cs, prep, scans, before) -> dict:
    from zpix_tpu_torch import runtime

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, total = [], 0.0
    for si, (sc, t) in enumerate(zip(prep.scans, scans)):
        if sc.kind != "ac_first":
            continue
        c = sc.comps[0]
        start = before[si]
        g = [x.clone() for x in start]
        tok = torch.ones(1, dtype=torch.int32, device=g[0].device)
        call = scan_call(prep, sc, t, g, tok)
        runtime.reset_launches()
        call()
        torch.cuda.synchronize()
        counted = {k: v for k, v in runtime.LAUNCHES.items() if v}
        same, ok, got = equal_plain(prep, sc, t, start)
        ms = cs.cuda_ms(call, 20)
        floor = scan_call(prep, sc, dict(t, flags=torch.zeros_like(t["flags"])), g, tok)
        lanes = int(t["starts"].shape[0])
        ctas = k9_grid(lanes)
        starts = sc.starts.reshape(prep.batch, -1).astype(np.int64)
        ends = sc.ends.reshape(prep.batch, -1).astype(np.int64)
        rows.append({
            "scan": si, "comp": c, "band": [sc.ss, sc.se], "al": sc.al, "ms": ms,
            "floor_ms": cs.cuda_ms(floor, 20),
            "launches_counted": counted, "launches": launches(call),
            "peak_mem_bytes": peak_bytes(call), "equal_plain": same, "ok": ok,
            "lanes": lanes, "data_lanes": int(sc.flags.sum()),
            "symbols": ac_first_symbols(t["stream"], t["starts"], t["flags"], t["tables"],
                                        sc.ss, sc.se),
            "changed": int((got[c] != start[c]).sum()),
            "sectors": sectors(got[c], start[c]),
            "stream_bits": int((ends[:, -1] - starts[:, 0]).sum()),
            "ctas": ctas, "sms_reached": min(ctas, n_sms)})
        total += ms
        del g, got
    return {"scans": rows, "ms": total, "floor_ms": sum(r["floor_ms"] for r in rows),
            "sectors": sum(r["sectors"] for r in rows)}


def sweep(cs, prep, scans, before) -> dict:
    """K8 at each tile size, K9's four scans at each count of CTAs an SM."""
    from zpix_tpu_torch.ops import progressive as kp

    out = {"k8_tile_lanes": [], "k9_ctas_per_sm": []}
    keep = kp.DC_TILE_LANES, kp.AC_CTAS_PER_SM
    try:
        for tile in SWEEP_TILES:
            kp.DC_TILE_LANES = tile
            si = next(i for i, sc in enumerate(prep.scans) if sc.kind == "dc_first")
            sc, t = prep.scans[si], scans[si]
            same, _, _ = equal_plain(prep, sc, t, before[si])
            g = [x.clone() for x in before[si]]
            tok = torch.ones(1, dtype=torch.int32, device=g[0].device)
            out["k8_tile_lanes"].append({"tile_lanes": tile, "equal_plain": same,
                                         "ms": cs.cuda_ms(scan_call(prep, sc, t, g, tok), 20)})
        kp.DC_TILE_LANES = keep[0]
        for ctas in SWEEP_CTAS:
            kp.AC_CTAS_PER_SM = ctas
            row = {"ctas_per_sm": ctas, "equal_plain": True, "ms": 0.0}
            for si, (sc, t) in enumerate(zip(prep.scans, scans)):
                if sc.kind != "ac_first":
                    continue
                same, _, _ = equal_plain(prep, sc, t, before[si])
                row["equal_plain"] &= same
                g = [x.clone() for x in before[si]]
                tok = torch.ones(1, dtype=torch.int32, device=g[0].device)
                row["ms"] += cs.cuda_ms(scan_call(prep, sc, t, g, tok), 20)
            out["k9_ctas_per_sm"].append(row)
    finally:
        kp.DC_TILE_LANES, kp.AC_CTAS_PER_SM = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prog_first_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_prog_first_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    runtime.lib()
    prep, scans, before = batch(cs, dev)
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "torch": torch.__version__,
           "k8": k8(cs, prep, scans, before), "k9": k9(cs, prep, scans, before)}
    if args.sweep:
        from zpix_tpu_torch.ops import progressive as kp

        if not hasattr(kp, "DC_TILE_LANES"):
            raise SystemExit("torch_prog_first_stages: --sweep needs ops/progressive.py's "
                             "DC_TILE_LANES and AC_CTAS_PER_SM")
        res["sweep"] = sweep(cs, prep, scans, before)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
