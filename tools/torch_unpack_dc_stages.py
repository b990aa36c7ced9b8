#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's sparse unpack K7 (csrc/unpack_sparse.cu)
and DC restore K3 (csrc/dc_restore.cu) on chip_smoke.py's content, with
their bounds and the PyTorch call that computes K3's function.

    python3 tools/torch_unpack_dc_stages.py [--root CHECKOUT] [--tag NAME]
                                            [--sweep] [--stages]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py: 16
distinct 1024x1024 4:2:0 q50 JPEGs a batch.

K7, on the restart-free batch 0 through the native front-end (the flat
buffer on the card): one decode's K7 as the checkout's
``parallel/batch.py::unpack_flat`` runs it (``decode``), and each
component alone through ``unpack_sparse`` (Y, Cb, Cr).  Each: the time
of a call (CUDA events, mean of 20 behind a spin kernel, as chip_smoke.py
times kernels), the host time to enqueue it (``host_ms``: mean of 20
calls with no sync between them), its counted launches, every CUDA
kernel and memset of one call with its device time (``torch.profiler``:
the split between the old offsets and expand kernels), peak memory,
whether it equals the plain version, and its bound (bytes: 8 bitmap bytes and 128 row bytes a
block, 2 bytes a nonzero value, 4 bytes a map entry, over 3.35 TB/s).
No single PyTorch call unpacks bits, clips and permutes: no library time.

K3, on three inputs: ``dri8`` (the main path's batch 0, a restart marker
every 8 MCUs: K1's ends, K2's diffs; 24,576 chains of 32 or 8 blocks),
``host_index`` (the restart-free batch 0 through the host index scan and
K2: 48 whole-image chains) and ``sync`` (the same batch through K19 and
K2).  Each: every form the checkout's ``dc_restore`` takes (``form`` in
the parent's, one kernel in later ones), timed and profiled as K7's
calls, equality with the plain version, the plain version's time, the
bound (bytes: 4 read and 4 written a block), and the library yardstick:
``torch.cumsum(..., dtype=torch.int32)`` a component on views of the
(segment, MCU, slot) layout (``cumsum_ms``: three calls; Y's four slots
an MCU are no view of one stride, so its chain is copied first by a
reshape, and that copy is timed with it; ``cumsum_y_copy_ms``: the copy
alone).

``--stages`` reads K7's and K3's stages as chip_smoke.py's
``native_stages``, ``host_index_stages`` and ``sync_stages`` do (CUDA
events between the launches of one decode, so a stage holds the host's
time to enqueue its call where the card waits for it), over the
restart-free batches 0-5 twice: the mean of each stage a route.

``--sweep`` times K7's decode and K3 on each input at tiles of 128,
256, 512 and 1,024 (blocks a K7 CTA, MCUs a K3 CTA; a thread each), each
point checked against the plain version.  The shipped kernels have one
tile each (``kTile``), so every point is a copy of the checkout's
``zpix_tpu_torch`` under its ``build/tile_sweep/`` with ``kTile`` and the
wrapper's matching constant rewritten, built and timed by this tool in a
process of its own.

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

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_TILES = (128, 256, 512, 1024)
REPS = 20


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


def counted(fn) -> dict:
    from zpix_tpu_torch import runtime

    runtime.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in runtime.LAUNCHES.items() if v}


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def host_ms(fn) -> float:
    """Host time to enqueue one call (mean of REPS, no sync between them):
    what a caller's thread spends before the card can start it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / REPS * 1e3


def timed(cs, fn, plain) -> dict:
    return {"ms": cs.cuda_ms(fn, REPS), "host_ms": host_ms(fn), "launches": launches(fn),
            "launches_counted": counted(fn), "peak_mem_bytes": peak_bytes(fn),
            "equal_plain": same(fn(), plain)}


def k7_inputs(cs, dev):
    """The restart-free batch 0 through the native front-end, on the card:
    (packed, flat buffer, front-end)."""
    from zpix_tpu_torch.parallel import batch as pb

    rf = cs.make_batch(100, dri=None)
    fe = pb.NativeBatchFrontEnd(rf[0], len(rf), pin=True)
    packed = fe.parse(rf)
    flat = pb.upload(packed, dev)
    torch.cuda.synchronize()
    return packed, flat, fe


def k7(cs, packed, flat, fe) -> dict:
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb

    B = packed.batch
    dims = packed.dims
    # as arrays: a checkout's Packed may give stream_perm's ints instead
    perms = [packed.perm_y] + [packed.perm_c] * (len(dims) - 1)
    sections = [(pb.carve(flat, packed.layout, "bm", c, B),
                 pb.carve(flat, packed.layout, "val", c, B)) for c in range(len(dims))]
    # the perms as the checkout's K7 takes them: a tensor on the card in
    # the parent, numpy (a cached map) in later ones
    if not hasattr(ks, "unpack_components"):
        perms = [None if p is None else torch.from_numpy(p).to(flat.device) for p in perms]
    plain = [ks.unpack_sparse_plain(bm, v, bv=bv, bh=bh, perm=p)
             for (bm, v), (bv, bh), p in zip(sections, dims, perms)]

    def decode():
        return pb.unpack_flat(flat, packed.layout, batch=B, dims=dims, perms=packed.perms)

    blocks = B * sum(bv * bh for bv, bh in dims)
    nnz = int(packed.nnz.sum())
    maps = sum(0 if p is None else len(p) for p in perms)
    nbytes = (8 + 128) * blocks + 2 * nnz + 4 * maps
    out = {"decode": timed(cs, decode, plain), "blocks": blocks, "nnz": nnz,
           "value_caps": list(fe.val_caps), "bound_bytes": nbytes,
           "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None, "components": {}}
    for name, (bm, v), (bv, bh), p, want in zip(("y", "cb", "cr"), sections, dims, perms, plain):
        out["components"][name] = timed(
            cs, lambda bm=bm, v=v, bv=bv, bh=bh, p=p: ks.unpack_sparse(bm, v, bv=bv, bh=bh,
                                                                        perm=p), want)
    return out


def k3_inputs(cs) -> dict:
    """{name: (dc diffs, hv, seg_mcus)} on the card."""
    from zpix_tpu_torch import DeviceJpegDecoder, prep_batch
    from zpix_tpu_torch.ops import entropy as ke

    plan = prep_batch(cs.make_batch(0))
    bufs = DeviceJpegDecoder().upload(plan)
    ends, ok = ke.index_pass(*bufs, bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)
    rf = cs.make_batch(100, dri=None)
    hplan, _, _, hdc = cs.host_index_inputs(rf)
    sdc, splan = cs.sync_dc_input(rf)
    torch.cuda.synchronize()
    return {"dri8": (ke.value_pass(*bufs, ends, ok, bpm=plan.bpm)[1], plan.hv, plan.seg_mcus),
            "host_index": (hdc, hplan.hv, hplan.seg_mcus), "sync": (sdc, splan.hv, splan.seg_mcus)}


def y_copy(dc, hv, seg_mcus: int):
    bpm = sum(h * v for h, v in hv)
    nb = hv[0][0] * hv[0][1]
    return dc.view(-1, seg_mcus, bpm)[:, :, :nb].reshape(-1, seg_mcus * nb)


def k3(cs, inputs) -> dict:
    import inspect

    from zpix_tpu_torch.ops import entropy as ke

    forms = ("thread", "block", "auto") if "form" in inspect.signature(
        ke.dc_restore).parameters else (None,)
    out = {}
    for name, (dc, hv, seg) in inputs.items():
        plain = ke.dc_restore_plain(dc, hv=hv, seg_mcus=seg)
        row = {"blocks": dc.numel(), "chains": dc.numel() // (seg * sum(h * v for h, v in hv))
               * len(hv), "seg_mcus": seg, "bound_bytes": 8 * dc.numel(),
               "bound_ms": 8 * dc.numel() / cs.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "plain_ms": cs.cuda_ms(lambda dc=dc, hv=hv, seg=seg: ke.dc_restore_plain(
                   dc, hv=hv, seg_mcus=seg), 1)}
        for form in forms:
            kw = {} if form is None else {"form": form}
            row[form or "kernel"] = timed(
                cs, lambda dc=dc, hv=hv, seg=seg, kw=kw: ke.dc_restore(dc, hv=hv, seg_mcus=seg,
                                                                         **kw), plain)
        lib = lambda dc=dc, hv=hv, seg=seg: cs.cumsum_chains(dc, hv, seg)  # noqa: E731
        bpm = sum(h * v for h, v in hv)
        pv, s0, eq = plain.view(-1, seg, bpm), 0, True
        for (h, v), got in zip(hv, lib()):
            eq &= bool(torch.equal(got, pv[:, :, s0 : s0 + h * v].reshape(got.shape)))
            s0 += h * v
        row["cumsum_ms"] = cs.cuda_ms(lib, REPS)
        row["cumsum_y_copy_ms"] = cs.cuda_ms(lambda dc=dc, hv=hv, seg=seg: y_copy(dc, hv, seg),
                                             REPS)
        row["cumsum_launches"] = launches(lib)
        row["cumsum_equal_plain"] = eq
        out[name] = row
    return out


# (file under zpix_tpu_torch, pattern) of each tile a sweep copy rewrites
_TILE_SITES = (("csrc/unpack_sparse.cu", r"^(constexpr int kTile = )\d+;"),
               ("ops/sparse.py", r"^(K7_TILE_BLOCKS = )\d+$"),
               ("csrc/dc_restore.cu", r"^(constexpr int kTile = )\d+;"),
               ("ops/entropy.py", r"^(K3_TILE_MCUS = )\d+$"))


def sweep_copy(root: str, tile: int) -> str:
    """A copy of ``root``'s zpix_tpu_torch under its build/tile_sweep/,
    with K7's and K3's tile set to ``tile``; -> the copy's root."""
    dst = os.path.join(root, "build", "tile_sweep", f"t{tile}")
    pkg = os.path.join(dst, "zpix_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "zpix_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pat in _TILE_SITES:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            src, n = re.subn(pat, lambda m: m.group(1) + str(tile)
                             + (";" if m.group(0).endswith(";") else ""), f.read(), flags=re.M)
        if n != 1:
            raise SystemExit(f"torch_unpack_dc_stages: no single tile in {path}")
        with open(path, "w") as f:
            f.write(src)
    return dst


def sweep(root: str) -> dict:
    """K7's decode and K3 on each input at each tile of SWEEP_TILES, each
    a copy of the checkout timed by this tool in a process of its own."""
    out = {"k7_tile_blocks": [], "k3_tile_mcus": []}
    for tile in SWEEP_TILES:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                              sweep_copy(root, tile), "--tag", f"t{tile}"],
                             capture_output=True, text=True, check=True)
        r = json.loads(run.stdout.strip().splitlines()[-1])
        d = r["k7"]["decode"]
        out["k7_tile_blocks"].append({"tile_blocks": tile, "ms": d["ms"],
                                      "equal_plain": d["equal_plain"]})
        out["k3_tile_mcus"].append({"tile_mcus": tile, **{
            name: {"ms": x["kernel"]["ms"], "equal_plain": x["kernel"]["equal_plain"]}
            for name, x in r["k3"].items()}})
    return out


def stages(cs) -> dict:
    """Each stage's mean ms between events, native, host-index and sync."""
    import numpy as np

    from zpix_tpu_torch import BatchJpegDecoder, HostIndexJpegDecoder, SyncJpegDecoder

    dev = torch.device("cuda")
    batches = [cs.make_batch(100 + i, dri=None) for i in range(6)]
    native, hidx, sdec = BatchJpegDecoder(), HostIndexJpegDecoder(planar=False), SyncJpegDecoder()
    for d in (native, hidx, sdec):
        d.decode(batches[0])
    torch.cuda.synchronize()
    rows = {"native": [], "host_index": [], "sync": []}
    for _ in range(2):
        for datas in batches:
            rows["native"].append(cs.native_stages(native, datas, dev)[1])
            rows["host_index"].append(cs.host_index_stages(hidx, datas)[2])
            rows["sync"].append(cs.sync_stages(sdec, datas)[2])
    return {route: {k: float(np.mean([r[k] for r in v])) for k in v[0]}
            for route, v in rows.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--stages", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_unpack_dc_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_unpack_dc_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    runtime.lib()
    packed, flat, fe = k7_inputs(cs, dev)
    inputs = k3_inputs(cs)
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "torch": torch.__version__,
           "k7": k7(cs, packed, flat, fe), "k3": k3(cs, inputs)}
    if args.sweep:
        res["sweep"] = sweep(root)
    if args.stages:
        res["stages"] = stages(cs)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
