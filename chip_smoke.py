#!/usr/bin/env python3
"""Smoke check and measurement of zpix_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from zpix_tpu_torch/csrc (nvcc) and the host
library from zpix_tpu_torch/csrc/host (g++), checks each kernel against
its plain PyTorch version on the card (exact equality), decodes batches
of 16 distinct 1024x1024 baseline 4:2:0 JPEGs (quality 50) through the
port's three baseline routes -- ``DeviceJpegDecoder`` on streams with a
restart marker every 8 MCUs, and ``BatchJpegDecoder`` (native front-end,
K7, K6) and ``HostIndexJpegDecoder`` (host index scan, K2, K3, K4) on
streams with none -- and batches of 16 copies of one 1024x1024 4:2:0
progressive JPEG (a new image each batch) through
``OnchipProgressiveDecoder`` (host index walks, K8-K11, K3, K6), times
them with CUDA events, checks that corrupt streams are flagged, and
prints one JSON object per line.  The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero.  Without
CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

import numpy as np
import torch

BATCH, SIZE, QUALITY, DRI = 16, 1024, 50, 8
TIMED_BATCHES = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# int32 operations, a multiply and an add counting two as in FLOP/s: an
# SM has half as many INT32 as FP32 lanes, so half of the data sheet's
# 67 TFLOP/s float32 rate outside the tensor cores
INT32_OPS_PER_S = 67e12 / 2
BOOST_HZ = 1.98e9  # H100 SXM boost clock, data sheet
# The least arithmetic each function needs (multiplies, adds, shifts,
# compares), counted on the functions, not on this port's kernels:
# - a Huffman symbol through a 16-bit lookahead table: peek (shift, mask),
#   consume code and extra bits (two adds), next index, end test;
#   K2 adds RECEIVE/EXTEND (shift, mask, compare, add);
# - the Wang IDCT of a block: 8 row butterflies of 55 and 8 column
#   butterflies of 64 operations (zpix_tpu/ops/idct.py:192-239);
# - K4 per coefficient: dequant multiply, +128, two clamps; per pixel:
#   scale Y, four channel sums, three clamp-shifts of three operations;
#   per chroma pair: two -128 and four products (zpix_tpu/ops/ycbcr.py).
OPS_K1_SYMBOL, OPS_K2_SYMBOL = 6, 10
OPS_IDCT_BLOCK = 8 * 55 + 8 * 64
OPS_K4_BLOCK, OPS_K4_PIXEL, OPS_K4_CHROMA = OPS_IDCT_BLOCK + 64 * 4, 14, 6
# - K7 per block: popcount and scan add; per coefficient: bit test (shift,
#   mask) and select.  K6 counts as K4 does (same arithmetic per block,
#   pixel and chroma pair).
OPS_K7_BLOCK = 2 + 64 * 3
# - K10 per band position of a block: load, zero test, count or bit read,
#   advance; K11 per block: bit extract (shift, mask), OR; K8 per block,
#   after its symbol: the prefix add and the shift.
OPS_K10_POSITION, OPS_K11_BLOCK, OPS_K8_BLOCK = 4, 3, 2
# Serial-chain bound of K1 and K2: each symbol's position depends on the
# previous symbol's length, so one step is at least a shared-memory table
# lookup and a shift and an add; taken as 30 cycles at the boost clock
# (an assumption, not a measurement).
CHAIN_CYCLES_PER_SYMBOL = 30

KERNELS = {  # name -> (source, TPU-side function it replaces)
    "unpack_sparse": ("zpix_tpu_torch/csrc/unpack_sparse.cu",
                      "zpix_tpu/parallel/batch.py:560"),
    "component_planes": ("zpix_tpu_torch/csrc/planes.cu",
                         "zpix_tpu/parallel/batch.py:84"),
    "index_pass": ("zpix_tpu_torch/csrc/entropy.cu",
                   "zpix_tpu/parallel/device_entropy.py:974"),
    "value_pass": ("zpix_tpu_torch/csrc/entropy.cu",
                   "zpix_tpu/parallel/device_entropy.py:611"),
    "dc_restore": ("zpix_tpu_torch/csrc/dc_restore.cu",
                   "zpix_tpu/parallel/device_entropy.py:836"),
    "backend": ("zpix_tpu_torch/csrc/backend.cu",
                "zpix_tpu/parallel/device_entropy.py:1289"),
    "idct_blocks": ("zpix_tpu_torch/csrc/idct.cu", "zpix_tpu/ops/idct.py:242"),
    "dc_first": ("zpix_tpu_torch/csrc/prog_entropy.cu",
                 "zpix_tpu/parallel/progressive_onchip.py:799"),
    "ac_first": ("zpix_tpu_torch/csrc/prog_entropy.cu",
                 "zpix_tpu/parallel/progressive_onchip.py:866"),
    "ac_refine": ("zpix_tpu_torch/csrc/prog_entropy.cu",
                  "zpix_tpu/parallel/progressive_onchip.py:937"),
    "dc_refine": ("zpix_tpu_torch/csrc/prog_store.cu",
                  "zpix_tpu/parallel/progressive_onchip.py:1713"),
}
PROG_KINDS = ("dc_first", "ac_first", "ac_refine", "dc_refine")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_bench_jpeg(size: int, quality: int, seed: int, dri_blocks,
                    progressive: bool = False) -> bytes:
    """Structured 4:2:0 test image, with a restart marker every
    ``dri_blocks`` MCUs or none (None), baseline or progressive: the JAX
    package's bench content, a sine pattern with seeded noise."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    x = np.linspace(0, 20, size)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]) + seed)).astype(np.uint8)
    noise = rng.randint(0, 24, (size, size)).astype(np.uint8)
    rgb = np.stack([base ^ noise, base.T, (base // 2 + 64)], -1)
    buf = BytesIO()
    kw = {} if dri_blocks is None else {"restart_marker_blocks": dri_blocks}
    if progressive:
        kw["progressive"] = True
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality, subsampling=2, **kw)
    return buf.getvalue()


def make_batch(index: int, batch: int = BATCH, size: int = SIZE, dri=DRI):
    return [make_bench_jpeg(size, QUALITY, index * batch + j, dri) for j in range(batch)]


def make_batches(indices, dri=DRI):
    """make_batch for each index, on a thread pool (Pillow's encoder and
    numpy release the GIL)."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return list(ex.map(lambda i: make_batch(i, dri=dri), indices))


def truncate_scan(data: bytes, n: int) -> bytes:
    """Drop n entropy bytes before EOI: the host index walk reads zeros
    past the stream's end where the card reads the next image's bytes,
    so the value pass's agree check must fail."""
    body = data[:-2 - n]
    while body[-1] == 0xFF:  # never leave half of a stuffed FF00 pair
        body = body[:-1]
    return body + data[-2:]


def inject_invalid_codes(data: bytes) -> bytes:
    """Overwrite 8 bytes in the middle of the scan with FF00 pairs: they
    destuff to FF bytes, and an all-ones 16-bit code is invalid in every
    table libjpeg writes, so the segment holding them must fail."""
    sos = data.find(b"\xff\xda")
    mid = (sos + len(data)) // 2
    while data[mid - 1] == 0xFF:  # do not split a stuffed pair or a marker
        mid += 1
    out = bytearray(data)
    out[mid : mid + 8] = b"\xff\x00" * 4
    if out[mid + 8] == 0x00:  # the byte after was the 00 of a stuffed FF
        out[mid + 8] = 0x01
    return bytes(out)


def flip_bytes(data: bytes) -> bytes:
    """Flip a run of 40 entropy bytes near the end of the scan."""
    out = bytearray(data)
    tail = len(out) - 600
    for i in range(tail, tail + 40):
        out[i] ^= 0x55
    return bytes(out)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up.  A
    spin kernel (~10 ms) holds the stream while the launches are queued,
    so a call whose host side is slower than its kernels is timed by the
    card, not by the rate at which the host issues it."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def segment_symbols(ac, dc_diff, seg_nmcu, nblk: int, bpm: int):
    """Huffman symbols per block (DC, AC with ZRLs, EOB) from decoded
    coefficients, -> (max per restart segment, max per block, total)."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG

    zz = ac[:, torch.as_tensor(UNZIG, device=ac.device).long()][:, 1:] != 0  # [L2, 63]
    idx = torch.arange(1, 64, device=ac.device)
    last = torch.where(zz, idx, 0).max(1).values
    prev = torch.cummax(torch.where(zz, idx, 0), 1).values
    prev = torch.cat([torch.zeros_like(prev[:, :1]), prev[:, :-1]], 1)
    run = torch.where(zz, idx - prev - 1, 0)
    syms = 1 + zz.sum(1) + (run // 16).sum(1) + (last < 63).long()
    blk = torch.arange(ac.shape[0], device=ac.device) % nblk
    valid = (blk // bpm) < seg_nmcu.long().repeat_interleave(nblk)
    syms = torch.where(valid, syms, 0)
    return int(syms.view(-1, nblk).sum(1).max()), int(syms.max()), int(syms.sum())


# ------------------------------------------------- restart-free slice (K3, K6, K7)

_SMALL_PLANES = [("gray", [(1, 1)], None), ("ycbcr", [(1, 1)] * 3, "444"),
                 ("ycbcr", [(2, 1), (1, 1), (1, 1)], "422"),
                 ("ycbcr", [(2, 2), (1, 1), (1, 1)], "420"),
                 ("ycbcr", [(1, 2), (1, 1), (1, 1)], "440"),
                 ("ycbcr", [(4, 1), (1, 1), (1, 1)], "411"),
                 ("ycbcr", [(4, 2), (1, 1), (1, 1)], "410"),
                 ("rgb", [(2, 1), (1, 1), (1, 1)], "422"),
                 ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)], "420"),
                 ("cmyk", [(1, 1)] * 4, None), ("cmyk", [(2, 2), (1, 1), (1, 1), (2, 2)], None)]


def small_kernel_checks(dev):
    """K7 and K6 against their plain versions on small random inputs: K6
    on every colour arm and ratio (full-range values and quants whose
    products wrap), K7 with the perm of every ratio and a clipped cap.
    -> {case: max_abs_err}."""
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb

    gen = torch.Generator(device="cpu").manual_seed(1)
    errs = {}
    mxx, myy, B = 7, 5, 3
    for color, hv, ratio in _SMALL_PLANES:
        for wide in (False, True):
            lim = 2**15 if wide else 1024
            grids = [torch.randint(-lim, lim, (B, myy * v, mxx * h, 64), generator=gen,
                                   dtype=torch.int16) for h, v in hv]
            grids = [(g * (torch.rand(g.shape, generator=gen) < 0.3)).to(dev) for g in grids]
            quants = [torch.randint(1, 2**16 if wide else 64, (B, 64), generator=gen,
                                    dtype=torch.int32).to(dev) for _ in hv]
            H, W = 8 * hv[0][1] * myy - 3, 8 * hv[0][0] * mxx - 5
            kw = dict(color=color, height=H, width=W, ratio=ratio,
                      sub=tuple(x != hv[0] for x in hv))
            got = pb.decode_batch_planes(grids, quants, **kw)
            factors = ([(1, 1)] if color == "gray" else
                       [(2, 2) if x else (1, 1) for x in kw["sub"]] if color == "cmyk" else
                       [(1, 1)] + [pb.RATIO_FACTORS[ratio]] * 2 + [(1, 1)] * (len(hv) - 3))
            want = kp.component_planes_plain(grids, quants, color=color, height=H, width=W,
                                             factors=factors)
            pattern = ratio or "".join(f"{h}{v}" for h, v in hv)
            errs[f"planes_{color}_{pattern}_{'wide' if wide else 'jpeg'}"] = (
                max_abs_err(got, want))
    for hv in ((2, 2), (2, 1), (1, 2), (4, 1), (4, 2)):
        bv, bh = myy * hv[1], mxx * hv[0]
        bm = (torch.randint(0, 256, (B, bv * bh, 8), generator=gen, dtype=torch.uint8)
              & torch.randint(0, 256, (B, bv * bh, 8), generator=gen, dtype=torch.uint8)).to(dev)
        for cap in (bv * bh * 64, 100):
            vals = torch.randint(-2**15, 2**15, (B, cap), generator=gen, dtype=torch.int16).to(dev)
            perm = torch.from_numpy(pb.stream_perm(mxx, myy, *hv)).to(dev)
            got = ks.unpack_sparse(bm, vals, bv=bv, bh=bh, perm=perm)
            want = ks.unpack_sparse_plain(bm, vals, bv=bv, bh=bh, perm=perm)
            errs[f"unpack_{hv[0]}{hv[1]}_cap{cap}"] = max_abs_err(got, want)
    torch.cuda.synchronize()
    return errs


def native_stages(dec, datas, dev):
    """One batch through BatchJpegDecoder's stages with CUDA events between
    them -> (pixels, {stage: ms}): host parse (host clock), H2D, K7 (all
    components), K6."""
    from zpix_tpu_torch.parallel import batch as pb

    t0 = time.perf_counter()
    packed = dec.front_end(datas).packed()
    parse_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    buf = pb.upload(packed, dev)
    ev[1].record()
    grids = pb.unpack_flat(buf, packed.layout, batch=packed.batch, dims=packed.dims,
                           perms=packed.perms)
    ev[2].record()
    quants = [pb.carve(buf, packed.layout, "q", c, packed.batch) for c in range(3)]
    px = pb.decode_batch_planes(grids, quants, color=packed.color, height=packed.height,
                                width=packed.width, ratio=packed.ratio)
    ev[3].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    return px, {"host_parse": parse_ms, "h2d": ms[0], "unpack_sparse": ms[1],
                "component_planes": ms[2], "device_total": ev[0].elapsed_time(ev[3])}


def host_index_stages(dec, datas):
    """One batch through HostIndexJpegDecoder's stages -> (pixels, ok,
    {stage: ms}): host index scan (host clock), H2D, K2, K3, K4."""
    from zpix_tpu_torch import prep_batch_host_index
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import entropy as ke

    t0 = time.perf_counter()
    plan = prep_batch_host_index(datas)
    scan_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    bb = dec.upload(plan)
    ev[1].record()
    ok = torch.ones(1, dtype=torch.int32, device=bb[0].device)
    a, d = ke.value_pass(*bb[:4], bb[4], ok, bpm=plan.bpm)
    ev[2].record()
    d = ke.dc_restore(d, hv=plan.hv, seg_mcus=plan.seg_mcus)
    ev[3].record()
    px = kb.backend(a, d, bb[3], kb.BackendGeometry.of(plan), planar=dec.planar)
    ev[4].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    return px, bool(ok), {"host_index_scan": scan_ms, "h2d": ms[0], "value_pass": ms[1],
                          "dc_restore": ms[2], "backend": ms[3],
                          "device_total": ev[0].elapsed_time(ev[4])}


def restart_free(batches, dev, mpix):
    """The two restart-free routes on the same batches: launches, plain-path
    equality on images 0 and 1, timed end to end and by stage, pixels equal
    between routes, a corrupt stream flagged.  -> a summary dict."""
    from zpix_tpu_torch import BatchJpegDecoder, HostIndexJpegDecoder, runtime
    from zpix_tpu_torch import prep_batch_host_index
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb

    native, hidx = BatchJpegDecoder(), HostIndexJpegDecoder(planar=False)
    native.decode(batches[1])  # warm: pinned buffers, caches
    hidx.decode(batches[1])
    torch.cuda.synchronize()
    runtime.reset_launches()
    px_n = native.decode(batches[0])
    torch.cuda.synchronize()
    launches_native = dict(runtime.LAUNCHES)
    runtime.reset_launches()
    px_h, ok_h = hidx.decode(batches[0])
    torch.cuda.synchronize()
    launches_hidx = dict(runtime.LAUNCHES)

    # images 0 and 1 against the plain path on the card, for each route
    fe2 = pb.NativeBatchFrontEnd(batches[0][0], 2)
    fe2.parse(batches[0][:2])
    p2 = fe2.packed()
    buf2 = pb.upload(p2, dev)
    dims = p2.dims
    perms = [None if p is None else torch.from_numpy(p).to(dev) for p in p2.perms]
    grids = [ks.unpack_sparse_plain(pb.carve(buf2, p2.layout, "bm", c, 2),
                                    pb.carve(buf2, p2.layout, "val", c, 2), bv=bv, bh=bh,
                                    perm=perm)
             for c, ((bv, bh), perm) in enumerate(zip(dims, perms))]
    quants = [pb.carve(buf2, p2.layout, "q", c, 2) for c in range(3)]
    f = pb.RATIO_FACTORS[p2.ratio]
    ref_n = kp.component_planes_plain(grids, quants, color="ycbcr", height=p2.height,
                                      width=p2.width, factors=[(1, 1), f, f])
    plan2 = prep_batch_host_index(batches[0][:2])
    b2 = hidx.upload(plan2)
    ok2 = torch.ones(1, dtype=torch.int32, device=dev)
    a2, d2 = ke.value_pass_plain(*b2[:4], b2[4], ok2, bpm=plan2.bpm)
    d2 = ke.dc_restore_plain(d2, hv=plan2.hv, seg_mcus=plan2.seg_mcus)
    ref_h = kb.backend_plain(a2, d2, b2[3], kb.BackendGeometry.of(plan2), planar=False)
    torch.cuda.synchronize()
    check = {"native_vs_plain": max_abs_err(px_n[:2], ref_n),
             "host_index_vs_plain": max_abs_err(px_h[:2], ref_h),
             "plain_ok": bool(ok2), "routes_equal": bool(torch.equal(px_n, px_h)),
             "host_index_ok": bool(ok_h)}

    # timed end to end, bytes in to a synchronised tensor, the two routes in
    # turn on each batch; peak memory is what one decode allocates at most
    # above what was held before it
    timed = {r: {"walls": [], "oks": [], "peak_mem_bytes": 0} for r in ("native", "host_index")}
    equal = []
    for datas in batches[2:]:
        outs = []
        for route, run in (("native", lambda d: (native.decode(d), True)),
                           ("host_index", hidx.decode)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            px, ok = run(datas)
            torch.cuda.synchronize()
            timed[route]["walls"].append(time.perf_counter() - t0)
            timed[route]["oks"].append(bool(ok))
            timed[route]["peak_mem_bytes"] = max(timed[route]["peak_mem_bytes"],
                                                 torch.cuda.max_memory_allocated() - base)
            outs.append(px)
        equal.append(bool(torch.equal(*outs)))
        del outs
    # per-stage breakdown over the same batches
    stages = {"native": [], "host_index": []}
    for datas in batches[2:]:
        _, st = native_stages(native, datas, dev)
        stages["native"].append(st)
        _, ok, st = host_index_stages(hidx, datas)
        stages["host_index"].append(st)
        timed["host_index"]["oks"].append(ok)
    routes = {}
    for route in ("native", "host_index"):
        walls = timed[route]["walls"]
        mean = {k: float(np.mean([st[k] for st in stages[route]])) for k in stages[route][0]}
        routes[route] = {
            "e2e_ms_per_batch": [w * 1e3 for w in walls],
            "e2e_mpix_per_s": mpix / float(np.mean(walls)),
            "device_mpix_per_s": mpix / (mean["device_total"] / 1e3),
            "device_busy_share": mean["device_total"] / (float(np.mean(walls)) * 1e3),
            "stage_ms_mean": mean, "peak_mem_bytes": timed[route]["peak_mem_bytes"],
            "launches_per_decode": {k: v for k, v in (
                launches_native if route == "native" else launches_hidx).items() if v},
        }

    # a corrupt stream on the host-index route: image 0 cut short.  Where
    # the host walk stays inside the stream's 8-byte alignment padding both
    # sides read zeros and agree (as in zpix_tpu); the first cut whose walk
    # runs past it must clear ok
    corrupt = {"outcomes": {}}
    for n in range(1, 65):
        try:
            _, okc = hidx.decode([truncate_scan(batches[0][0], n)] + batches[0][1:])
        except ZpixError:
            corrupt["outcomes"][n] = "host_scan_raised"
            continue
        corrupt["outcomes"][n] = "ok_false" if not bool(okc) else "ok_true"
        if not bool(okc):
            corrupt.update(cut_bytes=n, ok=False)
            break
    return {"launches": {"native": launches_native, "host_index": launches_hidx},
            "check": check, "routes": routes, "batches": len(batches) - 2,
            "all_ok": all(timed["host_index"]["oks"]), "routes_equal_per_batch": equal,
            "corrupt": corrupt}


def host_index_inputs(batch):
    """K2's outputs on a host-index batch: (plan, bufs, ac, dc diffs)."""
    from zpix_tpu_torch import HostIndexJpegDecoder, prep_batch_host_index
    from zpix_tpu_torch.ops import entropy as ke

    plan = prep_batch_host_index(batch)
    bufs = HostIndexJpegDecoder().upload(plan)
    ok = torch.ones(1, dtype=torch.int32, device=bufs[0].device)
    ac, dc = ke.value_pass(*bufs[:4], bufs[4], ok, bpm=plan.bpm)
    return plan, bufs, ac, dc


# ---------------------------------------------------- progressive slice (K8-K11)


def make_prog_batches(indices):
    """One 1024^2 4:2:0 q50 progressive image per batch, repeated BATCH
    times: Pillow gives every progressive image its own Huffman tables, and
    a batch must share them (the JAX package's BENCH_MODE=prog batches
    one image the same way)."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        images = list(ex.map(lambda i: make_bench_jpeg(SIZE, QUALITY, 1000 + i, None, True),
                             indices))
    return [[d] * BATCH for d in images]


def prog_plain():
    from zpix_tpu_torch.ops import progressive as kp

    return {"dc_first": kp.dc_first_plain, "ac_first": kp.ac_first_plain,
            "ac_refine": kp.ac_refine_plain, "dc_refine": kp.dc_refine_plain}


def prog_scan_checks(prep, bufs):
    """Every scan of one batch, in order: the kernel and its plain version
    on the same store and inputs, compared; the kernel's store goes on.
    -> (final grids, ok, {kind: max_abs_err}, {kind: work counts}, the
    store before each AC refinement scan)."""
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    plain = prog_plain()
    grids, ok = po.new_store(prep, bufs[1].device)
    errs = {k: 0 for k in PROG_KINDS}
    work = {k: {"scans": 0, "lanes": 0, "data_lanes": 0, "stream_bytes": 0, "changed": 0,
                "band_positions": 0} for k in PROG_KINDS}
    refine_inputs = {}
    for si, (sc, t) in enumerate(zip(prep.scans, bufs[0])):
        before = [g.clone() for g in grids]
        if sc.kind == "ac_refine":
            refine_inputs[si] = before[sc.comps[0]]
        p_grids, p_ok = [g.clone() for g in grids], ok.clone()
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
        po.apply_scan(plain[sc.kind], sc, t, p_grids, prep, p_ok)
        torch.cuda.synchronize()
        errs[sc.kind] = max(errs[sc.kind], max_abs_err(ok, p_ok),
                            *(max_abs_err(a, b) for a, b in zip(grids, p_grids)))
        w = work[sc.kind]
        w["scans"] += 1
        w["changed"] += sum(int((a != b).sum()) for a, b in zip(grids, before))
        if sc.kind == "dc_refine":
            g = [grids[c] for c in sc.comps]
            w["lanes"] += prep.batch * kp.scan_blocks(
                g, [prep.hv[c] for c in sc.comps], po.valid_grid(prep, sc.comps[0]))
            w["stream_bytes"] += sc.stream.nbytes
            continue
        w["lanes"] += sc.starts.shape[0]
        ends = sc.ends.reshape(prep.batch, -1).astype(np.int64)
        starts = sc.starts.reshape(prep.batch, -1).astype(np.int64)
        w["stream_bytes"] += int((ends[:, -1] - starts[:, 0]).sum() + 7) // 8  # bits walked
        if sc.kind == "ac_first":
            w["data_lanes"] += int(sc.flags.sum())
        if sc.kind == "ac_refine":
            w["band_positions"] += sc.starts.shape[0] * (sc.se - sc.ss + 1)
        del before, p_grids
    return grids, ok, errs, work, refine_inputs


MIXED_STREAMS, MIXED_QUANTS = (3, 8, 13), (5, 10)


def mixed_prep(prep):
    """A copy of ``prep`` whose images differ after the host walk, so that a
    kernel that put one image's lanes, rows or quant into another would
    disagree with its plain version: two bytes of every scan of the images
    MIXED_STREAMS XORed, each image at its own place (their lanes from
    there on fail their end checks and write other values), and the quant
    rows of the images MIXED_QUANTS changed."""
    B, scans = prep.batch, []
    for si, sc in enumerate(prep.scans):
        s = sc.stream.copy()
        for b in MIXED_STREAMS:
            if sc.kind == "dc_refine":  # raw bit rows [B, rowlen]
                s[b, (b * 7 + si) % s.shape[1]] ^= 0x5A
                continue
            lo = int(sc.starts.reshape(B, -1)[b, 0]) // 8
            hi = (int(sc.ends.reshape(B, -1)[b, -1]) + 7) // 8
            at = lo + (hi - lo) * (b + 1) // (B + 2)
            s[at : at + 2] ^= 0x5A
        scans.append(dataclasses.replace(sc, stream=s))
    quants = prep.quants.copy()
    for b in MIXED_QUANTS:
        quants[:, b] += b
    return dataclasses.replace(prep, scans=scans, quants=quants)


def prog_mixed_checks(dec, prep, kw6):
    """K8-K11 and K6's int32 arm against their plain versions on the full
    batch with images made to differ (``mixed_prep``) -> {kind:
    max_abs_err, "images_differ_store": n, "images_differ_pixels": n}."""
    from zpix_tpu_torch.ops import planes as kp6

    mp = mixed_prep(prep)
    mbufs = dec.upload(mp)
    grids, _, errs, _, _ = prog_scan_checks(mp, mbufs)
    quants = list(mbufs[1])
    px = kp6.component_planes(grids, quants, **kw6)
    errs["component_planes_int32"] = max_abs_err(
        px, kp6.component_planes_plain(grids, quants, **kw6))
    store_differs = torch.zeros(mp.batch, dtype=torch.bool, device=px.device)
    for g in grids:
        store_differs |= (g != g[:1]).flatten(1).any(1)
    errs["images_differ_store"] = int(store_differs.sum())
    errs["images_differ_pixels"] = int((px != px[:1]).flatten(1).any(1).sum())
    del grids, px
    return errs


def prog_stages(dec, datas, plain=None):
    """One 4:2:0 batch through OnchipProgressiveDecoder's stages -> (pixels,
    ok, {stage: ms}): parse and index walks (host clock), then CUDA events
    around H2D, the store, each scan (summed by kind; K8's include its K3
    launch) and K6.  ``plain`` (prog_plain()) takes the plain versions,
    K6's too."""
    from zpix_tpu_torch.ops import planes as kp6
    from zpix_tpu_torch.parallel import progressive_onchip as po
    from zpix_tpu_torch.parallel.batch import RATIO_FACTORS

    t0 = time.perf_counter()
    plans = [po.parse_progressive(d) for d in datas]
    po.check_batch(plans)
    t1 = time.perf_counter()
    prep = po.prep_hostindex(plans, dec._pool)
    t2 = time.perf_counter()
    fns = plain or po.SCAN_KERNELS
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4 + 2 * len(prep.scans))]
    torch.cuda.synchronize()
    ev[0].record()
    bufs = dec.upload(prep)
    ev[1].record()
    grids, ok = po.new_store(prep, dec.device)
    ev[2].record()
    for i, (sc, t) in enumerate(zip(prep.scans, bufs[0])):
        ev[3 + 2 * i].record()
        po.apply_scan(fns[sc.kind], sc, t, grids, prep, ok)
        ev[4 + 2 * i].record()
    kw6 = dict(color="ycbcr", height=prep.height, width=prep.width,
               factors=[(1, 1)] + [RATIO_FACTORS[prep.ratio]] * 2)
    k6 = kp6.component_planes if plain is None else kp6.component_planes_plain
    px = k6(grids, list(bufs[1]), **kw6)
    ev[-1].record()
    torch.cuda.synchronize()
    st = {"parse": (t1 - t0) * 1e3, "index_walks": (t2 - t1) * 1e3,
          "h2d": ev[0].elapsed_time(ev[1]), "store_zero": ev[1].elapsed_time(ev[2]),
          **{k: 0.0 for k in PROG_KINDS},
          "component_planes": ev[-2].elapsed_time(ev[-1]),
          "device_total": ev[0].elapsed_time(ev[-1])}
    for i, sc in enumerate(prep.scans):
        st[sc.kind] += ev[3 + 2 * i].elapsed_time(ev[4 + 2 * i])
    return px, bool(ok), st


def corrupt_first_scan(data: bytes) -> bytes:
    """Overwrite 8 bytes at the start of the first scan's entropy data with
    FF00 pairs: they destuff to FF bytes, an all-ones code no table holds,
    so the host's DC-first walk refuses the stream."""
    sos = data.find(b"\xff\xda")
    at = sos + 2 + ((data[sos + 2] << 8) | data[sos + 3]) + 2
    out = bytearray(data)
    out[at : at + 8] = b"\xff\x00" * 4
    if out[at + 8] == 0x00:  # the byte after was the 00 of a stuffed FF
        out[at + 8] = 0x01
    return bytes(out)


def progressive(dev):
    """The progressive route: kernels against their plain versions scan by
    scan on a full batch, as it is and with its images made to differ,
    launches of one decode, images 0 and 1 against the plain path and
    Pillow, 10 timed batches end to end and by stage, corrupt streams.
    -> (summary dict, {kernel: timing entry})."""
    from PIL import Image

    from zpix_tpu_torch import OnchipProgressiveDecoder, runtime
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import planes as kp6
    from zpix_tpu_torch.parallel import progressive_onchip as po
    from zpix_tpu_torch.parallel.batch import RATIO_FACTORS

    t0 = time.perf_counter()
    batches = make_prog_batches(range(TIMED_BATCHES + 2))
    content_s = time.perf_counter() - t0
    dec = OnchipProgressiveDecoder()
    prep = dec.prep(batches[0])
    bufs = dec.upload(prep)
    script = [f"{sc.kind}{list(sc.comps)} {sc.ss}-{sc.se} al{sc.al}" for sc in prep.scans]

    # K8-K11 against their plain versions, scan by scan, on the full batch
    grids, ok_k, errs, work, refine_inputs = prog_scan_checks(prep, bufs)
    quants = list(bufs[1])
    kw6 = dict(color="ycbcr", height=SIZE, width=SIZE,
               factors=[(1, 1)] + [RATIO_FACTORS[prep.ratio]] * 2)
    px6 = kp6.component_planes(grids, quants, **kw6)
    errs["component_planes_int32"] = max_abs_err(px6, kp6.component_planes_plain(grids, quants,
                                                                                **kw6))
    # the same at full width on images made to differ
    mixed = prog_mixed_checks(dec, prep, kw6)
    torch.cuda.synchronize()

    # the main path: one decode, launches counted
    dec.decode(batches[1])  # warm: pinned buffer, thread pool
    torch.cuda.synchronize()
    runtime.reset_launches()
    px, ok = dec.decode(batches[0])
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    # images 0 and 1 against the plain path on the card, image 0 against Pillow
    ref2, ok2, _ = prog_stages(dec, batches[0][:2], plain=prog_plain())
    pil = np.asarray(Image.open(BytesIO(batches[0][0])).convert("RGB"))
    check = {"max_abs_err": errs, "mixed_batch": mixed, "kernels_ok": bool(ok_k),
             "main_ok": bool(ok),
             "main_vs_plain": max_abs_err(px[:2], ref2), "plain_ok": ok2,
             "mean_abs_diff_vs_pillow": float(np.abs(px[0].cpu().numpy().astype(np.int32)
                                                     - pil.astype(np.int32)).mean()),
             "shape": list(px.shape)}

    # timed end to end, then by stage, over the same 10 batches
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    walls, oks, peak = [], [], 0
    for datas in batches[2:]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        px_t, ok_t = dec.decode(datas)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        oks.append(bool(ok_t))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        del px_t
    stages = []
    for datas in batches[2:]:
        _, ok_s, st = prog_stages(dec, datas)
        oks.append(ok_s)
        stages.append(st)
    mean = {k: float(np.mean([st[k] for st in stages])) for k in stages[0]}
    mpix = BATCH * SIZE * SIZE / 1e6

    # corrupt streams: the host walk refuses one; the kernels catch bytes
    # changed after the walk
    bad = [corrupt_first_scan(batches[0][0])] + batches[0][1:]
    _, ok_bad = dec.decode(bad)
    bad_prep = dec.prep(bad)
    late = dec.prep(batches[0][:2])
    late.scans[0].stream = late.scans[0].stream.copy()
    late.scans[0].stream[64:72] ^= 0x55
    _, ok_late = dec.run(late)
    corrupt = {"walk_refused_ok": bool(ok_bad), "failure": bad_prep.failure,
               "changed_after_walk_ok": bool(ok_late)}

    summary = {
        "script": script, "content_seconds": content_s, "check": check,
        "launches": launches, "batches": len(walls), "all_ok": all(oks),
        "e2e_ms_per_batch": [w * 1e3 for w in walls],
        "e2e_mpix_per_s": mpix / float(np.mean(walls)),
        "device_mpix_per_s": mpix / (mean["device_total"] / 1e3),
        "device_busy_share": mean["device_total"] / (float(np.mean(walls)) * 1e3),
        "stage_ms_mean": mean, "peak_mem_bytes": peak, "held_bytes": held,
        "bytes_per_image": len(batches[0][0]), "work": work, "corrupt": corrupt,
    }

    # timing entries for the kernel table: one decode's launches of each
    # kernel on this batch's inputs (K8, K9 and K11 do the same work on any
    # store; K10 reads it, so each rep restores its input first and the
    # restore alone is timed and taken off)
    plain = prog_plain()
    tg = [g.clone() for g in grids]
    tok = torch.ones(1, dtype=torch.int32, device=dev)
    by_kind = {k: [(si, sc, t) for si, (sc, t) in enumerate(zip(prep.scans, bufs[0]))
                   if sc.kind == k] for k in PROG_KINDS}

    def runner(kind, fns):
        def go():
            for si, sc, t in by_kind[kind]:
                if kind == "ac_refine":
                    tg[sc.comps[0]].copy_(refine_inputs[si])
                po.apply_scan(fns[kind], sc, t, tg, prep, tok)
        return go

    def restore():
        for si, sc, _ in by_kind["ac_refine"]:
            tg[sc.comps[0]].copy_(refine_inputs[si])

    restore_ms = cuda_ms(restore, 20)
    nblk_all = BATCH * sum(prep.myy * v * prep.mxx * h for h, v in prep.hv)
    tab = 4 * ke.TAB_WORDS
    wk = work
    bytes_ops = {
        "dc_first": (wk["dc_first"]["stream_bytes"] + 12 * wk["dc_first"]["lanes"]
                     + tab * wk["dc_first"]["scans"],
                     (OPS_K2_SYMBOL + OPS_K8_BLOCK) * wk["dc_first"]["lanes"]),
        # hasdata for every lane; starts and ends for a data lane only (an
        # EOB-covered lane reads no bits)
        "ac_first": (wk["ac_first"]["stream_bytes"] + 4 * wk["ac_first"]["lanes"]
                     + 8 * wk["ac_first"]["data_lanes"] + tab * wk["ac_first"]["scans"]
                     + 8 * wk["ac_first"]["changed"],
                     OPS_K2_SYMBOL * (wk["ac_first"]["changed"] + wk["ac_first"]["data_lanes"])),
        "ac_refine": (wk["ac_refine"]["stream_bytes"] + 12 * wk["ac_refine"]["lanes"]
                      + tab * wk["ac_refine"]["scans"] + 4 * wk["ac_refine"]["band_positions"]
                      + 4 * wk["ac_refine"]["changed"],
                      OPS_K10_POSITION * wk["ac_refine"]["band_positions"]),
        "dc_refine": (wk["dc_refine"]["stream_bytes"] + 8 * wk["dc_refine"]["changed"],
                      OPS_K11_BLOCK * wk["dc_refine"]["lanes"]),
    }
    entries = {}
    for kind in PROG_KINDS:
        ms = cuda_ms(runner(kind, po.SCAN_KERNELS), 20)
        plain_ms = cuda_ms(runner(kind, plain), 1)
        if kind == "ac_refine":
            ms, plain_ms = ms - restore_ms, plain_ms - restore_ms
        entries[kind] = {"ms": ms, "plain_ms": plain_ms, "bytes": bytes_ops[kind][0],
                         "ops": bytes_ops[kind][1], "launches": launches[kind],
                         "max_abs_err": errs[kind], "scans": wk[kind]["scans"]}
    entries["ac_refine"]["restore_ms_taken_off"] = restore_ms
    entries["component_planes_int32"] = {
        "ms": cuda_ms(lambda: kp6.component_planes(grids, quants, **kw6), 20),
        "plain_ms": cuda_ms(lambda: kp6.component_planes_plain(grids, quants, **kw6), 1),
        "bytes": 256 * nblk_all + 4 * 64 * 3 * BATCH + px6.numel(),
        "ops": OPS_K4_BLOCK * nblk_all + OPS_K4_PIXEL * BATCH * SIZE * SIZE
        + OPS_K4_CHROMA * 64 * BATCH * prep.mxx * prep.myy,
        "max_abs_err": errs["component_planes_int32"]}
    del tg, refine_inputs
    return summary, entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zpix_tpu_torch import DeviceJpegDecoder, prep_batch, runtime
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb
    from zpix_tpu_torch.runtime import host
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import idct as ki

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # nvcc and g++ side by side
        for f in [ex.submit(runtime.lib), ex.submit(host.lib)]:
            f.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": runtime.build_seconds})

    # ----------------------------------------------------- content, plans
    t0 = time.perf_counter()
    batches = make_batches(range(TIMED_BATCHES + 2))
    batches_rf = make_batches(range(100, 100 + TIMED_BATCHES + 2), dri=None)
    emit({"phase": "content", "seconds": time.perf_counter() - t0,
          "bytes_per_image": float(np.mean([len(d) for d in batches[0]])),
          "bytes_per_image_restart_free": float(np.mean([len(d) for d in batches_rf[0]]))})
    dec = DeviceJpegDecoder(planar=True)
    plan = prep_batch(batches[0])
    bufs = dec.upload(plan)
    stream, seg_pos, seg_nmcu, tables = bufs
    nblk = plan.seg_mcus * plan.bpm
    geom = kb.BackendGeometry.of(plan)
    L1, L2 = seg_pos.shape[0], seg_pos.shape[0] * nblk
    stream_used = sum(len(d) for d in batches[0])  # compressed bytes ~ stream read

    # ---------------------------------------------- kernels vs plain on card
    results = {}
    plan2 = prep_batch(batches[0][:2])
    b2 = dec.upload(plan2)
    ends_k, ok_k = ke.index_pass(*b2, bpm=plan2.bpm, nblk=nblk)
    ends_p, ok_p = ke.index_pass_plain(*b2, bpm=plan2.bpm, nblk=nblk)
    torch.cuda.synchronize()
    results["index_pass"] = max(max_abs_err(ends_k, ends_p), max_abs_err(ok_k, ok_p))
    ok2k, ok2p = ok_k.clone(), ok_k.clone()
    ac_k, dc_k = ke.value_pass(*b2, ends_k, ok2k, bpm=plan2.bpm)
    ac_p, dc_p = ke.value_pass_plain(*b2, ends_k, ok2p, bpm=plan2.bpm)
    torch.cuda.synchronize()
    results["value_pass"] = max(max_abs_err(ac_k, ac_p), max_abs_err(dc_k, dc_p),
                                max_abs_err(ok2k, ok2p))
    if not (bool(ok_k) and bool(ok2k)):
        raise SystemExit("chip_smoke: the 2-image check batch did not verify")

    # K1 and K2 again at the main path's shapes (16 images)
    ends, okf = ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk)
    ends_p, ok_p = ke.index_pass_plain(*bufs, bpm=plan.bpm, nblk=nblk)
    torch.cuda.synchronize()
    results["index_pass"] = max(results["index_pass"], max_abs_err(ends, ends_p),
                                max_abs_err(okf, ok_p))
    ok_vp = okf.clone()
    ac, dc_diff = ke.value_pass(*bufs, ends, okf, bpm=plan.bpm)
    ac_p, dc_p = ke.value_pass_plain(*bufs, ends, ok_vp, bpm=plan.bpm)
    torch.cuda.synchronize()
    results["value_pass"] = max(results["value_pass"], max_abs_err(ac, ac_p),
                                max_abs_err(dc_diff, dc_p), max_abs_err(okf, ok_vp))
    del ends_p, ac_p, dc_p
    dc_k = ke.dc_restore(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus)
    dc_p = ke.dc_restore_plain(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus)
    results["dc_restore"] = max_abs_err(dc_k, dc_p)
    px_k = kb.backend(ac, dc_k, tables, geom, planar=True)
    px_p = kb.backend_plain(ac, dc_k, tables, geom, planar=True)
    results["backend"] = max_abs_err(px_k, px_p)
    px_i = kb.backend(ac, dc_k, tables, geom, planar=False)
    results["backend"] = max(results["backend"],
                             max_abs_err(px_i, px_p.permute(0, 2, 3, 1)))
    gen = torch.Generator(device="cpu").manual_seed(0)
    blocks = torch.randint(-2048, 2048, (L2, 8, 8), generator=gen, dtype=torch.int32).to(dev)
    wide = torch.randint(-2**31, 2**31 - 1, (4096, 8, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)
    results["idct_blocks"] = max(
        max_abs_err(ki.idct_blocks(blocks), ki.idct_plain(blocks)),
        max_abs_err(ki.idct_blocks(wide), ki.idct_plain(wide)),
    )
    # K7 and K6 on the full restart-free batch (native front-end, 4:2:0)
    fe = pb.NativeBatchFrontEnd(batches_rf[0][0], BATCH, pin=True)
    fe.parse(batches_rf[0])
    packed = fe.packed()
    flat = pb.upload(packed, dev)
    dims = packed.dims
    perms = [None if p is None else torch.from_numpy(p).to(dev) for p in packed.perms]
    sections = [(pb.carve(flat, packed.layout, "bm", c, BATCH),
                 pb.carve(flat, packed.layout, "val", c, BATCH)) for c in range(3)]
    grids = [ks.unpack_sparse(bm, v, bv=bv, bh=bh, perm=pm)
             for (bm, v), (bv, bh), pm in zip(sections, dims, perms)]
    results["unpack_sparse"] = max(
        max_abs_err(g, ks.unpack_sparse_plain(bm, v, bv=bv, bh=bh, perm=pm))
        for g, (bm, v), (bv, bh), pm in zip(grids, sections, dims, perms))
    rf_quants = [pb.carve(flat, packed.layout, "q", c, BATCH) for c in range(3)]
    rf_factors = [(1, 1)] + [pb.RATIO_FACTORS[packed.ratio]] * 2
    rf_kw = dict(color="ycbcr", height=SIZE, width=SIZE, factors=rf_factors)
    rf_px = kp.component_planes(grids, rf_quants, **rf_kw)
    results["component_planes"] = max_abs_err(
        rf_px, kp.component_planes_plain(grids, rf_quants, **rf_kw))
    rf_blocks = BATCH * sum(bv * bh for bv, bh in dims)
    small = small_kernel_checks(dev)
    for k, err in small.items():
        key = "component_planes" if k.startswith("planes") else "unpack_sparse"
        results[key] = max(results[key], err)
    # K3's two forms on the host-index batch's whole-image chains
    hplan, hbufs, hac, hdc = host_index_inputs(batches_rf[0])
    hdc_p = ke.dc_restore_plain(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus)
    long_errs = {form: max_abs_err(ke.dc_restore(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus,
                                                 form=form), hdc_p)
                 for form in ("block", "thread")}
    long_errs.update({f"dri8_{form}": max_abs_err(
        ke.dc_restore(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus, form=form), dc_p)
        for form in ("block", "thread")})
    results["dc_restore"] = max(results["dc_restore"], *long_errs.values())
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "max_abs_err": results,
          "k1_k2_batches": [2, BATCH], "k3_k4_k5_shapes": {"lanes": L2, "blocks": L2},
          "k6_k7_small_cases": small, "k3_forms": long_errs,
          "k6_k7_full_batch": {"images": BATCH, "size": SIZE, "ratio": packed.ratio,
                               "value_caps": fe.val_caps, "nnz_max": fe.nnz.max(0).tolist()},
          "k3_host_index_chains": {"chains": BATCH * len(hplan.hv),
                                   "longest": hplan.seg_mcus * max(h * v for h, v in hplan.hv)}})
    if any(results.values()) or not bool(okf):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain version")

    # ---------------------------------------------------------- main path
    dec.decode(batches[1])  # warm: pinned-memory pool, caches
    torch.cuda.synchronize()
    runtime.reset_launches()
    pixels, ok = dec.decode(batches[0])
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    # K5's own path: the standalone IDCT entry on this batch's dequantised
    # blocks (decode runs the same butterflies inside K4, not K5)
    qs = tables[ke.TAB_QUANT : ke.TAB_QUANT + 256].view(4, 64)[
        torch.as_tensor(plan.comp_of_slot, device=dev).repeat(L2 // plan.bpm)]
    deq = ac.to(torch.int32)
    deq[:, 0] = dc_k
    deq = (deq * qs).view(L2, 8, 8)
    runtime.reset_launches()
    idct_out = ki.idct_blocks(deq)
    torch.cuda.synchronize()
    idct_launches = runtime.LAUNCHES["idct_blocks"]
    emit({"phase": "main_path", "launches": launches, "ok": bool(ok),
          "shape": list(pixels.shape), "idct_blocks_entry_launches": idct_launches})
    if not bool(ok) or idct_launches == 0 or min(
            launches[k] for k in ("index_pass", "value_pass", "dc_restore", "backend")) == 0:
        raise SystemExit("chip_smoke: main path did not verify or skipped a kernel")
    if tuple(pixels.shape) != (BATCH, 3, SIZE, SIZE):
        raise SystemExit("chip_smoke: wrong output shape")
    # images 0 and 1 against the plain path on the card
    e2, o2 = ke.index_pass_plain(*b2, bpm=plan2.bpm, nblk=nblk)
    a2, d2 = ke.value_pass_plain(*b2, e2, o2, bpm=plan2.bpm)
    d2 = ke.dc_restore_plain(d2, hv=plan2.hv, seg_mcus=plan2.seg_mcus)
    ref2 = kb.backend_plain(a2, d2, b2[3], kb.BackendGeometry.of(plan2), planar=True)
    blk_ref = ki.idct_plain(deq[: 4 * nblk])
    torch.cuda.synchronize()
    main_err = max_abs_err(pixels[:2], ref2)
    pil = np.asarray(__import__("PIL.Image").Image.open(BytesIO(batches[0][0])).convert("RGB"))
    pil_diff = float(np.abs(pixels[0].permute(1, 2, 0).cpu().numpy().astype(np.int32)
                            - pil.astype(np.int32)).mean())
    emit({"phase": "main_path_check", "max_abs_err_vs_plain": main_err,
          "plain_ok": bool(o2), "idct_blocks_err": max_abs_err(idct_out[: 4 * nblk], blk_ref),
          "mean_abs_diff_vs_pillow": pil_diff})
    if main_err or not bool(o2) or max_abs_err(idct_out[: 4 * nblk], blk_ref) or pil_diff > 8:
        raise SystemExit("chip_smoke: main path output is wrong")

    # timed: distinct batches, host prep + upload + kernels, end to end
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # tensors of the checks above
    walls, oks = [], []
    for datas in batches[2:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        px, okb = dec.decode(datas)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        oks.append(bool(okb))
    peak = torch.cuda.max_memory_allocated()
    # per-stage breakdown over the same batches
    stages = {k: [] for k in ("prep", "h2d", "index_pass", "value_pass",
                              "dc_restore", "backend", "device_total")}
    for datas in batches[2:]:
        t0 = time.perf_counter()
        p = prep_batch(datas)
        stages["prep"].append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        ev[0].record()
        bb = dec.upload(p)
        ev[1].record()
        e, o = ke.index_pass(*bb, bpm=p.bpm, nblk=nblk)
        ev[2].record()
        a, d = ke.value_pass(*bb, e, o, bpm=p.bpm)
        ev[3].record()
        d = ke.dc_restore(d, hv=p.hv, seg_mcus=p.seg_mcus)
        ev[4].record()
        kb.backend(a, d, bb[3], kb.BackendGeometry.of(p), planar=True)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(("h2d", "index_pass", "value_pass", "dc_restore", "backend")):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
        stages["device_total"].append(ev[1].elapsed_time(ev[5]))
    mpix = BATCH * SIZE * SIZE / 1e6
    emit({"phase": "timed", "batches": len(walls), "all_ok": all(oks),
          "e2e_ms_per_batch": [w * 1e3 for w in walls],
          "e2e_mpix_per_s": mpix / float(np.mean(walls)),
          "device_mpix_per_s": mpix / (float(np.mean(stages["device_total"])) / 1e3),
          # device time over host wall time per batch (two passes over the
          # same batches): the share of a batch the card is busy
          "device_busy_share": float(np.mean(stages["device_total"])) / (float(np.mean(walls)) * 1e3),
          "stage_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
          "peak_mem_bytes": peak, "peak_mem_above_held_bytes": peak - held})
    if not all(oks):
        raise SystemExit("chip_smoke: a timed batch did not verify")

    # ------------------------------------------------------ corrupt streams
    bad = [inject_invalid_codes(batches[0][0])] + batches[0][1:2]
    _, ok_bad = dec.decode(bad)
    flipped = [flip_bytes(batches[0][0])]
    try:
        px_f, ok_f = dec.decode(flipped)
        flip = "ok_false" if not bool(ok_f) else (
            "ok_true_pixels_differ" if not torch.equal(px_f[0], pixels[0]) else "ok_true_same")
    except ZpixError as exc:  # the host prep refused the stream
        flip = f"prep_raised:{type(exc).__name__}"
    emit({"phase": "corrupt", "invalid_codes_ok": bool(ok_bad), "flipped": flip})
    if bool(ok_bad) or flip == "ok_true_same":
        raise SystemExit("chip_smoke: a corrupt stream was not flagged")

    # ------------------------------------------------ restart-free routes
    rf = restart_free(batches_rf, dev, mpix)
    emit({"phase": "restart_free", **rf})
    ln, lh = rf["launches"]["native"], rf["launches"]["host_index"]
    if (min(ln["unpack_sparse"], ln["component_planes"]) == 0 or lh["index_pass"]
            or min(lh["value_pass"], lh["dc_restore"], lh["backend"]) == 0):
        raise SystemExit("chip_smoke: a restart-free route skipped a kernel")
    c = rf["check"]
    if (c["native_vs_plain"] or c["host_index_vs_plain"] or not c["plain_ok"]
            or not c["routes_equal"] or not c["host_index_ok"] or not rf["all_ok"]
            or not all(rf["routes_equal_per_batch"])):
        raise SystemExit("chip_smoke: a restart-free route's output is wrong")
    if rf["corrupt"].get("ok", True):
        raise SystemExit("chip_smoke: a corrupt restart-free stream was not flagged")

    # ------------------------------------------------------ progressive
    pg, prog_entries = progressive(dev)
    emit({"phase": "progressive", **pg})
    lp, pc = pg["launches"], pg["check"]
    if min(lp[k] for k in PROG_KINDS + ("dc_restore", "component_planes")) == 0:
        raise SystemExit("chip_smoke: the progressive route skipped a kernel")
    mx = pc["mixed_batch"]
    if (any(mx[k] for k in PROG_KINDS + ("component_planes_int32",))
            or mx["images_differ_store"] < len(MIXED_STREAMS)
            or mx["images_differ_pixels"] < len(MIXED_STREAMS) + len(MIXED_QUANTS)):
        raise SystemExit("chip_smoke: a progressive kernel disagrees on a mixed batch")
    if (any(pc["max_abs_err"].values()) or not pc["kernels_ok"] or not pc["main_ok"]
            or pc["main_vs_plain"] or not pc["plain_ok"] or pc["mean_abs_diff_vs_pillow"] > 8
            or pc["shape"] != [BATCH, SIZE, SIZE, 3] or not pg["all_ok"]):
        raise SystemExit("chip_smoke: the progressive route's output is wrong")
    if pg["corrupt"]["walk_refused_ok"] or pg["corrupt"]["changed_after_walk_ok"]:
        raise SystemExit("chip_smoke: a corrupt progressive stream was not flagged")

    # ------------------------------------------------------- kernel table
    ends, okf = ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk)
    ac, dc_diff = ke.value_pass(*bufs, ends, okf, bpm=plan.bpm)
    seg_syms, blk_syms, n_syms = segment_symbols(ac, dc_diff, seg_nmcu, nblk, plan.bpm)
    out_bytes = pixels.numel()
    n_mcus = L2 // plan.bpm
    chain_ms = {k: n * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3
                for k, n in (("index_pass", seg_syms), ("value_pass", blk_syms))}
    timing = {
        "index_pass": (lambda: ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk),
                       lambda: ke.index_pass_plain(*bufs, bpm=plan.bpm, nblk=nblk),
                       stream_used + 8 * L1 + 4 * ke.TAB_WORDS + 4 * L2,
                       OPS_K1_SYMBOL * n_syms),
        "value_pass": (lambda: ke.value_pass(*bufs, ends, okf.clone(), bpm=plan.bpm),
                       lambda: ke.value_pass_plain(*bufs, ends, okf.clone(), bpm=plan.bpm),
                       stream_used + 8 * L1 + 4 * ke.TAB_WORDS + 4 * L2 + 128 * L2 + 4 * L2,
                       OPS_K2_SYMBOL * n_syms),
        "dc_restore": (lambda: ke.dc_restore(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus),
                       lambda: ke.dc_restore_plain(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus),
                       8 * L2, L2),
        "backend": (lambda: kb.backend(ac, dc_k, tables, geom, planar=True),
                    lambda: kb.backend_plain(ac, dc_k, tables, geom, planar=True),
                    128 * L2 + 4 * L2 + 4 * ke.TAB_WORDS + out_bytes,
                    OPS_K4_BLOCK * L2 + OPS_K4_PIXEL * BATCH * SIZE * SIZE
                    + OPS_K4_CHROMA * 64 * n_mcus),
        "idct_blocks": (lambda: ki.idct_blocks(blocks), lambda: ki.idct_plain(blocks),
                        2 * blocks.numel() * 4, OPS_IDCT_BLOCK * blocks.shape[0]),
        # one decode's launches of K7 (every component) and of K6
        "unpack_sparse": (
            lambda: [ks.unpack_sparse(bm, v, bv=bv, bh=bh, perm=pm)
                     for (bm, v), (bv, bh), pm in zip(sections, dims, perms)],
            lambda: [ks.unpack_sparse_plain(bm, v, bv=bv, bh=bh, perm=pm)
                     for (bm, v), (bv, bh), pm in zip(sections, dims, perms)],
            (8 + 128) * rf_blocks + 2 * int(fe.nnz.sum()) + 4 * dims[0][0] * dims[0][1],
            OPS_K7_BLOCK * rf_blocks),
        "component_planes": (
            lambda: kp.component_planes(grids, rf_quants, **rf_kw),
            lambda: kp.component_planes_plain(grids, rf_quants, **rf_kw),
            128 * rf_blocks + 4 * 64 * 3 * BATCH + rf_px.numel(),
            OPS_K4_BLOCK * rf_blocks + OPS_K4_PIXEL * BATCH * SIZE * SIZE
            + OPS_K4_CHROMA * 64 * BATCH * packed.mxx * packed.myy),
    }
    # K3's two forms on both paths' chains, and its bound on the long ones
    k3 = {form: {"dri8_ms": cuda_ms(lambda f=form: ke.dc_restore(
                     dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus, form=f), 20),
                 "host_index_ms": cuda_ms(lambda f=form: ke.dc_restore(
                     hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus, form=f), 20)}
          for form in ("thread", "block")}
    k3["host_index_plain_ms"] = cuda_ms(
        lambda: ke.dc_restore_plain(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus), 1)
    k3["host_index_bound_ms"] = max(8 * hdc.numel() / HBM_BYTES_PER_S,
                                    hdc.numel() / INT32_OPS_PER_S) * 1e3
    k3["host_index_launches"] = lh["dc_restore"]
    k3["host_index_form"] = "block" if hplan.seg_mcus * 4 >= ke.LONG_CHAIN else "thread"
    # K2 and K4 again on the host-index route's inputs (interleaved out)
    hok = torch.ones(1, dtype=torch.int32, device=dev)
    host_index_ms = {
        "value_pass": cuda_ms(lambda: ke.value_pass(*hbufs[:4], hbufs[4], hok.clone(),
                                                    bpm=hplan.bpm), 20),
        "backend": cuda_ms(lambda: kb.backend(hac, hdc_p, hbufs[3],
                                              kb.BackendGeometry.of(hplan), planar=False), 20),
    }
    by_path = {k: {"dri8": launches[k], "native": ln[k], "host_index": lh[k],
                   "progressive": lp[k]} for k in timing}
    kernels = []
    for kname, (fk, fp, nbytes, nops) in timing.items():
        ms = cuda_ms(fk, 20)
        plain_ms = cuda_ms(fp, 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        row = {
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1],
            "launches": ln[kname] if kname in ("unpack_sparse", "component_planes")
            else launches[kname], "launches_by_path": by_path[kname],
            "max_abs_err": results[kname], "matches_plain": results[kname] == 0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_int32_ops": nops, "library_ms": None,
        }
        if kname in chain_ms:
            row["chain_bound_ms"] = chain_ms[kname]
        if kname == "idct_blocks":  # not on decode's path: its own entry's run
            row["standalone_launches"] = idct_launches
        if kname == "dc_restore":
            row["forms"] = k3
        if kname in host_index_ms:
            row["host_index_ms"] = host_index_ms[kname]
        if kname == "component_planes":  # its int32 arm, on the progressive store
            e = prog_entries["component_planes_int32"]
            row["max_abs_err"] = max(row["max_abs_err"], e["max_abs_err"])
            row["matches_plain"] = row["max_abs_err"] == 0
            row["progressive_int32"] = {
                "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_bytes": e["bytes"],
                "bound_ms": max(e["bytes"] / HBM_BYTES_PER_S, e["ops"] / INT32_OPS_PER_S) * 1e3}
        kernels.append(row)
    for kname in PROG_KINDS:
        e = prog_entries[kname]
        bytes_ms = e["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = e["ops"] / INT32_OPS_PER_S * 1e3
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": e["launches"],
            "launches_by_path": {"dri8": 0, "native": 0, "host_index": 0,
                                 "progressive": e["launches"]},
            "max_abs_err": e["max_abs_err"], "matches_plain": e["max_abs_err"] == 0,
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": e["bytes"], "bound_int32_ops": e["ops"], "library_ms": None,
            "scans_per_decode": e["scans"],
            **({"restore_ms_taken_off": e["restore_ms_taken_off"]}
               if "restore_ms_taken_off" in e else {}),
        })
    emit({"phase": "serial_chain", "max_symbols_per_segment": seg_syms,
          "max_symbols_per_block": blk_syms, "symbols": n_syms,
          "index_pass_ns_per_symbol": kernels[0]["ms"] * 1e6 / seg_syms,
          "value_pass_ns_per_symbol": kernels[1]["ms"] * 1e6 / blk_syms,
          "chain_bound_ms": chain_ms, "segment_lanes": L1, "block_lanes": L2})
    emit({"phase": "seconds", "total": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
