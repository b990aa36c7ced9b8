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
prints one JSON object per line.  Then the raster slice: batches of 16
distinct 1024x1024 QOI streams (the JAX bench's "noise" and "screen"
content, made by the port's host encoder) through ``HostIndexQoiDecoder``
(host lane fill, K12; host records, K13), the decoded batches back
through ``encode_device_batch`` (K14, streams byte-identical to the host
encoder), and 16 distinct 1024x1024 BMPs a batch from the port's numpy
writer through ``BatchBmpDecoder`` (K18, every bit depth, header and
orientation).  The last line is
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
    "qoi_lane_expand": ("zpix_tpu_torch/csrc/qoi_expand.cu",
                        "zpix_tpu/parallel/qoi_batch.py:1174"),
    "qoi_sorted_expand": ("zpix_tpu_torch/csrc/qoi_expand.cu",
                          "zpix_tpu/parallel/qoi_batch.py:818"),
    "qoi_encode": ("zpix_tpu_torch/csrc/qoi_encode.cu", "zpix_tpu/parallel/qoi_batch.py:1423"),
    "bmp_unpack": ("zpix_tpu_torch/csrc/bmp_unpack.cu", "zpix_tpu/parallel/bmp_batch.py:21"),
}
PROG_KINDS = ("dc_first", "ac_first", "ac_refine", "dc_refine")
RASTER_KINDS = ("qoi_lane_expand", "qoi_sorted_expand", "qoi_encode", "bmp_unpack")
# QOI content profiles -> lane_p, the JAX bench's choice for each
# (bench.py main_qoi); p4 caps 256 at 255, then shrinks it to 128 on 1024^2
QOI_PROFILES = {"noise": 16, "screen": 256}
# The least operations of each function, a pixel (or a record):
# - K12's masked sum, as a per-lane difference array (exact on any entry
#   set): an add at the clamped start and a subtract at the clamped end
#   per entry slot, a prefix add per pixel (the kernel itself does two
#   compares and an add per (pixel, entry slot));
# - K13: an add per record (the prefix sum), a compare per search step;
# - K14: hash (4 multiplies, 3 adds, a mask), run test, 5 differences, 16
#   range compares, bucket compare, size and scan adds;
# - K18: index extract (shift, mask) or swizzle, 3 x 4 for the premultiply.
OPS_K12_SLOT, OPS_K12_PIXEL = 2, 1
OPS_K13_RECORD, OPS_K13_STEP, OPS_K14_PIXEL = 1, 1, 32
OPS_K18_PIXEL = {1: 2, 2: 2, 4: 2, 8: 1, 24: 1, 32: 12}


def with_bound(entry: dict) -> dict:
    """A side measurement's entry with its bound: the larger of its bytes
    over the memory rate and its operations over the int32 rate."""
    bytes_ms = entry["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = entry["ops"] / INT32_OPS_PER_S * 1e3
    return {**entry, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


# ------------------------------------------------- QOI and BMP slice (K12-K14, K18)


def make_bench_qoi(size: int, seed: int, content: str) -> bytes:
    """A copy of the JAX bench's QOI content (bench.py:855-888) through the
    port's host encoder: "noise" (per-pixel noise over a sinusoid field,
    nearly one op a pixel) or "screen" (flat panels, a gradient band and 2%
    speckle; run-heavy).  "alpha" is this script's own: the noise image
    with an alpha that varies, content the p4 lane form refuses."""
    from zpix_tpu_torch.codecs.qoi.encode import Desc, encode

    rng = np.random.RandomState(seed)
    if content == "screen":
        rgba = np.zeros((size, size, 4), np.uint8)
        rgba[..., 3] = 255
        for _ in range(24):  # flat UI panels
            y, x = rng.randint(0, size, 2)
            h, w = rng.randint(size // 16, size // 3, 2)
            rgba[y : y + h, x : x + w, :3] = rng.randint(30, 226, 3)
        gy = rng.randint(0, size - size // 8)  # one gradient band
        grad = np.linspace(40, 215, size).astype(np.uint8)
        rgba[gy : gy + size // 8, :, :3] = grad[None, :, None]
        m = rng.rand(size, size) < 0.02  # sparse speckle
        rgba[..., :3][m] = rng.randint(0, 256, (int(m.sum()), 3))
        return encode(rgba, Desc(size, size, 4, 0))
    x = np.linspace(0, 20, size)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]) + seed)).astype(np.uint8)
    noise = rng.randint(0, 8, (size, size)).astype(np.uint8)
    alpha = 255 - 16 * noise if content == "alpha" else np.full_like(base, 255)
    rgba = np.stack([base ^ noise, base.T, base // 2 + 64, alpha], -1)
    return encode(rgba, Desc(size, size, 4, 0))


def make_qoi_batches(content: str, indices):
    """Batch s holds the BATCH images of seeds s * BATCH + j."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return [list(ex.map(lambda j, s=s: make_bench_qoi(SIZE, s * BATCH + j, content),
                            range(BATCH))) for s in indices]


def dev_t(a, dev):
    """numpy -> a tensor on ``dev``; uint32 as the int32 of the same bits."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)


def qoi_host_pixels(datas):
    """The port's host decoder on each stream -> [n, H, W, 4] uint8."""
    from zpix_tpu_torch.codecs.qoi.decode import decode

    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return np.stack(list(ex.map(decode, datas)))


def qoi_plan_layout(plan) -> dict:
    """A plan's layout and the bytes it uploads a pixel."""
    if hasattr(plan, "cnts"):
        nbytes = plan.cols.nbytes + plan.cnts.nbytes + plan.fill.nbytes
        out = {"fmt": "records", "rcap": plan.rcap}
    else:
        nbytes = plan.p4.nbytes if plan.fmt == "p4" else (
            plan.cols.nbytes + plan.s.nbytes + plan.e.nbytes)
        out = {"fmt": plan.fmt, "P": plan.P, "R": plan.R}
    return {**out, "staged_bytes": nbytes,
            "staged_bytes_per_px": nbytes / (plan.batch * plan.width * plan.height)}


def qoi_stages(dec, datas):
    """One batch through HostIndexQoiDecoder's stages -> (pixels, plan,
    {stage: ms}): the host pass (host clock; a lane pass at the hinted
    layout writes into the pinned buffer), then CUDA events around the
    upload (any packing into the pinned buffer included) and the
    expansion kernel."""
    t0 = time.perf_counter()
    plan = dec.prep(datas)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    bufs = dec.upload(plan)
    ev[1].record()
    px = dec.run(plan, bufs)
    ev[2].record()
    torch.cuda.synchronize()
    return px, plan, {"host_pass": host_ms, "h2d": ev[0].elapsed_time(ev[1]),
                      "expand": ev[1].elapsed_time(ev[2]),
                      "device_total": ev[0].elapsed_time(ev[2])}


def timed_decodes(decode, batches, stages=None, check=None):
    """Each batch decoded end to end (host clock, bytes in to a synchronised
    tensor) and, if ``stages``, again by stage -> (walls s, peak bytes
    above what was held, stage means or None, check results).  ``check``
    (datas, pixels) -> bool runs after each timed decode, outside the
    clock."""
    walls, peak, checks = [], 0, []
    for datas in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        px = decode(datas)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        if check is not None:
            checks.append(check(datas, px))
        del px
    mean = None
    if stages is not None:
        rows = [stages(datas)[-1] for datas in batches]
        mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    return walls, peak, mean, checks


def route_summary(walls, peak, mean, launches) -> dict:
    mpix = BATCH * SIZE * SIZE / 1e6
    return {"e2e_ms_per_batch": [w * 1e3 for w in walls],
            "e2e_mpix_per_s": mpix / float(np.mean(walls)),
            "device_mpix_per_s": mpix / (mean["device_total"] / 1e3),
            "device_busy_share": mean["device_total"] / (float(np.mean(walls)) * 1e3),
            "stage_ms_mean": mean, "peak_mem_bytes": peak,
            "launches_per_call": {k: v for k, v in launches.items() if v}}


def qoi_phase(dev):
    """The QOI decode routes: K12 and K13 against their plain versions on
    full batches (both profiles, alpha content, hand-built entries and
    records), HostIndexQoiDecoder (auto) on each profile and impl="sorted"
    on noise, launches of one decode, 10 timed batches end to end and by
    stage, pixels against the host decoder, damaged streams.  -> (summary,
    {kernel: timing entry}, {profile: (lane decoder, batches, decoded
    batch 0)})"""
    from zpix_tpu_torch import HostIndexQoiDecoder, runtime
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel import qoi_batch as tq

    t0 = time.perf_counter()
    batches = {c: make_qoi_batches(c, range(TIMED_BATCHES + 2)) for c in QOI_PROFILES}
    alpha = make_qoi_batches("alpha", [50])[0]
    content_s = time.perf_counter() - t0
    shape, npx = (BATCH, SIZE, SIZE), SIZE * SIZE

    # K12 and K13 against their plain versions on the card, full batches
    errs, layouts, lane_in = {}, {}, {}
    for c, lane_p in QOI_PROFILES.items():
        plan = tq.prep_qoi_lanes4(batches[c][0], lane_p)
        t = dev_t(plan.p4, dev)
        errs[f"lane_p4_{c}"] = max_abs_err(kq.lane_expand_p4(t, P=plan.P, shape=shape),
                                           kq.lane_expand_p4_plain(t, P=plan.P, shape=shape))
        layouts[c] = qoi_plan_layout(plan)
        lane_in[c] = (t, plan.P, plan.R)
    wplan = tq.prep_qoi_lanes(alpha, QOI_PROFILES["noise"])
    wide = [dev_t(a, dev) for a in (wplan.cols, wplan.s, wplan.e)]
    errs["lane_wide_alpha"] = max_abs_err(
        kq.lane_expand_wide(*wide, P=wplan.P, shape=shape),
        kq.lane_expand_wide_plain(*wide, P=wplan.P, shape=shape))
    layouts["alpha"] = qoi_plan_layout(wplan)
    gen = np.random.default_rng(2)
    _, P, R = lane_in["noise"]
    lanes = BATCH * npx // P
    hs = gen.integers(-3, P + 3, (lanes, R)).astype(np.int16)
    hand = [dev_t(gen.integers(0, 2**32, (lanes, R), dtype=np.uint64).astype(np.uint32), dev),
            dev_t(hs, dev), dev_t((hs + gen.integers(-2, P // 2 + 2, (lanes, R))).astype(
                np.int16), dev)]
    errs["lane_wide_hand_built"] = max_abs_err(kq.lane_expand_wide(*hand, P=P, shape=shape),
                                               kq.lane_expand_wide_plain(*hand, P=P, shape=shape))
    hp4 = dev_t(gen.integers(0, 256, (lanes, R * 4), dtype=np.uint8), dev)
    errs["lane_p4_hand_built"] = max_abs_err(kq.lane_expand_p4(hp4, P=P, shape=shape),
                                             kq.lane_expand_p4_plain(hp4, P=P, shape=shape))
    del hand, hp4
    rplan = tq.prep_qoi_records(batches["noise"][0])
    rec = [dev_t(a, dev) for a in (rplan.cols, rplan.cnts, rplan.fill)]
    errs["sorted_noise"] = max_abs_err(kq.sorted_expand(*rec, shape=shape),
                                       kq.sorted_expand_plain(*rec, shape=shape))
    layouts["records"] = qoi_plan_layout(rplan)
    hcnt = gen.integers(0, 63, (BATCH, 65536)).astype(np.uint8)
    hcnt[gen.random(hcnt.shape) < 0.33] = 0  # zero counts inside the records
    hcnt[::2, 40000:] = 0  # even images fall short of the pixel count: fill
    hrec = [dev_t(gen.integers(0, 2**32, hcnt.shape, dtype=np.uint64).astype(np.uint32), dev),
            dev_t(hcnt, dev),
            dev_t(gen.integers(0, 2**32, BATCH, dtype=np.uint64).astype(np.uint32), dev)]
    errs["sorted_hand_built"] = max_abs_err(kq.sorted_expand(*hrec, shape=shape),
                                            kq.sorted_expand_plain(*hrec, shape=shape))
    del hrec
    torch.cuda.synchronize()

    def check_host(n):
        return lambda datas, px: bool(np.array_equal(px[:n].cpu().numpy(),
                                                     qoi_host_pixels(datas[:n])))

    # the main path on each profile: one decode, launches counted, every
    # image against the host decoder; then 10 timed batches
    routes, launches, lane_decs = {}, {}, {}
    for c, lane_p in QOI_PROFILES.items():
        dec = HostIndexQoiDecoder(lane_p=lane_p)
        dec.decode(batches[c][1])  # warm: pinned buffer, thread pool
        torch.cuda.synchronize()
        runtime.reset_launches()
        px = dec.decode(batches[c][0])
        torch.cuda.synchronize()
        launches[c] = dict(runtime.LAUNCHES)
        main_equal = bool(np.array_equal(px.cpu().numpy(), qoi_host_pixels(batches[c][0])))
        lane_decs[c] = (dec, batches[c], px)
        walls, peak, mean, oks = timed_decodes(dec.decode, batches[c][2:],
                                               lambda d, dec=dec: qoi_stages(dec, d),
                                               check_host(2))
        # with the R hint set, the lane pass fills the pinned staging buffer
        plan = dec.prep(batches[c][2])
        in_staging = bool(np.shares_memory(plan.p4, dec._upload._staging.numpy()))
        routes[c] = {"main_equal_host": main_equal, "timed_images_0_1_equal_host": oks,
                     "layout": layouts[c], "plan_filled_in_staging": in_staging,
                     **route_summary(walls, peak, mean, launches[c])}
    # auto on alpha content: the wide form
    adec = HostIndexQoiDecoder(lane_p=QOI_PROFILES["noise"])
    aplan = adec.prep(alpha)
    runtime.reset_launches()
    pxa = adec.run(aplan, adec.upload(aplan))
    torch.cuda.synchronize()
    routes["alpha_auto"] = {"fmt": aplan.fmt, "launches": runtime.LAUNCHES["qoi_lane_expand"],
                            "equal_host": bool(np.array_equal(pxa.cpu().numpy(),
                                                              qoi_host_pixels(alpha)))}
    del pxa
    # impl="sorted" on the noise batches; pixels against the lane route's
    sdec = HostIndexQoiDecoder(impl="sorted")
    sdec.decode(batches["noise"][1])
    torch.cuda.synchronize()
    runtime.reset_launches()
    pxs = sdec.decode(batches["noise"][0])
    torch.cuda.synchronize()
    launches["sorted"] = dict(runtime.LAUNCHES)
    sorted_main_equal = bool(torch.equal(pxs, lane_decs["noise"][2]))
    del pxs
    lane_noise = lane_decs["noise"][0]
    walls, peak, mean, eq = timed_decodes(
        sdec.decode, batches["noise"][2:], lambda d: qoi_stages(sdec, d),
        lambda datas, px: bool(torch.equal(px, lane_noise.decode(datas))))
    routes["sorted_noise"] = {"main_equal_lane": sorted_main_equal,
                              "timed_equal_lane": eq, "layout": layouts["records"],
                              **route_summary(walls, peak, mean, launches["sorted"])}

    # damaged streams: ops cut short decode to the host decoder's fill; a
    # stream too short for its header raises as zpix_tpu does
    data = batches["noise"][0][0]
    cut = data[: len(data) // 2] + b"\x00" * 8
    want = qoi_host_pixels([cut])[0]
    damaged = {}
    for name, d in (("lane", lane_noise), ("sorted", sdec)):
        out = d.decode([cut] + batches["noise"][0][1:])
        damaged[f"cut_{name}_equal_host"] = bool(np.array_equal(out[0].cpu().numpy(), want))
    tail = want.reshape(-1, 4)[-SIZE:]  # the last row: the stream-exhausted fill
    damaged["cut_tail_is_fill"] = bool((tail == tail[-1]).all())
    try:
        HostIndexQoiDecoder().decode([b"qoif" + b"\x00" * 10])
        damaged["short_header"] = "no error"
    except ZpixError as exc:
        damaged["short_header"] = f"{type(exc).__name__}: {exc}"

    # timing entries: one decode's launch of K12 (noise, p4; screen and the
    # wide form beside it) and of K13 (noise records); the library yardstick
    # is the run-length expansion alone, torch.repeat_interleave of the
    # batch's packed colours by their counts
    t, P, R = lane_in["noise"]
    ts, Ps, Rs = lane_in["screen"]
    rcols, rcnt = rec[0].view(-1), rec[1].view(-1).long()
    total = int(rcnt.sum())
    lib_ms = cuda_ms(lambda: torch.repeat_interleave(rcols, rcnt, output_size=total), 20)
    out_bytes = BATCH * npx * 4
    steps = int(np.ceil(np.log2(rplan.rcap + 1)))

    def k12_ops(P, R):  # entry slots of the batch's lanes, and its pixels
        return OPS_K12_SLOT * R * (BATCH * npx // P) + OPS_K12_PIXEL * BATCH * npx

    entries = {
        "qoi_lane_expand": {
            "ms": cuda_ms(lambda: kq.lane_expand_p4(t, P=P, shape=shape), 20),
            "plain_ms": cuda_ms(lambda: kq.lane_expand_p4_plain(t, P=P, shape=shape), 1),
            "bytes": t.numel() + out_bytes, "ops": k12_ops(P, R),
            "launches": launches["noise"]["qoi_lane_expand"], "library_ms": lib_ms,
            "max_abs_err": max(v for k, v in errs.items() if k.startswith("lane")),
            "layout": {"P": P, "R": R, "fmt": "p4", "content": "noise"},
            "screen_p4": with_bound({
                "ms": cuda_ms(lambda: kq.lane_expand_p4(ts, P=Ps, shape=shape), 20),
                "P": Ps, "R": Rs, "bytes": ts.numel() + out_bytes, "ops": k12_ops(Ps, Rs)}),
            "alpha_wide": with_bound({
                "ms": cuda_ms(lambda: kq.lane_expand_wide(*wide, P=wplan.P, shape=shape), 20),
                "P": wplan.P, "R": wplan.R,
                "bytes": sum(x.numel() * x.element_size() for x in wide) + out_bytes,
                "ops": k12_ops(wplan.P, wplan.R)})},
        "qoi_sorted_expand": {
            "ms": cuda_ms(lambda: kq.sorted_expand(*rec, shape=shape), 20),
            "plain_ms": cuda_ms(lambda: kq.sorted_expand_plain(*rec, shape=shape), 1),
            "bytes": sum(x.numel() * x.element_size() for x in rec) + out_bytes,
            "ops": OPS_K13_RECORD * BATCH * rplan.rcap + OPS_K13_STEP * steps * BATCH * npx,
            "launches": launches["sorted"]["qoi_sorted_expand"], "library_ms": lib_ms,
            "max_abs_err": max(errs["sorted_noise"], errs["sorted_hand_built"]),
            "layout": {"rcap": rplan.rcap, "records": total}},
    }
    summary = {"content_seconds": content_s, "max_abs_err": errs, "layouts": layouts,
               "routes": routes, "damaged": damaged,
               "bytes_per_image": {c: float(np.mean([len(d) for d in batches[c][0]]))
                                   for c in QOI_PROFILES}}
    return summary, entries, launches, lane_decs


def qoi_encode_phase(dev, lane_decs):
    """encode_device_batch on the decoded batch 0 of each profile (a tensor
    on the card) and encode_device on one 3-channel image: every stream
    byte-identical to the host encoder, equal to the source stream and
    decoding back to its input; K14 against its plain version on both full
    batches; 10 timed noise batches (pack, K14, download).  -> (summary,
    timing entry, launches of one encode_device_batch)"""
    from zpix_tpu_torch import encode_device, encode_device_batch, runtime
    from zpix_tpu_torch.codecs.qoi.decode import decode
    from zpix_tpu_torch.codecs.qoi.encode import Desc, encode
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px, _streams

    descs = [Desc(SIZE, SIZE, 4, 0)] * BATCH
    check, launches, packed, errs = {}, None, {}, {}
    for c, (_dec, batches, px) in lane_decs.items():
        runtime.reset_launches()
        streams = encode_device_batch(px, descs)
        torch.cuda.synchronize()
        if launches is None:
            launches = dict(runtime.LAUNCHES)
        host = px.cpu().numpy()
        check[f"{c}_equal_host_encoder"] = all(s == encode(h, d)
                                               for s, h, d in zip(streams, host, descs))
        check[f"{c}_equal_source"] = streams == batches[0]
        check[f"{c}_roundtrip"] = all(np.array_equal(decode(s), h)
                                      for s, h in zip(streams, host))
        packed[c] = torch.stack([_pack_px(px[i], descs[i], dev) for i in range(BATCH)])
        out_k, tot_k = kq.encode(packed[c])
        out_p, tot_p = kq.encode_plain(packed[c])
        errs[c] = max(max_abs_err(out_k, out_p), max_abs_err(tot_k, tot_p))
        check[f"{c}_stream_bytes"] = int(tot_k.sum())
        del out_k, out_p, host
    rgb = lane_decs["noise"][2][0, ..., :3]
    d3 = Desc(SIZE, SIZE, 3, 0)
    check["rgb_equal_host_encoder"] = encode_device(rgb, d3) == encode(rgb.cpu().numpy(), d3)

    # timed: decoded noise batches (decoded outside the clock) encoded end to end
    dec, batches, _ = lane_decs["noise"]
    walls, stages = [], []
    mpix = BATCH * SIZE * SIZE / 1e6
    for datas in batches[2:]:
        px = dec.decode(datas)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = encode_device_batch(px, descs)
        walls.append(time.perf_counter() - t0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev[0].record()
        pk = torch.stack([_pack_px(px[i], descs[i], dev) for i in range(BATCH)])
        ev[1].record()
        out, tot = kq.encode(pk)
        ev[2].record()
        again = _streams(out, tot, descs)
        t2 = time.perf_counter()
        stages.append({"pack": ev[0].elapsed_time(ev[1]), "encode": ev[1].elapsed_time(ev[2]),
                       "download_and_streams": (t2 - t1) * 1e3 - ev[0].elapsed_time(ev[2])})
        check.setdefault("timed_equal_source", []).append(streams == datas == again)
        del px, pk, out
    mean = {k: float(np.mean([s[k] for s in stages])) for k in stages[0]}
    pk = packed["noise"]
    entry = {"ms": cuda_ms(lambda: kq.encode(pk), 20),
             "plain_ms": cuda_ms(lambda: kq.encode_plain(pk), 1),
             "bytes": pk.numel() * 4 + check["noise_stream_bytes"],
             "ops": OPS_K14_PIXEL * pk.numel(), "launches": launches["qoi_encode"],
             "library_ms": None, "max_abs_err": max(errs.values()),
             "screen_ms": cuda_ms(lambda: kq.encode(packed["screen"]), 20)}
    summary = {"check": check, "max_abs_err": errs, "e2e_ms_per_batch": [w * 1e3 for w in walls],
               "e2e_mpix_per_s": mpix / float(np.mean(walls)), "stage_ms_mean": mean,
               "launches_per_call": {k: v for k, v in launches.items() if v}}
    del packed
    return summary, entry, launches


BMP_TIMED = {"24bpp": (24, 40, False, False), "8bpp": (8, 40, False, False)}


def make_bmp(seed: int, bpp: int, info: int, top_down: bool, short: bool) -> bytes:
    """One random 1024^2 BMP from the port's numpy writer: indices and a
    palette of 2^bpp colours (fewer than half when ``short``, so indices
    pass its end) for 1-8 bpp, RGB or RGBA pixels for 24 and 32."""
    from zpix_tpu_torch.codecs.bmp.encode import encode

    rng = np.random.default_rng(seed)
    if bpp <= 8:
        n = max(1, (1 << bpp) // 2 - 1) if short else 1 << bpp
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, 1 << bpp, (SIZE, SIZE), dtype=np.uint8)
        return encode(idx, bpp=bpp, info_len=info, top_down=top_down, palette=pal)
    pix = rng.integers(0, 256, (SIZE, SIZE, 3 if bpp == 24 else 4), dtype=np.uint8)
    return encode(pix, bpp=bpp, info_len=info, top_down=top_down)


def make_bmp_batch(arm, s: int):
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return list(ex.map(lambda j: make_bmp(s * BATCH + j, *arm), range(BATCH)))


def bmp_stages(dec, datas):
    """One batch through BatchBmpDecoder's stages -> (pixels, plain pixels
    on the same uploaded inputs, {stage: ms})."""
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    t0 = time.perf_counter()
    rows, pal, (width, _h, top_down, bpp, allow_alpha) = dec.prep(datas)
    host_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(bpp=bpp, width=width, top_down=top_down, allow_alpha=allow_alpha)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    rows_d, pal_d = dec.upload(rows, pal)
    ev[1].record()
    px = bmp_unpack(rows_d, pal_d, **kw)
    ev[2].record()
    torch.cuda.synchronize()
    return px, bmp_unpack_plain(rows_d, pal_d, **kw), {
        "host_parse": host_ms, "h2d": ev[0].elapsed_time(ev[1]),
        "bmp_unpack": ev[1].elapsed_time(ev[2]), "device_total": ev[0].elapsed_time(ev[2])}


def bmp_phase(dev):
    """BMP: K18 against its plain version on every arm at full batch,
    BatchBmpDecoder on 10 timed batches of 24-bit bottom-up and of 8-bit
    paletted images, launches of one decode, pixels against the plain path,
    truncated pixel data.  -> (summary, timing entry, launches)"""
    from zpix_tpu_torch import BatchBmpDecoder, runtime
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    dec = BatchBmpDecoder()
    t0 = time.perf_counter()
    errs = {}
    arms = [(bpp, info, td, False) for bpp in (1, 2, 4, 8, 24, 32) for info in (40, 108, 124)
            for td in (False, True)] + [(bpp, 40, False, True) for bpp in (1, 2, 4, 8)]
    for i, arm in enumerate(arms):
        px, ref, _ = bmp_stages(dec, make_bmp_batch(arm, 700 + i))
        errs["{}bpp_{}_{}{}".format(arm[0], arm[1], "td" if arm[2] else "bu",
                                    "_short" if arm[3] else "")] = max_abs_err(px, ref)
        del px, ref
    arms_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = {k: [make_bmp_batch(arm, 900 + s) for s in range(TIMED_BATCHES + 2)]
               for k, arm in BMP_TIMED.items()}
    content_s = time.perf_counter() - t0
    routes, launches = {}, {}
    for k, bb in batches.items():
        dec.decode(bb[1])
        torch.cuda.synchronize()
        runtime.reset_launches()
        px = dec.decode(bb[0])
        torch.cuda.synchronize()
        launches[k] = dict(runtime.LAUNCHES)
        _, ref, _ = bmp_stages(dec, bb[0])
        main_equal = bool(torch.equal(px, ref))
        del px, ref
        walls, peak, mean, _ = timed_decodes(dec.decode, bb[2:], lambda d: bmp_stages(dec, d))
        equal = [bool(torch.equal(*bmp_stages(dec, d)[:2])) for d in bb[2:]]
        routes[k] = {"main_equal_plain": main_equal, "timed_equal_plain": equal,
                     **route_summary(walls, peak, mean, launches[k])}
    bad = batches["24bpp"][0]
    try:
        dec.decode(bad[:-1] + [bad[-1][:-100]])
        truncated = "no error"
    except ZpixError as exc:
        truncated = type(exc).__name__

    # timing entry: the 8-bit arm (its library yardstick is the palette
    # gather pal[b, idx], the index tensor made beforehand), 24-bit beside it
    rows, pal, (width, _h, top_down, bpp, allow_alpha) = dec.prep(batches["8bpp"][0])
    rows_d, pal_d = dev_t(rows, dev), dev_t(pal, dev)
    kw = dict(bpp=bpp, width=width, top_down=top_down, allow_alpha=allow_alpha)
    idx = rows_d[:, :, :width].long()
    bidx = torch.arange(BATCH, device=dev)[:, None, None]
    out_bytes = BATCH * SIZE * SIZE * 4
    rows24, pal24, (w24, _h, td24, bpp24, aa24) = dec.prep(batches["24bpp"][0])
    r24, p24 = dev_t(rows24, dev), dev_t(pal24, dev)
    kw24 = dict(bpp=bpp24, width=w24, top_down=td24, allow_alpha=aa24)
    entry = {"ms": cuda_ms(lambda: bmp_unpack(rows_d, pal_d, **kw), 20),
             "plain_ms": cuda_ms(lambda: bmp_unpack_plain(rows_d, pal_d, **kw), 1),
             "bytes": rows.nbytes + pal.nbytes + out_bytes,
             "ops": OPS_K18_PIXEL[8] * BATCH * SIZE * SIZE,
             "launches": launches["8bpp"]["bmp_unpack"],
             "library_ms": cuda_ms(lambda: pal_d[bidx, idx], 20),
             "max_abs_err": max(errs.values()), "arm": "8bpp",
             "arm_24bpp": with_bound({
                 "ms": cuda_ms(lambda: bmp_unpack(r24, p24, **kw24), 20),
                 "plain_ms": cuda_ms(lambda: bmp_unpack_plain(r24, p24, **kw24), 1),
                 "bytes": rows24.nbytes + pal24.nbytes + out_bytes,
                 "ops": OPS_K18_PIXEL[24] * BATCH * SIZE * SIZE,
                 "launches": launches["24bpp"]["bmp_unpack"]})}
    summary = {"arms_seconds": arms_s, "content_seconds": content_s, "max_abs_err": errs,
               "routes": routes, "truncated": truncated}
    return summary, entry, launches["24bpp"]


def raster_slice(dev):
    """The phases qoi, qoi_encode and bmp, each printed and checked ->
    ({kernel: timing entry}, {path: launches of one call})."""
    # ------------------------------------------------------------ QOI
    t0 = time.perf_counter()
    q, raster_entries, q_launches, lane_decs = qoi_phase(dev)
    emit({"phase": "qoi", "seconds": time.perf_counter() - t0, **q})
    if any(q["max_abs_err"].values()):
        raise SystemExit("chip_smoke: a QOI expansion kernel disagrees with its plain version")
    qr = q["routes"]
    if (min(q_launches[c]["qoi_lane_expand"] for c in QOI_PROFILES) == 0
            or q_launches["sorted"]["qoi_sorted_expand"] == 0
            or qr["alpha_auto"]["launches"] == 0 or qr["alpha_auto"]["fmt"] != "wide"):
        raise SystemExit("chip_smoke: a QOI route skipped its kernel")
    if (not all(qr[c]["main_equal_host"] and all(qr[c]["timed_images_0_1_equal_host"])
                for c in QOI_PROFILES)
            or not qr["alpha_auto"]["equal_host"] or not qr["sorted_noise"]["main_equal_lane"]
            or not all(qr["sorted_noise"]["timed_equal_lane"])):
        raise SystemExit("chip_smoke: a QOI route's pixels are wrong")
    dm = q["damaged"]
    if (not (dm["cut_lane_equal_host"] and dm["cut_sorted_equal_host"]
             and dm["cut_tail_is_fill"])
            or dm["short_header"] != "FormatError: qoi: data too short"):
        raise SystemExit("chip_smoke: a damaged QOI stream decoded wrongly")

    # ------------------------------------------------------ QOI encode
    t0 = time.perf_counter()
    qe, raster_entries["qoi_encode"], qe_launches = qoi_encode_phase(dev, lane_decs)
    emit({"phase": "qoi_encode", "seconds": time.perf_counter() - t0, **qe})
    del lane_decs
    qc = qe["check"]
    if (any(qe["max_abs_err"].values()) or qe_launches["qoi_encode"] == 0
            or not all(v for k, v in qc.items() if isinstance(v, bool))
            or not all(qc["timed_equal_source"])):
        raise SystemExit("chip_smoke: the device encoder's streams are wrong")

    # ------------------------------------------------------------ BMP
    t0 = time.perf_counter()
    bm, raster_entries["bmp_unpack"], bm_launches = bmp_phase(dev)
    emit({"phase": "bmp", "seconds": time.perf_counter() - t0, **bm})
    if any(bm["max_abs_err"].values()) or bm_launches["bmp_unpack"] == 0:
        raise SystemExit("chip_smoke: K18 disagrees with its plain version or was skipped")
    if (not all(r["main_equal_plain"] and all(r["timed_equal_plain"])
                for r in bm["routes"].values()) or bm["truncated"] != "UnexpectedEof"):
        raise SystemExit("chip_smoke: the BMP route's output is wrong")
    return raster_entries, {"qoi_lane": q_launches["noise"], "qoi_sorted": q_launches["sorted"],
                            "qoi_encode": qe_launches, "bmp": bm_launches}


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

    # ------------------------------------------- QOI decode and encode, BMP
    raster_entries, raster_paths = raster_slice(dev)

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
    paths = {"dri8": launches, "native": ln, "host_index": lh, "progressive": lp,
             **raster_paths}
    by_path = {k: {p: counts[k] for p, counts in paths.items()} for k in KERNELS}
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
            "launches_by_path": by_path[kname],
            "max_abs_err": e["max_abs_err"], "matches_plain": e["max_abs_err"] == 0,
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": e["bytes"], "bound_int32_ops": e["ops"], "library_ms": None,
            "scans_per_decode": e["scans"],
            **({"restore_ms_taken_off": e["restore_ms_taken_off"]}
               if "restore_ms_taken_off" in e else {}),
        })
    for kname in RASTER_KINDS:
        e = raster_entries[kname]
        bytes_ms = e["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = e["ops"] / INT32_OPS_PER_S * 1e3
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": e["launches"],
            "launches_by_path": by_path[kname], "max_abs_err": e["max_abs_err"],
            "matches_plain": e["max_abs_err"] == 0, "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": e["bytes"], "bound_int32_ops": e["ops"],
            "library_ms": e["library_ms"],
            **{k: v for k, v in e.items() if k not in (
                "ms", "plain_ms", "bytes", "ops", "launches", "library_ms", "max_abs_err")},
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
