#!/usr/bin/env python3
"""Smoke check and measurement of zpix_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from zpix_tpu_torch/csrc (nvcc) and the host
library from zpix_tpu_torch/csrc/host (g++), checks each kernel against
its plain PyTorch version on the card (exact equality; K4 and K6 on every
colour arm and sampling ratio, both layouts, odd crops, wrapping products,
and 64 x 1024^2 batches; K1 and K2 on their edges, on segments coded
with tables no Pillow image has, and on damaged streams;
every component sampled 3 x 1 or 1 x 3 through the three baseline
decoders; K7 over every component at every ratio and gray, on grids no
tile divides, batch 1 and a clipped cap; K3 at every tile size on chains
of 1, tile - 1, tile and tile + 1 MCUs, segments crossing tiles and the
three routes' chains), decodes batches
of 16 distinct 1024x1024 baseline 4:2:0 JPEGs (quality 50) through the
port's four baseline routes -- ``DeviceJpegDecoder`` on streams with a
restart marker every 8 MCUs, and ``BatchJpegDecoder`` (native front-end,
K7 in one launch for every component, K6), ``HostIndexJpegDecoder``
(host index scan, K2, K3, K4) and
``SyncJpegDecoder`` (K19's chunk sync, K2, K3, K4; the ``sync`` phase) on
streams with none -- and batches of 16 copies of one 1024x1024 4:2:0
progressive JPEG (a new image each batch) through
``OnchipProgressiveDecoder`` (host index walks, K8-K11, K6; K8-K11
also at q90 and q25, 4:4:4, gray and a 999x997 crop, on damaged copies,
and K10 on streams cut inside its scans; K8 at batch 1, 4:2:2 and a
width of 63 MCUs, on streams cut short; K9 on a store holding values in
its band and on one not 16-byte aligned; K11 on interleaved 4:4:4,
4:2:2, 4:2:0 and 4:1:1 scans, single-component scans with partial MCUs,
all and no bits set, rows wider than their bits and Al 0-13, each twice), times
them with CUDA events, checks that corrupt streams are flagged, holds
each route's image 0 against the port's host decoder
(zpix_tpu_torch.codecs.jpeg) at max_abs_err 0, and prints one JSON
object per line.  The ``python_front_end`` phase then decodes batches of
16 distinct 1024x1024 RGB 4:4:4, CMYK 4:4:4, YCCK {2x2,1x1,1x1,2x2},
one-scan-a-component 4:2:0 and progressive 4:2:0 streams through
``BatchJpegDecoder``'s Python front-end (the host decoder's scans,
pack_sparse, K7, K6 on its rgb, ycck, cmyk and ycbcr arms), every image
of a batch against the host decoder, K7 and K6 against their plain
versions, each kind timed by stage (front-end on 1 and 8 threads, H2D,
K7, K6), and ``OnchipProgressiveDecoder.decode_verified`` on a corrupt
batch and with ``ok`` forced False.  Then the raster slice: batches of 16
distinct 1024x1024 QOI streams (the JAX bench's "noise" and "screen"
content, made by the port's host encoder) through ``HostIndexQoiDecoder``
(host lane fill, K12, also on hand-built entries and on lanes wider than
its window, P = 5,000 and 32,767; host records, K13, also on its edges:
counts of 255, zero runs longer than a tile, an image all fill, 64 x
1024^2 noise records), the decoded batches back
through ``encode_device_batch`` (K14, streams byte-identical to the host
encoder; K14 also on 64 images, a grid of tiles beyond what the card holds
at once), and 16 distinct 1024x1024 BMPs a batch from the port's numpy
writer through ``BatchBmpDecoder`` (K18, every bit depth, header and
orientation, and widths 1, 3 and 5 at every bit depth; 1, 8, 24 and 32
bpp timed).  Then the ``png`` phase: K15-K17 against their plain
versions at 16 x 1024^2 (K15 also at 1, 31, 32, 33, 1,025 and 1,500 rows at
every bpp, K16 at every tile size on hand-built chains and at per = T - 1,
T, T + 1; K15's bands a block and K16's tile size swept on the bench
batch), batches of 16 distinct 1024x1024 RGB8 PNGs of the
JAX bench's content (Pillow, compress_level 6) through ``BatchPngDecoder``
by its three front-ends (host inflate and defilter, K17; host inflate,
K15, K17; host tokens, K16, K15, K17), two Adam7 batches (RGB8, and
paletted with tRNS, from the tests' PNG writer, tests/_torch_png.py) by
every front-end (K17's seven pass launches each timed with its bound),
and five kinds of damaged stream (a wrong adler32
trailer among them, checked on the card by ``device_inflate``; the
check also on rows of every alignment, of no bytes, of a span less or
more one byte, and on 70,000 one-byte images).  Then the
``pipeline`` phase: each route's 10 timed batches (DRI 8, native, host
index, sync, progressive, QOI noise p4, BMP 24 bpp, PNG ``host``)
decoded serially and through ``DecodePipeline``, the outputs and ``ok``
bit-identical, each run's end-to-end MPix/s and the card's busy share,
the metrics registry's report, and one pipelined DRI 8 run traced into
build/pipeline_trace (its five longest device ops and idle gaps).  The
``bmp`` and ``png`` phases also hold images 0 and 1 of each batch against
the port's host decoders (``zpix_tpu_torch.from_buffer(d).rgba_pixels()``)
at max_abs_err 0.  Then the ``decode_mixed`` phase: one shuffled list of
1024x1024 images (16 restart-free baseline 4:2:0 and 16 CMYK 4:4:4 JPEGs,
16 copies of one progressive 4:2:0 JPEG and 4 distinct ones, 16 QOI, 16
24-bit BMPs and 4 paletted ones with short palettes, 16 RGB8 PNGs, 2
progressive CMYK JPEGs and one gray JPEG) through
``zpix_tpu_torch.parallel.decode_mixed`` (min_batch 2): the route counts,
each kernel's launches in one call (K6-K12, K17, K18), every output equal
to the host path, 3 timed calls (MPix/s), the card's busy share, peak
memory and the metrics report, and the errors of a damaged PNG and of
unknown bytes.  Then the ``mesh`` phase (parallel/mesh.py): every mesh
decoder's batch of 16 (DRI 8, host index, native JPEG, BMP 24 bpp, PNG
``host`` and ``device_inflate``, QOI lane p4 and sorted) unsharded, over
``make_mesh()`` (every visible card) and over ``make_mesh(["cuda:0"] *
4)``, each output against the unsharded decode at max_abs_err 0 with
``ok`` True and each kernel's launches 4x on four shards, MPix/s and
launches a call; six DRI 8 images whose lanes straddle the four shards;
``decode_mixed(mesh=)`` on the mixed corpus against the unsharded call;
and two processes of this script on the one card (gloo,
parallel/distributed.py, ``--distributed-worker``), each decoding 8 of
the 16 DRI 8 images, their shards against the single-process decode.
Then the ``spec`` phase: K20-K23 against their plain versions at 16 x
1024^2 (K20 and K21 on every DC-first and AC-first scan, K22 on the host
tail's deltas beside ``scatter_add_``, K23 on QOI noise and screen), and
batches of 16 copies of one 1024^2 4:2:0 progressive image through
``OnchipProgressiveDecoder(impl="spec")`` (libjpeg's script: no host
tail, one flag fetch; Cb's AC-first scan moved after Y's first
refinement: the tail decodes 5 scans; a batch the host walk refuses goes
the spec path in host-index mode's ``decode()``) and
``DeviceProgressiveDecoder``, and QOI noise and screen through
``BatchQoiDecoder`` (its passes and chunks, an ``ops_cap`` overflow), each
against the host decoder and timed by stage between CUDA events.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero.  Without CUDA it exits non-zero and prints no
result.
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

from zpix_tpu_torch.utils import roofline
from zpix_tpu_torch.utils.roofline import (BOOST_HZ, HBM_BYTES_PER_S, INT32_OPS_PER_S,
                                           OPS_IDCT_BLOCK, OPS_K1_SYMBOL, OPS_K2_SYMBOL,
                                           OPS_K4_BLOCK, OPS_K4_CHROMA, OPS_K4_PIXEL)

BATCH, SIZE, QUALITY, DRI = 16, 1024, 50, 8
TIMED_BATCHES = 10
# The card's peaks and the least arithmetic of K1, K2, K4 and the IDCT:
# zpix_tpu_torch/utils/roofline.py, the bound of every entry below.
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
    "png_defilter": ("zpix_tpu_torch/csrc/png_defilter.cu", "zpix_tpu/ops/defilter.py:35"),
    "inflate_resolve": ("zpix_tpu_torch/csrc/inflate_resolve.cu", "zpix_tpu/ops/inflate.py:33"),
    "png_expand": ("zpix_tpu_torch/csrc/png_expand.cu", "zpix_tpu/parallel/png_batch.py:299"),
    "sync_decode": ("zpix_tpu_torch/csrc/sync_entropy.cu",
                    "zpix_tpu/parallel/device_entropy_sync.py:176"),
    "dc_first_spec": ("zpix_tpu_torch/csrc/prog_spec.cu",
                      "zpix_tpu/parallel/progressive_onchip.py:363"),
    "ac_first_spec": ("zpix_tpu_torch/csrc/prog_spec.cu",
                      "zpix_tpu/parallel/progressive_onchip.py:541"),
    "delta_add": ("zpix_tpu_torch/csrc/prog_spec.cu", "zpix_tpu/parallel/progressive.py:85"),
    "qoi_spec": ("zpix_tpu_torch/csrc/qoi_spec.cu", "zpix_tpu/parallel/qoi_batch.py:158"),
}
PROG_KINDS = ("dc_first", "ac_first", "ac_refine", "dc_refine")
RASTER_KINDS = ("qoi_lane_expand", "qoi_sorted_expand", "qoi_encode", "bmp_unpack",
                "png_defilter", "inflate_resolve", "png_expand")
# QOI content profiles -> lane_p, the JAX bench's choice for each
# (bench.py main_qoi); p4 caps 256 at 255, then shrinks it to 128 on 1024^2
QOI_PROFILES = {"noise": 16, "screen": 256}
# The least operations of each function, a pixel (or a record):
# - K12's masked sum, as a per-lane difference array (exact on any entry
#   set): an add at the clamped start and a subtract at the clamped end
#   per entry slot, a prefix add per pixel (the kernel's own algorithm);
# - K13: an add per record (the prefix sum), a select and a store per
#   pixel (the function's least work, whatever implements it);
# - K14: hash (4 multiplies, 3 adds, a mask), run test, 5 differences, 16
#   range compares, bucket compare, size and scan adds;
# - K18: index extract (shift, mask) or swizzle, 3 x 4 for the premultiply.
OPS_K12_SLOT, OPS_K12_PIXEL = 2, 1
OPS_K13_RECORD, OPS_K13_PIXEL, OPS_K14_PIXEL = 1, 2, 32
OPS_K18_PIXEL = {1: 2, 2: 2, 4: 2, 8: 1, 24: 1, 32: 12}


def with_bound(entry: dict) -> dict:
    """A side measurement's entry with its bound: the larger of its bytes
    over the memory rate and its operations over the int32 rate
    (``roofline.bound_ms``)."""
    ms, by = roofline.bound_ms(entry["bytes"], entry["ops"])
    return {**entry, "bound_ms": ms, "bound_by": by}


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


def host_path_err(px, datas, n: int = 2) -> int:
    """max_abs_err of images 0 .. n-1 of a batch's RGBA8 output [B, H, W, 4]
    against the port's host path, from_buffer(d).rgba_pixels() (-1 where a
    shape differs)."""
    from zpix_tpu_torch import from_buffer

    err = 0
    for i in range(n):
        img = from_buffer(datas[i])
        want = torch.from_numpy(img.rgba_pixels().reshape(img.height, img.width, 4))
        if tuple(px[i].shape) != tuple(want.shape):
            return -1
        err = max(err, max_abs_err(px[i].cpu(), want))
    return err


def block_symbols(ac):
    """Huffman symbols of each block (DC, AC with ZRLs, EOB) from its
    decoded natural-order AC row -> int64 [L2]."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG

    zz = ac[:, torch.as_tensor(UNZIG, device=ac.device).long()][:, 1:] != 0  # [L2, 63]
    idx = torch.arange(1, 64, device=ac.device)
    last = torch.where(zz, idx, 0).max(1).values
    prev = torch.cummax(torch.where(zz, idx, 0), 1).values
    prev = torch.cat([torch.zeros_like(prev[:, :1]), prev[:, :-1]], 1)
    run = torch.where(zz, idx - prev - 1, 0)
    return 1 + zz.sum(1) + (run // 16).sum(1) + (last < 63).long()


def segment_symbols(ac, dc_diff, seg_nmcu, nblk: int, bpm: int):
    """Huffman symbols per block from decoded coefficients, -> (max per
    restart segment, max per block, total)."""
    syms = block_symbols(ac)
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
            perm = pb.stream_perm(mxx, myy, *hv)
            got = ks.unpack_sparse(bm, vals, bv=bv, bh=bh, perm=perm)
            want = ks.unpack_sparse_plain(bm, vals, bv=bv, bh=bh, perm=perm)
            errs[f"unpack_{hv[0]}{hv[1]}_cap{cap}"] = max_abs_err(got, want)
    torch.cuda.synchronize()
    return errs


def k7_k3_edge_checks(dev):
    """K7's one-launch form over every component of a decode on grids of
    7 x 9 and 37 x 29 MCUs (block counts no tile divides, grids below one
    tile), every sampling ratio and gray, batches of 1 and 3, Cr's cap
    clipped; one launch a call.  K3 at whole-image chains of 1, tile - 1,
    tile and tile + 1 MCUs and restart segments of 3, 7 and 300 MCUs
    (crossing tiles), diffs over the whole int32 range.  Each case runs
    twice, so a launch that leaves the kept look-back scratch wrong for
    the next (its ticket counter, its words) shows.  -> {case:
    max_abs_err}, a launch count that is not 1 read as an error of 1."""
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb

    rng = np.random.default_rng(15)
    errs = {}
    for ratio in ("444", "422", "420", "440", "411", "410", "gray"):
        hv = (1, 1) if ratio == "gray" else pb.RATIO_FACTORS[ratio]
        for (mxx, myy), batch in (((7, 9), 3), ((37, 29), 1)):
            dims = [(myy * hv[1], mxx * hv[0])] + ([] if ratio == "gray" else [(myy, mxx)] * 2)
            comps = []
            for c, (bv, bh) in enumerate(dims):
                bm = (rng.integers(0, 256, (batch, bv * bh, 8))
                      & rng.integers(0, 256, (batch, bv * bh, 8))).astype(np.uint8)
                n = int(np.unpackbits(bm, axis=-1).reshape(batch, -1).sum(1).max())
                vals = rng.integers(-2**15, 2**15, (batch, 37 if c == 2 else n + 5))
                comps.append(ks.SparseComponent(
                    torch.from_numpy(bm).to(dev), torch.from_numpy(vals.astype(np.int16)).to(dev),
                    bv, bh, pb.stream_perm(mxx, myy, *hv) if c == 0 else None))
            want = ks.unpack_components_plain(comps)
            for rep in range(2):
                runtime.reset_launches()
                got = ks.unpack_components(comps)
                one = runtime.LAUNCHES["unpack_sparse"] == 1
                errs[f"k7_{ratio}_{mxx}x{myy}_b{batch}_r{rep}"] = max(
                    [int(not one)] + [max_abs_err(g, w) for g, w in zip(got, want)])
    hv, tile = ((2, 2), (1, 1), (1, 1)), ke.K3_TILE_MCUS
    for seg, n_seg in ((1, 5), (tile - 1, 3), (tile, 3), (tile + 1, 3), (3, 700), (7, 300),
                       (300, 9)):
        dc = torch.from_numpy(rng.integers(-2**31, 2**31, n_seg * seg * 6)
                              .astype(np.int32)).to(dev)
        want = ke.dc_restore_plain(dc, hv=hv, seg_mcus=seg)
        for rep in range(2):
            errs[f"k3_seg{seg}x{n_seg}_r{rep}"] = max_abs_err(
                ke.dc_restore(dc, hv=hv, seg_mcus=seg), want)
    torch.cuda.synchronize()
    return errs


def backend_checks(dev):
    """K4 against its plain version on every colour arm and ratio of
    _SMALL_PLANES, planar and interleaved, cropped to a size that is no
    multiple of the MCU or of 4, with padding lanes after each image (m_pad
    > n_mcu), in the JPEG range and with values and quants whose products
    wrap; then K4 (both layouts) and K6 (int16 and int32) on 64 x 1024^2
    4:2:0, far more strips than the persistent grid holds.
    -> {case: max_abs_err}."""
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops.entropy import TAB_WORDS

    gen = torch.Generator(device="cpu").manual_seed(2)
    errs = {}
    mxx, myy, B = 7, 5, 3
    for color, hv, ratio in _SMALL_PLANES:
        geom = kb.BackendGeometry(B, 8 * hv[0][0] * mxx - 5, 8 * hv[0][1] * myy - 3, tuple(hv),
                                  mxx, myy, mxx * myy + 5, color)
        n = B * geom.m_pad * geom.bpm
        pattern = ratio or "".join(f"{h}{v}" for h, v in hv)
        for wide in (False, True):
            lim = 2**15 if wide else 1024
            ac = torch.randint(-lim, lim, (n, 64), generator=gen, dtype=torch.int16)
            ac = (ac * (torch.rand(ac.shape, generator=gen) < 0.3)).to(dev)
            dc = (torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, dtype=torch.int64)
                  if wide else torch.randint(-2000, 2000, (n,), generator=gen))
            dc = dc.to(torch.int32).to(dev)
            tables = torch.randint(1, 2**16 if wide else 64, (TAB_WORDS,), generator=gen,
                                   dtype=torch.int32).to(dev)
            for planar in (True, False):
                got = kb.backend(ac, dc, tables, geom, planar=planar)
                want = kb.backend_plain(ac, dc, tables, geom, planar=planar)
                layout = "planar" if planar else "interleaved"
                errs[f"backend_{color}_{pattern}_{layout}_{'wide' if wide else 'jpeg'}"] = (
                    max_abs_err(got, want))
    big = 4 * BATCH
    hv = ((2, 2), (1, 1), (1, 1))
    geom = kb.BackendGeometry(big, SIZE, SIZE, hv, SIZE // 16, SIZE // 16, (SIZE // 16) ** 2,
                              "ycbcr")
    cgen = torch.Generator(device=dev).manual_seed(3)
    n = big * geom.m_pad * geom.bpm
    ac = torch.randint(-1024, 1024, (n, 64), generator=cgen, device=dev, dtype=torch.int16)
    ac *= torch.rand(ac.shape, generator=cgen, device=dev) < 0.1
    dc = torch.randint(-2000, 2000, (n,), generator=cgen, device=dev, dtype=torch.int32)
    tables = torch.randint(1, 64, (TAB_WORDS,), generator=cgen, device=dev, dtype=torch.int32)
    want = kb.backend_plain(ac, dc, tables, geom, planar=True)
    errs[f"backend_{big}x{SIZE}_planar"] = max_abs_err(
        kb.backend(ac, dc, tables, geom, planar=True), want)
    errs[f"backend_{big}x{SIZE}_interleaved"] = max_abs_err(
        kb.backend(ac, dc, tables, geom, planar=False), want.permute(0, 2, 3, 1))
    del ac, dc, want
    grids = []
    for h, v in hv:
        g = torch.randint(-1024, 1024, (big, SIZE // 16 * v, SIZE // 16 * h, 64), generator=cgen,
                          device=dev, dtype=torch.int16)
        grids.append(g * (torch.rand(g.shape, generator=cgen, device=dev) < 0.1))
    quants = [torch.randint(1, 64, (big, 64), generator=cgen, device=dev, dtype=torch.int32)
              for _ in hv]
    kw = dict(color="ycbcr", height=SIZE, width=SIZE, factors=[(1, 1), (2, 2), (2, 2)])
    want = kp.component_planes_plain(grids, quants, **kw)
    errs[f"planes_{big}x{SIZE}_int16"] = max_abs_err(kp.component_planes(grids, quants, **kw),
                                                     want)
    errs[f"planes_{big}x{SIZE}_int32"] = max_abs_err(
        kp.component_planes([g.to(torch.int32) for g in grids], quants, **kw), want)
    torch.cuda.synchronize()
    return errs


def jpeg_writer():
    """tests/_torch_jpeg_writer.py, the tests' JPEG inputs (Pillow, a
    baseline writer of any sampling, entropy segments coded with any
    tables; it imports nothing of the JAX package), loaded by path."""
    import importlib.util

    if "_torch_jpeg_writer" in sys.modules:
        return sys.modules["_torch_jpeg_writer"]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_torch_jpeg_writer.py")
    spec = importlib.util.spec_from_file_location("_torch_jpeg_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules["_torch_jpeg_writer"] = mod
    return mod


def k1_k2_edge_checks(dev, writer, hplan, hbufs, hac, hdc, rf_batch):
    """K1 and K2 against their plain versions on the card, on
    tests/_torch_jpeg_writer.py::k1_k2_edges at 512 x 307 (segments of one
    MCU, a partial last segment, lane counts no multiple of a CTA or a
    warp group, 63-coefficient blocks, ZRL runs, EOB at k = 1, DC sizes up
    to 11, optimised tables with long codes, 1, 3, 4, 6, 9 and 10 blocks
    an MCU), on its ``coded_segments`` (2,000 segments coded with tables
    no Pillow image has: 16-bit codes, more long-code prefixes than a
    CTA's second-level blocks, six table pairs; each also under random,
    unsorted limits), three kinds of damage (an invalid code, a read past
    the buffer, a block ending off ``ends``), and K2 on the host-index and sync
    routes' whole-image chains at 16 x 1024^2 (``hplan``, ``hbufs``, K2's
    ``hac``, ``hdc``: the host-index inputs of ``rf_batch``; the sync
    route's from K19 on the same batch).  -> {case: {"index_pass", "value_pass":
    max_abs_err, ok equality included; "ok": the kernels' ok}}."""
    from zpix_tpu_torch import DeviceJpegDecoder, SyncJpegDecoder, prep_batch
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sync as ksync

    dec = DeviceJpegDecoder()
    out = {}

    def both(bufs, bpm, nblk, shift_end=None):
        kw = dict(bpm=bpm, nblk=nblk)
        ends, ok = ke.index_pass(*bufs, **kw)
        ends_p, ok_p = ke.index_pass_plain(*bufs, **kw)
        row = {"index_pass": max(max_abs_err(ends, ends_p), max_abs_err(ok, ok_p))}
        if shift_end is not None:
            ends.view(-1)[shift_end] += 1
        ok_k, ok_q = ok.clone(), ok.clone()
        ac, dc = ke.value_pass(*bufs, ends, ok_k, bpm=bpm)
        ac_p, dc_p = ke.value_pass_plain(*bufs, ends, ok_q, bpm=bpm)
        row["value_pass"] = max(max_abs_err(ac, ac_p), max_abs_err(dc, dc_p),
                                max_abs_err(ok_k, ok_q))
        row["ok"] = [int(ok), int(ok_k)]
        return row

    def both_plan(plan, shift_end=None):
        return both(dec.upload(plan), plan.bpm, plan.seg_mcus * plan.bpm, shift_end)

    edges = writer.k1_k2_edges(512)
    for name, datas in edges.items():
        out[name] = both_plan(prep_batch(datas))
        if out[name]["ok"] != [1, 1]:
            raise SystemExit(f"chip_smoke: the K1/K2 edge case {name} did not verify")
    for name in writer.CODED_CASES:
        c = writer.coded_segments(name, n_segs=2000)
        for limits in ("as_coded", "random_limits"):
            if limits == "random_limits":
                c["tables"] = writer.random_limits(c["tables"])
            bufs = [torch.from_numpy(c[k]).to(dev)
                    for k in ("stream", "seg_pos", "seg_nmcu", "tables")]
            row = out[f"coded_{name}_{limits}"] = both(bufs, c["bpm"], c["nblk"])
            if limits == "as_coded" and row["ok"] != [1, 1]:
                raise SystemExit(f"chip_smoke: the K1/K2 coded case {name} did not verify")
    for name in ("dri1", "optimized_bpm6"):
        plan = prep_batch(edges[name])
        for kind in ("invalid_code", "past_buffer"):
            out[f"{name}_{kind}"] = both_plan(writer.damage_plan(plan, kind))
        out[f"{name}_end_off"] = both_plan(plan, shift_end=7)
    # K2 on whole-image chains: the host index scan's ends and K19's
    ok_q = torch.ones(1, dtype=torch.int32, device=dev)
    ac_p, dc_p = ke.value_pass_plain(*hbufs[:4], hbufs[4], ok_q, bpm=hplan.bpm)
    out["host_index_16x1024"] = {"value_pass": max(max_abs_err(hac, ac_p),
                                                   max_abs_err(hdc, dc_p)),
                                 "ok": [int(ok_q)]}
    sdec = SyncJpegDecoder()
    splan = sdec.prep(rf_batch)
    sb = sdec.upload(splan)
    sends = ksync.sync_ends(sb[0], sb[1], sb[4], sb[3], chunk_bytes=splan.chunk_bytes,
                            n_chunks=splan.n_chunks, bpm=splan.bpm,
                            nblk=splan.n_mcu * splan.bpm)[0]
    ok_k, ok_q = (torch.ones(1, dtype=torch.int32, device=dev) for _ in range(2))
    ac, dc = ke.value_pass(*sb[:4], sends, ok_k, bpm=splan.bpm)
    ac_p, dc_p = ke.value_pass_plain(*sb[:4], sends, ok_q, bpm=splan.bpm)
    out["sync_16x1024"] = {"value_pass": max(max_abs_err(ac, ac_p), max_abs_err(dc, dc_p),
                                             max_abs_err(ok_k, ok_q)), "ok": [int(ok_k)]}
    for name in ("host_index_16x1024", "sync_16x1024"):
        if out[name]["ok"] != [1]:
            raise SystemExit(f"chip_smoke: K2 on {name} did not verify")
    torch.cuda.synchronize()
    return out


def factor3_checks(dev, writer):
    """Every component sampled 3 x 1 (or 1 x 3), which every baseline prep
    admits: HostIndexJpegDecoder, SyncJpegDecoder and DeviceJpegDecoder
    (a restart marker every 2 MCUs) on the card against the same decoders'
    plain paths, at 40 x 24 and 203 x 117 (K4 through its hmax-3 pixel
    stage where the MCU is 3 blocks wide); K6 on the restart batch's
    coefficient planes (replication 1).  -> {case: max_abs_err}; raises
    where ok is not True."""
    from zpix_tpu_torch import (DeviceJpegDecoder, HostIndexJpegDecoder, SyncJpegDecoder,
                                prep_batch)
    from zpix_tpu_torch.ops import planes as kp

    errs = {}
    for tag, hv in (("h3", ((3, 1),) * 3), ("v3", ((1, 3),) * 3)):
        for w, h in ((40, 24), (203, 117)):
            plain = [writer.synth_ratio_jpeg(hv, w, h, s) for s in (0, 1)]
            dri = [writer.synth_ratio_jpeg(hv, w, h, s, dri=2) for s in (0, 1)]
            for make, datas in ((HostIndexJpegDecoder, plain), (SyncJpegDecoder, plain),
                                (DeviceJpegDecoder, dri)):
                got, ok = make(device=dev).decode(datas)
                want, want_ok = make(device="cpu").decode(datas)
                if not (bool(ok) and bool(want_ok)):
                    raise SystemExit(f"chip_smoke: factor-3 {tag} {make.__name__} not ok")
                errs[f"backend_{tag}_{w}x{h}_{make.__name__}"] = max_abs_err(got.cpu(), want)
            plan = prep_batch(dri)
            coeffs, _ = DeviceJpegDecoder(device="cpu").decode_coefficients(plan)
            x = coeffs.view(2, plan.n_segs * plan.seg_mcus, plan.bpm, 64)[:, : plan.n_mcu]
            hc, vc = hv[0]
            grids = [x[:, :, 3 * c : 3 * c + 3].reshape(2, plan.myy, plan.mxx, vc, hc, 64)
                     .permute(0, 1, 3, 2, 4, 5).reshape(2, plan.myy * vc, plan.mxx * hc, 64)
                     .contiguous() for c in range(3)]
            quants = [torch.from_numpy(np.tile(np.asarray(q, np.int32), (2, 1)))
                      for q in plan.quants]
            kw = dict(color="ycbcr", height=h, width=w, factors=[(1, 1)] * 3)
            errs[f"planes_{tag}_{w}x{h}"] = max_abs_err(
                kp.component_planes([g.to(dev) for g in grids], [q.to(dev) for q in quants],
                                    **kw).cpu(), kp.component_planes_plain(grids, quants, **kw))
    return errs


def native_stages(dec, datas, dev):
    """One batch through BatchJpegDecoder's stages with CUDA events between
    them -> (pixels, {stage: ms}): host parse (host clock), H2D, K7 (all
    components), K6."""
    from zpix_tpu_torch.parallel import batch as pb

    t0 = time.perf_counter()
    packed = dec.prep(datas)
    parse_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    buf = dec.upload(packed)
    ev[1].record()
    grids = pb.unpack_flat(buf, packed.layout, batch=packed.batch, dims=packed.dims,
                           perms=packed.perms)
    ev[2].record()
    quants = [pb.carve(buf, packed.layout, "q", c, packed.batch)
              for c in range(len(packed.hv))]
    px = pb.decode_batch_planes(grids, quants, color=packed.color, height=packed.height,
                                width=packed.width, ratio=packed.ratio, sub=packed.sub)
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
    p2 = pb.NativeBatchFrontEnd(batches[0][0], 2).parse(batches[0][:2])
    buf2 = pb.upload(p2, dev)
    dims = p2.dims
    grids = [ks.unpack_sparse_plain(pb.carve(buf2, p2.layout, "bm", c, 2),
                                    pb.carve(buf2, p2.layout, "val", c, 2), bv=bv, bh=bh,
                                    perm=perm)
             for c, ((bv, bh), perm) in enumerate(zip(dims, p2.perms))]
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
             "native_vs_host_decoder": host_decoder_err(px_n[0], batches[0][0]),
             "host_index_vs_host_decoder": host_decoder_err(px_h[0], batches[0][0]),
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


def sync_dc_input(batch):
    """K2's DC diffs on the sync route (K19's ends): (diffs, plan)."""
    from zpix_tpu_torch import SyncJpegDecoder
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sync as ksync

    dec = SyncJpegDecoder()
    plan = dec.prep(batch)
    b = dec.upload(plan)
    ends, ok = ksync.sync_ends(b[0], b[1], b[4], b[3], chunk_bytes=plan.chunk_bytes,
                               n_chunks=plan.n_chunks, bpm=plan.bpm,
                               nblk=plan.n_mcu * plan.bpm)[:2]
    return ke.value_pass(*b[:4], ends, ok, bpm=plan.bpm)[1], plan


def cumsum_chains(dc, hv, seg_mcus: int):
    """K3's function by PyTorch: torch.cumsum(dtype=int32) a component on
    views of the (segment, MCU, slot) layout (Y's slots copied by the
    reshape).  A yardstick; the port never calls it."""
    bpm = sum(h * v for h, v in hv)
    d = dc.view(-1, seg_mcus, bpm)
    out, s0 = [], 0
    for h, v in hv:
        out.append(torch.cumsum(d[:, :, s0 : s0 + h * v].reshape(d.shape[0], -1), 1,
                                dtype=torch.int32))
        s0 += h * v
    return out


# ------------------------------------------- restart-free on the card (K19)

SYNC_CHUNKS = (32, 256)  # the port's default chunk, and the JAX bench's (bench.py:763)


def sync_kernel_checks(batch, hplan):
    """K19 against its plain version on the card at full batch, at both
    chunk sizes: ends, ok, the entries and the link misses; the ends
    against the host index scan's; K19 alone at each sync chunk size (its
    misses and time).  -> {case: facts}"""
    from zpix_tpu_torch import SyncJpegDecoder, prep_batch_sync
    from zpix_tpu_torch.ops import sync as ksync

    out = {}
    # K19 alone at each sync chunk size on the 32-byte chunks: misses and time
    plan = prep_batch_sync(batch)
    b = SyncJpegDecoder().upload(plan)
    kw = dict(chunk_bytes=plan.chunk_bytes, n_chunks=plan.n_chunks, bpm=plan.bpm,
              nblk=plan.n_mcu * plan.bpm)
    ref = ksync.sync_ends(b[0], b[1], b[4], b[3], **kw)
    for sb in (32, 64, 128, 256, 512):
        res = ksync.sync_ends(b[0], b[1], b[4], b[3], sync_bytes=sb, **kw)
        out[f"sync_bytes{sb}"] = {
            "misses": int(res[3]), "ms": cuda_ms(lambda: ksync.sync_ends(
                b[0], b[1], b[4], b[3], sync_bytes=sb, **kw), 3),
            "max_abs_err_vs_default": max(max_abs_err(x, y) for x, y in zip(res[:3], ref[:3]))}
    # misses forced (links on the 32-byte chunks): K19 against its plain version
    forced = ksync.sync_ends(b[0], b[1], b[4], b[3], sync_bytes=32, **kw)
    pf = ksync.sync_ends_plain(b[0], b[1], b[4], b[3], sync_bytes=32, **kw)
    out["k19_forced_misses"] = {
        "misses": int(forced[3]), "plain_misses": pf[3], "default_misses": int(ref[3]),
        "max_abs_err": max(max(max_abs_err(x, y) for x, y in zip(forced[:3], pf[:3])),
                           abs(int(forced[3]) - pf[3]))}
    for cb in SYNC_CHUNKS:
        plan = prep_batch_sync(batch, cb)
        b = SyncJpegDecoder(chunk_bytes=cb).upload(plan)
        kw = dict(chunk_bytes=cb, n_chunks=plan.n_chunks, bpm=plan.bpm,
                  nblk=plan.n_mcu * plan.bpm)
        ends, ok, entries, misses = ksync.sync_ends(b[0], b[1], b[4], b[3], **kw)
        t0 = time.perf_counter()
        pe, pok, pent, pmisses = ksync.sync_ends_plain(b[0], b[1], b[4], b[3], **kw)
        torch.cuda.synchronize()
        out[f"chunk{cb}"] = {
            "max_abs_err": max(max_abs_err(ends, pe), max_abs_err(ok, pok),
                               max_abs_err(entries, pent), abs(int(misses) - pmisses)),
            "ok": bool(ok), "plain_ok": bool(pok), "misses": int(misses),
            "plain_seconds": time.perf_counter() - t0,
            "chunks_per_image": plan.n_chunks,
            "sync_chunk_bytes": cb * ksync.sync_factor(cb, None),
            "ends_equal_host_index_scan": bool(np.array_equal(ends.cpu().numpy(), hplan.ends))}
    return out


def sync_stages(dec, datas):
    """One batch through SyncJpegDecoder's stages -> (pixels, ok, {stage:
    ms}, K19's link misses): prep (host clock), then CUDA events around
    the upload, after each of K19's four launches (guesses and links;
    resolve, which writes every chunk's entry, the refine; record;
    assembly: the wrapper's ``on_stage`` hook), K2, K3 and K4."""
    from zpix_tpu_torch.ops import backend as kb

    t0 = time.perf_counter()
    plan = dec.prep(datas)
    prep_ms = (time.perf_counter() - t0) * 1e3
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    mark("start")
    bufs = dec.upload(plan)
    mark("h2d")
    ac, dc, okf = dec.entropy(plan, bufs, on_stage=mark)
    px = kb.backend(ac, dc, bufs[3], kb.BackendGeometry.of(plan), planar=False)
    mark("backend")
    torch.cuda.synchronize()
    ms = {"prep": prep_ms}
    for (_n, a), (name, b) in zip(marks, marks[1:]):
        ms[name if name in ("h2d", "value_pass", "dc_restore", "backend")
           else f"k19_{name}"] = a.elapsed_time(b)
    ms["device_total"] = marks[0][1].elapsed_time(marks[-1][1])
    return px, bool(okf), ms, int(dec.misses)


def sync_phase(batches, hplan, mpix):
    """SyncJpegDecoder on the restart-free batches: K19 against its plain
    version at both chunk sizes, one decode with launches counted (and no
    host index scan), images 0-1 against the plain path, 10 timed batches
    end to end and by stage with pixels equal to HostIndexJpegDecoder's,
    and three damaged streams.  -> summary"""
    from zpix_tpu_torch import HostIndexJpegDecoder, SyncJpegDecoder, prep_batch_sync, runtime
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops import backend as kb
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sync as ksync
    from zpix_tpu_torch.runtime import host

    t0 = time.perf_counter()
    checks = sync_kernel_checks(batches[0], hplan)
    checks_s = time.perf_counter() - t0
    dec, hidx = SyncJpegDecoder(), HostIndexJpegDecoder(planar=False)
    dec.decode(batches[1])  # warm: pinned buffer, caches
    torch.cuda.synchronize()
    scans, lib = [], host.lib()  # calls of the host index scan's C entry
    real_scan = lib.zpix_baseline_index_scan
    lib.zpix_baseline_index_scan = lambda *a: scans.append(1) or real_scan(*a)
    try:
        runtime.reset_launches()
        px, ok = dec.decode(batches[0])
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
    finally:
        lib.zpix_baseline_index_scan = real_scan
    main_misses = int(dec.misses)
    hx, hok = hidx.decode(batches[0])
    # images 0 and 1 against the plain path on the card
    plan2 = prep_batch_sync(batches[0][:2])
    b2 = dec.upload(plan2)
    e2, o2, _ent, _r = ksync.sync_ends_plain(b2[0], b2[1], b2[4], b2[3], chunk_bytes=32,
                                             n_chunks=plan2.n_chunks, bpm=plan2.bpm,
                                             nblk=plan2.n_mcu * plan2.bpm)
    a2, d2 = ke.value_pass_plain(*b2[:4], e2, o2, bpm=plan2.bpm)
    d2 = ke.dc_restore_plain(d2, hv=plan2.hv, seg_mcus=plan2.seg_mcus)
    ref2 = kb.backend_plain(a2, d2, b2[3], kb.BackendGeometry.of(plan2), planar=False)
    torch.cuda.synchronize()
    check = {"main_ok": bool(ok), "host_index_ok": bool(hok),
             "main_equal_host_index": bool(torch.equal(px, hx)),
             "main_vs_plain": max_abs_err(px[:2], ref2), "plain_ok": bool(o2),
             "main_vs_host_decoder": host_decoder_err(px[0], batches[0][0]),
             "shape": list(px.shape), "host_index_scans_in_decode": len(scans)}
    del px, hx, ref2, a2, d2

    # timed end to end; each batch's pixels against the host-index route's
    walls, oks, equal, peak = [], [], [], 0
    for datas in batches[2:]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pxb, okb = dec.decode(datas)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        oks.append(bool(okb))
        equal.append(bool(torch.equal(pxb, hidx.decode(datas)[0])))
        del pxb
    rows, misses = [], []
    for datas in batches[2:]:
        _px, okb, ms, r = sync_stages(dec, datas)
        rows.append(ms)
        misses.append(r)
        oks.append(okb)
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    # damaged streams in batch 0: ok False, or a refusal in prep; where the
    # damage leaves a stream that parses to its end (ok True), the pixels
    # must be the host-index route's, with its ok True too, and differ from
    # the clean decode's
    damaged = {}
    good = batches[0]
    clean = hidx.decode(good)[0]
    for name, bad in (("invalid_codes", inject_invalid_codes(good[0])),
                      ("truncated_10", truncate_scan(good[0], 10)),
                      ("flipped", flip_bytes(good[0]))):
        datas = [bad] + good[1:]
        try:
            pxd, okd = dec.decode(datas)
        except ZpixError as exc:
            damaged[name] = f"prep_raised:{type(exc).__name__}"
            continue
        if not bool(okd):
            damaged[name] = "ok_false"
            continue
        hpx, hok = hidx.decode(datas)
        same = bool(hok) and bool(torch.equal(pxd, hpx)) and not torch.equal(pxd[0], clean[0])
        damaged[name] = "ok_true_parses_as_host_index" if same else "ok_true"
    del clean
    return {"kernel_checks": checks, "kernel_checks_seconds": checks_s, "check": check,
            "launches": launches, "misses_main": main_misses, "misses_timed": misses,
            "host_syncs_per_decode": 0,
            "e2e_ms_per_batch": [w * 1e3 for w in walls],
            "e2e_mpix_per_s": mpix / float(np.mean(walls)),
            "device_mpix_per_s": mpix / (mean["device_total"] / 1e3),
            "device_busy_share": mean["device_total"] / (float(np.mean(walls)) * 1e3),
            "stage_ms_mean": mean, "peak_mem_bytes": peak,
            "all_ok": all(oks), "equal_host_index_per_batch": equal, "damaged": damaged}


def sync_entry(batch, hplan, hac, sy, by_path) -> dict:
    """K19's row of the kernels line: one sync_ends call on the restart-free
    batch at 32-byte chunks (the decoder's default); the bound from the
    stream read once, an int32 end written a
    block and OPS_K1_SYMBOL a symbol; the chain bounds of the longest chunk
    and sync chunk, a pass each (each block's symbols counted in the chunk
    where the block ends)."""
    from zpix_tpu_torch import SyncJpegDecoder, prep_batch_sync
    from zpix_tpu_torch.ops import sync as ksync

    plan = prep_batch_sync(batch)
    b = SyncJpegDecoder().upload(plan)
    kw = dict(chunk_bytes=plan.chunk_bytes, n_chunks=plan.n_chunks, bpm=plan.bpm,
              nblk=plan.n_mcu * plan.bpm)
    ms = cuda_ms(lambda: ksync.sync_ends(b[0], b[1], b[4], b[3], **kw), 20)
    plain_ms = cuda_ms(lambda: ksync.sync_ends_plain(b[0], b[1], b[4], b[3], **kw), 1)
    syms = block_symbols(hac).cpu().numpy().reshape(len(batch), -1)
    nbytes = int((plan.img_bit_end - plan.img_bit_start).sum()) // 8 + 4 * syms.size
    nops = OPS_K1_SYMBOL * int(syms.sum())
    longest = {}
    for name, cb in (("chunk", plan.chunk_bytes),
                     ("sync_chunk", plan.chunk_bytes * ksync.sync_factor(plan.chunk_bytes))):
        idx = (hplan.ends.astype(np.int64) - 1 - hplan.seg_bit_pos[:, None]) // (8 * cb)
        longest[name] = max(int(np.bincount(i, weights=w).max()) for i, w in zip(idx, syms))
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    kc = {k: v for k, v in sy["kernel_checks"].items() if k.startswith("chunk")}
    return {
        "name": "sync_decode", "route": "cuda", "source": KERNELS["sync_decode"][0],
        "replaces": KERNELS["sync_decode"][1], "launches": sy["launches"]["sync_decode"],
        "launches_by_path": by_path, "max_abs_err": max(v["max_abs_err"] for v in kc.values()),
        "matches_plain": all(v["max_abs_err"] == 0 for v in kc.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bound_bytes": nbytes,
        "bound_int32_ops": nops, "library_ms": None,
        "library_note": "no single PyTorch call decodes Huffman",
        "chain_bound_ms": longest["chunk"] * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3,
        "sync_chunk_chain_bound_ms": longest["sync_chunk"] * CHAIN_CYCLES_PER_SYMBOL
        / BOOST_HZ * 1e3,
        "longest_chunk_symbols": longest, "symbols": int(syms.sum()),
        "misses": sy["misses_main"], "chunk_bytes": plan.chunk_bytes,
        "sync_chunk_bytes": plan.chunk_bytes * ksync.sync_factor(plan.chunk_bytes)}


def sync_check(sy) -> None:
    """SystemExit unless the sync phase's checks all held."""
    c, ln = sy["check"], sy["launches"]
    kc = {k: v for k, v in sy["kernel_checks"].items() if k.startswith("chunk")}
    if any(v["max_abs_err_vs_default"] for k, v in sy["kernel_checks"].items()
           if k.startswith("sync_bytes")):
        raise SystemExit("chip_smoke: K19's result depends on its sync chunk")
    fm = sy["kernel_checks"]["k19_forced_misses"]
    if fm["max_abs_err"] or fm["misses"] <= fm["default_misses"]:
        raise SystemExit("chip_smoke: K19 disagrees with its plain version where misses are forced")
    if any(v["max_abs_err"] for v in kc.values()) or not all(
            v["ok"] and v["plain_ok"] and v["ends_equal_host_index_scan"] for v in kc.values()):
        raise SystemExit("chip_smoke: K19 disagrees with its plain version")
    if (min(ln["sync_decode"], ln["value_pass"], ln["dc_restore"], ln["backend"]) == 0
            or ln["index_pass"] or c["host_index_scans_in_decode"]):
        raise SystemExit("chip_smoke: the sync route skipped a kernel or scanned on the host")
    if (not (c["main_ok"] and c["host_index_ok"] and c["main_equal_host_index"] and c["plain_ok"])
            or c["main_vs_plain"] or c["main_vs_host_decoder"]
            or c["shape"] != [BATCH, SIZE, SIZE, 3]
            or not sy["all_ok"] or not all(sy["equal_host_index_per_batch"])):
        raise SystemExit("chip_smoke: the sync route's output is wrong")
    if "ok_true" in sy["damaged"].values():
        raise SystemExit("chip_smoke: a damaged stream passed the sync route")


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
                "band_positions": 0, "sectors": 0} for k in PROG_KINDS}
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
        # 32-byte sectors (8 words of a 64-word row) the scan changed
        w["sectors"] += sum(int((a != b).view(-1, 8, 8).any(-1).sum())
                            for a, b in zip(grids, before))
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


REFINE_CASES = (  # name, width, height, quality, sampling, copies
    ("q90", SIZE, SIZE, 90, "420", BATCH), ("q25", SIZE, SIZE, 25, "420", BATCH),
    ("444", SIZE, SIZE, QUALITY, "444", 4), ("gray", SIZE, SIZE, QUALITY, "gray", 4),
    ("crop_999x997", 999, 997, QUALITY, "420", 4))
DAMAGE_SEEDS = range(6)
# K8 across many tiles: name, width, height, sampling, copies (the main
# batch, q90, q25, 4:4:4, gray and the 999 x 997 crop run above)
FIRST_CASES = (("420_batch1", SIZE, SIZE, "420", 1), ("422", SIZE, SIZE, "422", 4),
               ("420_63_mcus", 1000, SIZE, "420", 4))


def make_prog_image(w: int, h: int, quality: int, mode: str, seed: int) -> bytes:
    """The bench's content (make_bench_jpeg) as a progressive JPEG of any
    size, quality and sampling ("420", "422", "444", "gray")."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    x = np.linspace(0, 20, max(w, h))
    base = (128 + 100 * np.sin(x[None, :w] * np.cos(x[:h, None]) + seed)).astype(np.uint8)
    noise = rng.randint(0, 24, (h, w)).astype(np.uint8)
    buf = BytesIO()
    if mode == "gray":
        Image.fromarray(base ^ noise, "L").save(buf, format="JPEG", quality=quality,
                                                progressive=True)
    else:
        rgb = np.stack([base ^ noise, base[::-1], base // 2 + 64], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality, progressive=True,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode])
    return buf.getvalue()


def prog_refine_checks(dec, data) -> dict:
    """K10's edges (K8, K9 and K11 on the way), each kernel against its
    plain version scan by scan, store and ok: REFINE_CASES (q90 and q25
    at the bench's batch, 4:4:4, gray, a crop whose width is not a
    multiple of 8), 2 copies of ``data`` with 6 random bytes written into
    every scan after the host walk (DAMAGE_SEEDS), and each refinement
    scan's buffer cut at 24 places over its data (reads stop on the cap,
    inside grouped correction-bit reads among them) -> {case: max_abs_err,
    "<case>_ok": ok after the scans, "cut_flagged": cuts that cleared ok}."""
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    out = {}
    for name, w, h, q, mode, n in REFINE_CASES:
        prep = dec.prep([make_prog_image(w, h, q, mode, 2000 + q)] * n)
        _, ok, errs, _, _ = prog_scan_checks(prep, dec.upload(prep))
        out[name] = max(errs.values())
        out[f"{name}_ok"] = int(ok)
    prep2 = dec.prep([data] * 2)
    for seed in DAMAGE_SEEDS:
        rng = np.random.default_rng(seed)
        scans = []
        for sc in prep2.scans:
            flat = sc.stream.copy().reshape(-1)
            at = rng.integers(0, flat.shape[0], 6)
            flat[at] = rng.integers(0, 256, 6, dtype=np.uint8)
            scans.append(dataclasses.replace(sc, stream=flat.reshape(sc.stream.shape)))
        dprep = dataclasses.replace(prep2, scans=scans)
        _, _, errs, _, _ = prog_scan_checks(dprep, dec.upload(dprep))
        out[f"damaged_{seed}"] = max(errs.values())
    bufs = dec.upload(prep2)
    grids, ok = po.new_store(prep2, bufs[1].device)
    out["cut"], out["cut_flagged"] = 0, 0
    for sc, t in zip(prep2.scans, bufs[0]):
        if sc.kind == "ac_refine":
            c = sc.comps[0]
            kw = dict(valid=po.valid_grid(prep2, c), ss=sc.ss, se=sc.se, al=sc.al)
            lo = int(sc.starts.min()) // 8
            hi = min(int(sc.ends.max()) // 8 + 9, t["stream"].shape[0])
            for cap in np.linspace(max(lo, 5), hi, 24).astype(int):
                args = (t["stream"][:cap], t["starts"], t["ends"], t["flags"], t["tables"])
                got, want = grids[c].clone(), grids[c].clone()
                ok_k, ok_p = torch.ones_like(ok), torch.ones_like(ok)
                kp.ac_refine(*args, ok_k, got, **kw)
                kp.ac_refine_plain(*args, ok_p, want, **kw)
                out["cut"] = max(out["cut"], max_abs_err(got, want), max_abs_err(ok_k, ok_p))
                out["cut_flagged"] += int(ok_k) == 0
        po.apply_scan(po.SCAN_KERNELS[sc.kind], sc, t, grids, prep2, ok)
    torch.cuda.synchronize()
    return out


def prog_cases():
    """tests/_torch_prog.py (K11's cases and its algorithm in numpy; it
    imports nothing of the JAX package), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_torch_prog.py")
    spec = importlib.util.spec_from_file_location("_torch_prog", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# K11's cases at chip size: interleaved 4:4:4, 4:2:2, 4:2:0 and 4:1:1,
# single-component scans with partial MCUs, all and no bits set, rows
# wider than their bits (the case list of tests/_torch_prog.py), on an MCU
# grid of 67 x 41 (block counts no multiple of 8 or 32, rows no multiple
# of 4 bytes), 16 images, the rows at an odd address; 4:2:0 at every Al
# of 0-13.
K11_GRID = dict(mxx=67, myy=41, batch=BATCH)
# K11 on the bench batch's one DC refinement scan (PERF.md, §6), written
# before the design's first run: 0.0191 ms before it
K11_PREDICTION_MS = (0.006, 0.010)


def k11_edge_checks(dev) -> dict:
    """K11 against its plain version on each case, twice (a second launch
    on fresh grids) -> {case: max_abs_err, or 1 where a call did not take
    one launch}."""
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import progressive as kp

    cases = prog_cases()
    runs = [(c, None) for c in cases.K11_CASES] + [("420", al) for al in range(14)]
    out = {}
    for case, al0 in runs:
        rows, grids, hv, valid, al = cases.k11_case(case, 17, al=al0, **K11_GRID)
        want = [torch.from_numpy(g.copy()).to(dev) for g in grids]
        flat = torch.zeros(rows.size + 1, dtype=torch.uint8, device=dev)
        rows_d = flat[1:].view(rows.shape)
        rows_d.copy_(torch.from_numpy(rows))
        kp.dc_refine_plain(rows_d, want, hv=hv, valid=valid, al=al)
        err = 0
        for _ in range(2):
            got = [torch.from_numpy(g).to(dev) for g in grids]
            before = runtime.LAUNCHES["dc_refine"]
            kp.dc_refine(rows_d, got, hv=hv, valid=valid, al=al)
            err = max(err, int(runtime.LAUNCHES["dc_refine"] != before + 1),
                      *(max_abs_err(g, w) for g, w in zip(got, want)))
        out[case if al0 is None else f"{case}_al{al}"] = err
    return out


def prog_first_checks(dec, prep, bufs) -> dict:
    """K8's and K9's edges, each kernel against its plain version (store
    and ok): FIRST_CASES scan by scan; the main batch's DC-first stream cut
    at 12 places (blocks past the cap store diff 0); each AC-first scan of
    the main batch on a store of random values in its band and on one a
    word off 16-byte alignment -> {case: max_abs_err}, "dc_cut_flagged":
    cuts that cleared ok."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG
    from zpix_tpu_torch.ops import progressive as kp
    from zpix_tpu_torch.parallel import progressive_onchip as po

    out = {}
    for name, w, h, mode, n in FIRST_CASES:
        p = dec.prep([make_prog_image(w, h, QUALITY, mode, 3000 + n)] * n)
        _, ok, errs, _, _ = prog_scan_checks(p, dec.upload(p))
        out[name] = max(errs.values())
        out[f"{name}_ok"] = int(ok)
    dev = bufs[1].device
    gen = torch.Generator(device=dev).manual_seed(5)
    unzig = torch.as_tensor(UNZIG, device=dev)
    out["dc_cut"], out["dc_cut_flagged"] = 0, 0
    out["ac_band_store"], out["ac_unaligned"] = 0, 0
    for sc, t in zip(prep.scans, bufs[0]):
        if sc.kind == "dc_first":
            store, _ = po.new_store(prep, dev)
            grids = [store[c] for c in sc.comps]
            kw = dict(hv=[prep.hv[c] for c in sc.comps], valid=po.valid_grid(prep, sc.comps[0]),
                      al=sc.al)
            for cap in np.linspace(16, t["stream"].shape[0], 12).astype(int):
                args = (t["stream"][:cap], t["starts"], t["ends"], t["tables"])
                got, want = [g.clone() for g in grids], [g.clone() for g in grids]
                ok_k, ok_p = torch.ones(1, dtype=torch.int32, device=dev), torch.ones(
                    1, dtype=torch.int32, device=dev)
                kp.dc_first(*args, ok_k, got, **kw)
                kp.dc_first_plain(*args, ok_p, want, **kw)
                out["dc_cut"] = max(out["dc_cut"], max_abs_err(ok_k, ok_p),
                                    *(max_abs_err(a, b) for a, b in zip(got, want)))
                out["dc_cut_flagged"] += int(ok_k) == 0
            del store, grids, got, want
        if sc.kind != "ac_first":
            continue
        c = sc.comps[0]
        shape = (prep.batch, prep.myy * prep.hv[c][1], prep.mxx * prep.hv[c][0], 64)
        band = torch.zeros(64, dtype=torch.bool, device=dev)
        band[unzig[sc.ss : sc.se + 1].long()] = True
        store = torch.randint(-(1 << 24), 1 << 24, shape, generator=gen, device=dev,
                              dtype=torch.int32) * band.to(torch.int32)
        kw = dict(valid=po.valid_grid(prep, c), ss=sc.ss, se=sc.se, al=sc.al)
        args = (t["stream"], t["starts"], t["ends"], t["flags"], t["tables"])
        want, ok_p = store.clone(), torch.ones(1, dtype=torch.int32, device=dev)
        kp.ac_first_plain(*args, ok_p, want, **kw)
        for key, off in (("ac_band_store", 0), ("ac_unaligned", 1)):
            flat = torch.empty(store.numel() + off, dtype=torch.int32, device=dev)
            got = flat[off:].view(shape)
            got.copy_(store)
            ok_k = torch.ones(1, dtype=torch.int32, device=dev)
            kp.ac_first(*args, ok_k, got, **kw)
            out[key] = max(out[key], max_abs_err(got, want), max_abs_err(ok_k, ok_p))
            del flat, got
        del store, want
    torch.cuda.synchronize()
    return out


def prog_stages(dec, datas, plain=None):
    """One 4:2:0 batch through OnchipProgressiveDecoder's stages -> (pixels,
    ok, {stage: ms}): parse and index walks (host clock), then CUDA events
    around H2D, the store, each scan (summed by kind) and K6.  ``plain``
    (prog_plain()) takes the plain versions, K6's too."""
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
    refine = prog_refine_checks(dec, batches[0][0])
    errs["ac_refine"] = max(errs["ac_refine"], *(v for k, v in refine.items()
                                                 if not k.endswith(("_ok", "_flagged"))))
    first = prog_first_checks(dec, prep, bufs)
    k11_edges = k11_edge_checks(dev)
    errs["dc_refine"] = max(errs["dc_refine"], *k11_edges.values())
    errs["dc_first"] = max(errs["dc_first"], first["dc_cut"],
                           *(first[n] for n, *_ in FIRST_CASES))
    errs["ac_first"] = max(errs["ac_first"], first["ac_band_store"], first["ac_unaligned"],
                           *(first[n] for n, *_ in FIRST_CASES))
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
    check = {"max_abs_err": errs, "mixed_batch": mixed, "refine_edges": refine,
             "first_edges": first, "k11_edges": k11_edges,
             "kernels_ok": bool(ok_k),
             "main_ok": bool(ok),
             "main_vs_plain": max_abs_err(px[:2], ref2), "plain_ok": ok2,
             "main_vs_host_decoder": host_decoder_err(px[0], batches[0][0]),
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
    # the store's scattered rows: K8 writes one 32-byte sector a block (row
    # 0), K9 reads and writes each sector it changes
    entries["dc_first"]["sector_bound_ms"] = 32 * wk["dc_first"]["lanes"] / HBM_BYTES_PER_S * 1e3
    entries["ac_first"]["sector_bound_ms"] = (64 * wk["ac_first"]["sectors"]
                                              / HBM_BYTES_PER_S * 1e3)
    # K11 reads and writes the sector of each block whose bit is set
    entries["dc_refine"]["sector_bound_ms"] = (64 * wk["dc_refine"]["changed"]
                                               / HBM_BYTES_PER_S * 1e3)
    entries["dc_refine"]["prediction_ms"] = K11_PREDICTION_MS
    entries["dc_refine"]["library_note"] = ("no single PyTorch call unpacks the bits and ORs "
                                            "them into scattered rows")
    entries["ac_refine"]["restore_ms_taken_off"] = restore_ms
    entries["component_planes_int32"] = {
        "ms": cuda_ms(lambda: kp6.component_planes(grids, quants, **kw6), 20),
        "plain_ms": cuda_ms(lambda: kp6.component_planes_plain(grids, quants, **kw6), 1),
        "bytes": 256 * nblk_all + 4 * 64 * 3 * BATCH + px6.numel(),
        "ops": OPS_K4_BLOCK * nblk_all + OPS_K4_PIXEL * BATCH * SIZE * SIZE
        + OPS_K4_CHROMA * 64 * BATCH * prep.mxx * prep.myy,
        "max_abs_err": errs["component_planes_int32"]}
    del tg, refine_inputs
    return summary, entries, batches


# --------------------------------- BatchJpegDecoder's Python front-end (K7, K6)

# stream kinds the native front-end refuses, each a batch of 16 distinct
# 1024^2 images: Pillow's RGB-colourspace 4:4:4 and Adobe CMYK 4:4:4, the
# tests' writer's YCCK {2x2, 1x1, 1x1, 2x2} and one-scan-a-component 4:2:0
# (random coefficients, PY_DENSITY of the AC nonzero), Pillow's progressive
PY_KINDS = ("rgb_444", "cmyk_444", "ycck_420", "multi_scan_420", "progressive_420")
PY_BATCHES = 3  # a kind: batch 0 checked image by image, all three timed
PY_DENSITY = 0.05
PY_ARMS = {"rgb_444": "rgb", "cmyk_444": "cmyk", "ycck_420": "ycck"}  # K6 arms new from bytes


def make_py_image(kind: str, seed: int, size: int) -> bytes:
    """One size x size image of a Python front-end kind (a process pool's
    task)."""
    from PIL import Image

    if kind == "progressive_420":
        return make_bench_jpeg(size, QUALITY, seed, None, progressive=True)
    if kind in ("rgb_444", "cmyk_444"):
        base = Image.open(BytesIO(make_bench_jpeg(size, 95, seed, None))).convert("RGB")
        buf = BytesIO()
        if kind == "cmyk_444":
            base.convert("CMYK").save(buf, format="JPEG", quality=QUALITY)
            return buf.getvalue()
        base.save(buf, format="JPEG", quality=QUALITY, subsampling=0)
        return jpeg_writer().as_rgb_stream(buf.getvalue())
    w = jpeg_writer()
    if kind == "ycck_420":
        return w.synth_ratio_jpeg(w.QUAD, size, size, seed, adobe=2, density=PY_DENSITY)
    return w.synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), size, size, seed, scans="separate",
                              density=PY_DENSITY)


def make_py_content() -> dict:
    """kind -> PY_BATCHES batches, made on a process pool (spawned: the
    parent holds threads and the card; the tasks are numpy, Pillow and
    Python)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = [(k, 5000 + 100 * i + BATCH * b + j, SIZE) for i, k in enumerate(PY_KINDS)
            for b in range(PY_BATCHES) for j in range(BATCH)]
    with ProcessPoolExecutor(os.cpu_count() or 2,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        images = iter(list(ex.map(make_py_image, *zip(*jobs))))
    return {k: [[next(images) for _ in range(BATCH)] for _ in range(PY_BATCHES)]
            for k in PY_KINDS}


def host_decoder_err(image, data: bytes) -> int:
    """max_abs_err of one decoded image (a [H, W] or [H, W, C] tensor)
    against the port's host decoder on its bytes."""
    want = jpeg_writer().port_host_pixels(data)
    return max_abs_err(image.cpu(), torch.from_numpy(np.ascontiguousarray(want)))


def host_outcome(fn):
    """fn()'s exception as (type, message), or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 -- the comparison is the point
        return [type(exc).__name__, str(exc)]
    return None


def front_end_serial(datas) -> dict:
    """The Python front-end on one thread, its two halves apart: the host
    decoder's scans (parse_coefficients) and the packing (pack_sparse and
    the flat buffer) -> ms."""
    from zpix_tpu_torch.parallel import batch as pb

    t0 = time.perf_counter()
    fes = [pb.parse_coefficients(d) for d in datas]
    t1 = time.perf_counter()
    parts = [(fe, [pb.pack_sparse(c) for c in fe.coeffs]) for fe in fes]
    pb.packed_from_front_ends(parts, pin=True)
    t2 = time.perf_counter()
    return {"front_end_1_thread_scan": (t1 - t0) * 1e3, "front_end_1_thread_pack": (t2 - t1) * 1e3,
            "front_end_1_thread": (t2 - t0) * 1e3}


def python_front_end_phase(dev) -> tuple:
    """BatchJpegDecoder on the streams its native front-end refuses: one
    decode of each kind with launches counted, every image of batch 0
    against the port's host decoder, K7 and K6 against their plain versions
    on each kind's full batch, K6 timed on its rgb, ycck and cmyk arms with
    bounds, each kind timed end to end and by stage (front-end on 1 and N
    threads, H2D, K7, K6), the batches through DecodePipeline, and
    OnchipProgressiveDecoder.decode_verified on a corrupt batch and with ok
    forced False.  -> (summary, {arm: K6 entry}, K7 entry, the last CMYK
    4:4:4 batch)"""
    from zpix_tpu_torch import BatchJpegDecoder, OnchipProgressiveDecoder, runtime
    from zpix_tpu_torch.ops import planes as kp
    from zpix_tpu_torch.ops import sparse as ks
    from zpix_tpu_torch.parallel import batch as pb
    from zpix_tpu_torch.parallel.pipeline import DecodePipeline
    from zpix_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    content = make_py_content()
    content_s = time.perf_counter() - t0
    dec = BatchJpegDecoder()
    for k in PY_KINDS:  # warm: worker threads, pinned pool
        dec.decode(content[k][1])
    torch.cuda.synchronize()
    refused0 = metrics.counters.get("jpeg_batch.native_refused", 0)
    python0 = metrics.counters.get("jpeg_batch.python_front_end", 0)
    runtime.reset_launches()
    outs = {k: dec.decode(content[k][0]) for k in PY_KINDS}
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    python_images = metrics.counters.get("jpeg_batch.python_front_end", 0) - python0

    # every image of batch 0 against the port's host decoder
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        host = {k: list(ex.map(lambda i, k=k: host_decoder_err(outs[k][i], content[k][0][i]),
                               range(BATCH))) for k in PY_KINDS}
    host_s = time.perf_counter() - t0
    shapes = {k: list(v.shape) for k, v in outs.items()}
    del outs

    # K7 and K6 against their plain versions on each kind's full batch;
    # K6 timed on the arms new from bytes
    checks, arms, k7 = {}, {}, {}
    for k in PY_KINDS:
        packed = dec.prep(content[k][0])
        buf = dec.upload(packed)
        comps = [ks.SparseComponent(pb.carve(buf, packed.layout, "bm", c, BATCH),
                                    pb.carve(buf, packed.layout, "val", c, BATCH), bv, bh, pm)
                 for c, ((bv, bh), pm) in enumerate(zip(packed.dims, packed.perms))]
        grids = ks.unpack_components(comps)
        quants = [pb.carve(buf, packed.layout, "q", c, BATCH) for c in range(len(packed.hv))]
        kw = dict(color=packed.color, height=SIZE, width=SIZE, ratio=packed.ratio,
                  sub=packed.sub)
        px = pb.decode_batch_planes(grids, quants, **kw)
        if packed.color == "gray":
            factors = [(1, 1)]
        elif packed.color == "cmyk":
            factors = [(2, 2) if x else (1, 1) for x in packed.sub]
        else:
            factors = [(1, 1)] + [pb.RATIO_FACTORS[packed.ratio]] * 2 + [(1, 1)] * (
                len(packed.hv) - 3)
        plain_kw = dict(color=packed.color, height=SIZE, width=SIZE, factors=factors)
        checks[k] = {
            "unpack_sparse": max(max_abs_err(g, w) for g, w in zip(
                grids, ks.unpack_components_plain(comps))),
            "component_planes": max_abs_err(px, kp.component_planes_plain(grids, quants,
                                                                          **plain_kw)),
            "color": packed.color, "hv": list(packed.hv), "sub": packed.sub,
            "value_caps": [int(n) // 2 for kind, _, _, n in packed.layout if kind == "val"],
            "nnz_max": packed.nnz.max(0).tolist(), "buffer_bytes": int(buf.numel())}
        blocks = BATCH * sum(bv * bh for bv, bh in packed.dims)
        k7[k] = with_bound({
            "ms": cuda_ms(lambda: ks.unpack_components(comps), 20),
            "plain_ms": cuda_ms(lambda: ks.unpack_components_plain(comps), 1),
            "bytes": (8 + 128) * blocks + 2 * int(packed.nnz.sum()),
            "ops": OPS_K7_BLOCK * blocks, "max_abs_err": checks[k]["unpack_sparse"]})
        if k in PY_ARMS:
            n_mcu = packed.mxx * packed.myy * BATCH
            arms[PY_ARMS[k]] = with_bound({
                "kind": k, "hv": list(packed.hv),
                "ms": cuda_ms(lambda: pb.decode_batch_planes(grids, quants, **kw), 20),
                "plain_ms": cuda_ms(lambda: kp.component_planes_plain(grids, quants,
                                                                      **plain_kw), 1),
                "bytes": 128 * blocks + 256 * len(packed.hv) * BATCH + px.numel(),
                "ops": OPS_K4_BLOCK * blocks + OPS_K4_PIXEL * BATCH * SIZE * SIZE
                + (OPS_K4_CHROMA * 64 * n_mcu if packed.color != "cmyk" else 0),
                "max_abs_err": checks[k]["component_planes"]})
        del grids, px, buf, comps
    torch.cuda.synchronize()

    # timed end to end, then by stage (native_stages reads any Packed)
    routes = {}
    for k in PY_KINDS:
        walls, peak, mean, _ = timed_decodes(
            dec.decode, content[k], stages=lambda d: native_stages(dec, d, dev))
        serial = [front_end_serial(d) for d in content[k]]
        mean["front_end_n_threads"] = mean.pop("host_parse")
        for key in serial[0]:
            mean[key] = float(np.mean([r[key] for r in serial]))
        routes[k] = route_summary(walls, peak, mean, {})
        routes[k]["bytes_per_image"] = float(np.mean([len(d) for d in content[k][0]]))

    # the batches through DecodePipeline: the same pixels
    serial_out = [dec.decode(b) for k in PY_KINDS for b in content[k][:2]]
    piped = list(DecodePipeline(dec, prefetch=2).map(
        [b for k in PY_KINDS for b in content[k][:2]]))
    pipeline_equal = all(torch.equal(a, b) for a, b in zip(serial_out, piped))
    del serial_out, piped

    # decode_verified: a batch whose image 0 the DC-first walk refuses (ok
    # False: the host decoder decodes the batch, and raises what it raises
    # on image 0), and a valid batch with ok forced False
    one = content["progressive_420"][0][0]
    pdec = OnchipProgressiveDecoder()
    bad = [corrupt_first_scan(one)] + [one] * (BATCH - 1)
    _, ok_bad = pdec.decode(bad)
    verified = {"corrupt_ok": bool(ok_bad),
                "corrupt_outcome": host_outcome(lambda: pdec.decode_verified(bad)),
                "host_decoder_outcome": host_outcome(
                    lambda: jpeg_writer().port_host_pixels(bad[0]))}
    px_p, ok_p = pdec.decode([one] * BATCH)
    run = pdec.run
    pdec.run = lambda prep, bufs=None: (run(prep, bufs)[0], torch.zeros(
        (), dtype=torch.bool, device=dev))
    forced = pdec.decode_verified([one] * BATCH)
    pdec.run = run
    verified.update(valid_ok=bool(ok_p), forced_shape=list(forced.shape),
                    forced_vs_card=max_abs_err(torch.from_numpy(forced), px_p.cpu()),
                    forced_vs_host_decoder=host_decoder_err(torch.from_numpy(forced[0]), one))
    pdec.close()
    del px_p, forced
    summary = {
        "kinds": list(PY_KINDS), "content_seconds": content_s, "launches": launches,
        "python_front_end_images": python_images,
        "native_refused": metrics.counters.get("jpeg_batch.native_refused", 0) - refused0,
        "host_decoder_max_abs_err": {k: max(v) for k, v in host.items()},
        "host_check_seconds": host_s, "shapes": shapes, "kernel_checks": checks,
        "routes": routes, "pipeline_equal_serial": pipeline_equal,
        "decode_verified": verified, "n_threads": os.cpu_count()}
    dec.close()
    return summary, arms, k7, content["cmyk_444"][-1]


def python_front_end_check(py) -> None:
    """SystemExit unless the python_front_end phase's checks all held."""
    n = len(PY_KINDS)
    if py["launches"]["unpack_sparse"] != n or py["launches"]["component_planes"] != n:
        raise SystemExit("chip_smoke: a Python front-end batch did not run K7 and K6 once each")
    if py["python_front_end_images"] != n * BATCH or py["native_refused"]:
        raise SystemExit("chip_smoke: a batch took the wrong front-end")
    if any(py["host_decoder_max_abs_err"].values()):
        raise SystemExit("chip_smoke: a Python front-end image differs from the host decoder")
    if any(c["unpack_sparse"] or c["component_planes"] for c in py["kernel_checks"].values()):
        raise SystemExit("chip_smoke: K7 or K6 disagrees with its plain version on a Python "
                         "front-end batch")
    v = py["decode_verified"]
    if (v["corrupt_ok"] or v["corrupt_outcome"] != v["host_decoder_outcome"]
            or not v["valid_ok"] or v["forced_vs_card"] or v["forced_vs_host_decoder"]
            or v["forced_shape"] != [BATCH, SIZE, SIZE, 3]):
        raise SystemExit("chip_smoke: decode_verified does not fall back to the host decoder")
    if not py["pipeline_equal_serial"]:
        raise SystemExit("chip_smoke: a pipelined Python front-end batch differs")


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
    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels

    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return np.stack(list(ex.map(decode_pixels, datas)))


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


def k13_hand_records(gen, dev):
    """Hand-built K13 records for BATCH images of SIZE^2: 65,536 counts
    0-62 an image, a third of them zero, the even images cut short of the
    pixel count (their tails take the fill) -> (cols, cnts, fill) on dev."""
    hcnt = gen.integers(0, 63, (BATCH, 65536)).astype(np.uint8)
    hcnt[gen.random(hcnt.shape) < 0.33] = 0  # zero counts inside the records
    hcnt[::2, 40000:] = 0  # even images fall short of the pixel count: fill
    return (dev_t(gen.integers(0, 2**32, hcnt.shape, dtype=np.uint64).astype(np.uint32), dev),
            dev_t(hcnt, dev),
            dev_t(gen.integers(0, 2**32, BATCH, dtype=np.uint64).astype(np.uint32), dev))


def k13_edge_checks(dev) -> dict:
    """K13 against its plain version on its edges -> {case: max_abs_err}:
    counts of 255 (totals 16 times the pixel count), one record covering
    a whole image, zero runs longer than a tile with rcap a multiple of
    neither the tile nor 16 (word loads) and an image all fill beside one
    half fill, and 64 x 1024^2 noise images' host records (a grid of tiles
    far beyond what the card holds at once)."""
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel import qoi_batch as tq

    gen = np.random.default_rng(13)

    def u32(*shape):
        return gen.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)

    shape = (BATCH, SIZE, SIZE)
    one = np.zeros((BATCH, 16), np.uint8)
    one[:, 0] = 255
    rcap = (1 << 20) + 100
    runs = gen.integers(0, 3, (BATCH, rcap)).astype(np.uint8)
    runs[:, 5000 : 5000 + 2 * max(kq.REC_TILES)] = 0
    runs[1] = 0
    runs[2] = gen.integers(0, 2, rcap)
    cases = {"counts_255": (u32(BATCH, 65536), np.full((BATCH, 65536), 255, np.uint8),
                            u32(BATCH), shape),
             "one_record": (u32(BATCH, 16), one, u32(BATCH), (BATCH, 15, 17)),
             "zero_runs": (u32(BATCH, rcap), runs, u32(BATCH), shape)}
    datas = [d for b in make_qoi_batches("noise", range(70, 74)) for d in b]
    plan = tq.prep_qoi_records(datas)
    cases["grid_64_noise"] = (plan.cols, plan.cnts, plan.fill, (len(datas), SIZE, SIZE))
    out = {}
    for name, (c, n, f, shp) in cases.items():
        rec = [dev_t(a, dev) for a in (c, n, f)]
        out[name] = max_abs_err(kq.sorted_expand(*rec, shape=shp),
                                kq.sorted_expand_plain(*rec, shape=shp))
        del rec
    torch.cuda.synchronize()
    return out


K12_WINDOW_CASES = ((5000, 64, 64), (32767, 32, 4))  # P, R, rows an image of BATCH


def k12_window_checks(gen, dev) -> dict:
    """K12's wide form on lanes wider than one of its windows (P = 5,000
    and 32,767, the int16 limit), against its plain version: spans that
    overlap, leave gaps or run past the lane, and the int16 extremes s =
    -32,768, e = 32,767 in slot 0 of every other lane -> {case:
    max_abs_err}."""
    from zpix_tpu_torch.ops import qoi as kq

    out = {}
    for P, R, rows in K12_WINDOW_CASES:
        lanes = BATCH * rows
        s = gen.integers(-3, P + 3, (lanes, R)).astype(np.int16)
        e = (s + gen.integers(-2, P // 2 + 2, (lanes, R))).astype(np.int16)
        s[::2, 0], e[::2, 0] = -32768, 32767
        w = [dev_t(gen.integers(0, 2**32, (lanes, R), dtype=np.uint64).astype(np.uint32), dev),
             dev_t(s, dev), dev_t(e, dev)]
        shape = (BATCH, rows, P)
        out[f"lane_wide_window_P{P}"] = max_abs_err(kq.lane_expand_wide(*w, P=P, shape=shape),
                                                    kq.lane_expand_wide_plain(*w, P=P,
                                                                              shape=shape))
        del w
    torch.cuda.synchronize()
    return out


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
    errs.update(k12_window_checks(gen, dev))
    rplan = tq.prep_qoi_records(batches["noise"][0])
    rec = [dev_t(a, dev) for a in (rplan.cols, rplan.cnts, rplan.fill)]
    errs["sorted_noise"] = max_abs_err(kq.sorted_expand(*rec, shape=shape),
                                       kq.sorted_expand_plain(*rec, shape=shape))
    layouts["records"] = qoi_plan_layout(rplan)
    hrec = k13_hand_records(gen, dev)
    errs["sorted_hand_built"] = max_abs_err(kq.sorted_expand(*hrec, shape=shape),
                                            kq.sorted_expand_plain(*hrec, shape=shape))
    del hrec
    srplan = tq.prep_qoi_records(batches["screen"][0])
    srec = [dev_t(a, dev) for a in (srplan.cols, srplan.cnts, srplan.fill)]
    errs["sorted_screen"] = max_abs_err(kq.sorted_expand(*srec, shape=shape),
                                        kq.sorted_expand_plain(*srec, shape=shape))
    errs.update({f"sorted_edge_{k}": v for k, v in k13_edge_checks(dev).items()})
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
        in_staging = dec._upload.staged([plan.p4])
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
            "ops": OPS_K13_RECORD * BATCH * rplan.rcap + OPS_K13_PIXEL * BATCH * npx,
            "launches": launches["sorted"]["qoi_sorted_expand"], "library_ms": lib_ms,
            "max_abs_err": max(v for k, v in errs.items() if k.startswith("sorted")),
            "layout": {"rcap": rplan.rcap, "records": total},
            "screen": with_bound({
                "ms": cuda_ms(lambda: kq.sorted_expand(*srec, shape=shape), 20),
                "rcap": srplan.rcap, "bytes": sum(x.numel() * x.element_size() for x in srec)
                + out_bytes, "ops": OPS_K13_RECORD * BATCH * srplan.rcap
                + OPS_K13_PIXEL * BATCH * npx})},
    }
    summary = {"content_seconds": content_s, "max_abs_err": errs, "layouts": layouts,
               "routes": routes, "damaged": damaged,
               "bytes_per_image": {c: float(np.mean([len(d) for d in batches[c][0]]))
                                   for c in QOI_PROFILES}}
    return summary, entries, launches, lane_decs


K14_GRID_BATCHES = 4  # 4 x 16 = 64 images of 1024^2: 32,768 tiles of K14


def k14_grid_beyond_resident(dev) -> bool:
    """K14 on 64 x 1024^2 images (noise and screen content in turns), a
    grid of tiles far larger than the card holds at once (the tiles take
    tickets, so every look-back waits on a tile already running): the ops
    equal the plain version's and each source stream's."""
    from zpix_tpu_torch.codecs.qoi.encode import Desc
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px

    d = Desc(SIZE, SIZE, 4, 0)
    datas = [s for i in range(K14_GRID_BATCHES) for s in make_qoi_batches(
        "screen" if i % 2 else "noise", [50 + i])[0]]
    px = torch.from_numpy(qoi_host_pixels(datas)).to(dev)
    packed = torch.stack([_pack_px(px[i], d, dev) for i in range(px.shape[0])])
    del px
    out, tot = kq.encode(packed)
    out_p, tot_p = kq.encode_plain(packed)
    same = bool(torch.equal(out, out_p) and torch.equal(tot, tot_p))
    del out_p, packed
    out, tot = out.cpu().numpy(), tot.cpu().numpy()
    return same and all(out[i, : tot[i]].tobytes() == s[14:-8] for i, s in enumerate(datas))


def qoi_encode_phase(dev, lane_decs):
    """encode_device_batch on the decoded batch 0 of each profile (a tensor
    on the card) and encode_device on one 3-channel image: every stream
    byte-identical to the host encoder, equal to the source stream and
    decoding back to its input; K14 against its plain version on both full
    batches and on 64 images (k14_grid_beyond_resident); 10 timed noise
    batches (pack, K14, download).  -> (summary, timing entry, launches of
    one encode_device_batch)"""
    from zpix_tpu_torch import encode_device, encode_device_batch, runtime
    from zpix_tpu_torch.codecs.qoi.decode import decode_pixels
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
        check[f"{c}_roundtrip"] = all(np.array_equal(decode_pixels(s), h)
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
    check["k14_grid_beyond_resident"] = k14_grid_beyond_resident(dev)

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


BMP_WIDTHS = (1, 3, 5)  # widths that end a row inside K18's 4-pixel group


def make_bmp(seed: int, bpp: int, info: int, top_down: bool, short: bool,
             width: int | None = None) -> bytes:
    """One random BMP of SIZE rows and ``width`` (1024) pixels from the
    port's numpy writer: indices and a palette of 2^bpp colours (fewer than
    half when ``short``, so indices pass its end) for 1-8 bpp, RGB or RGBA
    pixels for 24 and 32."""
    from zpix_tpu_torch.codecs.bmp.encode import encode

    rng = np.random.default_rng(seed)
    width = SIZE if width is None else width
    if bpp <= 8:
        n = max(1, (1 << bpp) // 2 - 1) if short else 1 << bpp
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, 1 << bpp, (SIZE, width), dtype=np.uint8)
        return encode(idx, bpp=bpp, info_len=info, top_down=top_down, palette=pal)
    pix = rng.integers(0, 256, (SIZE, width, 3 if bpp == 24 else 4), dtype=np.uint8)
    return encode(pix, bpp=bpp, info_len=info, top_down=top_down)


def make_bmp_batch(arm, s: int, width: int | None = None):
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        return list(ex.map(lambda j: make_bmp(s * BATCH + j, *arm, width=width), range(BATCH)))


def bmp_stages(dec, datas):
    """One batch through BatchBmpDecoder's stages -> (pixels, plain pixels
    on the same uploaded inputs, {stage: ms})."""
    from zpix_tpu_torch.ops.bmp import bmp_unpack, bmp_unpack_plain

    t0 = time.perf_counter()
    plan = dec.prep(datas)
    host_ms = (time.perf_counter() - t0) * 1e3
    width, _h, top_down, bpp, allow_alpha = plan[2]
    kw = dict(bpp=bpp, width=width, top_down=top_down, allow_alpha=allow_alpha)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    rows_d, pal_d = dec.upload(plan)
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
    host_errs = {}
    for i, arm in enumerate(arms):
        datas = make_bmp_batch(arm, 700 + i)
        px, ref, _ = bmp_stages(dec, datas)
        name = "{}bpp_{}_{}{}".format(arm[0], arm[1], "td" if arm[2] else "bu",
                                      "_short" if arm[3] else "")
        errs[name] = max_abs_err(px, ref)
        host_errs[name] = host_path_err(px, datas)
        del px, ref, datas
    # rows that end inside a 4-pixel group, every bit depth (32 with the
    # V5 alpha), at full batch; width 3 top-down
    for bpp in (1, 2, 4, 8, 24, 32):
        for w in BMP_WIDTHS:
            arm = (bpp, 124 if bpp == 32 else 40, w == 3, False)
            px, ref, _ = bmp_stages(dec, make_bmp_batch(arm, 800 + 10 * bpp + w, width=w))
            errs[f"{bpp}bpp_w{w}"] = max_abs_err(px, ref)
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
        main_host = host_path_err(px, bb[0])
        del px, ref
        walls, peak, mean, _ = timed_decodes(dec.decode, bb[2:], lambda d: bmp_stages(dec, d))
        equal, timed_host = [], []
        for d in bb[2:]:
            px, ref, _ = bmp_stages(dec, d)
            equal.append(bool(torch.equal(px, ref)))
            timed_host.append(host_path_err(px, d))
        del px, ref
        routes[k] = {"main_equal_plain": main_equal, "timed_equal_plain": equal,
                     "main_vs_host_path_images_0_1": main_host,
                     "timed_vs_host_path_images_0_1": timed_host,
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
    # 1 and 32 bpp (V5 alpha) beside them, with one decode's launches
    arms_timed = {}
    for k, arm in (("1bpp", (1, 40, False, False)), ("32bpp", (32, 124, False, False))):
        datas = make_bmp_batch(arm, 990)
        runtime.reset_launches()
        dec.decode(datas)
        torch.cuda.synchronize()
        n_launch = runtime.LAUNCHES["bmp_unpack"]
        ra, pa, (wa, _h, tda, bppa, aaa) = dec.prep(datas)
        rd, pd = dev_t(ra, dev), dev_t(pa, dev)
        kwa = dict(bpp=bppa, width=wa, top_down=tda, allow_alpha=aaa)
        errs[f"{k}_timed_inputs"] = max_abs_err(bmp_unpack(rd, pd, **kwa),
                                                bmp_unpack_plain(rd, pd, **kwa))
        arms_timed[f"arm_{k}"] = with_bound({
            "ms": cuda_ms(lambda: bmp_unpack(rd, pd, **kwa), 20),
            "plain_ms": cuda_ms(lambda: bmp_unpack_plain(rd, pd, **kwa), 1),
            "bytes": ra.nbytes + (pa.nbytes if bppa <= 8 else 0) + out_bytes,
            "ops": OPS_K18_PIXEL[bppa] * BATCH * SIZE * SIZE, "launches": n_launch})
        del rd, pd, datas
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
                 "launches": launches["24bpp"]["bmp_unpack"]}), **arms_timed}
    summary = {"arms_seconds": arms_s, "content_seconds": content_s, "max_abs_err": errs,
               "vs_host_path_images_0_1": host_errs, "routes": routes, "truncated": truncated}
    return summary, entry, launches["24bpp"], batches["24bpp"]


# ------------------------------------------------------ PNG slice (K15-K17)

PNG_FRONTS = {"host": {}, "defilter": {"device_defilter": True},
              "inflate": {"device_inflate": True}}
# The least operations of each function:
# - K15 a byte, by filter type: None 0, Sub and Up an add, Average two adds
#   and a shift, Paeth 14 (p, three differences and their absolutes, three
#   compares, two selects, the add);
# - K16: an add a token (the prefix sum of the lengths), a subtract a byte
#   (its source pointer);
# - K17: tc8 an OR a pixel (the alpha); p8 none beyond the gather.
OPS_K15_BYTE = (0, 1, 1, 3, 14)
OPS_K16_TOKEN, OPS_K16_BYTE, OPS_K17_PIXEL = 1, 1, 1
# Chain bound of K15: H + W - 1 dependent wavefront steps, each at least an
# L1 round trip for the previous step's bytes and a block barrier; taken as
# 40 cycles at the boost clock (an assumption, not a measurement).
CHAIN_CYCLES_PER_STEP = 40
# K15's boundary cases (rows; 4 images of this many pixels a row) and
# K16's hand-built token kinds (tests/_torch_png.py hand_tokens)
K15_EDGE_ROWS = (1, 31, 32, 33, 1025, 1500)
K15_EDGE_WIDTH = 97
K16_KINDS = ("rle", "overlap", "far", "far_edge")
# K15 on a grid larger than the card holds at once: images, rows, pixels
# a row (32 x 128 blocks of 128 threads; 132 SMs hold at most 16 each)
K15_GRID = (32, 16384, 301)


def png_writer():
    """tests/_torch_png.py, the tests' PNG writer (numpy and zlib; Pillow
    for the bench content), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_torch_png.py")
    spec = importlib.util.spec_from_file_location("_torch_png", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ADAM7_KINDS = ("tc8", "p8_trns")


def make_adam7_png(writer, j: int, kind: str):
    """Image j of an Adam7 batch -> (file, source RGBA8 [H, W, 4]): "tc8"
    the JAX bench's content, "p8_trns" its first channel as indices into a
    random palette with a random tRNS alpha."""
    if kind == "tc8":
        rgb = writer.bench_rgb(SIZE, 500 + j)
        data = writer.encode_png(rgb, "tc8", interlace=True, seed=j)
        return data, np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], -1)
    rng = np.random.default_rng(600 + j)
    idx = writer.bench_rgb(SIZE, 600 + j)[..., 0]
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    alpha = rng.integers(0, 256, 256, dtype=np.uint8)
    data = writer.encode_png(idx, "p8", palette=pal, trns=alpha.tobytes(), interlace=True,
                             seed=j)
    c, a = pal.astype(np.uint32), alpha.astype(np.uint32)[:, None]
    table = np.concatenate([(((c | c << 8) * a) // 0xFF) >> 8, a], 1).astype(np.uint8)
    return data, table[idx]  # the premultiplied NRGBA palette entry


def make_adam7_batches(writer, ex) -> dict:
    """{kind: (files, source RGBA8 [B, H, W, 4])} of both Adam7 batches,
    made on the thread pool ``ex``."""
    out = {}
    for kind in ADAM7_KINDS:
        made = list(ex.map(lambda j, k=kind: make_adam7_png(writer, j, k), range(BATCH)))
        out[kind] = ([m[0] for m in made], np.stack([m[1] for m in made]))
    return out


def make_png_content(writer):
    """-> (bench batches: batch s holds the JAX bench's PNGs of seeds
    s * BATCH + j; the Adam7 batches {name: (files, source RGBA8 [B, H, W,
    4])}), made on a thread pool."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        batches = [list(ex.map(lambda j, s=s: writer.make_bench_png(SIZE, s * BATCH + j),
                               range(BATCH))) for s in range(TIMED_BATCHES + 2)]
        interlaced = make_adam7_batches(writer, ex)
    return batches, interlaced


def png_stages(dec, datas):
    """One bench batch (non-interlaced) through BatchPngDecoder's own steps
    -> (pixels, {upload bytes}, {stage: ms}): ``parse`` (host walk with
    inflate or tokenize) and, on the default route, ``defilter`` (host
    clock); then CUDA events around ``upload`` and after each kernel that
    ``run`` queues (its ``on_kernel`` hook)."""
    t0 = time.perf_counter()
    plan = dec.parse(datas)
    t1 = time.perf_counter()
    ms = {"host_parse_inflate" if plan.route != "inflate" else "host_parse_tokenize":
          (t1 - t0) * 1e3}
    if plan.route == "host":
        dec.defilter(plan)
        ms["host_defilter"] = (time.perf_counter() - t1) * 1e3
    marks = []

    def mark(name, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    mark("start")
    bufs = dec.upload(plan)
    mark("h2d")
    px, bad = dec.run(plan, bufs, on_kernel=mark)
    torch.cuda.synchronize()
    if bad is not None and int(bad):
        raise SystemExit("chip_smoke: K15 flagged a filter type on the bench content")
    ms.update(dict.fromkeys(("h2d", "inflate_resolve", "adler32", "png_defilter", "png_expand"),
                            0.0))
    for (_n, a), (name, b) in zip(marks, marks[1:]):
        ms[name] += a.elapsed_time(b)
    ms["device_total"] = marks[0][1].elapsed_time(marks[-1][1])
    sizes = {"h2d_bytes": sum(a.nbytes for a in plan.parts)}
    if plan.route == "inflate":
        sizes["tokens_read_bytes"] = len(datas) * plan.nt * 9
        sizes["token_rows"] = {"nt": plan.nt, "cap": plan.main[0].shape[1]}
    return px, sizes, ms


PNG_KERNEL_TAGS = {"png_defilter": "k15", "inflate_resolve": "k16", "adler32": "k16_adler32",
                   "png_expand": "k17"}


class PngLaunchCheck:
    """BatchPngDecoder.run's ``on_kernel`` hook: every K15-K17 launch of a
    decode held against its plain version on the same inputs (the views of
    the upload that run passes, K16's output, each Adam7 pass and its
    placement on the canvas), the largest error a kernel under
    ``{k15,k16,k17}_{tag}``.  ``kept`` gets each kernel's first (args, kw,
    result), ``expands`` every K17 launch's (args, kw), for the timing
    entries."""

    def __init__(self, errs: dict, facts: dict, tag: str):
        self.errs, self.facts, self.tag, self.kept, self.expands = errs, facts, tag, {}, []

    def __call__(self, name, args, kw, res):
        from zpix_tpu_torch.ops.defilter import png_defilter_plain
        from zpix_tpu_torch.ops.inflate import adler32_plain, inflate_resolve_plain
        from zpix_tpu_torch.ops.png import png_expand_plain

        if name == "adler32":  # the sums, and each equal to its image's trailer
            flag = torch.zeros(1, dtype=torch.int32, device=args[0].device)
            err = max(max_abs_err(res, adler32_plain(args[0], args[1], flag)),
                      max_abs_err(res, args[1]), int(flag))
        elif name == "inflate_resolve":
            err = max_abs_err(res, inflate_resolve_plain(*args)[0])
        elif name == "png_defilter":
            flag = torch.zeros(1, dtype=torch.int32, device=args[0].device)
            err = max_abs_err(res, png_defilter_plain(*args, bpp=kw["bpp"], bad=flag))
            if kw["bad"] is not None:  # valid streams: never set
                err = max(err, max_abs_err(kw["bad"], flag))
        else:
            self.expands.append((args, kw))
            rows, width = args[0], kw["width"]
            got = res
            if kw.get("out") is not None:  # the pass's pixels, where K17 placed them
                xo, yo, xf, yf = kw["place"]
                got = res[:, yo : yo + rows.shape[1] * yf : yf, xo : xo + width * xf : xf]
            err = max_abs_err(got, png_expand_plain(*args, cd=kw["cd"], width=width))
        key = f"{PNG_KERNEL_TAGS[name]}_{self.tag}"
        self.errs[key] = max(self.errs.get(key, 0), err)
        self.kept.setdefault(name, (args, kw, res))


def png_kernel_checks(dev, writer, decs, batch, interlaced):
    """K15, K16 and K17 against their plain versions on the card at full
    batch: every launch of the bench batch's decode by each front-end and
    of both Adam7 batches' decode by ``device_inflate`` (PngLaunchCheck, at
    the shapes and strides the decoder gives them); K15 on random rows with
    random filter bytes 0-255 at every bpp; K16 against the host's inflate
    and on hand-built chains; K17 on every arm, keyed or not, a short
    palette, a width that is not a multiple of the pixels a byte, and
    placed as an Adam7 pass.  -> (max abs errors, {front: kept launches,
    adam7_{kind}: each pass's K17 (args, kw)}, facts)"""
    from zpix_tpu_torch.ops.defilter import BPPS, png_defilter, png_defilter_plain
    from zpix_tpu_torch.ops.inflate import TILES, inflate_resolve, inflate_resolve_plain
    from zpix_tpu_torch.ops.png import ARMS, png_expand, png_expand_plain, row_bytes

    errs, facts, kept = {}, {}, {}

    def zero():
        return torch.zeros(1, dtype=torch.int32, device=dev)

    def checked_run(dec, datas, tag):
        check = PngLaunchCheck(errs, facts, tag)
        plan = dec.prep(datas)
        bufs = dec.upload(plan)
        px, bad = dec.run(plan, bufs, on_kernel=check)
        torch.cuda.synchronize()
        if bad is not None and int(bad):
            raise SystemExit(f"chip_smoke: K15 flagged a filter type in {tag}")
        return px, check, bufs

    px, bufs = {}, {}
    for front, dec in decs.items():
        px[front], check, bufs[front] = checked_run(dec, batch, f"bench_{front}")
        kept[front] = check.kept
    # K16's bytes against the host's inflate, which the defilter route uploads
    errs["k16_bench_vs_host_inflate"] = max_abs_err(kept["inflate"]["inflate_resolve"][2],
                                                    bufs["defilter"][0])
    errs["k17_bench_routes_agree"] = max(max_abs_err(px["host"], px[f])
                                         for f in ("defilter", "inflate"))
    ft = kept["defilter"]["png_defilter"][0][1]
    facts["k15_bench_rows_by_type"] = torch.bincount(ft.reshape(-1).long(), minlength=5).tolist()
    for kind, (datas, src) in interlaced.items():
        got, check, _bufs = checked_run(decs["inflate"], datas, f"adam7_{kind}")
        errs[f"k17_adam7_{kind}_vs_source"] = max_abs_err(got, torch.from_numpy(src).to(dev))
        kept[f"adam7_{kind}"] = check.expands  # the seven passes' K17 launches
    del px, bufs

    gen = np.random.default_rng(5)
    for bpp in BPPS:
        s = torch.from_numpy(gen.integers(0, 256, (BATCH, SIZE, 1 + SIZE * bpp),
                                          dtype=np.uint8)).to(dev)
        bk, bp = zero(), zero()
        errs[f"k15_random_types_bpp{bpp}"] = max(
            max_abs_err(png_defilter(s[:, :, 1:], s[:, :, 0], bpp=bpp, bad=bk),
                        png_defilter_plain(s[:, :, 1:], s[:, :, 0], bpp=bpp, bad=bp)),
            max_abs_err(bk, bp), 1 - int(bk))
        del s
    # the band design's boundaries: 1, 31, 32, 33 rows (one band and the
    # first hand-off), 1,025 and 1,500 (33 and 47 bands: 9 and 12 blocks an
    # image), a random valid filter type a row, stream views of every row
    # alignment; then a grid of more blocks than the card holds at once
    for bpp in BPPS:
        for H in K15_EDGE_ROWS:
            s = torch.from_numpy(gen.integers(0, 256, (4, H, 1 + K15_EDGE_WIDTH * bpp),
                                              dtype=np.uint8)).to(dev)
            s[:, :, 0] %= 5
            errs[f"k15_edge_bpp{bpp}_h{H}"] = max_abs_err(
                png_defilter(s[:, :, 1:], s[:, :, 0], bpp=bpp),
                png_defilter_plain(s[:, :, 1:], s[:, :, 0], bpp=bpp))
            del s
    gb, gh, gw = K15_GRID
    s = torch.from_numpy(gen.integers(0, 256, (gb, gh, 1 + gw * 3), dtype=np.uint8)).to(dev)
    s[:, :, 0] %= 5
    errs["k15_grid_beyond_resident"] = max_abs_err(png_defilter(s[:, :, 1:], s[:, :, 0], bpp=3),
                                                   png_defilter_plain(s[:, :, 1:], s[:, :, 0],
                                                                      bpp=3))
    del s
    # the adler32 check on rows of odd length (every alignment) and 0xFF runs,
    # on a matching and a wrong trailer; then rows of no bytes and of a
    # span less or more one byte, and 70,000 one-byte images (more CTAs
    # than a grid's y holds), a wrong trailer in the last image only
    from zpix_tpu_torch.ops.inflate import ADLER_BAD, ADLER_SPAN, adler32_check, adler32_plain
    for tag, shape in (("random_rows", (BATCH, 3 * SIZE * SIZE + 7)), ("per0", (BATCH, 0)),
                       ("span_less_one", (BATCH, ADLER_SPAN - 1)),
                       ("span_more_one", (BATCH, ADLER_SPAN + 1)),
                       ("70000_images", (70_000, 1))):
        rows = torch.from_numpy(gen.integers(0, 256, shape, dtype=np.uint8))
        rows[1] = 0xFF
        rows = rows.to(dev)
        fk, fp = zero(), zero()
        want = adler32_plain(rows, torch.zeros(shape[0], dtype=torch.int32, device=dev), fp)
        got = adler32_check(rows, want, fk)
        clear = int(fk)
        off = want.clone()
        off[-1] ^= 1
        adler32_check(rows, off, fk)
        errs[f"k16_adler32_{tag}"] = max(max_abs_err(got, want), clear,
                                         abs(int(fk) - ADLER_BAD))
        del rows
    lens, per = kept["inflate"]["inflate_resolve"][0][0], kept["inflate"]["inflate_resolve"][0][3]
    facts["k16_bench_tokens"] = {"most": lens.shape[1],
                                 "mean": float((lens > 0).sum(1).double().mean())}
    # hand-built chains at full batch, every tile size (per is no multiple
    # of any): "rle" (every byte past the first tile rooted at byte 0, in
    # an earlier tile), "overlap" (copies straddling tile boundaries), "far"
    # (distance 32,768), "far_edge" (distance-32,768 copies starting on
    # every 8 KiB boundary), token counts that differ from image to image
    hand = writer.stack_tokens([writer.hand_tokens(gen, per, K16_KINDS[i % 4])
                                for i in range(BATCH)])
    hand = [torch.from_numpy(a).to(dev) for a in hand]
    want = inflate_resolve_plain(*hand, per)[0]
    for tile in TILES:
        errs[f"k16_hand_built_tile{tile}"] = max_abs_err(inflate_resolve(*hand, per, tile=tile),
                                                         want)
    del hand, want
    # per = T - 1, T, T + 1 for each tile size, the four kinds in one batch
    for tile in TILES:
        for off in (-1, 0, 1):
            small = writer.stack_tokens([writer.hand_tokens(gen, tile + off, k)
                                         for k in K16_KINDS])
            small = [torch.from_numpy(a).to(dev) for a in small]
            errs[f"k16_per_tile{tile}_{off:+d}"] = max_abs_err(
                inflate_resolve(*small, tile + off, tile=tile),
                inflate_resolve_plain(*small, tile + off)[0])
    # every arm at 16 x 1024 rows of width 1,021, not a multiple of 2, 4 or
    # 8 pixels a byte; placed at Adam7 pass 5's offsets and strides
    w = SIZE - 3
    pal = torch.from_numpy(gen.integers(0, 256, (BATCH, 256, 4), dtype=np.uint8)).to(dev)
    pal[:, 7:] = torch.tensor([0, 0, 0, 255], dtype=torch.uint8, device=dev)  # short palette
    canvas_p = torch.zeros(BATCH, 2 * SIZE, 2 * w, 4, dtype=torch.uint8, device=dev)
    rgen = torch.Generator(device=dev).manual_seed(5)
    for cd in ARMS:
        rows = torch.randint(0, 256, (BATCH, SIZE, row_bytes(cd, w)), generator=rgen,
                             dtype=torch.uint8, device=dev)
        keys = [None]
        if cd in ("g1", "g2", "g4", "g8", "g16", "tc8", "tc16"):
            first = rows[:, :1].cpu().numpy()
            keys.append(torch.from_numpy(writer.first_pixel_keys(first, cd)).to(dev))
        for key in keys:
            tag = f"k17_{cd}{'_keyed' if key is not None else ''}"
            errs[tag] = max_abs_err(png_expand(rows, pal, key, cd=cd, width=w),
                                    png_expand_plain(rows, pal, key, cd=cd, width=w))
            canvas_k = canvas_p.clone()
            png_expand(rows, pal, key, cd=cd, width=w, out=canvas_k, place=(1, 0, 2, 2))
            want = png_expand_plain(rows, pal, key, cd=cd, width=w, out=canvas_p.clone(),
                                    place=(1, 0, 2, 2))
            errs[tag + "_adam7_place"] = max_abs_err(canvas_k, want)
        del rows
    torch.cuda.synchronize()
    return errs, kept, facts


def k17_adam7_timing(passes) -> dict:
    """The seven K17 launches of an Adam7 decode, each timed alone on the
    rows, palette, key, canvas and placement the decoder gave it, with its
    bound (its rows and palette in, 4 bytes a pixel of the pass out) ->
    {"passes": [...], "ms_sum", "bound_ms_sum"}."""
    from zpix_tpu_torch.ops.png import png_expand

    rows_out = []
    for (rows, pal, key), kw in passes:
        B, h = rows.shape[:2]
        rows_out.append(with_bound({
            "ms": cuda_ms(lambda: png_expand(rows, pal, key, **kw), 20),
            "width": kw["width"], "rows": h, "place": list(kw["place"]),
            "bytes": rows.numel() + (pal.numel() if pal is not None else 0)
            + 4 * B * h * kw["width"], "ops": 0}))
    return {"passes": rows_out, "launches": len(rows_out),
            "ms_sum": sum(r["ms"] for r in rows_out),
            "bound_ms_sum": sum(r["bound_ms"] for r in rows_out)}


def png_phase(dev):
    """PNG: K15-K17 against their plain versions at full batch, then
    BatchPngDecoder by each front-end on 10 timed batches of the JAX bench's
    content (launches of one decode, stages, pixels against the other routes
    and Pillow), both Adam7 batches by every route against their source
    pixels, and the damaged streams by every route.  -> (summary, {kernel:
    timing entry}, {path: launches of one decode})"""
    from io import BytesIO

    from PIL import Image

    from zpix_tpu_torch import BatchPngDecoder, runtime
    from zpix_tpu_torch.errors import ZpixError
    from zpix_tpu_torch.ops.defilter import WARPS, png_defilter, png_defilter_plain
    from zpix_tpu_torch.ops.inflate import (TILE, TILES, adler32_check, adler32_plain,
                                            inflate_resolve, inflate_resolve_plain)
    from zpix_tpu_torch.ops.png import png_expand, png_expand_plain
    from zpix_tpu_torch.runtime import host

    writer = png_writer()
    t0 = time.perf_counter()
    batches, interlaced = make_png_content(writer)
    content_s = time.perf_counter() - t0
    decs = {f: BatchPngDecoder(**kw) for f, kw in PNG_FRONTS.items()}
    t0 = time.perf_counter()
    errs, kept, facts = png_kernel_checks(dev, writer, decs, batches[0], interlaced)
    checks_s = time.perf_counter() - t0

    # the routes: one decode with launches counted, then 10 timed batches;
    # every timed batch equal across the routes, images 0-1 equal Pillow's
    ref, routes, launches = {}, {}, {}

    host_errs = []

    def pillow_and_keep(datas, px):
        ref[id(datas)] = px
        host_errs.append(host_path_err(px, datas))
        pil = np.stack([np.asarray(Image.open(BytesIO(d)).convert("RGBA")) for d in datas[:2]])
        return bool(np.array_equal(px[:2].cpu().numpy(), pil))

    for front, dec in decs.items():
        dec.decode(batches[1])  # warm: pinned buffer, pool, token rows
        torch.cuda.synchronize()
        runtime.reset_launches()
        dec.decode(batches[0])
        torch.cuda.synchronize()
        launches[front] = dict(runtime.LAUNCHES)
        check = pillow_and_keep if front == "host" else (
            lambda datas, px: bool(torch.equal(px, ref[id(datas)])))
        walls, peak, mean, oks = timed_decodes(dec.decode, batches[2:],
                                               lambda d, dec=dec: png_stages(dec, d), check)
        _px, sizes, _ms = png_stages(dec, batches[2])
        key = "equal_pillow_images_0_1" if front == "host" else "equal_host_route"
        routes[front] = {key: oks, **sizes, **route_summary(walls, peak, mean, launches[front])}
    routes["host"]["vs_host_path_images_0_1"] = host_errs
    ref.clear()

    # Adam7: both batches by every route against the writer's source pixels
    adam7 = {}
    for kind, (datas, src) in interlaced.items():
        want = torch.from_numpy(src).to(dev)
        for front, dec in decs.items():
            runtime.reset_launches()
            px = dec.decode(datas)
            torch.cuda.synchronize()
            if kind == "tc8" and front == "host":
                launches["adam7"] = dict(runtime.LAUNCHES)
            adam7[f"{kind}_{front}_equal_source"] = bool(torch.equal(px, want))
            adam7[f"{kind}_{front}_equal_host_path_images_0_1"] = host_path_err(px, datas) == 0
        del want

    # damaged streams, each by every route: the error class and message
    rng = np.random.default_rng(8)
    pix = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    good = writer.encode_png(pix, "tc8")
    damaged = {}
    for damage in writer.DAMAGE:
        bad = writer.encode_png(pix, "tc8", damage=damage, filters=[0])
        for front, dec in decs.items():
            try:
                dec.decode([good, bad])
                damaged[f"{damage}_{front}"] = "no error"
            except ZpixError as exc:
                damaged[f"{damage}_{front}"] = f"{type(exc).__name__}: {exc}"
    for dec in decs.values():
        dec.close()

    # timing entries on the bench batch's launches of the main path (the
    # inputs run gave each kernel): K15 on the defilter route's stream
    # views, K16 on the inflate route's token-row views, K17's tc8 arm on
    # the default route's uploaded rows (library: one F.pad adding the
    # alpha); p8 beside it (library: the gather pal[b, idx])
    raw, ft = kept["defilter"]["png_defilter"][0]
    toks, per = kept["inflate"]["inflate_resolve"][0][:3], kept["inflate"]["inflate_resolve"][0][3]
    flat_k, trailers = kept["inflate"]["adler32"][0][:2]
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    nt = toks[0].shape[1]
    rows = kept["host"]["png_expand"][0][0]
    npx = BATCH * SIZE * SIZE
    ftc = facts["k15_bench_rows_by_type"]
    idx8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (BATCH, SIZE, SIZE), dtype=np.uint8)).to(dev)
    pal8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (BATCH, 256, 4), dtype=np.uint8)).to(dev)
    errs["k17_p8_timed_inputs"] = max_abs_err(png_expand(idx8, pal8, None, cd="p8", width=SIZE),
                                              png_expand_plain(idx8, pal8, None, cd="p8",
                                                               width=SIZE))
    bidx = torch.arange(BATCH, device=dev)[:, None, None]
    idx_long = idx8.long()
    tc8 = rows.view(BATCH, SIZE, SIZE, 3)
    # K16's tile sweep on the same inputs, each size checked against the
    # plain version
    k16_want = inflate_resolve_plain(*toks, per)[0]
    tile_sweep = {}
    for t in TILES:
        errs[f"k16_bench_tile{t}"] = max_abs_err(inflate_resolve(*toks, per, tile=t), k16_want)
        tile_sweep[t] = cuda_ms(lambda t=t: inflate_resolve(*toks, per, tile=t), 20)
    del k16_want
    adam7_ms = {kind: k17_adam7_timing(kept[f"adam7_{kind}"]) for kind in ADAM7_KINDS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    inflate_resolve(*toks, per)
    torch.cuda.synchronize()
    k16_peak = torch.cuda.max_memory_allocated() - held
    entries = {
        "png_defilter": {
            "ms": cuda_ms(lambda: png_defilter(raw, ft, bpp=3), 20),
            "plain_ms": cuda_ms(lambda: png_defilter_plain(raw, ft, bpp=3), 1),
            "bytes": 2 * raw.numel() + ft.numel(),
            "ops": sum(OPS_K15_BYTE[t] * n for t, n in enumerate(ftc[:5])) * SIZE * 3,
            "launches": launches["defilter"]["png_defilter"], "library_ms": None,
            "library_note": "no single PyTorch call computes the Paeth recurrence",
            "max_abs_err": max(v for k, v in errs.items() if k.startswith("k15")),
            "chain_bound_ms": (2 * SIZE - 1) * CHAIN_CYCLES_PER_STEP / BOOST_HZ * 1e3,
            "chain_cycles_per_step": CHAIN_CYCLES_PER_STEP,
            "rows_by_filter_type": ftc, "bands_a_block": WARPS},
        "inflate_resolve": {
            "ms": cuda_ms(lambda: inflate_resolve(*toks, per), 20),
            "plain_ms": cuda_ms(lambda: inflate_resolve_plain(*toks, per), 1),
            "bytes": BATCH * nt * 9 + BATCH * per,
            "ops": OPS_K16_TOKEN * BATCH * nt + OPS_K16_BYTE * BATCH * per,
            "launches": launches["inflate"]["inflate_resolve"], "library_ms": None,
            "library_note": "no single PyTorch call resolves LZ77 copies",
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith("k16") and not k.startswith("k16_adler32")),
            "tile": TILE, "ms_by_tile": tile_sweep, "peak_mem_bytes": k16_peak,
            "tokens": facts["k16_bench_tokens"],
            # the zlib trailer check of K16's output (csrc/adler32.cu): a CTA a
            # span of ADLER_SPAN bytes reads them once; two adds a byte (A,
            # then B += A)
            "adler32": with_bound({
                "source": "zpix_tpu_torch/csrc/adler32.cu",
                "ms": cuda_ms(lambda: adler32_check(flat_k, trailers, flag), 20),
                "plain_ms": cuda_ms(lambda: adler32_plain(flat_k, trailers, flag), 1),
                "bytes": flat_k.numel(), "ops": 2 * flat_k.numel(),
                "launches": launches["inflate"]["adler32"], "library_ms": None,
                "max_abs_err": max(v for k, v in errs.items() if k.startswith("k16_adler32"))})},
        "png_expand": {
            "ms": cuda_ms(lambda: png_expand(rows, None, None, cd="tc8", width=SIZE), 20),
            "plain_ms": cuda_ms(lambda: png_expand_plain(rows, None, None, cd="tc8",
                                                         width=SIZE), 1),
            "bytes": rows.numel() + 4 * npx, "ops": OPS_K17_PIXEL * npx,
            "launches": launches["host"]["png_expand"],
            "library_ms": cuda_ms(lambda: torch.nn.functional.pad(tc8, (0, 1), value=255), 20),
            "max_abs_err": max(v for k, v in errs.items() if k.startswith("k17")), "arm": "tc8",
            "arm_p8": with_bound({
                "ms": cuda_ms(lambda: png_expand(idx8, pal8, None, cd="p8", width=SIZE), 20),
                "plain_ms": cuda_ms(lambda: png_expand_plain(idx8, pal8, None, cd="p8",
                                                             width=SIZE), 1),
                "library_ms": cuda_ms(lambda: pal8[bidx, idx_long], 20),
                "bytes": idx8.numel() + pal8.numel() + 4 * npx, "ops": 0}),
            "adam7": adam7_ms},
    }
    del rows, idx8, idx_long, toks, kept, flat_k
    summary = {"content_seconds": content_s, "kernel_checks_seconds": checks_s,
               "max_abs_err": errs, "facts": facts, "routes": routes, "adam7": adam7,
               "damaged": damaged,
               "inflater": "libdeflate" if host.libdeflate_available()
               else "zlib", "bytes_per_image": float(np.mean([len(d) for d in batches[0]])),
               "inflated_bytes_per_image": per}
    paths = {"png_host": launches["host"], "png_defilter": launches["defilter"],
             "png_inflate": launches["inflate"], "png_adam7": launches["adam7"]}
    return summary, entries, paths, batches


PNG_DAMAGE_WANT = {  # damage -> (error class, message prefix) on the host-inflate routes
    "crc": ("ChecksumError", "png: CRC mismatch"),
    "short": ("FormatError", "png: not enough image data"),
    "filter": ("FormatError", "png: invalid filter type"),
    "deflate": ("FormatError", "png: inflate failed"),
    "adler": ("FormatError", "png: inflate failed: Error -3 while decompressing data: "
              "incorrect data check"),
}
PNG_DAMAGE_WANT_INFLATE = {**PNG_DAMAGE_WANT, "short": ("FormatError",
                                                        "png: inflated size mismatch"),
                           "deflate": ("FormatError", "zlib: invalid deflate stream")}


def png_check(pg, paths) -> None:
    """SystemExit unless the png phase's checks all held."""
    if any(pg["max_abs_err"].values()):
        raise SystemExit("chip_smoke: a PNG kernel disagrees with its plain version")
    if (min(p["png_expand"] for p in paths.values()) == 0
            or min(paths[p]["png_defilter"] for p in ("png_defilter", "png_inflate",
                                                      "png_adam7")) == 0
            or not 0 < paths["png_inflate"]["inflate_resolve"] <= 4
            or paths["png_inflate"]["adler32"] == 0):
        raise SystemExit("chip_smoke: a PNG route skipped its kernel")
    r = pg["routes"]
    if (not all(r["host"]["equal_pillow_images_0_1"]) or any(r["host"]["vs_host_path_images_0_1"])
            or not all(all(r[f]["equal_host_route"]) for f in ("defilter", "inflate"))
            or not all(pg["adam7"].values())):
        raise SystemExit("chip_smoke: a PNG route's pixels are wrong")
    for key, got in pg["damaged"].items():
        damage, front = key.split("_", 1)
        cls, msg = (PNG_DAMAGE_WANT_INFLATE if front == "inflate" else PNG_DAMAGE_WANT)[damage]
        if not got.startswith(f"{cls}: {msg}"):
            raise SystemExit(f"chip_smoke: damaged PNG {key} gave {got!r}")


def raster_slice(dev):
    """The phases qoi, qoi_encode, bmp and png, each printed and checked ->
    ({kernel: timing entry}, {path: launches of one call}, {pipeline
    route: its batches})."""
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
    qoi_noise = lane_decs["noise"][1]
    del lane_decs
    qc = qe["check"]
    if (any(qe["max_abs_err"].values()) or qe_launches["qoi_encode"] == 0
            or not all(v for k, v in qc.items() if isinstance(v, bool))
            or not all(qc["timed_equal_source"])):
        raise SystemExit("chip_smoke: the device encoder's streams are wrong")

    # ------------------------------------------------------------ BMP
    t0 = time.perf_counter()
    bm, raster_entries["bmp_unpack"], bm_launches, bmp_batches = bmp_phase(dev)
    emit({"phase": "bmp", "seconds": time.perf_counter() - t0, **bm})
    if any(bm["max_abs_err"].values()) or bm_launches["bmp_unpack"] == 0:
        raise SystemExit("chip_smoke: K18 disagrees with its plain version or was skipped")
    if (not all(r["main_equal_plain"] and all(r["timed_equal_plain"])
                for r in bm["routes"].values()) or bm["truncated"] != "UnexpectedEof"):
        raise SystemExit("chip_smoke: the BMP route's output is wrong")
    if (any(bm["vs_host_path_images_0_1"].values())
            or any(r["main_vs_host_path_images_0_1"] or any(r["timed_vs_host_path_images_0_1"])
                   for r in bm["routes"].values())):
        raise SystemExit("chip_smoke: a BMP batch differs from the port's host decoder")

    # ------------------------------------------------------------ PNG
    t0 = time.perf_counter()
    pg, png_entries, png_paths, png_batches = png_phase(dev)
    emit({"phase": "png", "seconds": time.perf_counter() - t0, **pg})
    png_check(pg, png_paths)
    raster_entries.update(png_entries)
    paths = {"qoi_lane": q_launches["noise"], "qoi_sorted": q_launches["sorted"],
             "qoi_encode": qe_launches, "bmp": bm_launches, **png_paths}
    return raster_entries, paths, {"qoi_noise_p4": qoi_noise, "bmp_24bpp": bmp_batches,
                                   "png_host": png_batches}


# ------------------------------------------------ pipeline (DecodePipeline)


def pipeline_decoders():
    """Pipeline route -> a new decoder of it, as the phases above drive it."""
    from zpix_tpu_torch import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                                DeviceJpegDecoder, HostIndexJpegDecoder, HostIndexQoiDecoder,
                                OnchipProgressiveDecoder, SyncJpegDecoder)

    return {"dri8": lambda: DeviceJpegDecoder(planar=True),
            "native": BatchJpegDecoder,
            "host_index": lambda: HostIndexJpegDecoder(planar=False),
            "sync": SyncJpegDecoder,
            "progressive": OnchipProgressiveDecoder,
            "qoi_noise_p4": lambda: HostIndexQoiDecoder(lane_p=QOI_PROFILES["noise"],
                                                        lane_fmt="p4"),
            "bmp_24bpp": BatchBmpDecoder,
            "png_host": BatchPngDecoder}


def device_spans(prof) -> list:
    """[(start us, end us, name)] of the card's kernels, copies and
    memsets in a torch.profiler run, by start."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def busy_and_gaps(spans) -> tuple:
    """The union of the spans (every stream) -> (its length in us, the
    idle gaps [(us, the op before, the op after)] between its first start
    and last end)."""
    busy, gaps, end, last = 0.0, [], None, None
    for a, b, name in spans:
        if end is None or a > end:
            if end is not None:
                gaps.append((a - end, last, name))
            busy += b - a
            end, last = b, name
        elif b > end:
            busy += b - end
            end, last = b, name
    return busy, gaps


def profiled_busy_share(fn) -> float:
    """fn() under torch.profiler (host and card): the card's busy time (the
    union of its ops over every stream) over the run's host wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return busy_and_gaps(device_spans(prof))[0] / (wall * 1e6)


def pipeline_phase(content: dict) -> dict:
    """Each route's 10 timed batches (16 distinct 1024^2 images; the
    progressive route 16 copies of a new image a batch) decoded serially
    (``decode``, a sync a batch) and through ``DecodePipeline`` (prefetch
    2, the decoder's prep / upload / run, one sync at the end): the
    pipelined outputs and ok bit-identical to the serial ones, each run's
    end-to-end MPix/s (host clock), a pipelined run with one prep thread
    (its ms a batch and its outputs), the card's busy share of each (a second
    run of each under torch.profiler: the union of the card's ops over its
    wall time), the metrics registry's report of the pipelined run; then
    one pipelined DRI 8 run of two batches traced by profile_trace into
    build/pipeline_trace with its five longest device ops and idle gaps."""
    from zpix_tpu_torch.parallel.pipeline import DecodePipeline
    from zpix_tpu_torch.utils import metrics, profile_trace

    mpix = TIMED_BATCHES * BATCH * SIZE * SIZE / 1e6
    routes = {}
    for name, make in pipeline_decoders().items():
        batches = content[name][2 : 2 + TIMED_BATCHES]
        dec = make()
        dec.decode(content[name][1])  # warm: pinned pool, caches, threads
        torch.cuda.synchronize()

        def serial():
            return [dec.decode(d) for d in batches]

        def pipelined(workers=None):
            outs = list(DecodePipeline(dec, prefetch=2, workers=workers).map(batches))
            # PNG's run also returns the inflate route's flag (None here)
            return [o[0] if name == "png_host" else o for o in outs]

        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = serial()
        torch.cuda.synchronize()
        t_serial = time.perf_counter() - t0
        metrics.reset()
        t0 = time.perf_counter()
        got = pipelined()
        torch.cuda.synchronize()
        t_pipe = time.perf_counter() - t0
        report = metrics.report()
        t0 = time.perf_counter()
        got1 = pipelined(workers=1)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        got1_equal = all(torch.equal(g[0] if isinstance(g, tuple) else g,
                                     w[0] if isinstance(w, tuple) else w)
                         for g, w in zip(got1, want))
        del got1
        pair = [(g, w) if isinstance(w, tuple) else ((g,), (w,)) for g, w in zip(got, want)]
        routes[name] = {
            "batches": len(batches),
            "pipelined_equal_serial": len(got) == len(want) and got1_equal and all(
                torch.equal(g[0], w[0]) for g, w in pair),
            "ok_equal": all(len(g) == 1 or bool(g[1]) == bool(w[1]) for g, w in pair),
            "all_ok": all(len(w) == 1 or bool(w[1]) for _, w in pair),
            "serial_mpix_per_s": mpix / t_serial, "pipelined_mpix_per_s": mpix / t_pipe,
            "serial_ms_per_batch": t_serial * 1e3 / len(batches),
            "pipelined_ms_per_batch": t_pipe * 1e3 / len(batches),
            # one prep thread (the default is one a prefetched batch)
            "pipelined_1_worker_ms_per_batch": t_one * 1e3 / len(batches),
            "serial_busy_share": profiled_busy_share(serial),
            "pipelined_busy_share": profiled_busy_share(pipelined),
            "metrics_report_pipelined": report.splitlines()}
        del got, want, pair
        if hasattr(dec, "close"):
            dec.close()
    # one pipelined DRI 8 run traced: the second batch prepped during the
    # first's upload and kernels
    dec = pipeline_decoders()["dri8"]()
    dec.decode(content["dri8"][1])
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pipeline_trace")
    with profile_trace(log_dir) as prof:
        outs = list(DecodePipeline(dec).map(content["dri8"][2:4]))
    spans = device_spans(prof)
    busy, gaps = busy_and_gaps(spans)
    del outs
    return {"cpu_count": os.cpu_count(), "prefetch": 2, "routes": routes,
            "trace": {"dir": log_dir, "files": sorted(os.listdir(log_dir)),
                      "device_ops": len(spans), "busy_us": busy,
                      "window_us": spans[-1][1] - spans[0][0] if spans else 0.0,
                      "longest_ops": [{"name": n, "us": b - a} for a, b, n in
                                      sorted(spans, key=lambda x: x[0] - x[1])[:5]],
                      "longest_gaps": [{"us": g, "after": x, "before": y} for g, x, y in
                                       sorted(gaps, reverse=True)[:5]]}}


# ------------------------------------------------ decode_mixed (the router)

MIXED_MIN_BATCH = 2
MIXED_TIMED = 3
# kind -> the route decode_mixed must take for it
MIXED_ROUTES = {"baseline_420": "device", "cmyk_444": "device", "progressive_420": "device",
                "qoi_noise": "device", "bmp_24bpp": "device", "bmp_8bpp_short": "device",
                "png_rgb8": "device", "progressive_cmyk": "host-routed",
                "gray_small": "host-small"}
# kernels of the router's device routes: K7, K6 (baseline and CMYK), K8-K11
# and K6 (progressive), K12 (QOI), K18 (BMP), K17 (PNG)
MIXED_KERNELS = ("unpack_sparse", "component_planes", "dc_first", "ac_first", "ac_refine",
                 "dc_refine", "qoi_lane_expand", "bmp_unpack", "png_expand")


def _mixed_prog_cmyk(seed: int) -> bytes:
    from PIL import Image

    buf = BytesIO()
    Image.open(BytesIO(make_bench_jpeg(SIZE, 95, seed, None))).convert("CMYK").save(
        buf, format="JPEG", quality=QUALITY, progressive=True)
    return buf.getvalue()


def _mixed_gray(seed: int) -> bytes:
    from PIL import Image

    buf = BytesIO()
    Image.open(BytesIO(make_bench_jpeg(SIZE, 95, seed, None))).convert("L").save(
        buf, format="JPEG", quality=QUALITY)
    return buf.getvalue()


def make_mixed_corpus(rf_batch, cmyk_batch, prog_batch, qoi_batch, bmp_batch,
                      png_batch) -> dict:
    """kind -> the streams of decode_mixed's corpus, every image 1024^2: the
    batches the earlier phases made (restart-free 4:2:0 JPEGs, CMYK 4:4:4
    JPEGs, 16 copies of one progressive 4:2:0 JPEG, QOI noise, 24-bit BMPs,
    RGB8 PNGs), and new here: 4 distinct progressive 4:2:0 JPEGs (Pillow
    writes tables an image, so the progressive bucket splits into five
    scripts), 4 paletted BMPs with short palettes, 2 progressive CMYK JPEGs
    (host-routed) and one gray JPEG (host-small under MIXED_MIN_BATCH)."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        distinct = list(ex.map(lambda s: make_bench_jpeg(SIZE, QUALITY, s, None,
                                                         progressive=True), range(7000, 7004)))
        short_bmp = list(ex.map(lambda s: make_bmp(s, 8, 40, False, True), range(7100, 7104)))
        prog_cmyk = list(ex.map(_mixed_prog_cmyk, (7200, 7201)))
        gray = list(ex.map(_mixed_gray, (7300,)))
    return {"baseline_420": list(rf_batch), "cmyk_444": list(cmyk_batch),
            "progressive_420": list(prog_batch) + distinct,
            "qoi_noise": list(qoi_batch), "bmp_24bpp": list(bmp_batch),
            "bmp_8bpp_short": short_bmp, "png_rgb8": list(png_batch),
            "progressive_cmyk": prog_cmyk, "gray_small": gray}


def kernel_counts(prof) -> dict:
    """The card's kernels in a torch.profiler run, counted by name (copies
    and memsets left out)."""
    from collections import Counter

    from torch.autograd import DeviceType

    return dict(Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                        and not e.name.startswith(("Memcpy", "Memset"))))


def mixed_phase(corpus: dict) -> dict:
    """decode_mixed on the corpus shuffled into one list (min_batch 2): a
    warm call (the router builds its decoders once), a call with the
    kernels' launches counted (runtime.LAUNCHES set to 0 just before, read
    just after) under torch.profiler (the card's kernels by name, its busy
    share), every output against the port's host path (from_buffer(d).
    rgba_pixels()) at max_abs_err 0, the decodes on a thread pool; then 3
    timed calls (host clock, a synchronised end), each equal to the first,
    with peak memory and metrics.report(); then a damaged PNG among good
    ones (the host decoder's error) and unknown bytes (UnknownFormat)."""
    from torch.profiler import ProfilerActivity, profile

    from zpix_tpu_torch import from_buffer, runtime
    from zpix_tpu_torch.parallel import bucketing
    from zpix_tpu_torch.utils import metrics

    items = [(k, d) for k, ds in corpus.items() for d in ds]
    order = np.random.default_rng(18).permutation(len(items))
    kinds, datas = [items[i][0] for i in order], [items[i][1] for i in order]
    del items

    def call():
        return bucketing.decode_mixed(datas, min_batch=MIXED_MIN_BATCH, return_stats=True)

    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    runtime.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs, stats = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    busy, _gaps = busy_and_gaps(device_spans(prof))
    by_name = kernel_counts(prof)
    del prof
    mpix = sum(o.shape[0] * o.shape[1] for o in outs) / 1e6

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        errs = list(ex.map(lambda i: host_path_err([torch.from_numpy(outs[i])], [datas[i]], 1),
                           range(len(datas))))
    host_s = time.perf_counter() - t0
    err_by_kind = {k: max(e for e, kk in zip(errs, kinds) if kk == k) for k in corpus}

    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    walls, equal = [], []
    for _ in range(MIXED_TIMED):
        t0 = time.perf_counter()
        got, st = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        equal.append(st == stats and all(np.array_equal(a, b) for a, b in zip(got, outs)))
        del got
    peak = torch.cuda.max_memory_allocated() - held
    report = metrics.report()

    def call_on(ds):
        return bucketing.decode_mixed(ds, min_batch=MIXED_MIN_BATCH)

    pngs = corpus["png_rgb8"]
    bad = bytearray(pngs[0])
    bad[len(bad) // 2] ^= 0xFF  # inside an IDAT payload: its CRC no longer holds
    bad = bytes(bad)
    errors = {"damaged_png": host_outcome(lambda: call_on([pngs[0], pngs[1], bad])),
              "damaged_png_host": host_outcome(lambda: from_buffer(bad)),
              "unknown": host_outcome(lambda: call_on([pngs[0], b"GIF89a" + bytes(64)]))}
    return {"images": len(datas), "mpix": mpix, "min_batch": MIXED_MIN_BATCH,
            "images_by_kind": {k: len(v) for k, v in corpus.items()},
            "routes": stats, "launches": {k: v for k, v in launches.items() if v},
            "launches_all": launches, "profiler_kernels_by_name": by_name,
            "warm_call_s": warm_s, "profiled_call_s": wall,
            "host_max_abs_err_by_kind": err_by_kind, "host_check_seconds": host_s,
            "timed_e2e_ms": [w * 1e3 for w in walls],
            "e2e_mpix_per_s": mpix / float(np.mean(walls)),
            "timed_equal_first": equal, "device_busy_share": busy / (wall * 1e6),
            "device_busy_us": busy, "peak_mem_bytes": peak,
            "metrics_report": report.splitlines(), "errors": errors}


def mixed_check(mx) -> None:
    """SystemExit unless the decode_mixed phase's checks all held."""
    want = {}
    for k, n in mx["images_by_kind"].items():
        want[MIXED_ROUTES[k]] = want.get(MIXED_ROUTES[k], 0) + n
    if mx["routes"] != want:
        raise SystemExit(f"chip_smoke: decode_mixed routes {mx['routes']}, want {want}")
    if any(mx["host_max_abs_err_by_kind"].values()) or not all(mx["timed_equal_first"]):
        raise SystemExit("chip_smoke: a decode_mixed output differs from the host path")
    if min(mx["launches_all"][k] for k in MIXED_KERNELS) == 0:
        raise SystemExit("chip_smoke: decode_mixed skipped a kernel of its routes")
    e = mx["errors"]
    if (e["damaged_png"] is None or e["damaged_png"] != e["damaged_png_host"]
            or e["unknown"] != ["UnknownFormat", "zpix: no codec matched the buffer"]):
        raise SystemExit(f"chip_smoke: decode_mixed's errors are wrong: {e}")


# ------------------------------------------------- mesh (parallel/mesh.py)

MESH_SHARDS = 4  # make_mesh(["cuda:0"] * 4): four shards on the one card
MESH_REPS = 3  # timed decodes a route and a mesh
MESH_STRADDLE = 6  # DRI 8 images on the four shards: 512 lanes each, 768 a shard
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh_phase")


def sharded_err(out, ref) -> int:
    """max_abs_err of a Sharded output against the unsharded tensor, each
    shard against its rows on the shard's device (-1 for a shape that
    differs)."""
    if tuple(out.shape) != tuple(ref.shape):
        return -1
    return max(max_abs_err(t, ref[idx].to(t.device)) for t, idx in zip(out.shards, out.indices))


def mesh_routes(content: dict) -> dict:
    """route -> (decoder maker taking a mesh or None, batch, whether decode
    returns (pixels, ok))."""
    from zpix_tpu_torch.parallel import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                                         DeviceJpegDecoder, HostIndexJpegDecoder,
                                         HostIndexQoiDecoder)

    qoi_p = QOI_PROFILES["noise"]
    return {
        "dri8": (lambda m: DeviceJpegDecoder(planar=True, mesh=m), content["dri8"], True),
        "host_index": (lambda m: HostIndexJpegDecoder(mesh=m), content["rf"], True),
        "native": (lambda m: BatchJpegDecoder(mesh=m), content["rf"], False),
        "bmp_24bpp": (lambda m: BatchBmpDecoder(mesh=m), content["bmp"], False),
        "png_host": (lambda m: BatchPngDecoder(mesh=m), content["png"], False),
        "png_device_inflate": (lambda m: BatchPngDecoder(device_inflate=True, mesh=m),
                               content["png"], False),
        "qoi_lane_p4": (lambda m: HostIndexQoiDecoder(lane_p=qoi_p, lane_fmt="p4", mesh=m),
                        content["qoi"], False),
        "qoi_sorted": (lambda m: HostIndexQoiDecoder(impl="sorted", mesh=m), content["qoi"],
                       False),
    }


def mesh_decode(dec, datas, with_ok: bool):
    """One timed decode (host clock, a synchronised end) with the kernels'
    launches counted (set to 0 just before, read just after) -> (pixels,
    ok or None, seconds, launches)."""
    from zpix_tpu_torch import runtime

    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.perf_counter()
    out = dec.decode(datas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    px, ok = out if with_ok else (out, None)
    return px, ok, wall, dict(runtime.LAUNCHES)


def distributed_worker(rank: str, port: str) -> int:
    """One of the mesh phase's two processes: join the gloo group, decode
    this process's local_shard of the DRI 8 batch on cuda:0, place it with
    host_local_batch on the global mesh (one position a process) and hold
    its shard against the single-process decode's image hashes; prints one
    JSON line, exits 0 when both processes' shards agree."""
    import hashlib

    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.parallel import DeviceJpegDecoder, distributed

    rank = int(rank)
    with open(os.path.join(MESH_DIR, "hashes.json")) as f:
        meta = json.load(f)
    datas = []
    for i in range(len(meta["sha256"])):
        with open(os.path.join(MESH_DIR, f"{i}.jpg"), "rb") as f:
            datas.append(f.read())
    joined = distributed.initialize(f"127.0.0.1:{port}", 2, rank, timeout=300)
    mesh = distributed.global_mesh(devices=["cuda:0"])
    local = distributed.local_shard(datas)
    dec = DeviceJpegDecoder(planar=True, device="cuda:0")
    dec.decode(local)  # warm
    px, ok, wall, launches = mesh_decode(dec, local, True)
    g = distributed.host_local_batch(mesh, px)
    rows = g.indices[0][0]
    got = [hashlib.sha256(im.cpu().numpy().tobytes()).hexdigest() for im in g.shards[0]]
    equal = got == meta["sha256"][rows]
    mine = {"rank": rank, "images": len(local), "rows": [rows.start, rows.stop],
            "equal_single_process": equal, "ok": bool(ok), "global_shape": list(g.shape),
            "complete_here": g.complete, "mesh": mesh.shape,
            "addressable": [mesh.addressable((k, 0)) for k in range(mesh.shape["batch"])],
            "e2e_ms": wall * 1e3, "launches": {k: v for k, v in launches.items() if v}}
    seen = [None, None]
    torch.distributed.all_gather_object(seen, mine)
    torch.distributed.destroy_process_group()
    good = joined and all(r["equal_single_process"] and r["ok"] for r in seen)
    print(json.dumps({**mine, "all_ranks_equal": good}), flush=True)
    return 0 if good else 1


def distributed_run(dri8, ref) -> dict:
    """Two processes of this script on the one card (gloo on 127.0.0.1),
    each decoding 8 of the 16 images; ``ref``: the single-process decode."""
    import hashlib
    import socket

    os.makedirs(MESH_DIR, exist_ok=True)
    for i, d in enumerate(dri8):
        with open(os.path.join(MESH_DIR, f"{i}.jpg"), "wb") as f:
            f.write(d)
    with open(os.path.join(MESH_DIR, "hashes.json"), "w") as f:
        json.dump({"sha256": [hashlib.sha256(im.cpu().numpy().tobytes()).hexdigest()
                              for im in ref]}, f)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--distributed-worker", str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for p, (out, err) in zip(procs, outs):
        lines = out.strip().splitlines()
        if p.returncode != 0 or not lines:
            raise SystemExit(f"chip_smoke: a distributed worker failed (rc {p.returncode}):\n"
                             f"{out[-2000:]}\n{err[-3000:]}")
        ranks.append(json.loads(lines[-1]))
    return {"seconds": time.perf_counter() - t0, "ranks": ranks}


def mesh_phase(content: dict, mixed_datas: list, smi: str) -> dict:
    """The mesh slice on the card: every mesh decoder over make_mesh() (every
    visible card: 1 x 1 here) and over make_mesh(["cuda:0"] * 4), each
    output against the unsharded decode on the card (max_abs_err 0) with
    ``ok`` True, MPix/s (host clock, MESH_REPS decodes) and launches a call
    at 1 and 4 shards beside the unsharded decoder's; the straddling case
    (6 DRI 8 images on 4 shards); decode_mixed(mesh=) against the
    unsharded call; and two processes on the one card through
    parallel/distributed.py."""
    from zpix_tpu_torch.parallel import bucketing, make_mesh

    meshes = {"1_shard": make_mesh(), "4_shards": make_mesh(["cuda:0"] * MESH_SHARDS)}
    routes, path = {}, {}
    for name, (make, datas, with_ok) in mesh_routes(content).items():
        mpix = len(datas) * SIZE * SIZE / 1e6
        plain = make(None)
        plain.decode(datas)  # warm
        ref, ref_ok, _, plain_launches = mesh_decode(plain, datas, with_ok)
        walls = [mesh_decode(plain, datas, with_ok)[2] for _ in range(MESH_REPS)]
        row = {"images": len(datas), "unsharded": {
            "mpix_per_s": mpix / float(np.mean(walls)), "e2e_ms": [w * 1e3 for w in walls],
            "launches": {k: v for k, v in plain_launches.items() if v}, "nvidia_smi": smi}}
        for label, mesh in meshes.items():
            dec = make(mesh)
            dec.decode(datas)  # warm
            px, ok, _, launches = mesh_decode(dec, datas, with_ok)
            for k, v in launches.items():
                path[k] = path.get(k, 0) + v
            walls = [mesh_decode(dec, datas, with_ok)[2] for _ in range(MESH_REPS)]
            row[label] = {
                "shards": len(px.shards), "images_a_shard": [t.shape[0] for t in px.shards],
                "max_abs_err": sharded_err(px, ref), "ok": True if ok is None else bool(ok),
                "mpix_per_s": mpix / float(np.mean(walls)), "e2e_ms": [w * 1e3 for w in walls],
                "launches": {k: v for k, v in launches.items() if v},
                "launches_scale_with_shards": all(
                    launches[k] == len(px.shards) * v for k, v in plain_launches.items()),
                "nvidia_smi": smi}
        row["unsharded_ok"] = True if ref_ok is None else bool(ref_ok)
        routes[name] = row
        del ref, px

    # the straddling case: an image's lanes on two shards
    make, datas, _ = mesh_routes(content)["dri8"]
    six = datas[:MESH_STRADDLE]
    ref, ref_ok = make(None).decode(six)
    px, ok, _, launches = mesh_decode(make(meshes["4_shards"]), six, True)
    for k, v in launches.items():
        path[k] = path.get(k, 0) + v
    straddle = {"images": len(six), "images_a_shard": [t.shape[0] for t in px.shards],
                "max_abs_err": sharded_err(px, ref), "ok": bool(ok), "unsharded_ok": bool(ref_ok),
                "launches": {k: v for k, v in launches.items() if v}}
    del px, ref

    # decode_mixed over the mesh against the unsharded call, each timed
    # after a warm call (the router builds its decoders once a mesh)
    from zpix_tpu_torch import runtime

    def mixed_call(mesh):
        torch.cuda.synchronize()
        runtime.reset_launches()
        t0 = time.perf_counter()
        outs, stats = bucketing.decode_mixed(mixed_datas, mesh=mesh, min_batch=MIXED_MIN_BATCH,
                                             return_stats=True)
        torch.cuda.synchronize()
        return outs, stats, time.perf_counter() - t0, dict(runtime.LAUNCHES)

    mixed_call(None)
    want, want_stats, want_wall, _ = mixed_call(None)
    mixed_call(meshes["4_shards"])
    got, stats, wall, mixed_launches = mixed_call(meshes["4_shards"])
    for k, v in mixed_launches.items():
        path[k] = path.get(k, 0) + v
    bucketing.close()
    mpix = sum(o.shape[0] * o.shape[1] for o in want) / 1e6
    mixed = {"images": len(mixed_datas), "routes": stats, "routes_unsharded": want_stats,
             "equal_unsharded": len(got) == len(want) and all(
                 a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, want)),
             "e2e_ms": wall * 1e3, "e2e_ms_unsharded": want_wall * 1e3,
             "mpix_per_s": mpix / wall, "mpix_per_s_unsharded": mpix / want_wall,
             "nvidia_smi": smi, "launches": {k: v for k, v in mixed_launches.items() if v}}
    del got, want

    dist = distributed_run(content["dri8"], make(None).decode(content["dri8"])[0])
    return {"meshes": {k: {"shape": m.shape, "devices": [str(d) for d in m.devices.reshape(-1)]}
                       for k, m in meshes.items()},
            "routes": routes, "straddle": straddle, "decode_mixed": mixed,
            "distributed": dist, "nvidia_smi": smi, "launches_all": path}


def mesh_check(ms) -> None:
    """SystemExit unless the mesh phase's checks all held."""
    for name, r in ms["routes"].items():
        for label in ("1_shard", "4_shards"):
            s = r[label]
            if s["max_abs_err"] or not s["ok"] or not s["launches_scale_with_shards"]:
                raise SystemExit(f"chip_smoke: mesh route {name} on {label} is wrong: {s}")
        if not r["unsharded_ok"] or r["4_shards"]["shards"] != MESH_SHARDS:
            raise SystemExit(f"chip_smoke: mesh route {name}'s reference did not verify")
    st = ms["straddle"]
    if (st["max_abs_err"] or not st["ok"] or not st["unsharded_ok"]
            or st["images_a_shard"] != [2, 1, 2, 1]):
        raise SystemExit(f"chip_smoke: the straddling mesh decode is wrong: {st}")
    mx = ms["decode_mixed"]
    if not mx["equal_unsharded"] or mx["routes"] != mx["routes_unsharded"]:
        raise SystemExit("chip_smoke: decode_mixed over the mesh differs from the unsharded call")
    ranks = ms["distributed"]["ranks"]
    if (len(ranks) != 2 or not all(r["all_ranks_equal"] and r["images"] == BATCH // 2
                                   and r["global_shape"][0] == BATCH for r in ranks)):
        raise SystemExit("chip_smoke: the two-process decode differs from the single process")


# ------------------------------------- spec: the decoders with no host index walk

SPEC_TIMED = 3  # timed batches a route
SPEC_KINDS = ("dc_first_spec", "ac_first_spec", "delta_add", "qoi_spec")
# Least operations: K20 and K21 a symbol (K2's symbol decode) and K20 a
# block its prefix add and shift; K23 an op (its length, up to five byte
# reads, the pixel's update, the hash: 4 multiplies, 3 adds, a mask, the
# index write) and a pixel its store; K22 an add an element.
OPS_K23_OP, OPS_K23_PIXEL, OPS_K22_ELEMENT = 20, 1, 1
SPEC_OPS_CAP = 16  # the overflow batch's ops a chunk (noise holds ~1,000 at 4 KiB)


class EventClock:
    """Callables wrapped where the code under test looks them up: each
    call's device time between CUDA events (``dev`` labels) or host time
    (``host`` labels), summed by label, the wrappers restored on exit."""

    def __init__(self, dev=(), host=()):
        self.targets = [(obj, name, label, True) for obj, name, label in dev]
        self.targets += [(obj, name, label, False) for obj, name, label in host]
        self.events, self.host = [], {}

    def _wrap(self, fn, label, device):
        def timed(*a, **kw):
            if not device:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.host[label] = self.host.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
                return out
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.events.append((label, e0, e1))
            return out
        return timed

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name, _, _ in self.targets]
        for (obj, name, label, device), (_, _, fn) in zip(self.targets, self.saved):
            setattr(obj, name, self._wrap(fn, label, device))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = dict(self.host)
        for label, e0, e1 in self.events:
            out[label] = out.get(label, 0.0) + e0.elapsed_time(e1)
        return out


def spec_scan_checks(dec, datas):
    """K20 against its plain version on every DC-first scan, and K21 in one
    call over every single-component AC-first scan against its plain
    version a scan at a time, on a full batch from a zero store on the
    card -> (max_abs_err by kernel, ok all, per scan: misses an image (the
    kernel's), chunk count, the most symbols a chunk, stream bytes, blocks;
    K20's kernel and plain ms a scan; K21's group: kernel and plain ms)."""
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.parallel import progressive_onchip as po

    plans = [po.parse_progressive(d) for d in datas]
    p0, dev = plans[0], dec.device
    errs = {"dc_first_spec": 0, "ac_first_spec": 0}
    oks, scans, acs = [], [], []

    def shape(c):
        return (len(datas), p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64)

    def entry(si, sc, name, F, arrays, valid):
        return {"scan": si, "kind": name, "comps": list(sc.comps), "chunks": F,
                "stream_bytes": int(arrays[0].nbytes),
                "blocks": len(datas) * (int(np.prod(valid)) if len(sc.comps) == 1 else
                                        p0.mxx * p0.myy * sum(p0.hv[c][0] * p0.hv[c][1]
                                                              for c in sc.comps))}

    for si, sc in enumerate(p0.scans):
        if not (sc.kind == "dc_first" or (sc.kind == "ac_first" and len(sc.comps) == 1)):
            continue
        arrays, F = po.spec_first_inputs(p0, plans, si, dec.chunk_bytes)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        valid = po.valid_grid(p0, sc.comps[0])
        if sc.kind == "ac_first":
            acs.append((si, sc, t, F, entry(si, sc, "ac_first_spec", F, arrays, valid)))
            continue
        kw = dict(valid=valid, al=sc.al, chunk_bytes=dec.chunk_bytes, n_chunks=F,
                  hv=[p0.hv[c] for c in sc.comps])
        gk = [torch.zeros(shape(c), dtype=torch.int32, device=dev) for c in sc.comps]
        gp = [torch.zeros(shape(c), dtype=torch.int32, device=dev) for c in sc.comps]
        okk, okp = (torch.ones(1, dtype=torch.int32, device=dev) for _ in range(2))
        stats = {}
        rounds = ps.dc_first_spec(*t, okk, gk, **kw)
        t0 = time.perf_counter()
        ps.dc_first_spec_plain(*t, okp, gp, **kw, stats=stats)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        errs["dc_first_spec"] = max(errs["dc_first_spec"], max_abs_err(okk, okp),
                                    *(max_abs_err(a, b) for a, b in zip(gk, gp)))
        oks.append(bool(okk) and bool(okp))
        scans.append({**entry(si, sc, "dc_first_spec", F, arrays, valid),
                      "rounds": rounds.cpu().tolist(), "chunk_symbols": stats["chunk_symbols"],
                      "ms": cuda_ms(lambda: ps.dc_first_spec(*t, okk, gk, **kw), 5),
                      "plain_ms": plain_s * 1e3})
        del gk, gp
    # K21: one call for every AC-first scan, its plain version a scan at a time
    comps = sorted({sc.comps[0] for _, sc, _, _, _ in acs})
    gk = {c: torch.zeros(shape(c), dtype=torch.int32, device=dev) for c in comps}
    gp = {c: torch.zeros(shape(c), dtype=torch.int32, device=dev) for c in comps}
    okk, okp = (torch.ones(1, dtype=torch.int32, device=dev) for _ in range(2))

    def group(grids):
        return [ps.AcScan(*t, grids[sc.comps[0]], po.valid_grid(p0, sc.comps[0]), sc.ss, sc.se,
                          sc.al, F) for _, sc, t, F, _ in acs]

    misses = ps.ac_first_spec_group(group(gk), okk, chunk_bytes=dec.chunk_bytes)
    t0 = time.perf_counter()
    for a, (_, _, _, _, e) in zip(group(gp), acs):
        stats = {}
        ps.ac_first_spec_plain(a.stream, a.starts, a.ends, a.tables, okp, a.grid, valid=a.valid,
                               ss=a.ss, se=a.se, al=a.al, chunk_bytes=dec.chunk_bytes,
                               n_chunks=a.n_chunks, stats=stats)
        e["chunk_symbols"] = stats["chunk_symbols"]
    torch.cuda.synchronize()
    ac_plain_s = time.perf_counter() - t0
    errs["ac_first_spec"] = max(max_abs_err(okk, okp),
                                *(max_abs_err(gk[c], gp[c]) for c in comps))
    oks.append(bool(okk) and bool(okp))
    for (_, _, _, _, e), m in zip(acs, misses.cpu().tolist()):
        e["rounds"] = m
        scans.append(e)
    grp = group(gk)
    ac_group = {"scans": len(acs), "ms": cuda_ms(
        lambda: ps.ac_first_spec_group(grp, okk, chunk_bytes=dec.chunk_bytes), 5),
        "plain_ms": ac_plain_s * 1e3}
    del gk, gp, grp
    return errs, all(oks), scans, ac_group


def prog_spec_route(dec, datas, clock_targets):
    """One spec decode with each stage timed -> (pixels, ok, stage ms)."""
    from zpix_tpu_torch.parallel import progressive_onchip as po

    with EventClock(*clock_targets(dec)) as clock:
        t0 = time.perf_counter()
        px, ok = dec.decode(datas)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    st = clock.ms()
    st["e2e"] = wall
    return px, bool(ok), st


def spec_phase(dev):
    """The three decoders with no host index walk: K20-K23 against their
    plain versions at full width, OnchipProgressiveDecoder(impl="spec") (no
    tail on libjpeg's script, the tail on a moved scan, the fallback of a
    refused walk), DeviceProgressiveDecoder and BatchQoiDecoder (noise and
    screen, an ops_cap overflow), each against the host decoder, timed by
    stage -> (summary, {kernel: timing entry})."""
    from zpix_tpu_torch import OnchipProgressiveDecoder, runtime
    from zpix_tpu_torch.ops import planes as kp6
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.ops import progressive as kpr
    from zpix_tpu_torch.ops import qoi_spec as qs
    from zpix_tpu_torch.parallel import BatchQoiDecoder, DeviceProgressiveDecoder
    from zpix_tpu_torch.parallel import HostIndexQoiDecoder
    from zpix_tpu_torch.parallel import progressive as pd
    from zpix_tpu_torch.parallel import progressive_onchip as po

    t0 = time.perf_counter()
    writer = jpeg_writer()
    batches = make_prog_batches(range(300, 301 + SPEC_TIMED))
    moved = [writer.move_scan(batches[0][0], 3, 5)] * BATCH
    qoi = {c: make_qoi_batches(c, range(1 + SPEC_TIMED)) for c in ("noise", "screen")}
    content_s = time.perf_counter() - t0
    mpix = BATCH * SIZE * SIZE / 1e6
    dec = OnchipProgressiveDecoder(impl="spec")

    # K20 (scan by scan) and K21 (one call) against their plain versions
    errs, kernels_ok, scans, ac_group = spec_scan_checks(dec, batches[0])

    def spec_targets(d):
        return ([(ps, "dc_first_spec", "dc_first_spec"),
                 (ps, "ac_first_spec_group", "ac_first_spec"),
                 (kpr, "ac_refine", "ac_refine"), (kpr, "dc_refine", "dc_refine"),
                 (ps, "delta_add_segments", "delta_add"),
                 (po, "decode_batch_planes", "component_planes"),
                 (d, "_upload", "h2d"), (po, "pack_flags", "flag_pack")],
                [(po, "parse_progressive", "host_parse"),
                 (po, "spec_first_inputs", "host_stack"), (po, "tail_deltas", "host_tail"),
                 (d, "_spec_refinements", "flag_fetch_and_walks")])

    # the spec route: launches of one decode, images 0 and 1 against the host
    dec.decode(batches[1])
    torch.cuda.synchronize()
    runtime.reset_launches()
    px, ok = dec.decode(batches[0])
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    route = {"ok": bool(ok), "n_host_tail_scans": dec.n_host_tail_scans,
             "flag_fetch_bytes": dec.spec_stats["flag_fetch_bytes"],
             "rounds": {si: r.cpu().tolist() for si, r in dec.spec_stats["rounds"].items()},
             "host_decoder_err": max(host_decoder_err(px[i], batches[0][i]) for i in (0, 1)),
             "launches": launches}
    # the same decode again, every stage timed, over the timed batches
    stages = [prog_spec_route(dec, b, spec_targets)[2] for b in batches[1:]]
    route["stage_ms_mean"] = {k: float(np.mean([s.get(k, 0.0) for s in stages]))
                              for k in stages[0]}
    route["e2e_mpix_per_s"] = mpix / (route["stage_ms_mean"]["e2e"] / 1e3)

    # the tail: Cb's AC-first scan moved after Y's first refinement (its
    # deltas kept for K22's checks)
    runtime.reset_launches()
    captured, tail_deltas = [], po.tail_deltas
    po.tail_deltas = lambda *a: captured.append(tail_deltas(*a)) or captured[-1]
    try:
        tpx, tok, tst = prog_spec_route(dec, moved, spec_targets)
    finally:
        po.tail_deltas = tail_deltas
    tail = {"ok": tok, "n_host_tail_scans": dec.n_host_tail_scans,
            "prefix": dec.spec_stats["prefix"], "launches": dict(runtime.LAUNCHES),
            "host_decoder_err": max(host_decoder_err(tpx[i], batches[0][0]) for i in (0, 1)),
            "stage_ms": tst, "e2e_mpix_per_s": mpix / (tst["e2e"] / 1e3)}
    # K22 on the tail's deltas: kernel, plain (scatter_add_ after the index
    # cast) and the library call alone, on a store of the batch's shape
    pl = po.parse_progressive(moved[0])
    dv = [(torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev)) for i, v in captured[0]]
    dv64 = [(i.long(), v) for i, v in dv]
    flat = [torch.randint(-999, 999, (BATCH, pl.myy * v * pl.mxx * h * 64), dtype=torch.int32,
                          device=dev) for h, v in pl.hv]
    k22_elems = sum(int(i.numel()) for i, _ in dv)
    sk = [f.clone() for f in flat]
    sp = [f.clone() for f in flat]
    k22_updates = [(s, i, v) for s, (i, v) in zip(sk, dv)]
    ps.delta_add_segments(k22_updates)
    for s, (i, v) in zip(sp, dv):
        ps.delta_add_plain(s, i, v)
    errs["delta_add"] = max(max_abs_err(a, b) for a, b in zip(sk, sp))

    def k22(fn, pairs):
        def go():
            for s, (i, v) in zip(sk, pairs):
                fn(s, i, v)
        return go

    k22_ms = cuda_ms(lambda: ps.delta_add_segments(k22_updates), 20)
    k22_plain_ms = cuda_ms(k22(ps.delta_add_plain, dv), 5)
    k22_lib_ms = cuda_ms(k22(lambda s, i, v: s.scatter_add_(1, i, v), dv64), 20)
    del sk, sp, flat, k22_updates

    # the fallback: a batch the DC-first walk refuses goes the spec path
    bad = [corrupt_first_scan(batches[0][0])] + batches[0][1:]
    hidx = OnchipProgressiveDecoder()
    runtime.reset_launches()
    fpx, fok = hidx.decode(bad)
    torch.cuda.synchronize()
    f_launches = dict(runtime.LAUNCHES)
    spx, sok = dec.decode(bad)
    fallback = {"refused": hidx.prep(bad).refused, "ok": bool(fok),
                "spec_launches": f_launches["dc_first_spec"],
                "hostindex_launches": f_launches["dc_first"],
                "equals_spec_decode": bool(fok) == bool(sok) and torch.equal(fpx, spx)}
    hidx.close()

    # DeviceProgressiveDecoder on the same batches
    ddec = DeviceProgressiveDecoder()
    ddec.decode(batches[1])
    torch.cuda.synchronize()
    runtime.reset_launches()
    dpx = ddec.decode(batches[0])
    torch.cuda.synchronize()
    d_launches = dict(runtime.LAUNCHES)
    delta = {"launches": d_launches, "host_decoder_err":
             max(host_decoder_err(dpx[i], batches[0][i]) for i in (0, 1)),
             "equals_spec_route": torch.equal(dpx, px)}
    dstages = []
    for b in batches[1:]:
        with EventClock([(ps, "delta_add_segments", "delta_add"),
                         (pd, "decode_batch_planes", "component_planes"),
                         (ddec, "_upload", "h2d")], [(ddec, "record", "host_record")]) as clk:
            t0 = time.perf_counter()
            ddec.decode(b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        st = clk.ms()
        st["e2e"] = wall
        dstages.append(st)
    delta["stage_ms_mean"] = {k: float(np.mean([s[k] for s in dstages])) for k in dstages[0]}
    delta["e2e_mpix_per_s"] = mpix / (delta["stage_ms_mean"]["e2e"] / 1e3)
    ddec.close()
    del dpx, tpx, fpx, spx

    # BatchQoiDecoder: K23 against its plain version, the host decoder and
    # HostIndexQoiDecoder (lane); passes and chunks; stages; an overflow
    qdec, lane = BatchQoiDecoder(), HostIndexQoiDecoder()
    qoi_out, k23 = {}, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "ops": 0,
                        "stream_bytes": 0}
    for content, qb in qoi.items():
        plan = qdec.prep(qb[0])
        bufs = qdec.upload(plan)
        runtime.reset_launches()
        qpx, qok = qdec.run(plan, bufs)
        torch.cuda.synchronize()
        ql = runtime.LAUNCHES["qoi_spec"]
        passes = qdec.last_rounds.cpu().tolist()
        kw = dict(n_chunks=plan.n_chunks, chunk_bytes=plan.chunk_bytes, ops_cap=plan.chunk_bytes,
                  height=SIZE, width=SIZE)
        stats = {}
        t0 = time.perf_counter()
        ppx, pok, _ = qs.spec_decode_plain(*bufs, **kw, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = cuda_ms(lambda: qs.spec_decode(*bufs, **kw), 3)
        err = max(max_abs_err(qpx, ppx), int(bool(qok) != bool(pok)))
        host = qoi_host_pixels(qb[0][:2])
        lane_px = lane.decode(qb[0])
        qst = []
        for b in qb[1:]:
            t0 = time.perf_counter()
            pl = qdec.prep(b)
            host_ms = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            ev[0].record()
            bb = qdec.upload(pl)
            ev[1].record()
            qdec.run(pl, bb)
            ev[2].record()
            torch.cuda.synchronize()
            qst.append({"host_prep": host_ms, "h2d": ev[0].elapsed_time(ev[1]),
                        "qoi_spec": ev[1].elapsed_time(ev[2]),
                        "e2e": host_ms + ev[0].elapsed_time(ev[2])})
        mean = {k: float(np.mean([s[k] for s in qst])) for k in qst[0]}
        walls, _, _, _ = timed_decodes(lambda d: qdec.decode(d)[0], qb[1:])
        qoi_out[content] = {
            "ok": bool(qok), "plain_ok": bool(pok), "max_abs_err_vs_plain": err,
            "host_decoder_err": max_abs_err(qpx[:2].cpu(), torch.from_numpy(host)),
            "lane_err": max_abs_err(qpx, lane_px), "launches": ql,
            "passes": passes, "plain_passes": stats["passes"], "chunks": plan.n_chunks,
            "chunk_bytes": plan.chunk_bytes, "chunk_ops": stats["chunk_ops"], "ops": stats["ops"],
            "stream_bytes": int(plan.stream.nbytes), "ms": ms, "plain_ms": plain_ms,
            "stage_ms_mean": mean, "e2e_ms": [w * 1e3 for w in walls],
            "e2e_mpix_per_s": mpix / float(np.mean(walls))}
        k23["max_abs_err"] = max(k23["max_abs_err"], err)
        for k in ("ms", "plain_ms", "ops", "stream_bytes"):
            k23[k] += qoi_out[content][k]
        del qpx, ppx, lane_px
    over = BatchQoiDecoder(ops_cap=SPEC_OPS_CAP)
    opx, ook = over.decode(qoi["noise"][0][:2])
    verified = over.decode_verified(qoi["noise"][0][:2])
    qoi_out["ops_cap_overflow"] = {
        "ops_cap": SPEC_OPS_CAP, "ok": bool(ook),
        "verified_host_err": max_abs_err(torch.from_numpy(verified),
                                         torch.from_numpy(qoi_host_pixels(qoi["noise"][0][:2])))}

    summary = {"content_seconds": content_s, "max_abs_err": errs, "kernels_ok": kernels_ok,
               "scans": scans, "spec": route, "tail": tail, "fallback": fallback,
               "delta": delta, "qoi": qoi_out,
               "k22_inputs": {"elements": k22_elems, "rows": [list(i.shape) for i, _ in dv]}}
    # timing entries: the main path's launches and this run's inputs; the
    # chain bounds are one chunk's symbols (ops), whatever a design repeats
    dc = [s for s in scans if s["kind"] == "dc_first_spec"]
    ac = [s for s in scans if s["kind"] == "ac_first_spec"]
    chain = {k: max(s["chunk_symbols"] for s in v)
             for k, v in (("dc_first_spec", dc), ("ac_first_spec", ac))}
    nblk_dc = sum(s["blocks"] for s in dc)
    entries = {
        "dc_first_spec": {
            "ms": sum(s["ms"] for s in dc), "plain_ms": sum(s["plain_ms"] for s in dc),
            "bytes": sum(s["stream_bytes"] for s in dc) + 4 * nblk_dc,
            "ops": (OPS_K2_SYMBOL + OPS_K8_BLOCK) * nblk_dc, "launches": launches["dc_first_spec"],
            "max_abs_err": errs["dc_first_spec"], "library_ms": None,
            "chain_bound_ms": chain["dc_first_spec"] * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3,
            "misses": {s["scan"]: s["rounds"] for s in dc}},
        "ac_first_spec": {
            "ms": ac_group["ms"], "plain_ms": ac_group["plain_ms"], "scans": ac_group["scans"],
            # the stream read, the valid blocks' band rows written
            "bytes": sum(s["stream_bytes"] for s in ac) + 4 * 63 * sum(s["blocks"] for s in ac),
            "ops": OPS_K2_SYMBOL * sum(s["blocks"] for s in ac),
            "launches": launches["ac_first_spec"], "max_abs_err": errs["ac_first_spec"],
            "library_ms": None,
            "chain_bound_ms": chain["ac_first_spec"] * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3,
            "misses": {s["scan"]: s["rounds"] for s in ac}},
        "delta_add": {
            "ms": k22_ms, "plain_ms": k22_plain_ms, "library_ms": k22_lib_ms,
            "library_call": "Tensor.scatter_add_(1, idx.long(), val), a call a component",
            "bytes": 16 * k22_elems, "ops": OPS_K22_ELEMENT * k22_elems,
            "launches": d_launches["delta_add"], "max_abs_err": errs["delta_add"],
            "launches_tail": tail["launches"]["delta_add"]},
        "qoi_spec": {
            "ms": k23["ms"], "plain_ms": k23["plain_ms"], "library_ms": None,
            "bytes": k23["stream_bytes"] + 2 * 4 * BATCH * SIZE * SIZE,
            "ops": OPS_K23_OP * k23["ops"] + OPS_K23_PIXEL * 2 * BATCH * SIZE * SIZE,
            "launches": qoi_out["noise"]["launches"], "max_abs_err": k23["max_abs_err"],
            "passes": {c: qoi_out[c]["passes"] for c in ("noise", "screen")},
            "chunks": {c: qoi_out[c]["chunks"] for c in ("noise", "screen")},
            "chain_bound_ms": max(qoi_out[c]["chunk_ops"] for c in ("noise", "screen"))
            * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3}}
    dec.close()
    return summary, entries


def spec_check(sp) -> None:
    from zpix_tpu_torch.ops.prog_spec import AC_FIRST_KERNELS, DC_FIRST_KERNELS

    r, t, f, d, q = sp["spec"], sp["tail"], sp["fallback"], sp["delta"], sp["qoi"]
    if any(sp["max_abs_err"].values()) or not sp["kernels_ok"]:
        raise SystemExit("chip_smoke: K20-K22 disagree with their plain versions")
    lr = r["launches"]
    if (not r["ok"] or r["n_host_tail_scans"] or r["host_decoder_err"]
            or lr["dc_first_spec"] != DC_FIRST_KERNELS or lr["ac_first_spec"] != AC_FIRST_KERNELS
            or lr["dc_first"] or lr["ac_first"]
            or min(lr["ac_refine"], lr["dc_refine"], lr["component_planes"]) == 0
            or r["flag_fetch_bytes"] == 0):
        raise SystemExit("chip_smoke: the spec route is wrong or skipped a kernel")
    if not t["ok"] or t["n_host_tail_scans"] != 5 or t["host_decoder_err"] or (
            t["launches"]["delta_add"] != 1 or t["launches"]["ac_first_spec"] != AC_FIRST_KERNELS):
        raise SystemExit("chip_smoke: the spec route's host tail is wrong")
    if not f["refused"] or not f["spec_launches"] or not f["equals_spec_decode"]:
        raise SystemExit("chip_smoke: a refused walk did not take the spec path")
    if d["host_decoder_err"] or not d["equals_spec_route"] or d["launches"]["delta_add"] != 1:
        raise SystemExit("chip_smoke: DeviceProgressiveDecoder is wrong")
    for c in ("noise", "screen"):
        e = q[c]
        if (not e["ok"] or not e["plain_ok"] or e["max_abs_err_vs_plain"]
                or e["host_decoder_err"] or e["lane_err"] or e["launches"] != 1
                or max(e["passes"]) != e["plain_passes"]):
            raise SystemExit(f"chip_smoke: BatchQoiDecoder is wrong on {c}")
    if q["ops_cap_overflow"]["ok"] or q["ops_cap_overflow"]["verified_host_err"]:
        raise SystemExit("chip_smoke: an ops_cap overflow was not flagged")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--distributed-worker"]:  # a process of the mesh phase
        return distributed_worker(*sys.argv[2:4])
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
    packed = fe.parse(batches_rf[0])
    flat = pb.upload(packed, dev)
    dims = packed.dims
    k7_comps = [ks.SparseComponent(pb.carve(flat, packed.layout, "bm", c, BATCH),
                                   pb.carve(flat, packed.layout, "val", c, BATCH), bv, bh, pm)
                for c, ((bv, bh), pm) in enumerate(zip(dims, packed.perms))]
    runtime.reset_launches()
    grids = ks.unpack_components(k7_comps)  # the decode's K7: one launch
    k7_full_launches = runtime.LAUNCHES["unpack_sparse"]
    results["unpack_sparse"] = max([int(k7_full_launches != 1)] + [
        max_abs_err(g, w) for g, w in zip(grids, ks.unpack_components_plain(k7_comps))])
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
    k4k6 = backend_checks(dev)
    for k, err in k4k6.items():
        key = "backend" if k.startswith("backend") else "component_planes"
        results[key] = max(results[key], err)
    edges7_3 = k7_k3_edge_checks(dev)
    for k, err in edges7_3.items():
        key = "unpack_sparse" if k.startswith("k7") else "dc_restore"
        results[key] = max(results[key], err)
    # K3 on the host-index and sync batches' whole-image chains (look-back)
    # and on DRI 8's segments
    hplan, hbufs, hac, hdc = host_index_inputs(batches_rf[0])
    sdc, splan = sync_dc_input(batches_rf[0])
    hdc_p = ke.dc_restore_plain(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus)
    k3_routes = {
        "host_index": max_abs_err(ke.dc_restore(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus),
                                  hdc_p),
        "sync": max_abs_err(ke.dc_restore(sdc, hv=splan.hv, seg_mcus=splan.seg_mcus),
                            ke.dc_restore_plain(sdc, hv=splan.hv, seg_mcus=splan.seg_mcus)),
        "dri8": max_abs_err(ke.dc_restore(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus), dc_p)}
    results["dc_restore"] = max(results["dc_restore"], *k3_routes.values())
    writer = jpeg_writer()
    edges = k1_k2_edge_checks(dev, writer, hplan, hbufs, hac, hdc, batches_rf[0])
    for row in edges.values():
        for k in ("index_pass", "value_pass"):
            results[k] = max(results[k], row.get(k, 0))
    f3 = factor3_checks(dev, writer)
    for k, err in f3.items():
        key = "backend" if k.startswith("backend") else "component_planes"
        results[key] = max(results[key], err)
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "max_abs_err": results,
          "k1_k2_batches": [2, BATCH], "k3_k4_k5_shapes": {"lanes": L2, "blocks": L2},
          "k6_k7_small_cases": small, "k4_k6_cases": k4k6, "k3_routes": k3_routes,
          "k7_k3_edge_checks": edges7_3, "k7_full_batch_launches": k7_full_launches,
          "k1_k2_edge_checks": edges, "factor3_checks": f3,
          "k6_k7_full_batch": {"images": BATCH, "size": SIZE, "ratio": packed.ratio,
                               "value_caps": fe.val_caps, "nnz_max": packed.nnz.max(0).tolist()},
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
    host0 = host_decoder_err(pixels[0].permute(1, 2, 0), batches[0][0])
    emit({"phase": "main_path_check", "max_abs_err_vs_plain": main_err,
          "plain_ok": bool(o2), "idct_blocks_err": max_abs_err(idct_out[: 4 * nblk], blk_ref),
          "mean_abs_diff_vs_pillow": pil_diff, "max_abs_err_vs_host_decoder": host0})
    if (main_err or not bool(o2) or max_abs_err(idct_out[: 4 * nblk], blk_ref) or pil_diff > 8
            or host0):
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
    if (ln["unpack_sparse"] != 1 or ln["component_planes"] == 0 or lh["index_pass"]
            or min(lh["value_pass"], lh["dc_restore"], lh["backend"]) == 0):
        raise SystemExit("chip_smoke: a restart-free route skipped a kernel, or K7 took more "
                         "than one launch")
    c = rf["check"]
    if (c["native_vs_plain"] or c["host_index_vs_plain"] or not c["plain_ok"]
            or c["native_vs_host_decoder"] or c["host_index_vs_host_decoder"]
            or not c["routes_equal"] or not c["host_index_ok"] or not rf["all_ok"]
            or not all(rf["routes_equal_per_batch"])):
        raise SystemExit("chip_smoke: a restart-free route's output is wrong")
    if rf["corrupt"].get("ok", True):
        raise SystemExit("chip_smoke: a corrupt restart-free stream was not flagged")

    # ------------------------------------- restart-free, wholly on the card
    t0 = time.perf_counter()
    sy = sync_phase(batches_rf, hplan, mpix)  # hplan: the host index scan of batch 0
    emit({"phase": "sync", "seconds": time.perf_counter() - t0, **sy})
    sync_check(sy)

    # ------------------------------------------------------ progressive
    pg, prog_entries, prog_batches = progressive(dev)
    emit({"phase": "progressive", **pg})
    lp, pc = pg["launches"], pg["check"]
    if (min(lp[k] for k in PROG_KINDS + ("component_planes",)) == 0 or lp["dc_restore"]
            or lp["dc_first"] != 1 or lp["ac_first"] != 4):
        raise SystemExit("chip_smoke: the progressive route's launches are not K8 1, K3 0, K9 4")
    mx = pc["mixed_batch"]
    if (any(mx[k] for k in PROG_KINDS + ("component_planes_int32",))
            or mx["images_differ_store"] < len(MIXED_STREAMS)
            or mx["images_differ_pixels"] < len(MIXED_STREAMS) + len(MIXED_QUANTS)):
        raise SystemExit("chip_smoke: a progressive kernel disagrees on a mixed batch")
    re = pc["refine_edges"]
    if (any(v for k, v in re.items() if not k.endswith(("_ok", "_flagged")))
            or not all(v == 1 for k, v in re.items() if k.endswith("_ok"))
            or re["cut_flagged"] == 0):
        raise SystemExit("chip_smoke: K10 disagrees with its plain version on an edge case")
    fst = pc["first_edges"]
    if (any(v for k, v in fst.items() if not k.endswith(("_ok", "_flagged")))
            or not all(v == 1 for k, v in fst.items() if k.endswith("_ok"))
            or fst["dc_cut_flagged"] == 0):
        raise SystemExit("chip_smoke: K8 or K9 disagrees with its plain version on an edge case")
    if (any(pc["max_abs_err"].values()) or not pc["kernels_ok"] or not pc["main_ok"]
            or pc["main_vs_plain"] or not pc["plain_ok"] or pc["mean_abs_diff_vs_pillow"] > 8
            or pc["main_vs_host_decoder"]
            or pc["shape"] != [BATCH, SIZE, SIZE, 3] or not pg["all_ok"]):
        raise SystemExit("chip_smoke: the progressive route's output is wrong")
    if pg["corrupt"]["walk_refused_ok"] or pg["corrupt"]["changed_after_walk_ok"]:
        raise SystemExit("chip_smoke: a corrupt progressive stream was not flagged")

    # ------------------------- BatchJpegDecoder's Python front-end, K7, K6
    t0 = time.perf_counter()
    py, py_arms, py_k7, py_cmyk = python_front_end_phase(dev)
    emit({"phase": "python_front_end", "seconds": time.perf_counter() - t0, **py,
          "k6_arms": py_arms, "k7_by_kind": py_k7})
    python_front_end_check(py)

    # ------------------------------------------- QOI decode and encode, BMP
    raster_entries, raster_paths, raster_content = raster_slice(dev)

    # ------------------------------------------- pipeline: overlapped routes
    t0 = time.perf_counter()
    pp = pipeline_phase({"dri8": batches, "native": batches_rf, "host_index": batches_rf,
                         "sync": batches_rf, "progressive": prog_batches, **raster_content})
    emit({"phase": "pipeline", "seconds": time.perf_counter() - t0, **pp})
    if not all(r["pipelined_equal_serial"] and r["ok_equal"] for r in pp["routes"].values()):
        raise SystemExit("chip_smoke: a pipelined route's output differs from its serial decode")

    # ------------------------------------- decode_mixed: the router over them
    from zpix_tpu_torch.parallel import bucketing

    t0 = time.perf_counter()
    mixed_corpus = make_mixed_corpus(batches_rf[2], py_cmyk, prog_batches[2],
                                     *(raster_content[k][2] for k in ("qoi_noise_p4", "bmp_24bpp",
                                                                      "png_host")))
    mesh_content = {"dri8": batches[0], "rf": batches_rf[0],
                    "bmp": raster_content["bmp_24bpp"][0], "png": raster_content["png_host"][0],
                    "qoi": raster_content["qoi_noise_p4"][0]}
    del raster_content, prog_batches, py_cmyk
    content_s = time.perf_counter() - t0
    mx = mixed_phase(mixed_corpus)
    bucketing.close()
    emit({"phase": "decode_mixed", "seconds": time.perf_counter() - t0,
          "content_seconds": content_s, **mx})
    mixed_check(mx)

    # ------------------------------------ mesh: every mesh decoder, 1 and 4 shards
    t0 = time.perf_counter()
    ms = mesh_phase(mesh_content, [d for ds in mixed_corpus.values() for d in ds], smi)
    del mixed_corpus, mesh_content
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0, **ms})
    mesh_check(ms)

    # ------------------------- spec: the decoders with no host index walk
    t0 = time.perf_counter()
    sp, spec_entries = spec_phase(dev)
    emit({"phase": "spec", "seconds": time.perf_counter() - t0, **sp})
    spec_check(sp)

    # ------------------------------------------------------- kernel table
    ends, okf = ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk)
    ac, dc_diff = ke.value_pass(*bufs, ends, okf, bpm=plan.bpm)
    seg_syms, blk_syms, n_syms = segment_symbols(ac, dc_diff, seg_nmcu, nblk, plan.bpm)
    chain_ms = {k: n * CHAIN_CYCLES_PER_SYMBOL / BOOST_HZ * 1e3
                for k, n in (("index_pass", seg_syms), ("value_pass", blk_syms))}
    k1c, k2c, k3c, k4c = roofline.jpeg_onchip_costs(plan, stream_bytes=stream_used,
                                                    symbols=n_syms)
    timing = {
        "index_pass": (lambda: ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk),
                       lambda: ke.index_pass_plain(*bufs, bpm=plan.bpm, nblk=nblk),
                       k1c.bytes_moved, k1c.int_ops),
        "value_pass": (lambda: ke.value_pass(*bufs, ends, okf.clone(), bpm=plan.bpm),
                       lambda: ke.value_pass_plain(*bufs, ends, okf.clone(), bpm=plan.bpm),
                       k2c.bytes_moved, k2c.int_ops),
        "dc_restore": (lambda: ke.dc_restore(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus),
                       lambda: ke.dc_restore_plain(dc_diff, hv=plan.hv, seg_mcus=plan.seg_mcus),
                       k3c.bytes_moved, k3c.int_ops),
        "backend": (lambda: kb.backend(ac, dc_k, tables, geom, planar=True),
                    lambda: kb.backend_plain(ac, dc_k, tables, geom, planar=True),
                    k4c.bytes_moved, k4c.int_ops),
        "idct_blocks": (lambda: ki.idct_blocks(blocks), lambda: ki.idct_plain(blocks),
                        2 * blocks.numel() * 4, OPS_IDCT_BLOCK * blocks.shape[0]),
        # one decode's K7 (every component, one launch) and K6
        "unpack_sparse": (
            lambda: ks.unpack_components(k7_comps),
            lambda: ks.unpack_components_plain(k7_comps),
            (8 + 128) * rf_blocks + 2 * int(packed.nnz.sum()) + 4 * dims[0][0] * dims[0][1],
            OPS_K7_BLOCK * rf_blocks),
        "component_planes": (
            lambda: kp.component_planes(grids, rf_quants, **rf_kw),
            lambda: kp.component_planes_plain(grids, rf_quants, **rf_kw),
            128 * rf_blocks + 4 * 64 * 3 * BATCH + rf_px.numel(),
            OPS_K4_BLOCK * rf_blocks + OPS_K4_PIXEL * BATCH * SIZE * SIZE
            + OPS_K4_CHROMA * 64 * BATCH * packed.mxx * packed.myy),
    }
    # K3 on the host-index and sync routes' whole-image chains: time,
    # bound, launches, and the library yardstick on every input
    k3 = {"tile_mcus": ke.K3_TILE_MCUS, "dri8_launches": launches["dc_restore"],
          "host_index_launches": lh["dc_restore"], "sync_launches": sy["launches"]["dc_restore"]}
    for route, (d, p) in (("dri8", (dc_diff, plan)), ("host_index", (hdc, hplan)),
                          ("sync", (sdc, splan))):
        k3[f"{route}_ms"] = cuda_ms(lambda d=d, p=p: ke.dc_restore(d, hv=p.hv,
                                                                   seg_mcus=p.seg_mcus), 20)
        k3[f"{route}_cumsum_ms"] = cuda_ms(lambda d=d, p=p: cumsum_chains(d, p.hv, p.seg_mcus),
                                           20)
        k3[f"{route}_bound_ms"] = max(8 * d.numel() / HBM_BYTES_PER_S,
                                      d.numel() / INT32_OPS_PER_S) * 1e3
    k3["host_index_plain_ms"] = cuda_ms(
        lambda: ke.dc_restore_plain(hdc, hv=hplan.hv, seg_mcus=hplan.seg_mcus), 1)
    # K2 and K4 again on the host-index route's inputs (interleaved out)
    hok = torch.ones(1, dtype=torch.int32, device=dev)
    host_index_ms = {
        "value_pass": cuda_ms(lambda: ke.value_pass(*hbufs[:4], hbufs[4], hok.clone(),
                                                    bpm=hplan.bpm), 20),
        "backend": cuda_ms(lambda: kb.backend(hac, hdc_p, hbufs[3],
                                              kb.BackendGeometry.of(hplan), planar=False), 20),
    }
    paths = {"dri8": launches, "native": ln, "host_index": lh, "sync": sy["launches"],
             "progressive": lp, "python_front_end": py["launches"], **raster_paths,
             "decode_mixed": mx["launches_all"], "mesh": ms["launches_all"],
             "spec": sp["spec"]["launches"], "spec_tail": sp["tail"]["launches"],
             "delta": sp["delta"]["launches"]}
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
            row["routes"] = k3
            row["library_ms"] = k3["dri8_cumsum_ms"]
            row["library_call"] = "torch.cumsum(dtype=int32), a call a component"
        if kname == "unpack_sparse":
            row["library_note"] = "no single PyTorch call unpacks bits, clips and permutes"
            # the Python front-end's batches: 3 and 4 components, perm None
            row["python_front_end"] = py_k7
            row["max_abs_err"] = max(row["max_abs_err"], *(e["max_abs_err"]
                                                           for e in py_k7.values()))
            row["matches_plain"] = row["max_abs_err"] == 0
        if kname in host_index_ms:
            row["host_index_ms"] = host_index_ms[kname]
        if kname == "component_planes":  # the arms the Python front-end opens
            row["arms"] = py_arms
            row["max_abs_err"] = max(row["max_abs_err"], *(e["max_abs_err"]
                                                           for e in py_arms.values()))
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
            **{k: e[k] for k in ("restore_ms_taken_off", "sector_bound_ms", "prediction_ms",
                                 "library_note") if k in e},
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
    kernels.append(sync_entry(batches_rf[0], hplan, hac, sy, by_path["sync_decode"]))
    for kname in SPEC_KINDS:
        e = dict(spec_entries[kname])
        ms_bound, by = roofline.bound_ms(e.pop("bytes"), e.pop("ops"))
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": e.pop("launches"),
            "launches_by_path": by_path[kname], "max_abs_err": e["max_abs_err"],
            "matches_plain": e.pop("max_abs_err") == 0, "ms": e.pop("ms"),
            "plain_ms": e.pop("plain_ms"), "bound_ms": ms_bound, "bound_by": by,
            "library_ms": e.pop("library_ms"), **e})
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
