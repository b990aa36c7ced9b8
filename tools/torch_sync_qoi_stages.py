#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's K19 (the JPEG chunk sync) and K14 (the
QOI encoder), launch by launch, on chip_smoke.py's content.

    python3 tools/torch_sync_qoi_stages.py [--root CHECKOUT] [--tag NAME]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py.

K19: the restart-free batch 0 of chip_smoke.py (16 distinct 1024x1024
4:2:0 q50 JPEGs, no DRI) through ``prep_batch_sync`` at 32-byte chunks:
the time of a call (CUDA events, mean of 10 after a warm-up), every CUDA
kernel and memset of one call in launch order with its device time (from
``torch.profiler``), the link misses, the peak memory of a call, the
chunks and sync chunks an image, the Huffman symbols an image (counted in
plain PyTorch from K2's coefficients on the host-index route), for each
sync chunk the number of distinct exits among its bpm slot guesses
(histogram and mean, from the guess scan in plain PyTorch) and of
distinct link exits, and the time and misses at sync chunks of 64, 128
and 256 bytes.

K14: the noise and screen batches of chip_smoke.py's qoi_encode phase (16
distinct 1024x1024 images each, decoded by the port's host decoder and
packed on the card): the time of a call, its launches with their device
times, its peak memory, the stream bytes, and whether the kernel's bytes
equal the plain version's.  Prints one JSON object; needs a CUDA device,
exits 1 without.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # hold the stream while the launches queue
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


def distinct_candidates(ksync, b, *, chunk_bytes, n_chunks, bpm):
    """The guess and link scans of sync_ends_plain, in plain PyTorch -> per
    sync chunk (chunk 0 and empty chunks left out): the number of distinct
    exits among its bpm slot guesses, and among its link exits."""
    from zpix_tpu_torch.ops.entropy import _Tables

    stream, starts, ends, tables = b[0], b[1], b[4], b[3]
    tab, s64, cap = _Tables(tables), stream.to(torch.int64), stream.shape[0]
    m = ksync.sync_factor(chunk_bytes)
    B, Fc, V = starts.shape[0], -(-n_chunks // m), bpm
    cs, ce = ksync.chunk_bounds(starts, ends, n_chunks=Fc, chunk_bytes=m * chunk_bytes)
    cs, ce = cs.view(B, Fc), ce.view(B, Fc)
    g = cs[None].expand(V, B, Fc).reshape(-1)
    slot = torch.arange(V, device=cs.device)[:, None, None].expand(V, B, Fc).reshape(-1)
    z = torch.zeros_like(g)
    ex, *_ = ksync._scan(tab, s64, cap, (g, slot, z, z), ce[None].expand(V, B, Fc).reshape(-1),
                         bpm)
    X = ksync.pack_entries(*ex).view(V, B, Fc)
    ent = ksync.unpack_entries(X[:, :, :-1].reshape(-1))
    ex, *_ = ksync._scan(tab, s64, cap, ent, ce[None, :, 1:].expand(V, B, Fc - 1).reshape(-1),
                         bpm)
    Y = ksync.pack_entries(*ex).view(V, B, Fc - 1)

    def distinct(T):  # [V, N] -> [N]
        s = T.sort(0).values
        return 1 + (s[1:] != s[:-1]).sum(0)

    live = (cs < ce)[:, 1:].reshape(-1)  # guesses of chunks 1.. that hold bits
    dx = distinct(X[:, :, 1:].reshape(V, -1))[live]
    dy = distinct(Y.reshape(V, -1))[live]
    hist = lambda d: torch.bincount(d, minlength=V + 1)[1:].tolist()  # noqa: E731
    return {"guess_distinct_hist": hist(dx), "guess_distinct_mean": float(dx.float().mean()),
            "link_distinct_hist": hist(dy), "link_distinct_mean": float(dy.float().mean()),
            "sync_chunks_counted": int(live.sum())}


def k19(cs, res):
    from zpix_tpu_torch import SyncJpegDecoder, prep_batch_sync, runtime
    from zpix_tpu_torch.ops import sync as ksync

    batch = cs.make_batch(100, dri=None)  # chip_smoke's restart-free batch 0
    plan = prep_batch_sync(batch)
    b = SyncJpegDecoder().upload(plan)
    kw = dict(chunk_bytes=plan.chunk_bytes, n_chunks=plan.n_chunks, bpm=plan.bpm,
              nblk=plan.n_mcu * plan.bpm)
    call = lambda: ksync.sync_ends(b[0], b[1], b[4], b[3], **kw)  # noqa: E731
    runtime.reset_launches()
    ends, ok, entries, misses = call()
    torch.cuda.synchronize()
    n_launch = runtime.LAUNCHES["sync_decode"]
    pe, pok, pent, pmisses = ksync.sync_ends_plain(b[0], b[1], b[4], b[3], **kw)
    _hplan, _hbufs, hac, _hdc = cs.host_index_inputs(batch)
    syms = cs.block_symbols(hac).view(len(batch), -1).sum(1)
    m = ksync.sync_factor(plan.chunk_bytes)
    bits = torch.as_tensor(plan.img_bit_end - plan.img_bit_start).long()
    out = {"ms": events_ms(call, 10), "launches_counted": n_launch, "launches": launches(call),
           "misses": int(misses), "plain_misses": pmisses, "ok": bool(ok),
           "equal_plain": bool(torch.equal(ends, pe) and torch.equal(entries, pent)
                               and torch.equal(ok, pok)),
           "chunk_bytes": plan.chunk_bytes, "sync_chunk_bytes": m * plan.chunk_bytes,
           "chunks_per_image_max": plan.n_chunks, "bpm": plan.bpm,
           "scan_bytes_per_image": (bits // 8).tolist(),
           "chunks_per_image": (-(-bits // (8 * plan.chunk_bytes))).tolist(),
           "sync_chunks_per_image": (-(-bits // (8 * m * plan.chunk_bytes))).tolist(),
           "symbols_per_image": syms.tolist(),
           **distinct_candidates(ksync, b, chunk_bytes=plan.chunk_bytes,
                                 n_chunks=plan.n_chunks, bpm=plan.bpm)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    sweep = {}
    for sb in (64, 128, 256):
        got = ksync.sync_ends(b[0], b[1], b[4], b[3], sync_bytes=sb, **kw)
        sweep[sb] = {"misses": int(got[3]), "equal_default": bool(
            torch.equal(got[0], ends) and torch.equal(got[2], entries) and torch.equal(got[1], ok)),
            "ms": events_ms(lambda sb=sb: ksync.sync_ends(b[0], b[1], b[4], b[3], sync_bytes=sb,
                                                           **kw), 10)}
    out["sync_bytes_sweep"] = sweep
    res["k19"] = out


def k14(cs, res):
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.codecs.qoi.encode import Desc
    from zpix_tpu_torch.ops import qoi as kq
    from zpix_tpu_torch.parallel.qoi_batch import _pack_px

    dev = torch.device("cuda")
    d = Desc(cs.SIZE, cs.SIZE, 4, 0)
    for content in ("noise", "screen"):
        px = torch.from_numpy(cs.qoi_host_pixels(cs.make_qoi_batches(content, [0])[0])).to(dev)
        pk = torch.stack([_pack_px(px[i], d, dev) for i in range(px.shape[0])])
        del px
        call = lambda: kq.encode(pk)  # noqa: E731
        runtime.reset_launches()
        out, tot = call()
        torch.cuda.synchronize()
        n_launch = runtime.LAUNCHES["qoi_encode"]
        po, pt = kq.encode_plain(pk)
        same = bool(torch.equal(out, po) and torch.equal(tot, pt))
        stream_bytes = int(tot.sum())
        del out, tot, po, pt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        res[f"k14_{content}"] = {
            "ms": events_ms(call, 20), "launches_counted": n_launch, "launches": launches(call),
            "peak_mem_bytes": torch.cuda.max_memory_allocated() - base,
            "stream_bytes": stream_bytes, "pixels": pk.numel(), "equal_plain": same}
        del pk


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sync_qoi_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = {"tag": args.tag, "root": os.path.relpath(os.path.abspath(args.root), HERE),
           "card": smi, "torch": torch.__version__}
    cs = smoke()
    k19(cs, res)
    k14(cs, res)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
