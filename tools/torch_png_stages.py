#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's PNG kernels K15 (defilter) and K16
(LZ77 resolve) and of the adler32 trailer check, launch by launch, on one
batch of the JAX bench's PNG content (16 distinct 1024x1024 RGB8 files,
Pillow at compress_level 6).

    python3 tools/torch_png_stages.py [--root CHECKOUT] [--tag NAME] [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's tests/_torch_png.py.

It prints one JSON object: the card's name and power limit; K15's time a
call (CUDA events, mean of 5 launches after a warm-up) and a wavefront
step (time over H + W - 1 = 2,047 steps), and the batch's rows by filter
type; K16's time a call, its launches, its peak memory above the inputs,
the tokens an image, and the bytes of each image whose copy chain leaves
its 32 KiB tile (computed from the tokens in plain PyTorch); for each
kernel, every CUDA kernel and memset of one call in launch order with its
device time, from ``torch.profiler``.  The adler32 check on K16's output
of that batch (the bytes the device_inflate route checks, with their
trailers): the time of a call (CUDA events, mean of 20), its CTAs (one an
image before the span design, ``ceil(per / ADLER_SPAN)`` an image since)
and the SMs they can occupy, ns a byte, the bytes bound (the batch read
once at 3.35 TB/s) and its share of the time, each CUDA kernel and memset
of a call, and whether the sums equal the plain version's and the flag
stays 0; with ``--sweep``, the same call at each span of ``SPANS`` (a
checkout with ``ADLER_SPAN``).  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE, TILE = 16, 1024, 32768
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate (chip_smoke.py's)
SPANS = (4096, 16384, 32768, 65536, 131072, 262144, 1 << 20)  # adler32 spans swept


def writer():
    spec = importlib.util.spec_from_file_location(
        "_torch_png", os.path.join(HERE, "tests", "_torch_png.py"))
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


def cross_tile_bytes(lens, dists, per: int) -> list:
    """Each image's bytes whose copy chain leaves its TILE-byte tile: the
    root of the chain (found by pointer doubling) lies in an earlier tile."""
    B = lens.shape[0]
    ln = lens.long()
    starts = torch.cumsum(ln, 1) - ln
    pos = torch.arange(per, device=lens.device).expand(B, per).contiguous()
    tok = torch.searchsorted(starts, pos, right=True) - 1
    d = torch.gather(dists.long(), 1, tok)
    src = torch.where(d > 0, pos - d, pos)
    while True:
        nxt = torch.gather(src, 1, src)
        if torch.equal(nxt, src):
            break
        src = nxt
    return ((src // TILE) != (pos // TILE)).sum(1).tolist()


def adler32_stages(ki, flat, trailers, sweep: bool) -> dict:
    """The trailer check on K16's output ``flat`` [B, per]: time, CTAs, ns
    a byte, bound, launches; the span sweep where the checkout has one."""
    B, per = flat.shape
    bad = torch.zeros(1, dtype=torch.int32, device=flat.device)
    call = lambda: ki.adler32_check(flat, trailers, bad)  # noqa: E731
    same = bool(torch.equal(call(), ki.adler32_plain(flat, trailers, torch.zeros_like(bad))))
    bound_ms = flat.numel() / HBM_BYTES_PER_S * 1e3
    sms = torch.cuda.get_device_properties(flat.device).multi_processor_count

    def one(span):
        ms = events_ms(call, 20)
        ctas = B * (-(-per // span) if span else 1)
        return {"span": span, "ms": ms, "ctas": ctas, "sms_used": min(ctas, sms),
                "ns_per_byte": ms * 1e6 / flat.numel(), "share_of_bound": bound_ms / ms}

    span = getattr(ki, "ADLER_SPAN", None)
    out = {"per": per, "batch": B, "bytes": flat.numel(), "bound_ms": bound_ms, "sms": sms,
           "equal_plain": same, **one(span), "launches": launches(call)}
    out["flag_clear"] = int(bad) == 0
    if sweep and span is not None:
        out["sweep"] = []
        for s in SPANS:
            ki.ADLER_SPAN = s
            ok = bool(torch.equal(call(), ki.adler32_plain(flat, trailers,
                                                           torch.zeros_like(bad))))
            out["sweep"].append({**one(s), "equal_plain": ok})
        ki.ADLER_SPAN = span
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--sweep", action="store_true", help="time the adler32 check at SPANS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_png_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from zpix_tpu_torch import BatchPngDecoder, runtime
    from zpix_tpu_torch.ops import defilter as kd
    from zpix_tpu_torch.ops import inflate as ki

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    w = writer()
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        datas = list(ex.map(lambda j: w.make_bench_png(SIZE, j), range(BATCH)))
    res = {"tag": args.tag, "root": os.path.relpath(os.path.abspath(args.root), HERE),
           "card": smi, "torch": torch.__version__}

    dfl = BatchPngDecoder(device_defilter=True)
    plan = dfl.prep(datas)
    stream = dfl.upload(plan)[0][:, : SIZE * (1 + 3 * SIZE)].view(BATCH, SIZE, 1 + 3 * SIZE)
    raw, ft = stream[:, :, 1:], stream[:, :, 0]
    k15 = lambda: kd.png_defilter(raw, ft, bpp=3)  # noqa: E731
    ms = events_ms(k15, 5)
    res["k15"] = {"ms": ms, "us_per_step": ms * 1e3 / (2 * SIZE - 1),
                  "equal_plain": bool(torch.equal(k15(), kd.png_defilter_plain(raw, ft, bpp=3))),
                  "rows_by_type": torch.bincount(ft.reshape(-1).long(), minlength=5).tolist(),
                  "launches": launches(k15)}
    dfl.close()
    del stream, raw, ft

    inf = BatchPngDecoder(device_inflate=True)
    plan = inf.prep(datas)
    bufs = inf.upload(plan)
    toks = [b[:, : plan.nt] for b in bufs[:3]]
    per = plan.per

    def k16():
        got = ki.inflate_resolve(*toks, per)
        return got[0] if isinstance(got, tuple) else got  # the parent returned (bytes, moved)

    runtime.reset_launches()
    got = k16()
    torch.cuda.synchronize()
    out = {"per": per, "nt": plan.nt, "tokens_per_image": (toks[0] > 0).sum(1).tolist(),
           "launches_counted": runtime.LAUNCHES["inflate_resolve"],
           "equal_plain": bool(torch.equal(got, ki.inflate_resolve_plain(*toks, per)[0])),
           "ms": events_ms(k16, 10), "launches": launches(k16)}
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k16()
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    out["cross_tile_bytes"] = cross_tile_bytes(toks[0], toks[1], per)
    res["k16"] = out
    flat = k16()
    res["adler32"] = adler32_stages(ki, flat, bufs[3], args.sweep)
    del flat
    inf.close()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
