#!/usr/bin/env python3
"""Where ``decode_mixed``'s time goes: chip_smoke.py's mixed corpus
(107 images of 1024x1024, the ``decode_mixed`` phase's; min_batch 2)
bucket by bucket, each stage of the router's route timed on its own.

    python3 tools/torch_mixed_stages.py [--reps N]

For each bucket of ``plan_buckets`` (in the router's order), the steps
``zpix_tpu_torch.parallel.bucketing`` takes for it, on the router's own
cached decoders:

* a device route: the decoder's host ``prep`` (the progressive bucket:
  the parse and the ``script_key`` split, then each group's prep), then
  ``upload`` and ``run`` to a synchronised end (host clock; CUDA events
  around them give the device window, copy included), the one copy of the
  bucket's pixels to the host (``.cpu().numpy()``), and the numpy
  conversion to RGBA8 (``_to_rgba``, or ``_cmyk_to_rgba`` for CMYK/YCCK);
* a host route (host-routed, host-small): the host decoders
  (``_host_rgba``), image by image.

Each stage's median over ``--reps`` rounds (one warm round first), their
sum a call, ``plan_buckets``' probe time, and the median wall of whole
``decode_mixed`` calls on the same list for comparison.  Prints one JSON
object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(cs) -> list:
    """chip_smoke.py's decode_mixed corpus (its content seeds), shuffled
    as the phase shuffles it."""
    with ThreadPoolExecutor(os.cpu_count() or 2) as ex:
        cmyk = list(ex.map(lambda j: cs.make_py_image("cmyk_444", 5000 + 100 + 2 * cs.BATCH + j,
                                                      cs.SIZE), range(cs.BATCH)))
        png = list(ex.map(lambda j: cs.png_writer().make_bench_png(cs.SIZE, 2 * cs.BATCH + j),
                          range(cs.BATCH)))
    groups = cs.make_mixed_corpus(cs.make_batch(102, dri=None), cmyk,
                                  cs.make_prog_batches([2])[0],
                                  cs.make_qoi_batches("noise", [2])[0],
                                  cs.make_bmp_batch(cs.BMP_TIMED["24bpp"], 902), png)
    items = [d for ds in groups.values() for d in ds]
    order = np.random.default_rng(18).permutation(len(items))
    return [items[i] for i in order]


class Clock:
    """Named host-clock stages a bucket, summed within a round."""

    def __init__(self):
        self.ms: dict = {}

    def add(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (t - t0) * 1e3
        return t


def device_round(dec, prep, clock, conv) -> tuple:
    """upload + run to a synchronised end, the copy, the conversion ->
    (run's output, the RGBA8 list)."""
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    out = dec.run(prep, dec.upload(prep))
    ev1.record()
    torch.cuda.synchronize()
    t0 = clock.add("upload_run", t0)
    clock.ms["device_window"] = clock.ms.get("device_window", 0.0) + ev0.elapsed_time(ev1)
    px = out[0] if isinstance(out, tuple) else out
    arr = px.cpu().numpy()
    t0 = clock.add("d2h", t0)
    rgba = conv(arr)
    clock.add("convert", t0)
    return out, rgba


def bucket_round(b, key, datas, dev, min_batch: int) -> tuple:
    """One bucket through the router's steps, each timed -> (route, {stage:
    ms}, RGBA8 list)."""
    from zpix_tpu_torch.parallel.progressive_onchip import parse_progressive, script_key

    clock = Clock()
    kind = key[0]
    t0 = time.perf_counter()
    if (len(datas) < min_batch or "host" in key
            or (kind == "jpeg" and key[5] and key[3] == 4)):
        rgba = [b._host_rgba(d) for d in datas]
        clock.add("host_decode", t0)
        return ("host-small" if len(datas) < min_batch else "host-routed"), clock.ms, rgba
    if kind == "jpeg" and key[5]:
        dec = b.decoder("progressive", dev)
        plans = [parse_progressive(d) for d in datas]
        groups: dict = {}
        for i, p in enumerate(plans):
            groups.setdefault(script_key(p), []).append(i)
        t0 = clock.add("parse_split", t0)
        rgba = [None] * len(datas)
        for idxs in groups.values():
            t0 = time.perf_counter()
            prep = dec.prep_plans([plans[i] for i in idxs])
            clock.add("prep", t0)
            (_px, ok), got = device_round(dec, prep, clock, lambda a: list(b._to_rgba(a)))
            assert bool(ok)
            for i, o in zip(idxs, got):
                rgba[i] = o
        clock.ms["groups"] = len(groups)
        return "device", clock.ms, rgba
    dec = b.decoder(kind, dev)
    prep = dec.prep(datas)
    clock.add("prep", t0)
    conv = (lambda a: list(b._cmyk_to_rgba(a))) if kind == "jpeg" and key[3] == 4 else (
        lambda a: list(b._to_rgba(a)))
    return "device", clock.ms, device_round(dec, prep, clock, conv)[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mixed_stages: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    cs = smoke()
    from zpix_tpu_torch.parallel import bucketing as b

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    datas = corpus(cs)
    content_s = time.perf_counter() - t0
    min_batch = cs.MIXED_MIN_BATCH
    want = b.decode_mixed(datas, min_batch=min_batch)  # warm: the decoders, pools, caches
    torch.cuda.synchronize()
    walls, probe_ms = [], []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        b.decode_mixed(datas, min_batch=min_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plan = b.plan_buckets(datas)
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    rounds: dict = {}
    equal = True
    for _ in range(args.reps):
        for key, idxs in plan.items():
            route, ms, rgba = bucket_round(b, key, [datas[i] for i in idxs], dev, min_batch)
            equal &= all(np.array_equal(r, want[i]) for r, i in zip(rgba, idxs))
            row = rounds.setdefault(str(key), {"images": len(idxs), "route": route, "ms": []})
            row["ms"].append(ms)
    buckets = {}
    for k, row in rounds.items():
        med = {s: float(np.median([m[s] for m in row["ms"]])) for s in row["ms"][0]}
        buckets[k] = {"images": row["images"], "route": row["route"], "median_ms": med,
                      "total_ms": sum(v for s, v in med.items()
                                      if s not in ("device_window", "groups"))}
    by_stage: dict = {}
    for v in buckets.values():
        for s, ms in v["median_ms"].items():
            if s != "groups":
                by_stage[s] = by_stage.get(s, 0.0) + ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    b.close()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "reps": args.reps,
        "images": len(datas), "mpix": sum(w.shape[0] * w.shape[1] for w in want) / 1e6,
        "content_seconds": content_s, "outputs_equal_decode_mixed": bool(equal),
        "decode_mixed_wall_ms": walls, "decode_mixed_median_ms": float(np.median(walls)),
        "plan_buckets_ms": float(np.median(probe_ms)),
        "stages_sum_ms": sum(v["total_ms"] for v in buckets.values()),
        "by_stage_ms": by_stage, "buckets": buckets}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
