#!/usr/bin/env python3
"""Device times of zpix_tpu_torch's entropy kernels K1 (index pass) and K2
(value pass), csrc/entropy.cu, on chip_smoke.py's content, with the work
each does.

    python3 tools/torch_entropy_stages.py [--root CHECKOUT] [--tag NAME]
                                          [--sweep]

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one), so that two versions of the kernels can be timed in
one run on one card (for example a ``git archive`` of the parent commit
unpacked into a directory that .gitignore lists: parent, change, change,
parent).  The content comes from this checkout's chip_smoke.py: 16
distinct 1024x1024 4:2:0 q50 JPEGs a batch.

Three inputs: ``dri8`` (the main path's batch 0, a restart marker every 8
MCUs: K1, then K2 on its ends), ``host_index`` (the restart-free batch 0
through the host index scan: K2 on whole-image chains) and ``sync`` (the
same batch through K19: K2 on its ends, over the sync route's stream
layout).  Each kernel: the time of a call (CUDA events, mean of 20 behind
a spin kernel, as chip_smoke.py times kernels), its counted launches, each
CUDA kernel of one call with its device time (``torch.profiler``), and
whether it equals its plain version (outputs and ``ok``).

The work: K1's longest segment in symbols and the time a symbol of it
(the pass is bound by that chain); K2's longest block, the sum over
groups of 32 consecutive blocks of each group's longest block (the
symbol steps of a warp that walks 32 blocks), and all symbols; symbols
whose code is longer than the lookahead table's 10 bits.  ``k1_walk``
replays the old kernel's 64-bit window on the dri8 segments (plain
PyTorch, a warp = 32 consecutive lanes): the share of symbol steps on
which some lane of the warp refills its window from device memory, and
on which some lane has a code longer than 10 bits.

``parts``: what bounds each pass from below on each input: K2 on its
first 32 blocks alone (the launch, the table staging and build, one
warp's group), the write of K2's outputs alone (``zero_`` of tensors of
their shapes), and K1 on its first segment alone.

``--sweep`` rebuilds csrc/entropy.cu with its launch shapes replaced
(``kIndexLanes``, the segments a K1 CTA walks; ``kValueCtasPerSm``, K2's
persistent CTAs an SM, which share 1,024 threads; at 4 only 3 fit an SM
by shared memory, and the rest run after them) into build/entropy_sweep/
(nvcc, sm_90a, all builds together), and times K1 at each segment count
a CTA on dri8 and K2 at each CTA count an SM on the three inputs through
their wrappers, each checked against its plain version.

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_CODE = 10  # the lookahead table's bits (ops/entropy.py LUT_BITS)
SWEEP_LANES = (32, 64, 128, 256)
SWEEP_CTAS = (1, 2, 4)
LANES_CONST = re.compile(r"constexpr int kIndexLanes = \d+;")
CTAS_CONST = re.compile(r"constexpr int kValueCtasPerSm = \d+;")


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


def inputs(cs) -> dict:
    """{name: (stream, seg_pos, seg_nmcu, tables, ends, bpm, nblk)} on the
    card; dri8's ends are K1's."""
    from zpix_tpu_torch import (DeviceJpegDecoder, HostIndexJpegDecoder, SyncJpegDecoder,
                                prep_batch, prep_batch_host_index)
    from zpix_tpu_torch.ops import entropy as ke
    from zpix_tpu_torch.ops import sync as ks

    out = {}
    plan = prep_batch(cs.make_batch(0))
    bufs = DeviceJpegDecoder().upload(plan)
    nblk = plan.seg_mcus * plan.bpm
    ends, _ = ke.index_pass(*bufs, bpm=plan.bpm, nblk=nblk)
    out["dri8"] = (*bufs, ends, plan.bpm, nblk)
    rf = cs.make_batch(100, dri=None)
    hplan = prep_batch_host_index(rf)
    hb = HostIndexJpegDecoder().upload(hplan)
    out["host_index"] = (*hb[:4], hb[4], hplan.bpm, hb[4].shape[1])
    sdec = SyncJpegDecoder()
    splan = sdec.prep(rf)
    sb = sdec.upload(splan)
    sends = ks.sync_ends(sb[0], sb[1], sb[4], sb[3], chunk_bytes=splan.chunk_bytes,
                         n_chunks=splan.n_chunks, bpm=splan.bpm,
                         nblk=splan.n_mcu * splan.bpm)[0]
    out["sync"] = (*sb[:4], sends, splan.bpm, splan.n_mcu * splan.bpm)
    torch.cuda.synchronize()
    return out


def code_lengths(stream, starts, ends, tables, bpm: int):
    """Per block (lane-parallel, plain PyTorch, as ops/entropy.py's value
    pass walks): symbols, and symbols whose code is longer than LONG_CODE
    bits -> (int64 [L2], int64 [L2])."""
    from zpix_tpu_torch.ops.entropy import _bits, _Tables, _window

    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    n_seg, nblk = ends.shape
    n = n_seg * nblk
    lanes = torch.arange(n, device=stream.device)
    slot = (lanes % nblk) % bpm
    e64 = ends.to(torch.int64)
    pos = torch.cat([starts.to(torch.int64)[:, None], e64[:, :-1]], 1).reshape(-1)
    stop = e64.reshape(-1)
    live = pos < stop
    syms = torch.zeros(n, dtype=torch.int64, device=stream.device)
    longs = torch.zeros_like(syms)
    dc = torch.ones(n, dtype=torch.bool, device=stream.device)
    while bool(live.any()):
        v, off = _window(s64, pos)
        tid = torch.where(dc, tab.slot_dc[slot], tab.slot_ac[slot])
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        live &= ~bad
        size = torch.where(dc, sym, sym & 15)
        syms += live
        longs += live & (ln > LONG_CODE)
        pos = torch.where(live, pos + ln + size, pos)
        dc &= ~live
        live &= pos < stop
    return syms, longs


def k1_walk(stream, seg_pos, seg_nmcu, tables, bpm: int) -> dict:
    """The old K1's walk replayed (plain PyTorch): its BitWindow refills
    from device memory where a symbol's position leaves the 64-bit window
    (huffman.cuh: more than 32 bits past its start); a warp is 32
    consecutive lanes.  -> shares of warp symbol steps."""
    from zpix_tpu_torch.ops.entropy import _bits, _Tables, _window

    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    n = seg_pos.shape[0]
    dev = stream.device
    pos = seg_pos.to(torch.int64)
    nm = seg_nmcu.to(torch.int64)
    wbyte = torch.full_like(pos, -(1 << 40))
    slot, mcu, k = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(3))
    dc = torch.ones(n, dtype=torch.bool, device=dev)
    warps = (n + 31) // 32
    pad = warps * 32 - n
    steps = refill_steps = long_steps = lane_steps = lane_refills = 0
    while True:
        act = mcu < nm
        if not bool(act.any()):
            break
        refill = act & ((pos - wbyte * 8 > 32) | (pos < wbyte * 8))
        wbyte = torch.where(refill, pos >> 3, wbyte)
        v, off = _window(s64, pos)
        tid = torch.where(dc, tab.slot_dc[slot], tab.slot_ac[slot])
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        act &= ~bad
        nm = torch.where(bad, 0, nm)  # a lane stops at a bad code
        longc = act & (ln > LONG_CODE)
        wact = torch.nn.functional.pad(act, (0, pad)).view(warps, 32).any(1)
        steps += int(wact.sum())
        refill_steps += int(torch.nn.functional.pad(refill, (0, pad)).view(warps, 32).any(1).sum())
        long_steps += int(torch.nn.functional.pad(longc, (0, pad)).view(warps, 32).any(1).sum())
        lane_steps += int(act.sum())
        lane_refills += int(refill.sum())
        r = torch.where(dc, 0, sym >> 4)
        size = torch.where(dc, sym, sym & 15)
        pos = torch.where(act, pos + ln + size, pos)
        nk = torch.where(dc, 1, torch.where(size > 0, (k + r).clamp(0, 63) + 1,
                                            torch.where(r == 15, k + 16, 64)))
        done = act & ~dc & (nk > 63)
        k = torch.where(done, 0, torch.where(act, nk, k))
        dc = torch.where(done, True, torch.where(act, False, dc))
        slot = torch.where(done, slot + 1, slot)
        wrap = slot >= bpm
        slot = torch.where(wrap, 0, slot)
        mcu = torch.where(wrap, mcu + 1, mcu)
    return {"warp_steps": steps, "warp_steps_with_a_refill": refill_steps,
            "refill_share": refill_steps / max(steps, 1),
            "warp_steps_with_a_long_code": long_steps,
            "long_code_share": long_steps / max(steps, 1),
            "lane_steps": lane_steps, "lane_refills": lane_refills}


def work(ins, cs) -> dict:
    out = {}
    for name, (stream, sp, nmcu, tables, ends, bpm, nblk) in ins.items():
        syms, longs = code_lengths(stream, sp, ends, tables, bpm)
        per_seg = syms.view(-1, nblk).sum(1)
        n = syms.shape[0]
        pad = (-n) % 32
        groups = torch.nn.functional.pad(syms, (0, pad)).view(-1, 32).max(1).values
        out[name] = {"segments": int(sp.shape[0]), "blocks": n,
                     "stream_bytes": int(stream.shape[0]), "symbols": int(syms.sum()),
                     "longest_segment_symbols": int(per_seg.max()),
                     "mean_segment_symbols": float(per_seg.float().mean()),
                     "longest_block_symbols": int(syms.max()),
                     "group32_longest_sum": int(groups.sum()),
                     "long_code_symbols": int(longs.sum())}
    return out


def timed(cs, call, plain, equal) -> dict:
    from zpix_tpu_torch import runtime

    runtime.reset_launches()
    got = call()
    torch.cuda.synchronize()
    counted = dict((k, v) for k, v in runtime.LAUNCHES.items() if v)
    same = equal(got, plain())
    del got
    return {"ms": cs.cuda_ms(call, 20), "launches_counted": counted,
            "launches": launches(call), "equal_plain": same}


def k1_k2(cs, ins) -> dict:
    from zpix_tpu_torch.ops import entropy as ke

    res = {}
    for name, (stream, sp, nmcu, tables, ends, bpm, nblk) in ins.items():
        row = {}
        if name == "dri8":
            row["index_pass"] = timed(
                cs, lambda: ke.index_pass(stream, sp, nmcu, tables, bpm=bpm, nblk=nblk),
                lambda: ke.index_pass_plain(stream, sp, nmcu, tables, bpm=bpm, nblk=nblk),
                lambda a, b: bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])))

        def k2(fn, ends=ends, stream=stream, sp=sp, nmcu=nmcu, tables=tables, bpm=bpm):
            ok = torch.ones(1, dtype=torch.int32, device=stream.device)
            ac, dc = fn(stream, sp, nmcu, tables, ends, ok, bpm=bpm)
            return ac, dc, ok

        row["value_pass"] = timed(
            cs, lambda k2=k2: k2(ke.value_pass), lambda k2=k2: k2(ke.value_pass_plain),
            lambda a, b: all(bool(torch.equal(x, y)) for x, y in zip(a, b)) and bool(a[2]))
        res[name] = row
    return res


def parts(cs, ins) -> dict:
    """What bounds K2 from below on each input: a launch on its first 32
    blocks alone (one warp's group: the launch, the table staging and
    build, one group's decode and store) and the write of its outputs
    alone (``zero_`` of tensors of the same shapes); K1 on its first
    segment alone."""
    from zpix_tpu_torch.ops import entropy as ke

    out = {}
    for name, (stream, sp, nmcu, tables, ends, bpm, nblk) in ins.items():
        e1 = ends[:1, :32].contiguous()
        ok = torch.ones(1, dtype=torch.int32, device=stream.device)
        ac = torch.empty(ends.numel(), 64, dtype=torch.int16, device=stream.device)
        dc = torch.empty(ends.numel(), dtype=torch.int32, device=stream.device)
        out[name] = {
            "value_pass_first_group_ms": cs.cuda_ms(
                lambda: ke.value_pass(stream, sp[:1], nmcu[:1], tables, e1, ok, bpm=bpm), 20),
            "rows_write_ms": cs.cuda_ms(lambda: (ac.zero_(), dc.zero_()), 20)}
        if name == "dri8":
            out[name]["index_pass_first_segment_ms"] = cs.cuda_ms(
                lambda: ke.index_pass(stream, sp[:1], nmcu[:1], tables, bpm=bpm, nblk=nblk), 20)
        del ac, dc
    return out


def sweep_builds(csrc: str) -> dict:
    """{(lanes, ctas): path of a library holding zpix_index_pass and
    zpix_value_pass built with kIndexLanes = lanes, kValueCtasPerSm =
    ctas}: each segment count at 1 CTA an SM, each CTA count at 64."""
    from zpix_tpu_torch import runtime

    source = open(os.path.join(csrc, "entropy.cu")).read()
    if not (LANES_CONST.search(source) and CTAS_CONST.search(source)):
        raise SystemExit("torch_entropy_stages: --sweep needs entropy.cu's launch constants")
    shapes = [(lanes, 1) for lanes in SWEEP_LANES] + [(64, c) for c in SWEEP_CTAS if c != 1]
    procs = {}
    for lanes, ctas in shapes:
        work = os.path.join(HERE, "build", "entropy_sweep", f"lanes_{lanes}_ctas_{ctas}")
        os.makedirs(work, exist_ok=True)
        for name in os.listdir(csrc):
            if name.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, name), work)
        text = LANES_CONST.sub(f"constexpr int kIndexLanes = {lanes};", source)
        text = CTAS_CONST.sub(f"constexpr int kValueCtasPerSm = {ctas};", text)
        with open(os.path.join(work, "entropy.cu"), "w") as f:
            f.write(text)
        so = os.path.join(work, "lib.so")
        procs[lanes, ctas] = (so, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(work, "entropy.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for shape, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc (lanes, ctas {shape}) failed:\n{out.decode()}")
    return {shape: so for shape, (so, _) in procs.items()}


def sweep(cs, ins) -> dict:
    """K1 and K2 on each sweep build, through their wrappers (the
    runtime's library swapped for the build's while it is timed)."""
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import entropy as ke

    builds = sweep_builds(runtime.CSRC)
    out = {"index_lanes": [], "value_ctas_per_sm": []}
    stream, sp, nmcu, tables, ends, bpm, nblk = ins["dri8"]
    want = ke.index_pass_plain(stream, sp, nmcu, tables, bpm=bpm, nblk=nblk)
    refs = {}
    for name, (stream, sp, nmcu, tables, ends, bpm, nblk) in ins.items():
        ok = torch.ones(1, dtype=torch.int32, device=stream.device)
        refs[name] = (*ke.value_pass_plain(stream, sp, nmcu, tables, ends, ok, bpm=bpm), ok)
    keep = runtime.lib(), runtime._fns
    try:
        for (lanes, ctas), so in builds.items():
            runtime._lib, runtime._fns = ctypes.CDLL(so), {}
            if ctas == 1:
                stream, sp, nmcu, tables, ends, bpm, nblk = ins["dri8"]
                call = lambda: ke.index_pass(stream, sp, nmcu, tables, bpm=bpm, nblk=nblk)  # noqa
                got = call()
                out["index_lanes"].append({"lanes": lanes, "ms": cs.cuda_ms(call, 20),
                                           "equal_plain": bool(torch.equal(got[0], want[0])
                                                               and torch.equal(got[1], want[1]))})
            if lanes != 64:
                continue
            row = {"ctas_per_sm": ctas}
            for name, (stream, sp, nmcu, tables, ends, bpm, nblk) in ins.items():
                def call(stream=stream, sp=sp, nmcu=nmcu, tables=tables, ends=ends, bpm=bpm):
                    ok = torch.ones(1, dtype=torch.int32, device=stream.device)
                    return (*ke.value_pass(stream, sp, nmcu, tables, ends, ok, bpm=bpm), ok)
                got = call()
                row[f"{name}_equal_plain"] = all(bool(torch.equal(x, y))
                                                 for x, y in zip(got, refs[name]))
                row[f"{name}_ms"] = cs.cuda_ms(call, 20)
            out["value_ctas_per_sm"].append(row)
    finally:
        runtime._lib, runtime._fns = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_entropy_stages: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = smoke()
    sys.path.insert(0, root)
    from zpix_tpu_torch import runtime

    if not os.path.abspath(runtime.CSRC).startswith(root):
        raise SystemExit(f"torch_entropy_stages: imported {runtime.CSRC}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runtime.lib()
    ins = inputs(cs)
    res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC, "torch": torch.__version__,
           "kernels": k1_k2(cs, ins), "work": work(ins, cs),
           "k1_walk": k1_walk(*ins["dri8"][:4], ins["dri8"][5]), "parts": parts(cs, ins)}
    d = res["work"]["dri8"]
    res["index_pass_ns_per_symbol"] = (res["kernels"]["dri8"]["index_pass"]["ms"] * 1e6
                                       / d["longest_segment_symbols"])
    if args.sweep:
        res["sweep"] = sweep(cs, ins)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
