#!/usr/bin/env python3
"""Device time of zpix_tpu_torch's spec kernels K23 (QOI, csrc/qoi_spec.cu),
K20 and K21 (progressive DC first and AC first) and K22 (delta add,
csrc/prog_spec.cu) on chip_smoke.py's spec content, and what their content
asks of them.

    python3 tools/torch_spec_stages.py [--root CHECKOUT] [--tag NAME]
    python3 tools/torch_spec_stages.py --ab PARENT_CHECKOUT [--stats]
    python3 tools/torch_spec_stages.py --stats

``--root`` is the checkout whose ``zpix_tpu_torch`` is imported and built
(default: this one).  ``--ab`` runs this tool on PARENT_CHECKOUT, this
checkout, this checkout and PARENT_CHECKOUT again, each in a process of its
own on the one card, so that two versions are timed in one call (a ``git
archive`` of the parent unpacked into a directory .gitignore lists).

The content is chip_smoke.py's: QOI noise and screen, 16 images of
1024^2 a batch at ``_adaptive_chunk``'s chunk, and libjpeg's progressive
script, 16 copies of one 1024^2 4:2:0 q50 image, its DC-first scan in
chunks of 64 bytes.  For each kernel: the time of a call (CUDA events,
mean of 20 behind a spin kernel, as chip_smoke.py times kernels), each
CUDA kernel of one call with its device time (``torch.profiler``), its
counted launches, the rounds it returns (its passes or misses an image
in the redesign), and a digest of its output (equal digests: equal
outputs, across checkouts); for the redesigned K23, the time of each of
its phases in one more call, from the card's clock at its barriers, and
for the redesigned K20 the phases of its second kernel's image-0 CTA.
``k21``: the batch's four AC-first scans, in one call where the checkout
has ``ac_first_spec_group``, else a call a scan, from a zero store (the
digest of the store after one call and ``ok``).  ``k22``: the updates
the spec route's host tail (Cb's AC-first scan moved after Y's first
refinement: 3) and ``DeviceProgressiveDecoder`` (13) add, captured from a
decode of each, in one call where the checkout has
``delta_add_segments``, else a call an update, from a zero store.

``--stats`` gives (alone, or once after ``--ab``'s runs) what the content
asks, from this checkout's host code and plain PyTorch, not the kernels:
for K23 on image 0 of each batch the ops by tag, per chunk the ops before its first absolute op (RGB or RGBA) and its read
mask's popcount (slots an INDEX op reads before the chunk writes them),
the longest chain of INDEX sources (an INDEX op whose source is an INDEX
op, and so on) and the plain version's source passes on the batch; for
K20 the distinct exits a chunk when every chunk is scanned from its first
bit at every slot, and the misses on the true path
(``ops/prog_spec.py::dc_entry_links_plain``); for each AC-first scan of
K21 the chunks an image, the finished blocks, blocks passed and symbols
a chunk from its true entry, and the misses on the true path
(``ac_entry_links_plain``).

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
DC_CHUNK = 64
PROG_INDEX = 300  # chip_smoke.py's spec phase batch 0


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_kernels(fn) -> list:
    """[(name, device us)] of one call's kernels, in launch order."""
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


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def qoi_plan(cs, content):
    from zpix_tpu_torch.parallel import BatchQoiDecoder

    datas = cs.make_qoi_batches(content, [0])[0]
    dec = BatchQoiDecoder()
    plan = dec.prep(datas)
    return plan, dec.upload(plan)


def k23(cs, content) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import qoi_spec as qs

    plan, bufs = qoi_plan(cs, content)
    kw = dict(n_chunks=plan.n_chunks, chunk_bytes=plan.chunk_bytes, ops_cap=plan.chunk_bytes,
              height=plan.height, width=plan.width)

    def call():
        return qs.spec_decode(*bufs, **kw)

    call()
    torch.cuda.synchronize()
    runtime.reset_launches()
    out, ok, rounds = call()
    torch.cuda.synchronize()
    res = {"content": content, "chunk_bytes": plan.chunk_bytes, "chunks": plan.n_chunks,
           "stream_bytes": int(plan.stream.nbytes), "ok": bool(ok),
           "rounds": rounds.cpu().tolist(), "launches": runtime.LAUNCHES["qoi_spec"],
           "digest": digest(out, ok), "ms": cs.cuda_ms(call, REPS),
           "kernels": device_kernels(call)}
    if hasattr(qs, "_spec_decode_cuda"):  # the phases of one call, on the card's clock
        stamps = torch.zeros(1 << 16, 2, dtype=torch.int64, device="cuda")
        qs._spec_decode_cuda(*bufs, **kw, stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.cpu().numpy()
        st = st[: int((st[:, 1] > 0).sum())]
        names = {1: "guesses", 2: "links", 3: "resolve", 4: "maps", 5: "carries", 6: "records",
                 11: "pixels", 12: "tile_carry", 13: "sources", 14: "wyllie_round",
                 15: "nodes", 20: "expand"}
        phases = {}
        for (code, t1), t0 in zip(st[1:], st[:-1, 1]):
            ph = phases.setdefault(names.get(int(code), str(code)), {"ms": 0.0, "n": 0})
            ph["ms"] += (int(t1) - int(t0)) / 1e6
            ph["n"] += 1
        res["phases"] = phases
        res["stamped_ms"] = (int(st[-1, 1]) - int(st[0, 1])) / 1e6
    return res


def dc_scan_inputs(cs):
    from zpix_tpu_torch.parallel import progressive_onchip as po

    datas = cs.make_prog_batches([PROG_INDEX])[0]
    plans = [po.parse_progressive(d) for d in datas]
    p0 = plans[0]
    si = next(i for i, sc in enumerate(p0.scans) if sc.kind == "dc_first")
    sc = p0.scans[si]
    arrays, F = po.spec_first_inputs(p0, plans, si, DC_CHUNK)
    shapes = [(len(datas), p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64) for c in sc.comps]
    kw = dict(hv=[p0.hv[c] for c in sc.comps], valid=po.valid_grid(p0, sc.comps[0]), al=sc.al,
              chunk_bytes=DC_CHUNK, n_chunks=F)
    return arrays, shapes, kw


def k20(cs) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import prog_spec as ps

    arrays, shapes, kw = dc_scan_inputs(cs)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    grids = [torch.zeros(s, dtype=torch.int32, device="cuda") for s in shapes]
    ok = torch.ones(1, dtype=torch.int32, device="cuda")

    def call():  # sets coefficient 0 of every block: the same work each rep
        return ps.dc_first_spec(*t, ok, grids, **kw)

    call()
    torch.cuda.synchronize()
    runtime.reset_launches()
    rounds = call()
    torch.cuda.synchronize()
    res = {"chunks": kw["n_chunks"], "stream_bytes": int(arrays[0].nbytes), "ok": bool(ok),
           "rounds": rounds.cpu().tolist(), "launches": runtime.LAUNCHES["dc_first_spec"],
           "digest": digest(*grids, ok), "ms": cs.cuda_ms(call, REPS),
           "kernels": device_kernels(call)}
    if hasattr(ps, "_dc_first_cuda"):  # image 0's CTA of the second kernel, on the card's clock
        stamps = torch.zeros(4, dtype=torch.int64, device="cuda")
        ps._dc_first_cuda(*t, ok, grids, **kw, stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.cpu().tolist()
        res["cta_phases_ms"] = {k: (st[i + 1] - st[i]) / 1e6
                                for i, k in enumerate(("resolve", "record", "chains"))}
    return res


def ac_scan_inputs(cs):
    """The AC-first scans of batch PROG_INDEX -> (store shapes a component,
    [(scan, numpy inputs, chunks)])."""
    from zpix_tpu_torch.parallel import progressive_onchip as po

    datas = cs.make_prog_batches([PROG_INDEX])[0]
    plans = [po.parse_progressive(d) for d in datas]
    p0 = plans[0]
    shapes = [(len(datas), p0.myy * v, p0.mxx * h, 64) for h, v in p0.hv]
    scans = [(sc, *po.spec_first_inputs(p0, plans, si, DC_CHUNK))
             for si, sc in enumerate(p0.scans) if sc.kind == "ac_first"]
    return p0, shapes, scans


def k21(cs) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.parallel import progressive_onchip as po

    p0, shapes, scans = ac_scan_inputs(cs)
    grids = [torch.zeros(s, dtype=torch.int32, device="cuda") for s in shapes]
    ok = torch.ones(1, dtype=torch.int32, device="cuda")
    ins = [([torch.from_numpy(a).cuda() for a in arrays], sc, F) for sc, arrays, F in scans]
    group = hasattr(ps, "ac_first_spec_group")

    def call():
        if group:
            return ps.ac_first_spec_group(
                [ps.AcScan(*t, grids[sc.comps[0]], po.valid_grid(p0, sc.comps[0]), sc.ss, sc.se,
                           sc.al, F) for t, sc, F in ins], ok, chunk_bytes=DC_CHUNK)
        return torch.stack([ps.ac_first_spec(*t, ok, grids[sc.comps[0]],
                                             valid=po.valid_grid(p0, sc.comps[0]), ss=sc.ss,
                                             se=sc.se, al=sc.al, chunk_bytes=DC_CHUNK, n_chunks=F)
                            for t, sc, F in ins])

    runtime.lib()
    runtime.reset_launches()
    rounds = call()  # from the zero store
    torch.cuda.synchronize()
    res = {"group": group, "scans": [[sc.comps[0], sc.ss, sc.se, sc.al] for sc, _, _ in scans],
           "chunks": [F for _, _, F in scans],
           "stream_bytes": [int(a[0].nbytes) for _, a, _ in scans], "ok": bool(ok),
           "rounds": rounds.cpu().tolist(), "launches": runtime.LAUNCHES["ac_first_spec"],
           "digest": digest(*grids, ok), "ms": cs.cuda_ms(call, REPS),
           "kernels": device_kernels(call)}
    return res


def k22_updates(cs) -> dict:
    """The (state, indices, values) each K22 route adds, captured from one
    decode: the spec route's host tail and DeviceProgressiveDecoder."""
    from zpix_tpu_torch import OnchipProgressiveDecoder
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.parallel import DeviceProgressiveDecoder

    datas = cs.make_prog_batches([PROG_INDEX])[0]
    moved = [cs.jpeg_writer().move_scan(datas[0], 3, 5)] * len(datas)
    name = "delta_add_segments" if hasattr(ps, "delta_add_segments") else "delta_add"
    orig, out = getattr(ps, name), {}
    for route, dec, batch in (("tail", OnchipProgressiveDecoder(impl="spec"), moved),
                              ("device_progressive", DeviceProgressiveDecoder(), datas)):
        got = []

        def capture(*a):
            got.extend(a[0] if name == "delta_add_segments" else [a])
            return orig(*a)

        setattr(ps, name, capture)
        try:
            dec.decode(batch)
        finally:
            setattr(ps, name, orig)
        dec.close()
        torch.cuda.synchronize()
        out[route] = [(tuple(st.shape), i.clone(), v.clone()) for st, i, v in got]
    return out


def k22(cs) -> dict:
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.ops import prog_spec as ps

    segments = hasattr(ps, "delta_add_segments")
    res = {"segments": segments}
    for route, ups in k22_updates(cs).items():
        states = [torch.zeros(sh, dtype=torch.int32, device="cuda") for sh, _, _ in ups]
        triples = [(st, i, v) for st, (_, i, v) in zip(states, ups)]

        def call():
            if segments:
                ps.delta_add_segments(triples)
            else:
                for st, i, v in triples:
                    ps.delta_add(st, i, v)

        runtime.reset_launches()
        call()  # onto the zero stores
        torch.cuda.synchronize()
        res[route] = {"updates": len(ups), "elements": sum(int(i.numel()) for _, i, _ in ups),
                      "launches": runtime.LAUNCHES["delta_add"], "digest": digest(*states),
                      "ms": cs.cuda_ms(call, REPS), "kernels": device_kernels(call)}
    return res


# ------------------------------------------------------------ content stats

TAGS = ("RGB", "RGBA", "INDEX", "DIFF", "LUMA", "RUN")


def qoi_op_stats(stream: bytes, start: int, end: int, cb: int) -> dict:
    """One image's serial decode with its sources: ops by tag, per chunk
    (ops starting in [start + c cb, + cb)) the ops before its first RGB or
    RGBA op and its read mask's popcount, the longest chain of INDEX
    sources."""
    s = stream
    idx = [0] * 64
    writer = [-1] * 64  # the op whose pixel last went to each slot
    chain = []  # a chain length an op (INDEX ops; 0 for others)
    tags = dict.fromkeys(TAGS, 0)
    r, g, b, a = 0, 0, 0, 255
    pos, k = start, 0
    n_chunks = -(-(end - start) // cb)
    before_abs = [0] * n_chunks
    seen_abs = [False] * n_chunks
    rmask = [0] * n_chunks
    wmask = [0] * n_chunks
    longest = 0
    while pos < end:
        c = (pos - start) // cb
        b1 = s[pos]
        ln = 0
        if b1 == 0xFE or b1 == 0xFF:
            r, g, b = s[pos + 1], s[pos + 2], s[pos + 3]
            if b1 == 0xFF:
                a = s[pos + 4]
            tags["RGBA" if b1 == 0xFF else "RGB"] += 1
            seen_abs[c] = True
            pos += 4 if b1 == 0xFE else 5
        else:
            op = b1 >> 6
            if op == 0:
                j = b1 & 63
                v = idx[j]
                r, g, b, a = v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255
                if not (wmask[c] >> j) & 1:
                    rmask[c] |= 1 << j
                src = writer[j]
                ln = (chain[src] if src >= 0 else 0) + 1
                longest = max(longest, ln)
                tags["INDEX"] += 1
                pos += 1
            elif op == 1:
                r = (r + ((b1 >> 4) & 3) - 2) & 255
                g = (g + ((b1 >> 2) & 3) - 2) & 255
                b = (b + (b1 & 3) - 2) & 255
                tags["DIFF"] += 1
                pos += 1
            elif op == 2:
                b2 = s[pos + 1]
                dg = (b1 & 63) - 32
                r = (r + dg + ((b2 >> 4) & 15) - 8) & 255
                g = (g + dg) & 255
                b = (b + dg + (b2 & 15) - 8) & 255
                tags["LUMA"] += 1
                pos += 2
            else:
                tags["RUN"] += 1
                pos += 1
        if not seen_abs[c]:
            before_abs[c] += 1
        h = (r * 3 + g * 5 + b * 7 + a * 11) & 63
        idx[h] = r << 24 | g << 16 | b << 8 | a
        writer[h] = k
        wmask[c] |= 1 << h
        chain.append(ln)
        k += 1
    pops = [bin(m).count("1") for m in rmask]
    return {"ops": k, "tags": tags, "longest_index_chain": longest,
            "ops_before_absolute": summary(before_abs), "read_mask_popcount": summary(pops),
            "chunks_with_no_absolute_op": int(sum(1 for x in seen_abs if not x))}


def summary(xs) -> dict:
    a = np.asarray(xs, np.int64)
    return {"min": int(a.min()), "median": float(np.median(a)), "mean": float(a.mean()),
            "max": int(a.max())}


def stats(cs) -> dict:
    from zpix_tpu_torch.ops import prog_spec as ps
    from zpix_tpu_torch.ops import qoi_spec as qs

    out = {}
    for content in ("noise", "screen"):
        plan, bufs = qoi_plan(cs, content)
        st = qoi_op_stats(plan.stream.tobytes(), int(plan.img_byte_start[0]),
                          int(plan.img_byte_end[0]), plan.chunk_bytes)
        pst = {}
        qs.spec_decode_plain(*bufs, n_chunks=plan.n_chunks, chunk_bytes=plan.chunk_bytes,
                             ops_cap=plan.chunk_bytes, height=plan.height, width=plan.width,
                             stats=pst)
        st.update(image0_chunks=-(-(int(plan.img_byte_end[0]) - int(plan.img_byte_start[0]))
                                  // plan.chunk_bytes),
                  plain_passes=pst["passes"], plain_chunk_ops=pst["chunk_ops"],
                  batch_ops=pst["ops"])
        out[f"qoi_{content}"] = st
    arrays, _, kw = dc_scan_inputs(cs)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    hv = kw["hv"]
    bpm = sum(h * v for h, v in hv) if len(hv) > 1 else 1
    r = ps.dc_entry_links_plain(*t, bpm=bpm, chunk_bytes=DC_CHUNK, n_chunks=kw["n_chunks"])
    starts, ends = arrays[1].astype(np.int64), arrays[2].astype(np.int64)
    full = (ends - starts + 8 * DC_CHUNK - 1) // (8 * DC_CHUNK)
    F = kw["n_chunks"]
    dist = r["distinct"].view(-1, F).cpu().numpy()
    real = np.concatenate([dist[b, 1:full[b]] for b in range(len(full))])
    out["dc_first"] = {"bpm": bpm, "chunks_an_image": full.tolist(),
                       "distinct_exits": summary(real),
                       "distinct_exits_hist": np.bincount(real, minlength=bpm + 1).tolist(),
                       "misses": r["misses"].tolist()}
    _, _, scans = ac_scan_inputs(cs)
    out["ac_first"] = []
    for sc, arrays, F in scans:
        t = [torch.from_numpy(a).cuda() for a in arrays]
        r = ps.ac_entry_links_plain(*t, ss=sc.ss, se=sc.se, chunk_bytes=DC_CHUNK, n_chunks=F)
        starts, ends = arrays[1].astype(np.int64), arrays[2].astype(np.int64)
        full = (ends - starts + 8 * DC_CHUNK - 1) // (8 * DC_CHUNK)
        real = np.concatenate([np.arange(b * F, b * F + full[b]) for b in range(len(full))])
        per = {k: summary(r[k].cpu().numpy()[real]) for k in ("count", "adv", "symbols")}
        out["ac_first"].append({"comp": sc.comps[0], "band": [sc.ss, sc.se], "al": sc.al,
                                "chunks_an_image": full.tolist(), "finished_blocks": per["count"],
                                "blocks_passed": per["adv"], "symbols": per["symbols"],
                                "misses": r["misses"].tolist()})
    return out


def ab(parent: str, with_stats: bool) -> dict:
    runs = []
    for root, tag in ((parent, "parent"), (HERE, "change"), (HERE, "change"), (parent, "parent")):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, "--tag",
                              tag], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"torch_spec_stages: {tag} failed:\n{res.stdout}\n{res.stderr}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    out = {"runs": runs}
    if with_stats:
        sys.path.insert(0, HERE)
        out["stats"] = stats(smoke())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--ab", metavar="PARENT")
    ap.add_argument("--stats", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_spec_stages: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.ab:
        res = {"nvidia_smi": smi, **ab(os.path.abspath(args.ab), args.stats)}
    elif args.stats:
        sys.path.insert(0, HERE)
        res = {"nvidia_smi": smi, "stats": stats(smoke())}
    else:
        root = os.path.abspath(args.root)
        sys.path.insert(0, root)  # before chip_smoke.py, which imports the package
        cs = smoke()
        from zpix_tpu_torch import runtime

        if not os.path.abspath(runtime.CSRC).startswith(root):
            raise SystemExit(f"torch_spec_stages: imported {runtime.CSRC}, not {root}")
        runtime.lib()
        res = {"tag": args.tag, "nvidia_smi": smi, "csrc": runtime.CSRC,
               "k23": [k23(cs, c) for c in ("noise", "screen")], "k20": k20(cs),
               "k21": k21(cs), "k22": k22(cs)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
