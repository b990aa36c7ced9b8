"""Progressive JPEG with no host index walk: K20 (DC first) and K21 (AC
first), whose chunk entries come from guesses and their links, and K22,
the sparse delta add; each a CUDA kernel (csrc/prog_spec.cu) with its plain
PyTorch version.

* ``dc_first_spec`` is K20, the port of zpix_tpu/parallel/
  progressive_onchip.py::build_dc_first_fn (:363-538) and _run_dc_first's
  store write (:1288-1348).
* ``ac_first_spec_group`` is K21, the port of build_ac_first_fn (:541-797)
  and _run_ac_first's (:1350-1389), over every AC-first scan of a batch in
  one call (``AcScan`` each); ``ac_first_spec`` is its one-scan case.
* ``delta_add_segments`` is K22 over every update of a decode in one
  launch: ``state[b, idx[b, j]] += val[b, j]`` (progressive.py::
  DeviceProgressiveDecoder._apply, :85-98, and the host tail's write-back,
  progressive_onchip.py:2286-2294); ``delta_add`` is its one-update case.
  ``Tensor.scatter_add_`` an update in turn is the plain version.

A spec scan's inputs: ``stream`` u8, the batch's destuffed scans as
``stack_spec`` lays them out (each image at an 8-byte aligned offset, 64
zero bytes at the end), ``starts`` and ``ends`` int32 [B] each image's
first and end bit, ``tables`` as for K8 (ops/entropy.py::pack_tables), and
``ok`` int32 [1], which the scan clears as zpix_tpu clears it.  Each image's
scan is cut into ``n_chunks`` chunks of ``chunk_bytes``; chunk c of an
image covers bits [start + 8 c chunk_bytes, + 8 chunk_bytes) clipped to its
end.  A lane decodes from its chunk's entry to the first symbol boundary
at or past the chunk's end; the entries are the serial decode's states at
the chunk starts.  ``ok`` is cleared where a chunk holds more than 4 *
chunk_bytes symbols (K20) or finished blocks (K21), where an image holds
fewer symbols than the scan's blocks (K20) or finishes fewer blocks than
its valid grid (K21), or where the first bad code (a DC size over 16
included) lies more than 16 bits before the image's end.  The values of
finished blocks go into the store: K20 sets coefficient 0 to the prefix of
the diffs along each component's chain << Al (diffs past an image's
symbols are 0), K21 adds each coefficient's ``val << Al``.

The plain versions find the entries by Jacobi rounds over every chunk at
once (a lane a chunk, a symbol an iteration), then scan once more to
record; the dispatch takes them for CPU tensors only.  They return their
rounds (one count for the batch); the kernels return each image's misses
(the chunks whose entry was none of the guess exits of the chunk before,
each a scan more; ``dc_entry_links_plain`` and ``ac_entry_links_plain``
count them the same way).  The results do not depend on them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..codecs.jpeg.tables import UNZIG
from . import entropy as _entropy
from .entropy import TAB_WORDS, _bits, _extend, _Tables, _window
from .progressive import (_check_grids, _dc_chains, _valid_rows, _wrap32, fast_div,
                          scan_blocks, store_blocks_plain)

NO_ERR = 2**31 - 1  # the error bit of a lane that met no bad code
CHUNK_WORDS = 6  # int32 scratch words a chunk (csrc/prog_spec.cu kChunkWords)
DC_FIRST_KERNELS = 2  # K20's CUDA kernels a call: the guesses and links, a CTA an image
AC_FIRST_KERNELS = 3  # K21's: the guesses and links, a warp an (image, scan), the record
_AC_LINK_CHUNKS = 254  # K21's chunks a guess-and-link block (kLinkThreads - 2)
_AC_REC_THREADS = 128  # K21's chunks a record block (kRecThreads)
_SCAN_WORDS = 19  # int64 words a scan of K21's table (kScanWords)
_DELTA_TILE = 4096  # K22's pairs a CTA (kDeltaTile)
_CHECK_EVERY = 16  # plain versions: symbols between checks that any lane is still running


def stack_spec(streams, chunk_bytes: int) -> tuple:
    """The images' scans back to back at 8-byte aligned offsets, then 64 zero
    bytes (zpix_tpu's _stack_streams layout: bits past an image's end are
    the next image's or zeros) -> (buffer u8, starts int32 [B] and ends int32
    [B] in bits, chunks an image: enough for the longest scan, rounded up
    to a multiple of 8)."""
    offs, total = [], 0
    for s in streams:
        offs.append(total)
        total += (len(s) + 7) // 8 * 8
    flat = np.zeros(total + 64, np.uint8)
    for s, o in zip(streams, offs):
        flat[o : o + len(s)] = s
    if flat.shape[0] > _entropy.MAX_STREAM:
        raise ValueError("progressive: a spec scan's batch stream must be under 256 MiB")
    starts = np.asarray(offs, np.int64) * 8
    ends = starts + 8 * np.asarray([len(s) for s in streams], np.int64)
    n_chunks = -(-max(len(s) for s in streams) // chunk_bytes)
    return flat, starts.astype(np.int32), ends.astype(np.int32), max(8, -(-n_chunks // 8) * 8)


# ------------------------------------------------------------- plain versions


def _chunks(starts, ends, n_chunks: int, chunk_bits: int):
    """-> (first unit, end unit) of every chunk, int64 [B * n_chunks]: chunk
    c of an image covers [start + c chunk_bits, + chunk_bits) clipped to
    its end (bits for a JPEG scan, bytes for a QOI stream)."""
    s, e = starts.to(torch.int64)[:, None], ends.to(torch.int64)[:, None]
    raw = s + chunk_bits * torch.arange(n_chunks, dtype=torch.int64, device=starts.device)
    cs = torch.minimum(raw, e)
    return cs.reshape(-1), torch.minimum(cs + chunk_bits, e).reshape(-1)


def entry_sources(starts, ends, n_chunks: int, unit: int):
    """The lane whose exit is each lane's entry, int64 [B * n_chunks]: chunk
    c - 1, except past an image's non-empty chunks, where it is the last
    non-empty one (an empty chunk's exit is its entry; the kernels'
    entry_source); chunk 0's entry is fixed (its own lane here)."""
    s, e = starts.to(torch.int64), ends.to(torch.int64)
    full = ((e - s + unit - 1) // unit)[:, None]
    c = torch.arange(n_chunks, dtype=torch.int64, device=starts.device)[None, :]
    src = torch.where(c - 1 < full, c - 1, (full - 1).clamp(min=0)).clamp(min=0)
    return (src + n_chunks * torch.arange(s.shape[0], device=starts.device)[:, None]).reshape(-1)


def fixed_point(scan, bit0, st0, src, max_rounds: int):
    """Jacobi rounds: every chunk scanned from its guess (bit0, st0), then
    again wherever its entry (its source lane's exit, ``entry_sources``)
    changed, until no entry changes -> (entry bits, entry states, the last
    scan's results [exit bit, exit state, ...] a lane, rounds, settled).
    ``scan(bit, st, sel)`` scans lanes ``sel``; past ``max_rounds`` the
    rounds stop unsettled."""
    L = bit0.shape[0]
    first = src == torch.arange(L, device=src.device)  # chunk 0 of each image
    ent_b, ent_s = bit0.clone(), st0.clone()
    sel = torch.arange(L, device=bit0.device)
    res, rounds = None, 0
    while True:
        out = scan(ent_b[sel], ent_s[sel], sel)
        if res is None:
            res = [o.clone() for o in out]
        else:
            for r, o in zip(res, out):
                r[sel] = o
        rounds += 1
        nb = torch.where(first, bit0, res[0][src])
        ns = torch.where(first, st0, res[1][src])
        need = (nb != ent_b) | (ns != ent_s)
        ent_b, ent_s = nb, ns
        if not bool(need.any()):
            return ent_b, ent_s, res, rounds, True
        if rounds > max_rounds:
            return ent_b, ent_s, res, rounds, False
        sel = need.nonzero().squeeze(1)


def _running(act, step: int) -> bool:
    return step % _CHECK_EVERY or bool(act.any())


def _dc_scan(tab, s64, cap: int, bit, slot, ce, bpm: int, rec=None):
    """K20's lanes from (bit, slot) to the first symbol boundary at or past
    ce -> (exit bit, exit slot, symbols, first bad bit).  ``rec`` = (out
    int64 [B * nblk], lane's row offset, lane's first symbol index, nblk):
    each symbol's diff goes to out[row + first + j] while first + j < nblk."""
    bit, slot = bit.clone(), slot.clone()
    act = bit < ce
    err = torch.full_like(bit, NO_ERR)
    cnt = torch.zeros_like(bit)
    step = 0
    while _running(act, step):
        step += 1
        past = (bit >> 3) + 8 > cap
        v, off = _window(s64, bit)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tab.slot_dc[slot])
        bad = act & (bad | (sym > 16) | past)
        err = torch.where(bad, bit, err)
        act = act & ~bad
        if rec is not None:
            out, row, first, nblk = rec
            g = first + cnt
            w = act & (g < nblk)
            at = torch.where(w, row + g, out.shape[0] - 1)
            out.scatter_(0, at, torch.where(w, _extend(v, off + ln, sym), out[-1]))
        cnt = cnt + act
        slot = torch.where(act, torch.where(slot + 1 == bpm, 0, slot + 1), slot)
        bit = torch.where(act, bit + ln + sym, bit)
        act = act & (bit < ce)
    return bit, slot, cnt, err


def _ac_scan(tab, tid, s64, cap: int, bit, k, ce, *, ss: int, se: int, rec=None):
    """K21's lanes from (bit, k) to the first symbol boundary at or past ce
    -> (exit bit, exit k, finished blocks, blocks passed, first bad bit,
    symbols).
    ``rec`` = (rows int64 [B * nvalid + 1, 64], lane's row offset, lane's
    first block index, lane's limit): each coefficient is added into its
    block's row while the block's index is below the limit."""
    bit, k = bit.clone(), k.clone()
    act = bit < ce
    err = torch.full_like(bit, NO_ERR)
    ndata = torch.zeros_like(bit)
    adv = torch.zeros_like(bit)
    nsym = torch.zeros_like(bit)
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=bit.device)
    tid = tid.expand(bit.shape[0])
    step = 0
    while _running(act, step):
        step += 1
        past = (bit >> 3) + 8 > cap
        v, off = _window(s64, bit)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        bad = act & (bad | past)
        err = torch.where(bad, bit, err)
        act = act & ~bad
        r, size = sym >> 4, sym & 15
        eob = (size == 0) & (r < 15)
        zrl = (size == 0) & (r == 15)
        k2 = k + r
        over = (size > 0) & (k2 > se)
        extra = torch.where(eob & (r > 0), _bits(v, off + ln, r.clamp(0, 14)), 0)
        skips = torch.where(eob, ((1 << r.clamp(0, 14)) | extra) - 1, 0)
        consume = torch.where(eob, ln + r, torch.where(zrl | over, ln, ln + size))
        new_k = torch.where(zrl, k + 16, torch.where(eob | over, k, k2 + 1))
        if rec is not None:
            rows, row, first, lim = rec
            g = first + adv
            w = act & (size > 0) & ~over & (g < lim)
            at = torch.where(w, (row + g) * 64 + unzig[k2.clamp(0, 63)], rows.numel() - 1)
            rows.view(-1).scatter_add_(0, at, torch.where(w, _extend(v, off + ln, size), 0))
        fin = act & (eob | over | (new_k > se))
        nsym = nsym + act
        ndata = ndata + fin
        adv = adv + torch.where(fin, 1 + skips, 0)
        k = torch.where(fin, ss, torch.where(act, new_k, k))
        bit = torch.where(act, bit + consume, bit)
        act = act & (bit < ce)
    return bit, k, ndata, adv, err, nsym


def _lanes(B: int, F: int, device):
    return torch.arange(B * F, device=device) // F


def dc_first_spec_plain(stream, starts, ends, tables, ok, grids, *, hv, valid, al: int,
                        chunk_bytes: int, n_chunks: int, stats: dict | None = None):
    """K20, plain: -> rounds int32 [B] (one count for the batch).  ``stats``
    gets the most symbols a chunk holds (``chunk_symbols``)."""
    B, F = grids[0].shape[0], n_chunks
    bpm = sum(h * v for h, v in hv) if len(grids) > 1 else 1
    nblk = scan_blocks(grids, hv, valid)
    tab, s64, cap = _Tables(tables), stream.to(torch.int64), stream.shape[0]
    cs, ce = _chunks(starts, ends, F, 8 * chunk_bytes)

    def scan(bit, slot, sel):
        return _dc_scan(tab, s64, cap, bit, slot, ce[sel], bpm)

    src = entry_sources(starts, ends, F, 8 * chunk_bytes)
    ent_b, ent_s, res, rounds, settled = fixed_point(scan, cs, torch.zeros_like(cs), src, F + 2)
    cnt = res[2].view(B, F)
    first = (cnt.cumsum(1) - cnt).reshape(-1)
    img = _lanes(B, F, cs.device)
    diffs = torch.zeros(B * nblk + 1, dtype=torch.int64, device=cs.device)
    _dc_scan(tab, s64, cap, ent_b, ent_s, ce, bpm, rec=(diffs, img * nblk, first, nblk))
    end = ends.to(torch.int64)
    good = (settled and bool((cnt <= 4 * chunk_bytes).all()) and bool((cnt.sum(1) >= nblk).all())
            and bool((res[3] >= end[img] - 16).all()))
    ok.mul_(int(good))
    if stats is not None:
        stats["chunk_symbols"] = int(cnt.max())
    chains, seg = _dc_chains(grids, hv, valid)
    dc = _entropy.dc_restore_plain(diffs[:-1].to(torch.int32), hv=chains, seg_mcus=seg)
    store_blocks_plain(dc, grids, hv=hv, valid=valid, al=al, mode="set")
    return torch.full((B,), rounds, dtype=torch.int32, device=cs.device)


def _entry_links_plain(scan, starts, ends, *, guesses, chunk_bytes: int, n_chunks: int):
    """K20 and K21's entry search as their kernels make it, in plain
    PyTorch: every chunk scanned from its first bit at each state of
    ``guesses`` (the guesses; guesses[0] is an image's start state); the
    guess exits of chunk c - 1 are chunk c's candidate entries, each scanned
    through chunk c and linked to the equal guess exit of chunk c; each
    distinct exit that matches none is put in as chunk c + 1's candidate
    ng + u (u its first candidate, ng = len(guesses)), scanned and linked
    too; the true path walks the links from chunk 0 and, where it meets a
    miss, puts its exit in as the next chunk's candidate ng and scans that
    chunk.  ``scan(bit, state, lanes)`` -> (exit bit, exit state, *results).
    -> (entry bits, entry states int64 [B * n_chunks] (past an image's
    non-empty chunks, the last one's exit, as ``fixed_point`` gives them),
    the results of the scans from them, the distinct guess exits a chunk,
    misses int64 [B]: the chunks entered by a candidate put in)."""
    B, F, ng = starts.shape[0], n_chunks, len(guesses)
    cs, _ = _chunks(starts, ends, F, 8 * chunk_bytes)
    L = B * F
    dev = cs.device

    def one(bits, states, lanes):
        return [r.tolist() for r in scan(torch.tensor(bits, dtype=torch.int64, device=dev),
                                         torch.tensor(states, dtype=torch.int64, device=dev),
                                         torch.tensor(lanes, dtype=torch.int64, device=dev))]

    lanes = torch.arange(L, device=dev)
    g = [r.view(ng, L) for r in scan(
        cs.repeat(ng), torch.tensor(guesses, device=dev).repeat_interleave(L), lanes.repeat(ng))]
    gkey = g[0] * 256 + g[1]  # a state as one number (states below 256)
    srt = gkey.sort(0).values
    distinct = 1 + (srt[1:] != srt[:-1]).sum(0)
    # the candidates of chunk c: the guess exits of chunk c - 1 (lane 0 of
    # an image scans from the image's start: its guess 0)
    prev = (lanes - 1).clamp(min=0)
    y = [r.view(ng, L) for r in scan(g[0][:, prev].reshape(-1), g[1][:, prev].reshape(-1),
                                     lanes.repeat(ng))]
    first = (lanes % F == 0)[None, :]
    y = [torch.where(first, a, b) for a, b in zip(g, y)]
    gkey_l, ykey_l = gkey.T.tolist(), (y[0] * 256 + y[1]).T.tolist()
    gl, yl = [t.T.tolist() for t in g], [t.T.tolist() for t in y]
    nres = len(g) - 2

    def link(key, lane):
        return gkey_l[lane].index(key) if key in gkey_l[lane] else -1

    full = ((ends.to(torch.int64) - starts.to(torch.int64) + 8 * chunk_bytes - 1)
            // (8 * chunk_bytes)).tolist()
    cols = {}  # (lane, column >= ng): a put-in candidate -> (entry, exit, results, link)

    def put_in(at):  # [(lane, column, bit, state)], scanned together
        x = one([a[2] for a in at], [a[3] for a in at], [a[0] for a in at])
        for i, (lane, col, b, s) in enumerate(at):
            xb, xs = x[0][i], x[1][i]
            last = (lane + 1) % F == 0 or (lane % F) + 1 >= full[lane // F]
            cols[lane, col] = ((b, s), (xb, xs), [r[i] for r in x[2:]],
                               -1 if last else link(xb * 256 + xs, lane))

    # the link kernel's put-ins: each chunk's distinct missed exits
    ins = []
    for lane in range(L):
        b_img, c = divmod(lane, F)
        if c < 1 or c + 1 >= full[b_img]:
            continue
        for v in range(ng):
            key = ykey_l[lane][v]
            if link(key, lane) < 0 and ykey_l[lane].index(key) == v:
                ins.append((lane + 1, ng + v, yl[0][lane][v], yl[1][lane][v]))
    if ins:
        put_in(ins)
    ent_b, ent_s = cs.clone(), torch.zeros(L, dtype=torch.int64, device=dev)
    res = [torch.zeros(L, dtype=torch.int64, device=dev) for _ in range(nres)]
    misses = torch.zeros(B, dtype=torch.int64)
    tail = []  # lanes past an image's non-empty chunks, scanned together at the end
    for b_img in range(B):
        l0, J = b_img * F, full[b_img] - 1
        ent_s[l0] = guesses[0]
        for i in range(nres):
            res[i][l0] = gl[2 + i][l0][0]
        exit_ = (gl[0][l0][0], gl[1][l0][0])
        t = 0
        for c in range(1, F):
            lane = l0 + c
            if c > J:  # empty chunks: the last non-empty one's exit
                tail.append((lane, *exit_))
                continue
            if t >= ng:
                (eb, es), exit_, r, nt = cols[lane, t]
                misses[b_img] += 1
            else:
                eb, es = gl[0][lane - 1][t], gl[1][lane - 1][t]
                exit_ = (yl[0][lane][t], yl[1][lane][t])
                r = [yl[2 + i][lane][t] for i in range(nres)]
                nt = link(exit_[0] * 256 + exit_[1], lane) if c + 1 <= J else -1
                if nt < 0 and c + 1 <= J:  # the link kernel put it in
                    nt = ng + ykey_l[lane].index(exit_[0] * 256 + exit_[1])
            ent_b[lane], ent_s[lane] = eb, es
            for i in range(nres):
                res[i][lane] = r[i]
            if nt < 0 and c + 1 <= J:  # a miss the link kernel did not put in
                put_in([(lane + 1, ng, *exit_)])
                nt = ng
            t = nt
    if tail:
        x = one([a[1] for a in tail], [a[2] for a in tail], [a[0] for a in tail])
        at = torch.tensor([a[0] for a in tail], device=dev)
        ent_b[at] = torch.tensor([a[1] for a in tail], device=dev)
        ent_s[at] = torch.tensor([a[2] for a in tail], device=dev)
        for i in range(nres):
            res[i][at] = torch.tensor(x[2 + i], device=dev)
    return ent_b, ent_s, res, distinct, misses


def dc_entry_links_plain(stream, starts, ends, tables, *, bpm: int, chunk_bytes: int,
                         n_chunks: int) -> dict:
    """K20's entry search as its kernels make it (``_entry_links_plain``,
    a guess at every slot 0 .. bpm - 1; for the tests and
    tools/torch_spec_stages.py, the dispatch never takes it) -> dict:
    ``bit``, ``slot`` the entries int64 [B * n_chunks], ``count``, ``err``
    the scans from them, ``distinct`` the distinct guess exits a chunk,
    ``misses`` int64 [B]."""
    tab, s64, cap = _Tables(tables), stream.to(torch.int64), stream.shape[0]
    _, ce = _chunks(starts, ends, n_chunks, 8 * chunk_bytes)

    def scan(bit, slot, lanes):
        return _dc_scan(tab, s64, cap, bit, slot, ce[lanes], bpm)

    bit, slot, (cnt, err), distinct, misses = _entry_links_plain(
        scan, starts, ends, guesses=list(range(bpm)), chunk_bytes=chunk_bytes, n_chunks=n_chunks)
    return {"bit": bit, "slot": slot, "count": cnt, "err": err, "distinct": distinct,
            "misses": misses}


def ac_entry_links_plain(stream, starts, ends, tables, *, ss: int, se: int, chunk_bytes: int,
                         n_chunks: int) -> dict:
    """K21's entry search as its kernels make it (``_entry_links_plain``,
    one guess a chunk: k = ss; for the tests and tools/torch_spec_stages.py,
    the dispatch never takes it) -> dict: ``bit``, ``k`` the entries int64
    [B * n_chunks], ``count`` (finished blocks), ``adv`` (blocks passed),
    ``err``, ``symbols`` the scans from them, ``distinct``, ``misses`` int64
    [B]."""
    tab, s64, cap = _Tables(tables), stream.to(torch.int64), stream.shape[0]
    _, ce = _chunks(starts, ends, n_chunks, 8 * chunk_bytes)
    tid = tab.slot_ac[0]

    def scan(bit, k, lanes):
        return _ac_scan(tab, tid, s64, cap, bit, k, ce[lanes], ss=ss, se=se)

    bit, k, (cnt, adv, err, nsym), distinct, misses = _entry_links_plain(
        scan, starts, ends, guesses=[ss], chunk_bytes=chunk_bytes, n_chunks=n_chunks)
    return {"bit": bit, "k": k, "count": cnt, "adv": adv, "err": err, "symbols": nsym,
            "distinct": distinct, "misses": misses}


def ac_first_spec_plain(stream, starts, ends, tables, ok, grid, *, valid, ss: int, se: int,
                        al: int, chunk_bytes: int, n_chunks: int, stats: dict | None = None):
    """K21, plain: -> rounds int32 [B] (one count for the batch).  ``stats``
    gets the most symbols a chunk holds (``chunk_symbols``)."""
    B, F = grid.shape[0], n_chunks
    nvy, nvx = valid
    nvalid = nvy * nvx
    tab, s64, cap = _Tables(tables), stream.to(torch.int64), stream.shape[0]
    cs, ce = _chunks(starts, ends, F, 8 * chunk_bytes)
    tid = tab.slot_ac[0]

    def scan(bit, k, sel):
        return _ac_scan(tab, tid, s64, cap, bit, k, ce[sel], ss=ss, se=se)

    src = entry_sources(starts, ends, F, 8 * chunk_bytes)
    ent_b, ent_k, res, rounds, settled = fixed_point(scan, cs, torch.full_like(cs, ss), src, F + 2)
    ndata, adv = res[2].view(B, F), res[3].view(B, F)
    img = _lanes(B, F, cs.device)
    total = adv.sum(1)
    lim = torch.minimum(total, torch.tensor(nvalid, device=cs.device))[img]
    rows = torch.zeros(B * nvalid + 1, 64, dtype=torch.int64, device=cs.device)
    _ac_scan(tab, tid, s64, cap, ent_b, ent_k, ce, ss=ss, se=se,
             rec=(rows, img * nvalid, (adv.cumsum(1) - adv).reshape(-1), lim))
    end = ends.to(torch.int64)
    good = (settled and bool((ndata <= 4 * chunk_bytes).all()) and bool((total >= nvalid).all())
            and bool((res[4] >= end[img] - 16).all()))
    ok.mul_(int(good))
    if stats is not None:
        stats["chunk_symbols"] = int(res[5].max())
    merged = _valid_rows(grid, valid).to(torch.int64) + (rows[:-1] << al)
    grid[:, :nvy, :nvx] = _wrap32(merged).view(B, nvy, nvx, 64)
    return torch.full((B,), rounds, dtype=torch.int32, device=cs.device)


def delta_add_plain(state, idx, val) -> None:
    """K22, plain: ``state.scatter_add_(1, idx, val)`` (int32, wrapping)."""
    state.scatter_add_(1, idx.to(torch.int64), val)


# ------------------------------------------------------------------ wrappers


def _check_spec(stream, starts, ends, tables, ok, B: int, chunk_bytes: int, n_chunks: int):
    if stream.dtype != torch.uint8 or starts.dtype != torch.int32 or (
            ends.dtype != torch.int32 or tables.dtype != torch.int32 or ok.dtype != torch.int32):
        raise TypeError("progressive: expected a u8 stream and int32 starts, ends, tables, ok")
    if starts.shape != (B,) or ends.shape != (B,) or tables.shape[0] != TAB_WORDS or (
            ok.shape != (1,)):
        raise ValueError("progressive: one start and end an image, packed tables, ok [1]")
    if chunk_bytes < 1 or n_chunks < 1 or stream.shape[0] > _entropy.MAX_STREAM:
        raise ValueError("progressive: chunks of at least a byte, a stream under 256 MiB")


def dc_first_spec(stream, starts, ends, tables, ok, grids, *, hv, valid, al: int,
                  chunk_bytes: int, n_chunks: int):
    """K20: a DC-first scan with no index walk -> coefficient 0 of each
    block it visits set to its chain's prefix << al, in place; clears
    ``ok``.  -> int32 [B]: on the card each image's misses, in plain
    PyTorch the batch's rounds."""
    _check_grids(grids, hv)
    B = grids[0].shape[0]
    _check_spec(stream, starts, ends, tables, ok, B, chunk_bytes, n_chunks)
    kw = dict(hv=hv, valid=valid, al=al, chunk_bytes=chunk_bytes, n_chunks=n_chunks)
    if stream.device.type == "cpu":
        return dc_first_spec_plain(stream, starts, ends, tables, ok, grids, **kw)
    runtime.require_cuda(stream, starts, ends, tables, ok, *grids)
    return _dc_first_cuda(stream, starts, ends, tables, ok, grids, **kw)


def _dc_first_cuda(stream, starts, ends, tables, ok, grids, *, hv, valid, al: int,
                   chunk_bytes: int, n_chunks: int, stamps=None):
    """K20's launch on checked CUDA inputs -> misses int32 [B].  ``stamps``
    (int64 [4] on the card, for tools/torch_spec_stages.py): its image-0
    CTA writes the card's clock (ns) at its start and after its resolve,
    record scan and chains' prefix."""
    B = grids[0].shape[0]
    interleaved = len(grids) > 1
    bpm = sum(h * v for h, v in hv) if interleaved else 1
    if bpm > _entropy.MAX_SLOTS or not 0 <= al <= 31:
        raise ValueError("dc_first_spec: more than 16 blocks an MCU or al outside 0..31")
    nblk = scan_blocks(grids, hv, valid)
    mxx = grids[0].shape[2] // hv[0][0]
    dev = stream.device
    L, W = B * n_chunks, 2 * bpm
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    chunks = torch.empty(L * CHUNK_WORDS, dtype=torch.int32, device=dev)
    states = torch.empty(2, W * L, dtype=torch.int64, device=dev)  # X, Y
    scans = torch.empty(2, W * L, dtype=torch.int32, device=dev)  # symbols, first bad bit
    links = torch.empty(L * W, dtype=torch.uint8, device=dev)
    diffs = torch.empty(max(1, B * nblk), dtype=torch.int32, device=dev)
    pad = [0] * (3 - len(grids))
    hvs = [h | v << 4 for h, v in hv] if interleaved else [0x11]
    runtime.launch(
        "dc_first_spec", dev, "zpix_spec_dc_first", "pl" + "p" * 17 + "i" * 18,
        stream.data_ptr(), stream.shape[0], starts.data_ptr(), ends.data_ptr(),
        tables.data_ptr(), ok.data_ptr(), rounds.data_ptr(), chunks.data_ptr(),
        states[0].data_ptr(), states[1].data_ptr(), scans[0].data_ptr(), 0, scans[1].data_ptr(),
        links.data_ptr(), diffs.data_ptr(), *[g.data_ptr() for g in grids], *pad,
        0 if stamps is None else stamps.data_ptr(), B, n_chunks,
        8 * chunk_bytes, 4 * chunk_bytes, nblk, bpm, len(grids), mxx if interleaved else valid[1],
        *hvs, *pad, *[g.shape[2] for g in grids], *pad, *[g.shape[1] for g in grids], *pad, al,
        kernels=DC_FIRST_KERNELS)
    return rounds


class AcScan(NamedTuple):
    """One AC-first scan of a K21 call: its spec inputs (``stack_spec``,
    ``pack_tables`` with the scan's AC table in slot 0), the component's
    grid int32 [B, bv, bh, 64] it adds into, its valid grid (nvy, nvx),
    band ss..se, Al and chunks an image."""
    stream: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    tables: torch.Tensor
    grid: torch.Tensor
    valid: tuple
    ss: int
    se: int
    al: int
    n_chunks: int


def ac_first_spec_group(scans, ok, *, chunk_bytes: int):
    """K21: AC-first scans of one batch (``AcScan`` each), each over band
    ss..se of one component with no index walk -> each coefficient's ``val
    << al`` added into its valid block's row of the scan's grid, in place;
    clears ``ok``.  The scans write disjoint bands and no coefficient 0, so
    one call equals the scans in turn (its plain version).  -> int32 [S, B]:
    on the card each (scan, image)'s misses, in plain PyTorch each scan's
    rounds."""
    if not scans:
        raise ValueError("ac_first_spec: no scan")
    B = scans[0].grid.shape[0]
    for sc in scans:
        _check_grids([sc.grid], [(1, 1)])
        if sc.grid.shape[0] != B:
            raise ValueError("ac_first_spec: the scans of a call share their batch")
        _check_spec(sc.stream, sc.starts, sc.ends, sc.tables, ok, B, chunk_bytes, sc.n_chunks)
        nvy, nvx = sc.valid
        if not 1 <= sc.ss <= sc.se <= 63 or nvy > sc.grid.shape[1] or nvx > sc.grid.shape[2]:
            raise ValueError("ac_first_spec: bad spectral band or valid grid")
    if ok.device.type == "cpu":
        return torch.stack([
            ac_first_spec_plain(sc.stream, sc.starts, sc.ends, sc.tables, ok, sc.grid,
                                valid=sc.valid, ss=sc.ss, se=sc.se, al=sc.al,
                                chunk_bytes=chunk_bytes, n_chunks=sc.n_chunks) for sc in scans])
    runtime.require_cuda(ok, *(t for sc in scans for t in (sc.stream, sc.starts, sc.ends,
                                                          sc.tables, sc.grid)))
    if not all(0 <= sc.al <= 31 for sc in scans):
        raise ValueError("ac_first_spec: al outside 0..31")
    return _ac_first_cuda(scans, ok, chunk_bytes)


def _ac_first_cuda(scans, ok, chunk_bytes: int):
    """K21's launch on checked CUDA inputs -> misses int32 [S, B]: the
    scan table (int64 words a scan, csrc/prog_spec.cu's kS* order) goes up
    by a pinned copy; the lanes of all scans share one grid."""
    S, B, dev = len(scans), scans[0].grid.shape[0], ok.device
    table = np.zeros((S, _SCAN_WORDS), np.int64)
    lanes = link_blocks = rec_blocks = 0
    for s, sc in enumerate(scans):
        nvy, nvx = sc.valid
        L = B * sc.n_chunks
        magic, shift = fast_div(nvx)
        table[s] = (sc.stream.data_ptr(), sc.stream.shape[0], sc.starts.data_ptr(),
                    sc.ends.data_ptr(), sc.tables.data_ptr(), sc.grid.data_ptr(), sc.n_chunks,
                    nvy * nvx, nvx, sc.grid.shape[2], sc.grid.shape[1], sc.ss, sc.se, sc.al,
                    lanes, link_blocks, rec_blocks, magic & 0xFFFFFFFF, shift)
        lanes += L
        link_blocks += -(-L // _AC_LINK_CHUNKS)
        rec_blocks += -(-L // _AC_REC_THREADS)
    if link_blocks >= 2**31 or rec_blocks >= 2**31:
        raise ValueError("ac_first_spec: too many chunks for one call")
    table_dev = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    counts = torch.empty(2, S * B, dtype=torch.int32, device=dev)  # misses, limits
    chunks = torch.empty(lanes * CHUNK_WORDS, dtype=torch.int32, device=dev)
    states = torch.empty(2, 2 * lanes, dtype=torch.int64, device=dev)  # X, Y
    words = torch.empty(3, 2 * lanes, dtype=torch.int32, device=dev)  # count, blocks passed, err
    links = torch.empty(2 * lanes, dtype=torch.uint8, device=dev)
    runtime.launch(
        "ac_first_spec", dev, "zpix_spec_ac_first_group", "piiii" + "p" * 10 + "lii",
        table_dev.data_ptr(), S, B, 8 * chunk_bytes, 4 * chunk_bytes, ok.data_ptr(),
        counts[0].data_ptr(), counts[1].data_ptr(), chunks.data_ptr(), states[0].data_ptr(),
        states[1].data_ptr(), words[0].data_ptr(), words[1].data_ptr(), words[2].data_ptr(),
        links.data_ptr(), lanes, link_blocks, rec_blocks, kernels=AC_FIRST_KERNELS)
    return counts[0].view(S, B)


def ac_first_spec(stream, starts, ends, tables, ok, grid, *, valid, ss: int, se: int, al: int,
                  chunk_bytes: int, n_chunks: int):
    """K21 on one AC-first scan (``ac_first_spec_group``'s one-scan case)
    -> int32 [B]: on the card each image's misses, in plain PyTorch the
    batch's rounds."""
    return ac_first_spec_group([AcScan(stream, starts, ends, tables, grid, tuple(valid), ss, se,
                                       al, n_chunks)], ok, chunk_bytes=chunk_bytes)[0]


def delta_add_segments(updates) -> None:
    """K22: for each update (state int32 [B, N], idx and val int32 [B, k])
    of ``updates``, ``state[b, idx[b, j]] += val[b, j]``, in place, in one
    launch (indices unique in a row but for padding entries, which add 0;
    two updates may hit one coefficient, as later scans of one band do)."""
    for state, idx, val in updates:
        if state.dtype != torch.int32 or idx.dtype != torch.int32 or val.dtype != torch.int32:
            raise TypeError("delta_add: int32 state, indices and values")
        if state.dim() != 2 or idx.dim() != 2 or idx.shape != val.shape or (
                idx.shape[0] != state.shape[0]):
            raise ValueError("delta_add: state [B, N], indices and values [B, k]")
    if not updates:
        return
    if updates[0][0].device.type == "cpu":
        for state, idx, val in updates:
            delta_add_plain(state, idx, val)
        return
    runtime.require_cuda(*(t for u in updates for t in u))
    rows, tiles = [], 0
    for state, idx, val in updates:
        B, k = idx.shape
        if B * k == 0:
            continue
        per_row = -(-k // _DELTA_TILE)
        rows.append((state.data_ptr(), idx.data_ptr(), val.data_ptr(), state.shape[1], k, per_row,
                     tiles))
        tiles += B * per_row
    if not rows:
        return
    if tiles >= 2**31:
        raise ValueError("delta_add: too many pairs for one launch")
    dev = updates[0][0].device
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    runtime.launch("delta_add", dev, "zpix_delta_add_segments", "pii", table.data_ptr(),
                   len(rows), tiles)


def delta_add(state, idx, val) -> None:
    """K22 on one update (``delta_add_segments``' one-update case):
    ``state[b, idx[b, j]] += val[b, j]`` for an int32 store [B, N] and int32
    [B, k] indices and values, in place."""
    delta_add_segments([(state, idx, val)])
