"""K19, the speculative chunk sync: a restart-free scan -> every block's
end bit, with no host index pass.

``sync_ends`` wraps K19 (csrc/sync_entropy.cu), the port of
zpix_tpu/parallel/device_entropy_sync.py::build_sync_decode_fn through its
assembly (:176-466), after arXiv:2111.09219.  Each image's scan is cut
into chunks of ``chunk_bytes``; a lane decodes code lengths and run/size
only, from an entry state (bit, MCU slot, k, DC/AC phase) to the first
symbol boundary at or past its chunk's end, and gives the state there.
Chunk i's entry is chunk i - 1's exit from its own entry, and chunk 0
enters at the image's start: the entries are the serial decode's states
at the chunk starts, unique however they are found, and so are the ends
and ``ok``.  zpix_tpu finds them by a modal seed and Jacobi rounds to the
fixed point; on the JAX bench's content the seed is mostly wrong and the
rounds run serially, about one a chunk (PERF.md, K19).  The port finds
them by candidate links instead, on sync chunks of ``sync_factor``
chunks (SYNC_BYTES):

* guesses (K19b): every sync chunk j is scanned from each of the bpm slot
  guesses at its start (chunk 0 from the image's start); the exits
  X[v][j] are chunk j + 1's candidate entries.  A wrong guess merges with
  the serial decode within a few symbols more often than not, so one of
  the candidates is almost always the true entry, and most candidates of a
  chunk are equal.
* links: chunk j + 1 is scanned once from each distinct candidate X[v][j]
  (and stops where it joins a guess's path); its exit Y[v][j + 1] is
  looked up among chunk j + 2's candidates.  The states at the starts of
  the chunks inside the sync chunk are taken on the way (the refine).  A
  missed exit is put in at once as the next chunk's extra candidate.
* resolve: from chunk 1's entry (chunk 0's exit, exact) the links give
  each sync chunk's entry in turn (composed in shared memory, a 32nd of the
  chunks a lane).  Where the true entry is not among a chunk's candidates
  and was not put in (a miss), that chunk is scanned from it and the walk
  goes on; a miss costs one scan, never a wrong entry.  Every chunk's
  entry then comes from its sync chunk's candidate.
* record (K19d): from the entries each chunk counts the blocks that end in
  it and records the first ``mb`` end bits; a block past ``mb``, or a code
  no table holds, sets the chunk's error bit.
* assembly: an exclusive prefix of the counts per image places each end
  at its raster index, then ``ok`` is cleared unless Σ counts >= nblk,
  the last end lies in [img_end - 7, img_end], every error bit lies at or
  past that end, and no lane read past the stream buffer.

``sync_ends_plain`` is the same function in plain PyTorch: the guesses,
links (every candidate), refine and record lane-parallel with one symbol
an iteration (as ops/entropy.py's plain passes), the resolve a walk over
the sync chunks, all images at once.  The dispatch takes it for CPU tensors only.  Its
``ok`` also holds K19's read check, which the JAX package does not make
(it clips reads; on valid streams the two agree).  Entry states travel
packed in one int64: bit << 32 | slot << 16 | k << 8 | phase.
"""

from __future__ import annotations

import torch

from .. import runtime
from .entropy import TAB_WORDS, _bits, _Tables, _window

ERR_NONE = 2**31 - 1  # the error bit of a lane that met no error
# The links run on sync chunks of at least this many bytes: a wrong slot
# guess merges with the serial decode within a few symbols more often
# than not, so on 128 bytes one of the bpm guesses is the true entry
# almost always (PERF.md, K19), and a pass over a sync chunk stays short.
SYNC_BYTES = 128
# The most shared memory an image's links and candidate indices (sync
# chunks x (bpm + 2) bytes) take in K19's resolve; an image with more is
# resolved in global memory.
LINK_SMEM_BYTES = 96 * 1024
LUT_WORDS = 4096  # K19's 10-bit lookahead table, 8 tables of u16 (csrc/sync_entropy.cu)


def chunk_bounds(starts, ends, *, n_chunks: int, chunk_bytes: int):
    """-> (first bit, end bit) of every chunk, int64 [B * n_chunks]: chunk c
    of an image covers [start + c C, start + (c + 1) C) clipped to the
    image's end (C = 8 chunk_bytes bits); chunks past the end are empty."""
    c_bits = 8 * chunk_bytes
    s, e = starts.to(torch.int64)[:, None], ends.to(torch.int64)[:, None]
    raw = s + c_bits * torch.arange(n_chunks, dtype=torch.int64, device=starts.device)
    return torch.minimum(raw, e).reshape(-1), torch.minimum(raw + c_bits, e).reshape(-1)


def pack_entries(bit, slot, k, phase):
    return (bit << 32) | (slot << 16) | (k << 8) | phase


def unpack_entries(p):
    return p >> 32, (p >> 16) & 0xFFFF, (p >> 8) & 0xFF, p & 0xFF


def sync_factor(chunk_bytes: int, sync_bytes: int | None = None) -> int:
    """Chunks of ``chunk_bytes`` a sync chunk holds: enough for at least
    ``sync_bytes`` (default SYNC_BYTES), at least one."""
    want = SYNC_BYTES if sync_bytes is None else sync_bytes
    return max(1, -(-want // chunk_bytes))


def _scan(tab, s64, cap, state, ce, bpm, mb=None):
    """Every lane from its entry to the first symbol boundary at or past
    ce -> (exit state, failed, error bit, block count, recorded ends [L, mb]
    or None).  A bad code stops a lane there (its error bit); a read past
    the buffer stops it too and fails it."""
    bit, slot, k, phase = (x.clone() for x in state)
    n = bit.shape[0]
    lanes = torch.arange(n, device=bit.device)
    act = bit < ce
    fail = torch.zeros_like(act)
    err = torch.full_like(bit, ERR_NONE)
    cnt = torch.zeros_like(bit)
    rec = None if mb is None else torch.zeros(n, mb, dtype=torch.int64, device=bit.device)
    while bool(act.any()):
        past = act & ((bit >> 3) + 8 > cap)
        fail |= past
        act &= ~past
        v, off = _window(s64, bit)
        dc = phase == 0
        tid = torch.where(dc, tab.slot_dc[slot], tab.slot_ac[slot])
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        err = torch.where(act & bad, torch.minimum(err, bit), err)
        app = act & ~bad
        r = torch.where(dc, 0, sym >> 4)
        size = torch.where(dc, sym, sym & 15)
        new_k = torch.where(
            dc, 1, torch.where(size > 0, (k + r).clamp(0, 63) + 1,
                               torch.where(r == 15, k + 16, k)))
        adv = app & ~dc & (((size == 0) & (r != 15)) | (new_k > 63))
        end = bit + ln + size
        if rec is not None:
            err = torch.where(adv & (cnt >= mb), torch.minimum(err, bit), err)
            put = adv & (cnt < mb)
            rec[lanes[put], cnt[put]] = end[put]
        cnt = cnt + adv.to(torch.int64)
        slot = torch.where(adv, slot + 1, slot)
        slot = torch.where(adv & (slot >= bpm), 0, slot)
        k = torch.where(adv, 0, torch.where(app, new_k, k))
        phase = torch.where(adv, 0, torch.where(app & dc, 1, phase))
        bit = torch.where(app, end, bit)
        act = app & (bit < ce)
    return (bit, slot, k, phase), fail, err, cnt, rec


def sync_ends_plain(stream, starts, ends, tables, *, chunk_bytes: int, n_chunks: int,
                    bpm: int, nblk: int, sync_bytes: int | None = None):
    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    B, F, mb = starts.shape[0], n_chunks, 4 * chunk_bytes
    m = sync_factor(chunk_bytes, sync_bytes)
    Fc, V = -(-F // m), bpm
    dev = stream.device
    cs, ce = chunk_bounds(starts, ends, n_chunks=Fc, chunk_bytes=m * chunk_bytes)
    cs, ce = cs.view(B, Fc), ce.view(B, Fc)
    # guesses: X[v, b, j] = exit of sync chunk j from slot guess v (chunk 0
    # from the image's start)
    g = cs[None].expand(V, B, Fc).clone()
    slot = torch.arange(V, device=dev)[:, None, None].expand(V, B, Fc).clone()
    slot[:, :, 0] = 0
    zero = torch.zeros_like(g)
    ex, *_ = _scan(tab, s64, cap, (g.reshape(-1), slot.reshape(-1), zero.reshape(-1),
                                   zero.reshape(-1)), ce[None].expand(V, B, Fc).reshape(-1), bpm)
    X = pack_entries(*ex).view(V, B, Fc)
    # links: Y[v, b, j] = exit of sync chunk j from candidate X[v, b, j - 1]
    ent = unpack_entries(X[:, :, :-1].reshape(-1))
    ex, *_ = _scan(tab, s64, cap, ent, ce[None, :, 1:].expand(V, B, Fc - 1).reshape(-1), bpm)
    Y = pack_entries(*ex).view(V, B, Fc - 1)
    # resolve: walk the sync chunks, all images at once
    entries = torch.empty(B, Fc, dtype=torch.int64, device=dev)
    entries[:, 0] = pack_entries(starts.to(torch.int64), 0, 0, 0)
    cur, misses = X[0, :, 0], 0  # chunk 1's entry: chunk 0's exit from the start
    imgs = torch.arange(B, device=dev)
    for j in range(1, Fc):
        entries[:, j] = cur
        hit = X[:, :, j - 1] == cur[None]  # [V, B]: which candidate it is
        lost = ~hit.any(0)
        misses += int((lost & (cs[:, j] < ce[:, j])).sum())  # empty chunks pass it on
        if j + 1 == Fc:
            break
        nxt = Y[hit.to(torch.int64).argmax(0), imgs, j - 1]
        if bool(lost.any()):  # a miss: scan sync chunk j from the true entry
            st, *_ = _scan(tab, s64, cap, unpack_entries(cur[lost]), ce[lost, j], bpm)
            nxt[lost] = pack_entries(*st)
        cur = nxt
    # refine: each sync chunk's lane walks on to its chunks' starts
    fine = torch.zeros(B, Fc * m, dtype=torch.int64, device=dev)
    fine[:, ::m] = entries
    fs, _ = chunk_bounds(starts, ends, n_chunks=Fc * m, chunk_bytes=chunk_bytes)
    fs = fs.view(B, Fc, m)
    state = unpack_entries(entries.reshape(-1))
    for t in range(1, m):
        state, *_ = _scan(tab, s64, cap, state, fs[:, :, t].reshape(-1), bpm)
        fine[:, t::m] = pack_entries(*state).view(B, Fc)
    fine = fine[:, :F].reshape(-1)
    # record and assembly
    _, ce = chunk_bounds(starts, ends, n_chunks=F, chunk_bytes=chunk_bytes)
    _, fail, err, cnt, rec = _scan(tab, s64, cap, unpack_entries(fine), ce, bpm, mb)
    cnt2 = cnt.view(B, F)
    base = (torch.cumsum(cnt2, 1) - cnt2).reshape(-1)
    out = torch.zeros(B, nblk, dtype=torch.int64, device=dev)
    j = torch.arange(mb, device=dev)
    gi = base[:, None] + j
    put = (j < cnt[:, None]) & (gi < nblk)
    img = torch.arange(B, device=dev).repeat_interleave(F)[:, None].expand(-1, mb)
    out[img[put], gi[put]] = rec[put]
    last = out[:, -1]
    total_ok = bool((cnt2.sum(1) >= nblk).all())
    end_ok = bool(((last <= ends.to(torch.int64)) & (last >= ends.to(torch.int64) - 7)).all())
    err_ok = bool((err.view(B, F) >= last[:, None]).all())
    ok = total_ok and end_ok and err_ok and not bool(fail.any())
    return (out.to(torch.int32), torch.tensor([int(ok)], dtype=torch.int32, device=dev),
            fine.view(B, F), misses)


def sync_ends(stream, starts, ends, tables, *, chunk_bytes: int, n_chunks: int, bpm: int,
              nblk: int, sync_bytes: int | None = None, on_stage=None):
    """K19: stream u8 [cap], starts and ends int32 [B] (each image's first
    and end bit in the stream), packed tables -> (block ends int32 [B,
    nblk], ok int32 [1], entries int64 [B, n_chunks], misses: the sync
    chunks whose true entry was none of their candidates, a Python int on
    the CPU and an int32 [1] tensor on the card, so that the call makes no
    host sync).  The links run on sync chunks of ``sync_factor(chunk_bytes,
    sync_bytes)`` chunks.  ``on_stage(name)``, when given, is called after
    each of K19's four launches is queued: "guesses_links", "resolve"
    (with the refine: every chunk's entry), "record" and "assemble"."""
    if stream.dtype != torch.uint8 or starts.dtype != torch.int32 or (
            ends.dtype != torch.int32 or tables.dtype != torch.int32):
        raise TypeError("sync: expected a u8 stream and int32 bounds and tables")
    if tables.shape[0] != TAB_WORDS or starts.shape != ends.shape or starts.dim() != 1:
        raise ValueError("sync: table or bound shapes disagree")
    if not 1 <= bpm <= 16 or chunk_bytes < 1 or n_chunks < 1 or nblk < 1:
        raise ValueError("sync: bpm, chunk size, chunk count and block count out of range")
    kw = dict(chunk_bytes=chunk_bytes, n_chunks=n_chunks, bpm=bpm, nblk=nblk,
              sync_bytes=sync_bytes)
    if stream.device.type == "cpu":
        return sync_ends_plain(stream, starts, ends, tables, **kw)
    runtime.require_cuda(stream, starts, ends, tables)
    if stream.data_ptr() % 4 or stream.shape[0] >= 2**28:
        raise ValueError("sync: the stream must be 4-byte aligned and under 256 MiB")
    dev = stream.device
    B, F, mb = starts.shape[0], n_chunks, 4 * chunk_bytes
    m = sync_factor(chunk_bytes, sync_bytes)
    Fc = -(-F // m)
    L, W = B * Fc, bpm + 1
    ptrs = (stream.data_ptr(), stream.shape[0], starts.data_ptr(), ends.data_ptr(),
            tables.data_ptr())

    def stage(name):
        if on_stage is not None:
            on_stage(name)

    # one scratch tensor: candidates X, link exits Y [W, L] (column bpm: the
    # exits misses put in), the states inside each sync chunk [m - 1, W, L],
    # the guesses' [m - 1, bpm, L] and their checkpoint states [bpm, L] (int64); the lookahead table; links [L, W] and each sync chunk's
    # candidate index [L] (u8); the recorded ends [B * F, mb], counts and
    # error bits [B * F] (int32)
    n64 = (m + 1) * W * L + m * bpm * L
    n8 = -(-(L * (W + 1)) // 8)
    n32 = -(-(B * F * (mb + 2)) // 2)
    scratch = torch.empty(n64 + LUT_WORDS // 2 + n8 + n32, dtype=torch.int64, device=dev)
    X, Y = scratch[: W * L], scratch[W * L : 2 * W * L]
    S, SG = scratch[2 * W * L : (m + 1) * W * L], scratch[(m + 1) * W * L : n64 - bpm * L]
    CP = scratch[n64 - bpm * L : n64]
    lut = scratch[n64 : n64 + LUT_WORDS // 2]
    links, tj = scratch[n64 + LUT_WORDS // 2 :][:n8].view(torch.uint8)[: L * (W + 1)].split(
        [L * W, L])
    rec, cnt, err = scratch[n64 + LUT_WORDS // 2 + n8 :].view(torch.int32)[
        : B * F * (mb + 2)].split([B * F * mb, B * F, B * F])
    fine = torch.empty(B * F, dtype=torch.int64, device=dev)
    out = torch.empty(B, nblk, dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)  # ok, misses: set by the kernels
    geom = (B, Fc, 8 * chunk_bytes, m, bpm)
    runtime.launch("sync_decode", dev, "zpix_sync_guess_link", "plppp" + "pppppppp" + "iiiii",
                   *ptrs, lut.data_ptr(), X.data_ptr(), Y.data_ptr(), S.data_ptr(), SG.data_ptr(),
                   CP.data_ptr(), links.data_ptr(), flags.data_ptr(), *geom)
    stage("guesses_links")
    runtime.launch("sync_decode", dev, "zpix_sync_resolve", "plppp" + "pppppppppp" + "iiiiiii",
                   *ptrs, lut.data_ptr(), X.data_ptr(), Y.data_ptr(), S.data_ptr(), SG.data_ptr(),
                   CP.data_ptr(), links.data_ptr(), tj.data_ptr(), fine.data_ptr(), flags.data_ptr(), B, Fc, F,
                   8 * chunk_bytes, m, bpm, LINK_SMEM_BYTES)
    stage("resolve")
    runtime.launch("sync_decode", dev, "zpix_sync_record", "plppp" + "pppppp" + "iiiii",
                   *ptrs, lut.data_ptr(), fine.data_ptr(), rec.data_ptr(), cnt.data_ptr(),
                   err.data_ptr(), flags.data_ptr(), B, F, 8 * chunk_bytes, bpm, mb)
    stage("record")
    runtime.launch("sync_decode", dev, "zpix_sync_assemble", "pppppp" + "iiii",
                   ends.data_ptr(), rec.data_ptr(), cnt.data_ptr(), err.data_ptr(),
                   out.data_ptr(), flags.data_ptr(), B, F, mb, nblk)
    stage("assemble")
    return out, flags[:1], fine.view(B, F), flags[1:]
