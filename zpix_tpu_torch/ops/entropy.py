"""Entropy decode of restart segments: K1 (index pass), K2 (value pass)
and K3 (DC restore), each a CUDA kernel with its plain PyTorch version.

* ``index_pass`` wraps K1 (csrc/entropy.cu), the port of
  zpix_tpu/parallel/device_entropy.py::build_decode_fn's ``run_pass1``
  (:974-1058): one lane per restart segment finds every block's end bit.
* ``value_pass`` wraps K2 (csrc/entropy.cu), the port of ``_value_pass``
  (:611-766) and its agree/ok check (:1143-1150): one lane per block
  decodes the DC diff and the natural-order AC row.
* K1 and K2 read each symbol through a lookahead table that every CTA
  builds from the packed tables; ``index_lut_plain`` is its copy.
* ``dc_restore`` wraps K3 (csrc/dc_restore.cu), the port of
  ``_restore_dc_T_split`` (:836-851): one kernel, tiles of whole MCUs,
  for the short chains of restart segments and the whole-image chains of
  restart-free streams alike.

Layouts: lanes are block-major, lane = segment * nblk + mcu * bpm + slot,
so a segment's blocks, and an MCU's slots, are contiguous.  ``ok`` is an
int32 [1] tensor that the passes clear on any failure.  The bounds and
design of each kernel are noted in its CUDA source.

The plain versions are lane-parallel loops, one symbol per iteration,
with the same semantics (the dispatch takes them for CPU tensors only).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..codecs.jpeg.tables import UNZIG

# Layout of the packed int32 table tensor (csrc/huffman.cuh keeps the same).
TAB_LIMS, TAB_AOFF, TAB_VALS = 0, 128, 256
TAB_SLOT_DC, TAB_SLOT_AC, TAB_NVALS = 2304, 2320, 2336
TAB_QUANT = 2368
TAB_WORDS = TAB_QUANT + 4 * 64
MAX_TABLES, MAX_VALS, MAX_SLOTS = 8, 2048, 16

# K1 and K2's lookahead table (csrc/entropy.cu): codes of up to LUT_BITS
# bits in one lookup; an entry is LUT_BAD where every lookahead it covers
# is invalid, 0 where the kernels decode in full.
LUT_BITS = 10
LUT_BAD = 0x80000000
# The kernels' bit positions are int32: streams up to this many bytes.
MAX_STREAM = (1 << 28) - 1024


def pack_tables(tabs, slot_dc, slot_ac, quants=()) -> np.ndarray:
    """Huffman tables, per-slot table indices and quant tables -> one
    int32 vector the kernels read.

    For each table t, in the limit-compare form of zpix_tpu's CmpTables
    (device_entropy.py:126-140): ``lims[t][i]`` is the first 16-bit
    lookahead past the codes of length i+1, ``aoff[t][i]`` maps a code of
    that length to its index in the concatenated symbol bytes.
    """
    if len(tabs) > MAX_TABLES or len(slot_dc) > MAX_SLOTS:
        raise ValueError("jpeg: too many Huffman tables or MCU slots")
    out = np.zeros(TAB_WORDS, np.int32)
    base = 0
    for t, tab in enumerate(tabs):
        lim, a_prev = 0, 0
        for ln in range(1, 17):
            mx = tab.max_codes[ln - 1]
            if mx >= 0:
                lim = (mx + 1) << (16 - ln)
                a_prev = base + tab.vals_indices[ln - 1] - tab.min_codes[ln - 1]
            out[TAB_LIMS + 16 * t + ln - 1] = lim
            out[TAB_AOFF + 16 * t + ln - 1] = a_prev
        out[TAB_VALS + base : TAB_VALS + base + tab.num_codes] = tab.vals[: tab.num_codes]
        base += tab.num_codes
    out[TAB_NVALS] = base
    out[TAB_SLOT_DC : TAB_SLOT_DC + len(slot_dc)] = slot_dc
    out[TAB_SLOT_AC : TAB_SLOT_AC + len(slot_ac)] = slot_ac
    for c, q in enumerate(quants):
        out[TAB_QUANT + 64 * c : TAB_QUANT + 64 * (c + 1)] = q
    return out


# ------------------------------------------------------------ plain versions


class _Tables:
    """The packed tables as int64 tensors, for the plain versions."""

    def __init__(self, tables: torch.Tensor):
        t = tables.to(torch.int64)
        self.lims = t[TAB_LIMS : TAB_LIMS + 16 * MAX_TABLES].view(MAX_TABLES, 16)
        self.aoff = t[TAB_AOFF : TAB_AOFF + 16 * MAX_TABLES].view(MAX_TABLES, 16)
        self.vals = t[TAB_VALS : TAB_VALS + MAX_VALS]
        self.nvals = t[TAB_NVALS]
        self.slot_dc = t[TAB_SLOT_DC : TAB_SLOT_DC + MAX_SLOTS]
        self.slot_ac = t[TAB_SLOT_AC : TAB_SLOT_AC + MAX_SLOTS]

    def decode(self, look, tid):
        """-> (code length, symbol, bad) per lane (see csrc/huffman.cuh)."""
        lims, aoff = self.lims[tid], self.aoff[tid]
        ge = look[:, None] >= lims[:, :15]
        ln = 1 + ge.sum(1)
        a = aoff[:, 0] + (ge * (aoff[:, 1:] - aoff[:, :-1])).sum(1)
        bad = look >= lims[:, 15]
        vidx = a + (look >> (16 - ln))
        inside = (vidx >= 0) & (vidx < self.nvals)
        sym = torch.where(inside, self.vals[vidx.clamp(0, MAX_VALS - 1)], 0)
        return ln, sym, bad


def lut_entry(ln, sym, ac):
    """The kernels' lookahead entry of a code of ``ln`` bits for ``sym``,
    in the DC (ac 0) or AC (1) role: adv | step << 9 | len << 16 | size <<
    21, where adv = len + size bits, size = sym (DC) or sym & 15 (AC), and
    step = 1 (DC), run + 1 (size > 0), 16 (ZRL) or 64 (EOB): the block ends
    where the zigzag index k, 0 at the DC symbol, reaches 64."""
    size = torch.where(ac != 0, sym & 15, sym)
    r = sym >> 4
    step = torch.where(ac == 0, 1, torch.where(size > 0, r + 1, torch.where(r == 15, 16, 64)))
    return (ln + size) | (step << 9) | (ln << 16) | (size << 21)


def index_lut_plain(tables):
    """K1 and K2's lookahead table, as each CTA of csrc/entropy.cu builds
    it for the (table, role) pairs its slots use -> int64 [2, MAX_TABLES,
    2^LUT_BITS] (role: 0 DC, 1 AC).  Entry p is LUT_BAD where every 16-bit
    lookahead whose top LUT_BITS bits are p is an invalid code,
    ``lut_entry`` where all of them decode to one code of at most LUT_BITS
    bits, and 0 elsewhere: there the kernels read a second-level block,
    the ``lut_entry`` of each of the 64 lookaheads under p (0 for an
    invalid code), or decode in full.  Each limit compare is monotone in
    the lookahead, so the two ends of p's range decide."""
    tab = _Tables(tables)
    low = 16 - LUT_BITS
    p = torch.arange(1 << LUT_BITS, dtype=torch.int64, device=tables.device)
    out = torch.zeros(2, MAX_TABLES, 1 << LUT_BITS, dtype=torch.int64, device=tables.device)
    for t in range(MAX_TABLES):
        tid = torch.full_like(p, t)
        ln0, sym0, bad0 = tab.decode(p << low, tid)
        ln1, _, bad1 = tab.decode((p << low) | ((1 << low) - 1), tid)
        one = ~bad0 & ~bad1 & (ln0 == ln1) & (ln0 <= LUT_BITS)
        for ac in (0, 1):
            e = torch.where(one, lut_entry(ln0, sym0, torch.full_like(p, ac)), 0)
            out[ac, t] = torch.where(bad0 & bad1, LUT_BAD, e)
    return out


def _window(stream64, pos):
    """40 bits from byte pos >> 3 (big-endian) and the bit offset in them."""
    byte = (pos >> 3).clamp(0, stream64.shape[0] - 5)
    v = torch.zeros_like(pos)
    for i in range(5):
        v = (v << 8) | stream64[byte + i]
    return v, pos & 7


def _bits(v, off, n):
    """n (0..16) bits at bit off of a 40-bit window."""
    return (v >> (40 - off - n)) & ((1 << n) - 1)


def _extend(v, off, size):
    """RECEIVE + EXTEND with the JAX value pass's clipping (see huffman.cuh)."""
    sz = size.clamp(0, 16)
    raw = _bits(v, off, sz)
    top = (size - 1).clamp(0, 15)
    ext = torch.where(raw < (1 << top), raw - ((1 << sz) - 1), raw)
    return torch.where(size > 0, ext, 0)


def index_pass_plain(stream, seg_pos, seg_nmcu, tables, *, bpm: int, nblk: int):
    """K1's plain version: -> (ends int32 [L1, nblk], ok int32 [1])."""
    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n = seg_pos.shape[0]
    lanes = torch.arange(n, device=stream.device)
    pos = seg_pos.to(torch.int64)
    nm = seg_nmcu.to(torch.int64)
    slot, mcu, k = (torch.zeros(n, dtype=torch.int64, device=stream.device)
                    for _ in range(3))
    dc = torch.ones(n, dtype=torch.bool, device=stream.device)
    err = torch.zeros_like(dc)
    ends = torch.zeros(n, nblk, dtype=torch.int64, device=stream.device)
    while True:
        act = ~err & (mcu < nm)
        if not bool(act.any()):
            break
        past = act & ((pos >> 3) + 8 > cap)  # a read past the stream buffer
        err |= past
        act &= ~past
        v, off = _window(s64, pos)
        tid = torch.where(dc, tab.slot_dc[slot], tab.slot_ac[slot])
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        err |= act & bad
        app = act & ~bad
        r = torch.where(dc, 0, sym >> 4)
        size = torch.where(dc, sym, sym & 15)
        new_pos = pos + ln + size
        new_k = torch.where(
            dc, 1, torch.where(size > 0, (k + r).clamp(0, 63) + 1,
                               torch.where(r == 15, k + 16, k)))
        blk_done = ~dc & (((size == 0) & (r != 15)) | (new_k > 63))
        adv = app & blk_done
        col = (mcu * bpm + slot).clamp(0, nblk - 1)
        ends[lanes[adv], col[adv]] = new_pos[adv]
        pos = torch.where(app, new_pos, pos)
        k = torch.where(adv, 0, torch.where(app, new_k, k))
        dc = torch.where(adv, True, torch.where(app, False, dc))
        slot = torch.where(adv, slot + 1, slot)
        wrap = adv & (slot >= bpm)
        slot = torch.where(wrap, 0, slot)
        mcu = torch.where(wrap, mcu + 1, mcu)
    ok = (~err.any()).to(torch.int32).reshape(1)
    return ends.to(torch.int32), ok


def value_pass_plain(stream, seg_pos, seg_nmcu, tables, ends, ok, *, bpm: int):
    """K2's plain version: -> (ac int16 [L1*nblk, 64] natural order,
    dc int32 [L1*nblk] raw diffs); clears ``ok`` in place on failure."""
    tab = _Tables(tables)
    dev = stream.device
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n_seg, nblk = ends.shape
    n = n_seg * nblk
    lanes = torch.arange(n, device=dev)
    blk = lanes % nblk
    slot = blk % bpm
    valid = (blk // bpm) < seg_nmcu.to(torch.int64).repeat_interleave(nblk)
    ends64 = ends.to(torch.int64)
    pos = torch.cat([seg_pos.to(torch.int64)[:, None], ends64[:, :-1]], 1).reshape(-1)
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=dev)
    coef = torch.zeros(n, 64, dtype=torch.int16, device=dev)
    err = torch.zeros(n, dtype=torch.bool, device=dev)

    def step(act, tid):
        past = act & ((pos >> 3) + 8 > cap)
        act = act & ~past
        v, off = _window(s64, pos)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        return act & ~bad, past | (act & bad), v, off + ln, ln, sym

    # DC: every valid lane's first symbol
    app, e, v, off, ln, sym = step(valid, tab.slot_dc[slot])
    err |= e
    dc = torch.where(app, _extend(v, off, sym), 0)
    pos = torch.where(app, pos + ln + sym, pos)
    k = torch.ones(n, dtype=torch.int64, device=dev)
    done = ~app
    tac = tab.slot_ac[slot]
    while True:
        act = ~done
        if not bool(act.any()):
            break
        app, e, v, off, ln, sym = step(act, tac)
        err |= e
        r, size = sym >> 4, sym & 15
        emit_k = (k + r).clamp(0, 63)
        put = app & (size > 0)
        coef[lanes[put], unzig[emit_k[put]]] = _extend(v, off, size)[put].to(torch.int16)
        new_k = torch.where(size > 0, emit_k + 1, torch.where(r == 15, k + 16, k))
        blk_done = ((size == 0) & (r != 15)) | (new_k > 63)
        pos = torch.where(app, pos + ln + size, pos)
        k = torch.where(app, new_k, k)
        done |= e | (app & blk_done)
    agree = (pos == ends64.reshape(-1)) | ~valid
    ok.mul_((~(err & valid).any() & agree.all()).to(torch.int32))
    return coef, dc.to(torch.int32)


def dc_restore_plain(dc, *, hv, seg_mcus: int):
    """K3's plain version: inclusive prefix sum of the DC diffs along each
    (segment, component) chain, int32 wrapping."""
    bpm = sum(h * v for h, v in hv)
    d = dc.to(torch.int64).view(-1, seg_mcus, bpm)
    parts, s0 = [], 0
    for h, v in hv:
        nb = h * v
        part = d[:, :, s0 : s0 + nb].reshape(d.shape[0], -1).cumsum(1)
        parts.append(part.view(d.shape[0], seg_mcus, nb))
        s0 += nb
    return torch.cat(parts, 2).reshape(-1).to(torch.int32)


# ------------------------------------------------------------------ wrappers


def _check_entropy_inputs(stream, seg_pos, seg_nmcu, tables):
    if stream.dtype != torch.uint8 or seg_pos.dtype != torch.int32 or (
        seg_nmcu.dtype != torch.int32 or tables.dtype != torch.int32
    ):
        raise TypeError("entropy: expected u8 stream and int32 offsets/tables")
    if tables.shape[0] != TAB_WORDS or seg_pos.shape != seg_nmcu.shape:
        raise ValueError("entropy: table or lane shapes disagree")


def _check_kernel_inputs(stream, bpm, nblk):
    if stream.shape[0] > MAX_STREAM:
        raise ValueError("entropy: the stream must be under 256 MiB")
    if not 1 <= bpm <= MAX_SLOTS or nblk < 1:
        raise ValueError("entropy: bpm or block count out of range")


def index_pass(stream, seg_pos, seg_nmcu, tables, *, bpm: int, nblk: int):
    """K1: -> (ends int32 [L1, nblk] absolute end bit of each block, 0 for
    padding blocks; ok int32 [1], 0 if a lane hit a bad code or ran past
    the buffer)."""
    _check_entropy_inputs(stream, seg_pos, seg_nmcu, tables)
    if stream.device.type == "cpu":
        return index_pass_plain(stream, seg_pos, seg_nmcu, tables, bpm=bpm, nblk=nblk)
    runtime.require_cuda(stream, seg_pos, seg_nmcu, tables)
    _check_kernel_inputs(stream, bpm, nblk)
    n = seg_pos.shape[0]
    ends = torch.empty(n, nblk, dtype=torch.int32, device=stream.device)
    ok = torch.ones(1, dtype=torch.int32, device=stream.device)
    runtime.launch(
        "index_pass", stream.device, "zpix_index_pass", "plppppp" + "iii",
        stream.data_ptr(), stream.shape[0], seg_pos.data_ptr(), seg_nmcu.data_ptr(),
        tables.data_ptr(), ends.data_ptr(), ok.data_ptr(), n, bpm, nblk,
    )
    return ends, ok


def value_pass(stream, seg_pos, seg_nmcu, tables, ends, ok, *, bpm: int):
    """K2: -> (ac int16 [L1*nblk, 64] natural order, dc int32 [L1*nblk]
    raw diffs).  Clears ``ok`` if a valid block hit a bad code or did not
    end where ``ends`` says."""
    _check_entropy_inputs(stream, seg_pos, seg_nmcu, tables)
    if ends.dtype != torch.int32 or ends.shape[0] != seg_pos.shape[0]:
        raise ValueError("value_pass: ends must be int32 [L1, nblk]")
    if stream.device.type == "cpu":
        return value_pass_plain(stream, seg_pos, seg_nmcu, tables, ends, ok, bpm=bpm)
    runtime.require_cuda(stream, seg_pos, seg_nmcu, tables, ends, ok)
    _check_kernel_inputs(stream, bpm, ends.shape[1])
    n = ends.numel()
    ac = torch.empty(n, 64, dtype=torch.int16, device=stream.device)
    dc = torch.empty(n, dtype=torch.int32, device=stream.device)
    runtime.launch(
        "value_pass", stream.device, "zpix_value_pass", "plpppppppl" + "ii",
        stream.data_ptr(), stream.shape[0], seg_pos.data_ptr(), seg_nmcu.data_ptr(),
        tables.data_ptr(), ends.data_ptr(), ac.data_ptr(), dc.data_ptr(),
        ok.data_ptr(), n, bpm, ends.shape[1],
    )
    return ac, dc


# MCUs a K3 CTA takes, a thread each (kTile in csrc/dc_restore.cu): it
# sizes the kernel's look-back scratch.
K3_TILE_MCUS = 128
_DC_COMPS = 4


def dc_restore(dc, *, hv, seg_mcus: int):
    """K3: raw DC diffs [L1*seg_mcus*bpm] int32 -> restored DC values (the
    inclusive prefix sum along each (segment, component) chain).  One
    launch; where a tile can start inside a segment, its look-back words
    live in the stream's kept scratch (no allocation, no memset)."""
    if dc.dtype != torch.int32:
        raise TypeError("dc_restore: expected int32 diffs")
    if dc.device.type == "cpu":
        return dc_restore_plain(dc, hv=hv, seg_mcus=seg_mcus)
    runtime.require_cuda(dc)
    nb = [h * v for h, v in hv]
    bpm = sum(nb)
    if not 1 <= len(nb) <= _DC_COMPS or dc.numel() % (seg_mcus * bpm):
        raise ValueError("dc_restore: the diffs are no whole segments of 1-4 chains")
    scratch, words, epoch = None, 0, 0
    if K3_TILE_MCUS % seg_mcus:  # a tile can start inside a segment: look-back, a ticket
        words = -(-(dc.numel() // bpm) // K3_TILE_MCUS) * _DC_COMPS + 1
        scratch, epoch = runtime.lookback_scratch(dc.device, words)
    out = torch.empty_like(dc)
    runtime.launch(
        "dc_restore", dc.device, "zpix_dc_restore", "pppli" + "l" + "i" * 7,
        dc.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), words, epoch,
        dc.numel(), seg_mcus, bpm, len(nb), *(nb + [0] * (_DC_COMPS - len(nb))),
    )
    return out
