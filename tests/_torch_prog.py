"""AC-first scans coded by hand for the zpix_tpu_torch tests: every rule of
K9's symbol walk (ZRL, EOB runs with their run bits, the overflow rule, a
band ending on a value) on a table with codes of 6 and of 12 bits, with
the store the scan must leave.  Made from numpy seeds; imports nothing of
the JAX package, so the GPU tests use it too.
"""

from __future__ import annotations

import numpy as np

from zpix_tpu_torch.codecs.jpeg.tables import UNZIG
from zpix_tpu_torch.parallel.progressive_onchip import ScanPrep

# Every AC symbol: EOBn (r << 4, r < 15), ZRL (0xF0), (r, size) for sizes
# 1..10.  40 codes of 6 bits, the rest of 12 (past K9's 9-bit lookahead).
AC_SYMBOLS = [r << 4 for r in range(16)] + [r << 4 | s for r in range(16) for s in range(1, 11)]
AC_COUNTS = [0] * 5 + [40] + [0] * 5 + [len(AC_SYMBOLS) - 40] + [0] * 4


def _codes(counts, syms):
    """symbol -> (code, length), canonical."""
    out, code, i = {}, 0, 0
    for ln, n in enumerate(counts, 1):
        for _ in range(n):
            out[syms[i]] = (code, ln)
            code += 1
            i += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def __len__(self):
        return len(self.bits)


def _magnitude(v: int) -> tuple:
    """(size, bits) of a nonzero coefficient (T.81 F.1.2.1)."""
    size = abs(v).bit_length()
    return size, (v if v > 0 else v + (1 << size) - 1)


def ac_first_scan(seed: int, *, batch=2, nvy=7, nvx=37, bv=8, bh=40, ss=1, se=63, al=1,
                  covered=0.3, zrl=0.15, overflow=0.05, eob_run_bits=True, store="random"):
    """A hand-coded AC-first scan over band ss..se of one component, every
    valid block of ``batch`` images (the top-left nvy x nvx corner of a
    [bv, bh] grid), a share ``covered`` of them in an EOB run (no bits).
    A block with data takes symbols until its band ends, an EOB (its run
    bits random: EOBn with n up to 14 when ``eob_run_bits``), or an
    overflow symbol (a size > 0 symbol with k + r > se: its code bits
    only) -> dict: ``prep`` (ScanPrep), ``grid`` int32 [batch, bv, bh, 64]
    (the store before the scan: random values, zeros, or random values
    inside the band only), ``want`` (the store after it), ``valid``
    (nvy, nvx), ``symbols``,
    and the counts of each rule used (``zrl``, ``eob_runs``,
    ``overflows``, ``band_ends``)."""
    rng = np.random.default_rng(seed)
    codes = _codes(AC_COUNTS, AC_SYMBOLS)
    nvalid = nvy * nvx
    out = _Bits()
    starts, ends = np.zeros(batch * nvalid, np.int64), np.zeros(batch * nvalid, np.int64)
    hasdata = (rng.random(batch * nvalid) >= covered).astype(np.int32)
    vals = np.zeros((batch * nvalid, 64), np.int64)
    count = {"symbols": 0, "zrl": 0, "eob_runs": 0, "overflows": 0, "band_ends": 0}

    def sym(s):
        c, ln = codes[s]
        out.put(c, ln)
        count["symbols"] += 1

    for lane in range(batch * nvalid):
        starts[lane] = len(out)
        if hasdata[lane]:
            k = ss
            while True:
                u = rng.random()
                if u < zrl:  # ZRL: 16 zeros
                    sym(0xF0)
                    count["zrl"] += 1
                    k += 16
                    if k > se:
                        count["band_ends"] += 1
                        break
                elif u < zrl + overflow:  # a value past the band: code bits only
                    r = int(rng.integers(se - k + 1, 16)) if se - k + 1 < 16 else None
                    if r is None:
                        continue
                    sym(r << 4 | int(rng.integers(1, 11)))
                    count["overflows"] += 1
                    break
                elif u < zrl + overflow + 0.2:  # EOB, its run bits
                    r = int(rng.integers(0, 15)) if eob_run_bits else 0
                    sym(r << 4)
                    out.put(int(rng.integers(0, 1 << r)), r)
                    count["eob_runs"] += r > 0
                    break
                else:
                    r = int(rng.integers(0, min(15, se - k) + 1))
                    v = int(rng.integers(1, 1024)) * (1 if rng.random() < 0.5 else -1)
                    size, bits = _magnitude(v)
                    sym(r << 4 | size)
                    out.put(bits, size)
                    vals[lane, UNZIG[k + r]] = v
                    k += r + 1
                    if k > se:
                        count["band_ends"] += 1
                        break
        ends[lane] = len(out)
    out.put(int(rng.integers(0, 1 << 30)), 30)  # bits past the last block
    nbytes = (len(out) + 7) // 8 + 16
    bits = np.zeros(nbytes * 8, np.uint8)
    bits[: len(out)] = out.bits
    stream = np.packbits(bits)
    prep = ScanPrep.from_arrays("ac_first", comps=(0,), ss=ss, se=se, al=al, stream=stream,
                                starts=starts, ends=ends, flags=hasdata,
                                huffs=[(AC_COUNTS, AC_SYMBOLS)])
    if store == "zero":
        grid = np.zeros((batch, bv, bh, 64), np.int32)
    else:
        grid = rng.integers(-(1 << 31), 1 << 31, (batch, bv, bh, 64), dtype=np.int64)
        if store == "band":  # nonzeros only where the scan writes
            band = np.zeros(64, bool)
            band[[UNZIG[k] for k in range(ss, se + 1)]] = True
            grid[..., ~band] = 0
        grid = grid.astype(np.int32)
    want = grid.astype(np.int64)
    want[:, :nvy, :nvx] += (vals << al).reshape(batch, nvy, nvx, 64)
    want = (((want + (1 << 31)) % (1 << 32)) - (1 << 31)).astype(np.int32)
    return {"prep": prep, "grid": grid, "want": want, "valid": (nvy, nvx), **count}


# ------------------------------------------------------------------- K11

# DC refinement cases: name -> (hv of the scan's components (one for a
# single-component scan), valid corner as a fraction of its grid or None
# for an interleaved scan, al, bits: "random", "all" or "none", extra
# bytes a row).  MCU grids of mxx x myy give block counts no multiple of
# 8 or 32 and rows no multiple of 4 bytes; "wide_rows" carries bytes past
# its bits, and every case sets the padding bits past the last block.
K11_CASES = {
    "444": ([(1, 1)] * 3, None, 1, "random", 0),
    "422": ([(2, 1), (1, 1), (1, 1)], None, 2, "random", 0),
    "420": ([(2, 2), (1, 1), (1, 1)], None, 0, "random", 0),
    "411": ([(4, 1), (1, 1), (1, 1)], None, 5, "random", 0),
    "single_partial": ([(2, 2)], (0.9, 0.94), 3, "random", 0),
    "single_chroma": ([(1, 1)], (1.0, 1.0), 4, "random", 0),
    "all_set": ([(2, 2), (1, 1), (1, 1)], None, 7, "all", 0),
    "none_set": ([(2, 2), (1, 1), (1, 1)], None, 7, "none", 0),
    "wide_rows": ([(2, 1), (1, 1), (1, 1)], None, 13, "random", 5),
}


def k11_case(name: str, seed: int, *, mxx=13, myy=7, batch=3, al=None):
    """-> (rows u8 [B, rowlen], grids int32 [B, bv, bh, 64] a component
    holding random values, hv, valid, al) for K11_CASES[name]; ``al``
    overrides the case's."""
    hv, frac, case_al, kind, extra = K11_CASES[name]
    rng = np.random.default_rng(seed)
    grids = [rng.integers(-2 ** 20, 2 ** 20, (batch, myy * v, mxx * h, 64)).astype(np.int32)
             for h, v in hv]
    if frac is None:
        valid, nblk = None, mxx * myy * sum(h * v for h, v in hv)
    else:
        valid = tuple(max(1, int(n * f)) for n, f in zip(grids[0].shape[1:3], frac))
        nblk = valid[0] * valid[1]
    rowlen = (nblk + 7) // 8 + extra
    if kind == "random":
        rows = rng.integers(0, 256, (batch, rowlen)).astype(np.uint8)
    else:
        rows = np.full((batch, rowlen), 0xFF if kind == "all" else 0, np.uint8)
    if nblk % 8:  # the bits past the last block are set: they must be ignored
        rows[:, nblk // 8] |= 0xFF >> (nblk % 8)
    return rows, grids, hv, valid, case_al if al is None else al


def dc_refine_words(rows, grids, hv, valid, al: int, run: int) -> None:
    """K11's algorithm in numpy (csrc/prog_store.cu), in place on the
    grids: a thread's ``run`` positions as one word of bits from bytes, the
    padding bits masked, its set bits walked MSB first, each position
    mapped through the slot table by the multiply-high divisions, and
    ``1 << al`` ORed into row 0."""
    from zpix_tpu_torch.ops.progressive import fast_div

    def div(n, pair):
        magic, shift = pair
        return (((n * (magic & 0xFFFFFFFF)) >> 32) + n) >> shift

    interleaved = len(grids) > 1
    mxx = grids[0].shape[2] // hv[0][0]
    if interleaved:
        slots = [(c, dy, dx) for c, (h, v) in enumerate(hv) for dy in range(v)
                 for dx in range(h)]
        bpm, per_row = len(slots), mxx
        nblk = mxx * (grids[0].shape[1] // hv[0][1]) * bpm
    else:
        bpm, per_row = 1, valid[1]
        nblk = valid[0] * valid[1]
    by_mcu, by_row = fast_div(bpm), fast_div(per_row)
    bit = np.int32(np.uint32(1 << al).view(np.int32))
    for b in range(rows.shape[0]):
        for first in range(0, nblk, run):
            n = min(run, nblk - first)
            w = 0
            for k in range(run // 8):
                if 8 * k < n:
                    w |= int(rows[b, first // 8 + k]) << (24 - 8 * k)
            if n < 32:
                w &= ~(0xFFFFFFFF >> n) & 0xFFFFFFFF
            while w:
                k = 32 - w.bit_length()  # __clz
                w ^= 0x80000000 >> k
                i = first + k
                if interleaved:
                    mcu = div(i, by_mcu)
                    c, dy, dx = slots[i - mcu * bpm]
                    my = div(mcu, by_row)
                    by, bx = my * hv[c][1] + dy, (mcu - my * per_row) * hv[c][0] + dx
                else:
                    c, by = 0, div(i, by_row)
                    bx = i - by * per_row
                grids[c][b, by, bx, 0] |= bit
