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
