"""Vectorized QOI encoder, bit-exact with the serial op emission: a copy of
zpix_tpu/codecs/qoi/encode_vec.py.  Host only.

The serial encoder (encode.py; the reference's encoder.zig:29-132) looks
history-dependent, but every piece of its state vectorizes:

* prev pixel is just the input shifted by one (runs compare p[i]==p[i-1]).
* The rolling index: the table is only written on an INDEX MISS -- but a
  hit means table[h] already equals the pixel, so after ANY non-run
  pixel the table holds that pixel's value.  Hence pixel i is an INDEX
  hit iff it equals the PREVIOUS NON-RUN PIXEL IN ITS HASH BUCKET
  (first bucket member compares against the zero-initialized table).
  That is one stable argsort by (hash, position) + a shifted compare.
* DIFF/LUMA eligibility is elementwise arithmetic on (p[i], p[i-1]).
* Runs flush at length 62 and before the next literal/at stream end --
  positions computable from run-segment geometry.

Output assembly: per-pixel emitted byte counts -> exclusive cumsum ->
masked scatter of each op class's 1..5 bytes.  It gives the bytes of
``encode`` and of the device encoder (parallel/qoi_batch.py::
encode_device).
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError
from .decode import QOI_PIXELS_MAX
from .encode import Desc

_PADDING = b"\x00" * 7 + b"\x01"


def _plan_ops(px: np.ndarray):
    """px: [n] uint32 packed 0xRRGGBBAA -> per-pixel op plan arrays.

    Returns (kind [n] int8, run_pre [n] int32, sizes [n] int32, fields...)
    kind: 0=run-member(no op) 1=INDEX 2=DIFF 3=LUMA 4=RGB 5=RGBA
    run_pre: number of pending run pixels flushed IMMEDIATELY BEFORE
    this pixel's own op (the serial `if run>0: emit` path), for non-run
    pixels; for run members, 62-chunk flushes are accounted separately.
    """
    n = px.shape[0]
    prev = np.empty_like(px)
    prev[0] = np.uint32(0x000000FF)
    prev[1:] = px[:-1]

    is_run = px == prev  # run-member pixels emit no literal op
    lit = ~is_run

    r = (px >> 24).astype(np.int32)
    g = (px >> 16).astype(np.int32) & 0xFF
    b = (px >> 8).astype(np.int32) & 0xFF
    a = px.astype(np.int32) & 0xFF
    pr = (prev >> 24).astype(np.int32)
    pg = (prev >> 16).astype(np.int32) & 0xFF
    pb = (prev >> 8).astype(np.int32) & 0xFF
    pa = prev.astype(np.int32) & 0xFF

    h = (r * 3 + g * 5 + b * 7 + a * 11) & 63

    # INDEX hit: equals the previous non-run pixel in the same hash
    # bucket (zero-initialized table for the first member).  Stable sort
    # by (hash, position) over the non-run pixels only.
    lit_idx = np.flatnonzero(lit)
    hit = np.zeros(n, bool)
    if lit_idx.size:
        order = np.argsort(h[lit_idx], kind="stable")
        sorted_pos = lit_idx[order]
        sh = h[lit_idx][order]
        sv = px[lit_idx][order]
        prev_v = np.empty_like(sv)
        prev_v[0] = 0
        prev_v[1:] = sv[:-1]
        same_bucket = np.empty(sh.shape, bool)
        same_bucket[0] = False
        same_bucket[1:] = sh[1:] == sh[:-1]
        bucket_prev = np.where(same_bucket, prev_v, np.uint32(0))
        hit[sorted_pos] = bucket_prev == sv

    vr = r - pr
    vg = g - pg
    vb = b - pb
    vg_r = vr - vg
    vg_b = vb - vg
    same_a = a == pa
    can_diff = same_a & (-3 < vr) & (vr < 2) & (-3 < vg) & (vg < 2) & (-3 < vb) & (vb < 2)
    can_luma = same_a & (-9 < vg_r) & (vg_r < 8) & (-33 < vg) & (vg < 32) & (-9 < vg_b) & (vg_b < 8)

    kind = np.zeros(n, np.int8)
    kind[lit & hit] = 1
    miss = lit & ~hit
    kind[miss & can_diff] = 2
    kind[miss & ~can_diff & can_luma] = 3
    kind[miss & ~can_diff & ~can_luma & same_a] = 4
    kind[miss & ~can_diff & ~can_luma & ~same_a] = 5
    return kind, is_run, (h, vr, vg, vb, vg_r, vg_b, r, g, b, a)


def encode_vec(pixels, desc: Desc) -> bytes:
    """Drop-in replacement for encode(): identical bytes, vector ops."""
    if (
        desc.width == 0
        or desc.height == 0
        or desc.channels not in (3, 4)
        or desc.colorspace > 1
        or desc.height >= QOI_PIXELS_MAX // desc.width
    ):
        raise FormatError("qoi: bad encode descriptor")
    n = desc.width * desc.height
    pix = np.asarray(pixels, np.uint8).reshape(-1)
    if len(pix) < n * desc.channels:
        raise FormatError("qoi: pixel buffer too small")
    ch = desc.channels
    c = pix[: n * ch].reshape(n, ch).astype(np.uint32)
    a = c[:, 3] if ch == 4 else np.full(n, 255, np.uint32)
    px = (c[:, 0] << 24) | (c[:, 1] << 16) | (c[:, 2] << 8) | a

    kind, is_run, (h, vr, vg, vb, vg_r, vg_b, r, g, b, av) = _plan_ops(px)

    # ---- run bookkeeping.  For each run segment (maximal stretch of
    # run members) the serial loop emits RUN(62) at every 62nd member
    # and flushes the remainder at the next literal (or at i==n-1).
    run_start = is_run & ~np.concatenate([[False], is_run[:-1]])
    seg_id = np.cumsum(run_start)  # 1-based over run members
    pos_in_seg = np.zeros(n, np.int64)
    if is_run.any():
        idx = np.flatnonzero(is_run)
        seg_of = seg_id[idx]
        first_of_seg = np.concatenate(
            [[True], seg_of[1:] != seg_of[:-1]]
        )
        # position within segment = index - segment start index
        seg_starts = idx[first_of_seg]
        start_of = seg_starts[np.cumsum(first_of_seg) - 1]
        pos_in_seg[idx] = idx - start_of + 1  # 1-based run count
    flush62 = is_run & (pos_in_seg % 62 == 0)  # RUN(62) emitted here
    # remainder flush BEFORE the next literal: attach to each literal
    # the residual count of the run segment immediately preceding it
    run_before = np.zeros(n, np.int64)
    prev_runlen = np.concatenate([[0], pos_in_seg[:-1]])
    lit = kind > 0
    run_before[lit] = np.where(
        is_run[np.maximum(np.flatnonzero(lit) - 1, 0)]
        & (np.flatnonzero(lit) > 0),
        prev_runlen[lit] % 62,
        0,
    )
    # end-of-stream flush (i == n-1 run member with residual)
    tail_flush = int(pos_in_seg[-1] % 62) if is_run[-1] else 0

    sizes = np.zeros(n, np.int64)
    sizes[kind == 1] = 1
    sizes[kind == 2] = 1
    sizes[kind == 3] = 2
    sizes[kind == 4] = 4
    sizes[kind == 5] = 5
    sizes += flush62 * 1  # RUN(62) byte at 62-boundaries
    sizes += (run_before > 0) * 1  # residual RUN byte before a literal

    offs = np.cumsum(sizes) - sizes
    total = int(offs[-1] + sizes[-1]) if n else 0
    out = np.zeros(total + (1 if tail_flush else 0), np.uint8)

    # RUN(62) chunks
    m = flush62
    out[offs[m]] = 0xC0 | 61
    # residual runs before literals (they precede the literal's own bytes)
    m = run_before > 0
    out[offs[m]] = (0xC0 | (run_before[m] - 1)).astype(np.uint8)
    lit_off = offs + (run_before > 0)  # literal bytes start after the flush

    m = kind == 1
    out[lit_off[m]] = h[m].astype(np.uint8)
    m = kind == 2
    out[lit_off[m]] = (
        0x40 | ((vr[m] + 2) << 4) | ((vg[m] + 2) << 2) | (vb[m] + 2)
    ).astype(np.uint8)
    m = kind == 3
    out[lit_off[m]] = (0x80 | (vg[m] + 32)).astype(np.uint8)
    out[lit_off[m] + 1] = (((vg_r[m] + 8) << 4) | (vg_b[m] + 8)).astype(np.uint8)
    m = kind == 4
    out[lit_off[m]] = 0xFE
    out[lit_off[m] + 1] = r[m].astype(np.uint8)
    out[lit_off[m] + 2] = g[m].astype(np.uint8)
    out[lit_off[m] + 3] = b[m].astype(np.uint8)
    m = kind == 5
    out[lit_off[m]] = 0xFF
    out[lit_off[m] + 1] = r[m].astype(np.uint8)
    out[lit_off[m] + 2] = g[m].astype(np.uint8)
    out[lit_off[m] + 3] = b[m].astype(np.uint8)
    out[lit_off[m] + 4] = av[m].astype(np.uint8)
    if tail_flush:
        out[-1] = 0xC0 | (tail_flush - 1)

    header = struct.pack(
        ">IIIBB", 0x716F6966, desc.width, desc.height, desc.channels,
        desc.colorspace,
    )
    return header + out.tobytes() + _PADDING
