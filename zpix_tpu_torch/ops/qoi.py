"""QOI on the card: K12 (lane expansion), K13 (sorted expansion) and K14
(the encoder), each a CUDA kernel with its plain PyTorch version.

* ``lane_expand_wide`` and ``lane_expand_p4`` wrap K12
  (csrc/qoi_expand.cu), the port of
  zpix_tpu/parallel/qoi_batch.py::build_qoi_lane_expand_fn (:1174):
  lane-major entries -> ``out[lane, p] = sum_r col[r] * (s[r] <= p < e[r])``
  (uint32, wrapping) -> bytes R, G, B, A.
* ``sorted_expand`` wraps K13 (csrc/qoi_expand.cu), the port of
  ``build_qoi_expand_fn`` (:818): per-image cumsum of the counts,
  searchsorted side "right", gather, and the stream-exhausted fill.
* ``encode`` wraps K14 (csrc/qoi_encode.cu), the port of ``_encode_core``
  (:1423) under ``_encode_fn``'s vmap (:1542): packed pixels -> the op
  bytes, byte-identical to the serial encoder, and each image's total.

A packed pixel is 0xRRGGBBAA held in an int32 tensor (the same 32 bits:
torch has no full uint32 arithmetic).  The plain versions are written as
the JAX graphs are; the dispatch takes them for CPU tensors only.  The
bounds and design of each kernel are noted in its CUDA source.
"""

from __future__ import annotations

import torch

from .. import runtime

ENC_TILE = 1024  # pixels a tile of K14 (csrc/qoi_encode.cu kTile)
SCAN_TILE = 4096  # counts a tile of K13's scans (csrc/qoi_expand.cu kTile)
_SIZES = (0, 1, 1, 2, 4, 5)  # bytes of an op, by kind


def encode_cap(n: int) -> int:
    """Bytes the device encoder reserves for an image of n pixels
    (qoi_batch.py:1548); the stream always fits."""
    return 5 * n + n // 62 + 8


def _u32(x):
    """int32 bits -> their uint32 value as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _rgba(packed, shape):
    """uint32 values (int64) 0xRRGGBBAA -> uint8 [*shape, 4] (R, G, B, A)."""
    ch = [(packed >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    return torch.stack(ch, -1).to(torch.uint8).reshape(*shape, 4)


# ------------------------------------------------------------ K12 lane expand


def _lane_sum(cols, s, e, P: int):
    """[Lt, R] colours (uint32 as int64) and spans -> [Lt, P] wrapped sums."""
    p = torch.arange(P, dtype=torch.int32, device=cols.device)
    acc = torch.zeros(cols.shape[0], P, dtype=torch.int64, device=cols.device)
    for r in range(cols.shape[1]):  # the JAX graph's sum over R, a slot at a time
        m = (p >= s[:, r : r + 1]) & (p < e[:, r : r + 1])
        acc += torch.where(m, cols[:, r : r + 1], 0)
    return acc & 0xFFFFFFFF


def _p4_entries(p4, P: int):
    """[Lt, R * 4] (r, g, b, start) u8 -> (cols int64, s, e int32) [Lt, R]."""
    t = p4.view(p4.shape[0], -1, 4).to(torch.int64)
    cols = (t[..., 0] << 24) | (t[..., 1] << 16) | (t[..., 2] << 8) | 0xFF
    s = t[..., 3].to(torch.int32)
    e = torch.cat([s[:, 1:], torch.full_like(s[:, :1], P)], 1)
    return cols, s, e


def lane_expand_wide_plain(cols, s, e, *, P: int, shape):
    return _rgba(_lane_sum(_u32(cols), s.to(torch.int32), e.to(torch.int32), P), shape)


def lane_expand_p4_plain(p4, *, P: int, shape):
    return _rgba(_lane_sum(*_p4_entries(p4, P), P), shape)


def _check_lanes(lanes: int, R: int, P: int, shape):
    B, H, W = shape
    if P < 1 or R < 1 or lanes * P != B * H * W:
        raise ValueError("qoi lane expand: the lanes must tile the batch's pixels")


def lane_expand_wide(cols, s, e, *, P: int, shape):
    """K12, wide form: cols int32 (uint32 bits), s and e int16, each [Lt, R],
    lane-major -> RGBA8 [B, H, W, 4] for ``shape`` = (B, H, W)."""
    if cols.dtype != torch.int32 or s.dtype != torch.int16 or e.dtype != torch.int16:
        raise TypeError("qoi lane expand: expected int32 colours and int16 spans")
    if cols.dim() != 2 or s.shape != cols.shape or e.shape != cols.shape:
        raise ValueError("qoi lane expand: cols, s and e must be [Lt, R]")
    _check_lanes(cols.shape[0], cols.shape[1], P, shape)
    if cols.device.type == "cpu":
        return lane_expand_wide_plain(cols, s, e, P=P, shape=shape)
    runtime.require_cuda(cols, s, e)
    out = torch.empty(*shape, 4, dtype=torch.uint8, device=cols.device)
    runtime.launch("qoi_lane_expand", cols.device, "zpix_qoi_lane_expand", "pppppliii",
                   cols.data_ptr(), s.data_ptr(), e.data_ptr(), 0, out.data_ptr(),
                   cols.shape[0], cols.shape[1], P, 0)
    return out


def lane_expand_p4(p4, *, P: int, shape):
    """K12, p4 form: [Lt, R * 4] u8 (r, g, b, start) granules, lane-major,
    ends implicit, alpha 255 -> RGBA8 [B, H, W, 4]."""
    if p4.dtype != torch.uint8 or p4.dim() != 2 or p4.shape[1] % 4:
        raise ValueError("qoi lane expand: p4 must be u8 [Lt, R * 4]")
    _check_lanes(p4.shape[0], p4.shape[1] // 4, P, shape)
    if p4.device.type == "cpu":
        return lane_expand_p4_plain(p4, P=P, shape=shape)
    runtime.require_cuda(p4)
    if p4.data_ptr() % 4:
        raise ValueError("qoi lane expand: p4 must be 4-byte aligned")
    out = torch.empty(*shape, 4, dtype=torch.uint8, device=p4.device)
    runtime.launch("qoi_lane_expand", p4.device, "zpix_qoi_lane_expand", "pppppliii",
                   0, 0, 0, p4.data_ptr(), out.data_ptr(), p4.shape[0], p4.shape[1] // 4, P, 1)
    return out


# ---------------------------------------------------------- K13 sorted expand


def sorted_expand_plain(cols, cnts, fill, *, shape):
    B, rcap = cols.shape
    npx = shape[1] * shape[2]
    cum = cnts.to(torch.int32).cumsum(1, dtype=torch.int32)
    total = cum[:, -1:]
    gpix = torch.arange(npx, dtype=torch.int32, device=cols.device).expand(B, npx).contiguous()
    op = torch.searchsorted(cum, gpix, right=True).clamp(0, rcap - 1)
    packed = torch.where(gpix < total, torch.gather(cols, 1, op), fill[:, None])
    return _rgba(_u32(packed), shape)


def sorted_expand(cols, cnts, fill, *, shape):
    """K13: records cols int32 (uint32 bits) [B, rcap], cnts u8 [B, rcap],
    fill int32 [B] -> RGBA8 [B, H, W, 4] for ``shape`` = (B, H, W)."""
    if cols.dtype != torch.int32 or cnts.dtype != torch.uint8 or fill.dtype != torch.int32:
        raise TypeError("qoi sorted expand: expected int32 cols and fill, u8 counts")
    if cols.dim() != 2 or cnts.shape != cols.shape or tuple(fill.shape) != (cols.shape[0],):
        raise ValueError("qoi sorted expand: cols and cnts [B, rcap], fill [B]")
    B, rcap = cols.shape
    if B != shape[0] or rcap < 1 or rcap * 255 >= 2**31:
        raise ValueError("qoi sorted expand: batch or record capacity out of range")
    if cols.device.type == "cpu":
        return sorted_expand_plain(cols, cnts, fill, shape=shape)
    runtime.require_cuda(cols, cnts, fill)
    dev = cols.device
    cum = torch.empty(B, rcap, dtype=torch.int32, device=dev)
    tile_sum = torch.empty(B, -(-rcap // SCAN_TILE), dtype=torch.int32, device=dev)
    total = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.empty(*shape, 4, dtype=torch.uint8, device=dev)
    runtime.launch("qoi_sorted_expand", dev, "zpix_qoi_sorted_expand", "ppppppplll",
                   cols.data_ptr(), cnts.data_ptr(), fill.data_ptr(), cum.data_ptr(),
                   tile_sum.data_ptr(), total.data_ptr(), out.data_ptr(), B, rcap,
                   shape[1] * shape[2], kernels=4)
    return out


# ------------------------------------------------------------- K14 encoder


def encode_plain(px):
    """[B, n] packed pixels (int32) -> (op bytes u8 [B, cap], zero past each
    total, totals int32 [B]), written as ``_encode_core`` is."""
    dev = px.device
    B, n = px.shape
    cap = encode_cap(n)
    i64 = torch.int64
    v = _u32(px)
    prev = torch.cat([torch.full((B, 1), 0xFF, dtype=i64, device=dev), v[:, :-1]], 1)
    is_run = v == prev
    lit = ~is_run
    r, g, b, a = [(v >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    pr, pg, pb, pa = [(prev >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    h = (r * 3 + g * 5 + b * 7 + a * 11) & 63

    # INDEX hit: the previous literal of the same bucket equals me (the
    # first literal of a bucket compares against the zero table)
    key = torch.where(lit, h, 64)
    order = torch.argsort(key, dim=1, stable=True)
    sh = key.gather(1, order)
    sv = v.gather(1, order)
    zero = torch.zeros(B, 1, dtype=i64, device=dev)
    prev_v = torch.cat([zero, sv[:, :-1]], 1)
    same_bucket = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=dev),
                             sh[:, 1:] == sh[:, :-1]], 1)
    hit_sorted = (torch.where(same_bucket, prev_v, 0) == sv) & (sh < 64)
    hit = torch.zeros_like(hit_sorted).scatter(1, order, hit_sorted)

    vr, vg, vb = r - pr, g - pg, b - pb
    vg_r, vg_b = vr - vg, vb - vg
    same_a = a == pa
    can_diff = same_a & (vr > -3) & (vr < 2) & (vg > -3) & (vg < 2) & (vb > -3) & (vb < 2)
    can_luma = (same_a & (vg_r > -9) & (vg_r < 8) & (vg > -33) & (vg < 32)
                & (vg_b > -9) & (vg_b < 8))
    miss = lit & ~hit
    kind = torch.zeros(B, n, dtype=i64, device=dev)
    kind = torch.where(lit & hit, 1, kind)
    kind = torch.where(miss & can_diff, 2, kind)
    kind = torch.where(miss & ~can_diff & can_luma, 3, kind)
    kind = torch.where(miss & ~can_diff & ~can_luma & same_a, 4, kind)
    kind = torch.where(miss & ~can_diff & ~can_luma & ~same_a, 5, kind)

    # runs: position in each maximal run, flushes at 62, before a literal
    # and at the end of the image
    iarr = torch.arange(n, dtype=i64, device=dev).expand(B, n)
    first = torch.ones(B, 1, dtype=torch.bool, device=dev)
    run_start = is_run & torch.cat([first, ~is_run[:, :-1]], 1)
    seg_start = torch.cummax(torch.where(run_start, iarr, -1), 1).values
    pos = torch.where(is_run, iarr - seg_start + 1, 0)
    flush62 = is_run & (pos % 62 == 0)
    prev_runlen = torch.cat([zero, pos[:, :-1]], 1)
    prev_isrun = torch.cat([~first, is_run[:, :-1]], 1)
    run_before = torch.where(lit & prev_isrun, prev_runlen % 62, 0)
    tail = torch.where(is_run[:, -1], pos[:, -1] % 62, 0)

    sizes = torch.tensor(_SIZES, dtype=i64, device=dev)[kind]
    sizes = sizes + flush62 + (run_before > 0)
    offs = sizes.cumsum(1) - sizes
    total = offs[:, -1] + sizes[:, -1]

    # masked scatters into [B, cap + 1]; slot cap of each row takes the
    # masked-off writes and is dropped
    out = torch.zeros(B, cap + 1, dtype=torch.uint8, device=dev)
    flat = out.view(-1)
    base = torch.arange(B, dtype=i64, device=dev)[:, None] * (cap + 1)

    def put(idx, val, mask):
        flat[torch.where(mask, idx, cap) + base] = (val & 0xFF).to(torch.uint8)

    put(offs, torch.full_like(offs, 0xC0 | 61), flush62)
    put(offs, 0xC0 | (run_before - 1), run_before > 0)
    lo = offs + (run_before > 0)
    put(lo, h, kind == 1)
    put(lo, 0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2), kind == 2)
    put(lo, 0x80 | (vg + 32), kind == 3)
    put(lo + 1, ((vg_r + 8) << 4) | (vg_b + 8), kind == 3)
    put(lo, torch.full_like(lo, 0xFE), kind == 4)
    is45 = (kind == 4) | (kind == 5)
    put(lo + 1, r, is45)
    put(lo + 2, g, is45)
    put(lo + 3, b, is45)
    put(lo, torch.full_like(lo, 0xFF), kind == 5)
    put(lo + 4, a, kind == 5)
    put(total[:, None], (0xC0 | (tail - 1))[:, None], (tail > 0)[:, None])
    return out[:, :cap], (total + (tail > 0)).to(torch.int32)


def encode(px):
    """K14: packed pixels int32 (uint32 bits 0xRRGGBBAA) [B, n] -> (op bytes
    u8 [B, cap] with cap = encode_cap(n), zero past each image's stream,
    totals int32 [B]).  ``out[b, :total[b]]`` is the serial encoder's op
    stream (no header, no padding)."""
    if px.dtype != torch.int32 or px.dim() != 2 or px.shape[1] < 1:
        raise ValueError("qoi encode: expected int32 packed pixels [B, n], n >= 1")
    if encode_cap(px.shape[1]) >= 2**31:
        raise ValueError("qoi encode: an image's stream offsets must fit int32")
    if px.device.type == "cpu":
        return encode_plain(px)
    runtime.require_cuda(px)
    B, n = px.shape
    cap = encode_cap(n)
    tiles = B * -(-n // ENC_TILE)
    scratch = torch.empty(tiles * 133 + B, dtype=torch.int32, device=px.device)
    out = torch.zeros(B, cap, dtype=torch.uint8, device=px.device)
    total = torch.empty(B, dtype=torch.int32, device=px.device)
    runtime.launch("qoi_encode", px.device, "zpix_qoi_encode_batch", "pppplll",
                   px.data_ptr(), out.data_ptr(), total.data_ptr(), scratch.data_ptr(),
                   B, n, cap, kernels=5)
    return out, total
