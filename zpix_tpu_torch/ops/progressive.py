"""Progressive JPEG scans on the coefficient store: K8 (DC first), K9 (AC
first), K10 (AC refinement) and K11 (DC refinement), each a CUDA kernel
with its plain PyTorch version.

* ``dc_first`` is K8 (csrc/prog_entropy.cu, the port of
  zpix_tpu/parallel/progressive_onchip.py::build_dc_first_value_fn, :799,
  and the "dc" arm of ``_make_update``, :1611-1652), one launch and a
  memset: one DC symbol per block, the prefix along each component's
  chain by tiles of whole MCUs (``DC_TILE_LANES``) with decoupled
  look-back between them, and coefficient 0 of each block set to the DC
  shifted by Al.
* ``ac_first`` is K9 (csrc/prog_entropy.cu, ``build_ac_first_value_fn``,
  :866): a persistent grid (``ac_first_grid``) whose warps take the valid
  blocks with data 32 at a time, a lane each, and add each ``val << Al``
  into its row with a reduction.
* ``ac_refine`` is K10 (csrc/prog_entropy.cu, ``build_ac_refine_fn``,
  :937): a warp takes 32 valid blocks' rows into shared memory, each lane
  walks its block a symbol at a time on a mask of its nonzeros, and the
  changed pieces go back in place.
* K8-K10 read symbols through a 9-bit lookahead table that each CTA
  builds (``lut_plain`` is its copy).
* ``dc_refine`` is K11 (csrc/prog_store.cu, the "dcr" arm of
  ``_make_update``, :1713-1745): one raw bit per block ORs ``1 << Al``
  into coefficient 0; a thread a byte of bits, a reduction a set bit.

A scan's inputs: ``stream`` u8 (the batch's destuffed scans), ``starts``
and ``ends`` int32 [B * nblk] absolute bit offsets into it, ``tables``
int32 [TAB_WORDS] (ops/entropy.py::pack_tables: a DC-first scan's tables
with its slot map in ``slot_dc``, an AC scan's one table in slot 0 of
``slot_ac``), and ``ok`` int32 [1], which every pass clears on a failure
(a bad code, a block that does not end where the host said, a read past
the stream buffer).

The store: per component an int32 grid [B, bv, bh, 64], natural order.
A scan names its components' grids and their blocks per MCU ``hv``.  A
single-component scan visits the component's valid blocks only: ``valid
= (nvy, nvx)``, the top-left corner of its grid, in raster order
(decoder.py:525-529).  An interleaved scan visits every block in (MCU,
slot) order.  Values wrap as int32, as in XLA.

The plain versions are lane-parallel loops with the same semantics; the
dispatch takes them for CPU tensors only.  The bounds and design of each
kernel are noted in its CUDA source.
"""

from __future__ import annotations

import torch

from .. import runtime
from ..codecs.jpeg.tables import UNZIG
from . import entropy as _entropy
from .entropy import TAB_WORDS, _bits, _extend, _Tables, _window

# ------------------------------------------------------------- plain versions


def _wrap32(x):
    """int64 -> int32, two's-complement wrap."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mcu_dims(grids, hv):
    return grids[0].shape[2] // hv[0][0], grids[0].shape[1] // hv[0][1]


def _dc_gather(grids, hv, valid):
    """Coefficient 0 of every block the scan visits, in scan order ->
    int64 [B, nblk]."""
    B = grids[0].shape[0]
    if len(grids) == 1:
        nvy, nvx = valid
        return grids[0][:, :nvy, :nvx, 0].reshape(B, -1).to(torch.int64)
    mxx, myy = _mcu_dims(grids, hv)
    parts = [g[..., 0].reshape(B, myy, v, mxx, h).permute(0, 1, 3, 2, 4)
             .reshape(B, myy * mxx, v * h) for g, (h, v) in zip(grids, hv)]
    return torch.cat(parts, 2).reshape(B, -1).to(torch.int64)


def _dc_scatter(grids, hv, valid, vals):
    """Write int64 [B, nblk] values (scan order) into coefficient 0, int32
    wrapping."""
    B = grids[0].shape[0]
    vals = _wrap32(vals)
    if len(grids) == 1:
        nvy, nvx = valid
        grids[0][:, :nvy, :nvx, 0] = vals.view(B, nvy, nvx)
        return
    mxx, myy = _mcu_dims(grids, hv)
    per_mcu = vals.view(B, myy * mxx, -1)
    s0 = 0
    for g, (h, v) in zip(grids, hv):
        part = per_mcu[:, :, s0 : s0 + h * v].reshape(B, myy, mxx, v, h)
        g[..., 0] = part.permute(0, 1, 3, 2, 4).reshape(B, myy * v, mxx * h)
        s0 += h * v


def dc_first_values_plain(stream, starts, ends, tables, ok, *, bpm: int):
    """K8's decode, plain: -> raw DC diffs int32 [L]; clears ``ok``."""
    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    pos = starts.to(torch.int64)
    past = (pos >> 3) + 8 > stream.shape[0]
    v, off = _window(s64, pos)
    slot = torch.arange(pos.shape[0], device=pos.device) % bpm
    ln, sym, bad = tab.decode(_bits(v, off, 16), tab.slot_dc[slot])
    diff = torch.where(past, 0, _extend(v, off + ln, sym))
    err = past | bad | (sym > 16) | (pos + ln + sym != ends.to(torch.int64))
    ok.mul_((~err.any()).to(torch.int32))
    return diff.to(torch.int32)


def store_blocks_plain(src, grids, *, hv, valid, al: int, mode: str):
    """The DC store, plain (K8's write and K11): ``mode="set"`` writes
    int32 [B * nblk] values ``<< al`` into coefficient 0; ``mode="or"``
    reads one bit a block from u8 rows [B, rowlen] (MSB first) and ORs
    ``1 << al`` where it is set.  In place."""
    B = grids[0].shape[0]
    if mode == "set":
        _dc_scatter(grids, hv, valid, src.to(torch.int64).view(B, -1) << al)
        return
    cur = _dc_gather(grids, hv, valid)
    i = torch.arange(cur.shape[1], device=cur.device)
    bit = (src[:, i >> 3].to(torch.int64) >> (7 - (i & 7))) & 1
    _dc_scatter(grids, hv, valid, torch.where(bit > 0, cur | (1 << al), cur))


def dc_first_plain(stream, starts, ends, tables, ok, grids, *, hv, valid, al: int) -> None:
    """K8, plain: decode, K3's plain prefix, the plain store."""
    interleaved = len(grids) > 1
    diffs = dc_first_values_plain(stream, starts, ends, tables, ok,
                                  bpm=sum(h * v for h, v in hv) if interleaved else 1)
    chains, seg = _dc_chains(grids, hv, valid)
    dc = _entropy.dc_restore_plain(diffs, hv=chains, seg_mcus=seg)
    store_blocks_plain(dc, grids, hv=hv, valid=valid, al=al, mode="set")


def dc_refine_plain(rows, grids, *, hv, valid, al: int) -> None:
    """K11, plain: the plain store in or mode."""
    store_blocks_plain(rows, grids, hv=hv, valid=valid, al=al, mode="or")


def _dc_chains(grids, hv, valid):
    """K3's view of a DC scan: (blocks per MCU of each chain, MCUs a
    chain): one chain per component over the MCUs of an interleaved scan,
    one chain over the valid blocks of a single-component one."""
    if len(grids) > 1:
        mxx, myy = _mcu_dims(grids, hv)
        return tuple(hv), mxx * myy
    return ((1, 1),), valid[0] * valid[1]


def _valid_rows(grid, valid):
    nvy, nvx = valid
    return grid[:, :nvy, :nvx].reshape(-1, 64)


def ac_first_plain(stream, starts, ends, hasdata, tables, ok, grid, *, valid, ss: int,
                   se: int, al: int):
    """K9, plain: adds ``val << al`` into the valid blocks' rows of
    ``grid`` in place; clears ``ok``."""
    dev = stream.device
    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n = starts.shape[0]
    lanes = torch.arange(n, device=dev)
    tid = tab.slot_ac[torch.zeros(n, dtype=torch.int64, device=dev)]
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=dev)
    pos = starts.to(torch.int64)
    k = torch.full((n,), ss, dtype=torch.int64, device=dev)
    done = hasdata == 0  # EOB-covered blocks have no bits
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    vals = torch.zeros(n, 64, dtype=torch.int64, device=dev)
    for _ in range(64):  # each symbol advances k or ends the block
        act = ~done & ~err
        if not bool(act.any()):
            break
        err |= act & ((pos >> 3) + 8 > cap)
        act &= ~err
        v, off = _window(s64, pos)
        ln, sym, bad = tab.decode(_bits(v, off, 16), tid)
        err |= act & bad
        act &= ~bad
        r, size = sym >> 4, sym & 15
        eob = (size == 0) & (r < 15)
        zrl = (size == 0) & (r == 15)
        over = (size > 0) & (k + r > se)
        emit = act & (size > 0) & ~over
        vals[lanes[emit], unzig[(k + r)[emit]]] = _extend(v, off + ln, size)[emit]
        consume = torch.where(eob, ln + r, torch.where(zrl | over, ln, ln + size))
        new_k = torch.where(zrl, k + 16, torch.where(eob | over, k, k + r + 1))
        pos = torch.where(act, pos + consume, pos)
        k = torch.where(act, new_k, k)
        done |= act & (eob | over | (new_k > se))
    agree = (pos == ends.to(torch.int64)) | (hasdata == 0)
    ok.mul_((done.all() & ~err.any() & agree.all()).to(torch.int32))
    nvy, nvx = valid
    rows = _valid_rows(grid, valid).to(torch.int64) + (vals << al)
    grid[:, :nvy, :nvx] = _wrap32(rows).view(grid.shape[0], nvy, nvx, 64)


LUT_BITS = 9  # K8-K10's lookahead tables: codes of up to 9 bits in one lookup
LUT_BAD = 0x8000


def lut_plain(tables, tid: int):
    """The lookahead table of packed table ``tid``, as each CTA of
    csrc/prog_entropy.cu builds it (lut_entry) -> int32 [2^LUT_BITS]:
    entry p is LUT_BAD where every 16-bit lookahead whose top LUT_BITS
    bits are p is an invalid code, ``len << 8 | sym`` where all of them
    decode to one code of at most LUT_BITS bits, 0 where the kernel
    decodes in full.  Each limit compare is monotone in the lookahead, so
    the two ends of p's range decide."""
    tab = _Tables(tables)
    low = 16 - LUT_BITS
    p = torch.arange(1 << LUT_BITS, dtype=torch.int64, device=tables.device)
    t = torch.full_like(p, tid)
    ln0, sym0, bad0 = tab.decode(p << low, t)
    ln1, _, bad1 = tab.decode((p << low) | ((1 << low) - 1), t)
    one = ~bad0 & ~bad1 & (ln0 == ln1) & (ln0 <= LUT_BITS)
    lut = torch.where(one, (ln0 << 8) | sym0, 0)
    return torch.where(bad0 & bad1, LUT_BAD, lut).to(torch.int32)


def refine_lut_plain(tables):
    """The lookahead table of an AC scan's one table (slot 0), as K9's and
    K10's CTAs build it."""
    return lut_plain(tables, int(_Tables(tables).slot_ac[0]))


def ac_refine_plain(stream, starts, ends, eob_entry, tables, ok, grid, *, valid, ss: int,
                    se: int, al: int):
    """K10, plain: applies one AC refinement scan to the valid blocks'
    rows of ``grid`` in place; clears ``ok``."""
    dev = stream.device
    tab = _Tables(tables)
    s64 = stream.to(torch.int64)
    cap = stream.shape[0]
    n = starts.shape[0]
    tid = tab.slot_ac[torch.zeros(n, dtype=torch.int64, device=dev)]
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=dev)
    delta = 1 << al
    zig = _valid_rows(grid, valid).to(torch.int64)[:, unzig]  # the store before the scan
    out = zig.clone()
    pos = starts.to(torch.int64)
    in_eob = eob_entry != 0
    need = ~in_eob
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    nz = torch.zeros(n, dtype=torch.int64, device=dev)
    pending = torch.zeros(n, dtype=torch.int64, device=dev)
    for kz in range(ss, se + 1):
        # the next (run, size) symbol, where one is due
        want = need & ~err
        err |= want & ((pos >> 3) + 8 > cap)
        want &= ~err
        v, off = _window(s64, pos)
        ln, sym, badh = tab.decode(_bits(v, off, 16), tid)
        r, s = sym >> 4, sym & 15
        err |= want & (badh | (s > 1))
        want &= ~err
        is_eob = (s == 0) & (r < 15)
        sign = _bits(v, off + ln, 1)
        pos = torch.where(want, pos + ln + torch.where(s == 1, 1, torch.where(is_eob, r, 0)),
                          pos)
        nz = torch.where(want, torch.where(s == 1, r, torch.where(is_eob, 0, 15)), nz)
        pending = torch.where(want, torch.where(s == 1, torch.where(sign > 0, delta, -delta),
                                                0), pending)
        in_eob |= want & is_eob
        need &= ~want
        # zigzag position kz
        coef = zig[:, kz]
        corr = ~err & (coef != 0)
        err |= corr & ((pos >> 3) + 8 > cap)
        corr &= ~err
        v, off = _window(s64, pos)
        cb = _bits(v, off, 1)
        pos = torch.where(corr, pos + 1, pos)
        zero = ~err & (coef == 0) & ~in_eob
        place = zero & (nz == 0)
        nz = torch.where(zero & (nz > 0), nz - 1, nz)
        out[:, kz] = (coef + torch.where(corr & (cb > 0), torch.where(coef > 0, delta, -delta), 0)
                      + torch.where(place, pending, 0))
        pending = torch.where(place, 0, pending)
        need |= place
    ok.mul_((~err.any() & (pos == ends.to(torch.int64)).all()).to(torch.int32))
    nat = torch.empty_like(out)
    nat[:, unzig] = out
    nvy, nvx = valid
    grid[:, :nvy, :nvx] = _wrap32(nat).view(grid.shape[0], nvy, nvx, 64)


# ------------------------------------------------------------------ wrappers


def _check_scan(stream, starts, ends, tables, ok):
    if stream.dtype != torch.uint8 or starts.dtype != torch.int32 or (
        ends.dtype != torch.int32 or tables.dtype != torch.int32 or ok.dtype != torch.int32
    ):
        raise TypeError("progressive: expected a u8 stream and int32 offsets, tables, ok")
    if tables.shape[0] != TAB_WORDS or starts.shape != ends.shape or ok.shape != (1,):
        raise ValueError("progressive: table, offset or ok shapes disagree")


def _check_grids(grids, hv):
    for g in grids:
        if g.dtype != torch.int32 or g.dim() != 4 or g.shape[3] != 64:
            raise TypeError("progressive: the store's grids are int32 [B, bv, bh, 64]")
        if not g.is_contiguous():
            raise ValueError("progressive: the store's grids must be contiguous")
    if len(grids) != len(hv) or not 1 <= len(grids) <= 3:
        raise ValueError("progressive: 1 to 3 grids, one (h, v) each")


def scan_blocks(grids, hv, valid) -> int:
    """Blocks one image has in a DC scan over ``grids``."""
    if len(grids) == 1:
        return valid[0] * valid[1]
    mxx, myy = _mcu_dims(grids, hv)
    return mxx * myy * sum(h * v for h, v in hv)


# Launch shapes (tools/torch_prog_first_stages.py --sweep times others):
# K8's tile, whole MCUs of at most this many blocks (a thread a block, at
# most 1,024); K9's persistent CTAs an SM, of AC_WARPS warps (the
# kernel's kAcWarps).
DC_TILE_LANES = 512
AC_CTAS_PER_SM = 4
AC_WARPS = 8


def fast_div(d: int) -> tuple:
    """The kernels' division by d (csrc/prog_entropy.cu, FastDiv) -> (magic,
    shift), magic as a signed int32: n // d == ((n * magic_u32 >> 32) + n)
    >> shift for 0 <= n < 2^31."""
    if not 1 <= d < 1 << 31:
        raise ValueError("fast_div: divisor out of range")
    shift = (d - 1).bit_length()
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return (magic - (1 << 32) if magic >= 1 << 31 else magic), shift


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_kernel_scan(stream, starts):
    if stream.shape[0] > _entropy.MAX_STREAM or starts.shape[0] >= 1 << 31:
        raise ValueError("progressive: the stream must be under 256 MiB, the blocks under 2^31")


def dc_first(stream, starts, ends, tables, ok, grids, *, hv, valid, al: int) -> None:
    """K8: a DC-first scan -> coefficient 0 of every block it visits set to
    the restored DC << al.  In place; clears ``ok`` on a bad code, a
    symbol > 16, a block not ending at ``ends`` or a read past the
    buffer."""
    _check_grids(grids, hv)
    _check_scan(stream, starts, ends, tables, ok)
    interleaved = len(grids) > 1
    bpm = sum(h * v for h, v in hv) if interleaved else 1
    B = grids[0].shape[0]
    if starts.shape[0] != B * scan_blocks(grids, hv, valid):
        raise ValueError("dc_first: one start per block the scan visits")
    if stream.device.type == "cpu":
        dc_first_plain(stream, starts, ends, tables, ok, grids, hv=hv, valid=valid, al=al)
        return
    runtime.require_cuda(stream, starts, ends, tables, ok, *grids)
    _check_kernel_scan(stream, starts)
    if bpm > _entropy.MAX_SLOTS:
        raise ValueError("dc_first: more than 16 blocks an MCU")
    if interleaved:
        mxx, myy = _mcu_dims(grids, hv)
        per_row, n_mcu, hvs = mxx, mxx * myy, hv
    else:
        per_row, n_mcu, hvs = valid[1], valid[0] * valid[1], [(1, 1)]
    if n_mcu == 0:
        return
    tile_mcus = max(1, min(DC_TILE_LANES, 1024) // bpm)
    tiles = B * -(-n_mcu // tile_mcus)
    threads = -(-tile_mcus * bpm // 32) * 32
    grid = min(tiles, _sm_count(stream.device) * max(1, 2048 // threads))
    scratch = torch.empty(2 * (3 * tiles + 1), dtype=torch.int32, device=stream.device)
    pad = [0] * (3 - len(grids))
    runtime.launch(
        "dc_first", stream.device, "zpix_prog_dc_first", "pl" + "p" * 8 + "i" * 19,
        stream.data_ptr(), stream.shape[0], starts.data_ptr(), ends.data_ptr(),
        tables.data_ptr(), ok.data_ptr(), *[g.data_ptr() for g in grids], *pad,
        scratch.data_ptr(), B, n_mcu, bpm, len(grids), per_row, *fast_div(per_row),
        *[h | v << 4 for h, v in hvs], *pad, *[g.shape[2] for g in grids], *pad,
        *[g.shape[1] for g in grids], *pad, al, tile_mcus, grid,
    )


def dc_refine(rows, grids, *, hv, valid, al: int) -> None:
    """K11: a DC refinement scan (u8 rows [B, rowlen], one bit a block,
    MSB first) -> ``1 << al`` ORed into coefficient 0 of each block the
    scan visits whose bit is set.  In place."""
    _check_grids(grids, hv)
    B, nblk = grids[0].shape[0], scan_blocks(grids, hv, valid)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[0] != B or (
            8 * rows.shape[1] < nblk):
        raise ValueError("dc_refine: takes u8 rows [B, >= nblk / 8]")
    if rows.device.type == "cpu":
        dc_refine_plain(rows, grids, hv=hv, valid=valid, al=al)
        return
    runtime.require_cuda(rows, *grids)
    interleaved = len(grids) > 1
    bpm = sum(h * v for h, v in hv) if interleaved else 1
    if bpm > _entropy.MAX_SLOTS or not 0 <= al <= 31 or B > 65535:
        raise ValueError("dc_refine: more than 16 blocks an MCU, al outside 0..31, or more "
                         "than 65,535 images")
    if B * nblk == 0:
        return
    mxx, myy = _mcu_dims(grids, hv)
    per_row = mxx if interleaved else valid[1]
    pad = [0] * (3 - len(grids))
    runtime.launch(
        "dc_refine", rows.device, "zpix_prog_dc_refine", "piii" + "ppp" + "i" * 13,
        rows.data_ptr(), rows.shape[1], nblk, B, *[g.data_ptr() for g in grids], *pad,
        len(grids), *[h | v << 4 for h, v in hv], *pad, mxx, myy, bpm, *fast_div(bpm),
        per_row, *fast_div(per_row), al,
    )


def _check_ac(stream, starts, ends, flags, tables, ok, grid, valid, ss, se):
    _check_scan(stream, starts, ends, tables, ok)
    _check_grids([grid], [(1, 1)])
    nvy, nvx = valid
    if flags.dtype != torch.int32 or flags.shape != starts.shape:
        raise TypeError("progressive: flags must be int32, one per block")
    if starts.shape[0] != grid.shape[0] * nvy * nvx or nvy > grid.shape[1] or (
            nvx > grid.shape[2]):
        raise ValueError("progressive: one offset per valid block of the grid")
    if not 1 <= ss <= se <= 63:
        raise ValueError("progressive: bad spectral band")


def ac_first_grid(n_lanes: int, device) -> int:
    """K9's CTAs for a scan of ``n_lanes`` valid blocks: AC_CTAS_PER_SM an
    SM, fewer where the scan's 32-block chunks give fewer warps work."""
    want = -(-n_lanes // (32 * AC_WARPS))
    return max(1, min(want, _sm_count(device) * AC_CTAS_PER_SM))


def ac_first(stream, starts, ends, hasdata, tables, ok, grid, *, valid, ss: int, se: int,
             al: int) -> None:
    """K9: an AC-first scan over band ss..se of one component -> ``val <<
    al`` added to each valid block's row of ``grid`` (int32 [B, bv, bh,
    64]).  ``hasdata`` int32 [B * nvalid]: 0 for blocks an EOB run covers
    (no bits, no end check).  In place; clears ``ok`` on a failure."""
    _check_ac(stream, starts, ends, hasdata, tables, ok, grid, valid, ss, se)
    if stream.device.type == "cpu":
        ac_first_plain(stream, starts, ends, hasdata, tables, ok, grid, valid=valid, ss=ss,
                       se=se, al=al)
        return
    runtime.require_cuda(stream, starts, ends, hasdata, tables, ok, grid)
    _check_kernel_scan(stream, starts)
    B, bv, bh = grid.shape[:3]
    nvy, nvx = valid
    n = starts.shape[0]
    if n == 0:
        return
    runtime.launch(
        "ac_first", stream.device, "zpix_prog_ac_first",
        "pl" + "p" * 6 + "i" * 8 + "l" + "i" * 4,
        stream.data_ptr(), stream.shape[0], starts.data_ptr(), ends.data_ptr(),
        hasdata.data_ptr(), tables.data_ptr(), grid.data_ptr(), ok.data_ptr(), n, nvy * nvx,
        *fast_div(nvy * nvx), nvx, *fast_div(nvx), bh, bv * bh, ss, se, al,
        ac_first_grid(n, stream.device),
    )


def ac_refine(stream, starts, ends, eob_entry, tables, ok, grid, *, valid, ss: int,
              se: int, al: int) -> None:
    """K10: an AC refinement scan over band ss..se of one component,
    applied to each valid block's row of ``grid`` in place.  ``eob_entry``
    int32 [B * nvalid]: 1 where an EOB run covers the block at entry.
    Clears ``ok`` on a failure."""
    _check_ac(stream, starts, ends, eob_entry, tables, ok, grid, valid, ss, se)
    if stream.device.type == "cpu":
        ac_refine_plain(stream, starts, ends, eob_entry, tables, ok, grid, valid=valid,
                        ss=ss, se=se, al=al)
        return
    runtime.require_cuda(stream, starts, ends, eob_entry, tables, ok, grid)
    B, bv, bh = grid.shape[:3]
    nvy, nvx = valid
    runtime.launch(
        "ac_refine", stream.device, "zpix_prog_ac_refine",
        "pl" + "pppppp" + "l" + "iii" + "l" + "iii",
        stream.data_ptr(), stream.shape[0], starts.data_ptr(), ends.data_ptr(),
        eob_entry.data_ptr(), tables.data_ptr(), grid.data_ptr(), ok.data_ptr(),
        starts.shape[0], nvy * nvx, nvx, bh, bv * bh, ss, se, al,
    )
