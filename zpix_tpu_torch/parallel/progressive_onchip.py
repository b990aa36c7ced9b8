"""Progressive JPEG on the GPU in host-index mode: SOF2 batches end to end.

The PyTorch/CUDA counterpart of zpix_tpu/parallel/progressive_onchip.py's
``OnchipProgressiveDecoder`` in its default host-index mode:

1. The host parses each stream (``parse_progressive``, numpy) and walks
   every scan of every image with the port's copies of the C++ index walks
   (csrc/host/entropy.cpp, ``zpix_prog_{dc_first,ac_first,refine}_index``;
   one image a worker thread, its scans in script order, so the nonzero
   masks and EOB runs evolve on the host and no store is fetched).
2. One pinned copy carries every scan's streams, offsets, flags and
   tables and the quant rows to the card (``PinnedUpload``).
3. One kernel a scan, in script order, on one stream with no host sync,
   updates an int32 coefficient store (per component [B, bv, bh, 64]):
   K8 for a DC-first scan, K9 AC first, K10 AC refinement, K11 DC
   refinement (ops/progressive.py).  ``ok`` is accumulated on the card.
4. K6 (ops/planes.py, its int32 arm) turns the store into pixels.

Output: (pixels u8 [B, H, W, 3], or [B, H, W] for gray; ok 0-dim bool),
both on the decoder's device.  A batch shares geometry, scan script and
Huffman tables (quant tables are per image).

Not ported, by decision: the speculative-chunk path and the host tail
(``impl="spec"``, ``_TailScanDecoder``).  Where an index walk refuses a
stream, the port returns ``ok`` False and does not raise
(``ProgPrep.failure`` names the scan and the image), and the batch
belongs to a host decoder: ``decode_verified`` then decodes it with the
port's (codecs/jpeg/decoder.py).  The ``max_batch`` split and the benchmark
``salt`` were TPU mechanics and change no output.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..codecs.jpeg import decoder as _host_decoder
from ..codecs.jpeg.tables import UNZIG, HuffTable
from ..color import ycbcr_to_rgb8
from ..errors import FormatError, UnsupportedError
from ..ops import entropy as _entropy
from ..ops import progressive as _prog
from ..runtime import host as _host
from .batch import decode_batch_planes
from .device_entropy import PinnedUpload, resolve_device

_RATIOS = {0x11: "444", 0x12: "440", 0x21: "422",
           0x22: "420", 0x41: "411", 0x42: "410"}

# ---------------------------------------------------------------- parse


@dataclass
class ScanInfo:
    comps: tuple  # component indices (0-based) in scan order
    td: tuple  # DC table id per scan component
    ta: tuple  # AC table id per scan component
    ss: int
    se: int
    ah: int
    al: int
    stream: np.ndarray  # destuffed entropy bytes of this scan
    huffs: dict = None  # (tc, th) -> HuffTable snapshot at this scan

    @property
    def kind(self) -> str:
        if self.ss == 0:
            return "dc_first" if self.ah == 0 else "dc_refine"
        return "ac_first" if self.ah == 0 else "ac_refine"


@dataclass
class ProgPlan:
    width: int
    height: int
    ncomp: int
    hv: tuple
    mxx: int
    myy: int
    quants: list  # [ncomp] natural-order int32[64]
    scans: list  # [ScanInfo]
    ratio: str
    tq: tuple  # per-component quant selector


def _destuff_scan(data: bytes, start: int):
    """Destuff one scan's entropy bytes: FF00 -> FF, stop at the first real
    marker (refinement scans end at the next DHT/SOS/EOI).  RST markers
    inside the scan -> UnsupportedError."""
    d = np.frombuffer(data, np.uint8)[start:]
    ff = np.flatnonzero(d[:-1] == 0xFF)
    nxt = d[ff + 1]
    real = ff[(nxt != 0x00) & (nxt != 0xFF)]
    end = int(real[0]) if len(real) else len(d)
    rst_mask = (nxt >= 0xD0) & (nxt <= 0xD7)
    if len(real) and rst_mask[np.searchsorted(ff, real[0])]:
        raise UnsupportedError("jpeg: progressive restart intervals on-chip")
    stuffed = ff[(nxt == 0x00)]
    stuffed = stuffed[stuffed < end]
    keep = np.ones(end, bool)
    keep[stuffed + 1] = False
    return d[:end][keep], start + end


def _scan_header(body, sof, huffs) -> tuple:
    """An SOS segment's (component indices, DC table ids, AC table ids, Ss,
    Se, Ah, Al), held to what the index walks and kernels rely on: a band
    inside one block, known components and defined tables; else
    FormatError."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise FormatError("jpeg: bad SOS segment")
    ids = tuple(c[0] for c in sof[3])
    cidx, tds, tas = [], [], []
    for i in range(ns):
        cs, tt = body[1 + 2 * i], body[2 + 2 * i]
        if cs not in ids:
            raise FormatError(f"jpeg: SOS names unknown component {cs}")
        cidx.append(ids.index(cs))
        tds.append(tt >> 4)
        tas.append(tt & 15)
    ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if ss > se or se > 63 or (ss == 0 and se != 0) or ah > 13 or al > 13:
        raise FormatError(f"jpeg: bad progressive scan Ss={ss} Se={se} Ah={ah} Al={al}")
    if ss:
        need = [(1, ta) for ta in tas]
    else:
        need = [] if ah else [(0, td) for td in tds]
    if any(k not in huffs for k in need):
        raise FormatError("jpeg: scan uses an undefined Huffman table")
    return tuple(cidx), tuple(tds), tuple(tas), ss, se, ah, al


def parse_progressive(data: bytes) -> ProgPlan:
    """Full marker walk of one SOF2 stream: geometry, per-scan parameters,
    table snapshots and destuffed entropy segments.  Malformed headers
    raise FormatError before any index walk reads them."""
    if data[:2] != b"\xff\xd8":
        raise FormatError("jpeg: missing SOI")
    pos = 2
    quants: dict = {}
    huffs: dict = {}
    sof = None
    scans: list = []
    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        if pos + 2 > len(data):
            raise FormatError("jpeg: truncated segment")
        seg_len = (data[pos] << 8) | data[pos + 1]
        if seg_len < 2 or pos + seg_len > len(data):
            raise FormatError("jpeg: truncated segment")
        body = data[pos + 2 : pos + seg_len]
        if marker == 0xC2:
            if len(body) < 6 or len(body) < 6 + 3 * body[5]:
                raise FormatError("jpeg: bad SOF2 segment")
            if body[0] != 8:
                raise UnsupportedError("jpeg: only 8-bit precision")
            h, w, nc = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            if not (h and w and nc) or any(not (1 <= hc <= 4 and 1 <= vc <= 4)
                                           for _, hc, vc, _ in comps):
                raise FormatError("jpeg: bad SOF2 segment")
            sof = (w, h, nc, tuple(comps))
        elif marker in (0xC0, 0xC1):
            raise UnsupportedError("jpeg: baseline stream; use the baseline path")
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedError("jpeg: only progressive DCT here")
        elif marker == 0xC4:
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1 : o + 17])
                total = sum(counts)
                if o + 17 + total > len(body):
                    raise FormatError("jpeg: truncated DHT segment")
                t = HuffTable()
                t.build(counts, bytes(body[o + 17 : o + 17 + total]))
                huffs[(tc, th)] = t
                o += 17 + total
        elif marker == 0xDB:
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                if o + (65 if pq == 0 else 129) > len(body):
                    raise FormatError("jpeg: truncated DQT segment")
                if pq == 0:
                    q = np.array(list(body[o + 1 : o + 65]), np.int32)
                    o += 65
                else:
                    raw = body[o + 1 : o + 129]
                    q = np.array([(raw[2 * i] << 8) | raw[2 * i + 1] for i in range(64)],
                                 np.int32)
                    o += 129
                nat = np.zeros(64, np.int32)
                nat[UNZIG] = q
                quants[tq] = nat
        elif marker == 0xDD:
            if (body[0] << 8) | body[1]:
                raise UnsupportedError("jpeg: progressive restart intervals on-chip")
        elif marker == 0xDA:
            if sof is None:
                raise FormatError("jpeg: SOS before SOF")
            cidx, tds, tas, ss, se, ah, al = _scan_header(body, sof, huffs)
            stream, endpos = _destuff_scan(data, pos + seg_len)
            scans.append(ScanInfo(comps=cidx, td=tds, ta=tas, ss=ss, se=se, ah=ah, al=al,
                                  stream=stream, huffs=dict(huffs)))
            pos = endpos
            continue
        pos += seg_len
    if sof is None or not scans:
        raise FormatError("jpeg: no SOF2/SOS")
    w, h, nc, comps = sof
    if any(c[3] not in quants for c in comps):
        raise FormatError("jpeg: a component's quant table is undefined")
    if nc == 1:
        # grayscale ignores declared sampling factors
        # (decoder.zig:546-561 normalizes (h, v) to (1, 1))
        cid, _, _, tq = comps[0]
        comps = ((cid, 1, 1, tq),)
    h0, v0 = comps[0][1], comps[0][2]
    ratio = "gray"
    if nc >= 3:
        ratio = _RATIOS.get((h0 // comps[1][1]) << 4 | (v0 // comps[1][2]))
        if ratio is None:
            raise UnsupportedError("jpeg: unsupported sampling")
    return ProgPlan(
        width=w, height=h, ncomp=nc, hv=tuple((c[1], c[2]) for c in comps),
        mxx=(w + 8 * h0 - 1) // (8 * h0), myy=(h + 8 * v0 - 1) // (8 * v0),
        quants=[quants[c[3]] for c in comps], scans=scans, ratio=ratio,
        tq=tuple(c[3] for c in comps),
    )


# ------------------------------------------------------- batch and geometry


def script_key(plan: ProgPlan) -> tuple:
    """Geometry, scan script and the full canonical identity of every
    scan's tables (symbols alone would collide for tables with equal
    symbol order but different code lengths).  Quant tables are per image
    and not part of it."""
    return (plan.width, plan.height, plan.ncomp, plan.hv, tuple(
        (s.comps, s.td, s.ta, s.ss, s.se, s.ah, s.al, tuple(sorted(
            (k, t.num_codes, tuple(t.vals[: t.num_codes]), tuple(t.min_codes),
             tuple(t.max_codes), tuple(t.vals_indices)) for k, t in s.huffs.items())))
        for s in plan.scans))


def check_batch(plans) -> None:
    """A batch shares geometry, scan script and tables, and has 1 or 3
    components; else UnsupportedError."""
    k0 = script_key(plans[0])
    if any(script_key(p) != k0 for p in plans[1:]):
        raise UnsupportedError(
            "jpeg: progressive batch must share geometry, scan script, and tables")
    if plans[0].ncomp not in (1, 3):
        raise UnsupportedError("jpeg: on-chip progressive covers gray/YCbCr")


def valid_grid(plan, c: int) -> tuple:
    """Component c's VALID blocks, those whose 8-pixel origin lies inside
    the image (decoder.py:525-529), as the corner they form: (nvy, nvx),
    rows < nvy and columns < nvx of the component's grid.  ``plan`` is a
    ProgPlan or a ProgPrep."""
    hc, vc = plan.hv[c]
    return (min(plan.myy * vc, -(-plan.height // 8)), min(plan.mxx * hc, -(-plan.width // 8)))


# Zero bytes after each image's scan in a stacked stream: the index walks
# read < 5 bytes past a stream and must read zeros there, as the
# reference's callers arrange by padding 8.
STREAM_GAP = 8


def stack_streams(streams) -> tuple:
    """The images' scans back to back, each at an 8-byte-aligned offset and
    followed by >= STREAM_GAP zero bytes, and >= 16 bytes of zeros at the
    end so the kernels' 8-byte window reads stay inside -> (buffer, byte
    offset of each)."""
    offs, total = [], 0
    for s in streams:
        offs.append(total)
        total += (len(s) + STREAM_GAP + 7) // 8 * 8
    flat = np.zeros(total + 16, np.uint8)
    for s, o in zip(streams, offs):
        flat[o : o + len(s)] = s
    if flat.shape[0] >= 1 << 28:
        raise UnsupportedError("jpeg: a progressive scan's batch stream is over 256 MiB")
    return flat, np.asarray(offs, np.int64)


# ------------------------------------------------------------- host prep


@dataclass
class ScanPrep:
    """One scan's device inputs, for the whole batch.

    ``stream`` u8: the images' destuffed scans stacked (``stack_streams``),
    or for a DC refinement the raw bit rows [B, rowlen].  ``starts``,
    ``ends`` int32 [B * nblk]: absolute bit offsets of each block the scan
    visits.  ``flags`` int32 [B * nblk]: hasdata (AC first) or EOB at
    entry (AC refinement).  ``tables`` int32 [TAB_WORDS]."""

    kind: str  # dc_first | ac_first | ac_refine | dc_refine
    comps: tuple  # frame components in scan order
    ss: int
    se: int
    al: int
    stream: np.ndarray
    starts: np.ndarray | None = None
    ends: np.ndarray | None = None
    flags: np.ndarray | None = None
    tables: np.ndarray | None = None

    ARRAYS = ("stream", "starts", "ends", "flags", "tables")

    @classmethod
    def from_arrays(cls, kind: str, *, comps, ss: int, se: int, al: int, stream,
                    starts=None, ends=None, flags=None, huffs=(), tid_of_slot=(0,)):
        """A scan from plain arrays: ``huffs`` its Huffman tables as (counts,
        vals) pairs, in the order ``tid_of_slot`` (the DC-first scan's
        table of each MCU slot) indexes them; an AC scan has one."""
        tabs = []
        for counts, vals in huffs:
            t = HuffTable()
            t.build(counts, vals)
            tabs.append(t)
        tables = None
        if kind == "dc_first":
            tables = _entropy.pack_tables(tabs, list(tid_of_slot), [])
        elif kind in ("ac_first", "ac_refine"):
            tables = _entropy.pack_tables(tabs, [], [0])
        def i32(a):
            return None if a is None else np.ascontiguousarray(a, np.int32)

        return cls(kind=kind, comps=tuple(int(c) for c in comps), ss=int(ss), se=int(se),
                   al=int(al), stream=np.ascontiguousarray(stream, np.uint8),
                   starts=i32(starts), ends=i32(ends), flags=i32(flags), tables=tables)

    def arrays(self) -> list:
        return [getattr(self, n) for n in self.ARRAYS if getattr(self, n) is not None]


@dataclass
class ProgPrep:
    """A batch ready for the card: geometry, per-image quant rows and one
    ``ScanPrep`` per scan in script order.  ``okh`` is the host's part of
    ``ok``; ``failure`` names the scan and the image that cleared it."""

    width: int
    height: int
    hv: tuple
    mxx: int
    myy: int
    ratio: str
    quants: np.ndarray  # int32 [ncomp, B, 64], natural order
    scans: list
    okh: bool = True
    failure: str | None = None

    @property
    def ncomp(self) -> int:
        return len(self.hv)

    @property
    def batch(self) -> int:
        return self.quants.shape[1]


def _huff_c(tabs):
    """HuffTables -> the C side's HuffTable array (csrc/host/entropy.cpp)."""
    arr = (_host.HuffTableC * len(tabs))()
    for ct, tab in zip(arr, tabs):
        ct.min_codes[:] = tab.min_codes
        ct.max_codes[:] = tab.max_codes
        ct.vals_indices[:] = tab.vals_indices
        ct.vals[:] = tab.vals
        ct.num_codes = tab.num_codes
    return arr


def _dc_scan_geom(p0: ProgPlan, sc: ScanInfo):
    """(DC tables in table-index order, tid_of_slot, blocks an image has in
    the scan) for a DC scan.  The DC-first walk and K8 both index the
    tables in this order, not by table id."""
    order = []
    for td in sc.td:
        if (0, td) not in order:
            order.append((0, td))
    tid_of_comp = {c: order.index((0, sc.td[i])) for i, c in enumerate(sc.comps)}
    if len(sc.comps) > 1:
        tid_of_slot = [tid_of_comp[c] for c in sc.comps for _ in range(p0.hv[c][0] * p0.hv[c][1])]
        nblk = p0.mxx * p0.myy * len(tid_of_slot)
    else:
        tid_of_slot = [tid_of_comp[sc.comps[0]]]
        nblk = int(np.prod(valid_grid(p0, sc.comps[0])))
    return [sc.huffs[kk] for kk in order], tid_of_slot, nblk


class _ScanWalk:
    """One scan's host walk for every image: its static inputs and the
    arrays the walks fill (row b for image b)."""

    def __init__(self, p0: ProgPlan, index: int, B: int, streams):
        self.index, self.sc = index, p0.scans[index]
        sc, self.kind = self.sc, self.sc.kind
        c = sc.comps[0]
        if self.kind in ("dc_first", "dc_refine"):
            tabs, self.tid_of_slot, self.nblk = _dc_scan_geom(p0, sc)
        else:
            tabs, self.tid_of_slot = [sc.huffs[(1, sc.ta[0])]], [0]
            self.nblk = int(np.prod(valid_grid(p0, c)))
        self.tabs = tabs
        if self.kind == "dc_refine":
            self.rowlen = (self.nblk + 7) // 8
            return
        self.huff_c = _huff_c(tabs)
        self.tids = np.asarray(self.tid_of_slot, np.int32)
        self.flat, self.offs = stack_streams(streams)
        self.lens = [len(s) for s in streams]
        self.starts = np.zeros((B, self.nblk), np.int32)
        self.ends = np.zeros((B, self.nblk), np.int32)
        self.flags = np.zeros((B, self.nblk), np.uint8)

    def run(self, lib, b: int, masks: dict, eob_run: list) -> int:
        """Walk image b's scan -> the C return code (0 = OK)."""
        sc, ptr, n = self.sc, self.flat.ctypes.data + int(self.offs[b]), self.lens[b]
        endb = ctypes.c_int64(0)
        starts, ends, flags = self.starts[b], self.ends[b], self.flags[b]
        if self.kind == "dc_first":
            rc = lib.zpix_prog_dc_first_index(
                ptr, n, self.huff_c, self.tids.ctypes.data, len(self.tids), self.nblk,
                ends.ctypes.data, ctypes.byref(endb))
            starts[1:] = ends[:-1]
            return rc
        c = sc.comps[0]
        if c not in masks:  # zigzag nonzero flags of the component's valid blocks
            masks[c] = np.zeros((self.nblk, 64), np.uint8)
        if self.kind == "ac_first":
            return lib.zpix_prog_ac_first_index(
                ptr, n, self.huff_c, sc.ss, sc.se, self.nblk, starts.ctypes.data,
                ends.ctypes.data, flags.ctypes.data, masks[c].ctypes.data,
                ctypes.byref(endb))
        ero = ctypes.c_uint16(0)
        rc = lib.zpix_prog_refine_index(
            ptr, n, self.huff_c, masks[c].ctypes.data, self.nblk, sc.ss, sc.se, eob_run[0],
            starts.ctypes.data, flags.ctypes.data, ctypes.byref(ero), ctypes.byref(endb))
        eob_run[0] = ero.value
        ends[:-1] = starts[1:]
        ends[-1] = endb.value
        return rc

    def prep(self, plans) -> tuple:
        """-> (ScanPrep, the first image whose scan is too short for a DC
        refinement, or None)."""
        sc = self.sc
        if self.kind == "dc_refine":
            rows = np.zeros((len(plans), self.rowlen), np.uint8)
            short = None
            for b, pl in enumerate(plans):
                st = pl.scans[self.index].stream[: self.rowlen]
                rows[b, : len(st)] = st
                if len(st) < self.rowlen and short is None:
                    short = b
            return ScanPrep(kind=self.kind, comps=sc.comps, ss=sc.ss, se=sc.se, al=sc.al,
                            stream=rows), short
        base = (self.offs * 8).astype(np.int32)[:, None]
        tables = (_entropy.pack_tables(self.tabs, self.tid_of_slot, [])
                  if self.kind == "dc_first" else _entropy.pack_tables(self.tabs, [], [0]))
        return ScanPrep(
            kind=self.kind, comps=sc.comps, ss=sc.ss, se=sc.se, al=sc.al, stream=self.flat,
            starts=(self.starts + base).reshape(-1), ends=(self.ends + base).reshape(-1),
            flags=None if self.kind == "dc_first" else self.flags.astype(np.int32).reshape(-1),
            tables=tables), None


def prep_hostindex(plans, pool: ThreadPoolExecutor | None = None) -> ProgPrep:
    """The host half for a checked batch: every scan's index walk for every
    image (one image a task on ``pool``, its scans in script order), then
    the scans' device inputs.  An index walk that refuses a stream, or an
    AC scan over more than one component, ends the script there: the
    scans before it are kept, ``okh`` is False and ``failure`` says why."""
    p0, B = plans[0], len(plans)
    failure = None
    walks = []
    for si, sc in enumerate(p0.scans):
        if sc.kind in ("ac_first", "ac_refine") and len(sc.comps) != 1:
            failure = f"scan {si} ({sc.kind}) covers {len(sc.comps)} components"
            break
        streams = None if sc.kind == "dc_refine" else [pl.scans[si].stream for pl in plans]
        walks.append(_ScanWalk(p0, si, B, streams))
    lib = _host.lib()

    def walk_image(b):
        masks, eob_run = {}, [0]
        for w in walks:
            if w.kind != "dc_refine":
                rc = w.run(lib, b, masks, eob_run)
                if rc:
                    return w.index, rc
        return None

    results = list(pool.map(walk_image, range(B)) if pool else map(walk_image, range(B)))
    failed = [(r[0], b, r[1]) for b, r in enumerate(results) if r]
    if failed:
        si, b, rc = min(failed)
        failure = (f"scan {si} ({p0.scans[si].kind}): the index walk refused image {b} "
                   f"({_host.error_name(rc)})")
        walks = [w for w in walks if w.index < si]
    scans = []
    for w in walks:
        sp, short = w.prep(plans)
        if short is not None and failure is None:
            failure = f"scan {w.index} (dc_refine): image {short}'s scan is too short"
        scans.append(sp)
    quants = np.stack([np.stack([pl.quants[c] for pl in plans])
                       for c in range(p0.ncomp)]).astype(np.int32)
    return ProgPrep(width=p0.width, height=p0.height, hv=p0.hv, mxx=p0.mxx, myy=p0.myy,
                    ratio=p0.ratio, quants=quants, scans=scans, okh=failure is None,
                    failure=failure)


# ------------------------------------------------------------- assembly

SCAN_KERNELS = {"dc_first": _prog.dc_first, "ac_first": _prog.ac_first,
                "ac_refine": _prog.ac_refine, "dc_refine": _prog.dc_refine}


def new_store(prep: ProgPrep, device) -> tuple:
    """A zeroed int32 coefficient store, one allocation -> (per component
    its grid [B, bv, bh, 64], ok int32 [1] holding the host's part)."""
    B = prep.batch
    sizes = [B * prep.myy * v * prep.mxx * h * 64 for h, v in prep.hv]
    store = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    grids = [g.view(B, prep.myy * v, prep.mxx * h, 64)
             for g, (h, v) in zip(torch.split(store, sizes), prep.hv)]
    return grids, torch.full((1,), int(prep.okh), dtype=torch.int32, device=device)


def apply_scan(fn, sc: ScanPrep, t: dict, grids, prep: ProgPrep, ok) -> None:
    """Scan ``sc`` (its device arrays ``t``) into the store through ``fn``:
    the kernel wrapper of its kind (``SCAN_KERNELS``) or its plain
    version, which takes the same arguments."""
    c0 = sc.comps[0]
    kw = dict(valid=valid_grid(prep, c0), al=sc.al)
    if sc.kind == "dc_first":
        fn(t["stream"], t["starts"], t["ends"], t["tables"], ok, [grids[c] for c in sc.comps],
           hv=[prep.hv[c] for c in sc.comps], **kw)
    elif sc.kind == "dc_refine":
        fn(t["stream"], [grids[c] for c in sc.comps], hv=[prep.hv[c] for c in sc.comps], **kw)
    else:
        fn(t["stream"], t["starts"], t["ends"], t["flags"], t["tables"], ok, grids[c0],
           ss=sc.ss, se=sc.se, **kw)


class OnchipProgressiveDecoder:
    """Progressive JPEG batches on the GPU (host-index mode): bytes ->
    (pixels [B, H, W, 3] u8, or [B, H, W] for gray; ok 0-dim bool) on the
    decoder's device, with no host sync.

    ``prep`` is the host half, ``upload`` the one pinned copy, ``run`` the
    device half; ``decode`` runs all three.  One thread pool for the index
    walks lives until ``close``.  ``ok`` False means the batch belongs to
    a host decoder.
    """

    def __init__(self, *, device=None, n_threads: int | None = None):
        self.device = resolve_device(device)
        self.n_threads = n_threads or os.cpu_count() or 2
        self._pool = ThreadPoolExecutor(self.n_threads)
        self._upload = PinnedUpload(self.device)

    def prep(self, datas: list[bytes]) -> ProgPrep:
        if not datas:
            raise ValueError("jpeg: empty batch")
        return self.prep_plans([parse_progressive(d) for d in datas])

    def prep_plans(self, plans) -> ProgPrep:
        """``prep`` from streams already parsed by ``parse_progressive``
        (the router parses a bucket once to split it by ``script_key``)."""
        check_batch(plans)
        return prep_hostindex(plans, self._pool)

    def upload(self, prep: ProgPrep):
        """-> (per scan {array name: device tensor}, quants int32 [ncomp, B,
        64]), in one copy."""
        parts = [a for sc in prep.scans for a in sc.arrays()] + [prep.quants]
        flat = iter(self._upload(parts))
        scans = [{n: next(flat) for n in ScanPrep.ARRAYS if getattr(sc, n) is not None}
                 for sc in prep.scans]
        return scans, next(flat)

    def decode_coefficients(self, prep: ProgPrep, bufs=None):
        """A zeroed int32 store, then every scan in script order -> (per
        component its grid [B, bv, bh, 64] natural order, ok int32 [1])."""
        scans, quants = self.upload(prep) if bufs is None else bufs
        grids, ok = new_store(prep, quants.device)
        for sc, t in zip(prep.scans, scans):
            apply_scan(SCAN_KERNELS[sc.kind], sc, t, grids, prep, ok)
        return grids, ok

    def run(self, prep: ProgPrep, bufs=None):
        """The device half: every scan into the store, then K6."""
        bufs = self.upload(prep) if bufs is None else bufs
        grids, ok = self.decode_coefficients(prep, bufs)
        pixels = decode_batch_planes(grids, list(bufs[1]), color="gray" if prep.ncomp == 1
                                     else "ycbcr", height=prep.height, width=prep.width,
                                     ratio=prep.ratio)
        return pixels, ok[0] != 0

    def decode(self, datas: list[bytes]):
        return self.run(self.prep(datas))

    def decode_verified(self, datas: list[bytes]) -> np.ndarray:
        """Host numpy output [B, H, W, 3] (gray [B, H, W]) with a
        whole-batch host fallback on ``ok`` False: every image then goes
        through the port's host decoder and ``color.ycbcr_to_rgb8``."""
        out, ok = self.decode(datas)
        if bool(ok):
            return out.cpu().numpy()
        outs = []
        for d in datas:
            img = _host_decoder.decode(d)
            if img.__class__.__name__ == "GrayImage":
                outs.append(img.pix)
            else:
                cb, cr = img.upsampled_cbcr()
                r, g, b = ycbcr_to_rgb8(img.y, cb, cr)
                outs.append(np.stack([r, g, b], axis=-1))
        return np.stack(outs)

    def close(self) -> None:
        """Shut the index walks' thread pool down."""
        self._pool.shutdown()
