"""Progressive JPEG on the GPU: SOF2 batches end to end.

The PyTorch/CUDA counterpart of zpix_tpu/parallel/progressive_onchip.py's
``OnchipProgressiveDecoder``, in its two modes.

Host-index mode (``impl="hostindex"``, the default):

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

Speculative mode (``impl="spec"``, and ``decode()`` in host-index mode
wherever an index walk refuses a stream, as zpix_tpu's ``_decode_chunk``
does, :2161-2175): the card finds the symbols of the first scans itself
(``decode_spec``, :2175-2296):

* DC first: K20; AC first over one component: K21 (ops/prog_spec.py),
  one call for every such scan of the prefix; DC refinement: K11 on the
  same raw bit rows.
* AC refinement: K10 on the host walk's offsets.  At the first
  refinement one fetch of the store's nonzero flags (packed 8 a byte on
  the card) seeds the walks' masks, and every later refinement scan is
  walked at once (they depend only on the masks) and uploaded in one copy.
* An AC-first scan over several components, an AC-first scan after a
  refinement, or a refinement whose walk refuses a stream ends the card's
  prefix.  The rest is the host tail: the store is fetched, each image's
  remaining scans are decoded by ``_TailScanDecoder`` (the port's host
  decoder seeded with the store, a thread an image), and each image's
  differences go back into the store through one K22 launch.  ``n_host_tail_scans``
  counts the scans it decoded.
* K6 turns the store into pixels.

Output: (pixels u8 [B, H, W, 3], or [B, H, W] for gray; ok 0-dim bool),
both on the decoder's device.  A batch shares geometry, scan script and
Huffman tables (quant tables are per image).  ``prep``, ``upload`` and
``run`` are the host-index mode's halves: where a walk refuses a stream,
``prep`` records it (``ProgPrep.failure``, ``refused``) and ``run``
returns ``ok`` False.

Not ported, by decision: zpix_tpu's unroll, window and compile knobs
(``k1``, ``k2``, ``W``, ``max_batch`` and ``ZPIX_PROG_IMPL``), which change
no output; the constructor's ``impl`` decides the mode.  The benchmark
``salt`` was a TPU mechanic.
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
from ..ops import prog_spec as _spec
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
    ``ok``; ``failure`` names the scan and the image that cleared it;
    ``refused`` says an index walk refused a stream or an AC scan covers
    several components (``decode`` then takes the spec path)."""

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
    refused: bool = False

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

    refused = failure is not None
    results = list(pool.map(walk_image, range(B)) if pool else map(walk_image, range(B)))
    failed = [(r[0], b, r[1]) for b, r in enumerate(results) if r]
    refused |= bool(failed)
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
                    failure=failure, refused=refused)


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


# ------------------------------------------------------------ speculative mode


def spec_prefix(p0: ProgPlan) -> int:
    """Scans the card can decode in spec mode before any walk runs: up to an
    AC-first scan over several components or after a refinement, or a
    refinement over several components (progressive_onchip.py:2192-2200)."""
    refined = False
    for si, sc in enumerate(p0.scans):
        if sc.kind == "ac_first" and (len(sc.comps) != 1 or refined):
            return si
        if sc.kind == "ac_refine":
            if len(sc.comps) != 1:
                return si
            refined = True
    return len(p0.scans)


def spec_first_inputs(p0: ProgPlan, plans, si: int, chunk_bytes: int) -> tuple:
    """A DC-first or AC-first scan's spec inputs -> ([stream, starts, ends,
    tables] numpy, chunks an image)."""
    sc = p0.scans[si]
    flat, starts, ends, n_chunks = _spec.stack_spec([pl.scans[si].stream for pl in plans],
                                                    chunk_bytes)
    if sc.kind == "dc_first":
        tabs, tid_of_slot, _ = _dc_scan_geom(p0, sc)
        tables = _entropy.pack_tables(tabs, tid_of_slot, [])
    else:
        tables = _entropy.pack_tables([sc.huffs[(1, sc.ta[0])]], [], [0])
    return [flat, starts, ends, tables], n_chunks


def pack_flags(grids):
    """The store's nonzero flags in zigzag order, 8 a byte MSB first
    (numpy.unpackbits' order), one row a component -> a flat u8 tensor on
    the store's device."""
    dev = grids[0].device
    unzig = torch.as_tensor(UNZIG, dtype=torch.int64, device=dev)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=dev)
    return torch.cat([(g.index_select(3, unzig) != 0).view(-1, 8).to(torch.uint8).mul_(weights)
                      .sum(1, dtype=torch.uint8) for g in grids])


def seed_masks(flags: np.ndarray, prep: ProgPrep) -> list:
    """Unpacked store flags (``pack_flags``) -> per image {component: its
    valid blocks' zigzag nonzero flags, u8 [nvalid, 64]}
    (progressive_onchip.py:1852-1860)."""
    B, out, off = prep.batch, [{} for _ in range(prep.batch)], 0
    bits = np.unpackbits(flags)
    for c, (h, v) in enumerate(prep.hv):
        bv, bh = prep.myy * v, prep.mxx * h
        n = B * bv * bh * 64
        grid = bits[off : off + n].reshape(B, bv, bh, 64)
        off += n
        nvy, nvx = valid_grid(prep, c)
        for b in range(B):
            out[b][c] = np.ascontiguousarray(grid[b, :nvy, :nvx]).reshape(-1, 64)
    return out


class _TailScanDecoder:
    """The port's host decoder that skips the first ``skip`` scans' entropy
    data (they ran on the card) and decodes the rest, seeded with the
    fetched store (progressive_onchip.py:1107-1162)."""

    def __init__(self, data: bytes, skip: int, seed):
        outer = self

        class _D(_host_decoder.Decoder):
            def __init__(self):
                super().__init__(data)
                self.collect_only = True
                self._scan_no = 0

            def process_sos(self, n: int) -> None:
                if self._scan_no < skip:
                    self._scan_no += 1
                    # the SOS header, then the entropy bytes up to the next
                    # real marker (stuffed FF00 and RSTs are entropy data)
                    self.read_full(n)
                    d, p = self.data, self.pos
                    while p < len(d) - 1 and not (d[p] == 0xFF and d[p + 1] not in (0x00, 0xFF)
                                                  and not 0xD0 <= d[p + 1] <= 0xD7):
                        p += 1
                    self.pos = p
                    return
                if self._scan_no == skip and seed is not None:
                    h0, v0 = self.component[0].h, self.component[0].v
                    if not self.img_allocated:
                        self._make_img((self.width + 8 * h0 - 1) // (8 * h0),
                                       (self.height + 8 * v0 - 1) // (8 * v0))
                    for c, arr in enumerate(seed):
                        if arr is not None:
                            self._ensure_coeff(c)
                            self.coeff[c][...] = arr
                    outer.seeded = True
                self._scan_no += 1
                super().process_sos(n)

        self.dec = _D()
        self.seeded = False

    def run(self):
        self.dec.decode_inner(False)
        return self.dec


def tail_deltas(grids, datas, skip: int, pool) -> list:
    """The host tail: the store fetched, each image's scans from ``skip`` on
    decoded on the host seeded with it, a thread an image -> per component
    (indices, values) int32 [B, k] of each image's changed coefficients
    (padding: index 0, value 0)."""
    seeds = [g.cpu().numpy() for g in grids]
    B = len(datas)

    def one(b):
        return _TailScanDecoder(datas[b], skip, [s[b] for s in seeds]).run()

    decs = list(pool.map(one, range(B)))
    out = []
    for c, seed in enumerate(seeds):
        parts = []
        for b, dec in enumerate(decs):
            diff = dec.coeff[c].astype(np.int64).reshape(-1) - seed[b].astype(np.int64).reshape(-1)
            nz = np.flatnonzero(diff)
            parts.append((nz, diff[nz]))
        k = max(1, max(len(nz) for nz, _ in parts))
        idx = np.zeros((B, k), np.int32)
        val = np.zeros((B, k), np.int32)
        for b, (nz, d) in enumerate(parts):
            idx[b, : len(nz)] = nz
            val[b, : len(nz)] = d.astype(np.int32)  # int32, wrapping
        out.append((idx, val))
    return out


class OnchipProgressiveDecoder:
    """Progressive JPEG batches on the GPU: bytes -> (pixels [B, H, W, 3]
    u8, or [B, H, W] for gray; ok 0-dim bool) on the decoder's device.

    ``impl``: "hostindex" (the default; ``prep`` the host half, ``upload``
    the one pinned copy, ``run`` the device half, with no host sync) or
    "spec" (``decode_spec``).  ``decode`` runs the three halves, or the spec
    path in spec mode or where a walk refuses a stream.  ``chunk_bytes``:
    the spec path's chunk (K20, K21).  ``n_host_tail_scans``: the scans the
    last ``decode`` left to the host tail.  One thread pool for the index
    walks and the tail lives until ``close``.  ``ok`` False means the batch
    belongs to a host decoder.
    """

    def __init__(self, *, device=None, n_threads: int | None = None, impl: str = "hostindex",
                 chunk_bytes: int = 64):
        if impl not in ("hostindex", "spec"):
            raise ValueError(f"jpeg: unknown progressive impl {impl!r}")
        if chunk_bytes < 1:
            raise ValueError("jpeg: chunk_bytes must be at least 1")
        self.impl = impl
        self.chunk_bytes = chunk_bytes
        self.device = resolve_device(device)
        self.n_threads = n_threads or os.cpu_count() or 2
        self._pool = ThreadPoolExecutor(self.n_threads)
        self._upload = PinnedUpload(self.device)
        self.n_host_tail_scans = 0
        # the last spec decode: each spec scan's count (int32 [B] by scan
        # index: on the card K20's and K21's misses, in plain PyTorch their
        # rounds), the flag fetch's bytes, the card's prefix
        self.spec_stats: dict = {}

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
        if not datas:
            raise ValueError("jpeg: empty batch")
        plans = [parse_progressive(d) for d in datas]
        check_batch(plans)
        if self.impl == "hostindex":
            prep = prep_hostindex(plans, self._pool)
            if not prep.refused:
                self.n_host_tail_scans = 0
                return self.run(prep)
        return self.decode_spec(plans, datas)

    def decode_spec(self, plans, datas: list[bytes]):
        """The spec path on a checked batch (module docstring): the card's
        prefix of scans in script order, then the host tail, then K6."""
        p0, B = plans[0], len(plans)
        n_pre = spec_prefix(p0)
        quants = np.stack([np.stack([pl.quants[c] for pl in plans])
                           for c in range(p0.ncomp)]).astype(np.int32)
        firsts, rows, okh = {}, {}, True
        for si in range(n_pre):
            kind = p0.scans[si].kind
            if kind in ("dc_first", "ac_first"):
                firsts[si] = spec_first_inputs(p0, plans, si, self.chunk_bytes)
            elif kind == "dc_refine":
                sp, short = _ScanWalk(p0, si, B, None).prep(plans)
                rows[si] = sp
                okh &= short is None
        prep = ProgPrep(width=p0.width, height=p0.height, hv=p0.hv, mxx=p0.mxx, myy=p0.myy,
                        ratio=p0.ratio, quants=quants, scans=[], okh=okh)
        arrays = [a for si in sorted(firsts) for a in firsts[si][0]]
        arrays += [rows[si].stream for si in sorted(rows)] + [quants]
        flat = iter(self._upload(arrays))
        dev_first = {si: [next(flat) for _ in range(4)] for si in sorted(firsts)}
        dev_rows = {si: next(flat) for si in sorted(rows)}
        dev_quants = next(flat)
        grids, ok = new_store(prep, dev_quants.device)
        self.spec_stats = stats = {"rounds": {}, "flag_fetch_bytes": 0}
        refs, n_prefix = None, n_pre
        # every AC-first scan of the prefix, in one K21 call where the first
        # comes: they precede every AC refinement (spec_prefix) and write
        # disjoint bands, never coefficient 0, so they commute with one
        # another and with the DC scans
        ac_firsts = [si for si in range(n_pre) if p0.scans[si].kind == "ac_first"]
        for si in range(n_pre):
            sc = p0.scans[si]
            if sc.kind == "ac_refine":
                if refs is None:
                    refs = self._spec_refinements(plans, si, grids, prep, stats)
                if si not in refs:
                    n_prefix = si
                    break
                apply_scan(_prog.ac_refine, refs[si][0], refs[si][1], grids, prep, ok)
            elif sc.kind == "dc_refine":
                apply_scan(_prog.dc_refine, rows[si], {"stream": dev_rows[si]}, grids, prep, ok)
            elif sc.kind == "dc_first":
                stats["rounds"][si] = _spec.dc_first_spec(
                    *dev_first[si], ok, [grids[c] for c in sc.comps],
                    hv=[p0.hv[c] for c in sc.comps], valid=valid_grid(prep, sc.comps[0]),
                    al=sc.al, chunk_bytes=self.chunk_bytes, n_chunks=firsts[si][1])
            elif si == ac_firsts[0]:
                group = [p0.scans[sj] for sj in ac_firsts]
                misses = _spec.ac_first_spec_group(
                    [_spec.AcScan(*dev_first[sj], grids[g.comps[0]],
                                  valid_grid(prep, g.comps[0]), g.ss, g.se, g.al, firsts[sj][1])
                     for sj, g in zip(ac_firsts, group)], ok, chunk_bytes=self.chunk_bytes)
                stats["rounds"].update(zip(ac_firsts, misses))
        self.n_host_tail_scans = len(p0.scans) - n_prefix
        stats["prefix"] = n_prefix
        if n_prefix < len(p0.scans):
            deltas = tail_deltas(grids, datas, n_prefix, self._pool)
            parts = iter(self._upload([a for pair in deltas for a in pair]))
            _spec.delta_add_segments([(g.view(B, -1), next(parts), next(parts)) for g in grids])
        pixels = decode_batch_planes(grids, list(dev_quants), color="gray" if p0.ncomp == 1
                                     else "ycbcr", height=p0.height, width=p0.width,
                                     ratio=p0.ratio)
        return pixels, ok[0] != 0

    def _spec_refinements(self, plans, si: int, grids, prep: ProgPrep, stats: dict) -> dict:
        """At the first AC refinement: one fetch of the store's nonzero
        flags seeds each image's masks, then every refinement scan from
        ``si`` up to the next AC-first scan is walked (one image a task,
        EOB runs from 0) and uploaded in one copy -> {scan: (ScanPrep, its
        device arrays)} for the scans before the first one a walk refused
        (progressive_onchip.py:2201-2248)."""
        p0, B = plans[0], len(plans)
        flags = pack_flags(grids).cpu().numpy()
        stats["flag_fetch_bytes"] = int(flags.nbytes)
        masks = seed_masks(flags, prep)
        walks = []
        for sj in range(si, len(p0.scans)):
            kind = p0.scans[sj].kind
            if kind == "ac_first" or (kind == "ac_refine" and len(p0.scans[sj].comps) != 1):
                break
            if kind == "ac_refine":
                walks.append(_ScanWalk(p0, sj, B, [pl.scans[sj].stream for pl in plans]))
        lib = _host.lib()

        def walk_image(b):
            eob_run = [0]
            for w in walks:
                if w.run(lib, b, masks[b], eob_run):
                    return w.index
            return len(p0.scans)

        stop = min(self._pool.map(walk_image, range(B)))
        preps = [w.prep(plans)[0] for w in walks if w.index < stop]
        flat = iter(self._upload([a for sp in preps for a in sp.arrays()]))
        out = {}
        for w, sp in zip(walks, preps):
            out[w.index] = (sp, {n: next(flat) for n in ScanPrep.ARRAYS
                                 if getattr(sp, n) is not None})
        return out

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
