"""Baseline-JPEG decode on the GPU: restart-segment lanes, end to end.

The PyTorch/CUDA counterpart of zpix_tpu/parallel/device_entropy.py's
restart-marker path (``DeviceJpegDecoder``).  Restart markers reset the
DC predictors and byte-align the stream (T.81 F.1.2.3), so every restart
segment of every image is an independent lane.  The host walks markers
and removes FF00 stuffing (numpy only); the device then runs four
hand-written kernels:

1. index pass (K1, ops/entropy.py): one thread per restart segment
   finds every 8x8 block's end bit;
2. value pass (K2): one thread per block decodes its DC diff and AC
   coefficients into a natural-order row, and checks that it ends where
   K1 said;
3. DC restore (K3): a prefix sum of DC diffs per component and segment;
4. back-end (K4, ops/backend.py): dequant, Wang IDCT, level shift,
   chroma replication and YCbCr->RGB straight into the output tensor.

Restart-free streams take ``HostIndexJpegDecoder``: the port's copy of
the host C++ index scan (csrc/host/entropy.cpp, a thread per image)
finds every block's end bit in place of K1, then K2, K3 (one chain per
image and component) and K4 run as above.

With ``mesh`` (parallel/mesh.py) both decoders shard the lanes, as
zpix_tpu's mesh upload does: each batch position gets the whole stream and
an equal run of lanes, and runs the kernels on its own device.

Everything is exact integer math: the output matches the JAX package
and the host decoder bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import ctypes
import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..codecs.jpeg.tables import UNZIG, HuffTable
from ..errors import FormatError, UnsupportedError
from ..ops import backend as _backend
from ..ops import entropy as _entropy
from ..utils import metrics, span, stage

_RATIOS = {0x11: "444", 0x12: "440", 0x21: "422",
           0x22: "420", 0x41: "411", 0x42: "410"}


@dataclass
class ScanPlan:
    """Host-side prep of a same-geometry baseline JPEG batch."""

    width: int
    height: int
    ncomp: int
    hv: tuple  # ((h,v), ...) per component
    ratio: str
    mxx: int
    myy: int
    bpm: int  # blocks per MCU
    comp_of_slot: tuple  # slot index -> component
    n_mcu: int  # MCUs per image
    seg_mcus: int  # restart interval (MCUs per segment)
    n_segs: int  # segments per image
    quants: list  # [ncomp] np.int32[64] natural order
    tid_dc: tuple  # component -> decode-table index for DC
    tid_ac: tuple
    stream: np.ndarray  # uint8, destuffed segments back to back (+pad)
    seg_bit_pos: np.ndarray  # int64 [B*n_segs] absolute bit offsets
    seg_n_mcu: np.ndarray  # int32 [B*n_segs] MCUs in each segment
    batch: int
    tables: np.ndarray  # int32 [entropy.TAB_WORDS]: Huffman tables + slot map
    color: str = "ycbcr"  # gray | ycbcr | rgb | ycck | cmyk
    ends: np.ndarray | None = None  # int32 [B, nblk]: the host index scan's block ends


def _parse_headers(data: bytes):
    """Minimal marker walk: SOI..SOS for one baseline JPEG.

    Mirrors the reference's marker loop (decoder.zig:220-373) for the
    subset a baseline scan needs; anything else -> UnsupportedError.
    """
    if data[:2] != b"\xff\xd8":
        raise FormatError("jpeg: missing SOI")
    pos = 2
    quants = [None] * 4
    huffs = {}  # (tc, th) -> HuffTable
    sof = None
    dri = 0
    jfif = False
    adobe_transform = None
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1  # liberal skip (decoder.zig:248-264)
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
        seg_len = (data[pos] << 8) | data[pos + 1]
        body = data[pos + 2 : pos + seg_len]
        if marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedError("jpeg: only baseline/extended-sequential DCT")
        if marker == 0xC0 or marker == 0xC1:  # baseline / extended sequential
            prec, h, w, nc = body[0], (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            if prec != 8:
                raise UnsupportedError("jpeg: only 8-bit precision")
            comps = []
            for i in range(nc):
                cid, hvb, tq = body[6 + 3 * i], body[7 + 3 * i], body[8 + 3 * i]
                comps.append((cid, hvb >> 4, hvb & 15, tq))
            if nc == 1:
                # grayscale ignores declared sampling factors
                # (decoder.zig:546-561 normalizes (h,v) to (1,1))
                cid, _, _, tq = comps[0]
                comps = [(cid, 1, 1, tq)]
            sof = (w, h, nc, tuple(comps))
        elif marker == 0xC2:
            raise UnsupportedError("jpeg: progressive not supported on-device")
        elif marker == 0xC4:  # DHT
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1 : o + 17])
                total = sum(counts)
                vals = bytes(body[o + 17 : o + 17 + total])
                t = HuffTable()
                t.build(counts, vals)
                huffs[(tc, th)] = t
                o += 17 + total
        elif marker == 0xDB:  # DQT
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                if pq == 0:
                    q = np.array(list(body[o + 1 : o + 65]), np.int32)
                    o += 65
                else:
                    raw = body[o + 1 : o + 129]
                    q = np.array(
                        [(raw[2 * i] << 8) | raw[2 * i + 1] for i in range(64)], np.int32
                    )
                    o += 129
                nat = np.zeros(64, np.int32)
                nat[UNZIG] = q  # store natural-order (decoder.zig:1564-1567)
                quants[tq] = nat
        elif marker == 0xDD:
            dri = (body[0] << 8) | body[1]
        elif marker == 0xE0:  # APP0 (JFIF)
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:  # APP14 (Adobe transform byte)
            if body[:6] == b"Adobe\x00" and len(body) >= 12:
                adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            ns = body[0]
            sel = []
            for i in range(ns):
                cs, tt = body[1 + 2 * i], body[2 + 2 * i]
                sel.append((cs, tt >> 4, tt & 15))
            scan_start = pos + seg_len
            if sof is None:
                raise FormatError("jpeg: SOS before SOF")
            w, h, nc, comps = sof
            if nc not in (1, 3, 4):
                raise UnsupportedError(
                    "jpeg: device decode covers 1/3/4-component frames"
                )
            # Color-space classification (decoder.zig:699-709, :795-809):
            # RGB = Adobe transform 0 or R/G/B component ids (non-JFIF);
            # 4-comp = YCCK (Adobe transform != 0) or raw CMYK (== 0);
            # no Adobe marker on 4-comp is the reference's error case.
            ids = tuple(c[0] for c in comps)
            is_rgb = (not jfif) and (
                adobe_transform == 0
                or (adobe_transform is None and ids == (0x52, 0x47, 0x42))
            )
            if nc == 1:
                color = "gray"
            elif nc == 3:
                color = "rgb" if is_rgb else "ycbcr"
            elif adobe_transform is None:
                raise UnsupportedError(
                    "jpeg: unknown color model: 4-component color model"
                )
            else:
                color = "cmyk" if adobe_transform == 0 else "ycck"
            if nc == 3:
                (h0, v0), (h1, v1), (h2, v2) = ((c[1], c[2]) for c in comps)
                if (h1, v1) != (h2, v2) or min(h1, v1) < 1:
                    raise UnsupportedError(
                        "jpeg: chroma planes must share sampling factors"
                    )
                if h0 % h1 or v0 % v1 or ((h0 // h1) << 4 | (v0 // v1)) not in _RATIOS:
                    raise UnsupportedError(
                        f"jpeg: unsupported sampling {h0}{v0}:{h1}{v1}:{h2}{v2}"
                    )
            if nc == 4:
                hvs = tuple((c[1], c[2]) for c in comps)
                if hvs not in (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2))):
                    # the reference's 4-component matrix, decoder.zig:595-611
                    raise UnsupportedError(
                        "jpeg: unsupported 4-component sampling"
                    )
            return sof, quants, huffs, dri, tuple(sel), scan_start, color
        pos += seg_len
    raise FormatError("jpeg: no SOS")


def _destuff(data: bytes, scan_start: int):
    """Scan body -> (destuffed bytes, segment start offsets in destuffed space).

    FF00 de-stuffing per decoder.zig:712-749; RST markers delimit segments
    (byte-aligned restarts, decoder.zig:1432-1452).
    """
    d = np.frombuffer(data, np.uint8)[scan_start:]
    ff = np.flatnonzero(d[:-1] == 0xFF)
    nxt = d[ff + 1]
    stuffed = ff[nxt == 0x00]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    eoi = ff[nxt == 0xD9]
    end = int(eoi[0]) if len(eoi) else len(d)
    stuffed = stuffed[stuffed < end]
    rst = rst[rst < end]
    other = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD9))]
    if len(other) and int(other[0]) < end:
        # includes FF FF, which the reference rejects as MissingFF00
        raise UnsupportedError("jpeg: unexpected marker inside scan data")
    # bytes to drop: each stuffed 00, and both bytes of each RST
    drop = np.concatenate([stuffed + 1, rst, rst + 1])
    drop.sort()
    keep = np.ones(end, bool)
    keep[drop[drop < end]] = False
    out = d[:end][keep]
    # segment starts (in destuffed coords): 0 and after each RST pair
    starts = np.concatenate([[0], rst + 2])
    dropped_before = np.searchsorted(drop, starts)
    return out, (starts - dropped_before).astype(np.int64)


def plan_from_arrays(*, stream, seg_bit_pos, seg_n_mcu, quants, hv, bpm,
                     seg_mcus, n_segs, mxx, myy, width, height, color,
                     huffs, sel) -> ScanPlan:
    """Build a plan from plain ints and numpy arrays.

    huffs: {(class, id): (counts[16], vals)}; sel: per component
    (dc table id, ac table id).  prep_batch ends here, and a test can
    feed the arrays of any other prep (the JAX package's included)
    through the port's device stages.
    """
    hv = tuple((int(h), int(v)) for h, v in hv)
    ncomp = len(hv)
    comp_of_slot = tuple(c for c in range(ncomp) for _ in range(hv[c][0] * hv[c][1]))
    if len(comp_of_slot) != bpm:
        raise ValueError("jpeg: bpm does not match the sampling factors")
    seg_n_mcu = np.asarray(seg_n_mcu, np.int32)
    if len(seg_n_mcu) % n_segs:
        raise ValueError("jpeg: lane count is not a multiple of n_segs")
    stream = np.asarray(stream, np.uint8)
    seg_bit_pos = np.asarray(seg_bit_pos, np.int64)
    if stream.shape[0] >= 1 << 28:
        raise UnsupportedError("jpeg: stream buffer over 256 MiB")
    ratio = "gray"
    if ncomp >= 3:
        hr, vr = hv[0][0] // hv[1][0], hv[0][1] // hv[1][1]
        ratio = _RATIOS[(hr << 4) | vr]
    # One decode-table slot per distinct (class, id), AC tables first
    # (the JAX package's order, so the table indices compare equal).
    order = []
    for want_cls in (1, 0):
        for td, ta in sel:
            kk = (want_cls, ta if want_cls else td)
            if kk not in order:
                order.append(kk)
    tid_of = {kk: i for i, kk in enumerate(order)}
    tabs = []
    for kk in order:
        t = HuffTable()
        t.build(*huffs[kk])
        tabs.append(t)
    tid_dc = tuple(tid_of[(0, sel[c][0])] for c in range(ncomp))
    tid_ac = tuple(tid_of[(1, sel[c][1])] for c in range(ncomp))
    tables = _entropy.pack_tables(
        tabs, [tid_dc[c] for c in comp_of_slot], [tid_ac[c] for c in comp_of_slot],
        quants,
    )
    return ScanPlan(
        width=int(width), height=int(height), ncomp=ncomp, hv=hv, ratio=ratio,
        mxx=int(mxx), myy=int(myy), bpm=int(bpm), comp_of_slot=comp_of_slot,
        n_mcu=int(mxx) * int(myy), seg_mcus=int(seg_mcus), n_segs=int(n_segs),
        quants=[np.asarray(q, np.int32) for q in quants],
        tid_dc=tid_dc, tid_ac=tid_ac, stream=stream, seg_bit_pos=seg_bit_pos,
        seg_n_mcu=seg_n_mcu, batch=len(seg_n_mcu) // int(n_segs), tables=tables, color=color,
    )


def _batch_streams(datas: list[bytes], *, restarts: bool, route: str):
    """Headers and destuffed scans of a batch that shares geometry AND
    tables -> (the first image's header fields, streams, segment starts).
    ``restarts`` asks for restart markers (DRI > 0); without, each stream
    must be one segment (the host-index route).  Each image's header walk
    and destuffing are the spans ``<route>.prep.headers`` and
    ``<route>.prep.destuff``."""
    if not datas:
        raise ValueError("jpeg: empty batch")
    first = None
    streams, seg_pos_all = [], []
    headers, destuff = f"{route}.prep.headers", f"{route}.prep.destuff"
    for data in datas:
        with span(headers):
            sof, quants, huffs, dri, sel, scan_start, color = _parse_headers(data)
        if restarts and dri <= 0:
            raise UnsupportedError(
                "jpeg: device entropy decode needs restart markers (DRI)"
            )
        key = (sof, tuple(q.tobytes() if q is not None else None for q in quants),
               tuple(sorted((k, t.num_codes, tuple(t.vals), tuple(t.min_codes),
                             tuple(t.max_codes), tuple(t.vals_indices))
                            for k, t in huffs.items())), dri, tuple(sel), color)
        if first is None:
            first = (key, sof, quants, huffs, dri, sel, color)
        elif key != first[0]:
            raise UnsupportedError("jpeg: batch must share geometry and tables")
        with span(destuff):
            stream, seg_starts = _destuff(data, scan_start)
        if not restarts and (len(seg_starts) != 1 or int(seg_starts[0]) != 0):
            raise UnsupportedError(
                "jpeg: the restart-free paths cover streams without restart "
                "markers (use prep_batch/DeviceJpegDecoder for DRI > 0)"
            )
        streams.append(stream)
        seg_pos_all.append(seg_starts)
    return first[1:], streams, seg_pos_all


def _flat_stream(streams):
    """Streams back to back (8-byte aligned per image) in a power-of-two
    buffer with >= 16 pad bytes, so the kernels' 8-byte reads past a
    lane's last bit stay inside it (and it matches the JAX package's
    buffer byte for byte) -> (buffer, byte offset of each stream)."""
    offs, total = [], 0
    for s in streams:
        offs.append(total)
        total += (len(s) + 7) // 8 * 8
    flat = np.zeros(1 << max(12, (total + 15).bit_length()), np.uint8)
    for s, o in zip(streams, offs):
        flat[o : o + len(s)] = s
    return flat, offs


def _mcu_grid(sof):
    w, h, _, comps = sof
    h0, v0 = comps[0][1], comps[0][2]
    return (w + 8 * h0 - 1) // (8 * h0), (h + 8 * v0 - 1) // (8 * v0)


def _plan(header, **arrays) -> ScanPlan:
    """plan_from_arrays with the header fields of ``_batch_streams``."""
    sof, quants, huffs, _, sel, color = header
    w, h, nc, comps = sof
    mxx, myy = _mcu_grid(sof)
    by_comp = {i: (td, ta) for i, (_, td, ta) in enumerate(sel)}
    return plan_from_arrays(
        quants=[quants[c[3]] for c in comps], hv=[(c[1], c[2]) for c in comps],
        bpm=sum(c[1] * c[2] for c in comps), mxx=mxx, myy=myy, width=w, height=h,
        color=color, huffs={k: (t.counts, t.vals[: t.num_codes]) for k, t in huffs.items()},
        sel=[by_comp[c] for c in range(nc)], **arrays,
    )


def prep_batch(datas: list[bytes]) -> ScanPlan:
    """Parse/destuff a batch with restart markers; all images must share
    geometry AND tables.  Every restart segment becomes a lane."""
    header, streams, seg_pos_all = _batch_streams(datas, restarts=True, route="jpeg_onchip")
    dri = header[3]
    mxx, myy = _mcu_grid(header[0])
    n_mcu = mxx * myy
    n_segs = (n_mcu + dri - 1) // dri
    for starts in seg_pos_all:
        if len(starts) != n_segs:
            raise UnsupportedError("jpeg: restart segment count mismatch")
    flat, offs = _flat_stream(streams)
    seg_bit_pos = np.concatenate(
        [(o + p) * 8 for o, p in zip(offs, seg_pos_all)]
    ).astype(np.int64)
    nm = np.full(n_segs, dri, np.int32)
    nm[-1] = n_mcu - dri * (n_segs - 1)
    return _plan(header, stream=flat, seg_bit_pos=seg_bit_pos,
                 seg_n_mcu=np.tile(nm, len(datas)), seg_mcus=dri, n_segs=n_segs)


# ------------------------------------------------------------- assembly


_UPLOAD_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
                  np.dtype(np.int32): torch.int32,
                  np.dtype(np.uint32): torch.int32}  # the same 32 bits


def _offsets(sizes) -> tuple[list, int]:
    """64-byte-aligned offsets of parts of ``sizes`` bytes, and their total."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += (n + 63) // 64 * 64
    return offs, total


class PinnedUpload:
    """Several numpy arrays (u8, int16, int32 or uint32, the last as int32
    bits) -> device tensors in one copy: the arrays are packed, 64-byte
    aligned, into one host buffer and carved on the device with no copy.
    ``views`` lends a host pass such a buffer, so that it can write the
    arrays there itself and ``__call__`` copies them up with no packing.

    Every plan has a staging buffer of its own, so a prep may fill the next
    batch's while an earlier one's copy is in flight (``DecodePipeline``):
    on CUDA the buffer comes from PyTorch's caching pinned-memory
    allocator, which records an event at each non-blocking copy from it
    and hands its memory out again only once that copy has completed.  The
    copies run on a side CUDA stream of their own, so an upload need not
    queue behind the kernels of the batch before it; the caller's stream
    waits for the copy, and the device buffer is marked as used there
    (``record_stream``, which covers every tensor carved from it), so the
    caching allocator gives its memory out again only after the kernels
    that read it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None  # the side CUDA stream of the copies
        # address -> a buffer ``views`` lent, held until its arrays are gone
        self._lent: dict = {}
        self._lock = threading.Lock()

    def _buffer(self, nbytes: int) -> torch.Tensor:
        """A new u8 host buffer of ``nbytes`` for one upload, pinned on CUDA."""
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda")

    def views(self, specs) -> list:
        """numpy arrays of ``specs`` [(shape, dtype), ...] in a new staging
        buffer, where ``__call__`` packs arrays of those shapes: filled in
        place and passed to ``__call__``, they go up with no packing copy.
        The buffer lives as long as the arrays."""
        sizes = [int(np.prod(shape)) * np.dtype(dt).itemsize for shape, dt in specs]
        offs, total = _offsets(sizes)
        buf = self._buffer(total)
        host = buf.numpy()  # the base every view below keeps alive
        addr = host.ctypes.data
        with self._lock:
            self._lent[addr] = buf
        weakref.finalize(host, self._release, addr)
        return [host[o : o + n].view(dt).reshape(shape)
                for (shape, dt), o, n in zip(specs, offs, sizes)]

    def _release(self, addr: int) -> None:
        """The arrays of the buffer at ``addr`` are gone: let it go (on CUDA
        the allocator keeps it until its copy has completed)."""
        with self._lock:
            del self._lent[addr]

    def _staged(self, parts):
        """The lent buffer ``parts`` fill at ``__call__``'s layout, or None."""
        if not parts:
            return None
        offs, total = _offsets([a.nbytes for a in parts])
        base = parts[0].ctypes.data
        with self._lock:
            buf = self._lent.get(base)
        if buf is None or buf.numel() < total or any(
                a.ctypes.data != base + o or not a.flags.c_contiguous
                for a, o in zip(parts, offs)):
            return None
        return buf

    def staged(self, parts) -> bool:
        """Whether ``__call__`` sends ``parts`` with no packing copy."""
        return self._staged(parts) is not None

    def send(self, host: torch.Tensor) -> torch.Tensor:
        """A host u8 buffer -> its copy on the device (a clone on the CPU):
        asynchronous, on the side stream, ordered before the caller's
        stream's later work.  The span ``upload.send`` (its ``bytes``)
        covers issuing the copy."""
        if self.device.type != "cuda":
            with span("upload.send", bytes=host.numel()):
                return host.clone()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream), span("upload.send", bytes=host.numel()):
            out = host.to(self.device, non_blocking=True)
        compute.wait_stream(self._stream)
        out.record_stream(compute)
        return out

    def __call__(self, parts) -> list:
        """The arrays packed, where ``views`` did not stage them, and sent:
        the span ``upload.pack`` carries the bytes packed (0 where staged)."""
        sizes = [a.nbytes for a in parts]
        offs, total = _offsets(sizes)
        buf = self._staged(parts)
        with span("upload.pack", packed_bytes=0 if buf is not None else sum(sizes)):
            if buf is None:
                buf = self._buffer(total)
                host = buf.numpy()
                for a, o in zip(parts, offs):
                    host[o : o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        out = self.send(buf[:total])
        return [out[o : o + a.nbytes].view(_UPLOAD_DTYPES[a.dtype]).view(a.shape)
                for a, o in zip(parts, offs)]


def resolve_device(device) -> torch.device:
    """The decoder's device: CUDA unless the caller names the CPU.

    With no CUDA device and no explicit ``"cpu"`` this raises: the port
    never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zpix_tpu_torch: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions"
        )
    return dev


class DeviceJpegDecoder:
    """Baseline JPEG batch decode on the GPU: bytes -> RGB8 tensor + ok.

    Requires restart markers (DRI > 0) and shared geometry and tables
    across the batch.  ``planar=True`` returns [B, 3, H, W] (the layout
    the JAX package's main path uses), else [B, H, W, 3]; gray is
    [B, H, W] and 4-component frames [B, 4, H, W] or [B, H, W, 4].
    ``ok`` is a 0-dim bool tensor on the decoder's device: False means
    the on-device verification failed and the batch belongs to the host
    decoder.
    """

    # The route: the JAX package's prefix for its counters and timers, and
    # the steps it times, under its names (zpix_tpu/parallel/
    # device_entropy.py:1675-1685)
    _ROUTE = "jpeg_onchip"
    _TIMERS = {"prep": "prep", "upload": "upload", "run": "dispatch"}

    def __init__(self, *, planar: bool = False, device=None, mesh=None):
        from .mesh import DeviceUploads, mesh_device

        self.planar = planar
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self._upload = PinnedUpload(self.device)
        self._uploads = DeviceUploads(self._upload)  # a shard device's, with a mesh

    def _parts(self, plan: ScanPlan, lo: int = 0, hi: int | None = None) -> list:
        """The upload's arrays for lanes [lo, hi): the whole stream and the
        tables, the lanes' offsets and counts (and ends)."""
        ends = [] if plan.ends is None else [plan.ends.reshape(len(plan.seg_n_mcu), -1)[lo:hi]]
        return [plan.stream, plan.seg_bit_pos[lo:hi].astype(np.int32), plan.seg_n_mcu[lo:hi],
                plan.tables] + ends

    def upload(self, plan: ScanPlan):
        """Stream, offsets, counts, tables (and the host index scan's ends,
        if the plan has them) -> device tensors, in one copy
        (``PinnedUpload``), as zpix_tpu's packed upload does.  With a mesh,
        a list: for each batch position, the same on its device for its
        equal run of lanes (the whole stream, its lanes' offsets), as
        zpix_tpu's mesh upload sends each device the stream and its own
        lanes' offsets; ValueError where the mesh does not divide the lane
        count."""
        from .mesh import shard_bounds

        with stage(self._ROUTE, "upload", self._TIMERS):
            if self.mesh is None:
                return tuple(self._upload(self._parts(plan)))
            lanes = shard_bounds(self.mesh, plan.batch * plan.n_segs,
                                 f"jpeg: the lane count ({plan.batch} images x "
                                 f"{plan.n_segs} segments)")
            return [tuple(self._uploads(dev)(self._parts(plan, lo, hi)))
                    for dev, lo, hi in lanes]

    def entropy(self, plan: ScanPlan, bufs):
        """K1 + K2 + K3 -> (AC int16 [L1*nblk, 64], DC int32 [L1*nblk]
        restored, ok int32 [1])."""
        stream, seg_bit_pos, seg_n_mcu, tables = bufs
        nblk = plan.seg_mcus * plan.bpm
        ends, okf = _entropy.index_pass(
            stream, seg_bit_pos, seg_n_mcu, tables, bpm=plan.bpm, nblk=nblk
        )
        ac, dc = _entropy.value_pass(
            stream, seg_bit_pos, seg_n_mcu, tables, ends, okf, bpm=plan.bpm
        )
        dc = _entropy.dc_restore(dc, hv=plan.hv, seg_mcus=plan.seg_mcus)
        return ac, dc, okf

    def decode_coefficients(self, plan: ScanPlan):
        """-> (coeffs [B*n_segs, nblk, 64] int16 natural order with the DC
        predictors restored, ok 0-dim bool).  With a mesh the coefficients
        are ``Sharded`` by lanes and ``ok`` is every shard's."""
        bufs = self.upload(plan)
        outs = [self.entropy(plan, b) for b in (bufs if self.mesh is not None else [bufs])]
        coeffs = []
        for ac, dc, _ in outs:
            ac[:, 0] = dc.to(torch.int16)  # the AC rows hold 0 at position 0
            coeffs.append(ac.view(-1, plan.seg_mcus * plan.bpm, 64))
        if self.mesh is None:
            return coeffs[0], outs[0][2][0] != 0
        from .mesh import Sharded, all_ok

        return Sharded.stack(coeffs), all_ok([o[2][0] != 0 for o in outs], self.device)

    def prep(self, datas: list[bytes]) -> ScanPlan:
        """The host half: marker walks, destuffing, segments and tables."""
        with stage(self._ROUTE, "prep", self._TIMERS, images=len(datas)):
            plan = prep_batch(datas)
        metrics.count("jpeg_onchip.images", len(datas))
        metrics.count("jpeg_onchip.megapixels", len(datas) * plan.width * plan.height / 1e6)
        return plan

    def run(self, plan: ScanPlan, bufs):
        """The device half on uploaded buffers: the entropy kernels, then K4
        -> (pixels, ok), both on the decoder's device, no sync.  With a
        mesh, each position runs K1-K3 on its lanes and K4 on the images
        whose first lane it holds -> (``Sharded`` pixels, ok on the mesh's
        first device: every shard's ok)."""
        with stage(self._ROUTE, "run", self._TIMERS):
            if self.mesh is None:
                ac, dc, okf = self.entropy(plan, bufs)
                pixels = _backend.backend(ac, dc, bufs[3], _backend.BackendGeometry.of(plan),
                                          planar=self.planar)
                return pixels, okf[0] != 0
            return self._run_sharded(plan, bufs)

    def _run_sharded(self, plan: ScanPlan, bufs):
        """K1-K3 on each position's lanes; then an image whose lanes two
        positions hold (the mesh divides the lane count but not the batch)
        has its other lanes' coefficient rows copied to the position that
        holds its first lane (``mesh.regroup``), and K4 runs there on
        whole images.  The copy is a peer copy between cards, and none
        where every position holds whole images."""
        from .mesh import Sharded, all_ok, regroup

        nblk = plan.seg_mcus * plan.bpm
        outs = [self.entropy(plan, b) for b in bufs]
        acs = regroup([ac.view(-1, nblk, 64) for ac, _, _ in outs], plan.n_segs)
        dcs = regroup([dc.view(-1, nblk) for _, dc, _ in outs], plan.n_segs)
        geom = _backend.BackendGeometry.of(plan)
        pixels = []
        for (ac, n), (dc, _), b in zip(acs, dcs, bufs):
            if n == 0:  # every lane here belongs to an image another holds
                pixels.append(torch.empty((0, *geom.out_shape(self.planar)[1:]),
                                          dtype=torch.uint8, device=ac.device))
                continue
            pixels.append(_backend.backend(
                ac.reshape(-1, 64), dc.reshape(-1), b[3],
                replace(geom, batch=n), planar=self.planar))
        return Sharded.stack(pixels), all_ok([o[2][0] != 0 for o in outs], self.device)

    def decode(self, datas: list[bytes]):
        """bytes -> (pixels, ok), both on the decoder's device, no sync."""
        plan = self.prep(datas)
        return self.run(plan, self.upload(plan))


# ------------------------------------------------------ restart-free streams

# Zero bytes after each stream for the host index scan.  It stops a
# corrupt stream's walk only at a block start past nbits + 512, and a
# block reads at most 64 symbols of <= 31 bits from there, so reads stay
# within ~320 bytes of the end (zpix_tpu pads 8, which a corrupt stream
# can overrun).
INDEX_SCAN_PAD = 512


def _huff_array(huffs):
    """{(class, id): HuffTable} -> the C side's HuffTable[8] (dc 0..3, ac 4..7)."""
    from ..runtime import host

    arr = (host.HuffTableC * 8)()
    for (cls, tid), tab in huffs.items():
        ct = arr[cls * 4 + tid]
        ct.min_codes[:] = tab.min_codes
        ct.max_codes[:] = tab.max_codes
        ct.vals_indices[:] = tab.vals_indices
        ct.vals[:] = tab.vals
        ct.num_codes = tab.num_codes
    return arr


def prep_batch_host_index(datas: list[bytes], n_threads: int | None = None) -> ScanPlan:
    """Restart-free batches: the host index scan -> per-block end bits.

    The port of zpix_tpu's prep_batch_host_index
    (device_entropy.py:1688-1830): headers and destuffing as prep_batch,
    then ``zpix_baseline_index_scan`` decodes symbol lengths only on a
    thread pool (one image each) and gives every block's end bit; the
    plan has one segment per image (seg_mcus = n_mcu) and carries the
    absolute ends for K2, whose agree check verifies each of them.
    """
    from ..runtime import host

    header, streams, _ = _batch_streams(datas, restarts=False, route="jpeg_hostindex")
    sof, _, huffs, _, sel, _ = header
    comps = sof[3]
    mxx, myy = _mcu_grid(sof)
    n_mcu = mxx * myy
    comp_of_slot = [c for c in range(sof[2]) for _ in range(comps[c][1] * comps[c][2])]
    bpm = len(comp_of_slot)
    B = len(datas)
    slot_dc = np.array([sel[c][1] for c in comp_of_slot], np.int32)
    slot_ac = np.array([sel[c][2] for c in comp_of_slot], np.int32)
    huff_arr = _huff_array(huffs)
    lib = host.lib()
    ends = np.empty((B, n_mcu * bpm), np.int32)
    padded = [np.concatenate([s, np.zeros(INDEX_SCAN_PAD, np.uint8)]) for s in streams]

    def one(b):
        endb = ctypes.c_int64(0)
        return lib.zpix_baseline_index_scan(
            padded[b].ctypes.data, len(streams[b]), huff_arr, slot_dc.ctypes.data,
            slot_ac.ctypes.data, bpm, n_mcu, ends[b].ctypes.data, ctypes.byref(endb))

    workers = min(B, n_threads or os.cpu_count() or 2)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        rcs = list(ex.map(one, range(B)))
    bad = [b for b, rc in enumerate(rcs) if rc != 0]
    if bad:
        raise FormatError(f"jpeg: host index scan failed on image {bad[0]} "
                          f"({host.error_name(rcs[bad[0]])})")
    flat, offs = _flat_stream(streams)
    seg_bit_pos = np.asarray(offs, np.int64) * 8
    plan = _plan(header, stream=flat, seg_bit_pos=seg_bit_pos,
                 seg_n_mcu=np.full(B, n_mcu, np.int32), seg_mcus=n_mcu, n_segs=1)
    plan.ends = ends + seg_bit_pos.astype(np.int32)[:, None]
    return plan


class HostIndexJpegDecoder(DeviceJpegDecoder):
    """Restart-free baseline JPEG: host index scan + K2, K3, K4.

    The port of zpix_tpu's HostIndexJpegDecoder (device_entropy.py:1833):
    the host decodes symbol lengths only (``prep_batch_host_index``), the
    card decodes every block's values in parallel from those ends and
    verifies each end exactly.  ``ok`` is K2's done & ~err & agree; there
    is no K1.  Streams with restart markers raise UnsupportedError (they
    belong to DeviceJpegDecoder).
    """

    _ROUTE = "jpeg_hostindex"  # device_entropy.py:1876-1882

    def __init__(self, *, planar: bool = False, device=None, n_threads: int | None = None,
                 mesh=None):
        super().__init__(planar=planar, device=device, mesh=mesh)
        self.n_threads = n_threads

    def entropy(self, plan: ScanPlan, bufs):
        """K2 from the host's ends + K3 -> (AC, restored DC, ok int32 [1])."""
        stream, seg_bit_pos, seg_n_mcu, tables, ends = bufs
        okf = torch.ones(1, dtype=torch.int32, device=stream.device)
        ac, dc = _entropy.value_pass(stream, seg_bit_pos, seg_n_mcu, tables, ends, okf,
                                     bpm=plan.bpm)
        dc = _entropy.dc_restore(dc, hv=plan.hv, seg_mcus=plan.seg_mcus)
        return ac, dc, okf

    def prep(self, datas: list[bytes]) -> ScanPlan:
        """The host half: headers, destuffing and the host index scan."""
        with stage(self._ROUTE, "prep", self._TIMERS, images=len(datas)):
            plan = prep_batch_host_index(datas, self.n_threads)
        metrics.count("jpeg_hostindex.images", len(datas))
        return plan
