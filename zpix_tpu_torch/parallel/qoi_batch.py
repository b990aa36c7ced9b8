"""QOI batches on the card: host record passes -> device run expansion
(``HostIndexQoiDecoder``), and the device encoder (``encode_device``,
``encode_device_batch``).

The port of zpix_tpu/parallel/qoi_batch.py's host-index split (:661-1410)
and device encoder (:1412-1623).  QOI's op stream is serial by
construction (every op updates the previous pixel and a 64-entry rolling
index), so the byte walk runs on the host, in the port's copy of the C++
(csrc/host/qoi.cpp, a thread an image), and emits run-length records; the
card expands them into the raster:

* ``impl="lane"`` (default): the raster is cut into P-pixel lanes and each
  record into per-lane entries (``prep_qoi_lanes``, wide form: colour u32,
  start and end i16; ``prep_qoi_lanes4``, p4 form: (r, g, b, start) u8,
  half the bytes, for opaque content with P <= 255), and K12 computes each
  lane's pixels as a masked sum over its entries (ops/qoi.py).
* ``impl="sorted"``: per-op (colour, count) records (``prep_qoi_records``)
  and K13's cumsum + searchsorted expansion.

``lane_fmt="auto"`` stages p4 and falls back to the wide form, batch by
batch, when a stream carries alpha.  The host pass is the serial
reference semantics, so the result is exact and there is no ``ok`` flag.
Each plan goes up in one pinned copy; the lane pass writes its plan
straight into the pinned buffer (``out=``).  With ``mesh`` the lane form
shards its lanes (batch-major, as zpix_tpu shards the lane-major arrays)
and the sorted form its images over the mesh's batch axis, each run
expanded on its own device; lanes of an image that two positions hold
come together where its first lane is (``mesh.regroup``), and the output
is ``Sharded``.  Not ported, by decision: the speculative
``BatchQoiDecoder`` and its knobs, the ``ZPIX_QOI_*`` environment
variables and the loop form of the expansion.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..codecs.qoi.decode import _parse_header
from ..codecs.qoi.encode import PADDING, check_desc, header
from ..errors import FormatError, UnsupportedError
from ..ops import qoi as kq
from ..runtime import host
from ..utils import metrics, trace
from .device_entropy import PinnedUpload, resolve_device
from .mesh import DeviceUploads, Sharded, mesh_device, regroup

DEFAULT_LANE_P = 32  # zpix_tpu's default when ZPIX_QOI_LANE_P is unset


def _batch_dims(datas) -> tuple[int, int]:
    if not datas:
        raise ValueError("qoi: empty batch")
    w, h, _c, _cs = _parse_header(datas[0])
    for d in datas[1:]:
        w2, h2, _c2, _cs2 = _parse_header(d)
        if (w2, h2) != (w, h):
            raise UnsupportedError("qoi: mixed dimensions in batch")
    return w, h


def _map(fn, n: int):
    """fn(i) for i < n on a thread pool (ctypes releases the GIL)."""
    with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 2)) as ex:
        return list(ex.map(fn, range(n)))


# ------------------------------------------------------------- record pass


@dataclass
class QoiRecordPlan:
    """Host record pass over a same-dimensions QOI batch."""

    width: int
    height: int
    cols: np.ndarray  # [B, rcap] uint32 packed 0xRRGGBBAA
    cnts: np.ndarray  # [B, rcap] uint8, 0 past each image's records
    fill: np.ndarray  # [B] uint32 final decoder px (stream-exhausted fill)
    batch: int
    rcap: int


def _record_scan_native(data: bytes, pixel_count: int):
    rcap = max(1, len(data))  # one op is >= 1 byte
    cols = np.empty(rcap, np.uint32)
    cnts = np.empty(rcap, np.uint8)
    n_out = ctypes.c_int64()
    fill = ctypes.c_uint32()
    rc = host.lib().zpix_qoi_record_scan(
        data, len(data), pixel_count, cols.ctypes.data, cnts.ctypes.data, rcap,
        ctypes.byref(n_out), ctypes.byref(fill))
    if rc != 0:
        raise FormatError(f"qoi: record scan failed (rc={rc})")
    n = n_out.value
    return cols[:n], cnts[:n], np.uint32(fill.value)


def prep_qoi_records(datas: list[bytes], rcap_hint: int | None = None) -> QoiRecordPlan:
    """Host record pass (threaded across the batch).  rcap pads to the next
    64Ki multiple (>= rcap_hint), as zpix_tpu pads it."""
    w, h = _batch_dims(datas)
    npx = w * h
    parts = _map(lambda i: _record_scan_native(datas[i], npx), len(datas))
    need = max(p[0].shape[0] for p in parts)
    rcap = max(need, rcap_hint or 0, 1)
    rcap = -(-rcap // 65536) * 65536  # 64Ki buckets: shared layouts
    B = len(datas)
    cols = np.zeros((B, rcap), np.uint32)
    cnts = np.zeros((B, rcap), np.uint8)
    fill = np.empty(B, np.uint32)
    for i, (c, n, f) in enumerate(parts):
        cols[i, : c.shape[0]] = c
        cnts[i, : n.shape[0]] = n
        fill[i] = f
    return QoiRecordPlan(w, h, cols, cnts, fill, B, rcap)


# --------------------------------------------------------------- lane pass


@dataclass
class QoiLanePlan:
    """Lane-aligned host record pass (the lane expansion's format).

    The raster is cut into P-pixel lanes; every record is split at lane
    boundaries into (color, local start, local end) entries.  Arrays are
    lane-MAJOR [Lt, R] (Lt = batch * lanes-per-image, lanes batch-major;
    each lane's R slots contiguous so the C++ fill streams sequentially).
    R = bucketed max entries a lane."""

    width: int
    height: int
    P: int
    cols: np.ndarray | None  # [Lt, R] uint32 (fmt="wide"; None for "p4")
    s: np.ndarray | None  # [Lt, R] int16 local start (>= e means empty slot)
    e: np.ndarray | None  # [Lt, R] int16 local end
    batch: int
    R: int
    # fmt="p4": (r, g, b, start) u8 granules in ONE [Lt, R*4] array, ends
    # implicit (e[r] = s[r+1], last = P; pad slots carry s = P); opaque
    # streams with P <= 255 only
    fmt: str = "wide"
    p4: np.ndarray | None = None


def _bucket8(r: int) -> int:
    return -(-max(r, 1) // 8) * 8


def _lane_geometry(datas, P: int | None, cap: int):
    """-> (w, h, P, n_lanes): P defaults to 32, is capped at ``cap`` (the
    int16 span limit 32767, or 255 for p4 starts) and shrinks to the
    largest divisor of the pixel count at or under it, so lanes tile the
    raster exactly."""
    w, h = _batch_dims(datas)
    npx = w * h
    P = min(P or DEFAULT_LANE_P, cap)
    if npx % P:
        P = next(q for q in range(min(P, npx), 0, -1) if npx % q == 0)
    return w, h, P, npx // P


def _first_r(datas, n_lanes: int, r_hint: int | None) -> int:
    """The layout hint, or an average-density estimate for the probe pass
    (ops a lane ~= stream bytes / 2.9 / lanes; x1.25 + 2 covers boundary
    splits; an undershoot costs one refill pass)."""
    if r_hint:
        return _bucket8(r_hint)
    est = max(len(d) for d in datas) / 2.9 / n_lanes
    return _bucket8(int(est * 1.25) + 2)


def prep_qoi_lanes(datas: list[bytes], P: int | None = None, r_hint: int | None = None,
                   out: tuple | None = None) -> QoiLanePlan:
    """Lane-aligned host pass, wide form (threaded across the batch): one
    sequential C++ fill of the padded [Lt, R] arrays per image
    (zpix_qoi_lane_fill).  R buckets to a multiple of 8 (>= r_hint); an
    undersized guess costs one refill, an overshot estimate (no hint) one
    refill at the tight bucket.  ``out``: (cols, s, e) arrays of a prior
    same-layout plan to fill in place (every slot is rewritten)."""
    w, h, P, n_lanes = _lane_geometry(datas, P, 32767)
    npx, B = w * h, len(datas)
    Lt = B * n_lanes
    R = _first_r(datas, n_lanes, r_hint)
    lib = host.lib()
    while True:
        if out is not None and out[0].shape == (Lt, R):
            cols, s, e = out
        else:
            cols = np.empty((Lt, R), np.uint32)
            s = np.empty((Lt, R), np.int16)
            e = np.empty((Lt, R), np.int16)

        def fill(i):
            off = i * n_lanes * R
            need = ctypes.c_int32()
            fillpx = ctypes.c_uint32()
            rc = lib.zpix_qoi_lane_fill(
                datas[i], len(datas[i]), npx, P, R, cols.ctypes.data + 4 * off,
                s.ctypes.data + 2 * off, e.ctypes.data + 2 * off, ctypes.byref(need),
                ctypes.byref(fillpx))
            if rc not in (0, 3):
                raise FormatError(f"qoi: lane fill failed (rc={rc})")
            return need.value

        needs = _map(fill, B)
        tight = _bucket8(max(max(needs), r_hint or 0))
        if max(needs) <= R:
            if tight < R and not r_hint:
                out, R = None, tight  # estimate overshot: refill at the tight bucket
                continue
            return QoiLanePlan(w, h, P, cols, s, e, B, R)
        R = tight


def prep_qoi_lanes4(datas: list[bytes], P: int | None = None, r_hint: int | None = None,
                    out: np.ndarray | None = None) -> QoiLanePlan | None:
    """Packed-4-byte lane prep: (r, g, b, start) u8 granules, 4 B an entry
    against the wide form's 8, ends implicit.  OPAQUE streams with P <= 255
    only: returns None when a stream carries alpha (the caller falls back to
    ``prep_qoi_lanes``).  ``out``: a [Lt, R*4] array of a prior same-layout
    plan to refill in place."""
    w, h, P, n_lanes = _lane_geometry(datas, P, 255)
    npx, B = w * h, len(datas)
    Lt = B * n_lanes
    R = _first_r(datas, n_lanes, r_hint)
    lib = host.lib()
    while True:
        p4 = out if out is not None and out.shape == (Lt, R * 4) else np.empty((Lt, R * 4), np.uint8)
        bail = []

        def fill(i):
            need = ctypes.c_int32()
            fillpx = ctypes.c_uint32()
            rc = lib.zpix_qoi_lane_fill4(
                datas[i], len(datas[i]), npx, P, R, p4.ctypes.data + i * n_lanes * R * 4,
                ctypes.byref(need), ctypes.byref(fillpx))
            if rc == 5:  # non-opaque: wide-form content
                bail.append(i)
                return 0
            if rc not in (0, 3):
                raise FormatError(f"qoi: lane fill4 failed (rc={rc})")
            return need.value

        needs = _map(fill, B)
        if bail:
            return None
        tight = _bucket8(max(max(needs), r_hint or 0))
        if max(needs) <= R:
            if tight < R and not r_hint:
                out, R = None, tight
                continue
            return QoiLanePlan(w, h, P, None, None, None, B, R, fmt="p4", p4=p4)
        R = tight


# ----------------------------------------------------------------- decoder


class HostIndexQoiDecoder:
    """QOI decode by host C++ record pass + device run-length expansion:
    bytes -> RGBA8 [B, H, W, 4] uint8 on the decoder's device.

    ``impl``: "lane" (K12) or "sorted" (K13).  ``lane_p``: pixels a lane
    (default 32; shrunk to a divisor of the pixel count, and to 255 for
    p4).  ``lane_fmt``: "auto" (p4, or wide on a batch that carries alpha),
    "wide" or "p4" (raises ``UnsupportedError`` on alpha content).  R and
    rcap hints carry from batch to batch, so batches of one layout share
    their shapes."""

    def __init__(self, *, impl: str = "lane", lane_p: int | None = None,
                 lane_fmt: str = "auto", device=None, mesh=None):
        if impl not in ("lane", "sorted") or lane_fmt not in ("auto", "wide", "p4"):
            raise ValueError(f"qoi: unknown impl {impl!r} or lane_fmt {lane_fmt!r}")
        self.impl = impl
        self.lane_p = lane_p
        self.lane_fmt = lane_fmt
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self._upload = PinnedUpload(self.device)
        self._uploads = DeviceUploads(self._upload)
        self._rcap_hint = 0
        self._r_hint = 0
        self._r4_hint = 0

    def _staged(self, datas, p4: bool, r_hint: int):
        """``out=`` for the lane pass: views of the pinned staging buffer at
        the layout the pass starts from (the hinted R, or its estimate)."""
        _w, _h, _P, n_lanes = _lane_geometry(datas, self.lane_p, 255 if p4 else 32767)
        Lt, R = len(datas) * n_lanes, _first_r(datas, n_lanes, r_hint or None)
        if p4:
            return self._upload.views([((Lt, R * 4), np.uint8)])[0]
        return tuple(self._upload.views([((Lt, R), np.uint32), ((Lt, R), np.int16),
                                         ((Lt, R), np.int16)]))

    def prep(self, datas: list[bytes]) -> QoiRecordPlan | QoiLanePlan:
        """The host pass of ``impl`` and ``lane_fmt``, with the carried hints.
        A lane plan is filled straight into a pinned staging buffer of its
        own when its layout is the one the pass starts from (the usual case
        once a batch has set the hint), so ``upload`` copies nothing on the
        host.  A hint ``run`` raised after this pass started only changes
        the layout: the pass grows R to what its batch needs."""
        with trace("qoi_hostindex.prep"):
            plan = self._prep(datas)
        metrics.count("qoi_hostindex.images", plan.batch)
        return plan

    def _prep(self, datas):
        if self.impl == "sorted":
            return prep_qoi_records(datas, self._rcap_hint or None)
        plan = None
        if self.lane_fmt in ("auto", "p4"):
            r4 = self._r4_hint
            plan = prep_qoi_lanes4(datas, self.lane_p, r4 or None,
                                   out=self._staged(datas, True, r4))
            if plan is None and self.lane_fmt == "p4":
                raise UnsupportedError(
                    "qoi: lane_fmt='p4' needs opaque content (alpha in stream) "
                    "- use 'auto' or 'wide'")
        r = self._r_hint
        return plan or prep_qoi_lanes(datas, self.lane_p, r or None,
                                      out=self._staged(datas, False, r))

    @staticmethod
    def _arrays(plan: QoiRecordPlan | QoiLanePlan) -> list:
        if isinstance(plan, QoiRecordPlan):
            return [plan.cols, plan.cnts, plan.fill]
        return [plan.p4] if plan.fmt == "p4" else [plan.cols, plan.s, plan.e]

    def upload(self, plan: QoiRecordPlan | QoiLanePlan) -> list:
        """The plan's arrays -> device tensors, in one pinned copy (with no
        packing copy for arrays ``prep`` filled in place).  With a mesh, a
        list of those a batch position: its run of images (sorted) or of
        lanes (lane); ValueError where the mesh does not divide them."""
        arrays = self._arrays(plan)
        if self.mesh is None:
            return self._upload(arrays)
        n = len(arrays[0])
        return self._uploads.runs(self.mesh, arrays, f"qoi: the batch ({n} images)"
                                  if isinstance(plan, QoiRecordPlan)
                                  else f"qoi: the lane count ({n} lanes)")

    def run(self, plan: QoiRecordPlan | QoiLanePlan, bufs):
        """The expansion kernel on uploaded buffers -> [B, H, W, 4] uint8
        (``Sharded`` with a mesh)."""
        if isinstance(plan, QoiRecordPlan):
            self._rcap_hint = max(self._rcap_hint, plan.rcap)
        elif plan.fmt == "p4":
            self._r4_hint = max(self._r4_hint, plan.R)
        else:
            self._r_hint = max(self._r_hint, plan.R)
        shape = (plan.height, plan.width)
        if self.mesh is None:
            return self._expand(plan, bufs, (plan.batch, *shape))
        if isinstance(plan, QoiRecordPlan):
            return Sharded.stack(self._expand(plan, b, (len(b[0]), *shape)) for b in bufs)
        # a run of lanes -> its pixels, a row of P each; then whole images
        rows = [self._expand(plan, b, (len(b[0]), plan.P, 1)).view(-1, plan.P, 4)
                for b in bufs]
        npx = plan.width * plan.height
        return Sharded.stack(px.view(n, *shape, 4) for px, n in regroup(rows, npx // plan.P))

    @staticmethod
    def _expand(plan: QoiRecordPlan | QoiLanePlan, bufs, shape):
        if isinstance(plan, QoiRecordPlan):
            return kq.sorted_expand(*bufs, shape=shape)
        if plan.fmt == "p4":
            return kq.lane_expand_p4(bufs[0], P=plan.P, shape=shape)
        return kq.lane_expand_wide(*bufs, P=plan.P, shape=shape)

    def decode(self, datas: list[bytes], plan: QoiRecordPlan | QoiLanePlan | None = None):
        if plan is None:
            plan = self.prep(datas)
        return self.run(plan, self.upload(plan))


# ----------------------------------------------------------- device encode


def _pack_px(pixels, desc, device):
    """Pixels (numpy or tensor, uint8) -> packed 0xRRGGBBAA int32 [n] on
    ``device``; alpha 255 for 3 channels."""
    n = desc.width * desc.height
    pix = torch.as_tensor(np.asarray(pixels, np.uint8) if not torch.is_tensor(pixels)
                          else pixels).to(device).reshape(-1)
    if pix.dtype != torch.uint8:
        raise TypeError("qoi: pixels must be uint8")
    if pix.numel() < n * desc.channels:
        raise FormatError("qoi: pixel buffer too small")
    c = pix[: n * desc.channels].view(n, desc.channels)
    a = c[:, 3] if desc.channels == 4 else torch.full_like(c[:, 0], 255)
    # bytes A, B, G, R read as one little-endian word are 0xRRGGBBAA
    return torch.stack([a, c[:, 2], c[:, 1], c[:, 0]], -1).view(torch.int32).view(n)


def _streams(out, totals, descs) -> list[bytes]:
    """Header + out[b, :total] + padding for each image, out downloaded in
    one copy."""
    totals = totals.cpu().tolist()
    body = out[:, : max(totals)].cpu().numpy()
    return [b"".join((header(d), body[i, :t].data, PADDING))
            for i, (d, t) in enumerate(zip(descs, totals))]


def encode_device(pixels, desc, device=None) -> bytes:
    """On-device QOI encode (K14): byte-identical to codecs/qoi/encode.encode().
    The host checks the descriptor and adds the header and the padding."""
    check_desc(desc)
    dev = resolve_device(device)
    out, total = kq.encode(_pack_px(pixels, desc, dev)[None])
    return _streams(out, total, [desc])[0]


def encode_device_batch(pixel_batch, descs, device=None) -> list[bytes]:
    """Batched on-device encode of same-size images: pixel_batch [B, ...]
    uint8 (numpy or tensor), descs a Desc an image sharing width, height and
    channels -> the encoded bytes of each image."""
    d0 = descs[0]
    if any((d.width, d.height, d.channels) != (d0.width, d0.height, d0.channels)
           for d in descs):
        raise UnsupportedError("qoi: encode batch must share geometry")
    dev = resolve_device(device)
    px = torch.stack([_pack_px(p, d, dev) for p, d in zip(pixel_batch, descs)])
    out, totals = kq.encode(px)
    return _streams(out, totals, descs)
