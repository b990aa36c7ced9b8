"""Batched JPEG decode from coefficients: native front-end -> K7 -> K6.

The PyTorch/CUDA counterpart of zpix_tpu/parallel/batch.py's native
route (``NativeBatchFrontEnd`` + ``decode_batch_ycbcr_flat``).  The host
half parses a batch of same-geometry baseline JPEGs with the port's copy
of the native C++ front-end (csrc/host/entropy.cpp, a thread per image):
marker walk, Huffman scan and sparse packing straight into one flat
buffer of the batch's own (pinned when the decoder runs on CUDA), which
goes to the card in one copy.  The device half carves that buffer with
no copy and runs two hand-written kernels:

1. sparse unpack (K7, ops/sparse.py): nonzero bitmaps + int16 values ->
   dense coefficient grids in grid order, one launch for all components;
2. component planes (K6, ops/planes.py): per-image dequant, Wang IDCT,
   level shift, chroma replication and colour into [B, H, W, C] u8.

The native front-end takes 1- and 3-component single-scan non-RGB
baseline streams.  A batch holding any other stream (RGB, 4-component,
multi-scan, progressive, or one of mixed geometry) goes to the Python
front-end, as every stream does in the reference's ``BatchJpegDecoder``:
the host decoder (codecs/jpeg/decoder.py, its scans in the C++
``zpix_decode_scan``, an image a worker thread) parses each image to
dense coefficient grids, which ``pack_sparse`` packs into the same flat
buffer (grid order, so no perm), so ``upload`` and ``run`` (K7, then K6
on the gray, ycbcr, rgb, ycck or cmyk arm) are those of the native
route.  A batch the native front-end fails on is parsed again by the
Python front-end: it raises the reference's own error, or decodes and is
counted under ``jpeg_batch.native_refused``.  With ``mesh``, the parsed
batch is cut into equal runs of images (``Packed.images``), one a batch
position of the mesh, each uploaded to and decoded (K7, K6) on its own
device, as zpix_tpu shards every stacked input; the output is ``Sharded``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..codecs.jpeg.decoder import ADOBE_UNKNOWN, Decoder
from ..codecs.jpeg.tables import UNZIG
from ..errors import FormatError, UnsupportedError
from ..ops import planes as _planes
from ..ops import sparse as _sparse
from ..runtime import host as _host
from ..utils import metrics, span, stage, trace
from .device_entropy import PinnedUpload
from .mesh import DeviceUploads, Sharded, mesh_device, shard_bounds

_RATIOS = {0x11: "444", 0x12: "440", 0x21: "422",
           0x22: "420", 0x41: "411", 0x42: "410"}
RATIO_FACTORS = {"444": (1, 1), "422": (2, 1), "420": (2, 2),
                 "440": (1, 2), "411": (4, 1), "410": (4, 2)}
_REFUSED = "is one the native front-end refuses (the Python front-end takes it)"
_MIXED = ("batch images must share (width, height, ratio, color); "
          "bucket mixed shapes separately")


# ------------------------------------------------------------------ host half


class FrontEndResult:
    """Per-image entropy-decode output of the Python front-end."""

    __slots__ = (
        "width", "height", "ratio", "ncomp", "coeffs", "quants", "hv", "color"
    )

    def __init__(self, width, height, ratio, ncomp, coeffs, quants, hv,
                 color="ycbcr"):
        self.width = width
        self.height = height
        self.ratio = ratio
        self.ncomp = ncomp
        self.coeffs = coeffs  # list of [bv, bh, 64] int32 (natural order)
        self.quants = quants  # list of [64] int32 (natural order)
        self.hv = hv  # list of (h, v)
        # "gray" | "ycbcr" | "rgb" | "ycck" | "cmyk" | "cmyk?" (4-comp with
        # no Adobe marker: the reference errors, decoder.zig:795-799)
        self.color = color


def parse_coefficients(data: bytes) -> FrontEndResult:
    """Entropy-decode a JPEG to coefficient tensors without reconstructing."""
    d = Decoder(data)
    d.collect_only = True
    d.decode_inner(False)
    ncomp = d.num_components
    ratio = d._subsample_ratio() if ncomp >= 3 else "gray"
    if ncomp == 1:
        color = "gray"
    elif ncomp == 3:
        color = "rgb" if d.is_rgb() else "ycbcr"
    elif not d.adobe_transform_valid:
        color = "cmyk?"
    else:
        color = "cmyk" if d.adobe_transform == ADOBE_UNKNOWN else "ycck"
    coeffs, quants, hv = [], [], []
    for i in range(ncomp):
        coeffs.append(d.coeff[i] if d.coeff[i] is not None else None)
        qzig = d.quant[d.component[i].tq]
        qnat = np.empty(64, np.int32)
        qnat[UNZIG] = qzig
        quants.append(qnat)
        hv.append((d.component[i].h, d.component[i].v))
    return FrontEndResult(
        d.width, d.height, ratio, ncomp, coeffs, quants, hv, color
    )


class PackedFrontEnd:
    """Sparse-packed front-end output of one image (stream block order;
    ``perms[c]`` maps grid index -> stream index, None when equal)."""

    __slots__ = ("width", "height", "ratio", "ncomp", "bitmaps", "vals", "quants",
                 "hv", "perms")

    def __init__(self, width, height, ratio, ncomp, bitmaps, vals, quants, hv, perms):
        self.width, self.height, self.ratio, self.ncomp = width, height, ratio, ncomp
        self.bitmaps = bitmaps  # list of [nb, 8] uint8
        self.vals = vals  # list of int16[nnz]
        self.quants = quants  # list of [64] int32, natural order
        self.hv = hv
        self.perms = perms


_PERM_CACHE: dict = {}


def stream_perm(mxx: int, myy: int, hi: int, vi: int):
    """grid->stream block index map for one component of an interleaved
    scan: stream order is (my, mx, j) with by = vi*my + j//hi and
    bx = hi*mx + j%hi (decoder.zig:1327-1329); None when that is already
    row-major grid order (hi == vi == 1)."""
    if hi == 1 and vi == 1:
        return None
    key = (mxx, myy, hi, vi)
    if key not in _PERM_CACHE:
        my, mx, jj = np.meshgrid(np.arange(myy), np.arange(mxx), np.arange(hi * vi),
                                 indexing="ij")
        grid_of_stream = ((vi * my + jj // hi) * (mxx * hi) + hi * mx + jj % hi).reshape(-1)
        inv = np.empty_like(grid_of_stream)
        inv[grid_of_stream] = np.arange(len(grid_of_stream))
        _PERM_CACHE[key] = inv.astype(np.int32)
    return _PERM_CACHE[key]


def _peek_sof(data: bytes):
    """Cheap scan for SOF0/1 dims and sampling factors -> (w, h, nc, hv),
    or None (no baseline SOF before the first SOS)."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        ln = (data[pos + 2] << 8) | data[pos + 3]
        if marker in (0xC0, 0xC1):
            seg = data[pos + 4 : pos + 2 + ln]
            if len(seg) < 6:
                return None
            h, w, nc = (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            hv = [(seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 0x0F) for i in range(nc)]
            return w, h, nc, [(1, 1)] if nc == 1 else hv
        if marker == 0xDA:
            return None
        pos += 2 + ln
    return None


def _ratio(hv):
    if len(hv) == 1:
        return "gray"
    hr, vr = hv[0][0] // hv[1][0], hv[0][1] // hv[1][1]
    return _RATIOS.get((hr << 4) | vr)


def _mcus(w, h, hv):
    h0, v0 = hv[0]
    return (w + 8 * h0 - 1) // (8 * h0), (h + 8 * v0 - 1) // (8 * v0)


def _ptrs(arrays):
    out = (ctypes.c_void_p * 4)()
    for i, a in enumerate(arrays):
        out[i] = a.ctypes.data
    return out


def parse_packed_native(data: bytes, n_threads: int = 1):
    """One image through the native front-end -> PackedFrontEnd, or None
    where it refuses the stream.  ``n_threads`` > 1 decodes restart
    segments in parallel when the stream has them."""
    sof = _peek_sof(data)
    if sof is None or sof[2] not in (1, 3):
        return None
    w, h, nc, hv = sof
    mxx, myy = _mcus(w, h, hv)
    bitmaps, vals = [], []
    cap_arr = (ctypes.c_int64 * 4)()
    for i in range(nc):
        nb = mxx * hv[i][0] * myy * hv[i][1]
        bitmaps.append(np.empty((nb, 8), np.uint8))
        vals.append(np.empty(nb * 64, np.int16))
        cap_arr[i] = nb * 64
    quant_nat = np.zeros((3, 64), np.int32)
    nnz = (ctypes.c_int64 * 4)()
    rc = _host.lib().zpix_parse_baseline(
        data, len(data), w, h, _ptrs(bitmaps), _ptrs(vals),
        cap_arr, quant_nat.ctypes.data, nnz, n_threads)
    ratio = _ratio(hv)
    if rc != 0 or ratio is None:
        return None
    return PackedFrontEnd(
        w, h, ratio, nc, bitmaps, [vals[i][: nnz[i]] for i in range(nc)],
        [quant_nat[i] for i in range(nc)], hv,
        [stream_perm(mxx, myy, *hv[i]) for i in range(nc)])


def pack_sparse(coeff: np.ndarray):
    """[bv, bh, 64] int32 -> (bitmap [nb, 8] uint8, vals int16[nnz])."""
    coeff = np.ascontiguousarray(coeff, np.int32)
    nb = coeff.shape[0] * coeff.shape[1]
    bitmap = np.empty((nb, 8), np.uint8)
    vals = np.empty(coeff.size, np.int16)
    n = _host.lib().zpix_pack_sparse(coeff.ctypes.data, nb, bitmap.ctypes.data,
                                     vals.ctypes.data, coeff.size)
    if n < 0:
        raise RuntimeError("pack_sparse: value buffer too small")
    return bitmap, vals[:n].copy()


def flat_layout(batch: int, nb, val_caps):
    """The flat buffer's sections (kind, comp, byte offset, nbytes), each
    64-byte aligned: the bitmaps [B, nb_c, 8] u8 of every component, then
    the values [B, cap_c] int16, then the quant rows [B, 64] int32.  The
    first two are zpix_tpu's NativeBatchFrontEnd layout, byte for byte."""
    layout, off = [], 0
    for kind, sizes in (("bm", [batch * n * 8 for n in nb]),
                        ("val", [batch * c * 2 for c in val_caps]),
                        ("q", [batch * 256] * len(nb))):
        for c, nbytes in enumerate(sizes):
            layout.append((kind, c, off, nbytes))
            off += (nbytes + 63) // 64 * 64
    return layout, off


def carve(buffer: torch.Tensor, layout, kind: str, c: int, batch: int):
    """A section of the flat buffer as a typed view (no copy): bitmaps
    [B, nb, 8] u8, values [B, cap] int16 or quant rows [B, 64] int32."""
    for k, cc, off, nbytes in layout:
        if (k, cc) == (kind, c):
            seg = buffer[off : off + nbytes]
            if kind == "bm":
                return seg.view(batch, -1, 8)
            return seg.view(torch.int16 if kind == "val" else torch.int32).view(batch, -1)
    raise KeyError((kind, c))


class NativeBatchFrontEnd:
    """Whole-batch native front-end: one C call, an internal thread pool.

    Parses N same-geometry baseline JPEGs into one flat buffer
    (``flat_layout``), so a batch ships to the card in one copy.  Each
    ``parse`` fills a buffer of its own (pinned host memory from PyTorch's
    caching allocator with ``pin=True``), so parses may run on several
    threads at once and a buffer is rewritten only once its copy is done.
    Value capacity is ``nb * 64 / VAL_CAP_FRAC`` per image, or twice the
    sample's count if more; ``dense=True`` sizes it for every coefficient.
    """

    VAL_CAP_FRAC = 8

    def __init__(self, sample: bytes, batch: int, n_threads: int | None = None, *,
                 pin: bool = False, dense: bool = False):
        sof = _peek_sof(sample)
        if sof is None or sof[2] not in (1, 3):
            raise UnsupportedError(f"jpeg: this stream {_REFUSED}")
        self.width, self.height, self.ncomp, self.hv = sof
        self.ratio = _ratio(self.hv)
        if self.ratio is None:
            raise UnsupportedError(f"jpeg: sampling {self.hv} {_REFUSED}")
        self.mxx, self.myy = _mcus(self.width, self.height, self.hv)
        self.batch = batch
        self.pin = pin
        self.n_threads = n_threads or (os.cpu_count() or 2)
        p = None if dense else parse_packed_native(sample)
        self.nb, self.val_caps = [], []
        for c, (hi, vi) in enumerate(self.hv):
            nb = self.mxx * hi * self.myy * vi
            cap = nb * 64 if dense else nb * 64 // self.VAL_CAP_FRAC
            if p is not None:
                cap = max(cap, 2 * len(p.vals[c]))
            self.nb.append(nb)
            self.val_caps.append(min((cap + 511) // 512 * 512, nb * 64))
        self.layout, self.nbytes = flat_layout(batch, self.nb, self.val_caps)
        self.perm_y = stream_perm(self.mxx, self.myy, *self.hv[0])
        self.perm_c = stream_perm(self.mxx, self.myy, *self.hv[1]) if self.ncomp >= 3 else None
        # stream_perm's ints of each (None for grid order): they key the
        # perms' device maps, so a decode hashes no perm
        self.perm_ints = tuple(None if p is None else (self.mxx, self.myy, *hv)
                               for p, hv in ((self.perm_y, self.hv[0]),
                                             (self.perm_c, self.hv[-1])))

    def parse(self, datas: list[bytes]) -> "Packed":
        """Parse the batch into a new flat buffer (one C call) -> its
        Packed.  Raises UnsupportedError for a stream this front-end
        refuses, FormatError for a broken one or one denser than the value
        capacity."""
        b = len(datas)
        if b != self.batch:
            raise ValueError("batch size mismatch")
        buf = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=self.pin)
        bitmaps, vals, quants = ([carve(buf, self.layout, kind, c, b).numpy()
                                  for c in range(self.ncomp)] for kind in ("bm", "val", "q"))
        nnz = np.empty((b, 3), np.int64)
        rcs = np.empty(b, np.int32)
        data_ptrs = (ctypes.c_char_p * b)(*datas)
        lens = (ctypes.c_int64 * b)(*[len(d) for d in datas])
        caps = (ctypes.c_int64 * 4)(*self.val_caps)
        strides = (ctypes.c_int64 * 4)(*[n * 8 for n in self.nb])
        rc = _host.lib().zpix_parse_baseline_batch(
            data_ptrs, lens, b, self.width, self.height, self.ncomp,
            _ptrs(bitmaps), _ptrs(vals), caps, strides, _ptrs(quants), nnz.ctypes.data,
            rcs.ctypes.data, self.n_threads)
        if rc == _host.ERR_UNSUPPORTED:
            i = int(np.flatnonzero(rcs == rc)[0])
            raise UnsupportedError(f"jpeg: image {i} {_REFUSED}")
        if rc != 0:
            i = int(np.flatnonzero(rcs != 0)[0])
            raise FormatError(f"jpeg: native front-end failed on image {i} (rc={rc}; "
                              "a broken stream, or denser than the value capacity)")
        return Packed(buf, tuple(self.layout), b, self.width, self.height, tuple(self.hv),
                      self.mxx, self.myy, self.perm_y, self.perm_c, nnz,
                      perm_ints=self.perm_ints)


@dataclass
class Packed:
    """A parsed batch: the flat buffer (u8 tensor, or numpy), its layout
    and the geometry the device half needs."""

    buffer: object
    layout: tuple
    batch: int
    width: int
    height: int
    hv: tuple
    mxx: int
    myy: int
    perm_y: object = None  # grid->stream int32 [nb_y], or None
    perm_c: object = None
    nnz: object = None  # nonzero values a component int64 [B, 3] (native) or [B, ncomp]
    # K6's arm: gray, ycbcr, rgb, ycck or cmyk (None: gray or ycbcr by the
    # component count, as the native front-end gives them)
    color: str | None = None
    # the cmyk arm's 2x2-subsampled components (reference batch.py:743)
    sub: tuple | None = None
    # (y, chroma): the stream_perm ints perm_y and perm_c were made from
    # (None for grid order), or None where the perms came as arrays
    perm_ints: tuple | None = None

    def __post_init__(self):
        if self.color is None:
            self.color = "gray" if len(self.hv) == 1 else "ycbcr"

    @property
    def ratio(self) -> str:
        return _ratio(self.hv)

    @property
    def dims(self):
        """Per component its block grid (bv, bh)."""
        return [(self.myy * v, self.mxx * h) for h, v in self.hv]

    @property
    def perms(self):
        """Per component its grid->stream map (chroma share one): the
        stream_perm ints where the plan has them, else the arrays."""
        py, pc = self.perm_ints or (self.perm_y, self.perm_c)
        return [py] + [pc] * (len(self.hv) - 1)

    def images(self, lo: int, hi: int, *, pin: bool = False) -> "Packed":
        """Images [lo, hi) of the batch in a flat buffer of their own (each
        section holds the batch's rows, so theirs are one run of it),
        pinned with ``pin``; the batch itself where that is all of it."""
        if (lo, hi) == (0, self.batch):
            return self
        b = hi - lo
        src = self.buffer.numpy() if isinstance(self.buffer, torch.Tensor) else np.asarray(
            self.buffer, np.uint8)
        layout, off = [], 0
        for kind, c, _o, nbytes in self.layout:
            n = nbytes // self.batch * b
            layout.append((kind, c, off, n))
            off += (n + 63) // 64 * 64
        buf = torch.zeros(off, dtype=torch.uint8, pin_memory=pin)
        dst = buf.numpy()
        for (_k, _c, so, nbytes), (_k2, _c2, do, n) in zip(self.layout, layout):
            row = nbytes // self.batch
            dst[do : do + n] = src[so + lo * row : so + hi * row]
        return replace(self, buffer=buf, layout=tuple(layout), batch=b,
                                   nnz=None if self.nnz is None else self.nnz[lo:hi])


def parse_and_pack(data: bytes):
    """One image through the Python front-end -> (FrontEndResult, per
    component its (bitmap [nb, 8] u8, values int16[nnz]) in grid order).
    The dense grids are dropped once packed."""
    fe = parse_coefficients(data)
    if fe.color == "cmyk?":
        return fe, None  # refused below, once the batch is checked
    for c, coeff in enumerate(fe.coeffs):
        if coeff is None:
            raise FormatError(f"jpeg: component {c} has no scan")
    packs = [pack_sparse(coeff) for coeff in fe.coeffs]
    fe.coeffs = None
    return fe, packs


def packed_from_front_ends(parts, *, pin: bool = False) -> Packed:
    """parse_and_pack's results of one batch -> a Packed batch in one flat
    buffer (``flat_layout``, perm None: the grids are in grid order),
    pinned with ``pin``.  Raises the reference's errors: ValueError for a
    batch of mixed geometry or colour, UnsupportedError for a 4-component
    stream with no Adobe marker."""
    fes = [fe for fe, _ in parts]
    f0 = fes[0]
    for fe in fes[1:]:
        if ((fe.width, fe.height, fe.ratio, fe.color) != (f0.width, f0.height, f0.ratio,
                                                          f0.color) or fe.hv != f0.hv):
            raise ValueError(_MIXED)
    if f0.color == "cmyk?":
        raise UnsupportedError("jpeg: unknown color model: 4-component color model")
    b, nc = len(parts), f0.ncomp
    hv = tuple((int(h), int(v)) for h, v in f0.hv)
    mxx, myy = _mcus(f0.width, f0.height, hv)
    nb = [mxx * h * myy * v for h, v in hv]
    nnz = np.array([[len(packs[c][1]) for c in range(nc)] for _, packs in parts], np.int64)
    caps = [min((max(1, int(nnz[:, c].max())) + 511) // 512 * 512, nb[c] * 64)
            for c in range(nc)]
    layout, nbytes = flat_layout(b, nb, caps)
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    for _, _, off, n in layout:  # the alignment gaps, so a batch's buffer is its own
        buf[off + n : (off + n + 63) // 64 * 64] = 0
    for c in range(nc):
        bm, vals, q = (carve(buf, layout, kind, c, b).numpy() for kind in ("bm", "val", "q"))
        for i, (fe, packs) in enumerate(parts):
            bitmap, v = packs[c]
            bm[i] = bitmap
            vals[i, : len(v)] = v
            vals[i, len(v):] = 0
            q[i] = fe.quants[c]
    color = "gray" if nc == 1 else f0.color
    sub = tuple(x != hv[0] for x in hv) if color == "cmyk" else None
    return Packed(buf, tuple(layout), b, f0.width, f0.height, hv, mxx, myy, nnz=nnz,
                  color=color, sub=sub)


def packed_from_arrays(buffer, layout, quants, perm_y, perm_c, *, width: int,
                       height: int, hv, batch: int) -> Packed:
    """A Packed batch from plain numpy arrays: a flat buffer with bitmap
    and value sections as ``layout`` gives them (zpix_tpu's
    NativeBatchFrontEnd buffer and layout fit), the quant rows [B, 64] per
    component, and the grid->stream perms.  The quant rows are appended
    as ``flat_layout``'s "q" sections."""
    buffer = np.asarray(buffer, np.uint8)
    layout = [tuple(x) for x in layout if x[0] != "q"]
    off = (buffer.shape[0] + 63) // 64 * 64
    parts = [buffer, np.zeros(off - buffer.shape[0], np.uint8)]
    for c, q in enumerate(quants):
        q = np.ascontiguousarray(q, np.int32).reshape(batch, 64)
        layout.append(("q", c, off, q.nbytes))
        parts.append(q.view(np.uint8).reshape(-1))
        off += q.nbytes
    hv = tuple((int(h), int(v)) for h, v in hv)
    mxx, myy = _mcus(width, height, hv)
    perm = lambda p: None if p is None else np.asarray(p, np.int32)  # noqa: E731
    return Packed(torch.from_numpy(np.concatenate(parts)), tuple(layout), batch,
                  int(width), int(height), hv, mxx, myy, perm(perm_y), perm(perm_c))


# ---------------------------------------------------------------- device half


def unpack_flat(buffer, layout, *, batch: int, dims, perms):
    """K7 over every component of a flat buffer, one launch -> grids [B,
    bv, bh, 64] int16.  ``dims``: per component its grid (bv, bh);
    ``perms``: its grid->stream map or None."""
    return _sparse.unpack_components(
        _sparse.SparseComponent(carve(buffer, layout, "bm", c, batch),
                                carve(buffer, layout, "val", c, batch), bv, bh, perm)
        for c, ((bv, bh), perm) in enumerate(zip(dims, perms)))


def decode_batch_planes(grids, quants, *, color: str, height: int, width: int,
                        ratio: str | None = None, sub=None):
    """K6 on coefficient grids (int16 [B, bv, bh, 64]) and quant rows
    (int32 [B, 64]), for one of zpix_tpu's batch.py colour graphs:
    ``ratio`` gives the chroma replication of ycbcr, rgb and ycck, ``sub``
    marks the cmyk arm's 2x2-subsampled components."""
    n = len(grids)
    if color == "gray":
        factors = [(1, 1)]
    elif color == "cmyk":
        factors = [(2, 2) if s else (1, 1) for s in sub]
    else:
        f = RATIO_FACTORS[ratio]
        factors = [(1, 1), f, f] + [(1, 1)] * (n - 3)
    return _planes.component_planes(grids, quants, color=color, height=height, width=width,
                                    factors=factors)


def decode_batch_ycbcr_to_rgb(cy, ccb, ccr, qy, qcb, qcr, *, height, width, ratio):
    """[B, bv, bh, 64] grids + [B, 64] quants -> interleaved RGB8 [B, H, W, 3]."""
    return decode_batch_planes([cy, ccb, ccr], [qy, qcb, qcr], color="ycbcr",
                               height=height, width=width, ratio=ratio)


def decode_batch_gray(cy, qy, *, height, width):
    return decode_batch_planes([cy], [qy], color="gray", height=height, width=width)


def decode_batch_ycbcr_packed(bm_y, v_y, bm_cb, v_cb, bm_cr, v_cr, qy, qcb, qcr, *,
                              height, width, ratio, by, bx, cby, cbx,
                              perm_y=None, perm_c=None):
    """Per-component bitmaps and values -> RGB8 [B, H, W, 3] (K7, then K6)."""
    grids = _sparse.unpack_components(
        _sparse.SparseComponent(bm, v, bv, bh, p)
        for bm, v, bv, bh, p in ((bm_y, v_y, by, bx, perm_y), (bm_cb, v_cb, cby, cbx, perm_c),
                                 (bm_cr, v_cr, cby, cbx, perm_c)))
    return decode_batch_ycbcr_to_rgb(*grids, qy, qcb, qcr, height=height, width=width,
                                     ratio=ratio)


def decode_batch_ycbcr_flat(buffer, qy, qcb, qcr, *, height, width, ratio, by, bx,
                            cby, cbx, layout, batch, perm_y=None, perm_c=None):
    """One flat u8 buffer (bitmap and value sections as ``layout`` gives
    them) + quant rows -> RGB8 [B, H, W, 3] (K7, then K6)."""
    grids = unpack_flat(buffer, layout, batch=batch, dims=[(by, bx), (cby, cbx), (cby, cbx)],
                        perms=[perm_y, perm_c, perm_c])
    return decode_batch_ycbcr_to_rgb(*grids, qy, qcb, qcr, height=height, width=width,
                                     ratio=ratio)


def upload(packed: Packed, device) -> torch.Tensor:
    """The flat buffer on ``device``: one copy, asynchronous from pinned
    memory."""
    buf = packed.buffer
    if not isinstance(buf, torch.Tensor):
        buf = torch.from_numpy(np.asarray(buf, np.uint8))
    return buf.to(device, non_blocking=True)


def decode_uploaded(buf: torch.Tensor, packed: Packed) -> torch.Tensor:
    """The flat buffer on the device -> pixels: K7 (every component), then K6."""
    grids = unpack_flat(buf, packed.layout, batch=packed.batch, dims=packed.dims,
                        perms=packed.perms)
    quants = [carve(buf, packed.layout, "q", c, packed.batch) for c in range(len(packed.hv))]
    return decode_batch_planes(grids, quants, color=packed.color, height=packed.height,
                               width=packed.width, ratio=packed.ratio, sub=packed.sub)


class BatchJpegDecoder:
    """Same-geometry JPEG batches through a host front-end, K7 and K6:
    bytes -> RGB8 [B, H, W, 3] (gray [B, H, W]; ycck and cmyk [B, H, W,
    4]) on the decoder's device, no sync.  ``prep`` (the front-end parse),
    ``upload`` (one copy) and ``run`` (the kernels) split ``decode``.

    Single-scan gray and YCbCr baseline batches take the native front-end
    (one C call); every other batch (RGB, YCCK, CMYK, multi-scan,
    progressive, mixed geometry) the Python front-end, an image a worker
    thread (``n_threads``, the C++ scan releasing the GIL; the pool lives
    until ``close``), and then the same upload and kernels.  Errors are
    the reference's: a batch of mixed geometry or colour raises
    ValueError, a 4-component stream with no Adobe marker
    UnsupportedError, a broken stream the host decoder's error.
    """

    # the route, and the step the JAX package times, under its name
    _ROUTE, _TIMERS = "jpeg_batch", {"prep": "front_end"}

    def __init__(self, *, device=None, n_threads: int | None = None, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.n_threads = n_threads
        self._upload = PinnedUpload(self.device)
        self._uploads = DeviceUploads(self._upload)
        self._front_ends: dict = {}  # geometry -> NativeBatchFrontEnd
        self._lock = threading.Lock()  # preps may run on several threads
        self._pool = None  # the Python front-end's workers, made on first use

    def _front_end(self, datas: list[bytes], sofs) -> tuple:
        """-> (geometry key, the cached native front-end for it)."""
        key = (tuple(sofs[0][:3]), tuple(sofs[0][3]), len(datas))
        with self._lock:
            fe = self._front_ends.get(key)
        if fe is None:
            fe = NativeBatchFrontEnd(datas[0], len(datas), self.n_threads,
                                     pin=self.device.type == "cuda")
            with self._lock:
                fe = self._front_ends.setdefault(key, fe)
        return key, fe

    def _parse_native(self, datas: list[bytes], sofs) -> Packed:
        key, fe = self._front_end(datas, sofs)
        try:
            with span("jpeg_batch.prep.parse"):
                return fe.parse(datas)
        except FormatError:
            # perhaps denser than the value capacity: once more with room
            # for every coefficient, kept only if that parses
            dense = NativeBatchFrontEnd(datas[0], len(datas), self.n_threads,
                                        pin=self.device.type == "cuda", dense=True)
            with span("jpeg_batch.prep.parse"):
                packed = dense.parse(datas)
            with self._lock:
                self._front_ends[key] = dense
            return packed

    def _parse_python(self, datas: list[bytes]) -> Packed:
        """The Python front-end: each image parsed and packed on a worker
        thread, then one flat buffer."""
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.n_threads or os.cpu_count() or 2)
            pool = self._pool
        with trace("jpeg_batch.python_front_end"):
            parts = list(pool.map(parse_and_pack, datas))
            packed = packed_from_front_ends(parts, pin=self.device.type == "cuda")
        metrics.count("jpeg_batch.python_front_end", len(datas))
        return packed

    def _parse(self, datas: list[bytes]) -> Packed:
        if not datas:
            raise ValueError("jpeg: empty batch")
        sofs = [_peek_sof(d) for d in datas]
        if (any(s is None or s[2] not in (1, 3) for s in sofs)
                or any(s != sofs[0] for s in sofs[1:])):
            return self._parse_python(datas)
        try:
            return self._parse_native(datas, sofs)
        except UnsupportedError:  # RGB, multi-scan, a sampling it does not take
            return self._parse_python(datas)
        except FormatError:
            # the native front-end failed even with room for every
            # coefficient: the Python front-end raises the reference's
            # error, or decodes, and then the refusal is counted
            packed = self._parse_python(datas)
            metrics.count("jpeg_batch.native_refused", len(datas))
            return packed

    def prep(self, datas: list[bytes]) -> Packed:
        """The host half: a front-end parse into a flat buffer of the
        batch's own."""
        with stage(self._ROUTE, "prep", self._TIMERS, images=len(datas)):
            packed = self._parse(datas)
        metrics.count("jpeg_batch.images", len(datas))
        metrics.count("jpeg_batch.megapixels", len(datas) * packed.width * packed.height / 1e6)
        return packed

    def upload(self, packed: Packed) -> torch.Tensor:
        """The flat buffer on the device, in one copy.  With a mesh, a list
        of (its run of images as a Packed, that run's buffer on its
        device) a batch position; ValueError where the mesh does not divide
        the batch."""
        with stage(self._ROUTE, "upload", self._TIMERS):
            if self.mesh is None:
                return self._upload.send(packed.buffer)
            out = []
            for dev, lo, hi in shard_bounds(self.mesh, packed.batch,
                                            f"jpeg: the batch ({packed.batch} images)"):
                part = packed.images(lo, hi, pin=dev.type == "cuda")
                out.append((part, self._uploads(dev).send(part.buffer)))
            return out

    def run(self, packed: Packed, buf: torch.Tensor) -> torch.Tensor:
        """K7, then K6, on the uploaded buffer -> pixels (``Sharded`` with a
        mesh, each run decoded on its own device)."""
        with stage(self._ROUTE, "run", self._TIMERS):
            if self.mesh is None:
                return decode_uploaded(buf, packed)
            return Sharded.stack(decode_uploaded(b, part) for part, b in buf)

    def decode(self, datas: list[bytes]) -> torch.Tensor:
        packed = self.prep(datas)
        return self.run(packed, self.upload(packed))

    def close(self) -> None:
        """Shut the Python front-end's worker threads down."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()
