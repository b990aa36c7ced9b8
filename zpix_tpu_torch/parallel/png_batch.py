"""Batched PNG decode: host front-end -> card defilter and expansion.

The port of zpix_tpu/parallel/png_batch.py (:52-106, :325-608), by all
three of its front-ends:

- default: the host inflates (libdeflate with the IHDR's exact size, else
  ``zlib``) and defilters (csrc/host/defilter.cpp, straight into the pinned
  staging buffer); K17 expands on the card (ops/png.py).
- ``device_defilter=True``: the host inflates into the staging buffer; K15
  (ops/defilter.py) defilters the uploaded stream in place, then K17.
- ``device_inflate=True``: the host runs only the DEFLATE symbol resolve
  (csrc/host/inflate.cpp), writing its tokens into the staging buffer; K16
  (ops/inflate.py) resolves the LZ77 copies, then K15 and K17.
- Adam7, by any front-end: K15 and K17 a pass, K17 placing each pass on
  the canvas; the default front-end defilters Adam7 on the card, as the
  JAX package does.

Every route raises a FormatError where the host decoder does, on the same
bytes: an inflated stream too short for the IHDR and a filter type above 4
(checked on the host from the inflated bytes; with ``device_inflate`` the
size by the tokenizer and the filter types by K15's flag, read once a
call), and a corrupt zlib stream, its adler32 trailer included (with
``device_inflate``, a trailer cut short by the tokenizer and a wrong one by
the adler32 check of K16's output on the card, into the same flag).  The JAX batch path lets the first two
through on some routes and ``zlib.error`` escape (ROADMAP queue 3).  With ``mesh``, each
batch position uploads and runs the route's kernels on its equal run of
images (zpix_tpu's ``_shard`` of every stacked input), on its own device,
and the output is ``Sharded``.  Not ported: the ``ZPIX_DEVICE_*``
environment variables (the arguments decide), and the power-of-two token
padding, which bounds XLA recompiles: the upload pads each image's tokens
with zero-length ones to the batch's most, the same function.
"""

from __future__ import annotations

import ctypes
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..codecs.png.decode import (
    _BITS_PER_PIXEL,
    INTERLACING,
    PALETTE_NRGBA,
    SIGNATURE,
    _pass_dims,
    _State,
    _parse_ihdr,
    _parse_plte,
    _parse_trns,
    _walk_chunks,
)
from ..errors import FormatError, UnsupportedError
from ..ops.defilter import png_defilter
from ..ops.inflate import ADLER_BAD, adler32_check, inflate_resolve
from ..ops.png import ARMS, WHOLE, png_expand, row_bytes
from ..runtime import host
from ..utils import metrics, trace
from .device_entropy import PinnedUpload
from .mesh import DeviceUploads, Sharded, mesh_device

TOKEN_ALIGN = 4096  # token rows of the staging buffer grow in these steps
# zlib's message for a wrong adler32 trailer, as the host decoder gives it
ADLER_MESSAGE = "png: inflate failed: Error -3 while decompressing data: incorrect data check"


def _token_specs(B: int, cap: int) -> list:
    """The staging layout of the inflate route: lens and dists int32, lits
    u8, [B, cap] each, then the zlib trailers uint32 [B], in that order."""
    return [((B, cap), np.int32), ((B, cap), np.int32), ((B, cap), np.uint8),
            ((B,), np.uint32)]


def _zlib_failure(idat: bytes) -> FormatError:
    """The host decoder's error for a zlib stream that its inflate refuses."""
    try:
        zlib.decompress(idat)
    except zlib.error as e:
        return FormatError(f"png: inflate failed: {e}")
    return FormatError("png: inflate failed")


def _walk_idat(data: bytes):
    """Chunk walk: returns (state, concatenated IDAT, exact inflated size)."""
    if data[:8] != SIGNATURE:
        raise FormatError("png: invalid signature")
    st = _State()
    idat = bytearray()
    for ctype, payload in _walk_chunks(data):
        if ctype == b"IHDR":
            _parse_ihdr(st, payload)
        elif ctype == b"PLTE":
            _parse_plte(st, payload)
        elif ctype == b"tRNS":
            _parse_trns(st, payload)
        elif ctype == b"IDAT":
            idat += payload
    return st, bytes(idat), sum(ph * (1 + rb) for _p, _pw, ph, rb in _segments(st))


def _segments(st: _State):
    """(Adam7 pass or None, width, height, row bytes) of each segment of
    the inflated stream: the image, or its passes that hold pixels."""
    cd = st.color_depth
    if not st.interlace:
        return [(None, st.width, st.height, row_bytes(cd, st.width))]
    dims = [(p, *_pass_dims(st.width, st.height, p)) for p in range(7)]
    return [(p, pw, ph, row_bytes(cd, pw)) for p, pw, ph in dims if pw and ph]


def _check_filtered(st: _State, raw: np.ndarray) -> None:
    """The host decoder's checks of an inflated stream, segment by segment:
    enough bytes, then filter types 0-4 (its defilter's messages)."""
    off = 0
    for _p, _pw, ph, rb in _segments(st):
        need = ph * (1 + rb)
        have = max(0, min(need, len(raw) - off))
        if have < need:
            raise FormatError(f"png: not enough image data: have {have}, want {need}")
        if (raw[off : off + need : 1 + rb] > 4).any():
            raise FormatError("png: invalid filter type")
        off += need


def _inflate(st: _State, idat: bytes, expected: int, out=None):
    """Host inflate, checked: -> the stream (bytes, or ``out`` filled with
    its first ``expected`` bytes)."""
    raw = host.zlib_decompress_sized(idat, expected, out)
    if raw is None:
        try:
            raw = zlib.decompress(idat)
        except zlib.error as e:
            raise FormatError(f"png: inflate failed: {e}") from e
    arr = np.frombuffer(raw, np.uint8) if isinstance(raw, bytes) else raw
    _check_filtered(st, arr)
    if out is not None and arr is not out:
        out[:] = arr[:expected]
        return out
    return raw


def parse_filtered(data: bytes):
    """Chunk walk + inflate: returns (state, raw filtered bytes)."""
    st, idat, expected = _walk_idat(data)
    return st, _inflate(st, idat, expected)


def parse_tokens(data: bytes):
    """Chunk walk + DEFLATE symbol resolve, the host half of the two-pass
    inflate: returns (state, lens, dists, lits)."""
    st, idat, expected = _walk_idat(data)
    lens, dists, lits, out_bytes, _adler = host.inflate_tokens(idat, expected)
    if out_bytes != expected:
        raise FormatError("png: inflated size mismatch")
    return st, lens, dists, lits


def color_keys(states) -> np.ndarray | None:
    """tRNS colour keys [B, 3] int32 in the depth's native domain (-1 = no
    key, never matches), or None when no image has one."""
    if not any(st.use_transparent for st in states):
        return None
    key = np.full((len(states), 3), -1, np.int32)
    for i, st in enumerate(states):
        if not st.use_transparent:
            continue
        t, cd = st.transparent, st.color_depth
        if cd in ("g1", "g2", "g4", "g8"):
            key[i] = t[1]  # pre-scaled by _parse_trns
        elif cd == "g16":
            key[i] = (t[0] << 8) | t[1]
        elif cd == "tc8":
            key[i] = (t[1], t[3], t[5])
        elif cd == "tc16":
            key[i] = ((t[0] << 8) | t[1], (t[2] << 8) | t[3], (t[4] << 8) | t[5])
        else:  # pragma: no cover -- _parse_trns rejects these
            raise UnsupportedError(f"png: tRNS with {cd}")
    return key


def palettes(states) -> np.ndarray:
    """Per-image palettes [B, 256, 4] u8, premultiplied (tRNS entries are
    non-premultiplied), opaque black past the real palette (the reference
    auto-extends for out-of-range indices)."""
    pal = np.zeros((len(states), 256, 4), np.uint8)
    pal[:, :, 3] = 0xFF
    for i, st in enumerate(states):
        if st.palette is None:
            raise FormatError("png: missing PLTE before IDAT")
        p = st.palette.astype(np.uint32)
        is_n = st.palette_kinds == PALETTE_NRGBA
        a = p[:, 3:4]
        wide = p[:, :3] | (p[:, :3] << 8)
        pal[i, : len(p), :3] = np.where(is_n[:, None], ((wide * a) // 0xFF) >> 8, p[:, :3])
        pal[i, : len(p), 3] = p[:, 3]
    return pal


@dataclass
class PngPlan:
    """One batch after the host stage: the upload's arrays, filled in the
    decoder's pinned staging buffer."""

    st: _State  # the first image's (the batch shares geometry and depth)
    route: str  # "host", "defilter" or "inflate"
    main: list  # host: rows [B, H, row_bytes] u8; defilter: stream [B, per] u8;
    #             inflate: lens, dists int32 and lits u8 [B, cap], trailers uint32 [B]
    pal: np.ndarray | None  # [B, 256, 4] u8 (paletted depths)
    key: np.ndarray | None  # [B, 3] int32
    per: int  # inflated bytes an image
    nt: int = 0  # inflate: tokens a row that K16 reads (the batch's most)
    raw: np.ndarray | None = None  # host: the inflated streams [B, per], host memory

    @property
    def parts(self) -> list:
        return self.main + [a for a in (self.pal, self.key) if a is not None]


class BatchPngDecoder:
    """Same-shape batched PNG -> premultiplied RGBA8 [B, H, W, 4] on the
    decoder's device.  ``prep`` (host), ``upload`` (one pinned copy) and
    ``run`` (the kernels) split ``decode``.  One thread pool of
    ``n_threads`` walks and inflates the images for the decoder's life;
    ``close`` shuts it."""

    def __init__(self, n_threads: int | None = None, device_defilter: bool = False,
                 device_inflate: bool = False, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.n_threads = n_threads or os.cpu_count() or 2
        self.device_defilter = device_defilter
        # device_inflate subsumes device_defilter: the resolved bytes are
        # already on the card, so the filter recurrence runs there too
        self.device_inflate = device_inflate
        self._pool = ThreadPoolExecutor(self.n_threads)
        self._upload = PinnedUpload(self.device)
        self._uploads = DeviceUploads(self._upload)
        # the host route's inflate buffers: a prep takes one, its defilter
        # gives it back (preps may run on several threads at once)
        self._raws: list = []
        self._raws_lock = threading.Lock()
        self._tok_cap = None  # token rows of the staging buffer, from the last batch

    def close(self) -> None:
        """Shut the host stage's thread pool down."""
        self._pool.shutdown()

    def parse(self, datas: list[bytes]) -> PngPlan:
        """Chunk walks, then inflate (into the staging buffer, or the host
        buffer on the default route) or tokenize (into the staging buffer),
        an image a pool thread."""
        if not datas:
            raise ValueError("png: empty batch")
        with trace("png_batch.inflate"):
            plan = self._parse(datas)
        metrics.count("png_batch.images", len(datas))
        return plan

    def _parse(self, datas: list[bytes]) -> PngPlan:
        walked = list(self._pool.map(_walk_idat, datas))
        states = [w[0] for w in walked]
        st0 = states[0]
        for st in states[1:]:
            # interlace is part of the layout: per-pass framing differs
            if (st.width, st.height, st.color_depth, st.interlace) != (
                    st0.width, st0.height, st0.color_depth, st0.interlace):
                raise ValueError("batch images must share (width, height, depth, interlace)")
        cd = st0.color_depth
        if cd not in ARMS:
            raise UnsupportedError(f"png: batched path does not cover {cd}")
        B, per = len(datas), walked[0][2]
        key = color_keys(states)
        pal = palettes(states) if cd.startswith("p") else None
        if self.device_inflate:
            return self._tokenize(walked, pal, key)
        route = "defilter" if self.device_defilter or st0.interlace else "host"
        seg = _segments(st0)[0]
        main = ((B, st0.height, seg[3]) if route == "host" else (B, per), np.uint8)
        plan = self._plan(st0, route, [main], pal, key, per)
        if route == "host":
            with self._raws_lock:
                raw = self._raws.pop() if self._raws else np.empty(0, np.uint8)
            if raw.size < B * per:
                raw = np.empty(B * per, np.uint8)
            plan.raw = raw[: B * per].reshape(B, per)
        dst = plan.raw if route == "host" else plan.main[0]
        list(self._pool.map(lambda i: _inflate(states[i], walked[i][1], per, dst[i]), range(B)))
        return plan

    def _plan(self, st0, route, main_specs, pal, key, per) -> PngPlan:
        """A plan whose arrays are views of the staging buffer, the palette
        and key copied in."""
        specs = main_specs + [(a.shape, a.dtype) for a in (pal, key) if a is not None]
        views = self._upload.views(specs)
        n = len(main_specs)
        extra = iter(views[n:])
        plan = PngPlan(st0, route, views[:n], None if pal is None else next(extra),
                       None if key is None else next(extra), per)
        for dst, src in ((plan.pal, pal), (plan.key, key)):
            if src is not None:
                dst[:] = src
        return plan

    def _tokenize(self, walked, pal, key) -> PngPlan:
        """Tokens straight into the staging buffer, in rows of ``cap`` tokens
        (the last batch's most, with headroom; at first the most an image can
        hold).  Only the images that do not fit are tokenized again, at full
        room into arrays of their own; then the rows widen (``_widen``).
        K16 reads each row's first ``nt``."""
        B, per, st0 = len(walked), walked[0][2], walked[0][0]
        cap = min(self._tok_cap or per + 1, per + 1)
        plan = self._plan(st0, "inflate", _token_specs(B, cap), pal, key, per)

        def fill(i, out=None):
            toks = host.inflate_tokens(walked[i][1], per, out=out)
            if toks is not None and toks[4] is None:  # the trailer is cut short
                raise _zlib_failure(walked[i][1])
            if toks is not None and toks[3] != per:
                raise FormatError("png: inflated size mismatch")
            return None if toks is None else toks[:3] + toks[4:]

        toks = list(self._pool.map(lambda i: fill(i, [a[i] for a in plan.main[:3]]),
                                   range(B)))
        over = [i for i, t in enumerate(toks) if t is None]
        if over:
            for i, t in zip(over, self._pool.map(fill, over)):
                toks[i] = t
            plan = self._widen(plan, toks, pal, key)
        counts = [len(t[0]) for t in toks]
        plan.nt = max(counts)
        for i, n in enumerate(counts):
            plan.main[0][i, n : plan.nt] = 0  # zero-length padding
        plan.main[3][:] = [t[3] for t in toks]
        self._tok_cap = min(per + 1, -(-(plan.nt + plan.nt // 16) // TOKEN_ALIGN) * TOKEN_ALIGN)
        return plan

    def _widen(self, plan: PngPlan, toks, pal, key) -> PngPlan:
        """A plan whose token rows hold the batch's most tokens, in a staging
        buffer of its own, every image's tokens copied in: the images
        tokenized at full room from their own arrays, the others from the
        first plan's rows (which keep its buffer alive until the copy)."""
        B, per = len(toks), plan.per
        most = max(len(t[0]) for t in toks)
        cap = min(per + 1, -(-most // TOKEN_ALIGN) * TOKEN_ALIGN)
        wide = self._plan(plan.st, "inflate", _token_specs(B, cap), pal, key, per)
        for k in range(3):  # lens, dists, lits
            for i in range(B):
                src = toks[i][k]
                wide.main[k][i, : src.shape[0]] = src
        return wide

    def defilter(self, plan: PngPlan) -> None:
        """Default route: the host defilter (csrc/host/defilter.cpp, its own
        ``n_threads`` threads) from the inflated streams into the staging
        buffer's rows."""
        rows = plan.main[0]
        B, h, rb = rows.shape
        ptr = ctypes.c_void_p * B
        with trace("png_batch.defilter"):
            rc = host.lib().zpix_defilter_batch(
                ptr(*[plan.raw[i].ctypes.data for i in range(B)]), h, rb,
                (_BITS_PER_PIXEL[plan.st.color_depth] + 7) // 8,
                ptr(*[rows[i].ctypes.data for i in range(B)]), B, self.n_threads)
        raw = plan.raw if plan.raw.base is None else plan.raw.base
        plan.raw = None
        with self._raws_lock:
            self._raws.append(raw)
        if rc != 0:
            raise FormatError("png: invalid filter type")

    def prep(self, datas: list[bytes]) -> PngPlan:
        plan = self.parse(datas)
        if plan.route == "host":
            self.defilter(plan)
        return plan

    def upload(self, plan: PngPlan) -> list:
        """Everything the route sends (rows, stream or tokens, palettes,
        keys) -> device tensors, in one pinned copy; with a mesh, a list of
        those a batch position, each its run of images (ValueError where the
        mesh does not divide the batch)."""
        if self.mesh is None:
            return self._upload(plan.parts)
        return self._uploads.runs(self.mesh, plan.parts,
                                  f"png: the batch ({len(plan.parts[0])} images)")

    def run(self, plan: PngPlan, bufs, on_kernel=None):
        """The kernels -> (RGBA8 [B, H, W, 4], the flag int32 [1] of the
        inflate route, else None: 1 for a filter type above 4 (K15),
        ADLER_BAD for a wrong adler32 trailer).  ``on_kernel(name, args, kw,
        result)``, when given, is called after each kernel wrapper returns,
        with the wrapper's arguments (chip_smoke.py times each stage and
        holds each launch against its plain version through it).  With a
        mesh: (``Sharded`` pixels, a list of each position's flag, or
        None)."""
        if self.mesh is not None:
            outs = [self._run(plan, b, on_kernel) for b in bufs]
            bad = [o[1] for o in outs]
            return Sharded.stack(o[0] for o in outs), None if bad[0] is None else bad
        return self._run(plan, bufs, on_kernel)

    def _run(self, plan: PngPlan, bufs, on_kernel=None):
        def call(name, fn, *args, **kw):
            res = fn(*args, **kw)
            if on_kernel is not None:
                on_kernel(name, args, kw, res)
            return res

        st = plan.st
        cd = st.color_depth
        n = len(plan.main)
        pal = bufs[n] if plan.pal is not None else None
        key = bufs[-1] if plan.key is not None else None
        if plan.route == "host":
            return call("png_expand", png_expand, bufs[0], pal, key, cd=cd, width=st.width), None
        bad = None
        if plan.route == "inflate":
            lens, dists, lits = (b[:, : plan.nt] for b in bufs[:3])
            flat = call("inflate_resolve", inflate_resolve, lens, dists, lits, plan.per)
            bad = torch.zeros(1, dtype=torch.int32, device=flat.device)
            call("adler32", adler32_check, flat, bufs[3], bad)
        else:
            flat = bufs[0]
        B = flat.shape[0]
        bpp = (_BITS_PER_PIXEL[cd] + 7) // 8
        out = None
        if st.interlace:  # Adam7 passes tile the canvas: every pixel is written
            out = torch.empty(B, st.height, st.width, 4, dtype=torch.uint8, device=flat.device)
        off = 0
        for p, pw, ph, rb in _segments(st):
            seg = flat[:, off : off + ph * (1 + rb)].view(B, ph, 1 + rb)
            off += ph * (1 + rb)
            rows = call("png_defilter", png_defilter, seg[:, :, 1:], seg[:, :, 0], bpp=bpp,
                        bad=bad)
            px = call("png_expand", png_expand, rows, pal, key, cd=cd, width=pw, out=out,
                      place=WHOLE if p is None else INTERLACING[p])
        return px, bad

    def decode(self, datas: list[bytes]):
        plan = self.prep(datas)
        px, bad = self.run(plan, self.upload(plan))
        flags = 0  # one sync a call (a shard), after the kernels
        for b in [] if bad is None else bad if isinstance(bad, list) else [bad]:
            flags |= int(b.item())
        if flags & ADLER_BAD:  # the host decoder's inflate fails before its defilter
            raise FormatError(ADLER_MESSAGE)
        if flags:
            raise FormatError("png: invalid filter type")
        return px
