"""Ragged-batch bucketing: decode a mixed corpus through one call.  The
port of zpix_tpu/parallel/bucketing.py on the port's batch decoders.

Every batch decoder wants same-geometry inputs, but a real corpus mixes
formats and sizes.  The planner probes each encoded image's header (no
pixel work), groups the list into a compatibility bucket a (codec,
geometry), decodes each bucket through its batch decoder on the card,
and sends to the host decoder whatever no batch path covers -- returning
premultiplied RGBA8 [H, W, 4] numpy arrays in input order (the
``rgba_pixels`` flatten, the reference's src/image/image.zig:103-130).

Bucket keys a codec (zpix_tpu's):

* PNG  -- (width, height, bit depth, colour type, interlace):
  ``BatchPngDecoder`` (host inflate and defilter, K17).
* JPEG -- (width, height, components, sampling, progressive).  Baseline,
  4-component included: ``BatchJpegDecoder`` (K7, K6); CMYK and YCCK
  planes then take the Color.toRGBA cmyk arm.  Progressive gray and
  YCbCr: ``OnchipProgressiveDecoder`` (K8-K11, K6).  Progressive
  4-component streams go to the host.
* QOI  -- (width, height): ``HostIndexQoiDecoder``, lane form (K12).
* BMP  -- (width, height, orientation, bpp, header version):
  ``BatchBmpDecoder`` (K18).

Routes, counted a image under ``decode_mixed.<route>`` in
``utils.metrics``: ``device``; ``host-small`` (a bucket under
``min_batch``); ``host-routed`` (a key no batch decoder covers);
``host-error`` (the batch decoder raised, or a progressive batch came
back with ``ok`` False: logged, then the host decoder, whose error is
the call's).  A ``RuntimeError`` -- a kernel that fails to build or to
launch, or the card's own -- is not a batch decoder's refusal of its
input: it propagates.

Three differences from zpix_tpu, on purpose: a progressive bucket is
split by ``script_key`` (geometry, scan script and tables) before it
reaches the decoder, so a mix of encoders decodes on the card a group a
script where zpix_tpu's batch raises into ``host-error`` (the same
pixels, other route counts); each decoder is built once a (kind,
device) and reused, until ``close``; and the BMP host decoder reads an
index past a short palette as (0, 0, 0, 0) (codecs/bmp/decode.py).
"""

from __future__ import annotations

import logging
import struct
import threading

import numpy as np

from ..codecs.bmp.decode import _read_header
from ..errors import UnknownFormat
from ..utils import metrics
from .bmp_batch import BatchBmpDecoder
from .batch import BatchJpegDecoder
from .device_entropy import resolve_device
from .png_batch import BatchPngDecoder
from .progressive_onchip import OnchipProgressiveDecoder, parse_progressive, script_key
from .qoi_batch import HostIndexQoiDecoder

_log = logging.getLogger("zpix_tpu_torch")

# ---------------------------------------------------------------------------
# Header probes -- magic bytes + just enough structure for a bucket key.
# ---------------------------------------------------------------------------


def _probe_png(data: bytes):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    # IHDR is required first (decoder.zig Stage machine); 8-byte chunk
    # header + 13-byte payload.
    if len(data) < 33 or data[12:16] != b"IHDR":
        return ("png", "host")
    w, h = struct.unpack(">II", data[16:24])
    depth, ctype, _, _, interlace = data[24:29]
    return ("png", w, h, depth, ctype, interlace)


def _probe_jpeg(data: bytes):
    if data[:2] != b"\xff\xd8":
        return None
    # Marker walk to the first SOF (decoder.zig:220-355 simplified to
    # length-skips; entropy data never precedes the first SOF).
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xFF:
            i += 1
            continue
        seglen = (data[i + 2] << 8) | data[i + 3]
        if m in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            p = i + 4
            if p + 6 > n:
                break
            h = (data[p + 1] << 8) | data[p + 2]
            w = (data[p + 3] << 8) | data[p + 4]
            ncomp = data[p + 5]
            hv = []
            q = p + 6
            for _ in range(ncomp):
                if q + 3 > n:
                    break
                hv.append(data[q + 1])
                q += 3
            return ("jpeg", w, h, ncomp, tuple(hv), m == 0xC2)
        i += 2 + seglen
    return ("jpeg", "host")  # undecodable header: let the host error


def _probe_qoi(data: bytes):
    if data[:4] != b"qoif" or len(data) < 14:
        return None
    w, h = struct.unpack(">II", data[4:12])
    return ("qoi", w, h)


def _probe_bmp(data: bytes):
    if data[:2] != b"BM":
        return None
    try:
        hh = _read_header(data)
        return ("bmp", hh[0], hh[1], hh[2], hh[3], hh[4])
    except Exception:
        return ("bmp", "host")


def probe_key(data: bytes):
    """Codec + compatibility bucket key for one encoded image."""
    for probe in (_probe_png, _probe_jpeg, _probe_qoi, _probe_bmp):
        key = probe(data)
        if key is not None:
            return key
    raise UnknownFormat("zpix: no codec matched the buffer")


def plan_buckets(buffers) -> dict:
    """Group buffer indices into compatibility buckets: key -> [idx]."""
    buckets: dict = {}
    for i, data in enumerate(buffers):
        buckets.setdefault(probe_key(data), []).append(i)
    return buckets


# ---------------------------------------------------------------------------
# Decoders: one a (kind, device), reused across calls
# ---------------------------------------------------------------------------

_MAKERS = {
    "png": lambda dev: BatchPngDecoder(device=dev),
    "jpeg": lambda dev: BatchJpegDecoder(device=dev),
    "progressive": lambda dev: OnchipProgressiveDecoder(device=dev),
    "qoi": lambda dev: HostIndexQoiDecoder(impl="lane", device=dev),
    "bmp": lambda dev: BatchBmpDecoder(device=dev),
}
_decoders: dict = {}
_decoders_lock = threading.Lock()


def decoder(kind: str, device):
    """The router's decoder of ``kind`` on ``device``, built on first use."""
    key = (kind, device)
    with _decoders_lock:
        dec = _decoders.get(key)
        if dec is None:
            dec = _decoders[key] = _MAKERS[kind](device)
    return dec


def close() -> None:
    """Shut the cached decoders' thread pools down and drop them; the next
    call builds new ones."""
    with _decoders_lock:
        decs = list(_decoders.values())
        _decoders.clear()
    for dec in decs:
        if hasattr(dec, "close"):
            dec.close()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _host_rgba(data: bytes) -> np.ndarray:
    from .. import from_buffer

    img = from_buffer(data)
    return np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4
    )


def _to_rgba(arr: np.ndarray) -> np.ndarray:
    """Normalize a batch decoder's output to [B, H, W, 4] RGBA8."""
    if arr.ndim == 3:  # gray planes [B, H, W]
        a = np.full(arr.shape + (1,), 255, np.uint8)
        g = arr[..., None]
        return np.concatenate([g, g, g, a], axis=-1)
    if arr.shape[-1] == 3:  # RGB -> opaque RGBA
        a = np.full(arr.shape[:-1] + (1,), 255, np.uint8)
        return np.concatenate([arr, a], axis=-1)
    return arr


def _cmyk_to_rgba(arr: np.ndarray) -> np.ndarray:
    """A batch of the host CMYKImage's planes [B, H, W, 4] -> RGBA8, the
    Color.toRGBA cmyk arm (color.zig:115-121)."""
    from ..color import cmyk_to_rgba16

    r, g, b = cmyk_to_rgba16(arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3])
    rgba = np.empty(arr.shape, np.uint8)
    rgba[..., 0] = r >> 8
    rgba[..., 1] = g >> 8
    rgba[..., 2] = b >> 8
    rgba[..., 3] = 255
    return rgba


def _batched(kind: str, key, datas: list[bytes], device) -> list:
    """One batch decode on the card, its tensor copied to the host once."""
    arr = decoder(kind, device).decode(datas).cpu().numpy()
    if kind == "jpeg" and key[3] == 4:
        return list(_cmyk_to_rgba(arr))
    return list(_to_rgba(arr))


def _progressive(key, datas: list[bytes], device) -> tuple:
    """A progressive gray or YCbCr bucket, parsed once and split by
    ``script_key``: a decode a group of one script.  A group whose ``ok``
    is False goes to the host (logged, route host-error)."""
    dec = decoder("progressive", device)
    plans = [parse_progressive(d) for d in datas]
    groups: dict = {}
    for i, p in enumerate(plans):
        groups.setdefault(script_key(p), []).append(i)
    outs: list = [None] * len(datas)
    routes: dict = {}
    for idxs in groups.values():
        px, ok = dec.run(dec.prep_plans([plans[i] for i in idxs]))
        if bool(ok):
            got, route = list(_to_rgba(px.cpu().numpy())), "device"
        else:
            _log.warning(
                "decode_mixed: progressive device decode failed verification on "
                "a %d-image group (key=%r); host fallback", len(idxs), key)
            got, route = [_host_rgba(datas[i]) for i in idxs], "host-error"
        for i, o in zip(idxs, got):
            outs[i] = o
        routes[route] = routes.get(route, 0) + len(idxs)
    return outs, routes


def _decode_bucket(kind: str, key, datas: list[bytes], device, min_batch: int):
    """-> (RGBA8 list, {route: images}) for one bucket."""
    n = len(datas)
    if n < min_batch or "host" in key:
        return [_host_rgba(d) for d in datas], {
            "host-small" if "host" not in key else "host-routed": n}
    if kind == "jpeg" and key[5] and key[3] == 4:
        # no batch path for progressive CMYK/YCCK
        return [_host_rgba(d) for d in datas], {"host-routed": n}
    try:
        if kind == "jpeg" and key[5]:
            return _progressive(key, datas, device)
        return _batched(kind, key, datas, device), {"device": n}
    except RuntimeError:
        raise
    except Exception:
        _log.exception(
            "decode_mixed: batched %s decoder failed on a %d-image bucket "
            "(key=%r); falling back to the host decoder", kind, n, key)
        return [_host_rgba(d) for d in datas], {"host-error": n}


def decode_mixed(buffers, *, min_batch: int = 1, return_stats: bool = False, device=None):
    """Decode a mixed list of encoded images (any supported format, any
    geometry) -> list of premultiplied RGBA8 [H, W, 4] uint8 numpy arrays
    in input order.

    device: the batch decoders' device, ``cuda`` unless the caller passes
    ``"cpu"`` (each kernel's plain version); without a card the call
    raises.  min_batch: buckets smaller than this go to the host decoder.
    return_stats=True also returns {route: image count}; the same counts
    land in ``utils.metrics`` as decode_mixed.<route>."""
    device = resolve_device(device)
    buffers = list(buffers)
    results: list = [None] * len(buffers)
    stats: dict = {}
    for key, idxs in plan_buckets(buffers).items():
        outs, routes = _decode_bucket(key[0], key, [buffers[i] for i in idxs], device,
                                      min_batch)
        for route, n in routes.items():
            stats[route] = stats.get(route, 0) + n
            metrics.count(f"decode_mixed.{route}", n)
        for i, out in zip(idxs, outs):
            results[i] = np.asarray(out, np.uint8)
    if return_stats:
        return results, stats
    return results


def load_batch(paths, *, min_batch: int = 1, device=None):
    """decode_mixed over a list of file paths (one call for a real
    directory: the planner handles mixed formats and geometries)."""
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    return decode_mixed(bufs, min_batch=min_batch, device=device)
