"""Synthetic JPEG inputs and shared helpers for the zpix_tpu_torch tests.

Every input is made here or in tests/_torch_jpeg_writer.py (re-exported
below) with Pillow from numpy seeds; no test of the port reads the
reference corpus.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image
from _torch_jpeg_writer import (  # noqa: F401  (the inputs the tests share)
    CODED_CASES, QUAD, _noise_jpeg, as_rgb_stream, coded_segments, damage_plan,
    encode_baseline, k1_k2_edges, move_scan, port_host_pixels, random_limits, synth_jpeg,
    synth_plain_jpeg, synth_ratio_jpeg)

torch.set_num_threads(2)  # the suite runs with several workers


def synth_cmyk(transform=None, w=40, h=24, seed=0, dri_blocks=3):
    """Pillow CMYK JPEG with a restart marker every ``dri_blocks`` MCUs (or
    none for None); ``transform`` patches the Adobe APP14 transform byte
    (2 = YCCK) so both 4-component arms share one entropy stream."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    kw = {} if dri_blocks is None else {"restart_marker_blocks": dri_blocks}
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG", quality=75, **kw)
    data = bytearray(buf.getvalue())
    if transform is not None:
        at = data.find(b"Adobe")
        data[at + 11] = transform
    return bytes(data)


def synth_rgb(w=40, h=24, seed=0, dri_blocks=3):
    """An RGB-colorspace JPEG: JFIF renamed away and component ids
    R, G, B in both SOF and SOS; a restart marker every ``dri_blocks``
    MCUs, or none for None."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    kw = {} if dri_blocks is None else {"restart_marker_blocks": dri_blocks}
    Image.fromarray(rgb).save(buf, format="JPEG", quality=75, subsampling=0, **kw)
    return as_rgb_stream(buf.getvalue())


ARMS = {
    "gray": lambda: synth_jpeg(mode="gray"),
    "ycbcr": lambda: synth_jpeg(mode="420"),
    "rgb": synth_rgb,
    "cmyk": lambda: synth_cmyk(None),
    "ycck": lambda: synth_cmyk(2),
}


def huffs_of(data: bytes):
    """(counts, vals) per (class, id) and per-component selectors, from
    the JAX package's header walk."""
    from zpix_tpu.parallel.device_entropy import _parse_headers

    _, _, huffs, _, sel, _, _ = _parse_headers(data)
    out = {}
    for k, t in huffs.items():
        counts = [t.max_codes[i] - t.min_codes[i] + 1 if t.max_codes[i] >= 0 else 0
                  for i in range(16)]
        out[k] = (counts, t.vals[: t.num_codes])
    return out, [(td, ta) for _, td, ta in sel]


def port_plan_from_jax(jplan, data: bytes):
    """The port's plan built from the JAX package's prep of ``data``."""
    from zpix_tpu_torch.parallel.device_entropy import plan_from_arrays

    huffs, sel = huffs_of(data)
    return plan_from_arrays(
        stream=jplan.stream, seg_bit_pos=jplan.seg_bit_pos, seg_n_mcu=jplan.seg_n_mcu,
        quants=jplan.quants, hv=jplan.hv, bpm=jplan.bpm, seg_mcus=jplan.seg_mcus,
        n_segs=jplan.n_segs, mxx=jplan.mxx, myy=jplan.myy, width=jplan.width,
        height=jplan.height, color=jplan.color, huffs=huffs, sel=sel,
    )


def host_pixels(data: bytes):
    """The host decoder's output in the device decoders' layout."""
    import zpix_tpu.codecs.jpeg as jpeg
    from zpix_tpu.color import ycbcr_to_rgb8

    img = jpeg.decode(data)
    if hasattr(img, "upsampled_cbcr"):
        cb, cr = img.upsampled_cbcr()
        return np.stack(ycbcr_to_rgb8(img.y, cb, cr), -1)
    return img.pix


def random_grids(rng, hv, mxx, myy, batch, lo=-1024, hi=1024):
    """Random int16 coefficient grids [B, myy*v, mxx*h, 64] per component,
    mostly zeros, as numpy arrays."""
    out = []
    for h, v in hv:
        g = rng.integers(lo, hi, (batch, myy * v, mxx * h, 64))
        g[rng.random(g.shape) < 0.7] = 0
        out.append(g.astype(np.int16))
    return out


def jax_native_lib():
    """zpix_tpu's native library.  Test workers may build it at the same
    time, and a worker that loads a half-written file marks it failed:
    retry the load for a while before giving up."""
    import time

    from zpix_tpu import runtime

    for _ in range(60):
        lib = runtime.get_lib()
        if lib is not None:
            return lib
        runtime._lib_failed = False
        time.sleep(1)
    raise RuntimeError("zpix_tpu's native library did not build")


def truncate_scan(data: bytes, n: int) -> bytes:
    """Drop n entropy bytes before EOI (never leaving half of a stuffed
    FF00 pair)."""
    body = data[:-2 - n]
    while body[-1] == 0xFF:
        body = body[:-1]
    return body + data[-2:]


def synth_progressive(w=64, h=48, mode="420", phase=0.0, quality=75, **kw):
    """Structured image with seeded noise -> progressive JPEG (Pillow
    writes libjpeg's standard script and optimised Huffman tables, so
    every image has its own tables)."""
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    base ^= np.random.default_rng(int(phase * 1000)).integers(0, 16, base.shape, dtype=np.uint8)
    buf = io.BytesIO()
    if mode == "gray":
        Image.fromarray(base, "L").save(buf, format="JPEG", quality=quality, progressive=True,
                                        **kw)
    else:
        rgb = np.stack([base, base[::-1], base // 2 + 32], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality, progressive=True,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
    return buf.getvalue()


def host_coeffs(data: bytes, n_scans: int):
    """The host Decoder's coefficients after the first ``n_scans`` scans:
    per component [bv, bh, 64] int32 natural order.  Later scans' entropy bytes are skipped, as
    zpix_tpu's _TailScanDecoder skips the first ones."""
    from zpix_tpu.codecs.jpeg.decoder import Decoder

    class _Prefix(Decoder):
        def __init__(self):
            super().__init__(data)
            self.collect_only = True
            self._scan_no = 0

        def process_sos(self, n: int) -> None:
            self._scan_no += 1
            if self._scan_no <= n_scans:
                super().process_sos(n)
                return
            if not self.img_allocated:  # zeros for an empty prefix
                h0, v0 = self.component[0].h, self.component[0].v
                self._make_img((self.width + 8 * h0 - 1) // (8 * h0),
                               (self.height + 8 * v0 - 1) // (8 * v0))
            for c in range(self.num_components):
                self._ensure_coeff(c)
            # skip the SOS header and the entropy bytes up to the next real
            # marker (stuffed FF00 and RSTs are entropy data)
            self.read_full(n)
            d, p = self.data, self.pos
            while p < len(d) - 1 and not (d[p] == 0xFF and d[p + 1] not in (0x00, 0xFF)
                                          and not 0xD0 <= d[p + 1] <= 0xD7):
                p += 1
            self.pos = p

    dec = _Prefix()
    dec.decode_inner(False)
    return [dec.coeff[c] for c in range(dec.num_components)]




def python_front_end_cases(w: int, h: int) -> dict:
    """name -> make(seed): each stream kind BatchJpegDecoder sends to its
    Python front-end (the GPU tests')."""
    return {
        "rgb_444": lambda s: synth_ratio_jpeg(((1, 1),) * 3, w, h, s, adobe=0),
        "rgb_420_dri": lambda s: synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), w, h, s, dri=4,
                                                  adobe=0),
        "ycck_444": lambda s: synth_ratio_jpeg(((1, 1),) * 4, w, h, s, adobe=2),
        "ycck_2211": lambda s: synth_ratio_jpeg(QUAD, w, h, s, adobe=2),
        "cmyk_444": lambda s: synth_ratio_jpeg(((1, 1),) * 4, w, h, s, adobe=0),
        "cmyk_2211": lambda s: synth_ratio_jpeg(QUAD, w, h, s, adobe=0),
        "multi_scan_420": lambda s: synth_ratio_jpeg(((2, 2), (1, 1), (1, 1)), w, h, s,
                                                     scans="separate"),
        "progressive_420": lambda s: synth_progressive(w, h, phase=s),
        "progressive_444": lambda s: synth_progressive(w, h, mode="444", phase=s),
        "progressive_gray": lambda s: synth_progressive(w, h, mode="gray", phase=s),
    }
