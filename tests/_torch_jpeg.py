"""Synthetic JPEG inputs and shared helpers for the zpix_tpu_torch tests.

Every input is made here with Pillow from numpy seeds; no test of the
port reads the reference corpus.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image

torch.set_num_threads(2)  # the suite runs with several workers


def synth_jpeg(w=48, h=32, mode="420", dri_blocks=2, phase=0.0, quality=60,
               restart_marker_rows=None):
    """Structured image -> baseline JPEG with restart markers."""
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    kw = {"restart_marker_rows": restart_marker_rows} if restart_marker_rows else {
        "restart_marker_blocks": dri_blocks}
    buf = io.BytesIO()
    if mode == "gray":
        Image.fromarray(base, "L").save(buf, format="JPEG", quality=quality, **kw)
    else:
        rgb = np.stack([base, base[::-1], base // 2 + 32], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
    return buf.getvalue()


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
    data = bytearray(buf.getvalue())
    at = data.find(b"JFIF\x00")
    data[at : at + 4] = b"XXXX"
    for marker, first in ((b"\xff\xc0", 10), (b"\xff\xda", 5)):
        p = data.find(marker)
        step = 3 if marker == b"\xff\xc0" else 2
        for i, cid in enumerate(b"RGB"):
            data[p + first + step * i] = cid
    return bytes(data)


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


def synth_plain_jpeg(w=48, h=32, mode="420", phase=0.0, quality=60):
    """Structured image -> baseline JPEG with no restart markers."""
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    buf = io.BytesIO()
    if mode == "gray":
        Image.fromarray(base, "L").save(buf, format="JPEG", quality=quality)
    else:
        rgb = np.stack([base, base[::-1], base // 2 + 32], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode])
    return buf.getvalue()


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


def _segments(data: bytes, marker: int):
    """The whole segments (marker included) of one kind, before SOS."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xDA:
        ln = (data[pos + 2] << 8) | data[pos + 3]
        if data[pos + 1] == marker:
            out.append(data[pos : pos + 2 + ln])
        pos += 2 + ln
    return out


def _codes(dht: bytes):
    """{(class, id): {symbol: (code, length)}} from DHT segments."""
    out, body = {}, dht[4:]
    while body:
        counts, o = body[1:17], 17
        table, code = {}, 0
        for ln, n in enumerate(counts, 1):
            for _ in range(n):
                table[body[o]] = (code, ln)
                code += 1
                o += 1
            code <<= 1
        out[(body[0] >> 4, body[0] & 15)] = table
        body = body[o:]
    return out


def encode_baseline(grids, hv, width, height):
    """Quantized coefficient grids (per component [myy*v, mxx*h, 64] int,
    natural order) -> a baseline YCbCr JPEG with sampling ``hv``, no
    restart markers, Pillow's quant and Huffman tables.  Pillow writes
    only 4:4:4, 4:2:2 and 4:2:0; this writes any ratio."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG

    template = synth_plain_jpeg(w=16, h=16, mode="444")
    dqt, dhts = b"".join(_segments(template, 0xDB)), _segments(template, 0xC4)
    codes = {}
    for seg in dhts:
        codes.update(_codes(seg))
    nc = len(hv)
    mxx, myy = grids[0].shape[1] // hv[0][0], grids[0].shape[0] // hv[0][1]
    bits, nbits = [], 0
    acc = 0

    def put(value, n):
        nonlocal acc, nbits
        acc, nbits = (acc << n) | (value & ((1 << n) - 1)), nbits + n
        while nbits >= 8:
            nbits -= 8
            byte = (acc >> nbits) & 0xFF
            bits.append(byte)
            if byte == 0xFF:
                bits.append(0)

    def sym(table, s, value=0, size=0):
        code, ln = codes[table][s]
        put(code, ln)
        if size:
            put(value if value > 0 else value + (1 << size) - 1, size)

    pred = [0] * nc
    for my in range(myy):
        for mx in range(mxx):
            for c, (h, v) in enumerate(hv):
                t = 0 if c == 0 else 1
                for j in range(h * v):
                    zz = np.asarray(grids[c][v * my + j // h, h * mx + j % h])[UNZIG]
                    diff = int(zz[0]) - pred[c]
                    pred[c] = int(zz[0])
                    s = abs(diff).bit_length()
                    sym((0, t), s, diff, s)
                    run = 0
                    for k in range(1, 64):
                        val = int(zz[k])
                        if val == 0:
                            run += 1
                            continue
                        while run > 15:
                            sym((1, t), 0xF0)
                            run -= 16
                        s = abs(val).bit_length()
                        sym((1, t), (run << 4) | s, val, s)
                        run = 0
                    if run:
                        sym((1, t), 0x00)
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)
    sof = bytes([0xFF, 0xC0, 0, 8 + 3 * nc, 8, height >> 8, height & 255, width >> 8,
                 width & 255, nc]) + b"".join(
        bytes([c + 1, h << 4 | v, 0 if c == 0 else 1]) for c, (h, v) in enumerate(hv))
    sos = bytes([0xFF, 0xDA, 0, 6 + 2 * nc, nc]) + b"".join(
        bytes([c + 1, 0x00 if c == 0 else 0x11]) for c in range(nc)) + bytes([0, 63, 0])
    return b"\xff\xd8" + dqt + sof + b"".join(dhts) + sos + bytes(bits) + b"\xff\xd9"


def synth_ratio_jpeg(hv, width=40, height=24, seed=0):
    """encode_baseline of random sparse coefficients at sampling ``hv``."""
    rng = np.random.default_rng(seed)
    mxx = (width + 8 * hv[0][0] - 1) // (8 * hv[0][0])
    myy = (height + 8 * hv[0][1] - 1) // (8 * hv[0][1])
    grids = []
    for h, v in hv:
        g = rng.integers(-40, 40, (myy * v, mxx * h, 64))
        g[rng.random(g.shape) < 0.8] = 0
        g[..., 0] = rng.integers(-300, 300, g.shape[:2])
        grids.append(g)
    return encode_baseline(grids, hv, width, height)


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
