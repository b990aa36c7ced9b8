"""Synthetic QOI and BMP inputs for the zpix_tpu_torch tests.

Everything is made here from numpy seeds, through the port's own host
encoder (``zpix_tpu_torch.codecs.qoi.encode``) and BMP writer
(``zpix_tpu_torch.codecs.bmp.encode``): no zpix_tpu import, so the GPU
tests run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

from zpix_tpu_torch.codecs.bmp.encode import encode as bmp_encode
from zpix_tpu_torch.codecs.qoi.encode import Desc, encode

BMP_BPPS = (1, 2, 4, 8, 24, 32)
BMP_INFOS = (40, 108, 124)


def qoi_images(w=40, h=24, seed=0):
    """Gradient (DIFF/LUMA chains), flat (RUN caps), palette (INDEX hits)
    and noise (RGB/RGBA literals), as tests/test_qoi_device.py makes them."""
    rng = np.random.default_rng(seed)
    grad = np.zeros((h, w, 4), np.uint8)
    grad[..., 3] = 255
    grad[..., :3] = (np.arange(w)[None, :, None] * 2 + np.arange(h)[:, None, None]).astype(
        np.uint8)
    flat = np.full((h, w, 4), 77, np.uint8)
    pal = np.zeros((h, w, 4), np.uint8)
    lut = rng.integers(0, 256, (7, 4), dtype=np.uint8)
    pal[:] = lut[(np.arange(h * w) % 7)].reshape(h, w, 4)
    noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    return [grad, flat, pal, noise]


def qoi_enc(img, channels=4) -> bytes:
    h, w = img.shape[:2]
    return encode(img, Desc(w, h, channels, 0))


def structured_pixels(rng, h, w, alpha=True):
    """RGBA [h, w, 4]: runs of 1 to 130 pixels (runs of 62 and 63 among
    them) of a few palette colours (INDEX hits), small steps from the
    previous pixel (DIFF/LUMA) and random colours (RGB/RGBA), so runs and
    buckets cross the device encoder's tile boundaries."""
    n = h * w
    pal = rng.integers(0, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    pal[0], pal[1] = 0xFF, 0
    px = np.empty(n, np.uint32)
    i = 0
    while i < n:
        run = int(rng.choice([1, 1, 2, 5, 61, 62, 63, 130]))
        c = pal[rng.integers(0, 5)] if rng.random() < 0.6 else np.uint32(rng.integers(0, 2**32))
        if rng.random() < 0.3 and i:
            c = np.uint32((int(px[i - 1]) + 0x01010100) & 0xFFFFFFFF)
        px[i : i + run] = c
        i += run
    if not alpha:
        px |= 0xFF
    rgba = np.stack([(px >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.uint8)
    return rgba.reshape(h, w, 4)


def encode_cases():
    """(pixels, channels) cases of the device encoder: every op class,
    alpha, 3 channels, tail flush, runs of 62, 63 and 124, single pixels,
    and images of several 1024-pixel tiles."""
    rng = np.random.default_rng(7)
    h, w = 24, 40
    av = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    av[..., 3] = rng.integers(0, 3, (h, w)) * 127
    tr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    tr[h // 2:] = 9
    cases = [(img, 4) for img in qoi_images() + [av, tr]]
    cases.append((qoi_images()[0][..., :3], 3))
    cases += [(np.full((1, 1, 4), 9, np.uint8), 4), (np.zeros((1, 1, 4), np.uint8), 4),
              (np.full((1, 62, 4), 7, np.uint8), 4), (np.full((1, 63, 4), 7, np.uint8), 4),
              (np.full((1, 124, 4), 7, np.uint8), 4),
              (np.full((1, 3, 4), [0, 0, 0, 255], np.uint8), 4)]
    cases += [(structured_pixels(rng, 37, 91), 4), (structured_pixels(rng, 64, 80), 4),
              (np.full((40, 100, 4), 5, np.uint8), 4)]  # one run over four tiles
    return cases


def lane_entries(rng, lanes, R, P):
    """Hand-built wide-form entries: random colours, spans that overlap,
    leave gaps, run past [0, P) or are empty -> cols u32, s, e int16."""
    cols = rng.integers(0, 2**32, (lanes, R), dtype=np.uint64).astype(np.uint32)
    s = rng.integers(-3, P + 3, (lanes, R)).astype(np.int16)
    e = (s + rng.integers(-2, P // 2 + 2, (lanes, R))).astype(np.int16)
    return cols, s, e


def p4_entries(rng, lanes, R):
    """Hand-built p4 granules: any bytes, so starts fall anywhere in 0-255."""
    return rng.integers(0, 256, (lanes, R * 4), dtype=np.uint8)


def record_entries(rng, B, rcap):
    """Hand-built records: counts 0-62, a third of them zero, anywhere in
    the records (about 21 pixels a record, so the total may fall short of
    the pixel count or pass it)."""
    cols = rng.integers(0, 2**32, (B, rcap), dtype=np.uint64).astype(np.uint32)
    cnts = rng.integers(0, 63, (B, rcap)).astype(np.uint8)
    cnts[rng.random((B, rcap)) < 0.33] = 0
    fill = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    return cols, cnts, fill


def bmp_image(rng, bpp, h, w, *, info=40, top_down=False, n_colors=None):
    """One random BMP of ``bpp``; paletted ones get ``n_colors`` entries
    (default 2^bpp) and indices that may pass them."""
    if bpp <= 8:
        n = n_colors or (1 << bpp)
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, 1 << bpp, (h, w), dtype=np.uint8)
        return bmp_encode(idx, bpp=bpp, info_len=info, top_down=top_down, palette=pal)
    c = 3 if bpp == 24 else 4
    pix = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return bmp_encode(pix, bpp=bpp, info_len=info, top_down=top_down)


def bmp_arms():
    """(bpp, info, top_down, short palette) of every K18 arm."""
    arms = []
    for bpp in BMP_BPPS:
        for info in BMP_INFOS:
            for top_down in (False, True):
                arms.append((bpp, info, top_down, False))
        if bpp <= 8:
            arms.append((bpp, 40, False, True))
    return arms


def bmp_batch(arm, h=7, w=13, batch=3, seed=0):
    bpp, info, top_down, short = arm
    rng = np.random.default_rng(seed)
    n = max(1, (1 << bpp) // 2 - 1) if short and bpp <= 8 else None
    return [bmp_image(rng, bpp, h, w, info=info, top_down=top_down, n_colors=n)
            for _ in range(batch)]
