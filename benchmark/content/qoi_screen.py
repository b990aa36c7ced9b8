"""Screenshot-like frames for a QOI configuration (RGB, or RGBA where it
has 4 channels): the JAX bench's "screen" content (``bench.py``
``make_bench_qoi``) at the configuration's width and height, in NumPy,
encoded by the benchmark's frozen QOI encoder.

Per frame, from ``(seed, index)``: ``panels`` flat panels of a random
colour (each side a 1/16 to 1/3 of the frame's), one horizontal gradient
band an eighth of the height (DIFF and LUMA chains), and ``speckle`` of
the pixels set to random colours (text-like).  Opaque."""

from __future__ import annotations

import numpy as np

LOSSLESS = True  # a decode gives back exactly ``pixels``


def pixels(config: dict, params: dict, seed: int, index: int) -> np.ndarray:
    w, h = config["width"], config["height"]
    rng = np.random.default_rng([seed % 2**64, index])
    px = np.zeros((h, w, config["channels"]), np.uint8)
    px[..., 3:] = 255
    for _ in range(params["panels"]):
        y, x = rng.integers(0, h), rng.integers(0, w)
        ph, pw = rng.integers(h // 16, h // 3), rng.integers(w // 16, w // 3)
        px[y:y + ph, x:x + pw, :3] = rng.integers(30, 226, 3)
    gy = rng.integers(0, h - h // 8)
    grad = np.linspace(40, 215, w).astype(np.uint8)
    px[gy:gy + h // 8, :, :3] = grad[None, :, None]
    m = rng.random((h, w), dtype=np.float32) < params["speckle"]
    px[..., :3][m] = rng.integers(0, 256, (int(m.sum()), 3))
    return px


def encode(config: dict, params: dict, raster: np.ndarray) -> bytes:
    from benchmark.native import qoi_encode

    return qoi_encode(raster, config["colorspace"])
