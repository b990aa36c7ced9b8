"""Camera-like frames for a JPEG configuration: the JAX bench's structured
field (``bench.py`` ``make_bench_jpeg``) at the configuration's width and
height, in NumPy, encoded by Pillow as the configuration states it.

Per frame, from ``(seed, index)``: a phase for the two sinusoid fields
(red carries per-pixel noise of 0..``noise_levels``-1 XORed in, green is
the transposed field, blue half the first plus 64).  The field keeps the
JAX bench's scale of 20 radians over 1,023 pixels on both axes."""

from __future__ import annotations

import io

import numpy as np

LOSSLESS = False  # decoded pixels follow the reference decoder, not the raster


def pixels(config: dict, params: dict, seed: int, index: int) -> np.ndarray:
    w, h = config["width"], config["height"]
    rng = np.random.default_rng([seed % 2**64, index])
    phase = rng.uniform(0.0, 2 * np.pi)
    x = np.arange(w, dtype=np.float32) * np.float32(20 / 1023)
    y = np.arange(h, dtype=np.float32) * np.float32(20 / 1023)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    base_t = (128 + 100 * np.sin(y[:, None] * np.cos(x[None, :]) + phase)).astype(np.uint8)
    noise = rng.integers(0, params["noise_levels"], (h, w), dtype=np.uint8)
    return np.stack([base ^ noise, base_t, base // 2 + 64], -1)


def encode(config: dict, params: dict, raster: np.ndarray) -> bytes:
    from PIL import Image

    sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[config["subsampling"]]
    kw = {}
    if config.get("restart_interval_mcus"):
        kw["restart_marker_blocks"] = config["restart_interval_mcus"]
    buf = io.BytesIO()
    Image.fromarray(raster).save(buf, format="JPEG", quality=config["quality"],
                                 subsampling=sub, optimize=False, progressive=False, **kw)
    return buf.getvalue()
