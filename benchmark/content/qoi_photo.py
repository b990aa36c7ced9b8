"""Photo-like frames for a QOI configuration (RGB, or RGBA where it has 4
channels): a smooth field with per-pixel noise, so that most ops are
QOI_OP_DIFF and QOI_OP_LUMA, as photographs give, encoded by the
benchmark's frozen QOI encoder.

Per frame, from ``(seed, index)``: each colour channel is the sum of two
plane waves with periods of ``period_px`` pixels or more and random
directions and phases (amplitude 96 in all), plus independent noise
uniform over ``-noise .. noise``, clipped to 0..255.  Opaque.  This is not
the JAX bench's "noise" content, which is QOI's worst case."""

from __future__ import annotations

import numpy as np

LOSSLESS = True  # a decode gives back exactly ``pixels``


def pixels(config: dict, params: dict, seed: int, index: int) -> np.ndarray:
    w, h = config["width"], config["height"]
    rng = np.random.default_rng([seed % 2**64, index])
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float32)
    px = np.empty((h, w, config["channels"]), np.uint8)
    px[..., 3:] = 255
    n = params["noise"]
    for c in range(3):
        field = np.full((h, w), 128, np.float32)
        for amp in (56, 40):
            theta = rng.uniform(0, 2 * np.pi)
            k = 2 * np.pi / (params["period_px"] * rng.uniform(1.0, 3.0))
            # sin(kx x + ky y + phase) as a sum of two outer products
            ax = np.float32(k * np.cos(theta)) * x + np.float32(rng.uniform(0, 2 * np.pi))
            by = np.float32(k * np.sin(theta)) * y
            field += amp * (np.cos(by)[:, None] * np.sin(ax)[None, :]
                            + np.sin(by)[:, None] * np.cos(ax)[None, :])
        field += rng.integers(-n, n + 1, (h, w), dtype=np.int8)
        px[..., c] = np.clip(field, 0, 255).astype(np.uint8)
    return px


def encode(config: dict, params: dict, raster: np.ndarray) -> bytes:
    from benchmark.native import qoi_encode

    return qoi_encode(raster, config["colorspace"])
