"""Exact fixed-point 8x8 inverse DCT (Wang 1984) on numpy: the host JPEG
decoder's back-end.

The port's copy of zpix_tpu/ops/idct.py:41-161 (``_row_pass``,
``_col_pass``, ``idct_batch``), host code of the codec: no card path
calls it (K5, csrc/idct.cu, and the IDCT inside K4 and K6 are the
card's).  It reproduces the reference IDCT (zpix src/jpeg/idct.zig:77-201)
bit for bit: scaled constants w1..w7 = 2048*sqrt(2)*cos(k*pi/16), the
4-stage butterfly and every intermediate shift and round.  The
reference's short cut for rows whose AC coefficients are all zero
(idct.zig:84-97) gives the same numbers as the full butterfly, which runs
on every row here.
"""

from __future__ import annotations

import numpy as np

W1 = 2841  # 2048*sqrt(2)*cos(1*pi/16)
W2 = 2676  # 2048*sqrt(2)*cos(2*pi/16)
W3 = 2408  # 2048*sqrt(2)*cos(3*pi/16)
W5 = 1609  # 2048*sqrt(2)*cos(5*pi/16)
W6 = 1108  # 2048*sqrt(2)*cos(6*pi/16)
W7 = 565   # 2048*sqrt(2)*cos(7*pi/16)
W1PW7 = W1 + W7
W1MW7 = W1 - W7
W2PW6 = W2 + W6
W2MW6 = W2 - W6
W3PW5 = W3 + W5
W3MW5 = W3 - W5
R2 = 181  # 256/sqrt(2)


def _row_pass(s):
    """Horizontal 1-D IDCT on s[..., 8, 8] int32 (zpix src/jpeg/idct.zig:79-145).

    Returns the transformed rows.
    """
    c = np.int32

    x0 = (s[..., 0] << c(11)) + c(128)
    x1 = s[..., 4] << c(11)
    x2 = s[..., 6]
    x3 = s[..., 2]
    x4 = s[..., 1]
    x5 = s[..., 7]
    x6 = s[..., 5]
    x7 = s[..., 3]

    # Stage 1.
    x8 = c(W7) * (x4 + x5)
    x4 = x8 + c(W1MW7) * x4
    x5 = x8 - c(W1PW7) * x5
    x8 = c(W3) * (x6 + x7)
    x6 = x8 - c(W3MW5) * x6
    x7 = x8 - c(W3PW5) * x7

    # Stage 2.
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = c(W6) * (x3 + x2)
    x2 = x1 - c(W2PW6) * x2
    x3 = x1 + c(W2MW6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7

    # Stage 3.
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (c(R2) * (x4 + x5) + c(128)) >> c(8)
    x4 = (c(R2) * (x4 - x5) + c(128)) >> c(8)

    # Stage 4.
    return np.stack(
        [
            (x7 + x1) >> c(8),
            (x3 + x2) >> c(8),
            (x0 + x4) >> c(8),
            (x8 + x6) >> c(8),
            (x8 - x6) >> c(8),
            (x0 - x4) >> c(8),
            (x3 - x2) >> c(8),
            (x7 - x1) >> c(8),
        ],
        axis=-1,
    )


def _col_pass(s):
    """Vertical 1-D IDCT on s[..., 8, 8] int32 (idct.zig:148-200)."""
    c = np.int32

    y0 = (s[..., 0, :] << c(8)) + c(8192)
    y1 = s[..., 4, :] << c(8)
    y2 = s[..., 6, :]
    y3 = s[..., 2, :]
    y4 = s[..., 1, :]
    y5 = s[..., 7, :]
    y6 = s[..., 5, :]
    y7 = s[..., 3, :]

    # Stage 1.
    y8 = c(W7) * (y4 + y5) + c(4)
    y4 = (y8 + c(W1MW7) * y4) >> c(3)
    y5 = (y8 - c(W1PW7) * y5) >> c(3)
    y8 = c(W3) * (y6 + y7) + c(4)
    y6 = (y8 - c(W3MW5) * y6) >> c(3)
    y7 = (y8 - c(W3PW5) * y7) >> c(3)

    # Stage 2.
    y8 = y0 + y1
    y0 = y0 - y1
    y1 = c(W6) * (y3 + y2) + c(4)
    y2 = (y1 - c(W2PW6) * y2) >> c(3)
    y3 = (y1 + c(W2MW6) * y3) >> c(3)
    y1 = y4 + y6
    y4 = y4 - y6
    y6 = y5 + y7
    y5 = y5 - y7

    # Stage 3.
    y7 = y8 + y3
    y8 = y8 - y3
    y3 = y0 + y2
    y0 = y0 - y2
    y2 = (c(R2) * (y4 + y5) + c(128)) >> c(8)
    y4 = (c(R2) * (y4 - y5) + c(128)) >> c(8)

    # Stage 4.
    return np.stack(
        [
            (y7 + y1) >> c(14),
            (y3 + y2) >> c(14),
            (y0 + y4) >> c(14),
            (y8 + y6) >> c(14),
            (y8 - y6) >> c(14),
            (y0 - y4) >> c(14),
            (y3 - y2) >> c(14),
            (y7 - y1) >> c(14),
        ],
        axis=-2,
    )


def idct_batch(blocks: np.ndarray) -> np.ndarray:
    """2-D IDCT over [..., 8, 8] int32 blocks (numpy)."""
    s = blocks.astype(np.int32, copy=False)
    return _col_pass(_row_pass(s))

