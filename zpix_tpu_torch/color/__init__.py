"""Exact integer color math, vectorized (the port's copy of zpix_tpu/color).

Re-implements the reference's fixed-point color conversions
(zpix src/color/color.zig) as vectorized int32 numpy ops so the
same constants/rounding apply to whole planes at once.  These conversions are
the *parity contract*: every constant and shift below must match the
reference bit-for-bit.
"""

from .convert import (
    ycbcr_to_rgb8,
    ycbcr_to_rgba16,
    rgb_to_ycbcr,
    rgb_to_cmyk,
    cmyk_to_rgba16,
    gray_coeff_luma,
)

__all__ = [
    "ycbcr_to_rgb8",
    "ycbcr_to_rgba16",
    "rgb_to_ycbcr",
    "rgb_to_cmyk",
    "cmyk_to_rgba16",
    "gray_coeff_luma",
]
