"""The H100's peaks and the least time a piece of work can take on it.

A frozen copy of ``zpix_tpu_torch/utils/roofline.py``'s arithmetic
(``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``, ``bound_ms``), kept with the
benchmark so that a change to the program cannot move the yardstick.
Peaks of the H100 SXM (NVIDIA's data sheet, at its 700 W limit):

* HBM3                 3.35 TB/s
* int32 operations     33.5 Tops/s: an SM has half as many INT32 as FP32
                       lanes, so half of the 67 TFLOP/s float32 rate
                       outside the tensor cores, a multiply and an add
                       counting two
"""

from __future__ import annotations

CARD = "H100 SXM"
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """-> (the least time the card can take for ``nbytes`` moved and ``ops``
    int32 operations, in ms; "bytes" or "operations", whichever bounds it)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
