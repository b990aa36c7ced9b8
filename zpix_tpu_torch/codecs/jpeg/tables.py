"""Huffman table construction and the zig-zag map.

The port's own copy of zpix_tpu/codecs/jpeg/tables.py: an 8-bit LUT fast
path (entry = value << 8 | code_length + 1; zpix
src/jpeg/decoder.zig:1070-1091), which the host decoder's Python scan and
the C++ scan's ``HuffTableC.lut`` read, and the canonical
min/max/value-index tables for code lengths 1..16 (T.81 C.2, the DHT
build at decoder.zig:1093-1109).  ``counts`` keeps the code counts for
the device decoders' table packing.
"""

from __future__ import annotations

import numpy as np

from ...errors import FormatError

MAX_CODE_LENGTH = 16
LUT_SIZE = 8
MAX_NUM_CODES = 256

# unzig[zig] = natural-order index of the zig-zag-order coefficient
# (zpix src/jpeg/decoder.zig:73-82).
UNZIG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    np.int32,
)


class HuffTable:
    __slots__ = ("num_codes", "counts", "lut", "vals", "min_codes", "max_codes",
                 "vals_indices")

    def __init__(self):
        self.num_codes = 0
        self.counts = [0] * MAX_CODE_LENGTH
        self.lut = [0] * 256
        self.vals = [0] * MAX_NUM_CODES
        self.min_codes = [-1] * MAX_CODE_LENGTH
        self.max_codes = [-1] * MAX_CODE_LENGTH
        self.vals_indices = [-1] * MAX_CODE_LENGTH

    def build(self, counts, vals) -> None:
        """counts[i] = number of codes with length i+1; vals = symbol bytes."""
        counts = [int(c) for c in counts]
        total = sum(counts)
        if total == 0:
            raise FormatError("jpeg: Huffman table has zero length")
        if total > MAX_NUM_CODES:
            raise FormatError("jpeg: Huffman table has excessive length")
        self.num_codes = total
        self.counts = counts
        self.vals[:total] = [int(v) for v in vals[:total]]

        # 8-bit LUT (decoder.zig:1070-1091).
        self.lut = [0] * 256
        code = 0
        val_index = 0
        for i in range(LUT_SIZE):
            code <<= 1
            for _ in range(counts[i]):
                base = code << (7 - i)
                lut_value = (self.vals[val_index] << 8) | (2 + i)
                for k in range(1 << (7 - i)):
                    self.lut[base | k] = lut_value
                code += 1
                val_index += 1

        # min/max/vals_indices (decoder.zig:1093-1109).
        code_base = 0
        index = 0
        for i, num in enumerate(counts):
            if num == 0:  # a table defined again keeps no stale length
                self.min_codes[i] = -1
                self.max_codes[i] = -1
                self.vals_indices[i] = -1
            else:
                self.min_codes[i] = code_base
                self.max_codes[i] = code_base + num - 1
                self.vals_indices[i] = index
                code_base += num
                index += num
            code_base <<= 1
