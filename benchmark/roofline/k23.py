"""The work of K23's function, QOI decode of a batch, counted from the
inputs alone (each file's header and op stream), so the same batch reads
the same work whatever implements it.

Bytes: each op stream read once (the file less its 14-byte header and
8-byte end padding) and each RGBA pixel written once (4 bytes).  The
operations (a table lookup, a few adds and a hash an op) are far under
the bytes' bound at 3.35 TB/s against 33.5 Tops/s, and are not counted.
"""

from __future__ import annotations

import struct

HEADER, PADDING = 14, 8


def bytes_moved(files) -> int:
    """The bytes the decode of ``files`` (QOI files' bytes) must move."""
    total = 0
    for data in files:
        _, w, h, _, _ = struct.unpack(">4sIIBB", data[:HEADER])
        total += len(data) - HEADER - PADDING + 4 * w * h
    return total
