"""Roofline accounting of the decode's kernels on the H100.

The port of zpix_tpu/utils/roofline.py: "is N MPix/s close to the card's
speed of light?" needs the bytes each stage must move and the operations
it must do, set against the card's peaks.  The counts are of the
functions, not of this port's kernels: each input read once, each output
written once, and the least arithmetic the function needs, so the same
batch reads the same work whatever implements it.  (zpix_tpu's model also
counts its TPU while-loop carries and unroll knobs; the port has neither.)

Peaks, H100 SXM (NVIDIA's data sheet):

* HBM3                 3.35 TB/s
* int32 operations     33.5 Tops/s: an SM has half as many INT32 as FP32
                       lanes, so half of the 67 TFLOP/s float32 rate
                       outside the tensor cores, a multiply and an add
                       counting two as in FLOP/s
* boost clock          1.98 GHz

A card whose power limit is set under its 700 W maximum runs slower under
load than these peaks assume; ``chip_smoke.py`` prints the card's name
and limit beside every time it measures.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.entropy import TAB_WORDS  # the packed tables' int32 words

CARD = "H100 SXM"
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
BOOST_HZ = 1.98e9

# The least arithmetic each function needs (multiplies, adds, shifts,
# compares), counted on the functions, not on this port's kernels:
# - a Huffman symbol through a 16-bit lookahead table: peek (shift, mask),
#   consume code and extra bits (two adds), next index, end test;
#   K2 adds RECEIVE/EXTEND (shift, mask, compare, add);
# - the Wang IDCT of a block: 8 row butterflies of 55 and 8 column
#   butterflies of 64 operations (zpix_tpu/ops/idct.py:192-239);
# - K4 per coefficient: dequant multiply, +128, two clamps; per pixel:
#   scale Y, four channel sums, three clamp-shifts of three operations;
#   per chroma pair: two -128 and four products (zpix_tpu/ops/ycbcr.py).
OPS_K1_SYMBOL, OPS_K2_SYMBOL = 6, 10
OPS_IDCT_BLOCK = 8 * 55 + 8 * 64
OPS_K4_BLOCK, OPS_K4_PIXEL, OPS_K4_CHROMA = OPS_IDCT_BLOCK + 64 * 4, 14, 6


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """-> (the least time the card can take for ``nbytes`` moved and
    ``ops`` int32 operations, in ms; "bytes" or "operations", whichever
    bounds it)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


@dataclass
class StageCost:
    name: str
    bytes_moved: float  # device memory traffic, bytes per batch
    int_ops: float  # int32 operations per batch

    @property
    def bound_ms(self) -> float:
        return bound_ms(self.bytes_moved, self.int_ops)[0]

    @property
    def bound_by(self) -> str:
        return bound_ms(self.bytes_moved, self.int_ops)[1]

    def line(self, ms: float | None) -> str:
        if not ms:
            return (f"{self.name:<18} {self.bytes_moved / 1e6:9.1f} MB "
                    f"{self.int_ops / 1e9:8.2f} Gop   bound {self.bound_ms:.4f} ms "
                    "(no time measured)")
        bw = self.bytes_moved / (ms * 1e-3)
        ops = self.int_ops / (ms * 1e-3)
        return (f"{self.name:<18} {ms:7.3f} ms  {bw / 1e9:7.1f} GB/s "
                f"({100 * bw / HBM_BYTES_PER_S:4.1f}% HBM)  {ops / 1e12:5.2f} Tops/s "
                f"({100 * ops / INT32_OPS_PER_S:4.1f}% INT32)  "
                f"bound {self.bound_ms:.4f} ms ({self.bound_by})")


def jpeg_onchip_costs(plan, *, stream_bytes: int | None = None, symbols: int = 0):
    """StageCosts of K1 (index pass), K2 (value pass), K3 (DC restore)
    and K4 (back-end) for one decode of ``plan`` (a
    ``parallel.device_entropy.ScanPlan``).  ``stream_bytes``: the entropy
    bytes the lanes read (default: the plan's whole stream buffer);
    ``symbols``: the Huffman symbols the batch holds (counted from a
    decode's output; 0 leaves the entropy passes' operations out).  The
    output is uint8, one byte a channel, in either layout."""
    B = plan.batch
    L1 = B * plan.n_segs
    L2 = L1 * plan.seg_mcus * plan.bpm
    stream = int(plan.stream.shape[0]) if stream_bytes is None else stream_bytes
    channels = {"gray": 1, "cmyk": 4, "ycck": 4}.get(plan.color, 3)
    out_bytes = B * plan.height * plan.width * channels
    # K1 reads the stream, each lane's offset and count, the tables, and
    # writes each block's end; K2 reads those and writes 64 int16 and one
    # int32 DC a block; K3 reads and writes each DC; K4 reads the rows,
    # the DCs and the tables and writes the pixels.
    k1 = stream + 8 * L1 + 4 * TAB_WORDS + 4 * L2
    k2 = k1 + 128 * L2 + 4 * L2
    return (
        StageCost("K1 index pass", k1, OPS_K1_SYMBOL * symbols),
        StageCost("K2 value pass", k2, OPS_K2_SYMBOL * symbols),
        StageCost("K3 DC restore", 8 * L2, L2),
        StageCost("K4 back-end", 128 * L2 + 4 * L2 + 4 * TAB_WORDS + out_bytes,
                  OPS_K4_BLOCK * L2 + OPS_K4_PIXEL * B * plan.height * plan.width
                  + OPS_K4_CHROMA * 64 * (L2 // plan.bpm)),
    )


def report(costs, times_ms, total_ms: float | None = None,
           link_bytes: float | None = None, link_ms: float | None = None) -> str:
    """Text block: one utilisation line a stage, the whole, and the
    host-to-device link."""
    lines = [f"roofline ({CARD} peaks: {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM3, "
             f"{INT32_OPS_PER_S / 1e12:.1f} Tops/s int32; counts of the functions)"]
    for c, ms in zip(costs, times_ms):
        lines.append("  " + c.line(ms))
    if total_ms:
        total = StageCost("TOTAL", sum(c.bytes_moved for c in costs),
                          sum(c.int_ops for c in costs))
        lines.append("  " + total.line(total_ms))
    if link_bytes and link_ms:
        bw = link_bytes / (link_ms * 1e-3) / 1e9
        lines.append(f"  {'link (H2D)':<18} {link_ms:7.3f} ms  {bw:7.2f} GB/s "
                     f"({link_bytes / 1e6:.1f} MB over PCIe)")
    return "\n".join(lines)
