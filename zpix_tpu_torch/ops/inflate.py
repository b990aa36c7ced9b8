"""K16, the LZ77 copy resolve: DEFLATE tokens -> the inflated bytes.

``inflate_resolve`` wraps K16 (csrc/inflate_resolve.cu), the port of
zpix_tpu/ops/inflate.py::resolve_tokens_jnp (:33) vmapped an image
(zpix_tpu/parallel/png_batch.py:498-500): the lengths summed a chunk of
tokens, then each image's output in tiles of ``tile`` bytes resolved in
order, every pointer in shared memory.  ``inflate_resolve_plain`` is
the same function in plain PyTorch, written as the JAX graph is: token
starts by an exclusive cumsum, each byte's token by searchsorted (side
"right", minus 1), a source pointer (pos for a literal, pos - dist for a
copy), pointer doubling to the fixed point, and a gather of the literals.
The dispatch takes it for CPU tensors only.

Tokens come from the host symbol-resolve pass (``runtime.host.
inflate_tokens``): lens and dists int32, lits u8, [B, NT], zero-length
padding after each image's last token.  Domain: lengths >= 1 summing to
``per``, 1 <= dist <= the bytes produced before the token.

``adler32_check`` wraps the zlib trailer check of K16's output
(csrc/adler32.cu; the JAX package checks no trailer on this route), with
``adler32_plain`` its plain version: RFC 1950's adler32 of each image's
bytes, A = 1 + sum d_i and B = n + sum (n - i) d_i, both mod 65521.  On
the card each image is cut into spans of ``ADLER_SPAN`` bytes, a CTA a
span, and the last CTA of an image adds its spans' terms
(``tests/_torch_png.py::adler32_span_terms`` is that arithmetic in numpy).
"""

from __future__ import annotations

import torch

from .. import runtime

SCAN_CHUNK = 4096  # tokens a chunk of K16's length sums (csrc/inflate_resolve.cu kChunk)
TILES = (8192, 16384, 32768)  # output bytes a tile of K16's resolve
TILE = 32768  # the default (the fastest of chip_smoke.py's sweep of TILES)
ADLER_MOD = 65521
ADLER_BAD = 2  # the bit adler32_check ORs into its flag on a mismatch
ADLER_SPAN = 65536  # bytes a CTA of the adler32 check (a power of two, 16 to 2^20)
ADLER_THREADS = 256  # threads a CTA (csrc/adler32.cu kThreads)


def doubling_rounds(per: int) -> int:
    """Rounds that always reach the fixed point: every chain is shorter
    than ``per``, and a round at least doubles each pointer's reach."""
    return max(1, (per - 1).bit_length())


def inflate_resolve_plain(lens, dists, lits, per: int):
    B = lens.shape[0]
    dev = lens.device
    ln = lens.to(torch.int64)
    starts = torch.cumsum(ln, 1) - ln  # the first byte of each token
    pos = torch.arange(per, dtype=torch.int64, device=dev).expand(B, per).contiguous()
    # Padded tokens start at the total (== per) > pos: never selected.
    tok = torch.searchsorted(starts, pos, right=True) - 1
    d = torch.gather(dists.to(torch.int64), 1, tok)
    src = torch.where(d > 0, pos - d, pos)
    val = torch.gather(lits, 1, tok)
    moved = torch.zeros(doubling_rounds(per), dtype=torch.int32, device=dev)
    for k in range(moved.numel()):  # ping-pong: nxt is a new tensor
        nxt = torch.gather(src, 1, src)
        if torch.equal(nxt, src):
            break
        moved[k] = 1
        src = nxt
    return torch.gather(val, 1, src), moved


def scratch_words(batch: int, nt: int, per: int, tile: int) -> int:
    """K16's scratch (csrc/inflate_resolve.cu zpix_inflate_resolve's layout):
    a ticket, a flag a tile, a length sum a chunk of tokens."""
    chunks, tiles = -(-nt // SCAN_CHUNK), -(-per // tile)
    return 1 + batch * tiles + batch * chunks


def inflate_resolve(lens, dists, lits, per: int, *, tile: int = TILE):
    """K16: lens, dists int32 and lits u8 [B, NT] (each row contiguous; rows
    may be strided views of a wider staging buffer) -> u8 [B, per];
    ``tile`` is the output bytes a tile on the card."""
    if lens.dtype != torch.int32 or dists.dtype != torch.int32 or lits.dtype != torch.uint8:
        raise TypeError("inflate resolve: expected int32 lens and dists, u8 lits")
    if lens.dim() != 2 or dists.shape != lens.shape or lits.shape != lens.shape:
        raise ValueError("inflate resolve: lens, dists and lits must be [B, NT]")
    if per < 1 or per >= 2**31:
        raise ValueError("inflate resolve: output size out of range")
    if tile not in TILES:
        raise ValueError(f"inflate resolve: tile {tile} not one of {TILES}")
    if lens.device.type == "cpu":
        return inflate_resolve_plain(lens, dists, lits, per)[0]
    runtime.require_cuda(lens, dists, lits, rows=True)
    if not lens.stride(0) == dists.stride(0) == lits.stride(0):
        raise ValueError("inflate resolve: lens, dists and lits must share a row stride")
    B, nt = lens.shape
    dev = lens.device
    scratch = torch.empty(scratch_words(B, nt, per, tile), dtype=torch.int32, device=dev)
    out = torch.empty(B, per, dtype=torch.uint8, device=dev)
    if B and nt:
        runtime.launch("inflate_resolve", dev, "zpix_inflate_resolve", "pppllpplli",
                       lens.data_ptr(), dists.data_ptr(), lits.data_ptr(), lens.stride(0), nt,
                       scratch.data_ptr(), out.data_ptr(), B, per, tile, kernels=2)
    return out


def adler32_plain(flat, want, bad):
    B, per = flat.shape
    d = flat.to(torch.int64)
    w = (per - torch.arange(per, dtype=torch.int64, device=flat.device)) % ADLER_MOD
    a = (1 + d.sum(1)) % ADLER_MOD
    b = (per + (w * d).sum(1)) % ADLER_MOD
    sums = (b << 16) | a
    mismatch = (sums != (want.to(torch.int64) & 0xFFFFFFFF)).any()
    bad |= ADLER_BAD * mismatch.to(torch.int32)
    return _as_int32(sums)


def _as_int32(x):
    """uint32 values held in int64 -> the same 32 bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def adler32_check(flat, want, bad):
    """flat u8 [B, per] (K16's output, contiguous), want int32 [B] (each
    image's zlib trailer, uint32 bits), bad int32 [1] -> the adler32 of
    each image's bytes, int32 [B] (uint32 bits); ORs ADLER_BAD into
    ``bad`` when any differs from ``want``."""
    if flat.dtype != torch.uint8 or want.dtype != torch.int32 or bad.dtype != torch.int32:
        raise TypeError("adler32: expected u8 bytes, int32 trailers and an int32 flag")
    if flat.dim() != 2 or tuple(want.shape) != (flat.shape[0],) or bad.numel() != 1:
        raise ValueError("adler32: bytes must be [B, per], trailers [B], the flag [1]")
    if flat.device.type == "cpu":
        return adler32_plain(flat, want, bad)
    runtime.require_cuda(flat, want, bad)
    B, per = flat.shape
    span = ADLER_SPAN
    if span < 16 or span > 1 << 20 or span & (span - 1):
        raise ValueError(f"adler32: span {span} not a power of two from 16 to 2^20")
    sums = torch.empty(B, dtype=torch.int32, device=flat.device)
    if B:
        scratch = torch.empty(adler32_scratch_words(B, per, span), dtype=torch.int32,
                              device=flat.device)
        runtime.launch("adler32", flat.device, "zpix_adler32_check", "plppplip",
                       flat.data_ptr(), per, want.data_ptr(), sums.data_ptr(), bad.data_ptr(), B,
                       span.bit_length() - 1, scratch.data_ptr())
    return sums


def adler32_scratch_words(batch: int, per: int, span: int) -> int:
    """The adler32 check's scratch (csrc/adler32.cu zpix_adler32_check's
    layout): a ticket an image, two terms a span (one empty span for
    per = 0)."""
    return batch + 2 * batch * max(1, -(-per // span))
