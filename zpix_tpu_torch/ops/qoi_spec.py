"""K23: QOI decoded on the card with no host pass, the speculative chunk
scan of zpix_tpu/parallel/qoi_batch.py::build_qoi_decode_fn (:158-565); a
CUDA kernel (csrc/qoi_spec.cu) and its plain PyTorch version.

Inputs: ``stream`` u8, the batch's op streams with their 8-byte padding
back to back at 8-byte aligned offsets (``parallel/qoi_batch.py::
prep_qoi_batch``), and int32 [B] per image its first op byte
(``starts``), the end of its op bytes (``ends``) and the end with the
padding (``raw_ends``).  Each image's ops are cut into ``n_chunks`` chunks
of ``chunk_bytes``; a lane decodes ops from its chunk's entry (byte,
previous pixel, 64-entry index) to the first op boundary at or past the
chunk's end, and the entries are the serial decode's states at the chunk
starts.  Output: (RGBA u8 [B, H, W, 4], ok 0-dim bool, rounds int32 [B]).
Pixels past an image's emitted total repeat its final pixel (the
stream-exhausted fill, qoi_batch.py:495-511); pixels past H * W are not
written.  ``ok`` is False where an op reads past its image's padded end,
where a chunk holds more than ``ops_cap`` ops, or where the rounds did
not settle (zpix_tpu's rules).

The plain version computes the same function another way, with depth
logarithmic in the ops rather than a round a chunk (K23's rounds repeat
where an index slot's value comes through a chain of earlier chunks: about
one round a chunk on the JAX bench's noise).  An op's length is its first
byte's, so the op boundaries alone settle in a few Jacobi rounds over the
chunks (a lane a chunk, an op an iteration), and a last scan lists every
op.  Each op's pixel is then an absolute value, its predecessor's plus a
delta (DIFF, LUMA, RUN; RGB keeps the alpha) or a copy of the last earlier
op whose pixel hashed to its slot (INDEX): given those sources, every pixel
follows by pointer jumping (Wyllie's prefix over the forest they make);
the hashes of those pixels give the sources again, and the two alternate
until the sources settle (each pass fixes at least the earliest wrong one;
the fixed point is the serial decode's).  The ops' (pixel, count) expand as
zpix_tpu expands them.  The dispatch takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from .. import runtime
from .prog_spec import _chunks, entry_sources, fixed_point

_CHECK_EVERY = 16  # plain version: ops between checks that any lane is still running


def _op_size(b1):
    return torch.where(b1 == 0xFE, 4, torch.where(b1 == 0xFF, 5, torch.where(b1 >> 6 == 2, 2, 1)))


def _pos_scan(s64, pos, ce, raw, rec=None):
    """Lanes from byte pos to the first op boundary at or past ce -> (exit
    pos, ops, bad: an op reading past its image's padded end stops the
    lane).  ``rec`` = (out int64 [n * M + 1], M): op j's first byte at
    lane * M + j."""
    pos = pos.clone()
    n, cap = pos.shape[0], s64.shape[0]
    lanes = torch.arange(n, device=pos.device)
    nops = torch.zeros_like(pos)
    bad = torch.zeros(n, dtype=torch.bool, device=pos.device)
    act = pos < ce
    step = 0
    while step % _CHECK_EVERY or bool(act.any()):
        step += 1
        size = _op_size(s64[pos.clamp(0, cap - 1)])
        over = act & (pos + size > raw)
        bad |= over
        act = act & ~over
        if rec is not None:
            out, M = rec
            out.scatter_(0, torch.where(act, lanes * M + nops.clamp(max=M - 1), out.shape[0] - 1),
                         torch.where(act, pos, 0))
        nops = nops + act
        pos = torch.where(act, pos + size, pos)
        act = act & (pos < ce)
    return pos, torch.zeros_like(pos), nops, bad


def _wyllie(ptr, acc):
    """Sums along each node's pointer path: ``ptr`` int64 [n + 1] (roots and
    the sentinel n point to n), ``acc`` [n + 1, c] (the sentinel's 0) ->
    each node's acc plus its successors' up to its root's, inclusive."""
    for _ in range(max(1, int(ptr.shape[0]).bit_length())):
        acc = acc + acc[ptr]
        ptr = ptr[ptr]
    return acc


def spec_decode_plain(stream, starts, ends, raw_ends, *, n_chunks: int, chunk_bytes: int,
                      ops_cap: int, height: int, width: int, stats: dict | None = None):
    """K23, plain -> (rgba u8 [B, H, W, 4], ok 0-dim bool, rounds int32 [B]:
    the op boundaries' Jacobi rounds, one count for the batch).  ``stats``
    gets the most ops a chunk holds (``chunk_ops``), the batch's ops
    (``ops``) and the source passes (``passes``)."""
    B, F = starts.shape[0], n_chunks
    dev = stream.device
    s64 = stream.to(torch.int64)
    cap = s64.shape[0]
    cs, ce = _chunks(starts, ends, F, chunk_bytes)
    raw = raw_ends.to(torch.int64).repeat_interleave(F)
    src = entry_sources(starts, ends, F, chunk_bytes)

    def scan(pos, _st, sel):
        return _pos_scan(s64, pos, ce[sel], raw[sel])

    pos, _, res, rounds, settled = fixed_point(scan, cs, torch.zeros_like(cs), src, F + 2)
    nops, bad = res[2], res[3]
    M = max(1, int(nops.max()))
    firsts = torch.zeros(B * F * M + 1, dtype=torch.int64, device=dev)
    _pos_scan(s64, pos, ce, raw, rec=(firsts, M))
    # the ops in stream order, after a virtual op 0: the initial pixel
    valid = (torch.arange(M, device=dev)[None, :] < nops[:, None]).view(B, F * M)
    n_img = valid.sum(1)
    P = int(n_img.max()) + 1
    slot = torch.where(valid, valid.cumsum(1), P)  # op index (1-based), P: dropped
    op_pos = torch.zeros(B, P + 1, dtype=torch.int64, device=dev)
    op_pos.scatter_(1, slot, firsts[:-1].view(B, F * M))
    op_pos = op_pos[:, :P]
    k = torch.arange(P, device=dev)[None, :]
    real = (k >= 1) & (k <= n_img[:, None])
    byte = [s64[(op_pos + i).clamp(0, cap - 1)] for i in range(5)]
    b1 = byte[0]
    is_rgb, is_rgba = real & (b1 == 0xFE), real & (b1 == 0xFF)
    lit = real & ~(is_rgb | is_rgba)
    t_idx, t_diff, t_luma, t_run = (lit & (b1 >> 6 == i) for i in range(4))
    dg = (b1 & 63) - 32
    luma = (dg + ((byte[1] >> 4) & 15) - 8, dg, dg + (byte[1] & 15) - 8)
    d_rgb = torch.stack([torch.where(t_diff, ((b1 >> sh) & 3) - 2, torch.where(t_luma, d, 0))
                         for sh, d in zip((4, 2, 0), luma)], -1)
    abs_rgb = torch.where((is_rgb | is_rgba)[..., None], torch.stack(byte[1:4], -1), 0)
    abs_a = torch.where(is_rgba, byte[4], torch.where(k == 0, 255, 0))
    n = B * P
    flat = (torch.arange(B, device=dev)[:, None] * P + k)  # [B, P] global op index
    prev = torch.where(real, flat - 1, n)
    rel = t_diff | t_luma | t_run  # rgb from the previous op
    keep_a = is_rgb | rel  # alpha from the previous op
    slot_of = b1 & 63
    cand = torch.where(real, 0, 1)  # ops that write the index (sort keys below)
    src = torch.full((B, P), -1, dtype=torch.int64, device=dev)
    sentinel_rgb = torch.zeros(1, 3, dtype=torch.int64, device=dev)
    sentinel_a = torch.zeros(1, 1, dtype=torch.int64, device=dev)
    passes = 0
    while True:
        passes += 1
        has = t_idx & (src >= 0)
        to = torch.where(has, flat - k + src, n)
        ptr_rgb = torch.where(rel, prev, to).reshape(-1)
        ptr_a = torch.where(keep_a, prev, to).reshape(-1)
        ptr_rgb = torch.cat([torch.where(ptr_rgb == n, n, ptr_rgb), ptr_rgb.new_tensor([n])])
        ptr_a = torch.cat([ptr_a, ptr_a.new_tensor([n])])
        rgb = _wyllie(ptr_rgb, torch.cat([torch.where(rel[..., None], d_rgb, abs_rgb)
                                          .reshape(n, 3), sentinel_rgb])) & 255
        a = _wyllie(ptr_a, torch.cat([torch.where(keep_a | has, 0, abs_a).reshape(n, 1),
                                      sentinel_a])) & 255
        px = torch.cat([rgb[:n], a[:n]], 1).view(B, P, 4)
        h = (px[..., 0] * 3 + px[..., 1] * 5 + px[..., 2] * 7 + px[..., 3] * 11) & 63
        key = torch.where(cand == 0, ((torch.arange(B, device=dev)[:, None] * 64 + h) * P + k),
                          B * 64 * P).reshape(-1)
        keys = key.sort().values
        q = ((torch.arange(B, device=dev)[:, None] * 64 + slot_of) * P + k).reshape(-1)
        at = torch.searchsorted(keys, q) - 1
        hit = keys[at.clamp(min=0)]
        ok_hit = (at >= 0) & (hit // P == q // P)
        new_src = torch.where(t_idx & ok_hit.view(B, P), (hit % P).view(B, P), -1)
        if torch.equal(new_src, src):
            break
        src = new_src
    packed = (px[..., 0] << 24) | (px[..., 1] << 16) | (px[..., 2] << 8) | px[..., 3]
    count = torch.where(real, torch.where(t_run, (b1 & 63) + 1, 1), 0)
    npx = height * width
    cum = count.cumsum(1)
    g = torch.arange(npx, device=dev).expand(B, npx).contiguous()
    op = torch.searchsorted(cum, g, right=True).clamp(max=P - 1)
    fill = packed.gather(1, n_img[:, None])
    out = torch.where(g < cum[:, -1:], packed.gather(1, op), fill)
    ok = torch.tensor(settled, device=dev) & ~bad.any() & (nops <= ops_cap).all()
    if stats is not None:
        stats.update(chunk_ops=M, ops=int(n_img.sum()), passes=passes)
    rgba = torch.stack([(out >> sh) & 255 for sh in (24, 16, 8, 0)], -1).to(torch.uint8)
    return (rgba.view(B, height, width, 4), ok,
            torch.full((B,), rounds, dtype=torch.int32, device=dev))


_chunk_bytes_c = None


def spec_decode(stream, starts, ends, raw_ends, *, n_chunks: int, chunk_bytes: int,
                ops_cap: int, height: int, width: int):
    """K23: the batch's op streams -> (rgba u8 [B, H, W, 4], ok 0-dim bool,
    rounds int32 [B]) on the stream's device."""
    global _chunk_bytes_c
    B = starts.shape[0]
    if stream.dtype != torch.uint8 or any(t.dtype != torch.int32 or t.shape != (B,)
                                          for t in (starts, ends, raw_ends)):
        raise TypeError("qoi_spec: a u8 stream and int32 [B] starts, ends, raw ends")
    if n_chunks < 1 or chunk_bytes < 1 or ops_cap < 1 or stream.shape[0] >= 1 << 31:
        raise ValueError("qoi_spec: chunks, chunk bytes and ops_cap of at least 1, a stream "
                         "under 2 GiB")
    kw = dict(n_chunks=n_chunks, chunk_bytes=chunk_bytes, ops_cap=ops_cap, height=height,
              width=width)
    if stream.device.type == "cpu":
        return spec_decode_plain(stream, starts, ends, raw_ends, **kw)
    runtime.require_cuda(stream, starts, ends, raw_ends)
    dev = stream.device
    if _chunk_bytes_c is None:
        _chunk_bytes_c = runtime.fn("zpix_qoi_spec_chunk_bytes", "")()
    out = torch.empty(B, height, width, 4, dtype=torch.uint8, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    chunks = torch.empty(B * n_chunks * _chunk_bytes_c, dtype=torch.uint8, device=dev)
    runtime.launch("qoi_spec", dev, "zpix_qoi_spec", "p" * 8 + "iiiil",
                   stream.data_ptr(), starts.data_ptr(), ends.data_ptr(), raw_ends.data_ptr(),
                   out.data_ptr(), ok.data_ptr(), rounds.data_ptr(), chunks.data_ptr(), B,
                   n_chunks, chunk_bytes, ops_cap, height * width)
    return out, ok[0] != 0, rounds
