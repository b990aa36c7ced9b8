"""K23: QOI decoded on the card with no host pass, the speculative chunk
scan of zpix_tpu/parallel/qoi_batch.py::build_qoi_decode_fn (:158-565); a
CUDA kernel (csrc/qoi_spec.cu) and its plain PyTorch version.

Inputs: ``stream`` u8, the batch's op streams with their 8-byte padding
back to back at 8-byte aligned offsets (``parallel/qoi_batch.py::
prep_qoi_batch``), and int32 [B] per image its first op byte
(``starts``), the end of its op bytes (``ends``) and the end with the
padding (``raw_ends``).  Each image's ops are cut into ``n_chunks`` chunks
of ``chunk_bytes``; a chunk holds the ops that start in its bytes, from
its entry, the serial decode's state at its start.  Output: (RGBA u8 [B,
H, W, 4], ok 0-dim bool, rounds int32 [B]).  Pixels past an image's
emitted total repeat its final pixel (the stream-exhausted fill,
qoi_batch.py:495-511); pixels past H * W are not written.  ``ok`` is False
where an op reads past its image's padded end or a chunk holds more than
``ops_cap`` ops (zpix_tpu's rules), and where the kernel's passes hit
their cap (the most ops an image holds + 2, which only a fault reaches).

Both versions compute the pixels with depth logarithmic in the ops rather
than a round a chunk.  An op's length is its first byte's, so the op
boundaries follow with no pixel state; every op is then listed.  Each
op's pixel is an absolute value, its predecessor's plus a delta (DIFF,
LUMA, RUN; RGB keeps the alpha) or a copy of its source, the last earlier
op whose pixel hashed to its slot (INDEX): given the sources, every pixel
follows by pointer jumping (Wyllie's); the hashes of those pixels give the
sources again, and the two alternate until the sources settle (each pass
fixes at least the earliest wrong one; the fixed point is the serial
decode's).  The plain version finds the boundaries by Jacobi rounds over
the chunks and the sources by a sort; it returns its boundary rounds, one
count for the batch.  The kernel finds the boundaries by guesses and links
and the sources by per-tile last-writer tables (``sources_last_writer_plain``
mirrors it); it returns each image's passes, whose most is the plain
version's ``passes``.  The dispatch takes the plain version for CPU tensors
only.
"""

from __future__ import annotations

import torch

from .. import runtime
from .prog_spec import _chunks, entry_sources, fixed_point

_CHECK_EVERY = 16  # plain version: ops between checks that any lane is still running
TILE_OPS = 2048  # ops a tile of K23's passes (csrc/qoi_spec.cu kTile)


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


def sources_sorted(h, writer, t_idx, slot_of):
    """The plain version's sources: for each INDEX op (``t_idx``, bool [B, P])
    the last op before it in its row that is a ``writer`` and whose hash
    ``h`` is its slot ``slot_of`` (int64 [B, P]), -1 where none, found by a
    sort of (row, hash, op) keys and a search.  -> int64 [B, P], -1 off the
    INDEX ops."""
    B, P = h.shape
    dev = h.device
    k = torch.arange(P, device=dev)[None, :]
    row = torch.arange(B, device=dev)[:, None] * 64
    keys = torch.where(writer, (row + h) * P + k, B * 64 * P).reshape(-1).sort().values
    q = ((row + slot_of) * P + k).reshape(-1)
    at = torch.searchsorted(keys, q) - 1
    hit = keys[at.clamp(min=0)]
    ok_hit = (at >= 0) & (hit // P == q // P)
    return torch.where(t_idx & ok_hit.view(B, P), (hit % P).view(B, P), -1)


def sources_last_writer_plain(h, writer, t_idx, slot_of, tile: int = None):
    """``sources_sorted``'s function computed as K23's passes compute it
    (for the tests; the dispatch never takes it): tiles of ``tile`` ops,
    each tile's table of the last writer a slot, their exclusive max over
    the tiles (P2), in a tile each 32-op group's table and their exclusive
    max over the groups after the tile's carry, and inside a group the
    last writer before the op (P3's lane masks a slot)."""
    tile = tile or TILE_OPS
    B, P = h.shape
    dev = h.device
    NT = -(-P // tile)
    pad = NT * tile - P
    k = torch.arange(P, device=dev).expand(B, P)
    slots = torch.arange(64, device=dev)
    last = torch.where(writer[..., None] & (h[..., None] == slots), k[..., None], -1)
    last = torch.nn.functional.pad(last, (0, 0, 0, pad), value=-1)  # [B, NT * tile, 64]
    lanes = last.view(B, NT * tile // 32, 32, 64)
    groups = lanes.max(2).values  # each group's table
    tiles = groups.view(B, NT, tile // 32, 64).max(2).values

    def exclusive(x, dim):
        inc = x.cummax(dim).values
        return torch.cat([torch.full_like(inc.narrow(dim, 0, 1), -1),
                          inc.narrow(dim, 0, inc.shape[dim] - 1)], dim)

    carry = exclusive(tiles, 1)  # P2
    gpre = torch.maximum(exclusive(groups.view(B, NT, tile // 32, 64), 2), carry[:, :, None])
    best = torch.maximum(exclusive(lanes, 2), gpre.view(B, -1, 1, 64))  # [B, G, 32, 64]
    j = torch.nn.functional.pad(slot_of.clamp(0, 63), (0, pad)).view(B, -1, 32, 1)
    src = best.gather(3, j).view(B, -1)[:, :P]
    return torch.where(t_idx, src, -1)


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
        new_src = sources_sorted(h, real, t_idx, slot_of)  # every real op writes the index
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


def spec_decode(stream, starts, ends, raw_ends, *, n_chunks: int, chunk_bytes: int,
                ops_cap: int, height: int, width: int):
    """K23: the batch's op streams -> (rgba u8 [B, H, W, 4], ok 0-dim bool,
    rounds int32 [B]) on the stream's device."""
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
    return _spec_decode_cuda(stream, starts, ends, raw_ends, **kw)


def _spec_decode_cuda(stream, starts, ends, raw_ends, *, n_chunks: int, chunk_bytes: int,
                      ops_cap: int, height: int, width: int, stamps=None):
    """K23's launch on checked CUDA inputs.  ``stamps`` (int64 [n, 2] on the
    card, for tools/torch_spec_stages.py): the kernel writes (phase, the
    card's clock in ns) after each of its grid barriers, phases as
    csrc/qoi_spec.cu names them."""
    B = starts.shape[0]
    dev = stream.device
    L, cap = B * n_chunks, stream.shape[0]
    tpi = -(-n_chunks * chunk_bytes // TILE_OPS)
    out = torch.empty(B, height, width, 4, dtype=torch.uint8, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    chunk_words = torch.empty(14 * L, dtype=torch.int32, device=dev)
    gpos = torch.empty(8 * L, dtype=torch.int32, device=dev)
    maps = torch.empty(6 * L, dtype=torch.int32, device=dev)
    image_words = torch.empty(6 * B, dtype=torch.int32, device=dev)
    flags = torch.empty(3, dtype=torch.int32, device=dev)
    op_words = torch.empty(7 * cap, dtype=torch.int32, device=dev)
    meta = torch.empty(cap, dtype=torch.uint8, device=dev)
    node = torch.empty(cap, dtype=torch.int64, device=dev)
    tiles = torch.empty(2, B * tpi * 64, dtype=torch.int32, device=dev)
    runtime.launch("qoi_spec", dev, "zpix_qoi_spec", "p" * 18 + "i" * 6 + "ll",
                   stream.data_ptr(), starts.data_ptr(), ends.data_ptr(), raw_ends.data_ptr(),
                   out.data_ptr(), ok.data_ptr(), rounds.data_ptr(), chunk_words.data_ptr(),
                   gpos.data_ptr(), maps.data_ptr(), image_words.data_ptr(), flags.data_ptr(),
                   op_words.data_ptr(), meta.data_ptr(), node.data_ptr(), tiles[0].data_ptr(),
                   tiles[1].data_ptr(), 0 if stamps is None else stamps.data_ptr(),
                   0 if stamps is None else stamps.shape[0], B, n_chunks, chunk_bytes, ops_cap,
                   tpi, cap, height * width)
    return out, ok[0] != 0, rounds
