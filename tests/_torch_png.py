"""A PNG writer for the zpix_tpu_torch tests and chip_smoke.py: numpy, zlib
and struct only (no zpix_tpu import, so the GPU tests run where JAX is not
installed).

``encode_png`` writes any (colour type, bit depth) of the PNG spec, with a
filter type chosen per row and applied for real (all five filters), PLTE
(short palettes too) and tRNS, Adam7, IDAT split across chunks, and the
deflate modes stored (level 0), Z_FIXED, Z_RLE and default dynamic; it can
damage the file in five ways (``DAMAGE``).  ``random_pixels`` makes the
samples of a depth from a numpy generator.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# depth code -> (colour type, bit depth, samples a pixel)
DEPTHS = {"g1": (0, 1, 1), "g2": (0, 2, 1), "g4": (0, 4, 1), "g8": (0, 8, 1),
          "g16": (0, 16, 1), "tc8": (2, 8, 3), "tc16": (2, 16, 3), "p1": (3, 1, 1),
          "p2": (3, 2, 1), "p4": (3, 4, 1), "p8": (3, 8, 1), "ga8": (4, 8, 2),
          "ga16": (4, 16, 2), "tca8": (6, 8, 4), "tca16": (6, 16, 4)}
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]  # (x offset, y offset, x step, y step)
STRATEGIES = {"stored": (0, zlib.Z_DEFAULT_STRATEGY), "fixed": (6, zlib.Z_FIXED),
              "rle": (6, zlib.Z_RLE), "default": (6, zlib.Z_DEFAULT_STRATEGY)}
DAMAGE = ("crc", "short", "filter", "deflate", "adler")


def random_pixels(rng, cd: str, w: int, h: int, *, hi: int | None = None):
    """Samples [h, w] or [h, w, n] of depth ``cd``, uniform below 2^bits (or
    below ``hi``): uint8, or uint16 for 16-bit depths."""
    _ct, bits, n = DEPTHS[cd]
    top = hi if hi is not None else 1 << bits
    shape = (h, w) if n == 1 else (h, w, n)
    return rng.integers(0, top, shape).astype(np.uint16 if bits == 16 else np.uint8)


def pack_samples(pix, cd: str) -> np.ndarray:
    """Samples [h, w(, n)] -> scanline bytes [h, row_bytes], MSB first,
    16-bit big-endian, sub-byte rows padded with zero bits."""
    _ct, bits, n = DEPTHS[cd]
    h, w = pix.shape[:2]
    s = pix.reshape(h, w * n)
    if bits == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, w * n * 2)
    if bits == 8:
        return s.astype(np.uint8)
    per = 8 // bits
    rb = (w * bits + 7) // 8
    padded = np.zeros((h, rb * per), np.uint8)
    padded[:, :w] = s
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (padded.reshape(h, rb, per) << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, ftypes) -> np.ndarray:
    """Scanlines [h, rb] -> the filtered stream [h, 1 + rb] with row r's
    filter byte ftypes[r] (0-4 applied; others written as given, the row
    left as is)."""
    h, rb = rows.shape
    x = rows.astype(np.int32)
    out = np.empty((h, 1 + rb), np.uint8)
    prev = np.zeros(rb, np.int32)
    for r in range(h):
        cur = x[r]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:rb]
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:rb]
        f = int(ftypes[r])
        pred = {1: left, 2: prev, 3: (left + prev) >> 1, 4: _paeth(left, prev, ul)}.get(f, 0)
        out[r, 0] = f
        out[r, 1:] = (cur - pred) & 0xFF
        prev = cur
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(pix, cd: str, *, palette=None, trns: bytes | None = None,
               interlace: bool = False, filters=None, seed: int = 0,
               strategy: str = "default", idat_chunks: int = 1,
               damage: str | None = None) -> bytes:
    """A PNG of samples ``pix`` at depth ``cd``.  ``palette``: [n, 3] u8 PLTE
    entries; ``trns``: the tRNS payload; ``filters``: a filter type a row
    (cycled over each pass's rows) or None for a seeded random choice of
    0-4; ``damage``: one of DAMAGE (a CRC mismatch in IDAT, a stream 3
    rows short, filter type 7 on the stream's row 2, a first deflate block
    of type 3, the zlib adler32 trailer's last byte XORed with 0xFF, the
    chunk CRC written for the damaged bytes)."""
    ctype, bits, n = DEPTHS[cd]
    h, w = pix.shape[:2]
    bpp = max(1, bits * n // 8)
    rng = np.random.default_rng(seed)
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    stream, row = [], 0
    for xo, yo, xf, yf in passes:
        sub = pix[yo::yf, xo::xf]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = pack_samples(sub, cd)
        if filters is None:
            ft = rng.integers(0, 5, rows.shape[0])
        else:
            ft = [filters[(row + i) % len(filters)] for i in range(rows.shape[0])]
        row += rows.shape[0]
        stream.append(filter_rows(rows, bpp, ft))
    raw = np.concatenate([s.reshape(-1) for s in stream])
    if damage == "filter":  # the stream's third row
        starts = np.cumsum([0] + [s.shape[1] for s in stream for _ in range(s.shape[0])])
        raw[starts[2]] = 7
    if damage == "short":
        raw = raw[: len(raw) - 3 * stream[-1].shape[1]]
    level, strat = STRATEGIES[strategy]
    comp = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strat)
    idat = bytearray(comp.compress(raw.tobytes()) + comp.flush())
    if damage == "deflate":
        idat[2] = 0xFF  # BFINAL 1, BTYPE 3: no such block type
    if damage == "adler":
        idat[-1] ^= 0xFF
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    cut = np.linspace(0, len(idat), idat_chunks + 1).astype(int)
    for i in range(idat_chunks):
        c = chunk(b"IDAT", bytes(idat[cut[i] : cut[i + 1]]))
        if damage == "crc" and i == 0:
            c = c[:-1] + bytes([c[-1] ^ 0x5A])
        out += c
    return out + chunk(b"IEND", b"")


def png_batch(cd: str, w: int, h: int, *, batch: int = 2, seed: int = 0,
              interlace: bool = False, trns: bool = False, short: bool = False,
              strategy: str = "default", hi: int | None = None):
    """``batch`` distinct PNGs of depth ``cd`` -> (files, samples).  A
    paletted depth gets 2^bits PLTE entries (fewer than half with
    ``short``, so indices pass its end); ``trns`` gives image 0 a tRNS
    chunk -- a colour key equal to its first pixel (gray, truecolour) or
    alphas for some entries (paletted) -- and leaves the others without,
    so keyed and unkeyed images mix."""
    rng = np.random.default_rng(seed)
    ctype, bits, _n = DEPTHS[cd]
    files, pixels = [], []
    for i in range(batch):
        pix = random_pixels(rng, cd, w, h, hi=hi)
        palette = t = None
        if ctype == 3:
            n = max(1, (1 << bits) // 2 - 1) if short else 1 << bits
            palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            if trns and i == 0:
                t = rng.integers(0, 256, (n + 1) // 2, dtype=np.uint8).tobytes()
        elif trns and i == 0 and ctype in (0, 2):
            first = np.atleast_1d(pix[0, 0]).astype(np.uint16)
            t = first.astype(">u2").tobytes()
        files.append(encode_png(pix, cd, palette=palette, trns=t, interlace=interlace,
                                seed=seed + i, strategy=strategy))
        pixels.append(pix)
    return files, pixels


def hand_tokens(rng, per: int, kind: str, edge: int = 8192):
    """Tokens of one image of ``per`` bytes inside K16's domain -> (lens,
    dists, lits): "rle" is a literal then 258-byte copies at distance 1
    (zlib's Z_RLE on flat content: the deepest chains); "overlap" mixes
    literals with copies shorter than, equal to and longer than their
    distance, which straddle every boundary they meet; "far" adds copies at
    distance 32,768; "far_edge" is "overlap" with its tokens cut at every
    multiple of ``edge`` bytes, where, once 32,768 bytes are out, a copy at
    distance 32,768 starts (so that it lands on a tile's first byte and
    reads one)."""
    lens, dists, lits = [1], [0], [int(rng.integers(0, 256))]
    produced = 1
    while produced < per:
        left = per - produced
        if kind == "far_edge":
            left = min(left, edge - produced % edge)
        if kind == "far_edge" and produced % edge == 0 and produced >= 32768 and left >= 3:
            n = int(min(left, rng.integers(3, 259)))
            lens.append(n), dists.append(32768), lits.append(0)
        elif kind == "rle":
            n = min(258, left)
            lens.append(n), dists.append(1), lits.append(0)
        elif rng.random() < 0.4 or left < 3:
            n = 1
            lens.append(1), dists.append(0), lits.append(int(rng.integers(0, 256)))
        else:
            n = int(min(left, rng.integers(3, 259)))
            if kind == "far" and produced >= 32768 and rng.random() < 0.5:
                d = 32768
            else:
                d = int(rng.integers(1, min(produced, 300) + 1))
            lens.append(n), dists.append(d), lits.append(0)
        produced += n
    return (np.array(lens, np.int32), np.array(dists, np.int32), np.array(lits, np.uint8))


def stack_tokens(toks, nt: int | None = None):
    """Per-image tokens -> [B, nt] arrays, zero-length padding after each
    image's last token (nt: at least the most, default the most plus 5)."""
    nt = nt or max(len(t[0]) for t in toks) + 5
    out = [np.zeros((len(toks), nt), dt) for dt in (np.int32, np.int32, np.uint8)]
    for i, t in enumerate(toks):
        for a, src in zip(out, t):
            a[i, : len(src)] = src
    return out


def bench_rgb(size: int = 1024, seed: int = 0) -> np.ndarray:
    """The JAX bench's PNG pixels (bench.py:437-452 make_bench_png): a
    structured RGB8 image [size, size, 3], distinct for each seed."""
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 20, size)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]) + seed)).astype(np.uint8)
    noise = rng.randint(0, 24, (size, size)).astype(np.uint8)
    return np.stack([base ^ noise, base.T, (base // 2 + 64)], -1)


def make_bench_png(size: int = 1024, seed: int = 0) -> bytes:
    """The JAX bench's PNG content: ``bench_rgb`` written by Pillow at
    compress_level 6."""
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(bench_rgb(size, seed)).save(buf, format="PNG", compress_level=6)
    return buf.getvalue()


def first_pixel_keys(rows: np.ndarray, cd: str) -> np.ndarray:
    """Scanlines [B, h, row_bytes] -> [B, 3] int32 tRNS keys equal to each
    image's first pixel in the key's domain (scaled for g1/g2/g4, 16-bit
    for g16/tc16), the last image's -1 (no key)."""
    _ct, bits, _n = DEPTHS[cd]
    r = rows[:, 0].astype(np.int32)
    if bits < 8:
        k = (r[:, :1] >> (8 - bits)) * {1: 0xFF, 2: 0x55, 4: 0x11}[bits]
    elif bits == 8:
        k = r[:, :3] if cd == "tc8" else r[:, :1]
    else:
        k = (r[:, 0:6:2] << 8) | r[:, 1:6:2]
        k = k if cd == "tc16" else k[:, :1]
    key = np.broadcast_to(k, (len(r), 3)).copy()
    key[-1] = -1
    return key


ADLER_MOD = 65521


def adler32_span_terms(data, addr: int, span: int, threads: int = 256) -> dict:
    """csrc/adler32.cu's arithmetic in numpy: the adler32 of ``data`` (u8
    [n]) whose first byte lies ``addr`` bytes past a 16-byte boundary, cut
    into spans of ``span`` bytes, each read as the kernel's ``threads``
    threads read it (head bytes, 16-byte groups t, t + threads, ..., tail
    bytes), each span's (S, B term) mod 65521 and their sum as its last CTA
    adds them.  -> {"sum": the checksum, and the largest value each
    accumulator held: "group_s", "group_w" (a group's S and sum k d_k),
    "thread_s", "thread_w" (a thread's s and w before the mod)}."""
    d = np.asarray(data, np.uint8).astype(np.int64)
    n = d.size
    top = dict.fromkeys(("group_s", "group_w", "thread_s", "thread_w"), 0)
    a_terms, b_terms = [], []
    for i0 in range(0, max(n, 1), span):
        seg = d[i0 : i0 + span]
        ln = seg.size
        head = min(ln, (16 - (addr + i0) % 16) % 16)
        nvec = (ln - head) // 16
        s = np.zeros(threads, np.int64)
        w = np.zeros(threads, np.int64)
        s[:head] += seg[:head]
        w[:head] += np.arange(head) * seg[:head]
        groups = seg[head : head + 16 * nvec].reshape(nvec, 16)
        gs, gw = groups.sum(1), (groups * np.arange(16)).sum(1)
        lane = np.arange(nvec) % threads
        np.add.at(s, lane, gs)
        np.add.at(w, lane, (head + 16 * np.arange(nvec)) * gs + gw)
        t0 = head + 16 * nvec
        s[: ln - t0] += seg[t0:]
        w[: ln - t0] += np.arange(t0, ln) * seg[t0:]
        for k, v in (("group_s", gs), ("group_w", gw), ("thread_s", s), ("thread_w", w)):
            top[k] = max(top[k], int(v.max()) if v.size else 0)
        S = int((s % ADLER_MOD).sum()) % ADLER_MOD
        T = int((w % ADLER_MOD).sum()) % ADLER_MOD
        a_terms.append(S)
        b_terms.append(((n - i0) % ADLER_MOD * S + ADLER_MOD - T) % ADLER_MOD)
    a = (sum(a_terms) % ADLER_MOD + 1) % ADLER_MOD
    b = (sum(b_terms) % ADLER_MOD + n % ADLER_MOD) % ADLER_MOD
    return {"sum": b << 16 | a, **top}


def adler32_thread_bounds(span: int, threads: int = 256) -> dict:
    """The largest values csrc/adler32.cu's header states for an all-0xFF
    span: a group's S and sum k d_k, a thread's s and w."""
    s = 255 * (16 * -(-span // (16 * threads)) + 2)
    return {"group_s": 16 * 255, "group_w": 255 * 120, "thread_s": s, "thread_w": s * (span - 1)}
