"""A plain baseline JPEG decoder: ITU T.81 sequential DCT, Huffman coding,
8-bit samples, one scan, no restart markers.

Written for the benchmark from the standard and the published integer
IDCT, in Python (the Huffman walk) and NumPy (everything after it).  It
imports nothing of the program and takes nothing the program made: the
tables, the coefficients and the pixels are all worked out here from the
file's bytes.

The arithmetic is the one the program guarantees bit for bit:

* dequantisation: coefficient times table entry, in int32;
* the IDCT: Wang's fixed-point 8x8 butterfly (the MPEG reference
  decoder's ``idct.c``, as Go's ``image/jpeg/idct.go`` publishes it):
  constants 2048 sqrt(2) cos(k pi / 16), rows shifted by 8, columns by 14;
* level shift and clamp: ``clip(x + 128, 0, 255)``;
* chroma: each sample replicated over its h x v pixels (no smoothing);
* colour: JFIF YCbCr -> RGB in 16-bit fixed point,
  ``R = Y * 0x10101 + 91881 (Cr - 128)``,
  ``G = Y * 0x10101 - 22554 (Cb - 128) - 46802 (Cr - 128)``,
  ``B = Y * 0x10101 + 116130 (Cb - 128)``, each ``clip(v, 0, 2^24 - 1) >> 16``.

``decode(data)`` -> uint8 [H, W, 3] (gray: [H, W]).  ``idct=`` swaps the
transform (the benchmark's control passes a float one).
"""

from __future__ import annotations

import numpy as np

# ZIGZAG[k] = the natural (row-major) index of the k-th coefficient in
# zig-zag order (T.81 figure A.6)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565
R2 = 181  # 256 / sqrt(2)


def _butterfly(x0, x1, x2, x3, x4, x5, x6, x7, *, rnd: int, pre: int, shift: int):
    """One 1-D pass over eight int32 arrays (x0 and x1 already scaled):
    Wang's four stages.  ``rnd`` and ``pre`` are the column pass's extra
    rounding of the odd products and its shift of them (0 on rows)."""
    t = W7 * (x4 + x5) + rnd
    a4 = (t + (W1 - W7) * x4) >> pre
    a5 = (t - (W1 + W7) * x5) >> pre
    t = W3 * (x6 + x7) + rnd
    a6 = (t - (W3 - W5) * x6) >> pre
    a7 = (t - (W3 + W5) * x7) >> pre
    e0 = x0 + x1
    e1 = x0 - x1
    t = W6 * (x3 + x2) + rnd
    e2 = (t - (W2 + W6) * x2) >> pre
    e3 = (t + (W2 - W6) * x3) >> pre
    o1 = a4 + a6
    o4 = a4 - a6
    o6 = a5 + a7
    o5 = a5 - a7
    f7 = e0 + e3
    f8 = e0 - e3
    f3 = e1 + e2
    f0 = e1 - e2
    o2 = (R2 * (o4 + o5) + 128) >> 8
    o4 = (R2 * (o4 - o5) + 128) >> 8
    return [(f7 + o1) >> shift, (f3 + o2) >> shift, (f0 + o4) >> shift, (f8 + o6) >> shift,
            (f8 - o6) >> shift, (f0 - o4) >> shift, (f3 - o2) >> shift, (f7 - o1) >> shift]


def idct_int(blocks: np.ndarray) -> np.ndarray:
    """[N, 8, 8] int32 dequantised coefficients (natural order) -> [N, 8, 8]
    int32 samples before the level shift."""
    s = blocks.astype(np.int32)
    r = [s[:, :, k] for k in range(8)]  # rows: each [N, 8] over the row index
    rows = _butterfly((r[0] << 11) + 128, r[4] << 11, r[6], r[2], r[1], r[7], r[5], r[3],
                      rnd=0, pre=0, shift=8)
    t = np.stack(rows, axis=-1)  # [N, row, col]
    c = [t[:, k, :] for k in range(8)]  # columns: each [N, 8] over the column index
    cols = _butterfly((c[0] << 8) + 8192, c[4] << 8, c[6], c[2], c[1], c[7], c[5], c[3],
                      rnd=4, pre=3, shift=14)
    return np.stack(cols, axis=1)


def _lut(counts, values) -> list:
    """A 16-bit lookahead table: entry (code length << 8) | symbol for every
    16-bit word that starts with the code, -1 where no code starts."""
    lut = np.full(1 << 16, -1, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | values[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _markers(data: bytes):
    """SOI .. SOS -> (frame, quant tables, Huffman tables, scan selectors,
    the first byte of the entropy-coded data)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("jpeg: no SOI")
    pos, quant, huff, frame = 2, {}, {}, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("jpeg: expected a marker")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = (data[pos + 2] << 8) | data[pos + 3]
        body = data[pos + 4:pos + 2 + length]
        if marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise ValueError("jpeg: only 8-bit samples")
            h, w, nc = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            frame = (w, h, comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError("jpeg: only baseline sequential DCT")
        elif marker == 0xC4:
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1:o + 17])
                n = sum(counts)
                huff[(tc, th)] = _lut(counts, list(body[o + 17:o + 17 + n]))
                o += 17 + n
        elif marker == 0xDB:
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                if pq:
                    q = np.frombuffer(bytes(body[o + 1:o + 129]), ">u2").astype(np.int32)
                    o += 129
                else:
                    q = np.frombuffer(bytes(body[o + 1:o + 65]), np.uint8).astype(np.int32)
                    o += 65
                quant[tq] = q  # zig-zag order
        elif marker == 0xDD:
            if (body[0] << 8) | body[1]:
                raise ValueError("jpeg: restart intervals are not covered")
        elif marker == 0xDA:
            ns = body[0]
            sel = {body[1 + 2 * i]: (body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                   for i in range(ns)}
            if frame is None:
                raise ValueError("jpeg: SOS before SOF")
            if len(sel) != len(frame[2]):
                raise ValueError("jpeg: only single-scan (interleaved) files")
            return frame, quant, huff, sel, pos + 2 + length
        pos += 2 + length
    raise ValueError("jpeg: no SOS")


def _entropy_bytes(data: bytes, start: int) -> np.ndarray:
    """The scan's bytes up to its end marker, FF00 stuffing removed."""
    d = np.frombuffer(data, np.uint8, offset=start)
    ff = np.flatnonzero(d[:-1] == 0xFF)
    nxt = d[ff + 1]
    ends = ff[nxt != 0x00]
    end = int(ends[0]) if len(ends) else len(d)
    if len(ends) and d[end + 1] != 0xD9:
        raise ValueError("jpeg: a marker inside the scan")
    keep = np.ones(end, bool)
    stuffed = ff[(nxt == 0x00) & (ff < end)]
    keep[stuffed + 1] = False
    return d[:end][keep]


def coefficients(data: bytes):
    """Huffman-decode the scan -> (frame, quant tables, a list of
    [rows, cols, 64] int32 zig-zag coefficients per component, DC
    predictions applied)."""
    frame, quant, huff, sel, start = _markers(data)
    w, h, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mxx = -(-w // (8 * hmax))
    myy = -(-h // (8 * vmax))
    dims = [(myy * c[2], mxx * c[1]) for c in comps]
    base = np.cumsum([0] + [r * cc for r, cc in dims])
    # each MCU's blocks in coding order: (component, the block's first
    # coefficient slot in MCU (0, 0), the slots an MCU row and an MCU
    # column move it, its tables)
    layout = []
    for ci, (cid, hc, vc, _) in enumerate(comps):
        td, ta = sel[cid]
        cols = dims[ci][1]
        for by in range(vc):
            for bx in range(hc):
                layout.append((ci, (int(base[ci]) + by * cols + bx) * 64, vc * cols * 64,
                               hc * 64, huff[(0, td)], huff[(1, ta)]))
    body = _entropy_bytes(data, start)
    pad = np.zeros(len(body) + 8, np.uint64)
    pad[:len(body)] = body
    # win[i]: the five bytes from byte i, big-endian (bits 39..0)
    win = ((pad[:-4] << np.uint64(32)) | (pad[1:-3] << np.uint64(24)) | (pad[2:-2] << np.uint64(16))
           | (pad[3:-1] << np.uint64(8)) | pad[4:]).tolist()
    nbits = 8 * len(body)
    pred = [0] * len(comps)
    slots, vals = [], []
    mask32 = 0xFFFFFFFF
    p = 0
    for my in range(myy):
        for mx in range(mxx):
            for ci, off, row_step, col_step, dc_lut, ac_lut in layout:
                blk = off + my * row_step + mx * col_step
                # DC: a size category, then that many bits
                wd = (win[p >> 3] >> (8 - (p & 7))) & mask32
                e = dc_lut[wd >> 16]
                if e < 0:
                    raise ValueError("jpeg: bad DC code")
                n, s = e >> 8, e & 255
                v = 0
                if s:
                    v = (wd >> (32 - n - s)) & ((1 << s) - 1)
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                p += n + s
                pred[ci] += v
                slots.append(blk)
                vals.append(pred[ci])
                k = 1
                while k < 64:
                    wd = (win[p >> 3] >> (8 - (p & 7))) & mask32
                    e = ac_lut[wd >> 16]
                    if e < 0:
                        raise ValueError("jpeg: bad AC code")
                    n, rs = e >> 8, e & 255
                    s = rs & 15
                    if s == 0:
                        p += n
                        if rs == 0xF0:  # ZRL: sixteen zeros
                            k += 16
                            continue
                        break  # EOB
                    k += rs >> 4
                    v = (wd >> (32 - n - s)) & ((1 << s) - 1)
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    p += n + s
                    slots.append(blk + k)
                    vals.append(v)
                    k += 1
                if k > 64 or p > nbits:
                    raise ValueError("jpeg: a block runs past its end")
    flat = np.zeros(int(base[-1]) * 64, np.int32)
    flat[np.asarray(slots, np.int64)] = np.asarray(vals, np.int32)
    out = [flat[int(base[i]) * 64:int(base[i + 1]) * 64].reshape(*dims[i], 64)
           for i in range(len(comps))]
    return frame, quant, out


def _planes(frame, quant, coeffs, idct):
    """Dequantise, transform, level-shift: one uint8 plane per component
    (padded to whole MCUs)."""
    planes = []
    for (cid, hc, vc, tq), zz in zip(frame[2], coeffs):
        rows, cols = zz.shape[:2]
        nat = np.zeros((rows * cols, 64), np.int32)
        nat[:, ZIGZAG] = zz.reshape(-1, 64) * quant[tq][None, :]
        px = np.clip(idct(nat.reshape(-1, 8, 8)) + 128, 0, 255).astype(np.uint8)
        planes.append(px.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(8 * rows, 8 * cols))
    return planes


def _to_rgb(y, cb, cr):
    yy = y.astype(np.int32) * 0x10101
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128

    def fix(v):
        return (np.clip(v, 0, (1 << 24) - 1) >> 16).astype(np.uint8)

    return np.stack([fix(yy + 91881 * cr), fix(yy - 22554 * cb - 46802 * cr),
                     fix(yy + 116130 * cb)], axis=-1)


def decode(data: bytes, *, idct=idct_int) -> np.ndarray:
    """A baseline JPEG's bytes -> uint8 [H, W, 3] RGB ([H, W] for gray)."""
    frame, quant, coeffs = coefficients(data)
    w, h, comps = frame
    planes = _planes(frame, quant, coeffs, idct)
    if len(comps) == 1:
        return planes[0][:h, :w]
    if len(comps) != 3:
        raise ValueError("jpeg: only gray and YCbCr files")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    full = []
    for (cid, hc, vc, _), plane in zip(comps, planes):
        full.append(np.repeat(np.repeat(plane, vmax // vc, axis=0), hmax // hc, axis=1)[:h, :w])
    return _to_rgb(*full)
