"""JPEG inputs of the zpix_tpu_torch tests and of chip_smoke.py, made
from numpy seeds: Pillow's writer, a baseline writer of any sampling,
K1 and K2's edge cases, and entropy segments coded with tables no
Pillow image has.  Imports nothing of the JAX package (chip_smoke.py
loads this file by path on the card); tests/_torch_jpeg.py re-exports it.
"""

from __future__ import annotations

import io

import numpy as np
from PIL import Image


def synth_jpeg(w=48, h=32, mode="420", dri_blocks=2, phase=0.0, quality=60,
               restart_marker_rows=None):
    """Structured image -> baseline JPEG with restart markers."""
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    kw = {"restart_marker_rows": restart_marker_rows} if restart_marker_rows else {
        "restart_marker_blocks": dri_blocks}
    buf = io.BytesIO()
    if mode == "gray":
        Image.fromarray(base, "L").save(buf, format="JPEG", quality=quality, **kw)
    else:
        rgb = np.stack([base, base[::-1], base // 2 + 32], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
    return buf.getvalue()


def synth_plain_jpeg(w=48, h=32, mode="420", phase=0.0, quality=60):
    """Structured image -> baseline JPEG with no restart markers."""
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(np.uint8)
    buf = io.BytesIO()
    if mode == "gray":
        Image.fromarray(base, "L").save(buf, format="JPEG", quality=quality)
    else:
        rgb = np.stack([base, base[::-1], base // 2 + 32], -1)
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality,
                                  subsampling={"444": 0, "422": 1, "420": 2}[mode])
    return buf.getvalue()


def _segments(data: bytes, marker: int):
    """The whole segments (marker included) of one kind, before SOS."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xDA:
        ln = (data[pos + 2] << 8) | data[pos + 3]
        if data[pos + 1] == marker:
            out.append(data[pos : pos + 2 + ln])
        pos += 2 + ln
    return out


def _codes(dht: bytes):
    """{(class, id): {symbol: (code, length)}} from DHT segments."""
    out, body = {}, dht[4:]
    while body:
        counts, o = body[1:17], 17
        table, code = {}, 0
        for ln, n in enumerate(counts, 1):
            for _ in range(n):
                table[body[o]] = (code, ln)
                code += 1
                o += 1
            code <<= 1
        out[(body[0] >> 4, body[0] & 15)] = table
        body = body[o:]
    return out


def encode_baseline(grids, hv, width, height, dri=None, scans="interleaved", adobe=None):
    """Quantized coefficient grids (per component [myy*v, mxx*h, 64] int,
    natural order) -> a baseline JPEG with sampling ``hv``, a restart
    marker every ``dri`` MCUs (none for None), Pillow's quant and Huffman
    tables.  Pillow writes only 4:4:4, 4:2:2 and 4:2:0; this writes any
    ratio and 1, 3 or 4 components.  ``scans="separate"`` writes one
    non-interleaved scan a component (no restart markers), each covering
    the component's in-image blocks only (bx * 8 < width and by * 8 <
    height, as the reference decoder walks them, decoder.zig:1316-1325).
    ``adobe``: the transform byte of an Adobe APP14 segment (0: RGB or
    CMYK, 1: YCbCr, 2: YCCK), or None for no segment."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG

    template = synth_plain_jpeg(w=16, h=16, mode="444")
    dqt, dhts = b"".join(_segments(template, 0xDB)), _segments(template, 0xC4)
    codes = {}
    for seg in dhts:
        codes.update(_codes(seg))
    nc = len(hv)
    mxx, myy = grids[0].shape[1] // hv[0][0], grids[0].shape[0] // hv[0][1]
    bits, nbits = [], 0
    acc = 0

    def put(value, n):
        nonlocal acc, nbits
        acc, nbits = (acc << n) | (value & ((1 << n) - 1)), nbits + n
        while nbits >= 8:
            nbits -= 8
            byte = (acc >> nbits) & 0xFF
            bits.append(byte)
            if byte == 0xFF:
                bits.append(0)
        acc &= (1 << nbits) - 1  # keep only the bits not yet written

    def sym(table, s, value=0, size=0):
        code, ln = codes[table][s]
        put(code, ln)
        if size:
            put(value if value > 0 else value + (1 << size) - 1, size)

    def block(c, t, by, bx):
        zz = np.asarray(grids[c][by, bx])[UNZIG]
        diff = int(zz[0]) - pred[c]
        pred[c] = int(zz[0])
        s = abs(diff).bit_length()
        sym((0, t), s, diff, s)
        last = 0
        for k in np.flatnonzero(zz[1:]) + 1:
            run = int(k) - last - 1
            while run > 15:
                sym((1, t), 0xF0)
                run -= 16
            val = int(zz[k])
            s = abs(val).bit_length()
            sym((1, t), (run << 4) | s, val, s)
            last = int(k)
        if last < 63:
            sym((1, t), 0x00)

    def flush():
        nonlocal acc, nbits
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)
        out = bytes(bits)
        bits.clear()
        acc = 0
        return out

    pred = [0] * nc
    entropy = []
    if scans == "separate":
        for c, (h, v) in enumerate(hv):
            for by in range(myy * v):
                for bx in range(mxx * h):
                    if bx * 8 < width and by * 8 < height:
                        block(c, 0 if c == 0 else 1, by, bx)
            entropy.append(([c], flush()))
    else:
        for my in range(myy):
            for mx in range(mxx):
                m = my * mxx + mx
                if dri and m and m % dri == 0:  # RSTn: pad with ones, reset predictors
                    if nbits:
                        put((1 << (8 - nbits)) - 1, 8 - nbits)
                    bits.extend([0xFF, 0xD0 + (m // dri - 1) % 8])
                    pred = [0] * nc
                for c, (h, v) in enumerate(hv):
                    for j in range(h * v):
                        block(c, 0 if c == 0 else 1, v * my + j // h, h * mx + j % h)
        entropy.append((list(range(nc)), flush()))
    sof = bytes([0xFF, 0xC0, 0, 8 + 3 * nc, 8, height >> 8, height & 255, width >> 8,
                 width & 255, nc]) + b"".join(
        bytes([c + 1, h << 4 | v, 0 if c == 0 else 1]) for c, (h, v) in enumerate(hv))
    sos = b"".join(
        bytes([0xFF, 0xDA, 0, 6 + 2 * len(comps), len(comps)]) + b"".join(
            bytes([c + 1, 0x00 if c == 0 else 0x11]) for c in comps) + bytes([0, 63, 0]) + data
        for comps, data in entropy)
    drs = b"" if not dri else bytes([0xFF, 0xDD, 0, 4, dri >> 8, dri & 255])
    app14 = b"" if adobe is None else (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                                       + bytes([adobe]))
    return b"\xff\xd8" + app14 + dqt + sof + b"".join(dhts) + drs + sos + b"\xff\xd9"


def synth_ratio_jpeg(hv, width=40, height=24, seed=0, dri=None, scans="interleaved",
                     adobe=None, density=0.2):
    """encode_baseline of random sparse coefficients at sampling ``hv``,
    a share ``density`` of the AC coefficients nonzero (out-of-image
    blocks of a ``scans="separate"`` stream are zero, as its decode leaves
    them)."""
    rng = np.random.default_rng(seed)
    mxx = (width + 8 * hv[0][0] - 1) // (8 * hv[0][0])
    myy = (height + 8 * hv[0][1] - 1) // (8 * hv[0][1])
    grids = []
    for h, v in hv:
        g = rng.integers(-40, 40, (myy * v, mxx * h, 64))
        g[rng.random(g.shape) < 1 - density] = 0
        g[..., 0] = rng.integers(-300, 300, g.shape[:2])
        if scans == "separate":
            g[(np.arange(g.shape[0]) * 8 >= height)[:, None]
              | (np.arange(g.shape[1]) * 8 >= width)[None, :]] = 0
        grids.append(g)
    return encode_baseline(grids, hv, width, height, dri, scans, adobe)


def _noise_jpeg(w, h, mode, quality, seed, dri, optimize=False):
    """Seeded noise over a smooth pattern -> baseline JPEG, a restart
    marker every ``dri`` MCUs (Pillow; ``optimize`` writes the image's own
    Huffman tables, with codes up to 16 bits)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 9, w)
    base = 128 + 90 * np.sin(x[None, :] + np.linspace(0, 5, h)[:, None])
    img = np.clip(base[..., None] + rng.normal(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    kw = dict(format="JPEG", quality=quality, restart_marker_blocks=dri, optimize=optimize)
    if mode == "gray":
        Image.fromarray(img[..., 0], "L").save(buf, **kw)
    else:
        Image.fromarray(img).save(buf, subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
    return buf.getvalue()


def _edge_grids(hv, mxx, myy, seed):
    """Coefficients that reach every step kind: DC diffs up to 11 bits
    (alternating +-1000), ZRL runs before a coefficient at zigzag 40,
    blocks of DC alone (EOB at k = 1), and blocks whose last coefficient
    sits at zigzag 63 (no EOB)."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG

    rng = np.random.default_rng(seed)
    grids = []
    for h, v in hv:
        g = np.zeros((myy * v, mxx * h, 64), np.int64)
        kind = rng.integers(0, 4, g.shape[:2])
        g[..., 0] = np.where(rng.random(g.shape[:2]) < 0.5, 1000, -1000)
        g[kind == 1, UNZIG[40]] = rng.integers(1, 100, int((kind == 1).sum()))
        g[kind == 2, UNZIG[63]] = -7
        g[kind == 2, UNZIG[1]] = 3
        grids.append(g)
    return grids


def k1_k2_edges(size=200, seed=0):
    """{case: batch of JPEG bytes (one geometry, one set of tables)} that
    drive K1 and K2 through their edges: a segment of one MCU, a partial
    last segment (and lane counts no multiple of a CTA or a warp group),
    blocks of all 63 AC coefficients (quality 100 noise), ZRL runs, EOB at
    k = 1 and DC sizes up to 11, Pillow's optimised tables with long codes
    at 1, 3, 4 and 6 blocks an MCU, 4:1:0 (10 blocks an MCU), and every
    component sampled 3 x 1 or 1 x 3.  ``size``: the width (the height is
    3/5 of it)."""
    w, h = size, size * 3 // 5
    out = {
        "dri1": [synth_jpeg(w=w, h=h, dri_blocks=1, phase=p) for p in (0.0, 1.0)],
        "partial_last_segment": [synth_jpeg(w=w, h=h, dri_blocks=5, phase=p) for p in (0, 2)],
        "q100_noise_444": [_noise_jpeg(w, h, "444", 100, seed + i, 3) for i in range(2)],
    }
    hv = ((2, 2), (1, 1), (1, 1))
    mxx, myy = (w + 15) // 16, (h + 15) // 16
    out["zrl_eob_dc11"] = [encode_baseline(_edge_grids(hv, mxx, myy, seed + i), hv, w, h, 2)
                           for i in range(2)]
    for mode, bpm in (("gray", 1), ("444", 3), ("422", 4), ("420", 6)):
        one = _noise_jpeg(w, h, mode, 95, seed, 4, optimize=True)
        out[f"optimized_bpm{bpm}"] = [one, one]  # per-image tables: one image twice
    out["bpm10"] = [synth_ratio_jpeg(((4, 2), (1, 1), (1, 1)), w, h, seed + i, dri=3)
                    for i in range(2)]
    for name, f in (("factor3_h", ((3, 1),) * 3), ("factor3_v", ((1, 3),) * 3)):
        out[name] = [synth_ratio_jpeg(f, w, h, seed + i, dri=2) for i in range(2)]
    return out


def damage_plan(plan, kind):
    """A copy of a restart plan with one kind of damage for K1 and K2:
    "invalid_code" (FF bytes at segment 1's start: an all-ones code is
    invalid in every table Pillow writes) or "past_buffer" (the last
    segment starts 4 bytes before the stream's end)."""
    import copy

    plan = copy.copy(plan)
    plan.stream = plan.stream.copy()
    plan.seg_bit_pos = plan.seg_bit_pos.copy()
    if kind == "invalid_code":
        at = int(plan.seg_bit_pos[min(1, len(plan.seg_bit_pos) - 1)]) // 8
        plan.stream[at : at + 4] = 0xFF
    else:
        plan.seg_bit_pos[-1] = 8 * (plan.stream.shape[0] - 4)
    return plan


# ------------------------------------------- segments coded with any tables

# (counts of codes of each length 1-16, symbol bytes) of tables no Pillow
# image has.  Each is a prefix code (Kraft sum <= 1).
_DC_TABLE = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_SKEWED = ([0, 2, 3, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_UNARY = ([1] * 12 + [0] * 4, list(range(12)))
# one code of each length 2-15 and two of 16 bits
_AC_SIXTEEN = ([0] + [1] * 14 + [2], [0x00, 0x01, 0x11, 0x02, 0x21, 0x12, 0x31, 0x03, 0x41,
                                     0x51, 0x13, 0x61, 0x22, 0xF0, 0x0A, 0xFA])
# 30 codes of 5 bits and 160 of 12: the 12-bit codes lie under 40 distinct
# 10-bit prefixes, more than the kernels' second-level blocks (32)
_AC_MANY_LONG = ([0, 0, 0, 0, 30, 0, 0, 0, 0, 0, 0, 160, 0, 0, 0, 0],
                 [(37 * i) % 256 for i in range(190)])
# 2, 4, 8 and 16 codes of 2, 4, 6 and 8 bits and 64 of 11
_AC_SPREAD = ([0, 2, 0, 4, 0, 8, 0, 16, 0, 0, 64, 0, 0, 0, 0, 0],
              [(53 * i + 1) % 256 for i in range(94)])

# case: (tables, (DC table, AC table) of each MCU slot)
CODED_CASES = {
    "sixteen_bit_codes": ([_DC_TABLE, _AC_SIXTEEN], [(0, 1)]),
    "many_second_level_blocks": ([_DC_TABLE, _AC_SIXTEEN, _AC_MANY_LONG], [(0, 1), (0, 2)]),
    # six (table, role) pairs: more than the kernels' lookahead regions (4)
    "six_table_pairs": ([_DC_TABLE, _DC_SKEWED, _DC_UNARY, _AC_SIXTEEN, _AC_MANY_LONG,
                         _AC_SPREAD],
                        [(0, 3), (1, 4), (2, 5), (0, 4), (1, 5), (2, 3)]),
}


def _canonical(counts):
    """The canonical (code, length) of each symbol index of a table."""
    out, code = [], 0
    for ln, n in enumerate(counts, 1):
        for _ in range(n):
            out.append((code, ln))
            code += 1
        code <<= 1
    return out


def coded_segments(case, n_segs=300, seg_mcus=5, seed=0):
    """Restart segments of random blocks coded with CODED_CASES[case]'s
    tables, each symbol drawn uniformly from its table, each extend field
    random: the last segment is partial (seg_mcus // 2 + 1 MCUs), and
    each segment starts on a byte.  -> dict: ``stream`` (uint8, 16 zero
    bytes past the last segment), ``seg_pos`` and ``seg_nmcu`` (int32
    [n_segs]), ``tables`` (packed int32, ops/entropy.py::pack_tables),
    ``bpm``, ``nblk``, and what the passes must find: ``ends`` (int32
    [n_segs, nblk], 0 for padding blocks), ``ac`` (int16 [n_segs * nblk,
    64] natural order) and ``dc`` (int32 DC diffs)."""
    from zpix_tpu_torch.codecs.jpeg.tables import UNZIG, HuffTable
    from zpix_tpu_torch.ops.entropy import pack_tables

    specs, slots = CODED_CASES[case]
    codes = [_canonical(counts) for counts, _ in specs]
    rng = np.random.default_rng(seed)
    bpm = len(slots)
    nblk = seg_mcus * bpm
    ends = np.zeros((n_segs, nblk), np.int32)
    ac = np.zeros((n_segs * nblk, 64), np.int16)
    dc = np.zeros(n_segs * nblk, np.int32)
    seg_pos = np.zeros(n_segs, np.int32)
    seg_nmcu = np.full(n_segs, seg_mcus, np.int32)
    seg_nmcu[-1] = seg_mcus // 2 + 1
    bits = []

    def put_symbol(t):
        i = int(rng.integers(len(codes[t])))
        code, ln = codes[t][i]
        bits.extend((code >> (ln - 1 - j)) & 1 for j in range(ln))
        return specs[t][1][i]

    def put_extend(size):
        raw = int(rng.integers(1 << size))
        bits.extend((raw >> (size - 1 - j)) & 1 for j in range(size))
        return raw - (1 << size) + 1 if raw < (1 << (size - 1)) else raw

    for s in range(n_segs):
        seg_pos[s] = len(bits)
        for m in range(seg_nmcu[s]):
            for slot, (td, ta) in enumerate(slots):
                lane = s * nblk + m * bpm + slot
                size = put_symbol(td)
                dc[lane] = put_extend(size) if size else 0
                k = 1
                while True:
                    sym = put_symbol(ta)
                    r, size = sym >> 4, sym & 15
                    if size:
                        k = min(k + r, 63)
                        ac[lane, UNZIG[k]] = put_extend(size)
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
                    if k > 63:
                        break
                ends[s, m * bpm + slot] = len(bits)
        bits.extend([1] * (-len(bits) % 8))
    stream = np.packbits(np.asarray(bits, np.uint8))
    tabs = []
    for counts, vals in specs:
        tab = HuffTable()
        tab.build(counts, vals)
        tabs.append(tab)
    tables = pack_tables(tabs, [d for d, _ in slots], [a for _, a in slots])
    return {"stream": np.concatenate([stream, np.zeros(16, np.uint8)]), "seg_pos": seg_pos,
            "seg_nmcu": seg_nmcu, "tables": tables, "bpm": bpm, "nblk": nblk,
            "ends": ends, "ac": ac, "dc": dc}


def random_limits(tables, seed=0):
    """A copy of packed tables with every code-length limit and value
    offset drawn at random: unsorted limits and offsets outside the symbol
    bytes, which no JPEG has, but on which the kernels and their plain
    versions must still agree."""
    from zpix_tpu_torch.ops import entropy as ke

    rng = np.random.default_rng(seed)
    out = np.array(tables, copy=True)
    out[ke.TAB_LIMS : ke.TAB_LIMS + 128] = rng.integers(0, 70000, 128)
    out[ke.TAB_AOFF : ke.TAB_AOFF + 128] = rng.integers(-50, 200, 128)
    return out


def as_rgb_stream(data: bytes) -> bytes:
    """A Pillow 4:4:4 JPEG made an RGB-colourspace one: JFIF renamed away
    and component ids R, G, B in both SOF and SOS."""
    out = bytearray(data)
    at = out.find(b"JFIF\x00")
    out[at : at + 4] = b"XXXX"
    for marker, first, step in ((b"\xff\xc0", 10, 3), (b"\xff\xda", 5, 2)):
        p = out.find(marker)
        for i, cid in enumerate(b"RGB"):
            out[p + first + step * i] = cid
    return bytes(out)


def port_host_pixels(data: bytes):
    """The port's host decoder's output (zpix_tpu_torch.codecs.jpeg) in the
    batch decoders' layout: gray [H, W], YCbCr through ycbcr_to_rgb8 and
    RGB [H, W, 3], CMYK and YCCK [H, W, 4] (the CMYKImage channels)."""
    from zpix_tpu_torch.codecs import jpeg
    from zpix_tpu_torch.color import ycbcr_to_rgb8

    img = jpeg.decode(data)
    name = type(img).__name__
    if name == "YCbCrImage":
        cb, cr = img.upsampled_cbcr()
        return np.stack(ycbcr_to_rgb8(img.y, cb, cr), -1)
    if name == "RGBAImage":
        return img.pix[..., :3]
    return img.pix


# 4-component sampling {2x2, 1x1, 1x1, 2x2}, the one besides all-1x1 that
# the SOF admits (decoder.zig:595-611)
QUAD = ((2, 2), (1, 1), (1, 1), (2, 2))
