"""The port's BatchQoiDecoder on the CPU (K23's plain version) against
zpix_tpu's BatchQoiDecoder (XLA:CPU) and the host decoder: the counterparts
of tests/test_qoi_device.py:40-181.  Exact: tolerance 0."""

import numpy as np
import pytest
import torch
from _torch_raster import qoi_enc, qoi_images

from zpix_tpu.parallel import qoi_batch as jq
from zpix_tpu_torch.codecs.qoi.decode import decode_pixels
from zpix_tpu_torch.errors import UnsupportedError
from zpix_tpu_torch.ops import qoi_spec as ks
from zpix_tpu_torch.parallel import BatchQoiDecoder, make_mesh
from zpix_tpu_torch.parallel import qoi_batch as tq


def _port(**kw):
    return BatchQoiDecoder(device="cpu", **kw)


def _both(datas, **kw):
    """(port rgba numpy, port ok, zpix_tpu rgba, zpix_tpu ok)."""
    out, ok = _port(**kw).decode(datas)
    jout, jok = jq.BatchQoiDecoder(k_ops=2, **kw).decode(datas)
    return out.numpy(), bool(ok), np.asarray(jout), bool(jok)


def test_parity():
    datas = [qoi_enc(a) for a in qoi_images()]
    out, ok, jout, jok = _both(datas, chunk_bytes=32)
    assert ok and jok and np.array_equal(out, jout)
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], decode_pixels(d)), i


@pytest.mark.parametrize("cb", [16, 64, 256])
def test_chunk_geometry_invariance(cb):
    data = qoi_enc(qoi_images()[0])
    out, ok, jout, jok = _both([data], chunk_bytes=cb)
    assert ok and jok and np.array_equal(out, jout)
    assert np.array_equal(out[0], decode_pixels(data))


def test_truncated_fill():
    """An op stream cut in half: ok and pixels as zpix_tpu's, and
    decode_verified the host decoder's fill with the last pixel."""
    data = qoi_enc(qoi_images()[3])
    t = data[: len(data) // 2] + b"\x00" * 8
    out, ok, jout, jok = _both([t], chunk_bytes=32)
    assert ok == jok
    if ok:
        assert np.array_equal(out, jout)
    assert np.array_equal(_port(chunk_bytes=32).decode_verified([t])[0], decode_pixels(t))


def test_rejects_mixed_dims():
    a = qoi_enc(np.zeros((8, 8, 4), np.uint8))
    b = qoi_enc(np.zeros((8, 16, 4), np.uint8))
    with pytest.raises(UnsupportedError):
        tq.prep_qoi_batch([a, b])
    with pytest.raises(jq.UnsupportedError):
        jq.prep_qoi_batch([a, b])


def test_mixed_stream_lengths():
    """A flat image (a tiny stream) beside noise: the short image's empty
    chunks pass its state on."""
    imgs = qoi_images()
    datas = [qoi_enc(imgs[1]), qoi_enc(imgs[3])]
    out, ok, jout, jok = _both(datas, chunk_bytes=32)
    assert ok and jok and np.array_equal(out, jout)
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], decode_pixels(d))


def test_ops_cap_overflow_exact():
    """ops_cap below a chunk's ops clears ok (never wrong pixels under ok),
    decode_verified takes the host decoder; a cap that covers the ops keeps
    the card's path exact.  ok as zpix_tpu's in both."""
    imgs = qoi_images()
    flat, dense = qoi_enc(imgs[1]), qoi_enc(imgs[3])
    _, ok, _, jok = _both([dense], chunk_bytes=32, ops_cap=2)
    assert not ok and not jok
    assert np.array_equal(_port(chunk_bytes=32, ops_cap=2).decode_verified([dense])[0],
                          decode_pixels(dense))
    out, ok, jout, jok = _both([flat], chunk_bytes=32, ops_cap=32)
    assert ok and jok and np.array_equal(out, jout)
    assert np.array_equal(out[0], decode_pixels(flat))


def test_sharded_parity():
    """make_mesh(["cpu"] * 8): each position decodes its image; the
    Sharded output and ok as zpix_tpu's on its 8 XLA:CPU devices."""
    import jax

    from zpix_tpu.parallel.mesh import make_mesh as jax_mesh

    imgs = qoi_images()
    datas = [qoi_enc(imgs[i % len(imgs)]) for i in range(8)]
    out, ok = BatchQoiDecoder(chunk_bytes=32, mesh=make_mesh(["cpu"] * 8)).decode(datas)
    jout, jok = jq.BatchQoiDecoder(chunk_bytes=32, mesh=jax_mesh(jax.devices()[:8], batch=8,
                                                                  stripe=1)).decode(datas)
    assert type(out).__name__ == "Sharded" and bool(ok) and bool(jok)
    assert np.array_equal(np.asarray(out), np.asarray(jout))
    for i, d in enumerate(datas):
        assert np.array_equal(np.asarray(out)[i], decode_pixels(d))


def test_prep_matches_zpix_tpu():
    """prep_qoi_batch's offsets, chunk size and count are zpix_tpu's; its
    bytes are the same up to the zeros after the last image;
    _adaptive_chunk doubles the chunk as zpix_tpu's does."""
    datas = [qoi_enc(a) for a in qoi_images(64, 40)]
    for cb in (None, 32):
        p, j = tq.prep_qoi_batch(datas, cb), jq.prep_qoi_batch(datas, cb)
        for f in ("img_byte_start", "img_byte_end", "img_raw_end"):
            assert np.array_equal(getattr(p, f), getattr(j, f))
        assert (p.chunk_bytes, p.n_chunks, p.batch) == (j.chunk_bytes, j.n_chunks, j.batch)
        n = p.stream.shape[0]
        assert np.array_equal(p.stream, j.stream[:n]) and not j.stream[n:].any()
    for n in (10, 96_000, 97_000, 3_000_000, 10**9):
        assert tq._adaptive_chunk(n) == jq._adaptive_chunk(n)


def test_plain_matches_serial_decode_with_many_rounds():
    """K23's plain version where the rounds matter: 16-byte chunks over
    palette and screen-like content (index slots written early, read much
    later), pixels the host decoder's, ok True."""
    rng = np.random.default_rng(4)
    img = np.zeros((48, 64, 4), np.uint8)
    img[..., 3] = 255
    lut = rng.integers(0, 256, (40, 4), dtype=np.uint8)
    img[:] = lut[rng.integers(0, 40, (48, 64))]
    img[10:30, 5:50] = 9
    datas = [qoi_enc(img), qoi_enc(qoi_images(64, 48)[2])]
    plan = tq.prep_qoi_batch(datas, 16)
    rgba, ok, rounds = ks.spec_decode(
        *(torch.from_numpy(a) for a in (plan.stream, plan.img_byte_start, plan.img_byte_end,
                                        plan.img_raw_end)),
        n_chunks=plan.n_chunks, chunk_bytes=16, ops_cap=16, height=48, width=64)
    assert bool(ok) and int(rounds[0]) > 1
    for i, d in enumerate(datas):
        assert np.array_equal(rgba[i].numpy(), decode_pixels(d))


def test_metrics_count_images_and_time_the_prep():
    from zpix_tpu_torch.utils import metrics

    images = metrics.counters["qoi_onchip.images"]
    calls = metrics.timer_calls["qoi_onchip.prep"]
    _port(chunk_bytes=32).decode([qoi_enc(qoi_images()[0])] * 2)
    assert metrics.counters["qoi_onchip.images"] == images + 2
    assert metrics.timer_calls["qoi_onchip.prep"] == calls + 1


def _serial_ops(data: bytes):
    """The serial decode of a QOI stream's ops -> (hash of each op's pixel,
    INDEX flags, INDEX slots, each INDEX op's source: the last op before it
    whose pixel hashed to its slot, -1 where none), numpy [n]."""
    s, pos, end = data, 14, len(data) - 8
    idx, writer = [0] * 64, [-1] * 64
    r, g, b, a = 0, 0, 0, 255
    hs, is_idx, slots, srcs = [], [], [], []
    while pos < end:
        b1 = s[pos]
        j, src = 0, -1
        if b1 in (0xFE, 0xFF):
            r, g, b = s[pos + 1], s[pos + 2], s[pos + 3]
            a = s[pos + 4] if b1 == 0xFF else a
            pos += 4 if b1 == 0xFE else 5
        elif b1 >> 6 == 0:
            j = b1 & 63
            v, src = idx[j], writer[j]
            r, g, b, a = v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255
            pos += 1
        elif b1 >> 6 == 1:
            r, g, b = ((r + ((b1 >> 4) & 3) - 2) & 255, (g + ((b1 >> 2) & 3) - 2) & 255,
                       (b + (b1 & 3) - 2) & 255)
            pos += 1
        elif b1 >> 6 == 2:
            dg, b2 = (b1 & 63) - 32, s[pos + 1]
            r, g, b = ((r + dg + ((b2 >> 4) & 15) - 8) & 255, (g + dg) & 255,
                       (b + dg + (b2 & 15) - 8) & 255)
            pos += 2
        else:
            pos += 1
        h = (r * 3 + g * 5 + b * 7 + a * 11) & 63
        hs.append(h)
        is_idx.append(b1 >> 6 == 0)
        slots.append(j)
        srcs.append(src)
        idx[h] = r << 24 | g << 16 | b << 8 | a
        writer[h] = len(hs) - 1
    return (np.array(hs), np.array(is_idx), np.array(slots), np.array(srcs))


@pytest.mark.parametrize("tile", [32, 64, 2048])
@pytest.mark.parametrize("content", ["palette", "bench"])
def test_last_writer_sources_match_serial_and_sorted_sources(content, tile):
    """K23's sources as its passes find them (per-tile last-writer tables,
    their exclusive max over the tiles, 32-op groups inside a tile) equal
    the plain version's sort-based sources and the serial decode's, on the
    ops' true pixels (a palette image, nearly all INDEX ops with deep
    source chains, and the JAX bench's screen and noise), several images a
    batch."""
    from _torch_raster import bench_pixels

    if content == "palette":
        rng = np.random.default_rng(tile)
        lut = rng.integers(0, 256, (50, 4), dtype=np.uint8)
        imgs = [lut[rng.integers(0, 50, (40, 56))], qoi_images(56, 40)[2]]
    else:
        imgs = [bench_pixels(64, 3, "screen"), bench_pixels(64, 4, "noise")]
    rows = [_serial_ops(qoi_enc(im)) for im in imgs]
    P = max(len(r[0]) for r in rows) + 5  # rows of unequal length, padded
    h, t_idx, slot, want = (np.zeros((len(rows), P), np.int64) for _ in range(4))
    writer = np.zeros((len(rows), P), bool)
    t_idx = t_idx.astype(bool)
    want -= 1
    for i, (hs, ix, sl, sr) in enumerate(rows):
        n = len(hs)
        h[i, :n], t_idx[i, :n], slot[i, :n], want[i, :n], writer[i, :n] = hs, ix, sl, sr, True
    args = [torch.from_numpy(a) for a in (h, writer, t_idx, slot)]
    assert (want >= 0).sum() > 50
    sorted_src = ks.sources_sorted(*args)
    assert np.array_equal(sorted_src.numpy(), want)
    assert torch.equal(ks.sources_last_writer_plain(*args, tile=tile), sorted_src)


@pytest.mark.parametrize("seed", range(3))
def test_last_writer_sources_match_sorted_on_random_rows(seed):
    """Random hashes, writers, INDEX flags and slots, rows longer than a
    tile: the tiled last-writer sources equal the sorted ones."""
    rng = np.random.default_rng(seed)
    B, P = 3, 5000 + 977 * seed
    args = [torch.from_numpy(a) for a in (rng.integers(0, 64, (B, P)), rng.random((B, P)) < 0.9,
                                          rng.random((B, P)) < 0.5, rng.integers(0, 64, (B, P)))]
    assert torch.equal(ks.sources_last_writer_plain(*args), ks.sources_sorted(*args))
