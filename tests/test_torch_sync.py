"""The port's SyncJpegDecoder (K19 -> K2 -> K3 -> K4) on the CPU (the
kernels' plain versions) against zpix_tpu's on XLA:CPU and the host
decoder.  Exact: tolerance 0.

Three JAX builds, shared by module-scoped fixtures on one 4:2:0 batch
shape (every damaged batch keeps that shape, so its calls hit the jit
cache): ``build_sync_decode_fn(_stage=3)``, ``decode_coefficients`` and
``decode``.  Every other case is held against the host decoder only.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_jpeg import (host_pixels, jax_native_lib, synth_cmyk, synth_jpeg,
                         synth_plain_jpeg, synth_ratio_jpeg, synth_rgb, truncate_scan)
from PIL import Image

from zpix_tpu import errors as jerr
from zpix_tpu.parallel import device_entropy_sync as jds
from zpix_tpu_torch import HostIndexJpegDecoder, SyncJpegDecoder, prep_batch_sync
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.ops import sync as ksync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _invalid_codes(data: bytes) -> bytes:
    """FF00 pairs in mid-scan: they destuff to FF bytes, and an all-ones
    16-bit code is invalid in every table libjpeg writes."""
    out = bytearray(data)
    mid = (data.find(b"\xff\xda") + len(data)) // 2
    while out[mid - 1] == 0xFF:
        mid += 1
    out[mid : mid + 8] = b"\xff\x00" * 4
    if out[mid + 8] == 0x00:
        out[mid + 8] = 0x01
    return bytes(out)


def _flipped(data: bytes) -> bytes:
    """16 scan bytes XORed with 0x55, from the scan's middle."""
    out = bytearray(data)
    mid = (data.find(b"\xff\xda") + len(data)) // 2
    for i in range(mid, mid + 16):
        out[i] ^= 0x55
    return bytes(out)


@pytest.fixture(scope="module")
def batch():
    """Two 4:2:0 images whose scans differ in length (1,428 and 1,446
    bytes), so the shorter image has empty chunks at its end."""
    return [synth_plain_jpeg(w=64, h=48, mode="420", phase=p) for p in (0.0, 0.3)]


@pytest.fixture(scope="module")
def cases(batch):
    return {"clean": batch, "invalid_codes": [_invalid_codes(batch[0]), batch[1]],
            "truncated": [truncate_scan(batch[0], 10), batch[1]],
            "flipped": [batch[0], _flipped(batch[1])]}


@pytest.fixture(scope="module")
def jax_stage3(batch):
    return jds.build_sync_decode_fn(jds.prep_batch_sync(batch), _stage=3)


@pytest.fixture(scope="module")
def jax_decoder():
    jax_native_lib()
    return jds.SyncJpegDecoder()


def _outcome(fn, errors):
    try:
        return "ok", fn()
    except errors.ZpixError as exc:
        return type(exc).__name__, str(exc)


def test_prep_matches_jax(batch):
    """The stream bytes, bit starts and ends, mb and the geometry of
    zpix_tpu's prep; the chunk count without its x32 buckets.  (The table
    indices differ: zpix_tpu's sync prep numbers its tables DC first, the
    port's packed tables AC first, as its restart path does.)"""
    got, want = prep_batch_sync(batch), jds.prep_batch_sync(batch)
    assert np.array_equal(got.stream, want.stream)
    assert np.array_equal(got.img_bit_start, want.img_bit_start)
    assert np.array_equal(got.img_bit_end, want.img_bit_end)
    assert got.mb == want.mb == 128 and got.chunk_bytes == want.chunk_bytes
    longest = int((want.img_bit_end - want.img_bit_start).max()) // 8
    assert got.n_chunks == -(-longest // 32) and want.n_chunks == -(-got.n_chunks // 32) * 32
    for f in ("width", "height", "ncomp", "hv", "ratio", "mxx", "myy", "bpm", "comp_of_slot",
              "n_mcu", "color"):
        assert getattr(got, f) == getattr(want, f), f
    assert all(np.array_equal(a, b) for a, b in zip(got.quants, want.quants))
    assert got.seg_n_mcu.tolist() == [got.n_mcu] * 2


def test_prep_errors_match_jax(batch):
    """DRI > 0 and a batch of mixed tables raise UnsupportedError in both
    packages, an empty batch ValueError."""
    restart = synth_jpeg(w=64, h=48, dri_blocks=2)
    other_q = synth_plain_jpeg(w=64, h=48, mode="420", quality=90)
    for datas in ([restart], [batch[0], other_q], [batch[0], synth_plain_jpeg(w=72, h=48)]):
        got = _outcome(lambda: prep_batch_sync(datas), terr)
        want = _outcome(lambda: jds.prep_batch_sync(datas), jerr)
        assert got[0] == want[0] == "UnsupportedError"
    for prep in (prep_batch_sync, jds.prep_batch_sync):
        with pytest.raises(ValueError, match="empty batch"):
            prep([])


@pytest.mark.parametrize("name", ["clean", "invalid_codes", "truncated", "flipped"])
def test_sync_ends_plain_matches_jax(cases, jax_stage3, name):
    """sync_ends_plain's ends and flag against build_sync_decode_fn's
    stage 3 (ends and end_ok & err_ok & total_ok), with the links on sync
    chunks (the default) and on the chunks themselves; ends compared where
    the flag holds."""
    datas = cases[name]
    jp = jds.prep_batch_sync(datas)
    want_ends, want_flag = (np.asarray(x) for x in jax_stage3(
        jp.stream, jp.img_bit_start, jp.img_bit_end))
    plan = prep_batch_sync(datas)
    b = SyncJpegDecoder(device="cpu").upload(plan)
    runs = [ksync.sync_ends_plain(b[0], b[1], b[4], b[3], chunk_bytes=32,
                                  n_chunks=plan.n_chunks, bpm=plan.bpm,
                                  nblk=plan.n_mcu * plan.bpm, sync_bytes=sb)
            for sb in (None, 32)]
    for ends, ok, _entries, _misses in runs:
        assert bool(ok) == bool(want_flag)
        if bool(want_flag):
            assert np.array_equal(ends.numpy(), want_ends)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][2], runs[1][2])
    assert bool(want_flag) == (name == "clean")


def test_decoder_coefficients_match_jax(batch, jax_decoder):
    want, want_ok = jax_decoder.decode_coefficients(jds.prep_batch_sync(batch))
    got, ok = SyncJpegDecoder(device="cpu").decode_coefficients(prep_batch_sync(batch))
    assert bool(want_ok) and bool(ok) and ok.dim() == 0
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["clean", "invalid_codes", "truncated", "flipped"])
def test_decoder_matches_jax_and_host(cases, jax_decoder, name):
    """Pixels and ok against zpix_tpu's decode (and the host decoder where
    ok holds); the damaged batches give ok False in both, or the same
    refusal in prep."""
    datas = cases[name]
    got = _outcome(lambda: SyncJpegDecoder(device="cpu").decode(datas), terr)
    want = _outcome(lambda: jax_decoder.decode(datas), jerr)
    if got[0] != "ok":
        assert got == want
        return
    (px, ok), (jpx, jok) = got[1], want[1]
    assert bool(ok) == bool(jok) == (name == "clean")
    if bool(ok):
        assert np.array_equal(px.numpy(), np.asarray(jpx))
        for i, d in enumerate(datas):
            assert np.array_equal(px[i].numpy(), host_pixels(d))


def _flat_jpeg(size=128):
    buf = io.BytesIO()
    Image.fromarray(np.full((size, size, 3), 128, np.uint8)).save(
        buf, format="JPEG", quality=50, subsampling=2)
    return buf.getvalue()


HOST_CASES = {
    "gray_bpm1": lambda: [synth_plain_jpeg(w=56, h=40, mode="gray", phase=p) for p in (0, 1.5)],
    "444": lambda: [synth_plain_jpeg(w=40, h=32, mode="444", phase=p) for p in (0, 1.5)],
    "422": lambda: [synth_plain_jpeg(w=40, h=32, mode="422", phase=p) for p in (0, 1.5)],
    "411": lambda: [synth_ratio_jpeg(((4, 1), (1, 1), (1, 1)), 64, 24, s) for s in (0, 1)],
    "440": lambda: [synth_ratio_jpeg(((1, 2), (1, 1), (1, 1)), 40, 32, s) for s in (0, 1)],
    "cmyk": lambda: [synth_cmyk(None, 48, 32, s, dri_blocks=None) for s in (0, 1)],
    "ycck": lambda: [synth_cmyk(2, 48, 32, s, dri_blocks=None) for s in (0, 1)],
    "rgb": lambda: [synth_rgb(48, 32, s, dri_blocks=None) for s in (0, 1)],
    "flat": lambda: [_flat_jpeg()],
    "one_chunk": lambda: [synth_plain_jpeg(w=8, h=8, mode="gray")],
}


@pytest.mark.parametrize("chunk_bytes", [32, 256])
@pytest.mark.parametrize("name", list(HOST_CASES))
def test_cases_match_host_decoder(name, chunk_bytes):
    """Every sampling and colour arm, a flat image (the most blocks a
    chunk can end: DC + EOB, a few bits each), a scan shorter than one
    chunk, and 256-byte chunks: ok and the host decoder's pixels."""
    datas = HOST_CASES[name]()
    plan = prep_batch_sync(datas, chunk_bytes)
    if name == "one_chunk":
        assert plan.n_chunks == 1
    px, ok = SyncJpegDecoder(chunk_bytes=chunk_bytes, device="cpu").decode(datas)
    assert bool(ok)
    for i, d in enumerate(datas):
        want = host_pixels(d)
        assert np.array_equal(px[i].numpy(), want[..., : px.shape[-1]] if px.dim() == 4 else want)


def test_flat_chunks_fill_their_capacity():
    """A flat image's chunks end the most blocks (DC + EOB, ~5 bits each;
    zpix_tpu's capacity case, test_device_entropy_sync.py:109-123): 48 a
    chunk here, within mb, and the ends equal the host index scan's."""
    from zpix_tpu_torch import prep_batch_host_index

    datas = [_flat_jpeg(256)]
    plan = prep_batch_sync(datas)
    b = SyncJpegDecoder(device="cpu").upload(plan)
    ends, ok, _e, _r = ksync.sync_ends(b[0], b[1], b[4], b[3], chunk_bytes=32,
                                      n_chunks=plan.n_chunks, bpm=plan.bpm,
                                      nblk=plan.n_mcu * plan.bpm)
    assert bool(ok)
    assert np.array_equal(ends.numpy(), prep_batch_host_index(datas).ends)
    per_chunk = np.bincount((ends.numpy()[0] - 1 - int(plan.img_bit_start[0])) // 256)
    assert 40 <= per_chunk.max() <= plan.mb


def test_entries_are_the_serial_decode_states(batch):
    """The converged entries against a serial walk (one lane, the plain
    scan chunk after chunk): every chunk enters at the state the serial
    decode has at its start, and chunk 0 at the image's start."""
    from zpix_tpu_torch.ops.entropy import _Tables

    plan = prep_batch_sync(batch)
    b = SyncJpegDecoder(device="cpu").upload(plan)
    _ends, ok, entries, _misses = ksync.sync_ends(
        b[0], b[1], b[4], b[3], chunk_bytes=32, n_chunks=plan.n_chunks, bpm=plan.bpm,
        nblk=plan.n_mcu * plan.bpm)
    assert bool(ok)
    tab, s64 = _Tables(b[3]), b[0].to(torch.int64)
    cs, _ce = ksync.chunk_bounds(b[1], b[4], n_chunks=plan.n_chunks, chunk_bytes=32)
    for img in range(2):
        one = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
        state = (one(int(b[1][img])), one(0), one(0), one(0))
        for c in range(plan.n_chunks):
            bound = cs.view(2, -1)[img, c : c + 1]
            state, *_ = ksync._scan(tab, s64, b[0].shape[0], state, bound, plan.bpm)
            assert int(ksync.pack_entries(*state)) == int(entries[img, c]), (img, c)


def test_refused_inputs():
    with pytest.raises(terr.UnsupportedError):
        SyncJpegDecoder(device="cpu").decode([synth_jpeg(w=48, h=32, dri_blocks=2)])
    with pytest.raises(ValueError):
        prep_batch_sync([])
    plan = prep_batch_sync([synth_plain_jpeg()])
    b = SyncJpegDecoder(device="cpu").upload(plan)
    with pytest.raises(ValueError):
        ksync.sync_ends(b[0], b[1], b[4], b[3], chunk_bytes=32, n_chunks=plan.n_chunks,
                        bpm=17, nblk=plan.n_mcu * plan.bpm)
    with pytest.raises(TypeError):
        ksync.sync_ends(b[0], b[1].long(), b[4], b[3], chunk_bytes=32, n_chunks=plan.n_chunks,
                        bpm=plan.bpm, nblk=plan.n_mcu * plan.bpm)


def test_matches_host_index_route(batch):
    """The same pixels and ok as HostIndexJpegDecoder(planar=False), and
    the same block ends as its host index scan."""
    from zpix_tpu_torch import prep_batch_host_index

    px, ok = SyncJpegDecoder(device="cpu").decode(batch)
    hx, hok = HostIndexJpegDecoder(device="cpu").decode(batch)
    assert bool(ok) and bool(hok) and torch.equal(px, hx)
    plan = prep_batch_sync(batch)
    b = SyncJpegDecoder(device="cpu").upload(plan)
    ends, *_ = ksync.sync_ends(b[0], b[1], b[4], b[3], chunk_bytes=32,
                               n_chunks=plan.n_chunks, bpm=plan.bpm, nblk=plan.n_mcu * plan.bpm)
    assert np.array_equal(ends.numpy(), prep_batch_host_index(batch).ends)


def test_sync_modules_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys, zpix_tpu_torch, zpix_tpu_torch.ops.sync, "
        "zpix_tpu_torch.parallel.device_entropy_sync\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'zpix_tpu' or m.startswith('zpix_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_decoder_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncJpegDecoder()


@pytest.mark.parametrize("name", ["batch_420", "gray_bpm1", "cmyk", "flat"])
def test_forced_misses_leave_entries_and_ends(batch, name):
    """Links on the 32-byte chunks themselves (sync_bytes 32) miss often:
    the walk puts in and scans each missed entry, and the entries, ends
    and ok do not move from the default sync chunks' or 512-byte ones'."""
    datas = batch if name == "batch_420" else HOST_CASES[name]()
    plan = prep_batch_sync(datas)
    b = SyncJpegDecoder(device="cpu").upload(plan)
    kw = dict(chunk_bytes=32, n_chunks=plan.n_chunks, bpm=plan.bpm, nblk=plan.n_mcu * plan.bpm)
    runs = {sb: ksync.sync_ends(b[0], b[1], b[4], b[3], sync_bytes=sb, **kw)
            for sb in (None, 32, 512)}
    base = runs[None]
    assert bool(base[1])
    for sb, (ends, ok, entries, _misses) in runs.items():
        assert torch.equal(ends, base[0]) and torch.equal(entries, base[2]), sb
        assert torch.equal(ok, base[1]), sb
    if name == "batch_420":
        assert runs[32][3] > runs[None][3]
