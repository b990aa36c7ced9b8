"""The port's BMP slice on the CPU (K18's plain version) against zpix_tpu.
Exact: tolerance 0.

* ``_read_header`` against zpix_tpu's on files from the port's numpy
  writer, every arm, and on damaged headers: the same exception class and
  message.
* K18's plain version against zpix_tpu's ``BatchBmpDecoder`` on every arm
  (bpp 1/2/4/8/24/32, headers of 40/108/124 bytes, both orientations, a
  palette shorter than 2^bpp).
* ``BatchBmpDecoder(device="cpu")`` against
  ``zpix_tpu.codecs.bmp.decode(...).rgba_pixels()``.
"""

import struct

import numpy as np
import pytest
import torch
from _torch_raster import bmp_arms, bmp_batch

from zpix_tpu import errors as jerr
from zpix_tpu.codecs.bmp import decode as jax_decode
from zpix_tpu.codecs.bmp.decode import _read_header as jax_read_header
from zpix_tpu.parallel.bmp_batch import BatchBmpDecoder as JaxBatchBmpDecoder
from zpix_tpu_torch import BatchBmpDecoder
from zpix_tpu_torch import errors as terr
from zpix_tpu_torch.codecs.bmp.decode import _read_header
from zpix_tpu_torch.ops.bmp import bmp_unpack_plain

ARMS = bmp_arms()
ARM_IDS = [f"{b}bpp-{i}-{'td' if t else 'bu'}{'-short' if s else ''}" for b, i, t, s in ARMS]


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_read_header_matches(arm):
    for data in bmp_batch(arm, 5, 9, batch=2):
        a, b = jax_read_header(data), _read_header(data)
        assert a[:5] == b[:5] and a[6] == b[6]
        assert (a[5] is None) == (b[5] is None)
        if a[5] is not None:
            assert a[5].dtype == b[5].dtype and np.array_equal(a[5], b[5])


def _patch(data, off, fmt, value):
    out = bytearray(data)
    struct.pack_into(fmt, out, off, value)
    return bytes(out)


def _bad_headers():
    pal8 = bmp_batch((8, 40, False, False), 4, 4, batch=1)[0]
    rgb = bmp_batch((24, 108, False, False), 4, 4, batch=1)[0]
    argb = bmp_batch((32, 124, False, False), 4, 4, batch=1)[0]
    return {
        "truncated_header": pal8[:17],
        "signature": b"BX" + pal8[2:],
        "header_version": _patch(pal8, 14, "<I", 64),
        "truncated_info": rgb[:60],
        "negative_width": _patch(pal8, 18, "<i", -4),
        "planes": _patch(pal8, 26, "<H", 2),
        "rle": _patch(pal8, 30, "<I", 1),
        "bitfields_v3": _patch(_patch(pal8, 30, "<I", 3), 28, "<H", 32),
        "bitfields_masks": _patch(argb, 54, "<I", 0x00FF00),
        "palette_size": _patch(pal8, 46, "<I", 300),
        "color_offset": _patch(pal8, 10, "<I", 60),
        "rgb_offset": _patch(rgb, 10, "<I", 200),
        "truncated_palette": pal8[:14 + 40 + 100],
        "bit_depth": _patch(rgb, 28, "<H", 16),
    }


@pytest.mark.parametrize("name", list(_bad_headers()))
def test_read_header_errors_match(name):
    data = _bad_headers()[name]
    with pytest.raises(jerr.ZpixError) as want:
        jax_read_header(data)
    with pytest.raises(getattr(terr, type(want.value).__name__)) as got:
        _read_header(data)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_unpack_plain_matches_jax(arm):
    """zpix_tpu's batched decode against the port's prep + K18's plain
    version, on 3 distinct images of an odd width (padded rows)."""
    datas = bmp_batch(arm, 7, 13)
    rows, pal, (width, _h, top_down, bpp, allow_alpha) = BatchBmpDecoder(device="cpu").prep(datas)
    got = bmp_unpack_plain(torch.from_numpy(rows), torch.from_numpy(pal), bpp=bpp, width=width,
                           top_down=top_down, allow_alpha=allow_alpha)
    assert np.array_equal(got.numpy(), np.asarray(JaxBatchBmpDecoder().decode(datas)))


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_decoder_matches_host_decode(arm):
    """The batch decode against the host decoder's premultiplied RGBA.  A
    short palette's indices past its end have no host colour (the host
    decoder indexes out of range); there the batch path gives 0, 0, 0, 0
    and zpix_tpu's batch decode is the oracle."""
    datas = bmp_batch(arm, 6, 11, seed=5)
    got = BatchBmpDecoder(device="cpu").decode(datas)
    assert got.shape == (3, 6, 11, 4) and got.dtype == torch.uint8
    for k, d in enumerate(datas):
        img = jax_decode(d)
        if arm[3] and (img.pix >= len(img.palette)).any():
            want = np.asarray(JaxBatchBmpDecoder().decode([d]))[0]
            assert (got[k].numpy()[img.pix >= len(img.palette)] == 0).all()
        else:
            want = img.rgba_pixels().reshape(6, 11, 4)
        assert np.array_equal(got[k].numpy(), want), k


def test_decoder_errors():
    datas = bmp_batch((24, 40, False, False), 6, 11)
    dec = BatchBmpDecoder(device="cpu")
    with pytest.raises(terr.UnexpectedEof):
        dec.decode(datas[:1] + [datas[1][:-5]])
    other = bmp_batch((24, 40, True, False), 6, 11)[0]  # top-down: another batch key
    with pytest.raises(terr.UnsupportedError):
        dec.decode([datas[0], other])
    with pytest.raises(ValueError):
        dec.decode([])
