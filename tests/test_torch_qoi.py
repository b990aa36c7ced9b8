"""The port's QOI slice on the CPU (the kernels' plain versions) against
zpix_tpu on XLA:CPU and the host codec.  Exact: tolerance 0.

* K12's plain version, both formats, against zpix_tpu's
  ``build_qoi_lane_expand_fn`` on zpix_tpu's own host plans and on
  hand-built entries that overlap, leave gaps or lie outside the lane.
* K13's plain version against ``build_qoi_expand_fn`` on host records and
  on hand-built records with zero counts.
* ``HostIndexQoiDecoder(device="cpu")``, every route and format, against
  zpix_tpu's decoder and the host decoder.
* ``encode_device``/``encode_device_batch(device="cpu")`` (K14's plain
  version) against zpix_tpu's ``encode_device`` and the host encoder.
"""

import numpy as np
import pytest
import torch
from _torch_raster import (encode_cases, lane_entries, p4_entries, qoi_enc, qoi_images,
                           record_entries)

from zpix_tpu.codecs.qoi.decode import decode as jax_decode
from zpix_tpu.codecs.qoi.encode import Desc as JDesc
from zpix_tpu.codecs.qoi.encode import encode as jax_encode
from zpix_tpu.parallel import qoi_batch as jq
from zpix_tpu_torch import HostIndexQoiDecoder, encode_device, encode_device_batch
from zpix_tpu_torch.codecs.qoi.encode import Desc
from zpix_tpu_torch.errors import FormatError, UnsupportedError
from zpix_tpu_torch.ops import qoi as kq


def _t(a):
    """numpy -> CPU tensor; uint32 as the int32 of the same bits."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _datas():
    return [qoi_enc(i) for i in qoi_images()]


def _host(datas):
    return np.stack([jax_decode(d).pix for d in datas])


def _trunc(data):
    return data[: len(data) // 2] + b"\x00" * 8


# ------------------------------------------------------------ K12 lane expand


def _lane_plain(plan):
    shape = (plan.batch, plan.height, plan.width)
    if plan.fmt == "p4":
        return kq.lane_expand_p4(_t(plan.p4), P=plan.P, shape=shape)
    return kq.lane_expand_wide(_t(plan.cols), _t(plan.s), _t(plan.e), P=plan.P, shape=shape)


def _lane_jax(plan):
    fn = jq.build_qoi_lane_expand_fn(plan)
    if plan.fmt == "p4":
        return np.asarray(fn(plan.p4))
    return np.asarray(fn(plan.cols, plan.s, plan.e))


@pytest.mark.parametrize("P", [8, 16, 60])
@pytest.mark.parametrize("fmt", ["wide", "p4"])
def test_lane_expand_plain_matches_jax_on_host_plans(fmt, P):
    """zpix_tpu's own plan arrays into K12's plain version, a stream cut
    short among them (its tail is a fill entry)."""
    datas = _datas()
    if fmt == "p4":
        datas = [d for d, i in zip(datas, qoi_images()) if (i[..., 3] == 255).all()]
    datas = datas + [_trunc(datas[-1])]
    plan = (jq.prep_qoi_lanes4 if fmt == "p4" else jq.prep_qoi_lanes)(datas, P)
    assert plan.fmt == fmt
    got = _lane_plain(plan).numpy()
    assert np.array_equal(got, _lane_jax(plan)) and np.array_equal(got, _host(datas))


@pytest.mark.parametrize("P,R", [(16, 5), (12, 40), (300, 3)])
def test_lane_expand_plain_matches_jax_on_any_entries(P, R):
    """The masked sum on entries no host fill makes: overlaps add (uint32,
    wrapping), gaps give 0, spans outside [0, P) clip; p4 granules of
    random bytes."""
    rng = np.random.default_rng(P * R)
    B, lanes = 2, 6
    cols, s, e = lane_entries(rng, B * lanes, R, P)
    plan = jq.QoiLanePlan(P, lanes, P, cols, s, e, B, R)
    assert np.array_equal(_lane_plain(plan).numpy(), _lane_jax(plan))
    if P <= 255:
        p4 = p4_entries(rng, B * lanes, R)
        plan = jq.QoiLanePlan(P, lanes, P, None, None, None, B, R, fmt="p4", p4=p4)
        assert np.array_equal(_lane_plain(plan).numpy(), _lane_jax(plan))


def test_lane_expand_checks_shapes():
    p4 = torch.zeros(12, 16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        kq.lane_expand_p4(p4, P=16, shape=(1, 13, 16))  # lanes do not tile the pixels
    with pytest.raises(TypeError):
        kq.lane_expand_wide(torch.zeros(12, 4, dtype=torch.int32), p4[:, :4], p4[:, :4], P=16,
                            shape=(1, 12, 16))


# ---------------------------------------------------------- K13 sorted expand


def _sorted_both(plan):
    got = kq.sorted_expand(_t(plan.cols), _t(plan.cnts), _t(plan.fill),
                           shape=(plan.batch, plan.height, plan.width)).numpy()
    return got, np.asarray(jq.build_qoi_expand_fn(plan)(plan.cols, plan.cnts, plan.fill))


def test_sorted_expand_plain_matches_jax_on_host_records():
    datas = _datas() + [_trunc(_datas()[3])]
    got, want = _sorted_both(jq.prep_qoi_records(datas))
    assert np.array_equal(got, want) and np.array_equal(got, _host(datas))


@pytest.mark.parametrize("rcap", [20, 50, 300])
def test_sorted_expand_plain_matches_jax_on_zero_counts(rcap):
    """Zero counts inside the records (repeated prefix sums), totals short
    of the pixel count (fill) and past it (clip)."""
    rng = np.random.default_rng(rcap)
    cols, cnts, fill = record_entries(rng, 3, rcap)
    got, want = _sorted_both(jq.QoiRecordPlan(40, 24, cols, cnts, fill, 3, rcap))
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ decoder


@pytest.mark.parametrize("impl,fmt,P", [("lane", "auto", None), ("lane", "auto", 16),
                                        ("lane", "wide", 60), ("lane", "p4", 16),
                                        ("sorted", "auto", None)])
def test_decoder_matches_jax_and_host(impl, fmt, P):
    datas = _datas()
    if fmt == "p4":
        datas = [d for d, i in zip(datas, qoi_images()) if (i[..., 3] == 255).all()]
    datas = datas + [_trunc(datas[-1])]
    got = HostIndexQoiDecoder(impl=impl, lane_fmt=fmt, lane_p=P, device="cpu").decode(datas)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = np.asarray(jq.HostIndexQoiDecoder(impl=impl, lane_fmt=fmt, lane_p=P).decode(datas))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), _host(datas))


def test_decoder_auto_falls_back_on_alpha_and_keeps_hints():
    """auto: p4 on an opaque batch, the wide form on a batch with alpha,
    batch by batch; p4 raises on alpha; the R hints grow, not shrink."""
    imgs = qoi_images()
    opaque = [qoi_enc(i) for i in imgs if (i[..., 3] == 255).all()]
    alpha = [qoi_enc(imgs[3])]
    dec = HostIndexQoiDecoder(lane_p=16, device="cpu")
    assert dec.prep(opaque).fmt == "p4" and dec.prep(alpha).fmt == "wide"
    for batch in (opaque, alpha, opaque):
        assert np.array_equal(dec.decode(batch).numpy(), _host(batch))
    assert dec._r4_hint > 0 and dec._r_hint > 0
    r4 = dec._r4_hint
    dec.decode([qoi_enc(imgs[1])])  # a flat image needs fewer slots
    assert dec._r4_hint == r4
    with pytest.raises(UnsupportedError):
        HostIndexQoiDecoder(lane_fmt="p4", device="cpu").decode(alpha)
    with pytest.raises(ValueError):
        HostIndexQoiDecoder(impl="loop", device="cpu")


@pytest.mark.parametrize("fmt", ["p4", "wide"])
def test_decoder_fills_the_staging_buffer_in_place(fmt):
    """Once a batch has set the R hint, the lane pass writes its plan
    straight into the upload's staging buffer, so the upload packs nothing;
    the pixels stay exact batch after batch, the buffer being reused."""
    datas = _datas()
    if fmt == "p4":
        datas = [d for d, i in zip(datas, qoi_images()) if (i[..., 3] == 255).all()]
    dec = HostIndexQoiDecoder(lane_p=16, lane_fmt=fmt, device="cpu")
    for batch in (datas, datas[::-1], datas):
        plan = dec.prep(batch)
        assert plan.fmt == fmt
        arrs = [plan.p4] if fmt == "p4" else [plan.cols, plan.s, plan.e]
        staging = dec._upload._staging.numpy()
        in_place = all(np.shares_memory(a, staging) for a in arrs)
        assert np.array_equal(dec.run(plan, dec.upload(plan)).numpy(), _host(batch))
    assert in_place  # the last batch, at the layout of the first


def test_decoder_run_clip_and_default_lane_width():
    img = np.full((6, 11, 4), 200, np.uint8)  # 66 px: a run of 62, then 4
    data = qoi_enc(img)
    dec = HostIndexQoiDecoder(device="cpu")
    assert dec.prep([data] * 2).P == 22  # 32 shrinks to a divisor of 66
    assert np.array_equal(dec.decode([data] * 2).numpy()[1], img)


def test_entry_points_need_cuda_unless_cpu():
    from zpix_tpu_torch import BatchBmpDecoder

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = qoi_images()[0]
    for make in (HostIndexQoiDecoder, BatchBmpDecoder,
                 lambda: encode_device(img, Desc(40, 24, 4, 0)),
                 lambda: encode_device_batch([img], [Desc(40, 24, 4, 0)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ------------------------------------------------------------------ encoder


@pytest.mark.parametrize("case", range(len(encode_cases())))
def test_encode_device_matches_host(case):
    img, ch = encode_cases()[case]
    h, w = img.shape[:2]
    got = encode_device(img, Desc(w, h, ch, 0), device="cpu")
    assert got == jax_encode(img, JDesc(w, h, ch, 0))
    assert np.array_equal(jax_decode(got).pix[..., :ch], img)


def test_encode_device_matches_jax():
    from zpix_tpu.parallel.qoi_batch import encode_device as jax_encode_device

    # the cases of zpix_tpu's test_encode_device_byte_identical and
    # test_encode_device_edge_sizes
    for i, (img, ch) in enumerate(encode_cases()[:12]):
        h, w = img.shape[:2]
        got = encode_device(torch.from_numpy(img), Desc(w, h, ch, 0), device="cpu")
        assert got == jax_encode_device(img, JDesc(w, h, ch, 0)), i


def test_encode_device_batch_matches_jax_and_host():
    from zpix_tpu.parallel.qoi_batch import encode_device_batch as jax_batch

    imgs = qoi_images()
    descs = [Desc(40, 24, 4, c % 2) for c in range(len(imgs))]
    jdescs = [JDesc(40, 24, 4, c % 2) for c in range(len(imgs))]
    got = encode_device_batch(np.stack(imgs), descs, device="cpu")
    assert got == jax_batch(imgs, jdescs)
    assert got == [jax_encode(i, d) for i, d in zip(imgs, jdescs)]
    rgb = [i[..., :3] for i in imgs]
    got3 = encode_device_batch(rgb, [Desc(40, 24, 3, 0)] * 4, device="cpu")
    assert got3 == [jax_encode(i, JDesc(40, 24, 3, 0)) for i in rgb]


def test_encode_plain_tail_and_zeros():
    """K14's plain output past each image's total is zero, and the totals
    count the tail flush."""
    px = torch.tensor([[0xFF, 0xFF, 0x01020304, 0x01020304, 0x01020304]], dtype=torch.int32)
    out, total = kq.encode(px)
    assert int(total[0]) == 1 + 5 + 1  # RUN(2), RGBA, RUN(2)
    assert out.shape == (1, kq.encode_cap(5)) and not out[0, int(total[0]):].any()


def test_encode_device_errors():
    img = qoi_images()[0]
    with pytest.raises(FormatError):
        encode_device(img, Desc(40, 24, 5, 0), device="cpu")
    with pytest.raises(FormatError):
        encode_device(img[:3], Desc(40, 24, 4, 0), device="cpu")
    with pytest.raises(UnsupportedError):
        encode_device_batch([img, img], [Desc(40, 24, 4, 0), Desc(24, 40, 4, 0)], device="cpu")
