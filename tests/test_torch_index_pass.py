"""K1, the index pass, and K2, the value pass: the port's block ends
against the JAX package's ``build_decode_fn(plan, _stage=1)``, and its
coefficients, DC diffs and ok against ``_stage=17`` (the value pass and
its agree check), on the same prep, fed to the port through
``plan_from_arrays``.  Exact: tolerance 0."""

import numpy as np
import pytest
import torch
from _torch_jpeg import port_plan_from_jax, synth_cmyk, synth_jpeg, synth_ratio_jpeg

from zpix_tpu.parallel.device_entropy import build_decode_fn
from zpix_tpu.parallel.device_entropy import prep_batch as jax_prep
from zpix_tpu_torch import DeviceJpegDecoder
from zpix_tpu_torch.ops import entropy as ke


def _port_ends(plan):
    bufs = DeviceJpegDecoder(device="cpu").upload(plan)
    return ke.index_pass(*bufs, bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)


CASES = {
    "420_dri2_batch2": lambda: [synth_jpeg(mode="420", phase=p) for p in (0.0, 1.0)],
    "cmyk": lambda: [synth_cmyk(None)],
    "dri1": lambda: [synth_jpeg(mode="420", dri_blocks=1)],
    "partial_last_segment": lambda: [synth_jpeg(mode="420", w=48, h=32, dri_blocks=4)],
    "444": lambda: [synth_jpeg(mode="444", w=40, h=24, dri_blocks=4)],
    "410_bpm10": lambda: [synth_ratio_jpeg(((4, 2), (1, 1), (1, 1)), 64, 32, dri=3)],
    "gray": lambda: [synth_jpeg(mode="gray", dri_blocks=3)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_ends_match_jax_stage1(case):
    datas = CASES[case]()
    jplan = jax_prep(datas)
    want_ends, want_ok = build_decode_fn(jplan, _stage=1)(
        jplan.stream, jplan.seg_bit_pos, jplan.seg_n_mcu)
    ends, ok = _port_ends(port_plan_from_jax(jplan, datas[0]))
    assert bool(want_ok) and bool(ok[0])
    assert np.array_equal(ends.numpy(), np.asarray(want_ends))


@pytest.mark.parametrize("case", ["dri1", "partial_last_segment", "444", "410_bpm10", "gray",
                                  "cmyk"])
def test_values_match_jax_stage17(case):
    """K2's AC rows and DC diffs against the JAX value pass's rows (the DC
    diff at position 0), and its ok after the agree check."""
    datas = CASES[case]()
    jplan = jax_prep(datas)
    want_rows, want_ok = build_decode_fn(jplan, _stage=17)(
        jplan.stream, jplan.seg_bit_pos, jplan.seg_n_mcu)
    plan = port_plan_from_jax(jplan, datas[0])
    if case == "partial_last_segment":
        assert plan.n_mcu % plan.seg_mcus
    bufs = DeviceJpegDecoder(device="cpu").upload(plan)
    ends, ok = ke.index_pass(*bufs, bpm=plan.bpm, nblk=plan.seg_mcus * plan.bpm)
    ac, dc = ke.value_pass(*bufs, ends, ok, bpm=plan.bpm)
    want_rows = np.asarray(want_rows)
    assert bool(want_ok) and bool(ok[0])
    assert np.array_equal(ac.numpy()[:, 1:], want_rows[:, 1:])
    assert not ac[:, 0].any()
    assert np.array_equal(dc.numpy().astype(np.int16), want_rows[:, 0])


def test_padding_blocks_of_partial_last_segment_stay_zero():
    data = synth_jpeg(mode="420", w=48, h=32, dri_blocks=4)  # 6 MCUs: 4 + 2
    jplan = jax_prep([data])
    ends, ok = _port_ends(port_plan_from_jax(jplan, data))
    assert bool(ok[0]) and jplan.seg_n_mcu.tolist() == [4, 2]
    last = ends[-1].numpy()
    assert (last[2 * jplan.bpm :] == 0).all() and (last[: 2 * jplan.bpm] > 0).all()


def test_invalid_code_clears_ok():
    """An all-ones code is invalid in every table libjpeg writes."""
    data = synth_jpeg(mode="420", phase=0.5)
    jplan = jax_prep([data])
    plan = port_plan_from_jax(jplan, data)
    plan.stream = plan.stream.copy()
    start = int(plan.seg_bit_pos[1]) // 8
    plan.stream[start : start + 4] = 0xFF
    _, ok = _port_ends(plan)
    assert not bool(ok[0])


def test_read_past_buffer_clears_ok():
    data = synth_jpeg(mode="gray")
    plan = port_plan_from_jax(jax_prep([data]), data)
    plan.seg_bit_pos = plan.seg_bit_pos.copy()
    plan.seg_bit_pos[-1] = 8 * (plan.stream.shape[0] - 4)
    _, ok = _port_ends(plan)
    assert not bool(ok[0])


def test_wrapper_takes_plain_version_only_on_cpu():
    data = synth_jpeg(mode="gray")
    plan = port_plan_from_jax(jax_prep([data]), data)
    bufs = DeviceJpegDecoder(device="cpu").upload(plan)
    got = ke.index_pass(*bufs, bpm=1, nblk=plan.seg_mcus)[0]
    want = ke.index_pass_plain(*bufs, bpm=1, nblk=plan.seg_mcus)[0]
    assert torch.equal(got, want)
    meta = [t.to("meta") for t in bufs]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        ke.index_pass(*meta, bpm=1, nblk=plan.seg_mcus)
