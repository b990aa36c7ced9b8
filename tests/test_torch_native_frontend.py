"""The port's copy of the native C++ front-end (csrc/host/entropy.cpp,
built by zpix_tpu_torch/runtime/host.py) against zpix_tpu's own build of
the same functions: parse_packed_native, NativeBatchFrontEnd.parse and
pack_sparse give the same bitmaps, values, quants, nnz and perms.
Exact: tolerance 0."""

import numpy as np
import pytest
from _torch_jpeg import (jax_native_lib, synth_cmyk, synth_jpeg, synth_plain_jpeg,
                         synth_ratio_jpeg, synth_rgb)

from zpix_tpu.parallel import batch as jb
from zpix_tpu_torch.errors import UnsupportedError
from zpix_tpu_torch.parallel import batch as tb
from zpix_tpu_torch.runtime import host

CASES = {
    "gray": lambda p: synth_plain_jpeg(w=37, h=29, mode="gray", phase=p),
    "444": lambda p: synth_plain_jpeg(w=37, h=29, mode="444", phase=p),
    "422": lambda p: synth_plain_jpeg(w=37, h=29, mode="422", phase=p),
    "420": lambda p: synth_plain_jpeg(w=51, h=35, mode="420", phase=p),
    "420-dri": lambda p: synth_jpeg(w=51, h=35, mode="420", dri_blocks=3, phase=p),
    "gray-dri": lambda p: synth_jpeg(w=37, h=29, mode="gray", dri_blocks=5, phase=p),
    "440": lambda p: synth_ratio_jpeg([(1, 2), (1, 1), (1, 1)], 43, 27, seed=int(10 * p)),
    "411": lambda p: synth_ratio_jpeg([(4, 1), (1, 1), (1, 1)], 43, 27, seed=int(10 * p)),
    "410": lambda p: synth_ratio_jpeg([(4, 2), (1, 1), (1, 1)], 43, 27, seed=int(10 * p)),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_lib():
    jax_native_lib()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_parse_packed_native_matches_jax(case, threads):
    data = CASES[case](0.3)
    got = tb.parse_packed_native(data, threads)
    want = jb.parse_packed_native(data, threads)
    assert got is not None and want is not None
    assert (got.width, got.height, got.ratio, got.ncomp) == (
        want.width, want.height, want.ratio, want.ncomp)
    assert [tuple(x) for x in got.hv] == [tuple(x) for x in want.hv]
    for c in range(got.ncomp):
        assert np.array_equal(got.bitmaps[c], want.bitmaps[c])
        assert np.array_equal(got.vals[c], want.vals[c])
        assert np.array_equal(got.quants[c], want.quants[c])
        assert (got.perms[c] is None) == (want.perms[c] is None)
        if got.perms[c] is not None:
            assert np.array_equal(got.perms[c], want.perms[c])


@pytest.mark.parametrize("case", list(CASES))
def test_batch_front_end_matches_jax(case):
    datas = [CASES[case](p) for p in (0.0, 0.7, 1.4)]
    want = jb.NativeBatchFrontEnd(datas[0], 3, 2)
    want.parse(datas)
    written = []
    for threads in (1, 4):
        got = tb.NativeBatchFrontEnd(datas[0], 3, threads)
        pk = got.parse(datas)
        assert got.layout[: len(want.layout)] == [tuple(x) for x in want.layout]
        # every byte the parse writes (a new buffer's other bytes are not
        # set): the bitmaps, each image's values up to its count, the quants
        parts = []
        for c in range(got.ncomp):
            bm, vals, q = (tb.carve(pk.buffer, pk.layout, k, c, 3).numpy()
                           for k in ("bm", "val", "q"))
            assert np.array_equal(bm.reshape(want.bitmaps[c].shape), want.bitmaps[c])
            assert np.array_equal(pk.nnz[:, c], want.nnz[:, c])
            wv = want.vals[c].reshape(vals.shape)
            for b in range(3):
                n = int(pk.nnz[b, c])
                assert np.array_equal(vals[b, :n], wv[b, :n])
                parts.append(vals[b, :n].copy())
            assert np.array_equal(q, want.quants[c].reshape(q.shape))
            parts += [bm.copy(), q.copy()]
        written.append(parts)
        for p, q in ((pk.perm_y, want.perm_y), (pk.perm_c, want.perm_c)):
            assert (p is None) == (q is None) and (p is None or np.array_equal(p, q))
    assert all(np.array_equal(a, b) for a, b in zip(*written))  # 1 thread == 4 threads


@pytest.mark.parametrize("case", ["444", "420"])
def test_pack_sparse_matches_jax(case):
    from zpix_tpu.parallel.batch import parse_coefficients

    fe = parse_coefficients(CASES[case](0.5))
    for coeff in fe.coeffs:
        bm, vals = tb.pack_sparse(coeff)
        want_bm, want_vals = jb.pack_sparse(coeff)
        assert np.array_equal(bm, want_bm) and np.array_equal(vals, want_vals)
        mask = np.unpackbits(bm, axis=1).astype(bool)
        flat = coeff.reshape(-1, 64)
        assert np.array_equal(mask, flat != 0)
        assert np.array_equal(vals, flat[mask].astype(np.int16))


def test_pack_sparse_avx512_arm_matches_scalar_arm():
    """The AVX-512 arm of zpix_pack_sparse (built where the CPU has
    AVX-512 VBMI2) against the scalar arm the default build takes."""
    with open("/proc/cpuinfo") as f:
        if "avx512_vbmi2" not in f.read():
            pytest.skip("no AVX-512 VBMI2 on this CPU")
    rng = np.random.default_rng(0)
    coeff = rng.integers(-3000, 3000, (9, 11, 64)).astype(np.int32)
    coeff[rng.random(coeff.shape) < 0.8] = 0
    outs = []
    for flags in ((), ("-mavx512f", "-mavx512bw", "-mavx512vl", "-mavx512vbmi2")):
        lib = host.lib(flags)
        bm = np.empty((99, 8), np.uint8)
        vals = np.empty(coeff.size, np.int16)
        n = lib.zpix_pack_sparse(coeff.ctypes.data, 99, bm.ctypes.data, vals.ctypes.data,
                                 coeff.size)
        outs.append((bm, vals[:n]))
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("make", [synth_rgb, synth_cmyk], ids=["rgb", "cmyk"])
def test_refused_streams(make):
    data = make()
    assert tb.parse_packed_native(data) is None
    assert jb.parse_packed_native(data) is None
    with pytest.raises(UnsupportedError):  # cmyk at the SOF peek, rgb in the C parse
        tb.NativeBatchFrontEnd(data, 1).parse([data])
