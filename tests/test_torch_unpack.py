"""K7's plain version (ops/sparse.py::unpack_sparse_plain, the CPU arm
of unpack_sparse) against zpix_tpu's _unpack_sparse_graph + _apply_perm
on XLA:CPU.  Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpix_tpu.parallel.batch import _apply_perm, _unpack_sparse_graph
from zpix_tpu.parallel.batch import stream_perm as jax_stream_perm
from zpix_tpu_torch.ops.sparse import unpack_sparse
from zpix_tpu_torch.parallel.batch import stream_perm


def _jax(bitmap, vals, bv, bh, perm):
    out = _unpack_sparse_graph(jnp, jnp.asarray(bitmap), jnp.asarray(vals), bv, bh)
    return np.asarray(_apply_perm(jnp, out, None if perm is None else jnp.asarray(perm),
                                  bv, bh))


@pytest.mark.parametrize("hv", [(1, 1), (2, 2), (2, 1), (4, 2)])
@pytest.mark.parametrize("cap", ["exact", "clipped"])
def test_unpack_matches_jax(hv, cap):
    rng = np.random.default_rng(10 * hv[0] + hv[1] + 100 * (cap == "clipped"))
    mxx, myy, B = 5, 3, 3
    bv, bh = myy * hv[1], mxx * hv[0]
    bitmap = (rng.integers(0, 256, (B, bv * bh, 8)) & rng.integers(0, 256, (B, bv * bh, 8))
              ).astype(np.uint8)
    nnz = np.unpackbits(bitmap, axis=-1).reshape(B, -1).sum(1)
    width = int(nnz.max()) + 7 if cap == "exact" else int(nnz.min()) // 3
    vals = rng.integers(-2**15, 2**15, (B, width)).astype(np.int16)
    perm = stream_perm(mxx, myy, *hv)
    jperm = jax_stream_perm(mxx, myy, *hv)
    assert (perm is None) == (jperm is None)
    assert perm is None or np.array_equal(perm, jperm)
    got = unpack_sparse(torch.from_numpy(bitmap), torch.from_numpy(vals), bv=bv, bh=bh,
                        perm=None if perm is None else torch.from_numpy(perm))
    assert got.dtype == torch.int16 and tuple(got.shape) == (B, bv, bh, 64)
    assert np.array_equal(got.numpy().astype(np.int32), _jax(bitmap, vals, bv, bh, perm))


def test_unpack_rejects_bad_shapes():
    bm = torch.zeros(2, 6, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        unpack_sparse(bm, torch.zeros(2, 4, dtype=torch.int16), bv=2, bh=2)
    with pytest.raises(TypeError):
        unpack_sparse(bm, torch.zeros(2, 4, dtype=torch.int32), bv=2, bh=3)
