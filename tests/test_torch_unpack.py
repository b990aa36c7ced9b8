"""K7's plain version (ops/sparse.py::unpack_sparse_plain, the CPU arm
of unpack_sparse and of the one-call unpack_components) against
zpix_tpu's _unpack_sparse_graph + _apply_perm on XLA:CPU, and the stream
-> grid map K7 writes through.  Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpix_tpu.parallel.batch import _apply_perm, _unpack_sparse_graph
from zpix_tpu.parallel.batch import stream_perm as jax_stream_perm
from zpix_tpu_torch.ops.sparse import (SparseComponent, stream_to_grid, unpack_components,
                                        unpack_sparse)
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
                        perm=perm)
    assert got.dtype == torch.int16 and tuple(got.shape) == (B, bv, bh, 64)
    assert np.array_equal(got.numpy().astype(np.int32), _jax(bitmap, vals, bv, bh, perm))


def test_unpack_rejects_bad_shapes():
    bm = torch.zeros(2, 6, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        unpack_sparse(bm, torch.zeros(2, 4, dtype=torch.int16), bv=2, bh=2)
    with pytest.raises(TypeError):
        unpack_sparse(bm, torch.zeros(2, 4, dtype=torch.int32), bv=2, bh=3)


@pytest.mark.parametrize("mxx,myy", [(5, 3), (7, 5), (1, 1), (33, 17)])
@pytest.mark.parametrize("hv", [(1, 1), (2, 1), (2, 2), (4, 1)], ids=["444", "422", "420", "411"])
def test_stream_to_grid_inverts_stream_perm(hv, mxx, myy):
    """K7 writes each stream block at its grid place through the map the
    host builds from stream_perm: it must be the perm's inverse."""
    perm = stream_perm(mxx, myy, *hv)
    inv = stream_to_grid(perm)
    if hv == (1, 1):
        assert perm is None and inv is None
        return
    nb = mxx * hv[0] * myy * hv[1]
    assert inv.dtype == np.int32 and inv.shape == (nb,)
    assert np.array_equal(np.sort(inv), np.arange(nb))
    assert np.array_equal(inv[perm], np.arange(nb))
    assert np.array_equal(perm[inv], np.arange(nb))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "gray"])
@pytest.mark.parametrize("batch", [1, 3])
def test_unpack_components_match_jax(sampling, batch):
    """The one-call form over every component of a decode (its plain arm
    on the CPU) against zpix_tpu's graph and perm, component by component;
    Cr's value capacity clipped below its count."""
    hv = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1), "gray": (1, 1)}[sampling]
    rng = np.random.default_rng(len(sampling) + 10 * batch + hv[0] * hv[1])
    mxx, myy = 7, 3
    grids = [(myy * hv[1], mxx * hv[0])] + ([] if sampling == "gray" else [(myy, mxx)] * 2)
    perms = [stream_perm(mxx, myy, *hv)] + [None] * (len(grids) - 1)
    comps, want = [], []
    for c, ((bv, bh), perm) in enumerate(zip(grids, perms)):
        bitmap = (rng.integers(0, 256, (batch, bv * bh, 8))
                  & rng.integers(0, 256, (batch, bv * bh, 8))).astype(np.uint8)
        nnz = np.unpackbits(bitmap, axis=-1).reshape(batch, -1).sum(1)
        width = int(nnz.min()) // 2 if c == 2 else int(nnz.max()) + 3
        vals = rng.integers(-2**15, 2**15, (batch, width)).astype(np.int16)
        comps.append(SparseComponent(torch.from_numpy(bitmap), torch.from_numpy(vals), bv, bh,
                                     perm))
        want.append(_jax(bitmap, vals, bv, bh, perm))
    got = unpack_components(comps)
    assert len(got) == len(want)
    for g, w, (bv, bh) in zip(got, want, grids):
        assert g.dtype == torch.int16 and tuple(g.shape) == (batch, bv, bh, 64)
        assert np.array_equal(g.numpy().astype(np.int32), w)


def test_unpack_components_reject_bad_inputs():
    bm = torch.zeros(2, 6, 8, dtype=torch.uint8)
    ok = SparseComponent(bm, torch.zeros(2, 4, dtype=torch.int16), 2, 3)
    with pytest.raises(ValueError):
        unpack_components([])
    with pytest.raises(ValueError):
        unpack_components([ok] * 5)
    with pytest.raises(ValueError):  # a batch of another size
        unpack_components([ok, SparseComponent(bm[:1], torch.zeros(1, 4, dtype=torch.int16),
                                               2, 3)])
    with pytest.raises(ValueError):
        unpack_components([ok._replace(perm=np.arange(5, dtype=np.int32))])
    with pytest.raises(ValueError):
        unpack_components([ok._replace(perm=np.arange(6, dtype=np.int64))])


@pytest.mark.parametrize("module,source,name", [
    ("zpix_tpu_torch.ops.sparse", "unpack_sparse.cu", "K7_TILE_BLOCKS"),
    ("zpix_tpu_torch.ops.entropy", "dc_restore.cu", "K3_TILE_MCUS")], ids=["K7", "K3"])
def test_tile_constant_matches_kernel(module, source, name):
    """The wrapper sizes K7's and K3's look-back scratch by the kernel's
    tile: its constant must be the source's kTile."""
    import importlib
    import os
    import re

    from zpix_tpu_torch import runtime

    with open(os.path.join(runtime.CSRC, source)) as f:
        tile = re.findall(r"^constexpr int kTile = (\d+);", f.read(), re.M)
    assert tile == [str(getattr(importlib.import_module(module), name))]
