"""K7, the sparse coefficient unpack: nonzero bitmap + int16 values ->
dense coefficient grids, in grid order.

``unpack_components`` wraps K7 (csrc/unpack_sparse.cu), the port of
zpix_tpu/parallel/batch.py::_unpack_sparse_graph (:560) and _apply_perm
(:573), for every component of a decode in one launch; ``unpack_sparse``
is its one-component call.  ``unpack_sparse_plain`` is the same function
in plain PyTorch, written as the JAX graph is (unpack the bits, cumsum,
clip, gather, permute); the dispatch takes it for CPU tensors only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime

_SHIFTS = torch.arange(7, -1, -1, dtype=torch.int32)  # MSB first (np.packbits)

# Stream blocks a K7 CTA takes, a thread each (kTile in
# csrc/unpack_sparse.cu): it sizes the kernel's look-back scratch.
K7_TILE_BLOCKS = 256
MAX_COMPONENTS = 4


class SparseComponent(NamedTuple):
    """One component of a decode: its stream-order bitmap [B, bv*bh, 8]
    u8, its values [B, cap] int16 (each image's nonzeros in stream order),
    its grid (bv, bh) and its grid -> stream perm (numpy int32 [bv*bh],
    as parallel/batch.py::stream_perm gives it, or the four ints (mxx,
    myy, hi, vi) that stream_perm takes) or None for grid order."""

    bitmap: torch.Tensor
    vals: torch.Tensor
    bv: int
    bh: int
    perm: object = None


def _check(comp: SparseComponent, batch: int):
    bitmap, vals, perm, nb = comp.bitmap, comp.vals, comp.perm, comp.bv * comp.bh
    if bitmap.dtype != torch.uint8 or vals.dtype != torch.int16:
        raise TypeError("unpack_sparse: expected a u8 bitmap and int16 values")
    if bitmap.dim() != 3 or tuple(bitmap.shape[1:]) != (nb, 8) or bitmap.shape[0] != batch:
        raise ValueError("unpack_sparse: bitmap must be [B, bv*bh, 8]")
    if vals.dim() != 2 or vals.shape[0] != batch or vals.shape[1] < 1:
        raise ValueError("unpack_sparse: values must be [B, cap] with cap >= 1")
    if isinstance(perm, tuple):
        perm = perm_array(perm)
    if perm is not None and (not isinstance(perm, np.ndarray) or perm.dtype != np.int32
                             or perm.shape != (nb,)):
        raise ValueError("unpack_sparse: perm must be a numpy int32 [bv*bh], its stream_perm "
                         "ints, or None")


def perm_array(perm):
    """A perm given as stream_perm's four ints -> its numpy int32 array; an
    array or None as it is."""
    if isinstance(perm, tuple):
        from ..parallel.batch import stream_perm

        return stream_perm(*perm)
    return perm


def stream_to_grid(perm):
    """The inverse of a grid -> stream perm (numpy int32 [nb]): the grid
    index of each stream block, or None for grid order."""
    if perm is None:
        return None
    perm = np.asarray(perm, np.int64)
    inv = np.empty(perm.shape[0], np.int32)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return inv


# Device copies of grid maps kept at once: the least recently used goes
# first, so a mesh (a copy a shard device) or many geometries cannot grow it.
GRID_MAPS_KEPT = 16
_GRID_MAPS: OrderedDict = OrderedDict()
_GRID_MAPS_LOCK = threading.Lock()


def grid_map(perm, device):
    """The stream -> grid map of ``perm`` (a numpy array, or stream_perm's
    four ints) on ``device``, built on the host and copied there once
    while it stays among the ``GRID_MAPS_KEPT`` most recently used (a
    decode then makes no copy of its own); None for None.  Keyed by the
    device's type and index and by the four ints, or else the perm's
    bytes."""
    if perm is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.type, dev.index, perm if isinstance(perm, tuple) else perm.tobytes())
    with _GRID_MAPS_LOCK:
        m = _GRID_MAPS.get(key)
        if m is not None:
            _GRID_MAPS.move_to_end(key)
            return m
    m = torch.from_numpy(stream_to_grid(perm_array(perm))).to(dev)
    with _GRID_MAPS_LOCK:
        _GRID_MAPS[key] = m
        while len(_GRID_MAPS) > GRID_MAPS_KEPT:
            _GRID_MAPS.popitem(last=False)
    return m


def unpack_sparse_plain(bitmap, vals, *, bv: int, bh: int, perm=None):
    """[B, nb, 8] u8 + [B, cap] int16 -> [B, bv, bh, 64] int16, grid order."""
    B, nb = bitmap.shape[0], bv * bh
    bits = (bitmap.reshape(B, nb * 8).to(torch.int32)[..., None]
            >> _SHIFTS.to(bitmap.device)) & 1
    bits = bits.reshape(B, nb * 64)
    idx = (bits.cumsum(-1) - 1).clamp(0, vals.shape[1] - 1)
    coeff = torch.where(bits == 1, torch.gather(vals, 1, idx), 0).to(torch.int16)
    coeff = coeff.view(B, nb, 64)
    if perm is not None:
        coeff = coeff[:, torch.from_numpy(perm_array(perm)).to(coeff.device).long()]
    return coeff.reshape(B, bv, bh, 64)


def unpack_components_plain(comps):
    """The plain version of ``unpack_components``, a component at a time."""
    return [unpack_sparse_plain(c.bitmap, c.vals, bv=c.bv, bh=c.bh, perm=c.perm) for c in comps]


def unpack_components(comps):
    """K7: every component of a decode (a list of SparseComponent, one
    batch) -> their coefficient grids [B, bv, bh, 64] int16 in grid order
    (exact: the values are int16).  On the card one kernel launch,
    whatever the number of components, and no memset: the look-back words
    live in the stream's kept scratch."""
    comps = list(comps)
    if not 1 <= len(comps) <= MAX_COMPONENTS:
        raise ValueError(f"unpack_sparse: 1 to {MAX_COMPONENTS} components")
    batch = len(comps[0].bitmap)
    for c in comps:
        _check(c, batch)
    dev = comps[0].bitmap.device
    if dev.type == "cpu":
        return unpack_components_plain(comps)
    runtime.require_cuda(*[t for c in comps for t in (c.bitmap, c.vals)])
    outs, desc = [], []
    for c in comps:
        nb = c.bv * c.bh
        if c.bitmap.data_ptr() % 8:
            raise ValueError("unpack_sparse: the bitmap must be 8-byte aligned")
        if nb >= 1 << 26:
            raise ValueError("unpack_sparse: at most 2^26 blocks a component")
        m = grid_map(c.perm, dev)
        out = torch.empty(batch, c.bv, c.bh, 64, dtype=torch.int16, device=dev)
        outs.append(out)
        desc.append([c.bitmap.data_ptr(), c.vals.data_ptr(), 0 if m is None else m.data_ptr(),
                     out.data_ptr(), c.vals.shape[1], nb])
    words = sum(batch * -(-(c.bv * c.bh) // K7_TILE_BLOCKS) for c in comps) + 1
    scratch, epoch = runtime.lookback_scratch(dev, words)
    d = np.asarray(desc, np.int64)
    runtime.launch("unpack_sparse", dev, "zpix_unpack_sparse", "piipli",
                   d.ctypes.data, len(comps), batch, scratch.data_ptr(), words, epoch)
    return outs


def unpack_sparse(bitmap, vals, *, bv: int, bh: int, perm=None):
    """K7 on one component: stream-order bitmap [B, bv*bh, 8] u8 and
    values [B, cap] int16, ``perm`` numpy int32 [bv*bh] grid -> stream or None
    -> coefficients [B, bv, bh, 64] int16 in grid order."""
    return unpack_components([SparseComponent(bitmap, vals, bv, bh, perm)])[0]
