"""K7, the sparse coefficient unpack: nonzero bitmap + int16 values ->
dense coefficient grids, in grid order.

``unpack_sparse`` wraps K7 (csrc/unpack_sparse.cu), the port of
zpix_tpu/parallel/batch.py::_unpack_sparse_graph (:560) and _apply_perm
(:573).  ``unpack_sparse_plain`` is the same function in plain PyTorch,
written as the JAX graph is (unpack the bits, cumsum, clip, gather,
permute); the dispatch takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from .. import runtime

_SHIFTS = torch.arange(7, -1, -1, dtype=torch.int32)  # MSB first (np.packbits)


def _check(bitmap, vals, perm, bv: int, bh: int):
    if bitmap.dtype != torch.uint8 or vals.dtype != torch.int16:
        raise TypeError("unpack_sparse: expected a u8 bitmap and int16 values")
    if bitmap.dim() != 3 or tuple(bitmap.shape[1:]) != (bv * bh, 8):
        raise ValueError("unpack_sparse: bitmap must be [B, bv*bh, 8]")
    if vals.dim() != 2 or vals.shape[0] != bitmap.shape[0] or vals.shape[1] < 1:
        raise ValueError("unpack_sparse: values must be [B, cap] with cap >= 1")
    if perm is not None and (perm.dtype != torch.int32 or tuple(perm.shape) != (bv * bh,)):
        raise ValueError("unpack_sparse: perm must be int32 [bv*bh]")


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
        coeff = coeff[:, perm.long()]
    return coeff.reshape(B, bv, bh, 64)


def unpack_sparse(bitmap, vals, *, bv: int, bh: int, perm=None):
    """K7: one component's blocks, stream-order bitmap [B, bv*bh, 8] u8 and
    values [B, cap] int16 (the image's nonzeros in order), ``perm`` int32
    [bv*bh] grid -> stream or None -> coefficients [B, bv, bh, 64] int16
    in grid order (exact: the values are int16)."""
    _check(bitmap, vals, perm, bv, bh)
    if bitmap.device.type == "cpu":
        return unpack_sparse_plain(bitmap, vals, bv=bv, bh=bh, perm=perm)
    runtime.require_cuda(bitmap, vals, *([] if perm is None else [perm]))
    if bitmap.data_ptr() % 8:
        raise ValueError("unpack_sparse: the bitmap must be 8-byte aligned")
    B, nb = bitmap.shape[0], bv * bh
    offs = torch.empty(B, nb, dtype=torch.int32, device=bitmap.device)
    out = torch.empty(B, bv, bh, 64, dtype=torch.int16, device=bitmap.device)
    runtime.launch(
        "unpack_sparse", bitmap.device, "zpix_unpack_sparse", "ppppplll",
        bitmap.data_ptr(), vals.data_ptr(), 0 if perm is None else perm.data_ptr(),
        offs.data_ptr(), out.data_ptr(), B, nb, vals.shape[1],
    )
    return out
