"""K6's plain version (ops/planes.py, the CPU arm of component_planes)
against zpix_tpu's _component_plane and its colour graphs (_gray_graph,
_ycbcr_graph for every _RATIO_FACTORS entry, _rgb_graph, _ycck_graph,
_cmyk_graph for each sub pattern) on XLA:CPU, on random coefficient
grids, including full-range values and quants whose products wrap.
Exact: tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jpeg import random_grids

from zpix_tpu.parallel import batch as jb
from zpix_tpu_torch.ops.planes import component_plane_plain
from zpix_tpu_torch.parallel.batch import RATIO_FACTORS, decode_batch_planes

MXX, MYY, B = 3, 2, 2
CASES = ([("gray", [(1, 1)], None)]
         + [("ycbcr", [(h, v), (1, 1), (1, 1)], r) for r, (h, v) in RATIO_FACTORS.items()]
         + [("rgb", [(2, 2), (1, 1), (1, 1)], "420"), ("rgb", [(1, 1)] * 3, "444"),
            ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)], "420"),
            ("ycck", [(1, 1)] * 4, "444"),
            ("cmyk", [(1, 1)] * 4, None), ("cmyk", [(2, 2), (1, 1), (1, 1), (2, 2)], None)])


def _inputs(hv, wide, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (-2**15, 2**15) if wide else (-1024, 1024)
    grids = random_grids(rng, hv, MXX, MYY, B, lo, hi)
    quants = [rng.integers(1, 2**16 if wide else 64, (B, 64)).astype(np.int32) for _ in hv]
    return grids, quants


def _jax_graph(color, hv, ratio, H, W):
    kw = dict(height=H, width=W)
    if color == "gray":
        return jax.jit(lambda *a: jb._gray_graph(*a, **kw))
    if color == "cmyk":
        sub = tuple(x != hv[0] for x in hv)
        return jax.jit(lambda *a: jb._cmyk_graph(*a, sub=sub, **kw))
    graph = {"ycbcr": jb._ycbcr_graph, "rgb": jb._rgb_graph, "ycck": jb._ycck_graph}[color]
    return jax.jit(lambda *a: graph(*a, ratio=ratio, **kw))


@pytest.mark.parametrize("wide", [False, True], ids=["jpeg-range", "wrapping"])
@pytest.mark.parametrize("color,hv,ratio", CASES,
                         ids=[f"{c}-{r or 'x'.join(f'{h}{v}' for h, v in hv)}"
                              for c, hv, r in CASES])
def test_planes_match_jax_graphs(color, hv, ratio, wide):
    grids, quants = _inputs(hv, wide, seed=len(hv) + 7 * hv[0][0] + 3 * hv[0][1])
    H, W = 8 * hv[0][1] * MYY - 3, 8 * hv[0][0] * MXX - 5
    want = np.asarray(_jax_graph(color, hv, ratio, H, W)(
        *[g.astype(np.int32) for g in grids], *quants))
    got = decode_batch_planes([torch.from_numpy(g) for g in grids],
                              [torch.from_numpy(q) for q in quants], color=color,
                              height=H, width=W, ratio=ratio,
                              sub=tuple(x != hv[0] for x in hv))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("wide", [False, True], ids=["jpeg-range", "wrapping"])
def test_component_plane_matches_jax(wide):
    (grid,), (quant,) = _inputs([(1, 1)], wide, seed=5)
    want = np.asarray(jax.jit(lambda g, q: jb._component_plane(jnp, g, q))(
        grid.astype(np.int32), quant))
    got = component_plane_plain(torch.from_numpy(grid), torch.from_numpy(quant))
    assert np.array_equal(got.numpy(), want)


def test_planes_reject_mismatched_grids():
    grids, quants = _inputs([(2, 2), (1, 1), (1, 1)], False, seed=1)
    grids[1] = grids[1][:, :1]
    with pytest.raises(ValueError):
        decode_batch_planes([torch.from_numpy(g) for g in grids],
                            [torch.from_numpy(q) for q in quants], color="ycbcr",
                            height=8, width=8, ratio="420")
