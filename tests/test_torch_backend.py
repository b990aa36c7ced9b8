"""K4, the back-end: the port's pixels from random coefficients against
the JAX package's ``_soa_backend`` for the gray, ycbcr, rgb, cmyk and
ycck arms and for every sampling ratio the plans carry (4:4:4, 4:2:2,
4:4:0, 4:1:1 and 4:1:0 from the tests' own encoder, cropped to 43 x 27),
planar and interleaved.  ``_soa_backend`` runs op by op here: the same
XLA operations as under jit, without the 10-20 s compile of each arm's
whole program on the CPU.  Exact: tolerance 0."""

import numpy as np
import pytest
import torch
from _torch_jpeg import ARMS, jax_native_lib, synth_ratio_jpeg

from zpix_tpu.parallel.device_entropy import _soa_backend
from zpix_tpu.parallel.device_entropy import prep_batch as jax_prep
from zpix_tpu.parallel.device_entropy import prep_batch_host_index as jax_prep_host_index
from zpix_tpu_torch import prep_batch, prep_batch_host_index
from zpix_tpu_torch.ops import backend as kb

# Restart-free streams at each ratio (the arms above cover 4:2:0): plans by
# the host index scan in both packages.
RATIOS = {"444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
          "440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
          "410": [(4, 2), (1, 1), (1, 1)]}
CASES = list(ARMS) + [f"ycbcr-{r}" for r in RATIOS]


def _plans(case):
    """(zpix_tpu's plan, the port's plan, colour arm) of a two-image batch."""
    if case in ARMS:
        data = ARMS[case]()
        return jax_prep([data, data]), prep_batch([data, data]), case
    hv = RATIOS[case.split("-")[1]]
    datas = [synth_ratio_jpeg(hv, width=43, height=27, seed=s) for s in (0, 1)]
    jax_native_lib()
    return jax_prep_host_index(datas), prep_batch_host_index(datas), "ycbcr"


def _coefficients(plan, seed):
    """Block-major AC int16 [B*m_pad*bpm, 64] and DC int32 [B*m_pad*bpm]:
    sparse AC, wide DC, junk at AC position 0 (both back-ends take the
    DC from its own row)."""
    rng = np.random.default_rng(seed)
    m_pad = plan.n_segs * plan.seg_mcus
    shape = (plan.batch, m_pad, plan.bpm)
    ac = rng.integers(-300, 300, shape + (64,)).astype(np.int16)
    ac *= (rng.random(shape + (64,)) < 0.3).astype(np.int16)
    ac[..., 0] = rng.integers(-3000, 3000, shape)
    dc = rng.integers(-2000, 2000, shape).astype(np.int32)
    return ac, dc


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "interleaved"])
@pytest.mark.parametrize("arm", CASES)
def test_backend_matches_soa_backend(arm, planar):
    jplan, plan, color = _plans(arm)
    assert plan.color == jplan.color == color
    assert tuple(plan.hv) == tuple(tuple(x) for x in jplan.hv)
    ac, dc = _coefficients(plan, seed=len(arm) + planar)
    dcv = np.ascontiguousarray(dc.transpose(2, 0, 1).reshape(-1))  # slot-major
    ac16 = np.ascontiguousarray(ac.transpose(3, 2, 0, 1).reshape(64, -1))
    want = np.asarray(_soa_backend(jplan, (dcv, ac16), planar=planar))
    got = kb.backend(
        torch.from_numpy(ac.reshape(-1, 64)), torch.from_numpy(dc.reshape(-1)),
        torch.from_numpy(plan.tables), kb.BackendGeometry.of(plan), planar=planar,
    )
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == kb.BackendGeometry.of(plan).out_shape(planar)
    assert np.array_equal(got.numpy(), want)


def test_backend_rejects_mismatched_shapes():
    plan = prep_batch([ARMS["gray"]()])
    geom = kb.BackendGeometry.of(plan)
    n = geom.batch * geom.m_pad * geom.bpm
    tables = torch.from_numpy(plan.tables)
    with pytest.raises(ValueError):
        kb.backend(torch.zeros(n - 1, 64, dtype=torch.int16),
                   torch.zeros(n - 1, dtype=torch.int32), tables, geom, planar=True)
    with pytest.raises(TypeError):
        kb.backend(torch.zeros(n, 64, dtype=torch.int32),
                   torch.zeros(n, dtype=torch.int32), tables, geom, planar=True)
