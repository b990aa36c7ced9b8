"""K1 and K2's lookahead table: ``ops/entropy.py::index_lut_plain``, the
plain copy of the table each CTA of csrc/entropy.cu builds, against the
limit-compare decode (``_Tables.decode``) on all 65,536 lookaheads of
every table, in both roles; and K1 and K2's plain versions on segments
coded with tables no Pillow image has, against what the writer coded.
Exact: tolerance 0."""

import numpy as np
import pytest
import torch
from _torch_jpeg import CODED_CASES, _noise_jpeg, coded_segments, synth_cmyk, synth_jpeg

from zpix_tpu_torch import prep_batch
from zpix_tpu_torch.codecs.jpeg.tables import HuffTable
from zpix_tpu_torch.ops import entropy as ke


def _long_code_tables():
    """Packed tables whose AC table has one code of each length 2-15 and
    two of 16 bits (a valid prefix code), beside Pillow's DC table."""
    std = prep_batch([synth_jpeg(mode="gray")]).tables
    dc = HuffTable()
    dc.build([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
    ac = HuffTable()
    ac.build([0] + [1] * 14 + [2], [0x00, 0x01, 0x11, 0x02, 0x21, 0x12, 0x31, 0x03, 0x41,
                                    0x51, 0x13, 0x61, 0x22, 0xF0, 0x0A, 0xFA])
    out = ke.pack_tables([dc, ac], [0], [1])
    out[ke.TAB_QUANT:] = std[ke.TAB_QUANT:]
    return torch.from_numpy(out)


def _random_limit_tables():
    """Pillow's tables with every limit and value offset drawn at random:
    unsorted limits and offsets outside the symbol bytes, which no JPEG
    has, but which the table and the full decode must still agree on."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(prep_batch([synth_jpeg(mode="420")]).tables)
    t[ke.TAB_LIMS : ke.TAB_LIMS + 128] = torch.from_numpy(
        rng.integers(0, 70000, 128).astype(np.int32))
    t[ke.TAB_AOFF : ke.TAB_AOFF + 128] = torch.from_numpy(
        rng.integers(-50, 200, 128).astype(np.int32))
    return t


TABLES = {
    "pillow_standard": lambda: torch.from_numpy(prep_batch([synth_jpeg(mode="420")]).tables),
    "pillow_cmyk": lambda: torch.from_numpy(prep_batch([synth_cmyk(None)]).tables),
    "optimized_gray": lambda: torch.from_numpy(
        prep_batch([_noise_jpeg(120, 72, "gray", 95, 0, 4, optimize=True)]).tables),
    "optimized_420": lambda: torch.from_numpy(
        prep_batch([_noise_jpeg(120, 72, "420", 95, 1, 4, optimize=True)]).tables),
    "sixteen_bit_codes": _long_code_tables,
    "random_limits": _random_limit_tables,
    "many_second_level_blocks": lambda: torch.from_numpy(
        coded_segments("many_second_level_blocks", n_segs=2)["tables"]),
    "six_table_pairs": lambda: torch.from_numpy(
        coded_segments("six_table_pairs", n_segs=2)["tables"]),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_lookahead_table_matches_full_decode(name):
    tables = TABLES[name]()
    lut = ke.index_lut_plain(tables)
    assert lut.shape == (2, ke.MAX_TABLES, 1 << ke.LUT_BITS)
    tab = ke._Tables(tables)
    looks = torch.arange(1 << 16, dtype=torch.int64)
    long_codes = 0
    for t in range(ke.MAX_TABLES):
        ln, sym, bad = tab.decode(looks, torch.full_like(looks, t))
        for ac in (0, 1):
            e = lut[ac, t, looks >> (16 - ke.LUT_BITS)]
            assert bool(bad[e == ke.LUT_BAD].all())
            one = (e != 0) & (e != ke.LUT_BAD)
            assert not bool(bad[one].any())
            assert torch.equal(e[one], ke.lut_entry(ln, sym, torch.full_like(ln, ac))[one])
            assert torch.equal((e[one] >> 16) & 31, ln[one])
            if name != "random_limits":  # canonical codes: every short code is in the table
                assert bool((e[~bad & (ln <= ke.LUT_BITS)] != 0).all())
            long_codes += int((~bad & (ln > ke.LUT_BITS)).sum())
    if name in ("sixteen_bit_codes", "optimized_gray", "optimized_420",
                "many_second_level_blocks", "six_table_pairs"):
        assert long_codes > 0, "wants codes longer than the table, decoded in full"


def test_lookahead_entry_fields():
    """adv = len + size, the step of k: 1 for DC, run + 1 for a
    coefficient, 16 for ZRL, 64 for EOB; DC sizes up to 255 bits."""
    ln = torch.tensor([2, 4, 11, 9, 3, 16])
    sym = torch.tensor([0x03, 0x00, 0xF0, 0x2A, 11, 255])
    ac = torch.tensor([1, 1, 1, 1, 0, 0])
    e = ke.lut_entry(ln, sym, ac)
    adv, step, size = e & 511, (e >> 9) & 127, (e >> 21) & 255
    assert adv.tolist() == [5, 4, 11, 19, 14, 271]
    assert step.tolist() == [1, 64, 16, 3, 1, 1]
    assert size.tolist() == [3, 0, 0, 10, 11, 255]
    assert bool((e > 0).all() and (e < ke.LUT_BAD).all())


def test_unused_tables_are_invalid_everywhere():
    lut = ke.index_lut_plain(TABLES["pillow_standard"]())
    nvals = np.asarray(lut[:, 4:])  # Pillow's 4:2:0 stream packs four tables
    assert (nvals == ke.LUT_BAD).all()


@pytest.mark.parametrize("case", list(CODED_CASES))
def test_plain_passes_decode_coded_segments(case):
    """The writer's segments (codes of 11-16 bits, more long-code prefixes
    than the kernels' second-level blocks, six table pairs, a partial
    last segment) through K1's and K2's plain versions: every block end,
    coefficient and DC diff as coded, ok set."""
    c = coded_segments(case, n_segs=40)
    args = [torch.from_numpy(c[k]) for k in ("stream", "seg_pos", "seg_nmcu", "tables")]
    ends, ok = ke.index_pass_plain(*args, bpm=c["bpm"], nblk=c["nblk"])
    assert torch.equal(ends, torch.from_numpy(c["ends"])) and bool(ok)
    ac, dc = ke.value_pass_plain(*args, ends, ok, bpm=c["bpm"])
    assert torch.equal(ac, torch.from_numpy(c["ac"])) and torch.equal(dc, torch.from_numpy(c["dc"]))
    assert bool(ok)
