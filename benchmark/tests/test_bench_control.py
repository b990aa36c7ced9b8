"""The check fails what it must: the control (the reference with one of the
configuration's guarantees broken, in the program's place) and faults
planted under the timed path all come out not correct; the reference
itself and the sound program come out correct."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

SEED = 2**31 + 21


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.tiny_sync", "tiny.tiny_screen", "tiny.tiny_photo"])
def test_control_fails_and_reference_passes(root, cell, monkeypatch):
    """The control and the plain reference, each in the program's place in a
    whole run: the run's own check fails the one and passes the other."""
    monkeypatch.setattr(control, "CHUNK", 256)  # tiny streams: chunks of their size
    ref = control.run(cell, SEED, control.reference_decode, seconds=0.2, root=root)
    assert ref["correct"] is True
    assert all(v["value"] == 0 for v in ref["checks"].values())
    ctl = control.run(cell, SEED, control.control_decode, seconds=0.2, root=root)
    assert ctl["correct"] is False
    assert ctl["checks"]["mismatched_bytes"]["value"] > 0


class Faulty:
    """The program's decoder with a fault planted where its answer is made."""

    def __init__(self, decoder, fault):
        self.decoder, self.fault, self.last = decoder, fault, None
        self.prep, self.upload = decoder.prep, decoder.upload

    def run(self, plan, bufs):
        out = self.decoder.run(plan, bufs)
        pixels, ok = harness.split(out)
        if self.fault == "unchanged":  # the step hands back the state it had
            prev, self.last = self.last, pixels
            pixels = pixels if prev is None else prev
        elif self.fault == "half":  # half the batch left out
            pixels = pixels.clone()
            pixels[pixels.shape[0] // 2:] = 0
        elif self.fault == "altered":  # an answer altered where it is made
            pixels = pixels.clone()
            pixels[:, 0, 0, 0] ^= 1
        elif self.fault == "ok_false":
            ok = torch.tensor(False)
        return (pixels, ok) if ok is not None else pixels


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "ok_false"])
@pytest.mark.parametrize("cell", ["tiny.tiny_sync", "tiny.tiny_native", "tiny.tiny_photo"])
def test_planted_faults_come_out_not_correct(root, cell, fault):
    if fault == "ok_false" and cell == "tiny.tiny_native":
        pytest.skip("the native route has no ok flag")
    result = harness.measure(cell, seed=SEED, seconds=0.3, trace=False,
                             device=torch.device("cpu"), t_start=0.0, root=root,
                             log=lambda line: None,
                             make=lambda c, device: Faulty(harness.make_decoder(c, device), fault))
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_sound_run_is_correct(root):
    result = harness.measure("tiny.tiny_sync", seed=SEED, seconds=0.3, trace=False,
                             device=torch.device("cpu"), t_start=0.0, root=root,
                             log=lambda line: None)
    assert result["correct"] is True
    assert all(v["value"] == 0 for v in result["checks"].values())
