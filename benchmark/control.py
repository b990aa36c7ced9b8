"""The controls of the benchmark's correctness check: the reference put in
the program's place with one of the configuration's guarantees broken,
driven through a whole run (``harness.measure``: the loader, the window,
the sample drawn from the seed and the check), so that the run's own
comparison judges it.  The benchmark's runs never run this; it shows
that the check fails what it must fail.

* JPEG (``nuscenes-cam-jpeg``): the reference decoder with its IDCT in
  float32 (the textbook transform as two 8 x 8 matrix products, rounded to
  nearest) in place of the exact integer one: the step a kernel on float
  units would tempt.
* QOI (``qoi-*``): the reference decoder that restarts from QOI's initial
  state at the first op of every ``CHUNK``-byte chunk of the op stream: a
  chunk-parallel decode that keeps the first guess at every chunk start
  and skips the passes that repair it.

    python3 benchmark/control.py --workload <cell> --seeds <n> <n> ... [--seconds <s>]

runs the cell for each seed with the control in the program's place, then
with the plain reference in its place (which must come out correct), and
prints each run's ``correct`` and ``checks`` as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CHUNK = 4096


def idct_float32(blocks: np.ndarray) -> np.ndarray:
    """[N, 8, 8] dequantised coefficients -> samples before the level shift,
    in float32 and rounded to nearest."""
    k = np.arange(8)
    m = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16) / 2
    m[:, 0] /= np.sqrt(2)
    m = m.astype(np.float32)
    out = m @ blocks.astype(np.float32) @ m.T
    return np.rint(out).astype(np.int32)


def control_decode(cell, data: bytes) -> np.ndarray:
    """The control's decode of one frame of ``cell``'s configuration."""
    from benchmark import harness

    ref = harness.load_module("reference", cell.config["reference"], cell.root)
    if cell.config["codec"] == "jpeg":
        return ref.decode(data, idct=idct_float32)
    return ref.decode(data, restart_every=CHUNK)


def reference_decode(cell, data: bytes) -> np.ndarray:
    from benchmark import harness

    return harness.load_module("reference", cell.config["reference"], cell.root).decode(data)


class Standin:
    """A decoder for the program's loader that decodes with ``decode(cell,
    data)`` on the host: ``run`` hands back the batch's images, each worked
    out when the check reads it (a plain decoder takes seconds a frame, so
    the window decodes nothing), and ``ok`` True."""

    def __init__(self, cell, decode):
        self.cell, self.decode = cell, decode

    def prep(self, datas):
        return datas

    def upload(self, plan):
        return None

    def run(self, plan, bufs):
        import torch

        return _Images(self, plan), torch.tensor(True)


class _Images:
    def __init__(self, standin: Standin, datas: list):
        self.standin, self.datas = standin, datas

    def __getitem__(self, pos):
        import torch

        return torch.from_numpy(self.standin.decode(self.standin.cell, self.datas[pos]))


def run(workload: str, seed: int, decode, *, seconds: float = 1.0, device=None,
        root=None) -> dict:
    """One run of ``workload`` with ``decode`` in the program's place -> the
    run's result (``correct``, ``checks``, ...)."""
    import torch

    from benchmark import harness

    return harness.measure(workload, seed=seed, seconds=seconds, trace=False,
                           device=device or torch.device("cpu"), t_start=time.perf_counter(),
                           root=root or harness.ROOT, log=lambda line: None,
                           make=lambda cell, dev: Standin(cell, decode))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for seed in args.seeds:
        for side, decode in (("control", control_decode), ("reference", reference_decode)):
            t0 = time.perf_counter()
            res = run(args.workload, seed, decode, seconds=args.seconds)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "correct": res["correct"], "checks": res["checks"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
