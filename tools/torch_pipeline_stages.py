#!/usr/bin/env python3
"""The restart-marker, native, host-index and sync JPEG routes of
zpix_tpu_torch serially and through ``DecodePipeline`` at several settings,
on chip_smoke.py's content, with each run's stage timers.

    python3 tools/torch_pipeline_stages.py [--reps N]

Content: chip_smoke.py's 16 distinct 1024x1024 4:2:0 q50 JPEGs a batch,
10 timed batches after a warm-up one (DRI 8 for ``DeviceJpegDecoder``,
restart-free for the other three).  Each route runs, in turns, ``reps``
times: serially (``decode``, a sync a batch), pipelined with prefetch 2
and 2 prep threads (the default), pipelined with 1 prep thread, and both
pipelined settings again with the interpreter's switch interval at 0.5 ms
(5 ms by default: how long a thread that wants the GIL waits before the
one holding it is asked to let go).  Each run: ms a batch (host clock,
one sync at the end) and ``metrics``' mean host ms a call of each stage
timer (prep, upload, dispatch), which shows where the time grew.  The
outputs of every pipelined run are checked against the serial ones.

Prints one JSON object; needs a CUDA device, exits 1 without.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"serial": None, "w2": (2, None), "w1": (1, None), "w2_si0.5ms": (2, 5e-4),
            "w1_si0.5ms": (1, 5e-4)}


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(dec, batches, setting):
    """-> (ms a batch, the outputs, {timer: mean ms a call})."""
    from zpix_tpu_torch.parallel.pipeline import DecodePipeline
    from zpix_tpu_torch.utils import metrics

    old = sys.getswitchinterval()
    metrics.reset()
    torch.cuda.synchronize()
    try:
        if setting is not None and setting[1] is not None:
            sys.setswitchinterval(setting[1])
        t0 = time.perf_counter()
        if setting is None:
            outs = [dec.decode(d) for d in batches]
        else:
            outs = list(DecodePipeline(dec, prefetch=2, workers=setting[0]).map(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(old)
    timers = {k: v["total_s"] * 1e3 / v["calls"]
              for k, v in metrics.snapshot()["timers"].items()}
    return wall * 1e3 / len(batches), outs, timers


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pipeline_stages: no CUDA device", file=sys.stderr)
        return 1
    cs = smoke()
    sys.path.insert(0, HERE)
    from zpix_tpu_torch import runtime
    from zpix_tpu_torch.runtime import host

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runtime.lib()
    host.lib()
    dri = cs.make_batches(range(cs.TIMED_BATCHES + 1))
    rf = cs.make_batches(range(100, 100 + cs.TIMED_BATCHES + 1), dri=None)
    makers = cs.pipeline_decoders()
    res = {"nvidia_smi": smi, "cpu_count": os.cpu_count(), "routes": {}}
    for name, content in (("dri8", dri), ("native", rf), ("host_index", rf), ("sync", rf)):
        dec = makers[name]()
        dec.decode(content[0])
        rows = {k: [] for k in SETTINGS}
        want = None
        equal = True
        for _ in range(args.reps):
            for k, setting in SETTINGS.items():
                ms, outs, timers = run(dec, content[1:], setting)
                if want is None:
                    want = outs
                else:
                    equal &= all(torch.equal(o[0] if isinstance(o, tuple) else o,
                                             w[0] if isinstance(w, tuple) else w)
                                 for o, w in zip(outs, want))
                rows[k].append({"ms_per_batch": ms, "timer_ms_per_call": timers})
        res["routes"][name] = {"equal_serial": equal, **rows}
        del want
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
