"""The program's spans (``zpix_tpu_torch.utils.profiling``) on the card,
against the profiler.  In a quiet process, one batch of the size of each
of two cells (``qoi.screen``: 32 screen-like 1920x1080 RGB QOI frames
through ``BatchQoiDecoder``; ``cam_jpeg.sync``: 48 1600x900 camera JPEGs
through ``SyncJpegDecoder``), made by the benchmark's content generators:
the batch's kernel time (its ``launch.<entry>.card`` spans summed:
``kernel_ms``) agrees within 10% with the union of the card's ops its run
enqueued; the program's spans lie inside the benchmark's ``bench.*`` spans
around the same calls, on one clock; no span's name is among the card's
ops (``devtrace``).  In every cell's loop (``harness.measure``, a traced
window of a few seconds, the prep worker contending with the loop thread
for the interpreter and the host's cores), ``kernel_ms`` holds the
profiled time of the program's kernels a window batch, and exceeds it by
no more than 10% and the card's wait for each entry to issue its work,
at most ``LAUNCH_WAIT_MS`` a launch (the events are recorded inside the entry,
``csrc/timing.cuh``: a wait for the interpreter lock, milliseconds, lies
outside them).  These need a CUDA card:

    python -m pytest -m cuda benchmark/tests/test_bench_program_spans.py -q
"""

import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import devtrace, harness
from zpix_tpu_torch.utils import metrics, profiling, spans

pytestmark = pytest.mark.cuda

SEED = 2**31 + 2525
ROUTES = {"qoi.screen": "qoi_onchip", "cam_jpeg.sync": "jpeg_sync"}
CLOCK_NS = 50_000  # how far a span may lie outside the record_function around it
LAUNCH_WAIT_MS = 0.030  # an entry's issue of its work on an idle stream, at most
KERNEL_MS = {"cam_jpeg.sync": "kernel_ms.jpeg", "qoi.screen": "kernel_ms.qoi",
             "cam_jpeg.native": "kernel_ms.jpeg", "qoi.photo": "kernel_ms.qoi_photo"}


def _one_batch(name: str):
    """The cell and its first batch of frames, made from the seed."""
    cell = harness.load_cell(name)
    gen = harness.load_module("content", cell.mix["content"])
    params = cell.mix["content_params"]

    def frame(i):
        return gen.encode(cell.config, params, gen.pixels(cell.config, params, SEED, i))

    with ThreadPoolExecutor(harness.CORPUS_THREADS) as pool:
        return cell, list(pool.map(frame, range(cell.batch)))


@pytest.mark.parametrize("name", list(ROUTES))
def test_card_spans_agree_with_the_profiler(cuda, name):
    route = ROUTES[name]
    cell, datas = _one_batch(name)
    dec = harness.make_decoder(cell, cuda)
    plan = dec.prep(datas)
    dec.run(plan, dec.upload(plan))  # builds and warms the kernels
    torch.cuda.synchronize()
    bench = harness.Spans()
    timed = harness.Timed(dec, bench)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bench.profiled = True
        with profiling.for_batch(7):
            plan = timed.prep(datas)
            bufs = timed.upload(plan)
            torch.cuda.synchronize()  # the copy alone before the run
            t_run = profiling.now()
            timed.run(plan, bufs)
            torch.cuda.synchronize()
        bench.profiled = False
    got = spans()
    dev, host = devtrace._events(prof)

    launches = [s for s in got if s.name.startswith("launch.") and s.name.endswith(".card")]
    assert launches and all(s.batch == 7 for s in launches)
    run_ops = [op for op in dev if op[0] >= t_run and "Memcpy HtoD" not in op[2]]
    assert run_ops
    union_ms = devtrace.busy_and_gaps(run_ops, run_ops[0][0], max(b for _, b, _ in run_ops))[
        0] / 1e6
    kernel_ms = sum(s.counts["card_ms"] for s in launches)
    print(f"{name}: launches' card time {kernel_ms:.4f} ms ({len(launches)} launches), "
          f"the union of the run's ops {union_ms:.4f} ms ({len(run_ops)} ops)")
    assert abs(kernel_ms - union_ms) <= 0.10 * union_ms

    for step, outer in (("prep", "bench.prep"), ("upload", "bench.upload"),
                        ("run", "bench.launch")):
        (a, b), = [(a, b) for a, b, n in host if n == outer]
        s, = [s for s in got if s.name == f"{route}.{step}"]
        assert s.batch == 7
        assert a - CLOCK_NS <= s.start_ns <= s.end_ns <= b + CLOCK_NS, step
        assert s.end_ns - s.start_ns >= 0.5 * (b - a), step  # most of the call
    assert not {n for _, _, n in dev} & {s.name for s in got}
    close = getattr(dec, "close", None)
    if close is not None:
        close()


def _program_kernel(op: str) -> bool:
    """A card op of the program's hand-written kernels (not a copy, a
    memset or one of PyTorch's own kernels)."""
    return not op.startswith(("Memcpy", "Memset")) and "at::" not in op


@pytest.mark.parametrize("name", list(KERNEL_MS))
def test_kernel_ms_agrees_with_the_profiled_kernels_in_the_loop(cuda, name):
    """The events the program records around each launch, under the load
    of the cell's own loop, against the profiler's device time of the same
    kernels over the traced window's batches (the breakdown's busiest ops)."""
    metrics.reset()
    result = harness.measure(name, seed=SEED, seconds=4.0, trace=True, device=cuda,
                             t_start=time.perf_counter(), log=lambda line: None)
    assert result["correct"], result["checks"]
    batches = result["attempted"] // harness.load_cell(name).batch
    ops = result["breakdown"]["device_ops"]
    profiled_ms = sum(s for n, s in ops if _program_kernel(n)) * 1e3 / batches
    kernel_ms = result["metrics"][KERNEL_MS[name]]["value"]
    pairs = [s for s in spans() if s.name.startswith("launch.") and s.name.endswith(".card")]
    launches = len(pairs) / len({s.batch for s in pairs})  # a batch
    print(f"{name}: kernel_ms {kernel_ms:.4f} against {profiled_ms:.4f} profiled a batch, "
          f"{launches:.2f} launches a batch ({batches} batches; ops {ops})")
    assert 0.98 * profiled_ms <= kernel_ms <= 1.10 * profiled_ms + LAUNCH_WAIT_MS * launches
