"""The port's spans (zpix_tpu_torch/utils/profiling.py) on the CPU: off
they record nothing and the timers are as before; on, each loader batch's
``pipeline.queue``, ``<route>.prep`` (and its children), ``upload.pack``,
``upload.send`` and ``<route>.run`` carry the harness's global batch index
and nest under their parents; a span lines up with a ``record_function``
on the profiler's clock and is none itself; ``packed_bytes`` counts the
packed arrays' bytes (0 on the ``views`` path); the benchmark's span
readers read values on the CPU path, and nothing where only the card
has something to read, or where the buffer dropped spans.  The loop is
the benchmark's, through its entry ``harness.measure(trace=True)`` on the
benchmark's tiny cells (``benchmark/tests/tiny.py``)."""

import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from benchmark.tests import tiny
from zpix_tpu_torch import BatchJpegDecoder, HostIndexQoiDecoder, SyncJpegDecoder, runtime
from zpix_tpu_torch.parallel import BatchQoiDecoder
from zpix_tpu_torch.parallel.device_entropy import PinnedUpload
from zpix_tpu_torch.parallel.pipeline import DecodePipeline
from zpix_tpu_torch.utils import metrics, profiling, recording, span, spans
from _torch_jpeg import synth_plain_jpeg

CPU = torch.device("cpu")
SEED = 2**31 + 25
# tiny cell -> (its route, the decoder its mix names, window seconds: five
# window batches or more of the plain CPU kernels, three at half their
# speed on a busy host, so that a batch prepped inside the window is asked)
CELLS = {"tiny.tiny_sync": ("jpeg_sync", SyncJpegDecoder, 8.0),
         "tiny.tiny_native": ("jpeg_batch", BatchJpegDecoder, 0.6),
         "tiny.tiny_screen": ("qoi_onchip", BatchQoiDecoder, 3.0),
         "tiny.tiny_photo": ("qoi_onchip", BatchQoiDecoder, 3.0)}


class Run:
    """One traced run of a tiny cell through ``harness.measure`` on the
    CPU: its result, the global batch indices of the batches its window
    delivered (the warm-up's come first), the program's spans kept during
    it, and each prep's plan (the mix's one prep worker takes the batches
    in order, so a plan's index is its batch's)."""

    def __init__(self, root, name: str, seconds: float):
        mix = json.loads((root / "benchmark" / "mixes" / f"{name.split('.')[1]}.json")
                         .read_text())
        cls, self.plans = CELLS[name][1], []
        assert mix["decoder"]["class"] == cls.__name__ and mix["workers"] == 1
        plans = self.plans

        class Watched(cls):
            def prep(self, datas):
                plans.append(super().prep(datas))
                return plans[-1]

        self.root, kept = root, len(spans())
        self.result = harness.measure(name, seed=SEED, seconds=seconds, trace=True, device=CPU,
                                      t_start=time.perf_counter(), root=root,
                                      log=lambda line: None,
                                      make=lambda cell, device: Watched(device=device))
        self.metrics = self.result["metrics"]
        first, n = mix["warmup_batches"], self.result["attempted"] // mix["batch"]
        self.batches = list(range(first, first + n))
        self.spans = spans()[kept:]

    def in_window(self, name: str) -> list:
        """The ``name`` spans of the window's batches."""
        window = set(self.batches)
        return [s for s in self.spans if s.name == name and s.batch in window]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def runs(root):
    """Every tiny cell's traced run, one after another in one process."""
    metrics.reset()
    return {name: Run(root, name, seconds) for name, (_, _, seconds) in CELLS.items()}


# ------------------------------------------------------------ off and on


def test_recording_off_keeps_no_spans_and_times_as_before():
    metrics.reset()
    assert not metrics.is_recording
    datas = [synth_plain_jpeg(32, 16, phase=p) for p in (0.0, 1.0)]
    dec = SyncJpegDecoder(device="cpu")
    out = list(DecodePipeline(dec).map([datas, datas]))
    assert len(out) == 2
    assert spans() == [] and metrics.spans_dropped == 0
    snap = metrics.snapshot()
    assert set(snap["timers"]) == {"jpeg_sync.prep"} and snap["timers"]["jpeg_sync.prep"][
        "calls"] == 2
    assert snap["counters"] == {"jpeg_sync.images": 4.0}
    assert "span " not in metrics.report()
    assert span("x.y") is span("x.z")  # the one shared null context


def test_recording_on_nests_children_and_reports_them():
    metrics.reset()
    datas = [synth_plain_jpeg(32, 16, phase=p) for p in (0.0, 1.0)]
    with recording():
        SyncJpegDecoder(device="cpu").decode(datas)
    got = spans()
    by_id = {s.id: s for s in got}
    names = [s.name for s in got]
    for name, n in (("jpeg_sync.prep", 1), ("jpeg_sync.prep.headers", 2),
                    ("jpeg_sync.prep.destuff", 2), ("jpeg_sync.prep.flat", 1),
                    ("jpeg_sync.upload", 1), ("upload.pack", 1), ("upload.send", 1),
                    ("jpeg_sync.run", 1)):
        assert names.count(name) == n, name
    parent_of = {"jpeg_sync.prep.headers": "jpeg_sync.prep",
                 "jpeg_sync.prep.destuff": "jpeg_sync.prep",
                 "jpeg_sync.prep.flat": "jpeg_sync.prep", "upload.pack": "jpeg_sync.upload",
                 "upload.send": "jpeg_sync.upload"}
    for s in got:
        assert s.batch is None and s.start_ns <= s.end_ns
        if s.name in parent_of:
            p = by_id[s.parent]
            assert p.name == parent_of[s.name] and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        elif s.name.count(".") == 1:
            assert s.parent is None
    prep = next(s for s in got if s.name == "jpeg_sync.prep")
    assert prep.counts == {"images": 2}
    assert set(metrics.snapshot()["timers"]) == {"jpeg_sync.prep"}  # no new timer
    report = metrics.report()
    assert "span jpeg_sync.prep.destuff" in report and "(2x," in report
    assert not metrics.is_recording


def test_span_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    metrics.reset()
    monkeypatch.setattr(profiling, "SPAN_CAP", 5)
    with recording():
        for _ in range(8):
            with span("test.cap"):
                pass
    assert len(spans()) == 5 and metrics.spans_dropped == 3
    assert "(dropped)" in metrics.report()
    metrics.reset()
    assert spans() == [] and metrics.spans_dropped == 0


def test_spans_from_many_threads_keep_their_own_parents_and_batches():
    metrics.reset()
    n = 200

    def work(k):
        with profiling.for_batch(k):
            for _ in range(n):
                with span("test.outer"):
                    with span("test.inner", k=k):
                        pass

    with recording():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    got = spans()
    by_id = {s.id: s for s in got}
    assert len(got) == 8 * 2 * n and len(by_id) == len(got)
    for s in got:
        if s.name == "test.inner":
            p = by_id[s.parent]
            assert p.name == "test.outer" and p.batch == s.batch == s.counts["k"]
            assert p.thread == s.thread


# ------------------------------------------------------------ card spans


class _Events:
    """A stand-in for a launch's pair of CUDA events: running until
    ``done``, then ``ms`` apart."""

    def __init__(self, ms: float):
        self.value, self.done, self.waited = ms, False, False

    def ms(self, wait: bool):
        if wait:
            self.waited = self.done = True
        return self.value if self.done else None


def test_card_spans_are_read_once_their_events_complete_in_order():
    metrics.reset()
    first, second = _Events(1.5), _Events(0.25)
    with recording(), profiling.for_batch(4), span("test.run"):
        profiling.record_card("launch.a", profiling.now(), first)
        profiling.record_card("launch.b", profiling.now(), second)
        second.done = True  # the later pair waits for the earlier: read in order
        profiling.record_card("launch.c", None, _Events(9.0))  # started while not recording
    with metrics._lock:
        kept = list(metrics._spans)
    assert [s.name for s in kept] == ["launch.a", "launch.b", "test.run"]  # none read yet
    first.done = True
    pending = _Events(2.0)
    with recording():  # the next card span's read takes a and b, waiting for neither
        profiling.record_card("launch.d", profiling.now(), pending)
    with metrics._lock:
        kept = [s.name for s in metrics._spans]
    assert kept[-2:] == ["launch.a.card", "launch.b.card"]
    assert not first.waited and not second.waited
    got = spans()
    assert got[-1].name == "launch.d.card" and got[-1].counts == {"card_ms": 2.0}
    assert pending.waited  # a read of the buffer waits for the pairs still running
    by_name = {s.name: s for s in got}
    assert set(by_name) == {"test.run", "launch.a", "launch.b", "launch.a.card", "launch.b.card",
                            "launch.d", "launch.d.card"}
    for name, ms in (("launch.a", 1.5), ("launch.b", 0.25)):
        host, card = by_name[name], by_name[name + ".card"]
        assert host.parent == by_name["test.run"].id and card.parent == host.id
        assert host.batch == card.batch == 4 and card.counts == {"card_ms": ms}
        assert (card.start_ns, card.end_ns) == (host.start_ns, host.end_ns)


def test_a_timed_launch_arms_its_events_around_the_entry(monkeypatch):
    """``runtime.launch`` while recording: the pair of events is armed for
    the entry, which records them itself (``csrc/timing.cuh``), then
    disarmed, by calls that keep the interpreter lock (``held``; the entry
    lets it go as an untimed launch does), and the pair becomes the
    launch's card span, read later."""
    metrics.reset()
    calls = []

    def fake_fn(name, sig, held=False):
        def call(*args):
            if name == "zpix_event_read":  # the pair is still running on the card
                assert held and args[:2] == (11, 12)
                return runtime._NOT_READY
            calls.append((name, held, args))
            return 0
        return call

    monkeypatch.setattr(runtime, "fn", fake_fn)
    handles = iter((11, 12))
    monkeypatch.setattr(runtime, "_event", lambda card: next(handles))
    with recording(), profiling.for_batch(3):
        err = runtime._timed_launch(0, "zpix_test_entry", "pi", (5, 6), 77, profiling.now())
    assert err == 0
    assert calls == [("zpix_event_arm", True, (11, 12)), ("zpix_test_entry", False, (5, 6, 77)),
                     ("zpix_event_disarm", True, ())]
    with metrics._lock:
        kept = list(metrics._spans)
        (card, events), = metrics._cards
    assert [s.name for s in kept] == ["launch.zpix_test_entry"] and kept[0].batch == 3
    assert card.name == "launch.zpix_test_entry.card" and card.parent == kept[0].id
    assert (events.card, events.start, events.end) == (0, 11, 12)
    metrics.reset()


def test_every_kernel_entry_records_its_armed_events():
    """Each C entry of the kernel library (but the timing functions) opens
    with a ``TimedEntry`` on the stream it launches on, its last argument."""
    import glob
    import os
    import re

    entries = 0
    for path in glob.glob(os.path.join(runtime.CSRC, "*.cu")):
        if path.endswith("events.cu"):
            continue
        src = open(path).read()
        for m in re.finditer(r'extern "C" int (zpix_\w+)\((.*?)\)\s*\{\n([^\n]*)\n', src,
                             re.S):
            stream = m.group(2).split(",")[-1].split()[-1]
            assert m.group(3).strip() == f"const zpix::TimedEntry timed({stream});", m.group(1)
            entries += 1
    assert entries >= 27


# ----------------------------------------------------------------- clock


def test_spans_share_the_profilers_clock_and_are_no_record_functions():
    """A span opened with a ``record_function`` starts and ends within
    100 us of it on ``kineto_results``' clock (the median of 9 probes, so
    one probe the scheduler interrupts does not decide), and the profiler
    holds no event of a span's name."""
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.is_recording
        for i in range(9):
            with record_function(f"probe.{i}"), span(f"test.probe.{i}"):
                time.sleep(0.002)
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    got = {s.name: s for s in spans()}
    assert len(got) == 9
    d_start, d_end = [], []
    for i in range(9):
        a, b = events[f"probe.{i}"]
        s = got[f"test.probe.{i}"]
        d_start.append(abs(s.start_ns - a))
        d_end.append(abs(s.end_ns - b))
    assert statistics.median(d_start) < 100_000 and statistics.median(d_end) < 100_000
    assert not set(got) & set(events)
    assert not metrics.is_recording


# ---------------------------------------------------------------- upload


def test_packed_bytes_count_the_packed_arrays_and_none_on_the_views_path():
    metrics.reset()
    up = PinnedUpload(CPU)
    parts = [np.arange(100, dtype=np.uint8), np.arange(7, dtype=np.int32),
             np.arange(6, dtype=np.int16).reshape(2, 3)]
    staged = up.views([((100,), np.uint8), ((7,), np.int32), ((2, 3), np.int16)])
    for a, b in zip(staged, parts):
        a[...] = b
    assert up.staged(staged)
    with recording():
        plain = up(parts)
        lent = up(staged)
    for got in (plain, lent):
        assert [torch.equal(g, torch.from_numpy(p)) for g, p in zip(got, parts)] == [True] * 3
    packs = [s for s in spans() if s.name == "upload.pack"]
    sends = [s for s in spans() if s.name == "upload.send"]
    assert [s.counts["packed_bytes"] for s in packs] == [100 + 28 + 12, 0]
    assert [s.counts["bytes"] for s in sends] == [192 + 64, 192 + 64]  # 64-byte aligned parts


def test_the_qoi_lane_pass_writes_its_staging_and_packs_nothing():
    metrics.reset()
    rng = np.random.default_rng(3)
    from _torch_raster import qoi_enc

    imgs = [np.concatenate([rng.integers(0, 256, (16, 32, 3), dtype=np.uint8),
                            np.full((16, 32, 1), 255, np.uint8)], -1) for _ in range(2)]
    datas = [qoi_enc(i) for i in imgs]
    dec = HostIndexQoiDecoder(lane_p=16, lane_fmt="p4", device="cpu")
    dec.decode(datas)  # the layout hint set: the lane pass fills staging in place
    with recording():
        dec.decode(datas)
    assert [s.counts["packed_bytes"] for s in spans() if s.name == "upload.pack"] == [0]


# --------------------------------------------------------- through the loop


@pytest.mark.parametrize("name", list(CELLS))
def test_window_batches_carry_the_harness_batch_index(runs, name):
    """Every span of the loader's stages carries the global batch index
    ``g`` of the batch it served; each window batch has its upload and run
    spans, and those prepped inside the window their queue and prep
    spans, each nested as the decoder opens them."""
    run, route = runs[name], CELLS[name][0]
    asked = run.batches
    assert run.result["correct"] and len(asked) >= 3
    assert {s.batch for s in run.spans if s.name == f"{route}.run"} == set(asked)
    by_id = {s.id: s for s in run.spans}
    steps = ["pipeline.queue", f"{route}.prep", f"{route}.upload", f"{route}.run",
             "upload.send"] + (["upload.pack"] if route != "jpeg_batch" else [])
    for step in steps:
        found = {s.batch: s for s in run.in_window(step)}
        assert all(isinstance(g, int) for g in found), step
        want = asked if step.endswith((".upload", ".run", ".pack", ".send")) else asked[2:]
        assert set(want) <= set(found), step
    for s in run.in_window(f"{route}.upload") + run.in_window(f"{route}.run"):
        assert s.parent is None
    for s in run.in_window("upload.send"):
        p = by_id[s.parent]
        assert p.name == f"{route}.upload" and p.batch == s.batch
    prep_children = [s for s in run.spans if s.name.startswith(f"{route}.prep.")]
    assert prep_children
    for s in prep_children:
        p = by_id[s.parent]
        assert p.name == f"{route}.prep" and p.batch == s.batch and p.thread == s.thread
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    ready = {s.batch for s in run.in_window("pipeline.ready")}
    assert set(asked[2:]) <= ready


@pytest.mark.parametrize("name", list(CELLS))
def test_readers_read_the_cpu_path_and_leave_the_card_metrics_out(runs, name):
    run = runs[name]
    got = run.metrics
    want = {"tiny.tiny_sync": {"prep_queue_ms.jpeg", "destuff_ms.jpeg_sync", "pack_mb.jpeg_sync"},
            "tiny.tiny_native": {"prep_queue_ms.jpeg"},
            "tiny.tiny_screen": {"prep_queue_ms.qoi", "pack_mb.qoi"},
            "tiny.tiny_photo": {"prep_queue_ms.qoi_photo", "pack_mb.qoi_photo"}}[name]
    assert want <= set(got)
    assert all(got[m]["value"] >= 0 for m in want)
    assert not {m for m in got if m.startswith(("kernel_ms.", "idle_pack_ms."))}
    manifest = json.loads((run.root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in manifest["per_layer"] if name in m.get("workloads", ())}
    assert want <= listed
    assert {m for m in listed if m.startswith(("kernel_ms.", "idle_pack_ms."))}  # listed, not read


def test_pack_mb_is_the_mean_bytes_packed_and_runs_do_not_mix(root):
    """pack_mb.qoi: each window batch's packed bytes are its plan's arrays;
    a second run of the cell in the same process, whose batches carry the
    same indices, reads its own window alone."""
    metrics.reset()
    name = "tiny.tiny_screen"
    first = Run(root, name, CELLS[name][2])
    second = Run(root, name, CELLS[name][2])

    def expected(run):
        total = sum(run.plans[g].stream.nbytes + 3 * 4 * run.plans[g].batch
                    for g in run.batches)
        return total / len(run.batches) / 1e6

    assert set(first.batches) & set(second.batches)
    assert len(spans()) == len(first.spans) + len(second.spans)  # the first run's are kept
    for run in (first, second):
        assert sorted(s.batch for s in run.in_window("upload.pack")) == run.batches
        assert run.metrics["pack_mb.qoi"]["value"] == pytest.approx(expected(run), rel=1e-12)


def test_readers_read_nothing_where_spans_were_dropped(root, monkeypatch):
    """A run whose spans outgrew the buffer reads none of the span
    metrics (their means would hold the window's first batches alone),
    and reads them again once nothing was dropped."""
    metrics.reset()
    name = "tiny.tiny_screen"
    monkeypatch.setattr(profiling, "SPAN_CAP", 20)
    full = Run(root, name, CELLS[name][2])
    assert metrics.spans_dropped > 0 and full.result["correct"]
    assert not {m for m in full.metrics if m.startswith(("pack_mb.", "prep_queue_ms."))}
    monkeypatch.undo()
    metrics.reset()
    again = Run(root, name, CELLS[name][2])
    assert {"pack_mb.qoi", "prep_queue_ms.qoi"} <= set(again.metrics)
