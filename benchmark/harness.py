"""The benchmark's machinery: one cell a run, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its file under
``configs/``: the deployment's sizes and guarantees, and the plain
reference that checks it) and a traffic mix (``mixes/<traffic>.json``:
the decoder, batch, loader settings, corpus size, content generator and
how many answers the check samples).  The content generator is
``content/<name>.py``, the reference ``reference/<name>.py``, and each
metric ``metrics/<metric name>.py`` with a ``read(ctx)``.  Everything is
found by name, so a new cell, mix, configuration or metric is new files
and entries, and no edit here.

A run (``measure``):

1. makes the corpus from ``--seed`` (``corpus`` frames, on a thread pool);
2. builds the decoder the mix names and drives it through the program's
   loader, ``zpix_tpu_torch.parallel.DecodePipeline(decoder,
   prefetch=, workers=).map(batches)``, with the corpus cycled so each
   batch holds distinct images;
3. warms up (``warmup_batches``), which ends the set-up;
4. measures for ``seconds``: a closed loop that asks the loader for a
   batch, waits on a blocking CUDA event until its pixels and ``ok`` are
   complete on the card, and asks again;
5. checks a sample of the window's answers, drawn from the seed, against
   the reference (see ``check``), and reads the cell's metrics.

With ``trace`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are read from it; without, the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "zpix_tpu")
CORPUS_THREADS = 8
_load_lock = threading.RLock()


# ------------------------------------------------------------------ data


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<root>/benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / BENCH.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no {kind} file {path}")
    mod_name = f"_bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    with _load_lock:  # threads of one pool may ask at once
        mod = sys.modules.get(mod_name)
        if mod is not None and getattr(mod, "__file__", None) == str(path):
            return mod
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
        return mod


@dataclass
class Cell:
    name: str
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # the configuration's file
    mix: dict  # the traffic mix's file
    manifest: dict
    root: Path

    @property
    def batch(self) -> int:
        return self.mix["batch"]

    @property
    def mpix_per_image(self) -> float:
        return self.config["width"] * self.config["height"] / 1e6

    def metrics(self, kind: str) -> list:
        """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"benchmark: no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / BENCH.name / "mixes" / f"{entry['traffic']}.json").read_text())
    return Cell(name, entry, config, mix, manifest, root)


def make_corpus(cell: Cell, seed: int) -> list:
    """The mix's ``corpus`` frames, encoded, made from ``(seed, index)``."""
    gen = load_module("content", cell.mix["content"], cell.root)
    params = cell.mix["content_params"]

    def one(i):
        return gen.encode(cell.config, params, gen.pixels(cell.config, params, seed, i))

    with ThreadPoolExecutor(CORPUS_THREADS) as pool:
        return list(pool.map(one, range(cell.mix["corpus"])))


def make_decoder(cell: Cell, device):
    spec = cell.mix["decoder"]
    mod = importlib.import_module(spec["module"])
    return getattr(mod, spec["class"])(device=device, **spec.get("kwargs", {}))


def batch_indices(cell: Cell, g: int) -> list:
    """Corpus indices of the loader's ``g``-th batch (the corpus cycled)."""
    n, b = cell.mix["corpus"], cell.batch
    return [(g * b + j) % n for j in range(b)]


# ----------------------------------------------------------------- spans


class Spans:
    """Host spans the benchmark records around the calls into the program:
    (name, start, end) on ``time.perf_counter``; under the profiler each is
    also a ``record_function`` named ``bench.<name>``, so the trace places
    it."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()
        self.profiled = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiled:
            from torch.profiler import record_function

            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        t1 = time.perf_counter()
        with self._lock:
            self.items.append((name, t0, t1))

    def durations(self, name: str, lo: float, hi: float) -> list:
        """Seconds of the ``name`` spans that started in [lo, hi)."""
        with self._lock:
            return [b - a for n, a, b in self.items if n == name and lo <= a < hi]


class Timed:
    """The decoder, its ``prep``, ``upload`` and ``run`` inside the
    benchmark's spans, for ``DecodePipeline(decoder=...)``.  After each
    ``run`` it keeps what the program counts for that batch (K23's
    passes, ``last_rounds``)."""

    def __init__(self, decoder, spans: Spans):
        self.decoder = decoder
        self.spans = spans
        self.rounds: list = []

    def prep(self, datas):
        with self.spans.span("prep"):
            return self.decoder.prep(datas)

    def upload(self, plan):
        with self.spans.span("upload"):
            return self.decoder.upload(plan)

    def run(self, plan, bufs):
        with self.spans.span("launch"):
            out = self.decoder.run(plan, bufs)
        rounds = getattr(self.decoder, "last_rounds", None)
        if rounds is not None:
            self.rounds.append(rounds)
        return out


def split(out):
    """A loader result -> (pixels, ok tensor or None where the route has no flag)."""
    if isinstance(out, tuple):
        return out[0], out[1]
    return out, None


# ---------------------------------------------------------------- window


@dataclass
class Window:
    t0: float
    t_end: float = 0.0
    cpu_s: float = 0.0
    asks: list = field(default_factory=list)  # (t ask, t complete, ok, global batch index)
    trace: object = None  # devtrace.Trace of a traced window
    warmup_ok_false: int = 0  # warm-up batches the program flagged ok False

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


class Reservoir:
    """``size`` of the window's batches, each kept with equal chance, drawn
    from the seed (reservoir sampling: the window's length is not known
    before it closes)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2**64, 0x6B65])
        self.kept: list = []  # (global batch index, pixels)
        self.seen = 0

    def offer(self, g: int, pixels) -> None:
        if self.seen < self.size:
            self.kept.append((g, pixels))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (g, pixels)
        self.seen += 1


def _wait(device) -> None:
    """Block until the work enqueued so far (the batch's pixels and ok) is
    complete on the card: a blocking CUDA event, so the host thread sleeps
    and spends no CPU."""
    if device.type == "cuda":
        import torch

        ev = torch.cuda.Event(blocking=True)
        ev.record()
        ev.synchronize()


def drive(cell: Cell, corpus: list, *, seconds: float, seed: int, device, trace: bool,
          spans: Spans, timed: Timed):
    """Warm up, then the measured window -> (Window, Reservoir)."""
    from zpix_tpu_torch.parallel import DecodePipeline

    state = {"g": 0}

    def batches():
        while True:
            yield [corpus[i] for i in batch_indices(cell, state["g"])]
            state["g"] += 1

    pipe = DecodePipeline(timed, prefetch=cell.mix["prefetch"], workers=cell.mix["workers"])
    it = pipe.map(batches())
    g_next = warm_bad = 0
    try:
        for _ in range(cell.mix["warmup_batches"]):
            ok = split(next(it))[1]  # the pixels go at once: they are not checked
            _wait(device)
            warm_bad += ok is not None and not bool(ok)
            g_next += 1
        sample = Reservoir(cell.mix["check"]["batches"], seed)
        prof = None
        with contextlib.ExitStack() as stack:
            if trace:
                prof = stack.enter_context(_profiler(device))
                spans.profiled = True
                stack.callback(setattr, spans, "profiled", False)
            timed.rounds.clear()
            win = Window(t0=time.perf_counter(), warmup_ok_false=warm_bad)
            win.t_end = win.t0
            c0 = time.process_time()
            with spans.span("window"):
                while time.perf_counter() - win.t0 < seconds:
                    ta = time.perf_counter()
                    with spans.span("ask"):
                        pixels, ok = split(next(it))
                    with spans.span("wait"):
                        _wait(device)
                    win.t_end = time.perf_counter()
                    win.asks.append((ta, win.t_end, ok is None or bool(ok), g_next))
                    sample.offer(g_next, pixels)
                    g_next += 1
            win.cpu_s = time.process_time() - c0
        if prof is not None:
            from benchmark import devtrace

            win.trace = devtrace.Trace.of(prof)
    finally:
        it.close()  # the loader's pool waits for the preps still running
    return win, sample


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


# ----------------------------------------------------------------- check


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return self.value <= self.limit


def strata(batch: int, k: int, rng) -> list:
    """One position drawn from each of ``k`` equal parts of a batch."""
    edges = np.linspace(0, batch, k + 1).astype(int)
    return [int(rng.integers(edges[i], edges[i + 1])) for i in range(k)]


def expected(cell: Cell, corpus: list, seed: int, index: int) -> np.ndarray:
    """What a decode of corpus frame ``index`` must give: the generator's
    raster where the codec is lossless, else the configuration's reference
    decoder on the frame's bytes."""
    gen = load_module("content", cell.mix["content"], cell.root)
    if gen.LOSSLESS:
        raster = gen.pixels(cell.config, cell.mix["content_params"], seed, index)
        return widen(raster, cell.config.get("decoded_channels", raster.shape[-1]))
    ref = load_module("reference", cell.config["reference"], cell.root)
    return ref.decode(corpus[index])


def widen(raster: np.ndarray, channels: int) -> np.ndarray:
    """An RGB raster as the decoder gives it back with ``channels`` 4: alpha 255."""
    if raster.shape[-1] >= channels:
        return raster
    alpha = np.full(raster.shape[:-1] + (channels - raster.shape[-1],), 255, np.uint8)
    return np.concatenate([raster, alpha], -1)


def check(cell: Cell, corpus: list, seed: int, win: Window, sample: Reservoir,
          expect=expected) -> list:
    """The window's answers against the reference -> [Check].

    * ``mismatched_bytes``: of the sampled images (``check.images_per_batch``
      from each of ``check.batches`` window batches, a position from each
      equal part of the batch, all drawn from the seed), the pixel bytes
      that differ from ``expect`` (every byte of an image whose shape
      differs); limit 0, the decode is exact.
    * ``ok_false_batches``: batches, of the warm-up and the window, the
      program flagged as not decoded (``ok`` False): limit 0, every stream
      of the corpus is valid.
    * ``window_batches_missing``: 1 if the window delivered no batch."""
    rng = np.random.default_rng([seed % 2**64, 0x636B])
    k = cell.mix["check"]["images_per_batch"]
    picks = []  # (corpus index, pixels on the host)
    for g, pixels in sorted(sample.kept, key=lambda t: t[0]):
        idx = batch_indices(cell, g)
        for pos in strata(cell.batch, k, rng):
            picks.append((idx[pos], pixels[pos].cpu().numpy()))
    sample.kept.clear()  # the program's outputs are on the host now

    def compare(pick):
        i, got = pick
        want = expect(cell, corpus, seed, i)
        if got.shape != want.shape:
            return int(want.size)
        return int(np.count_nonzero(got != want))

    with ThreadPoolExecutor(CORPUS_THREADS) as pool:
        bad = sum(pool.map(compare, picks))
    return [Check("mismatched_bytes", bad, 0),
            Check("ok_false_batches",
                  win.warmup_ok_false + sum(1 for a in win.asks if not a[2]), 0),
            Check("window_batches_missing", int(not win.asks), 0)]


# --------------------------------------------------------------- metrics


@dataclass
class Context:
    """What a metric's ``read(ctx)`` reads."""

    cell: Cell
    corpus: list
    setup_s: float
    win: Window
    spans: Spans
    timed: Timed

    @property
    def ok_batches(self) -> int:
        return sum(1 for a in self.win.asks if a[2])

    @property
    def ok_mpix(self) -> float:
        return self.ok_batches * self.cell.batch * self.cell.mpix_per_image

    def delivery_ms(self) -> list:
        return [(a[1] - a[0]) * 1e3 for a in self.win.asks]

    def window_batches(self) -> list:
        """Corpus indices of each batch the window delivered."""
        return [batch_indices(self.cell, a[3]) for a in self.win.asks]


def metric_reader(name: str, root: Path = ROOT):
    """The reader of a metric: ``metrics/<its name up to the first dot>.py``,
    one file a measurement (``prep_ms.jpeg_sync`` is ``prep_ms`` read in
    the cells it lists)."""
    return load_module("metrics", name.split(".")[0], root)


def read_metrics(ctx: Context, kind: str) -> dict:
    out = {}
    for m in ctx.cell.metrics(kind):
        value = metric_reader(m["name"], ctx.cell.root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that no run may hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def measure(name: str, *, seed: int, seconds: float, trace: bool, device, t_start: float,
            root: Path = ROOT, log=print, make=make_decoder) -> dict:
    """One run of cell ``name`` -> the result's dict (without printing it).
    ``t_start``: the process's start on ``time.perf_counter``; ``make(cell,
    device)``: the decoder the loader drives (the control puts its own in
    the program's place)."""
    import torch

    cell = load_cell(name, root)
    t_corpus = time.perf_counter()
    corpus = make_corpus(cell, seed)
    t_decoder = time.perf_counter()
    spans = Spans()
    timed = Timed(make(cell, device), spans)
    win, sample = drive(cell, corpus, seconds=seconds, seed=seed, device=device, trace=trace,
                        spans=spans, timed=timed)
    setup_s = win.t0 - t_start
    quarters = np.histogram([a[1] for a in win.asks], 4, (win.t0, win.t_end))[0]
    log(f"setup {setup_s:.3f} s: imports and card {t_corpus - t_start:.3f}, corpus "
        f"{t_decoder - t_corpus:.3f} ({sum(map(len, corpus)) / 1e6:.1f} MB), decoder and "
        f"warm-up {win.t0 - t_decoder:.3f}; window {win.seconds:.3f} s, "
        f"{len(win.asks)} batches (by quarter {quarters.tolist()}), cpu {win.cpu_s:.3f} s")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.entry["chips"], "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    metrics = read_metrics(Context(cell, corpus, setup_s, win, spans, timed),
                           "per_layer" if trace else "end_to_end")
    breakdown = None
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s()
        breakdown = win.trace.breakdown()
    close = getattr(timed.decoder, "close", None)
    if close is not None:
        close()
    del timed  # the program's state goes before the reference runs
    checks = check(cell, corpus, seed, win, sample)
    attempted = len(win.asks) * cell.batch
    failed = sum(1 for a in win.asks if not a[2]) * cell.batch
    result = {"correct": all(c.passed for c in checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        log(f"check {c.name} {c.value} limit {c.limit} {'ok' if c.passed else 'FAILED'}")
    return result
