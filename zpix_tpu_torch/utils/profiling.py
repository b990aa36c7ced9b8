"""Counters, stage timers, spans and the profiler hook.

The port of zpix_tpu/utils/profiling.py, and the port's span recorder:

* ``metrics``: a process-wide registry of counters and stage timers
  (images, megapixels, host time a stage) that the decoders feed under
  the JAX package's names (``jpeg_onchip.prep``, ``png_batch.images``...).
* ``trace(name)``: a context manager timing a host stage into it.  Around
  a kernel dispatch it measures the host's time to issue the launches: it
  never synchronises the device.
* Spans: while recording is on, ``trace``, ``stage`` and ``span`` also
  append a ``Span`` (name, batch id, parent, thread, start and end,
  counts) to a bounded buffer of the registry, read by ``spans()``.
  Recording is on while a ``torch.profiler`` records and inside
  ``recording()``; off, a span that feeds no timer costs one test of two
  flags and hands back a shared null context: no clock read, no lock, no
  allocation.  Spans are stamped with ``time.time_ns``, the Unix-epoch
  clock ``torch.profiler`` stamps its host events with, so a span lines
  up with the profiler's trace.  They are not ``record_function``s: under
  a CUDA profiler every ``record_function`` around launches is also laid
  over the card's timeline as an annotation, which a reader of the
  card's busy time would count as the card's work.
* Card spans: ``runtime.launch`` brackets each kernel launch with a pair
  of CUDA timing events (``record_card``), read once the second has
  completed, or on ``spans()``, as the span ``launch.<entry>.card`` with
  the count ``card_ms``: the card's time in the kernels with no profiler.
  On the CPU there are none.
* ``profile_trace(log_dir)``: ``torch.profiler`` over the enclosed region
  (the CPU, and the card where there is one), written as a Chrome trace
  into ``log_dir``; the JAX package wraps ``jax.profiler`` here.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_CAP = 1 << 18  # spans a registry keeps; later ones are counted as dropped
_NO_COUNTS: dict = {}  # the counts of a span that carries none (never written)
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """A recorded span.  ``start_ns`` and ``end_ns`` are Unix-epoch ns
    (``time.time_ns``, the profiler's clock); a ``.card`` span's are its
    launch's, and its ``counts["card_ms"]`` the card's time between its
    events.  ``batch``: the ``DecodePipeline`` batch it served
    (None outside one); ``parent``: the ``id`` of the span open around it
    on its thread."""

    name: str
    batch: int | None
    id: int
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    counts: dict


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # ids of this thread's open spans, innermost last
        self.batch: int | None = None  # the batch this thread works for


_local = _Local()
_ids = itertools.count(1)


class Metrics:
    """Thread-safe counters and stage timers, and the span buffer."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self.timer_calls: dict[str, int] = defaultdict(int)
        self._spans: list[Span] = []
        self.spans_dropped = 0  # spans not kept: the buffer held SPAN_CAP
        self._cards: deque = deque()  # (span, its events) not yet read
        self._card_lock = threading.Lock()  # taken before ``_lock``, never inside it
        self._recording = 0  # open ``recording()`` blocks

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timers[name] += seconds
            self.timer_calls[name] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers": {k: {"total_s": v, "calls": self.timer_calls[k]}
                           for k, v in self.timers.items()},
            }

    def reset(self) -> None:
        with self._card_lock:
            self._cards.clear()
        with self._lock:
            self.counters.clear()
            self.timers.clear()
            self.timer_calls.clear()
            self._spans.clear()
            self.spans_dropped = 0

    # ---------------------------------------------------------------- spans

    @property
    def is_recording(self) -> bool:
        return bool(self._recording or _autograd_profiler._is_profiler_enabled)

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the block, with no profiler."""
        with self._lock:
            self._recording += 1
        try:
            yield self
        finally:
            with self._lock:
                self._recording -= 1

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < SPAN_CAP:
                self._spans.append(span)
            else:
                self.spans_dropped += 1

    def _card(self, span: Span, events) -> None:
        """A card span and its events (``events.ms(wait)``: the card's ms
        between them, None while they run): kept until they have completed."""
        with self._card_lock:
            self._cards.append((span, events))
        self._read_cards(wait=False)

    def _read_cards(self, wait: bool) -> None:
        """Turn the card spans whose events completed into spans, in order;
        ``wait``: wait for every one (a read, never the hot path)."""
        with self._card_lock:
            while self._cards:
                span, events = self._cards[0]
                ms = events.ms(wait)
                if ms is None:
                    return
                self._cards.popleft()
                self._keep(span._replace(counts={"card_ms": ms}))

    def spans(self) -> list[Span]:
        """The spans recorded so far, in the order they ended (card spans
        once their events have completed: this waits for them)."""
        self._read_cards(wait=True)
        with self._lock:
            return list(self._spans)

    def report(self) -> str:
        """One aligned text table: the counters, then each stage timer's
        total and mean a call, then each span name's count, total, mean
        and summed counts."""
        snap = self.snapshot()
        lines = [f"{k:<36} {snap['counters'][k]:>12.3f}" for k in sorted(snap["counters"])]
        for k in sorted(snap["timers"]):
            t = snap["timers"][k]
            mean = t["total_s"] / max(t["calls"], 1)
            lines.append(f"{k:<36} {t['total_s'] * 1e3:>9.1f} ms "
                         f"({t['calls']}x, {mean * 1e3:.2f} ms/call)")
        by_name: dict = {}
        for s in self.spans():
            n, ns, counts = by_name.get(s.name, (0, 0, {}))
            for k, v in s.counts.items():
                counts[k] = counts.get(k, 0) + v
            by_name[s.name] = (n + 1, ns + s.end_ns - s.start_ns, counts)
        for k in sorted(by_name):
            n, ns, counts = by_name[k]
            summed = "".join(f", {c} {v:.6g}" for c, v in sorted(counts.items()))
            lines.append(f"span {k:<31} {ns / 1e6:>9.1f} ms ({n}x, {ns / 1e6 / n:.3f} "
                         f"ms/span{summed})")
        if self.spans_dropped:
            lines.append(f"span {'(dropped)':<31} {self.spans_dropped:>12d}")
        return "\n".join(lines)


metrics = Metrics()


class _Span:
    """A span of ``registry``: its time fed to the timer ``timer`` (where
    given), and, while recording, the span ``name`` kept with ``counts``."""

    __slots__ = ("registry", "name", "timer", "counts", "t_timer", "id", "parent", "batch",
                 "start_ns")

    def __init__(self, registry: Metrics, name: str, timer: str | None, counts: dict):
        self.registry, self.name, self.timer, self.counts = registry, name, timer, counts
        self.id = None

    def __enter__(self):
        if self.timer is not None:
            self.t_timer = time.perf_counter()
        if self.registry.is_recording:
            stack = _local.stack
            self.parent = stack[-1] if stack else None
            self.id = next(_ids)
            stack.append(self.id)
            self.batch = _local.batch
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.id is not None:
            span = Span(self.name, self.batch, self.id, self.parent, threading.get_ident(),
                        self.start_ns, time.time_ns(), self.counts or _NO_COUNTS)
            _local.stack.pop()
            self.registry._keep(span)
        if self.timer is not None:
            self.registry.add_time(self.timer, time.perf_counter() - self.t_timer)
        return False


def trace(name: str, registry: Metrics = metrics, **counts):
    """Time a host stage into the registry; while recording, also the span
    ``name`` with ``counts``."""
    return _Span(registry, name, name, counts)


def span(name: str, **counts):
    """The span ``name`` with ``counts`` (``bytes``, ``packed_bytes``,
    ``images``...), feeding no timer."""
    if not metrics.is_recording:
        return _NULL
    return _Span(metrics, name, None, counts)


def stage(route: str, step: str, timers: dict, **counts):
    """A decoder's step ``step`` ("prep", "upload" or "run") on route
    ``route`` ("jpeg_sync", "qoi_onchip"...): the span ``<route>.<step>``,
    its time also fed to the JAX package's timer ``<route>.<timers[step]>``
    where ``timers`` maps the step to the name that package times it
    under."""
    jax_name = timers.get(step)
    if jax_name is None and not metrics.is_recording:
        return _NULL
    return _Span(metrics, f"{route}.{step}", jax_name and f"{route}.{jax_name}", counts)


@contextlib.contextmanager
def for_batch(batch: int):
    """The spans this thread opens inside the block serve ``batch``."""
    before, _local.batch = _local.batch, batch
    try:
        yield
    finally:
        _local.batch = before


def now() -> int | None:
    """The span clock's time (ns) while recording, else None."""
    return time.time_ns() if metrics.is_recording else None


def _ended(name: str, start_ns: int, batch: int | None) -> Span:
    """The span ``name`` of ``batch`` from ``start_ns`` to now, kept."""
    stack = _local.stack
    span = Span(name, batch, next(_ids), stack[-1] if stack else None, threading.get_ident(),
                start_ns, time.time_ns(), _NO_COUNTS)
    metrics._keep(span)
    return span


def record(name: str, start_ns: int | None, batch: int | None) -> None:
    """Keep the span ``name`` of ``batch`` from ``start_ns`` (a ``now()``,
    perhaps on another thread) to now, where both ends fall while
    recording: a wait that crosses threads (a queue)."""
    if start_ns is not None and metrics.is_recording:
        _ended(name, start_ns, batch)


def record_card(name: str, start_ns: int | None, events) -> None:
    """Keep the span ``name`` from ``start_ns`` (a ``now()``) to now, of
    this thread's batch, and under it the span ``<name>.card`` with the
    count ``card_ms``: the card's time between ``events`` (``events.ms(wait)``
    -> ms, or None while they have not completed and ``wait`` is False),
    read once they have completed (never waiting on the hot path) or on
    ``spans()``."""
    if start_ns is None:
        return
    host = _ended(name, start_ns, _local.batch)
    metrics._card(host._replace(name=name + ".card", id=next(_ids), parent=host.id), events)


def recording():
    """Record spans into ``metrics`` inside the block, with no profiler."""
    return metrics.recording()


def spans() -> list[Span]:
    """The spans ``metrics`` recorded so far (see ``Metrics.spans``)."""
    return metrics.spans()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler.profile`` over the enclosed region, CPU activity
    and, where a CUDA device is present, the card's (synchronised at the
    region's end); yields the profiler (its ``events()`` hold the device
    ops) and writes the timeline as a
    Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir``.  Spans are
    recorded meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if len(acts) > 1:  # the device ops still in flight belong to the region
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
