"""A traced window, read from ``torch.profiler``: the card's operations and
the benchmark's host spans on one clock.

The interval arithmetic is ``chip_smoke.py``'s (``device_spans``,
``busy_and_gaps``, ``profiled_busy_share``), copied so that the yardstick
does not move with the program's scripts: the card is busy where any of
its kernels, copies or memsets runs on any stream (their union), and
idle elsewhere in the window.  Each idle gap is named by what the host's
loop thread was doing at the gap's middle: the innermost of the spans
``harness.drive`` records (``upload``, ``launch`` inside ``ask``, then
``wait``), "wait_prep" where ``ask`` holds neither (the loader waits for
its worker's prep), "consumer" outside them (the loop's own work).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

MAIN_SPANS = ("bench.upload", "bench.launch", "bench.ask", "bench.wait")
GAP_NAMES = {"bench.upload": "upload", "bench.launch": "launch", "bench.ask": "wait_prep",
             "bench.wait": "wait_card", None: "consumer"}


def _events(prof):
    """-> ([(start ns, end ns, name)] of the card's ops, [(start, end, name)]
    of the ``bench.*`` host spans), from the profiler's raw events in ns."""
    from torch.autograd import DeviceType

    rows = [(e.device_type(), e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()]

    # the profiler also lays each host span over the card's timeline as a
    # user annotation of the same name: those are no work of the card
    dev = sorted((a, b, n) for t, a, b, n in rows
                 if t == DeviceType.CUDA and not n.startswith("bench."))
    host = sorted((a, b, n) for t, a, b, n in rows
                  if t == DeviceType.CPU and n.startswith("bench."))
    return dev, host


def busy_and_gaps(spans, lo: float, hi: float):
    """The union of ``spans`` [(start, end, name)] inside [lo, hi] -> (its
    length, the idle gaps [(start, end)] of [lo, hi] outside it)."""
    busy, gaps, end = 0, [], lo
    for a, b, _ in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


@dataclass
class Trace:
    dev: list  # the card's ops (start ns, end ns, name), by start
    host: list  # the bench.* spans
    lo: int  # the window, ns
    hi: int
    _main: list = field(default_factory=list, repr=False)  # the loop thread's spans

    def __post_init__(self):
        self._main = [s for s in self.host if s[2] in MAIN_SPANS]
        self._starts = [s[0] for s in self._main]

    @classmethod
    def of(cls, prof) -> "Trace":
        dev, host = _events(prof)
        win = [(a, b) for a, b, n in host if n == "bench.window"]
        lo, hi = win[0] if win else ((dev[0][0], max(b for _, b, _ in dev)) if dev else (0, 0))
        return cls(dev, host, lo, hi)

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return busy_and_gaps(self.dev, self.lo, self.hi)[0] / 1e9

    def op_seconds(self, match) -> float:
        """Device seconds, inside the window, of the ops whose name ``match(name)`` accepts."""
        return sum(min(b, self.hi) - max(a, self.lo) for a, b, n in self.dev
                   if match(n) and min(b, self.hi) > max(a, self.lo)) / 1e9

    def _doing(self, t: int):
        """The innermost loop-thread span holding time ``t`` (None: none).
        The thread's spans nest, so it is the latest to start that holds it."""
        for a, b, n in reversed(self._main[max(0, bisect.bisect_right(self._starts, t) - 3):
                                           bisect.bisect_right(self._starts, t)]):
            if b >= t:
                return n
        return None

    def breakdown(self) -> dict:
        """The ten ops that took the most device time, and the idle time by
        what the host was doing, in seconds, most first."""
        by_op = defaultdict(int)
        for a, b, n in self.dev:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                by_op[n] += b - a
        by_gap = defaultdict(int)
        for a, b in busy_and_gaps(self.dev, self.lo, self.hi)[1]:
            by_gap[GAP_NAMES[self._doing((a + b) // 2)]] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s / 1e9] for n, s in top],
                "idle_gaps": [[n, s / 1e9] for n, s in gaps]}
