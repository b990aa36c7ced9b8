"""Counters, stage timers and the profiler hook.

The port of zpix_tpu/utils/profiling.py:

* ``metrics``: a process-wide registry of counters and stage timers
  (images, megapixels, host time a stage) that the decoders feed under
  the JAX package's names (``jpeg_onchip.prep``, ``png_batch.images``...).
* ``trace(name)``: a context manager timing a host stage into it.  Around
  a kernel dispatch it measures the host's time to issue the launches: it
  never synchronises the device.
* ``profile_trace(log_dir)``: ``torch.profiler`` over the enclosed region
  (the CPU, and the card where there is one), written as a Chrome trace
  into ``log_dir``; the JAX package wraps ``jax.profiler`` here.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class Metrics:
    """Thread-safe counters and stage timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self.timer_calls: dict[str, int] = defaultdict(int)

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
        with self._lock:
            self.counters.clear()
            self.timers.clear()
            self.timer_calls.clear()

    def report(self) -> str:
        """One aligned text table: the counters, then each stage timer's
        total and mean a call."""
        snap = self.snapshot()
        lines = [f"{k:<36} {snap['counters'][k]:>12.3f}" for k in sorted(snap["counters"])]
        for k in sorted(snap["timers"]):
            t = snap["timers"][k]
            mean = t["total_s"] / max(t["calls"], 1)
            lines.append(f"{k:<36} {t['total_s'] * 1e3:>9.1f} ms "
                         f"({t['calls']}x, {mean * 1e3:.2f} ms/call)")
        return "\n".join(lines)


metrics = Metrics()


@contextlib.contextmanager
def trace(name: str, registry: Metrics = metrics):
    """Time a host stage into the registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.add_time(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler.profile`` over the enclosed region, CPU activity
    and, where a CUDA device is present, the card's (synchronised at the
    region's end); yields the profiler (its ``events()`` hold the device
    ops) and writes the timeline as a
    Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir``."""
    import torch
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
