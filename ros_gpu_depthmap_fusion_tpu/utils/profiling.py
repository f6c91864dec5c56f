"""Profiling utilities.

- :class:`MeasureTime` — section timers with exponentially-weighted-average
  smoothing and per-frame accumulation, mirroring the reference's profiler
  (``measure_time.h:6-133``, EWA gain 0.1 set at gpu_depthmap_fusion.cpp:655).
- :class:`StageTimer` — the per-frame stage-timing schema the reference
  prints when ``enable_debug_output`` is set (``_component.cpp:471-514``):
  a fixed stage list with per-frame microsecond readings. The fused step is
  one XLA program, so stage-level numbers come from running the stage list
  separately under :func:`hard_sync` (see ``benchmarks/stage_breakdown.py``)
  or from a ``jax.profiler`` trace; end-to-end numbers use this timer
  around the fused step.
- ``jax.profiler`` trace capture helper for Perfetto/XProf.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


def hard_sync(x) -> None:
    """Wait until the device work producing ``x`` has finished. JAX
    dispatch is asynchronous, so timing code must end its timed region
    here or it measures the enqueue, not the work. The program runs its
    tests on the CPU (``tests/conftest.py``: 8 virtual devices) and its
    measurements on the GPU (``python chip_smoke.py``, ``python
    bench.py``); ``block_until_ready`` is a complete sync on both."""
    import jax
    jax.block_until_ready(x)

# the reference's canonical stage schema (_component.cpp:471-514)
REFERENCE_STAGES = [
    "add", "upload_process_point_sequences", "upload_depth", "convert",
    "flying_pixel", "crop", "mask", "voxel_coords", "download_points",
    "voxelize", "occupancy", "download_grid", "segmentation", "tracking",
    "publish_objects", "publish", "total",
]


class MeasureTime:
    """EWA section profiler (measure_time.h translation)."""

    def __init__(self, gain: float = 0.1):
        self.gain = gain
        self.smoothed: Dict[str, float] = {}
        self.frame_acc: Dict[str, float] = {}
        self._open: Dict[str, float] = {}
        self._frame_start: Optional[float] = None

    def begin_frame(self):
        self._frame_start = time.perf_counter()
        self.frame_acc = {}

    def begin(self, name: str):
        self._open[name] = time.perf_counter()

    def end(self, name: str):
        t = time.perf_counter() - self._open.pop(name)
        self.frame_acc[name] = self.frame_acc.get(name, 0.0) + t

    @contextlib.contextmanager
    def section(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def end_frame(self):
        if self._frame_start is not None:
            self.frame_acc["__frame__"] = (time.perf_counter()
                                           - self._frame_start)
        for name, t in self.frame_acc.items():
            if name in self.smoothed:
                self.smoothed[name] = (t * self.gain
                                       + (1 - self.gain) * self.smoothed[name])
            else:
                self.smoothed[name] = t

    def report(self) -> str:
        lines = []
        for name, t in sorted(self.smoothed.items()):
            lines.append(f"{name:36s} {t * 1e6:12.1f} us")
        return "\n".join(lines)


class StageTimer:
    """Fixed-schema per-frame stage timing (microseconds)."""

    def __init__(self, stages: Optional[List[str]] = None):
        self.stages = stages or REFERENCE_STAGES
        self.readings: Dict[str, List[float]] = {s: [] for s in self.stages}

    def record(self, stage: str, seconds: float):
        self.readings.setdefault(stage, []).append(seconds)

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                hard_sync(block)
            self.record(name, time.perf_counter() - t0)

    def summary_us(self) -> Dict[str, float]:
        return {s: (1e6 * sum(v) / len(v)) for s, v in self.readings.items()
                if v}

    def report(self) -> str:
        return "\n".join(f"{s:32s} {us:12.1f} us"
                         for s, us in self.summary_us().items())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in Perfetto/XProf."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
