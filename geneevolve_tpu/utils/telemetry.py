"""Observability: memory reports, per-stage timing, profiler traces.

The reference's telemetry is `process_mem_usage` (VM/RSS from
`/proc/self/stat`, `/root/reference/src/Simulation.cpp:3440-3475`) plus
`time(0)` deltas printed per phase and per generation
(`Simulation.cpp:2067-2079`). This module keeps those artifacts (same
units, Mb) and adds what a device program needs: per-device HBM stats and
`jax.profiler` trace capture.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import jax


def process_mem_usage() -> Tuple[float, float]:
    """(vm_mb, rss_mb) of this process, from /proc/self/stat; (0, 0) when
    unavailable (non-Linux)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().split()
        vsize = float(fields[22])
        rss_pages = float(fields[23])
        page_kb = os.sysconf("SC_PAGE_SIZE") / 1024
        return vsize / 1024.0 / 1024.0, rss_pages * page_kb / 1024.0
    except (OSError, IndexError, ValueError):
        return 0.0, 0.0


def device_memory_mb() -> Dict[str, float]:
    """{device: HBM bytes_in_use (Mb)} for devices that report memory stats
    (GPUs do; the CPU backend reports none, so it is left out)."""
    out: Dict[str, float] = {}
    for d in jax.local_devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats and "bytes_in_use" in stats:
            out[str(d)] = stats["bytes_in_use"] / 1024.0 / 1024.0
    return out


class StageTimer:
    """Accumulates wall time per named stage; one instance per run.

    Usage::

        timer = StageTimer()
        with timer("reproduce"):
            ...
        timer.report(print)
    """

    def __init__(self) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self, log=print) -> None:
        if not self.totals:
            return
        log("      stage timing (total s / calls):")
        for k, v in self.totals.items():
            log(f"        {k:<22s} {v:10.3f}  /{self.counts[k]}")


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """jax.profiler trace into `trace_dir` (viewable in TensorBoard /
    Perfetto); no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield
