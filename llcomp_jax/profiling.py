"""Tracing / profiling hooks (SURVEY §5: absent in the reference).

Thin wrappers over jax.profiler so codec phases show up named in TensorBoard
/ Perfetto traces, plus a tiny wall-clock phase timer for host-side stats.
"""
from __future__ import annotations

import contextlib
import os
import time

import jax


@contextlib.contextmanager
def annotate(label: str):
    """Name a region in device traces (no-op cost when not tracing)."""
    with jax.profiler.TraceAnnotation(label):
        yield


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a device trace for the enclosed block into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulating wall-clock timer: ``with timer('encode'): ...``."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }


def enabled() -> bool:
    """Stage profiling is on when LLCT_PROFILE=1 (checked per call so tests
    can toggle it)."""
    return os.environ.get("LLCT_PROFILE") == "1"


#: process-wide stage timer; ``python bench.py`` prints its report when
#: LLCT_PROFILE=1.
stages = PhaseTimer()


def timed(label: str, fn, *args, **kwargs):
    """Run one pipeline stage, named in device traces via ``annotate``.

    With LLCT_PROFILE=1 also blocks on the stage's outputs and records the
    wall time in ``stages`` — this serializes JAX's async dispatch, so
    profile-mode throughput is NOT representative; it exists to attribute
    time, not to measure end-to-end speed.
    """
    if not enabled():
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    with annotate(label):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    stages.totals[label] = stages.totals.get(label, 0.0) + dt
    stages.counts[label] = stages.counts.get(label, 0) + 1
    return out
