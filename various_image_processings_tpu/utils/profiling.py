"""Benchmark timing utilities.

Counterpart of the reference's ``MEASURE`` macro
(sample/benchmark/main.cpp:20-33): N+1 runs, first discarded as warmup,
mean wall-clock msec — plus MP/s, and optional jax.profiler traces.  Every
timed call ends in ``jax.block_until_ready``: JAX returns before the device
finishes, so a timing without it measures the enqueue.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


def fence(out):
    """Wait until every leaf of ``out`` has been computed; returns ``out``."""
    return jax.block_until_ready(out)


def _warm_seconds(fn, args, n: int) -> list[float]:
    """Seconds of each of ``n`` calls ``fn(*args)``, each ending in a fence."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fence(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def measure(fn, iters: int = 50) -> float:
    """Mean msec per call over `iters` runs, first (compile) run discarded.
    `fn` must return a jax array (or pytree)."""
    fence(fn())
    return sum(_warm_seconds(fn, (), iters)) / iters * 1e3


def timed(fn, *args, n: int = 5):
    """(output, compile+first-run seconds, median warm msec of ``n`` calls)."""
    t0 = time.perf_counter()
    out = fence(fn(*args))
    first = time.perf_counter() - t0
    return out, first, float(np.median(_warm_seconds(fn, args, n))) * 1e3


def measure_throughput(fn, pixels: int, iters: int = 50):
    """(mean msec, MP/s)."""
    ms = measure(fn, iters)
    return ms, pixels / ms / 1e3


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (TensorBoard-compatible)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
