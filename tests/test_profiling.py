"""Profiling utilities (the reference's only tracing is the MEASURE macro;
SURVEY.md §5 asks for jax.profiler traces + MP/s reporting)."""

import os

import jax.numpy as jnp
import pytest

from various_image_processings_tpu.utils.profiling import (
    measure, measure_throughput, fence, trace)


def test_measure_returns_positive_msec():
    x = jnp.ones((64, 64))
    ms = measure(lambda: x * 2.0, iters=3)
    assert ms > 0


def test_measure_throughput():
    x = jnp.ones((64, 64))
    ms, mps = measure_throughput(lambda: x + 1.0, pixels=64 * 64, iters=3)
    assert ms > 0 and mps > 0


def test_fence_handles_pytrees():
    fence({"a": jnp.ones((4, 4)), "b": (jnp.zeros(3), jnp.float32(1.0))})


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        (jnp.ones((128, 128)) * 3.0).block_until_ready()
    found = []
    for root, _, files in os.walk(d):
        found += files
    assert found, "no trace files written"
