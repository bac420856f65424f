"""Bilateral-family parity: XLA ops vs golden references on seed-42 random
images (the reference's 50×50 unit-test workload, test/bilateral_filter.cu)."""

import numpy as np
import pytest

from various_image_processings_tpu import golden
from various_image_processings_tpu.core.rng import random_image, MT19937
from various_image_processings_tpu.ops.bilateral import bilateral_filter, joint_bilateral_filter
from various_image_processings_tpu.ops.adaptive_bilateral import adaptive_bilateral_filter


def max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.mark.parametrize("ksize", [3, 9, 15])
def test_bilateral_xla_vs_golden(ksize):
    src = random_image(50, 50)
    expected = golden.bilateral_filter(src, ksize, 10.0, 30.0)
    actual = bilateral_filter(src, ksize, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_joint_bilateral_xla_vs_golden():
    src = random_image(50, 50)
    # independent guide drawn further along the same stream
    rng = MT19937(42)
    raw = rng.raw(2 * 50 * 50 * 3)
    guide = (raw[50 * 50 * 3:] % np.uint32(255)).astype(np.uint8).reshape(50, 50, 3)
    expected = golden.joint_bilateral_filter(src, guide, 9, 10.0, 30.0)
    actual = joint_bilateral_filter(src, guide, 9, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_adaptive_bilateral_xla_vs_golden():
    src = random_image(50, 50)
    expected = golden.adaptive_bilateral_filter(src, 9, 10.0, 30.0)
    actual = adaptive_bilateral_filter(src, 9, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_adaptive_bilateral_small_ksize_boundary_flips_rare():
    # At k=3 the offset can be extreme and the f32-vs-exact LUT index
    # boundary flips (see ops/adaptive_bilateral.py) can move individual
    # degenerate pixels; they must stay rare.
    src = random_image(50, 50)
    expected = golden.adaptive_bilateral_filter(src, 3, 10.0, 30.0)
    actual = np.asarray(adaptive_bilateral_filter(src, 3, 10.0, 30.0, impl="xla"))
    diff = np.abs(actual.astype(np.int32) - expected.astype(np.int32))
    assert (diff > 1).mean() < 1e-3


def test_bilateral_nonsquare_image():
    src = random_image(37, 61)
    expected = golden.bilateral_filter(src, 9, 10.0, 30.0)
    actual = bilateral_filter(src, 9, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_abf_subnormal_weight_band_parity():
    """Small σ_color on noise images drives EVERY tap's range weight into the
    reference LUT's f32-subnormal band (the LUT is f64-built/f32-stored and
    fades through subnormals before exact 0) — a plain f32 exp recompute
    flushes the band to zero and divides 0/0 where the reference returns a
    meaningful value (was: garbage diffs up to 254).  The 2⁶⁴ weight bias +
    exact-zero cutoff (core/luts.py color_table_zero_index) bounds the band
    to a few u8 of golden (golden is bit-exact vs the compiled reference
    here).  The residual wobble is inherent: band weights carry only 1–6
    significant bits (the LUT entries are f32 subnormals), so ±1 ulp of
    exp2 — which varies across vector/scalar libm lanes and platforms —
    amplifies to ±few u8, the same instability class as the reference's own
    CPU-vs-CUDA divergence.  Regression for ops/adaptive_bilateral.py
    (pre-fix this measured max 254)."""
    import warnings
    from various_image_processings_tpu import golden
    from various_image_processings_tpu.core.rng import random_image
    from various_image_processings_tpu.ops.adaptive_bilateral import (
        adaptive_bilateral_filter)

    for k, ss, sc, h, w in [(3, 9.3, 16.3, 26, 41), (15, 22.8, 11.5, 45, 13),
                            (11, 8.0, 21.8, 35, 56), (11, 19.6, 35.6, 33, 49)]:
        img = random_image(h, w)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # golden 0/0 where the ref does it
            exp = golden.adaptive_bilateral_filter(img, k, ss, sc)
        got = np.asarray(adaptive_bilateral_filter(img, k, ss, sc, impl="xla"))
        diff = np.abs(got.astype(int) - exp.astype(int))
        assert diff.max() <= 8, (k, sc, diff.max())
        assert (diff > 2).sum() <= 8, (k, sc, int((diff > 2).sum()))


def test_abf_box_mean_division_exhaustive():
    """The ABF index twin (PARITY.md D2) needs fl(box/k²) bit-equal to the
    host's IEEE-RN f32 division for EVERY reachable box value.  XLA
    strength-reduces division by a literal constant into reciprocal-multiply
    (measured: fl(598/9) off by 1 ulp) — the path guards with
    jax.lax.optimization_barrier.  This pins the guarded construction,
    exhaustively, for the XLA graph."""
    import jax
    import jax.numpy as jnp

    for k in (3, 5, 7, 9, 11, 13, 15):
        k2 = np.float32(k * k)
        box = np.arange(0, 255 * k * k + 1, dtype=np.float32)
        want = (box / k2).astype(np.float32)

        @jax.jit
        def xla_div(x, kk=float(k2)):
            kb = jax.lax.optimization_barrier(jnp.float32(kk))
            return x / kb

        got = np.asarray(xla_div(jnp.asarray(box)))
        assert np.array_equal(want, got), f"xla k={k}"


def test_abf_subnormal_grid_rounding_not_folded():
    """The D2b weight twin's add-subtract grid rounding must survive
    compilation: XLA's simplifier folds (v + C) − C → v for a literal C,
    silently deleting the quantization — the code barriers C.  Pin the
    guarded construction on a band value (identity would return v)."""
    import jax
    import jax.numpy as jnp

    C = np.float32(2.0 ** -62)
    v = np.float32(1.7e-26)  # inside the biased subnormal band
    want = np.float32(np.float32(v + C) - C)
    assert want != v  # the quantization must actually move this value

    @jax.jit
    def q(x):
        c = jax.lax.optimization_barrier(jnp.float32(C))
        return (x + c) - c

    assert np.asarray(q(jnp.float32(v))) == want


def test_abf_product_underflow_zero_window():
    """SMALL σ_space × small σ_color: the reference's per-tap f32 weight is
    the PRODUCT kernel_space·color_table[idx]
    (include/cpp/adaptive_bilateral_filter.hpp:68) — a tiny space weight
    times an f32-subnormal table entry underflows to exact 0 several
    indices before the table itself reaches 0, and on noise images entire
    windows land past that boundary (reference: 0/0 → NaN → u8 0).  The
    round-3 LUT-only cutoff (color_table_zero_index) kept those weights
    alive and computed a real average — diffs up to 255 (found by the
    round-4 fuzz campaign, cases 131/207/256/306).  The double-rounded
    grid quantization (whose flush boundary equals the product's, pinned
    vs product_zero_index in test_luts.py) + the sumk==0 select pin the
    class exactly; surviving band pixels keep the D2b few-u8 wobble."""
    import warnings
    from various_image_processings_tpu import golden

    # (k, σs, σc, h, w): the four fuzz-failure parameter points (diff 203-255
    # pre-fix; the class needs σ_space ≲ 2, which the band test above misses)
    for i, (k, ss, sc, h, w) in enumerate([(13, 1.13, 1.6, 50, 50),
                                           (7, 1.13, 5.14, 32, 32),
                                           (15, 0.47, 3.49, 31, 64),
                                           (13, 1.75, 5.14, 48, 48)]):
        img = np.random.default_rng(777 + i).integers(
            0, 256, (h, w, 3), np.uint8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # golden 0/0 where the ref does it
            exp = golden.adaptive_bilateral_filter(img, k, ss, sc)
        got = np.asarray(adaptive_bilateral_filter(img, k, ss, sc, impl="xla"))
        diff = np.abs(got.astype(int) - exp.astype(int))
        assert diff.max() <= 4, (k, ss, sc, diff.max())
        assert (diff > 1).sum() <= 4, (k, ss, sc, int((diff > 1).sum()))
