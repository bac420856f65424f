"""Kernel parity on the CPU.

The bilateral / joint bilateral cases run the Pallas-Triton kernel
(ops/pallas/bilateral.py) in interpret mode against the golden twin; the
compiled kernel is held to the same references on the card by
tests/test_gpu.py.  ABF, gradient and the BTF stages have no kernel: their
cases here hold the XLA paths to golden."""

import jax.numpy as jnp
import numpy as np
import pytest

from various_image_processings_tpu import golden
from various_image_processings_tpu.core.rng import random_image, random_array
from various_image_processings_tpu.ops.bilateral import (
    bilateral_filter, joint_bilateral_filter, _bilateral_math)
from various_image_processings_tpu.ops.adaptive_bilateral import adaptive_bilateral_filter
from various_image_processings_tpu.ops.gradient import gradient
from various_image_processings_tpu.ops.pallas.bilateral import (
    joint_bilateral_pallas, _tap_tables)

SQRT3 = float(np.sqrt(np.float32(3.0)))


def max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


@pytest.mark.parametrize("shape", [(50, 50), (37, 61)])
def test_pallas_bilateral_vs_golden(shape):
    src = random_image(*shape)
    expected = golden.bilateral_filter(src, 9, 10.0, 30.0)
    actual = bilateral_filter(src, 9, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


def test_pallas_joint_bilateral_vs_golden():
    src = random_image(50, 50)
    guide = random_image(50, 50)[::-1].copy()
    expected = golden.joint_bilateral_filter(src, guide, 9, 10.0, 30.0)
    actual = joint_bilateral_filter(src, guide, 9, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


@pytest.mark.parametrize("ksize", [3, 5, 11])
def test_pallas_bilateral_pair_kernel_other_k(ksize):
    # other odd k: other circle spans per tap row, other halo widths
    src = random_image(41, 57)
    expected = golden.bilateral_filter(src, ksize, 10.0, 30.0)
    actual = bilateral_filter(src, ksize, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


def test_pallas_joint_pair_kernel_k11():
    src = random_image(41, 57)
    guide = random_image(41, 57)[::-1].copy()
    expected = golden.joint_bilateral_filter(src, guide, 11, 10.0, 30.0)
    actual = joint_bilateral_filter(src, guide, 11, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


def test_pallas_adaptive_bilateral_vs_golden():
    src = random_image(50, 50)
    expected = golden.adaptive_bilateral_filter(src, 9, 10.0, 30.0)
    actual = adaptive_bilateral_filter(src, 9, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_pallas_adaptive_bilateral_large_sigma_specialized_kernel():
    """σ_color ≳ 107 puts the LUT zero index past the reachable dist range
    (3·510); pins the XLA path's parity on both sides of that threshold."""
    src = random_image(50, 50)
    for sc in (105.0, 150.0):
        expected = golden.adaptive_bilateral_filter(src, 9, 10.0, sc)
        actual = adaptive_bilateral_filter(src, 9, 10.0, sc, impl="xla")
        assert max_diff(actual, expected) <= 1, sc


def test_pallas_large_ksize_falls_back_to_xla():
    # 17×17 (the BTF joint-bilateral size): the same kernel, longer tap loop
    src = random_image(40, 40)
    expected = golden.joint_bilateral_filter(src, src, 17, 8.0, 1.7320508)
    actual = joint_bilateral_filter(src, src, 17, 8.0, 1.7320508, impl="pallas")
    assert max_diff(actual, expected) <= 1


@pytest.mark.parametrize("channels", [1, 3])
def test_pallas_gradient_vs_golden(channels):
    src = random_array(50 * 50 * channels).reshape(50, 50, channels)
    expected = golden.gradient(src)
    got = np.asarray(gradient(src, impl="xla"))
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(expected)))
    assert np.all(np.abs(got - expected) <= 4 * ulp)


def test_pallas_btf_stages_vs_golden():
    from various_image_processings_tpu.ops.bilateral_texture import (
        _blur_and_rtv_math, _guide_math)
    src = random_image(50, 50)
    mag = golden.gradient(src)
    blurred_g, rtv_g = golden.compute_blur_and_rtv(src, mag, 9)
    blurred, rtv = _blur_and_rtv_math(jnp.asarray(src).astype(jnp.float32),
                                      jnp.asarray(mag), 9)
    np.testing.assert_allclose(np.asarray(blurred), blurred_g, atol=1e-3)
    np.testing.assert_allclose(np.asarray(rtv), rtv_g, rtol=1e-4, atol=1e-5)
    expected_guide = golden.compute_guide(blurred_g, rtv_g, 9)
    guide = np.asarray(_guide_math(jnp.asarray(blurred_g), jnp.asarray(rtv_g),
                                   9, strict=True))
    assert max_diff(guide, expected_guide) <= 1


def test_pallas_btf_end_to_end():
    from various_image_processings_tpu.ops.bilateral_texture import bilateral_texture_filter
    src = random_image(40, 40)
    expected = golden.bilateral_texture_filter(src, ksize=5, nitr=2)
    actual = np.asarray(bilateral_texture_filter(src, ksize=5, nitr=2, impl="pallas"))
    diff = np.abs(actual.astype(np.int64) - expected.astype(np.int64))
    assert np.percentile(diff, 99.9) <= 2
    assert diff.max() <= 3


@pytest.mark.parametrize("ksize", [17, 21])
def test_pallas_chunked_self_bilateral(ksize):
    # self-guided large k (one input stream, many tap rows)
    src = random_image(45, 70)
    expected = golden.bilateral_filter(src, ksize, 10.0, 30.0)
    actual = bilateral_filter(src, ksize, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


def test_pallas_chunked_joint_rectangular():
    src = random_image(33, 90)
    guide = random_image(33, 90)[::-1].copy()
    expected = golden.joint_bilateral_filter(src, guide, 17, 8.0, 1.7320508)
    actual = joint_bilateral_filter(src, guide, 17, 8.0, 1.7320508, impl="pallas")
    assert max_diff(actual, expected) <= 1


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"),
                                             ("reflect101", "rint")])
def test_planar_joint_bilateral_matches_hwc(border, rounding):
    """The kernel works on the planar (3, H, W) padded image; its HWC
    result must match the HWC XLA path for both JBF semantics
    (reference-CUDA and cv::ximgproc) at the BTF's k=17 — exercising the
    replicate AND reflect-101 halo and the half-even rounding."""
    src = random_image(41, 57)
    guide = random_image(41, 57)[::-1].copy()
    kern = np.asarray(joint_bilateral_pallas(
        jnp.asarray(src), jnp.asarray(guide), 17, 8.0, SQRT3, border,
        rounding, interpret=True))
    xla = np.asarray(_bilateral_math(
        jnp.asarray(src).astype(jnp.float32),
        jnp.asarray(guide).astype(jnp.float32), 17, 8.0, SQRT3, border,
        rounding))
    assert kern.shape == src.shape and kern.dtype == np.uint8
    diff = np.abs(kern.astype(int) - xla.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


# Deterministic odd-shape sweep over the kernel's (8, 64) output tile:
# exactly one tile, heights below one tile, widths one past a tile
# boundary, several tiles with a partial last one, extreme aspect ratios —
# the padding/cropping of the kernel wrapper (k=9 and the BTF's k=17) and
# the ABF XLA path.
_SWEEP_SHAPES = [(8, 64), (7, 131), (9, 257), (25, 130), (83, 19)]


@pytest.mark.parametrize("shape", _SWEEP_SHAPES)
def test_odd_shape_sweep_bilateral(shape):
    src = random_image(*shape)
    expected = golden.bilateral_filter(src, 9, 10.0, 30.0)
    actual = bilateral_filter(src, 9, 10.0, 30.0, impl="pallas")
    assert max_diff(actual, expected) <= 1


def test_odd_shape_sweep_adaptive():
    src = random_image(7, 131)
    expected = golden.adaptive_bilateral_filter(src, 9, 10.0, 30.0)
    actual = adaptive_bilateral_filter(src, 9, 10.0, 30.0, impl="xla")
    assert max_diff(actual, expected) <= 1


def test_odd_shape_sweep_chunked_joint():
    src = random_image(7, 131)
    guide = random_image(7, 131)[::-1].copy()
    expected = golden.joint_bilateral_filter(src, guide, 17, 8.0, 1.7320508)
    actual = joint_bilateral_filter(src, guide, 17, 8.0, 1.7320508,
                                    impl="pallas")
    assert max_diff(actual, expected) <= 1


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 5)])
def test_sub_radius_images_match_golden(shape):
    """Images smaller than the kernel radius exercise the full replicate
    border machinery on every side simultaneously (reference clamps per-tap,
    include/cpp/bilateral_filter.hpp:89-90); all paths must stay exact."""
    from various_image_processings_tpu.ops.bilateral_texture import (
        bilateral_texture_filter)
    src = random_image(*shape)
    assert max_diff(bilateral_filter(src, 9, 10.0, 30.0, impl="pallas"),
                    golden.bilateral_filter(src, 9, 10.0, 30.0)) == 0
    assert max_diff(adaptive_bilateral_filter(src, 9, 10.0, 30.0, impl="xla"),
                    golden.adaptive_bilateral_filter(src, 9, 10.0, 30.0)) == 0
    assert max_diff(bilateral_texture_filter(src, ksize=5, nitr=1, impl="xla"),
                    golden.bilateral_texture_filter(src, ksize=5, nitr=1)) == 0


@pytest.mark.parametrize("ksize,sigma_space", [(3, 10.0), (9, 10.0),
                                               (17, 8.0), (15, 0.5)])
def test_tap_tables_cover_exactly_the_nonzero_taps(ksize, sigma_space):
    """The kernel loops over each tap row's [lo, hi) span: together the
    spans must hold every non-zero spatial weight (in (ky, kx) order) and
    nothing but zeros besides."""
    from various_image_processings_tpu.core.luts import space_kernel
    ws, span = _tap_tables(ksize, sigma_space)
    space = space_kernel(ksize, sigma_space)
    np.testing.assert_array_equal(ws, space.reshape(-1))
    covered = np.zeros((ksize, ksize), bool)
    for ky in range(ksize):
        lo, hi = span[2 * ky], span[2 * ky + 1]
        assert 0 <= lo <= hi <= ksize
        covered[ky, lo:hi] = True
    assert not space[~covered].any()
    assert covered[ksize // 2, ksize // 2]

