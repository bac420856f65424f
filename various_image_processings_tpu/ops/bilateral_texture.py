"""Bilateral texture filter (Cho et al. 2014 texture removal).

Counterpart of ``BilateralTextureFilterImpl::execute`` (reference:
include/cpp/bilateral_texture_filter.hpp:153-164) and the CUDA pipeline
(reference: src/bilateral_texture_filter_impl.cu:199-214).

Per iteration: gradient magnitude → fused box-blur + mRTV statistics →
guide (window argmin of mRTV, first-minimum tie-break in (ky, kx) order,
α-blend) → joint bilateral with ksize=2k−1, σ_space=k−1, σ_color=√3 (the
in-repo JBF variant used by the reference's CUDA path,
src/bilateral_texture_filter_impl.cu:188; the CPU path defers to OpenCV's
ximgproc jointBilateralFilter instead, which differs slightly).

The whole nitr-iteration pipeline stays one XLA program via lax.fori_loop;
with ``impl="pallas"`` its JBF stage is the Triton kernel
(ops/pallas/bilateral.py) and the other stages stay XLA.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pad import replicate_pad
from . import _validate
from ._dispatch import resolve_impl
from .gradient import _gradient_math
from .bilateral import _bilateral_math

EPSILON = np.float32(1e-9)  # include/cpp/bilateral_texture_filter.hpp:15


def _blur_and_rtv_math(image_f: jax.Array, magnitude: jax.Array, ksize: int):
    """(H,W,3) f32 u8-valued image, (H,W) f32 magnitude →
    ((H,W,3) f32 blurred, (H,W) f32 rtv)."""
    h, w, _ = image_f.shape
    radius = ksize // 2
    # TRUE division only (reference: b_sum/(ksize*ksize) and (b+g+r)/3.f,
    # include/cpp/bilateral_texture_filter.hpp:28-29, :56-60).  XLA
    # strength-reduces division by a literal into a reciprocal-multiply,
    # 1 ulp off — enough to flip the guide stage's strict-less argmin at
    # near-ties and move the final JBF output by tens of u8 (round-4 fuzz
    # case100, 64×31 k=9: max 52 u8).  The barrier keeps the divisors
    # opaque, exactly like the ABF index twin (ops/adaptive_bilateral.py).
    threef, k2f = jax.lax.optimization_barrier(
        (jnp.float32(3.0), jnp.float32(ksize * ksize)))
    intensity = (image_f[:, :, 0] + image_f[:, :, 1] + image_f[:, :, 2]) / threef

    img_p = replicate_pad(image_f, radius, radius, radius, radius)
    int_p = replicate_pad(intensity, radius, radius, radius, radius)
    mag_p = replicate_pad(magnitude, radius, radius, radius, radius)

    b_sum = jnp.zeros((h, w, 3), jnp.float32)
    i_max = jnp.full((h, w), 0.0, jnp.float32)
    i_min = jnp.full((h, w), 256.0, jnp.float32)
    m_max = jnp.zeros((h, w), jnp.float32)
    m_sum = jnp.zeros((h, w), jnp.float32)
    for dy in range(ksize):
        for dx in range(ksize):
            b_sum = b_sum + img_p[dy : dy + h, dx : dx + w]
            iw = int_p[dy : dy + h, dx : dx + w]
            mw = mag_p[dy : dy + h, dx : dx + w]
            i_max = jnp.maximum(i_max, iw)
            i_min = jnp.minimum(i_min, iw)
            m_max = jnp.maximum(m_max, mw)
            m_sum = m_sum + mw
    blurred = b_sum / k2f
    rtv = (i_max - i_min) * m_max / (m_sum + EPSILON)
    return blurred, rtv


def _guide_math(blurred: jax.Array, rtv: jax.Array, ksize: int,
                strict: bool = False) -> jax.Array:
    """((H,W,3) f32, (H,W) f32) → (H,W,3) f32 u8-valued guide.

    Running strict-less argmin over taps in (ky, kx) order replicates the
    reference's first-minimum tie-break (include/cpp/bilateral_texture_filter.hpp:101-112)
    without gathers.

    strict=True pins the two jit-instability sites this stage has
    (PARITY.md D1c): alpha is barriered so XLA cannot re-evaluate its
    exp chain per consumer fusion (re-evaluations were measured 1 ulp
    apart, flipping the final trunc), and the two blend products are
    barriered so ``α·best + (1−α)·blur + 0.5`` cannot FMA-contract —
    eager and jit then agree bit-for-bit.
    """
    h, w, _ = blurred.shape
    radius = ksize // 2
    sigma_alpha = jnp.float32(1.0) / jnp.float32(5 * ksize)

    rtv_p = replicate_pad(rtv, radius, radius, radius, radius)
    blur_p = replicate_pad(blurred, radius, radius, radius, radius)

    best_rtv = jnp.full((h, w), jnp.finfo(jnp.float32).max, jnp.float32)
    best_blur = jnp.zeros((h, w, 3), jnp.float32)
    for dy in range(ksize):
        for dx in range(ksize):
            rv = rtv_p[dy : dy + h, dx : dx + w]
            bv = blur_p[dy : dy + h, dx : dx + w]
            m = rv < best_rtv
            best_rtv = jnp.where(m, rv, best_rtv)
            best_blur = jnp.where(m[:, :, None], bv, best_blur)

    alpha = jnp.float32(2.0) / (jnp.float32(1.0)
            + jnp.exp(sigma_alpha * (rtv - best_rtv))) - jnp.float32(1.0)
    if strict:
        alpha = jax.lax.optimization_barrier(alpha)
        p1, p2 = jax.lax.optimization_barrier(
            (alpha[:, :, None] * best_blur,
             (jnp.float32(1.0) - alpha)[:, :, None] * blurred))
        guide = p1 + p2 + jnp.float32(0.5)
    else:
        guide = (alpha[:, :, None] * best_blur
                 + (jnp.float32(1.0) - alpha)[:, :, None] * blurred
                 + jnp.float32(0.5))
    return jnp.clip(jnp.trunc(guide), 0.0, 255.0)


@functools.partial(jax.jit, static_argnames=("ksize", "nitr", "impl", "variant"))
def _btf_jit(src: jax.Array, ksize: int, nitr: int, impl: str,
             variant: str = "cuda") -> jax.Array:
    jbf_ksize = 2 * ksize - 1
    jbf_sigma_space = float(ksize - 1)
    jbf_sigma_color = float(math.sqrt(3.0))
    # the ONLY difference between the reference's two BTF paths is the final
    # JBF stage's border + rounding: its CUDA path uses the in-repo JBF
    # (replicate pad, u8(x+0.5f) truncation) while the cpp path defers to
    # cv::ximgproc::jointBilateralFilter (reflect-101 pad, cvRound
    # half-to-even) — interior tap math is IDENTICAL (L1 range LUT, same
    # circle-masked spatial Gaussian; probed bit-exact against the compiled
    # oracle, tests/test_reference_oracle.py::test_jbf_cpp_variant)
    border = "reflect101" if variant == "cpp" else "replicate"
    rounding = "rint" if variant == "cpp" else "trunc"

    # strict composition (PARITY.md D1c): a ±1 jit-vs-eager flip in any
    # iteration amplifies through the next iteration's guide/JBF weights to
    # tens of u8, so the guide blend and JBF accumulation run with their
    # rounding sites pinned.  The gradient and blur/rtv stages need nothing:
    # the gradient's products are exact (integer-valued diffs), and
    # blur/rtv contain no mul-feeding-add chains (the divisions are already
    # barrier-opaque).  The Pallas JBF kernel rounds every product and sum
    # separately by construction.
    def iteration(img_u8):
        img_f = img_u8.astype(jnp.float32)
        magnitude = _gradient_math(img_f)
        blurred, rtv = _blur_and_rtv_math(img_f, magnitude, ksize)
        guide = _guide_math(blurred, rtv, ksize, strict=True)
        if impl != "xla":
            from .pallas.bilateral import joint_bilateral_pallas
            return joint_bilateral_pallas(
                img_u8, guide.astype(jnp.uint8), jbf_ksize, jbf_sigma_space,
                jbf_sigma_color, border, rounding,
                interpret=impl == "interpret")
        return _bilateral_math(img_f, guide, jbf_ksize,
                               jbf_sigma_space, jbf_sigma_color,
                               border, rounding, strict=True)

    return jax.lax.fori_loop(0, nitr, lambda _, img: iteration(img), src,
                             unroll=False)


def bilateral_texture_filter(src, ksize: int = 9, nitr: int = 3,
                             impl: str = "auto",
                             variant: str = "cuda") -> jax.Array:
    """(H, W, 3) u8 → (H, W, 3) u8 texture-removed image.

    variant: "cuda" (default) matches the reference's CUDA pipeline
    (src/bilateral_texture_filter_impl.cu:199-214, in-repo JBF); "cpp"
    matches its cpp pipeline (include/cpp/bilateral_texture_filter.hpp:
    153-164, cv::ximgproc::jointBilateralFilter final stage) — ≤1 u8 vs the
    compiled reference cpp path (PARITY.md D1)."""
    src = jnp.asarray(src)
    _validate.check_u8_color("src", src)
    _validate.check_ksize(ksize)
    if nitr < 0:
        raise ValueError(f"nitr must be >= 0, got {nitr}")
    if variant not in ("cuda", "cpp"):
        raise ValueError(f'variant must be "cuda" or "cpp", got {variant!r}')
    return _btf_jit(src, int(ksize), int(nitr), resolve_impl(impl),
                    variant)
