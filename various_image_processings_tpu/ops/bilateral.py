"""Bilateral and joint bilateral filters.

Counterpart of ``bilateral_filter`` / ``joint_bilateral_filter``
(reference: include/cpp/bilateral_filter.hpp:41-207) and the CUDA kernels
(reference: src/bilateral_filter_impl.cu:7-96, :98-202).

Semantics preserved for ±1/255 parity:
- spatial Gaussian zeroed outside the inscribed circle (taps with zero weight
  are skipped entirely — identical sums);
- range weight from the L1 u8 color distance of the guide;
- f32 accumulation in (ky, kx) tap order;
- output ``u8(sum/sumk + 0.5f)`` truncation.

The XLA path unrolls the (non-zero) taps of the stencil into one fused
program over the replicate-padded image; the Pallas path is a Triton GPU
kernel over (TH, TW) output tiles (ops/pallas/bilateral.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.luts import space_kernel, gauss_coeff_f32
from ..core.pad import replicate_pad, reflect101_pad
from . import _validate
from ._dispatch import resolve_impl


def nonzero_taps(ksize: int, sigma_space: float):
    """[(dy, dx, weight_f32)] for taps inside the inscribed circle, in the
    reference's (ky, kx) scan order."""
    space = space_kernel(ksize, sigma_space)
    taps = []
    for dy in range(ksize):
        for dx in range(ksize):
            w = space[dy, dx]
            if w != 0.0:
                taps.append((dy, dx, np.float32(w)))
    return taps


def _pad2d(x: jax.Array, r: int, border: str) -> jax.Array:
    if border == "replicate":
        return replicate_pad(x, r, r, r, r)
    # reflect-101 (cv BORDER_DEFAULT): edge pixel not repeated — what
    # cv::ximgproc::jointBilateralFilter uses (probed bit-exact against the
    # compiled oracle, tests/test_reference_oracle.py::test_jbf_cpp_variant);
    # multi-reflects like cv::borderInterpolate when r exceeds the image
    return reflect101_pad(x, r, 0, 1)


def _bilateral_math(src_f: jax.Array, guide_f: jax.Array, ksize: int,
                    sigma_space: float, sigma_color: float,
                    border: str = "replicate",
                    rounding: str = "trunc",
                    strict: bool = False) -> jax.Array:
    """src_f/guide_f: (H, W, 3) f32 holding u8 values → (H, W, 3) u8.

    border/rounding select between the reference's own JBF semantics
    (replicate pad + ``u8(x + 0.5f)`` truncation) and
    cv::ximgproc::jointBilateralFilter's (reflect-101 pad + cvRound
    half-to-even) — the ONLY two places the reference's cpp and CUDA BTF
    paths actually differ (their interior tap math is identical; probed
    against the compiled oracle).

    strict=True keeps every f32 rounding site separate under jit: XLA CPU
    FMA-contracts ``sums + sp*wk`` inside fused loops (measured: 14% of
    random a*b+c values differ from separate rounds), which moves sums by
    ulps and flips the rint/trunc at near-.5 values — harmless ±1 for a
    standalone filter (the golden envelope), but inside the BTF iteration
    loop a ±1 flip amplifies to tens of u8 (PARITY.md D1c).  Tap products
    are flushed through chunked optimization_barriers so the accumulation
    adds only ever see materialized, separately-rounded products — eager
    and jit then agree bit-for-bit.  Costs extra materialization traffic;
    used by the BTF composition."""
    h, w, _ = src_f.shape
    radius = ksize // 2
    coeff = gauss_coeff_f32(sigma_color)

    src_p = _pad2d(src_f, radius, border)
    guide_p = _pad2d(guide_f, radius, border)
    guide_c = guide_f

    if strict:
        # accumulate (b, g, r, 1)·wk so every tap's exp/wk value has exactly
        # ONE consumer (no fusion duplication can re-evaluate it) and the
        # reference's tap-order sums/sumk accumulation is preserved
        src4_p = jnp.concatenate(
            [src_p, jnp.ones_like(src_p[:, :, :1])], axis=2)
        acc4 = jnp.zeros((h, w, 4), jnp.float32)
        chunk: list = []

        def flush(chunk, acc4):
            prods = jax.lax.optimization_barrier(tuple(chunk))
            for p in prods:
                acc4 = acc4 + p
            return acc4

        for dy, dx, ws in nonzero_taps(ksize, sigma_space):
            sp4 = src4_p[dy : dy + h, dx : dx + w]
            gp = guide_p[dy : dy + h, dx : dx + w]
            dist = jnp.sum(jnp.abs(gp - guide_c), axis=2)  # exact ints
            wk = ws * jnp.exp(dist * dist * coeff)
            chunk.append(sp4 * wk[:, :, None])
            if len(chunk) == 8:
                acc4 = flush(chunk, acc4)
                chunk = []
        if chunk:
            acc4 = flush(chunk, acc4)
        sums, sumk = acc4[:, :, :3], acc4[:, :, 3]
    else:
        sums = jnp.zeros((h, w, 3), jnp.float32)
        sumk = jnp.zeros((h, w), jnp.float32)
        for dy, dx, ws in nonzero_taps(ksize, sigma_space):
            sp = src_p[dy : dy + h, dx : dx + w]
            gp = guide_p[dy : dy + h, dx : dx + w]
            dist = jnp.sum(jnp.abs(gp - guide_c), axis=2)  # exact ints in f32
            wk = ws * jnp.exp(dist * dist * coeff)
            sums = sums + sp * wk[:, :, None]
            sumk = sumk + wk
    out = sums / sumk[:, :, None]
    if rounding == "rint":
        return jnp.rint(out).astype(jnp.uint8)
    return jnp.floor(out + jnp.float32(0.5)).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("ksize", "sigma_space", "sigma_color", "impl"))
def _bf_jit(src: jax.Array, ksize: int, sigma_space: float,
            sigma_color: float, impl: str) -> jax.Array:
    if impl != "xla":
        from .pallas.bilateral import joint_bilateral_pallas
        return joint_bilateral_pallas(src, None, ksize, sigma_space,
                                      sigma_color,
                                      interpret=impl == "interpret")
    src_f = src.astype(jnp.float32)
    return _bilateral_math(src_f, src_f, ksize, sigma_space, sigma_color)


@functools.partial(jax.jit, static_argnames=("ksize", "sigma_space", "sigma_color",
                                              "impl", "border", "rounding"))
def _jbf_jit(src: jax.Array, guide: jax.Array, ksize: int, sigma_space: float,
             sigma_color: float, impl: str, border: str = "replicate",
             rounding: str = "trunc") -> jax.Array:
    if impl != "xla":
        from .pallas.bilateral import joint_bilateral_pallas
        return joint_bilateral_pallas(src, guide, ksize, sigma_space,
                                      sigma_color, border, rounding,
                                      interpret=impl == "interpret")
    return _bilateral_math(src.astype(jnp.float32), guide.astype(jnp.float32),
                           ksize, sigma_space, sigma_color, border, rounding)


def bilateral_filter(src, ksize: int = 9, sigma_space: float = 10.0,
                     sigma_color: float = 30.0, impl: str = "auto") -> jax.Array:
    """(H, W, 3) u8 → (H, W, 3) u8 edge-preserving smoothing."""
    src = jnp.asarray(src)
    _validate.check_u8_color("src", src)
    _validate.check_ksize(ksize)
    return _bf_jit(src, int(ksize), float(sigma_space), float(sigma_color),
                   resolve_impl(impl))


def joint_bilateral_filter(src, guide, ksize: int = 9, sigma_space: float = 10.0,
                           sigma_color: float = 30.0, impl: str = "auto") -> jax.Array:
    """(H, W, 3) u8 src smoothed with range kernel keyed off `guide`."""
    src = jnp.asarray(src)
    guide = jnp.asarray(guide)
    _validate.check_u8_color("src", src)
    _validate.check_u8_color("guide", guide)
    if src.shape != guide.shape:
        raise ValueError(f"src {tuple(src.shape)} and guide {tuple(guide.shape)} "
                         "must have the same shape")
    _validate.check_ksize(ksize)
    return _jbf_jit(src, guide, int(ksize), float(sigma_space), float(sigma_color),
                    resolve_impl(impl))
