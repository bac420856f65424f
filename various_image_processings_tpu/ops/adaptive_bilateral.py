"""Adaptive bilateral filter (Zhang–Allebach style).

Counterpart of ``adaptive_bilateral_filter`` (reference:
include/cpp/adaptive_bilateral_filter.hpp:13-104) and the CUDA kernel
(reference: src/adaptive_bilateral_filter_impl.cu:7-152).

Per-pixel offset = center − box-mean of the window; range distance =
``| (src − center) − offset |`` summed L1, truncated to int before the range
Gaussian (the truncation is replicated with ``floor`` — required for ±1
parity).  The box sums come from the border-replicated integral image (like
the CPU reference).  XLA only: there is no kernel for this op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.luts import gauss_coeff_f32
from ..core.pad import replicate_pad
from . import _validate
from ._dispatch import resolve_impl
from .bilateral import nonzero_taps
from .integral_image import window_sums


def _abf_math(src_u8: jax.Array, ksize: int, sigma_space: float,
              sigma_color: float) -> jax.Array:
    h, w, _ = src_u8.shape
    radius = ksize // 2
    coeff = gauss_coeff_f32(sigma_color)

    src_f = src_u8.astype(jnp.float32)
    src_i = src_u8.astype(jnp.int32)
    box = window_sums(src_i, radius)  # exact int32 window sums

    # The C++ range index is int(Σ_ch |(p−c) − (c − box/k²)|) with f32
    # rounding at every step (:41-45).  We replicate that f32 sequence
    # EXACTLY on IEEE-divider hosts: every input is an exact-in-f32
    # integer, sub/add are IEEE correctly rounded on every XLA backend,
    # the 3-term L1 sum is added in the C++ order, and the one risky op —
    # the box/k² division — is exhaustively verified correctly-rounded for
    # every reachable (box, k) pair on XLA-CPU
    # (tests/test_bilateral.py::test_abf_box_mean_division_exhaustive).  A
    # previous revision computed the index in exact integer arithmetic
    # instead; at small σ_color the Gaussian is steep enough that its
    # boundary flips (f32 sequence a few ulp below an integer the exact
    # value reaches) changed single weights ~4×, shifting pixels by tens of
    # u8 (round-4 fuzz).  Bit-equal index ⇒ those flips are gone.
    # optimization_barrier keeps k² opaque: XLA strength-reduces division by
    # a LITERAL constant into reciprocal-multiply (NOT correctly rounded —
    # measured: fl(598/9) off by 1 ulp on XLA-CPU), while division by a
    # runtime value is a true IEEE-RN divide.
    k2f = jax.lax.optimization_barrier(jnp.float32(ksize * ksize))
    offset = src_f - box.astype(jnp.float32) / k2f  # (H, W, 3), C++ :54-56

    src_p_f = replicate_pad(src_f, radius, radius, radius, radius)
    src_p_i = replicate_pad(src_i, radius, radius, radius, radius)

    # Subnormal-band twin (D2b, PARITY.md).  The reference's weight is
    # DOUBLE-rounded f32: the f64 exp first rounds to the stored table
    # entry — which fades through the f32 SUBNORMAL range (1..23
    # significant bits) before exact 0 — and the ws·table[idx] product
    # then rounds AGAIN (include/cpp/adaptive_bilateral_filter.hpp:34-38,
    # :68).  ABF's center-tap distance is the box-mean offset (unbounded),
    # so with small σ_color entire windows land in that band; replicating
    # the ratio there needs both roundings (a fused full-precision
    # ws·exp(d²c) is ~½ quantum off either one — tens of u8 when every
    # surviving weight is 1-2 quanta, round-4 fuzz).  Everything is scaled
    # by 2⁶⁴ (exact; the sums/sumk ratio is invariant under a power-of-two
    # scale) so the band sits in normal range: the table's subnormal band
    # is then e < 2⁻⁶² on the grid 2⁻⁸⁵, and the add-subtract trick with
    # C = 2²³·grid = 2⁻⁶² rounds to that grid below C (ties-to-even, 0
    # below half a quantum — the same flush boundary as the reference),
    # identity above.  The ws multiply is IEEE-RN in-register, and the
    # same trick replicates the product's subnormal rounding.  Where the
    # whole window flushes, the reference divides 0/0 and its NaN casts
    # to u8 0 (x86 cvttss2si → 0x80000000); the final select replicates
    # that pixel exactly.
    lg_coeff = jnp.float32(float(coeff) * np.log2(np.e))
    off0, off1, off2 = offset[..., 0], offset[..., 1], offset[..., 2]
    # barrier: XLA's algebraic simplifier folds (v + C) − C → v for literal
    # C (measured), which would silently delete the grid rounding
    subn_c, subn_c128 = jax.lax.optimization_barrier(
        (jnp.float32(2.0 ** -62), jnp.float32(4.0)))
    bias = jnp.float32(64.0)
    sums = jnp.zeros((h, w, 3), jnp.float32)
    sumk = jnp.zeros((h, w), jnp.float32)
    for dy, dx, ws in nonzero_taps(ksize, sigma_space):
        sp_f = src_p_f[dy : dy + h, dx : dx + w]
        sp_i = src_p_i[dy : dy + h, dx : dx + w]
        dp = (sp_i - src_i).astype(jnp.float32)  # exact: |Δ| ≤ 255
        # the C++ adds |d0|+|d1|+|d2| left to right (:44) — keep that order
        dist = (jnp.abs(dp[..., 0] - off0) + jnp.abs(dp[..., 1] - off1)
                ) + jnp.abs(dp[..., 2] - off2)
        d = jnp.floor(dist)  # static_cast<int>, dist ≥ 0 (:45)
        e = jnp.exp2(d * d * lg_coeff + bias)  # table entry · 2⁶⁴
        e = (e + subn_c) - subn_c              # table-store rounding
        if ws >= 2.0 ** -126:
            wk = jnp.float32(ws) * e           # ws·table[idx], IEEE-RN
            wk = (wk + subn_c) - subn_c        # product rounding
        else:
            # subnormal space weight (tiny σ_space): XLA flushes
            # subnormal OPERANDS (DAZ, measured on XLA-CPU), so ride a
            # 2¹²⁸ bias for this tap: ws·2⁶⁴ is exact and normal, the
            # grid is then 2⁻¹⁴⁹·2¹²⁸ = 2⁻²¹ (C = 2²³·grid = 4.0; the
            # product of a subnormal ws is ALWAYS on the subnormal grid),
            # and the 2⁻⁶⁴ rescale back to the accumulator bias is exact.
            wk = jnp.float32(float(ws) * 2.0 ** 64) * e
            wk = (wk + subn_c128) - subn_c128
            wk = wk * jnp.float32(2.0 ** -64)
        sums = sums + sp_f * wk[:, :, None]
        sumk = sumk + wk
    out = jnp.floor(sums / sumk[:, :, None] + jnp.float32(0.5))
    return jnp.where(sumk[:, :, None] == 0, jnp.float32(0.0),
                     out).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("ksize", "sigma_space", "sigma_color"))
def _abf_jit(src: jax.Array, ksize: int, sigma_space: float,
             sigma_color: float) -> jax.Array:
    return _abf_math(src, ksize, sigma_space, sigma_color)


def adaptive_bilateral_filter(src, ksize: int = 9, sigma_space: float = 10.0,
                              sigma_color: float = 30.0, impl: str = "auto") -> jax.Array:
    """(H, W, 3) u8 → (H, W, 3) u8."""
    src = jnp.asarray(src)
    _validate.check_u8_color("src", src)
    _validate.check_ksize(ksize)
    resolve_impl(impl, has_kernel=False)
    return _abf_jit(src, int(ksize), float(sigma_space), float(sigma_color))
