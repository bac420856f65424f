"""Sobel-style gradient magnitude.

Counterpart of ``gradient`` (reference: include/cpp/gradient.hpp:89)
and ``cuda_gradient`` (reference: include/cuda/gradient.hpp:13): clamped
central differences (one-sided forms at the borders are exactly central
differences on a replicate-padded image), squared-summed over channels,
sqrt → (H, W) f32.

Supports u8 / f32 × 1 / 3 channels, matching the reference's dispatch
(include/cpp/gradient.hpp:93-104).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ._dispatch import resolve_impl


def _gradient_math(s: jax.Array) -> jax.Array:
    """s: (H, W, C) f32 → (H, W) f32."""
    up = jnp.concatenate([s[:1], s[:-1]], axis=0)
    down = jnp.concatenate([s[1:], s[-1:]], axis=0)
    left = jnp.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = jnp.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    vdiff = down - up
    hdiff = right - left
    total = jnp.sum(hdiff * hdiff + vdiff * vdiff, axis=2)
    return jnp.sqrt(total)


@jax.jit
def _gradient_jit(src: jax.Array) -> jax.Array:
    s = src if src.ndim == 3 else src[:, :, None]
    return _gradient_math(s.astype(jnp.float32))


def gradient(src, impl: str = "auto") -> jax.Array:
    """(H, W) or (H, W, C) u8|f32 → (H, W) f32 gradient magnitude."""
    src = jnp.asarray(src)
    if src.dtype not in (jnp.uint8, jnp.float32):
        raise TypeError(f"gradient supports u8/f32, got {src.dtype}")
    resolve_impl(impl, has_kernel=False)
    return _gradient_jit(src)
