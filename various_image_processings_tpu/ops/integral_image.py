"""Border-replicated integral image (summed-area table).

Counterpart of ``BorderReplicatedIntegralImage`` (reference:
include/cpp/border_replicated_integral_image.hpp:7-85).  The two sequential
prefix passes become ``jnp.cumsum`` (XLA lowers these to efficient parallel
scans); integer sources accumulate in int32, floating in float32, matching
the reference's accumulator choice (:18-23).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.pad import replicate_pad


@functools.partial(jax.jit, static_argnames=("radius",))
def integral_image(src: jax.Array, radius: int) -> jax.Array:
    """(H, W[, C]) u8|i32|f32 → (H+2r+1, W+2r+1[, C]) i32|f32 summed-area table.

    Entry [y, x] holds the inclusive sum of the replicate-padded image over
    rows < y, cols < x (row/col 0 are zero), so the window sum over padded
    coords [y0, y1] × [x0, x1] is the standard 4-corner expression.
    """
    src = jnp.asarray(src)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    acc = jnp.float32 if jnp.issubdtype(src.dtype, jnp.floating) else jnp.int32
    padded = replicate_pad(src.astype(acc), radius, radius, radius, radius)
    ii = jnp.cumsum(jnp.cumsum(padded, axis=0, dtype=acc), axis=1, dtype=acc)
    # prepend the zero row/column
    ii = jnp.pad(ii, [(1, 0), (1, 0), (0, 0)])
    return ii[:, :, 0] if squeeze else ii


@functools.partial(jax.jit, static_argnames=("radius", "window_radius"))
def window_sums(src: jax.Array, radius: int, window_radius: int | None = None) -> jax.Array:
    """(H, W[, C]) → (H, W[, C]) inclusive sums of the (2r+1)² window centred
    at each pixel, borders replicate-padded. Counterpart of the per-pixel
    ``integral.get(x-r, y-r, x+r, y+r)`` pattern
    (reference: include/cpp/adaptive_bilateral_filter.hpp:53)."""
    if window_radius is None:
        window_radius = radius
    src = jnp.asarray(src)
    h, w = src.shape[0], src.shape[1]
    ii = integral_image(src, radius)
    r, wr = radius, window_radius
    # centre pixel (y, x) → padded-coord window [y-wr, y+wr] × [x-wr, x+wr]
    y0 = r - wr
    x0 = r - wr
    a = ii[y0 + 2 * wr + 1 : y0 + 2 * wr + 1 + h, x0 + 2 * wr + 1 : x0 + 2 * wr + 1 + w]
    b = ii[y0 + 2 * wr + 1 : y0 + 2 * wr + 1 + h, x0 : x0 + w]
    c = ii[y0 : y0 + h, x0 + 2 * wr + 1 : x0 + 2 * wr + 1 + w]
    d = ii[y0 : y0 + h, x0 : x0 + w]
    return a - b - c + d
