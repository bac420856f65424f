"""Padding / alignment helpers shared by the XLA and Pallas paths.

The reference clamps window coordinates to the image rect everywhere
(``std::clamp(x + kx, 0, width - 1)``, e.g. include/cpp/bilateral_filter.hpp:89-90),
which is exactly replicate ("edge") padding.  On the device we pre-pad once
and turn every clamped gather into a static slice, which XLA fuses.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def replicate_pad_np(img: np.ndarray, radius: int) -> np.ndarray:
    """Edge-pad the two leading spatial dims of an HW[C] numpy array."""
    pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def reflect101_indices(n: int, lo: int, hi: int) -> np.ndarray:
    """Source-index map for cv::BORDER_REFLECT_101 padding: ``lo`` elements
    before and ``hi`` after an n-element axis, with OpenCV's multi-reflection
    semantics (borderInterpolate folds repeatedly, so any pad width works —
    jnp.pad(mode="reflect") raises for pad > n-1).  n == 1 maps everything
    to 0, like borderInterpolate."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    j = np.mod(idx, period)
    return np.where(j >= n, period - j, j)


def reflect101_pad(img, r: int, row_axis: int = 0, col_axis: int = 1):
    """Reflect-101 pad the given two axes of a jax array by r, valid for ANY
    r (multi-reflection).  Decided PER AXIS: jnp.pad when r fits that axis
    (r <= n-1, the common case); a static index gather only on an axis the
    pad cannot cover — so an extreme aspect ratio pays the gather on one
    axis, not both."""
    import jax.numpy as jnp

    if r == 0:
        return img

    def pad_one(x, axis):
        n = x.shape[axis]
        if r <= n - 1:
            pads = [(0, 0)] * x.ndim
            pads[axis] = (r, r)
            return jnp.pad(x, pads, mode="reflect")
        return jnp.take(x, jnp.asarray(reflect101_indices(n, r, r)),
                        axis=axis)

    return pad_one(pad_one(img, row_axis), col_axis)


def replicate_pad(img, pad_top: int, pad_bottom: int, pad_left: int,
                  pad_right: int, axis: int = 0):
    """Edge-pad two adjacent spatial dims (``axis``, ``axis+1``) of a jax
    array — axis=0 for HW[C] layouts, axis=1 for planar CHW.

    Implemented with concatenations of edge slices (jnp.pad(mode='edge')
    also works; this form keeps the trace tiny for large radii).
    """
    import jax.numpy as jnp

    def pad_axis(x, ax, before, after):
        if not (before or after):
            return x
        idx0 = (slice(None),) * ax + (slice(0, 1),)
        idx1 = (slice(None),) * ax + (slice(-1, None),)
        parts = []
        if before:
            shape = x.shape[:ax] + (before,) + x.shape[ax + 1:]
            parts.append(jnp.broadcast_to(x[idx0], shape))
        parts.append(x)
        if after:
            shape = x.shape[:ax] + (after,) + x.shape[ax + 1:]
            parts.append(jnp.broadcast_to(x[idx1], shape))
        return jnp.concatenate(parts, axis=ax)

    img = pad_axis(img, axis, pad_top, pad_bottom)
    return pad_axis(img, axis + 1, pad_left, pad_right)
