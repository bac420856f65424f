"""Gaussian pyramid ops (pyrDown / pyrUp).

Equivalents of the cv::pyrDown / cv::pyrUp calls the reference's
inpainting pyramid uses (include/cpp/wexler_inpainting.hpp:68-91, :52-57).

The u8 path is a BIT-EXACT twin of OpenCV's fixed-point u8 pyramid
(established by fuzzing against cv2 across shapes, channel counts, and odd
dst sizes — tests/test_pyramid.py asserts equality):

- ``pyrDown``: integer 5-tap binomial conv [1 4 6 4 1] in both axes at the
  even sample grid, BORDER_REFLECT_101 on the SOURCE indices, final
  descale ``(acc + 128) >> 8``.  All intermediates ≤ 255·256 — exact in
  int32.
- ``pyrUp``: zero-stuffed conv by the same kernel, but the reflection runs
  in the UPSAMPLED (2H, 2W) index domain and the result is cropped to the
  requested dst size; final descale ``(acc + 32) >> 6``.  In source-row
  terms that reflection is: row −1 → row 1, row H → row **H−1** (NOT the
  source-domain reflect-101's H−2) — the border quirk that kept the old
  float path at ≤1 u8 instead of exact.

Both are implemented as strided slices + concats (no gathers), so they
compile to cheap fused programs; float inputs take a separable f32 path
with the same taps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_K5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], jnp.float32) / 16.0
_K5I = (1, 4, 6, 4, 1)


def _sep_blur(img_f: jax.Array, kernel: jax.Array) -> jax.Array:
    """(H, W, C) f32 separable blur with BORDER_REFLECT_101."""
    r = (kernel.shape[0] - 1) // 2
    p = jnp.pad(img_f, [(r, r), (0, 0), (0, 0)], mode="reflect")
    out = jnp.zeros_like(img_f)
    h = img_f.shape[0]
    for i in range(kernel.shape[0]):
        out = out + kernel[i] * p[i : i + h]
    p = jnp.pad(out, [(0, 0), (r, r), (0, 0)], mode="reflect")
    out = jnp.zeros_like(img_f)
    w = img_f.shape[1]
    for i in range(kernel.shape[0]):
        out = out + kernel[i] * p[:, i : i + w]
    return out


@jax.jit
def _pyr_down_f(img_f: jax.Array) -> jax.Array:
    return _sep_blur(img_f, _K5)[::2, ::2]


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def _pyr_up_f(img_f: jax.Array, out_h: int, out_w: int) -> jax.Array:
    h, w, c = img_f.shape
    up = jnp.zeros((2 * h, 2 * w, c), img_f.dtype)
    up = up.at[::2, ::2].set(img_f)
    up = _sep_blur(up, _K5 * 2.0)
    # odd-larger dst: same duplicated trailing lines as the u8 path
    # (row 2h−2 / col 2w−1 — see _up_axis); verified vs cv2's float path
    row = up[2 * h - 2 : 2 * h - 1] if out_h == 2 * h + 1 else None
    up = jnp.concatenate([up, row], 0) if row is not None else up[:out_h]
    col = up[:, 2 * w - 1 : 2 * w] if out_w == 2 * w + 1 else None
    return jnp.concatenate([up, col], 1) if col is not None else up[:, :out_w]


@jax.jit
def _pyr_down_u8(img: jax.Array) -> jax.Array:
    """(H, W, C) u8 → ((H+1)//2, (W+1)//2, C) u8, bit-exact cv::pyrDown.

    Planar (C, H, W) compute, one plane per channel."""
    h, w, _ = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    s = img.astype(jnp.int32).transpose(2, 0, 1)       # (C, H, W)
    # BORDER_REFLECT_101 pad by 2 each side, built from slices (exact for
    # h,w ≥ 3 — caller guarantees; OpenCV requires ≥ 2 and reflect-101 of
    # a 2-row image degenerates the same way jnp's 'reflect' does)
    s = jnp.concatenate(
        [s[:, 2:0:-1], s, s[:, h - 2 : h - 4 if h >= 4 else None : -1]], 1)
    s = jnp.concatenate(
        [s[:, :, 2:0:-1], s, s[:, :, w - 2 : w - 4 if w >= 4 else None : -1]], 2)
    vert = sum(kv * s[:, i : i + 2 * oh - 1 : 2] for i, kv in enumerate(_K5I))
    acc = sum(kv * vert[:, :, j : j + 2 * ow - 1 : 2]
              for j, kv in enumerate(_K5I))
    return ((acc + 128) >> 8).astype(jnp.uint8).transpose(1, 2, 0)


def _up_axis(s: jax.Array, axis: int, n: int, out_n: int) -> jax.Array:
    """One pyrUp axis in exact int32 along ``axis``: n → out_n ≤ 2n+1.

    even rows 2t  = s[t−1] + 6·s[t] + s[t+1]   (t−1 → |t−1|, t = n → n−1)
    odd rows 2t+1 = 4·(s[t] + s[t+1])
    (the 2n-domain reflection — see module docstring).

    cv::pyrUp also allows the odd-LARGER dst size 2n+1; its extra trailing
    line duplicates line 2n−2 on the first (vertical) axis but line 2n−1
    on the second (horizontal) axis — an asymmetry of OpenCV's separable
    row-then-column implementation, established by fuzzing vs cv2 across
    shapes and every legal odd/even dst combination."""
    def sl(a, lo, hi):
        return jax.lax.slice_in_dim(a, lo, hi, axis=axis)

    top = sl(s, min(1, n - 1), min(1, n - 1) + 1)
    bot = sl(s, n - 1, n)
    ext = jnp.concatenate([top, s, bot], axis)  # ext[u+1] = s[reflected u]
    even = sl(ext, 0, n) + 6 * sl(ext, 1, n + 1) + sl(ext, 2, n + 2)
    odd = 4 * (sl(ext, 1, n + 1) + sl(ext, 2, n + 2))
    inter = jnp.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] = 2 * n
    inter = inter.reshape(shape)
    if out_n == 2 * n + 1:
        dup = 2 * n - 2 if axis == 1 else 2 * n - 1
        return jnp.concatenate([inter, sl(inter, dup, dup + 1)], axis)
    return sl(inter, 0, out_n)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def _pyr_up_u8(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """(H, W, C) u8 → (out_h, out_w, C) u8, bit-exact cv::pyrUp(dstsize).
    Planar compute (see _pyr_down_u8)."""
    h, w, _ = img.shape
    s = img.astype(jnp.int32).transpose(2, 0, 1)       # (C, H, W)
    v = _up_axis(s, 1, h, out_h)
    acc = _up_axis(v, 2, w, out_w)
    return ((acc + 32) >> 6).astype(jnp.uint8).transpose(1, 2, 0)


def pyr_down(img) -> jax.Array:
    """(H, W[, C]) u8|f32 → (ceil(H/2), ceil(W/2)[, C]) same dtype.

    Matches cv::pyrDown's default output size ((H+1)/2, (W+1)/2); u8 is
    bit-exact vs OpenCV's fixed-point path."""
    img = jnp.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    if img.dtype == jnp.uint8 and min(img.shape[:2]) >= 3:
        out = _pyr_down_u8(img)
    else:
        out = _pyr_down_f(img.astype(jnp.float32))
        if img.dtype == jnp.uint8:
            out = jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)
        else:
            out = out.astype(img.dtype)
    return out[:, :, 0] if squeeze else out


def pyr_up(img, out_shape=None) -> jax.Array:
    """(H, W[, C]) → (2H, 2W[, C]) (or `out_shape`), cv::pyrUp semantics;
    u8 is bit-exact vs OpenCV's fixed-point path incl. odd dst sizes."""
    img = jnp.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, _ = img.shape
    out_h, out_w = out_shape if out_shape is not None else (2 * h, 2 * w)
    if out_h > 2 * h + 1 or out_w > 2 * w + 1:
        raise ValueError(
            f"pyr_up dst ({out_h}, {out_w}) exceeds (2H+1, 2W+1) for "
            f"source ({h}, {w}) — beyond cv::pyrUp's legal range")
    if img.dtype == jnp.uint8:
        out = _pyr_up_u8(img, out_h, out_w)
    else:
        out = _pyr_up_f(img.astype(jnp.float32), out_h, out_w).astype(img.dtype)
    return out[:, :, 0] if squeeze else out
