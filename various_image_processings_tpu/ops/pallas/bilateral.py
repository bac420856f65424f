"""Pallas-Triton kernel: bilateral / joint bilateral filter on the GPU.

GPU counterpart of the CUDA kernels ``bilateral_filter_kernel`` /
``joint_bilateral_filter_kernel`` (reference: src/bilateral_filter_impl.cu:7-96,
:98-202), with the same per-pixel arithmetic as the golden twin
(golden/bilateral.py):

- one program per (TH, TW) output tile of the planar, border-padded u8
  image; every tap is a shifted (TH, TW) load straight from device memory
  (L1/L2 serve the halo reuse the reference stages in shared memory);
- the guide stays u8 until it is in registers; the range distance is the
  integer L1 distance of the three channels;
- the range weight is gathered from the reference's 768-entry f32 table
  (core/luts.py), times the spatial weight, rounded once;
- sums are taken in the reference's (ky, kx) tap order: a loop over tap
  rows, and inside it over the row's span of the inscribed circle, so one
  kernel covers every ksize with a program size independent of it;
- every product and sum rounds separately (``mul.rn`` / ``add.rn`` /
  ``div.rn``, which ptxas never contracts into an FMA), so the compiled
  kernel is the bit-exact twin of the golden filter.

In interpret mode (the CPU test suite) the same kernel body runs with plain
jax.numpy arithmetic, which XLA:CPU may contract: ≤1 u8 from golden there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...core.luts import color_table, space_kernel
from ...core.pad import cdiv, reflect101_pad, replicate_pad

# output rows × cols per program (powers of two) and warps per program:
# the fastest of a sweep of 8 tile/warp pairs at 4K k=9 on an H100
TILE = (8, 64)
NUM_WARPS = 4
NUM_STAGES = 1


def _asm(interpret: bool, op: str, *args):
    """f32 ``op.rn`` (or ``cvt.rni``) on same-shape f32 arrays."""
    if interpret:
        x = args[0]
        return {"mul": lambda: x * args[1], "add": lambda: x + args[1],
                "div": lambda: x / args[1], "rint": lambda: jnp.rint(x)}[op]()
    if op == "rint":
        asm, cons = "cvt.rni.f32.f32 $0, $1;", "=f,f"
    else:
        asm, cons = f"{op}.rn.f32 $0, $1, $2;", "=f,f,f"
    return plt.elementwise_inline_asm(
        asm, args=list(args), constraints=cons, pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(args[0].shape,
                                                  jnp.float32)])[0]


def _kernel(ws_ref, span_ref, lut_ref, src_ref, guide_ref, out_ref, *,
            ksize: int, th: int, tw: int, joint: bool, rounding: str,
            interpret: bool):
    r = ksize // 2
    r0 = pl.program_id(0) * th
    c0 = pl.program_id(1) * tw
    op = functools.partial(_asm, interpret)

    def tile(ref, c, dy, dx):
        return ref[c, pl.ds(r0 + dy, th), pl.ds(c0 + dx, tw)]

    gc = [tile(guide_ref, c, r, r).astype(jnp.int32) for c in range(3)]

    def tap(ky, kx, acc):
        g = [tile(guide_ref, c, ky, kx) for c in range(3)]
        gi = [v.astype(jnp.int32) for v in g]
        dist = (jnp.abs(gi[0] - gc[0]) + jnp.abs(gi[1] - gc[1])
                + jnp.abs(gi[2] - gc[2]))
        ws = jnp.broadcast_to(ws_ref[ky * ksize + kx], (th, tw))
        wk = op("mul", lut_ref[dist], ws)
        s = [tile(src_ref, c, ky, kx) for c in range(3)] if joint else g
        sums = [op("add", acc[c], op("mul", s[c].astype(jnp.float32), wk))
                for c in range(3)]
        return (*sums, op("add", acc[3], wk))

    def row(ky, acc):
        return jax.lax.fori_loop(span_ref[2 * ky], span_ref[2 * ky + 1],
                                 functools.partial(tap, ky), acc)

    zero = jnp.zeros((th, tw), jnp.float32)
    acc = jax.lax.fori_loop(0, ksize, row, (zero, zero, zero, zero))
    half = jnp.full((th, tw), 0.5, jnp.float32)
    for c in range(3):
        q = op("div", acc[c], acc[3])
        q = op("rint", q) if rounding == "rint" else jnp.floor(op("add", q, half))
        out_ref[c, pl.ds(r0, th), pl.ds(c0, tw)] = (
            q.astype(jnp.int32).astype(jnp.uint8))


def _tap_tables(ksize: int, sigma_space: float):
    """(flat (k·k,) f32 spatial weights, (2k,) i32 [lo, hi) column span of
    each tap row's non-zero weights).  The circle mask makes every row's
    non-zero weights contiguous; zero weights inside a span (underflow at
    tiny σ_space) add exact zeros."""
    space = space_kernel(ksize, sigma_space)
    span = np.zeros((ksize, 2), np.int32)
    for ky in range(ksize):
        nz = np.nonzero(space[ky])[0]
        span[ky] = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
    return space.reshape(-1), span.reshape(-1)


def _planar_padded(img: jax.Array, r: int, rows: int, cols: int,
                   border: str) -> jax.Array:
    """(H, W, 3) u8 → (3, rows, cols) u8: ``border`` halo of r on every side
    (replicate, or reflect-101 for the cv::ximgproc variant), then replicate
    padding on the bottom/right up to whole tiles (it only feeds outputs
    that are cropped)."""
    h, w, _ = img.shape
    if border == "reflect101" and r > 0:
        img = reflect101_pad(img, r, 0, 1)
        img = replicate_pad(img, 0, rows - img.shape[0], 0, cols - img.shape[1])
    else:
        img = replicate_pad(img, r, rows - r - h, r, cols - r - w)
    return img.transpose(2, 0, 1)


@functools.partial(jax.jit, static_argnames=(
    "ksize", "sigma_space", "sigma_color", "border", "rounding", "interpret"))
def joint_bilateral_pallas(src: jax.Array, guide: jax.Array | None,
                           ksize: int, sigma_space: float, sigma_color: float,
                           border: str = "replicate", rounding: str = "trunc",
                           *, interpret: bool) -> jax.Array:
    """(H, W, 3) u8 src (+ u8 guide, or None for the self-guided filter) →
    (H, W, 3) u8.  border/rounding select the reference-JBF vs
    cv::ximgproc::jointBilateralFilter semantics (see
    ops/bilateral.py::_bilateral_math)."""
    h, w, _ = src.shape
    th, tw = TILE
    r = ksize // 2
    nh, nw = cdiv(h, th), cdiv(w, tw)
    rows, cols = nh * th + 2 * r, nw * tw + 2 * r
    ws, span = _tap_tables(ksize, sigma_space)
    lut = color_table(sigma_color)
    src_p = _planar_padded(src, r, rows, cols, border)
    joint = guide is not None
    guide_p = _planar_padded(guide, r, rows, cols, border) if joint else src_p
    kernel = functools.partial(_kernel, ksize=ksize, th=th, tw=tw,
                               joint=joint, rounding=rounding,
                               interpret=interpret)
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        kernel,
        grid=(nh, nw),
        in_specs=[anywhere] * 5,
        out_specs=anywhere,
        out_shape=jax.ShapeDtypeStruct((3, nh * th, nw * tw), jnp.uint8),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="bilateral_tile",
    )(jnp.asarray(ws), jnp.asarray(span), jnp.asarray(lut), src_p, guide_p)
    return out[:, :h, :w].transpose(1, 2, 0)
