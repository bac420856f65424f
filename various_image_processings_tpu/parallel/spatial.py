"""Spatial sharding with halo exchange between devices.

For single images too large for one device, rows shard across the mesh's
spatial axis and each stencil pulls its halo rows from the ring neighbours
via ``jax.lax.ppermute`` — the reference's shared-memory halo tiles, lifted
from intra-device to inter-device (SURVEY.md §5 "long-context" equivalence).

Global-boundary devices replicate their own edge rows, preserving the
reference's BORDER_REPLICATE semantics exactly, so the sharded result is
bit-identical to the single-device op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import SPATIAL_AXIS


def halo_exchange_rows(block: jax.Array, radius: int, axis_name: str,
                       num_devices: int) -> jax.Array:
    """(Hl, W, C) local rows → (Hl + 2r, W, C) with halo rows from ring
    neighbours; edge devices replicate their own boundary rows."""
    if num_devices == 1:
        top = jnp.broadcast_to(block[:1], (radius,) + block.shape[1:])
        bot = jnp.broadcast_to(block[-1:], (radius,) + block.shape[1:])
        return jnp.concatenate([top, block, bot], axis=0)

    idx = jax.lax.axis_index(axis_name)
    down = [(i, (i + 1) % num_devices) for i in range(num_devices)]
    up = [(i, (i - 1) % num_devices) for i in range(num_devices)]
    # my bottom rows → next device's top halo; my top rows → prev's bottom halo
    from_prev = jax.lax.ppermute(block[-radius:], axis_name, down)
    from_next = jax.lax.ppermute(block[:radius], axis_name, up)
    top_rep = jnp.broadcast_to(block[:1], (radius,) + block.shape[1:])
    bot_rep = jnp.broadcast_to(block[-1:], (radius,) + block.shape[1:])
    top = jnp.where(idx == 0, top_rep, from_prev)
    bot = jnp.where(idx == num_devices - 1, bot_rep, from_next)
    return jnp.concatenate([top, block, bot], axis=0)


def _make_stencil_runner(fn_full, radius: int, mesh: Mesh, in_ndims,
                         out_ndim: int):
    """jit(shard_map(...)) runner for a row-sharded stencil op.  The
    shard_map sits INSIDE the jit: eager shard_map runs its body op by op,
    one dispatch each."""
    d = mesh.shape[SPATIAL_AXIS]
    in_specs = tuple(P(SPATIAL_AXIS, *([None] * (nd - 1))) for nd in in_ndims)
    out_spec = P(SPATIAL_AXIS, *([None] * (out_ndim - 1)))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_spec, check_vma=False)
    def run(local, *local_extras):
        padded = halo_exchange_rows(local, radius, SPATIAL_AXIS, d)
        padded_extras = [halo_exchange_rows(e, radius, SPATIAL_AXIS, d)
                         for e in local_extras]
        out = fn_full(padded, *padded_extras)
        return out[radius : radius + local.shape[0]]

    return run


@functools.lru_cache(maxsize=128)
def _cached_stencil_runner(op: str, params: tuple, impl: str, mesh: Mesh,
                           radius: int, in_ndims: tuple, out_ndim: int):
    """One jitted runner per (op, params, impl, mesh, ranks) — re-creating
    the shard_map closure per call would retrace every invocation."""
    if op == "bf":
        from ..ops.bilateral import _bf_jit
        fn = lambda blk: _bf_jit(blk, *params, impl)
    elif op == "jbf":
        from ..ops.bilateral import _jbf_jit
        fn = lambda blk, gd: _jbf_jit(blk, gd, *params, impl)
    elif op == "abf":
        from ..ops.adaptive_bilateral import _abf_jit
        fn = lambda blk: _abf_jit(blk, *params)
    elif op == "gradient":
        from ..ops.gradient import _gradient_jit
        fn = _gradient_jit
    else:
        raise ValueError(op)
    return _make_stencil_runner(fn, radius, mesh, in_ndims, out_ndim)


def _check_shardable(h: int, radius: int, mesh: Mesh):
    d = mesh.shape[SPATIAL_AXIS]
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    if h // d < radius:
        raise ValueError(f"shard height {h // d} smaller than halo {radius}")


def stencil_apply_sharded(fn_full, image, radius: int, mesh: Mesh,
                          out_ndim: int | None = None, extras=()):
    """Run a replicate-padded stencil op on a row-sharded image.

    fn_full: the single-device op ((H', W, C) → output with leading row dim,
    computing with its own internal replicate padding).  Each device receives
    its rows plus exchanged halos, runs fn_full on the extended block, and
    crops the halo back off — exact for any op whose output pixel depends
    only on the (2r+1)² input window.  out_ndim: rank of fn_full's output
    (defaults to the image's rank).  extras: additional row-aligned arrays
    (e.g. a guide image) sharded and halo-exchanged the same way, passed to
    fn_full after the image.

    The runner is memoized on (fn_full, mesh, radius, ranks) — like the
    per-op wrappers below — so repeated calls with a STABLE fn_full reuse
    one compiled program; a fresh lambda per call still retraces (its
    identity is the cache key).
    """
    _check_shardable(image.shape[0], radius, mesh)
    in_ndims = (image.ndim,) + tuple(e.ndim for e in extras)
    run = _cached_generic_stencil_runner(fn_full, radius, mesh, in_ndims,
                                         out_ndim or image.ndim)
    return run(image, *extras)


@functools.lru_cache(maxsize=64)
def _cached_generic_stencil_runner(fn_full, radius: int, mesh: Mesh,
                                   in_ndims: tuple, out_ndim: int):
    return _make_stencil_runner(fn_full, radius, mesh, in_ndims, out_ndim)


def _default_mesh(mesh):
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh(batch=1, spatial=len(jax.devices()))
    return mesh


def bilateral_filter_sharded(image, ksize: int = 9, sigma_space: float = 10.0,
                             sigma_color: float = 30.0, mesh: Mesh | None = None,
                             impl: str = "auto"):
    """(H, W, 3) u8 → (H, W, 3) u8, rows sharded over the mesh's spatial
    axis with ppermute halo exchange. Bit-identical to the single-device op."""
    from ..ops._dispatch import resolve_impl
    mesh = _default_mesh(mesh)
    impl = resolve_impl(impl)
    radius = ksize // 2
    _check_shardable(image.shape[0], radius, mesh)
    run = _cached_stencil_runner(
        "bf", (int(ksize), float(sigma_space), float(sigma_color)), impl,
        mesh, radius, (image.ndim,), image.ndim)
    return run(image)


def joint_bilateral_filter_sharded(image, guide, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """Row-sharded joint bilateral filter: image and guide shard together,
    both halo-exchanged. Bit-identical to the single-device op."""
    from ..ops._dispatch import resolve_impl
    mesh = _default_mesh(mesh)
    impl = resolve_impl(impl)
    if image.shape[:2] != guide.shape[:2]:
        raise ValueError("image and guide sizes differ")
    radius = ksize // 2
    _check_shardable(image.shape[0], radius, mesh)
    run = _cached_stencil_runner(
        "jbf", (int(ksize), float(sigma_space), float(sigma_color)), impl,
        mesh, radius, (image.ndim, guide.ndim), image.ndim)
    return run(image, guide)


def adaptive_bilateral_filter_sharded(image, ksize: int = 9,
                                      sigma_space: float = 10.0,
                                      sigma_color: float = 30.0,
                                      mesh: Mesh | None = None,
                                      impl: str = "auto"):
    """Row-sharded adaptive bilateral filter (halo = radius: both the box
    mean and the range window span the same (2r+1)² neighbourhood)."""
    from ..ops._dispatch import resolve_impl
    mesh = _default_mesh(mesh)
    impl = resolve_impl(impl, has_kernel=False)
    radius = ksize // 2
    _check_shardable(image.shape[0], radius, mesh)
    run = _cached_stencil_runner(
        "abf", (int(ksize), float(sigma_space), float(sigma_color)), impl,
        mesh, radius, (image.ndim,), image.ndim)
    return run(image)


def gradient_sharded(image, mesh: Mesh | None = None, impl: str = "auto"):
    """Row-sharded gradient magnitude (halo = 1)."""
    from ..ops._dispatch import resolve_impl
    mesh = _default_mesh(mesh)
    impl = resolve_impl(impl, has_kernel=False)
    _check_shardable(image.shape[0], 1, mesh)
    run = _cached_stencil_runner("gradient", (), impl, mesh, 1,
                                 (image.ndim,), 2)
    return run(image)


@functools.lru_cache(maxsize=64)
def _cached_btf_sharded_runner(ksize: int, nitr: int, impl: str, mesh: Mesh):
    import math

    d = mesh.shape[SPATIAL_AXIS]
    radius = ksize // 2
    jbf_ksize = 2 * ksize - 1
    jbf_radius = jbf_ksize // 2
    jbf_sigma_space = float(ksize - 1)
    jbf_sigma_color = float(math.sqrt(3.0))
    spec = P(SPATIAL_AXIS, None, None)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=spec, check_vma=False)
    def run(local):
        hl = local.shape[0]

        def stage(fn, r, *arrays):
            ext = [halo_exchange_rows(a, r, SPATIAL_AXIS, d) for a in arrays]
            out = fn(*ext)
            return jax.tree_util.tree_map(lambda o: o[r : r + hl], out)

        from ..ops.bilateral import _bilateral_math
        from ..ops.bilateral_texture import _blur_and_rtv_math, _guide_math
        from ..ops.gradient import _gradient_math

        def jbf(img_u8, guide):
            if impl != "xla":
                from ..ops.pallas.bilateral import joint_bilateral_pallas
                return joint_bilateral_pallas(
                    img_u8, guide.astype(jnp.uint8), jbf_ksize,
                    jbf_sigma_space, jbf_sigma_color,
                    interpret=impl == "interpret")
            return _bilateral_math(img_u8.astype(jnp.float32), guide,
                                   jbf_ksize, jbf_sigma_space,
                                   jbf_sigma_color)

        def iteration(_, img_u8):
            img_f = img_u8.astype(jnp.float32)
            magnitude = stage(_gradient_math, 1, img_f)
            blurred, rtv = stage(
                lambda i, m: _blur_and_rtv_math(i, m, ksize), radius,
                img_f, magnitude)
            guide = stage(lambda b, r_: _guide_math(b, r_, ksize), radius,
                          blurred, rtv)
            return stage(jbf, jbf_radius, img_u8, guide)

        return jax.lax.fori_loop(0, nitr, iteration, local, unroll=False)

    return run


def bilateral_texture_filter_sharded(image, ksize: int = 9, nitr: int = 3,
                                     mesh: Mesh | None = None,
                                     impl: str = "auto"):
    """Row-sharded bilateral texture filter, bit-identical everywhere.

    A multi-stage pipeline does not commute with one-shot pre-padding (stage
    2 of a replicate-padded input ≠ replicate-padding stage 2's output), so
    instead of pre-padding the whole nitr pipeline this exchanges halos
    PER STAGE inside one shard_map body: gradient (halo 1), blur+mRTV (r),
    guide (r), joint bilateral (k−1), each on the freshly exchanged rows.
    ``halo_exchange_rows`` replicates the current stage's own edge rows at
    the global top/bottom — exactly the single-device op's per-stage
    clamping — so every row, including the global boundary bands, matches
    the single-device op bit-for-bit (same stage kernels, same per-pixel
    windows).

    ``impl`` selects the JBF stage exactly like the single-device op (the
    Triton kernel on a GPU, XLA elsewhere); the other stages are XLA.
    """
    from ..ops._dispatch import resolve_impl

    mesh = _default_mesh(mesh)
    impl = resolve_impl(impl)
    d = mesh.shape[SPATIAL_AXIS]
    radius = ksize // 2
    jbf_radius = (2 * ksize - 1) // 2
    h = image.shape[0]
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    if h // d < max(1, radius, jbf_radius):
        raise ValueError(
            f"shard height {h // d} smaller than the widest stage halo "
            f"{max(1, radius, jbf_radius)}")
    return _cached_btf_sharded_runner(int(ksize), int(nitr), impl, mesh)(image)
