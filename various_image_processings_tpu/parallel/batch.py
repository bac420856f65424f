"""Batch fan-out over the device mesh.

The replacement for the reference's "one image per process" model: a batch
of images is sharded over the mesh's batch axis via shard_map, each device
runs the single-image op locally, results gather back.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import BATCH_AXIS


@functools.lru_cache(maxsize=64)
def _cached_generic_runner(fn, mesh: Mesh, ndim: int):
    import jax.numpy as jnp

    spec = P(BATCH_AXIS, *([None] * (ndim - 1)))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=P(BATCH_AXIS), check_vma=False)
    def run(local):
        return jnp.stack([fn(local[i]) for i in range(local.shape[0])])

    return run


# fresh-callable churn detector: counts cache misses per fn.__code__ so a
# caller passing a new lambda every call (same code, new identity — every
# miss recompiles AND pins the closure + its captured arrays in the cache)
# gets warned instead of silently paying a compile per invocation
_RUNNER_MISSES_BY_CODE: dict = {}
_CHURN_WARN_AT = 3
_CHURN_KEYS_CAP = 1024   # heuristic table only — never let it grow unbounded


def _churn_key(fn):
    """Stable, non-pinning identity for the churn heuristic: unwrap
    functools.partial chains and bound methods down to the code object, so
    fresh partials over the same function share one counter (and the
    partial itself — plus anything it captured — is never held as a key).
    Objects without code (e.g. C callables) key by type qualname."""
    seen = fn
    while isinstance(seen, functools.partial):
        seen = seen.func
    seen = getattr(seen, "__func__", seen)
    code = getattr(seen, "__code__", None)
    if code is not None:
        return code
    return (type(seen).__module__, type(seen).__qualname__)


def batched_apply(fn, images, mesh: Mesh):
    """Apply a single-image op to a sharded batch.

    fn: (H, W, ...) → out (static shapes, any rank — only the batch axis is
    sharding-constrained on the output); images: (B, H, W, ...) with B
    divisible by the mesh's batch-axis size.  Images stay sharded on device;
    the per-device batch runs as an unrolled loop (each op fills a device on
    its own).

    The shard_map is wrapped in jit: un-jitted shard_map runs its body op
    by op, one dispatch each.

    One jitted runner is cached per (fn, mesh, rank) — pass a STABLE
    function object (a def/partial, not a fresh lambda per call) to reuse
    the compiled program across calls.  Note the cache holds strong
    references: up to 64 runners stay alive, each keeping its fn closure
    (and any arrays it captured) pinned.  Passing a fresh closure per call
    both retraces every invocation and fills the cache with dead entries —
    a RuntimeWarning fires after the third miss for the same code object."""
    b = images.shape[0]
    nbatch = mesh.shape[BATCH_AXIS]
    if b % nbatch != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nbatch}")
    misses_before = _cached_generic_runner.cache_info().misses
    run = _cached_generic_runner(fn, mesh, images.ndim)
    if _cached_generic_runner.cache_info().misses > misses_before:
        if len(_RUNNER_MISSES_BY_CODE) > _CHURN_KEYS_CAP:
            _RUNNER_MISSES_BY_CODE.clear()
        code = _churn_key(fn)
        n = _RUNNER_MISSES_BY_CODE[code] = _RUNNER_MISSES_BY_CODE.get(code, 0) + 1
        if n == _CHURN_WARN_AT:
            import warnings
            warnings.warn(
                "batched_apply compiled a new runner for the same function "
                f"code {_CHURN_WARN_AT} times — you are likely passing a "
                "fresh lambda/closure per call, which retraces every "
                "invocation and pins each closure (plus captured arrays) in "
                "the runner cache; pass one stable def/functools.partial "
                "instead", RuntimeWarning, stacklevel=3)
    return run(images)


def _single_image_fn(op: str, params: tuple, impl: str):
    if op == "bilateral":
        from ..ops.bilateral import _bf_jit
        return lambda img: _bf_jit(img, *params, impl)
    elif op == "btf":
        from ..ops.bilateral_texture import _btf_jit
        return lambda img: _btf_jit(img, *params, impl)
    elif op == "abf":
        from ..ops.adaptive_bilateral import _abf_jit
        return lambda img: _abf_jit(img, *params)
    elif op == "gradient":
        from ..ops.gradient import _gradient_jit
        return _gradient_jit
    raise ValueError(op)


@functools.lru_cache(maxsize=64)
def _cached_batched_runner(op: str, params: tuple, impl: str, mesh: Mesh,
                           ndim: int):
    """One jitted shard_map runner per (op, params, impl, mesh, rank):
    re-creating the closure per call would retrace every invocation.
    jax.jit specializes per input shape, so one runner serves all batch
    sizes.  The shard_map sits INSIDE the jit — eager shard_map runs its
    body op by op."""
    import jax.numpy as jnp

    single = _single_image_fn(op, params, impl)
    spec = P(BATCH_AXIS, *([None] * (ndim - 1)))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=P(BATCH_AXIS), check_vma=False)
    def run(local):
        return jnp.stack([single(local[i]) for i in range(local.shape[0])])

    return run


def _dispatch_batched(op, params, images, mesh, impl):
    from ..ops._dispatch import resolve_impl
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh()
    impl = resolve_impl(impl, has_kernel=op in ("bilateral", "btf"))
    nbatch = mesh.shape[BATCH_AXIS]
    if images.shape[0] % nbatch != 0:
        raise ValueError(
            f"batch {images.shape[0]} not divisible by mesh batch axis {nbatch}")
    return _cached_batched_runner(op, params, impl, mesh, images.ndim)(images)


def bilateral_filter_batched(images, ksize: int = 9, sigma_space: float = 10.0,
                             sigma_color: float = 30.0, mesh: Mesh | None = None,
                             impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-sharded over the mesh."""
    return _dispatch_batched("bilateral",
                             (int(ksize), float(sigma_space), float(sigma_color)),
                             images, mesh, impl)


def bilateral_texture_filter_batched(images, ksize: int = 9, nitr: int = 3,
                                     mesh: Mesh | None = None,
                                     impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-sharded over the mesh."""
    return _dispatch_batched("btf", (int(ksize), int(nitr)), images, mesh, impl)


def adaptive_bilateral_filter_batched(images, ksize: int = 9,
                                      sigma_space: float = 10.0,
                                      sigma_color: float = 30.0,
                                      mesh: Mesh | None = None,
                                      impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-sharded over the mesh."""
    return _dispatch_batched("abf",
                             (int(ksize), float(sigma_space), float(sigma_color)),
                             images, mesh, impl)


def gradient_batched(images, mesh: Mesh | None = None, impl: str = "auto"):
    """(B, H, W[, C]) u8|f32 → (B, H, W) f32, batch-sharded over the mesh."""
    return _dispatch_batched("gradient", (), images, mesh, impl)


@functools.lru_cache(maxsize=64)
def _cached_jbf_runner(params: tuple, impl: str, mesh: Mesh, ndim: int):
    import jax.numpy as jnp

    from ..ops.bilateral import _jbf_jit

    spec = P(BATCH_AXIS, *([None] * (ndim - 1)))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec),
                       out_specs=P(BATCH_AXIS), check_vma=False)
    def run(local, local_guide):
        return jnp.stack([_jbf_jit(local[i], local_guide[i], *params, impl)
                          for i in range(local.shape[0])])

    return run


def joint_bilateral_filter_batched(images, guides, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """(B, H, W, 3) u8 images + guides → (B, H, W, 3) u8, batch-sharded."""
    from ..ops._dispatch import resolve_impl
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh()
    impl = resolve_impl(impl)
    if images.shape != guides.shape:
        raise ValueError("images and guides shapes differ")
    nbatch = mesh.shape[BATCH_AXIS]
    if images.shape[0] % nbatch != 0:
        raise ValueError(
            f"batch {images.shape[0]} not divisible by mesh batch axis {nbatch}")
    runner = _cached_jbf_runner(
        (int(ksize), float(sigma_space), float(sigma_color)), impl, mesh,
        images.ndim)
    return runner(images, guides)


def superpixel_slic_batched(images, superpixel_size: int = 30,
                            num_iteration: int = 10, color_scale: float = 20.0,
                            metric: str = "euclidean", mesh: Mesh | None = None):
    """(B, H, W, 3) u8 BGR → (B, H, W) i32 labels.

    The device k-means runs as ONE vmapped XLA program over the whole batch
    (jax batches the early-exit while_loop with per-image masking, so each
    image stops updating exactly when its single-image run would); the
    host-side connectivity stage (native C++ CCL + merge) loops per image.
    With a multi-device mesh the batch shards over the batch axis."""
    import jax.numpy as jnp
    import numpy as np

    from ..core.colors import bgr2lab_u8_exact
    from ..models.slic import enforce_connectivity

    images = np.asarray(images)
    b, h, w = images.shape[:3]
    lab = bgr2lab_u8_exact(images)                       # (B, H, W, 3)
    mesh_key = mesh if (mesh is not None and mesh.shape[BATCH_AXIS] > 1) else None
    if mesh_key is not None and b % mesh_key.shape[BATCH_AXIS] != 0:
        raise ValueError(
            f"batch {b} not divisible by mesh batch axis "
            f"{mesh_key.shape[BATCH_AXIS]}")
    runner = _cached_slic_runner(h, w, int(superpixel_size),
                                 int(num_iteration), float(color_scale),
                                 metric, mesh_key)
    labels_dev, drift_dev = runner(jnp.asarray(lab))
    # one device→host round-trip for both outputs
    labels_np, drift_np = jax.device_get((labels_dev, drift_dev))
    max_drift = float(drift_np.max())
    if max_drift > 2.0:
        import warnings
        warnings.warn(
            f"SLIC center drift reached {max_drift:.0f} cells (> 2) in the "
            "batch: the 5x5 cell gather no longer covers every reference "
            "+/-S scan window (models/slic.py bounded-drift assumption)",
            RuntimeWarning, stacklevel=2)
    return np.stack([enforce_connectivity(labels_np[i], lab[i],
                                          int(superpixel_size), metric)
                     for i in range(b)])


@functools.lru_cache(maxsize=64)
def _cached_slic_runner(h: int, w: int, sp_size: int, nitr: int,
                        color_scale: float, metric: str, mesh: Mesh | None):
    """One jitted (optionally shard_mapped) vmapped k-means program per
    config/mesh — rebuilding the vmap+jit closure per call retraces every
    invocation."""
    from ..models.slic import slic_device

    def one(x):
        labels, _, _, drift = slic_device(x, h, w, sp_size, nitr,
                                          color_scale, metric)
        return labels, drift

    device_fn = jax.vmap(one)
    if mesh is None:
        return jax.jit(device_fn)
    spec = P(BATCH_AXIS, None, None, None)
    return jax.jit(shard_map(device_fn, mesh=mesh, in_specs=(spec,),
                             out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                             check_vma=False))


def inpainting_wexler_batched(images, masks, **kwargs):
    """(B, H, W, 3) u8 + (B, H, W) u8 masks → (B, H, W, 3) u8 fills.

    Sequential per image by design: each image's fill pass is already a
    whole-device XLA program (a lax.while_loop of full-image conv searches),
    so intra-device batching would only interleave rings of unrelated holes;
    on a multi-device deployment, fan images out one per device instead (the
    fills share no state)."""
    import numpy as np

    from ..models.inpainting import WexlerInpainting

    images = np.asarray(images)
    masks = np.asarray(masks)
    if images.shape[:1] != masks.shape[:1]:
        raise ValueError("images and masks batch sizes differ")
    model = WexlerInpainting(**kwargs)
    return np.stack([model.apply(images[i], masks[i])
                     for i in range(images.shape[0])])


def bilateral_filter_batch_spatial(images, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8 over BOTH mesh axes in ONE program:
    the batch shards over the mesh's batch axis and each image's rows shard
    over the spatial axis, with ppermute halo exchange along spatial rings.
    Bit-identical to the single-device op (the 2-axis mesh story the
    reference has no counterpart for)."""
    from ..ops._dispatch import resolve_impl
    from .mesh import SPATIAL_AXIS

    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh()
    impl = resolve_impl(impl)
    nbatch = mesh.shape[BATCH_AXIS]
    d = mesh.shape[SPATIAL_AXIS]
    b, h = images.shape[0], images.shape[1]
    if b % nbatch != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nbatch}")
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    radius = int(ksize) // 2
    if h // d < radius:
        raise ValueError(f"shard height {h // d} smaller than halo {radius}")
    runner = _cached_batch_spatial_runner(
        int(ksize), float(sigma_space), float(sigma_color), impl, mesh)
    return runner(images)


@functools.lru_cache(maxsize=64)
def _cached_batch_spatial_runner(ksize: int, sigma_space: float,
                                 sigma_color: float, impl: str, mesh: Mesh):
    """One jitted 2-axis shard_map program per (params, impl, mesh) — the
    per-call closure form retraced every invocation (jit specializes per
    input shape, so one runner serves all batch/image sizes)."""
    import jax.numpy as jnp

    from ..ops.bilateral import _bf_jit
    from .mesh import SPATIAL_AXIS
    from .spatial import halo_exchange_rows

    radius = ksize // 2
    d = mesh.shape[SPATIAL_AXIS]
    spec = P(BATCH_AXIS, SPATIAL_AXIS, None, None)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=spec, check_vma=False)
    def run(local):  # (b_local, h_local, W, 3)
        def one(img_rows):
            padded = halo_exchange_rows(img_rows, radius, SPATIAL_AXIS, d)
            out = _bf_jit(padded, ksize, sigma_space, sigma_color, impl)
            return out[radius : radius + img_rows.shape[0]]

        # uniform local batch size on every device → the ppermutes inside
        # the loop stay collective-uniform across the mesh
        return jnp.stack([one(local[i]) for i in range(local.shape[0])])

    return run


def joint_bilateral_filter_batch_spatial(images, guides, ksize: int = 9,
                                         sigma_space: float = 10.0,
                                         sigma_color: float = 30.0,
                                         mesh: Mesh | None = None,
                                         impl: str = "auto"):
    """(B, H, W, 3) u8 images + guides → (B, H, W, 3) u8 over BOTH mesh
    axes in ONE program: the deepest two-operand sharding — batch shards
    over the mesh's batch axis AND each image's/guide's rows shard over the
    spatial axis with ppermute halo exchange for both operands.
    Bit-identical to the single-device op (twin of the reference's
    guide-keyed kernel, include/cpp/bilateral_filter.hpp:126, at a scale
    the reference cannot reach)."""
    from ..ops._dispatch import resolve_impl
    from .mesh import SPATIAL_AXIS

    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh()
    impl = resolve_impl(impl)
    if images.shape != guides.shape:
        raise ValueError("images and guides shapes differ")
    nbatch = mesh.shape[BATCH_AXIS]
    d = mesh.shape[SPATIAL_AXIS]
    b, h = images.shape[0], images.shape[1]
    if b % nbatch != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nbatch}")
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    radius = int(ksize) // 2
    if h // d < radius:
        raise ValueError(f"shard height {h // d} smaller than halo {radius}")
    runner = _cached_jbf_batch_spatial_runner(
        int(ksize), float(sigma_space), float(sigma_color), impl, mesh)
    return runner(images, guides)


@functools.lru_cache(maxsize=64)
def _cached_jbf_batch_spatial_runner(ksize: int, sigma_space: float,
                                     sigma_color: float, impl: str,
                                     mesh: Mesh):
    import jax.numpy as jnp

    from ..ops.bilateral import _jbf_jit
    from .mesh import SPATIAL_AXIS
    from .spatial import halo_exchange_rows

    radius = ksize // 2
    d = mesh.shape[SPATIAL_AXIS]
    spec = P(BATCH_AXIS, SPATIAL_AXIS, None, None)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec, check_vma=False)
    def run(local, local_guide):  # (b_local, h_local, W, 3) each
        def one(img_rows, g_rows):
            p = halo_exchange_rows(img_rows, radius, SPATIAL_AXIS, d)
            pg = halo_exchange_rows(g_rows, radius, SPATIAL_AXIS, d)
            out = _jbf_jit(p, pg, ksize, sigma_space, sigma_color, impl)
            return out[radius : radius + img_rows.shape[0]]

        # uniform local batch size on every device → the ppermutes inside
        # the loop stay collective-uniform across the mesh
        return jnp.stack([one(local[i], local_guide[i])
                          for i in range(local.shape[0])])

    return run
