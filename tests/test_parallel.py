"""Multi-chip layer on the 8-virtual-device CPU mesh: batch sharding and
spatial halo-exchange sharding must reproduce the single-device results
exactly."""

import jax
import numpy as np
import pytest

from various_image_processings_tpu.core.rng import MT19937
from various_image_processings_tpu.ops.bilateral import bilateral_filter
from various_image_processings_tpu.parallel import (
    make_mesh, batched_apply, bilateral_filter_batched, bilateral_filter_sharded)


def batch_images(b, h, w):
    raw = MT19937(42).raw(b * h * w * 3)
    return (raw % np.uint32(255)).astype(np.uint8).reshape(b, h, w, 3)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    mesh2 = make_mesh(batch=4, spatial=2)
    assert mesh2.shape["batch"] == 4 and mesh2.shape["y"] == 2
    with pytest.raises(ValueError, match="devices"):
        make_mesh(batch=16, spatial=1)


def test_batched_bilateral_matches_per_image():
    imgs = batch_images(8, 40, 40)
    mesh = make_mesh(batch=8, spatial=1)
    out = np.asarray(bilateral_filter_batched(imgs, 9, 10.0, 30.0, mesh=mesh,
                                              impl="xla"))
    for i in range(8):
        single = np.asarray(bilateral_filter(imgs[i], 9, 10.0, 30.0, impl="xla"))
        np.testing.assert_array_equal(out[i], single)


def test_batched_rejects_indivisible_batch():
    imgs = batch_images(6, 16, 16)
    mesh = make_mesh(batch=4, spatial=1)
    with pytest.raises(ValueError, match="divisible"):
        bilateral_filter_batched(imgs, mesh=mesh, impl="xla")


@pytest.mark.parametrize("spatial", [2, 4, 8])
def test_spatially_sharded_bilateral_bit_exact(spatial):
    img = batch_images(1, 64, 48)[0]
    mesh = make_mesh(batch=1, spatial=spatial)
    out = np.asarray(bilateral_filter_sharded(img, 9, 10.0, 30.0, mesh=mesh,
                                              impl="xla"))
    single = np.asarray(bilateral_filter(img, 9, 10.0, 30.0, impl="xla"))
    np.testing.assert_array_equal(out, single)


@pytest.mark.parametrize("batch,spatial,b", [(4, 2, 4), (2, 4, 6)])
def test_mixed_mesh_batch_and_spatial_one_program(batch, spatial, b):
    # ONE shard_map over BOTH mesh axes: batch shards images, spatial shards
    # each image's rows with ppermute halo exchange, in a single program
    from various_image_processings_tpu.parallel import bilateral_filter_batch_spatial
    imgs = batch_images(b, 32, 32)
    mesh = make_mesh(batch=batch, spatial=spatial)
    out = np.asarray(bilateral_filter_batch_spatial(
        imgs, 9, 10.0, 30.0, mesh=mesh, impl="xla"))
    for i in range(b):
        single = np.asarray(bilateral_filter(imgs[i], impl="xla"))
        np.testing.assert_array_equal(out[i], single)


def test_joint_bilateral_batched_and_sharded():
    from various_image_processings_tpu.parallel import (
        joint_bilateral_filter_batched, joint_bilateral_filter_sharded)
    from various_image_processings_tpu.ops.bilateral import joint_bilateral_filter
    imgs = batch_images(4, 40, 40)
    guides = batch_images(4, 40, 40)[::-1].copy()
    mesh = make_mesh(batch=4, spatial=1)
    out = np.asarray(joint_bilateral_filter_batched(
        imgs, guides, 9, 10.0, 30.0, mesh=mesh, impl="xla"))
    for i in range(4):
        single = np.asarray(joint_bilateral_filter(
            imgs[i], guides[i], 9, 10.0, 30.0, impl="xla"))
        np.testing.assert_array_equal(out[i], single)

    sp_mesh = make_mesh(batch=1, spatial=4)
    sh = np.asarray(joint_bilateral_filter_sharded(
        imgs[0], guides[0], 9, 10.0, 30.0, mesh=sp_mesh, impl="xla"))
    single = np.asarray(joint_bilateral_filter(
        imgs[0], guides[0], 9, 10.0, 30.0, impl="xla"))
    np.testing.assert_array_equal(sh, single)


@pytest.mark.parametrize("batch,spatial,b", [(4, 2, 4), (2, 4, 6)])
def test_joint_bilateral_batch_spatial_bit_exact(batch, spatial, b):
    # the deepest two-operand sharding: batch × spatial in ONE program,
    # image AND guide rows each halo-exchanged along the spatial ring
    from various_image_processings_tpu.parallel import (
        joint_bilateral_filter_batch_spatial)
    from various_image_processings_tpu.ops.bilateral import joint_bilateral_filter
    imgs = batch_images(b, 32, 32)
    guides = batch_images(b, 32, 32)[::-1].copy()
    mesh = make_mesh(batch=batch, spatial=spatial)
    out = np.asarray(joint_bilateral_filter_batch_spatial(
        imgs, guides, 9, 10.0, 30.0, mesh=mesh, impl="xla"))
    for i in range(b):
        single = np.asarray(joint_bilateral_filter(
            imgs[i], guides[i], 9, 10.0, 30.0, impl="xla"))
        np.testing.assert_array_equal(out[i], single)


def test_slic_batched_matches_per_image():
    from various_image_processings_tpu.parallel import superpixel_slic_batched
    from various_image_processings_tpu.ops.slic import superpixel_slic
    imgs = batch_images(4, 48, 48)
    mesh = make_mesh(batch=4, spatial=1)
    out = superpixel_slic_batched(imgs, superpixel_size=16, num_iteration=3,
                                  mesh=mesh)
    assert out.shape == (4, 48, 48)
    for i in range(4):
        single = np.asarray(superpixel_slic(imgs[i], 16, 3))
        np.testing.assert_array_equal(out[i], single)


def test_wexler_batched_matches_per_image():
    from various_image_processings_tpu.parallel import inpainting_wexler_batched
    from various_image_processings_tpu.ops.inpainting import inpainting_wexler
    size = 48
    img = np.zeros((size, size, 3), np.uint8)
    img[:, :, :] = ((np.arange(size) // 4) % 2 * 180 + 40).astype(np.uint8)[None, :, None]
    imgs = np.stack([img, img[:, ::-1]])
    mask = np.zeros((size, size), np.uint8)
    mask[20:26, 20:26] = 255
    masks = np.stack([mask, mask])
    out = inpainting_wexler_batched(imgs, masks)
    for i in range(2):
        single = np.asarray(inpainting_wexler(imgs[i], masks[i]))
        np.testing.assert_array_equal(out[i], single)


def test_joint_bilateral_parallel_shape_mismatch():
    from various_image_processings_tpu.parallel import (
        joint_bilateral_filter_batched, joint_bilateral_filter_sharded)
    imgs = batch_images(4, 40, 40)
    with pytest.raises(ValueError, match="differ"):
        joint_bilateral_filter_batched(imgs, imgs[:, :32], impl="xla")
    with pytest.raises(ValueError, match="differ"):
        joint_bilateral_filter_sharded(imgs[0], imgs[0][:32], impl="xla")


def test_sharded_abf_and_gradient_bit_exact():
    from various_image_processings_tpu.parallel.spatial import (
        adaptive_bilateral_filter_sharded, gradient_sharded)
    from various_image_processings_tpu.ops.adaptive_bilateral import adaptive_bilateral_filter
    from various_image_processings_tpu.ops.gradient import gradient
    img = batch_images(1, 64, 48)[0]
    mesh = make_mesh(batch=1, spatial=4)
    out = np.asarray(adaptive_bilateral_filter_sharded(img, 9, mesh=mesh, impl="xla"))
    np.testing.assert_array_equal(
        out, np.asarray(adaptive_bilateral_filter(img, 9, impl="xla")))
    g = np.asarray(gradient_sharded(img, mesh=mesh, impl="xla"))
    np.testing.assert_array_equal(g, np.asarray(gradient(img, impl="xla")))


@pytest.mark.parametrize("spatial,nitr", [(2, 1), (4, 3)])
def test_sharded_btf_bit_exact(spatial, nitr):
    # per-stage halo exchange keeps even the GLOBAL boundary bands exact
    from various_image_processings_tpu.parallel.spatial import (
        bilateral_texture_filter_sharded)
    from various_image_processings_tpu.ops.bilateral_texture import bilateral_texture_filter
    img = batch_images(1, 128, 48)[0]
    mesh = make_mesh(batch=1, spatial=spatial)
    out = np.asarray(bilateral_texture_filter_sharded(img, ksize=5, nitr=nitr,
                                                      mesh=mesh, impl="xla"))
    single = np.asarray(bilateral_texture_filter(img, 5, nitr, impl="xla"))
    np.testing.assert_array_equal(out, single)


def test_sharded_pallas_impl_bit_exact():
    # impl="pallas" runs the Triton bilateral kernel under shard_map
    # (interpret mode on the CPU mesh) — must match the single-device
    # kernel op exactly
    img = batch_images(1, 64, 48)[0]
    mesh = make_mesh(batch=1, spatial=2)
    out = np.asarray(bilateral_filter_sharded(img, 5, 10.0, 30.0, mesh=mesh,
                                              impl="pallas"))
    single = np.asarray(bilateral_filter(img, 5, 10.0, 30.0, impl="pallas"))
    np.testing.assert_array_equal(out, single)


def test_sharded_btf_pallas_impl_bit_exact():
    # per-stage halo exchange around the XLA stages and the kernel JBF
    from various_image_processings_tpu.parallel.spatial import (
        bilateral_texture_filter_sharded)
    from various_image_processings_tpu.ops.bilateral_texture import (
        bilateral_texture_filter)
    img = batch_images(1, 64, 48)[0]
    mesh = make_mesh(batch=1, spatial=2)
    out = np.asarray(bilateral_texture_filter_sharded(img, ksize=3, nitr=1,
                                                      mesh=mesh, impl="pallas"))
    single = np.asarray(bilateral_texture_filter(img, 3, 1, impl="pallas"))
    np.testing.assert_array_equal(out, single)


def test_batched_pallas_impl_matches_single():
    imgs = batch_images(4, 40, 40)
    mesh = make_mesh(batch=4, spatial=1)
    out = np.asarray(bilateral_filter_batched(imgs, 5, 10.0, 30.0, mesh=mesh,
                                              impl="pallas"))
    for i in range(4):
        single = np.asarray(bilateral_filter(imgs[i], 5, 10.0, 30.0,
                                             impl="pallas"))
        np.testing.assert_array_equal(out[i], single)


def test_batched_abf_and_gradient():
    from various_image_processings_tpu.parallel import (
        adaptive_bilateral_filter_batched, gradient_batched)
    from various_image_processings_tpu.ops.adaptive_bilateral import adaptive_bilateral_filter
    from various_image_processings_tpu.ops.gradient import gradient
    imgs = batch_images(4, 24, 24)
    mesh = make_mesh(batch=4, spatial=1)
    out = np.asarray(adaptive_bilateral_filter_batched(imgs, 9, mesh=mesh, impl="xla"))
    np.testing.assert_array_equal(
        out[1], np.asarray(adaptive_bilateral_filter(imgs[1], 9, impl="xla")))
    g = np.asarray(gradient_batched(imgs, mesh=mesh, impl="xla"))
    np.testing.assert_array_equal(g[2], np.asarray(gradient(imgs[2], impl="xla")))


def test_batched_apply_rank_changing_fn():
    """batched_apply must support fns whose output rank differs from the
    input rank (review finding: out_specs built from the INPUT rank raised
    for e.g. gradient's (H,W,3)->(H,W))."""
    import jax.numpy as jnp

    from various_image_processings_tpu.core.rng import random_image
    from various_image_processings_tpu.ops.gradient import _gradient_jit
    from various_image_processings_tpu.parallel import make_mesh
    from various_image_processings_tpu.parallel.batch import batched_apply

    mesh = make_mesh(batch=2, spatial=1)
    imgs = jnp.asarray(np.stack([random_image(16, 16) for _ in range(4)]))
    out = batched_apply(_gradient_jit, imgs, mesh)
    assert out.shape == (4, 16, 16)
    single = _gradient_jit(imgs[0])
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(single))


def test_batched_apply_warns_on_fresh_closure_churn():
    """Passing a fresh lambda per call retraces every invocation and pins
    each closure in the runner cache — the third miss for the same code
    object must fire a RuntimeWarning (ADVICE r3)."""
    import warnings

    import jax.numpy as jnp

    from various_image_processings_tpu.core.rng import random_image
    from various_image_processings_tpu.parallel import make_mesh
    from various_image_processings_tpu.parallel import batch as batch_mod

    mesh = make_mesh(batch=2, spatial=1)
    imgs = jnp.asarray(np.stack([random_image(8, 8) for _ in range(2)]))

    def fresh():
        # distinct function objects, one shared code object
        return lambda im: im + jnp.uint8(1)

    code = fresh().__code__
    batch_mod._RUNNER_MISSES_BY_CODE.pop(code, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            batch_mod.batched_apply(fresh(), imgs, mesh)
    msgs = [w for w in caught if issubclass(w.category, RuntimeWarning)
            and "fresh lambda" in str(w.message)]
    assert len(msgs) == 1

    # a STABLE callable must never trigger it
    stable = fresh()
    batch_mod._RUNNER_MISSES_BY_CODE.pop(code, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            batch_mod.batched_apply(stable, imgs, mesh)
    assert not any("fresh lambda" in str(w.message) for w in caught)
