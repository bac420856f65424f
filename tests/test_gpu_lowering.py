"""AOT Pallas→Triton lowering of the bilateral kernel, on the CPU host.

``jax.export(..., platforms=["cuda"])`` runs the real Pallas→Triton lowering
(primitive support, ref indexing, inline asm) without a GPU — the guard
against kernels that interpret-mode tests accept but the Triton lowering
rejects.  What it cannot catch: Triton/ptxas compile failures (registers,
shared memory) — the first chip run of a new kernel checks those.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

TRITON_CALL = "__gpu$xla.gpu.triton"
SQRT3 = float(math.sqrt(3.0))


_KEEP_ALIVE = []


def _lower_cuda(fn, *args) -> str:
    """Trace + lower for CUDA; returns the module text (raises on
    unsupported kernels).  The Triton custom call is not on jax.export's
    list of stable targets, hence the disabled check.  Each lowered
    function is kept alive: a collected lambda's address can be reused by
    the next one, and the export's lowering cache then mixes them up."""
    _KEEP_ALIVE.append(fn)
    exported = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            TRITON_CALL)])(*args)
    text = exported.mlir_module()
    assert TRITON_CALL in text, "the kernel was not lowered through Triton"
    return text


U8_HWC = jax.ShapeDtypeStruct((64, 256, 3), jnp.uint8)


def _kernel(*args, **kwargs):
    from various_image_processings_tpu.ops.pallas.bilateral import (
        joint_bilateral_pallas)
    return joint_bilateral_pallas(*args, interpret=False, **kwargs)


@pytest.mark.parametrize("ksize", [3, 9])
def test_bilateral_lowers(ksize):
    _lower_cuda(lambda s: _kernel(s, None, ksize, 10.0, 30.0), U8_HWC)


def test_joint_bilateral_k9_lowers():
    _lower_cuda(lambda s, g: _kernel(s, g, 9, 10.0, 30.0), U8_HWC, U8_HWC)


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"),
                                             ("reflect101", "rint")])
def test_joint_bilateral_k17_lowers(border, rounding):
    """k=17 (the BTF's JBF) with both variants' border/rounding; the rint
    epilogue is the ``cvt.rni`` inline asm."""
    text = _lower_cuda(lambda s, g: _kernel(s, g, 17, 8.0, SQRT3, border,
                                            rounding), U8_HWC, U8_HWC)
    if rounding == "rint":
        assert "cvt.rni.f32.f32" in text


def test_kernel_rounds_each_product_and_sum_separately():
    """The compiled kernel's products and sums are ``mul.rn``/``add.rn``
    (never contracted into an FMA) and its divide is ``div.rn`` — what makes
    it the bit-exact twin of golden on the card."""
    text = _lower_cuda(lambda s: _kernel(s, None, 5, 10.0, 30.0), U8_HWC)
    for op in ("mul.rn.f32", "add.rn.f32", "div.rn.f32"):
        assert op in text, op


@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_btf_iteration_lowers(variant):
    """The whole BTF (XLA stages + kernel JBF in a fori_loop) lowers with
    the kernel compiled, for both variants."""
    from various_image_processings_tpu.ops.bilateral_texture import _btf_jit
    def btf(s):
        return _btf_jit(s, 9, 2, "pallas", variant)

    _lower_cuda(btf, U8_HWC)


def test_batched_shardmap_kernel_lowers():
    """4-way batch shard_map with the compiled kernel inside lowers for a
    4-GPU mesh (the CPU devices stand in for the mesh's shape)."""
    from various_image_processings_tpu.parallel.batch import (
        _cached_batched_runner)
    mesh = Mesh(np.array(jax.devices()[:4]), ("batch",))
    run = _cached_batched_runner("bilateral", (9, 10.0, 30.0), "pallas", mesh, 4)
    _lower_cuda(run, jax.ShapeDtypeStruct((8, 64, 128, 3), jnp.uint8))


def test_spatial_shardmap_kernel_lowers():
    """Row-sharded bilateral (ppermute halo exchange around the compiled
    kernel) lowers for a 4-GPU mesh."""
    from various_image_processings_tpu.parallel.spatial import (
        _cached_stencil_runner)
    mesh = Mesh(np.array(jax.devices()[:4]), ("y",))
    run = _cached_stencil_runner("bf", (9, 10.0, 30.0), "pallas", mesh, 4,
                                 (3,), 3)
    _lower_cuda(run, jax.ShapeDtypeStruct((256, 128, 3), jnp.uint8))
