"""Path choice (ops/_dispatch.py) and the compile-cache rule
(utils/compile_cache.py)."""

import os

import jax
import numpy as np
import pytest

from various_image_processings_tpu.core.rng import random_image
from various_image_processings_tpu.ops import _dispatch
from various_image_processings_tpu.ops._dispatch import resolve_impl


@pytest.fixture
def backend(monkeypatch):
    """Pretend the default backend is the given platform."""
    def set_(name):
        monkeypatch.setattr(_dispatch.jax, "default_backend", lambda: name)
    return set_


def test_auto_picks_kernel_only_on_gpu(backend):
    backend("gpu")
    assert resolve_impl("auto") == "pallas"
    assert resolve_impl("auto", has_kernel=False) == "xla"
    backend("cpu")
    assert resolve_impl("auto") == "xla"
    assert resolve_impl("auto", has_kernel=False) == "xla"


def test_interpret_only_on_cpu(backend):
    backend("cpu")
    assert resolve_impl("pallas") == "interpret"
    backend("gpu")
    assert resolve_impl("pallas") == "pallas"
    assert resolve_impl("xla") == "xla"


def test_pallas_on_op_without_kernel_raises(backend):
    from various_image_processings_tpu.ops.adaptive_bilateral import (
        adaptive_bilateral_filter)
    from various_image_processings_tpu.ops.gradient import gradient
    img = random_image(8, 8)
    with pytest.raises(ValueError, match="no Pallas kernel"):
        gradient(img, impl="pallas")
    with pytest.raises(ValueError, match="no Pallas kernel"):
        adaptive_bilateral_filter(img, 3, impl="pallas")
    backend("gpu")
    with pytest.raises(ValueError, match="no Pallas kernel"):
        resolve_impl("pallas", has_kernel=False)


def test_unknown_impl_rejected():
    with pytest.raises(ValueError, match="impl must be one of"):
        resolve_impl("mosaic")


def test_parallel_wrappers_reject_pallas_for_kernelless_ops():
    from various_image_processings_tpu.parallel import (
        adaptive_bilateral_filter_batched, gradient_sharded, make_mesh)
    imgs = np.stack([random_image(16, 16)] * 2)
    with pytest.raises(ValueError, match="no Pallas kernel"):
        adaptive_bilateral_filter_batched(
            imgs, 3, mesh=make_mesh(batch=2, spatial=1), impl="pallas")
    with pytest.raises(ValueError, match="no Pallas kernel"):
        gradient_sharded(imgs[0], mesh=make_mesh(batch=1, spatial=2),
                         impl="pallas")


def test_compile_cache_follows_env_when_set(monkeypatch, tmp_path):
    from various_image_processings_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []   # JAX reads the variable itself; nothing overrides it


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from various_image_processings_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
