"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the
multi-device sharding paths (shard_map over a Mesh, ppermute halo exchange)
execute without accelerators and Pallas kernels run in interpret mode.
``--gpu`` leaves JAX on its default platform instead: that is how the
``gpu``-marked tests (tests/test_gpu.py) are run on the card.
"""

import os

import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="run on JAX's default platform (the card) "
                          "instead of 8 virtual CPU devices")


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
    assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture(scope="session")
def lenna():
    """512×512 BGR u8 sample image (reference: sample_image/lenna.png)."""
    cv2 = pytest.importorskip("cv2")
    path = "/root/reference/sample_image/lenna.png"
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        pytest.skip("lenna.png not available")
    return np.asarray(img)
