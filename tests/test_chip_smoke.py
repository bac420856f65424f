"""The GPU entry points refuse to report without a GPU, and the CPU-side
helpers of the on-card checks (utils/onchip.py) behave."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from various_image_processings_tpu.utils import onchip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_fails_without_gpu(script):
    r = _run([script], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_synthetic_image_is_seeded_and_varied():
    a = onchip.synthetic_image(48, 64, 3)
    assert a.shape == (48, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, onchip.synthetic_image(48, 64, 3))
    assert not np.array_equal(a, onchip.synthetic_image(48, 64, 4))
    assert a.std() > 20      # regions and texture, not a flat field


def test_diff_stats_and_boundary_recall():
    a = np.zeros((10, 10), np.uint8)
    b = a.copy()
    b[0, 0] = 3
    st = onchip.diff_stats(a, b)
    assert st["max"] == 3 and st["frac"] == pytest.approx(0.01)
    labels = np.zeros((20, 20), np.int32)
    labels[:, 10:] = 1
    assert onchip.boundary_recall(labels, labels) == 1.0
    shifted = np.zeros((20, 20), np.int32)
    shifted[:, 12:] = 1
    assert onchip.boundary_recall(labels, shifted) == 1.0      # within 2 px
    assert onchip.boundary_recall(labels, shifted, tol=1) == 0.0


def test_jbf_k17_check_runs_on_cpu():
    """The k=17 check's kernel (interpret mode here) against the strict XLA
    form, at a small size."""
    records = onchip.check_jbf_k17(sizes=((20, 30),))
    assert len(records) == 1 and records[0]["shape"] == [20, 30, 3]
    assert records[0]["parity"].startswith(("max 0", "max 1"))


def test_four_device_check_on_cpu_mesh():
    """The 4-device check's meshes, input shardings and comparison with one
    device, on four virtual CPU devices at small sizes."""
    import jax
    records = onchip.check_four_devices(
        jax.devices("cpu")[:4], frame_hw=(16, 24), big_hw=(32, 40),
        small_hw=(12, 20))
    assert [r["parity"] for r in records] == ["bit-identical"] * 3
