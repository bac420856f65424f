"""The main path on the card: every public op at a real size against its
plain reference (the checks of utils/onchip.py, which chip_smoke.py runs
too).  They need an NVIDIA GPU and skip elsewhere; on the card:

    python -m pytest tests/test_gpu.py --gpu
"""

import jax
import pytest

from various_image_processings_tpu.utils import onchip

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpus():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest tests/test_gpu.py "
                    "--gpu on the card")
    return devices


@pytest.mark.parametrize("check", [
    "check_bilateral_vs_golden", "check_filters_4k", "check_jbf_k17",
    "check_btf",
    "check_btf_4k", "check_slic", "check_wexler"])
def test_main_path_on_card(gpus, check):
    for record in getattr(onchip, check)():
        print(record)


def test_four_cards_match_one(gpus):
    if len(gpus) < 4:
        pytest.skip("needs 4 GPUs")
    onchip.check_four_devices(gpus[:4])
