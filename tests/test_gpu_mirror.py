"""Full-size checks against the float64 mirror on a GPU (marker ``gpu``).

They skip without a card; chip_smoke.py runs the same phases.  On a card:

    LMVN_TEST_DEVICE=gpu python -m pytest tests/ -m gpu
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_256_drivers_vs_mirror(gpu_device):
    chip_smoke.phase_256((256, 256, 256))


def test_512_vs_mirror(gpu_device):
    chip_smoke.phase_512((512, 512, 512))
