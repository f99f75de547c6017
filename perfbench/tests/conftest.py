"""Shared fixtures of the benchmark's own tests.

    python -m pytest perfbench/tests -q                 # CPU (card tests skip)
    python -m pytest perfbench/tests -q -m cuda         # on the card

``TINY`` shrinks a configuration to what a CPU test holds (ResNet-50 at
64², batch 2); the card tests run the cells at their own sizes.
"""

from __future__ import annotations

import pytest
import torch

TINY_SIZES = {"backbone": "resnet50", "image_shape": [64, 64, 3], "image_min_dim": 64,
              "image_max_dim": 64, "calib_images": 4, "calib_chunk": 2}
TINY_PARAMS = {"batch": 2, "sample": 4, "ref_block": 2, "warm": 1}


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
