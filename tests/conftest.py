"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is tested with the standard JAX fake
multi-device pattern (SURVEY.md §4 item 4). Must run before jax is
imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


# fixed per-fixture seeds: drawing from the session rng made each test's
# image depend on which tests ran BEFORE it, so failures didn't reproduce
# in isolation (review r3)

@pytest.fixture()
def small_image():
    img = np.random.RandomState(17).rand(24, 32, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


@pytest.fixture()
def small_image_b():
    img = np.random.RandomState(18).rand(24, 32, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


@pytest.fixture()
def while_kernel_interpret(monkeypatch):
    """Run the per-pixel loop kernel (pallas_kernels/while_kernel) in
    Pallas interpret mode for this test: it compiles for a GPU only."""
    from mathmap_tpu.pallas_kernels import while_kernel as WK

    monkeypatch.setattr(WK, "INTERPRET", True)
    return WK
