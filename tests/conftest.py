"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The analog of the reference's hidden-window trick for GPU-less testing
(BVH_intergration_tests.cpp:26-28): sharding/collective code paths are
exercised on ``--xla_force_host_platform_device_count=8`` CPU devices, no
accelerator required.  Must run before the first ``import jax`` anywhere.

``SRT_TEST_GPU=1`` leaves the platform to JAX instead, so the ``gpu``-marked
tests run on a card (README, "Tests and the GPU"); they skip on the CPU.
"""

import os

ON_GPU = os.environ.get("SRT_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import gc  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound jit-cache/buffer growth across the suite.

    Two consecutive full-suite runs on a 2-CPU host died with SIGSEGV at
    ~81/84 tests (~20 min in) while every file passed in isolation —
    accumulated compiled-executable and donated-buffer state across ~80
    jit'd programs.  Dropping compilation caches between test modules keeps
    the peak bounded; per-module (not per-test) so intra-file cache reuse
    (the expensive gradient tests re-jit the same trace repeatedly) is
    preserved.
    """
    yield
    jax.clear_caches()
    gc.collect()
