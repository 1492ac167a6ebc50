"""
Test-global configuration. The platform is pinned by the root conftest.py
(CPU with 8 virtual devices unless ``SMQTK_TESTS_DEVICE=1`` leaves it to
JAX). Tests marked ``gpu`` run a kernel compiled for the card; whether a
GPU is present is decided inside a fixture, at run time, never while a
module is imported.
"""
import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless the default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {platform!r})")


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compile_state():
    """Drop JAX/XLA compilation caches between test modules.

    The ~900-test suite compiles thousands of distinct XLA:CPU programs in a
    single process; retained executables/LLVM JIT state accumulated until the
    CPU backend segfaulted deterministically inside ``backend_compile_and_load``
    at ~88% of the run (rc=139, twice, same stack — see VERDICT round 4).
    Clearing per-module bounds the live compile state; re-compiles of shared
    programs in later modules are cheap relative to the suite.
    """
    yield
    import jax

    jax.clear_caches()
