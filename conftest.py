"""
Root pytest configuration: the doctest pass collects modules from the
``smqtk_indexing_tpu`` package itself (pyproject testpaths), whose imports
touch jax — so the CPU/virtual-device pinning must happen HERE, before any
package module is imported, not only in tests/conftest.py.

By default the suite runs on the CPU backend with 8 virtual devices (the
sharding tests need a mesh; Pallas kernels run in interpret mode). Set
``SMQTK_TESTS_DEVICE=1`` to leave the platform to JAX instead — on a GPU
machine that runs the suite, including the ``gpu``-marked tests, on the
card (``python -m pytest -m gpu tests``).
"""
import os

if not os.environ.get("SMQTK_TESTS_DEVICE"):
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

collect_ignore = ["examples", "tools", "bench.py", "bench_all.py",
                  "__graft_entry__.py", "chip_smoke.py"]
