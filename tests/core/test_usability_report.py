"""Honest availability reporting: is_usable() + usability_report().

The reference gates backends on importability
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:86-89); since the
compute stack here always imports, the operator-facing signal lives in
``usability_report()`` — kernel tier (compiled GPU vs interpret fallback),
env-flag-disabled engines, and a summary ``degraded`` bool.
"""
import jax
import pytest

from smqtk_indexing_tpu.core.plugin import Pluggable
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu.interfaces.hash_index import HashIndex
from smqtk_indexing_tpu.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)


def test_every_impl_reports():
    for iface in (NearestNeighborsIndex, HashIndex):
        for impl in iface.get_impls():
            if not impl.__module__.startswith("smqtk_indexing_tpu."):
                continue  # test-local dummy plugins from other modules
            r = impl.usability_report()
            assert r["class"] == impl.__name__
            assert r["usable"] is True
            # Compute-backed impls must expose the tier signal.
            assert r["kernel_tier"] in ("gpu-triton", "cpu-interpret")
            assert isinstance(r["degraded"], bool)


def test_kernel_tier_matches_backend():
    r = FlatNearestNeighborsIndex.usability_report()
    if jax.default_backend() == "gpu":
        assert r["kernel_tier"] == "gpu-triton"
    else:
        assert r["kernel_tier"] == "cpu-interpret"
        assert r["degraded"] is True
    assert r["backend"] == jax.default_backend()
    assert r["devices"] == len(jax.devices())


def test_forced_fallback_is_observable(monkeypatch):
    # Kill an engine via its env flag: the report must surface the flag
    # and flip degraded, matching what the serving path actually does
    # (the native host scan reads the same variable).
    monkeypatch.setenv("SMQTK_TPU_NO_NATIVE", "1")
    r = FlatNearestNeighborsIndex.usability_report()
    assert "SMQTK_TPU_NO_NATIVE" in r["disabled_flags"]
    assert r["degraded"] is True
    monkeypatch.delenv("SMQTK_TPU_NO_NATIVE")
    r2 = FlatNearestNeighborsIndex.usability_report()
    assert r2["disabled_flags"] == []


def test_base_default_report():
    class Dummy(Pluggable):
        pass

    r = Dummy.usability_report()
    assert r == {"class": "Dummy", "usable": True}
