"""
AutotunedNearestNeighborsIndex tests: FLANN-wrapper parity surface
(/root/reference/tests/impls/nn_index/test_flann.py:143-223 behavioral
patterns) plus calibration behavior of the device autotuner.
"""
import numpy as np
import pytest

from smqtk_indexing_tpu.core.configuration import configuration_test_helper
from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu.models.nn_index.autotune import (
    AutotunedNearestNeighborsIndex,
)


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


class TestAutotunedIndex:
    def test_plugin_discoverable(self):
        assert AutotunedNearestNeighborsIndex \
            in NearestNeighborsIndex.get_impls()

    def test_configuration_roundtrip(self):
        i = AutotunedNearestNeighborsIndex(
            autotune=True, target_precision=0.9, sample_fraction=0.2,
            distance_method="hik", random_seed=3)
        for inst in configuration_test_helper(i):
            assert isinstance(inst, AutotunedNearestNeighborsIndex)
            assert inst.autotune is True
            assert inst.target_precision == 0.9
            assert inst.distance_method == "hik"

    def test_invalid_distance(self):
        with pytest.raises(ValueError):
            AutotunedNearestNeighborsIndex(distance_method="bogus")

    def test_invalid_precision(self):
        with pytest.raises(ValueError):
            AutotunedNearestNeighborsIndex(target_precision=0.0)

    def test_exact_euclidean(self):
        rng = np.random.default_rng(0)
        elems = [_elem(j, rng.normal(size=16)) for j in range(128)]
        i = AutotunedNearestNeighborsIndex(distance_method="euclidean")
        i.build_index(elems)
        res, dists = i.nn(elems[5], 3)
        assert res[0].uuid() == 5
        assert res[0] is elems[5]
        assert dists[0] == pytest.approx(0.0, abs=1e-5)

    def test_hik_histograms(self):
        # HIK over normalized histograms (the reference FLANN default
        # distance, flann.py:96-100).
        rng = np.random.default_rng(1)
        hists = rng.random((64, 32)).astype(np.float32)
        hists /= hists.sum(axis=1, keepdims=True)
        elems = [_elem(j, h) for j, h in enumerate(hists)]
        i = AutotunedNearestNeighborsIndex(distance_method="hik")
        i.build_index(elems)
        res, dists = i.nn(elems[10], 5)
        assert res[0].uuid() == 10
        assert dists[0] == pytest.approx(0.0, abs=1e-5)
        assert all(0.0 <= d <= 1.0 + 1e-5 for d in dists)
        assert list(dists) == sorted(dists)

    def test_chi_square(self):
        rng = np.random.default_rng(2)
        hists = rng.random((64, 32)).astype(np.float32)
        elems = [_elem(j, h) for j, h in enumerate(hists)]
        i = AutotunedNearestNeighborsIndex(distance_method="chi_square")
        i.build_index(elems)
        res, dists = i.nn(elems[20], 3)
        assert res[0].uuid() == 20
        assert dists[0] == pytest.approx(0.0, abs=1e-5)

    def test_small_data_stays_exact_even_with_autotune(self):
        rng = np.random.default_rng(3)
        elems = [_elem(j, rng.normal(size=8)) for j in range(64)]
        i = AutotunedNearestNeighborsIndex(
            autotune=True, target_precision=0.5, random_seed=0)
        i.build_index(elems)
        assert i._ivf is None  # below the IVF threshold
        res, _ = i.nn(elems[0], 1)
        assert res[0].uuid() == 0

    def test_autotune_calibrates_ivf(self):
        # Clustered data big enough to cross the IVF threshold; the tuner
        # must pick an nprobe meeting the precision target.
        rng = np.random.default_rng(4)
        centers = rng.normal(size=(64, 16)) * 10
        elems = [_elem(f"{c}-{j}",
                       centers[c] + rng.normal(size=16) * 0.3)
                 for c in range(64) for j in range(80)]
        i = AutotunedNearestNeighborsIndex(
            autotune=True, target_precision=0.9, sample_fraction=0.05,
            random_seed=0)
        i.build_index(elems)
        assert i._ivf is not None
        assert i._tuned_nprobe is not None
        # Queries go through the tuned engine and return originals.
        res, dists = i.nn(elems[0], 5)
        assert res[0].uuid() == elems[0].uuid()
        assert dists[0] == pytest.approx(0.0, abs=1e-4)

    def test_update_and_remove(self):
        rng = np.random.default_rng(5)
        elems = [_elem(j, rng.normal(size=8)) for j in range(32)]
        i = AutotunedNearestNeighborsIndex()
        i.build_index(elems[:16])
        i.update_index(elems[16:])
        assert i.count() == 32
        i.remove_from_index([0, 1])
        assert i.count() == 30
        with pytest.raises(KeyError):
            i.remove_from_index([0])

    def test_persistence_roundtrip(self):
        cache = DataMemoryElement()
        rng = np.random.default_rng(6)
        elems = [_elem(j, rng.normal(size=8)) for j in range(32)]
        i = AutotunedNearestNeighborsIndex(index_element=cache)
        i.build_index(elems)
        i2 = AutotunedNearestNeighborsIndex(index_element=cache)
        assert i2.count() == 32
        res, dists = i2.nn(elems[3], 1)
        assert res[0].uuid() == 3


def test_autotune_retunes_after_mutation():
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(64, 16)) * 10
    elems = [_elem(f"{c}-{j}", centers[c] + rng.normal(size=16) * 0.3)
             for c in range(64) for j in range(80)]
    i = AutotunedNearestNeighborsIndex(
        autotune=True, target_precision=0.9, sample_fraction=0.05,
        random_seed=0)
    i.build_index(elems)
    assert i._ivf is not None
    # Removing most of the data drops below the IVF threshold: the tuner
    # must fall back to exact scans.
    i.remove_from_index([e.uuid() for e in elems[640:]])
    assert i.count() == 640
    assert i._ivf is None
    res, d = i.nn(elems[0], 1)
    assert res[0].uuid() == elems[0].uuid()
