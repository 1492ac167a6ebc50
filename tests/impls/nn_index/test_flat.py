import random
import unittest

import numpy as np
import pytest

from smqtk_indexing_tpu.core.configuration import configuration_test_helper
from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu.models.nn_index.flat import FlatNearestNeighborsIndex


def _mk(i, vec):
    return DescriptorMemoryElement(i, np.asarray(vec, dtype=np.float32))


class TestFlatPluginAndConfig (unittest.TestCase):

    def test_impl_findable(self) -> None:
        assert FlatNearestNeighborsIndex in \
            NearestNeighborsIndex.get_impls()

    def test_configuration_roundtrip(self) -> None:
        inst = FlatNearestNeighborsIndex(metric="cosine", read_only=True)
        for i in configuration_test_helper(inst):
            assert i.metric == "cosine"
            assert i.read_only is True

    def test_invalid_metric_raises(self) -> None:
        with pytest.raises(ValueError, match="metric"):
            FlatNearestNeighborsIndex(metric="mahalanobis")

    def test_default_config_json_compliant(self) -> None:
        import json
        json.dumps(FlatNearestNeighborsIndex.get_default_config())


class TestFlatBehavior (unittest.TestCase):

    def test_query_is_own_nearest_neighbor(self) -> None:
        rng = np.random.default_rng(0)
        descrs = [_mk(i, rng.normal(size=64)) for i in range(200)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        assert idx.count() == 200
        for q in random.Random(1).sample(descrs, 10):
            ns, ds = idx.nn(q, 3)
            assert ns[0].uuid() == q.uuid()
            assert np.isclose(ds[0], 0.0, atol=1e-4)
            # distances ascending
            assert list(ds) == sorted(ds)

    def test_perturbed_query_retrieves_source(self) -> None:
        rng = np.random.default_rng(2)
        descrs = [_mk(i, rng.normal(size=32)) for i in range(500)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        src = descrs[123]
        q = _mk("q", src.vector() + 0.001 * rng.normal(size=32))
        ns, ds = idx.nn(q, 1)
        assert ns[0].uuid() == 123

    def test_colinear_points_exact_order(self) -> None:
        # Points [j, 2j]: distances from origin-direction query are ordered
        # by j (reference geometry test, test_faiss.py:443-515 family).
        descrs = [_mk(j, [j + 1.0, 2.0 * (j + 1.0)]) for j in range(50)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        q = _mk("q", [0.0, 0.0])
        ns, ds = idx.nn(q, 10)
        assert [n.uuid() for n in ns] == list(range(10))
        assert list(ds) == sorted(ds)

    def test_unit_vectors_all_equidistant(self) -> None:
        dim = 8
        descrs = [_mk(i, np.eye(dim)[i]) for i in range(dim)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        q = _mk("q", np.eye(dim)[0])
        ns, ds = idx.nn(q, dim)
        assert np.isclose(ds[0], 0.0, atol=1e-5)
        np.testing.assert_allclose(ds[1:], np.sqrt(2.0), rtol=1e-5)

    def test_nn_many_matches_single(self) -> None:
        rng = np.random.default_rng(3)
        descrs = [_mk(i, rng.normal(size=16)) for i in range(100)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        qs = descrs[:7]
        batch = idx.nn_many(qs, 4)
        for q, (ns_b, ds_b) in zip(qs, batch):
            ns_s, ds_s = idx.nn(q, 4)
            assert [n.uuid() for n in ns_b] == [n.uuid() for n in ns_s]
            np.testing.assert_allclose(ds_b, ds_s, rtol=1e-5)

    def test_request_more_than_indexed_warns_and_truncates(self) -> None:
        descrs = [_mk(i, [float(i), 0.0]) for i in range(5)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        with pytest.warns(UserWarning):
            ns, ds = idx.nn(descrs[0], 10)
        assert len(ns) == 5

    def test_cosine_metric(self) -> None:
        descrs = [
            _mk("a", [1.0, 0.0]),
            _mk("b", [1.0, 1.0]),
            _mk("c", [0.0, 1.0]),
        ]
        idx = FlatNearestNeighborsIndex(metric="cosine")
        idx.build_index(descrs)
        ns, ds = idx.nn(_mk("q", [2.0, 0.0]), 3)
        assert [n.uuid() for n in ns] == ["a", "b", "c"]
        assert np.isclose(ds[0], 0.0, atol=1e-3)
        assert np.isclose(ds[1], 0.5, atol=1e-3)
        assert np.isclose(ds[2], 1.0, atol=1e-3)

    def test_hik_metric(self) -> None:
        descrs = [
            _mk("a", [0.5, 0.5, 0.0]),
            _mk("b", [0.0, 0.5, 0.5]),
        ]
        idx = FlatNearestNeighborsIndex(metric="hik")
        idx.build_index(descrs)
        ns, ds = idx.nn(_mk("q", [0.5, 0.5, 0.0]), 2)
        assert ns[0].uuid() == "a"
        assert np.isclose(ds[0], 0.0, atol=1e-5)
        assert np.isclose(ds[1], 0.5, atol=1e-5)

    def test_inner_product_metric(self) -> None:
        descrs = [_mk("lo", [1.0, 0.0]), _mk("hi", [10.0, 0.0])]
        idx = FlatNearestNeighborsIndex(metric="inner_product")
        idx.build_index(descrs)
        ns, ds = idx.nn(_mk("q", [1.0, 0.0]), 2)
        assert ns[0].uuid() == "hi"  # larger IP first (dist = -ip)
        assert np.isclose(ds[0], -10.0, atol=1e-4)


class TestFlatMutation (unittest.TestCase):

    def _small_index(self):
        descrs = [_mk(i, [float(i), float(i)]) for i in range(10)]
        idx = FlatNearestNeighborsIndex()
        idx.build_index(descrs)
        return idx, descrs

    def test_rebuild_replaces(self) -> None:
        idx, _ = self._small_index()
        idx.build_index([_mk("only", [5.0, 5.0])])
        assert idx.count() == 1
        ns, _ = idx.nn(_mk("q", [0.0, 0.0]), 1)
        assert ns[0].uuid() == "only"

    def test_update_adds(self) -> None:
        idx, _ = self._small_index()
        idx.update_index([_mk(100, [100.0, 100.0])])
        assert idx.count() == 11
        ns, _ = idx.nn(_mk("q", [101.0, 101.0]), 1)
        assert ns[0].uuid() == 100

    def test_update_on_empty_builds(self) -> None:
        idx = FlatNearestNeighborsIndex()
        idx.update_index([_mk(0, [1.0, 2.0])])
        assert idx.count() == 1

    def test_update_duplicate_uid_skipped_with_warning(self) -> None:
        idx, descrs = self._small_index()
        with pytest.warns(UserWarning, match="already-indexed"):
            idx.update_index([_mk(0, [99.0, 99.0])])
        assert idx.count() == 10
        # Original vector still in place.
        ns, ds = idx.nn(_mk("q", [0.0, 0.0]), 1)
        assert ns[0].uuid() == 0
        assert np.isclose(ds[0], 0.0, atol=1e-5)

    def test_remove(self) -> None:
        idx, descrs = self._small_index()
        idx.remove_from_index([0, 1])
        assert idx.count() == 8
        ns, _ = idx.nn(_mk("q", [0.0, 0.0]), 1)
        assert ns[0].uuid() == 2

    def test_remove_unknown_uid_keyerror_no_mutation(self) -> None:
        idx, _ = self._small_index()
        with pytest.raises(KeyError):
            idx.remove_from_index([5, "nope"])
        assert idx.count() == 10
        # 5 must still be present.
        ns, ds = idx.nn(_mk("q", [5.0, 5.0]), 1)
        assert ns[0].uuid() == 5

    def test_remove_then_re_add(self) -> None:
        idx, descrs = self._small_index()
        idx.remove_from_index([3])
        idx.update_index([descrs[3]])
        assert idx.count() == 10
        ns, _ = idx.nn(descrs[3], 1)
        assert ns[0].uuid() == 3

    def test_remove_all_then_query_raises(self) -> None:
        idx, _ = self._small_index()
        idx.remove_from_index(range(10))
        assert idx.count() == 0
        with pytest.raises(ValueError):
            idx.nn(_mk("q", [0.0, 0.0]))

    def test_read_only_guards(self) -> None:
        descrs = [_mk(i, [float(i)]) for i in range(3)]
        idx = FlatNearestNeighborsIndex(read_only=True)
        with pytest.raises(ReadOnlyError):
            idx.build_index(descrs)
        with pytest.raises(ReadOnlyError):
            idx.update_index(descrs)
        with pytest.raises(ReadOnlyError):
            idx.remove_from_index([0])


class TestFlatPersistence (unittest.TestCase):

    def test_save_load_roundtrip(self) -> None:
        elem = DataMemoryElement()
        rng = np.random.default_rng(5)
        descrs = [_mk(i, rng.normal(size=24)) for i in range(50)]
        idx = FlatNearestNeighborsIndex(index_element=elem)
        idx.build_index(descrs)
        assert not elem.is_empty()

        idx2 = FlatNearestNeighborsIndex(index_element=elem)
        assert idx2.count() == 50
        ns, ds = idx2.nn(descrs[7], 1)
        assert ns[0].uuid() == 7

    def test_persistence_through_update_and_remove(self) -> None:
        elem = DataMemoryElement()
        idx = FlatNearestNeighborsIndex(index_element=elem)
        idx.build_index([_mk(i, [float(i), 1.0]) for i in range(5)])
        idx.update_index([_mk(10, [10.0, 1.0])])
        idx.remove_from_index([0])

        idx2 = FlatNearestNeighborsIndex(index_element=elem)
        assert idx2.count() == 5
        ns, _ = idx2.nn(_mk("q", [10.0, 1.0]), 1)
        assert ns[0].uuid() == 10
        with pytest.raises(KeyError):
            idx2.remove_from_index([0])

    def test_read_only_index_element_raises_on_build(self) -> None:
        elem = DataMemoryElement(readonly=True)
        idx = FlatNearestNeighborsIndex(index_element=elem)
        with pytest.raises(ReadOnlyError):
            idx.build_index([_mk(0, [1.0])])


class TestShardedFlat:
    """Multi-device flat index (n_devices) on the 8-virtual-CPU mesh."""

    def _elems(self, n=200, d=32, seed=0):
        import numpy as np
        from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
        rng = np.random.default_rng(seed)
        return [DescriptorMemoryElement(j, rng.normal(size=d).astype(np.float32))
                for j in range(n)]

    def test_sharded_matches_single(self):
        import numpy as np
        import pytest
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        elems = self._elems()
        single = FlatNearestNeighborsIndex()
        multi = FlatNearestNeighborsIndex(n_devices=8)
        single.build_index(elems)
        multi.build_index(elems)
        for j in (0, 57, 199):
            r1, d1 = single.nn(elems[j], 5)
            r8, d8 = multi.nn(elems[j], 5)
            assert [e.uuid() for e in r8] == [e.uuid() for e in r1]
            np.testing.assert_allclose(d8, d1, atol=1e-5)

    def test_sharded_mutation(self):
        import numpy as np
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
        elems = self._elems(64, 16, seed=1)
        i = FlatNearestNeighborsIndex(n_devices=8)
        i.build_index(elems)
        i.update_index([DescriptorMemoryElement("new", np.full(16, 9.0, np.float32))])
        r, d = i.nn(DescriptorMemoryElement("q", np.full(16, 9.0, np.float32)), 1)
        assert r[0].uuid() == "new"
        i.remove_from_index(["new"])
        r, d = i.nn(DescriptorMemoryElement("q", np.full(16, 9.0, np.float32)), 1)
        assert r[0].uuid() != "new"

    def test_sharded_config_roundtrip(self):
        from smqtk_indexing_tpu.core.configuration import (
            configuration_test_helper,
        )
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        i = FlatNearestNeighborsIndex(n_devices=8)
        for inst in configuration_test_helper(i):
            assert inst.n_devices == 8


class TestBfloat16Storage:
    def test_bf16_self_retrieval_and_order(self):
        import numpy as np
        import pytest
        from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        rng = np.random.default_rng(0)
        elems = [DescriptorMemoryElement(j, rng.normal(size=32).astype(np.float32))
                 for j in range(128)]
        i = FlatNearestNeighborsIndex(dtype="bfloat16")
        i.build_index(elems)
        res, dists = i.nn(elems[7], 5)
        assert res[0].uuid() == 7
        # bf16 storage quantizes coordinates; self-distance is small, not 0.
        assert dists[0] == pytest.approx(0.0, abs=5e-2)
        assert list(dists) == sorted(dists)

    def test_invalid_dtype(self):
        import pytest
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        with pytest.raises(ValueError):
            FlatNearestNeighborsIndex(dtype="float16")


class TestFactoryString:
    def test_sqfp16_maps_to_bfloat16(self):
        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        assert index_from_factory_string("SQfp16").dtype == "bfloat16"
        i = index_from_factory_string("IVF8,SQfp16")
        assert i.dtype == "bfloat16" and i.n_lists == 8

    def test_sq4_sq6_rejected(self):
        import pytest

        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        for s in ("SQ4", "SQ6", "IVF8,SQ4"):
            with pytest.raises(ValueError, match="scalar quantizers"):
                index_from_factory_string(s)

    def test_flat(self):
        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        i = index_from_factory_string("IDMap,Flat")
        assert isinstance(i, FlatNearestNeighborsIndex)
        assert i.metric == "euclidean"
        i2 = index_from_factory_string("Flat", metric="ip")
        assert i2.metric == "inner_product"

    def test_ivf(self):
        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        from smqtk_indexing_tpu.models.nn_index.ivf import (
            IvfNearestNeighborsIndex,
        )
        i = index_from_factory_string("IVF4096,Flat", nprobe=32)
        assert isinstance(i, IvfNearestNeighborsIndex)
        assert i.n_lists == 4096
        assert i.nprobe == 32

    def test_unsupported(self):
        import pytest
        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        with pytest.raises(ValueError):
            index_from_factory_string("HNSW32,Flat")
        with pytest.raises(ValueError):
            index_from_factory_string("Flat", metric="hamming")


def test_remove_then_re_add():
    # Reference behavior (test_faiss.py:359): a removed UID can be re-added.
    import numpy as np
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    elems = [DescriptorMemoryElement(j, np.asarray([j, j], np.float32))
             for j in range(8)]
    i = FlatNearestNeighborsIndex()
    i.build_index(elems)
    i.remove_from_index([3])
    assert i.count() == 7
    i.update_index([elems[3]])
    assert i.count() == 8
    r, d = i.nn(elems[3], 1)
    assert r[0].uuid() == 3 and d[0] == 0.0


def test_all_impl_configs_json_serializable():
    import json
    from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
        NearestNeighborsIndex,
    )
    from smqtk_indexing_tpu.interfaces.hash_index import HashIndex
    from smqtk_indexing_tpu.interfaces.lsh_functor import LshFunctor
    for iface in (NearestNeighborsIndex, HashIndex, LshFunctor):
        for impl in iface.get_impls():
            json.dumps(impl.get_default_config())


def test_remove_duplicate_uids_no_corruption():
    # Review regression: [5, 5] must remove once, cleanly (no KeyError
    # mid-mutation, no double-decrement of the live count).
    import numpy as np
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    elems = [DescriptorMemoryElement(j, np.asarray([j, j], np.float32))
             for j in range(8)]
    i = FlatNearestNeighborsIndex()
    i.build_index(elems)
    i.remove_from_index([5, 5])
    assert i.count() == 7
    r, d = i.nn(elems[5], 1)
    assert r[0].uuid() != 5
    # Re-adding works and produces exactly one row.
    i.update_index([elems[5]])
    assert i.count() == 8
    r, d = i.nn(elems[5], 2)
    assert r[0].uuid() == 5 and d[0] == 0.0 and r[1].uuid() != 5


def test_fused_mirror_is_metric_keyed(monkeypatch):
    # The two-stage scan's stage 1 ranks cosine on normalized rows: a
    # store queried with alternating metrics must serve each query by its
    # own metric (forced onto the two-stage path, which the GPU takes),
    # matching the streaming scan.
    import numpy as np
    from smqtk_indexing_tpu.ops.store import VectorStore

    rng = np.random.default_rng(0)
    mat = rng.normal(size=(5000, 8)).astype(np.float32) * 3
    ref = VectorStore()
    ref.build(mat, list(range(5000)))
    monkeypatch.setattr(VectorStore, "_two_stage_eligible",
                        lambda self, metric: True)
    vs = VectorStore()
    vs.build(mat, list(range(5000)))
    for metric in ("euclidean", "cosine", "euclidean"):
        d2, _, r2 = vs.knn(mat[:4], 5, metric=metric)
        monkeypatch.setattr(VectorStore, "_two_stage_eligible",
                            lambda self, metric: False)
        d1, _, r1 = ref.knn(mat[:4], 5, metric=metric)
        monkeypatch.setattr(VectorStore, "_two_stage_eligible",
                            lambda self, metric: True)
        assert np.array_equal(r2, r1), metric
        np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-5)


class TestSq8Storage:
    def test_sq8_self_retrieval_and_persistence(self):
        import numpy as np
        import pytest
        from smqtk_indexing_tpu.data.data_element import DataMemoryElement
        from smqtk_indexing_tpu.data.descriptor import (
            DescriptorMemoryElement,
        )
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        rng = np.random.default_rng(0)
        elems = [DescriptorMemoryElement(
                     j, rng.normal(size=32).astype(np.float32))
                 for j in range(256)]
        ie = DataMemoryElement()
        i = FlatNearestNeighborsIndex(dtype="sq8", index_element=ie)
        i.build_index(elems)
        res, dists = i.nn(elems[7], 5)
        assert res[0].uuid() == 7
        # sq8 quantizes coordinates; self-distance small, not 0.
        assert dists[0] == pytest.approx(0.0, abs=0.2)
        assert list(dists) == sorted(dists)
        # update + remove keep working on the quantized store
        i.update_index([DescriptorMemoryElement(
            999, rng.normal(size=32).astype(np.float32))])
        i.remove_from_index([0])
        assert i.count() == 256
        # reload via persisted payload
        j = FlatNearestNeighborsIndex(dtype="sq8", index_element=ie)
        assert j.count() == 256
        res2, _ = j.nn(elems[7], 1)
        assert res2[0].uuid() == 7

    def test_sq8_config_roundtrip(self):
        from smqtk_indexing_tpu.core.configuration import (
            configuration_test_helper,
        )
        from smqtk_indexing_tpu.models.nn_index.flat import (
            FlatNearestNeighborsIndex,
        )
        i = FlatNearestNeighborsIndex(dtype="sq8")
        for inst in configuration_test_helper(i):
            assert inst.dtype == "sq8"
