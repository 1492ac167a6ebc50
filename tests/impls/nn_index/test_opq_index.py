"""
OPQ dtype ('opq<M>' — the reference's FAISS 'OPQ<M>,...' rotation
pre-transform, faiss.py:182-199) across the index tiers: flat store,
IVF rows tier (XLA scan + forced tiled routing), IVF code tier with
rotation persistence, and the factory grammar.
"""
import json
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu.models.nn_index.flat import FlatNearestNeighborsIndex
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _correlated_elems(n=600, d=16, r=4, seed=0):
    """Low-intrinsic-dim rows — the regime OPQ exists for."""
    rng = np.random.default_rng(seed)
    centers = rng.random((64, r), dtype=np.float32)
    w = rng.standard_normal((r, d)).astype(np.float32) / np.sqrt(r)
    z = centers[rng.integers(0, 64, size=n)]
    z = z + rng.normal(size=(n, r)).astype(np.float32) / 12
    x = z @ w + rng.normal(size=(n, d)).astype(np.float32) * 0.02
    return [_elem(i, x[i]) for i in range(n)], x


def _query(idx, vec, k=5):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return idx.nn(_elem("q", vec), k)


class TestFactoryOpq:
    def test_flat_form(self):
        idx = index_from_factory_string("OPQ4,PQ4")
        assert isinstance(idx, FlatNearestNeighborsIndex)
        assert idx.dtype == "opq4"

    def test_ivf_form(self):
        idx = index_from_factory_string("OPQ4,IVF8,PQ4")
        assert isinstance(idx, IvfNearestNeighborsIndex)
        assert idx.dtype == "opq4" and idx.n_lists == 8

    def test_ivf_code_form(self):
        idx = index_from_factory_string("OPQ4,IVF8,PQ4", storage="code")
        assert idx.storage == "code" and idx.dtype == "opq4"

    def test_mismatched_m(self):
        with pytest.raises(ValueError, match="match"):
            index_from_factory_string("OPQ4,IVF8,PQ8")

    def test_opq_without_pq(self):
        with pytest.raises(ValueError, match="pre-transform"):
            index_from_factory_string("OPQ4,Flat")

    def test_dim_reducing_form_rejected(self):
        with pytest.raises(ValueError, match="dimension-reducing"):
            index_from_factory_string("OPQ8_64,PQ8")


class TestFlatOpq:
    def test_build_query_roundtrip(self):
        elems, x = _correlated_elems()
        idx = FlatNearestNeighborsIndex(dtype="opq4")
        idx.build_index(elems)
        nbrs, dists = _query(idx, x[7])
        assert nbrs[0].uuid() == 7
        assert list(dists) == sorted(dists)
        cfg = json.loads(json.dumps(idx.get_config()))
        idx2 = FlatNearestNeighborsIndex.from_config(cfg)
        assert idx2.dtype == "opq4"

    def test_hik_rejected(self):
        with pytest.raises(ValueError, match="hik"):
            FlatNearestNeighborsIndex(dtype="opq4", metric="hik")

    def test_opq_beats_pq_recall_on_correlated_data(self):
        """The point of the feature: at equal bytes/vector the rotated
        codec returns measurably better neighbors on correlated data."""
        elems, x = _correlated_elems(n=2000, d=64, r=4, seed=1)
        q = np.asarray(
            _correlated_elems(n=64, d=64, r=4, seed=99)[1])
        d2 = ((q[:, None, :].astype(np.float64)
               - x[None, :, :].astype(np.float64)) ** 2).sum(-1)
        truth = np.argsort(d2, axis=1)[:, :10]

        def recall(dtype):
            idx = FlatNearestNeighborsIndex(dtype=dtype)
            idx.build_index(elems)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = idx.nn_many([_elem(f"q{i}", q[i])
                                   for i in range(len(q))], 10)
            return np.mean([
                len({e.uuid() for e in r[0]} & set(t.tolist())) / 10.0
                for r, t in zip(res, truth)])

        r_pq, r_opq = recall("pq8"), recall("opq8")
        # Measured margin ~+0.08 in this regime (64-d, 4-intrinsic-dim);
        # +0.03 keeps headroom for k-means tie noise.
        assert r_opq > r_pq + 0.03, (r_pq, r_opq)

    def test_update_encodes_with_build_rotation(self):
        elems, x = _correlated_elems()
        idx = FlatNearestNeighborsIndex(dtype="opq4")
        idx.build_index(elems[:500])
        idx.update_index(elems[500:])
        nbrs, _ = _query(idx, x[550])
        assert nbrs[0].uuid() == 550


class TestShardedOpq:
    def test_sharded_flat_matches_single(self):
        """OPQ on the 8-virtual-device mesh: the rotation trains on host
        before sharding, so per-shard scans + merge must reproduce the
        single-device results exactly."""
        elems, x = _correlated_elems(n=400)
        single = FlatNearestNeighborsIndex(dtype="opq4")
        multi = FlatNearestNeighborsIndex(dtype="opq4", n_devices=8)
        single.build_index(elems)
        multi.build_index(elems)
        for qi in (0, 123, 399):
            n1, d1 = _query(single, x[qi])
            n8, d8 = _query(multi, x[qi])
            assert [e.uuid() for e in n8] == [e.uuid() for e in n1]
            np.testing.assert_allclose(d8, d1, atol=1e-5)


class TestIvfOpqRows:
    def _index(self, **kw):
        kw.setdefault("n_lists", 4)
        kw.setdefault("nprobe", 4)
        kw.setdefault("kmeans_iterations", 4)
        kw.setdefault("random_seed", 0)
        kw.setdefault("dtype", "opq4")
        return IvfNearestNeighborsIndex(**kw)

    def test_build_query(self):
        elems, x = _correlated_elems()
        idx = self._index()
        idx.build_index(elems)
        nbrs, _ = _query(idx, x[3])
        assert nbrs[0].uuid() == 3

    def test_forced_tiled_routing_parity(self, monkeypatch):
        """The tiled ADC scan (storage='code') finds the same winners as
        the rows tier's row-major XLA scan over the same data."""
        elems, x = _correlated_elems()
        idx_x = self._index()
        idx_x.build_index(elems)
        idx_t = self._index(storage="code")
        idx_t.build_index(elems)
        assert idx_t._dev3 is not None     # tiled engine
        assert idx_x._dev3 is None
        for qi in (3, 17, 101):
            n_x, d_x = _query(idx_x, x[qi])
            n_t, d_t = _query(idx_t, x[qi])
            assert n_x[0].uuid() == n_t[0].uuid() == qi
            ids_x = {e.uuid() for e in n_x}
            ids_t = {e.uuid() for e in n_t}
            assert len(ids_x & ids_t) >= 4, (qi, ids_x, ids_t)
            np.testing.assert_allclose(d_x[0], d_t[0], rtol=1e-3,
                                       atol=1e-3)


class TestIvfOpqCode:
    def _index(self, **kw):
        kw.setdefault("n_lists", 4)
        kw.setdefault("nprobe", 4)
        kw.setdefault("kmeans_iterations", 4)
        kw.setdefault("random_seed", 0)
        return IvfNearestNeighborsIndex(dtype="opq4", storage="code",
                                        **kw)

    def test_host_mirror_is_codes_and_rotation_trained(self):
        elems, _ = _correlated_elems()
        idx = self._index()
        idx.build_index(elems)
        assert idx._host.dtype == np.uint8
        assert idx._host.shape[1] == 4
        assert idx._code_rot is not None
        d_codec = idx._code_rot.shape[0]
        assert np.abs(idx._code_rot.T @ idx._code_rot
                      - np.eye(d_codec)).max() < 1e-4
        # The kernel transform is the composed 2-D matrix.
        assert idx._perm_dev.ndim == 2

    def test_self_retrieval(self):
        elems, x = _correlated_elems()
        idx = self._index()
        idx.build_index(elems)
        for qi in (0, 42, 311):
            nbrs, dists = _query(idx, x[qi])
            assert nbrs[0].uuid() == qi
            assert list(dists) == sorted(dists)

    def test_persistence_roundtrip_with_rotation(self):
        elems, x = _correlated_elems()
        el = DataMemoryElement(readonly=False)
        idx = self._index(index_element=el)
        idx.build_index(elems)
        ref = [(e.uuid() for e in _query(idx, x[i])[0]) for i in (5, 99)]
        ref = [list(g) for g in ref]
        idx2 = self._index(index_element=el)
        assert idx2.count() == idx.count()
        assert idx2._code_rot is not None
        np.testing.assert_array_equal(idx2._code_rot, idx._code_rot)
        for want, qi in zip(ref, (5, 99)):
            got = [e.uuid() for e in _query(idx2, x[qi])[0]]
            assert got == want

    def test_update_after_reload_uses_persisted_rotation(self):
        elems, x = _correlated_elems()
        el = DataMemoryElement(readonly=False)
        idx = self._index(index_element=el)
        idx.build_index(elems[:500])
        idx2 = self._index(index_element=el)
        idx2.update_index(elems[500:])
        nbrs, _ = _query(idx2, x[555])
        assert nbrs[0].uuid() == 555

    def test_cross_load_into_rows_instance_decodes_back(self):
        """A rotated-code payload loaded by a float32 'rows' instance
        decodes through R^T + inverse interleave: reconstructions live
        in the ORIGINAL dim order (codec loss only)."""
        elems, x = _correlated_elems()
        el = DataMemoryElement(readonly=False)
        idx = self._index(index_element=el)
        idx.build_index(elems)
        rows = IvfNearestNeighborsIndex(
            n_lists=4, nprobe=4, kmeans_iterations=4, random_seed=0,
            dtype="float32", storage="rows", index_element=el)
        assert rows.count() == len(elems)
        # Reconstruction error in the original space is bounded by the
        # codec, far below the data scale (not garbage / wrong basis).
        # _host rows are LIST-SORTED — map back through _row2uid.
        orig = x[np.asarray(rows._row2uid, dtype=np.int64)]
        errs = np.sqrt(((rows._host - orig) ** 2).sum(-1))
        assert float(np.median(errs)) < 0.5 * float(
            np.median(np.sqrt((x ** 2).sum(-1))))
        nbrs, _ = _query(rows, x[8])
        assert nbrs[0].uuid() == 8
