"""
Residual IVF-PQ (``pq_residual=True`` — FAISS's ``by_residual`` IVF-PQ
behavior, the reference's default for index_factory 'IVF<n>,PQ<M>'):
codes quantize ``x - centroid(list)``. Covers exactness w.r.t. the
(c + r_hat) reconstruction, the recall gain on clustered data, every
serving path (rows-tier XLA scan, tiled ADC scan of the code tier,
exact + score), persistence, updates, and the OPQ composition.
"""
import json
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _clustered(n=2000, d=32, n_clusters=32, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.random((n_clusters, d), dtype=np.float32) * 10
    x = centers[rng.integers(0, n_clusters, size=n)] \
        + rng.normal(size=(n, d)).astype(np.float32) * noise
    return x


def _index(**kw):
    kw.setdefault("n_lists", 8)
    kw.setdefault("nprobe", 8)
    kw.setdefault("kmeans_iterations", 5)
    kw.setdefault("random_seed", 0)
    kw.setdefault("dtype", "pq8")
    kw.setdefault("pq_residual", True)
    return IvfNearestNeighborsIndex(**kw)


def _query(idx, vec, k=5):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return idx.nn(_elem("q", vec), k)


class TestFactoryDefault:
    def test_ivf_pq_factory_defaults_to_residual(self):
        """FAISS's index_factory('IVF<n>,PQ<M>') builds by_residual=True
        on L2 — the grammar must match; explicit kwargs and non-L2
        metrics opt out."""
        from smqtk_indexing_tpu.models.nn_index.factory import (
            index_from_factory_string,
        )
        assert index_from_factory_string("IVF8,PQ4").pq_residual is True
        assert index_from_factory_string(
            "OPQ4,IVF8,PQ4").pq_residual is True
        assert index_from_factory_string(
            "IVF8,PQ4", pq_residual=False).pq_residual is False
        assert index_from_factory_string(
            "IVF8,PQ4", metric="ip").pq_residual is False
        # Cosine defaults to residual ON the code tier only (round 5).
        assert index_from_factory_string(
            "IVF8,PQ4", metric="cosine",
            storage="code").pq_residual is True
        assert index_from_factory_string(
            "IVF8,PQ4", metric="cosine").pq_residual is False
        # Flat PQ has no lists to residualize against.
        assert index_from_factory_string("PQ4").get_config().get(
            "pq_residual") is None


class TestValidation:
    def test_requires_pq_dtype(self):
        with pytest.raises(ValueError, match="PQ dtype"):
            IvfNearestNeighborsIndex(dtype="sq8", pq_residual=True)

    def test_metric_matrix(self):
        # cosine residual exists ONLY on the code tier (unit-sphere
        # codes); rows-tier cosine and inner_product stay rejected.
        with pytest.raises(ValueError, match="storage='code'"):
            IvfNearestNeighborsIndex(dtype="pq8", pq_residual=True,
                                     metric="cosine")
        with pytest.raises(ValueError, match="inner_product"):
            IvfNearestNeighborsIndex(dtype="pq8", pq_residual=True,
                                     metric="inner_product",
                                     storage="code")
        idx = IvfNearestNeighborsIndex(dtype="pq8", pq_residual=True,
                                       metric="cosine", storage="code")
        assert idx.pq_residual is True

    def test_multi_device_accepted(self):
        idx = IvfNearestNeighborsIndex(dtype="pq8", pq_residual=True,
                                       n_devices=4)
        assert idx.pq_residual is True

    def test_config_roundtrip(self):
        idx = _index()
        cfg = json.loads(json.dumps(idx.get_config()))
        idx2 = IvfNearestNeighborsIndex.from_config(cfg)
        assert idx2.pq_residual is True


def _exact_recon_dists(idx, q):
    """float64 distances from q to the index's OWN reconstructions
    (c_T + r_hat mapped back to original dims via _row_vector)."""
    rec = np.stack([idx._row_vector(i)
                    for i in range(idx._host.shape[0])])
    return np.sqrt(((q.astype(np.float64)
                     - rec.astype(np.float64)) ** 2).sum(-1))


class TestExactness:
    def test_distances_exact_vs_reconstruction_full_probe(self):
        """At full probe, rows == float64 brute force over the residual
        reconstructions and reported distances match — the codec is the
        only loss (FAISS IVF-PQ contract). Code tier: _row_vector IS the
        decode (the rows tier keeps raw floats there)."""
        x = _clustered(n=800)
        idx = _index(nprobe=8, storage="code")
        idx.build_index([_elem(i, x[i]) for i in range(len(x))])
        uid_of_row = list(idx._row2uid)
        rng = np.random.default_rng(7)
        for qv in x[rng.choice(len(x), 5, replace=False)]:
            d64 = _exact_recon_dists(idx, qv)
            want = {uid_of_row[r] for r in np.argsort(d64)[:5]}
            nbrs, dists = _query(idx, qv, 5)
            got = [e.uuid() for e in nbrs]
            # near-tie tolerance at the k boundary
            assert len(set(got) & want) >= 4, (got, want)
            row_of_uid = {u: r for r, u in enumerate(uid_of_row)}
            ref = np.sort(d64[[row_of_uid[u] for u in got]])
            np.testing.assert_allclose(dists, ref, rtol=1e-4, atol=1e-4)

    def test_forced_tiled_routing_parity(self, monkeypatch):
        # Residual PQ through the tiled scan (storage='code') against the
        # rows tier's row-major XLA scan over the same data.
        x = _clustered(n=1200)
        idx_x = _index()
        idx_x.build_index([_elem(i, x[i]) for i in range(len(x))])
        idx_t = _index(storage="code")
        idx_t.build_index([_elem(i, x[i]) for i in range(len(x))])
        assert idx_t._dev3 is not None and idx_x._dev3 is None
        assert idx_t._row2list_dev is not None
        for qi in (3, 700):
            n_x, d_x = _query(idx_x, x[qi])
            n_t, d_t = _query(idx_t, x[qi])
            ids_x = [e.uuid() for e in n_x]
            ids_t = [e.uuid() for e in n_t]
            assert len(set(ids_x) & set(ids_t)) >= 4, (ids_x, ids_t)
            np.testing.assert_allclose(d_x[0], d_t[0], rtol=1e-3,
                                       atol=1e-3)

    def test_code_tier_score_mode_consistent(self):
        x = _clustered(n=1200)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx_e = _index(storage="code", rerank="exact")
        idx_e.build_index(els)
        idx_s = _index(storage="code", rerank="score")
        idx_s.build_index(els)
        for qi in (10, 500):
            n_e, d_e = _query(idx_e, x[qi])
            n_s, d_s = _query(idx_s, x[qi])
            assert n_e[0].uuid() == n_s[0].uuid()
            np.testing.assert_allclose(d_e[0], d_s[0], rtol=5e-3,
                                       atol=5e-3)


class TestShardedRows:
    def test_sharded_rows_residual_matches_single_device(self):
        """Rows-tier residual PQ over an 8-device mesh: per-shard scans
        carry the same -2<q,c> probe offsets and row-local centroid
        re-adds, so full-probe results agree with the single-device
        path (near-tie order tolerance at the k boundary only)."""
        x = _clustered(n=1600)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx1 = _index()
        idx1.build_index(els)
        idx8 = _index(n_devices=8)
        idx8.build_index(els)
        assert idx8._mesh is not None
        assert idx8._row2list_dev is not None
        for qi in (3, 444, 1200):
            n1, d1 = _query(idx1, x[qi])
            n8, d8 = _query(idx8, x[qi])
            ids1 = [e.uuid() for e in n1]
            ids8 = [e.uuid() for e in n8]
            assert len(set(ids1) & set(ids8)) >= 4, (ids1, ids8)
            np.testing.assert_allclose(d8[0], d1[0], rtol=1e-4,
                                       atol=1e-4)


class TestRecallGain:
    def test_residual_beats_raw_on_clustered_data(self):
        """The point of the feature: with lists aligned to cluster
        structure, quantizing residuals instead of raw rows lifts
        recall at identical bytes/vector."""
        rng = np.random.default_rng(1)
        n, d, c = 4000, 32, 64
        centers = rng.random((c, d), dtype=np.float32) * 10
        x = centers[rng.integers(0, c, size=n)] \
            + rng.normal(size=(n, d)).astype(np.float32) * 0.8
        q = centers[rng.integers(0, c, size=32)] \
            + rng.normal(size=(32, d)).astype(np.float32) * 0.8
        els = [_elem(i, x[i]) for i in range(n)]
        d2 = ((q[:, None].astype(np.float64)
               - x[None].astype(np.float64)) ** 2).sum(-1)
        truth = np.argsort(d2, 1)[:, :10]

        def recall(residual):
            idx = _index(n_lists=64, nprobe=64, kmeans_iterations=8,
                         pq_residual=residual)
            idx.build_index(els)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = idx.nn_many([_elem(f"q{i}", q[i])
                                   for i in range(32)], 10)
            return np.mean([
                len({e.uuid() for e in r[0]} & set(t.tolist())) / 10.0
                for r, t in zip(res, truth)])

        r_raw, r_res = recall(False), recall(True)
        assert r_res > r_raw + 0.1, (r_raw, r_res)


class TestCosineResidual:
    """Round-5 cell: cosine + pq_residual on the code tier (the L2
    residual pipeline over unit-sphere codes IS cosine ranking)."""

    def test_full_probe_matches_angular_oracle_on_reconstructions(self):
        """At full probe, results match a float64 angular oracle over
        the index's OWN reconstructions (codec is the only loss), and
        reported distances are the angular 2*arccos(sim)/pi values."""
        x = _clustered(n=800)
        idx = _index(storage="code", metric="cosine")
        idx.build_index([_elem(i, x[i]) for i in range(len(x))])
        uid_of_row = list(idx._row2uid)
        rec = np.stack([idx._row_vector(i)
                        for i in range(idx._host.shape[0])]
                       ).astype(np.float64)
        rec_n = rec / np.maximum(
            np.linalg.norm(rec, axis=1, keepdims=True), 1e-30)
        rng = np.random.default_rng(7)
        for qv in x[rng.choice(len(x), 5, replace=False)]:
            qn = qv.astype(np.float64)
            qn = qn / max(np.linalg.norm(qn), 1e-30)
            sim = np.clip(rec_n @ qn, -1.0, 1.0)
            d64 = 2.0 * np.arccos(sim) / np.pi
            want = {uid_of_row[r] for r in np.argsort(d64)[:5]}
            nbrs, dists = _query(idx, qv, 5)
            got = [e.uuid() for e in nbrs]
            assert len(set(got) & want) >= 4, (got, want)
            row_of_uid = {u: r for r, u in enumerate(uid_of_row)}
            ref = np.sort(d64[[row_of_uid[u] for u in got]])
            np.testing.assert_allclose(dists, ref, rtol=1e-3, atol=1e-3)

    def test_score_mode_consistent(self):
        x = _clustered(n=1200)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx_e = _index(storage="code", metric="cosine", rerank="exact")
        idx_e.build_index(els)
        idx_s = _index(storage="code", metric="cosine", rerank="score")
        idx_s.build_index(els)
        for qi in (10, 500):
            n_e, d_e = _query(idx_e, x[qi])
            n_s, d_s = _query(idx_s, x[qi])
            assert n_e[0].uuid() == n_s[0].uuid()
            np.testing.assert_allclose(d_e[0], d_s[0], rtol=5e-3,
                                       atol=5e-3)

    def test_sharded_matches_single_device(self):
        x = _clustered(n=1600)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx1 = _index(storage="code", metric="cosine")
        idx1.build_index(els)
        idx8 = _index(storage="code", metric="cosine", n_devices=8)
        idx8.build_index(els)
        assert idx8._mesh is not None
        for qi in (3, 444, 1200):
            n1, d1 = _query(idx1, x[qi])
            n8, d8 = _query(idx8, x[qi])
            ids1 = [e.uuid() for e in n1]
            ids8 = [e.uuid() for e in n8]
            assert len(set(ids1) & set(ids8)) >= 4, (ids1, ids8)
            np.testing.assert_allclose(d8[0], d1[0], rtol=1e-4,
                                       atol=1e-4)

    def test_cosine_residual_beats_raw_on_clustered_sphere(self):
        """The recall lever carries to the angular metric: clustered
        directions quantize better as residuals at identical bytes."""
        rng = np.random.default_rng(1)
        n, d, c = 4000, 32, 64
        centers = rng.normal(size=(c, d)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        x = centers[rng.integers(0, c, size=n)] \
            + rng.normal(size=(n, d)).astype(np.float32) * 0.15
        q = centers[rng.integers(0, c, size=32)] \
            + rng.normal(size=(32, d)).astype(np.float32) * 0.15
        els = [_elem(i, x[i]) for i in range(n)]
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        truth = np.argsort(-(qn.astype(np.float64)
                             @ xn.astype(np.float64).T), 1)[:, :10]

        def recall(residual):
            idx = _index(n_lists=64, nprobe=64, kmeans_iterations=8,
                         storage="code", metric="cosine",
                         pq_residual=residual)
            idx.build_index(els)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = idx.nn_many([_elem(f"q{i}", q[i])
                                   for i in range(32)], 10)
            return np.mean([
                len({e.uuid() for e in r[0]} & set(t.tolist())) / 10.0
                for r, t in zip(res, truth)])

        r_raw, r_res = recall(False), recall(True)
        assert r_res > r_raw + 0.05, (r_raw, r_res)

    def test_persistence_roundtrip(self):
        x = _clustered(n=600)
        els = [_elem(i, x[i]) for i in range(len(x))]
        el = DataMemoryElement(readonly=False)
        idx = _index(storage="code", metric="cosine", index_element=el)
        idx.build_index(els)
        n1, d1 = _query(idx, x[42])
        idx2 = _index(storage="code", metric="cosine", index_element=el)
        assert idx2.pq_residual is True
        n2, d2 = _query(idx2, x[42])
        assert [e.uuid() for e in n1] == [e.uuid() for e in n2]
        np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)


class TestLifecycle:
    def test_update_and_remove(self):
        x = _clustered(n=1000)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx = _index(storage="code")
        idx.build_index(els[:800])
        idx.update_index(els[800:])
        nbrs, _ = _query(idx, x[900])
        assert nbrs[0].uuid() == 900
        idx.remove_from_index([900])
        nbrs, _ = _query(idx, x[900])
        assert 900 not in {e.uuid() for e in nbrs}

    def test_persistence_roundtrip(self):
        x = _clustered(n=900)
        els = [_elem(i, x[i]) for i in range(len(x))]
        el = DataMemoryElement(readonly=False)
        idx = _index(storage="code", index_element=el)
        idx.build_index(els)
        want = [e.uuid() for e in _query(idx, x[44])[0]]
        idx2 = _index(storage="code", index_element=el)
        assert idx2.pq_residual is True
        got = [e.uuid() for e in _query(idx2, x[44])[0]]
        assert got == want

    def test_cross_load_decode_adds_centroid_back(self):
        x = _clustered(n=900)
        els = [_elem(i, x[i]) for i in range(len(x))]
        el = DataMemoryElement(readonly=False)
        idx = _index(storage="code", index_element=el)
        idx.build_index(els)
        rows = IvfNearestNeighborsIndex(
            n_lists=8, nprobe=8, kmeans_iterations=5, random_seed=0,
            dtype="float32", storage="rows", index_element=el)
        orig = x[np.asarray(rows._row2uid, dtype=np.int64)]
        errs = np.sqrt(((rows._host - orig) ** 2).sum(-1))
        # Residual reconstructions: error ~ codec step on the RESIDUAL
        # scale — far below the data scale (centroid was added back).
        assert float(np.median(errs)) < 0.2 * float(
            np.median(np.sqrt((orig ** 2).sum(-1))))
        nbrs, _ = _query(rows, x[8])
        assert nbrs[0].uuid() == 8

    def test_legacy_payload_without_flag_loads_as_raw(self):
        """A code-tier payload saved BEFORE the residual flag existed
        (no 'pq_residual' header key) holds raw codes: a residual-
        configured loader must adopt raw semantics, not reinterpret the
        codes as residuals (which would corrupt every distance)."""
        x = _clustered(n=600)
        els = [_elem(i, x[i]) for i in range(len(x))]
        el = DataMemoryElement(readonly=False)
        raw = _index(storage="code", pq_residual=False, index_element=el)
        raw.build_index(els)
        want = [e.uuid() for e in _query(raw, x[7])[0]]
        # Strip the flag from the header (simulate the legacy format).
        payload = el.get_bytes()
        hlen = int.from_bytes(payload[:8], "big")
        header = json.loads(payload[8:8 + hlen].decode())
        del header["pq_residual"]
        hb = json.dumps(header).encode()
        el.set_bytes(len(hb).to_bytes(8, "big") + hb
                     + payload[8 + hlen:])
        loaded = _index(storage="code", pq_residual=True,
                        index_element=el)
        assert loaded.pq_residual is False
        got = [e.uuid() for e in _query(loaded, x[7])[0]]
        assert got == want

    def test_opq_residual_compose(self):
        x = _clustered(n=900)
        els = [_elem(i, x[i]) for i in range(len(x))]
        idx = _index(dtype="opq8")
        idx.build_index(els)
        nbrs, dists = _query(idx, x[17])
        assert nbrs[0].uuid() == 17
        assert list(dists) == sorted(dists)
