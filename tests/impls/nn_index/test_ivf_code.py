"""
IvfNearestNeighborsIndex ``storage='code'`` capacity-tier tests: the host
mirror is int8 SQ8 codes, queries run the tiled-transposed list scan
(the SQ8 kernel in interpret mode on CPU), and persistence round-trips codes +
codec without ever materializing float originals (the reference's FAISS
SQ serialization contract, faiss.py:368-386).
"""
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.core.configuration import configuration_test_helper
from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _clustered(n_clusters=4, per=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 10
    elems = []
    for ci, c in enumerate(centers):
        for j in range(per):
            elems.append(_elem(f"{ci}-{j}", c + rng.normal(size=d) * 0.3))
    return elems


def _code_index(**kw):
    kw.setdefault("n_lists", 4)
    kw.setdefault("nprobe", 4)
    kw.setdefault("kmeans_iterations", 6)
    kw.setdefault("random_seed", 0)
    return IvfNearestNeighborsIndex(dtype="sq8", storage="code", **kw)


def _pq_code_index(**kw):
    kw.setdefault("n_lists", 4)
    kw.setdefault("nprobe", 4)
    kw.setdefault("kmeans_iterations", 6)
    kw.setdefault("random_seed", 0)
    kw.setdefault("dtype", "pq4")
    return IvfNearestNeighborsIndex(storage="code", **kw)


class TestIvfCodeTierConfig:
    def test_requires_sq8(self):
        with pytest.raises(ValueError, match="dtype='sq8'"):
            IvfNearestNeighborsIndex(storage="code", dtype="float32")

    def test_accepts_pq(self):
        i = IvfNearestNeighborsIndex(storage="code", dtype="pq4")
        assert i.dtype == "pq4"

    def test_metric_axis(self):
        # Round 4: the capacity tier serves euclidean, inner_product and
        # cosine (FAISS METRIC_* parity, faiss.py:51-67); nothing else.
        for m in ("euclidean", "inner_product", "cosine"):
            i = IvfNearestNeighborsIndex(storage="code", dtype="sq8",
                                         metric=m)
            assert i.metric == m
        with pytest.raises(ValueError, match="metric"):
            IvfNearestNeighborsIndex(storage="code", dtype="sq8",
                                     metric="hik")

    def test_multi_device_supported(self):
        # Round 4: the capacity tier shards over a mesh
        # (parallel/sharded_ivf_code.py), residual PQ included; the
        # ROWS tier's residual shards too (row2list rides the row shards,
        # codec-space centroids replicate — parallel/sharded_ivf.py).
        i = IvfNearestNeighborsIndex(storage="code", dtype="sq8",
                                     n_devices=4)
        assert i.n_devices == 4
        i2 = IvfNearestNeighborsIndex(storage="code", dtype="pq4",
                                      pq_residual=True, n_devices=4)
        assert i2.pq_residual is True
        i3 = IvfNearestNeighborsIndex(storage="rows", dtype="pq4",
                                      pq_residual=True, n_devices=4)
        assert i3.pq_residual is True

    def test_bad_values(self):
        with pytest.raises(ValueError, match="storage"):
            IvfNearestNeighborsIndex(storage="columns")
        with pytest.raises(ValueError, match="rerank"):
            IvfNearestNeighborsIndex(rerank="never")

    def test_configuration_roundtrip(self):
        i = _code_index(rerank="score")
        for inst in configuration_test_helper(i):
            assert inst.storage == "code"
            assert inst.rerank == "score"
            assert inst.dtype == "sq8"


class TestIvfCodeTierQuery:
    def test_host_mirror_is_int8(self):
        elems = _clustered()
        i = _code_index()
        i.build_index(elems)
        assert i._host.dtype == np.int8
        assert i._code_a is not None and i._code_a.shape == (16,)

    def test_self_retrieval(self):
        elems = _clustered()
        i = _code_index(nprobe=2)
        i.build_index(elems)
        assert i.count() == len(elems)
        for j in (0, 77, 159):
            res, dists = i.nn(elems[j], 3)
            assert res[0].uuid() == elems[j].uuid()
            # Distance is exact w.r.t. the QUANTIZED vector; self-match
            # lands within the codec step.
            assert dists[0] < 0.5
            assert list(dists) == sorted(dists)

    def test_matches_rows_sq8_at_full_probe(self):
        # Same data, same deterministic codec training: the code tier at
        # nprobe == n_lists must rank identically to the rows-tier sq8
        # index probing everything (both exact over quantized vectors).
        elems = _clustered(seed=3)
        code = _code_index()
        rows = IvfNearestNeighborsIndex(
            dtype="sq8", n_lists=4, nprobe=4, kmeans_iterations=6,
            random_seed=0)
        code.build_index(elems)
        rows.build_index(elems)
        for j in (5, 60, 130):
            q = _elem("q", np.asarray(elems[j].vector()) + 0.05)
            r_c, d_c = code.nn(q, 8)
            r_r, d_r = rows.nn(q, 8)
            assert [e.uuid() for e in r_c] == [e.uuid() for e in r_r]
            np.testing.assert_allclose(d_c, d_r, atol=1e-3)

    def test_score_rerank_close_to_exact(self):
        elems = _clustered(seed=4)
        exact = _code_index()
        score = _code_index(rerank="score")
        exact.build_index(elems)
        score.build_index(elems)
        q = _elem("q", np.asarray(elems[10].vector()) + 0.05)
        r_e, d_e = exact.nn(q, 5)
        r_s, d_s = score.nn(q, 5)
        assert [e.uuid() for e in r_e] == [e.uuid() for e in r_s]
        np.testing.assert_allclose(d_s, d_e, atol=5e-2)


class TestIvfCodeTierMutation:
    def test_update_encodes_with_build_codec(self):
        elems = _clustered()
        i = _code_index()
        i.build_index(elems[:120])
        a0 = i._code_a.copy()
        i.update_index(elems[120:])
        np.testing.assert_array_equal(i._code_a, a0)
        assert i.count() == len(elems)
        res, _ = i.nn(elems[150], 1)
        assert res[0].uuid() == elems[150].uuid()

    def test_update_skips_duplicates(self):
        elems = _clustered()
        i = _code_index()
        i.build_index(elems)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            i.update_index(elems[:3])
        assert any("already-indexed" in str(x.message) for x in w)

    def test_removal_poisons_rows(self):
        elems = _clustered()
        i = _code_index(nprobe=4)
        i.build_index(elems)
        victim = elems[7]
        i.remove_from_index([victim.uuid()])
        assert i.count() == len(elems) - 1
        res, _ = i.nn(victim, 3)
        assert victim.uuid() not in [e.uuid() for e in res]

    def test_removal_compaction(self):
        # Removing >half triggers re-layout from the int8 mirror without
        # retraining the codec.
        elems = _clustered(n_clusters=4, per=320)  # 1280 rows > 1024
        i = _code_index()
        i.build_index(elems)
        a0 = i._code_a.copy()
        i.remove_from_index([e.uuid() for e in elems[: len(elems) * 3 // 4]])
        np.testing.assert_array_equal(i._code_a, a0)
        assert i.count() == len(elems) - len(elems) * 3 // 4
        keep = elems[len(elems) * 3 // 4:]
        res, _ = i.nn(keep[5], 1)
        assert res[0].uuid() == keep[5].uuid()


class TestIvfCodeTierPersistence:
    def test_payload_is_codes_not_floats(self):
        elems = _clustered()
        ie = DataMemoryElement(readonly=False)
        i = _code_index(index_element=ie)
        i.build_index(elems)
        import io
        payload = ie.get_bytes()
        hlen = int.from_bytes(payload[:8], "big")
        import json
        header = json.loads(payload[8:8 + hlen].decode())
        assert header["storage"] == "code"
        with np.load(io.BytesIO(payload[8 + hlen:]),
                     allow_pickle=True) as z:
            assert z["matrix"].dtype == np.int8
            assert "code_a" in z

    def test_roundtrip_code_to_code(self):
        elems = _clustered()
        ie = DataMemoryElement(readonly=False)
        i = _code_index(index_element=ie)
        i.build_index(elems)
        q = _elem("q", np.asarray(elems[33].vector()) + 0.05)
        r0, d0 = i.nn(q, 5)
        j = _code_index(index_element=ie)
        assert j.count() == len(elems)
        np.testing.assert_array_equal(j._code_a, i._code_a)
        r1, d1 = j.nn(q, 5)
        assert [e.uuid() for e in r0] == [e.uuid() for e in r1]
        np.testing.assert_allclose(d0, d1, atol=1e-5)

class TestIvfCodeTierPq:
    """PQ 'code' tier: (n, M) uint8 host mirror served by the tiled
    ADC list scan (plain XLA)."""

    def test_host_mirror_is_pq_codes(self):
        elems = _clustered()
        i = _pq_code_index()
        i.build_index(elems)
        assert i._host.dtype == np.uint8
        assert i._host.shape[1] == 4
        assert i._code_cb is not None and i._code_cb.shape[:2] == (4, 256)

    def test_self_retrieval(self):
        elems = _clustered()
        i = _pq_code_index(nprobe=4)
        i.build_index(elems)
        assert i.count() == len(elems)
        for j in (0, 77, 159):
            res, dists = i.nn(elems[j], 3)
            # PQ distances are exact w.r.t. the reconstruction; on this
            # well-separated mixture the self row still wins.
            assert res[0].uuid() == elems[j].uuid()
            assert list(dists) == sorted(dists)

    def test_matches_pq_rows_tier_at_full_probe(self):
        # Same data: the PQ code tier at nprobe == n_lists must return
        # the same neighbor SETS as exhaustive float64 brute force over
        # its own reconstructions (the codec is the only loss).
        from smqtk_indexing_tpu.ops.pq import pq_decode_np
        elems = _clustered(seed=3)
        i = _pq_code_index()
        i.build_index(elems)
        _, _, perm = i._pq_grid()
        dbq = pq_decode_np(i._host, i._code_cb).astype(np.float64)
        q = np.asarray(elems[60].vector(), np.float64) + 0.05
        q_c = np.zeros(len(perm))
        q_c[:len(q)] = q
        q_c = q_c[perm]
        d2 = np.sqrt(((q_c[None, :] - dbq) ** 2).sum(-1))
        ref = [i._row2uid[r] for r in np.argsort(d2)[:5]]
        res, dists = i.nn(_elem("q", q.astype(np.float32)), 5)
        assert [e.uuid() for e in res] == ref
        np.testing.assert_allclose(dists, np.sort(d2)[:5], atol=1e-4)

    def test_update_and_removal(self):
        elems = _clustered()
        i = _pq_code_index()
        i.build_index(elems[:120])
        cb0 = i._code_cb.copy()
        i.update_index(elems[120:])
        np.testing.assert_array_equal(i._code_cb, cb0)  # codec fixed
        assert i.count() == len(elems)
        victim = elems[7]
        i.remove_from_index([victim.uuid()])
        res, _ = i.nn(victim, 3)
        assert victim.uuid() not in [e.uuid() for e in res]

    def test_roundtrip(self):
        elems = _clustered()
        ie = DataMemoryElement(readonly=False)
        i = _pq_code_index(index_element=ie)
        i.build_index(elems)
        q = _elem("q", np.asarray(elems[33].vector()) + 0.05)
        r0, d0 = i.nn(q, 5)
        j = _pq_code_index(index_element=ie)
        assert j.count() == len(elems)
        assert j._host.dtype == np.uint8
        np.testing.assert_array_equal(j._code_cb, i._code_cb)
        r1, d1 = j.nn(q, 5)
        assert [e.uuid() for e in r0] == [e.uuid() for e in r1]
        np.testing.assert_allclose(d0, d1, atol=1e-5)

    def test_cross_load_pq_codes_into_rows_instance(self):
        elems = _clustered()
        ie = DataMemoryElement(readonly=False)
        i = _pq_code_index(index_element=ie)
        i.build_index(elems)
        j = IvfNearestNeighborsIndex(
            index_element=ie, n_lists=4, nprobe=4, kmeans_iterations=6,
            random_seed=0)
        assert j.count() == len(elems)
        assert j._host.dtype == np.float32
        assert j._host.shape[1] == 16  # decoded back to descriptor dim
        res, dists = j.nn(elems[20], 1)
        assert res[0].uuid() == elems[20].uuid()


class TestIvfCodeTierPersistenceCross:
    def test_cross_load_into_rows_instance(self):
        # A rows-tier instance loading a code payload decodes the codes
        # to floats and serves normally (lossy only by the SQ8 step).
        elems = _clustered()
        ie = DataMemoryElement(readonly=False)
        i = _code_index(index_element=ie)
        i.build_index(elems)
        j = IvfNearestNeighborsIndex(
            index_element=ie, n_lists=4, nprobe=4, kmeans_iterations=6,
            random_seed=0)
        assert j.count() == len(elems)
        assert j._host.dtype == np.float32
        res, dists = j.nn(elems[20], 1)
        assert res[0].uuid() == elems[20].uuid()
        assert dists[0] < 0.5
