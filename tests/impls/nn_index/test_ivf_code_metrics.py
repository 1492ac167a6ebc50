"""
Capacity ('code') tier metric axis: inner_product and cosine served by
the same tiled list scans (FAISS's METRIC_INNER_PRODUCT /
normalized-cosine usage on the same IVF factory configs, reference
/root/reference/smqtk_indexing/impls/nn_index/faiss.py:51-67).

Oracle strategy (mirrors test_ivf_code's codec-faithful checks): at
nprobe == n_lists the scan is exhaustive over the quantized vectors, so
results must match a float64 brute-force over the DECODED codes under
the same metric — the codec is the only loss, never the pipeline.
"""
import numpy as np
import pytest

from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _clustered(n_clusters=4, per=40, d=16, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * scale
    elems = []
    for ci, c in enumerate(centers):
        for j in range(per):
            elems.append(_elem(f"{ci}-{j}", c + rng.normal(size=d) * 0.3))
    return elems


def _index(metric, dtype="sq8", **kw):
    kw.setdefault("n_lists", 4)
    kw.setdefault("nprobe", 4)          # == n_lists: exhaustive probing
    kw.setdefault("kmeans_iterations", 6)
    kw.setdefault("random_seed", 0)
    return IvfNearestNeighborsIndex(metric=metric, dtype=dtype,
                                    storage="code", **kw)


def _decoded_f64(idx):
    """Float64 reconstructions of the host code mirror, descriptor dims."""
    if idx._pq_m(idx.dtype) is not None:
        from smqtk_indexing_tpu.ops.pq import pq_decode_np
        return pq_decode_np(idx._host, idx._code_cb).astype(np.float64)
    return (idx._host.astype(np.float64) * idx._code_a
            + idx._code_b)


def _codec_q(idx, q):
    """Map a query onto the oracle's grid (PQ: codec-dim interleave)."""
    if idx._pq_m(idx.dtype) is None:
        return np.asarray(q, np.float64)
    _, _, perm = idx._pq_grid()
    q_c = np.zeros(len(perm))
    q_c[:len(q)] = q
    return q_c[perm]


def _oracle(idx, q, metric, k):
    """(uids, dists) of the float64 brute force over decoded codes."""
    db = _decoded_f64(idx)
    qq = _codec_q(idx, q)
    if metric == "inner_product":
        d = -(db @ qq)
    elif metric == "cosine":
        nm = np.linalg.norm(db, axis=1) * np.linalg.norm(qq)
        sim = np.clip((db @ qq) / np.where(nm == 0, 1.0, nm), -1.0, 1.0)
        d = 2.0 * np.arccos(sim) / np.pi
    else:
        d = np.sqrt(((db - qq[None, :]) ** 2).sum(-1))
    order = np.argsort(d, kind="stable")[:k]
    return [idx._row2uid[r] for r in order], d[order]


class TestInnerProduct:
    @pytest.mark.parametrize("dtype", ["sq8", "pq4"])
    def test_matches_float64_oracle(self, dtype):
        elems = _clustered(seed=3)
        idx = _index("inner_product", dtype=dtype)
        idx.build_index(elems)
        rng = np.random.default_rng(1)
        for j in (5, 60, 130):
            q = np.asarray(elems[j].vector()) + \
                rng.normal(size=16).astype(np.float32) * 0.05
            ref_uids, ref_d = _oracle(idx, q, "inner_product", 5)
            res, dists = idx.nn(_elem("q", q), 5)
            assert [e.uuid() for e in res] == ref_uids
            np.testing.assert_allclose(dists, ref_d, atol=1e-3)
            # Reported distance is the negated IP (ascending = most
            # similar first) — the ops/scan metric contract.
            assert list(dists) == sorted(dists)

    def test_score_mode_is_exact_for_ip(self):
        # With zeroed row stats the kernel score IS -<q, x_hat - b>, so
        # score-mode distances match exact-mode to the bf16-split bound.
        elems = _clustered(seed=4)
        exact = _index("inner_product", rerank="exact")
        score = _index("inner_product", rerank="score")
        exact.build_index(elems)
        score.build_index(elems)
        q = _elem("q", np.asarray(elems[10].vector()) + 0.05)
        r_e, d_e = exact.nn(q, 5)
        r_s, d_s = score.nn(q, 5)
        assert [e.uuid() for e in r_e] == [e.uuid() for e in r_s]
        np.testing.assert_allclose(d_s, d_e, rtol=1e-4, atol=1e-3)

    def test_ip_prefers_longer_vectors(self):
        # Sanity of the metric itself: a scaled-up copy of the query
        # direction must beat the unit copy under IP (and would NOT
        # under euclidean).
        d = 16
        base = np.zeros(d, np.float32)
        base[0] = 1.0
        elems = [_elem("long", base * 10.0), _elem("short", base)]
        elems += [_elem(f"n{i}", np.random.default_rng(i)
                        .normal(size=d).astype(np.float32) * 0.1)
                  for i in range(62)]
        idx = _index("inner_product", n_lists=2, nprobe=2)
        idx.build_index(elems)
        res, dists = idx.nn(_elem("q", base), 2)
        assert res[0].uuid() == "long"
        assert dists[0] < dists[1] < 0


class TestCosine:
    @pytest.mark.parametrize("dtype", ["sq8", "pq4"])
    def test_matches_float64_oracle(self, dtype):
        elems = _clustered(seed=5)
        idx = _index("cosine", dtype=dtype)
        idx.build_index(elems)
        rng = np.random.default_rng(2)
        for j in (5, 60, 130):
            q = np.asarray(elems[j].vector()) + \
                rng.normal(size=16).astype(np.float32) * 0.05
            ref_uids, ref_d = _oracle(idx, q, "cosine", 5)
            res, dists = idx.nn(_elem("q", q), 5)
            assert [e.uuid() for e in res] == ref_uids
            np.testing.assert_allclose(dists, ref_d, atol=1e-3)

    def test_codes_carry_unit_rows(self):
        # The persisted representation is the unit sphere: decoded codes
        # have ~unit norm regardless of the original row scale.
        elems = _clustered(seed=6, scale=50.0)
        idx = _index("cosine")
        idx.build_index(elems)
        norms = np.linalg.norm(_decoded_f64(idx), axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=5e-2)

    def test_scale_invariance(self):
        # Cosine must rank a direction match over a magnitude match.
        d = 16
        rng = np.random.default_rng(7)
        u = rng.normal(size=d).astype(np.float32)
        u /= np.linalg.norm(u)
        v = rng.normal(size=d).astype(np.float32)
        v /= np.linalg.norm(v)
        elems = [_elem("same-dir", u * 50.0), _elem("other-dir", v * 1.0)]
        elems += [_elem(f"n{i}", rng.normal(size=d).astype(np.float32))
                  for i in range(62)]
        idx = _index("cosine", n_lists=2, nprobe=2)
        idx.build_index(elems)
        res, dists = idx.nn(_elem("q", u), 1)
        assert res[0].uuid() == "same-dir"
        assert dists[0] < 0.1

    def test_update_encodes_normalized(self):
        # Build on an interleaved subset so the update rows stay inside
        # the build-time codec's per-dim box (a quantizer trained once
        # CLIPS out-of-range adds — FAISS semantics; an update from an
        # unseen cluster direction decodes short on purpose).
        elems = _clustered(seed=8)
        idx = _index("cosine")
        idx.build_index(elems[0::2])
        idx.update_index(elems[1::2])
        assert idx.count() == len(elems)
        norms = np.linalg.norm(_decoded_f64(idx), axis=1)
        np.testing.assert_allclose(norms[: idx.count()], 1.0, atol=5e-2)
        res, _ = idx.nn(elems[151], 1)
        assert res[0].uuid() == elems[151].uuid()

    def test_score_mode_same_winners(self):
        elems = _clustered(seed=9)
        exact = _index("cosine", rerank="exact")
        score = _index("cosine", rerank="score")
        exact.build_index(elems)
        score.build_index(elems)
        q = _elem("q", np.asarray(elems[33].vector()) + 0.05)
        r_e, d_e = exact.nn(q, 5)
        r_s, d_s = score.nn(q, 5)
        # Score mode ranks by L2-of-quantized (== cosine up to the SQ8
        # step's ~1e-2 perturbation of ||x_hat||), so near-tie slots at
        # the k boundary may swap vs the exact angular re-rank — the
        # documented score-mode contract. Top hit and the set (modulo
        # one boundary slot) must agree; distances to ~the norm error.
        assert r_e[0].uuid() == r_s[0].uuid()
        assert len({e.uuid() for e in r_e}
                   & {e.uuid() for e in r_s}) >= 4
        np.testing.assert_allclose(d_s[:3], d_e[:3], atol=5e-2)


class TestPersistence:
    @pytest.mark.parametrize("metric", ["inner_product", "cosine"])
    def test_roundtrip(self, metric):
        elems = _clustered(seed=10)
        ie = DataMemoryElement(readonly=False)
        idx = _index(metric, index_element=ie)
        idx.build_index(elems)
        q = _elem("q", np.asarray(elems[33].vector()) + 0.05)
        r0, d0 = idx.nn(q, 5)
        j = _index(metric, index_element=ie)
        assert j.count() == len(elems)
        r1, d1 = j.nn(q, 5)
        assert [e.uuid() for e in r0] == [e.uuid() for e in r1]
        np.testing.assert_allclose(d0, d1, atol=1e-5)

    def test_metric_mismatch_warns(self):
        import warnings
        elems = _clustered(seed=11)
        ie = DataMemoryElement(readonly=False)
        idx = _index("inner_product", index_element=ie)
        idx.build_index(elems)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            # The loader logs/warns on header-metric mismatch; it must
            # not silently serve IP codes as euclidean.
            j = IvfNearestNeighborsIndex(
                metric="euclidean", dtype="sq8", storage="code",
                n_lists=4, nprobe=4, random_seed=0, index_element=ie)
            assert j.count() == len(elems)


class TestResidualMetricMatrix:
    def test_ip_rejected_cosine_code_accepted(self):
        # Round 5: cosine residual EXISTS on the code tier (unit-sphere
        # codes); inner_product stays rejected (no L2 probe-score
        # decomposition), and rows-tier cosine residual stays rejected.
        with pytest.raises(ValueError, match="inner_product"):
            IvfNearestNeighborsIndex(
                storage="code", dtype="pq4", metric="inner_product",
                pq_residual=True)
        with pytest.raises(ValueError, match="storage='code'"):
            IvfNearestNeighborsIndex(
                storage="rows", dtype="pq4", metric="cosine",
                pq_residual=True)
        idx = IvfNearestNeighborsIndex(
            storage="code", dtype="pq4", metric="cosine",
            pq_residual=True)
        assert idx.pq_residual is True
