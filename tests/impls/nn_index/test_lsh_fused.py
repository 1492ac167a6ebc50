"""
Single-dispatch LSH serving (ops/lsh_fused.py, round 5): the fused
hash -> near-code scan -> bucket-expand -> exact-re-rank program must
agree with the two-dispatch path (identical candidate semantics: n
nearest unique codes, union of buckets, exact re-rank — reference flow
/root/reference/smqtk_indexing/impls/nn_index/lsh.py:452-518).
"""
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.lsh_functor.itq import ItqFunctor
from smqtk_indexing_tpu.models.lsh_functor.simple_rp import SimpleRPFunctor
from smqtk_indexing_tpu.models.nn_index.lsh import LSHNearestNeighborIndex


def _elems(n=200, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return [DescriptorMemoryElement(i, rng.normal(size=d)
                                    .astype(np.float32)) for i in range(n)]


def _build(els, functor_cls=ItqFunctor, **kw):
    functor = functor_cls(bit_length=8, random_seed=0)
    functor.fit(els)
    idx = LSHNearestNeighborIndex(lsh_functor=functor, **kw)
    idx.build_index(els)
    return idx


def _q(idx, els, n=5):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return idx.nn_many(els, n)


class TestFusedParity:
    @pytest.mark.parametrize("metric", ["euclidean", "cosine", "hik"])
    @pytest.mark.parametrize("functor_cls", [ItqFunctor, SimpleRPFunctor])
    def test_matches_two_dispatch_path(self, metric, functor_cls,
                                       monkeypatch):
        els = _elems()
        if metric == "hik":
            # HIK is a histogram metric: use non-negative vectors.
            for e in els:
                e.set_vector(np.abs(e.vector()))
        idx = _build(els, functor_cls=functor_cls,
                     distance_method=metric)
        assert idx._fused_ready(5, 8) is not None
        res_f = _q(idx, els[:16])
        assert idx._fused is not None     # the fused state served it
        monkeypatch.setenv("SMQTK_TPU_NO_LSH_FUSED", "1")
        res_2 = _q(idx, els[:16])
        for (ef, df), (e2, d2) in zip(res_f, res_2):
            assert [e.uuid() for e in ef] == [e.uuid() for e in e2]
            np.testing.assert_allclose(df, d2, rtol=1e-5, atol=1e-6)

    def test_normalized_functor_rerank_uses_raw_query(self, monkeypatch):
        """Functor normalization applies to HASHING only (the reference
        functor normalizes inside get_hash, itq.py:389-408; the query
        re-rank uses raw vectors, lsh.py:507-518). Regression: the fused
        program once reranked against the normalized query, so
        self-queries stopped returning themselves."""
        els = _elems(seed=5)
        functor = ItqFunctor(bit_length=8, random_seed=0, normalize=2)
        functor.fit(els)
        idx = LSHNearestNeighborIndex(lsh_functor=functor)
        idx.build_index(els)
        assert idx._fused_ready(5, 8) is not None
        res_f = _q(idx, els[:16])
        assert idx._fused is not None
        for i, (nbrs, dists) in enumerate(res_f):
            assert nbrs[0].uuid() == i
            assert dists[0] < 1e-3
        monkeypatch.setenv("SMQTK_TPU_NO_LSH_FUSED", "1")
        res_2 = _q(idx, els[:16])
        for (ef, df), (e2, d2) in zip(res_f, res_2):
            assert [e.uuid() for e in ef] == [e.uuid() for e in e2]
            np.testing.assert_allclose(df, d2, rtol=1e-5, atol=1e-6)

    def test_single_query_nn_uses_fused(self):
        els = _elems()
        idx = _build(els)
        nbrs, dists = idx.nn(els[17], 4)
        assert idx._fused is not None
        assert nbrs[0].uuid() == 17
        # Device distances may carry ~1e-4 noise (bf16 products in
        # candidate_distances — same margin as the two-dispatch path).
        assert dists[0] < 1e-3

    def test_counters(self):
        from smqtk_indexing_tpu.utils.tracing import COUNTERS
        els = _elems()
        idx = _build(els)
        base = COUNTERS.get("lsh.fused_queries")
        _q(idx, els[:8])
        assert COUNTERS.get("lsh.fused_queries") == base + 8


class TestFusedLifecycle:
    def test_mutations_invalidate_state(self):
        els = _elems(120)
        idx = _build(els[:100])
        _q(idx, els[:4])
        assert idx._fused is not None
        idx.update_index(els[100:])
        assert idx._fused is None
        res = _q(idx, [els[110]], 3)
        assert res[0][0][0].uuid() == 110
        idx.remove_from_index([110])
        assert idx._fused is None
        res = _q(idx, [els[110]], 3)
        assert 110 not in [e.uuid() for e in res[0][0]]

    def test_budget_fallback(self, monkeypatch):
        els = _elems()
        idx = _build(els)
        res_f = _q(idx, els[:8])
        monkeypatch.setattr(LSHNearestNeighborIndex,
                            "_FUSED_SLOT_BUDGET", 1)
        assert idx._fused_ready(5, 8) is None
        res_2 = _q(idx, els[:8])
        for (ef, _), (e2, _) in zip(res_f, res_2):
            assert [e.uuid() for e in ef] == [e.uuid() for e in e2]

    def test_configured_hash_index_uses_two_dispatch(self):
        from smqtk_indexing_tpu.models.hash_index.linear import (
            LinearHashIndex,
        )
        els = _elems()
        idx = _build(els, hash_index=LinearHashIndex())
        assert idx._fused_ready(5, 8) is None
        res = _q(idx, els[:4])
        assert res[0][0][0].uuid() == 0

    def test_mxu_engine_parity(self, monkeypatch):
        """The ±1 near-code engine (the GPU's engine from PM1_SCAN_MIN
        codes, forced here on a small set) must serve the same contract
        as the XOR engine — equal-Hamming
        code ties may legally admit different bucket supersets, so the
        assertions are contract-shaped (self-match, sorted distances,
        identical nearest result), not bit-equality."""
        from smqtk_indexing_tpu.ops import hamming
        els = _elems(300, d=32, seed=3)
        monkeypatch.setattr(hamming, "pm1_engine", lambda n, x: True)
        idx = _build(els)
        st = idx._fused_ready(5, 8)
        assert st is not None and st["pm1"] is not None
        res_m = _q(idx, els[:16])
        for i, (nbrs, dists) in enumerate(res_m):
            assert nbrs[0].uuid() == i
            assert dists[0] < 1e-3
            assert list(dists) == sorted(dists)
        # same index through the XOR engine: nearest result agrees
        idx._fused = None
        monkeypatch.setattr(hamming, "pm1_engine", lambda n, x: False)
        res_x = _q(idx, els[:16])
        assert idx._fused["pm1"] is None
        for (em, dm), (ex, dx) in zip(res_m, res_x):
            assert em[0].uuid() == ex[0].uuid()
            assert abs(dm[0] - dx[0]) < 1e-4

    def test_functor_without_affine_form_falls_back(self):
        els = _elems()
        idx = _build(els)
        idx.lsh_functor.hash_model = lambda: None
        assert idx._fused_ready(5, 8) is None
        res = _q(idx, els[:4])
        assert res[0][0][0].uuid() == 0
