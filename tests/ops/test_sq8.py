"""
SQ8 codec + scan tests (CPU): codec round-trip error bounds, scan recall
against the exact float scan, store integration, factory strings, and the
row-sharded variant.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import scan, sq8
from smqtk_indexing_tpu.ops.store import VectorStore


def _data(n=4096, d=32, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32) * 2.0
    q = rng.normal(size=(8, d)).astype(np.float32) * 2.0
    return db, q


def test_codec_roundtrip_error_bound():
    db, _ = _data()
    a, b = sq8.sq8_train(db)
    codes = sq8.sq8_encode_np(db, a, b)
    assert codes.dtype == np.int8
    dec = np.asarray(sq8.sq8_decode(jnp.asarray(codes), jnp.asarray(a),
                                    jnp.asarray(b)))
    # Max per-dim error is half a quantization step.
    err = np.abs(dec - db)
    assert np.all(err <= a[None, :] * 0.5 + 1e-6)


def test_codec_constant_dimension():
    db, _ = _data(n=256, d=8)
    db[:, 3] = 7.25  # constant dim: a=eps, codes 0, b reproduces exactly
    a, b = sq8.sq8_train(db)
    codes = sq8.sq8_encode_np(db, a, b)
    dec = np.asarray(sq8.sq8_decode(jnp.asarray(codes), jnp.asarray(a),
                                    jnp.asarray(b)))
    np.testing.assert_allclose(dec[:, 3], 7.25, rtol=1e-6)


def _setup_scan(db, metric="euclidean"):
    a, b = sq8.sq8_train(db)
    codes = jnp.asarray(sq8.sq8_encode_np(db, a, b))
    s2, nrm = sq8.sq8_row_stats(codes, jnp.asarray(a), jnp.asarray(b))
    valid = jnp.ones(db.shape[0], dtype=bool)
    return codes, jnp.asarray(a), jnp.asarray(b), s2, nrm, valid


@pytest.mark.parametrize("metric",
                         ["euclidean", "inner_product", "cosine", "hik"])
def test_sq8_topk_high_recall_vs_exact(metric):
    db, q = _data()
    if metric == "hik":  # histograms: nonnegative
        db, q = np.abs(db), np.abs(q)
    codes, a, b, s2, nrm, valid = _setup_scan(db)
    d_sq8, r_sq8 = sq8.sq8_topk(codes, a, b, s2, nrm, valid,
                                jnp.asarray(q), k=10, metric=metric)
    sqv = np.einsum("ij,ij->i", db, db).astype(np.float32)
    d_ref, r_ref = scan.flat_topk(
        jnp.asarray(db), jnp.asarray(sqv), jnp.asarray(np.sqrt(sqv)),
        valid, jnp.asarray(q), k=10, metric=metric)
    r_sq8, r_ref = np.asarray(r_sq8), np.asarray(r_ref)
    rec = np.mean([len(set(r_sq8[i]) & set(r_ref[i])) / 10
                   for i in range(q.shape[0])])
    assert rec >= 0.9, (metric, rec)
    # distances ascend and are finite
    d_sq8 = np.asarray(d_sq8)
    assert np.all(np.diff(d_sq8, axis=1) >= -1e-5)


def test_sq8_two_stage_matches_float64():
    """The streamed two-stage SQ8 scan (segment minima, then the kept
    segments re-scored and the winners re-ranked in f32) returns the
    float64 top-k over the dequantized codes, dead rows excluded."""
    import jax.numpy as jnp

    from smqtk_indexing_tpu.ops import sq8
    from smqtk_indexing_tpu.ops.device import TILE_N

    rng = np.random.default_rng(0)
    n, d, b, k = 2 * TILE_N, 128, 8, 8
    mat = (rng.random((n, d), dtype=np.float32) * 10)
    a, bb = sq8.sq8_train(mat)
    codes = sq8.sq8_encode_np(mat, a, bb)
    q = (rng.random((b, d), dtype=np.float32) * 10)
    cj = jnp.asarray(codes)
    aj, bj = jnp.asarray(a), jnp.asarray(bb)
    s2, nrm = sq8.sq8_row_stats(cj, aj, bj)
    valid = np.ones(n, bool)
    valid[100:200] = False
    vj = jnp.asarray(valid)
    x = codes.astype(np.float64) * a + bb
    q64 = q.astype(np.float64)
    for metric in ("euclidean", "inner_product"):
        d_f, r_f = sq8.sq8_topk(cj, aj, bj, s2, nrm, vj, jnp.asarray(q),
                                k=k, metric=metric, chunk=1024)
        if metric == "euclidean":
            ref = np.sqrt(((q64[:, None] - x[None]) ** 2).sum(-1))
        else:
            ref = -(q64 @ x.T)
        ref[:, ~valid] = np.inf
        rows = np.argsort(ref, axis=1)[:, :k]
        assert np.array_equal(np.asarray(r_f), rows), metric
        np.testing.assert_allclose(np.asarray(d_f),
                                   np.take_along_axis(ref, rows, 1),
                                   rtol=1e-5, atol=1e-4)


def test_sq8_topk_self_match_and_chunked():
    # > chunk rows exercises the lax.scan streaming path (N % chunk == 0,
    # the store capacity invariant).
    db, _ = _data(n=3072, d=16, seed=2)
    codes, a, b, s2, nrm, valid = _setup_scan(db)
    q = np.asarray(sq8.sq8_decode(codes[:8], a, b))  # exact grid points
    d_s, r_s = sq8.sq8_topk(codes, a, b, s2, nrm, valid, jnp.asarray(q),
                            k=3, metric="euclidean", chunk=1024)
    assert np.array_equal(np.asarray(r_s)[:, 0], np.arange(8))
    assert np.allclose(np.asarray(d_s)[:, 0], 0.0, atol=1e-4)


def test_sq8_topk_respects_valid_mask():
    db, q = _data(n=512, d=16, seed=3)
    codes, a, b, s2, nrm, _ = _setup_scan(db)
    valid = np.zeros(512, dtype=bool)
    valid[37] = True
    d_s, r_s = sq8.sq8_topk(codes, a, b, s2, nrm, jnp.asarray(valid),
                            jnp.asarray(q), k=4, metric="euclidean")
    r_s, d_s = np.asarray(r_s), np.asarray(d_s)
    assert np.all(r_s[:, 0] == 37)
    assert np.all(r_s[:, 1:] == -1)
    assert np.all(np.isinf(d_s[:, 1:]))


def test_store_sq8_build_query_mutate_persist():
    db, q = _data(n=600, d=24, seed=4)
    st = VectorStore(dtype="sq8")
    st.build(db, list(range(600)))
    dists, uids, rows = st.knn(q, 5)
    # recall vs exact f32 store
    st32 = VectorStore(dtype="float32")
    st32.build(db, list(range(600)))
    _, uids32, _ = st32.knn(q, 5)
    rec = np.mean([len(set(uids[i]) & set(uids32[i])) / 5
                   for i in range(len(uids))])
    assert rec >= 0.9
    # add (encodes with the build-time codec) + remove + re-query
    st.add(db[:4] + 0.01, [1000, 1001, 1002, 1003])
    st.remove([0, 1])
    assert st.n_valid == 602
    d2, u2, _ = st.knn(db[2][None, :], 1)
    assert u2[0][0] == 2
    # persistence round-trip (host mirror is f32: codec retrains on load)
    blob = st.to_bytes()
    st2 = VectorStore(dtype="sq8")
    st2.from_bytes(blob)
    assert st2.n_valid == 602
    d3, u3, _ = st2.knn(db[2][None, :], 1)
    assert u3[0][0] == 2


def test_store_sq8_sharded_matches_single():
    from smqtk_indexing_tpu.parallel import make_mesh
    db, q = _data(n=1024, d=16, seed=5)
    st1 = VectorStore(dtype="sq8")
    st1.build(db, list(range(1024)))
    st8 = VectorStore(dtype="sq8", mesh=make_mesh(8))
    st8.build(db, list(range(1024)))
    d1, u1, _ = st1.knn(q, 8)
    d8, u8, _ = st8.knn(q, 8)
    np.testing.assert_allclose(d8, d1, atol=1e-5)
    assert u1 == u8


def test_factory_sq8_strings():
    from smqtk_indexing_tpu.models.nn_index.factory import (
        index_from_factory_string,
    )
    from smqtk_indexing_tpu.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    idx = index_from_factory_string("SQ8")
    assert isinstance(idx, FlatNearestNeighborsIndex)
    assert idx.dtype == "sq8"
    idx = index_from_factory_string("IDMap,SQ8", metric="ip")
    assert idx.dtype == "sq8" and idx.metric == "inner_product"
    # PQ strings now route to the PQ codec (ops/pq.py).
    assert index_from_factory_string("IDMap,PQ16").dtype == "pq16"


@pytest.mark.parametrize("metric", ["euclidean", "inner_product",
                                    "cosine"])
def test_sq8_chunked_matches_single_block(metric):
    """The streamed two-stage path (N > chunk) and the single-block path
    (N <= chunk) agree on the same codes, for every matmul-form metric."""
    import jax.numpy as jnp

    from smqtk_indexing_tpu.ops import sq8

    rng = np.random.default_rng(5)
    n, d, b, k = 16384, 128, 8, 8
    mat = rng.standard_normal((n, d)).astype(np.float32)
    a, bb = sq8.sq8_train(mat)
    codes = sq8.sq8_encode_np(mat, a, bb)
    q = rng.standard_normal((b, d)).astype(np.float32)
    aj, bj = jnp.asarray(a), jnp.asarray(bb)
    cj = jnp.asarray(codes)
    s2, nrm = sq8.sq8_row_stats(cj, aj, bj)
    valid = np.ones(n, bool)
    valid[50:150] = False            # dead-row mask must survive
    vj = jnp.asarray(valid)
    qj = jnp.asarray(q)
    d_one, r_one = sq8.sq8_topk(cj, aj, bj, s2, nrm, vj, qj, k=k,
                                metric=metric, chunk=n)
    d_str, r_str = sq8.sq8_topk(cj, aj, bj, s2, nrm, vj, qj, k=k,
                                metric=metric, chunk=4096)
    assert np.array_equal(np.asarray(r_str), np.asarray(r_one)), metric
    np.testing.assert_allclose(np.asarray(d_str), np.asarray(d_one),
                               atol=1e-5, rtol=1e-6)
    assert not (set(np.asarray(r_str).ravel().tolist())
                & set(range(50, 150)))
