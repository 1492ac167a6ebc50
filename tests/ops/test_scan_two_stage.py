"""
Two-stage exact scan tests (ops/scan.flat_topk_two_stage: segment-minima
stage 1, exact f32 stage 2) against float64 numpy and the streaming
``flat_topk`` scan.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from smqtk_indexing_tpu.ops.device import SEG, TILE_N
from smqtk_indexing_tpu.ops.scan import (
    flat_topk, flat_topk_two_stage, segment_minima,
)

MIN_N = TILE_N  # smallest capacity the stores route to the two-stage scan


def _mk(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32) * 3
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32) * 3
    return db, sq, q


def _fused(db, sq, valid, q, **kw):
    return flat_topk_two_stage(jnp.asarray(db), jnp.asarray(sq),
                               jnp.asarray(valid), jnp.asarray(q), **kw)


def _minima64(db, sq, q):
    s = sq.astype(np.float64)[None] - 2.0 * (
        q.astype(np.float64) @ db.astype(np.float64).T)
    return s.reshape(q.shape[0], -1, SEG).min(-1)


def test_fused_matches_reference_scan():
    n, d, b, k = 2 * MIN_N, 128, 8, 10
    db, sq, q = _mk(n, d, b)
    valid = np.ones(n, dtype=bool)
    d_ref, r_ref = flat_topk(jnp.asarray(db), jnp.asarray(sq),
                             jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                             jnp.asarray(q), k=k)
    d_fused, r_fused = _fused(db, sq, valid, q, k=k)
    assert np.array_equal(np.asarray(r_fused), np.asarray(r_ref))
    np.testing.assert_allclose(np.asarray(d_fused), np.asarray(d_ref),
                               atol=1e-4)


def test_fused_exact_vs_numpy_float64():
    n, d, b, k = MIN_N, 64, 8, 5
    db, sq, q = _mk(n, d, b, seed=1)
    valid = np.ones(n, dtype=bool)
    d_fused, r_fused = _fused(db, sq, valid, q, k=k)
    d2 = ((q.astype(np.float64)[:, None, :]
           - db.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(r_fused), ref_rows)


def test_fused_respects_valid_mask():
    n, d, b = MIN_N, 64, 8
    db, sq, q = _mk(n, d, b, seed=2)
    valid = np.zeros(n, dtype=bool)
    valid[37] = True
    q2 = np.vstack([db[37] + 0.001] + [q[1:]]).astype(np.float32)
    d_fused, r_fused = _fused(db, sq, valid, q2, k=4)
    r = np.asarray(r_fused)
    assert np.all(r[:, 0] == 37)
    assert np.all(r[:, 1:] == -1)
    assert np.all(np.isinf(np.asarray(d_fused)[:, 1:]))


def test_fused_duplicate_heavy_data():
    # Many identical rows: distances must still be valid (ties arbitrary).
    n, d, b, k = MIN_N, 32, 8, 8
    db = np.tile(np.arange(32, dtype=np.float32), (n, 1))
    db[100] += 0.5
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    q = db[:b].copy()
    d_fused, r_fused = _fused(db, sq, np.ones(n, bool), q, k=k)
    assert np.allclose(np.asarray(d_fused)[1:, :], 0.0, atol=1e-5)


def test_fused_inner_product_matches_reference():
    n, d, b, k = MIN_N, 64, 8, 6
    db, sq, q = _mk(n, d, b, seed=4)
    valid = np.ones(n, dtype=bool)
    d_ref, r_ref = flat_topk(jnp.asarray(db), jnp.asarray(sq),
                             jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                             jnp.asarray(q), k=k, metric="inner_product")
    d_f, r_f = _fused(db, sq, valid, q, k=k, metric="inner_product")
    assert np.array_equal(np.asarray(r_f), np.asarray(r_ref))
    np.testing.assert_allclose(np.asarray(d_f), np.asarray(d_ref),
                               atol=1e-4)


def test_fused_cosine_matches_reference():
    n, d, b, k = MIN_N, 64, 8, 6
    db, sq, q = _mk(n, d, b, seed=5)
    valid = np.ones(n, dtype=bool)
    norm = np.sqrt(sq)
    d_ref, r_ref = flat_topk(jnp.asarray(db), jnp.asarray(sq),
                             jnp.asarray(norm), jnp.asarray(valid),
                             jnp.asarray(q), k=k, metric="cosine")
    d_f, r_f = _fused(db, sq, valid, q, k=k, metric="cosine",
                      db_norm=jnp.asarray(norm))
    assert np.array_equal(np.asarray(r_f), np.asarray(r_ref))
    np.testing.assert_allclose(np.asarray(d_f), np.asarray(d_ref),
                               atol=1e-4)


def test_topk_smallest_matches_lax_topk():
    from smqtk_indexing_tpu.ops.scan import topk_smallest
    rng = np.random.default_rng(7)
    m = rng.normal(size=(16, 1024)).astype(np.float32)
    # inject inf padding and duplicate values (tie handling)
    m[:, 100:110] = np.inf
    m[:, 3] = m[:, 5]
    for kk in (1, 8, 24, 60):
        v, i = topk_smallest(jnp.asarray(m), kk)
        neg = jnp.sort(jnp.asarray(m), axis=1)[:, :kk]
        np.testing.assert_allclose(np.asarray(v), np.asarray(neg), rtol=0)
        # indices must address the returned values
        got = np.take_along_axis(m, np.asarray(i), axis=1)
        np.testing.assert_allclose(got, np.asarray(v), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_segment_minima_matches_float64(dtype):
    # Stage 1 for every database dtype it serves: f32 (three-pass bf16
    # products, ~1e-5 relative), bf16 rows and int8 codes (exact
    # operands; the query rounds to bf16).
    n, d, b = MIN_N, 128, 24
    rng = np.random.default_rng(3)
    if dtype == "int8":
        db = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    else:
        db = (rng.normal(size=(n, d)) * 3).astype(np.float32)
        if dtype == "bfloat16":
            db = np.asarray(jnp.asarray(db, jnp.bfloat16), np.float32)
    sq = rng.random(n).astype(np.float32) * 100
    q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    got = np.asarray(segment_minima(jnp.asarray(db, dtype=dtype),
                                    jnp.asarray(sq), jnp.asarray(q)))
    q_ref = q if dtype == "float32" \
        else np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    ref = _minima64(db.astype(np.float32), sq, q_ref)
    assert got.shape == (b, n // SEG)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_fused_masked_rows_match_float64(metric):
    # Dead rows (valid=False, the store's removal mask) never surface and
    # the live top-k equals float64 numpy per metric.
    n, d, b, k = 2 * MIN_N, 128, 8, 10
    db, sq, q = _mk(n, d, b, seed=4)
    valid = np.ones(n, dtype=bool)
    valid[50:200] = False
    norm = np.sqrt(sq)
    kw = {}
    x64, q64 = db.astype(np.float64), q.astype(np.float64)
    ip = q64 @ x64.T
    if metric == "euclidean":
        ref = ((q64[:, None] - x64[None]) ** 2).sum(-1)
    elif metric == "inner_product":
        ref = -ip
    else:
        ref = -ip / (np.linalg.norm(q64, axis=1)[:, None] * norm[None])
        kw = dict(db_norm=jnp.asarray(norm))
    ref[:, ~valid] = np.inf
    d_f, r_f = _fused(db, sq, valid, q, k=k, metric=metric, **kw)
    r_f = np.asarray(r_f)
    assert valid[r_f].all()
    assert np.array_equal(r_f, np.argsort(ref, axis=1)[:, :k]), metric


@pytest.mark.parametrize("b", [1, 5, 70])
def test_segment_minima_any_batch_and_chunk(b):
    # Any batch size, and a stream of several chunks (chunk < N).
    n, d = MIN_N, 64
    db, sq, q = _mk(n, d, b, seed=9)
    got = np.asarray(segment_minima(jnp.asarray(db), jnp.asarray(sq),
                                    jnp.asarray(q), chunk=1024))
    ref = _minima64(db, sq, q)
    assert got.shape == (b, n // SEG)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_pad_to_k_contract():
    # ops/scan.pad_to_k is the ONE (B, k) epilogue shared by the tiled
    # score-mode finisher, exact_rerank_decoded, and both sharded
    # per-shard merges — pin both legs: truncate when the candidate
    # width exceeds k, +inf/-1 pad when a budget capped it below k.
    from smqtk_indexing_tpu.ops.scan import pad_to_k

    d = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    r = jnp.asarray(np.arange(12, dtype=np.int32).reshape(3, 4))

    # truncate leg: kk=4 > k=2
    dt, rt = pad_to_k(d, r, 2)
    assert dt.shape == (3, 2) and rt.shape == (3, 2)
    assert np.array_equal(np.asarray(dt), np.asarray(d)[:, :2])
    assert np.array_equal(np.asarray(rt), np.asarray(r)[:, :2])

    # pad leg: kk=4 < k=7 -> +inf dists, -1 rows, dtype preserved
    dp, rp = pad_to_k(d.astype(jnp.bfloat16), r, 7)
    assert dp.shape == (3, 7) and rp.shape == (3, 7)
    assert dp.dtype == jnp.bfloat16 and rp.dtype == jnp.int32
    assert np.all(np.isinf(np.asarray(dp, dtype=np.float32)[:, 4:]))
    assert np.all(np.asarray(rp)[:, 4:] == -1)

    # identity leg: kk == k returns the same content
    di, ri = pad_to_k(d, r, 4)
    assert np.array_equal(np.asarray(di), np.asarray(d))
    assert np.array_equal(np.asarray(ri), np.asarray(r))
