"""Tiled-transposed IVF-PQ tests: the PQ code tier ((n_tiles, M, 4096)
int8 code tiles scored by per-code lookups of the query's ADC table, plain
XLA) against float64 brute force over the reconstructed rows."""
import numpy as np

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import pq as pq_ops
from smqtk_indexing_tpu.ops.ivf_tiled import (
    TILE_ROWS, build_slot_table, build_tiled_csr, ivf_query_tiled_pq,
)


def _query_pq(*arrays, **kw):
    return ivf_query_tiled_pq(*[jnp.asarray(x) for x in arrays], **kw)


def _pq_chunked_layout(n_chunks=2, c_lists=16, d=128, m=16, seed=0):
    """Clustered rows in per-chunk list-sorted order, PQ-encoded into the
    tiled-transposed code layout + codec arrays + float64 reconstruction
    reference."""
    rng = np.random.default_rng(seed)
    chunk_rows = TILE_ROWS
    n = n_chunks * chunk_rows
    centers = rng.normal(size=(c_lists, d)).astype(np.float32) * 2.0
    rows = np.empty((n, d), np.float32)
    chunk_lens = np.zeros((n_chunks, c_lists), np.int64)
    chunk_bases = np.arange(n_chunks) * chunk_rows
    assigns = np.empty(n, np.int32)
    for c in range(n_chunks):
        a_c = np.sort(rng.integers(0, c_lists, size=chunk_rows))
        chunk_lens[c] = np.bincount(a_c, minlength=c_lists)
        rows[c * chunk_rows:(c + 1) * chunk_rows] = (
            centers[a_c] + rng.normal(size=(chunk_rows, d))
            .astype(np.float32) * 0.3)
        assigns[c * chunk_rows:(c + 1) * chunk_rows] = a_c

    d_codec = pq_ops.pq_codec_dim(d, m)
    perm = np.argsort(np.arange(d_codec) % m, kind="stable") \
        .astype(np.int32)
    rows_c = rows[:, perm] if d_codec == d else np.concatenate(
        [rows, np.zeros((n, d_codec - d), np.float32)], axis=1)[:, perm]
    cb = pq_ops.pq_train(rows_c[:4096], m, n_iter=8)
    codes = pq_ops.pq_encode_np(rows_c, cb)             # (n, M) uint8
    db3c = np.ascontiguousarray(
        codes.view(np.int8).reshape(n_chunks, chunk_rows, m)
        .transpose(0, 2, 1))
    cb_sq = (cb.astype(np.float64) ** 2).sum(-1)        # (M, 256)
    s2 = np.zeros(n, np.float64)
    for mi in range(m):
        s2 += cb_sq[mi][codes[:, mi]]
    s2t = np.ascontiguousarray(
        s2.astype(np.float32).reshape(n_chunks, 1, chunk_rows))

    v_tile, v_col, v_len, v_orig, first_virt = build_tiled_csr(
        chunk_lens, chunk_bases)
    cents = np.stack([
        rows[assigns == li].mean(0) if (assigns == li).any()
        else np.zeros(d, np.float32)
        for li in range(c_lists)]).astype(np.float32)
    table = build_slot_table(v_orig, c_lists)
    # float64 reconstructions on the CODEC grid.
    dbq_c = pq_ops.pq_decode_np(codes, cb).astype(np.float64)
    return (db3c, s2t, cb, perm, cents, table, v_tile, v_col, v_len,
            dbq_c, assigns, codes)


def test_pq_tiled_full_probe_is_exact_wrt_reconstruction():
    (db3c, s2t, cb, perm, cents, table, v_tile, v_col, v_len,
     dbq_c, assigns, codes) = _pq_chunked_layout()
    rng = np.random.default_rng(1)
    bq, k = 8, 8
    d = cents.shape[1]
    q = rng.normal(size=(bq, d)).astype(np.float32) * 2.0
    dd, rr = _query_pq(
        jnp.asarray(db3c), jnp.asarray(s2t), jnp.asarray(cb),
        jnp.asarray(perm), jnp.asarray(cents), jnp.asarray(table),
        jnp.asarray(v_tile), jnp.asarray(v_col), jnp.asarray(v_len),
        jnp.asarray(q), k=k, nprobe_orig=cents.shape[0])
    q_c = q[:, perm].astype(np.float64)
    d2 = np.sqrt(((q_c[:, None, :] - dbq_c[None, :, :]) ** 2).sum(-1))
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(rr), ref_rows)
    np.testing.assert_allclose(
        np.asarray(dd), np.take_along_axis(d2, ref_rows, axis=1),
        rtol=1e-4, atol=1e-4)


def test_pq_tiled_faithful_nprobe_matches_per_list_bruteforce():
    (db3c, s2t, cb, perm, cents, table, v_tile, v_col, v_len,
     dbq_c, assigns, codes) = _pq_chunked_layout(seed=7)
    rng = np.random.default_rng(2)
    bq, k, nprobe = 8, 4, 3
    d = cents.shape[1]
    q = rng.normal(size=(bq, d)).astype(np.float32) * 2.0
    dd, rr = _query_pq(
        jnp.asarray(db3c), jnp.asarray(s2t), jnp.asarray(cb),
        jnp.asarray(perm), jnp.asarray(cents), jnp.asarray(table),
        jnp.asarray(v_tile), jnp.asarray(v_col), jnp.asarray(v_len),
        jnp.asarray(q), k=k, nprobe_orig=nprobe)
    rr = np.asarray(rr)
    dd = np.asarray(dd)
    q_c = q[:, perm].astype(np.float64)
    c_d2 = ((q[:, None, :].astype(np.float64)
             - cents[None, :, :]) ** 2).sum(-1)
    for bi in range(bq):
        probed = np.argsort(c_d2[bi])[:nprobe]
        cand = np.flatnonzero(np.isin(assigns, probed))
        d2 = np.sqrt(((q_c[bi] - dbq_c[cand]) ** 2).sum(-1))
        order = cand[np.argsort(d2)][:k]
        assert np.array_equal(rr[bi], order), bi
        np.testing.assert_allclose(dd[bi], np.sort(d2)[:k],
                                   rtol=1e-4, atol=1e-4)


def test_pq_tiled_score_rerank_matches_gather():
    (db3c, s2t, cb, perm, cents, table, v_tile, v_col, v_len,
     dbq_c, assigns, codes) = _pq_chunked_layout(seed=11)
    rng = np.random.default_rng(3)
    bq, k, nprobe = 8, 8, 4
    d = cents.shape[1]
    q = rng.normal(size=(bq, d)).astype(np.float32) * 2.0
    args = (jnp.asarray(db3c), jnp.asarray(s2t), jnp.asarray(cb),
            jnp.asarray(perm), jnp.asarray(cents), jnp.asarray(table),
            jnp.asarray(v_tile), jnp.asarray(v_col), jnp.asarray(v_len),
            jnp.asarray(q))
    d_g, r_g = _query_pq(
        *args, k=k, nprobe_orig=nprobe)
    d_s, r_s = _query_pq(
        *args, k=k, nprobe_orig=nprobe, rerank="score")
    # Score mode ranks by the scan's f32 ADC surrogate, which deviates
    # from the exact reconstruction distance by f32 cancellation, so
    # near-ties at the k boundary may legitimately differ from the
    # exact-gather path. Contract:
    # every score-mode winner's EXACT distance is within tolerance of
    # the true k-th distance, reported distances match the exact ones,
    # and the list is sorted.
    r_s, r_g = np.asarray(r_s), np.asarray(r_g)
    d_s, d_g = np.asarray(d_s), np.asarray(d_g)
    q_c = q[:, np.asarray(perm)].astype(np.float64)
    for bi in range(bq):
        exact = np.sqrt(((q_c[bi] - dbq_c[r_s[bi]]) ** 2).sum(-1))
        # Surrogate noise bound on the SQUARED distance: f32
        # cancellation of the score magnitude (||q||^2 + s2).
        scale = float((q_c[bi] ** 2).sum()
                      + (dbq_c[r_s[bi]] ** 2).sum(-1).max())
        tol2 = 1e-5 * scale
        tol = tol2 / max(2.0 * float(d_g[bi][-1]), 1e-6)
        assert (exact <= d_g[bi][-1] + tol).all(), bi
        assert len(set(r_s[bi]) & set(r_g[bi])) >= k - 2, bi
        assert np.abs(d_s[bi].astype(np.float64) ** 2
                      - exact ** 2).max() <= tol2, bi
        assert list(d_s[bi]) == sorted(d_s[bi]), bi


def test_pq_tiled_dead_row_poison():
    # +inf in s2t must keep a row out of every result (the code tier's
    # removal mechanism — no liveness gather exists on this path).
    (db3c, s2t, cb, perm, cents, table, v_tile, v_col, v_len,
     dbq_c, assigns, codes) = _pq_chunked_layout(seed=15)
    victim = 37
    q = (pq_ops.pq_decode_np(codes[victim:victim + 1], cb)
         .astype(np.float32))
    # Query in ORIGINAL dim order: un-interleave the codec-grid decode.
    inv = np.argsort(perm)
    q = q[:, inv][:, :cents.shape[1]]
    s2t_p = s2t.copy()
    s2t_p[victim // TILE_ROWS, 0, victim % TILE_ROWS] = np.inf
    dd, rr = _query_pq(
        jnp.asarray(db3c), jnp.asarray(s2t_p), jnp.asarray(cb),
        jnp.asarray(perm), jnp.asarray(cents), jnp.asarray(table),
        jnp.asarray(v_tile), jnp.asarray(v_col), jnp.asarray(v_len),
        jnp.asarray(np.repeat(q, 8, axis=0)), k=8,
        nprobe_orig=cents.shape[0])
    assert not np.any(np.asarray(rr) == victim)

