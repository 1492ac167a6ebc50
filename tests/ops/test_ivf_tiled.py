"""Tiled-transposed-layout IVF list-scan tests (the ``storage='code'``
tier: IVF-SQ8 over the single-copy (n_tiles, d, 4096) array) against
float64 brute force on the dequantized codes. The list-scan kernel runs in
interpret mode on the CPU; ``gpu``-marked tests compile it for the card."""
import numpy as np
import pytest

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import sq8 as sq8_ops
from smqtk_indexing_tpu.ops.device import kernel_interpret
from smqtk_indexing_tpu.ops.ivf_tiled import (
    TILE_ROWS, build_slot_table, build_tiled_csr, ivf_query_tiled,
)
from smqtk_indexing_tpu.ops.pallas_ivf import W, list_scores


def _query(db3, s2t, a, b, cents, table, v_tile, v_col, v_len, q, **kw):
    args = [jnp.asarray(x) for x in (db3, s2t, a, b, cents, table, v_tile,
                                     v_col, v_len, q)]
    return ivf_query_tiled(*args, interpret=kernel_interpret(args[0]),
                           **kw)


def _chunked_layout(n_chunks=2, c_lists=16, d=128, seed=0):
    """Clustered rows written in per-chunk list-sorted order (the way the
    100M build ingests chunks), plus the codec and CSR arrays."""
    rng = np.random.default_rng(seed)
    chunk_rows = TILE_ROWS  # one tile per chunk
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

    a, b = sq8_ops.sq8_train(rows)
    codes = sq8_ops.sq8_encode_np(rows, a, b)
    db3 = np.ascontiguousarray(
        codes.reshape(n_chunks, chunk_rows, d).transpose(0, 2, 1))
    u = codes.astype(np.float64)
    s2 = ((a.astype(np.float64) * u) ** 2).sum(1).astype(np.float32)
    s2t = np.ascontiguousarray(s2.reshape(n_chunks, 1, chunk_rows))

    v_tile, v_col, v_len, v_orig, first_virt = build_tiled_csr(
        chunk_lens, chunk_bases)
    cents = np.stack([
        rows[assigns == li].mean(0) if (assigns == li).any()
        else np.zeros(d, np.float32)
        for li in range(c_lists)]).astype(np.float32)
    dbq = u * a + b  # float64 dequantized reference
    return (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig,
            first_virt, dbq, assigns)


def test_csr_builder_invariants():
    (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig, first_virt,
     dbq, assigns) = _chunked_layout(n_chunks=3, seed=3)
    # Sublists fit one probe window after end-of-tile clamping.
    assert (v_len <= W).all()
    c0 = np.minimum(v_col, TILE_ROWS - W)
    assert ((v_col - c0) + v_len <= W).all()
    # No sublist crosses a tile boundary.
    assert (v_col + v_len <= TILE_ROWS).all()
    # Every row is covered exactly once, with its own list id.
    cover = np.zeros(dbq.shape[0], np.int32)
    for ti, co, ln, orig in zip(v_tile, v_col, v_len, v_orig):
        rows = ti * TILE_ROWS + co + np.arange(ln)
        cover[rows] += 1
        assert (assigns[rows] == orig).all()
    assert (cover == 1).all()
    assert (first_virt >= 0).all()
    assert (v_orig[first_virt] == np.arange(len(first_virt))).all()


def test_tiled_full_probe_is_exact():
    (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig, first_virt,
     dbq, assigns) = _chunked_layout()
    rng = np.random.default_rng(1)
    bq, k = 8, 8
    q = (dbq[rng.integers(0, dbq.shape[0], bq)]
         + rng.normal(size=(bq, dbq.shape[1])) * 0.1).astype(np.float32)
    table = build_slot_table(v_orig, cents.shape[0])
    dd, rr = _query(db3, s2t, a, b, cents, table, v_tile, v_col, v_len, q,
                    k=k, nprobe_orig=cents.shape[0])
    d2 = np.sqrt(((q[:, None, :].astype(np.float64)
                   - dbq[None, :, :]) ** 2).sum(-1))
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(rr), ref_rows)
    np.testing.assert_allclose(
        np.asarray(dd), np.take_along_axis(d2, ref_rows, axis=1),
        rtol=1e-4, atol=1e-4)


def test_tiled_faithful_nprobe_matches_per_list_bruteforce():
    (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig, first_virt,
     dbq, assigns) = _chunked_layout(seed=7)
    rng = np.random.default_rng(2)
    bq, k, nprobe = 8, 4, 3
    q = (dbq[rng.integers(0, dbq.shape[0], bq)]
         + rng.normal(size=(bq, dbq.shape[1])) * 0.1).astype(np.float32)
    table = build_slot_table(v_orig, cents.shape[0])
    dd, rr = _query(db3, s2t, a, b, cents, table, v_tile, v_col, v_len, q,
                    k=k, nprobe_orig=nprobe)
    rr = np.asarray(rr)
    dd = np.asarray(dd)
    # FAISS-faithful reference: rank ORIGINAL lists by centroid L2, scan
    # exactly the nprobe nearest lists' rows, exact distances.
    c_d2 = ((q[:, None, :].astype(np.float64)
             - cents[None, :, :]) ** 2).sum(-1)
    for bi in range(bq):
        probed = np.argsort(c_d2[bi])[:nprobe]
        mask = np.isin(assigns, probed)
        cand = np.flatnonzero(mask)
        d2 = np.sqrt(((q[bi].astype(np.float64)
                       - dbq[cand]) ** 2).sum(-1))
        order = cand[np.argsort(d2)][:k]
        assert np.array_equal(rr[bi], order), bi
        np.testing.assert_allclose(dd[bi], np.sort(d2)[:k],
                                   rtol=1e-4, atol=1e-4)


def test_list_scores_match_float64():
    # The list-scan kernel alone: random windows (dead slots, windows
    # clamped at the tile end, +inf-poisoned rows) against numpy.
    rng = np.random.default_rng(4)
    n_tiles, d, b, p = 2, 128, 3, 7
    db3 = rng.integers(-127, 128, size=(n_tiles, d, TILE_ROWS)) \
        .astype(np.int8)
    s2t = rng.random((n_tiles, 1, TILE_ROWS)).astype(np.float32) * 50
    s2t[1, 0, TILE_ROWS - 3] = np.inf
    t = rng.normal(size=(b, d)).astype(np.float32)
    ti = rng.integers(0, n_tiles, size=(b, p)).astype(np.int32)
    c0 = rng.integers(0, TILE_ROWS - W + 1, size=(b, p)).astype(np.int32)
    c0[0, 0], ti[0, 0] = TILE_ROWS - W, 1
    lo = rng.integers(0, 64, size=(b, p)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, W, size=(b, p)), W) \
        .astype(np.int32)
    hi[0, 0], hi[1, 2] = W, lo[1, 2]            # full window, dead slot
    args = [jnp.asarray(x) for x in (db3, s2t, t, ti, c0, lo, hi)]
    got = np.asarray(list_scores(*args,
                                 interpret=kernel_interpret(args[0])))
    ref = np.full((b, p, W), np.inf)
    for i in range(b):
        for j in range(p):
            win = db3[ti[i, j], :, c0[i, j]:c0[i, j] + W].astype(np.float64)
            sc = s2t[ti[i, j], 0, c0[i, j]:c0[i, j] + W] \
                - 2.0 * (t[i].astype(np.float64) @ win)
            ref[i, j, lo[i, j]:hi[i, j]] = sc[lo[i, j]:hi[i, j]]
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=1e-5 * np.abs(ref[fin]).max())


def test_tiled_winner_gather_matches_numpy():
    # Exact re-rank input: the winners' codes gathered straight from the
    # tiled layout (row r at [r // TILE_ROWS, :, r % TILE_ROWS]).
    from smqtk_indexing_tpu.ops.ivf_tiled import _gather_codes
    rng = np.random.default_rng(7)
    db3 = rng.integers(-127, 128, size=(3, 64, TILE_ROWS)).astype(np.int8)
    rows = rng.integers(0, 3 * TILE_ROWS, size=(12, 8)).astype(np.int32)
    rows[0, :2] = -1                              # empty slots clamp to 0
    got = np.asarray(_gather_codes(jnp.asarray(db3), jnp.asarray(rows),
                                   TILE_ROWS))
    rc = np.maximum(rows, 0)
    oracle = db3[rc // TILE_ROWS, :, rc % TILE_ROWS]
    assert got.shape == (12, 8, 64)
    assert np.array_equal(got, oracle)


def test_tiled_score_rerank_matches_gather():
    # rerank="score" must return (near-tie order aside) the same rows
    # as the exact gather path; distances carry the f32 surrogate's
    # cancellation-bounded noise on the squared distance, far below the
    # SQ8 step.
    (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig, first_virt,
     dbq, assigns) = _chunked_layout(n_chunks=3, c_lists=16, seed=21)
    rng = np.random.default_rng(6)
    bq, k, nprobe = 8, 8, 4
    q = (dbq[rng.integers(0, dbq.shape[0], bq)]
         + rng.normal(size=(bq, dbq.shape[1])) * 0.1).astype(np.float32)
    table = build_slot_table(v_orig, cents.shape[0])
    args = (db3, s2t, a, b, cents, table, v_tile, v_col, v_len, q)
    d_g, r_g = _query(*args, k=k, nprobe_orig=nprobe)
    d_s, r_s = _query(*args, k=k, nprobe_orig=nprobe, rerank="score")
    # Score mode ranks by the scan's f32 surrogate, which deviates from
    # the exact quantized distance by f32 cancellation, so near-ties at
    # the k boundary (and adjacent orders) may legitimately differ from
    # the exact-gather path. The contract:
    # every score-mode winner's EXACT distance is within tolerance of
    # the true k-th distance, reported distances match the exact ones,
    # and the list is sorted.
    r_s, r_g = np.asarray(r_s), np.asarray(r_g)
    d_s, d_g = np.asarray(d_s), np.asarray(d_g)
    for bi in range(bq):
        exact = np.sqrt(((q[bi].astype(np.float64)
                          - dbq[r_s[bi]]) ** 2).sum(-1))
        # Surrogate noise bound on the SQUARED distance: f32 cancellation
        # of the score magnitude (||q - b||^2 + s2), 1e-5 relative.
        scale = float((q[bi].astype(np.float64) ** 2).sum()
                      + (dbq[r_s[bi]] ** 2).sum(-1).max())
        tol2 = 1e-5 * scale
        tol = tol2 / max(2.0 * float(d_g[bi][-1]), 1e-6)
        assert (exact <= d_g[bi][-1] + tol).all(), bi
        assert len(set(r_s[bi]) & set(r_g[bi])) >= k - 2, bi
        assert np.abs(d_s[bi].astype(np.float64) ** 2
                      - exact ** 2).max() <= tol2, bi
        assert list(d_s[bi]) == sorted(d_s[bi]), bi


def test_tiled_score_mode_pads_to_k():
    # The (B, k) return contract must hold in score mode even when k
    # exceeds the probe budget's candidate width (gather mode pads via
    # exact_rerank_decoded; regression: score mode once returned
    # (B, kk) with kk = n_probe * W < k).
    (db3, s2t, a, b, cents, v_tile, v_col, v_len, v_orig, first_virt,
     dbq, assigns) = _chunked_layout(n_chunks=2, c_lists=16, seed=31)
    rng = np.random.default_rng(9)
    q = dbq[rng.integers(0, dbq.shape[0], 2)].astype(np.float32)
    table = build_slot_table(v_orig, cents.shape[0])
    budget = table.shape[1]                   # nprobe=1 -> S_max slots
    k = budget * W + 40                # wider than every candidate slot
    d_s, r_s = _query(db3, s2t, a, b, cents, table, v_tile, v_col, v_len,
                      q, k=k, nprobe_orig=1, rerank="score")
    assert d_s.shape == (2, k) and r_s.shape == (2, k)
    d_s, r_s = np.asarray(d_s), np.asarray(r_s)
    assert np.isinf(d_s[:, -40:]).all()
    assert (r_s[:, -40:] == -1).all()
    # the real candidates lead the row, sorted ascending
    lead = d_s[0][np.isfinite(d_s[0])]
    assert (np.diff(lead) >= 0).all() and lead.size > 0


@pytest.mark.gpu
def test_list_scores_compiled_at_real_width():
    # The list-scan kernel compiled for the card at serving widths
    # (d=128, B=1024 queries x 16 probe slots) against float64 numpy on
    # 64 of the queries.
    rng = np.random.default_rng(5)
    n_tiles, d, b, p = 64, 128, 1024, 16
    db3 = rng.integers(-127, 128, size=(n_tiles, d, TILE_ROWS)) \
        .astype(np.int8)
    s2t = rng.random((n_tiles, 1, TILE_ROWS)).astype(np.float32) * 50
    t = rng.normal(size=(b, d)).astype(np.float32)
    ti = rng.integers(0, n_tiles, size=(b, p)).astype(np.int32)
    c0 = rng.integers(0, TILE_ROWS - W + 1, size=(b, p)).astype(np.int32)
    lo = np.zeros((b, p), np.int32)
    hi = rng.integers(0, W + 1, size=(b, p)).astype(np.int32)
    args = [jnp.asarray(x) for x in (db3, s2t, t, ti, c0, lo, hi)]
    assert kernel_interpret(args[0]) is False
    got = np.asarray(list_scores(*args, interpret=False))[:64]
    ref = np.full((64, p, W), np.inf)
    for i in range(64):
        for j in range(p):
            win = db3[ti[i, j], :, c0[i, j]:c0[i, j] + W].astype(np.float64)
            sc = s2t[ti[i, j], 0, c0[i, j]:c0[i, j] + W] \
                - 2.0 * (t[i].astype(np.float64) @ win)
            ref[i, j, :hi[i, j]] = sc[:hi[i, j]]
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=1e-5 * np.abs(ref[fin]).max())
