"""
Exhaustive kNN scan with fused streaming top-k.

This is the device-resident replacement for the reference's delegation of
flat search to FAISS C++ (/root/reference/smqtk_indexing/impls/nn_index/faiss.py:789-791):
the (N, d) descriptor matrix stays resident in device memory; a
``lax.scan`` streams row blocks through one matrix product each
(query @ blockᵀ), carrying a running (B, k)
best-distance/best-row state so the full (B, N) distance matrix is never
materialized. Scoring is a per-metric monotone surrogate (cheap inside the
scan); true distances are reconstructed only for the k selected rows.

Supported metrics: ``euclidean`` (L2), ``inner_product`` (returns -<q,x> as
the "distance" so ascending order = most similar), ``cosine`` (angular
distance in [0,1], pos_vectors=True semantics of
/root/reference/smqtk_indexing/utils/metrics.py:120-137), ``hik`` (histogram
intersection distance).
"""
from __future__ import annotations

import math
from functools import partial

from typing import Tuple

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.ops.device import SEG

METRICS = ("euclidean", "inner_product", "cosine", "hik", "chi_square")

#: Rows per streamed block. Must divide every device capacity, which
#: ops.device.capacity_for guarantees (capacities are 1024 * 2^m).
DEFAULT_CHUNK = 65536


def _chunk_scores(metric: str, q: jnp.ndarray, q_norm: jnp.ndarray,
                  x: jnp.ndarray, x_sq: jnp.ndarray,
                  x_norm: jnp.ndarray) -> jnp.ndarray:
    """
    (B, C) surrogate scores, lower = closer. Monotone in the true distance
    per query so top-k selection is exact; the true distance is produced by
    ``_finalize``.
    """
    if metric == "hik":
        # No matmul form exists: elementwise min on the VPU.
        return 1.0 - jnp.sum(
            jnp.minimum(q[:, None, :], x[None, :, :]), axis=-1)
    if metric == "chi_square":
        # Chi-square histogram distance (FLANN's CS_DISTANCE semantics as
        # exposed by the reference wrapper,
        # /root/reference/smqtk_indexing/impls/nn_index/flann.py:96-100):
        # sum over bins of (a-b)^2 / (a+b), empty bins contributing 0.
        s = q[:, None, :] + x[None, :, :]
        dlt = q[:, None, :] - x[None, :, :]
        return jnp.sum(jnp.where(s > 0, dlt * dlt / jnp.where(s > 0, s, 1.0),
                                 0.0), axis=-1)
    # precision=HIGHEST: a default-precision f32 product may run in TF32
    # (~10-bit mantissa) on the GPU's tensor cores, which on
    # O(||x||^2)-magnitude scores corrupts the surrogate *ranking* (true
    # neighbors drop out of the top-k before the exact re-rank can fix
    # them). bf16-stored databases are unaffected.
    ip = jnp.dot(q, x.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    if metric == "euclidean":
        # ||q||^2 omitted: constant per query, added in _finalize.
        return x_sq[None, :] - 2.0 * ip
    if metric == "inner_product":
        return -ip
    if metric == "cosine":
        denom = q_norm[:, None] * x_norm[None, :]
        denom = jnp.where(denom == 0, 1.0, denom)
        return -(ip / denom)
    raise ValueError(f"Unknown metric '{metric}'. Must be one of {METRICS}.")


def _finalize(metric: str, scores: jnp.ndarray,
              q_sq: jnp.ndarray) -> jnp.ndarray:
    """Map selected surrogate scores back to true distances."""
    if metric == "euclidean":
        return jnp.sqrt(jnp.maximum(scores + q_sq[:, None], 0.0))
    if metric == "cosine":
        sim = jnp.clip(-scores, -1.0, 1.0)
        return 2.0 * jnp.arccos(sim) / math.pi
    # inner_product (negated IP) and hik are already the reported distance.
    return scores


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def flat_topk(db: jnp.ndarray, db_sq: jnp.ndarray, db_norm: jnp.ndarray,
              valid: jnp.ndarray, q: jnp.ndarray, *, k: int,
              metric: str = "euclidean",
              chunk: int = DEFAULT_CHUNK):
    """
    Exhaustive top-k over a device-resident database: streamed score
    blocks with a carried running top-k (see module docstring). The
    two-stage segment-minima scan (:func:`flat_topk_two_stage`) serves the
    store instead on a GPU.

    :param db: (N, d) database matrix (rows beyond the live set zero-padded).
    :param db_sq: (N,) float32 squared L2 norms of rows.
    :param db_norm: (N,) float32 L2 norms of rows.
    :param valid: (N,) bool row-liveness mask (False rows never selected).
    :param q: (B, d) float32 query matrix (d matching db's padded dim).
    :param k: Neighbors per query (static; <= N).
    :param metric: One of METRICS (static).
    :param chunk: Streamed block size (static; N % chunk == 0 or N <= chunk).
    :return: (dists (B, k) float32 ascending, rows (B, k) int32). Entries
        beyond the number of valid rows carry +inf distance / row -1.
    """
    n, d = db.shape
    b = q.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    q_norm = jnp.sqrt(q_sq)
    qc = q.astype(db.dtype)

    if n <= chunk:
        scores = _chunk_scores(metric, qc, q_norm, db, db_sq, db_norm)
        scores = jnp.where(valid[None, :], scores, jnp.inf)
        neg, rows = jax.lax.top_k(-scores, k)
        return _exact_selected(metric, db, q, q_sq, -neg,
                               rows.astype(jnp.int32))

    num_chunks = n // chunk
    db_c = db.reshape(num_chunks, chunk, d)
    sq_c = db_sq.reshape(num_chunks, chunk)
    nm_c = db_norm.reshape(num_chunks, chunk)
    va_c = valid.reshape(num_chunks, chunk)
    base_rows = (jnp.arange(num_chunks, dtype=jnp.int32) * chunk)

    init = (jnp.full((b, k), jnp.inf, dtype=jnp.float32),
            jnp.full((b, k), -1, dtype=jnp.int32))

    def body(carry, blk):
        best_s, best_r = carry
        x, x_sq, x_norm, v, base = blk
        s = _chunk_scores(metric, qc, q_norm, x, x_sq, x_norm)
        s = jnp.where(v[None, :], s, jnp.inf)
        rows = base + jax.lax.broadcasted_iota(jnp.int32, (b, chunk), 1)
        cand_s = jnp.concatenate([best_s, s.astype(jnp.float32)], axis=1)
        cand_r = jnp.concatenate([best_r, rows], axis=1)
        neg, sel = jax.lax.top_k(-cand_s, k)
        return (-neg, jnp.take_along_axis(cand_r, sel, axis=1)), None

    (best_s, best_r), _ = jax.lax.scan(
        body, init, (db_c, sq_c, nm_c, va_c, base_rows))
    return _exact_selected(metric, db, q, q_sq, best_s, best_r)


#: Segment width for the streamed segment-minima filter (the fused
#: kernel's SEG, so the exactness argument is shared).
SEG_W = SEG


def topk_smallest(m: jnp.ndarray, kk: int, blk: int = 16
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exact top-kk SMALLEST over rows of (B, W) — the segment-minima
    recursion applied once more: at most kk blocks can have a block-min
    <= the kk-th smallest value (each such min is itself a value <= it,
    ties interchangeable), so the top-kk blocks by min contain every true
    top-kk element. One cheap (B, W/blk) top-k + a (B, kk*blk) top-k
    replace one full-width ``lax.top_k``.

    :return: (values ascending, indices) of shape (B, kk).
    """
    b, w = m.shape
    nb = w // blk
    if w % blk or nb <= kk:
        neg, idx = jax.lax.top_k(-m, kk)
        return -neg, idx.astype(jnp.int32)
    m3 = m.reshape(b, nb, blk)
    bmin = jnp.min(m3, axis=-1)
    _, bidx = jax.lax.top_k(-bmin, kk)                      # (b, kk)
    cand = jnp.take_along_axis(m3, bidx[:, :, None], axis=1) \
        .reshape(b, kk * blk)
    cid = (bidx[:, :, None] * blk
           + jax.lax.broadcasted_iota(jnp.int32, (b, kk, blk), 2)) \
        .reshape(b, kk * blk)
    neg, sel = jax.lax.top_k(-cand, kk)
    return -neg, jnp.take_along_axis(cid, sel, axis=1)


def streamed_segment_minima(score_fn, blocks, n: int, chunk: int,
                            bq: int, seg: int = SEG_W) -> jnp.ndarray:
    """
    Stream chunked score blocks and emit only per-``seg``-row minima —
    stage 1 of the two-stage scans (:func:`flat_topk_two_stage`,
    ops/sq8, ops/pq): each (B, chunk) score block reduces immediately and
    NO per-chunk ``lax.top_k`` runs (a per-chunk sort over every chunk is
    the cost the segment filter removes).

    :param score_fn: (chunk-slices of ``blocks``...) -> (bq, chunk)
        scores (+inf for dead rows).
    :param blocks: Arrays with leading dim n, chunked along it.
    :return: (bq, n // seg) float32 segment minima.
    """
    num_chunks = n // chunk
    blks = tuple(a.reshape((num_chunks, chunk) + a.shape[1:])
                 for a in blocks)

    def body(_, blk):
        s = score_fn(*blk)
        return None, jnp.min(s.reshape(bq, chunk // seg, seg), axis=-1)

    _, mins = jax.lax.scan(body, None, blks)
    return jnp.transpose(mins, (1, 0, 2)).reshape(bq, n // seg)


#: f32 products in the two-stage stage 1 run as three bf16 tensor-core
#: passes (x = hi + lo, hi = bf16(x): q.x = qh.xh + qh.xl + ql.xh, about
#: 1e-5 relative score error) against the k+8 segment margin; stage 2
#: re-ranks in exact f32. Measured faster than three TF32 passes end to
#: end (PERF.md).
STAGE1_F32 = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def segment_minima(db, sq, q, chunk: int = DEFAULT_CHUNK):
    """
    Stage 1 of :func:`flat_topk_two_stage`: per-query, per-SEG-row minima
    of ``sq - 2 <q, x>`` over the row-major database, streamed in
    (B, chunk) score blocks (f32 products at STAGE1_F32; bf16/int8 rows
    as bf16, exact for bf16 values, int8 codes and ±1 codes).

    :param db: (N, d) float32 / bfloat16 / int8, N % SEG == 0.
    :param sq: (N,) float32 per-row term (squared norms for euclidean,
        zeros for inner products; +inf masks dead rows).
    :param q: (B, d) float32.
    :return: (B, N // SEG) float32 segment minima.
    """
    n = db.shape[0]
    b = q.shape[0]
    chunk = min(chunk, n)
    if b < 16:
        # Products run as matrix-matrix (the multi-pass algorithm has no
        # matrix-vector lowering); the padding rows are sliced off.
        return segment_minima(
            db, sq, jnp.pad(q, ((0, 16 - b), (0, 0))), chunk)[:b]

    def score_fn(x, s):
        if x.dtype == jnp.float32:
            ip = jnp.dot(q, x.T, precision=STAGE1_F32,
                         preferred_element_type=jnp.float32)
        else:
            ip = jnp.dot(q.astype(jnp.bfloat16), x.astype(jnp.bfloat16).T,
                         preferred_element_type=jnp.float32)
        return s[None, :] - 2.0 * ip

    return streamed_segment_minima(score_fn, (db, sq), n, chunk, b)


@partial(jax.jit, static_argnames=("k", "metric"))
def flat_topk_two_stage(db: jnp.ndarray, db_sq: jnp.ndarray,
                        valid: jnp.ndarray, q: jnp.ndarray, *, k: int,
                        metric: str = "euclidean",
                        db_norm: jnp.ndarray = None
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exact exhaustive top-k in two stages: stage 1 keeps only per-SEG-row
    score minima (:func:`segment_minima`), the top S = min(max(k + 8, 16),
    N/SEG) segments per query are gathered whole, and stage 2 re-ranks
    their rows in exact f32. Exactness of the segment pre-selection: every
    row of the true top-k has score <= theta (the kth best), so its
    segment's minimum is <= theta; at most k distinct segment minima can
    be <= theta (each minimum is itself a score), so the top-(k + margin)
    segments by minimum contain every true top-k row with slack for ties
    and for stage 1's ~1e-5 relative score error (STAGE1_F32).

    Metrics: 'euclidean' (sq - 2*ip surrogate); 'inner_product' (zero sq,
    so -2*ip); 'cosine' (rows and query normalized for stage 1, so -2*cos;
    needs ``db_norm``, and stage 2 computes the angular distance from the
    raw rows).

    :return: the contract of :func:`flat_topk`: (dists (B, k) ascending,
        rows (B, k) int32; +inf / -1 padding).
    """
    assert metric in ("euclidean", "inner_product", "cosine")
    n, d = db.shape
    b = q.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    q_norm = jnp.sqrt(q_sq)
    q_stage1 = q
    db_stage1 = db
    if metric == "inner_product":
        db_sq = jnp.zeros_like(db_sq)
    elif metric == "cosine":
        assert db_norm is not None, "cosine needs db_norm"
        db_sq = jnp.zeros_like(db_sq)
        q_stage1 = q / jnp.where(q_norm == 0, 1.0, q_norm)[:, None]
        nrm = jnp.where(db_norm == 0, 1.0, db_norm)
        db_stage1 = (db.astype(jnp.float32) / nrm[:, None]).astype(db.dtype)
    # Exactness needs only k-1 segments (each segment-min < theta_k is
    # itself a distinct score < theta_k); +8 absorbs ties at theta_k, where
    # any tie choice is a valid top-k.
    s_keep = min(max(k + 8, 16), n // SEG)
    minima = segment_minima(
        db_stage1, jnp.where(valid, db_sq, jnp.inf).astype(jnp.float32),
        q_stage1)
    smin, sid = topk_smallest(minima, s_keep)
    sid = jnp.where(jnp.isinf(smin), -1, sid)

    # Stage 2: gather kept segments' rows; exact distances; final top-k.
    # Per-row side arrays gather SEGMENT-SHAPED ((b, s_keep, SEG) blocks
    # of 128 contiguous elements), not as scattered single elements.
    sid_c = jnp.maximum(sid, 0)
    rows = (sid_c[..., None] * SEG
            + jax.lax.broadcasted_iota(jnp.int32, (b, s_keep, SEG), 2))
    rows_flat = rows.reshape(b, s_keep * SEG)
    alive = (sid[..., None] >= 0) \
        & jnp.take(valid.reshape(n // SEG, SEG), sid_c, axis=0)
    alive = alive.reshape(b, s_keep * SEG)
    cand = jnp.take(db.reshape(n // SEG, SEG, d), sid_c, axis=0) \
        .reshape(b, s_keep * SEG, d).astype(jnp.float32)
    if metric == "inner_product":
        exact = -jnp.sum(cand * q[:, None, :], axis=-1)
    elif metric == "cosine":
        cn = jnp.take(db_norm.reshape(n // SEG, SEG), sid_c, axis=0) \
            .reshape(b, s_keep * SEG)
        ip = jnp.sum(cand * q[:, None, :], axis=-1)
        denom = q_norm[:, None] * cn
        sim = jnp.clip(ip / jnp.where(denom == 0, 1.0, denom), -1.0, 1.0)
        exact = 2.0 * jnp.arccos(sim) / math.pi
    else:
        diff = cand - q[:, None, :]
        exact = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
    exact = jnp.where(alive, exact, jnp.inf)
    out_d, sel = topk_smallest(exact, k)
    out_rows = jnp.take_along_axis(rows_flat, sel, axis=1) \
        .astype(jnp.int32)
    out_rows = jnp.where(jnp.isinf(out_d), -1, out_rows)
    return out_d, out_rows


def exact_rerank_decoded(x: jnp.ndarray, q: jnp.ndarray,
                         q_norm: jnp.ndarray, best_s: jnp.ndarray,
                         best_r: jnp.ndarray, metric: str, k: int):
    """
    Shared exact-re-rank epilogue for the compressed-codec scans
    (ops/sq8.sq8_topk, ops/pq.pq_topk, ops/ivf.ivf_query_pq): given the
    kk surrogate winners ALREADY DECODED to float32 rows, compute exact
    per-metric distances, re-sort, and emit the final (B, k) results.
    One implementation so the margin/tie semantics cannot diverge.

    :param x: (B, kk, d) float32 exactly decoded candidate rows.
    :param best_s: (B, kk) surrogate scores (+inf marks empty slots).
    :param best_r: (B, kk) int32 rows (-1 marks empty slots).
    :return: (dists (B, k) ascending, rows (B, k); +inf / -1 padding).
    """
    if metric == "euclidean":
        diff = x - q[:, None, :]
        exact = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
    elif metric == "inner_product":
        exact = -jnp.sum(x * q[:, None, :], axis=-1)
    elif metric == "cosine":
        ipx = jnp.sum(x * q[:, None, :], axis=-1)
        xn = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1), 0.0))
        denom = q_norm[:, None] * xn
        sim = jnp.clip(ipx / jnp.where(denom == 0, 1.0, denom),
                       -1.0, 1.0)
        exact = 2.0 * jnp.arccos(sim) / math.pi
    else:  # hik
        exact = 1.0 - jnp.sum(jnp.minimum(q[:, None, :], x), axis=-1)
    exact = jnp.where(jnp.isinf(best_s) | (best_r < 0), jnp.inf, exact)
    k_out = min(k, exact.shape[1])
    neg, sel = jax.lax.top_k(-exact, k_out)
    out_d = -neg
    out_rows = jnp.take_along_axis(best_r, sel, axis=1)
    out_rows = jnp.where(jnp.isinf(out_d), -1, out_rows)
    return pad_to_k(out_d, out_rows, k)


def pad_to_k(dists: jnp.ndarray, rows: jnp.ndarray, k: int):
    """Honor the (B, k) return contract when a candidate budget caps the
    selection width below k: truncate to k and pad with +inf / -1. The
    ONE implementation of this epilogue — the tiled score-mode finisher
    (ops/ivf_code) and the sharded per-shard merges
    (parallel/sharded_ivf_code) share it."""
    b, kk = dists.shape
    d_out, r_out = dists[:, :k], rows[:, :k]
    if kk < k:
        pad = k - kk
        d_out = jnp.concatenate(
            [d_out, jnp.full((b, pad), jnp.inf, d_out.dtype)], axis=1)
        r_out = jnp.concatenate(
            [r_out, jnp.full((b, pad), -1, jnp.int32)], axis=1)
    return d_out, r_out


def _exact_selected(metric: str, db: jnp.ndarray, q: jnp.ndarray,
                    q_sq: jnp.ndarray, scores: jnp.ndarray,
                    rows: jnp.ndarray, dq=None):
    """
    Reconstruct true distances for the selected (B, k) rows, re-sorted
    ascending. For L2 the surrogate (x_sq - 2ip) suffers catastrophic
    cancellation at tiny distances, so the k winners are re-computed exactly
    from a (B, k, d) gather — the fused, on-device analog of the reference's
    host-side exact re-rank
    (/root/reference/smqtk_indexing/impls/nn_index/faiss.py:818-827). Other
    metrics' surrogates finalize without cancellation.

    :param dq: Optional (a, b) SQ8 codec arrays when ``db`` holds int8
        codes — gathered rows dequantize before the exact distance.
    """
    if metric != "euclidean":
        return _finalize(metric, scores, q_sq), rows
    sel = jnp.take(db, jnp.maximum(rows, 0), axis=0).astype(jnp.float32)
    if dq is not None:
        sel = sel * dq[0] + dq[1]
    diff = sel - q[:, None, :]
    exact = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
    # Rows never filled (index -1 / +inf surrogate) stay +inf.
    exact = jnp.where(jnp.isinf(scores), jnp.inf, exact)
    # Exact values may reorder near-ties relative to the surrogate ranking.
    order = jnp.argsort(exact, axis=1)
    return (jnp.take_along_axis(exact, order, axis=1),
            jnp.take_along_axis(rows, order, axis=1))


def rerank_exact(metric: str, q: jnp.ndarray,
                 cand: jnp.ndarray) -> jnp.ndarray:
    """
    Exact distances from one query (d,) to candidate rows (M, d) — the fused
    analog of the reference's host-side exact re-rank after ANN retrieval
    (/root/reference/smqtk_indexing/impls/nn_index/faiss.py:818-827).
    """
    qb = q[None, :]
    if metric == "euclidean":
        diff = cand - qb
        return jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
    if metric == "cosine":
        qn = jnp.linalg.norm(qb, axis=-1)
        cn = jnp.linalg.norm(cand, axis=-1)
        denom = jnp.where(qn * cn == 0, 1.0, qn * cn)
        sim = jnp.clip(jnp.sum(cand * qb, axis=-1) / denom, -1.0, 1.0)
        return 2.0 * jnp.arccos(sim) / math.pi
    if metric == "hik":
        return 1.0 - jnp.sum(jnp.minimum(qb, cand), axis=-1)
    if metric == "chi_square":
        s = qb + cand
        dlt = qb - cand
        return jnp.sum(jnp.where(s > 0, dlt * dlt / jnp.where(s > 0, s, 1.0),
                                 0.0), axis=-1)
    if metric == "inner_product":
        return -jnp.sum(cand * qb, axis=-1)
    raise ValueError(f"Unknown metric '{metric}'.")
