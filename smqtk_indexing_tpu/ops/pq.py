"""
PQ (product quantization) codec + exhaustive scan.

The reference exposes FAISS product quantization through its factory
grammar (``PQ16`` etc.,
/root/reference/smqtk_indexing/impls/nn_index/faiss.py:190,368-386): d
dimensions split into M subspaces, each quantized to one of 256 learned
centroids — M bytes per vector (16 bytes at PQ16/d=128, 32x smaller than
float32).

Device-first formulation: FAISS's ADC scan (dist = Σ_m LUT[m, code_m]) is a
per-element table gather, which a matrix unit cannot run. Two matmul
formulations exist:

- ADC-as-matmul: one_hot(codes) (N, M*256) @ LUT (B, M*256)^T. Costs
  B * N * M * 256 MACs — at B=128, M=16 that is 32x the raw-scan matmul.
- **Dequantize-then-scan (used here)**: per streamed chunk, reconstruct
  x_hat = one_hot(codes_m) @ codebook_m per subspace (M small matmuls,
  256 * d MACs per ROW — amortized over the whole query batch), then score
  all B queries against the chunk with the standard surrogate matmul.
  Total (256 + B) * N * d MACs — ~10x cheaper than ADC-as-matmul at
  B=128, all matmul-shaped, and it reuses the SQ8 scan's streaming top-k and
  exact-re-rank skeleton (ops/sq8.py).

Because subspaces partition the dimensions, ||x_hat||^2 = Σ_m ||c_m||^2
exactly — per-row stats come from a one-hot matmul against the codebook
norm table, never from materializing the decoded matrix.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

PQ_METRICS = ("euclidean", "inner_product", "cosine", "hik")

#: Rows per streamed block (divides every 1024*2^m capacity).
DEFAULT_CHUNK = 65536

#: Centroids per subspace (8-bit codes, the FAISS PQ default).
K_SUB = 256


def pq_train(mat: np.ndarray, m: int, n_iter: int = 20,
             seed: int = 0, init: np.ndarray = None) -> np.ndarray:
    """
    Learn per-subspace codebooks with device k-means (ops/kmeans.py) —
    all M subspaces train in ONE vmapped Lloyd dispatch (a serial
    per-subspace loop pays one dispatch per subspace per call; OPQ's
    alternation multiplies that by its iteration count).

    :param mat: (n, d) float32 training rows (d % m == 0).
    :param m: Subquantizer count (bytes per vector).
    :param init: Optional (m, 256, d // m) warm-start codebooks (the OPQ
        alternation carries codebooks across rotation updates).
    :return: (m, 256, d // m) float32 codebooks.
    """
    n, d = mat.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subquantizers")
    dsub = d // m
    subs = np.ascontiguousarray(
        mat.reshape(n, m, dsub).transpose(1, 0, 2).astype(np.float32))
    if init is None:
        rng = np.random.default_rng(seed)
        k_eff = min(K_SUB, n)
        sel = rng.choice(n, k_eff, replace=False)
        init = subs[:, sel]                          # (m, k_eff, dsub)
        if k_eff < K_SUB:
            # Duplicate-padding keeps shapes static; extra centroids
            # just tie and never hurt assignment.
            init = np.concatenate(
                [init, init[:, rng.integers(0, k_eff, K_SUB - k_eff)]],
                axis=1)
    cents = _pq_train_vmapped(jnp.asarray(subs),
                              jnp.asarray(np.asarray(init, np.float32)),
                              n_iter=n_iter)
    return np.asarray(cents)


@partial(jax.jit, static_argnames=("n_iter",))
def _pq_train_vmapped(subs: jnp.ndarray, inits: jnp.ndarray, *,
                      n_iter: int) -> jnp.ndarray:
    """(m, n, dsub) subspace stacks + (m, 256, dsub) inits -> (m, 256,
    dsub) codebooks, one program for all subquantizers."""
    from smqtk_indexing_tpu.ops.kmeans import kmeans_lloyd

    valid = jnp.ones(subs.shape[1], dtype=bool)
    return jax.vmap(
        lambda s, i: kmeans_lloyd(s, valid, i, n_iter=n_iter)[0]
    )(subs, inits)


@partial(jax.jit, static_argnames=())
def _encode_block(sub: jnp.ndarray, cb: jnp.ndarray) -> jnp.ndarray:
    """(n, dsub) rows x (256, dsub) centroids -> (n,) uint8 nearest ids."""
    c_sq = jnp.sum(cb * cb, axis=-1)
    ip = jnp.dot(sub, cb.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    return jnp.argmin(c_sq[None, :] - 2.0 * ip, axis=1).astype(jnp.uint8)


def pq_encode_np(mat: np.ndarray, codebooks: np.ndarray,
                 chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Host wrapper: encode rows to (n, M) uint8 codes, chunked on device."""
    n, d = mat.shape
    m, _, dsub = codebooks.shape
    codes = np.zeros((n, m), dtype=np.uint8)
    for lo in range(0, n, chunk):
        blk = jnp.asarray(mat[lo:lo + chunk].astype(np.float32))
        for mi in range(m):
            codes[lo:lo + chunk, mi] = np.asarray(_encode_block(
                blk[:, mi * dsub:(mi + 1) * dsub],
                jnp.asarray(codebooks[mi])))
    return codes


def pq_decode_np(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """(n, M) uint8 -> (n, d) float32 reconstruction (host)."""
    return np.concatenate(
        [codebooks[mi][codes[:, mi]] for mi in range(codebooks.shape[0])],
        axis=1)


def pq_codec_dim(d_pad: int, m: int) -> int:
    """Codec-grid width: the lane-padded dim rounded UP to a multiple of
    the subquantizer count, so FAISS-valid configurations whose M does
    not divide 128 (e.g. d=96 with PQ12) still build — the extra zero
    dims quantize exactly and contribute nothing to any metric."""
    return -(-d_pad // m) * m


def pq_build_store(host: np.ndarray, valid_mask: np.ndarray,
                   capacity: int, d_pad: int, m: int,
                   rotate: bool = False, seed: int = 0, codec=None):
    """
    The one shared PQ store build (used by both the flat VectorStore and
    the IVF CSR store so codec details cannot diverge): round-robin dim
    interleave over the codec grid (zero-padding would otherwise pack
    every real dim into the first subspaces), train-per-build codebooks
    over the live rows, encode, exact recon-norm stats.

    :param host: (n, dim) float32 raw rows (any order).
    :param valid_mask: (n,) bool liveness.
    :param rotate: Learn an OPQ rotation (ops/opq.opq_train) composed
        after the interleave — the reference's 'OPQ<M>,...' pre-transform
        (faiss.py:182-199). Serving paths are untouched (L2/IP/cosine are
        rotation invariant); only encode/prep apply ``rot``.
    :return: (perm (d_codec,) int32, rot (d_codec, d_codec) f32 | None,
        codebooks np (m, 256, dsub) f32, codebooks device,
        codes device (capacity, m) uint8, s2 device (capacity,) f32).
    """
    from smqtk_indexing_tpu.ops.device import pad_rows_np

    if m > host.shape[1]:
        raise ValueError(
            f"PQ{m}: more subquantizers than dims ({host.shape[1]}).")
    d_codec = pq_codec_dim(d_pad, m)
    n = host.shape[0]
    if codec is not None:
        # Train-once contract (FAISS quantizer semantics): capacity
        # growth and compaction re-uploads reuse the build-time
        # (perm, rot, codebooks) so existing rows keep their distances.
        perm, rot, cb = codec
    else:
        perm = np.argsort(np.arange(d_codec) % m,
                          kind="stable").astype(np.int32)
        live = host[valid_mask] if not valid_mask.all() else host
        live_p = pad_rows_np(live, live.shape[0], d_codec)
        rot = None
        if rotate:
            from smqtk_indexing_tpu.ops.opq import opq_train
            rot, cb = opq_train(live_p[:, perm], m, seed=seed)
        else:
            cb = pq_train(live_p[:, perm], m)
    codes = np.zeros((capacity, m), dtype=np.uint8)
    rows_c = pad_rows_np(host, n, d_codec)[:, perm]
    codes[:n] = pq_encode_np(
        rows_c @ rot if rot is not None else rows_c, cb)
    cb_dev = jnp.asarray(cb)
    codes_dev = jnp.asarray(codes)
    s2 = pq_row_stats(codes_dev, cb_dev)
    return perm, rot, cb, cb_dev, codes_dev, s2


def pq_residual_build_store(host: np.ndarray, valid_mask: np.ndarray,
                            capacity: int, d_pad: int, m: int,
                            cents_pad: np.ndarray, assigns: np.ndarray,
                            rotate: bool = False, seed: int = 0):
    """
    Residual-encoded IVF-PQ build (FAISS's ``by_residual=True`` default
    for 'IVF<n>,PQ<M>', the reference's index_factory configuration):
    the codec quantizes ``x - centroid(assigned list)`` instead of raw
    rows, so PQ only carries the (much smaller) intra-cell offset —
    reconstruction error scales with the residual magnitude, not the
    data magnitude. Euclidean-only (the serving score needs the
    per-probe ``-2<q, c>`` term, which only the L2 probe selection
    computes).

    Geometry lives entirely in the transformed codec space T =
    interleave (+ optional OPQ rotation learned on the RESIDUALS):
    ``x_hat_T = c_T[list] + decode(code)``; orthogonality of T makes
    every distance equal its original-space counterpart.

    :param host: (n, dim) float32 raw rows in LIST-SORTED order.
    :param cents_pad: (C, d_pad) float32 lane-padded centroids.
    :param assigns: (n,) int32 original-list assignment per row.
    :return: (perm, rot | None, codebooks np, codebooks dev,
        codes dev (capacity, m) uint8, s2_full dev (capacity,) f32
        (= ||c_T + r_hat||^2), cents_T np (C, d_codec) f32,
        row2list dev (capacity,) int32).
    """
    from smqtk_indexing_tpu.ops.device import pad_rows_np

    if m > host.shape[1]:
        raise ValueError(
            f"PQ{m}: more subquantizers than dims ({host.shape[1]}).")
    d_codec = pq_codec_dim(d_pad, m)
    perm = np.argsort(np.arange(d_codec) % m,
                      kind="stable").astype(np.int32)
    n = host.shape[0]
    cents_c = pad_rows_np(cents_pad.astype(np.float32),
                          cents_pad.shape[0], d_codec)[:, perm]
    res = pad_rows_np(host, n, d_codec)[:, perm] - cents_c[assigns]
    live = res[valid_mask] if not valid_mask.all() else res
    rot = None
    if rotate:
        from smqtk_indexing_tpu.ops.opq import opq_train
        rot, cb = opq_train(live, m, seed=seed)
        res = res @ rot
        cents_c = np.ascontiguousarray(cents_c @ rot)
    else:
        cb = pq_train(live, m)
    codes = np.zeros((capacity, m), dtype=np.uint8)
    codes[:n] = pq_encode_np(res, cb)
    row2list = np.zeros(capacity, dtype=np.int32)
    row2list[:n] = assigns
    cb_dev = jnp.asarray(cb)
    codes_dev = jnp.asarray(codes)
    row2list_dev = jnp.asarray(row2list)
    s2 = pq_residual_stats(codes_dev, cb_dev, jnp.asarray(cents_c),
                           row2list_dev)
    return perm, rot, cb, cb_dev, codes_dev, s2, cents_c, row2list_dev


@partial(jax.jit, static_argnames=("chunk",))
def pq_residual_stats(codes: jnp.ndarray, codebooks: jnp.ndarray,
                      cents_c: jnp.ndarray, row2list: jnp.ndarray,
                      chunk: int = DEFAULT_CHUNK) -> jnp.ndarray:
    """(N,) float32 ``||c_T[row] + r_hat||^2`` — the residual codec's
    full reconstruction norms (chunked decode; exact f32 one-hot
    dequant)."""
    n, m = codes.shape

    def stats_of(cc, lids):
        x = _dequant(cc, codebooks, dtype=jnp.float32) \
            + jnp.take(cents_c, lids, axis=0)
        return jnp.sum(x * x, axis=-1)

    if n <= chunk:
        return stats_of(codes, row2list)
    num_chunks = n // chunk
    _, s2 = jax.lax.scan(
        lambda _, blk: (None, stats_of(*blk)), None,
        (codes.reshape(num_chunks, chunk, m),
         row2list.reshape(num_chunks, chunk)))
    return s2.reshape(n)


def pq_prep_queries(q_pad: np.ndarray, perm: np.ndarray,
                    rot: np.ndarray = None) -> np.ndarray:
    """Extend lane-padded queries to the codec grid, interleave, and
    (OPQ) rotate — the one query-side transform shared by every PQ
    serving path."""
    b, dp = q_pad.shape
    if len(perm) > dp:
        q_pad = np.concatenate(
            [q_pad, np.zeros((b, len(perm) - dp), q_pad.dtype)], axis=1)
    q_c = q_pad[:, perm]
    return q_c @ rot if rot is not None else q_c


def _dequant(codes_c: jnp.ndarray, cb: jnp.ndarray,
             dtype=jnp.bfloat16) -> jnp.ndarray:
    """
    (chunk, M) codes -> (chunk, d) reconstruction via one one-hot matmul
    per subspace (one-hot rows are exact in any dtype, so bf16 only rounds
    the CENTROID values — absorbed by the k+8 margin + f32 exact re-rank).
    The f32 path runs at Precision.HIGHEST: a default-precision f32
    product may run in TF32, which would silently corrupt the "exact"
    decode.
    """
    m = cb.shape[0]
    prec = jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None
    outs = []
    for mi in range(m):
        oh = jax.nn.one_hot(codes_c[:, mi].astype(jnp.int32), K_SUB,
                            dtype=dtype)
        outs.append(jnp.dot(oh, cb[mi].astype(dtype),
                            preferred_element_type=jnp.float32,
                            precision=prec))
    return jnp.concatenate(outs, axis=1)


@partial(jax.jit, static_argnames=("chunk",))
def pq_row_stats(codes: jnp.ndarray, codebooks: jnp.ndarray,
                 chunk: int = DEFAULT_CHUNK) -> jnp.ndarray:
    """
    (N,) float32 squared reconstruction norms: subspaces partition the
    dims, so ||x_hat||^2 = Σ_m ||c_{m, code_m}||^2 — an exact one-hot
    lookup into the f32 codebook norm table (no decode materialization).
    """
    n, m = codes.shape
    cb_sq = jnp.sum(codebooks * codebooks, axis=-1)  # (M, 256) f32

    def stats_of(cc):
        s = jnp.zeros((cc.shape[0],), jnp.float32)
        for mi in range(m):
            oh = jax.nn.one_hot(cc[:, mi].astype(jnp.int32), K_SUB,
                                dtype=jnp.float32)
            # HIGHEST: exact f32 table lookup (default-precision f32
            # products may run in TF32).
            s = s + jnp.dot(oh, cb_sq[mi],
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        return s

    if n <= chunk:
        return stats_of(codes)
    num_chunks = n // chunk
    _, s2 = jax.lax.scan(
        lambda _, cc: (None, stats_of(cc)), None,
        codes.reshape(num_chunks, chunk, m))
    return s2.reshape(n)


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def pq_topk(codes: jnp.ndarray, codebooks: jnp.ndarray, s2: jnp.ndarray,
            valid: jnp.ndarray, q: jnp.ndarray, *, k: int,
            metric: str = "euclidean", chunk: int = DEFAULT_CHUNK
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exhaustive top-k over a PQ-coded database (streamed
    dequantize-then-scan; same selection/re-rank skeleton as
    ops/sq8.sq8_topk — distances are exact w.r.t. the reconstructed
    vectors, the codec being the only loss, as with FAISS PQ).

    :param codes: (N, M) uint8 codes (dead rows anything; masked).
    :param codebooks: (M, 256, d // M) float32.
    :param s2: (N,) float32 squared reconstruction norms
        (:func:`pq_row_stats`).
    :param valid: (N,) bool row liveness.
    :param q: (B, d) float32 queries.
    :return: (dists (B, k) float32 ascending, rows (B, k) int32;
        +inf / -1 padding).
    """
    if metric not in PQ_METRICS:
        raise ValueError(
            f"metric must be one of {PQ_METRICS}, got {metric!r}")
    n, m = codes.shape
    bq = q.shape[0]
    q = q.astype(jnp.float32)
    q_norm = jnp.sqrt(jnp.sum(q * q, axis=-1))

    kk = min(k + 8, n)  # margin absorbs bf16 surrogate noise at the edge

    def scores_of(codes_c, s2_c, va_c):
        x = _dequant(codes_c, codebooks)                 # (chunk, d) f32
        if metric == "hik":
            s = 1.0 - jnp.sum(jnp.minimum(q[:, None, :], x[None, :, :]),
                              axis=-1)
        else:
            ip = jnp.dot(q.astype(jnp.bfloat16),
                         x.astype(jnp.bfloat16).T,
                         preferred_element_type=jnp.float32)
            if metric == "inner_product":
                s = -ip
            elif metric == "cosine":
                nrm_c = jnp.sqrt(jnp.maximum(s2_c, 0.0))
                denom = q_norm[:, None] * nrm_c[None, :]
                s = -(ip / jnp.where(denom == 0, 1.0, denom))
            else:  # euclidean
                s = s2_c[None, :] - 2.0 * ip
        return jnp.where(va_c[None, :], s, jnp.inf)

    if n <= chunk:
        s = scores_of(codes, s2, valid)
        neg, rows = jax.lax.top_k(-s, kk)
        best_s, best_r = -neg, rows.astype(jnp.int32)
    else:
        # Two-stage streaming — see ops/sq8.sq8_topk: stream segment
        # minima only (no per-chunk top-k sorts), rescore the k+16 best
        # segments' rows, keep kk row winners for the exact re-rank.
        from smqtk_indexing_tpu.ops.scan import topk_smallest
        from smqtk_indexing_tpu.ops.scan import (
            SEG_W, streamed_segment_minima,
        )
        minima = streamed_segment_minima(
            scores_of, (codes, s2, valid), n, chunk, bq)
        s_keep = min(k + 16, n // SEG_W)
        smin, sid = topk_smallest(minima, s_keep)
        sid = jnp.where(jnp.isinf(smin), -1, sid)
        sid_c = jnp.maximum(sid, 0)
        m_rows = s_keep * SEG_W
        rows = (sid_c[..., None] * SEG_W
                + jax.lax.broadcasted_iota(jnp.int32,
                                           (bq, s_keep, SEG_W), 2)) \
            .reshape(bq, m_rows)
        cand_codes = jnp.take(codes.reshape(n // SEG_W, SEG_W, m), sid_c,
                              axis=0).reshape(bq * m_rows, m)
        x = _dequant(cand_codes, codebooks).reshape(bq, m_rows, -1)

        def seg_gather(arr1d):
            return jnp.take(arr1d.reshape(n // SEG_W, SEG_W), sid_c,
                            axis=0).reshape(bq, m_rows)

        alive = (sid[..., None] >= 0) \
            & jnp.take(valid.reshape(n // SEG_W, SEG_W), sid_c, axis=0)
        alive = alive.reshape(bq, m_rows)
        if metric == "hik":
            s = 1.0 - jnp.sum(jnp.minimum(q[:, None, :], x), axis=-1)
        else:
            ip = jnp.einsum("bmd,bd->bm", x.astype(jnp.bfloat16),
                            q.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
            if metric == "inner_product":
                s = -ip
            elif metric == "cosine":
                denom = q_norm[:, None] * jnp.sqrt(
                    jnp.maximum(seg_gather(s2), 0.0))
                s = -(ip / jnp.where(denom == 0, 1.0, denom))
            else:
                s = seg_gather(s2) - 2.0 * ip
        s = jnp.where(alive, s, jnp.inf)
        sv, sel = topk_smallest(s, kk)
        best_s = sv
        best_r = jnp.take_along_axis(rows, sel, axis=1).astype(jnp.int32)
        best_r = jnp.where(jnp.isinf(best_s), -1, best_r)

    # Exact f32 re-rank of the kk winners from exactly decoded rows.
    from smqtk_indexing_tpu.ops.scan import exact_rerank_decoded
    sel_codes = jnp.take(codes, jnp.maximum(best_r, 0), axis=0)  # (B,kk,M)
    x = _dequant(sel_codes.reshape(bq * kk, m),
                 codebooks, dtype=jnp.float32).reshape(bq, kk, -1)
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)
