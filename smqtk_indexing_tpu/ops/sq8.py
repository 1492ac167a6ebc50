"""
SQ8 scalar-quantized vector codec + exhaustive scan.

The capacity tier the reference exposes through FAISS's factory grammar
(``SQ8`` / ``PQx`` codecs,
/root/reference/smqtk_indexing/impls/nn_index/faiss.py:190,368-386): vectors
are stored as one int8 code per dimension with a per-dimension affine codec
(x_d ~= a_d * u_d + b_d), cutting device-memory residency 4x vs float32.

The scan never dequantizes the database. With
r = q - b and t = r * a,

    ||q - x_hat||^2 = sum(r^2) - 2 * <t, u> + sum(a^2 u^2)

so the streamed score block is ONE matmul of the query-side ``t`` against
the raw int8 codes (cast to bfloat16 in-register — integers in [-127, 127]
are exact in bf16, so the tensor cores see exact code values) plus a
precomputed
per-row ``s2 = sum(a^2 u^2)`` — the same surrogate shape as the float scan
(ops/scan.py). Selection carries a k+8 margin and the winners are re-scored
from dequantized float32 rows, so reported distances are exact with respect
to the quantized vectors (the codec itself is the only loss, as with FAISS
SQ8 — recall is measured against the float ground truth by the benchmarks).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

SQ8_METRICS = ("euclidean", "inner_product", "cosine", "hik")

#: Rows per streamed block (divides every 1024*2^m capacity).
DEFAULT_CHUNK = 65536


def sq8_train(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """
    Fit the per-dimension affine codec from a training matrix: ``a`` spans
    the observed range over the 254-step int8 grid, ``b`` centers it.

    :return: (a (d,) float32 scale, b (d,) float32 offset).
    """
    mn = mat.min(axis=0).astype(np.float64)
    mx = mat.max(axis=0).astype(np.float64)
    a = (mx - mn) / 254.0
    # Constant dimensions still decode exactly: a=0 is degenerate for
    # encode division, so floor it at a tiny epsilon (codes become 0 and
    # b reproduces the constant).
    a = np.maximum(a, 1e-12)
    b = (mx + mn) / 2.0
    return a.astype(np.float32), b.astype(np.float32)


def sq8_encode_np(mat: np.ndarray, a: np.ndarray, b: np.ndarray
                  ) -> np.ndarray:
    """Quantize rows to int8 codes (host-side, for store mirrors)."""
    u = np.rint((mat.astype(np.float32) - b) / a)
    return np.clip(u, -127, 127).astype(np.int8)


@jax.jit
def sq8_encode(mat: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
               ) -> jnp.ndarray:
    """Quantize rows to int8 codes (device-side, for on-device builds)."""
    u = jnp.rint((mat.astype(jnp.float32) - b) / a)
    return jnp.clip(u, -127, 127).astype(jnp.int8)


def sq8_decode(codes: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
               ) -> jnp.ndarray:
    """Dequantize int8 codes to float32 rows."""
    return codes.astype(jnp.float32) * a + b


def sq8_build_store(host: np.ndarray, valid_mask: np.ndarray,
                    capacity: int, d_pad: int, dim: int, codec=None):
    """
    The one shared SQ8 store build (flat VectorStore and the IVF CSR
    store both call it so codec details cannot diverge): per-dim codec
    trained over the live rows, padding dims get scale epsilon / offset
    0 so zero-padded codes and queries contribute nothing to any score
    term.

    :return: (a_dev (d_pad,), b_dev (d_pad,), codes_dev (capacity, d_pad)
        int8, s2 (capacity,), nrm (capacity,)).
    """
    n = host.shape[0]
    if codec is not None:
        # Train-once contract (FAISS scalar quantizer): capacity growth
        # and compaction re-uploads reuse the build-time codec so
        # already-indexed rows keep their distances.
        a, b = codec
    else:
        live = host[valid_mask] if not valid_mask.all() else host
        a, b = sq8_train(live)
    a_p = np.full(d_pad, 1e-12, dtype=np.float32)
    b_p = np.zeros(d_pad, dtype=np.float32)
    a_p[:dim] = a
    b_p[:dim] = b
    codes = np.zeros((capacity, d_pad), dtype=np.int8)
    codes[:n, :dim] = sq8_encode_np(host, a, b)
    a_dev = jnp.asarray(a_p)
    b_dev = jnp.asarray(b_p)
    codes_dev = jnp.asarray(codes)
    s2, nrm = sq8_row_stats(codes_dev, a_dev, b_dev)
    return a_dev, b_dev, codes_dev, s2, nrm


@jax.jit
def sq8_row_stats(codes: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Per-row constants the scan needs: ``s2 = sum(a^2 u^2)`` (the quadratic
    code term of the L2 expansion) and the dequantized row L2 norm (cosine).
    """
    u = codes.astype(jnp.float32)
    s2 = jnp.sum((a * u) ** 2, axis=-1)
    x = u * a + b
    nrm = jnp.sqrt(jnp.sum(x * x, axis=-1))
    return s2, nrm


def _code_ip(t: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """(B, C) inner products of query-side t against int8 codes: codes cast
    to bf16 in-register (integers in [-127,127] are EXACT in bf16, so the
    product sees true code values; t's bf16 rounding is ~2^-8 relative
    score noise absorbed by the k+8 selection margin + exact re-rank)."""
    return jnp.dot(t.astype(jnp.bfloat16), codes.astype(jnp.bfloat16).T,
                   preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def sq8_topk(codes: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray,
             s2: jnp.ndarray, nrm: jnp.ndarray, valid: jnp.ndarray,
             q: jnp.ndarray, *, k: int, metric: str = "euclidean",
             chunk: int = DEFAULT_CHUNK
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exhaustive top-k over an SQ8-coded database.

    Streaming structure mirrors ops/scan.flat_topk (running top-k over
    chunked score blocks); the score matmul reads int8 codes only. The
    final k winners (selected with a k+8 margin) are dequantized and
    re-scored in float32, so returned distances are exact w.r.t. the
    quantized vectors.

    :param codes: (N, d) int8 codes (rows beyond the live set zeroed).
    :param a: (d,) float32 codec scales.
    :param b: (d,) float32 codec offsets.
    :param s2: (N,) float32 per-row sum((a*u)^2).
    :param nrm: (N,) float32 dequantized row norms.
    :param valid: (N,) bool row liveness.
    :param q: (B, d) float32 queries.
    :return: (dists (B, k) float32 ascending, rows (B, k) int32;
        +inf / -1 padding).
    """
    if metric not in SQ8_METRICS:
        raise ValueError(
            f"metric must be one of {SQ8_METRICS}, got {metric!r}")
    n, d = codes.shape
    bq = q.shape[0]
    q = q.astype(jnp.float32)
    q_norm = jnp.sqrt(jnp.sum(q * q, axis=-1))
    if metric == "euclidean":
        t = (q - b[None, :]) * a[None, :]
    else:
        # inner_product / cosine: <q, x_hat> = <q*a, u> + <q, b>. The
        # constant <q, b> shifts every score of a query equally for IP
        # (rank-free) but matters inside cosine's normalization — fold it
        # in by augmenting u with a constant 1 column? Cheaper: keep the
        # matmul pure and add the constant into the score via s2's slot.
        t = q * a[None, :]
    qb_const = q @ b  # (B,) constant inner-product term

    kk = min(k + 8, n)  # margin absorbs bf16 surrogate noise at the edge

    def scores_of(codes_c, s2_c, nrm_c, va_c):
        if metric == "cosine":
            ip = _code_ip(t, codes_c) + qb_const[:, None]
            denom = q_norm[:, None] * nrm_c[None, :]
            denom = jnp.where(denom == 0, 1.0, denom)
            s = -(ip / denom)
        elif metric == "inner_product":
            s = -(_code_ip(t, codes_c) + qb_const[:, None])
        elif metric == "hik":
            # No matmul form: dequantize the chunk on the VPU.
            x = codes_c.astype(jnp.float32) * a + b
            s = 1.0 - jnp.sum(jnp.minimum(q[:, None, :], x[None, :, :]),
                              axis=-1)
        else:  # euclidean
            s = s2_c[None, :] - 2.0 * _code_ip(t, codes_c)
        return jnp.where(va_c[None, :], s, jnp.inf)

    if n <= chunk:
        s = scores_of(codes, s2, nrm, valid)
        neg, rows = jax.lax.top_k(-s, kk)
        best_s, best_r = -neg, rows.astype(jnp.int32)
    else:
        # Two-stage streaming (ops/scan.flat_topk_two_stage's
        # structure): stream SEGMENT MINIMA only (no
        # per-chunk top-k), pick the k+16 best segments per query — every
        # segment holding a true top-k row has min <= the k-th best score,
        # and at most k(+ties) segments can — then rescore just those
        # segments' rows with the same surrogate and keep the kk row
        # winners. The doubled (segment, then row) margin covers the bf16
        # surrogate noise twice over.
        from smqtk_indexing_tpu.ops.scan import (
            SEG_W, streamed_segment_minima, topk_smallest,
        )
        minima = streamed_segment_minima(
            scores_of, (codes, s2, nrm, valid), n, chunk, bq)
        s_keep = min(k + 16, n // SEG_W)
        smin, sid = topk_smallest(minima, s_keep)
        sid = jnp.where(jnp.isinf(smin), -1, sid)
        sid_c = jnp.maximum(sid, 0)
        m_rows = s_keep * SEG_W
        rows = (sid_c[..., None] * SEG_W
                + jax.lax.broadcasted_iota(jnp.int32,
                                           (bq, s_keep, SEG_W), 2)) \
            .reshape(bq, m_rows)
        cand = jnp.take(codes.reshape(n // SEG_W, SEG_W, d), sid_c,
                        axis=0).reshape(bq, m_rows, d)

        def seg_gather(arr1d):
            return jnp.take(arr1d.reshape(n // SEG_W, SEG_W), sid_c,
                            axis=0).reshape(bq, m_rows)

        alive = (sid[..., None] >= 0).reshape(bq, s_keep, 1) \
            & jnp.take(valid.reshape(n // SEG_W, SEG_W), sid_c, axis=0)
        alive = alive.reshape(bq, m_rows)
        if metric == "hik":
            x = cand.astype(jnp.float32) * a + b
            s = 1.0 - jnp.sum(jnp.minimum(q[:, None, :], x), axis=-1)
        else:
            ip = jnp.einsum("bmd,bd->bm", cand.astype(jnp.bfloat16),
                            t.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
            if metric == "cosine":
                ip = ip + qb_const[:, None]
                denom = q_norm[:, None] * seg_gather(nrm)
                s = -(ip / jnp.where(denom == 0, 1.0, denom))
            elif metric == "inner_product":
                s = -(ip + qb_const[:, None])
            else:
                s = seg_gather(s2) - 2.0 * ip
        s = jnp.where(alive, s, jnp.inf)
        sv, sel = topk_smallest(s, kk)
        best_s = sv
        best_r = jnp.take_along_axis(rows, sel, axis=1).astype(jnp.int32)
        best_r = jnp.where(jnp.isinf(best_s), -1, best_r)

    # Exact re-rank of the kk winners from dequantized f32 rows.
    from smqtk_indexing_tpu.ops.scan import exact_rerank_decoded
    sel_codes = jnp.take(codes, jnp.maximum(best_r, 0), axis=0)
    x = sel_codes.astype(jnp.float32) * a + b        # (B, kk, d)
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)
