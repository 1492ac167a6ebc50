"""
Device-side k-means (Lloyd) training and assignment.

This is the device-resident replacement for the coarse-quantizer training the
reference delegates to FAISS C++ (``faiss_index.train``,
/root/reference/smqtk_indexing/impls/nn_index/faiss.py:516): assignment is a
chunked (rows-streamed) matmul against the centroid matrix, and
the centroid update is a segment-sum — both inside one jitted program with
the Lloyd loop under ``lax.fori_loop``. The (N, C) distance matrix is never
materialized whole; a ``lax.scan`` streams row blocks.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

#: Rows per streamed assignment block.
ASSIGN_CHUNK = 16384


def _pad_to_chunks(x: jnp.ndarray, w, chunk: int):
    """Zero-pad rows (and the weight/validity vector) to a chunk multiple
    so the streaming reshape is always exact (1M-row trainers hit the
    old N % chunk truncation)."""
    n = x.shape[0]
    n_pad = -(-n // chunk) * chunk if n > chunk else n
    if n_pad == n:
        return x, w, 0
    pad = n_pad - n
    x = jnp.concatenate(
        [x, jnp.zeros((pad, x.shape[1]), x.dtype)], axis=0)
    if w is not None:
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)], axis=0)
    return x, w, pad


def _assign_block(x: jnp.ndarray, x_sq: jnp.ndarray, c: jnp.ndarray,
                  c_sq: jnp.ndarray) -> jnp.ndarray:
    """(B, d) rows -> (B,) nearest-centroid ids (L2; ||x||² constant omitted
    from the argmin)."""
    # precision=HIGHEST: see ops/scan._chunk_scores — default-precision
    # f32 products may run in TF32, which scrambles nearest-centroid
    # argmins.
    ip = jnp.dot(x, c.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    return jnp.argmin(c_sq[None, :] - 2.0 * ip, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_iter", "chunk"))
def kmeans_lloyd(x: jnp.ndarray, valid: jnp.ndarray, init: jnp.ndarray, *,
                 n_iter: int, chunk: int = ASSIGN_CHUNK
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Lloyd's algorithm on a (N, d) float32 matrix (zero-padded rows masked by
    ``valid``).

    :param x: (N, d) training rows (any N — rows pad internally to a
        chunk multiple; padding is masked out of updates).
    :param valid: (N,) bool mask of real rows.
    :param init: (C, d) initial centroids.
    :param n_iter: Lloyd iterations (static).
    :return: (centroids (C, d) float32, assignments (N,) int32 under the
        final centroids; masked rows get assignment of nearest centroid but
        contribute nothing to updates).
    """
    n, d = x.shape
    c_count = init.shape[0]
    x = x.astype(jnp.float32)
    w = valid.astype(jnp.float32)
    x, w, pad = _pad_to_chunks(x, w, chunk)
    x_sq = jnp.sum(x * x, axis=-1)

    num_chunks = x.shape[0] // min(chunk, x.shape[0])
    eff_chunk = x.shape[0] // num_chunks
    x_c = x.reshape(num_chunks, eff_chunk, d)
    xsq_c = x_sq.reshape(num_chunks, eff_chunk)
    w_c = w.reshape(num_chunks, eff_chunk)

    def lloyd_step(_, c):
        c_sq = jnp.sum(c * c, axis=-1)

        def body(carry, blk):
            sums, counts = carry
            xb, xsqb, wb = blk
            a = _assign_block(xb, xsqb, c, c_sq)
            sums = sums + jax.ops.segment_sum(
                xb * wb[:, None], a, num_segments=c_count)
            counts = counts + jax.ops.segment_sum(
                wb, a, num_segments=c_count)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            body,
            (jnp.zeros((c_count, d), jnp.float32),
             jnp.zeros((c_count,), jnp.float32)),
            (x_c, xsq_c, w_c))
        new_c = jnp.where(counts[:, None] > 0,
                          sums / jnp.maximum(counts[:, None], 1.0), c)
        # Empty-cluster splitting (the FAISS clustering behavior): each
        # empty cell adopts a deterministically perturbed copy of a
        # large cluster's centroid (rank-r empty takes the rank-r
        # largest donor, cycling), so mass cannot pile into mega-lists
        # when the init under-covers the data — without this, a skewed
        # init leaves duplicate dead centroids and mega-lists many times
        # the mean.
        empty = counts <= 0
        donors = jnp.argsort(-counts)
        rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
        donor_idx = donors[jnp.clip(rank, 0, c_count - 1) % c_count]
        sign = 1.0 - 2.0 * (
            (jnp.arange(c_count)[:, None] + jnp.arange(d)[None, :]) % 2
        ).astype(jnp.float32)
        split = new_c[donor_idx] * (1.0 + 1e-4 * sign)
        return jnp.where(empty[:, None], split, new_c)

    c = jax.lax.fori_loop(0, n_iter, lloyd_step, init.astype(jnp.float32))

    c_sq = jnp.sum(c * c, axis=-1)

    def assign_body(_, blk):
        xb, xsqb, wb = blk
        return None, _assign_block(xb, xsqb, c, c_sq)

    _, assigns = jax.lax.scan(assign_body, None, (x_c, xsq_c, w_c))
    return c, assigns.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("chunk",))
def kmeans_assign(x: jnp.ndarray, centroids: jnp.ndarray, *,
                  chunk: int = ASSIGN_CHUNK) -> jnp.ndarray:
    """Nearest-centroid assignment for (N, d) rows (chunk-streamed)."""
    n, d = x.shape
    x = x.astype(jnp.float32)
    c = centroids.astype(jnp.float32)
    c_sq = jnp.sum(c * c, axis=-1)
    x, _, _ = _pad_to_chunks(x, None, chunk)
    num_chunks = x.shape[0] // min(chunk, x.shape[0])
    eff_chunk = x.shape[0] // num_chunks
    x_c = x.reshape(num_chunks, eff_chunk, d)
    xsq_c = jnp.sum(x * x, axis=-1).reshape(num_chunks, eff_chunk)

    def body(_, blk):
        xb, xsqb = blk
        return None, _assign_block(xb, xsqb, c, c_sq)

    _, assigns = jax.lax.scan(body, None, (x_c, xsq_c))
    return assigns.reshape(-1)[:n]
