"""
Row-sharded scan kernels: per-shard top-k + k-sized all-gather merge.

The SPMD pattern (SURVEY.md §5 "distributed communication backend"): every
device scans its own row shard with the exact same single-device program
(ops/scan.flat_topk / ops/hamming.hamming_topk), converts local row ids to
global ids with its shard offset, all-gathers the tiny (devices, B, k)
result blocks, and merges with one more top-k — communication is
O(devices * B * k), independent of N.

``sharded_kmeans_step`` is the distributed trainer step: local partial
centroid sums/counts + ``psum`` over the shard axis (the classic
data-parallel reduction, replacing nothing in the reference because the
reference has no distributed training at all).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from smqtk_indexing_tpu.ops import hamming, scan
from smqtk_indexing_tpu.ops.kmeans import _assign_block
from smqtk_indexing_tpu.parallel.mesh import DCN_AXIS, SHARD_AXIS, row_axes


def _merge_topk(d_all: jnp.ndarray, r_all: jnp.ndarray, k: int
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(S, B, k) per-shard results -> (B, k) global merge (ascending)."""
    s, b, kk = d_all.shape
    d_flat = jnp.transpose(d_all, (1, 0, 2)).reshape(b, s * kk)
    r_flat = jnp.transpose(r_all, (1, 0, 2)).reshape(b, s * kk)
    neg, sel = jax.lax.top_k(-d_flat, k)
    return -neg, jnp.take_along_axis(r_flat, sel, axis=1)


def _global_shard_index(mesh: Mesh) -> jnp.ndarray:
    """Row-major global shard index inside shard_map (slice-major on 2-D
    meshes, matching shard_rows' row layout)."""
    idx = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
    if DCN_AXIS in mesh.axis_names:
        idx = (jax.lax.axis_index(DCN_AXIS).astype(jnp.int32)
               * mesh.shape[SHARD_AXIS] + idx)
    return idx


def _hier_merge(mesh: Mesh, d: jnp.ndarray, r: jnp.ndarray, k: int
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical top-k merge: all-gather + merge over "shard", then —
    on 2-D meshes — a second k-sized merge over "dcn", so the slower
    network between device groups carries only k results per group."""
    dm, rm = _merge_topk(jax.lax.all_gather(d, SHARD_AXIS),
                         jax.lax.all_gather(r, SHARD_AXIS), k)
    if DCN_AXIS in mesh.axis_names:
        dm, rm = _merge_topk(jax.lax.all_gather(dm, DCN_AXIS),
                             jax.lax.all_gather(rm, DCN_AXIS), k)
    return dm, rm


@partial(jax.jit, static_argnames=("k", "metric", "mesh"))
def sharded_flat_topk(mesh: Mesh, db, db_sq, db_norm, valid, q, *,
                      k: int, metric: str = "euclidean"):
    """
    Exhaustive top-k over a row-sharded database.

    :param mesh: 1-D ("shard") or 2-D ("dcn", "shard") device mesh. All
        array args must already be placed: db/db_sq/db_norm/valid
        row-sharded (over every mesh axis), q replicated.
    :return: (dists (B, k) ascending, global rows (B, k) int32), replicated.
    """
    rows_spec = row_axes(mesh)

    def local(db_l, sq_l, nm_l, va_l, q_l):
        # A shard may hold fewer than k rows; select what exists and pad.
        k_loc = min(k, db_l.shape[0])
        d, r = scan.flat_topk(db_l, sq_l, nm_l, va_l, q_l,
                              k=k_loc, metric=metric)
        if k_loc < k:
            b = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((b, k - k_loc), jnp.inf, jnp.float32)], axis=1)
            r = jnp.concatenate(
                [r, jnp.full((b, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * db_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(rows_spec), P(rows_spec),
                  P(rows_spec), P(None, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db, db_sq, db_norm, valid, q)


@partial(jax.jit, static_argnames=("k", "mesh"))
def sharded_hamming_topk(mesh: Mesh, db, valid, q, *, k: int):
    """Row-sharded packed-code Hamming top-k (same merge pattern)."""
    rows_spec = row_axes(mesh)

    def local(db_l, va_l, q_l):
        k_loc = min(k, db_l.shape[0])
        d, r = hamming.hamming_topk(db_l, va_l, q_l, k=k_loc)
        if k_loc < k:
            b = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((b, k - k_loc), 2 ** 30, jnp.int32)], axis=1)
            r = jnp.concatenate(
                [r, jnp.full((b, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * db_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        dm, rm = _hier_merge(mesh, d.astype(jnp.float32), r, k)
        return dm.astype(jnp.int32), rm

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(rows_spec), P(None, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db, valid, q)


@partial(jax.jit, static_argnames=("k", "metric", "mesh"))
def sharded_sq8_topk(mesh: Mesh, codes, a, b, s2, nrm, valid, q, *,
                     k: int, metric: str = "euclidean"):
    """Row-sharded SQ8 scan (ops/sq8.sq8_topk per shard, same hierarchical
    merge as the float paths). codes/s2/nrm/valid row-sharded; a/b/q
    replicated."""
    from smqtk_indexing_tpu.ops.sq8 import sq8_topk

    rows_spec = row_axes(mesh)

    def local(codes_l, a_l, b_l, s2_l, nm_l, va_l, q_l):
        k_loc = min(k, codes_l.shape[0])
        d, r = sq8_topk(codes_l, a_l, b_l, s2_l, nm_l, va_l, q_l,
                        k=k_loc, metric=metric)
        if k_loc < k:
            bq = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((bq, k - k_loc), jnp.inf, jnp.float32)],
                axis=1)
            r = jnp.concatenate(
                [r, jnp.full((bq, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * codes_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(None), P(None), P(rows_spec),
                  P(rows_spec), P(rows_spec), P(None, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(codes, a, b, s2, nrm, valid, q)


@partial(jax.jit, static_argnames=("k", "metric", "mesh"))
def sharded_pq_topk(mesh: Mesh, codes, codebooks, s2, valid, q, *,
                    k: int, metric: str = "euclidean"):
    """Row-sharded PQ scan (ops/pq.pq_topk per shard, same hierarchical
    merge as the float paths). codes/s2/valid row-sharded; codebooks/q
    replicated."""
    from smqtk_indexing_tpu.ops.pq import pq_topk

    rows_spec = row_axes(mesh)

    def local(codes_l, cb_l, s2_l, va_l, q_l):
        k_loc = min(k, codes_l.shape[0])
        d, r = pq_topk(codes_l, cb_l, s2_l, va_l, q_l, k=k_loc,
                       metric=metric)
        if k_loc < k:
            bq = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((bq, k - k_loc), jnp.inf, jnp.float32)],
                axis=1)
            r = jnp.concatenate(
                [r, jnp.full((bq, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * codes_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(None, None, None), P(rows_spec),
                  P(rows_spec), P(None, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(codes, codebooks, s2, valid, q)


@partial(jax.jit, static_argnames=("k", "metric", "mesh"))
def sharded_rerank_topk(mesh: Mesh, q, cand, valid, *, k: int,
                        metric: str = "euclidean"):
    """
    Candidate-sharded exact re-rank for the LSH composite: the per-query
    candidate block (B, M, d) splits on its M axis across the mesh, each
    device scores its slice (ops/metrics.candidate_distances — the exact
    math of the single-device re-rank, so results are bit-identical), and the
    per-shard (B, k) winners merge hierarchically.

    :return: (dists (B, k) ascending with +inf padding, positions (B, k)
        int32 into the GLOBAL M axis with -1 padding), replicated.
    """
    from smqtk_indexing_tpu.ops.metrics import candidate_distances

    rows_spec = row_axes(mesh)

    def local(q_r, cand_l, va_l):
        m_loc = cand_l.shape[1]
        d = candidate_distances(q_r, cand_l, metric)
        d = jnp.where(va_l, d, jnp.inf)
        k_loc = min(k, m_loc)
        neg, sel = jax.lax.top_k(-d, k_loc)
        dd = -neg
        sel = sel + _global_shard_index(mesh) * m_loc
        sel = jnp.where(jnp.isinf(dd), -1, sel)
        if k_loc < k:
            b = q_r.shape[0]
            dd = jnp.concatenate(
                [dd, jnp.full((b, k - k_loc), jnp.inf, jnp.float32)], axis=1)
            sel = jnp.concatenate(
                [sel, jnp.full((b, k - k_loc), -1, jnp.int32)], axis=1)
        return _hier_merge(mesh, dd, sel, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None), P(None, rows_spec, None),
                  P(None, rows_spec)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(q, cand, valid)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_kmeans_step(mesh: Mesh, db, valid, centroids):
    """
    One data-parallel Lloyd step: each shard assigns its rows to the
    (replicated) centroids and contributes partial sums/counts; a ``psum``
    over the mesh produces the new replicated centroids.

    :return: (new centroids (C, d) float32 replicated,
              local assignments (N,) int32 row-sharded).
    """
    c_count = centroids.shape[0]
    rows_spec = row_axes(mesh)

    def local(db_l, va_l, c):
        x = db_l.astype(jnp.float32)
        x_sq = jnp.sum(x * x, axis=-1)
        a = _assign_block(x, x_sq, c.astype(jnp.float32),
                          jnp.sum(c.astype(jnp.float32) ** 2, axis=-1))
        w = va_l.astype(jnp.float32)
        sums = jax.ops.segment_sum(x * w[:, None], a,
                                   num_segments=c_count)
        counts = jax.ops.segment_sum(w, a, num_segments=c_count)
        sums = jax.lax.psum(sums, rows_spec)
        counts = jax.lax.psum(counts, rows_spec)
        new_c = jnp.where(counts[:, None] > 0,
                          sums / jnp.maximum(counts[:, None], 1.0),
                          c.astype(jnp.float32))
        return new_c, a

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(rows_spec), P(None, None)),
        out_specs=(P(None, None), P(rows_spec)),
        check_vma=False,
    )(db, valid, centroids)
