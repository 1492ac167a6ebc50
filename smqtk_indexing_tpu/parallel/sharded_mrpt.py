"""
Row-sharded MRPT query: per-shard leaf tables + the hierarchical top-k merge.

The MRPT leaf scan is embarrassingly row-parallel, but the global leaf
permutation (ops/mrpt.build_trees) indexes arbitrary rows, so naive row
sharding of the database would leave every shard gathering remote rows.
Instead the permutation is re-laid-out at build time (host-side,
:func:`shard_leaf_tables`): each shard stores, for every tree, the
sub-permutation restricted to its contiguous row block — in leaf order,
with per-(shard, tree) leaf offsets. Because every tree's permutation
contains each row exactly once, the per-shard tables are perfectly regular
``(S, T, capacity // S)`` arrays.

At query time every device descends all trees (cheap, replicated splits),
gathers only ITS leaf segments from ITS database block (~1/S of the
single-device gather), scores and exact-re-ranks locally, and the per-shard
(B, k) winners merge through the same hierarchical all-gather the flat
scan uses (parallel/sharded_scan._hier_merge) — O(devices * B * k)
traffic, independent of N.

Reference analog: the reference's MRPT is a single-host numpy loop
(/root/reference/smqtk_indexing/impls/nn_index/mrpt.py:443-496) with no
distributed path; this is the build's own SPMD design (SURVEY.md §5).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from smqtk_indexing_tpu.ops.mrpt import _candidate_topk, descend_leaves
from smqtk_indexing_tpu.ops.scan import _exact_selected
from smqtk_indexing_tpu.parallel.mesh import row_axes
from smqtk_indexing_tpu.parallel.sharded_scan import (
    _global_shard_index, _hier_merge,
)

_HI = jax.lax.Precision.HIGHEST


def shard_leaf_tables(leaf_table: np.ndarray, offsets: np.ndarray,
                      n_shards: int, capacity: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """
    Re-layout the global leaf permutation into per-shard local tables.

    :param leaf_table: (T, N) int32 per-tree row permutations grouped by
        leaf (global row ids).
    :param offsets: (2^depth + 1,) shared global leaf boundaries.
    :param n_shards: Mesh size S; rows block-shard as
        ``[s * capacity/S, (s+1) * capacity/S)``.
    :param capacity: Padded device row capacity (divisible by n_shards).
    :return: (leaf_local (S, T, capacity // S) int32 LOCAL row ids in leaf
        order — slots past a shard's real-row count are zero padding,
        off_local (S, T, 2^depth + 1) int32 per-shard leaf boundaries,
        leaf_max_local — max per-shard leaf segment length).
    """
    t_count, n = leaf_table.shape
    if capacity % n_shards:
        raise ValueError(
            f"capacity {capacity} not divisible by {n_shards} shards.")
    blk = capacity // n_shards
    n_leaves = len(offsets) - 1
    # Leaf id of every permutation position (shared across trees).
    leaf_ids = np.repeat(np.arange(n_leaves), np.diff(offsets))
    leaf_local = np.zeros((n_shards, t_count, blk), dtype=np.int32)
    off_local = np.zeros((n_shards, t_count, n_leaves + 1), dtype=np.int32)
    for t in range(t_count):
        perm = leaf_table[t].astype(np.int64)
        sid = perm // blk
        loc = (perm - sid * blk).astype(np.int32)
        # Stable shard-major grouping preserves leaf order within a shard.
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=n_shards)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for s in range(n_shards):
            seg = order[starts[s]:starts[s + 1]]
            leaf_local[s, t, :len(seg)] = loc[seg]
            off_local[s, t, 1:] = np.cumsum(
                np.bincount(leaf_ids[seg], minlength=n_leaves))
    leaf_max_local = int(np.diff(off_local, axis=-1).max())
    return leaf_local, off_local, leaf_max_local


@partial(jax.jit, static_argnames=("k", "depth", "leaf_max", "mesh"))
def sharded_mrpt_query(mesh: Mesh, db, db_sq, valid, bases, splits,
                       leaf_local, off_local, q, *, k: int, depth: int,
                       leaf_max: int):
    """
    Batched MRPT query over a row-sharded database.

    :param mesh: 1-D ("shard") or 2-D ("dcn", "shard") mesh. db/db_sq/valid
        row-sharded; leaf_local/off_local sharded on their leading S axis;
        bases/splits/q replicated.
    :param leaf_max: Static per-shard leaf segment bound
        (from :func:`shard_leaf_tables`, power-of-two rounded by callers).
    :return: (dists (B, k) ascending with +inf padding, GLOBAL rows (B, k)
        int32 with -1 padding), replicated.
    """
    rows_spec = row_axes(mesh)

    def local(db_l, sq_l, va_l, leaf_l, off_l, bases_r, splits_r, q_r):
        leaf_l = leaf_l.reshape(leaf_l.shape[-2:])   # (T, blk)
        off_l = off_l.reshape(off_l.shape[-2:])      # (T, L+1)
        n_loc = db_l.shape[0]
        b = q_r.shape[0]
        t_count = bases_r.shape[0]
        qf = q_r.astype(jnp.float32)
        q_sq = jnp.sum(qf * qf, axis=-1)

        proj = jnp.einsum("bd,tdl->btl", qf, bases_r, precision=_HI)
        leaves = descend_leaves(proj, splits_r, depth)        # (B, T)

        t_iota = jnp.arange(t_count, dtype=jnp.int32)[None, :]
        starts = off_l[t_iota, leaves]                        # (B, T)
        lengths = off_l[t_iota, leaves + 1] - starts
        ii = jax.lax.broadcasted_iota(jnp.int32, (b, t_count, leaf_max), 2)
        idx = jnp.clip(starts[..., None] + ii, 0, leaf_l.shape[1] - 1)
        ok = ii < lengths[..., None]
        t_idx = jax.lax.broadcasted_iota(jnp.int32, (b, t_count, leaf_max), 1)
        rows = leaf_l[t_idx, idx]                             # (B, T, L)
        m = t_count * leaf_max
        rows = rows.reshape(b, m)
        ok = ok.reshape(b, m) & jnp.take(va_l, rows, axis=0)

        # Dedupe across trees (a row lives on exactly ONE shard, so local
        # dedupe equals the single-device global dedupe).
        rows_s = jnp.where(ok, rows, n_loc)
        rows_sorted = jnp.sort(rows_s, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((b, 1), bool),
             rows_sorted[:, 1:] == rows_sorted[:, :-1]], axis=1)
        alive = (rows_sorted < n_loc) & ~dup
        rows_u = jnp.clip(rows_sorted, 0, n_loc - 1)

        # Same k+16 surrogate margin + exact re-rank as the single-device
        # kernel (bf16 cohort scoring); trim to k before the merge.
        k_sel = min(k + 16, m)
        top_scores, top_rows = _candidate_topk(db_l, sq_l, qf, rows_u,
                                               alive, k_sel)
        top_rows = top_rows.astype(jnp.int32)
        top_rows = jnp.where(jnp.isinf(top_scores), -1, top_rows)
        d_fin, r_fin = _exact_selected("euclidean", db_l, qf, q_sq,
                                       top_scores, top_rows)
        if k_sel < k:
            pad = k - k_sel
            d_fin = jnp.concatenate(
                [d_fin, jnp.full((b, pad), jnp.inf, jnp.float32)], axis=1)
            r_fin = jnp.concatenate(
                [r_fin, jnp.full((b, pad), -1, jnp.int32)], axis=1)
        d_fin, r_fin = d_fin[:, :k], r_fin[:, :k]
        offset = _global_shard_index(mesh) * n_loc
        r_fin = jnp.where(r_fin >= 0, r_fin + offset, r_fin)
        return _hier_merge(mesh, d_fin, r_fin, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(rows_spec, None), P(rows_spec), P(rows_spec),
                  P(rows_spec, None, None), P(rows_spec, None, None),
                  P(None, None, None), P(None, None), P(None, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db, db_sq, valid, leaf_local, off_local, bases, splits, q)
