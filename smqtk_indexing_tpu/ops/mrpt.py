"""
MRPT (Multiple Random Projection Trees) kernels and tree construction.

Device-first re-design of the reference's MRPT implementation
(/root/reference/smqtk_indexing/impls/nn_index/mrpt.py, after Hyvönen et
al., arXiv:1509.06957):

- Projection of the whole database against every tree's basis is ONE batched
  einsum (the reference streams 5000-row host chunks through
  numpy, mrpt.py:243-267).
- Trees are balanced median splits, stored as packed heap-order split arrays
  (children of node i at 2i+1 / 2i+2 — the same packed layout idea as the
  reference's splits array, mrpt.py:289-362) plus one row-permutation per
  tree ("leaf table"). Because splits are always at the segment midpoint,
  leaf boundaries are a function of (N, depth) only and are shared across
  trees.
- A query descends all trees in parallel (fori_loop over depth, vmapped over
  trees and queries), gathers the union of its leaves' rows, dedupes by
  sort-and-mask, and finishes with the fused exact L2 re-rank
  (ops/scan._exact_selected) — replacing the reference's host-side
  leaf-union + argpartition re-rank (mrpt.py:473-496).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.ops.scan import _exact_selected

_HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("chunk",))
def project_all(db: jnp.ndarray, bases: jnp.ndarray,
                chunk: int = 65536) -> jnp.ndarray:
    """(N, d) rows x (T, d, D) bases -> (N, T, D) projections, streamed."""
    n, d = db.shape
    num_chunks = max(n // chunk, 1)
    eff = n // num_chunks
    db_c = db.reshape(num_chunks, eff, d)

    def body(_, xb):
        return None, jnp.einsum("nd,tdl->ntl", xb.astype(jnp.float32),
                                bases, precision=_HI)

    _, out = jax.lax.scan(body, None, db_c)
    return out.reshape(n, bases.shape[0], bases.shape[2])


def build_trees(projs: np.ndarray, depth: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Host-side balanced median-split tree construction over precomputed
    projections.

    :param projs: (N, T, D) float32 projections (from :func:`project_all`).
    :param depth: Tree depth (leaves = 2^depth).
    :return: (splits (T, 2^depth - 1) float32 heap-order,
              leaf_table (T, N) int32 row permutations grouped by leaf,
              offsets (2^depth + 1,) int32 shared leaf boundaries).
    """
    n, t_count, d_depth = projs.shape
    assert depth <= d_depth
    n_nodes = 2 ** depth - 1
    splits = np.zeros((t_count, n_nodes), dtype=np.float32)
    leaf_table = np.zeros((t_count, n), dtype=np.int32)

    # Shared segment boundaries: midpoint splits depend only on (N, depth).
    bounds = [(0, n)]
    level_bounds = [bounds]
    for _ in range(depth):
        nxt = []
        for lo, hi in level_bounds[-1]:
            mid = lo + (hi - lo) // 2
            nxt.extend([(lo, mid), (mid, hi)])
        level_bounds.append(nxt)
    offsets = np.array([lo for lo, _ in level_bounds[-1]] + [n],
                       dtype=np.int32)

    for t in range(t_count):
        order = np.arange(n, dtype=np.int32)
        node = 0
        for level in range(depth):
            for lo, hi in level_bounds[level]:
                seg = hi - lo
                if seg > 1:
                    vals = projs[order[lo:hi], t, level]
                    mid_off = seg // 2
                    part = np.argpartition(vals, mid_off)
                    order[lo:hi] = order[lo:hi][part]
                    splits[t, node] = vals[part[mid_off]]
                elif seg == 1:
                    splits[t, node] = projs[order[lo], t, level]
                node += 1
        leaf_table[t] = order
    return splits, leaf_table, offsets


#: Max f32 elements of one (B, chunk, d) candidate gather (~512 MB) before
#: candidate scoring streams in chunks instead of materializing (B, M, d).
_STREAM_ELEMS = 1 << 27


def _candidate_topk(db: jnp.ndarray, db_sq: jnp.ndarray, q: jnp.ndarray,
                    rows_u: jnp.ndarray, alive: jnp.ndarray, k_inner: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exact-surrogate L2 top-k over per-query candidate rows.

    :param rows_u: (B, M) clipped candidate row ids.
    :param alive: (B, M) candidate liveness.
    :return: ((B, k_inner) ascending surrogate scores, (B, k_inner) rows).
        When B * M * d exceeds ``_STREAM_ELEMS`` the (B, M, d) gather
        streams in M-chunks with a running top-k merge (identical scores;
        keeps GIST-scale tree unions within device memory).
    """
    b, m = rows_u.shape
    d = db.shape[1]
    cohort = min(32, b)
    use_cohort = b >= 8 and b % cohort == 0

    def score(rows_c, alive_c):
        cand = jnp.take(db, rows_c, axis=0)
        mc = cand.shape[1]
        if use_cohort:
            # Candidate scoring as a COHORT dense matmul: a per-query
            # matvec (einsum bmd,bd->bm) is a bandwidth-bound reduce;
            # scoring each 32-query cohort against its pooled candidates
            # in ONE bf16 matrix product trades 32x redundant FLOPs for
            # tensor-core throughput. bf16 surrogate noise is absorbed
            # by the k+16 row margin callers carry plus the exact final
            # re-rank.
            nc = b // cohort
            g = cand.astype(jnp.bfloat16).reshape(nc, cohort * mc, d)
            qs = q.astype(jnp.bfloat16).reshape(nc, cohort, d)
            s_all = jax.lax.dot_general(
                qs, g, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            s4 = s_all.reshape(nc, cohort, cohort, mc)
            ip = jnp.take_along_axis(
                s4, jax.lax.broadcasted_iota(jnp.int32,
                                             (nc, cohort, 1, 1), 1),
                axis=2).reshape(b, mc)
        else:
            ip = jnp.einsum("bmd,bd->bm", cand.astype(jnp.float32), q,
                            precision=_HI)
        s = jnp.take(db_sq, rows_c, axis=0) - 2.0 * ip
        return jnp.where(alive_c, s, jnp.inf)

    if b * m * d <= _STREAM_ELEMS:
        scores = score(rows_u, alive)
        neg, sel = jax.lax.top_k(-scores, k_inner)
        return -neg, jnp.take_along_axis(rows_u, sel, axis=1)

    # Pad M to a power of two and stream chunk-wise.
    m_pad = 1
    while m_pad < m:
        m_pad *= 2
    if m_pad != m:
        rows_u = jnp.concatenate(
            [rows_u, jnp.zeros((b, m_pad - m), rows_u.dtype)], axis=1)
        alive = jnp.concatenate(
            [alive, jnp.zeros((b, m_pad - m), bool)], axis=1)
    mc = max(min(_STREAM_ELEMS // (b * d), m_pad), k_inner)
    mc_p = 1
    while mc_p * 2 <= mc:
        mc_p *= 2
    mc = mc_p
    nc = m_pad // mc
    rows_c = jnp.transpose(rows_u.reshape(b, nc, mc), (1, 0, 2))
    alive_c = jnp.transpose(alive.reshape(b, nc, mc), (1, 0, 2))

    init = (jnp.full((b, k_inner), jnp.inf, jnp.float32),
            jnp.zeros((b, k_inner), rows_u.dtype))

    def body(carry, blk):
        best_s, best_r = carry
        r_blk, a_blk = blk
        s = score(r_blk, a_blk)
        cand_s = jnp.concatenate([best_s, s], axis=1)
        cand_r = jnp.concatenate([best_r, r_blk], axis=1)
        neg, sel = jax.lax.top_k(-cand_s, k_inner)
        return (-neg, jnp.take_along_axis(cand_r, sel, axis=1)), None

    (best_s, best_r), _ = jax.lax.scan(body, init, (rows_c, alive_c))
    return best_s, best_r


def descend_leaves(proj: jnp.ndarray, splits: jnp.ndarray,
                   depth: int) -> jnp.ndarray:
    """
    Descend every tree for every query.

    :param proj: (B, T, D) query projections.
    :param splits: (T, 2^depth - 1) split values (heap order).
    :param depth: Tree depth (static).
    :return: (B, T) int32 leaf indices in [0, 2^depth).
    """
    def descend(pt, ps):
        # pt: (D,) projection values; ps: (2^depth - 1,) splits.
        def step(level, node):
            right = (pt[level] >= ps[node]).astype(jnp.int32)
            return 2 * node + 1 + right
        node = jax.lax.fori_loop(0, depth, step, jnp.int32(0))
        return node - (2 ** depth - 1)

    return jax.vmap(jax.vmap(descend, in_axes=(0, 0)),
                    in_axes=(0, None))(proj, splits)


@partial(jax.jit, static_argnames=("k", "depth", "leaf_max"))
def mrpt_query(db: jnp.ndarray, db_sq: jnp.ndarray, valid: jnp.ndarray,
               bases: jnp.ndarray, splits: jnp.ndarray,
               leaf_table: jnp.ndarray, offsets: jnp.ndarray,
               q: jnp.ndarray, *, k: int, depth: int, leaf_max: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Batched MRPT query: descend every tree, union leaf candidates, dedupe,
    exact-L2 top-k.

    :param db: (N, d) database rows (original order).
    :param db_sq: (N,) squared norms.
    :param valid: (N,) liveness mask.
    :param bases: (T, d, D) projection bases.
    :param splits: (T, 2^depth - 1) split values (heap order).
    :param leaf_table: (T, N) per-tree row permutation grouped by leaf.
    :param offsets: (2^depth + 1,) shared leaf boundaries.
    :param q: (B, d) float32 queries.
    :return: (dists (B, k) ascending with +inf padding, rows (B, k) int32
        with -1 padding; no duplicate rows per query).
    """
    n = db.shape[0]
    b = q.shape[0]
    t_count = bases.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)

    proj = jnp.einsum("bd,tdl->btl", q, bases, precision=_HI)  # (B, T, D)
    leaves = descend_leaves(proj, splits, depth)             # (B, T)

    starts = offsets[leaves]                                 # (B, T)
    lengths = offsets[leaves + 1] - starts
    ii = jax.lax.broadcasted_iota(jnp.int32, (b, t_count, leaf_max), 2)
    idx = jnp.clip(starts[..., None] + ii, 0, n - 1)
    ok = ii < lengths[..., None]
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (b, t_count, leaf_max), 1)
    rows = leaf_table[t_idx, idx]                            # (B, T, L)
    m = t_count * leaf_max
    rows = rows.reshape(b, m)
    ok = ok.reshape(b, m) & jnp.take(valid, rows, axis=0)

    # Dedupe across trees: sort rows (dead slots to sentinel n), mask
    # repeats so one physical row can't fill two result slots.
    rows_s = jnp.where(ok, rows, n)
    rows_sorted = jnp.sort(rows_s, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((b, 1), bool),
         rows_sorted[:, 1:] == rows_sorted[:, :-1]], axis=1)
    alive = (rows_sorted < n) & ~dup
    rows_u = jnp.clip(rows_sorted, 0, n - 1)

    # k+16 row margin: surrogate selection may run in bf16 (cohort
    # matmul path); the margin plus the exact re-rank keep the reported
    # top-k exact.
    k_sel = min(k + 16, m)
    top_scores, top_rows = _candidate_topk(db, db_sq, q, rows_u, alive,
                                           k_sel)
    top_rows = top_rows.astype(jnp.int32)
    top_rows = jnp.where(jnp.isinf(top_scores), -1, top_rows)
    d_fin, r_fin = _exact_selected("euclidean", db, q, q_sq, top_scores,
                                   top_rows)
    if k_sel < k:
        pad = k - k_sel
        d_fin = jnp.concatenate(
            [d_fin, jnp.full((b, pad), jnp.inf, jnp.float32)], axis=1)
        r_fin = jnp.concatenate(
            [r_fin, jnp.full((b, pad), -1, jnp.int32)], axis=1)
    return d_fin[:, :k], r_fin[:, :k]
