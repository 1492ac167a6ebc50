"""
Row-sharded tiled-transposed IVF serving — the capacity tier
(``storage='code'``) over a device mesh.

The single-device code tier (reference: FAISS 'IVF<n>,SQ8' /
'IVF<n>,PQ<M>' native list scans, smqtk_indexing/impls/nn_index/faiss.py:190)
keeps codes in the (n_tiles, d, TILE_ROWS) tiled-transposed layout and
scans probed lists with the tiled list scan
(ops/ivf_tiled.ivf_query_tiled[_pq]). This module shards that
layout on the TILE axis: each device owns a contiguous, tile-aligned row
range, holds its own local sublist CSR + original->sublist slot table
(global list spans clipped at shard boundaries, like
parallel/sharded_ivf.shard_csr), and runs the UNMODIFIED single-device
tiled query against replicated centroids/codecs/queries. Winners merge
with the standard k-sized all-gather (per mesh axis on 2-D meshes) —
communication O(devices * B * k), exactly the flat/IVF pattern.

Semantics match the single-device tier: probe selection ranks ORIGINAL
centroids (FAISS-faithful nprobe by construction) and every shard scans
its clipped portion of exactly the nprobe nearest lists, so the shard
union covers precisely the single-device candidate set.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, PartitionSpec as P

from smqtk_indexing_tpu.ops.scan import pad_to_k
from smqtk_indexing_tpu.parallel.mesh import row_axes
from smqtk_indexing_tpu.parallel.sharded_scan import (
    _global_shard_index, _hier_merge,
)


def shard_tiled_layout(lens: np.ndarray, n_rows_pad: int, n_shards: int,
                       c_lists: int):
    """
    Clip the global list-sorted row layout at (tile-aligned) shard
    boundaries and build each shard's LOCAL tiled CSR + slot table,
    padded to common shapes so they stack into shard_map operands.

    :param lens: (C,) per-list global row counts (list-sorted layout:
        list li occupies global rows [cumsum(lens)[li-1], +lens[li])).
    :param n_rows_pad: total padded rows; must divide by ``n_shards``
        into a multiple of TILE_ROWS (the shard boundary must fall on a
        tile edge — a probe window cannot cross tiles, and the tile axis
        is the sharded axis).
    :param c_lists: original list count C.
    :return: (v_tile (S, V), v_col (S, V), v_len (S, V) int32 — padded
        slots have len 0 (dead: the scan loads nothing for them) — and
        slot_table (S, C, S_max) int32, -1 padded).
    """
    from smqtk_indexing_tpu.ops.ivf_tiled import (
        TILE_ROWS, build_slot_table, build_tiled_csr,
    )
    per = n_rows_pad // n_shards
    if per % TILE_ROWS:
        raise ValueError(
            f"Shard row span {per} is not a multiple of TILE_ROWS "
            f"({TILE_ROWS}); pad n_rows to n_shards*TILE_ROWS multiples.")
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    ends = starts + np.asarray(lens, np.int64)
    parts = []
    for s in range(n_shards):
        lo, hi = s * per, (s + 1) * per
        loc_lens = (np.clip(ends, lo, hi)
                    - np.clip(starts, lo, hi)).astype(np.int64)
        v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(
            loc_lens[None, :], np.zeros(1, dtype=np.int64))
        table = build_slot_table(v_orig, c_lists)
        parts.append((v_tile, v_col, v_len, table))
    v_max = max(p[0].shape[0] for p in parts)
    s_max = max(p[3].shape[1] for p in parts)
    vt = np.zeros((n_shards, v_max), dtype=np.int32)
    vc = np.zeros((n_shards, v_max), dtype=np.int32)
    vl = np.zeros((n_shards, v_max), dtype=np.int32)
    st = np.full((n_shards, c_lists, s_max), -1, dtype=np.int32)
    for s, (t, c, ln, tab) in enumerate(parts):
        vt[s, :t.size] = t
        vc[s, :c.size] = c
        vl[s, :ln.size] = ln
        st[s, :, :tab.shape[1]] = tab
    return vt, vc, vl, st




@partial(jax.jit, static_argnames=("k", "nprobe_orig", "interpret",
                                   "rerank", "mesh", "metric"))
def sharded_ivf_query_tiled(mesh: Mesh, db3, s2t, a, b_codec, centroids,
                            slot_table, v_tile, v_col, v_len, q, *,
                            k: int, nprobe_orig: int, interpret: bool,
                            rerank: str = "gather",
                            metric: str = "euclidean"
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Sharded tiled IVF-SQ8 query.

    :param db3/s2t: (n_tiles, d, TILE_ROWS) codes / (n_tiles, 1,
        TILE_ROWS) row stats, sharded on the tile axis.
    :param a/b_codec: replicated SQ8 codec arrays.
    :param centroids: (C, d) float32, replicated.
    :param slot_table/v_tile/v_col/v_len: shard_tiled_layout outputs,
        sharded on their leading shard axis.
    :param q: (B, d) float32, replicated.
    :return: (dists (B, k), GLOBAL rows (B, k)), replicated.
    """
    from smqtk_indexing_tpu.ops.ivf_tiled import ivf_query_tiled

    def local(db3_l, s2_l, a_l, b_l, c, st_l, vt_l, vc_l, vl_l, q_l):
        n_local = db3_l.shape[0] * db3_l.shape[2]
        k_loc = min(k, n_local)
        d, r = ivf_query_tiled(
            db3_l, s2_l, a_l, b_l, c, st_l[0], vt_l[0], vc_l[0], vl_l[0],
            q_l, k=k_loc, nprobe_orig=nprobe_orig, interpret=interpret,
            rerank=rerank, metric=metric)
        d, r = pad_to_k(d, r, k)
        offset = _global_shard_index(mesh) * n_local
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    rows_spec = row_axes(mesh)
    in_specs = (P(rows_spec, None, None), P(rows_spec, None, None),
                P(None), P(None), P(None, None),
                P(rows_spec, None, None), P(rows_spec, None),
                P(rows_spec, None), P(rows_spec, None), P(None, None))
    return jax.shard_map(
        local, mesh=mesh, in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db3, s2t, a, b_codec, centroids, slot_table, v_tile, v_col, v_len,
      q)


@partial(jax.jit, static_argnames=("k", "nprobe_orig", "rerank", "mesh",
                                   "metric"))
def sharded_ivf_query_tiled_pq(mesh: Mesh, db3c, s2t, codebooks, perm,
                               centroids, slot_table, v_tile, v_col,
                               v_len, q, *, k: int, nprobe_orig: int,
                               rerank: str = "gather",
                               res_cents=None, row2list=None,
                               metric: str = "euclidean"
                               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Sharded tiled IVF-PQ query (raw/OPQ, or residual when
    ``res_cents``/``row2list`` are given — FAISS ``by_residual``).

    Residual mode shards cleanly: the per-probe ``-2<q, c>`` score
    offsets derive from the probe-selection matmul, which every shard
    computes identically from the replicated centroids/queries, and the
    exact re-rank's row -> original-list map is row-aligned, so it
    shards exactly like the code tiles (``row2list`` row-sharded,
    ``res_cents`` replicated).

    Same operand layout as :func:`sharded_ivf_query_tiled` with the PQ
    codec (codebooks + perm/OPQ transform) replicated.
    """
    from smqtk_indexing_tpu.ops.ivf_tiled import ivf_query_tiled_pq
    residual = res_cents is not None

    def local(db3_l, s2_l, cb_l, pm_l, c, st_l, vt_l, vc_l, vl_l, q_l,
              *res_l):
        rc_l, r2l_l = res_l if residual else (None, None)
        n_local = db3_l.shape[0] * db3_l.shape[2]
        k_loc = min(k, n_local)
        d, r = ivf_query_tiled_pq(
            db3_l, s2_l, cb_l, pm_l, c, st_l[0], vt_l[0], vc_l[0],
            vl_l[0], q_l, k=k_loc, nprobe_orig=nprobe_orig,
            rerank=rerank, res_cents=rc_l, row2list=r2l_l, metric=metric)
        d, r = pad_to_k(d, r, k)
        offset = _global_shard_index(mesh) * n_local
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    rows_spec = row_axes(mesh)
    pm_spec = P(None, None) if perm.ndim == 2 else P(None)
    in_specs = (P(rows_spec, None, None), P(rows_spec, None, None),
                P(None, None, None), pm_spec, P(None, None),
                P(rows_spec, None, None), P(rows_spec, None),
                P(rows_spec, None), P(rows_spec, None), P(None, None))
    extra = ()
    if residual:
        in_specs = in_specs + (P(None, None), P(rows_spec))
        extra = (res_cents, row2list)
    return jax.shard_map(
        local, mesh=mesh, in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db3c, s2t, codebooks, perm, centroids, slot_table, v_tile, v_col,
      v_len, q, *extra)
