"""
Row-sharded IVF query.

The globally list-sorted database row-shards contiguously across the mesh;
a shard's inverted-list view is the clipped intersection of the global CSR
ranges with its row span, so every shard runs the unmodified single-device
list-scan kernel (ops/ivf.ivf_query) against replicated centroids and its
local offsets/lengths. Each shard probes its own ``nprobe`` best non-empty
lists (lists cut by a shard boundary are probed by both owners), results
merge with the standard k-sized all-gather — communication O(devices*B*k).

With nprobe == n_lists this is exhaustive-exact, matching the single-device
kernel; at partial nprobe per-shard probing can only widen coverage
relative to single-device probing of the same nprobe.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.ops.ivf import ivf_query
from smqtk_indexing_tpu.parallel.mesh import row_axes
from smqtk_indexing_tpu.parallel.sharded_scan import (
    _global_shard_index, _hier_merge,
)
from jax.sharding import Mesh, PartitionSpec as P


def shard_csr(offsets: np.ndarray, lens: np.ndarray, n_rows: int,
              n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """
    Clip global CSR (offsets, lens) into per-shard local views.

    :param offsets: (C,) int32 global list start rows.
    :param lens: (C,) int32 global list lengths.
    :param n_rows: Total (padded) row count; must divide by n_shards.
    :return: (local_offsets (S, C) int32 — relative to each shard's base —
        and local_lens (S, C) int32).
    """
    per = n_rows // n_shards
    out_off = np.zeros((n_shards, len(offsets)), dtype=np.int32)
    out_len = np.zeros((n_shards, len(offsets)), dtype=np.int32)
    starts = offsets.astype(np.int64)
    ends = starts + lens.astype(np.int64)
    for s in range(n_shards):
        lo, hi = s * per, (s + 1) * per
        c_start = np.clip(starts, lo, hi)
        c_end = np.clip(ends, lo, hi)
        out_off[s] = (c_start - lo).astype(np.int32)
        out_len[s] = (c_end - c_start).astype(np.int32)
    return out_off, out_len


@partial(jax.jit, static_argnames=("k", "nprobe", "l_max", "metric", "mesh",
                                   "nprobe_orig", "has_dead"))
def sharded_ivf_query_pq(mesh: Mesh, codes, codebooks, s2, valid,
                         centroids, offsets, lens, q, *, k: int,
                         nprobe: int, l_max: int,
                         metric: str = "euclidean", first_virt=None,
                         nprobe_orig=None, has_dead: bool = True,
                         res_cents=None, row2list=None):
    """
    Row-sharded IVF over PQ codes: each shard runs
    ops/ivf.ivf_query_pq on its clipped CSR view (same per-shard layout
    as :func:`sharded_ivf_query`; codebooks/centroids/queries
    replicated), winners merge with the standard k-sized all-gather.

    Residual mode (``res_cents``/``row2list`` — FAISS ``by_residual``):
    the per-probe ``-2<q, c>`` offset derives from each shard's own
    replicated probe-selection matmul, and the exact re-rank's
    centroid-add is row-local, so the codec-space centroids replicate
    and the row→original-list map row-shards with the codes.
    """
    from smqtk_indexing_tpu.ops.ivf import ivf_query_pq

    def local(codes_l, cb_l, s2_l, va_l, c, off_l, len_l, q_l, *extra_l):
        extra_l = list(extra_l)
        r2l = extra_l.pop() if row2list is not None else None
        rc = extra_l.pop() if res_cents is not None else None
        fv = extra_l.pop() if first_virt is not None else None
        k_loc = min(k, codes_l.shape[0])
        d, r = ivf_query_pq(codes_l, cb_l, s2_l, va_l, c, off_l[0],
                            len_l[0], q_l, k=k_loc, nprobe=nprobe,
                            l_max=l_max, metric=metric, first_virt=fv,
                            nprobe_orig=nprobe_orig, has_dead=has_dead,
                            res_cents=rc, row2list=r2l)
        if k_loc < k:
            b = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((b, k - k_loc), jnp.inf, jnp.float32)],
                axis=1)
            r = jnp.concatenate(
                [r, jnp.full((b, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * codes_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    rows_spec = row_axes(mesh)
    extra, extra_specs = (), ()
    if first_virt is not None:
        extra += (first_virt,)
        extra_specs += (P(None),)
    if res_cents is not None:
        extra += (res_cents,)
        extra_specs += (P(None, None),)
    if row2list is not None:
        extra += (row2list,)
        extra_specs += (P(rows_spec),)
    in_specs = (P(rows_spec, None), P(None, None, None), P(rows_spec),
                P(rows_spec), P(None, None), P(rows_spec, None),
                P(rows_spec, None), P(None, None)) + extra_specs
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(codes, codebooks, s2, valid, centroids, offsets, lens, q, *extra)


@partial(jax.jit, static_argnames=("k", "nprobe", "l_max", "metric", "mesh",
                                   "nprobe_orig", "has_dead"))
def sharded_ivf_query(mesh: Mesh, db, db_sq, db_norm, valid, centroids,
                      offsets, lens, q, *, k: int, nprobe: int, l_max: int,
                      metric: str = "euclidean", dq=None, first_virt=None,
                      nprobe_orig=None, has_dead: bool = True):
    """
    :param db/db_sq/db_norm/valid: row-sharded over ``mesh`` (list-sorted
        global order).
    :param centroids: (C, d) replicated.
    :param offsets/lens: (S, C) per-shard local CSR views, row-sharded on
        their leading axis.
    :param q: (B, d) replicated.
    :param dq: Optional replicated (a, b) SQ8 codec arrays (int8 ``db``).
    :param first_virt/nprobe_orig: Optional replicated representative-slot
        table + static original-list probe count (FAISS-faithful nprobe,
        ops/ivf.probe_eligibility). NOTE: the local lens mask then selects
        each shard's clipped portion of EXACTLY the nprobe_orig nearest
        original lists — the shard union scans precisely the faithful
        global candidate set.
    :return: (dists (B, k), global rows (B, k)), replicated.
    """
    def local(db_l, sq_l, nm_l, va_l, c, off_l, len_l, q_l, *extra_l):
        extra_l = list(extra_l)
        fv = extra_l.pop() if first_virt is not None else None
        dq_l = tuple(extra_l) if extra_l else None
        k_loc = min(k, db_l.shape[0])
        d, r = ivf_query(db_l, sq_l, nm_l, va_l, c, off_l[0], len_l[0],
                         q_l, k=k_loc, nprobe=nprobe, l_max=l_max,
                         metric=metric, dq=dq_l,
                         first_virt=fv, nprobe_orig=nprobe_orig,
                         has_dead=has_dead)
        if k_loc < k:
            b = q_l.shape[0]
            d = jnp.concatenate(
                [d, jnp.full((b, k - k_loc), jnp.inf, jnp.float32)], axis=1)
            r = jnp.concatenate(
                [r, jnp.full((b, k - k_loc), -1, jnp.int32)], axis=1)
        offset = _global_shard_index(mesh) * db_l.shape[0]
        r = jnp.where(r >= 0, r + offset, r)
        return _hier_merge(mesh, d, r, k)

    rows_spec = row_axes(mesh)
    extra = tuple(dq) if dq is not None else ()
    if first_virt is not None:
        extra = extra + (first_virt,)
    in_specs = (P(rows_spec, None), P(rows_spec), P(rows_spec),
                P(rows_spec), P(None, None), P(rows_spec, None),
                P(rows_spec, None), P(None, None)) \
        + tuple(P(None) for _ in extra)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(db, db_sq, db_norm, valid, centroids, offsets, lens, q, *extra)
