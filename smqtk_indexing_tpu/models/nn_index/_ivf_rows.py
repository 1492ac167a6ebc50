"""
Rows-tier (float/row-major) engine for IvfNearestNeighborsIndex.

The upload/query strategy of ``storage='rows'`` — the float32 host
mirror with per-codec device layouts (f32/bf16 rows, row-major sq8
codes, PQ codes with XLA grouped dequant) served by the XLA list scans
(ops/ivf.ivf_query[_pq]) — extracted from models/nn_index/ivf.py (the
class keeps thin delegates). Functions take the index instance as
``idx``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.ops.device import capacity_for, pad_rows_np
from smqtk_indexing_tpu.ops.device import pow2_at_least as _pow2_at_least
from smqtk_indexing_tpu.ops.ivf import ivf_query
from smqtk_indexing_tpu.ops.pq import pq_prep_queries as _pq_prep


#: Longest virtual sublist of the rows-tier list balancer (see
#: upload_rows); fixes list layouts, and with them probe sets and recall.
SUBLIST_CAP = 480


def upload_rows(idx) -> None:
    n = idx._host.shape[0]
    idx._capacity = capacity_for(n)
    d_pad = idx._centroids_np.shape[1]
    valid = np.zeros(idx._capacity, dtype=bool)
    valid[:n] = idx._valid_host
    if idx.dtype == "sq8":
        # int8 code storage (the reference's 'IVFn,SQ8' codec axis,
        # faiss.py:190): scoring stats come from the DEQUANTIZED rows
        # so surrogate + exact re-rank agree (ops/sq8.py).
        from smqtk_indexing_tpu.ops import sq8 as sq8_ops
        (idx._sq8_a, idx._sq8_b, idx._dev, _, nrm) = \
            sq8_ops.sq8_build_store(idx._host, idx._valid_host,
                                    idx._capacity, d_pad, idx._dim)
        # ||x_hat||^2 = s2 + 2<a*u, b> + ||b||^2 == nrm^2; use the
        # dequantized stats directly.
        idx._dev_sq = nrm * nrm
        idx._dev_norm = nrm
        idx._dev_valid = jnp.asarray(valid)
    elif idx._pq_m(idx.dtype) is not None:
        # PQ codes in list-sorted order (the 'IVFn,PQm' factory
        # configuration) — shared codec build (ops/pq.pq_build_store:
        # dim interleave, train-per-build, exact recon-norm stats).
        from smqtk_indexing_tpu.ops import pq as pq_ops
        if idx.pq_residual:
            (idx._pq_perm, idx._pq_rot, _, idx._pq_cb_dev,
             idx._dev, s2, cents_c, idx._row2list_dev) = \
                pq_ops.pq_residual_build_store(
                    idx._host, idx._valid_host, idx._capacity,
                    d_pad, idx._pq_m(idx.dtype),
                    idx._centroids_np, idx._assign_host,
                    rotate=idx._pq_rotate(idx.dtype))
            idx._cents_codec_dev = jnp.asarray(
                cents_c.astype(np.float32))
        else:
            (idx._pq_perm, idx._pq_rot, _, idx._pq_cb_dev,
             idx._dev, s2) = pq_ops.pq_build_store(
                idx._host, idx._valid_host, idx._capacity, d_pad,
                idx._pq_m(idx.dtype),
                rotate=idx._pq_rotate(idx.dtype))
        # Padding rows decode to some centroid, but list windows
        # never cover them; keep their stats harmless anyway.
        idx._dev_sq = jnp.where(jnp.asarray(valid), s2, 0.0)
        idx._dev_norm = jnp.sqrt(jnp.maximum(idx._dev_sq, 0.0))
        idx._dev_valid = jnp.asarray(valid)
    else:
        dev_dtype = jnp.bfloat16 if idx.dtype == "bfloat16" \
            else jnp.float32
        # Host matrix is raw vectors; device matrix matches the metric
        # space used for exact scoring (raw for all metrics — cosine
        # normalizes in the kernel via db_norm).
        padded = pad_rows_np(idx._host, idx._capacity, d_pad)
        sq = np.zeros(idx._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", idx._host, idx._host)
        idx._dev = jnp.asarray(padded, dtype=dev_dtype)
        idx._dev_sq = jnp.asarray(sq)
        idx._dev_norm = jnp.sqrt(idx._dev_sq)
        idx._dev_valid = jnp.asarray(valid)
    c_count = idx._centroids_np.shape[0]
    lens = np.bincount(idx._assign_host,
                       minlength=c_count).astype(np.int32)
    offsets = np.zeros(c_count, dtype=np.int32)
    offsets[1:] = np.cumsum(lens)[:-1]
    # Balance the inverted lists: the query kernel pads every probe to
    # the LONGEST list, so one skewed mega-list multiplies the whole
    # gather. Lists longer than ~2x the mean split into contiguous
    # virtual sublists sharing (duplicating) their centroid — duplicate
    # centroid scores tie, so the probe selection naturally spends
    # adjacent nprobe slots covering a big list (standard IVF bucket
    # balancing; nprobe counts sublists).
    cap = min(max(int(np.ceil(2.0 * max(n, 1) / c_count)), 32),
              SUBLIST_CAP)
    v_off, v_len, v_orig = [], [], []
    for li in range(c_count):
        length = int(lens[li])
        start = int(offsets[li])
        if length == 0:
            v_off.append(start)
            v_len.append(0)
            v_orig.append(li)
            continue
        for lo in range(0, length, cap):
            v_off.append(start + lo)
            v_len.append(min(cap, length - lo))
            v_orig.append(li)
    v_off = np.asarray(v_off, dtype=np.int32)
    v_len = np.asarray(v_len, dtype=np.int32)
    v_orig = np.asarray(v_orig, dtype=np.int32)
    idx._n_virtual = len(v_off)
    # One representative virtual slot per original list (v_orig is
    # ascending by construction) — drives the FAISS-faithful
    # original-list probe eligibility (ops/ivf.probe_eligibility).
    first_virt = np.searchsorted(v_orig,
                                 np.arange(c_count)).astype(np.int32)
    idx._dev_first_virt = jnp.asarray(first_virt)
    # Worst-case sublists of a single original list: the query-side
    # nprobe translation scales by this so probing n original lists
    # always has enough virtual slots regardless of how finely the
    # balancer split them.
    idx._max_split = int(np.bincount(v_orig).max())
    idx._l_max = _pow2_at_least(max(int(v_len.max()), 1))
    # Centroids stay float even over int8 code storage.
    cent_dtype = jnp.bfloat16 if idx.dtype == "bfloat16" \
        else jnp.float32
    idx._dev_centroids = jnp.asarray(idx._centroids_np[v_orig],
                                      dtype=cent_dtype)
    if idx._pq_m(idx.dtype) is not None:
        # PQ queries arrive dim-interleaved (and OPQ-rotated) on the
        # codec grid; probe selection needs centroids in the same
        # space (rankings are orthogonal-transform invariant).
        idx._dev_centroids_pq = jnp.asarray(
            _pq_prep(idx._centroids_np[v_orig].astype(np.float32),
                     idx._pq_perm, idx._pq_rot))
    offsets, lens = v_off, v_len
    idx._dev_offsets = jnp.asarray(offsets)
    idx._dev_lens = jnp.asarray(lens)
    idx._mesh = idx._make_mesh()
    if idx._mesh is not None:
        from smqtk_indexing_tpu.parallel.mesh import (
            replicate, shard_rows,
        )
        from smqtk_indexing_tpu.parallel.sharded_ivf import shard_csr
        n_shards = idx._mesh.devices.size
        loc_off, loc_len = shard_csr(offsets, lens, idx._capacity,
                                     n_shards)
        idx._dev = shard_rows(idx._mesh, idx._dev)
        idx._dev_sq = shard_rows(idx._mesh, idx._dev_sq)
        idx._dev_norm = shard_rows(idx._mesh, idx._dev_norm)
        idx._dev_valid = shard_rows(idx._mesh, idx._dev_valid)
        idx._dev_centroids = replicate(idx._mesh,
                                        idx._dev_centroids)
        idx._dev_offsets = shard_rows(idx._mesh,
                                       jnp.asarray(loc_off))
        idx._dev_lens = shard_rows(idx._mesh, jnp.asarray(loc_len))
        idx._dev_first_virt = replicate(idx._mesh,
                                         idx._dev_first_virt)
        if idx._pq_m(idx.dtype) is not None:
            idx._pq_cb_dev = replicate(idx._mesh, idx._pq_cb_dev)
            idx._dev_centroids_pq = replicate(
                idx._mesh, idx._dev_centroids_pq)
            if idx.pq_residual:
                # Residual PQ: the row -> original-list map shards
                # with the codes; codec-space centroids replicate
                # (the per-probe -2<q,c> offset derives from each
                # shard's own probe-selection matmul).
                idx._row2list_dev = shard_rows(
                    idx._mesh, idx._row2list_dev)
                idx._cents_codec_dev = replicate(
                    idx._mesh, idx._cents_codec_dev)

# ------------------------------------------------------------------
# persistence
# ------------------------------------------------------------------


def query_rows(idx, q_p, k_dev, nprobe, first_virt, nprobe_orig,
               has_dead):
    """Serve one padded query batch through the rows-tier engines:
    sharded PQ / sharded generic / PQ grouped-dequant / generic XLA list
    scan."""
    if idx._mesh is not None \
            and idx._pq_m(idx.dtype) is not None:
        from smqtk_indexing_tpu.parallel.mesh import replicate
        from smqtk_indexing_tpu.parallel.sharded_ivf import (
            sharded_ivf_query_pq,
        )
        dists, rows = sharded_ivf_query_pq(
            idx._mesh, idx._dev, idx._pq_cb_dev, idx._dev_sq,
            idx._dev_valid, idx._dev_centroids_pq,
            idx._dev_offsets, idx._dev_lens,
            replicate(idx._mesh, jnp.asarray(
                _pq_prep(q_p, idx._pq_perm, idx._pq_rot))),
            k=k_dev, nprobe=nprobe, l_max=idx._l_max,
            metric=idx.metric, first_virt=first_virt,
            nprobe_orig=nprobe_orig, has_dead=has_dead,
            res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev)
    elif idx._mesh is not None:
        from smqtk_indexing_tpu.parallel.mesh import replicate
        from smqtk_indexing_tpu.parallel.sharded_ivf import (
            sharded_ivf_query,
        )
        dq = None
        if idx.dtype == "sq8":
            dq = (replicate(idx._mesh, idx._sq8_a),
                  replicate(idx._mesh, idx._sq8_b))
        dists, rows = sharded_ivf_query(
            idx._mesh, idx._dev, idx._dev_sq, idx._dev_norm,
            idx._dev_valid, idx._dev_centroids,
            idx._dev_offsets, idx._dev_lens,
            replicate(idx._mesh, jnp.asarray(q_p)), k=k_dev,
            nprobe=nprobe, l_max=idx._l_max, metric=idx.metric,
            dq=dq, first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead)
    elif idx._pq_m(idx.dtype) is not None:
        from smqtk_indexing_tpu.ops.ivf import ivf_query_pq
        dists, rows = ivf_query_pq(
            idx._dev, idx._pq_cb_dev, idx._dev_sq,
            idx._dev_valid, idx._dev_centroids_pq,
            idx._dev_offsets, idx._dev_lens,
            jnp.asarray(_pq_prep(q_p, idx._pq_perm,
                                 idx._pq_rot)),
            k=k_dev,
            nprobe=nprobe, l_max=idx._l_max, metric=idx.metric,
            first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead, res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev)
    else:
        dq = (idx._sq8_a, idx._sq8_b) \
            if idx.dtype == "sq8" else None
        dists, rows = ivf_query(
            idx._dev, idx._dev_sq, idx._dev_norm,
            idx._dev_valid, idx._dev_centroids,
            idx._dev_offsets, idx._dev_lens,
            jnp.asarray(q_p), k=k_dev, nprobe=nprobe,
            l_max=idx._l_max, metric=idx.metric, dq=dq,
            first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead)
    return dists, rows
