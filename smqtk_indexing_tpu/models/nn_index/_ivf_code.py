"""
Code-tier (tiled-transposed capacity) engine for IvfNearestNeighborsIndex.

The upload/query strategy of ``storage='code'``, extracted from
models/nn_index/ivf.py (the class keeps thin delegates so its
public/private surface and the validate_ivf_combination contract are
unchanged). Functions take the index instance as ``idx`` and operate on
its state under its model lock.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def encode_rows(idx, mat: np.ndarray, assigns: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """Code-tier host-mirror encode (called from ivf._layout): float32
    originals train the codec ONCE and encode to the int8/uint8 mirror;
    already-coded rows (re-layout after update/removal compaction) pass
    through. Cosine: the codes ARE the persisted representation, so
    they carry the unit-sphere rows (the tiled euclidean scan is then
    cosine ranking exactly — incl. composed with residual, round 5)."""
    if idx._pq_m(idx.dtype) is not None:
        if mat.dtype == np.uint8:
            return mat
        from smqtk_indexing_tpu.ops.pq import pq_encode_np, pq_train
        m, _, _ = idx._pq_grid()
        rows_c = idx._pq_prep_rows(
            idx._prep_for_metric(mat), rotate=False)
        if idx.pq_residual:
            rows_c = rows_c - idx._pq_cents_codec(None)[assigns]
        if idx._code_cb is None:
            live = rows_c[valid] if not valid.all() else rows_c
            if idx._pq_rotate(idx.dtype):
                from smqtk_indexing_tpu.ops.opq import opq_train
                idx._code_rot, idx._code_cb = opq_train(live, m)
            else:
                idx._code_cb = pq_train(live, m)
        if idx._code_rot is not None:
            rows_c = rows_c @ idx._code_rot
        return pq_encode_np(rows_c, idx._code_cb)
    if mat.dtype == np.int8:
        return mat
    from smqtk_indexing_tpu.ops.sq8 import sq8_encode_np, sq8_train
    mat = idx._prep_for_metric(
        np.asarray(mat, np.float32))         # cosine: unit rows
    if idx._code_a is None:
        live = mat[valid] if not valid.all() else mat
        idx._code_a, idx._code_b = sq8_train(live)
    return sq8_encode_np(mat, idx._code_a, idx._code_b)


def upload_tiled(idx) -> None:
    """Tiled-transposed device build: the single-copy layout (rows
    tile-major, dims contiguous — the list scan's form,
    ops/ivf_tiled.TILE_ROWS) + per-row surrogate stats (+inf on dead
    rows so removed entries can never win a scan), sublist CSR and the
    original->sublist slot table for table-form probe selection. The
    host mirror IS the codes; the codec lives in
    ``_code_a``/``_code_b``/``_code_cb``."""
    from smqtk_indexing_tpu.ops.ivf_tiled import (
        TILE_ROWS, build_slot_table, build_tiled_csr,
    )
    # Symmetric to _upload's stale-tiled clearing: a tiled rebuild
    # must not leave row-major device state behind.
    idx._dev = idx._dev_sq = idx._dev_norm = None
    idx._dev_valid = idx._dev_offsets = idx._dev_lens = None
    idx._dev_first_virt = None
    n = idx._host.shape[0]
    dim = idx._dim
    d_pad = idx._centroids_np.shape[1]
    n_tiles = max(1, -(-n // TILE_ROWS))
    # Mesh sharding splits the TILE axis: round the tile count up to
    # the device count so every shard owns whole tiles (a probe
    # window cannot cross tiles); surplus rows are dead-poisoned below.
    mesh = idx._make_mesh()
    if mesh is not None:
        s_dev = mesh.devices.size
        n_tiles = -(-n_tiles // s_dev) * s_dev
    n_pad = n_tiles * TILE_ROWS
    # Dead rows (and alignment padding) poison their surrogate: the
    # scan scores s2 - 2<lut/t, codes>, so +inf rows can never be
    # selected — no separate liveness gather exists on this path.
    dead = np.ones(n_pad, dtype=bool)
    dead[:n] = ~idx._valid_host
    if idx._pq_m(idx.dtype) is not None:
        m, _, perm = idx._pq_grid()
        cb = idx._code_cb
        rot = idx._code_rot
        codes = np.zeros((n_pad, m), dtype=np.uint8)
        codes[:n] = idx._host
        s2 = np.zeros(n_pad, dtype=np.float64)
        if idx.metric != "inner_product":
            # IP kernel form needs NO row stats (score = -2<q, x_hat>)
            # — skip the m full-length gather passes entirely; the
            # +inf dead poison below still applies.
            cb_sq = (cb.astype(np.float64) ** 2).sum(-1)
            for mi in range(m):
                s2 += cb_sq[mi][codes[:, mi]]
        if idx.pq_residual:
            # Residual codec: stats are the FULL reconstruction
            # norms ||c_T + r_hat||^2 = ||r_hat||^2 + 2<c_T, r_hat>
            # + ||c_T||^2; <c_T, r_hat> decomposes per subspace into
            # a (C, M, 256) centroid-codeword table (subspaces
            # partition the dims).
            cents_c = idx._pq_cents_codec(rot)
            cc64 = cents_c.astype(np.float64)
            ipc = np.einsum(
                "lms,mvs->lmv",
                cc64.reshape(cc64.shape[0], m, -1),
                cb.astype(np.float64))
            asg_pad = np.zeros(n_pad, dtype=np.int32)
            asg_pad[:n] = idx._assign_host
            s2 += (cc64 ** 2).sum(-1)[asg_pad]
            for mi in range(m):
                s2 += 2.0 * ipc[asg_pad, mi, codes[:, mi]]
            idx._cents_codec_dev = jnp.asarray(
                cents_c.astype(np.float32))
            # Keep the (n_pad,) row->list map on HOST here: the mesh
            # branch below shards it straight from numpy (a
            # jnp.asarray now would commit the whole map to ONE
            # device first — ~1.6GB at the 400M tier, the same
            # single-device-commit failure the tile buffers avoid).
            idx._row2list_dev = asg_pad
        s2 = s2.astype(np.float32)
        s2[dead] = np.inf
        # uint8 codes stored as int8 bits (the scan masks back with
        # & 0xFF).
        tiles = codes.view(np.int8).reshape(n_tiles, TILE_ROWS, m) \
            .transpose(0, 2, 1)
        idx._cb_dev = jnp.asarray(cb.astype(np.float32))
        if rot is not None:
            # OPQ: the kernel wrapper's query transform generalizes
            # from a 1-D perm (gather) to a 2-D orthogonal matrix
            # (matmul); fold perm + rotation into one.
            from smqtk_indexing_tpu.ops.opq import compose_transform
            idx._perm_dev = jnp.asarray(compose_transform(perm, rot))
        else:
            idx._perm_dev = jnp.asarray(perm)
    else:
        code_a, code_b = idx._code_a, idx._code_b
        codes = np.zeros((n_pad, d_pad), dtype=np.int8)
        codes[:n, :dim] = idx._host
        # Padding dims: epsilon scale / zero offset (zero codes and
        # query dims contribute nothing to any score term — ops/sq8).
        a_p = np.full(d_pad, 1e-12, dtype=np.float32)
        b_p = np.zeros(d_pad, dtype=np.float32)
        a_p[:dim] = code_a
        b_p[:dim] = code_b
        # Chunked stats + tile build: never materialize a float32
        # view of the whole code mirror (that is 8x the code bytes —
        # ~100GB of temporaries at the 100M 'code' tier, defeating
        # the tier's memory contract). ~1M rows per chunk.
        s2 = np.empty(n_pad, dtype=np.float32)
        tiles = np.empty((n_tiles, d_pad, TILE_ROWS), dtype=np.int8)
        t_chunk = max(1, (1 << 20) // TILE_ROWS)
        for t0 in range(0, n_tiles, t_chunk):
            t1 = min(t0 + t_chunk, n_tiles)
            r0, r1 = t0 * TILE_ROWS, t1 * TILE_ROWS
            if idx.metric == "inner_product":
                # IP kernel form scores -<q, x_hat - b> directly —
                # zero stats, +inf dead poison below.
                s2[r0:r1] = 0.0
            else:
                u = codes[r0:r1].astype(np.float32)
                u *= a_p
                s2[r0:r1] = np.einsum("nd,nd->n", u, u)
            tiles[t0:t1] = codes[r0:r1] \
                .reshape(t1 - t0, TILE_ROWS, d_pad).transpose(0, 2, 1)
        s2[dead] = np.inf
        idx._sq8_a = jnp.asarray(a_p)
        idx._sq8_b = jnp.asarray(b_p)
    c_count = idx._centroids_np.shape[0]
    lens = np.bincount(idx._assign_host,
                       minlength=c_count).astype(np.int64)
    if mesh is not None:
        # Sharded capacity tier: per-shard clipped CSR/slot tables
        # (lists cut at shard boundaries are probed by both owners —
        # the shard union scans exactly the global candidate set),
        # codes/stats sharded on the tile axis, centroids replicated.
        from smqtk_indexing_tpu.parallel.mesh import (
            replicate, shard_rows,
        )
        from smqtk_indexing_tpu.parallel.sharded_ivf_code import (
            shard_tiled_layout,
        )
        vt, vc, vl, st = shard_tiled_layout(
            lens, n_pad, mesh.devices.size, c_count)
        # Shard the big buffers straight from HOST numpy: device_put
        # with a NamedSharding sends each device only its slice —
        # wrapping in jnp.asarray first would commit the whole
        # multi-GB tile buffer to ONE device before resharding
        # (OOM at corpus sizes beyond one device, the tier's whole point).
        idx._dev3 = shard_rows(mesh, np.ascontiguousarray(tiles))
        idx._s2t = shard_rows(
            mesh, s2.reshape(n_tiles, 1, TILE_ROWS))
        idx._v_tile = shard_rows(mesh, vt)
        idx._v_col = shard_rows(mesh, vc)
        idx._v_len = shard_rows(mesh, vl)
        idx._slot_table = shard_rows(mesh, st)
        if idx._row2list_dev is not None:
            # Residual PQ: the row -> original-list map is
            # row-aligned with the tiles — shard it the same way.
            idx._row2list_dev = shard_rows(mesh, idx._row2list_dev)
        # Codec arrays are per-query shard_map operands: replicate
        # them ONCE here so the query path's replicate() calls are
        # no-ops (device_put to an equal sharding), not a fresh
        # cross-mesh transfer per batch (res_cents alone is ~8MB at
        # 16K lists x 128 dims).
        if idx._pq_m(idx.dtype) is not None:
            idx._cb_dev = replicate(mesh, idx._cb_dev)
            idx._perm_dev = replicate(mesh, idx._perm_dev)
            if idx._cents_codec_dev is not None:
                idx._cents_codec_dev = replicate(
                    mesh, idx._cents_codec_dev)
        else:
            idx._sq8_a = replicate(mesh, idx._sq8_a)
            idx._sq8_b = replicate(mesh, idx._sq8_b)
        idx._dev_centroids = replicate(
            mesh, jnp.asarray(idx._centroids_np.astype(np.float32)))
        idx._capacity = n_pad
        # Same definition as the single-device path below: TOTAL slot
        # count (incl. dead empty-list slots — budget semantics), here
        # summed over the per-shard clipped tables.
        idx._n_virtual = int(vl.size)
        idx._mesh = mesh
        return
    idx._dev3 = jnp.asarray(np.ascontiguousarray(tiles))
    idx._s2t = jnp.asarray(s2.reshape(n_tiles, 1, TILE_ROWS))
    if idx._row2list_dev is not None:
        # Residual PQ: the row->list map stayed host numpy above so
        # the mesh branch could shard it without a single-device
        # commit; single-device serving wants it resident here.
        idx._row2list_dev = jnp.asarray(idx._row2list_dev)
    v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(
        lens[None, :], np.zeros(1, dtype=np.int64))
    table = build_slot_table(v_orig, c_count)
    idx._v_tile = jnp.asarray(v_tile)
    idx._v_col = jnp.asarray(v_col)
    idx._v_len = jnp.asarray(v_len)
    idx._slot_table = jnp.asarray(table)
    idx._dev_centroids = jnp.asarray(
        idx._centroids_np.astype(np.float32))
    idx._capacity = n_pad
    idx._n_virtual = len(v_len)
    idx._mesh = None


def query_tiled(idx, q_p, k_dev):
    """Serve one padded query batch through the tiled list scan (sharded
    mesh or single device), or return None when no tiled device state
    exists (the rows-tier engines serve it — _ivf_rows.query_rows)."""
    if idx._dev3 is None:
        return None
    from smqtk_indexing_tpu.ops.device import kernel_interpret
    nprobe_o = min(idx.nprobe, idx._centroids_np.shape[0])
    rr = "score" if idx.rerank == "score" else "gather"
    pq = idx._pq_m(idx.dtype) is not None
    # The SQ8 list scan runs compiled on a GPU, interpreted on the CPU —
    # decided from where the tiles actually live (tests may pin work to
    # CPU devices). The PQ list scan is plain XLA.
    interp = None if pq else kernel_interpret(idx._dev3)
    if idx._mesh is not None:
        # Sharded code tier: per-shard tiled list scan over the clipped
        # CSR views + hierarchical k-merge (parallel/sharded_ivf_code.py).
        from smqtk_indexing_tpu.parallel.mesh import replicate
        from smqtk_indexing_tpu.parallel.sharded_ivf_code import (
            sharded_ivf_query_tiled, sharded_ivf_query_tiled_pq,
        )
        qd = replicate(idx._mesh, jnp.asarray(q_p))
        if pq:
            rc = None if idx._cents_codec_dev is None else \
                replicate(idx._mesh, idx._cents_codec_dev)
            return sharded_ivf_query_tiled_pq(
                idx._mesh, idx._dev3, idx._s2t,
                replicate(idx._mesh, idx._cb_dev),
                replicate(idx._mesh, idx._perm_dev),
                idx._dev_centroids, idx._slot_table,
                idx._v_tile, idx._v_col, idx._v_len, qd,
                k=k_dev, nprobe_orig=nprobe_o, rerank=rr,
                res_cents=rc, row2list=idx._row2list_dev,
                metric=idx.metric)
        return sharded_ivf_query_tiled(
            idx._mesh, idx._dev3, idx._s2t,
            replicate(idx._mesh, idx._sq8_a),
            replicate(idx._mesh, idx._sq8_b),
            idx._dev_centroids, idx._slot_table,
            idx._v_tile, idx._v_col, idx._v_len, qd,
            k=k_dev, nprobe_orig=nprobe_o,
            interpret=interp, rerank=rr,
            metric=idx.metric)
    # Single device: dead rows are +inf-poisoned in _s2t, so no
    # liveness gather.
    from smqtk_indexing_tpu.ops.ivf_tiled import (
        ivf_query_tiled, ivf_query_tiled_pq,
    )
    if pq:
        return ivf_query_tiled_pq(
            idx._dev3, idx._s2t, idx._cb_dev,
            idx._perm_dev, idx._dev_centroids,
            idx._slot_table, idx._v_tile, idx._v_col,
            idx._v_len, jnp.asarray(q_p), k=k_dev,
            nprobe_orig=nprobe_o, rerank=rr,
            res_cents=idx._cents_codec_dev, row2list=idx._row2list_dev,
            metric=idx.metric)
    return ivf_query_tiled(
        idx._dev3, idx._s2t, idx._sq8_a, idx._sq8_b,
        idx._dev_centroids, idx._slot_table,
        idx._v_tile, idx._v_col, idx._v_len,
        jnp.asarray(q_p), k=k_dev, nprobe_orig=nprobe_o,
        interpret=interp, rerank=rr, metric=idx.metric)
