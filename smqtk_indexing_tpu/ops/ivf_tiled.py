"""
IVF over the tiled-transposed code layout — the ``storage='code'`` tier
(FAISS 'IVF<n>,SQ8' / 'IVF<n>,PQ<M>' native list scans,
faiss.py:190,368-386).

Codes live in one (n_tiles, d, TILE_ROWS) array: row r at
``[r // TILE_ROWS, :, r % TILE_ROWS]``. Every inverted list is a run of
columns inside one tile (``build_tiled_csr`` cuts lists at W columns and
at tile edges), so a probe is a (d, W) window at a tile index and a
column. A query selects its ``nprobe`` nearest ORIGINAL centroids and
expands each through the slot table to its sublist windows
(``_windows``); the list scan scores every window, and the caller keeps
the top-(k+8) surrogate scores and finalizes (exact re-rank from the
gathered codes, or straight from the scores).

The SQ8 list scan is the Pallas kernel in ops/pallas_ivf.py (measured
faster than the plain XLA window gather end to end, PERF.md); the PQ list
scan is plain XLA (:func:`pq_list_scores`), its kernel form measured no
faster.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.ops.device import TILE_N
from smqtk_indexing_tpu.ops.pallas_ivf import W, list_scores
from smqtk_indexing_tpu.ops.scan import pad_to_k, topk_smallest

#: Row capacity of one tile of the tiled-transposed layout.
TILE_ROWS = TILE_N



def build_tiled_csr(chunk_lens, chunk_bases, cap: int = W,
                    tile: int = TILE_ROWS):
    """
    Virtual-sublist CSR over a tiled-transposed layout built in CHUNKS:
    chunk c's rows occupy global rows [chunk_bases[c], ...) sorted by
    list id, so original list ``li`` is a union of per-chunk contiguous
    runs. Each run splits at ``cap`` (so one window covers any sublist)
    and at ``tile`` boundaries (a window cannot cross tiles).

    :param chunk_lens: (n_chunks, C) int — per-chunk per-list row counts.
    :param chunk_bases: (n_chunks,) int — global first row of each chunk.
    :return: (v_tile, v_col, v_len, v_orig, first_virt) int32 arrays —
        sublist tile index / in-tile start column / length / original
        list id, plus one representative slot per original (empty
        originals get a dead len-0 slot so FAISS-faithful nprobe ranks
        them like FAISS does).
    """
    import numpy as np
    chunk_lens = np.asarray(chunk_lens)
    n_chunks, c_lists = chunk_lens.shape
    v_off, v_len, v_orig = [], [], []
    for c in range(n_chunks):
        lens_c = chunk_lens[c]
        offs = chunk_bases[c] + np.concatenate(
            [[0], np.cumsum(lens_c)[:-1]])
        for li in np.nonzero(lens_c)[0]:
            start, end = int(offs[li]), int(offs[li] + lens_c[li])
            while start < end:
                stop = min(end, start + cap,
                           (start // tile + 1) * tile)
                v_off.append(start)
                v_len.append(stop - start)
                v_orig.append(li)
                start = stop
    v_off = np.asarray(v_off, dtype=np.int64)
    v_len = np.asarray(v_len, dtype=np.int32)
    v_orig = np.asarray(v_orig, dtype=np.int32)
    # Dead slots for all-empty originals (rank, never scan).
    missing = np.setdiff1d(np.arange(c_lists), v_orig)
    if missing.size:
        v_off = np.concatenate([v_off, np.zeros(missing.size, np.int64)])
        v_len = np.concatenate([v_len, np.zeros(missing.size, np.int32)])
        v_orig = np.concatenate([v_orig, missing.astype(np.int32)])
    first_virt = np.full(c_lists, -1, dtype=np.int32)
    for i, li in enumerate(v_orig):
        if first_virt[li] < 0:
            first_virt[li] = i
    assert (first_virt >= 0).all()
    return ((v_off // tile).astype(np.int32),
            (v_off % tile).astype(np.int32), v_len, v_orig, first_virt)


def build_slot_table(v_orig, c_lists: int):
    """(C, S_max) int32 table mapping each original list to its sublist
    slot ids (-1 padded) — the probe-selection form that ranks ORIGINAL
    centroids only."""
    import numpy as np
    v_orig = np.asarray(v_orig)
    counts = np.bincount(v_orig, minlength=c_lists)
    s_max = int(counts.max())
    table = np.full((c_lists, s_max), -1, dtype=np.int32)
    fill = np.zeros(c_lists, dtype=np.int64)
    for slot, li in enumerate(v_orig):
        table[li, fill[li]] = slot
        fill[li] += 1
    return table


def _windows(slot_table, lists, v_tile, v_col, v_len, tile_n):
    """Expand selected ORIGINAL lists into their sublist windows via the
    slot table: (ti, c0, lo, hi) of shape (B, nprobe * S_max) — tile
    index, window start column and the live [lo, hi) columns of the
    window. Dead (-1) slots become zero-length windows."""
    b = lists.shape[0]
    slots = slot_table[lists]                    # (B, n_orig, S_max)
    dead = slots < 0
    slots_c = jnp.maximum(slots, 0)
    ln = jnp.where(dead, 0, v_len[slots_c])
    ti = jnp.where(dead, 0, v_tile[slots_c])
    col = jnp.where(dead, 0, v_col[slots_c])
    c0 = jnp.minimum(col, tile_n - W)
    lo = col - c0
    hi = lo + ln

    def flat(x):
        return x.reshape(b, -1).astype(jnp.int32)

    return flat(ti), flat(c0), flat(lo), flat(hi)


def _xla_windows(arr, ti, c0):
    """(B, P, rows, W) windows of a tiled array by ``lax.dynamic_slice``."""
    rows = arr.shape[1]

    def one(t, c):
        return jax.lax.dynamic_slice(arr, (t, 0, c), (1, rows, W))[0]

    return jax.vmap(jax.vmap(one))(ti, c0)


def pq_list_scores(db3c, s2t, lut, ti, c0, lo, hi, q_chunk: int = 64):
    """
    PQ list scan, plain XLA: per chunk of ``q_chunk`` queries, gather the
    (M, W) code windows and sum the query's ADC table entries per code,
    ``s2 - 2 sum_m LUT[m, code_m]``.

    :param db3c: (n_tiles, M, TILE_ROWS) int8 (uint8 PQ code bits).
    :param s2t: (n_tiles, 1, TILE_ROWS) float32 squared reconstruction
        norms (+inf poisons dead rows).
    :param lut: (B, M*256) float32 ADC table
        lut[b, m*256 + v] = <q_m, codebook[m, v]>.
    :param ti/c0/lo/hi: (B, P) int32 windows (see ``_windows``).
    :return: (B, P, W) float32 surrogate scores, +inf outside windows.
    """
    b, p = ti.shape
    bc = min(q_chunk, b)
    b_pad = -(-b // bc) * bc

    def pad(x):
        return jnp.pad(x, ((0, b_pad - b),) + ((0, 0),) * (x.ndim - 1))

    def chunk(args):
        tab, ti_c, c0_c, lo_c, hi_c = args
        codes = _xla_windows(db3c, ti_c, c0_c)         # (bc, P, M, W)
        s2 = _xla_windows(s2t, ti_c, c0_c)[:, :, 0]    # (bc, P, W)
        m = codes.shape[2]
        idx = (codes.astype(jnp.int32) & 0xFF) \
            + jnp.arange(m, dtype=jnp.int32)[None, None, :, None] * 256
        ip = jnp.sum(jax.vmap(lambda tb, i: tb[i])(tab, idx), axis=2)
        lane = jnp.arange(W, dtype=jnp.int32)[None, None, :]
        ok = (lane >= lo_c[..., None]) & (lane < hi_c[..., None])
        return jnp.where(ok, s2 - 2.0 * ip, jnp.inf)

    nc = b_pad // bc
    parts = jax.lax.map(chunk, tuple(
        pad(x).reshape((nc, bc) + x.shape[1:])
        for x in (lut.astype(jnp.float32), ti, c0, lo, hi)))
    return parts.reshape(b_pad, p, W)[:b]


def _scan_topk(scores, ti, c0, tile_n, kk):
    """Keep the top-``kk`` (B, P, W) window scores and their global rows,
    per query."""
    b, p = ti.shape
    scores = scores.reshape(b, p * W)
    rows = ((ti * tile_n + c0)[..., None]
            + jax.lax.broadcasted_iota(jnp.int32, (b, p, W), 2)
            ).reshape(b, p * W)
    top_scores, sel = topk_smallest(scores, kk)
    top_rows = jnp.take_along_axis(rows, sel, axis=1).astype(jnp.int32)
    return top_scores, jnp.where(jnp.isinf(top_scores), -1, top_rows)


def _gather_codes(db3, rows, tile_n):
    """(B, kk, d) codes of global rows (clamped at 0) from the tiled
    layout."""
    rows_c = jnp.maximum(rows, 0)
    return db3[rows_c // tile_n, :, rows_c % tile_n]


def _tiled_scan_finish(db3, s2t, a, b_codec, q, q_norm, t, ti, c0, lo, hi,
                       *, k: int, interpret: bool, rerank: str = "gather",
                       metric: str = "euclidean"):
    """Shared tail of the tiled SQ8 query: list scan over the selected
    windows, top-(k+8), then finalization per ``rerank``:

    - "gather": gather each winner's codes, dequantize, exact f32
      distance (bit-faithful to the quantized vectors) under ``metric``
      (ops/scan.exact_rerank_decoded).
    - "score": distances come straight from the scan's f32 surrogate —
      euclidean: sqrt(score + ||q - b_codec||^2), off the exact squared
      distance to the quantized vector only by f32 cancellation, at most
      ~1e-5 * (||q - b||^2 + s2) (chip_smoke.py holds it to that bound);
      rankings use the same surrogate either way.
      inner_product: the score IS -<q, x_hat - b_codec> (the caller
      passed t = q * a / 2 with zeroed s2t), so the reported negated IP
      is score - <q, b_codec>.
      cosine: rows were L2-normalized BEFORE encoding and q arrives
      normalized, so score + ||q - b||^2 = ||q - x_hat||^2 and the
      angular distance is 2*arccos(1 - d^2/2)/pi up to the codec's
      ~1e-2 deviation of ||x_hat|| from 1.
    """
    from smqtk_indexing_tpu.ops.scan import exact_rerank_decoded

    tile_n = db3.shape[2]
    p = ti.shape[1]
    kk = min(k + 8, p * W)
    scores = list_scores(db3, s2t, t, ti, c0, lo, hi, interpret=interpret)
    top_scores, top_rows = _scan_topk(scores, ti, c0, tile_n, kk)

    if rerank == "score":
        if metric == "inner_product":
            qb = jnp.sum(q * b_codec[None, :], axis=-1)
            dists = top_scores - qb[:, None]
        else:
            rq = q - b_codec[None, :]
            r_sq = jnp.sum(rq * rq, axis=-1)
            d2 = jnp.maximum(top_scores + r_sq[:, None], 0.0)
            if metric == "cosine":
                sim = jnp.clip(1.0 - d2 / 2.0, -1.0, 1.0)
                dists = 2.0 * jnp.arccos(sim) / math.pi
            else:
                dists = jnp.sqrt(d2)
        dists = jnp.where(top_rows < 0, jnp.inf, dists)
        return pad_to_k(dists, top_rows, k)

    x = _gather_codes(db3, top_rows, tile_n).astype(jnp.float32) * a \
        + b_codec
    return exact_rerank_decoded(x, q, q_norm, top_scores, top_rows,
                                metric, k)


def _tiled_scan_finish_pq(db3c, s2t, codebooks, q_c, lut, ti, c0, lo, hi,
                          *, k: int, rerank: str = "gather", probe_off=None,
                          res_cents=None, row2list=None,
                          metric: str = "euclidean"):
    """PQ counterpart of :func:`_tiled_scan_finish`: list scan + top-k
    over the windows, then finalization per ``rerank`` — "gather" decodes
    the winners' codes exactly (f32) and reports distances exact w.r.t.
    the reconstruction; "score" reconstructs sqrt(score + ||q||^2) from
    the scan's surrogate.

    Residual mode (``probe_off``/``res_cents``/``row2list`` given): the
    scores gain a per-probe ``-2<q, c>`` broadcast before selection
    (codes carry residuals; s2t holds ``||c_T + r_hat||^2``), and the
    exact decode adds the winner's codec-space centroid back."""
    from smqtk_indexing_tpu.ops.pq import _dequant
    from smqtk_indexing_tpu.ops.scan import exact_rerank_decoded

    tile_n = db3c.shape[2]
    m_sub = db3c.shape[1]
    b, p = ti.shape
    q_sq = jnp.sum(q_c * q_c, axis=-1)
    q_norm = jnp.sqrt(q_sq)
    kk = min(k + 8, p * W)

    scores = pq_list_scores(db3c, s2t, lut, ti, c0, lo, hi)
    if probe_off is not None:
        # Residual offset: +inf-masked window columns stay +inf.
        scores = scores + probe_off[:, :, None]
    top_scores, top_rows = _scan_topk(scores, ti, c0, tile_n, kk)

    if rerank == "score":
        if metric == "inner_product":
            # Score with zeroed s2t is exactly -2<q, x_hat>.
            dists = top_scores / 2.0
        else:
            d2 = jnp.maximum(top_scores + q_sq[:, None], 0.0)
            if metric == "cosine":
                sim = jnp.clip(1.0 - d2 / 2.0, -1.0, 1.0)
                dists = 2.0 * jnp.arccos(sim) / math.pi
            else:
                dists = jnp.sqrt(d2)
        dists = jnp.where(top_rows < 0, jnp.inf, dists)
        return pad_to_k(dists, top_rows, k)

    codes_u = _gather_codes(db3c, top_rows, tile_n).astype(jnp.int32) & 0xFF
    x = _dequant(codes_u.reshape(b * kk, m_sub), codebooks,
                 dtype=jnp.float32).reshape(b, kk, -1)
    if res_cents is not None:
        rows_c = jnp.maximum(top_rows, 0)
        x = x + jnp.take(res_cents,
                         jnp.take(row2list, rows_c, axis=0), axis=0)
    return exact_rerank_decoded(x, q_c, q_norm, top_scores, top_rows,
                                metric, k)


def _probe_lists(q, centroids, nprobe_orig, metric):
    """Nearest ``nprobe_orig`` ORIGINAL centroids per query (-IP for
    inner_product): (ip_c (B, C), lists (B, nprobe_orig))."""
    c = centroids.astype(jnp.float32)
    ip_c = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    if metric == "inner_product":
        c_scores = -ip_c
    else:
        c_scores = jnp.sum(c * c, axis=-1)[None, :] - 2.0 * ip_c
    _, lists = jax.lax.top_k(-c_scores, nprobe_orig)
    return ip_c, lists


@partial(jax.jit, static_argnames=("k", "nprobe_orig", "interpret",
                                   "rerank", "metric"))
def ivf_query_tiled(db3: jnp.ndarray, s2t: jnp.ndarray,
                    a: jnp.ndarray, b_codec: jnp.ndarray,
                    centroids: jnp.ndarray, slot_table: jnp.ndarray,
                    v_tile: jnp.ndarray, v_col: jnp.ndarray,
                    v_len: jnp.ndarray, q: jnp.ndarray, *,
                    k: int, nprobe_orig: int, interpret: bool,
                    rerank: str = "gather", metric: str = "euclidean"
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Tiled IVF-SQ8 query with ORIGINAL-centroid probe selection: rank the
    (C, d) original centroids, take exactly the ``nprobe_orig`` nearest
    (FAISS-faithful by construction), and expand each via ``slot_table``
    to its sublist windows (budget nprobe_orig * S_max; dead pad slots
    load nothing).

    ``metric``: 'euclidean' (default), 'inner_product' or 'cosine' (FAISS
    IVF serves METRIC_INNER_PRODUCT through the same list scans,
    faiss.py:51-67). The scan's score is always ``s2 - 2 <t, u>``, so
    inner_product folds the query as ``t = q * a / 2`` against ZEROED row
    stats (the caller builds s2t = 0 with +inf dead poison), making the
    score exactly ``-<q, x_hat - b_codec>`` — a per-query constant away
    from -IP. Probe selection ranks centroids by -IP. Cosine callers pass
    q and centroids/codes already L2-normalized (build-side contract) and
    the euclidean pipeline IS cosine ranking on the unit sphere.

    :param interpret: ops/device.kernel_interpret of the operands.
    :return: (dists (B, k) float32 ascending — exact w.r.t. the quantized
        vectors under rerank='gather', rows (B, k) int32; +inf / -1
        padding).
    """
    tile_n = db3.shape[2]
    q = q.astype(jnp.float32)
    q_norm = jnp.sqrt(jnp.sum(q * q, axis=-1))
    if metric == "inner_product":
        t = q * (0.5 * a[None, :])
    else:
        t = (q - b_codec[None, :]) * a[None, :]
    _, lists = _probe_lists(q, centroids, nprobe_orig, metric)
    ti, c0, lo, hi = _windows(slot_table, lists, v_tile, v_col, v_len,
                              tile_n)
    return _tiled_scan_finish(db3, s2t, a, b_codec, q, q_norm, t,
                              ti, c0, lo, hi, k=k, interpret=interpret,
                              rerank=rerank, metric=metric)


@partial(jax.jit, static_argnames=("k", "nprobe_orig", "rerank", "metric"))
def ivf_query_tiled_pq(db3c: jnp.ndarray, s2t: jnp.ndarray,
                       codebooks: jnp.ndarray, perm: jnp.ndarray,
                       centroids: jnp.ndarray, slot_table: jnp.ndarray,
                       v_tile: jnp.ndarray, v_col: jnp.ndarray,
                       v_len: jnp.ndarray, q: jnp.ndarray, *,
                       k: int, nprobe_orig: int, rerank: str = "gather",
                       res_cents=None, row2list=None,
                       metric: str = "euclidean"
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Tiled IVF-PQ query with original-centroid probe selection — the
    reference's 'IVF<n>,PQ<M>' configuration (faiss.py:190). Probe
    selection ranks the (C, d) original centroids in the ORIGINAL dim
    order; the ADC table and the exact decode work on the codec grid
    (``perm``-interleaved dims — L2 distances are permutation invariant).

    :param codebooks: (M, 256, dsub) float32 (codec-grid subspaces).
    :param perm: (d_codec,) int32 dim interleave (ops/pq.pq_build_store)
        OR a (d_codec, d_codec) float32 orthogonal transform (the OPQ
        interleave+rotation composition, ops/opq.compose_transform) —
        L2 is invariant under either, so the scan/ADC math is identical.
    :param q: (B, d_pad) float32 queries, original (lane-padded) order.
    :param res_cents: (C_orig, d_codec) float32 codec-space centroids —
        residual mode (FAISS ``by_residual``; codes carry
        ``x_T - c_T[list]``, s2t holds ``||c_T + r_hat||^2``).
    :param row2list: (n_pad,) int32 original-list id per tiled row
        (residual mode; required for rerank="gather").
    :param metric: 'euclidean' | 'inner_product' | 'cosine'. The ADC
        table is a pure inner product either way; inner_product zeroes
        the s2 stats build-side so the score is exactly
        ``-2 <q, x_hat>`` (IP is invariant under the perm/orthogonal
        codec transform), and probe selection ranks centroids by -IP.
        Cosine callers pass q normalized over codes of normalized rows
        (euclidean pipeline == cosine ranking on the unit sphere) —
        this composes with residual mode unchanged. Residual
        inner_product is rejected (IP probe selection has no L2
        decomposition).
    """
    if res_cents is not None and rerank != "score" and row2list is None:
        raise ValueError("residual gather re-rank needs row2list")
    if res_cents is not None and metric == "inner_product":
        raise ValueError(
            "residual PQ serves euclidean or cosine (IP probe selection "
            "has no L2 -2<q,c> decomposition)")
    m_sub, tile_n = db3c.shape[1], db3c.shape[2]
    b, d_pad = q.shape
    d_codec = perm.shape[0]
    q = q.astype(jnp.float32)
    if d_codec > d_pad:
        q_ext = jnp.concatenate(
            [q, jnp.zeros((b, d_codec - d_pad), jnp.float32)], axis=1)
    else:
        q_ext = q
    if perm.ndim == 2:                              # OPQ transform
        q_c = jnp.dot(q_ext, perm.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    else:
        q_c = jnp.take(q_ext, perm, axis=1)         # codec grid
    dsub = d_codec // m_sub
    lut = jnp.einsum(
        "bms,mvs->bmv", q_c.reshape(b, m_sub, dsub), codebooks,
        precision=jax.lax.Precision.HIGHEST).reshape(b, m_sub * 256)

    ip_c, lists = _probe_lists(q, centroids, nprobe_orig, metric)
    ti, c0, lo, hi = _windows(slot_table, lists, v_tile, v_col, v_len,
                              tile_n)

    probe_off = None
    if res_cents is not None:
        # Per-ORIGINAL-list -2<q, c>, broadcast over its sublist slots
        # (dead slots score +inf regardless — their windows are empty).
        s_max = slot_table.shape[1]
        off_orig = -2.0 * jnp.take_along_axis(ip_c, lists, axis=1)
        probe_off = jnp.broadcast_to(
            off_orig[..., None], (b, nprobe_orig, s_max)).reshape(b, -1)

    return _tiled_scan_finish_pq(db3c, s2t, codebooks, q_c, lut,
                                 ti, c0, lo, hi, k=k, rerank=rerank,
                                 probe_off=probe_off,
                                 res_cents=res_cents, row2list=row2list,
                                 metric=metric)
