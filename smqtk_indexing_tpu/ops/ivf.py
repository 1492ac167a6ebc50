"""
IVF (inverted-file) list-scan query kernel.

Device-resident equivalent of FAISS's IVF search with ``nprobe``
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:715-749): the
database is laid out sorted by coarse-cluster id so every inverted list is a
contiguous row range (CSR layout: per-list offset + length). A query batch
scores the centroid matrix with one matrix product, selects the top-``nprobe`` lists,
gathers the (padded) candidate row blocks, scores them with the same
monotone surrogates as the flat scan, and finishes with the fused exact
re-rank of the k winners (ops/scan._exact_selected) — the reference's
host-side exact re-rank (faiss.py:818-827) fused on device.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.ops.scan import _exact_selected

METRICS = ("euclidean", "inner_product", "cosine")


def probe_eligibility(c_scores_raw: jnp.ndarray, lens: jnp.ndarray,
                      first_virt, nprobe_orig) -> jnp.ndarray:
    """
    FAISS-faithful nprobe semantics (faiss.py:715-749): ``nprobe`` counts
    ORIGINAL inverted lists ranked purely by centroid distance, and exactly
    those lists' contents are scanned — the list balancer's virtual
    sublists must not let nearer sublists of farther lists sneak in.

    Every sublist of an original list carries a bitwise-identical centroid
    score (duplicated centroid rows, one matmul), so the original ranking
    is read off the virtual scores at one representative slot per original
    (``first_virt``): a slot is eligible iff its score is <= the
    nprobe_orig-th best original score. Exact score ties across distinct
    originals admit a superset (deterministic; the probe budget carries +8
    slack for them).

    Degenerate-tie limitation: the budget's slack covers ONE extra tied
    original list (times its sublists). If >1 distinct originals tie
    bitwise at the threshold (possible only with duplicate data yielding
    byte-identical k-means centroids — never observed with real-valued
    descriptors), ``top_k`` over the widened-but-finite budget may drop
    some tied lists' sublists, scanning a deterministic subset of the
    admitted superset. Results remain valid neighbors; only the
    tie-breaking order differs from FAISS's.

    :param c_scores_raw: (B, C_virtual) UNMASKED centroid surrogate scores
        (ascending better; empty lists included, as FAISS ranks them).
    :param lens: (C_virtual,) sublist lengths.
    :param first_virt: (C_original,) int32 — one representative virtual
        slot per original list; None disables original-level thresholding
        (legacy behavior: rank virtual sublists directly).
    :param nprobe_orig: Original lists to probe (static), or None.
    :return: (B, C_virtual) scores with ineligible/empty slots at +inf.
    """
    masked = jnp.where(lens[None, :] > 0, c_scores_raw, jnp.inf)
    if first_virt is None or nprobe_orig is None \
            or nprobe_orig >= first_virt.shape[0]:
        return masked
    orig_scores = jnp.take(c_scores_raw, first_virt, axis=1)  # (B, C)
    neg_o, _ = jax.lax.top_k(-orig_scores, nprobe_orig)
    thresh = -neg_o[:, -1]
    return jnp.where(c_scores_raw <= thresh[:, None], masked, jnp.inf)


@partial(jax.jit,
         static_argnames=("k", "nprobe", "l_max", "metric", "nprobe_orig",
                          "has_dead"))
def ivf_query(db: jnp.ndarray, db_sq: jnp.ndarray, db_norm: jnp.ndarray,
              valid: jnp.ndarray, centroids: jnp.ndarray,
              offsets: jnp.ndarray, lens: jnp.ndarray, q: jnp.ndarray, *,
              k: int, nprobe: int, l_max: int,
              metric: str = "euclidean", dq=None, first_virt=None,
              nprobe_orig=None, has_dead: bool = True
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    :param db: (N, d) database sorted by coarse-cluster id (zero-padded).
        May hold int8 SQ8 codes when ``dq`` is given (the reference's
        'IVFn,SQ8' factory configuration, faiss.py:190).
    :param dq: Optional (a, b) SQ8 codec arrays — gathered candidates
        dequantize to float32 before scoring, and db_sq/db_norm must be
        the DEQUANTIZED rows' stats (distances are exact w.r.t. the
        quantized vectors, as in ops/sq8.sq8_topk).
    :param db_sq: (N,) squared L2 norms of rows.
    :param db_norm: (N,) L2 norms of rows.
    :param valid: (N,) bool row-liveness mask.
    :param centroids: (C, d) coarse centroids.
    :param offsets: (C,) int32 start row of each inverted list.
    :param lens: (C,) int32 length of each inverted list.
    :param q: (B, d) float32 queries.
    :param k: Neighbors per query (static).
    :param nprobe: Virtual probe-slot budget per query (static; <= C).
    :param l_max: Padded inverted-list length (static; >= max(lens)).
    :param metric: 'euclidean' | 'inner_product' | 'cosine' (static).
    :param first_virt: Optional (C_original,) representative virtual slot
        per original list — enables FAISS-faithful original-list probe
        eligibility (see :func:`probe_eligibility`).
    :param nprobe_orig: Original lists to probe (static; with first_virt).
    :return: (dists (B, k) float32 ascending, rows (B, k) int32 into the
        sorted layout; unfilled slots carry +inf / -1).
    """
    n, d = db.shape
    b = q.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    q_norm = jnp.sqrt(q_sq)

    # Centroids stay float even over int8 code storage.
    c_dt = jnp.float32 if dq is not None else db.dtype
    c = centroids.astype(c_dt)
    c_sq = jnp.sum(c.astype(jnp.float32) * c.astype(jnp.float32), axis=-1)
    # precision=HIGHEST: see ops/scan._chunk_scores — default-precision
    # f32 products may run in TF32 and corrupt score rankings.
    ip_c = jnp.dot(q.astype(c_dt), c.T,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    if metric == "inner_product":
        c_scores = -ip_c
    elif metric == "cosine":
        c_norm = jnp.sqrt(c_sq)
        denom = q_norm[:, None] * c_norm[None, :]
        c_scores = -(ip_c / jnp.where(denom == 0, 1.0, denom))
    else:
        c_scores = c_sq[None, :] - 2.0 * ip_c
    c_scores = probe_eligibility(c_scores, lens, first_virt, nprobe_orig)
    _, lists = jax.lax.top_k(-c_scores, nprobe)          # (B, nprobe)

    starts = offsets[lists]                               # (B, nprobe)
    # Budget slots past the eligible lists (score +inf) scan nothing.
    probe_ok = jnp.take_along_axis(c_scores, lists, axis=1) < jnp.inf
    lengths = jnp.where(probe_ok, lens[lists], 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (b, nprobe, l_max), 2)
    rows = starts[..., None] + ii                         # (B, nprobe, L)
    in_list = ii < lengths[..., None]
    rows_flat = jnp.clip(rows.reshape(b, nprobe * l_max), 0, n - 1)
    mask = in_list.reshape(b, nprobe * l_max)
    if has_dead:
        # Scattered per-row liveness gather — skipped by callers whose
        # stores carry no removed rows (windows never cover padding).
        mask = mask & jnp.take(valid, rows_flat, axis=0)

    cand = jnp.take(db, rows_flat, axis=0)                # (B, M, d)
    cand = cand.astype(jnp.float32)
    if dq is not None:
        cand = cand * dq[0] + dq[1]
    ip = jnp.einsum("bmd,bd->bm", cand, q,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric == "inner_product":
        scores = -ip
    elif metric == "cosine":
        cn = jnp.take(db_norm, rows_flat, axis=0)
        denom = q_norm[:, None] * cn
        scores = -(ip / jnp.where(denom == 0, 1.0, denom))
    else:
        scores = jnp.take(db_sq, rows_flat, axis=0) - 2.0 * ip
    scores = jnp.where(mask, scores, jnp.inf)

    # The candidate pool may be smaller than k (few probed lists); select
    # what exists and pad the remainder with empty (-1 / +inf) slots.
    k_inner = min(k, nprobe * l_max)
    neg, sel = jax.lax.top_k(-scores, k_inner)
    top_rows = jnp.take_along_axis(rows_flat, sel, axis=1).astype(jnp.int32)
    top_scores = -neg
    top_rows = jnp.where(jnp.isinf(top_scores), -1, top_rows)
    if k_inner < k:
        pad = k - k_inner
        top_scores = jnp.concatenate(
            [top_scores, jnp.full((b, pad), jnp.inf, jnp.float32)], axis=1)
        top_rows = jnp.concatenate(
            [top_rows, jnp.full((b, pad), -1, jnp.int32)], axis=1)
    return _exact_selected(metric, db, q, q_sq, top_scores, top_rows,
                           dq=dq)


@partial(jax.jit,
         static_argnames=("k", "nprobe", "l_max", "metric", "nprobe_orig",
                          "has_dead"))
def ivf_query_pq(codes: jnp.ndarray, codebooks: jnp.ndarray,
                 s2: jnp.ndarray, valid: jnp.ndarray,
                 centroids: jnp.ndarray, offsets: jnp.ndarray,
                 lens: jnp.ndarray, q: jnp.ndarray, *, k: int, nprobe: int,
                 l_max: int, metric: str = "euclidean", first_virt=None,
                 nprobe_orig=None, has_dead: bool = True,
                 res_cents=None, row2list=None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    IVF list-scan over PRODUCT-QUANTIZED codes — the reference's
    'IVF<n>,PQ<M>' factory configuration (faiss.py:190): same CSR probe
    selection as :func:`ivf_query`, but the database is (N, M) uint8 PQ
    codes dequantized per probed list via the one-hot matmul formulation
    (ops/pq._dequant; no ADC table gathers). Probed lists stream through
    a ``lax.scan`` with a running top-(k+8); the winners re-rank exactly
    from f32-decoded rows, so reported distances are exact w.r.t. the
    reconstruction (the codec being the only loss, as with FAISS IVF-PQ).

    Residual mode (``res_cents``/``row2list`` given — FAISS
    ``by_residual``): codes carry ``x_T - c_T[list]``; the score adds a
    per-probe ``-2<q, c_probe>`` offset (one broadcast, derived from the
    probe-selection matmul already computed) and ``s2`` holds the FULL
    reconstruction norms ``||c_T + r_hat||^2``
    (ops/pq.pq_residual_build_store). Euclidean only.

    :param codes: (N, M) uint8 codes in list-sorted CSR order.
    :param codebooks: (M, 256, d // M) float32.
    :param s2: (N,) float32 squared reconstruction norms.
    :param res_cents: (C_orig, d_codec) float32 codec-space centroids
        (residual mode only).
    :param row2list: (N,) int32 original-list id per row (residual mode
        only; drives the exact re-rank's centroid add).
    :return: (dists (B, k) ascending, rows (B, k) int32; +inf/-1 pads).
    """
    from smqtk_indexing_tpu.ops.pq import _dequant

    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}")
    residual = res_cents is not None
    if residual and metric != "euclidean":
        raise ValueError("residual PQ serves euclidean only")
    n, m_sub = codes.shape
    b = q.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    q_norm = jnp.sqrt(q_sq)

    c = centroids.astype(jnp.float32)
    c_sq = jnp.sum(c * c, axis=-1)
    ip_c = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    if metric == "inner_product":
        c_scores = -ip_c
    elif metric == "cosine":
        c_norm = jnp.sqrt(c_sq)
        denom = q_norm[:, None] * c_norm[None, :]
        c_scores = -(ip_c / jnp.where(denom == 0, 1.0, denom))
    else:
        c_scores = c_sq[None, :] - 2.0 * ip_c
    c_scores = probe_eligibility(c_scores, lens, first_virt, nprobe_orig)
    _, lists = jax.lax.top_k(-c_scores, nprobe)
    starts = offsets[lists]                               # (B, P)
    probe_ok = jnp.take_along_axis(c_scores, lists, axis=1) < jnp.inf
    lengths = jnp.where(probe_ok, lens[lists], 0)
    if residual:
        # Per-probe -2<q, c> from the probe-selection matmul (constant
        # across a probe's rows — one broadcast per scan step).
        probe_off = -2.0 * jnp.take_along_axis(ip_c, lists, axis=1)
    else:
        probe_off = jnp.zeros_like(starts, dtype=jnp.float32)

    kk = min(k + 8, nprobe * l_max)  # margin absorbs bf16 decode noise
    # Probes stream through the scan in GROUPS: one probe per step makes
    # every dequant matmul tiny and pays the scan/gather fixed cost
    # nprobe times — grouping widens the one-hot dots and the ip
    # contraction by 8x per step (the per-step candidate block stays
    # ~l_max*8 rows, well under the streamed-scan chunk budget).
    group = 1
    while group < 8 and nprobe % (group * 2) == 0 \
            and l_max * group * 2 <= 8192:
        group *= 2
    g_l = group * l_max
    iota_l = jax.lax.broadcasted_iota(
        jnp.int32, (b, group, l_max), 2)

    def body(carry, blk):
        bs, br = carry
        start_j, len_j, off_j = blk                       # (G, B) each
        rows_j = jnp.transpose(start_j)[..., None] + iota_l  # (B, G, L)
        ok = iota_l < jnp.transpose(len_j)[..., None]
        rows_c = jnp.clip(rows_j, 0, n - 1).reshape(b, g_l)
        ok = ok.reshape(b, g_l)
        if has_dead:
            ok = ok & jnp.take(valid, rows_c, axis=0)
        cj = jnp.take(codes, rows_c, axis=0)              # (B, GL, M)
        x = _dequant(cj.reshape(b * g_l, m_sub),
                     codebooks).reshape(b, g_l, -1)       # f32 of bf16 cb
        # Batched contraction (bf16 operands, f32 accumulation); the
        # decode noise is already bf16-level and the winners re-rank
        # exactly, so the bf16 query rounding adds nothing new.
        ip = jnp.einsum("bld,bd->bl", x.astype(jnp.bfloat16),
                        q.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        if metric == "inner_product":
            s = -ip
        elif metric == "cosine":
            nrm_j = jnp.sqrt(jnp.maximum(
                jnp.take(s2, rows_c, axis=0), 0.0))
            denom = q_norm[:, None] * nrm_j
            s = -(ip / jnp.where(denom == 0, 1.0, denom))
        else:
            s = jnp.take(s2, rows_c, axis=0) - 2.0 * ip
            if residual:
                s = s + jnp.broadcast_to(
                    jnp.transpose(off_j)[..., None],
                    (b, group, l_max)).reshape(b, g_l)
        s = jnp.where(ok, s, jnp.inf)
        cand_s = jnp.concatenate([bs, s], axis=1)
        cand_r = jnp.concatenate([br, rows_c], axis=1)
        neg, sel = jax.lax.top_k(-cand_s, kk)
        return (-neg, jnp.take_along_axis(cand_r, sel, axis=1)), None

    init = (jnp.full((b, kk), jnp.inf, jnp.float32),
            jnp.full((b, kk), -1, jnp.int32))
    (best_s, best_r), _ = jax.lax.scan(
        body, init,
        (jnp.transpose(starts).reshape(nprobe // group, group, b),
         jnp.transpose(lengths).reshape(nprobe // group, group, b),
         jnp.transpose(probe_off).reshape(nprobe // group, group, b)))

    # Exact re-rank from exactly (HIGHEST) decoded f32 rows (residual
    # mode adds the winner's codec-space centroid back first).
    from smqtk_indexing_tpu.ops.scan import exact_rerank_decoded
    rows_cl = jnp.maximum(best_r, 0)
    sel_codes = jnp.take(codes, rows_cl, axis=0)
    x = _dequant(sel_codes.reshape(b * kk, m_sub), codebooks,
                 dtype=jnp.float32).reshape(b, kk, -1)
    if residual:
        x = x + jnp.take(res_cents, jnp.take(row2list, rows_cl, axis=0),
                         axis=0)
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)
