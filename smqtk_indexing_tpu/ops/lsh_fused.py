"""
Single-dispatch LSH serving: hash -> near-code selection -> bucket
expansion -> exact re-rank as ONE jitted device program.

The reference's composite LSH query is a four-stage host pipeline
(/root/reference/smqtk_indexing/impls/nn_index/lsh.py:452-518): hash the
query, ask the hash index for near codes, expand candidate UIDs through
the hash2uuids KV store on the host, fetch vectors and re-rank. The
two-dispatch path (models/nn_index/lsh.py) batches each stage but pays
TWO device round trips per served batch (hash+hamming scan, then
re-rank) with a host hop for bucket expansion between them.

This module fuses them: the bucket table is made
device-resident in IVF form — descriptor rows sorted by bucket so each
unique hash code owns a contiguous row range (off/len CSR), exactly the
list-sorted layout models/nn_index/ivf.py uses — and the query program
performs hash (matmul+sign), packed XOR-popcount Hamming top-n over the
unique-code table, CSR window expansion, row gather, exact metric
distances, and top-k without leaving the device. Candidate semantics are
IDENTICAL to the two-dispatch path (n nearest unique codes, union of
their buckets, exact re-rank): near-ties in code selection may resolve
differently than heapq order, which the HashIndex contract already
allows.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.ops.hamming import DEFAULT_CHUNK, hamming_topk
from smqtk_indexing_tpu.ops.metrics import candidate_distances


def _pack_bits_device(h: jnp.ndarray) -> jnp.ndarray:
    """(B, bits) bool -> (B, ceil(bits/32)) uint32, matching
    utils/bits.pack_bit_vectors_u32 exactly (np.packbits big-endian bytes
    viewed as little-endian uint32 words) so device-packed query codes are
    comparable with the host-packed unique-code table."""
    b, bits = h.shape
    pad = (-bits) % 32
    if pad:
        h = jnp.concatenate(
            [h, jnp.zeros((b, pad), dtype=bool)], axis=1)
    w = h.shape[1] // 32
    hh = h.reshape(b, w, 4, 8).astype(jnp.uint32)
    byte_val = jnp.sum(
        hh << (7 - jnp.arange(8, dtype=jnp.uint32))[None, None, None, :],
        axis=-1)
    word = jnp.sum(
        byte_val << (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, :],
        axis=-1)
    return word.astype(jnp.uint32)


@partial(jax.jit, static_argnames=("k", "n_codes", "n_sel", "l_max",
                                   "metric", "normalize", "engine"))
def lsh_fused_query(db: jnp.ndarray, row_valid: jnp.ndarray,
                    packed: jnp.ndarray, code_valid: jnp.ndarray,
                    off: jnp.ndarray, ln: jnp.ndarray,
                    q: jnp.ndarray, mean: jnp.ndarray, proj: jnp.ndarray,
                    *, k: int, n_codes: int, n_sel: int, l_max: int,
                    metric: str, normalize=None, engine: str = "xor",
                    pm1: jnp.ndarray = None, code_sq: jnp.ndarray = None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    One-dispatch LSH serve.

    :param db: (N_pad, d) float32 descriptor rows SORTED BY BUCKET (each
        unique code's members contiguous).
    :param row_valid: (N_pad,) bool liveness (padding rows False).
    :param packed: (U_pad, W) uint32 packed unique hash codes (the
        device-resident hash->bucket table).
    :param code_valid: (U_pad,) bool (padding codes False).
    :param off: (U_pad,) int32 bucket start row per unique code.
    :param ln: (U_pad,) int32 bucket length per unique code.
    :param q: (B, d) float32 queries (pad rows zero; results discarded).
    :param mean: (d,) float32 functor mean (LshFunctor.hash_model).
    :param proj: (d, bits) float32 functor projection.
    :param k: top-k results per query (static).
    :param n_codes: SHAPE budget of near codes to expand (static,
        pow2-rounded to bound recompiles).
    :param n_sel: number of near codes the caller actually requested
        (static, <= n_codes); selection slots past it are zero-length
        masked so candidate-set semantics match ``HashIndex.nn(h, n_sel)``
        exactly despite the rounded shape.
    :param l_max: max bucket length (static; windows pad to it).
    :param metric: 'euclidean' | 'cosine' | 'hik'.
    :param normalize: functor row-normalization ``ord`` (static; None =
        pass-through), applied before the mean subtract as in
        models/lsh_functor/simple_rp.norm_rows.
    :param engine: near-code scan engine (static). "xor" — streaming
        chunked XOR-popcount (ops/hamming.hamming_topk; never
        materializes the (B, U) distance matrix, but its per-chunk
        running top-k runs over every chunk). "pm1" — the ±1 bfloat16
        form through the two-stage flat scan
        (ops/scan.flat_topk_two_stage; squared L2 between ±1 vectors
        is exactly 4x Hamming, so the euclidean surrogate
        ``bits - 2<q,u> = 4*ham - bits`` ranks codes exactly) — chosen
        by the same rule as ops/hamming.CodeStore
        (ops/hamming.pm1_engine). Requires ``pm1``/``code_sq``.
    :param pm1: (U_pad, bits_pad) bfloat16 ±1 code rows, zero-padded
        dims/rows (pm1 engine only).
    :param code_sq: (U_pad,) float32 true bit count per live code.
    :return: (dists (B, k) f32 ascending with +inf pads,
        rows (B, k) int32 into the bucket-sorted layout, -1 pads).
    """
    q = q.astype(jnp.float32)
    # Functor normalization applies to HASHING only (the reference functor
    # normalizes inside get_hash, itq.py:389-408); the exact re-rank below
    # must use the RAW query, matching the two-dispatch path's
    # _rerank_batch(q_mat, ...) (models/nn_index/lsh.py).
    qh = q
    if normalize is not None:
        nrm = jnp.linalg.norm(q, ord=normalize, axis=-1, keepdims=True)
        qh = q / jnp.where(nrm == 0, 1.0, nrm)
    z = jnp.dot(qh - mean[None, :], proj,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    h = z >= 0

    if engine == "pm1":
        from smqtk_indexing_tpu.ops.scan import flat_topk_two_stage
        bits = proj.shape[1]
        b = q.shape[0]
        bits_pad = pm1.shape[1]
        q_pm1 = jnp.zeros((b, bits_pad), jnp.float32)
        q_pm1 = q_pm1.at[:, :bits].set(
            h.astype(jnp.float32) * 2.0 - 1.0)
        _, codes_sel = flat_topk_two_stage(
            pm1, code_sq, code_valid, q_pm1, k=n_codes)
    else:
        qp = _pack_bits_device(h)
        # Streaming chunked XOR-popcount top-n over the unique-code
        # table: never materializes the (B, U) distance matrix — 4GB at
        # B=1024 over 1M unique codes if done as one block. Invalid
        # selections (fewer than n_codes live codes) surface via the
        # code_valid gather below.
        _, codes_sel = hamming_topk(packed, code_valid, qp, k=n_codes,
                                    chunk=min(DEFAULT_CHUNK,
                                              packed.shape[0]))

    neg_sel = codes_sel < 0        # streaming top-k may keep -1 pads
    codes_sel = jnp.maximum(codes_sel, 0)
    sel_off = jnp.take(off, codes_sel, axis=0)          # (B, n_codes)
    sel_len = jnp.take(ln, codes_sel, axis=0)
    # Zero out (a) shape-budget slots past the requested n_sel codes and
    # (b) dead/padding/-1 selections that surfaced because fewer than
    # n_codes valid codes exist.
    rank_ok = jnp.arange(n_codes, dtype=jnp.int32)[None, :] < n_sel
    sel_ok = rank_ok & ~neg_sel \
        & jnp.take(code_valid, codes_sel, axis=0)
    sel_len = jnp.where(sel_ok, sel_len, 0)
    b = q.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (b, n_codes, l_max), 2)
    rows = sel_off[..., None] + iota                    # (B, n_codes, L)
    live = iota < sel_len[..., None]
    rows_flat = jnp.where(live, rows, 0).reshape(b, n_codes * l_max)
    live_flat = live.reshape(b, n_codes * l_max)

    cand = jnp.take(db, rows_flat, axis=0)              # (B, n*L, d)
    dist = candidate_distances(q, cand, metric)
    ok = live_flat & jnp.take(row_valid, rows_flat, axis=0)
    dist = jnp.where(ok, dist, jnp.inf)

    kk = min(k, n_codes * l_max)
    neg, sel = jax.lax.top_k(-dist, kk)
    out_d = -neg
    out_r = jnp.take_along_axis(rows_flat, sel, axis=1).astype(jnp.int32)
    out_r = jnp.where(jnp.isinf(out_d), -1, out_r)
    if kk < k:
        pad = k - kk
        out_d = jnp.concatenate(
            [out_d, jnp.full((b, pad), jnp.inf, jnp.float32)], axis=1)
        out_r = jnp.concatenate(
            [out_r, jnp.full((b, pad), -1, jnp.int32)], axis=1)
    return out_d, out_r
