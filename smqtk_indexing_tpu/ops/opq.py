"""
OPQ (optimized product quantization) rotation training.

The reference exposes FAISS's OPQ pre-transform through its factory
grammar (``OPQ16,IVF4096,PQ16`` — faiss.index_factory strings pass
through /root/reference/smqtk_indexing/impls/nn_index/faiss.py:182-199):
an orthogonal matrix R learned to minimize PQ reconstruction error
``||X R - dec(enc(X R))||_F`` before product quantization (Ge et al.,
"Optimized Product Quantization", CVPR 2013). Because euclidean /
inner-product / cosine are rotation invariant, the rotated codec plugs
into every existing PQ path (XLA dequant scan, tiled ADC scan,
sharded scan) untouched — only the row-encode and query-prep transforms
change, composing R after the deterministic dim-interleave permutation.

Device-first formulation: the alternation's heavy step is per-subspace
k-means, which already runs on device (ops/pq.pq_train -> ops/kmeans);
the Procrustes rotation update is one (d, d) SVD on a d x d host matrix
(d <= ~1024 — microseconds, not worth a device round-trip), fed by one
device matmul X^T X_hat. Init is OPQ's non-parametric eigenvalue
allocation: PCA directions dealt across subspaces balancing the
log-eigenvalue product, so each subquantizer sees comparable variance.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

#: Training-sample cap: OPQ fits a (d, d) rotation — 32K rows bound the
#: alternation's per-iteration k-means cost while leaving >=128 rows per
#: codeword at d<=1024.
DEFAULT_SAMPLE = 32768


def eig_alloc_init(rows_c: np.ndarray, m: int) -> np.ndarray:
    """Eigenvalue-allocation initial rotation (Ge et al. §4, OPQ-P):
    PCA-rotate, then greedily deal principal directions to the M
    subspaces balancing each bucket's log-eigenvalue product (the
    per-subquantizer information load).

    :param rows_c: (n, d_codec) float32 codec-grid rows.
    :param m: Subquantizer count (d_codec % m == 0).
    :return: (d_codec, d_codec) float32 orthogonal init.
    """
    d = rows_c.shape[1]
    dsub = d // m
    mu = rows_c.mean(axis=0, dtype=np.float64)
    cov = np.cov((rows_c.astype(np.float64) - mu).T)
    w, v = np.linalg.eigh(np.atleast_2d(cov))
    w, v = w[::-1], v[:, ::-1]                       # descending variance
    buckets: list = [[] for _ in range(m)]
    load = np.zeros(m)
    for i in range(d):
        free = [b for b in range(m) if len(buckets[b]) < dsub]
        b = min(free, key=lambda j: load[j])
        buckets[b].append(i)
        load[b] += np.log(max(w[i], 1e-12))
    order = np.concatenate([np.asarray(b, dtype=np.int64)
                            for b in buckets])
    return np.ascontiguousarray(v[:, order]).astype(np.float32)


def opq_train(rows_c: np.ndarray, m: int, n_iter: int = 16,
              seed: int = 0, sample: int = DEFAULT_SAMPLE,
              inner_kmeans_iter: int = 4, final_kmeans_iter: int = 20,
              init: str = "identity") -> Tuple[np.ndarray, np.ndarray]:
    """
    Learn the OPQ rotation + final codebooks.

    Alternation (OPQ-NP): (1) per-subspace k-means on the rotated sample
    (few Lloyd steps — the codebooks only steer the rotation), (2)
    encode/decode, (3) orthogonal-Procrustes update
    ``R = U V^T, U S V^T = svd(X^T X_hat)``. A final full-strength
    k-means on the converged rotation produces the codebooks actually
    served.

    ``init="identity"`` is the default on purpose: the eigenvalue
    allocation ("eig", Ge et al.'s parametric warm start) is a
    near-fixed-point of the alternation (decoupled subspaces make
    ``X^T X_hat`` block diagonal, so Procrustes barely moves) and on
    CLUSTERED data it is a poor one — measured on a 1024-cluster
    16-intrinsic-dim mixture: identity-init converges 1.03 -> 0.44
    reconstruction error while eig-init stalls at 0.99.

    :param rows_c: (n, d_codec) float32 codec-grid rows (the dim
        interleave of ops/pq.pq_build_store already applied; R composes
        after it).
    :param m: Subquantizer count.
    :param init: "identity" | "eig" (:func:`eig_alloc_init`).
    :return: (R (d_codec, d_codec) float32 orthogonal,
        codebooks (m, 256, d_codec // m) float32) — encode/serve with
        ``rows_c @ R`` and these codebooks.
    """
    from smqtk_indexing_tpu.ops.pq import pq_decode_np, pq_encode_np, \
        pq_train

    n, d = rows_c.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subquantizers")
    if init not in ("identity", "eig"):
        raise ValueError(f"init must be 'identity' | 'eig', got {init!r}")
    if n > sample:
        sel = np.random.default_rng(seed).choice(n, sample, replace=False)
        x = np.ascontiguousarray(rows_c[sel]).astype(np.float32)
    else:
        x = np.asarray(rows_c, dtype=np.float32)
    r = eig_alloc_init(x, m) if init == "eig" \
        else np.eye(d, dtype=np.float32)
    x64 = x.astype(np.float64)
    # Warm-start codebooks across alternations (without it each inner
    # k-means restarts from scratch: the objective is non-monotone and
    # the LAST iterate can be poor — measured recall regressions on
    # low-intrinsic-dim data); keep the best-error (R, cb) seen, since
    # even warm-started alternation only roughly descends.
    cb = None
    best = (np.inf, r, None)
    for _ in range(n_iter):
        xr = x @ r
        cb = pq_train(xr, m, n_iter=inner_kmeans_iter, seed=seed,
                      init=cb)
        rec = pq_decode_np(pq_encode_np(xr, cb), cb)
        err = float(((xr - rec) ** 2).sum())
        if err < best[0]:
            best = (err, r, cb)
        u, _, vt = np.linalg.svd(x64.T @ rec.astype(np.float64))
        r = (u @ vt).astype(np.float32)
    _, r, cb = best
    cb = pq_train(np.ascontiguousarray(x @ r), m,
                  n_iter=final_kmeans_iter, seed=seed, init=cb)
    return r, cb


def compose_transform(perm: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """Fold the dim-interleave permutation and the OPQ rotation into ONE
    (d_ext, d_codec) matrix T with ``q_codec = q_ext @ T`` — the 2-D
    transform form the tiled PQ kernel wrapper accepts in place of the
    1-D perm (a permutation is itself orthogonal, so downstream math is
    identical).

    :param perm: (d_codec,) int dim interleave (codec <- extended).
    :param rot: (d_codec, d_codec) float32 orthogonal.
    """
    d = len(perm)
    p = np.zeros((d, d), dtype=np.float32)
    p[np.asarray(perm), np.arange(d)] = 1.0
    return np.ascontiguousarray(p @ rot)
