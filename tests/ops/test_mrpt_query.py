"""MRPT query (ops/mrpt.mrpt_query, the XLA candidate-gather path) on the
shapes the removed leaf-mirror tests used: reported distances are the
float64 distances of the returned rows, rows never repeat across trees,
and on well-separated clusters the result equals brute force."""
import numpy as np

import jax.numpy as jnp

from smqtk_indexing_tpu.ops.mrpt import build_trees, mrpt_query, project_all


def _build(n=2048, d=64, t_count=4, depth=3, seed=0, clustered=True):
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(32, d)).astype(np.float32) * 4.0
        mat = (centers[rng.integers(0, 32, n)]
               + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    else:
        mat = rng.normal(size=(n, d)).astype(np.float32)
    d_pad = 128
    mat_p = np.zeros((n, d_pad), np.float32)
    mat_p[:, :d] = mat
    bases = np.zeros((t_count, d_pad, depth), np.float32)
    bases[:, :d, :] = rng.standard_normal((t_count, d, depth)) \
        .astype(np.float32)
    projs = np.asarray(project_all(jnp.asarray(mat_p),
                                   jnp.asarray(bases)))
    splits, leaf_table, offsets = build_trees(projs, depth)
    leaf_max = int(np.diff(offsets).max())
    sq = np.einsum("ij,ij->i", mat_p, mat_p).astype(np.float32)
    valid = np.ones(n, bool)
    return mat_p, sq, valid, bases, splits, leaf_table, offsets, leaf_max


def _query(mat_p, sq, valid, bases, splits, leaf_table, offsets, q, k,
           leaf_max, depth=3):
    return mrpt_query(
        jnp.asarray(mat_p), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(bases), jnp.asarray(splits), jnp.asarray(leaf_table),
        jnp.asarray(offsets), jnp.asarray(q), k=k, depth=depth,
        leaf_max=leaf_max)


def test_mrpt_matches_bruteforce_on_separated_data():
    (mat_p, sq, valid, bases, splits, leaf_table, offsets,
     leaf_max) = _build()
    rng = np.random.default_rng(1)
    q = mat_p[rng.integers(0, mat_p.shape[0], 8)] \
        + rng.normal(size=(8, 128)).astype(np.float32) * 0.05
    k = 8
    d_e, r_e = _query(mat_p, sq, valid, bases, splits, leaf_table,
                      offsets, q, k, leaf_max)
    d2 = np.sqrt(((q[:, None].astype(np.float64)
                   - mat_p[None].astype(np.float64)) ** 2).sum(-1))
    ref = np.argsort(d2, axis=1)[:, :k]
    r_e = np.asarray(r_e)
    recall = np.mean([len(set(r_e[i]) & set(ref[i])) / k
                      for i in range(8)])
    assert recall >= 0.95, recall
    np.testing.assert_allclose(np.asarray(d_e),
                               np.take_along_axis(d2, r_e, 1),
                               rtol=1e-5, atol=1e-4)


def test_mrpt_exact_distances_on_gaussian_data():
    # Dense gaussian data: every reported distance is the true distance
    # of its row, ascending.
    (mat_p, sq, valid, bases, splits, leaf_table, offsets,
     leaf_max) = _build(clustered=False, seed=5)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(8, 128)).astype(np.float32)
    q[:, 64:] = 0
    k = 8
    d_m, r_m = _query(mat_p, sq, valid, bases, splits, leaf_table,
                      offsets, q, k, leaf_max)
    d_m, r_m = np.asarray(d_m), np.asarray(r_m)
    for i in range(8):
        assert (np.diff(d_m[i]) >= 0).all()
        for j in range(k):
            if r_m[i, j] >= 0:
                ref = np.sqrt(((mat_p[r_m[i, j]].astype(np.float64)
                                - q[i]) ** 2).sum())
                assert abs(float(d_m[i, j]) - ref) < 1e-3


def test_mrpt_no_duplicate_rows():
    (mat_p, sq, valid, bases, splits, leaf_table, offsets,
     leaf_max) = _build(t_count=6, seed=9)
    rng = np.random.default_rng(3)
    q = mat_p[rng.integers(0, mat_p.shape[0], 8)]
    d_m, r_m = _query(mat_p, sq, valid, bases, splits, leaf_table,
                      offsets, q, 16, leaf_max)
    r_m = np.asarray(r_m)
    for row in r_m:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
