"""Device k-means: streaming shapes, masking, and FAISS-style
empty-cell splitting."""
import numpy as np

import jax.numpy as jnp

from smqtk_indexing_tpu.ops.kmeans import kmeans_assign, kmeans_lloyd


def test_non_chunk_divisible_rows_pad_internally():
    # Regression: 1M-row PQ training crashed on the truncating reshape
    # (N % chunk != 0 with N > chunk).
    rng = np.random.default_rng(0)
    n = 40_000
    x = rng.normal(size=(n, 8)).astype(np.float32)
    init = x[:64]
    c, a = kmeans_lloyd(jnp.asarray(x), jnp.ones(n, bool),
                        jnp.asarray(init), n_iter=3)
    assert a.shape == (n,)
    a2 = kmeans_assign(jnp.asarray(x), c)
    assert np.array_equal(np.asarray(a), np.asarray(a2))


def test_masked_rows_do_not_move_centroids():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    x[128:] = 1e6  # poison rows, masked out
    valid = np.arange(256) < 128
    init = x[:8]
    c, _ = kmeans_lloyd(jnp.asarray(x), jnp.asarray(valid),
                        jnp.asarray(init), n_iter=4)
    assert np.abs(np.asarray(c)).max() < 100.0


def test_empty_cells_split_large_donors():
    # Init under-covers the data (all init centroids inside ONE of two
    # well-separated blobs): without splitting, the far blob piles into
    # one mega-cell and the other centroids stay empty forever.
    rng = np.random.default_rng(2)
    n_half, d, c_count = 2048, 16, 16
    blob_a = rng.normal(size=(n_half, d)).astype(np.float32)
    blob_b = rng.normal(size=(n_half, d)).astype(np.float32) + 50.0
    x = np.concatenate([blob_a, blob_b])
    init = blob_a[:c_count]  # deliberately skewed init
    c, a = kmeans_lloyd(jnp.asarray(x), jnp.ones(2 * n_half, bool),
                        jnp.asarray(init), n_iter=10)
    counts = np.bincount(np.asarray(a), minlength=c_count)
    # Splitting must recruit centroids into blob B: no empty cells and
    # no mega-cell holding an entire blob.
    assert (counts > 0).all(), counts
    assert counts.max() < n_half, counts
    # Both blobs are represented among the centroids.
    c_np = np.asarray(c)
    assert (c_np.mean(1) > 25).any() and (c_np.mean(1) < 25).any()
