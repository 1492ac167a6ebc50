"""
Sharding tests on the 8-virtual-device CPU mesh (conftest forces
xla_force_host_platform_device_count=8): sharded results must exactly match
the single-device kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smqtk_indexing_tpu.ops import hamming, scan
from smqtk_indexing_tpu.ops.kmeans import kmeans_lloyd
from smqtk_indexing_tpu.parallel import (
    make_mesh, shard_rows, sharded_flat_topk, sharded_hamming_topk,
    sharded_kmeans_step,
)
from smqtk_indexing_tpu.parallel.mesh import replicate
from smqtk_indexing_tpu.utils.bits import pack_bit_vectors_u32


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_mesh_size(mesh):
    assert mesh.devices.size == 8


def test_sharded_flat_matches_single(mesh):
    rng = np.random.default_rng(0)
    n, d, b, k = 1024, 128, 8, 16
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db)
    valid = np.ones(n, dtype=bool)

    d1, r1 = scan.flat_topk(jnp.asarray(db), jnp.asarray(sq),
                            jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                            jnp.asarray(q), k=k)

    db_s = shard_rows(mesh, jnp.asarray(db))
    sq_s = shard_rows(mesh, jnp.asarray(sq))
    nm_s = shard_rows(mesh, jnp.asarray(np.sqrt(sq)))
    va_s = shard_rows(mesh, jnp.asarray(valid))
    q_r = replicate(mesh, jnp.asarray(q))
    d8, r8 = sharded_flat_topk(mesh, db_s, sq_s, nm_s, va_s, q_r, k=k)

    np.testing.assert_allclose(np.asarray(d8), np.asarray(d1), atol=1e-5)
    assert np.array_equal(np.asarray(r8), np.asarray(r1))


def test_sharded_flat_respects_mask(mesh):
    rng = np.random.default_rng(1)
    n, d = 512, 32
    db = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db)
    valid = np.zeros(n, dtype=bool)
    valid[100] = True  # single valid row, lives on shard 1
    q = db[100][None, :]
    q = np.concatenate([q, np.zeros((7, d), np.float32)])

    d8, r8 = sharded_flat_topk(
        mesh, shard_rows(mesh, jnp.asarray(db)),
        shard_rows(mesh, jnp.asarray(sq)),
        shard_rows(mesh, jnp.asarray(np.sqrt(sq))),
        shard_rows(mesh, jnp.asarray(valid)),
        replicate(mesh, jnp.asarray(q)), k=4)
    assert int(np.asarray(r8)[0, 0]) == 100
    assert np.asarray(d8)[0, 0] == pytest.approx(0.0, abs=1e-5)
    assert np.all(np.isinf(np.asarray(d8)[0, 1:]))


def test_sharded_hamming_matches_single(mesh):
    rng = np.random.default_rng(2)
    n, bits, b, k = 2048, 64, 8, 8
    codes = rng.integers(0, 2, size=(n, bits)).astype(bool)
    qb = rng.integers(0, 2, size=(b, bits)).astype(bool)
    db = jnp.asarray(pack_bit_vectors_u32(codes))
    q = jnp.asarray(pack_bit_vectors_u32(qb))
    valid = jnp.ones(n, dtype=bool)

    d1, r1 = hamming.hamming_topk(db, valid, q, k=k)
    d8, r8 = sharded_hamming_topk(
        mesh, shard_rows(mesh, db), shard_rows(mesh, valid),
        replicate(mesh, q), k=k)
    assert np.array_equal(np.asarray(d8), np.asarray(d1))
    # Row sets must agree (ties may order differently across merges).
    got = np.take_along_axis(
        (qb[:, None, :] ^ codes[None, :, :]).sum(-1),
        np.asarray(r8), axis=1)
    assert np.array_equal(got, np.asarray(d1))


def test_sharded_kmeans_step_matches_single(mesh):
    rng = np.random.default_rng(3)
    n, d, c = 1024, 16, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    init = db[rng.choice(n, c, replace=False)]

    # Single-device single Lloyd iteration.
    c1, _ = kmeans_lloyd(jnp.asarray(db), jnp.asarray(valid),
                         jnp.asarray(init), n_iter=1)
    c8, assigns = sharded_kmeans_step(
        mesh, shard_rows(mesh, jnp.asarray(db)),
        shard_rows(mesh, jnp.asarray(valid)),
        replicate(mesh, jnp.asarray(init)))
    np.testing.assert_allclose(np.asarray(c8), np.asarray(c1),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(assigns).shape == (n,)
