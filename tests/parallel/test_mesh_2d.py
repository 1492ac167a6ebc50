"""
2-D ("dcn" x "shard") mesh tests: rows shard over both axes and the hierarchical
top-k merge (intra-slice all-gather over "shard", inter-slice merge over
"dcn") must be bit-identical to the single-device kernels. Runs on the
8-virtual-device CPU platform as a (2, 4) two-slice emulation.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smqtk_indexing_tpu.ops import hamming, scan
from smqtk_indexing_tpu.ops.kmeans import kmeans_lloyd
from smqtk_indexing_tpu.parallel import (
    make_mesh, shard_rows, sharded_flat_topk, sharded_hamming_topk,
    sharded_kmeans_step,
)
from smqtk_indexing_tpu.parallel.mesh import DCN_AXIS, SHARD_AXIS, replicate
from smqtk_indexing_tpu.utils.bits import pack_bit_vectors_u32


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(8, dcn=2)


def test_mesh_axes(mesh2):
    assert mesh2.axis_names == (DCN_AXIS, SHARD_AXIS)
    assert mesh2.shape[DCN_AXIS] == 2 and mesh2.shape[SHARD_AXIS] == 4


def test_2d_flat_matches_single(mesh2):
    rng = np.random.default_rng(10)
    n, d, b, k = 1024, 64, 8, 16
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db)
    valid = np.ones(n, dtype=bool)

    d1, r1 = scan.flat_topk(jnp.asarray(db), jnp.asarray(sq),
                            jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                            jnp.asarray(q), k=k)
    d2, r2 = sharded_flat_topk(
        mesh2, shard_rows(mesh2, jnp.asarray(db)),
        shard_rows(mesh2, jnp.asarray(sq)),
        shard_rows(mesh2, jnp.asarray(np.sqrt(sq))),
        shard_rows(mesh2, jnp.asarray(valid)),
        replicate(mesh2, jnp.asarray(q)), k=k)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1), atol=1e-5)
    assert np.array_equal(np.asarray(r2), np.asarray(r1))


def test_2d_global_row_ids_span_slices(mesh2):
    # A single valid row in the LAST shard of the LAST slice must come back
    # with its correct GLOBAL row id — catches wrong slice-major offsets.
    rng = np.random.default_rng(11)
    n, d = 512, 32
    db = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db)
    valid = np.zeros(n, dtype=bool)
    valid[n - 3] = True
    q = np.concatenate([db[n - 3][None, :], np.zeros((7, d), np.float32)])

    d2, r2 = sharded_flat_topk(
        mesh2, shard_rows(mesh2, jnp.asarray(db)),
        shard_rows(mesh2, jnp.asarray(sq)),
        shard_rows(mesh2, jnp.asarray(np.sqrt(sq))),
        shard_rows(mesh2, jnp.asarray(valid)),
        replicate(mesh2, jnp.asarray(q)), k=4)
    assert int(np.asarray(r2)[0, 0]) == n - 3
    assert np.asarray(d2)[0, 0] == pytest.approx(0.0, abs=1e-5)
    assert np.all(np.isinf(np.asarray(d2)[0, 1:]))


def test_2d_hamming_matches_single(mesh2):
    rng = np.random.default_rng(12)
    n, bits, b, k = 2048, 64, 8, 8
    codes = rng.integers(0, 2, size=(n, bits)).astype(bool)
    qb = rng.integers(0, 2, size=(b, bits)).astype(bool)
    db = jnp.asarray(pack_bit_vectors_u32(codes))
    q = jnp.asarray(pack_bit_vectors_u32(qb))
    valid = jnp.ones(n, dtype=bool)

    d1, r1 = hamming.hamming_topk(db, valid, q, k=k)
    d2, r2 = sharded_hamming_topk(
        mesh2, shard_rows(mesh2, db), shard_rows(mesh2, valid),
        replicate(mesh2, q), k=k)
    assert np.array_equal(np.asarray(d2), np.asarray(d1))
    got = np.take_along_axis(
        (qb[:, None, :] ^ codes[None, :, :]).sum(-1),
        np.asarray(r2), axis=1)
    assert np.array_equal(got, np.asarray(d1))


def test_2d_kmeans_step_matches_single(mesh2):
    rng = np.random.default_rng(13)
    n, d, c = 1024, 16, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    init = db[rng.choice(n, c, replace=False)]

    c1, _ = kmeans_lloyd(jnp.asarray(db), jnp.asarray(valid),
                         jnp.asarray(init), n_iter=1)
    c2, assigns = sharded_kmeans_step(
        mesh2, shard_rows(mesh2, jnp.asarray(db)),
        shard_rows(mesh2, jnp.asarray(valid)),
        replicate(mesh2, jnp.asarray(init)))
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c1),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(assigns).shape == (n,)


def test_2d_ivf_matches_single(mesh2):
    """IVF rows now shard over BOTH axes (each DCN slice holds 1/dcn of
    the database, not a replica) and the merge is hierarchical."""
    from smqtk_indexing_tpu.ops.ivf import ivf_query
    from smqtk_indexing_tpu.parallel import shard_csr, sharded_ivf_query

    rng = np.random.default_rng(7)
    n, d, c, b, k = 1024, 32, 8, 8, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    assigns = rng.integers(0, c, size=n)
    order = np.argsort(assigns, kind="stable")
    db = db[order]
    lens = np.bincount(assigns, minlength=c).astype(np.int32)
    offsets = np.zeros(c, dtype=np.int32)
    offsets[1:] = np.cumsum(lens)[:-1]
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    cents = np.stack([
        db[offsets[i]:offsets[i] + max(int(lens[i]), 1)].mean(0)
        for i in range(c)]).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)

    d1, r1 = ivf_query(jnp.asarray(db), jnp.asarray(sq),
                       jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                       jnp.asarray(cents), jnp.asarray(offsets),
                       jnp.asarray(lens), jnp.asarray(q), k=k, nprobe=c,
                       l_max=int(lens.max()))
    loc_off, loc_len = shard_csr(offsets, lens, n, 8)
    # Per-shard row counts must actually split over both axes (128 rows
    # per device on the (2, 4) mesh — no per-slice replica).
    db_s = shard_rows(mesh2, jnp.asarray(db))
    assert db_s.sharding.shard_shape(db_s.shape)[0] == n // 8
    d8, r8 = sharded_ivf_query(
        mesh2, db_s, shard_rows(mesh2, jnp.asarray(sq)),
        shard_rows(mesh2, jnp.asarray(np.sqrt(sq))),
        shard_rows(mesh2, jnp.asarray(valid)),
        replicate(mesh2, jnp.asarray(cents)),
        shard_rows(mesh2, jnp.asarray(loc_off)),
        shard_rows(mesh2, jnp.asarray(loc_len)),
        replicate(mesh2, jnp.asarray(q)), k=k, nprobe=c,
        l_max=int(lens.max()))
    np.testing.assert_allclose(np.asarray(d8), np.asarray(d1), atol=1e-5)
    assert np.array_equal(np.asarray(r8), np.asarray(r1))
