"""
Sharded MRPT on the 8-virtual-device CPU mesh: per-shard leaf tables must
reproduce the single-device query exactly (same candidate union, same exact
distances), at the kernel level and through the model API.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.mrpt import MRPTNearestNeighborsIndex
from smqtk_indexing_tpu.ops.device import capacity_for, pad_rows_np
from smqtk_indexing_tpu.ops.mrpt import build_trees, mrpt_query, project_all
from smqtk_indexing_tpu.parallel import (
    make_mesh, shard_leaf_tables, shard_rows, sharded_mrpt_query,
)
from smqtk_indexing_tpu.parallel.mesh import replicate


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(autouse=True)
def _pin_cpu():
    # Sharded-vs-single bit-identity must not become a cross-backend
    # comparison: pin unsharded arrays to the CPU.
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def test_shard_leaf_tables_partition():
    rng = np.random.default_rng(0)
    n, t, depth, cap, shards = 300, 3, 4, 1024, 8
    projs = rng.normal(size=(n, t, depth)).astype(np.float32)
    _, leaf_table, offsets = build_trees(projs, depth)
    leaf_loc, off_loc, lmax = shard_leaf_tables(leaf_table, offsets,
                                                shards, cap)
    assert leaf_loc.shape == (shards, t, cap // shards)
    assert off_loc.shape == (shards, t, 2 ** depth + 1)
    blk = cap // shards
    for ti in range(t):
        # Union of per-shard globalized entries == the tree's permutation.
        got = []
        for s in range(shards):
            cnt = off_loc[s, ti, -1]
            got.extend((leaf_loc[s, ti, :cnt] + s * blk).tolist())
        assert sorted(got) == list(range(n))
        # Per-leaf shard partition matches the global leaf contents.
        for leaf in range(2 ** depth):
            glob = set(leaf_table[ti, offsets[leaf]:offsets[leaf + 1]])
            per = set()
            for s in range(shards):
                lo, hi = off_loc[s, ti, leaf], off_loc[s, ti, leaf + 1]
                per |= {int(r) + s * blk for r in leaf_loc[s, ti, lo:hi]}
            assert per == glob
    assert lmax == int(np.diff(off_loc, axis=-1).max())


def test_sharded_mrpt_kernel_matches_single(mesh):
    rng = np.random.default_rng(1)
    n, d, t, depth, b, k = 1000, 32, 4, 4, 8, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cap = capacity_for(n)
    mat_p = pad_rows_np(db, cap, d)
    bases = rng.standard_normal((t, d, depth)).astype(np.float32)
    projs = np.asarray(project_all(jnp.asarray(mat_p),
                                   jnp.asarray(bases)))[:n]
    splits, leaf_table, offsets = build_trees(projs, depth)
    leaf_max = _pow2(int(np.diff(offsets).max()))
    sq = np.zeros(cap, np.float32)
    sq[:n] = np.einsum("ij,ij->i", db, db)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    leaf_pad = np.zeros((t, cap), np.int32)
    leaf_pad[:, :n] = leaf_table

    d1, r1 = mrpt_query(jnp.asarray(mat_p), jnp.asarray(sq),
                        jnp.asarray(valid), jnp.asarray(bases),
                        jnp.asarray(splits), jnp.asarray(leaf_pad),
                        jnp.asarray(offsets), jnp.asarray(q), k=k,
                        depth=depth, leaf_max=leaf_max)

    leaf_loc, off_loc, lmax = shard_leaf_tables(leaf_table, offsets,
                                                mesh.devices.size, cap)
    d8, r8 = sharded_mrpt_query(
        mesh, shard_rows(mesh, jnp.asarray(mat_p)),
        shard_rows(mesh, jnp.asarray(sq)),
        shard_rows(mesh, jnp.asarray(valid)),
        replicate(mesh, jnp.asarray(bases)),
        replicate(mesh, jnp.asarray(splits)),
        shard_rows(mesh, jnp.asarray(leaf_loc)),
        shard_rows(mesh, jnp.asarray(off_loc)),
        replicate(mesh, jnp.asarray(q)), k=k, depth=depth,
        leaf_max=_pow2(max(lmax, 1)))
    np.testing.assert_allclose(np.asarray(d8), np.asarray(d1), atol=1e-5)
    assert np.array_equal(np.asarray(r8), np.asarray(r1))


def test_model_n_devices_matches_single(mesh):
    rng = np.random.default_rng(2)
    n, d = 600, 24
    db = rng.normal(size=(n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    i1 = MRPTNearestNeighborsIndex(num_trees=5, depth=4, random_seed=0)
    i8 = MRPTNearestNeighborsIndex(num_trees=5, depth=4, random_seed=0,
                                   n_devices=8)
    i1.build_index(elems)
    i8.build_index(elems)
    q = [DescriptorMemoryElement(f"q{j}", rng.normal(size=d)
                                 .astype(np.float32)) for j in range(6)]
    res1 = i1.nn_many(q, 5)
    res8 = i8.nn_many(q, 5)
    for (e1, d1), (e8, d8) in zip(res1, res8):
        assert [x.uuid() for x in e1] == [x.uuid() for x in e8]
        np.testing.assert_allclose(d8, d1, atol=1e-5)


def test_model_n_devices_update_and_remove(mesh):
    rng = np.random.default_rng(3)
    n, d = 200, 16
    db = rng.normal(size=(n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    idx = MRPTNearestNeighborsIndex(num_trees=4, depth=3, random_seed=1,
                                    n_devices=8)
    idx.build_index(elems)
    extra = DescriptorMemoryElement("new", rng.normal(size=d)
                                    .astype(np.float32))
    idx.update_index([extra])
    assert idx.count() == n + 1
    res = idx.nn(extra, 1)
    assert res[0][0].uuid() == "new"
    idx.remove_from_index(["new"])
    assert idx.count() == n
