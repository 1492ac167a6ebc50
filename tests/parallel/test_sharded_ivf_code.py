"""Sharded capacity tier: storage='code' over a device mesh.

Reference parity target: FAISS 'IVF<n>,SQ8'/'IVF<n>,PQ<M>' configs
(smqtk_indexing/impls/nn_index/faiss.py:190) served row-sharded — per-shard
tiled list scans of the clipped list views + hierarchical k-merge
(parallel/sharded_ivf_code.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smqtk_indexing_tpu.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex
from smqtk_indexing_tpu.ops.ivf_tiled import TILE_ROWS
from smqtk_indexing_tpu.parallel.sharded_ivf_code import shard_tiled_layout


def _mkelems(vecs):
    out = []
    for i, v in enumerate(vecs):
        e = DescriptorMemoryElement(i)
        e.set_vector(v)
        out.append(e)
    return out


def _build(n, d, seed, **kw):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    els = _mkelems(vecs)
    idx = IvfNearestNeighborsIndex(
        descriptor_set=MemoryDescriptorSet(), n_lists=16, nprobe=16,
        storage="code", random_seed=seed, **kw)
    idx.build_index(els)
    return idx, els, vecs


class TestShardTiledLayout:
    def test_lengths_partition_and_alignment(self):
        rng = np.random.default_rng(0)
        lens = rng.integers(0, 900, size=24).astype(np.int64)
        n_pad = 8 * TILE_ROWS
        assert lens.sum() <= n_pad
        vt, vc, vl, st = shard_tiled_layout(lens, n_pad, 8, 24)
        assert vt.shape == vc.shape == vl.shape
        assert st.shape[0] == 8 and st.shape[1] == 24
        # Per-list lengths across all shards' slots partition the global
        # lengths exactly.
        got = np.zeros(24, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        for s in range(8):
            for li in range(24):
                for slot in st[s, li]:
                    if slot >= 0:
                        got[li] += vl[s, slot]
        assert np.array_equal(got, lens)
        # Every live slot's window stays inside its tile.
        live = vl > 0
        assert (vc[live] + vl[live] <= TILE_ROWS).all()

    def test_misaligned_shard_span_rejected(self):
        with pytest.raises(ValueError, match="TILE_ROWS"):
            shard_tiled_layout(np.array([10]), TILE_ROWS + 8, 2, 1)


@pytest.mark.parametrize("dtype,metric", [
    ("sq8", "euclidean"), ("pq4", "euclidean"),
    # Round-4 metric axis: the sharded tier forwards `metric` to the
    # same per-shard table scans, so agreement must hold there too.
    ("sq8", "inner_product"), ("pq4", "cosine"),
])
def test_sharded_code_tier_matches_single_device(dtype, metric):
    n, d, k = 10000, 32, 8
    idx1, els, vecs = _build(n, d, 7, dtype=dtype, metric=metric)
    idx8, _, _ = _build(n, d, 7, dtype=dtype, metric=metric, n_devices=8)
    assert idx8._mesh is not None and idx1._mesh is None
    # The codecs train on identical host data in identical order, so the
    # sharded tier must return the single-device results exactly (up to
    # reduction-order float noise on distances).
    qels = els[:6]
    r1 = idx1.nn_many(qels, k)
    r8 = idx8.nn_many(qels, k)
    for (e1, d1), (e8, d8) in zip(r1, r8):
        assert e1[0].uuid() == e8[0].uuid()
        # ID sets agree modulo exact-tie ordering and (cosine over a
        # lossy codec only) one k-boundary slot: the surrogate
        # preselection is L2-of-quantized while the exact re-rank is
        # angular, and the sharded tier's PER-SHARD k+8 pools can catch
        # an exact-better candidate the single global k+8 pool ranked
        # just past its margin. Distances must agree wherever the ids
        # do.
        u1 = [x.uuid() for x in e1]
        u8 = [x.uuid() for x in e8]
        assert len(set(u1) ^ set(u8)) <= 2
        common = [i for i in range(len(u1)) if u1[i] == u8[i]]
        assert len(common) >= k - 1
        np.testing.assert_allclose(np.asarray(d1)[common],
                                   np.asarray(d8)[common],
                                   rtol=1e-4, atol=1e-4)


def test_sharded_code_tier_small_corpus_dead_shards():
    # n < TILE_ROWS: all real rows land on shard 0; shards 1-7 are fully
    # dead and must contribute nothing (no NaNs, no bogus rows).
    idx, els, vecs = _build(600, 16, 3, dtype="sq8", n_devices=8)
    res = idx.nn(els[5], 4)
    assert res[0][0].uuid() == 5
    assert np.isfinite(res[1]).all()


def test_sharded_code_tier_mutation_flows():
    idx, els, vecs = _build(5000, 16, 11, dtype="sq8", n_devices=8)
    idx.remove_from_index([0, 1, 2])
    assert idx.count() == 4997
    res = idx.nn(els[3], 5)
    got = {e.uuid() for e in res[0]}
    assert 3 in got and not got & {0, 1, 2}
    # Update with fresh vectors re-layouts through the sharded upload.
    rng = np.random.default_rng(99)
    new = _mkelems(rng.normal(size=(3, 16)).astype(np.float32))
    for i, e in enumerate(new):
        e._uuid = 5000 + i  # distinct uids
    idx.update_index(new)
    assert idx.count() == 5000
    res = idx.nn(new[0], 3)
    assert res[0][0].uuid() == 5000


def test_sharded_code_tier_score_rerank():
    idx, els, vecs = _build(5000, 16, 5, dtype="sq8", n_devices=8,
                            rerank="score")
    res = idx.nn(els[8], 4)
    assert res[0][0].uuid() == 8
    assert np.isfinite(res[1]).all()


def test_sharded_code_residual_matches_single_device():
    # FAISS by_residual over the sharded capacity tier: row2list shards
    # with the tiles, residual centroids replicate; results must match
    # the single-device residual configuration exactly.
    n, d, k = 10000, 32, 8
    idx1, els, _ = _build(n, d, 13, dtype="pq4", pq_residual=True)
    idx8, _, _ = _build(n, d, 13, dtype="pq4", pq_residual=True,
                        n_devices=8)
    assert idx8._mesh is not None
    r1 = idx1.nn_many(els[:6], k)
    r8 = idx8.nn_many(els[:6], k)
    for (e1, d1), (e8, d8) in zip(r1, r8):
        assert e1[0].uuid() == e8[0].uuid()
        np.testing.assert_allclose(d1, d8, rtol=1e-4, atol=1e-4)


def test_rows_residual_multi_device_accepted():
    # Round 4: the rows tier's residual shards too (row2list rides the
    # row shards; single-device agreement covered in
    # tests/impls/nn_index/test_pq_residual.py::TestShardedRows).
    idx = IvfNearestNeighborsIndex(storage="rows", dtype="pq4",
                                   pq_residual=True, n_devices=8)
    assert idx.pq_residual is True


def test_sharded_code_persistence_roundtrip():
    from smqtk_indexing_tpu.data.data_element import DataMemoryElement
    elem = DataMemoryElement()
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(5000, 16)).astype(np.float32)
    els = _mkelems(vecs)
    ds = MemoryDescriptorSet()
    idx = IvfNearestNeighborsIndex(
        descriptor_set=ds, index_element=elem, n_lists=16, nprobe=16,
        storage="code", dtype="sq8", random_seed=21, n_devices=8)
    idx.build_index(els)
    r_before = idx.nn(els[7], 5)
    idx2 = IvfNearestNeighborsIndex(
        descriptor_set=ds, index_element=elem, n_lists=16, nprobe=16,
        storage="code", dtype="sq8", random_seed=21, n_devices=8)
    assert idx2.count() == 5000 and idx2._mesh is not None
    r_after = idx2.nn(els[7], 5)
    assert [e.uuid() for e in r_before[0]] == [e.uuid() for e in r_after[0]]
    np.testing.assert_allclose(r_before[1], r_after[1], rtol=1e-5)
