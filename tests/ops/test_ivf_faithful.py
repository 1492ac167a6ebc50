"""
FAISS-faithful nprobe semantics (reference faiss.py:715-749): ``nprobe``
counts ORIGINAL inverted lists ranked by centroid distance, and exactly
those lists' contents are scanned — nearer rows living in farther lists
must NOT be returned, and every sublist of a probed (balancer-split) list
must be scanned.
"""
import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex
from smqtk_indexing_tpu.ops.device import kernel_interpret
from smqtk_indexing_tpu.ops.ivf import ivf_query


def _adversarial_layout():
    """
    Two original lists. List A (near the query's region) holds mediocre
    neighbors and is split into 3 virtual sublists; list B's centroid is
    far, but B contains a planted vector RIGHT NEXT to the query. Faithful
    nprobe=1 must return only A's rows; legacy nearest-virtual probing with
    a >1 budget would leak the planted B row in.
    """
    d = 8
    rng = np.random.default_rng(0)
    a_rows = rng.normal(size=(48, d)).astype(np.float32) * 0.5  # around 0
    q = np.zeros((1, d), dtype=np.float32)
    planted = q[0] + 0.01  # closest vector overall, lives in list B
    b_rows = np.vstack([planted] + [
        (rng.normal(size=d) * 0.5 + 20.0).astype(np.float32)
        for _ in range(15)]).astype(np.float32)
    db = np.vstack([a_rows, b_rows])
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    # Virtual CSR: A split into 3 sublists of 16, B one sublist.
    offsets = np.array([0, 16, 32, 48], dtype=np.int32)
    lens = np.array([16, 16, 16, 16], dtype=np.int32)
    cent_a = a_rows.mean(0)
    cent_b = b_rows[1:].mean(0)  # B's centroid ignores the planted row
    cents = np.vstack([cent_a, cent_a, cent_a, cent_b]).astype(np.float32)
    first_virt = np.array([0, 3], dtype=np.int32)
    valid = np.ones(len(db), dtype=bool)
    return (jnp.asarray(db), jnp.asarray(sq), jnp.asarray(valid),
            jnp.asarray(cents), jnp.asarray(offsets), jnp.asarray(lens),
            jnp.asarray(q), jnp.asarray(first_virt))


def test_xla_kernel_faithful_nprobe1():
    db, sq, valid, cents, offsets, lens, q, first_virt = \
        _adversarial_layout()
    dd, rr = ivf_query(db, sq, jnp.sqrt(sq), valid, cents, offsets, lens,
                       q, k=8, nprobe=4, l_max=16,
                       first_virt=first_virt, nprobe_orig=1)
    rows = np.asarray(rr)[0]
    rows = rows[rows >= 0]
    assert len(rows) == 8
    # Only list A's rows (0..47); the planted row 48 must NOT appear.
    assert np.all(rows < 48)
    # All three sublists of A were scanned: the true top-8 within A.
    d2 = np.asarray(((q[0][None, :] - db[:48]) ** 2).sum(1))
    expect = set(np.argsort(d2)[:8].tolist())
    assert set(rows.tolist()) == expect


def test_xla_kernel_legacy_budget_leaks():
    # Sanity that the fixture is adversarial: WITHOUT original-list
    # eligibility, a 4-slot budget probes B too and the planted row wins.
    db, sq, valid, cents, offsets, lens, q, _ = _adversarial_layout()
    dd, rr = ivf_query(db, sq, jnp.sqrt(sq), valid, cents, offsets, lens,
                       q, k=8, nprobe=4, l_max=16)
    assert int(np.asarray(rr)[0, 0]) == 48


def test_tiled_kernel_faithful_nprobe1():
    # The code tier's list scan on the same adversarial layout: list A is
    # cut into three sublists (every one must be scanned), list B holds
    # the planted row and must not be probed at nprobe=1.
    from smqtk_indexing_tpu.ops import sq8 as sq8_ops
    from smqtk_indexing_tpu.ops.ivf_tiled import (
        TILE_ROWS, build_slot_table, build_tiled_csr, ivf_query_tiled,
    )
    db, sq, valid, cents, offsets, lens, q, first_virt = \
        _adversarial_layout()
    db = np.asarray(db)
    n, d = db.shape
    a, b = sq8_ops.sq8_train(db)
    codes = np.zeros((TILE_ROWS, d), np.int8)
    codes[:n] = sq8_ops.sq8_encode_np(db, a, b)
    u = codes.astype(np.float64)
    s2 = ((a.astype(np.float64) * u) ** 2).sum(1).astype(np.float32)
    s2[n:] = np.inf
    db3 = jnp.asarray(np.ascontiguousarray(codes.T[None]))
    v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(
        np.array([[48, 16]]), np.zeros(1, np.int64), cap=16)
    assert (v_orig == 0).sum() == 3
    table = build_slot_table(v_orig, 2)
    cents2 = np.asarray(cents)[[0, 3]]
    dd, rr = ivf_query_tiled(
        db3, jnp.asarray(s2.reshape(1, 1, TILE_ROWS)), jnp.asarray(a),
        jnp.asarray(b), jnp.asarray(cents2), jnp.asarray(table),
        jnp.asarray(v_tile), jnp.asarray(v_col), jnp.asarray(v_len), q,
        k=8, nprobe_orig=1, interpret=kernel_interpret(db3))
    rows = np.asarray(rr)[0]
    rows = rows[rows >= 0]
    assert len(rows) == 8 and np.all(rows < 48)
    dq = u[:48] * a + b
    d2 = ((np.asarray(q)[0][None, :] - dq) ** 2).sum(1)
    assert set(rows.tolist()) == set(np.argsort(d2)[:8].tolist())


def test_model_nprobe1_scans_exactly_nearest_list():
    """End to end: nn_many at nprobe=1 returns exactly the brute-force
    top-k over the rows assigned to each query's nearest centroid."""
    rng = np.random.default_rng(1)
    n, d = 4000, 16
    db = rng.normal(size=(n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    idx = IvfNearestNeighborsIndex(n_lists=16, nprobe=1,
                                   kmeans_iterations=4, random_seed=0)
    idx.build_index(elems)
    cents = idx._centroids_np[:, :d]
    assign = np.argmin(
        ((db[:, None, :] - cents[None, :, :]) ** 2).sum(-1), axis=1)
    queries = rng.normal(size=(4, d)).astype(np.float32)
    q_elems = [DescriptorMemoryElement(f"q{j}", queries[j])
               for j in range(len(queries))]
    res = idx.nn_many(q_elems, 5)
    for j, (e_list, d_list) in enumerate(res):
        c_near = int(np.argmin(((queries[j][None, :] - cents) ** 2).sum(1)))
        members = np.where(assign == c_near)[0]
        d2 = ((queries[j][None, :] - db[members]) ** 2).sum(1)
        expect = [int(members[i]) for i in np.argsort(d2)[:5]]
        got = [e.uuid() for e in e_list]
        assert got == expect[:len(got)]
        # Nothing outside the nearest list is returned.
        assert all(assign[u] == c_near for u in got)
