"""Rows-tier IVF list scan (ops/ivf.ivf_query — the XLA path serving
``storage='rows'``) against float64 brute force: f32, bf16 and SQ8 code
databases, masked rows, the last list of the array, and FAISS-faithful
nprobe."""
import numpy as np

import jax.numpy as jnp

from smqtk_indexing_tpu.ops.ivf import ivf_query


def _scan(db, valid, cents, offsets, lens, q, k, nprobe, dq=None,
          sq=None, **kw):
    """ivf_query over a list-sorted layout; row stats from the
    (dequantized) rows."""
    if sq is None:
        x = np.asarray(jnp.asarray(db).astype(jnp.float32), np.float64)
        if dq is not None:
            x = x * np.asarray(dq[0]) + np.asarray(dq[1])
        sq = (x ** 2).sum(1).astype(np.float32)
    return ivf_query(jnp.asarray(db), jnp.asarray(sq),
                     jnp.asarray(np.sqrt(sq)), jnp.asarray(valid),
                     jnp.asarray(cents), jnp.asarray(offsets),
                     jnp.asarray(lens), jnp.asarray(q), k=k,
                     nprobe=nprobe, l_max=int(lens.max()), dq=dq, **kw)


def _layout(n, d, c, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32) * 3
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
    return db, sq, cents, offsets, lens


def test_rows_scan_full_probe_matches_float64():
    n, d, c, k, b = 2048, 128, 8, 8, 8
    db, sq, cents, offsets, lens = _layout(n, d, c)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, d)).astype(np.float32) * 3
    valid = np.ones(n, dtype=bool)
    d_x, r_x = _scan(db, valid, cents, offsets, lens, q, k, c, sq=sq)
    d2 = np.sqrt(((q[:, None, :].astype(np.float64)
                   - db[None].astype(np.float64)) ** 2).sum(-1))
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(r_x), ref_rows)
    np.testing.assert_allclose(np.asarray(d_x),
                               np.take_along_axis(d2, ref_rows, 1),
                               rtol=1e-4, atol=1e-4)


def test_rows_scan_respects_valid_mask_and_last_list():
    # The last list sits at the end of the array: its window must score
    # exactly its rows, and a masked row never surfaces.
    n, d, c, b = 1024, 64, 4, 8
    db, sq, cents, offsets, lens = _layout(n, d, c, seed=2)
    rng = np.random.default_rng(3)
    valid = np.ones(n, dtype=bool)
    valid[7] = False
    valid[n - 1] = False
    q = np.vstack([db[7] + 0.001, db[n - 2] + 0.001] + list(
        rng.normal(size=(b - 2, d)).astype(np.float32)))
    d_x, r_x = _scan(db, valid, cents, offsets, lens, q, 4, c, sq=sq)
    r = np.asarray(r_x)
    assert not np.any(r == 7) and not np.any(r == n - 1)
    d2 = ((q[:2, None].astype(np.float64)
           - db[None].astype(np.float64)) ** 2).sum(-1)
    d2[:, ~valid] = np.inf
    assert r[0, 0] == np.argmin(d2[0]) and r[1, 0] == n - 2


def test_rows_scan_bf16_database():
    n, d, c, k, b = 2048, 128, 8, 8, 8
    db, sq, cents, offsets, lens = _layout(n, d, c, seed=5)
    rng = np.random.default_rng(6)
    q = rng.normal(size=(b, d)).astype(np.float32) * 3
    valid = np.ones(n, dtype=bool)
    db16 = jnp.asarray(db, dtype=jnp.bfloat16)
    d_x, r_x = _scan(db16, valid, cents, offsets, lens, q, k, c)
    # Exact reference on the QUANTIZED (bf16) data.
    dbq = np.asarray(db16.astype(jnp.float32))
    d2 = ((q[:, None, :].astype(np.float64)
           - dbq[None, :, :].astype(np.float64)) ** 2).sum(-1)
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(r_x), ref_rows)


def test_rows_scan_sq8_codes():
    # int8 SQ8 codes: distances exact w.r.t. the dequantized database.
    from smqtk_indexing_tpu.ops import sq8 as sq8_ops

    n, d, c, k, b = 2048, 128, 8, 8, 8
    db, sq, cents, offsets, lens = _layout(n, d, c, seed=9)
    rng = np.random.default_rng(10)
    q = rng.normal(size=(b, d)).astype(np.float32) * 3
    valid = np.ones(n, dtype=bool)
    a, bb = sq8_ops.sq8_train(db)
    codes = sq8_ops.sq8_encode_np(db, a, bb)
    d_x, r_x = _scan(codes, valid, cents, offsets, lens, q, k, c,
                     dq=(jnp.asarray(a), jnp.asarray(bb)))
    dbq = codes.astype(np.float64) * a + bb
    d2 = np.sqrt(((q[:, None, :].astype(np.float64)
                   - dbq[None, :, :]) ** 2).sum(-1))
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    assert np.array_equal(np.asarray(r_x), ref_rows)
    np.testing.assert_allclose(
        np.asarray(d_x), np.take_along_axis(d2, ref_rows, axis=1),
        rtol=1e-4, atol=1e-4)


def test_rows_scan_sq8_faithful_nprobe_and_dead_rows():
    # SQ8 codes under the FAISS-faithful nprobe translation + removals,
    # against per-list float64 brute force.
    from smqtk_indexing_tpu.ops import sq8 as sq8_ops

    n, d, c, k, b = 2048, 64, 8, 4, 8
    db, sq, cents, offsets, lens = _layout(n, d, c, seed=11)
    rng = np.random.default_rng(12)
    q = rng.normal(size=(b, d)).astype(np.float32) * 3
    valid = np.ones(n, dtype=bool)
    valid[13] = False
    a, bb = sq8_ops.sq8_train(db)
    codes = sq8_ops.sq8_encode_np(db, a, bb)
    first_virt = np.arange(c, dtype=np.int32)   # 1 sublist per original
    d_x, r_x = _scan(codes, valid, cents, offsets, lens, q, k, c,
                     dq=(jnp.asarray(a), jnp.asarray(bb)),
                     first_virt=jnp.asarray(first_virt), nprobe_orig=3,
                     has_dead=True)
    r_x = np.asarray(r_x)
    assert not np.any(r_x == 13)
    dbq = codes.astype(np.float64) * a + bb
    list_of = np.repeat(np.arange(c), lens)
    c_d2 = ((q[:, None].astype(np.float64) - cents[None]) ** 2).sum(-1)
    for bi in range(b):
        probed = np.argsort(c_d2[bi])[:3]
        cand = np.flatnonzero(np.isin(list_of, probed) & valid)
        d2 = ((q[bi].astype(np.float64) - dbq[cand]) ** 2).sum(-1)
        assert np.array_equal(r_x[bi], cand[np.argsort(d2)][:k]), bi
