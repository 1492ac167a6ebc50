"""
Kernel-level tests for packed Hamming top-k (ops/hamming.py) against a host
numpy brute force, including the chunked streaming path and the CodeStore
bookkeeping (dedup, masked removal, compaction, persistence).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from smqtk_indexing_tpu.ops.hamming import CodeStore, hamming_topk
from smqtk_indexing_tpu.utils.bits import (
    pack_bit_vectors_u32, unpack_bit_vectors_u32, bit_vector_to_int_large,
)


def _brute_hamming(q_bool: np.ndarray, db_bool: np.ndarray) -> np.ndarray:
    return (q_bool[:, None, :] ^ db_bool[None, :, :]).sum(-1)


@pytest.mark.parametrize("bits", [8, 32, 96, 256])
def test_hamming_topk_matches_bruteforce(bits):
    rng = np.random.default_rng(0)
    db_bool = rng.integers(0, 2, size=(512, bits)).astype(bool)
    q_bool = rng.integers(0, 2, size=(16, bits)).astype(bool)
    db = jnp.asarray(pack_bit_vectors_u32(db_bool))
    q = jnp.asarray(pack_bit_vectors_u32(q_bool))
    valid = jnp.ones(512, dtype=bool)

    dists, rows = hamming_topk(db, valid, q, k=8)
    dists, rows = np.asarray(dists), np.asarray(rows)

    ref = _brute_hamming(q_bool, db_bool)
    ref_sorted = np.sort(ref, axis=1)[:, :8]
    assert np.array_equal(dists, ref_sorted)
    # Returned rows produce the returned distances.
    got = np.take_along_axis(ref, rows, axis=1)
    assert np.array_equal(got, dists)


def test_hamming_topk_chunked_path():
    rng = np.random.default_rng(1)
    n, bits, chunk = 1024, 64, 256
    db_bool = rng.integers(0, 2, size=(n, bits)).astype(bool)
    q_bool = rng.integers(0, 2, size=(4, bits)).astype(bool)
    db = jnp.asarray(pack_bit_vectors_u32(db_bool))
    q = jnp.asarray(pack_bit_vectors_u32(q_bool))
    valid = jnp.ones(n, dtype=bool)

    d_chunked, _ = hamming_topk(db, valid, q, k=16, chunk=chunk)
    d_full, _ = hamming_topk(db, valid, q, k=16, chunk=n)
    assert np.array_equal(np.asarray(d_chunked), np.asarray(d_full))


def test_hamming_topk_respects_valid_mask():
    bits = 32
    db_bool = np.zeros((8, bits), dtype=bool)
    db_bool[3, :5] = True  # the only valid row
    q_bool = np.zeros((1, bits), dtype=bool)
    valid = np.zeros(8, dtype=bool)
    valid[3] = True
    dists, rows = hamming_topk(
        jnp.asarray(pack_bit_vectors_u32(db_bool)), jnp.asarray(valid),
        jnp.asarray(pack_bit_vectors_u32(q_bool)), k=1)
    assert int(rows[0, 0]) == 3
    assert int(dists[0, 0]) == 5


class TestCodeStore:
    def _codes(self, n, bits, seed=0):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 2, size=(n, bits)).astype(bool)

    def test_build_dedups(self):
        cs = CodeStore()
        mat = np.array([[1, 0, 1], [1, 0, 1], [0, 1, 0]], dtype=bool)
        cs.build(mat)
        assert cs.n_valid == 2

    def test_add_skips_existing(self):
        cs = CodeStore()
        cs.build(self._codes(16, 32))
        before = cs.n_valid
        cs.add(self._codes(16, 32))  # same seed: identical codes
        assert cs.n_valid == before

    def test_remove_unknown_keyerror_no_mutation(self):
        cs = CodeStore()
        mat = self._codes(8, 16)
        cs.build(mat)
        n0 = cs.n_valid
        bogus = np.vstack([mat[0], ~mat[0]])
        if bit_vector_to_int_large(~mat[0]) in cs._int2row:
            pytest.skip("random collision")
        with pytest.raises(KeyError):
            cs.remove(bogus)
        assert cs.n_valid == n0
        assert cs.has_int(bit_vector_to_int_large(mat[0]))

    def test_query_excludes_removed(self):
        bits = 16
        mat = self._codes(32, bits, seed=3)
        cs = CodeStore()
        cs.build(mat)
        n_uniq = cs.n_valid
        q = mat[:1]
        d0, c0 = cs.knn(q, 1)
        assert d0[0, 0] == 0
        cs.remove(mat[:1])
        assert cs.n_valid == n_uniq - 1
        d1, c1 = cs.knn(q, 1)
        assert d1[0, 0] > 0 or not np.array_equal(c1[0, 0], mat[0])

    def test_bit_length_mismatch(self):
        cs = CodeStore()
        cs.build(self._codes(4, 16))
        with pytest.raises(ValueError):
            cs.add(self._codes(4, 32))
        with pytest.raises(ValueError):
            cs.knn(self._codes(1, 32), 1)

    def test_roundtrip_bytes(self):
        cs = CodeStore()
        mat = self._codes(32, 48, seed=5)
        cs.build(mat)
        blob = cs.to_bytes()
        cs2 = CodeStore()
        cs2.from_bytes(blob)
        assert cs2.n_valid == cs.n_valid
        assert sorted(cs2.ints()) == sorted(cs.ints())

    def test_knn_code_recovery(self):
        bits = 24
        mat = self._codes(64, bits, seed=7)
        cs = CodeStore()
        cs.build(mat)
        d, codes = cs.knn(mat[:4], 1)
        assert np.array_equal(d[:, 0], np.zeros(4))
        assert np.array_equal(codes[:, 0, :], mat[:4])


def test_pack_unpack_roundtrip_odd_bits():
    rng = np.random.default_rng(9)
    for bits in (1, 7, 31, 33, 100):
        mat = rng.integers(0, 2, size=(5, bits)).astype(bool)
        packed = pack_bit_vectors_u32(mat)
        assert packed.shape == (5, (bits + 31) // 32)
        assert np.array_equal(unpack_bit_vectors_u32(packed, bits), mat)


def test_mxu_hamming_path_matches_xor(monkeypatch):
    """The ±1-matmul Hamming engine (the GPU's engine above
    PM1_SCAN_MIN codes, forced here on the CPU) must return identical
    distances to the XOR+popcount engine."""
    rng = np.random.default_rng(42)
    bits, n = 128, 4096
    mat = rng.integers(0, 2, size=(n, bits)).astype(bool)
    cs = CodeStore()
    cs.build(mat)
    q = mat[:8]
    d_xor, c_xor = cs.knn(q, 5)

    monkeypatch.setattr(CodeStore, "_pm1_eligible", lambda self: True)
    cs2 = CodeStore()
    cs2.build(mat)
    d_mxu, c_mxu = cs2.knn(q, 5)
    assert np.array_equal(d_mxu, d_xor)
    # Same codes selected (ties permitting: compare distances of codes).
    assert np.array_equal(
        (q[:, None, :] ^ c_mxu).sum(-1), (q[:, None, :] ^ c_xor).sum(-1))


def test_mxu_mirror_incremental_append(monkeypatch):
    """After a build+query, add() must update the ±1 mirror incrementally
    and keep results exact."""
    monkeypatch.setattr(CodeStore, "_pm1_eligible", lambda self: True)
    rng = np.random.default_rng(7)
    bits = 64
    # Above HOST_SCAN_MAX so the ±1 path (not the host scan) serves it.
    mat = rng.integers(0, 2, size=(3072, bits)).astype(bool)
    extra = rng.integers(0, 2, size=(100, bits)).astype(bool)
    cs = CodeStore()
    cs.build(mat)
    cs.knn(mat[:4], 3)          # forces the mirror to materialize
    assert cs._dev_pm1 is not None
    cs.add(extra)               # incremental append (capacity unchanged)
    assert cs._dev_pm1 is not None
    d, codes = cs.knn(extra[:4], 1)
    assert np.array_equal(d[:, 0], np.zeros(4))
    assert np.array_equal(codes[:, 0, :], extra[:4])
