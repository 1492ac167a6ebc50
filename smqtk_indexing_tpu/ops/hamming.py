"""
Packed-code Hamming distance kernels and the device-resident code store.

Device-resident replacement for the reference's big-int Hamming scan
(/root/reference/smqtk_indexing/impls/hash_index/linear.py:231-244 —
``heapq.nsmallest`` over ``bin(i ^ j).count('1')``,
utils/metrics.py:140-155): hash codes are stored as ``(N, ceil(bits/32))``
uint32 packed matrices resident in device memory, and a query is one fused
XOR + ``lax.population_count`` + row-sum + ``top_k`` XLA program. A
``lax.scan`` streams row blocks for large N so the full (B, N) distance
matrix is never materialized (same streaming-top-k shape as ops/scan.py).

Big-endian bit-0-is-MSB public semantics (reference
impls/lsh_functor/itq.py:46-50) are preserved at the pack/unpack boundary in
``utils/bits.py``; Hamming distance is invariant to intra-word bit order.
"""
from __future__ import annotations

import io
import threading
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.ops.device import capacity_for
from smqtk_indexing_tpu.ops.device import pow2_at_least as _pow2_at_least
from smqtk_indexing_tpu.utils import bits as bits_util

#: Rows per streamed block (codes are narrow, so blocks can be large).
DEFAULT_CHUNK = 262144

#: Below this many live codes the host popcount scan (native C++ when
#: available) beats the device program's launch/transfer latency.
HOST_SCAN_MAX = 2048

#: From this many codes on a GPU, Hamming queries run as a ±1 bfloat16
#: product (see pm1_engine): squared Euclidean distance between ±1 vectors
#: is exactly 4x the Hamming distance, so the two-stage flat scan
#: (ops/scan.flat_topk_two_stage) serves hash lookups as bf16 products on
#: the tensor cores, where XOR+popcount streams (B, chunk) integer score
#: blocks through a running top-k (measured slower at 1M x 256 bits,
#: PERF.md). ±1 values and f32 accumulation are exact, so results are
#: exact integers.
PM1_SCAN_MIN = 16384


def pm1_engine(n_codes: int, x) -> bool:
    """The one rule choosing the ±1 engine over XOR-popcount, shared by
    CodeStore and the fused LSH query (ops/lsh_fused.py): ``n_codes`` at
    least PM1_SCAN_MIN and the codes (``x``) on a GPU."""
    from smqtk_indexing_tpu.ops.device import on_gpu
    return n_codes >= PM1_SCAN_MIN and on_gpu(x)

#: Sentinel distance for invalid (masked / padded) rows. Larger than any
#: real Hamming distance (codes are at most a few thousand bits).
_INVALID = jnp.int32(2 ** 30)


def _block_hamming(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """(B, W) uint32 queries vs (C, W) uint32 codes -> (B, C) int32."""
    xor = jnp.bitwise_xor(q[:, None, :], x[None, :, :])
    return jnp.sum(jax.lax.population_count(xor).astype(jnp.int32), axis=-1)


@partial(jax.jit, static_argnames=("k", "chunk"))
def hamming_topk(db: jnp.ndarray, valid: jnp.ndarray, q: jnp.ndarray, *,
                 k: int, chunk: int = DEFAULT_CHUNK
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Exhaustive Hamming top-k over a device-resident packed-code matrix.

    :param db: (N, W) uint32 packed codes (rows beyond live set arbitrary).
    :param valid: (N,) bool row-liveness mask.
    :param q: (B, W) uint32 packed query codes.
    :param k: Neighbors per query (static; <= N).
    :param chunk: Streamed block size (static; N % chunk == 0 or N <= chunk).
    :return: (dists (B, k) int32 ascending, rows (B, k) int32). Slots beyond
        the number of valid rows carry the _INVALID sentinel / row -1.
    """
    n, w = db.shape
    b = q.shape[0]

    if n <= chunk:
        d = _block_hamming(q, db)
        d = jnp.where(valid[None, :], d, _INVALID)
        neg, rows = jax.lax.top_k(-d, k)
        return -neg, rows.astype(jnp.int32)

    num_chunks = n // chunk
    db_c = db.reshape(num_chunks, chunk, w)
    va_c = valid.reshape(num_chunks, chunk)
    base_rows = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    init = (jnp.full((b, k), _INVALID, dtype=jnp.int32),
            jnp.full((b, k), -1, dtype=jnp.int32))

    def body(carry, blk):
        best_d, best_r = carry
        x, v, base = blk
        d = jnp.where(v[None, :], _block_hamming(q, x), _INVALID)
        rows = base + jax.lax.broadcasted_iota(jnp.int32, (b, chunk), 1)
        cand_d = jnp.concatenate([best_d, d], axis=1)
        cand_r = jnp.concatenate([best_r, rows], axis=1)
        neg, sel = jax.lax.top_k(-cand_d, k)
        return (-neg, jnp.take_along_axis(cand_r, sel, axis=1)), None

    (best_d, best_r), _ = jax.lax.scan(body, init, (db_c, va_c, base_rows))
    return best_d, best_r



class CodeStore:
    """
    Device-resident store of *unique* packed hash codes with int-key
    bookkeeping (host dict code-int -> row), queryable with Hamming top-k.

    The host mirror (compact uint32 matrix) is the persistence and
    compaction source of truth; removal is a validity-mask flip with
    compaction when under half full (same growable-array design as
    ops/store.VectorStore).
    """

    def __init__(self, bit_length: Optional[int] = None, mesh=None):
        """
        :param mesh: Optional 1-D ``jax.sharding.Mesh`` — packed codes
            row-shard across it and queries run the per-shard Hamming scan
            + k-sized all-gather merge (parallel/sharded_scan.py).
        """
        self._lock = threading.RLock()
        self._bits = bit_length
        self._mesh = mesh
        self._clear_state()
        if bit_length is not None:
            self._bits = int(bit_length)

    def _clear_state(self) -> None:
        bits = self._bits
        self._host: Optional[np.ndarray] = None      # (n_rows, W) uint32
        self._valid_host: Optional[np.ndarray] = None
        self._row2int: List[int] = []
        self._int2row: Dict[int, int] = {}
        self._n_live = 0
        self._dev = None
        self._dev_valid = None
        self._dev_pm1 = None     # (cap, bits_pad) bf16 ±1 mirror
        self._dev_pm1_sq = None  # (cap,) f32 squared norms (= bits)
        self._capacity = 0
        self._bits = bits

    @property
    def bits(self) -> Optional[int]:
        return self._bits

    @property
    def n_valid(self) -> int:
        return self._n_live

    def ints(self) -> List[int]:
        """Live code integers in row order."""
        with self._lock:
            if self._host is None:
                return []
            return [c for c, v in zip(self._row2int, self._valid_host) if v]

    def has_int(self, code: int) -> bool:
        with self._lock:
            return code in self._int2row

    def clear(self) -> None:
        with self._lock:
            self._clear_state()
            self._bits = None

    # ------------------------------------------------------------------
    # mutation (codes given as (n, bits) boolean matrices)
    # ------------------------------------------------------------------
    def _check_bits(self, mat: np.ndarray) -> None:
        if self._bits is None:
            self._bits = int(mat.shape[1])
        elif mat.shape[1] != self._bits:
            raise ValueError(
                f"Hash code bit length {mat.shape[1]} does not match "
                f"index bit length {self._bits}.")

    def build(self, bool_mat: np.ndarray) -> None:
        """Replace contents with the (deduplicated) given codes."""
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            bits = self._bits
            self._clear_state()
            self._bits = bits
            self._check_bits(bool_mat)
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            seen: Dict[int, int] = {}
            keep_rows = []
            for i, c in enumerate(ints):
                if c not in seen:
                    seen[c] = len(keep_rows)
                    keep_rows.append(i)
            self._host = bits_util.pack_bit_vectors_u32(bool_mat[keep_rows])
            self._valid_host = np.ones(len(keep_rows), dtype=bool)
            self._row2int = [ints[i] for i in keep_rows]
            self._int2row = seen
            self._n_live = len(keep_rows)
            self._upload_full()

    def add(self, bool_mat: np.ndarray) -> None:
        """Add codes, silently skipping ones already present."""
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            if self._host is None:
                self.build(bool_mat)
                return
            self._check_bits(bool_mat)
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            fresh_rows = []
            fresh_ints = []
            batch_seen = set()
            for i, c in enumerate(ints):
                if c not in self._int2row and c not in batch_seen:
                    batch_seen.add(c)
                    fresh_rows.append(i)
                    fresh_ints.append(c)
            if not fresh_rows:
                return
            packed = bits_util.pack_bit_vectors_u32(bool_mat[fresh_rows])
            start = self._host.shape[0]
            self._host = np.concatenate([self._host, packed], axis=0)
            self._valid_host = np.concatenate(
                [self._valid_host, np.ones(len(fresh_rows), dtype=bool)])
            for j, c in enumerate(fresh_ints):
                self._int2row[c] = start + j
                self._row2int.append(c)
            self._n_live += len(fresh_rows)
            if self._host.shape[0] > self._capacity:
                self._upload_full()
            else:
                self._upload_rows(start, packed)

    def remove(self, bool_mat: np.ndarray) -> None:
        """
        Remove the given codes.

        :raises KeyError: any code not present; nothing removed in that case
            (reference KeyError-non-mutation contract,
            /root/reference/smqtk_indexing/impls/hash_index/linear.py:184-204).
        """
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            rows = []
            for c in ints:
                if c not in self._int2row:
                    raise KeyError(c)
                rows.append(self._int2row[c])
            for c in ints:
                self._int2row.pop(c, None)
            assert self._valid_host is not None
            self._valid_host[rows] = False
            self._n_live -= len(set(rows))
            if self._n_live == 0:
                bits = self._bits
                self._clear_state()
                self._bits = bits
                return
            if self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                self._compact()
            else:
                self._upload_valid()

    def _compact(self) -> None:
        keep = np.flatnonzero(self._valid_host)
        self._host = np.ascontiguousarray(self._host[keep])
        self._row2int = [self._row2int[i] for i in keep]
        self._int2row = {c: i for i, c in enumerate(self._row2int)}
        self._valid_host = np.ones(self._host.shape[0], dtype=bool)
        self._upload_full()

    # ------------------------------------------------------------------
    # device sync
    # ------------------------------------------------------------------
    def _upload_full(self) -> None:
        assert self._host is not None
        n = self._host.shape[0]
        self._capacity = capacity_for(n)
        padded = np.zeros((self._capacity, self._host.shape[1]),
                          dtype=np.uint32)
        padded[:n] = self._host
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = self._valid_host
        self._dev = jnp.asarray(padded)
        self._dev_valid = jnp.asarray(valid)
        self._dev_pm1 = self._dev_pm1_sq = None
        if self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import shard_rows
            self._dev = shard_rows(self._mesh, self._dev)
            self._dev_valid = shard_rows(self._mesh, self._dev_valid)

    def _upload_rows(self, start: int, packed: np.ndarray) -> None:
        self._dev = jax.lax.dynamic_update_slice(
            self._dev, jnp.asarray(packed), (start, 0))
        self._dev_valid = jax.lax.dynamic_update_slice(
            self._dev_valid,
            jnp.ones(packed.shape[0], dtype=bool), (start,))
        if self._dev_pm1 is not None:
            # Incremental append into the ±1 mirror: only the new rows are
            # unpacked (a full mirror rebuild is O(cap * bits) host work +
            # a whole-matrix upload per mutation).
            n_new = packed.shape[0]
            bits_pad = self._dev_pm1.shape[1]
            block = np.zeros((n_new, bits_pad), dtype=np.float32)
            block[:, :self._bits] = bits_util.unpack_bit_vectors_u32(
                packed, self._bits) * 2.0 - 1.0
            self._dev_pm1 = jax.lax.dynamic_update_slice(
                self._dev_pm1, jnp.asarray(block, dtype=jnp.bfloat16),
                (start, 0))
            self._dev_pm1_sq = jax.lax.dynamic_update_slice(
                self._dev_pm1_sq,
                jnp.full(n_new, float(self._bits), jnp.float32), (start,))

    def _upload_valid(self) -> None:
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:len(self._valid_host)] = self._valid_host
        self._dev_valid = jnp.asarray(valid)
        if self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import shard_rows
            self._dev_valid = shard_rows(self._mesh, self._dev_valid)

    # ------------------------------------------------------------------
    # ±1 (matmul) mirror
    # ------------------------------------------------------------------
    def _pm1_eligible(self) -> bool:
        return self._mesh is None and pm1_engine(self._capacity, self._dev)

    def _ensure_pm1(self) -> None:
        """Build the ±1 bfloat16 mirror lazily (cap, bits padded to 128)."""
        if self._dev_pm1 is not None:
            return
        bits_pad = -(-self._bits // 128) * 128
        pm1 = np.zeros((self._capacity, bits_pad), dtype=np.float32)
        bools = bits_util.unpack_bit_vectors_u32(self._host, self._bits)
        pm1[:self._host.shape[0], :self._bits] = bools * 2.0 - 1.0
        sq = np.zeros(self._capacity, dtype=np.float32)
        sq[:self._host.shape[0]] = float(self._bits)
        self._dev_pm1 = jnp.asarray(pm1, dtype=jnp.bfloat16)
        self._dev_pm1_sq = jnp.asarray(sq)

    def _knn_pm1(self, q_bool: np.ndarray, k_dev: int, pm1,
                 pm1_sq, dev_valid) -> Tuple[np.ndarray, np.ndarray]:
        """Hamming top-k through the two-stage flat scan on ±1 codes (all
        device arrays are caller-snapshotted under the store lock)."""
        from smqtk_indexing_tpu.ops.scan import flat_topk_two_stage
        b = q_bool.shape[0]
        b_pad = _pow2_at_least(b, 8)
        bits_pad = pm1.shape[1]
        qp = np.zeros((b_pad, bits_pad), dtype=np.float32)
        qp[:b, :self._bits] = q_bool * 2.0 - 1.0
        # pm1 is bf16, so the f32 stage 2 gathers bf16-sized segments and
        # casts in-register — exact for ±1 values.
        d, rows = flat_topk_two_stage(pm1, pm1_sq, dev_valid,
                                      jnp.asarray(qp), k=k_dev)
        d = np.asarray(d)
        rows = np.asarray(rows)
        # d = sqrt(4 * hamming) exactly; recover integer distances.
        ham = np.round((d * d) / 4.0)
        ham = np.where(rows >= 0, ham, float(2 ** 30)).astype(np.int32)
        return ham, rows

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def knn(self, q_bool: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
        """
        Hamming top-k for a (B, bits) boolean query batch.

        :return: (dists (B, k') int32 ascending — raw bit counts, not
            normalized — and codes (B, k', bits) bool) with
            k' = min(k, live codes).
        """
        with self._lock:
            if self._host is None:
                raise ValueError("Code store is empty.")
            # ONE consistent snapshot: row indices computed against these
            # device arrays must gather codes from the matching host
            # mirror (a concurrent remove+compact between two separate
            # lock acquisitions would desynchronize them).
            dev, dev_valid = self._dev, self._dev_valid
            host, h_valid = self._host, self._valid_host
            n_live = self._n_live
            cap = self._capacity
            bits = self._bits
            host_rows = host.shape[0]
            use_pm1 = self._pm1_eligible() and host_rows > HOST_SCAN_MAX
            if use_pm1:
                self._ensure_pm1()
                pm1, pm1_sq = self._dev_pm1, self._dev_pm1_sq
                pm1_valid = self._dev_valid
        q_bool = np.atleast_2d(np.asarray(q_bool)).astype(bool)
        if q_bool.shape[1] != bits:
            raise ValueError(
                f"Query bit length {q_bool.shape[1]} != index {bits}.")
        q_packed = bits_util.pack_bit_vectors_u32(q_bool)
        b = q_bool.shape[0]
        b_pad = _pow2_at_least(b, 8)
        if b_pad != b:
            q_packed = np.concatenate(
                [q_packed,
                 np.zeros((b_pad - b, q_packed.shape[1]), dtype=np.uint32)])
        k_eff = min(k, n_live)
        if self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import replicate
            from smqtk_indexing_tpu.parallel.sharded_scan import (
                sharded_hamming_topk,
            )
            k_dev = min(_pow2_at_least(k_eff), cap)
            dd, rr = sharded_hamming_topk(
                self._mesh, dev, dev_valid,
                replicate(self._mesh, jnp.asarray(q_packed)), k=k_dev)
            dists = np.asarray(dd)[:b, :k_eff]
            rows = np.asarray(rr)[:b, :k_eff]
        elif host_rows <= HOST_SCAN_MAX:
            # Tiny index: device round-trip latency dominates; run the
            # native (C++) host scan over the host mirror. Tie order
            # matches the device path (distance then row ascending).
            from smqtk_indexing_tpu import native
            dists, rows = native.hamming_topk(
                host, h_valid, q_packed[:b], k_eff)
        elif use_pm1:
            k_dev = min(_pow2_at_least(k_eff), cap)
            dists, rows = self._knn_pm1(q_bool, k_dev, pm1, pm1_sq,
                                        pm1_valid)
            dists = dists[:b, :k_eff]
            rows = rows[:b, :k_eff]
        else:
            k_dev = min(_pow2_at_least(k_eff), cap)
            dists, rows = hamming_topk(dev, dev_valid,
                                       jnp.asarray(q_packed), k=k_dev)
            dists = np.asarray(dists)[:b, :k_eff]
            rows = np.asarray(rows)[:b, :k_eff]
        # Unfilled slots carry row -1 (clamp for the host gather; their
        # distances already hold the sentinel).
        sel = host[np.maximum(rows, 0).reshape(-1)]
        codes = bits_util.unpack_bit_vectors_u32(sel, bits) \
            .reshape(b, k_eff, bits)
        return dists, codes

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        with self._lock:
            bio = io.BytesIO()
            if self._host is None:
                np.savez(bio, empty=np.array(True))
            else:
                keep = np.flatnonzero(self._valid_host)
                np.savez(bio, packed=self._host[keep],
                         bits=np.array(self._bits))
            return bio.getvalue()

    def from_bytes(self, data: bytes) -> None:
        bio = io.BytesIO(data)
        with np.load(bio) as z:
            if "empty" in z:
                self.clear()
                return
            packed = z["packed"]
            bits = int(z["bits"])
        self.build(bits_util.unpack_bit_vectors_u32(packed, bits))
