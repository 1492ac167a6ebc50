"""
Device-resident, growable vector store with UID bookkeeping.

Device-first inversion of the reference's storage triple-bookkeeping
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:260-274): vectors live
once in a padded device matrix; the host keeps a float32 mirror (the persistence
and compaction source of truth), a row->UID array and UID->row dict. Removal
is a validity-mask flip (the reference's ``remove_ids`` C++ call,
faiss.py:675, becomes a mask update); capacity doubles on growth and the
store compacts when under half full — both keep jit cache keys bounded
(capacities are always 1024 * 2^m).
"""
from __future__ import annotations

import io
import re
import threading
from typing import Hashable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.ops import scan
from smqtk_indexing_tpu.ops.device import capacity_for, pad_dim, pad_rows_np
from smqtk_indexing_tpu.ops.device import pow2_at_least as _pow2_at_least

#: Device storage codecs: float32 (exact), bfloat16 (half traffic, tiny
#: recall cost), sq8 (int8 scalar quantization, 4x capacity — the
#: reference's FAISS 'SQ8' codec axis, faiss.py:190; see ops/sq8.py),
#: pq<M> (product quantization, M bytes/vector — e.g. 'pq16' is 32x
#: capacity at d=128; see ops/pq.py).
_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "sq8": jnp.int8}

_PQ_RE = re.compile(r"(o?)pq(\d+)$")


def _pq_m(dtype_name: str):
    """Subquantizer count for 'pq<M>' / 'opq<M>' dtype names, else
    None ('opq' = PQ behind a learned OPQ rotation, ops/opq.py)."""
    m = _PQ_RE.fullmatch(dtype_name)
    return int(m.group(2)) if m else None


def _pq_rotate(dtype_name: str) -> bool:
    """True for the OPQ variants ('opq<M>')."""
    m = _PQ_RE.fullmatch(dtype_name)
    return bool(m and m.group(1))


class VectorStore:
    """
    (N, d) float vector store, queryable with exhaustive top-k on device.

    Thread safety: mutations swap immutable device arrays behind a lock
    (mirrors the lock-around-swap discipline the reference interfaces mandate,
    /root/reference/smqtk_indexing/interfaces/nearest_neighbor_index.py:22-24).
    """

    def __init__(self, dtype: str = "float32", mesh=None):
        """
        :param mesh: Optional 1-D ``jax.sharding.Mesh`` — when given, device
            arrays are row-sharded across it and queries run the per-shard
            scan + k-sized all-gather merge (parallel/sharded_scan.py). Mesh
            sizes are powers of two, so they always divide the capacity
            quantum.
        """
        if dtype not in _DTYPES and _pq_m(dtype) is None:
            raise ValueError(
                f"dtype must be one of {sorted(_DTYPES)}, 'pq<M>' or "
                "'opq<M>'")
        self._dtype_name = dtype
        self._mesh = mesh
        self._lock = threading.RLock()
        self._clear_state()

    def _two_stage_eligible(self, metric: str) -> bool:
        """Serve through the two-stage segment-minima scan
        (ops/scan.flat_topk_two_stage) — measured faster than the
        streaming scan on the GPU (PERF.md): single device, matmul-form
        metric, float storage, capacity of at least one tile."""
        from smqtk_indexing_tpu.ops.device import TILE_N, on_gpu
        return (metric in ("euclidean", "inner_product", "cosine")
                and self._dtype_name in ("float32", "bfloat16")
                and self._mesh is None and self._capacity >= TILE_N
                and on_gpu(self._dev))

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _clear_state(self) -> None:
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None      # (n_rows, d) f32
        self._valid_host: Optional[np.ndarray] = None  # (n_rows,) bool
        self._row2uid: List[Hashable] = []
        self._uid2row: dict = {}
        self._n_live = 0
        # device side
        self._dev = None
        self._dev_sq = None
        self._dev_norm = None
        self._dev_valid = None
        self._capacity = 0
        # sq8 codec (trained at build, fixed across incremental adds —
        # the FAISS scalar-quantizer train-once contract)
        self._sq8_a = None
        self._sq8_b = None
        # pq codebooks (same train-once contract) + the dim interleave:
        # zero-padding packs all real dims into the first subspaces, so
        # dims are permuted round-robin across subquantizers before
        # encoding (every metric served is coordinate-permutation
        # invariant; queries permute identically at scan time).
        self._pq_cb = None
        self._pq_cb_dev = None
        self._pq_perm = None
        self._pq_rot = None   # (d_codec, d_codec) f32 OPQ rotation | None

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def n_valid(self) -> int:
        return self._n_live

    @property
    def capacity(self) -> int:
        return self._capacity

    def uids(self) -> List[Hashable]:
        """Live UIDs in row order."""
        with self._lock:
            if self._host is None:
                return []
            return [u for u, v in zip(self._row2uid, self._valid_host) if v]

    def has_uid(self, uid: Hashable) -> bool:
        with self._lock:
            return uid in self._uid2row

    def uid_to_row(self) -> dict:
        """Snapshot of the live UID -> storage-row mapping (the
        externally-persistable uid2idx view, reference faiss.py:260-274).
        Rows may change on compaction/rebuild; callers mirror, not cache."""
        with self._lock:
            return dict(self._uid2row)

    def vector(self, uid: Hashable) -> np.ndarray:
        """:raises KeyError: unknown UID."""
        with self._lock:
            row = self._uid2row[uid]
            assert self._host is not None
            return self._host[row]

    def clear(self) -> None:
        with self._lock:
            self._clear_state()

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def build(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        """Replace all contents with the given (n, d) matrix and UIDs."""
        src = mat
        mat = np.ascontiguousarray(np.atleast_2d(mat), dtype=np.float32)
        if isinstance(src, np.ndarray) and np.shares_memory(mat, src):
            # The host mirror is the persistence/compaction source of
            # truth — never alias caller-owned memory.
            mat = mat.copy()
        if mat.shape[0] != len(uids):
            raise ValueError("Row count does not match UID count.")
        if len(set(uids)) != len(uids):
            raise ValueError("Duplicate UIDs in build input.")
        with self._lock:
            self._clear_state()
            self._dim = int(mat.shape[1])
            self._host = mat
            self._valid_host = np.ones(mat.shape[0], dtype=bool)
            self._row2uid = list(uids)
            self._uid2row = {u: i for i, u in enumerate(uids)}
            self._n_live = mat.shape[0]
            self._upload_full()

    def add(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        """
        Append rows (UIDs must be new; replacing an existing UID is the
        caller's policy to implement via remove+add).
        """
        mat = np.ascontiguousarray(np.atleast_2d(mat), dtype=np.float32)
        if mat.shape[0] != len(uids):
            raise ValueError("Row count does not match UID count.")
        with self._lock:
            if self._host is None:
                self.build(mat, uids)
                return
            if mat.shape[1] != self._dim:
                raise ValueError(
                    f"Dim mismatch: store={self._dim}, input={mat.shape[1]}")
            if len(set(uids)) != len(uids):
                raise ValueError("Duplicate UIDs in add input.")
            for u in uids:
                if u in self._uid2row:
                    raise ValueError(f"UID already present: {u!r}")
            start = self._host.shape[0]
            self._host = np.concatenate([self._host, mat], axis=0)
            self._valid_host = np.concatenate(
                [self._valid_host, np.ones(mat.shape[0], dtype=bool)])
            for i, u in enumerate(uids):
                self._uid2row[u] = start + i
                self._row2uid.append(u)
            self._n_live += mat.shape[0]
            if self._host.shape[0] > self._capacity:
                self._upload_full()
            else:
                self._upload_rows(start, mat)

    def remove(self, uids: Sequence[Hashable]) -> None:
        """
        Mask out rows for the given UIDs.

        :raises KeyError: any UID unknown; nothing is removed in that case.
        """
        # Dedupe (preserving order): duplicated UIDs must not corrupt the
        # bookkeeping or raise KeyError mid-mutation.
        uids = list(dict.fromkeys(uids))
        with self._lock:
            rows = []
            for u in uids:
                if u not in self._uid2row:
                    raise KeyError(u)
                rows.append(self._uid2row[u])
            for u in uids:
                del self._uid2row[u]
            assert self._valid_host is not None
            self._valid_host[rows] = False
            self._n_live -= len(rows)
            if self._n_live == 0:
                self._clear_state()
                return
            if self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                self._compact()
            else:
                self._upload_valid()

    def _compact(self) -> None:
        assert self._host is not None and self._valid_host is not None
        keep = np.flatnonzero(self._valid_host)
        self._host = np.ascontiguousarray(self._host[keep])
        self._row2uid = [self._row2uid[i] for i in keep]
        self._uid2row = {u: i for i, u in enumerate(self._row2uid)}
        self._valid_host = np.ones(self._host.shape[0], dtype=bool)
        self._upload_full()

    # ------------------------------------------------------------------
    # device sync
    # ------------------------------------------------------------------
    def _upload_full(self) -> None:
        assert self._host is not None and self._dim is not None
        n = self._host.shape[0]
        self._capacity = capacity_for(n)
        d_pad = pad_dim(self._dim)
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = self._valid_host
        if self._dtype_name == "sq8":
            from smqtk_indexing_tpu.ops import sq8
            codec = None if self._sq8_a is None else (
                np.asarray(self._sq8_a)[:self._dim],
                np.asarray(self._sq8_b)[:self._dim])
            (self._sq8_a, self._sq8_b, self._dev, self._dev_sq,
             self._dev_norm) = sq8.sq8_build_store(
                self._host, self._valid_host, self._capacity, d_pad,
                self._dim, codec=codec)
            self._dev_valid = jnp.asarray(valid)
            if self._mesh is not None:
                from smqtk_indexing_tpu.parallel.mesh import shard_rows
                self._dev = shard_rows(self._mesh, self._dev)
                self._dev_sq = shard_rows(self._mesh, self._dev_sq)
                self._dev_norm = shard_rows(self._mesh, self._dev_norm)
                self._dev_valid = shard_rows(self._mesh, self._dev_valid)
            return
        pq_m = _pq_m(self._dtype_name)
        if pq_m is not None:
            from smqtk_indexing_tpu.ops import pq
            codec = None if self._pq_cb is None else (
                self._pq_perm, self._pq_rot, self._pq_cb)
            (self._pq_perm, self._pq_rot, self._pq_cb, self._pq_cb_dev,
             self._dev, self._dev_sq) = pq.pq_build_store(
                self._host, self._valid_host, self._capacity, d_pad,
                pq_m, rotate=_pq_rotate(self._dtype_name), codec=codec)
            self._dev_norm = jnp.sqrt(jnp.maximum(self._dev_sq, 0.0))
            self._dev_valid = jnp.asarray(valid)
            if self._mesh is not None:
                from smqtk_indexing_tpu.parallel.mesh import shard_rows
                self._dev = shard_rows(self._mesh, self._dev)
                self._dev_sq = shard_rows(self._mesh, self._dev_sq)
                self._dev_norm = shard_rows(self._mesh, self._dev_norm)
                self._dev_valid = shard_rows(self._mesh, self._dev_valid)
            return
        padded = pad_rows_np(self._host, self._capacity, d_pad)
        sq = np.zeros(self._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
        self._dev = jnp.asarray(padded, dtype=_DTYPES[self._dtype_name])
        self._dev_sq = jnp.asarray(sq)
        self._dev_norm = jnp.sqrt(self._dev_sq)
        self._dev_valid = jnp.asarray(valid)
        if self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import shard_rows
            self._dev = shard_rows(self._mesh, self._dev)
            self._dev_sq = shard_rows(self._mesh, self._dev_sq)
            self._dev_norm = shard_rows(self._mesh, self._dev_norm)
            self._dev_valid = shard_rows(self._mesh, self._dev_valid)

    def _upload_rows(self, start: int, mat: np.ndarray) -> None:
        """Incremental append of rows [start, start+len(mat)) on device."""
        if self._mesh is not None:
            # Sharded arrays re-place wholesale (dynamic_update_slice would
            # drop the sharding); mutation rate is low relative to queries.
            self._upload_full()
            return
        d_pad = pad_dim(self._dim)  # type: ignore[arg-type]
        if self._dtype_name == "sq8":
            # Encode with the codec trained at build (out-of-range values
            # clip — the FAISS scalar-quantizer add-after-train contract).
            from smqtk_indexing_tpu.ops import sq8
            a = np.asarray(self._sq8_a)[:self._dim]
            b = np.asarray(self._sq8_b)[:self._dim]
            codes = np.zeros((mat.shape[0], d_pad), dtype=np.int8)
            codes[:, :self._dim] = sq8.sq8_encode_np(mat, a, b)
            block_dev = jnp.asarray(codes)
            self._dev = jax.lax.dynamic_update_slice(
                self._dev, block_dev, (start, 0))
            s2, nrm = sq8.sq8_row_stats(block_dev, self._sq8_a,
                                        self._sq8_b)
            self._dev_sq = jax.lax.dynamic_update_slice(
                self._dev_sq, s2, (start,))
            self._dev_norm = jax.lax.dynamic_update_slice(
                self._dev_norm, nrm, (start,))
            self._dev_valid = jax.lax.dynamic_update_slice(
                self._dev_valid, jnp.ones(mat.shape[0], dtype=bool),
                (start,))
            return
        if _pq_m(self._dtype_name) is not None:
            # Encode with the codebooks trained at build (FAISS
            # add-after-train contract).
            from smqtk_indexing_tpu.ops import pq
            codes = pq.pq_encode_np(
                pq.pq_prep_queries(
                    pad_rows_np(mat, mat.shape[0], d_pad),
                    self._pq_perm, self._pq_rot),
                self._pq_cb)
            block_dev = jnp.asarray(codes)
            self._dev = jax.lax.dynamic_update_slice(
                self._dev, block_dev, (start, 0))
            s2 = pq.pq_row_stats(block_dev, self._pq_cb_dev)
            self._dev_sq = jax.lax.dynamic_update_slice(
                self._dev_sq, s2, (start,))
            self._dev_norm = jax.lax.dynamic_update_slice(
                self._dev_norm, jnp.sqrt(jnp.maximum(s2, 0.0)), (start,))
            self._dev_valid = jax.lax.dynamic_update_slice(
                self._dev_valid, jnp.ones(mat.shape[0], dtype=bool),
                (start,))
            return
        block = pad_rows_np(mat, mat.shape[0], d_pad)
        dev_dtype = _DTYPES[self._dtype_name]
        self._dev = jax.lax.dynamic_update_slice(
            self._dev, jnp.asarray(block, dtype=dev_dtype), (start, 0))
        sq = np.einsum("ij,ij->i", mat, mat).astype(np.float32)
        self._dev_sq = jax.lax.dynamic_update_slice(
            self._dev_sq, jnp.asarray(sq), (start,))
        self._dev_norm = jax.lax.dynamic_update_slice(
            self._dev_norm, jnp.sqrt(jnp.asarray(sq)), (start,))
        self._dev_valid = jax.lax.dynamic_update_slice(
            self._dev_valid, jnp.ones(mat.shape[0], dtype=bool), (start,))

    def _upload_valid(self) -> None:
        assert self._valid_host is not None
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:len(self._valid_host)] = self._valid_host
        self._dev_valid = jnp.asarray(valid)
        if self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import shard_rows
            self._dev_valid = shard_rows(self._mesh, self._dev_valid)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def knn(self, q: np.ndarray, k: int, metric: str = "euclidean"
            ) -> Tuple[np.ndarray, List[List[Hashable]], np.ndarray]:
        """
        Exhaustive top-k for a (B, d) query batch.

        :return: (dists (B, k') float32 ascending, per-query UID lists,
            rows (B, k') int32) where k' = min(k, live rows).
        """
        with self._lock:
            if self._host is None:
                raise ValueError("Store is empty.")
            dev, dev_sq, dev_norm, dev_valid = (
                self._dev, self._dev_sq, self._dev_norm, self._dev_valid)
            sq8_a, sq8_b = self._sq8_a, self._sq8_b
            pq_cb_dev, pq_perm = self._pq_cb_dev, self._pq_perm
            pq_rot = self._pq_rot
            # Borrow, don't copy: the list only ever grows in place
            # (append under the lock) and compaction REPLACES the
            # object, so this reference stays index-consistent with the
            # device arrays snapshotted above — an O(N) copy per query
            # batch costs ~10ms at 1M rows on this host.
            row2uid = self._row2uid
            n_live = self._n_live
            cap = self._capacity
            d = self._dim
            use_two_stage = self._two_stage_eligible(metric)

        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        if q.shape[1] != d:
            raise ValueError(f"Query dim {q.shape[1]} != store dim {d}")
        b = q.shape[0]
        b_pad = _pow2_at_least(b, 8)
        d_pad = pad_dim(d)  # type: ignore[arg-type]
        q_pad = pad_rows_np(q, b_pad, d_pad)

        k_eff = min(k, n_live)
        # Round the on-device k up to a power of two (capped at capacity) so
        # distinct user n values reuse compiled programs; trim host-side.
        k_dev = min(_pow2_at_least(k_eff, 1), cap)

        if pq_rot is not None and metric == "hik":
            # min() is not rotation invariant — OPQ serves the
            # matmul-form metrics only (FAISS's OPQ pre-transform is
            # L2/IP-only for the same reason).
            raise ValueError("metric 'hik' is not supported with OPQ "
                             "(rotation-variant); use 'pq<M>'")
        if _pq_m(self._dtype_name) is not None and self._mesh is None:
            from smqtk_indexing_tpu.ops.pq import pq_prep_queries, pq_topk
            dists, rows = pq_topk(
                dev, pq_cb_dev, dev_sq, dev_valid,
                jnp.asarray(pq_prep_queries(q_pad, pq_perm, pq_rot)),
                k=k_dev, metric=metric)
        elif _pq_m(self._dtype_name) is not None:
            from smqtk_indexing_tpu.ops.pq import pq_prep_queries
            from smqtk_indexing_tpu.parallel.mesh import replicate
            from smqtk_indexing_tpu.parallel.sharded_scan import (
                sharded_pq_topk,
            )
            dists, rows = sharded_pq_topk(
                self._mesh, dev, replicate(self._mesh, pq_cb_dev),
                dev_sq, dev_valid,
                replicate(self._mesh,
                          jnp.asarray(pq_prep_queries(q_pad, pq_perm,
                                                      pq_rot))),
                k=k_dev, metric=metric)
        elif self._dtype_name == "sq8" and self._mesh is None:
            from smqtk_indexing_tpu.ops.sq8 import sq8_topk
            dists, rows = sq8_topk(
                dev, sq8_a, sq8_b, dev_sq, dev_norm,
                dev_valid, jnp.asarray(q_pad), k=k_dev, metric=metric)
        elif self._dtype_name == "sq8":
            from smqtk_indexing_tpu.parallel.mesh import replicate
            from smqtk_indexing_tpu.parallel.sharded_scan import (
                sharded_sq8_topk,
            )
            dists, rows = sharded_sq8_topk(
                self._mesh, dev, replicate(self._mesh, sq8_a),
                replicate(self._mesh, sq8_b), dev_sq,
                dev_norm, dev_valid,
                replicate(self._mesh, jnp.asarray(q_pad)),
                k=k_dev, metric=metric)
        elif self._mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import replicate
            from smqtk_indexing_tpu.parallel.sharded_scan import (
                sharded_flat_topk,
            )
            dists, rows = sharded_flat_topk(
                self._mesh, dev, dev_sq, dev_norm, dev_valid,
                replicate(self._mesh, jnp.asarray(q_pad)),
                k=k_dev, metric=metric)
        elif use_two_stage:
            dists, rows = scan.flat_topk_two_stage(
                dev, dev_sq, dev_valid, jnp.asarray(q_pad), k=k_dev,
                metric=metric, db_norm=dev_norm)
        else:
            dists, rows = scan.flat_topk(
                dev, dev_sq, dev_norm, dev_valid, jnp.asarray(q_pad),
                k=k_dev, metric=metric)
        dists = np.asarray(dists)[:b, :k_eff]
        rows = np.asarray(rows)[:b, :k_eff]
        # r >= 0 guard: -1 padding must fail soft (skip), not resolve to
        # the last row via Python negative indexing (k_eff = min(k,
        # n_live) keeps padding out today; match the streamed sibling).
        uid_lists = [[row2uid[r] for r in row if r >= 0] for row in rows]
        return dists, uid_lists, rows

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize live rows + UIDs (compact form)."""
        with self._lock:
            bio = io.BytesIO()
            if self._host is None:
                np.savez(bio, empty=np.array(True))
            else:
                keep = np.flatnonzero(self._valid_host)
                np.savez(
                    bio,
                    matrix=self._host[keep],
                    uids=np.array([self._row2uid[i] for i in keep],
                                  dtype=object),
                )
            return bio.getvalue()

    def from_bytes(self, data: bytes) -> None:
        bio = io.BytesIO(data)
        with np.load(bio, allow_pickle=True) as z:
            if "empty" in z:
                self.clear()
                return
            mat = z["matrix"]
            uids = list(z["uids"])
        self.build(mat, uids)


class HostStreamedVectorStore (VectorStore):
    """
    The beyond-device-memory capacity tier (SURVEY.md §5 index-size
    scaling): the database lives in HOST memory only; each query batch
    streams it through the device in fixed-size row blocks, running the
    exact flat scan per block and merging the per-block (B, k) winners on
    host. Capacity is bounded by host RAM instead of device memory;
    per-query-batch cost is one host->device transfer of the whole matrix
    (this tier trades that for unbounded N; for device-resident speed use
    the base store, a mesh, or a compressed codec).

    Exactness: every block result is already the exact per-metric distance
    (ops/scan.flat_topk re-ranks winners exactly), so the host merge of
    block top-k lists is the exact global top-k.
    """

    #: Rows per streamed device block (pow2 so jit keys stay bounded).
    BLOCK_ROWS = 1 << 20

    def __init__(self, dtype: str = "float32", mesh=None,
                 block_rows: Optional[int] = None):
        if mesh is not None:
            raise ValueError(
                "HostStreamedVectorStore streams through ONE device; use "
                "the base VectorStore with n_devices for mesh sharding.")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "Host streaming serves float32/bfloat16 (compressed codecs "
                "are device-resident tiers; combining them with host "
                "streaming would re-encode per batch).")
        super().__init__(dtype=dtype)
        if block_rows is not None:
            if block_rows & (block_rows - 1) or block_rows < 1024:
                raise ValueError("block_rows must be a power of two "
                                 ">= 1024.")
            self.BLOCK_ROWS = block_rows

    # Device mirrors are never kept: uploads are per-query-batch streams.
    def _upload_full(self) -> None:
        self._capacity = capacity_for(self._host.shape[0])

    def _upload_rows(self, start: int, mat: np.ndarray) -> None:
        self._capacity = capacity_for(self._host.shape[0])

    def _upload_valid(self) -> None:
        pass

    def knn(self, q: np.ndarray, k: int, metric: str = "euclidean"
            ) -> Tuple[np.ndarray, List[List[Hashable]], np.ndarray]:
        with self._lock:
            if self._host is None:
                raise ValueError("Store is empty.")
            host = self._host
            # Snapshot the liveness mask: remove() flips _valid_host IN
            # PLACE, so holding a reference would yield a torn view across
            # streamed blocks mid-removal (the base store's device arrays
            # are immutable snapshots; this copy restores that semantic).
            # _host itself is only ever replaced wholesale (concat/new
            # array), never mutated in place, so the reference is safe —
            # and copying it here could be tens of GB.
            valid_host = self._valid_host.copy()
            row2uid = self._row2uid   # borrow (see base knn)
            n_live = self._n_live
            d = self._dim

        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        if q.shape[1] != d:
            raise ValueError(f"Query dim {q.shape[1]} != store dim {d}")
        b = q.shape[0]
        b_pad = _pow2_at_least(b, 8)
        d_pad = pad_dim(d)
        q_dev = jnp.asarray(pad_rows_np(q, b_pad, d_pad))

        k_eff = min(k, n_live)
        n = host.shape[0]
        block = min(self.BLOCK_ROWS, capacity_for(n))
        k_dev = min(_pow2_at_least(k_eff, 1), block)
        dev_dtype = _DTYPES[self._dtype_name]

        dists_parts, rows_parts = [], []
        for lo in range(0, n, block):
            blk = host[lo:lo + block]
            rows_n = blk.shape[0]
            pad_n = block if rows_n > block // 2 or lo > 0 \
                else capacity_for(rows_n)
            mat_p = pad_rows_np(blk, pad_n, d_pad)
            sq = np.zeros(pad_n, dtype=np.float32)
            sq[:rows_n] = np.einsum("ij,ij->i", blk, blk)
            va = np.zeros(pad_n, dtype=bool)
            va[:rows_n] = valid_host[lo:lo + block]
            dev = jnp.asarray(mat_p, dtype=dev_dtype)
            dev_sq = jnp.asarray(sq)
            dd, rr = scan.flat_topk(
                dev, dev_sq, jnp.sqrt(dev_sq), jnp.asarray(va), q_dev,
                k=min(k_dev, pad_n), metric=metric)
            dd = np.asarray(dd)[:b]
            rr = np.asarray(rr)[:b]
            rows_parts.append(np.where(rr >= 0, rr + lo, -1))
            dists_parts.append(dd)
        dists = np.concatenate(dists_parts, axis=1)
        rows = np.concatenate(rows_parts, axis=1)
        dists = np.where(rows >= 0, dists, np.inf)
        sel = np.argsort(dists, axis=1, kind="stable")[:, :k_eff]
        dists = np.take_along_axis(dists, sel, axis=1)
        rows = np.take_along_axis(rows, sel, axis=1)
        uid_lists = [[row2uid[r] for r in row if r >= 0] for row in rows]
        return dists, uid_lists, rows
