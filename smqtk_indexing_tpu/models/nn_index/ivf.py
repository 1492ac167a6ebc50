"""
IVF (inverted-file, coarse-quantized) device nearest-neighbor index.

Capability-parity with the reference's FAISS IVF configurations
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py — factory strings
like 'IVF4096,Flat' with query-time ``ivf_nprobe``, faiss.py:230-236,
715-749) without the C++ delegation: k-means training is a jitted chunked
Lloyd program (ops/kmeans.py), the database is laid out sorted by coarse
cluster so each inverted list is a contiguous row range, and a query is one
fused centroid-scan + list-gather + top-k + exact-re-rank program
(ops/ivf.py).

Reference semantic notes carried over: update skips already-indexed UIDs
with a warning (faiss.py:561-642); removal is mask-based (the ``remove_ids``
C++ call, faiss.py:644-679, becomes a validity flip + periodic compaction);
persistence overwrites the configured index element on every mutation
(interfaces/nearest_neighbor_index.py:18-21).
"""
from __future__ import annotations

import logging
import threading
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.data.descriptor import (
    DescriptorElement, DescriptorSet, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu.models.nn_index._results import assemble_results
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu.ops.device import capacity_for, pad_dim, pad_rows_np
from smqtk_indexing_tpu.ops.device import pow2_at_least as _pow2_at_least
from smqtk_indexing_tpu.models.nn_index._ivf_matrix import (  # noqa: F401
    _is_pq_dtype, validate_ivf_combination,
)
from smqtk_indexing_tpu.ops.kmeans import kmeans_assign, kmeans_lloyd
from smqtk_indexing_tpu.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)


class IvfNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Coarse-quantized approximate kNN: k-means cells + per-query list probing.

    :param descriptor_set: Backing descriptor element storage.
    :param index_element: Optional DataElement persisting the trained index.
    :param metric: 'euclidean' | 'inner_product' | 'cosine'.
    :param n_lists: Number of coarse cells; 0 = auto (≈ sqrt(N) rounded to a
        power of two, clamped to [16, 4096] for sane defaults).
    :param nprobe: Cells probed per query (query-time tunable attribute, the
        reference's ``ivf_nprobe``).
    :param kmeans_iterations: Lloyd iterations for training.
    :param max_points_per_centroid: Training subsample cap (n_lists * this),
        mirroring the FAISS clustering parameter of the same name.
    :param random_seed: Seed for k-means init / training subsample.
    :param dtype: Device storage codec ('float32' | 'bfloat16' | 'sq8' —
        int8 scalar quantization, 4x capacity; the reference's 'IVFn,SQ8'
        factory codec, faiss.py:190).
    :param storage: Host-mirror strategy. 'rows' (default) keeps float32
        originals host-side (exact distances, any metric/codec). 'code'
        is the CAPACITY tier: the host mirror itself is int8 codes (4x
        smaller — 12.8GB instead of 51GB at 100M x 128), persistence
        saves/reloads codes (never float originals), and queries run
        through the tiled-transposed list scan (ops/ivf_tiled.py).
        Requires dtype='sq8' or 'pq<M>' and metric euclidean,
        inner_product or cosine (FAISS's METRIC_* axis on the same
        factory configs, faiss.py:51-67; cosine encodes L2-normalized
        rows — codes persist on the unit sphere). With 'pq<M>' the
        mirror is (n, M) uint8 PQ codes (16 bytes/vector at PQ16) and
        the scan looks the per-query ADC table up per code
        (ops/ivf_tiled.ivf_query_tiled_pq).
        The codec is trained once at build and reused by updates (FAISS
        quantizer semantics: train() fixes the codec, adds encode with
        it — faiss.py:368-386). Shards over ``n_devices``
        (parallel/sharded_ivf_code.py).
    :param rerank: Finalization for the 'code' tier. 'exact' (default)
        gathers the winners' codes and reports distances exact w.r.t.
        the quantized vectors; 'score' takes distances straight from the
        scan's f32 surrogate (f32 cancellation noise only, far below the
        SQ8 codec step) and skips the winner gather.
    :param read_only: Refuse mutations when True.
    :param pq_residual: (PQ dtypes, euclidean) Encode RESIDUALS
        ``x - centroid(assigned list)`` instead of raw rows — FAISS's
        ``by_residual`` IVF-PQ behavior: the codec only carries the
        intra-cell offset, so reconstruction error scales with the
        residual magnitude (on clustered data a large recall gain at
        identical bytes/vector). Serving adds one ``-2<q, c>`` broadcast
        per probe (derived from the probe-selection matmul) and the
        exact re-rank adds the winner's centroid back
        (ops/pq.pq_residual_build_store).

    >>> import numpy as np
    >>> from smqtk_indexing_tpu.data.descriptor import (
    ...     DescriptorMemoryElement)
    >>> rng = np.random.default_rng(0)
    >>> els = [DescriptorMemoryElement(i, rng.normal(size=8)
    ...        .astype(np.float32)) for i in range(64)]
    >>> index = IvfNearestNeighborsIndex(n_lists=4, nprobe=4,
    ...                                  random_seed=0)
    >>> index.build_index(els)
    >>> neighbors, dists = index.nn(els[5], 3)
    >>> neighbors[0].uuid()
    5
    >>> index.nprobe = 2   # query-time tunable (reference: ivf_nprobe)
    >>> len(index.nn(els[5], 3)[0])
    3
    """

    @classmethod
    def is_usable(cls) -> bool:
        # Usable whenever the compute stack imports (the reference gates
        # availability on backend importability, faiss.py:86-89); HOW it
        # runs — compiled GPU kernels vs interpret fallback — is reported
        # by usability_report().
        try:
            import jax  # noqa: F401
            return True
        except Exception:  # pragma: no cover - broken install
            return False

    @classmethod
    def usability_report(cls) -> dict:
        from smqtk_indexing_tpu.ops.device import device_report
        r = super().usability_report()
        r.update(device_report())
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["index_element"] = make_default_config(DataElement.get_impls())
        from smqtk_indexing_tpu.data.key_value import KeyValueStore
        c["uid2idx_kvs"] = make_default_config(KeyValueStore.get_impls())
        c["idx2uid_kvs"] = make_default_config(KeyValueStore.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "IvfNearestNeighborsIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        ds_cfg = cfg.get("descriptor_set")
        if ds_cfg and ds_cfg.get("type"):
            cfg["descriptor_set"] = from_config_dict(
                ds_cfg, DescriptorSet.get_impls())
        else:
            cfg["descriptor_set"] = None
        ie_cfg = cfg.get("index_element")
        if ie_cfg and ie_cfg.get("type"):
            cfg["index_element"] = from_config_dict(
                ie_cfg, DataElement.get_impls())
        else:
            cfg["index_element"] = None
        from smqtk_indexing_tpu.data.key_value import KeyValueStore
        for slot in ("uid2idx_kvs", "idx2uid_kvs"):
            sc = cfg.get(slot)
            if sc and sc.get("type"):
                cfg[slot] = from_config_dict(sc, KeyValueStore.get_impls())
            else:
                cfg[slot] = None
        return super().from_config(cfg, False)

    def __init__(
        self,
        descriptor_set: Optional[DescriptorSet] = None,
        index_element: Optional[DataElement] = None,
        metric: str = "euclidean",
        n_lists: int = 0,
        nprobe: int = 8,
        kmeans_iterations: int = 10,
        max_points_per_centroid: int = 256,
        random_seed: Optional[int] = None,
        dtype: str = "float32",
        storage: str = "rows",
        rerank: str = "exact",
        read_only: bool = False,
        n_devices: Optional[int] = None,
        pq_residual: bool = False,
        uid2idx_kvs=None,
        idx2uid_kvs=None,
    ):
        super().__init__()
        # The full supported-configuration matrix (and every rejection)
        # lives in validate_ivf_combination — one authority, no
        # constraint hidden in a kernel wrapper.
        validate_ivf_combination(metric, dtype, storage, rerank,
                                 n_devices, pq_residual)
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.metric = metric
        self.n_lists = int(n_lists)
        self.nprobe = int(nprobe)
        self.kmeans_iterations = int(kmeans_iterations)
        self.max_points_per_centroid = int(max_points_per_centroid)
        self.random_seed = random_seed
        self.dtype = dtype
        self.storage = storage
        self.rerank = rerank
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self.pq_residual = bool(pq_residual)
        # Optional external uid<->idx mirrors (reference layout parity,
        # faiss.py:260-274; see models/nn_index/_kvs.py).
        self.uid2idx_kvs = uid2idx_kvs
        self.idx2uid_kvs = idx2uid_kvs

        self._model_lock = threading.RLock()
        self._reset_state()
        self._load_index()

    @staticmethod
    def _pq_m(dtype_name: str):
        """Subquantizer count for 'pq<M>' / 'opq<M>' dtype names, else
        None ('opq' = PQ behind a learned OPQ rotation, ops/opq.py —
        the reference's 'OPQ<M>,...' factory pre-transform)."""
        import re
        m = re.fullmatch(r"(o?)pq(\d+)", dtype_name)
        return int(m.group(2)) if m else None

    @staticmethod
    def _pq_rotate(dtype_name: str) -> bool:
        """True for the OPQ dtype variants ('opq<M>')."""
        import re
        m = re.fullmatch(r"(o?)pq(\d+)", dtype_name)
        return bool(m and m.group(1))

    def _pq_grid(self):
        """(m, d_codec, perm) of the 'code' tier's PQ codec grid —
        deterministic from the lane-padded dim, so it never needs
        persisting (ops/pq.pq_build_store uses the same construction).
        The OPQ rotation (``self._code_rot``), being learned, DOES
        persist (``code_rot`` in the payload)."""
        from smqtk_indexing_tpu.ops.pq import pq_codec_dim
        m = self._pq_m(self.dtype)
        d_pad = self._centroids_np.shape[1]
        d_codec = pq_codec_dim(d_pad, m)
        perm = np.argsort(np.arange(d_codec) % m,
                          kind="stable").astype(np.int32)
        return m, d_codec, perm

    def _pq_cents_codec(self, rot: Optional[np.ndarray]) -> np.ndarray:
        """(C, d_codec) float32 centroids in the full codec transform
        space (interleave + optional OPQ rotation) — the residual
        codec's reference frame. The rot=None form is cached (the
        descriptor-set repopulation path calls _row_vector per row;
        rebuilding the table each call is O(C*d) per row)."""
        if rot is None and self._cents_codec_cache is not None:
            return self._cents_codec_cache
        from smqtk_indexing_tpu.ops.device import pad_rows_np
        _, d_codec, perm = self._pq_grid()
        c = pad_rows_np(self._centroids_np.astype(np.float32),
                        self._centroids_np.shape[0], d_codec)[:, perm]
        if rot is not None:
            return np.ascontiguousarray(c @ rot)
        self._cents_codec_cache = c
        return c

    def _pq_prep_rows(self, mat: np.ndarray,
                      rotate: bool = True) -> np.ndarray:
        """Float rows -> codec-grid (n, d_codec) interleaved (and, when
        the OPQ rotation is trained and ``rotate``, rotated) float32."""
        from smqtk_indexing_tpu.ops.device import pad_rows_np
        _, d_codec, perm = self._pq_grid()
        rows_c = pad_rows_np(np.asarray(mat, np.float32),
                             mat.shape[0], d_codec)[:, perm]
        if rotate and self._code_rot is not None:
            rows_c = rows_c @ self._code_rot
        return rows_c

    def _make_mesh(self):
        """Row-shard the list-sorted database over a device mesh (lists
        split at shard boundaries become per-shard CSR views — see
        parallel/sharded_ivf.py)."""
        if self.n_devices is None or self.n_devices <= 1:
            return None
        from smqtk_indexing_tpu.parallel.mesh import make_mesh
        return make_mesh(self.n_devices)

    def _reset_state(self) -> None:
        # Host source of truth (sorted-by-list order).
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None        # (n, d) f32 sorted
        self._valid_host: Optional[np.ndarray] = None  # (n,) bool
        self._row2uid: List[Hashable] = []
        self._uid2row: Dict[Hashable, int] = {}
        self._assign_host: Optional[np.ndarray] = None  # (n,) int32 list ids
        self._n_live = 0
        self._centroids_np: Optional[np.ndarray] = None  # (C, d) f32
        # Device side.
        self._dev = None
        self._dev_sq = None
        self._dev_norm = None
        self._dev_valid = None
        self._dev_centroids = None
        self._dev_offsets = None
        self._dev_lens = None
        self._dev_first_virt = None
        self._capacity = 0
        self._l_max = 0
        self._n_virtual = 0
        self._max_split = 1
        self._mesh = None
        # sq8 codec (trained per build over the live rows)
        self._sq8_a = None
        self._sq8_b = None
        # 'code' tier: host codec (np (dim,) f32 for sq8 / (M, 256, dsub)
        # codebooks for pq; trained ONCE, reused by updates) +
        # tiled-transposed device state.
        self._code_a: Optional[np.ndarray] = None
        self._code_b: Optional[np.ndarray] = None
        self._code_cb: Optional[np.ndarray] = None
        #: OPQ rotation of the code tier's codec (learned once with the
        #: codebooks, persisted as 'code_rot').
        self._code_rot: Optional[np.ndarray] = None
        self._cb_dev = None
        self._perm_dev = None
        self._dev3 = None            # (n_tiles, d_pad, TILE_ROWS) int8
        self._s2t = None             # (n_tiles, 1, TILE_ROWS) f32 (+inf
        self._v_tile = None          #  poisons removed rows)
        self._v_col = None
        self._v_len = None
        self._slot_table = None
        # pq codec (codebooks + the round-robin dim interleave; see
        # ops/store.py for why padding demands the interleave)
        self._pq_cb_dev = None
        self._pq_perm = None
        self._pq_rot = None   # rows-tier OPQ rotation (retrained/build)
        self._dev_centroids_pq = None
        # Residual PQ (pq_residual=True): codec-space centroids + the
        # per-row original-list map for the exact re-rank's centroid add.
        self._cents_codec_dev = None
        self._row2list_dev = None
        self._cents_codec_cache = None   # host (C, d_codec), rot=None

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c.update({
            "metric": self.metric,
            "n_lists": self.n_lists,
            "nprobe": self.nprobe,
            "kmeans_iterations": self.kmeans_iterations,
            "max_points_per_centroid": self.max_points_per_centroid,
            "random_seed": self.random_seed,
            "dtype": self.dtype,
            "storage": self.storage,
            "rerank": self.rerank,
            "read_only": self.read_only,
            "n_devices": self.n_devices,
            "pq_residual": self.pq_residual,
        })
        if self.uid2idx_kvs is not None:
            c["uid2idx_kvs"] = merge_dict(
                c["uid2idx_kvs"], to_config_dict(self.uid2idx_kvs))
        if self.idx2uid_kvs is not None:
            c["idx2uid_kvs"] = merge_dict(
                c["idx2uid_kvs"], to_config_dict(self.idx2uid_kvs))
        return c

    # ------------------------------------------------------------------
    # training + layout
    # ------------------------------------------------------------------
    def _auto_lists(self, n: int) -> int:
        if self.n_lists > 0:
            return self.n_lists
        return min(max(_pow2_at_least(int(np.sqrt(n))), 16), 4096)

    def _prep_for_metric(self, mat: np.ndarray) -> np.ndarray:
        """Cosine cells are trained/assigned on L2-normalized rows so the
        L2 coarse quantizer matches angular neighborhoods."""
        if self.metric == "cosine":
            norms = np.linalg.norm(mat, axis=1, keepdims=True)
            return mat / np.where(norms == 0, 1.0, norms)
        return mat

    def _train_centroids(self, mat: np.ndarray) -> np.ndarray:
        n = mat.shape[0]
        c_count = min(self._auto_lists(n), n)
        rng = np.random.default_rng(self.random_seed)
        train = self._prep_for_metric(mat)
        cap = c_count * self.max_points_per_centroid
        if n > cap:
            sel = rng.choice(n, size=cap, replace=False)
            train = train[sel]
        init = train[rng.choice(train.shape[0], size=c_count,
                                replace=False)]
        # Pad training rows to a chunk-divisible count for the scan.
        t = train.shape[0]
        t_pad = capacity_for(t)
        d_pad = pad_dim(mat.shape[1])
        train_p = pad_rows_np(train, t_pad, d_pad)
        valid = np.zeros(t_pad, dtype=bool)
        valid[:t] = True
        init_p = pad_rows_np(init.astype(np.float32), c_count, d_pad)
        centroids, _ = kmeans_lloyd(
            jnp.asarray(train_p), jnp.asarray(valid), jnp.asarray(init_p),
            n_iter=self.kmeans_iterations)
        LOG.debug("Trained %d IVF centroids on %d rows", c_count, t)
        return np.asarray(centroids)

    def _assign(self, mat: np.ndarray) -> np.ndarray:
        assert self._centroids_np is not None
        d_pad = self._centroids_np.shape[1]
        n = mat.shape[0]
        n_pad = capacity_for(n)
        mat_p = pad_rows_np(self._prep_for_metric(mat), n_pad, d_pad)
        a = kmeans_assign(jnp.asarray(mat_p),
                          jnp.asarray(self._centroids_np))
        return np.asarray(a)[:n].astype(np.int32)

    def _layout(self, mat: np.ndarray, uids: Sequence[Hashable],
                assigns: np.ndarray,
                valid: Optional[np.ndarray] = None) -> None:
        """Sort rows by list id, rebuild CSR offsets, upload to device.

        'code' tier: ``mat`` may arrive as float32 originals (initial
        build — the codec trains here, once) or as int8 codes (re-layout
        after update/removal compaction); the host mirror is ALWAYS the
        int8 codes.
        """
        order = np.argsort(assigns, kind="stable")
        mat = mat[order]
        assigns = assigns[order]
        uids = [uids[i] for i in order]
        if valid is None:
            valid = np.ones(mat.shape[0], dtype=bool)
        else:
            valid = valid[order]

        if self.storage == "code":
            from smqtk_indexing_tpu.models.nn_index import _ivf_code
            self._host = np.ascontiguousarray(
                _ivf_code.encode_rows(self, mat, assigns, valid))
        else:
            self._host = np.ascontiguousarray(mat, dtype=np.float32)
        self._valid_host = valid
        self._row2uid = list(uids)
        self._uid2row = {u: i for i, u in enumerate(uids)
                         if valid[i]}
        self._assign_host = assigns
        self._n_live = int(valid.sum())
        if self.storage == "code":
            self._upload_tiled()
        else:
            self._upload()

    def _upload_tiled(self) -> None:
        """Tiled-transposed ('code' tier) device build (engine:
        models/nn_index/_ivf_code.upload_tiled)."""
        from smqtk_indexing_tpu.models.nn_index import _ivf_code
        _ivf_code.upload_tiled(self)

    def _upload(self) -> None:
        """Rows-tier device build (engine:
        models/nn_index/_ivf_rows.upload_rows)."""
        from smqtk_indexing_tpu.models.nn_index import _ivf_rows
        _ivf_rows.upload_rows(self)
    def _save_index(self) -> None:
        """Persist the payload into the configured index element
        (engine: models/nn_index/_ivf_persist.save_index)."""
        from smqtk_indexing_tpu.models.nn_index import _ivf_persist
        _ivf_persist.save_index(self)
    def _dim_from_descriptor_set(self):
        """True (unpadded) vector width from any stored descriptor, or
        None when the set is empty — legacy-payload dim recovery."""
        for elem in self.descriptor_set.iterdescriptors():
            v = elem.vector()
            if v is not None:
                return int(np.asarray(v).shape[-1])
        return None

    def _load_index(self) -> None:
        """Load + relayout the persisted payload (engine:
        models/nn_index/_ivf_persist.load_index)."""
        from smqtk_indexing_tpu.models.nn_index import _ivf_persist
        _ivf_persist.load_index(self)
    def _row_vector(self, i: int) -> np.ndarray:
        """Float view of host row ``i`` (decodes the code mirror on the
        'code' tier — the only float these rows have; originals are not
        retained at capacity)."""
        if self.storage == "code":
            if self._pq_m(self.dtype) is not None:
                from smqtk_indexing_tpu.ops.pq import pq_decode_np
                _, _, perm = self._pq_grid()
                x_c = pq_decode_np(self._host[i:i + 1], self._code_cb)
                if self._code_rot is not None:
                    x_c = x_c @ self._code_rot.T
                if self.pq_residual:
                    x_c = x_c + self._pq_cents_codec(None)[
                        self._assign_host[i:i + 1]]
                return x_c[0, np.argsort(perm)][:self._dim]
            return (self._host[i].astype(np.float32) * self._code_a
                    + self._code_b)
        return self._host[i]

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._n_live

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _sync_kvs(self) -> None:
        from smqtk_indexing_tpu.models.nn_index._kvs import sync_uid_kvs
        self._kvs_synced = sync_uid_kvs(
            self.uid2idx_kvs, self.idx2uid_kvs, dict(self._uid2row),
            prev=getattr(self, "_kvs_synced", None))

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            uids = list(by_uid.keys())
            mat = np.vstack([by_uid[u].vector() for u in uids]) \
                .astype(np.float32)
            self._dim = int(mat.shape[1])
            # Full build retrains the codec too (FAISS train() semantics).
            self._code_a = self._code_b = self._code_cb = None
            self._code_rot = None
            self._cents_codec_cache = None
            with trace_span("ivf.train"):
                self._centroids_np = self._train_centroids(mat)
            assigns = self._assign(mat)
            self._layout(mat, uids, assigns)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())
            self._sync_kvs()
            self._save_index()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            if self._host is None:
                self._build_index(elems)
                return
            by_uid = {e.uuid(): e for e in elems}
            fresh = [u for u in by_uid if u not in self._uid2row]
            skipped = len(by_uid) - len(fresh)
            if skipped:
                warnings.warn(
                    f"Skipped {skipped} already-indexed descriptor UID(s) "
                    "during update.")
            if fresh:
                new_mat = np.vstack([by_uid[u].vector() for u in fresh]) \
                    .astype(np.float32)
                new_assigns = self._assign(new_mat)
                keep = np.flatnonzero(self._valid_host)
                if self.storage == "code":
                    # Updates encode with the build-time codec (FAISS
                    # quantizer adds never retrain) so the merged mirror
                    # stays codes end to end. Cosine codes carry
                    # unit-sphere rows, matching _layout's build encode.
                    new_mat = self._prep_for_metric(new_mat)
                    if self._pq_m(self.dtype) is not None:
                        from smqtk_indexing_tpu.ops.pq import pq_encode_np
                        rows_c = self._pq_prep_rows(new_mat,
                                                    rotate=False)
                        if self.pq_residual:
                            rows_c = rows_c - self._pq_cents_codec(
                                None)[new_assigns]
                        if self._code_rot is not None:
                            rows_c = rows_c @ self._code_rot
                        new_mat = pq_encode_np(rows_c, self._code_cb)
                    else:
                        from smqtk_indexing_tpu.ops.sq8 import (
                            sq8_encode_np,
                        )
                        new_mat = sq8_encode_np(new_mat, self._code_a,
                                                self._code_b)
                mat = np.concatenate([self._host[keep], new_mat])
                uids = [self._row2uid[i] for i in keep] + fresh
                assigns = np.concatenate(
                    [self._assign_host[keep], new_assigns])
                self._layout(mat, uids, assigns)
                self.descriptor_set.add_many_descriptors(
                    by_uid[u] for u in fresh)
            self._sync_kvs()
            self._save_index()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        with self._model_lock:
            self._guard_read_only()
            uids = list(dict.fromkeys(uids))  # dedupe: see VectorStore
            rows = []
            for u in uids:
                if u not in self._uid2row:
                    raise KeyError(u)
                rows.append(self._uid2row[u])
            for u in uids:
                del self._uid2row[u]
            self._valid_host[rows] = False
            self._n_live -= len(rows)
            if self._n_live == 0:
                centroids = self._centroids_np
                dim = self._dim
                code_ab = (self._code_a, self._code_b, self._code_cb,
                           self._code_rot)
                self._reset_state()
                self._centroids_np = centroids
                self._dim = dim
                (self._code_a, self._code_b, self._code_cb,
                 self._code_rot) = code_ab
            elif self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                keep = np.flatnonzero(self._valid_host)
                self._layout(self._host[keep],
                             [self._row2uid[i] for i in keep],
                             self._assign_host[keep])
            elif self._dev3 is not None:
                # Poison the removed rows' surrogate stats in place: the
                # tiled scan scores s2 - 2<t,u>, so +inf rows can never
                # be selected (no liveness gather exists on this path).
                from smqtk_indexing_tpu.ops.ivf_tiled import TILE_ROWS
                r = np.asarray(rows, dtype=np.int64)
                self._s2t = self._s2t.at[
                    r // TILE_ROWS, 0, r % TILE_ROWS].set(np.inf)
            else:
                valid = np.zeros(self._capacity, dtype=bool)
                valid[:len(self._valid_host)] = self._valid_host
                self._dev_valid = jnp.asarray(valid)
                if self._mesh is not None:
                    from smqtk_indexing_tpu.parallel.mesh import shard_rows
                    self._dev_valid = shard_rows(self._mesh,
                                                 self._dev_valid)
            self.descriptor_set.remove_many_descriptors(uids)
            self._sync_kvs()
            self._save_index()

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        q = np.vstack([d.vector() for d in ds]).astype(np.float32)
        with self._model_lock:
            if self._host is None:
                raise ValueError("No index currently set to query from!")
            d_pad = self._centroids_np.shape[1]
            if q.shape[1] != self._dim:
                raise ValueError(
                    f"Query dim {q.shape[1]} != index dim {self._dim}")
            b = q.shape[0]
            b_pad = _pow2_at_least(b, 8)
            q_p = pad_rows_np(q, b_pad, d_pad)
            if self.storage == "code" and self.metric == "cosine":
                # The code tier's cosine representation is the unit
                # sphere (codes carry normalized rows); queries must
                # match. Zero pad rows stay zero (results discarded).
                nrm = np.linalg.norm(q_p, axis=1, keepdims=True)
                q_p = q_p / np.where(nrm == 0, 1.0, nrm)
            k_eff = min(n, self._n_live)
            k_dev = min(_pow2_at_least(k_eff), self._capacity)
            # FAISS-faithful nprobe (faiss.py:715-749): nprobe counts
            # ORIGINAL lists ranked by centroid distance, and exactly
            # those lists' contents are scanned. The kernels get (a) a
            # virtual probe-slot BUDGET sized for the worst case — n
            # original lists can split into up to n * _max_split sublists
            # (+8 absorbs exact centroid-score ties, pow2-rounded to bound
            # jit recompiles) — and (b) nprobe_orig + a representative
            # slot per original, from which they derive the n-th-best
            # original score and zero out every budget slot beyond the
            # eligible lists (ops/ivf.probe_eligibility). nprobe >= n_lists is
            # exhaustive: probe every virtual list (exact, the contract
            # tests rely on it).
            if self.nprobe >= self._centroids_np.shape[0]:
                nprobe = self._n_virtual
                nprobe_orig = None
                first_virt = None
            else:
                nprobe_orig = self.nprobe
                first_virt = self._dev_first_virt
                # +1 list of slack: exact centroid-score ties at the
                # threshold admit a superset (probe_eligibility), and a
                # tied list's sublists must still fit the budget.
                nprobe = min(
                    _pow2_at_least(
                        (self.nprobe + 1) * self._max_split + 8),
                    self._n_virtual)
            COUNTERS.add("ivf.queries", b)
            # Faithful semantics: count ORIGINAL lists actually scanned
            # (budget slots beyond the eligible lists scan nothing).
            n_orig_probed = nprobe_orig if nprobe_orig is not None \
                else self._centroids_np.shape[0]
            COUNTERS.add("ivf.probed_lists", b * n_orig_probed)
            # Mean-list-length ESTIMATE (probed lists skew larger than
            # average on clustered data; exact counts would need a
            # device round-trip per query batch).
            COUNTERS.add(
                "ivf.candidates_scanned_est",
                b * n_orig_probed
                * max(self._n_live // max(self._centroids_np.shape[0], 1),
                      1))
            # No removed rows -> the kernels skip the per-row liveness
            # gather (large and scattered at high probe budgets).
            has_dead = not bool(self._valid_host.all())
            from smqtk_indexing_tpu.models.nn_index import (
                _ivf_code, _ivf_rows,
            )
            res = _ivf_code.query_tiled(self, q_p, k_dev)
            if res is None:
                res = _ivf_rows.query_rows(
                    self, q_p, k_dev, nprobe, first_virt, nprobe_orig,
                    has_dead)
            dists, rows = res
            dists = np.asarray(dists)[:b, :k_eff]
            rows = np.asarray(rows)[:b, :k_eff]
            # Unfilled slots (not enough candidates in probed lists)
            # carry row -1; the assembler trims them.
            out = assemble_results(dists, rows, self._row2uid,
                                   self.descriptor_set)
        shortest = min(len(r[0]) for r in out)
        if shortest < n:
            if n > self._n_live:
                warnings.warn(
                    f"Requested {n} neighbors but only {self._n_live} "
                    "are indexed.")
            else:
                warnings.warn(
                    f"Requested {n} neighbors but some queries found only "
                    f"{shortest} in the probed lists; increase nprobe for "
                    "better coverage.")
        return out
