"""
Exhaustive (flat) device nearest-neighbor index.

Capability-parity with the reference's FAISS 'Flat' configuration
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:70-831, default
factory 'IDMap,Flat' at :190) without the C++ delegation: the descriptor
matrix is HBM-resident and every query is one fused scan+top-k XLA program
(ops/scan.py), including the exact re-rank the reference performs on the host
after FAISS returns (faiss.py:818-827).

Metric surface covers the reference's METRIC_* label map (faiss.py:51-67)
with 'euclidean' | 'inner_product' | 'cosine' | 'hik'.
"""
from __future__ import annotations

import json
import logging
import threading
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np

from smqtk_indexing_tpu.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.data.descriptor import (
    DescriptorElement, DescriptorSet, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu.models.nn_index._results import (
    assemble_results_from_uids,
)
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu.ops.scan import METRICS
from smqtk_indexing_tpu.ops.store import VectorStore
from smqtk_indexing_tpu.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)


class FlatNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Brute-force exact kNN over a device-resident descriptor matrix.

    :param descriptor_set: Backing descriptor element storage (defaults to a
        new in-memory set).
    :param index_element: Optional DataElement to persist index state to
        (overwritten on every mutation; auto-loaded at construction).
    :param metric: Distance metric label; one of
        'euclidean' | 'inner_product' | 'cosine' | 'hik'.
    :param dtype: Device storage codec: 'float32' (exact), 'bfloat16'
        (half the memory traffic; tiny recall cost),
        'sq8' (int8 scalar quantization, 4x capacity — the reference's
        FAISS 'SQ8' factory codec, faiss.py:190; see ops/sq8.py),
        'pq<M>' (product quantization, M bytes/vector — e.g. 'pq16' is
        32x capacity at d=128, the FAISS 'PQ16' codec; see ops/pq.py),
        or 'opq<M>' (PQ behind a learned OPQ rotation — the FAISS
        'OPQ<M>,PQ<M>' pre-transform; matmul-form metrics only;
        see ops/opq.py).
    :param read_only: Refuse mutations when True.
    :param storage: 'device' keeps the database HBM-resident (fastest);
        'host_stream' keeps it in host RAM and streams blocks through the
        device per query batch — the beyond-device-memory capacity tier (exact results;
        float32/bfloat16 only).

    >>> import numpy as np
    >>> from smqtk_indexing_tpu.data.descriptor import (
    ...     DescriptorMemoryElement)
    >>> rng = np.random.default_rng(0)
    >>> els = [DescriptorMemoryElement(i, rng.normal(size=8)
    ...        .astype(np.float32)) for i in range(32)]
    >>> index = FlatNearestNeighborsIndex()
    >>> index.build_index(els)
    >>> neighbors, dists = index.nn(els[3], 2)
    >>> neighbors[0].uuid(), round(float(dists[0]), 6)
    (3, 0.0)
    >>> index.remove_from_index([3])
    >>> index.count()
    31
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
        r.update(device_report(flags=("SMQTK_TPU_NO_NATIVE",)))
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
                    ) -> "FlatNearestNeighborsIndex":
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
        dtype: str = "float32",
        read_only: bool = False,
        n_devices: Optional[int] = None,
        storage: str = "device",
        uid2idx_kvs=None,
        idx2uid_kvs=None,
    ):
        super().__init__()
        if metric not in METRICS:
            raise ValueError(
                f"metric must be one of {METRICS}, got {metric!r}")
        if storage not in ("device", "host_stream"):
            raise ValueError(
                "storage must be 'device' (HBM-resident) or "
                f"'host_stream' (>HBM tier), got {storage!r}")
        from smqtk_indexing_tpu.ops.store import _pq_m, _pq_rotate
        if _pq_rotate(dtype) and metric == "hik":
            raise ValueError(
                "metric 'hik' is not supported with OPQ dtypes "
                "(min() is rotation-variant); use 'pq<M>'")
        if metric not in ("euclidean", "inner_product", "cosine", "hik") \
                and (dtype == "sq8" or _pq_m(dtype) is not None):
            # Fail at construction, not at the first query after an
            # expensive build (the compressed scans serve the matmul-form
            # metrics + hik only; ops/sq8.SQ8_METRICS, ops/pq.PQ_METRICS).
            raise ValueError(
                f"metric {metric!r} is not supported with compressed "
                f"dtype {dtype!r}; use float32/bfloat16")
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.metric = metric
        self.dtype = dtype
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self.storage = storage
        # Optional external uid<->idx mirrors (reference layout parity,
        # faiss.py:260-274; see models/nn_index/_kvs.py).
        self.uid2idx_kvs = uid2idx_kvs
        self.idx2uid_kvs = idx2uid_kvs

        self._model_lock = threading.RLock()
        self._store = self._new_store()
        self._load_index()

    def _new_store(self) -> VectorStore:
        if self.storage == "host_stream":
            from smqtk_indexing_tpu.ops.store import HostStreamedVectorStore
            if self.n_devices is not None and self.n_devices > 1:
                raise ValueError(
                    "storage='host_stream' streams through one device; "
                    "combine capacity axes via n_devices OR host "
                    "streaming, not both.")
            return HostStreamedVectorStore(dtype=self.dtype)
        return VectorStore(dtype=self.dtype, mesh=self._make_mesh())

    def _make_mesh(self):
        """Row-shard across a device mesh when multi-device is requested
        (the reference has no distributed path at all — SURVEY.md §2.6;
        this is the slice-scaling design of parallel/)."""
        if self.n_devices is None or self.n_devices <= 1:
            return None
        from smqtk_indexing_tpu.parallel.mesh import make_mesh
        return make_mesh(self.n_devices)

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c["metric"] = self.metric
        c["dtype"] = self.dtype
        c["read_only"] = self.read_only
        c["n_devices"] = self.n_devices
        c["storage"] = self.storage
        if self.uid2idx_kvs is not None:
            c["uid2idx_kvs"] = merge_dict(
                c["uid2idx_kvs"], to_config_dict(self.uid2idx_kvs))
        if self.idx2uid_kvs is not None:
            c["idx2uid_kvs"] = merge_dict(
                c["idx2uid_kvs"], to_config_dict(self.idx2uid_kvs))
        return c

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save_index(self) -> None:
        if self.index_element is None:
            return
        if self.index_element.is_read_only():
            raise ReadOnlyError(
                f"Index element {self.index_element} is read-only.")
        header = json.dumps({"metric": self.metric,
                             "dtype": self.dtype}).encode()
        body = self._store.to_bytes()
        payload = len(header).to_bytes(8, "big") + header + body
        self.index_element.set_bytes(payload)
        LOG.debug("Persisted flat index (%d bytes).", len(payload))

    def _load_index(self) -> None:
        if self.index_element is None or self.index_element.is_empty():
            return
        payload = self.index_element.get_bytes()
        hlen = int.from_bytes(payload[:8], "big")
        header = json.loads(payload[8:8 + hlen].decode())
        self._store.from_bytes(payload[8 + hlen:])
        # Rebuild the descriptor-set side if it disagrees (consistency check
        # mirroring the reference's post-load size validation,
        # /root/reference/smqtk_indexing/impls/nn_index/faiss.py:426-438).
        if self.descriptor_set.count() != self._store.n_valid:
            LOG.warning(
                "Descriptor set size (%d) disagrees with loaded index size "
                "(%d); repopulating descriptor set from index payload.",
                self.descriptor_set.count(), self._store.n_valid)
            from smqtk_indexing_tpu.data.descriptor import (
                DescriptorMemoryElement,
            )
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(
                DescriptorMemoryElement(u, self._store.vector(u))
                for u in self._store.uids()
            )
        if header.get("metric") != self.metric:
            LOG.warning(
                "Loaded index was built with metric %r; instance configured "
                "with %r.", header.get("metric"), self.metric)
        if header.get("dtype") != self.dtype:
            # Symmetric to the metric warning: the payload carries raw
            # floats, so loading re-encodes with THIS instance's codec —
            # distances and memory footprint change silently otherwise.
            LOG.warning(
                "Loaded index was built with dtype %r; instance configured "
                "with %r (rows re-encode with the configured codec).",
                header.get("dtype"), self.dtype)
        self._sync_kvs()

    # ------------------------------------------------------------------
    # index mutation
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _sync_kvs(self) -> None:
        from smqtk_indexing_tpu.models.nn_index._kvs import sync_uid_kvs
        self._kvs_synced = sync_uid_kvs(
            self.uid2idx_kvs, self.idx2uid_kvs, self._store.uid_to_row(),
            prev=getattr(self, "_kvs_synced", None))

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            # Last occurrence of a duplicated UID wins (dict semantics).
            by_uid = {e.uuid(): e for e in elems}
            uids = list(by_uid.keys())
            mat = np.vstack([by_uid[u].vector() for u in uids]) \
                .astype(np.float32)
            new_store = self._new_store()
            new_store.build(mat, uids)
            # Atomic swap once device arrays are ready.
            self._store = new_store
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())
            self._sync_kvs()
            self._save_index()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            fresh = [u for u in by_uid if not self._store.has_uid(u)]
            skipped = len(by_uid) - len(fresh)
            if skipped:
                # Reference semantics: already-indexed UIDs are skipped with
                # a warning (faiss.py:561-642).
                warnings.warn(
                    f"Skipped {skipped} already-indexed descriptor UID(s) "
                    "during update.")
            if fresh:
                mat = np.vstack([by_uid[u].vector() for u in fresh]) \
                    .astype(np.float32)
                self._store.add(mat, fresh)
                self.descriptor_set.add_many_descriptors(
                    by_uid[u] for u in fresh)
            self._sync_kvs()
            self._save_index()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            # KeyError (with no mutation) surfaces from the store pre-check.
            self._store.remove(uids)
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
        with self._model_lock, trace_span("flat.query"):
            COUNTERS.add("flat.queries", len(ds))
            dists, uid_lists, _ = self._store.knn(q, n, metric=self.metric)
            out = assemble_results_from_uids(dists, uid_lists,
                                             self.descriptor_set)
        # Per-query minimum (not just query 0), matching ivf.py/mrpt.py.
        shortest = min((len(o[0]) for o in out), default=n)
        if shortest < n:
            warnings.warn(
                f"Requested {n} neighbors but only {shortest} are indexed.")
        return out
