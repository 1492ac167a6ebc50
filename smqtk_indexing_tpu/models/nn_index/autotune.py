"""
Autotuned device nearest-neighbor index — FLANN-wrapper parity.

Capability-parity with the reference's (deprecated)
``FlannNearestNeighborsIndex``
(/root/reference/smqtk_indexing/impls/nn_index/flann.py:27-479): same tuning
surface (``autotune``, ``target_precision`` default 0.95, ``sample_fraction``,
flann.py:55,90-95), same distance methods ('euclidean' | 'hik' |
'chi_square', flann.py:96-100), same update/remove = rebuild-from-cache
semantics (flann.py:360-412).

Device-first re-design: instead of FLANN's kd-tree/k-means autotuner, the
tuner calibrates an IVF (coarse-quantized) index against the exact
exhaustive scan on a held-out sample, picking the smallest ``nprobe`` whose
measured recall@10 meets ``target_precision`` — falling back to the exact
scan when the dataset is small or the metric has no coarse-quantizer form
(hik / chi_square, which the fused exhaustive scan serves exactly at full
speed). FLANN's fork-safety machinery (flann.py:158-161, 247-258) is
unnecessary: device state is process-local immutable arrays and rebuilds are
explicit.
"""
from __future__ import annotations

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
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex
from smqtk_indexing_tpu.ops.store import VectorStore

LOG = logging.getLogger(__name__)

VALID_DISTANCES = ("euclidean", "hik", "chi_square", "cosine",
                   "inner_product")

#: Below this many rows the exhaustive scan is unconditionally faster than
#: any coarse quantization (one matrix pass over <= a few MB).
_MIN_ROWS_FOR_IVF = 4096


class AutotunedNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Exact-or-calibrated-approximate kNN with a FLANN-style tuning surface.

    :param descriptor_set: Backing descriptor element storage.
    :param index_element: Optional DataElement persisting index state.
    :param autotune: When True (and the metric supports coarse
        quantization), calibrate an IVF engine to the requested precision;
        when False, serve exact exhaustive scans.
    :param target_precision: Desired recall@10 vs exact search in [0, 1]
        (reference default 0.95, flann.py:55).
    :param sample_fraction: Fraction of the indexed data used as calibration
        queries (reference flann.py:90-95).
    :param distance_method: 'euclidean' | 'hik' | 'chi_square' | 'cosine' |
        'inner_product'.
    :param random_seed: Calibration sampling / k-means seed.
    :param read_only: Refuse mutations when True.
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
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "AutotunedNearestNeighborsIndex":
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
        return super().from_config(cfg, False)

    def __init__(
        self,
        descriptor_set: Optional[DescriptorSet] = None,
        index_element: Optional[DataElement] = None,
        autotune: bool = False,
        target_precision: float = 0.95,
        sample_fraction: float = 0.1,
        distance_method: str = "euclidean",
        random_seed: Optional[int] = None,
        read_only: bool = False,
    ):
        super().__init__()
        if distance_method not in VALID_DISTANCES:
            raise ValueError(
                f"distance_method must be one of {VALID_DISTANCES}, got "
                f"{distance_method!r}")
        if not (0.0 < target_precision <= 1.0):
            raise ValueError("target_precision must be in (0, 1].")
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.autotune = bool(autotune)
        self.target_precision = float(target_precision)
        self.sample_fraction = float(sample_fraction)
        self.distance_method = distance_method
        self.random_seed = random_seed
        self.read_only = bool(read_only)

        self._model_lock = threading.RLock()
        self._store = VectorStore()
        self._ivf: Optional[IvfNearestNeighborsIndex] = None
        self._tuned_nprobe: Optional[int] = None
        self._load_index()

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c.update({
            "autotune": self.autotune,
            "target_precision": self.target_precision,
            "sample_fraction": self.sample_fraction,
            "distance_method": self.distance_method,
            "random_seed": self.random_seed,
            "read_only": self.read_only,
        })
        return c

    # ------------------------------------------------------------------
    # persistence (exact store only; the IVF engine re-tunes on load)
    # ------------------------------------------------------------------
    def _save_index(self) -> None:
        if self.index_element is None:
            return
        if self.index_element.is_read_only():
            raise ReadOnlyError(
                f"Index element {self.index_element} is read-only.")
        self.index_element.set_bytes(self._store.to_bytes())

    def _load_index(self) -> None:
        if self.index_element is None or self.index_element.is_empty():
            return
        self._store.from_bytes(self.index_element.get_bytes())
        if self.descriptor_set.count() != self._store.n_valid:
            from smqtk_indexing_tpu.data.descriptor import (
                DescriptorMemoryElement,
            )
            LOG.warning(
                "Descriptor set size (%d) disagrees with loaded index "
                "(%d); repopulating.", self.descriptor_set.count(),
                self._store.n_valid)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(
                DescriptorMemoryElement(u, self._store.vector(u))
                for u in self._store.uids())
        self._maybe_tune()

    # ------------------------------------------------------------------
    # autotuning
    # ------------------------------------------------------------------
    def _maybe_tune(self) -> None:
        """(Re)calibrate the approximate engine for the current contents."""
        self._ivf = None
        self._tuned_nprobe = None
        n = self._store.n_valid
        if not self.autotune or self.target_precision >= 1.0:
            return
        if self.distance_method not in ("euclidean", "cosine",
                                        "inner_product"):
            LOG.info(
                "Metric %r has no coarse-quantizer form; serving exact "
                "exhaustive scans (already the fast path on the device).",
                self.distance_method)
            return
        if n < _MIN_ROWS_FOR_IVF:
            LOG.info(
                "Only %d rows; exhaustive scan is faster than coarse "
                "quantization below %d rows.", n, _MIN_ROWS_FOR_IVF)
            return

        uids = self._store.uids()
        mat = np.vstack([self._store.vector(u) for u in uids])
        # Index the caller's own element objects so query results hand back
        # the originals, not copies.
        elems = list(self.descriptor_set.get_many_descriptors(uids))
        ivf_metric = "inner_product" if self.distance_method \
            == "inner_product" else self.distance_method
        ivf = IvfNearestNeighborsIndex(
            metric=ivf_metric, random_seed=self.random_seed)
        ivf.build_index(elems)

        # Calibration queries: a sample of the data itself; ground truth
        # from the exact store.
        rng = np.random.default_rng(self.random_seed)
        n_cal = int(min(max(32, n * self.sample_fraction), 512))
        sel = rng.choice(n, size=n_cal, replace=False)
        k = 10
        _, true_uid_lists, _ = self._store.knn(
            mat[sel], k, metric=self._store_metric())
        truth = [set(u) for u in true_uid_lists]

        n_lists = ivf._centroids_np.shape[0]
        chosen = None
        nprobe = 1
        while nprobe <= n_lists:
            ivf.nprobe = nprobe
            results = ivf.nn_many([elems[i] for i in sel], k)
            hits = sum(
                len({e.uuid() for e in res} & t) / max(len(t), 1)
                for (res, _), t in zip(results, truth))
            recall = hits / n_cal
            LOG.debug("Autotune: nprobe=%d recall@%d=%.4f", nprobe, k,
                      recall)
            if recall >= self.target_precision:
                chosen = nprobe
                break
            nprobe *= 2
        if chosen is None or chosen >= n_lists:
            LOG.info("Autotune could not beat exhaustive scan (needed "
                     "nprobe ~= n_lists); serving exact scans.")
            return
        ivf.nprobe = chosen
        self._ivf = ivf
        self._tuned_nprobe = chosen
        LOG.info("Autotuned IVF engine: %d lists, nprobe=%d for "
                 "target_precision=%.2f", n_lists, chosen,
                 self.target_precision)

    def _store_metric(self) -> str:
        return self.distance_method

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            uids = list(by_uid.keys())
            mat = np.vstack([by_uid[u].vector() for u in uids]) \
                .astype(np.float32)
            store = VectorStore()
            store.build(mat, uids)
            self._store = store
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())
            self._maybe_tune()
            self._save_index()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            fresh = [u for u in by_uid if not self._store.has_uid(u)]
            skipped = len(by_uid) - len(fresh)
            if skipped:
                warnings.warn(
                    f"Skipped {skipped} already-indexed descriptor UID(s) "
                    "during update.")
            if fresh:
                mat = np.vstack([by_uid[u].vector() for u in fresh]) \
                    .astype(np.float32)
                self._store.add(mat, fresh)
                self.descriptor_set.add_many_descriptors(
                    by_uid[u] for u in fresh)
                self._maybe_tune()
            self._save_index()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            self._store.remove(uids)
            self.descriptor_set.remove_many_descriptors(uids)
            self._maybe_tune()
            self._save_index()

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        with self._model_lock:
            if self._ivf is not None:
                return self._ivf._nn_many(ds, n)
            q = np.vstack([d.vector() for d in ds]).astype(np.float32)
            dists, uid_lists, _ = self._store.knn(
                q, n, metric=self._store_metric())
            out = assemble_results_from_uids(dists, uid_lists,
                                             self.descriptor_set)
        shortest = min(len(r[0]) for r in out)
        if shortest < n:
            warnings.warn(
                f"Requested {n} neighbors but only {shortest} "
                "are indexed.")
        return out
