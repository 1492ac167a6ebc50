"""
Shared engine for the packed-code hash indexes.

Both ``LinearHashIndex`` and ``BallTreeHashIndex`` execute on the same exact
XOR + population_count + fused top-k scan over packed uint32 codes
(ops/hamming.CodeStore) — they differ only in configuration surface (the
reference exposed two impls, linear.py and sklearn_balltree.py, whose
engines genuinely differed on CPU; on the device the exhaustive scan serves both,
see block.py's module docstring). This base holds the shared cache
persistence, mutation, and normalized-Hamming query plumbing so the plugins
stay two distinct config classes without duplicated bodies.
"""
from __future__ import annotations

import logging
import threading
from typing import Iterable, Tuple

import numpy as np

from smqtk_indexing_tpu.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu.interfaces.hash_index import HashIndex
from smqtk_indexing_tpu.ops.hamming import CodeStore

LOG = logging.getLogger(__name__)


class _CodeStoreHashIndex (HashIndex):
    """
    HashIndex backed by a ``CodeStore``; subclasses set ``self.cache_element``
    and may override ``_make_mesh`` before calling ``_init_store()``.
    """

    @classmethod
    def is_usable(cls) -> bool:
        # The shared engine base is not itself a plugin.
        return cls is not _CodeStoreHashIndex

    @classmethod
    def usability_report(cls) -> dict:
        from smqtk_indexing_tpu.ops.device import device_report
        r = super().usability_report()
        r.update(device_report(flags=("SMQTK_TPU_NO_NATIVE",)))
        return r

    def _init_store(self) -> None:
        """Call at the end of subclass ``__init__`` (after config attrs)."""
        self._model_lock = threading.RLock()
        self._store = CodeStore(mesh=self._make_mesh())
        self._load_cache()

    def _make_mesh(self):
        return None

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save_cache(self) -> None:
        if self.cache_element is None:
            return
        if self.cache_element.is_read_only():
            raise ReadOnlyError(
                f"Cache element {self.cache_element} is read-only.")
        self.cache_element.set_bytes(self._store.to_bytes())

    def _load_cache(self) -> None:
        if self.cache_element is None or self.cache_element.is_empty():
            return
        self._store.from_bytes(self.cache_element.get_bytes())
        LOG.debug("Loaded %d hash codes from cache.", self._store.n_valid)

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def _build_index(self, hashes: Iterable[np.ndarray]) -> None:
        with self._model_lock:
            mat = np.vstack([np.asarray(h) for h in hashes]).astype(bool)
            new_store = CodeStore(mesh=self._make_mesh())
            new_store.build(mat)
            self._store = new_store
            self._save_cache()

    def _update_index(self, hashes: Iterable[np.ndarray]) -> None:
        with self._model_lock:
            mat = np.vstack([np.asarray(h) for h in hashes]).astype(bool)
            self._store.add(mat)
            self._save_cache()

    def _remove_from_index(self, hashes: Iterable[np.ndarray]) -> None:
        with self._model_lock:
            mat = np.vstack([np.asarray(h) for h in hashes]).astype(bool)
            self._store.remove(mat)
            self._save_cache()

    def _nn_many(self, hs, n: int = 1):
        hs = np.atleast_2d(np.asarray(hs)).astype(bool)
        with self._model_lock:
            dists, codes = self._store.knn(hs, n)
        bits = hs.shape[1]
        return [(codes[i], tuple(float(d) / bits for d in dists[i]))
                for i in range(hs.shape[0])]

    def _nn(self, h: np.ndarray, n: int = 1
            ) -> Tuple[np.ndarray, Tuple[float, ...]]:
        h = np.asarray(h).astype(bool).reshape(1, -1)
        with self._model_lock:
            dists, codes = self._store.knn(h, n)
        bits = h.shape[1]
        return codes[0], tuple(float(d) / bits for d in dists[0])
