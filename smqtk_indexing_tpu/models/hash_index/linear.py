"""
Brute-force Hamming-distance hash index, device edition.

Capability-parity with the reference's ``LinearHashIndex``
(/root/reference/smqtk_indexing/impls/hash_index/linear.py:28-244) which keeps
a ``set[int]`` of arbitrary-precision codes and heap-scans with a Python
popcount. Here the unique codes live on-device as a packed ``(N, bits/32)``
uint32 matrix and a query is one fused XOR + population_count + top-k program
(ops/hamming.py). Distances returned are normalized by the query bit length
into [0, 1] (reference linear.py:243). Shared engine plumbing lives in
``_base._CodeStoreHashIndex``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from smqtk_indexing_tpu.core.configuration import (
    make_default_config, merge_dict, from_config_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.models.hash_index._base import _CodeStoreHashIndex


class LinearHashIndex (_CodeStoreHashIndex):
    """
    Exhaustive Hamming search over unique hash codes.

    :param cache_element: Optional DataElement to persist index state to
        (write-through on every mutation; auto-loaded at construction —
        reference cache semantics, linear.py:121-142).
    """

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["cache_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "LinearHashIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        ce = cfg.get("cache_element")
        if ce and ce.get("type"):
            cfg["cache_element"] = from_config_dict(
                ce, DataElement.get_impls())
        else:
            cfg["cache_element"] = None
        return super().from_config(cfg, False)

    def __init__(self, cache_element: Optional[DataElement] = None,
                 n_devices: Optional[int] = None):
        """
        :param n_devices: Row-shard the packed codes across this many
            devices (per-shard scan + all-gather merge); None = single
            device.
        """
        super().__init__()
        self.cache_element = cache_element
        self.n_devices = n_devices
        self._init_store()

    def _make_mesh(self):
        if self.n_devices is None or self.n_devices <= 1:
            return None
        from smqtk_indexing_tpu.parallel.mesh import make_mesh
        return make_mesh(self.n_devices)

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        if self.cache_element is not None:
            c["cache_element"] = merge_dict(
                c["cache_element"], to_config_dict(self.cache_element))
        c["n_devices"] = self.n_devices
        return c
