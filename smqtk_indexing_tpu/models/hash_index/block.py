"""
BallTree-equivalent hash index.

Capability-parity with the reference's ``SkLearnBallTreeHashIndex``
(/root/reference/smqtk_indexing/impls/hash_index/sklearn_balltree.py:33-375):
same constructor surface (``cache_element``, ``leaf_size``, ``random_seed``),
same build-dedup / rebuild-on-update / rebuild-on-remove / normalized-Hamming
``nn`` semantics.

Device-first inversion: a metric ball tree is a pointer-chasing,
data-dependent branch structure — the worst possible shape for a wide
parallel machine. On the device the exhaustive packed XOR + population_count + fused top-k scan
(ops/hamming.py) is both exact and faster than any tree traversal up to very
large N (the scan is memory-bandwidth bound at ~bits/8 bytes per code), so this
implementation intentionally executes on the same engine as LinearHashIndex
(shared base ``_base._CodeStoreHashIndex``). ``leaf_size`` and
``random_seed`` are retained for config-surface parity and are no-ops, as
documented. The two classes remain distinct plugins so configs written
against either reference impl resolve here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from smqtk_indexing_tpu.core.configuration import (
    make_default_config, merge_dict, from_config_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.models.hash_index._base import _CodeStoreHashIndex


class BallTreeHashIndex (_CodeStoreHashIndex):
    """
    Hamming hash index with the reference BallTree configuration surface,
    executing as an exact packed-code scan on the device.

    :param cache_element: Optional DataElement for write-through persistence.
    :param leaf_size: Accepted for parity with the reference's sklearn
        BallTree parameter (sklearn_balltree.py:96-104); the device scan has no
        tree, so this affects nothing and is preserved in config
        round-trips.
    :param random_seed: Accepted for parity; unused (the scan is exact and
        deterministic).
    """

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["cache_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "BallTreeHashIndex":
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
                 leaf_size: int = 40,
                 random_seed: Optional[int] = None):
        super().__init__()
        self.cache_element = cache_element
        self.leaf_size = leaf_size
        self.random_seed = random_seed
        self._init_store()

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        if self.cache_element is not None:
            c["cache_element"] = merge_dict(
                c["cache_element"], to_config_dict(self.cache_element))
        c["leaf_size"] = self.leaf_size
        c["random_seed"] = self.random_seed
        return c
