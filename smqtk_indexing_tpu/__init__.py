"""
smqtk_indexing_tpu — an accelerator nearest-neighbor index-and-query engine.

Provides the same capability surface as SMQTK-Indexing (reference:
/root/reference/smqtk_indexing/__init__.py:1-3 exports the three interfaces),
re-designed device-first: descriptor matrices and packed hash codes live in
device-resident JAX arrays, every build/query is a jitted XLA/Pallas program,
and host Python only orchestrates and maps UIDs.
"""
from smqtk_indexing_tpu.interfaces.hash_index import HashIndex  # noqa: F401
from smqtk_indexing_tpu.interfaces.lsh_functor import LshFunctor  # noqa: F401
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (  # noqa: F401
    NearestNeighborsIndex,
)

__version__ = "0.1.0"
