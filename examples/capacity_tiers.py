"""
The storage-capacity ladder: one index API, five residency tiers.

The reference exposes FAISS codecs through factory strings
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:190); here the
same `dtype` axis composes with device meshes and host streaming:

| tier                 | bytes/dim (d=128) | capacity vs f32 | exact? |
|----------------------|-------------------|-----------------|--------|
| float32 (default)    | 4                 | 1x              | yes    |
| bfloat16             | 2                 | 2x              | ~      |
| sq8                  | 1                 | 4x              | codec  |
| pq16                 | 0.125             | 32x             | codec  |
| storage='host_stream'| host RAM          | unbounded       | yes    |
| n_devices=N (mesh)   | × N devices       | × N             | yes    |

Run: python examples/capacity_tiers.py   (CPU-safe; small shapes)
"""
import numpy as np

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu.models.nn_index.flat import FlatNearestNeighborsIndex


def main() -> None:
    rng = np.random.default_rng(0)
    n, d = 4096, 128
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 64, n)]
          + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    probe = elems[123]

    tiers = [
        ("float32 (exact)", FlatNearestNeighborsIndex()),
        ("bfloat16", FlatNearestNeighborsIndex(dtype="bfloat16")),
        ("SQ8 via factory", index_from_factory_string("IDMap,SQ8")),
        ("PQ16 via factory", index_from_factory_string("PQ16")),
        ("host stream",
         FlatNearestNeighborsIndex(storage="host_stream")),
    ]
    for name, idx in tiers:
        idx.build_index(elems)
        neighbors, dists = idx.nn(probe, 3)
        print(f"{name:>18}: top-3 uids "
              f"{[e.uuid() for e in neighbors]}, d0={dists[0]:.4f}")
        assert neighbors[0].uuid() == 123


if __name__ == "__main__":
    main()
