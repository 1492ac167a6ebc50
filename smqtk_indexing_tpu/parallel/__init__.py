"""
Multi-device scaling layer.

The reference has **no distributed execution of any kind** (SURVEY.md §2.6
parallelism census: host-side ``parallel_map`` thread/process pools and
optional single-host FAISS-GPU offload only). This package is the
framework's first-class replacement for a host of cards joined all to
all: the ``(N, d)`` descriptor matrix (and packed code matrices) shard by
rows across a ``jax.sharding.Mesh``; each device runs the same scan+top-k
program on its shard; a k-sized ``all_gather`` plus an O(devices * k)
merge produces the global result.
"""
from smqtk_indexing_tpu.parallel.mesh import (  # noqa: F401
    SHARD_AXIS, make_mesh, shard_rows,
)
from smqtk_indexing_tpu.parallel.sharded_ivf import (  # noqa: F401
    shard_csr, sharded_ivf_query,
)
from smqtk_indexing_tpu.parallel.sharded_mrpt import (  # noqa: F401
    shard_leaf_tables, sharded_mrpt_query,
)
from smqtk_indexing_tpu.parallel.sharded_scan import (  # noqa: F401
    sharded_flat_topk, sharded_hamming_topk, sharded_kmeans_step,
    sharded_pq_topk, sharded_rerank_topk, sharded_sq8_topk,
)
