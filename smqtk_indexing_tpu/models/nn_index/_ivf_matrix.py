"""
The supported IVF configuration matrix and its single enforcement point.

Imported (and re-exported) by models/nn_index/ivf.py; the matrix table
below is THE authority for which (metric x dtype x storage x rerank x
devices x residual) cells exist — cells not rejected here are built and
queried by tests/impls/nn_index/test_ivf_combinations.py.
"""
from __future__ import annotations

from smqtk_indexing_tpu.ops.ivf import METRICS


def _is_pq_dtype(dtype: str) -> bool:
    import re
    return bool(re.fullmatch(r"o?pq\d+", dtype))


#: The supported IVF configuration matrix — the single authority for
#: which (metric x dtype x storage x rerank x devices x residual) cells
#: exist, enforced at construction so no constraint is discoverable only
#: by reading kernel wrappers. Cells not rejected here are built and
#: queried by tests/impls/nn_index/test_ivf_combinations.py.
#:
#: storage='rows' (float32 host mirror, exact re-rank semantics):
#:   dtype     metric                          devices   notes
#:   float32   euclidean/inner_product/cosine  1..N
#:   bfloat16  euclidean/inner_product/cosine  1..N
#:   sq8       euclidean/inner_product/cosine  1..N      row-major XLA
#:             list scan (ops/ivf.ivf_query)
#:   pq/opq<M> euclidean/inner_product/cosine  1..N      XLA grouped
#:             dequant list scan (ops/ivf.ivf_query_pq)
#:   pq/opq<M> +pq_residual: euclidean only, 1..N (row2list row-shards
#:             with the codes; codec-space centroids replicate)
#: storage='code' (int8/uint8 code host mirror — the capacity tier):
#:   dtype     metric                          devices   notes
#:   sq8       euclidean/inner_product/cosine  1..N      tiled list scan;
#:             sharded via parallel/sharded_ivf_code.py. inner_product
#:             zeroes the row stats (the kernel score becomes exactly
#:             -<q, x_hat - b>); cosine encodes L2-NORMALIZED rows and
#:             normalizes queries (euclidean pipeline == cosine ranking
#:             on the unit sphere)
#:   pq/opq<M> euclidean/inner_product/cosine  1..N      tiled ADC scan
#:             (per-code table lookups; the table is a pure IP either
#:             way)
#:   pq/opq<M> +pq_residual: euclidean OR cosine, 1..N (row2list
#:             row-shards with the tiles; res-centroids replicate).
#:             Cosine residual = the euclidean residual pipeline over
#:             the unit-sphere codes (rows normalized at encode,
#:             queries at serve) — rows-tier residual stays euclidean
#:             (its codes carry raw rows)
#: rerank: 'exact' everywhere; 'score' changes behavior only on the
#:   tiled serving path (the code tier) — on every other path distances are already exact, so 'score' is a
#:   no-op there by construction, never an error.
def validate_ivf_combination(metric: str, dtype: str, storage: str,
                             rerank: str, n_devices, pq_residual: bool
                             ) -> None:
    """Reject unsupported IVF configuration cells with an explanation.

    Raises ValueError on: unknown metric/dtype/storage/rerank values;
    storage='code' with a float dtype or a metric outside
    euclidean/inner_product/cosine; pq_residual with a non-PQ dtype or
    non-euclidean metric.
    """
    if metric not in METRICS:
        raise ValueError(
            f"metric must be one of {METRICS}, got {metric!r}")
    if dtype not in ("float32", "bfloat16", "sq8") \
            and not _is_pq_dtype(dtype):
        raise ValueError(
            "dtype must be 'float32' | 'bfloat16' | 'sq8' | 'pq<M>' "
            f"| 'opq<M>', got {dtype!r}")
    if storage not in ("rows", "code"):
        raise ValueError(
            f"storage must be 'rows' | 'code', got {storage!r}")
    if rerank not in ("exact", "score"):
        raise ValueError(
            f"rerank must be 'exact' | 'score', got {rerank!r}")
    if pq_residual:
        if not _is_pq_dtype(dtype):
            raise ValueError(
                "pq_residual requires a PQ dtype ('pq<M>'/'opq<M>'), "
                f"got {dtype!r}")
        if metric == "cosine":
            if storage != "code":
                raise ValueError(
                    "pq_residual with metric='cosine' requires "
                    "storage='code' (the code tier's codes carry "
                    "L2-NORMALIZED rows, so the L2 residual pipeline is "
                    "cosine ranking on the unit sphere; the rows tier's "
                    "codes carry raw rows)")
        elif metric != "euclidean":
            raise ValueError(
                "pq_residual serves euclidean (any storage) or cosine "
                "(storage='code'); inner_product has no L2 probe-score "
                "decomposition for the per-probe -2<q,c> term")
    if storage == "code":
        if dtype != "sq8" and not _is_pq_dtype(dtype):
            raise ValueError(
                "storage='code' (code-resident capacity tier) requires "
                f"dtype='sq8', 'pq<M>' or 'opq<M>', got {dtype!r}")
        if metric not in ("euclidean", "inner_product", "cosine"):
            raise ValueError(
                "storage='code' serves euclidean, inner_product or "
                f"cosine (no matmul surrogate exists for {metric!r})")
