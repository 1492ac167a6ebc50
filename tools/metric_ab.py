"""
Same-window metric-axis A/B on the 'code' tier at 1M: euclidean vs
inner_product vs cosine through the SAME tiled list scan (only query
folds / probe selection / finalization switch). Answers two questions on
the card:

1. Is the metric axis free?  The IP fold zeroes the row stats and the
   cosine path is the euclidean pipeline on the unit sphere, so qps
   should be within run-to-run noise of euclidean at every nprobe.
2. What recall does each metric achieve vs its OWN float64 exact oracle
   on the original rows (codec + probing loss together)?

Single process on purpose: cross-metric deltas are only meaningful
same-window.

Run from the repository root: python tools/metric_ab.py
"""
from __future__ import annotations

import json
import time

import numpy as np

N, D, NQ, K = 1_000_000, 96, 128, 10
NPROBES = (4, 16)


def _log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _truth(dbf, queries, metric, db_sq):
    """Float64 exact top-K ids under `metric` over the original rows.

    ``dbf`` is the float64 db converted ONCE by the caller; euclidean uses
    the expanded form ``db_sq - 2*db@q`` (q² is rank-constant) so no
    per-query (N, d) temporary is allocated.
    """
    out = []
    if metric == "cosine":
        dbn = dbf / np.maximum(np.sqrt(db_sq)[:, None], 1e-30)
    for q in queries:
        qf = q.astype(np.float64)
        if metric == "euclidean":
            d = db_sq - 2.0 * (dbf @ qf)
        elif metric == "inner_product":
            d = -(dbf @ qf)
        else:
            d = -(dbn @ (qf / max(np.linalg.norm(qf), 1e-30)))
        out.append(set(np.argsort(d, kind="stable")[:K].tolist()))
    return out


def main() -> None:
    import bench_all
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    db, queries, dataset = bench_all._load_or_make(
        "deep_base.fvecs", N, D, 1.0, seed=2, nq=1024)
    n = db.shape[0]
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    q_recall = [DescriptorMemoryElement(f"q{i}", queries[i])
                for i in range(NQ)]
    q_large = [DescriptorMemoryElement(f"Q{i}", queries[i])
               for i in range(1024)]
    _log(f"dataset={dataset} n={n} d={D}")

    dbf = db.astype(np.float64)
    db_sq = (dbf * dbf).sum(1)
    for metric in ("euclidean", "inner_product", "cosine"):
        truth = _truth(dbf, queries[:NQ], metric, db_sq)
        idx = IvfNearestNeighborsIndex(
            n_lists=4096, kmeans_iterations=6, max_points_per_centroid=64,
            random_seed=0, dtype="sq8", storage="code", rerank="score",
            metric=metric)
        t0 = time.perf_counter()
        idx.build_index(elems)
        _log(f"{metric}: build {time.perf_counter() - t0:.1f}s")
        for nprobe in NPROBES:
            idx.nprobe = nprobe
            res = idx.nn_many(q_recall, K)            # compile + warm
            got = [{e.uuid() for e in r} for r, _ in res]
            recall = float(np.mean([len(g & t) / K
                                    for g, t in zip(got, truth)]))
            idx.nn_many(q_large, K)                   # compile + warm
            t0 = time.perf_counter()
            for _ in range(3):
                idx.nn_many(q_large, K)
            dt = (time.perf_counter() - t0) / 3
            print(json.dumps({
                "metric_axis": metric, "nprobe": nprobe,
                "qps_b1024": round(1024 / dt, 0),
                "recall_at_10": round(recall, 4),
                "dataset": dataset}), flush=True)


if __name__ == "__main__":
    main()
