"""
Headline benchmark (BASELINE.md config 1): exhaustive flat L2 kNN on
SIFT1M-shaped data (1M x 128-d float32, k=10) — the configuration the
reference serves through CPU-FAISS 'IDMap,Flat'
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:190).

Prints TWO JSON lines, headline first:
1. {"metric": "sift1m_flat_l2_knn_qps_b2048_bestof3", ...} — the exact
   flat-scan headline (vs_baseline = host BLAS exhaustive scan).
2. {"metric": "deep1m_ivf4096_sq8_code_score_np4_b1024_qps", ...} — the
   SERVING tier (IVF-4096 SQ8 code storage, rerank='score', nprobe=4,
   B=1024 through the public nn_many path), with recall@10 vs float64
   exact on held-out queries, so codec regressions are visible.

value    = device queries/second through the two-stage exact scan
           (ops/scan.flat_topk_two_stage, the path the store serves on a
           GPU) at batch 2048, database resident in device memory.
baseline = host (numpy/BLAS, this machine) exhaustive scan QPS on the same
           data — the stand-in for CPU-FAISS Flat, which is not installed
           here (BASELINE.json "published": {}). Measured on a 1/8 subsample
           and scaled linearly (exhaustive scan cost is linear in N); the
           scan itself (sgemm + argpartition) is the same work FAISS Flat
           does per query.
"""
from __future__ import annotations

import json
import time

import numpy as np

N = 1_000_000
DIM = 128
K = 10
BATCH = 2048
WARMUP = 2
ITERS = 16
HOST_SUBSAMPLE = N // 8
HOST_ITERS = 3


def _host_scan_qps(db: np.ndarray, q: np.ndarray) -> float:
    """Exhaustive L2 top-k on host BLAS (the CPU-FAISS-Flat stand-in)."""
    db_sq = np.einsum("ij,ij->i", db, db)
    t0 = time.perf_counter()
    for _ in range(HOST_ITERS):
        ip = q @ db.T
        d2 = db_sq[None, :] - 2.0 * ip
        idx = np.argpartition(d2, K, axis=1)[:, :K]
        part = np.take_along_axis(d2, idx, axis=1)
        np.take_along_axis(idx, np.argsort(part, axis=1), axis=1)
    dt = time.perf_counter() - t0
    return HOST_ITERS * q.shape[0] / dt


def main() -> None:
    import jax.numpy as jnp

    from smqtk_indexing_tpu.ops.device import capacity_for
    from smqtk_indexing_tpu.ops.scan import flat_topk_two_stage

    rng = np.random.default_rng(0)
    # SIFT-like: non-negative, roughly uniform magnitude 0..218.
    db = (rng.random((N, DIM), dtype=np.float32) * 218.0)
    q = (rng.random((BATCH, DIM), dtype=np.float32) * 218.0)
    db_sq = np.einsum("ij,ij->i", db, db).astype(np.float32)

    # Pad rows to the store's capacity quantum (chunk-divisible), masking
    # the tail — the same layout VectorStore uploads.
    n_pad = capacity_for(N)
    db_p = np.zeros((n_pad, DIM), dtype=np.float32)
    db_p[:N] = db
    sq_p = np.zeros(n_pad, dtype=np.float32)
    sq_p[:N] = db_sq
    valid_np = np.zeros(n_pad, dtype=bool)
    valid_np[:N] = True

    dev = jnp.asarray(db_p)
    dev_sq = jnp.asarray(sq_p)
    valid = jnp.asarray(valid_np)
    qd = jnp.asarray(q)

    def run(qb):
        return flat_topk_two_stage(dev, dev_sq, valid, qb, k=16)

    # Warmup / compile; results are materialized to host.
    for _ in range(WARMUP):
        d, r = run(qd)
        np.asarray(d)

    # Throughput: pipeline dispatches (serving-style), materialize all;
    # best and median of three windows.
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [run(qd) for _ in range(ITERS)]
        for d, r in outs:
            np.asarray(d)
        dt = time.perf_counter() - t0
        windows.append(ITERS * BATCH / dt)
    dev_qps = max(windows)
    dev_qps_median = sorted(windows)[len(windows) // 2]

    # Sanity: self-queries must return themselves (run once, not timed).
    dd, rr = run(jnp.asarray(db[:BATCH]))
    rr0 = np.asarray(rr)[:, 0]
    assert np.array_equal(rr0, np.arange(BATCH)), "self-query recall failed"

    # Host baseline is load-sensitive (this box runs other work): take
    # the best of five runs — the least-contended sample is the fairest
    # stand-in for a dedicated CPU-FAISS box.
    host_qps_sub = max(_host_scan_qps(db[:HOST_SUBSAMPLE], q)
                       for _ in range(5))
    host_qps = host_qps_sub * HOST_SUBSAMPLE / N

    # Best-of-3 timing windows; the median window is published alongside
    # so the figure is self-describing.
    print(json.dumps({
        "metric": "sift1m_flat_l2_knn_qps_b2048_bestof3",
        "value": round(dev_qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(dev_qps / host_qps, 2),
        "median_window": round(dev_qps_median, 2),
    }), flush=True)

    # Free the flat-scan device arrays before the serving-tier build.
    del dev, dev_sq, valid, qd, run
    serving_metric(host_qps * N)  # host baseline rescales by N below


def serving_metric(host_scan_qps_times_n: float) -> None:
    """Second line: the production serving configuration (docs Config 3a —
    IVF-4096, SQ8 code tier, rerank='score', nprobe=4) on Deep1M-shaped
    data (1M x 96), measured through the PUBLIC ``nn_many`` path at
    B=1024 (best-of-3 windows, as the headline). vs_baseline = host
    exhaustive-scan stand-in rescaled to this N*d (the same comparator the headline uses — CPU-FAISS IVF is
    not installed, BASELINE.json "published": {})."""
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    n_serve, d_serve = 1_000_000, 96
    # Clustered synthetic mixture, same shape/recipe as bench_all's
    # Deep1M stand-in (recall on pure-uniform data is degenerate — every
    # query's true neighbors scatter across arbitrary k-means cells and
    # nprobe=4 recall reads ~0.05 regardless of pipeline quality).
    # Queries are held-out mixture draws, never indexed.
    rng = np.random.default_rng(2)
    n_clusters = 1024
    total = n_serve + 1024
    centers = rng.random((n_clusters, d_serve), dtype=np.float32)
    pts = centers[rng.integers(0, n_clusters, size=total)]
    pts += rng.normal(size=(total, d_serve)).astype(np.float32) / 12
    pts = np.clip(pts, 0, 1).astype(np.float32)[rng.permutation(total)]
    db, queries = pts[:n_serve], pts[n_serve:]

    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n_serve)]
    q_large = [DescriptorMemoryElement(f"Q{i}", queries[i])
               for i in range(1024)]
    nq_r = 128

    idx = IvfNearestNeighborsIndex(
        n_lists=4096, nprobe=4, kmeans_iterations=10,
        max_points_per_centroid=64, random_seed=0, dtype="sq8",
        storage="code", rerank="score")
    t0 = time.perf_counter()
    idx.build_index(elems)
    build_s = time.perf_counter() - t0

    # recall@10 vs float64 exact (expanded form; q^2 is rank-constant)
    dbf = db.astype(np.float64)
    db_sq64 = np.einsum("ij,ij->i", dbf, dbf)
    truth = []
    for i in range(nq_r):
        d2 = db_sq64 - 2.0 * (dbf @ queries[i].astype(np.float64))
        truth.append(set(np.argsort(d2, kind="stable")[:K].tolist()))
    res = idx.nn_many(q_large[:nq_r], K)
    got = [[e.uuid() for e in r] for r, _ in res]
    recall = float(np.mean([len(set(g) & t) / K
                            for g, t in zip(got, truth)]))

    idx.nn_many(q_large, K)  # compile + warm the B=1024 program
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            idx.nn_many(q_large, K)
        windows.append(2 * 1024 / (time.perf_counter() - t0))
    qps = max(windows)

    host_qps = host_scan_qps_times_n / n_serve * (DIM / d_serve)
    print(json.dumps({
        "metric": "deep1m_ivf4096_sq8_code_score_np4_b1024_qps",
        "value": round(qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(qps / host_qps, 2),
        "median_window": round(sorted(windows)[1], 2),
        "recall_at_10": round(recall, 4),
        "build_wall_s": round(build_s, 1),
        "n": n_serve,
    }), flush=True)


if __name__ == "__main__":
    from smqtk_indexing_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
