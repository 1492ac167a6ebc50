"""
Full benchmark table for the BASELINE.md configurations. Prints one JSON
line per measurement (bench.py remains the single-line headline the driver
consumes).

Methodology (round-2 rework): queries are HELD OUT — drawn from the same
distribution as the database but never inserted (or read from the TexMex
``*_query.fvecs`` file when present) — and ground truth is the chunked
float64 exact scan. Recall curves are therefore real tradeoff curves: the
cheap end of each sweep sits well below 1.0 and rises monotonically with
probe effort.

Configs (synthetic data at the published shapes — this environment has no
network egress and no real corpora on disk, recorded in BASELINE.md; on a
connected machine drop the TexMex .fvecs files in $SMQTK_TPU_DATA and
every config switches to them via native.read_vecs — column `dataset`
says which was used):

1. Exhaustive flat L2, SIFT1M-shaped (1M x 128): exact QPS (see bench.py).
2. ItqFunctor 128-bit + Hamming engines, SIFT1M-shaped: ITQ fit wall time,
   batched hash throughput, Hamming lookup p50, and LSH-style recall@10 vs
   candidate-pool size.
3. IVF (4096 lists), Deep1M-shaped (1M x 96): nprobe sweep recall@10 + QPS.
4. MRPT, GIST1M-shaped (256K x 960): build time, trees/depth sweep
   recall@10 + QPS.
5. Sharded flat over an 8-device mesh: exercised functionally by
   __graft_entry__.dryrun_multichip (no multi-chip hardware here).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

N_QUERIES = 128


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _load_or_make(name: str, n: int, d: int, scale: float, seed: int,
                  nq: int = N_QUERIES, rank: int = None):
    """
    :return: (db (n, d) float32, queries (nq, d) float32, dataset label).
        Queries are held out: the TexMex query file when available, else
        fresh draws from the same synthetic mixture (never indexed).
    """
    data_dir = os.environ.get("SMQTK_TPU_DATA", "")
    path = os.path.join(data_dir, name) if data_dir else ""
    # rank-controlled sections measure a SPECIFIC synthetic regime (the
    # correlated recall ladder) — a real corpus must not silently
    # substitute for it under the same metric label.
    if path and os.path.isfile(path) and rank is None:
        from smqtk_indexing_tpu import native
        db = native.read_vecs(path, n, d)
        qpath = path.replace("_base.", "_query.").replace("base.", "query.")
        if os.path.isfile(qpath) and qpath != path:
            q = native.read_vecs(qpath, nq, d)
        else:  # hold out the tail of the base file
            q, db = db[-nq:], db[:-nq]
        return db, q[:nq], name
    rng = np.random.default_rng(seed)
    # Clustered synthetic mixture (recall on pure-uniform data is
    # degenerate); queries are INDEPENDENT draws from the same mixture —
    # never copies of database points — so partial-probe recall < 1.
    n_clusters = 1024
    total = n + nq
    if rank is not None:
        # Correlated flavor: the cluster mixture lives in a rank-`rank`
        # latent subspace mixed through a random linear map (the
        # descriptor-like regime where the OPQ rotation matters; iid-dim
        # mixtures are PQ/OPQ-adversarial by construction).
        lat = rng.random((n_clusters, rank), dtype=np.float32) * scale
        w = rng.standard_normal((rank, d)).astype(np.float32) \
            / np.sqrt(rank)
        z = lat[rng.integers(0, n_clusters, size=total)]
        z += rng.normal(size=(total, rank)).astype(np.float32) \
            * (scale / 12)
        pts = (z @ w + rng.normal(size=(total, d)).astype(np.float32)
               * (scale / 50)).astype(np.float32)
        pts = pts[rng.permutation(total)]
        return pts[:n], pts[n:], f"synthetic-rank{rank}"
    centers = rng.random((n_clusters, d), dtype=np.float32) * scale
    pts = centers[rng.integers(0, n_clusters, size=total)]
    pts += rng.normal(size=(total, d)).astype(np.float32) * (scale / 12)
    pts = np.clip(pts, 0, scale).astype(np.float32)
    perm = rng.permutation(total)
    pts = pts[perm]
    return pts[:n], pts[n:], "synthetic"


def _recall_at_10(got_ids, true_ids) -> float:
    return float(np.mean([
        len(set(g[:10]) & set(t[:10])) / 10.0
        for g, t in zip(got_ids, true_ids)]))


def _exact_ground_truth(db, queries, k=10, chunk=100_000):
    """Chunked float64 exact top-k on host (no (Q, N, d) materialization)."""
    q64 = queries.astype(np.float64)
    q_sq = (q64 ** 2).sum(1)[:, None]
    best = None
    for lo in range(0, db.shape[0], chunk):
        x = db[lo:lo + chunk].astype(np.float64)
        d2 = q_sq + (x ** 2).sum(1)[None, :] - 2.0 * (q64 @ x.T)
        ids = np.argsort(d2, axis=1)[:, :k] + lo
        vals = np.take_along_axis(d2, ids - lo, axis=1)
        if best is None:
            best = (vals, ids)
        else:
            cv = np.concatenate([best[0], vals], axis=1)
            ci = np.concatenate([best[1], ids], axis=1)
            sel = np.argsort(cv, axis=1)[:, :k]
            best = (np.take_along_axis(cv, sel, axis=1),
                    np.take_along_axis(ci, sel, axis=1))
    return best[1]


def bench_itq_linear() -> None:
    import jax.numpy as jnp

    from smqtk_indexing_tpu.ops.hamming import hamming_topk
    from smqtk_indexing_tpu.ops.itq import hash_batch, itq_fit
    from smqtk_indexing_tpu.utils.bits import pack_bit_vectors_u32

    n, d, bits = 1_000_000, 128, 128  # ITQ requires bits <= d; SIFT is 128-d
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=0)
    n = db.shape[0]
    fit_sample = db[np.random.default_rng(0).choice(n, 100_000,
                                                    replace=False)]

    # ITQ fit (100K sample, 50 iterations — the reference default).
    rng = np.random.default_rng(0)
    r_init = rng.standard_normal((bits, bits)).astype(np.float32)
    t0 = time.perf_counter()
    mean_vec, rotation = itq_fit(jnp.asarray(fit_sample),
                                 jnp.asarray(r_init), bits=bits, n_iter=50)
    np.asarray(mean_vec)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean_vec, rotation = itq_fit(jnp.asarray(fit_sample),
                                 jnp.asarray(r_init), bits=bits, n_iter=50)
    np.asarray(mean_vec)
    fit_s = time.perf_counter() - t0
    emit(metric="itq128_fit_100k_wall", value=round(fit_s, 2), unit="s",
         cold_incl_compile_s=round(cold_s, 2), dataset=dataset,
         note="target < 60s (BASELINE.md)")

    # Batched hashing throughput (1M codes; warm-timed).
    dev_db = jnp.asarray(db)
    codes = np.asarray(hash_batch(dev_db, mean_vec, rotation))
    t0 = time.perf_counter()
    codes = np.asarray(hash_batch(dev_db, mean_vec, rotation))
    hash_s = time.perf_counter() - t0
    emit(metric="itq128_hash_1m_throughput",
         value=round(n / hash_s, 0), unit="vectors/s", dataset=dataset)

    # Hamming lookup over 1M codes: the ±1 bf16 matmul engine — exact
    # (d^2 between ±1 vectors = 4 * hamming); see ops/hamming.py.
    from smqtk_indexing_tpu.ops.scan import flat_topk_two_stage
    n_pad = 1 << 20
    b = 1024
    bits_pad = bits  # 128 bits: already a multiple of 128
    pm1 = np.zeros((n_pad, bits_pad), dtype=np.float32)
    pm1[:n] = codes * 2.0 - 1.0
    sqv = np.zeros(n_pad, dtype=np.float32)
    sqv[:n] = float(bits)
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    dev_pm1 = jnp.asarray(pm1, dtype=jnp.bfloat16)
    dev_sqv = jnp.asarray(sqv)
    dev_valid = jnp.asarray(valid)
    q_pm1 = jnp.asarray(pm1[:b].astype(np.float32))
    dd, rr = flat_topk_two_stage(dev_pm1, dev_sqv, dev_valid, q_pm1, k=16)
    np.asarray(dd)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        dd, rr = flat_topk_two_stage(dev_pm1, dev_sqv, dev_valid, q_pm1,
                                     k=16)
        np.asarray(dd)
        lat.append(time.perf_counter() - t0)
    p50 = sorted(lat)[len(lat) // 2]
    emit(metric="hamming128_1m_lookup_p50_b1024",
         value=round(p50 * 1e3, 2), unit="ms",
         qps=round(b / p50, 0), engine="pm1", dataset=dataset)
    assert int(np.asarray(rr)[0, 0]) == 0  # self-code found

    # Reference engine comparison: XOR + popcount path.
    packed = pack_bit_vectors_u32(codes)
    packed_p = np.zeros((n_pad, packed.shape[1]), dtype=np.uint32)
    packed_p[:n] = packed
    dev = jnp.asarray(packed_p)
    qcodes = jnp.asarray(packed[:b])
    dd2, rr2 = hamming_topk(dev, dev_valid, qcodes, k=16)
    np.asarray(dd2)
    t0 = time.perf_counter()
    dd2, rr2 = hamming_topk(dev, dev_valid, qcodes, k=16)
    np.asarray(dd2)
    xor_ms = (time.perf_counter() - t0) * 1e3
    emit(metric="hamming128_1m_lookup_xor_engine_b1024",
         value=round(xor_ms, 2), unit="ms", qps=round(b / xor_ms * 1e3, 0),
         dataset=dataset)
    # Both engines agree exactly.
    assert np.array_equal(
        np.asarray(dd2),
        np.round((np.asarray(dd) ** 2) / 4.0).astype(np.int32))

    # LSH-style recall@10 of hash-then-exact-rerank vs float64 truth,
    # swept over the candidate-pool size (held-out queries).
    nq = queries.shape[0]
    truth = _exact_ground_truth(db, queries)
    q_codes = np.asarray(hash_batch(jnp.asarray(queries), mean_vec,
                                    rotation))
    q_pm1_r = (q_codes * 2.0 - 1.0).astype(np.float32)
    for pool in (64, 256, 512, 2048):
        dd, rr = flat_topk_two_stage(dev_pm1, dev_sqv, dev_valid,
                                     jnp.asarray(q_pm1_r), k=pool)
        np.asarray(dd)
        t0 = time.perf_counter()
        dd, rr = flat_topk_two_stage(dev_pm1, dev_sqv, dev_valid,
                                     jnp.asarray(q_pm1_r), k=pool)
        cand = np.asarray(rr)
        ham_s = time.perf_counter() - t0
        got = []
        for qi in range(nq):
            c = cand[qi][cand[qi] >= 0]
            vecs = db[c]
            dist = ((vecs - queries[qi]) ** 2).sum(1)
            got.append(c[np.argsort(dist)][:10])
        emit(metric=f"itq128_hamming_rerank_pool{pool}_recall_at_10",
             value=round(_recall_at_10(got, truth), 4), unit="recall",
             hamming_qps=round(nq / ham_s, 0), dataset=dataset,
             note="held-out queries; exact re-rank of the pool")


#: bench_ivf variant tags -> (dtype, storage, rerank, build_env).
_IVF_VARIANTS = {
    "": ("float32", "rows", "exact", {}),
    # rows-sq8: float32 mirror, row-major int8 codes, exact re-rank.
    "_sq8": ("sq8", "rows", "exact", {}),
    "_sq8_score": ("sq8", "rows", "score", {}),
    # rows-pq16: float32 mirror, XLA grouped-probe dequant scan.
    "_pq16": ("pq16", "rows", "exact", {}),
    # The code tier (int8 host mirror + tiled-transposed list scan
    # through the public API).
    "_code": ("sq8", "code", "exact", {}),
    "_code_score": ("sq8", "code", "score", {}),
    # PQ16 code tier: (n, 16) uint8 mirror, per-code ADC table lookups
    # (16 B/vector).
    "_code_pq16": ("pq16", "code", "exact", {}),
    "_code_pq16_score": ("pq16", "code", "score", {}),
    # OPQ16: the same 16 B/vector behind a learned rotation (the
    # reference's 'OPQ16,IVF4096,PQ16' pre-transform) — the recall
    # lever for PQ-adversarial (near-iid-dim) data.
    "_opq16": ("opq16", "rows", "exact", {}),
    "_code_opq16_score": ("opq16", "code", "score", {}),
    # Residual PQ16 (FAISS by_residual, ITS default for 'IVF<n>,PQ<M>'):
    # codes carry x - centroid(list) — on clustered data the codec only
    # quantizes the intra-cell noise.
    "_pq16_res": ("pq16", "rows", "exact", {}, {"pq_residual": True}),
    "_code_pq16_res_score": ("pq16", "code", "score", {},
                             {"pq_residual": True}),
    "_opq16_res": ("opq16", "rows", "exact", {}, {"pq_residual": True}),
}


def bench_ivf(tags=("", "_sq8", "_pq16"),
              nprobes=(1, 2, 4, 8, 16, 32, 64, 128),
              rank=None, label="deep1m") -> None:
    """IVF4096 nprobe sweeps over the storage codecs (the reference's
    'IVF4096,Flat' / 'IVF4096,SQ8' / 'IVF4096,PQ16' factory configs,
    faiss.py:190): recall@10 on 128 held-out queries (float64 ground
    truth) + QPS at B=128 (latency row) and B=1024 (the amortized batch
    size)."""
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    n, d = 1_000_000, 96
    db, queries, dataset = _load_or_make("deep_base.fvecs", n, d, 1.0,
                                         seed=2, nq=1024, rank=rank)
    n = db.shape[0]
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    nq_r = 128
    truth = _exact_ground_truth(db, queries[:nq_r])
    q_recall = [DescriptorMemoryElement(f"q{i}", queries[i])
                for i in range(nq_r)]
    q_large = [DescriptorMemoryElement(f"Q{i}", queries[i])
               for i in range(1024)]
    for tag in tags:
        dtype, storage, rerank, build_env, *rest = _IVF_VARIANTS[tag]
        extra = rest[0] if rest else {}
        idx = IvfNearestNeighborsIndex(n_lists=4096, kmeans_iterations=10,
                                       max_points_per_centroid=64,
                                       random_seed=0, dtype=dtype,
                                       storage=storage, rerank=rerank,
                                       **extra)
        saved_env = {k: os.environ.get(k) for k in build_env}
        os.environ.update(build_env)
        t0 = time.perf_counter()
        try:
            idx.build_index(elems)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        emit(metric=f"ivf4096{tag}_{label}_build_wall",
             value=round(time.perf_counter() - t0, 1), unit="s",
             dataset=dataset)

        for nprobe in nprobes:
            idx.nprobe = nprobe
            res = idx.nn_many(q_recall, 10)          # compile + warm
            t0 = time.perf_counter()
            for _ in range(3):
                res = idx.nn_many(q_recall, 10)
            dt128 = (time.perf_counter() - t0) / 3
            got = [[e.uuid() for e in r] for r, _ in res]
            idx.nn_many(q_large, 10)                 # compile + warm
            t0 = time.perf_counter()
            for _ in range(2):
                idx.nn_many(q_large, 10)
            dt1024 = (time.perf_counter() - t0) / 2
            emit(metric=f"ivf4096{tag}_{label}_nprobe{nprobe}",
                 value=round(nq_r / dt128, 0), unit="queries/s",
                 qps_b1024=round(1024 / dt1024, 0), dataset=dataset,
                 recall_at_10=round(_recall_at_10(got, truth), 4))


def bench_lsh_e2e() -> None:
    """END-TO-END LSH serving through the public model API (round-5
    Config 2 refresh): ITQ-128 + hash2uuids buckets + exact re-rank over
    SIFT1M-shaped data through the fused single-dispatch path, measured
    at B=128 (latency row) and B=1024 (amortized row)."""
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.lsh_functor.itq import ItqFunctor
    from smqtk_indexing_tpu.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )

    n, d = 1_000_000, 128
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=0, nq=1024)
    n = db.shape[0]
    truth = _exact_ground_truth(db, queries[:128])
    els = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    q128 = [DescriptorMemoryElement(f"q{i}", queries[i])
            for i in range(128)]
    q1024 = [DescriptorMemoryElement(f"Q{i}", queries[i])
             for i in range(1024)]

    functor = ItqFunctor(bit_length=128, random_seed=0)
    functor.fit(els[:100_000])
    idx = LSHNearestNeighborIndex(lsh_functor=functor,
                                  distance_method="euclidean")
    t0 = time.perf_counter()
    idx.build_index(els)
    emit(metric="lsh_e2e_itq128_build_wall",
         value=round(time.perf_counter() - t0, 1), unit="s",
         dataset=dataset)
    st = idx._fused_ready(10, 1024)
    emit(metric="lsh_e2e_fused_state",
         eligible_b1024=st is not None,
         n_codes_live=None if idx._fused is None
         else idx._fused["n_codes_live"],
         l_max=None if idx._fused is None else idx._fused["l_max"],
         rows=None if idx._fused is None
         else len(idx._fused["row2elem"]))

    for label, qs, iters in (("b128", q128, 3), ("b1024", q1024, 2)):
        res = idx.nn_many(qs, 10)       # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            res = idx.nn_many(qs, 10)
        dt = (time.perf_counter() - t0) / iters
        kw = {}
        if label == "b128":
            got = [[e.uuid() for e in r] for r, _ in res]
            kw["recall_at_10"] = round(_recall_at_10(got, truth), 4)
        emit(metric=f"lsh_e2e_itq128_fused_{label}",
             value=round(len(qs) / dt, 0), unit="queries/s",
             dataset=dataset, **kw)


def bench_mrpt() -> None:
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    from smqtk_indexing_tpu.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )

    n, d = 262_144, 960
    db, queries, dataset = _load_or_make("gist_base.fvecs", n, d, 1.0,
                                         seed=4)
    n = db.shape[0]
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    nq = min(64, queries.shape[0])
    queries = queries[:nq]
    truth = _exact_ground_truth(db, queries)
    q_elems = [DescriptorMemoryElement(f"q{i}", queries[i])
               for i in range(nq)]
    for trees, depth in ((8, 9), (16, 7), (32, 6)):
        idx = MRPTNearestNeighborsIndex(num_trees=trees, depth=depth,
                                        random_seed=0)
        t0 = time.perf_counter()
        idx.build_index(elems)
        build_s = time.perf_counter() - t0
        res = idx.nn_many(q_elems, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            res = idx.nn_many(q_elems, 10)
        dt = (time.perf_counter() - t0) / 3
        got = [[e.uuid() for e in r] for r, _ in res]
        emit(metric=f"mrpt_gist256k_t{trees}_d{depth}",
             value=round(nq / dt, 0), unit="queries/s", dataset=dataset,
             build_wall_s=round(build_s, 1),
             recall_at_10=round(_recall_at_10(got, truth), 4))


def bench_sq8() -> None:
    """SQ8 capacity tier at the SIFT1M shape: recall + QPS vs the exact
    f32 engine on identical held-out queries."""
    import jax.numpy as jnp

    from smqtk_indexing_tpu.ops import sq8
    from smqtk_indexing_tpu.ops.device import capacity_for, pad_rows_np

    n, d = 1_000_000, 128
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=6)
    n = db.shape[0]
    truth = _exact_ground_truth(db, queries)
    cap = capacity_for(n)
    a, b = sq8.sq8_train(db)
    codes_np = np.zeros((cap, d), dtype=np.int8)
    codes_np[:n] = sq8.sq8_encode_np(db, a, b)
    codes = jnp.asarray(codes_np)
    a_j, b_j = jnp.asarray(a), jnp.asarray(b)
    s2, nrm = sq8.sq8_row_stats(codes, a_j, b_j)
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True
    valid = jnp.asarray(valid)
    nq = queries.shape[0]
    qb = jnp.asarray(pad_rows_np(queries, max(nq, 128), d))
    dd, rr = sq8.sq8_topk(codes, a_j, b_j, s2, nrm, valid, qb, k=16)
    np.asarray(dd)
    t0 = time.perf_counter()
    for _ in range(3):
        dd, rr = sq8.sq8_topk(codes, a_j, b_j, s2, nrm, valid, qb, k=16)
    np.asarray(dd)
    dt = (time.perf_counter() - t0) / 3
    got = np.asarray(rr)[:nq, :10]
    emit(metric="sq8_sift1m_scan_b128", value=round(nq / dt, 0),
         unit="queries/s", dataset=dataset,
         recall_at_10=round(_recall_at_10(got, truth), 4),
         note="int8 codes, 4x capacity vs f32; exact re-rank on "
              "dequantized winners")


if __name__ == "__main__":
    import sys

    from smqtk_indexing_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    sections = {"itq": bench_itq_linear, "lsh_e2e": bench_lsh_e2e,
                "ivf": bench_ivf,
                "mrpt": bench_mrpt, "sq8": bench_sq8,
                # Same-window A/B: rows-tier sq8 (exact + score) vs
                # the code tier.
                "ivf_code": lambda: bench_ivf(
                    ("_sq8", "_sq8_score", "_code", "_code_score"),
                    nprobes=(1, 4, 16, 64)),
                # PQ counterpart: the rows tier's XLA dequant scan vs
                # the code tier (exact + score), plus the OPQ16
                # rotation (recall lever at equal bytes).
                "ivf_code_pq": lambda: bench_ivf(
                    ("_pq16", "_code_pq16",
                     "_code_pq16_score", "_opq16", "_code_opq16_score",
                     "_pq16_res", "_code_pq16_res_score"),
                    nprobes=(1, 4, 16, 64)),
                # Correlated (rank-8 latent) 1M flavor — the regime the
                # OPQ rotation exists for; shows the full recall ladder
                # raw PQ -> OPQ -> residual -> OPQ+residual at 16 B/vec.
                # Opt-in by name (not in the default section list).
                "ivf_corr": lambda: bench_ivf(
                    ("_pq16", "_opq16", "_pq16_res", "_opq16_res"),
                    nprobes=(1, 4, 16, 64), rank=8, label="corr1m")}
    picked = [a for a in sys.argv[1:] if a in sections] \
        or [s for s in sections if s != "ivf_corr"]
    emit(metric="bench_all_start", value=time.time(), unit="epoch_s",
         sections=picked)
    for name in picked:
        sections[name]()
    emit(metric="bench_all_done", value=time.time(), unit="epoch_s")
