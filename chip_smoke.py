"""
Bring-up smoke run on NVIDIA GPUs: drives the index engine's main paths
through the public API (``build_index``, ``nn_many``, ``nn``) at real size,
runs every Pallas kernel compiled for the card, and checks each result
against a float64 numpy reference.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards: sharded vs one device

One card runs, in order: ``device`` (name, power limit, JAX platform;
fails unless the platform is ``gpu``), ``flat`` (exhaustive flat index,
three metrics), ``ivf_sq8`` (IVF code tier, SQ8, both re-rank modes),
``ivf_pq`` (IVF code tier, PQ16, plain and residual), ``hash`` (ITQ + LSH
on the ±1 engine, linear Hamming index) and ``gpu_tests`` (the
``gpu``-marked tests on the card). ``--four-cards`` runs ``device``,
``flat4`` and ``ivf4`` only: the sharded flat index and the sharded SQ8
code tier at 4M rows, each compared with a one-device index over the same
data in the same process.

The parent process never imports JAX: it runs each phase as a child
(``--phase NAME``), one at a time, so one process holds the cards. Every
phase prints its build time, time per batch and comparison, and ends with
a JSON line; the first failing phase stops the run with a non-zero exit.
The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
These are bring-up timings, not benchmark numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
K = 10
#: Whole-run deadline (seconds), compilation included.
DEADLINE_S = 1150.0

FLAT_N, FLAT_D, FLAT_B, FLAT_CHECK = 1_000_000, 128, 2048, 256
IVF_N, IVF_D, IVF_B, IVF_CHECK, IVF_LISTS = 1_000_000, 96, 1024, 256, 4096
PQ_CHECK = 64
LSH_N, LSH_BITS, LSH_B, LSH_MIN_UNIQUE = 200_000, 128, 1024, 100_000
HAM_N, HAM_BITS, HAM_B, HAM_CHECK = 1_000_000, 256, 1024, 64
SHARD_N, SHARD_B = 4_000_000, 1024
REPS = 3

ONE_CARD = ("device", "flat", "ivf_sq8", "ivf_pq", "hash", "gpu_tests")
FOUR_CARDS = ("device", "flat4", "ivf4")


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# shared helpers (child processes only)
# ---------------------------------------------------------------------------

def device_info():
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def elements(mat, prefix=""):
    from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
    if prefix:
        return [DescriptorMemoryElement(f"{prefix}{i}", v)
                for i, v in enumerate(mat)]
    return [DescriptorMemoryElement(i, v) for i, v in enumerate(mat)]


def timed_batches(fn, reps=REPS):
    """Warm up once (compiles), then time ``reps`` calls that end in
    host objects. :return: (last result, seconds per call list)."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times


def unpack(results):
    """nn_many results -> (uids (B, k) object array, dists (B, k))."""
    uids = np.array([[e.uuid() for e in r] for r, _ in results],
                    dtype=object)
    dists = np.array([list(d) for _, d in results], dtype=np.float64)
    return uids, dists


def report(name, build_s, times, batch, **extra):
    per = float(np.mean(times))
    say(f"[{name}] build {build_s:.2f} s; per batch of {batch}: "
        f"mean {per * 1e3:.2f} ms, min {min(times) * 1e3:.2f} ms "
        f"({batch / per:.0f} queries/s); "
        + "; ".join(f"{k}={v}" for k, v in extra.items()))


def flat_truth(db64, q64, metric):
    """(B, N) float64 reference distances (the index's metric
    definitions: euclidean, negated inner product, angular in [0, 1])."""
    ip = q64 @ db64.T
    if metric == "euclidean":
        sq = np.einsum("ij,ij->i", db64, db64)
        qs = np.einsum("ij,ij->i", q64, q64)
        return np.sqrt(np.maximum(sq[None] - 2.0 * ip + qs[:, None], 0.0))
    if metric == "inner_product":
        return -ip
    nrm = np.linalg.norm(db64, axis=1)
    qn = np.linalg.norm(q64, axis=1)
    sim = np.clip(ip / (qn[:, None] * nrm[None]), -1.0, 1.0)
    return 2.0 * np.arccos(sim) / np.pi


def check_topk(got_rows, got_d, true_row_d, kth, rtol, what):
    """Rows equal the reference top-k except at exact ties, and distances
    agree with the reference to ``rtol``."""
    check(len(set(got_rows)) == len(got_rows), f"{what}: duplicate rows")
    scale = np.maximum(np.abs(true_row_d), 1e-6)
    err = float(np.max(np.abs(got_d - true_row_d) / scale))
    check(err <= rtol, f"{what}: distance rel err {err:.3g} > {rtol}")
    slack = rtol * max(abs(kth), 1e-6)
    check(bool(np.all(true_row_d <= kth + slack)),
          f"{what}: a returned row is beyond the k-th true distance")
    return err


def clustered(n, d, extra, seed):
    """Deep1M-shaped clustered mixture (1024 centers, uniform in [0, 1],
    Gaussian spread 1/12, clipped), shuffled; the last ``extra`` rows are
    held-out queries."""
    rng = np.random.default_rng(seed)
    total = n + extra
    centers = rng.random((1024, d), dtype=np.float32)
    pts = centers[rng.integers(0, 1024, size=total)]
    pts += rng.normal(size=(total, d)).astype(np.float32) / 12
    pts = np.clip(pts, 0, 1).astype(np.float32)[rng.permutation(total)]
    return pts[:n], pts[n:]


def l2_truth_topk(db, q, k, chunk=32):
    """Exact float64 euclidean top-k row ids per query."""
    db64 = db.astype(np.float64)
    sq = np.einsum("ij,ij->i", db64, db64)
    out = []
    for i in range(0, q.shape[0], chunk):
        d2 = sq[None] - 2.0 * (q[i:i + chunk].astype(np.float64) @ db64.T)
        part = np.argpartition(d2, k, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d2, part, 1), axis=1)
        out.append(np.take_along_axis(part, order, 1))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(n_cards):
    info = device_info()
    say(f"[device] jax: platform={info['platform']} "
        f"kind={info['kind']} count={info['count']}")
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {info['platform']!r}")
    if info["count"] < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {info['count']}")
    return {}


def phase_flat():
    from smqtk_indexing_tpu.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    rng = np.random.default_rng(SEED)
    # SIFT1M-shaped: non-negative, roughly uniform magnitude 0..218.
    db = rng.random((FLAT_N, FLAT_D), dtype=np.float32) * 218.0
    q = rng.random((FLAT_B, FLAT_D), dtype=np.float32) * 218.0
    els, qels = elements(db), elements(q, "q")
    db64, q64 = db.astype(np.float64), q[:FLAT_CHECK].astype(np.float64)
    out = {}
    for metric in ("euclidean", "inner_product", "cosine"):
        idx = FlatNearestNeighborsIndex(metric=metric)
        t0 = time.perf_counter()
        idx.build_index(els)
        build_s = time.perf_counter() - t0
        res, times = timed_batches(lambda: idx.nn_many(qels, K))
        uids, dists = unpack(res)
        single = idx.nn(qels[0], K)
        check([e.uuid() for e in single[0]] == list(uids[0]),
              f"flat {metric}: nn() != nn_many() row 0")
        worst = 0.0
        for c0 in range(0, FLAT_CHECK, 32):
            truth = flat_truth(db64, q64[c0:c0 + 32], metric)
            for j in range(truth.shape[0]):
                i = c0 + j
                rows = uids[i].astype(np.int64)
                kth = np.partition(truth[j], K - 1)[K - 1]
                worst = max(worst, check_topk(
                    rows, dists[i], truth[j][rows], kth, 1e-5,
                    f"flat {metric} query {i}"))
        report(f"flat {metric}", build_s, times, FLAT_B,
               checked=FLAT_CHECK, max_rel_err=f"{worst:.2e}")
        out[metric] = {"build_s": build_s, "batch_s": times}
        del idx
    return out


def _ivf_data():
    db, queries = clustered(IVF_N, IVF_D, IVF_B, SEED + 2)
    return db, queries, elements(db), elements(queries, "q")


def phase_ivf_sq8():
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu.ops.sq8 import sq8_encode_np
    db, queries, els, qels = _ivf_data()
    truth = l2_truth_topk(db, queries[:IVF_CHECK], K)
    idx = IvfNearestNeighborsIndex(
        n_lists=IVF_LISTS, nprobe=4, kmeans_iterations=10,
        max_points_per_centroid=64, random_seed=0, dtype="sq8",
        storage="code", rerank="score")
    t0 = time.perf_counter()
    idx.build_index(els)
    build_s = time.perf_counter() - t0
    a = idx._code_a.astype(np.float64)
    b = idx._code_b.astype(np.float64)
    out = {"build_s": build_s}
    for rerank in ("score", "gather"):
        idx.rerank = rerank
        res, times = timed_batches(lambda: idx.nn_many(qels, K))
        uids, dists = unpack(res)
        check(uids.shape == (IVF_B, K), f"ivf sq8 {rerank}: short result")
        recall = float(np.mean([
            len(set(uids[i].astype(np.int64)) & set(truth[i])) / K
            for i in range(IVF_CHECK)]))
        check(recall >= 0.8, f"ivf sq8 {rerank}: recall@10 {recall:.3f}")
        worst = 0.0
        for i in range(IVF_CHECK):
            rows = uids[i].astype(np.int64)
            u = sq8_encode_np(db[rows], idx._code_a, idx._code_b) \
                .astype(np.float64)
            x_hat = u * a + b
            qv = queries[i].astype(np.float64)
            exact = np.sqrt(((x_hat - qv) ** 2).sum(1))
            if rerank == "gather":
                err = np.abs(dists[i] - exact) / np.maximum(exact, 1e-6)
                check(bool(np.all(err <= 1e-4)),
                      f"ivf sq8 gather query {i}: rel err {err.max():.3g}")
                worst = max(worst, float(err.max()))
            else:
                # f32 cancellation bound of the surrogate (ops/ivf_tiled
                # ._tiled_scan_finish): 1e-5 * (||q - b||^2 + s2).
                bound = 1e-5 * (((qv - b) ** 2).sum()
                                + ((a * u) ** 2).sum(1))
                err = np.abs(dists[i] ** 2 - exact ** 2)
                check(bool(np.all(err <= bound)),
                      f"ivf sq8 score query {i}: |d^2 err| "
                      f"{err.max():.3g} > {bound.min():.3g}")
                worst = max(worst, float((err / bound).max()))
        report(f"ivf sq8 code rerank={rerank}", build_s, times, IVF_B,
               recall_at_10=f"{recall:.4f}",
               worst_err=f"{worst:.2e}"
               + (" rel" if rerank == "gather" else " of bound"))
        out[rerank] = {"batch_s": times, "recall_at_10": recall}
    return out


def _adc_reference(idx, q, k, nprobe):
    """Numpy ADC top-k over the same codes: nprobe nearest centroids
    (float64), every row of those lists decoded from its PQ code (plus
    its list centroid in residual mode), float64 distances. :return:
    (uid -> distance for all candidates, k-th distance)."""
    m, d_codec, perm = idx._pq_grid()
    cb = idx._code_cb.astype(np.float64)
    cents = idx._centroids_np.astype(np.float64)
    d_pad = cents.shape[1]
    qp = np.zeros(d_codec)
    qp[:q.shape[0]] = q
    qc = qp[perm]
    c_sc = (cents ** 2).sum(1) - 2.0 * cents @ qp[:d_pad]
    lists = np.argsort(c_sc, kind="stable")[:nprobe]
    rows = np.flatnonzero(np.isin(idx._assign_host, lists))
    codes = idx._host[rows]
    x = np.concatenate([cb[j][codes[:, j]] for j in range(m)], axis=1)
    if idx.pq_residual:
        x = x + idx._pq_cents_codec(None).astype(np.float64)[
            idx._assign_host[rows]]
    dist = np.sqrt(((x - qc) ** 2).sum(1))
    kth = np.partition(dist, k - 1)[k - 1]
    return {idx._row2uid[r]: dv for r, dv in zip(rows, dist)}, kth


def phase_ivf_pq():
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    db, queries, els, qels = _ivf_data()
    out = {}
    for residual in (False, True):
        name = "pq16" + (" residual" if residual else "")
        idx = IvfNearestNeighborsIndex(
            n_lists=IVF_LISTS, nprobe=4, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype="pq16",
            storage="code", pq_residual=residual)
        t0 = time.perf_counter()
        idx.build_index(els)
        build_s = time.perf_counter() - t0
        res, times = timed_batches(lambda: idx.nn_many(qels, K))
        uids, dists = unpack(res)
        mismatched, worst = 0, 0.0
        for i in range(PQ_CHECK):
            ref, kth = _adc_reference(idx, queries[i].astype(np.float64),
                                      K, idx.nprobe)
            if not all(u in ref for u in uids[i]):
                mismatched += 1      # a probe-selection near-tie
                continue
            ref_d = np.array([ref[u] for u in uids[i]])
            worst = max(worst, check_topk(
                uids[i].astype(np.int64), dists[i], ref_d, kth, 1e-4,
                f"ivf {name} query {i}"))
        check(mismatched <= PQ_CHECK // 32,
              f"ivf {name}: {mismatched} queries left the probed lists")
        report(f"ivf {name} code", build_s, times, IVF_B,
               checked=PQ_CHECK, probe_ties=mismatched,
               max_rel_err=f"{worst:.2e}")
        out[name] = {"build_s": build_s, "batch_s": times}
        del idx
    return out


def _hamming(packed, qp):
    return np.bitwise_count(packed ^ qp[None, :]).sum(1)


def phase_hash():
    from smqtk_indexing_tpu.models.hash_index.linear import LinearHashIndex
    from smqtk_indexing_tpu.models.lsh_functor.itq import ItqFunctor
    from smqtk_indexing_tpu.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )
    rng = np.random.default_rng(SEED + 3)
    out = {}

    # ITQ + LSH: enough unique codes that the ±1 engine serves.
    db = rng.random((LSH_N, 128), dtype=np.float32) * 218.0
    els = elements(db)
    qels = els[:LSH_B]                       # self-queries
    t0 = time.perf_counter()
    functor = ItqFunctor(bit_length=LSH_BITS, random_seed=0)
    functor.fit(els)
    idx = LSHNearestNeighborIndex(lsh_functor=functor,
                                  distance_method="euclidean")
    idx.build_index(els)
    build_s = time.perf_counter() - t0
    res, times = timed_batches(lambda: idx.nn_many(qels, K))
    st = idx._fused
    check(st is not None and st["pm1"] is not None,
          "lsh: the ±1 near-code engine did not serve")
    codes = functor.get_hash_batch(db)
    uniq = np.unique(codes, axis=0)
    check(uniq.shape[0] >= LSH_MIN_UNIQUE,
          f"lsh: {uniq.shape[0]} unique codes")
    upk = np.packbits(uniq, axis=1).view(np.uint64)
    allpk = np.packbits(codes, axis=1).view(np.uint64)
    uids, dists = unpack(res)
    for i in range(HAM_CHECK):
        rows = uids[i].astype(np.int64)
        check(rows[0] == i and dists[i][0] <= 1e-3,
              f"lsh query {i}: self not first")
        exact = np.sqrt(((db[rows].astype(np.float64)
                          - db[i].astype(np.float64)) ** 2).sum(1))
        err = np.abs(dists[i] - exact) / np.maximum(exact, 1e-3)
        check(bool(np.all(err <= 1e-5)), f"lsh query {i}: rel err")
        hq = allpk[i]
        h_n = np.partition(_hamming(upk, hq), K - 1)[K - 1]
        check(bool(np.all(_hamming(allpk[rows], hq) <= h_n)),
              f"lsh query {i}: a result's code is beyond the {K} "
              "nearest codes")
    report("lsh itq", build_s, times, LSH_B, unique_codes=uniq.shape[0],
           checked=HAM_CHECK)
    out["lsh"] = {"build_s": build_s, "batch_s": times}
    del idx

    # Linear Hamming index at 1M codes x 256 bits.
    hcodes = rng.random((HAM_N, HAM_BITS)) < 0.5
    qcodes = rng.random((HAM_B, HAM_BITS)) < 0.5
    hi = LinearHashIndex()
    t0 = time.perf_counter()
    hi.build_index(hcodes)
    build_s = time.perf_counter() - t0
    res, times = timed_batches(lambda: hi.nn_many(qcodes, K))
    packed = np.packbits(hcodes, axis=1).view(np.uint64)
    qpk = np.packbits(qcodes, axis=1).view(np.uint64)
    for i in range(HAM_CHECK):
        got_codes, got_d = res[i]
        ham = _hamming(packed, qpk[i])
        want = np.sort(np.partition(ham, K - 1)[:K]) / HAM_BITS
        check(np.array_equal(np.asarray(got_d), want),
              f"linear hash query {i}: distances differ from numpy")
        got_pk = np.packbits(np.asarray(got_codes), axis=1).view(np.uint64)
        check(np.array_equal(_hamming(got_pk, qpk[i]) / HAM_BITS,
                             np.asarray(got_d)),
              f"linear hash query {i}: code/distance mismatch")
    report("linear hash 256-bit", build_s, times, HAM_B, checked=HAM_CHECK)
    out["linear"] = {"build_s": build_s, "batch_s": times}
    return out


def phase_gpu_tests():
    env = dict(os.environ, SMQTK_TESTS_DEVICE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-p",
         "no:cacheprovider", "tests"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    say(f"[gpu tests] {tail[0]} ({time.perf_counter() - t0:.1f} s)")
    check(proc.returncode == 0 and "skipped" not in tail[0],
          "gpu-marked tests failed or skipped:\n" + proc.stdout[-4000:]
          + proc.stderr[-2000:])
    return {"summary": tail[0]}


def _shard_compare(name, make, els, qels, rtol):
    """Build ``make(None)`` and ``make(4)`` over the same elements, run
    the same batch, compare rows (up to ties) and distances."""
    built = {}
    for nd in (None, 4):
        idx = make(nd)
        t0 = time.perf_counter()
        idx.build_index(els)
        build_s = time.perf_counter() - t0
        res, times = timed_batches(lambda: idx.nn_many(qels, K))
        built[nd] = unpack(res)
        report(f"{name} n_devices={nd or 1}", build_s, times, len(qels))
        del idx
    (u1, d1), (u4, d4) = built[None], built[4]
    differ = 0
    for i in range(len(qels)):
        err = np.abs(d4[i] - d1[i]) / np.maximum(np.abs(d1[i]), 1e-6)
        check(bool(np.all(err <= rtol)),
              f"{name} query {i}: sharded distances differ")
        if list(u4[i]) != list(u1[i]):
            # Rows may differ only where distances tie.
            dist_of = dict(zip(u1[i], d1[i]))
            dist_of.update(zip(u4[i], d4[i]))
            for u in set(u4[i]) ^ set(u1[i]):
                check(abs(dist_of[u] - d1[i][-1])
                      <= rtol * max(abs(d1[i][-1]), 1e-6),
                      f"{name} query {i}: rows differ beyond ties")
            differ += 1
    say(f"[{name}] sharded vs one device: {len(qels)} queries, "
        f"{differ} differ only at ties")


def phase_flat4():
    from smqtk_indexing_tpu.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    rng = np.random.default_rng(SEED + 4)
    db = rng.random((SHARD_N, 128), dtype=np.float32) * 218.0
    q = rng.random((SHARD_B, 128), dtype=np.float32) * 218.0
    _shard_compare(
        "flat4", lambda nd: FlatNearestNeighborsIndex(n_devices=nd),
        elements(db), elements(q, "q"), 1e-5)
    return {}


def phase_ivf4():
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    db, queries = clustered(SHARD_N, 96, SHARD_B, SEED + 5)
    _shard_compare(
        "ivf4 sq8 code",
        lambda nd: IvfNearestNeighborsIndex(
            n_lists=IVF_LISTS, nprobe=4, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype="sq8",
            storage="code", n_devices=nd),
        elements(db), elements(queries, "q"), 1e-4)
    return {}


PHASES = {
    "device": None, "flat": phase_flat, "ivf_sq8": phase_ivf_sq8,
    "ivf_pq": phase_ivf_pq, "hash": phase_hash,
    "gpu_tests": phase_gpu_tests, "flat4": phase_flat4, "ivf4": phase_ivf4,
}


def run_phase(name, n_cards):
    from smqtk_indexing_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if name == "device":
        result = phase_device(n_cards)
    else:
        result = PHASES[name]()
    print(json.dumps({"phase": name, "ok": True, "device": device_info(),
                      "result": result}), flush=True)


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the four-card sharded phases only")
    ap.add_argument("--phase", choices=sorted(PHASES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    if args.phase:
        run_phase(args.phase, n_cards)
        return

    from smqtk_indexing_tpu.utils.compile_cache import enable_compile_cache
    say(f"compile cache: {enable_compile_cache()}")
    say(nvidia_smi_line())
    deadline = time.monotonic() + DEADLINE_S
    device = None
    for name in (FOUR_CARDS if args.four_cards else ONE_CARD):
        cmd = [sys.executable, os.path.abspath(__file__), "--phase", name]
        if args.four_cards:
            cmd.append("--four-cards")
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=max(1.0, deadline - t0))
        except subprocess.TimeoutExpired as e:
            sys.stdout.write((e.stdout or b"").decode() if isinstance(
                e.stdout, bytes) else (e.stdout or ""))
            print(f"phase {name}: deadline exceeded", file=sys.stderr)
            raise SystemExit(1)
        lines = proc.stdout.rstrip().splitlines()
        for line in lines[:-1]:
            say(line)
        last = lines[-1] if lines else ""
        try:
            res = json.loads(last)
        except ValueError:
            res = None
            if last:
                say(last)
        if proc.returncode != 0 or not (res and res.get("ok")):
            sys.stderr.write(proc.stderr[-6000:])
            print(f"phase {name} failed (rc={proc.returncode})",
                  file=sys.stderr)
            raise SystemExit(1)
        say(f"[{name}] ok in {time.monotonic() - t0:.1f} s")
        device = res["device"]
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
