"""
Codec recall ladder on CORRELATED (rank-8 latent) data — the regime where
PQ/OPQ/residual meaningfully separate (iid-dim synthetic mixtures are
PQ-adversarial by construction: every subspace carries independent
information, so 16-byte codes hit a codec ceiling regardless of
pipeline).

Recall@10 is DEVICE-INDEPENDENT (identical codecs, layouts and probe
semantics run on the CPU and the GPU — parity held by the test suite), so
this table is valid from a CPU run, which is the default here (set
JAX_PLATFORMS to choose another backend); QPS comes from the card
(bench_all.py section `ivf_corr`).

Usage: python tools/recall_ladder.py [n] [d]   (defaults 200000 64)
Emits one JSON line per (codec, nprobe) plus a markdown table on stderr.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from bench_all import _exact_ground_truth, _load_or_make, _recall_at_10  # noqa: E402
from smqtk_indexing_tpu.data.descriptor import (  # noqa: E402
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.models.nn_index.ivf import (  # noqa: E402
    IvfNearestNeighborsIndex,
)

CODECS = [
    # (label, kwargs) — rows tier: identical float mirror, codec on device.
    ("f32", dict(dtype="float32")),
    ("sq8", dict(dtype="sq8")),
    ("pq16", dict(dtype="pq16", pq_residual=False)),
    ("pq16_res", dict(dtype="pq16", pq_residual=True)),
    ("opq16", dict(dtype="opq16", pq_residual=False)),
    ("opq16_res", dict(dtype="opq16", pq_residual=True)),
]


def main(n: int = 200_000, d: int = 64, rank: int = 8) -> None:
    nprobes = (1, 2, 4, 8, 16, 32)
    n_lists = 256 if n <= 300_000 else 1024
    db, queries, label = _load_or_make(
        "corr_base.fvecs", n, d, scale=1.0, seed=5, nq=128, rank=rank)
    print(f"# dataset={label} n={n} d={d} n_lists={n_lists}",
          file=sys.stderr, flush=True)
    true_ids = _exact_ground_truth(db, queries, k=10)

    els = []
    for i in range(n):
        e = DescriptorMemoryElement(i)
        e.set_vector(db[i])
        els.append(e)
    qels = [DescriptorMemoryElement(f"q{i}", queries[i])
            for i in range(queries.shape[0])]

    rows = {}
    for name, kw in CODECS:
        idx = IvfNearestNeighborsIndex(
            descriptor_set=MemoryDescriptorSet(), n_lists=n_lists,
            nprobe=nprobes[0], random_seed=0, **kw)
        idx.build_index(els)
        for nprobe in nprobes:
            idx.nprobe = nprobe
            res = idx.nn_many(qels, 10)
            got = [[e.uuid() for e in r[0]] for r in res]
            rec = _recall_at_10(got, true_ids)
            rows.setdefault(name, {})[nprobe] = rec
            print(json.dumps({"section": "recall_ladder",
                              "dataset": label, "n": n, "d": d,
                              "codec": name, "nprobe": nprobe,
                              "recall_at_10": round(rec, 4)}), flush=True)
        del idx

    hdr = "| codec (bytes/vec) | " + " | ".join(
        f"np={p}" for p in nprobes) + " |"
    bytes_per = {"f32": 4 * d, "sq8": d, "pq16": 16, "pq16_res": 16,
                 "opq16": 16, "opq16_res": 16}
    print(hdr, file=sys.stderr)
    print("|" + "---|" * (len(nprobes) + 1), file=sys.stderr)
    for name, _ in CODECS:
        cells = " | ".join(f"{rows[name][p]:.3f}" for p in nprobes)
        print(f"| {name} ({bytes_per[name]}B) | {cells} |",
              file=sys.stderr, flush=True)

    cosine_ladder(db, queries, els, qels, n_lists, nprobes, label, n, d)


# Round-5 cell: cosine + residual on the code tier (unit-sphere codes).
COSINE_CODECS = [
    ("cos_sq8", dict(dtype="sq8")),
    ("cos_pq16", dict(dtype="pq16", pq_residual=False)),
    ("cos_pq16_res", dict(dtype="pq16", pq_residual=True)),
    ("cos_opq16_res", dict(dtype="opq16", pq_residual=True)),
]


def cosine_ladder(db, queries, els, qels, n_lists, nprobes, label, n, d
                  ) -> None:
    """Angular-metric rung of the ladder: code-tier codecs under
    metric='cosine', incl. the round-5 residual cell, against a float64
    angular oracle."""
    dbn = db.astype(np.float64)
    dbn /= np.maximum(np.linalg.norm(dbn, axis=1, keepdims=True), 1e-30)
    qn = queries.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-30)
    true_ids = [np.argsort(-(dbn @ qv), kind="stable")[:10].tolist()
                for qv in qn]

    rows = {}
    for name, kw in COSINE_CODECS:
        idx = IvfNearestNeighborsIndex(
            descriptor_set=MemoryDescriptorSet(), n_lists=n_lists,
            nprobe=nprobes[0], random_seed=0, metric="cosine",
            storage="code", **kw)
        idx.build_index(els)
        for nprobe in nprobes:
            idx.nprobe = nprobe
            res = idx.nn_many(qels, 10)
            got = [[e.uuid() for e in r[0]] for r in res]
            rec = _recall_at_10(got, true_ids)
            rows.setdefault(name, {})[nprobe] = rec
            print(json.dumps({"section": "recall_ladder_cosine",
                              "dataset": label, "n": n, "d": d,
                              "codec": name, "nprobe": nprobe,
                              "recall_at_10": round(rec, 4)}), flush=True)
        del idx

    bytes_per = {"cos_sq8": d, "cos_pq16": 16, "cos_pq16_res": 16,
                 "cos_opq16_res": 16}
    print("| cosine codec (bytes/vec) | " + " | ".join(
        f"np={p}" for p in nprobes) + " |", file=sys.stderr)
    print("|" + "---|" * (len(nprobes) + 1), file=sys.stderr)
    for name, _ in COSINE_CODECS:
        cells = " | ".join(f"{rows[name][p]:.3f}" for p in nprobes)
        print(f"| {name} ({bytes_per[name]}B) | {cells} |",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    main(n, d)
