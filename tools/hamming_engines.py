"""
A/B of the two Hamming engines through ``LinearHashIndex.nn_many`` on one
GPU, in one process: the ±1 bf16 product engine (ops/hamming.pm1_engine's
choice from PM1_SCAN_MIN codes) against packed XOR + popcount, at
1M codes x 256 bits, B=1024, k=10. Order: ±1, XOR, XOR, ±1; each form is
warmed up once, then timed over REPS calls (host clock around calls that
end in host arrays).

Run from the repository root: python tools/hamming_engines.py
Prints one JSON line per timing and a last line with the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N, BITS, B, K, REPS = 1_000_000, 256, 1024, 10, 5


def main() -> None:
    from smqtk_indexing_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import chip_smoke
    from smqtk_indexing_tpu.models.hash_index.linear import LinearHashIndex
    from smqtk_indexing_tpu.ops import hamming

    rng = np.random.default_rng(0)
    codes = rng.random((N, BITS)) < 0.5
    queries = rng.random((B, BITS)) < 0.5
    index = LinearHashIndex()
    index.build_index(codes)
    pm1_min = hamming.PM1_SCAN_MIN
    # The rule compares the store's capacity (1024 * 2^m >= N) with the
    # threshold, so "xor" sets it above any capacity.
    engines = {"pm1": pm1_min, "xor": 1 << 62}
    results = {}
    for name in ("pm1", "xor", "xor", "pm1"):
        hamming.PM1_SCAN_MIN = engines[name]
        out = index.nn_many(queries, K)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = index.nn_many(queries, K)
            times.append(time.perf_counter() - t0)
        results[name] = np.array([d for _, d in out])
        print(json.dumps({"engine": name, "n": N, "bits": BITS, "b": B,
                          "mean_ms": 1e3 * float(np.mean(times)),
                          "min_ms": 1e3 * min(times)}), flush=True)
    hamming.PM1_SCAN_MIN = pm1_min
    # Both engines return the same distances.
    assert np.array_equal(results["pm1"], results["xor"])
    print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi_line(),
                      "device": chip_smoke.device_info()}), flush=True)


if __name__ == "__main__":
    main()
