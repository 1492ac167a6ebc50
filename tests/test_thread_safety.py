"""
Thread-safety contract (reference interfaces mandate it,
nearest_neighbor_index.py:22-24): concurrent queries during mutations must
never crash or return malformed results — the lock-around-swap discipline
on immutable device arrays.
"""
import threading

import numpy as np

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.flat import FlatNearestNeighborsIndex


import pytest


@pytest.mark.parametrize("kwargs", [
    {},                                  # f32 HBM-resident
    {"dtype": "sq8"},                    # codec tier (train-per-build)
    {"dtype": "pq8"},                    # PQ codec tier
    {"storage": "host_stream"},          # >HBM streamed tier
])
def test_concurrent_queries_and_mutations(kwargs):
    rng = np.random.default_rng(0)
    elems = [DescriptorMemoryElement(j, rng.normal(size=16).astype(np.float32))
             for j in range(256)]
    idx = FlatNearestNeighborsIndex(**kwargs)
    idx.build_index(elems)

    errors = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                res, dists = idx.nn(elems[rng.integers(0, 128)], 3)
                assert len(res) == len(dists) <= 3
                assert list(dists) == sorted(dists)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    def mutate_loop():
        try:
            for i in range(10):
                uid = f"new-{i}"
                idx.update_index([DescriptorMemoryElement(
                    uid, rng.normal(size=16).astype(np.float32))])
                idx.remove_from_index([uid])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query_loop) for _ in range(4)]
    m = threading.Thread(target=mutate_loop)
    for t in threads:
        t.start()
    m.start()
    m.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 256


def test_concurrent_ivf_code_tier():
    """The capacity tier serializes queries and mutations under the model
    lock; concurrent use must never crash, tear the int8 mirror, or
    resurrect poisoned (removed) rows."""
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    rng = np.random.default_rng(1)
    elems = [DescriptorMemoryElement(j, rng.normal(size=16).astype(np.float32))
             for j in range(256)]
    idx = IvfNearestNeighborsIndex(
        dtype="sq8", storage="code", n_lists=4, nprobe=4,
        kmeans_iterations=4, random_seed=0)
    idx.build_index(elems)

    errors = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                res, dists = idx.nn(elems[rng.integers(0, 128)], 3)
                assert len(res) == len(dists) <= 3
                assert list(dists) == sorted(dists)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    last_ghost = [None]

    def mutate_loop():
        try:
            for i in range(5):
                vec = rng.normal(size=16).astype(np.float32)
                last_ghost[0] = vec
                idx.update_index([DescriptorMemoryElement("ghost", vec)])
                idx.remove_from_index(["ghost"])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query_loop) for _ in range(2)]
    m = threading.Thread(target=mutate_loop)
    for t in threads:
        t.start()
    m.start()
    m.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 256
    # After all mutations settle, the final ghost stays removed (its
    # poisoned row can never win a scan).
    res, _ = idx.nn(DescriptorMemoryElement("probe", last_ghost[0]), 5)
    assert "ghost" not in [e.uuid() for e in res]


def test_concurrent_sharded_ivf_code_tier():
    """Sharded capacity tier (round 4): concurrent queries during
    update/remove must never crash, tear the sharded tile mirror, or
    resurrect poisoned rows on any shard."""
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    rng = np.random.default_rng(3)
    elems = [DescriptorMemoryElement(j, rng.normal(size=16).astype(np.float32))
             for j in range(256)]
    idx = IvfNearestNeighborsIndex(
        dtype="sq8", storage="code", n_lists=4, nprobe=4,
        kmeans_iterations=4, random_seed=0, n_devices=8)
    idx.build_index(elems)
    assert idx._mesh is not None

    errors = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                res, dists = idx.nn(elems[rng.integers(0, 128)], 3)
                assert len(res) == len(dists) <= 3
                assert list(dists) == sorted(dists)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    def mutate_loop():
        try:
            for i in range(3):
                vec = rng.normal(size=16).astype(np.float32)
                idx.update_index([DescriptorMemoryElement("ghost", vec)])
                idx.remove_from_index(["ghost"])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query_loop) for _ in range(2)]
    m = threading.Thread(target=mutate_loop)
    for t in threads:
        t.start()
    m.start()
    m.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 256


def test_concurrent_ivf_rows_tiled(monkeypatch):
    """The tiled engine (storage='code') poisons removed rows in place
    and re-lays out on update — concurrent use must never crash or
    resurrect removed rows."""
    from smqtk_indexing_tpu.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    rng = np.random.default_rng(2)
    elems = [DescriptorMemoryElement(j, rng.normal(size=16).astype(np.float32))
             for j in range(256)]
    idx = IvfNearestNeighborsIndex(
        dtype="sq8", storage="code", n_lists=4, nprobe=4,
        kmeans_iterations=4, random_seed=0)
    idx.build_index(elems)
    assert idx._dev3 is not None

    errors = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                res, dists = idx.nn(elems[rng.integers(0, 128)], 3)
                assert len(res) == len(dists) <= 3
                assert list(dists) == sorted(dists)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    last_ghost = [None]

    def mutate_loop():
        try:
            for i in range(5):
                vec = rng.normal(size=16).astype(np.float32)
                last_ghost[0] = vec
                idx.update_index([DescriptorMemoryElement("ghost", vec)])
                idx.remove_from_index(["ghost"])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query_loop) for _ in range(2)]
    m = threading.Thread(target=mutate_loop)
    for t in threads:
        t.start()
    m.start()
    m.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 256
    res, _ = idx.nn(DescriptorMemoryElement("probe", last_ghost[0]), 5)
    assert "ghost" not in [e.uuid() for e in res]
