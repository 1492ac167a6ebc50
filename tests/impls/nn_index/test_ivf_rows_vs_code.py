"""
Rows tier against code tier: ``IvfNearestNeighborsIndex(storage='rows')``
keeps the float32 host mirror and serves the row-major XLA list scan
(ops/ivf); ``storage='code'`` persists codes and serves the tiled list
scan (ops/ivf_tiled). The storage alone selects the engine. At full
probe both are exact over the same codec, so they agree.
"""
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex


def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _clustered(n_clusters=4, per=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 10
    elems = []
    for ci, c in enumerate(centers):
        for j in range(per):
            elems.append(_elem(f"{ci}-{j}", c + rng.normal(size=d) * 0.3))
    return elems


def _index(dtype="sq8", storage="rows", **kw):
    kw.setdefault("n_lists", 4)
    kw.setdefault("nprobe", 4)
    kw.setdefault("kmeans_iterations", 6)
    kw.setdefault("random_seed", 0)
    return IvfNearestNeighborsIndex(dtype=dtype, storage=storage, **kw)


def _agree_at_full_probe(dtype):
    elems = _clustered()
    queries = _clustered(seed=3)[:12]
    idx_r = _index(dtype)
    idx_r.build_index(elems)
    idx_c = _index(dtype, storage="code")
    idx_c.build_index(elems)
    k = 8
    for q in queries:
        n_r, d_r = idx_r.nn(q, k)
        n_c, d_c = idx_c.nn(q, k)
        # Same per-build codec over the same live rows: same winners
        # (modulo quantized-distance ties), same exact distances.
        assert {e.uuid() for e in n_c} == {e.uuid() for e in n_r}
        np.testing.assert_allclose(d_c, d_r, rtol=1e-4, atol=1e-4)


def test_rows_tier_keeps_float_mirror():
    idx = _index()
    idx.build_index(_clustered())
    assert idx._dev3 is None              # no tiled device state
    assert idx._dev is not None           # row-major int8 codes
    assert idx._host.dtype == np.float32  # rows-tier mirror intact
    assert idx._code_a is None            # codec is per-layout, not
    #                                       the persisted 'code' codec


def test_code_matches_rows_at_full_probe():
    _agree_at_full_probe("sq8")


def test_update_and_removal():
    elems = _clustered()
    idx = _index()
    idx.build_index(elems)
    target = elems[0]
    extra = _elem("new-0", np.asarray(target.vector()) + 0.01)
    idx.update_index([extra])
    assert idx.count() == len(elems) + 1
    n, _ = idx.nn(target, 3)
    got = {e.uuid() for e in n}
    assert "new-0" in got and "0-0" in got
    idx.remove_from_index(["0-0"])
    assert idx.count() == len(elems)
    n, _ = idx.nn(target, 3)
    assert "0-0" not in {e.uuid() for e in n}
    with pytest.raises(KeyError):
        idx.remove_from_index(["absent"])


def test_persistence_is_float_rows():
    elems = _clustered()
    cache = DataMemoryElement(readonly=False)
    idx = _index(index_element=cache)
    idx.build_index(elems)
    baseline = [e.uuid() for e in idx.nn(elems[5], 5)[0]]
    # rows-tier contract: the payload carries float32 originals (the
    # 'code' tier is the codes-only format), so a float32/rows instance
    # can reload it losslessly.
    idx2 = _index(index_element=cache)
    assert idx2.count() == len(elems)
    assert idx2._host.dtype == np.float32
    assert [e.uuid() for e in idx2.nn(elems[5], 5)[0]] == baseline


def test_relayout_keeps_each_engine():
    # Re-layouts (update, removal compaction) rebuild the same engine's
    # device state and never the other's.
    elems = _clustered()
    for storage in ("rows", "code"):
        idx = _index(storage=storage)
        idx.build_index(elems)
        idx.update_index([_elem("late",
                                np.asarray(elems[0].vector()) + 0.5)])
        idx.remove_from_index([e.uuid() for e in elems[1:100]])
        if storage == "rows":
            assert idx._dev3 is None and idx._dev is not None
        else:
            assert idx._dev3 is not None and idx._dev is None
        n, _ = idx.nn(elems[0], 2)
        assert elems[0].uuid() in {e.uuid() for e in n}


def test_code_tier_has_no_rowmajor_state():
    idx = _index(storage="code")
    idx.build_index(_clustered())
    assert idx._dev3 is not None
    assert idx._dev is None
    assert idx._host.dtype == np.int8     # codes are the mirror


def test_pq_rows_tier_keeps_float_mirror():
    idx = _index("pq4")
    idx.build_index(_clustered())
    assert idx._dev3 is None
    assert idx._dev is not None
    assert idx._host.dtype == np.float32
    assert idx._code_cb is None   # per-layout codec, never persisted


def test_pq_code_matches_rows_at_full_probe():
    _agree_at_full_probe("pq4")


def test_pq_update_and_removal():
    elems = _clustered()
    idx = _index("pq4")
    idx.build_index(elems)
    target = elems[0]
    idx.update_index([_elem("new-0",
                            np.asarray(target.vector()) + 0.01)])
    assert idx.count() == len(elems) + 1
    idx.remove_from_index(["0-0"])
    n, _ = idx.nn(target, 3)
    assert "0-0" not in {e.uuid() for e in n}


@pytest.mark.parametrize("storage", ["rows", "code"])
def test_nprobe_partial_coverage(storage):
    # Faithful nprobe: nprobe=1 restricts to the nearest original list
    # (self-retrieval still finds the query's own cluster).
    elems = _clustered()
    idx = _index(storage=storage, nprobe=1)
    idx.build_index(elems)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n, d = idx.nn(elems[17], 1)
    assert n[0].uuid() == elems[17].uuid()
    # Self-distance is the sq8 quantization residual (±10-scale data).
    assert d[0] < 0.5
