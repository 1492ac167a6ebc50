"""FaissNearestNeighborsIndex adapter: the reference's exact config
surface served by this package's engines
(/root/reference/smqtk_indexing/impls/nn_index/faiss.py:150-343)."""
import json
import warnings

import numpy as np
import pytest

from smqtk_indexing_tpu.data.data_element import DataMemoryElement
from smqtk_indexing_tpu.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.data.key_value import MemoryKeyValueStore
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu.models.nn_index.faiss_compat import (
    FaissNearestNeighborsIndex,
)


def _els(n, d, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = DescriptorMemoryElement(i)
        e.set_vector(rng.normal(size=d).astype(np.float32))
        out.append(e)
    return out


def test_discoverable():
    assert FaissNearestNeighborsIndex in NearestNeighborsIndex.get_impls()


def test_reference_shaped_config_roundtrip():
    # A config with the reference's exact key set deserializes and
    # serializes with the same keys.
    idx = FaissNearestNeighborsIndex(
        factory_string="IVF16,Flat", metric_type="l2", ivf_nprobe=4,
        random_seed=0)
    cfg = json.loads(json.dumps(idx.get_config()))
    for key in ("descriptor_set", "uid2idx_kvs", "idx2uid_kvs",
                "factory_string", "metric_type", "ivf_nprobe",
                "read_only", "random_seed", "use_gpu", "gpu_id"):
        assert key in cfg, key
    idx2 = FaissNearestNeighborsIndex.from_config(cfg)
    assert idx2.factory_string == "IVF16,Flat"
    assert idx2.ivf_nprobe == 4


@pytest.mark.parametrize("fs,metric", [
    ("IDMap,Flat", "l2"),
    ("Flat", 0),              # METRIC_INNER_PRODUCT int constant
    ("SQ8", "l2"),
    ("IVF16,Flat", "l2"),
    ("IVF16,SQ8", "l2"),
    ("IVF16,PQ4", "l2"),
    ("OPQ4,IVF16,PQ4", "l2"),
])
def test_factory_strings_build_and_query(fs, metric):
    els = _els(300, 16, seed=3)
    idx = FaissNearestNeighborsIndex(
        factory_string=fs, metric_type=metric, ivf_nprobe=16,
        random_seed=0)
    idx.build_index(els)
    assert idx.count() == 300
    res = idx.nn(els[11], 5)
    got = [e.uuid() for e in res[0]]
    assert 11 in got, (fs, got)


def test_ivf_nprobe_is_query_time_tunable():
    els = _els(600, 16, seed=5)
    idx = FaissNearestNeighborsIndex(
        factory_string="IVF16,Flat", ivf_nprobe=16, random_seed=0)
    idx.build_index(els)
    full = idx.nn(els[3], 8)
    idx.ivf_nprobe = 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        narrow = idx.nn(els[3], 8)
    assert narrow[0][0].uuid() == 3
    assert idx._inner.nprobe == 1
    assert full[0][0].uuid() == 3


def test_three_store_layout_and_param_element():
    u2i, i2u = MemoryKeyValueStore(), MemoryKeyValueStore()
    pe = DataMemoryElement()
    ie = DataMemoryElement()
    els = _els(100, 8, seed=9)
    idx = FaissNearestNeighborsIndex(
        descriptor_set=MemoryDescriptorSet(), uid2idx_kvs=u2i,
        idx2uid_kvs=i2u, index_element=ie, index_param_element=pe,
        factory_string="IVF16,Flat", random_seed=1)
    idx.build_index(els)
    assert u2i.count() == 100 and i2u.count() == 100
    params = json.loads(pe.get_bytes().decode())
    assert params["factory_string"] == "IVF16,Flat"
    # Reload through a fresh adapter: index payload + stores rehydrate.
    idx2 = FaissNearestNeighborsIndex(
        descriptor_set=MemoryDescriptorSet(), index_element=ie,
        index_param_element=pe, factory_string="IVF16,Flat",
        random_seed=1)
    assert idx2.count() == 100
    assert idx2.nn(els[7], 3)[0][0].uuid() == 7


def test_use_gpu_warns_not_raises():
    with pytest.warns(UserWarning, match="accelerator-resident"):
        FaissNearestNeighborsIndex(use_gpu=True)


def test_invalid_values_match_reference_errors():
    with pytest.raises(ValueError, match="factory_string"):
        FaissNearestNeighborsIndex(factory_string=7)
    with pytest.raises(ValueError, match="metric type"):
        FaissNearestNeighborsIndex(metric_type="hamming")
    with pytest.raises(ValueError, match="metric type"):
        FaissNearestNeighborsIndex(metric_type=23)
    with pytest.raises(ValueError, match="ivf_nprobe"):
        FaissNearestNeighborsIndex(ivf_nprobe=0)


def test_param_element_mismatch_warns(caplog):
    pe = DataMemoryElement(json.dumps(
        {"factory_string": "IVF1024,PQ64"}).encode())
    import logging
    with caplog.at_level(logging.WARNING):
        FaissNearestNeighborsIndex(index_param_element=pe,
                                   factory_string="Flat")
    assert any("factory_string" in r.message for r in caplog.records)
