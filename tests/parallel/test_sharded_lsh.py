"""
Sharded LSH composite on the 8-virtual-device CPU mesh: n_devices must
shard the fallback LinearHashIndex and the candidate re-rank without
changing any result (candidate distances are computed elementwise, so
sharded and single-device scores are bit-identical).
"""
import numpy as np
import pytest

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.models.lsh_functor.itq import ItqFunctor
from smqtk_indexing_tpu.models.nn_index.lsh import LSHNearestNeighborIndex
from smqtk_indexing_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    # Materialize the CPU mesh fallback once for the module.
    return make_mesh(8)


@pytest.fixture(autouse=True)
def _pin_cpu():
    # These tests assert sharded == single-device bit-identity. Pin
    # everything to CPU — the property under test is sharding
    # equivalence, not backend numerics.
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _build(n_devices, elems, fit, metric="euclidean"):
    functor = ItqFunctor(bit_length=16, random_seed=0)
    functor.fit(fit)
    idx = LSHNearestNeighborIndex(lsh_functor=functor,
                                  distance_method=metric,
                                  n_devices=n_devices)
    idx.build_index(elems)
    return idx


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_lsh_matches_single(mesh, metric):
    rng = np.random.default_rng(0)
    n, d = 400, 32
    db = rng.random((n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    fit = [DescriptorMemoryElement(f"f{i}", v) for i, v in
           enumerate(db[:200])]
    i1 = _build(None, elems, fit, metric)
    i8 = _build(8, elems, fit, metric)
    qs = [DescriptorMemoryElement(f"q{j}",
                                  rng.random(d).astype(np.float32))
          for j in range(5)]
    res1 = i1.nn_many(qs, 4)
    res8 = i8.nn_many(qs, 4)
    for (e1, d1), (e8, d8) in zip(res1, res8):
        assert [x.uuid() for x in e1] == [x.uuid() for x in e8]
        np.testing.assert_allclose(d8, d1, atol=0)


def test_sharded_lsh_single_query_and_config(mesh):
    rng = np.random.default_rng(1)
    n, d = 128, 16
    db = rng.random((n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    fit = [DescriptorMemoryElement(f"f{i}", v) for i, v in enumerate(db)]
    idx = _build(8, elems, fit)
    assert idx.get_config()["n_devices"] == 8
    e, dd = idx.nn(elems[3], 3)
    assert e[0].uuid() == 3
    assert dd[0] == pytest.approx(0.0, abs=1e-6)
