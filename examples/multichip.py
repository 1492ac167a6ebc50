"""
Multi-device indexes: row-sharded over every device of the default
backend (the largest power of two of them).

Run on the CPU with an emulated 8-device mesh (the example sets the
emulation flag itself before jax initializes):
    JAX_PLATFORMS=cpu python examples/multichip.py
On a machine with several cards, run it without JAX_PLATFORMS and
`n_devices` takes the cards.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from smqtk_indexing_tpu.data.descriptor import (  # noqa: E402
    DescriptorMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index.flat import (  # noqa: E402
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu.models.nn_index.ivf import (  # noqa: E402
    IvfNearestNeighborsIndex,
)


def main() -> None:
    n_dev = 1 << (len(jax.devices()).bit_length() - 1)
    print(f"default devices: {len(jax.devices())} "
          f"({jax.devices()[0].platform}); sharding over {n_dev}")
    rng = np.random.default_rng(0)
    elems = [DescriptorMemoryElement(i, rng.normal(size=64).astype(np.float32))
             for i in range(4096)]

    # Exhaustive scan row-sharded over the devices: per-shard top-k,
    # k-sized all-gather merge.
    flat = FlatNearestNeighborsIndex(n_devices=n_dev)
    flat.build_index(elems)
    res, dists = flat.nn(elems[7], 5)
    print("sharded flat top-5:",
          [(e.uuid(), round(d, 3)) for e, d in zip(res, dists)])

    # IVF sharded by contiguous row spans of the list-sorted layout.
    ivf = IvfNearestNeighborsIndex(n_devices=8, n_lists=16, nprobe=16,
                                   kmeans_iterations=5, random_seed=0)
    ivf.build_index(elems)
    res, dists = ivf.nn(elems[7], 5)
    print("sharded ivf  top-5:",
          [(e.uuid(), round(d, 3)) for e, d in zip(res, dists)])


if __name__ == "__main__":
    main()
