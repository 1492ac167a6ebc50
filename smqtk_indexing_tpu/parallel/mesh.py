"""
Mesh construction and row-sharding helpers.

The mesh follows the algorithm alone: flat/Hamming/IVF scans are
embarrassingly row-parallel, so rows shard over one logical axis
("shard") and each query performs one k-sized all-gather; the cards of
one host are joined all to all, so no device order is better than
another. Deployments spanning several hosts may add an outer "dcn" axis
(``make_mesh(dcn=...)``): rows shard over BOTH axes and the query merge
is hierarchical — all-gather within a host first, then one tiny merge
across hosts (k values per host, the only traffic crossing the slower
network between hosts).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"
DCN_AXIS = "dcn"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              dcn: int = 1) -> Mesh:
    """
    Build a mesh over the first ``n_devices`` devices of the default
    backend (all by default): 1-D ``("shard",)`` when ``dcn == 1``, else
    2-D ``("dcn", "shard")`` with ``dcn`` groups of ``n_devices // dcn``
    devices (assigned group-major, so each group's devices are
    contiguous in enumeration order).

    :raises ValueError: fewer devices than asked for — there is no
        fallback to another platform.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices; the "
                f"{jax.default_backend()!r} backend has {len(devices)}.")
        if n_devices & (n_devices - 1):
            raise ValueError(
                f"n_devices must be a power of two (got {n_devices}): "
                "store capacities are 1024*2^m and must shard evenly.")
        devices = devices[:n_devices]
    devices = np.array(devices)
    if dcn > 1:
        if devices.size % dcn:
            raise ValueError(
                f"dcn={dcn} does not divide device count {devices.size}.")
        return Mesh(devices.reshape(dcn, devices.size // dcn),
                    (DCN_AXIS, SHARD_AXIS))
    return Mesh(devices, (SHARD_AXIS,))


def row_axes(mesh: Mesh) -> tuple:
    """Mesh axis names that the row dimension shards over (all of them)."""
    return tuple(mesh.axis_names)


def shard_rows(mesh: Mesh, arr: jax.Array) -> jax.Array:
    """
    Place an array row-sharded over the mesh (first axis split across every
    mesh axis — "shard" alone on 1-D meshes, ("dcn", "shard") on 2-D).
    Row count must divide evenly (ops/device.capacity_for capacities are
    powers of two, so any power-of-two mesh divides them).
    """
    n_dev = mesh.devices.size
    if arr.shape[0] % n_dev:
        raise ValueError(
            f"Leading dim {arr.shape[0]} not divisible by mesh size "
            f"{n_dev}.")
    spec = P(row_axes(mesh), *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, arr: jax.Array) -> jax.Array:
    """Place an array fully replicated over the mesh."""
    spec = P(*([None] * arr.ndim))
    return jax.device_put(arr, NamedSharding(mesh, spec))
