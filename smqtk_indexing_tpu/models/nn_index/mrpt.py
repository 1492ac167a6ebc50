"""
MRPT (Multiple Random Projection Trees) device nearest-neighbor index.

Capability-parity with the reference's ``MRPTNearestNeighborsIndex``
(/root/reference/smqtk_indexing/impls/nn_index/mrpt.py:42-533, Hyvönen et
al. arXiv:1509.06957): same tunables (``num_trees``, ``depth``,
``random_seed``, ``read_only``), same update/remove = full-rebuild semantics
(mrpt.py:428-442), same examined-points math (≈ num_trees * N / 2^depth).

Device-first inversions (see ops/mrpt.py): whole-database projection is one
streamed einsum; query descent/union/re-rank is one fused device program;
persistence is npz bytes into a DataElement instead of pickled TreeElement
files (mrpt.py:364-401).
"""
from __future__ import annotations

import io
import logging
import threading
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.data.descriptor import (
    DescriptorElement, DescriptorSet, MemoryDescriptorSet,
)
from smqtk_indexing_tpu.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu.models.nn_index._results import assemble_results
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu.ops.device import capacity_for, pad_dim, pad_rows_np
from smqtk_indexing_tpu.ops.device import pow2_at_least as _pow2_at_least
from smqtk_indexing_tpu.ops.mrpt import build_trees, mrpt_query, project_all
from smqtk_indexing_tpu.utils.tracing import COUNTERS

LOG = logging.getLogger(__name__)


class MRPTNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Approximate kNN via multiple balanced random-projection trees.

    :param descriptor_set: Backing descriptor element storage.
    :param index_element: Optional DataElement persisting the built trees
        (the reference's index/parameters filepaths collapse into one
        element; use DataFileElement for on-disk persistence).
    :param num_trees: Number of trees (reference guidance: ≈ 3k / leaf_size,
        mrpt.py:64-73).
    :param depth: Tree depth; each query examines ≈ num_trees * N / 2^depth
        points. Clamped (with a warning) so leaves are non-empty.
    :param random_seed: Seed for the Gaussian projection bases.
    :param read_only: Refuse mutations when True.
    :param n_devices: Row-shard the database and leaf tables across this
        many mesh devices (power of two); queries run the per-shard leaf
        scan + hierarchical top-k merge (parallel/sharded_mrpt.py).
    """

    @classmethod
    def is_usable(cls) -> bool:
        # Usable whenever the compute stack imports (the reference gates
        # availability on backend importability, faiss.py:86-89); HOW it
        # runs — compiled GPU kernels vs interpret fallback — is reported
        # by usability_report().
        try:
            import jax  # noqa: F401
            return True
        except Exception:  # pragma: no cover - broken install
            return False

    @classmethod
    def usability_report(cls) -> dict:
        from smqtk_indexing_tpu.ops.device import device_report
        r = super().usability_report()
        r.update(device_report(flags=("SMQTK_TPU_NO_NATIVE",)))
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["index_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "MRPTNearestNeighborsIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        ds_cfg = cfg.get("descriptor_set")
        if ds_cfg and ds_cfg.get("type"):
            cfg["descriptor_set"] = from_config_dict(
                ds_cfg, DescriptorSet.get_impls())
        else:
            cfg["descriptor_set"] = None
        ie_cfg = cfg.get("index_element")
        if ie_cfg and ie_cfg.get("type"):
            cfg["index_element"] = from_config_dict(
                ie_cfg, DataElement.get_impls())
        else:
            cfg["index_element"] = None
        return super().from_config(cfg, False)

    def __init__(
        self,
        descriptor_set: Optional[DescriptorSet] = None,
        index_element: Optional[DataElement] = None,
        num_trees: int = 10,
        depth: int = 1,
        random_seed: Optional[int] = None,
        read_only: bool = False,
        n_devices: Optional[int] = None,
    ):
        super().__init__()
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.num_trees = int(num_trees)
        self.depth = int(depth)
        self.random_seed = random_seed
        self.read_only = bool(read_only)
        self.n_devices = n_devices

        self._model_lock = threading.RLock()
        self._reset_state()
        self._load_index()

    def _reset_state(self) -> None:
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None
        self._row2uid: List[Hashable] = []
        self._uid2row: Dict[Hashable, int] = {}
        self._bases_np: Optional[np.ndarray] = None
        self._splits_np: Optional[np.ndarray] = None
        self._leaf_np: Optional[np.ndarray] = None
        self._offsets_np: Optional[np.ndarray] = None
        self._depth_eff = 0
        self._leaf_max = 0
        # device
        self._dev = None
        self._dev_sq = None
        self._dev_valid = None
        self._dev_bases = None
        self._dev_splits = None
        self._dev_leaf = None
        self._dev_offsets = None
        self._capacity = 0
        self._mesh = None
        # sharded-mesh state (n_devices > 1)
        self._dev_leaf_local = None
        self._dev_off_local = None
        self._leaf_max_sh = 0

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c.update({
            "num_trees": self.num_trees,
            "depth": self.depth,
            "random_seed": self.random_seed,
            "read_only": self.read_only,
            "n_devices": self.n_devices,
        })
        return c

    def _make_mesh(self):
        """Row-shard across a device mesh when multi-device is requested
        (same semantics as FlatNearestNeighborsIndex.n_devices)."""
        if self.n_devices is None or self.n_devices <= 1:
            return None
        from smqtk_indexing_tpu.parallel.mesh import make_mesh
        return make_mesh(self.n_devices)

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def _rebuild(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        n, d = mat.shape
        self._dim = d
        depth_eff = self.depth
        max_depth = max(int(np.floor(np.log2(max(n, 2)))), 1)
        if depth_eff > max_depth:
            warnings.warn(
                f"Requested depth {depth_eff} too deep for {n} rows; "
                f"clamping to {max_depth} (examined points ≈ "
                f"num_trees * N / 2^depth).")
            depth_eff = max_depth
        self._depth_eff = depth_eff

        rng = np.random.default_rng(self.random_seed)
        d_pad = pad_dim(d)
        bases = rng.standard_normal(
            (self.num_trees, d, depth_eff)).astype(np.float32)
        bases_p = np.zeros((self.num_trees, d_pad, depth_eff),
                           dtype=np.float32)
        bases_p[:, :d, :] = bases

        n_pad = capacity_for(n)
        mat_p = pad_rows_np(mat, n_pad, d_pad)
        projs = np.asarray(project_all(jnp.asarray(mat_p),
                                       jnp.asarray(bases_p)))[:n]
        splits, leaf_table, offsets = build_trees(projs, depth_eff)
        LOG.debug("Built %d trees depth %d over %d rows (leaf sizes %d-%d)",
                  self.num_trees, depth_eff, n,
                  int(np.diff(offsets).min()), int(np.diff(offsets).max()))

        self._host = mat
        self._row2uid = list(uids)
        self._uid2row = {u: i for i, u in enumerate(uids)}
        self._bases_np = bases_p
        self._splits_np = splits
        self._leaf_np = leaf_table
        self._offsets_np = offsets
        self._leaf_max = _pow2_at_least(int(np.diff(offsets).max()))
        self._upload(mat_p, n)
        self._save_index()

    def _upload(self, mat_p: np.ndarray, n: int) -> None:
        self._capacity = mat_p.shape[0]
        sq = np.zeros(self._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = True
        mesh = self._make_mesh()
        if mesh is not None:
            from smqtk_indexing_tpu.parallel.mesh import (
                replicate, shard_rows,
            )
            from smqtk_indexing_tpu.parallel.sharded_mrpt import (
                shard_leaf_tables,
            )
            leaf_loc, off_loc, lmax = shard_leaf_tables(
                self._leaf_np, self._offsets_np, mesh.devices.size,
                self._capacity)
            self._leaf_max_sh = _pow2_at_least(max(lmax, 1))
            self._dev = shard_rows(mesh, jnp.asarray(mat_p))
            self._dev_sq = shard_rows(mesh, jnp.asarray(sq))
            self._dev_valid = shard_rows(mesh, jnp.asarray(valid))
            self._dev_bases = replicate(mesh, jnp.asarray(self._bases_np))
            self._dev_splits = replicate(mesh, jnp.asarray(self._splits_np))
            self._dev_leaf_local = shard_rows(mesh, jnp.asarray(leaf_loc))
            self._dev_off_local = shard_rows(mesh, jnp.asarray(off_loc))
            self._mesh = mesh
            return
        self._mesh = None
        # leaf_table indexes real rows only; pad with clamped zeros.
        leaf_pad = np.zeros((self.num_trees, self._capacity), dtype=np.int32)
        leaf_pad[:, :n] = self._leaf_np
        self._dev = jnp.asarray(mat_p)
        self._dev_sq = jnp.asarray(sq)
        self._dev_valid = jnp.asarray(valid)
        self._dev_bases = jnp.asarray(self._bases_np)
        self._dev_splits = jnp.asarray(self._splits_np)
        self._dev_leaf = jnp.asarray(leaf_pad)
        self._dev_offsets = jnp.asarray(self._offsets_np)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save_index(self) -> None:
        if self.index_element is None:
            return
        if self.index_element.is_read_only():
            raise ReadOnlyError(
                f"Index element {self.index_element} is read-only.")
        bio = io.BytesIO()
        np.savez(bio, matrix=self._host,
                 uids=np.array(self._row2uid, dtype=object),
                 bases=self._bases_np, splits=self._splits_np,
                 leaf_table=self._leaf_np, offsets=self._offsets_np,
                 depth_eff=np.array(self._depth_eff))
        self.index_element.set_bytes(bio.getvalue())

    def _load_index(self) -> None:
        if self.index_element is None or self.index_element.is_empty():
            return
        with np.load(io.BytesIO(self.index_element.get_bytes()),
                     allow_pickle=True) as z:
            mat = z["matrix"]
            uids = list(z["uids"])
            self._bases_np = z["bases"]
            self._splits_np = z["splits"]
            self._leaf_np = z["leaf_table"]
            self._offsets_np = z["offsets"]
            self._depth_eff = int(z["depth_eff"])
        n, d = mat.shape
        self._dim = d
        self._host = mat
        self._row2uid = uids
        self._uid2row = {u: i for i, u in enumerate(uids)}
        self._leaf_max = _pow2_at_least(int(np.diff(self._offsets_np).max()))
        d_pad = self._bases_np.shape[1]
        self._upload(pad_rows_np(mat, capacity_for(n), d_pad), n)
        if self.descriptor_set.count() != n:
            LOG.warning(
                "Descriptor set size (%d) disagrees with loaded index size "
                "(%d); repopulating from index payload.",
                self.descriptor_set.count(), n)
            from smqtk_indexing_tpu.data.descriptor import (
                DescriptorMemoryElement,
            )
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(
                DescriptorMemoryElement(u, mat[i])
                for i, u in enumerate(uids))

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return len(self._uid2row)

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            uids = list(by_uid.keys())
            mat = np.vstack([by_uid[u].vector() for u in uids]) \
                .astype(np.float32)
            self._rebuild(mat, uids)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        # Reference semantics: update is a full rebuild over old + new
        # (mrpt.py:428-436).
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            by_uid = {e.uuid(): e for e in elems}
            if self._host is not None:
                fresh = [u for u in by_uid if u not in self._uid2row]
                old_uids = list(self._row2uid)
                # Always copy — never alias self._host: in-place
                # replacement of re-sent UIDs below must not touch the
                # live index (or an array shared with prior persistence)
                # before _rebuild validates and completes.
                mat = np.vstack(
                    [self._host]
                    + [np.asarray(by_uid[u].vector(), dtype=np.float32)
                       .reshape(1, -1) for u in fresh]) \
                    if fresh else self._host.copy()
                # Replace vectors for re-sent UIDs in the copy.
                for u in by_uid:
                    if u in self._uid2row:
                        mat[self._uid2row[u]] = by_uid[u].vector()
                uids = old_uids + fresh
            else:
                uids = list(by_uid.keys())
                mat = np.vstack([by_uid[u].vector() for u in uids]) \
                    .astype(np.float32)
            self._rebuild(np.ascontiguousarray(mat, dtype=np.float32), uids)
            self.descriptor_set.add_many_descriptors(by_uid.values())

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        # Reference semantics: remove is a full rebuild over the remainder
        # (mrpt.py:437-442), KeyError with no mutation on unknown UIDs.
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            for u in uids:
                if u not in self._uid2row:
                    raise KeyError(u)
            dead = {self._uid2row[u] for u in uids}
            keep = [i for i in range(len(self._row2uid)) if i not in dead]
            self.descriptor_set.remove_many_descriptors(uids)
            if not keep:
                self._reset_state()
                if self.index_element is not None \
                        and not self.index_element.is_read_only():
                    self.index_element.set_bytes(b"")
                return
            self._rebuild(np.ascontiguousarray(self._host[keep]),
                          [self._row2uid[i] for i in keep])

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        q = np.vstack([d.vector() for d in ds]).astype(np.float32)
        with self._model_lock:
            if self._host is None:
                raise ValueError("No index currently set to query from!")
            if q.shape[1] != self._dim:
                raise ValueError(
                    f"Query dim {q.shape[1]} != index dim {self._dim}")
            b = q.shape[0]
            b_pad = _pow2_at_least(b, 8)
            d_pad = self._bases_np.shape[1]
            q_p = pad_rows_np(q, b_pad, d_pad)
            k_eff = min(n, self.count())
            k_dev = min(_pow2_at_least(k_eff), self._capacity)
            COUNTERS.add("mrpt.queries", b)
            COUNTERS.add("mrpt.candidates_examined",
                         b * self.num_trees * self._leaf_max)
            if self._mesh is not None:
                from smqtk_indexing_tpu.parallel.mesh import replicate
                from smqtk_indexing_tpu.parallel.sharded_mrpt import (
                    sharded_mrpt_query,
                )
                dists, rows = sharded_mrpt_query(
                    self._mesh, self._dev, self._dev_sq, self._dev_valid,
                    self._dev_bases, self._dev_splits,
                    self._dev_leaf_local, self._dev_off_local,
                    replicate(self._mesh, jnp.asarray(q_p)), k=k_dev,
                    depth=self._depth_eff, leaf_max=self._leaf_max_sh)
            else:
                dists, rows = mrpt_query(
                    self._dev, self._dev_sq, self._dev_valid,
                    self._dev_bases, self._dev_splits, self._dev_leaf,
                    self._dev_offsets, jnp.asarray(q_p), k=k_dev,
                    depth=self._depth_eff, leaf_max=self._leaf_max)
            dists = np.asarray(dists)[:b, :k_eff]
            rows = np.asarray(rows)[:b, :k_eff]
            out = assemble_results(dists, rows, self._row2uid,
                                   self.descriptor_set)
        shortest = min(len(r[0]) for r in out)
        if shortest < n:
            # Reference under-fill warning (mrpt.py:503-508).
            if n > self.count():
                warnings.warn(
                    f"Requested {n} neighbors but only {self.count()} "
                    "are indexed.")
            else:
                warnings.warn(
                    f"Requested {n} neighbors but some queries reached "
                    f"only {shortest} candidates; increase num_trees or "
                    "decrease depth for more coverage.")
        return out
