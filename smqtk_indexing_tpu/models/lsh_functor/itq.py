"""
Iterative Quantization (ITQ) LSH functor.

Capability-parity with the reference's ``ItqFunctor``
(/root/reference/smqtk_indexing/impls/lsh_functor/itq.py:32-408): same
constructor surface (mean_vec/rotation byte-element caches, bit_length,
itq_iterations, normalize, random_seed), same model persistence as ``.npy``
bytes (itq.py:212-237), same dim >= bit_length guard (itq.py:326-330), same
big-endian bit-0-is-MSB hash semantics (itq.py:46-50).

Device-first inversion: ``fit`` is one jitted XLA program (ops/itq.itq_fit —
PCA via eigh + the 50-iteration rotation loop under lax.fori_loop) instead of
the reference's host numpy eig/SVD loop, and hashing is a single batched
matmul+sign kernel.
"""
from __future__ import annotations

import io
import logging
from typing import Any, Dict, Iterable, Optional, Union

import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu.data.data_element import DataElement
from smqtk_indexing_tpu.data.descriptor import DescriptorElement
from smqtk_indexing_tpu.interfaces.lsh_functor import LshFunctor
from smqtk_indexing_tpu.models.lsh_functor.simple_rp import norm_rows
from smqtk_indexing_tpu.ops.itq import hash_batch, itq_fit

LOG = logging.getLogger(__name__)


class ItqFunctor (LshFunctor):
    """
    ITQ hash functor: PCA projection + learned orthogonal rotation + sign.

    :param mean_vec_cache_elem: Optional DataElement caching the fitted mean
        vector as ``.npy`` bytes.
    :param rotation_cache_elem: Optional DataElement caching the fitted
        rotation matrix as ``.npy`` bytes.
    :param bit_length: Hash code length (PCA components kept).
    :param itq_iterations: Rotation refinement iterations (50 is "usually
        enough", reference itq.py:137-138).
    :param normalize: Optional numpy ``ord`` for descriptor row
        normalization before centering.
    :param random_seed: Seed for the initial random rotation.

    >>> import numpy as np
    >>> from smqtk_indexing_tpu.data.descriptor import (
    ...     DescriptorMemoryElement)
    >>> rng = np.random.default_rng(0)
    >>> els = [DescriptorMemoryElement(i, rng.normal(size=16)
    ...        .astype(np.float32)) for i in range(64)]
    >>> functor = ItqFunctor(bit_length=8, random_seed=0)
    >>> functor.fit(els)
    >>> code = functor.get_hash(els[0].vector())
    >>> code.shape, code.dtype.kind
    ((8,), 'b')
    """

    @classmethod
    def is_usable(cls) -> bool:
        return True

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["mean_vec_cache_elem"] = make_default_config(
            DataElement.get_impls())
        c["rotation_cache_elem"] = make_default_config(
            DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "ItqFunctor":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        for key in ("mean_vec_cache_elem", "rotation_cache_elem"):
            sub = cfg.get(key)
            if sub and sub.get("type"):
                cfg[key] = from_config_dict(sub, DataElement.get_impls())
            else:
                cfg[key] = None
        return super().from_config(cfg, False)

    def __init__(self,
                 mean_vec_cache_elem: Optional[DataElement] = None,
                 rotation_cache_elem: Optional[DataElement] = None,
                 bit_length: int = 8,
                 itq_iterations: int = 50,
                 normalize: Optional[Union[int, float, str]] = None,
                 random_seed: Optional[int] = None):
        super().__init__()
        self.mean_vec_cache_elem = mean_vec_cache_elem
        self.rotation_cache_elem = rotation_cache_elem
        self.bit_length = int(bit_length)
        self.itq_iterations = int(itq_iterations)
        self.normalize = normalize
        self.random_seed = random_seed

        # Model components (device arrays once fitted/loaded).
        self.mean_vec: Optional[jnp.ndarray] = None   # (d,)
        self.rotation: Optional[jnp.ndarray] = None   # (d, bits)
        self.load_model()

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        if self.mean_vec_cache_elem is not None:
            c["mean_vec_cache_elem"] = merge_dict(
                c["mean_vec_cache_elem"],
                to_config_dict(self.mean_vec_cache_elem))
        if self.rotation_cache_elem is not None:
            c["rotation_cache_elem"] = merge_dict(
                c["rotation_cache_elem"],
                to_config_dict(self.rotation_cache_elem))
        c["bit_length"] = self.bit_length
        c["itq_iterations"] = self.itq_iterations
        c["normalize"] = self.normalize
        c["random_seed"] = self.random_seed
        return c

    # ------------------------------------------------------------------
    # model persistence (reference itq.py:212-237 semantics)
    # ------------------------------------------------------------------
    def has_model(self) -> bool:
        return self.mean_vec is not None and self.rotation is not None

    def save_model(self) -> None:
        """Write fitted model components to configured cache elements."""
        if not self.has_model():
            return
        if (self.mean_vec_cache_elem is not None
                and self.mean_vec_cache_elem.writable()):
            bio = io.BytesIO()
            np.save(bio, np.asarray(self.mean_vec))
            self.mean_vec_cache_elem.set_bytes(bio.getvalue())
        if (self.rotation_cache_elem is not None
                and self.rotation_cache_elem.writable()):
            bio = io.BytesIO()
            np.save(bio, np.asarray(self.rotation))
            self.rotation_cache_elem.set_bytes(bio.getvalue())

    def load_model(self) -> None:
        """Load model components from cache elements when both are set."""
        if (self.mean_vec_cache_elem is not None
                and not self.mean_vec_cache_elem.is_empty()
                and self.rotation_cache_elem is not None
                and not self.rotation_cache_elem.is_empty()):
            mv = np.load(io.BytesIO(self.mean_vec_cache_elem.get_bytes()))
            rot = np.load(io.BytesIO(self.rotation_cache_elem.get_bytes()))
            self.mean_vec = jnp.asarray(mv, dtype=jnp.float32)
            self.rotation = jnp.asarray(rot, dtype=jnp.float32)
            LOG.debug("Loaded ITQ model: mean %s, rotation %s",
                      mv.shape, rot.shape)

    # ------------------------------------------------------------------
    # fitting
    # ------------------------------------------------------------------
    def fit(self, descriptors: Iterable[DescriptorElement],
            use_multiprocessing: bool = True) -> None:
        """
        Fit the ITQ model on the given descriptor elements (one jitted XLA
        program on device).

        :param use_multiprocessing: Accepted for reference API parity
            (itq.py:291-300); ignored — vector collection is one host pass
            and the fit itself runs on device.
        :raises RuntimeError: A model is already loaded.
        :raises ValueError: No descriptors, or descriptor dimensionality is
            smaller than ``bit_length``.
        """
        if self.has_model():
            raise RuntimeError(
                "Model components have already been loaded/fitted; "
                "refusing to overwrite.")
        vecs = [d.vector() for d in descriptors]
        if not vecs:
            raise ValueError("No descriptors given to fit on.")
        x = np.vstack(vecs).astype(np.float32)
        if x.shape[1] < self.bit_length:
            raise ValueError(
                f"Descriptor dimensionality ({x.shape[1]}) is less than the "
                f"configured bit length ({self.bit_length}); cannot compute "
                "ITQ model. (reference guard itq.py:326-330)")
        x = norm_rows(x, self.normalize)
        rng = np.random.default_rng(self.random_seed)
        r_init = rng.standard_normal(
            (self.bit_length, self.bit_length)).astype(np.float32)
        mean_vec, rotation = itq_fit(
            jnp.asarray(x), jnp.asarray(r_init),
            bits=self.bit_length, n_iter=self.itq_iterations)
        self.mean_vec = mean_vec
        self.rotation = rotation
        self.save_model()

    # ------------------------------------------------------------------
    # hashing
    # ------------------------------------------------------------------
    def _require_model(self) -> None:
        if not self.has_model():
            raise RuntimeError(
                "ITQ functor has no model; fit() it or configure model "
                "cache elements.")

    def get_hash(self, descriptor: np.ndarray) -> np.ndarray:
        self._require_model()
        return self.get_hash_batch(
            np.asarray(descriptor).reshape(1, -1))[0]

    def get_hash_batch(self, descriptors: np.ndarray) -> np.ndarray:
        self._require_model()
        mat = np.atleast_2d(np.asarray(descriptors, dtype=np.float32))
        mat = norm_rows(mat, self.normalize)
        return np.asarray(hash_batch(jnp.asarray(mat), self.mean_vec,
                                     self.rotation))

    def hash_model(self):
        """(mean, rotation, normalize) — ITQ is exactly the affine
        sign-hash form, so the fused LSH serving program can inline it."""
        if not self.has_model():
            return None
        return (np.asarray(self.mean_vec, dtype=np.float32),
                np.asarray(self.rotation, dtype=np.float32),
                self.normalize)
