"""
Simple random-projection LSH functor.

Capability-parity with the reference's ``SimpleRPFunctor``
(/root/reference/smqtk_indexing/impls/lsh_functor/simple_rp.py:15-127): fit
records the sample mean and a (dim, bits) Gaussian projection; hashing is
``(v - mean) @ rps >= 0``. Explicitly a baseline functor, "not for
production" (simple_rp.py:17-20) — use ItqFunctor.

Device-first: ``get_hash_batch`` runs the whole matrix through one jitted
matmul+sign program (ops/itq.hash_batch) instead of the reference's
per-descriptor host loop.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import jax.numpy as jnp
import numpy as np

from smqtk_indexing_tpu.data.descriptor import DescriptorElement
from smqtk_indexing_tpu.interfaces.lsh_functor import LshFunctor
from smqtk_indexing_tpu.ops.itq import hash_batch


def norm_rows(mat: np.ndarray,
              normalize: Optional[Union[int, float, str]]) -> np.ndarray:
    """
    Row-normalize a matrix with numpy ``ord`` semantics, or pass through when
    ``normalize`` is None (reference normalization contract,
    /root/reference/smqtk_indexing/impls/lsh_functor/itq.py:172-191).
    Zero-norm rows are left unchanged.
    """
    if normalize is None:
        return mat
    norms = np.linalg.norm(mat, ord=normalize, axis=-1, keepdims=True)
    return mat / np.where(norms == 0, 1.0, norms)


class SimpleRPFunctor (LshFunctor):
    """
    Baseline random-projection hashing.

    :param bit_length: Hash code length in bits.
    :param normalize: Optional numpy ``ord`` to row-normalize descriptors
        with before projection.
    :param random_seed: Seed for the Gaussian projection matrix.
    """

    @classmethod
    def is_usable(cls) -> bool:
        return True

    def __init__(self,
                 bit_length: int = 8,
                 normalize: Optional[Union[int, float, str]] = None,
                 random_seed: Optional[int] = None):
        super().__init__()
        self.bit_length = int(bit_length)
        self.normalize = normalize
        self.random_seed = random_seed
        # Model components
        self.rps: Optional[jnp.ndarray] = None       # (d, bits)
        self.mean_vec: Optional[jnp.ndarray] = None  # (d,)

    def get_config(self) -> Dict[str, Any]:
        return {
            "bit_length": self.bit_length,
            "normalize": self.normalize,
            "random_seed": self.random_seed,
        }

    def has_model(self) -> bool:
        return self.rps is not None and self.mean_vec is not None

    def fit(self, descriptors: Iterable[DescriptorElement]) -> np.ndarray:
        """
        Fit the projection model to a descriptor sample.

        :return: The fitted mean vector.
        """
        vecs = [d.vector() for d in descriptors]
        if not vecs:
            raise ValueError("No descriptors given to fit on.")
        x = norm_rows(np.vstack(vecs).astype(np.float64), self.normalize)
        rng = np.random.default_rng(self.random_seed)
        d = x.shape[1]
        self.mean_vec = jnp.asarray(np.mean(x, axis=0), dtype=jnp.float32)
        self.rps = jnp.asarray(
            rng.standard_normal((d, self.bit_length)), dtype=jnp.float32)
        return np.asarray(self.mean_vec)

    def _require_model(self) -> None:
        if not self.has_model():
            raise RuntimeError(
                "Functor has no random projection model; call fit() first.")

    def get_hash(self, descriptor: np.ndarray) -> np.ndarray:
        self._require_model()
        return self.get_hash_batch(
            np.asarray(descriptor).reshape(1, -1))[0]

    def get_hash_batch(self, descriptors: np.ndarray) -> np.ndarray:
        self._require_model()
        mat = np.atleast_2d(np.asarray(descriptors, dtype=np.float32))
        mat = norm_rows(mat, self.normalize)
        return np.asarray(hash_batch(jnp.asarray(mat), self.mean_vec,
                                     self.rps))

    def hash_model(self):
        """(mean, rps, normalize) — the affine sign-hash form for the
        fused LSH serving program."""
        if not self.has_model():
            return None
        return (np.asarray(self.mean_vec, dtype=np.float32),
                np.asarray(self.rps, dtype=np.float32), self.normalize)
