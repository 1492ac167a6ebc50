"""
Device-side ITQ model fitting (Gong & Lazebnik, "Iterative Quantization",
CVPR 2011) — the jitted replacement for the reference's host numpy fit
(/root/reference/smqtk_indexing/impls/lsh_functor/itq.py:239-289,291-387):
mean-centering, PCA via symmetric eigendecomposition of the covariance, and
the ITQ rotation refinement loop (sign -> C = BᵀV -> SVD -> R = Ŝ S̄ᵀ) as one
XLA program with the loop under ``lax.fori_loop``.

The covariance is symmetric so ``eigh`` (stable, sorted) replaces the
reference's general ``eig`` (itq.py:351-356); tests therefore check geometric
invariants (recall, bit balance), not bit-exact hashes — see SURVEY.md §7
"ITQ numerical parity".
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def _polar(m: jnp.ndarray, steps: int = 16) -> jnp.ndarray:
    """
    Orthogonal polar factor via Newton–Schulz iteration — pure matmuls.

    A ``jnp.linalg.svd`` per ITQ iteration is an iterative decomposition
    on the device; the polar factor is all the rotation update
    needs, and Newton–Schulz (X <- 1.5X - 0.5 X Xᵀ X, converging for
    spectral norm < sqrt(3); guaranteed here by Frobenius pre-scaling)
    replaces each SVD with ~16 small matmuls.
    """
    hi = jax.lax.Precision.HIGHEST
    x = m / jnp.maximum(jnp.linalg.norm(m), 1e-30)

    def body(_, x):
        xxt = jnp.dot(x, x.T, preferred_element_type=jnp.float32,
                      precision=hi)
        return 1.5 * x - 0.5 * jnp.dot(xxt, x,
                                       preferred_element_type=jnp.float32,
                                       precision=hi)

    return jax.lax.fori_loop(0, steps, body, x)


@partial(jax.jit, static_argnames=("bits", "n_iter"))
def itq_fit(x: jnp.ndarray, r_init: jnp.ndarray, *, bits: int,
            n_iter: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Fit an ITQ model on a (n, d) float32 descriptor sample.

    :param x: (n, d) descriptor matrix (already normalized if requested).
    :param r_init: (bits, bits) random Gaussian matrix; orthogonalized here.
    :param bits: Code length (static; must be <= d).
    :param n_iter: Rotation refinement iterations (static; reference default
        50, itq.py:137-138).
    :return: (mean_vec (d,), rotation (d, bits)) — hashing is
        ``(v - mean_vec) @ rotation >= 0``.
    """
    x = x.astype(jnp.float32)
    n = x.shape[0]
    mean_vec = jnp.mean(x, axis=0)
    xc = x - mean_vec[None, :]

    # PCA: top-`bits` eigenvectors of the (symmetric) covariance.
    cov = jnp.dot(xc.T, xc, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST) \
        / jnp.maximum(n - 1, 1)
    _, eigvecs = jnp.linalg.eigh(cov)       # ascending eigenvalues
    pc_top = eigvecs[:, ::-1][:, :bits]      # (d, bits), descending

    v = jnp.dot(xc, pc_top, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)  # (n, bits)

    # Initial random orthogonal rotation (orthogonalize the Gaussian init).
    r0 = _polar(r_init.astype(jnp.float32))

    def body(_, r):
        z = jnp.dot(v, r, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        b = jnp.where(z >= 0, 1.0, -1.0)
        c = jnp.dot(b.T, v, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        # argmin_R ||B - V R||_F over orthogonal R is the orthogonal polar
        # factor of Cᵀ (C = BᵀV = S̄ Ω Ŝᵀ  =>  R = Ŝ S̄ᵀ = polar(Cᵀ)).
        return _polar(c.T)

    r = jax.lax.fori_loop(0, n_iter, body, r0)
    rotation = jnp.dot(pc_top, r, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    return mean_vec, rotation


@jax.jit
def hash_batch(x: jnp.ndarray, mean_vec: jnp.ndarray,
               rotation: jnp.ndarray) -> jnp.ndarray:
    """(n, d) descriptors -> (n, bits) boolean codes: one batched matmul+sign
    replacing the reference's per-descriptor Python loop
    (/root/reference/smqtk_indexing/impls/nn_index/lsh.py:316-321)."""
    z = jnp.dot(x.astype(jnp.float32) - mean_vec[None, :], rotation,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    return z >= 0
