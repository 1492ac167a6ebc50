"""
SQ8 list-scan kernel of the IVF code tier (ops/ivf_tiled.py), Pallas
through Triton.

One program per (query, probe slot): it loads its own window indices
(tile, start column, live [lo, hi) columns), loads only the live columns
of its (d, W) window of the tiled-transposed int8 codes under a mask (dead
slots load nothing), and scores them in f32 as ``s2 - 2 <t, u>`` with
``t`` the query-side codec fold. The plain XLA form gathers every full
window instead; this kernel measured faster end to end on the card
(PERF.md). It compiles for the GPU and runs in the Pallas interpreter on
the CPU (ops/device.kernel_interpret decides which).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Width of one probe window (columns). Sublists are cut at W rows and at
#: tile edges (ops/ivf_tiled.build_tiled_csr), so a window starting at
#: ``min(col, TILE_ROWS - W)`` covers any sublist.
W = 512

#: Code rows (dims) loaded per step of the SQ8 window scan (the largest
#: power of two dividing d, at most this): a (step, W) slice keeps one
#: program's live values in registers.
ROWS_STEP = 16


def _window_mask(lo_ref, hi_ref):
    lane = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    return (lane >= lo_ref[0]) & (lane < hi_ref[0])


def _window_rows(db_ref, ti, c0, r0, rows, ok):
    """(rows, W) slice of one window, live columns only (dead columns
    and dead slots load nothing)."""
    return plgpu.load(db_ref.at[ti, pl.ds(r0, rows), pl.ds(c0, W)],
                      mask=jnp.broadcast_to(ok[None, :], (rows, W)),
                      other=0)


def _list_kernel(ti_ref, c0_ref, lo_ref, hi_ref, t_ref, db_ref, s2_ref,
                 out_ref):
    """SQ8 window score ``s2 - 2 <t, u>`` (f32 math over exactly
    represented code values; +inf outside the live columns)."""
    ok = _window_mask(lo_ref, hi_ref)
    ti, c0 = ti_ref[0], c0_ref[0]
    d = db_ref.shape[1]
    step = math.gcd(ROWS_STEP, d)
    ip = jnp.zeros((W,), jnp.float32)
    for r0 in range(0, d, step):
        codes = _window_rows(db_ref, ti, c0, r0, step, ok)
        t = t_ref[0, r0:r0 + step]
        ip += jnp.sum(codes.astype(jnp.float32) * t[:, None], axis=0)
    s2 = plgpu.load(s2_ref.at[ti, 0, pl.ds(c0, W)], mask=ok, other=0.0)
    out_ref[0, 0, :] = jnp.where(ok, s2 - 2.0 * ip, jnp.inf)


@partial(jax.jit, static_argnames=("interpret",))
def list_scores(db3, s2t, t, ti, c0, lo, hi, *, interpret: bool):
    """
    :param db3: (n_tiles, d, TILE_ROWS) int8 SQ8 codes.
    :param s2t: (n_tiles, 1, TILE_ROWS) float32 per-row sum((a*u)^2)
        (+inf on dead rows).
    :param t: (B, d) float32 query-side codec fold (q - b_codec) * a.
    :param ti/c0/lo/hi: (B, P) int32 windows (ops/ivf_tiled._windows).
    :param interpret: ops/device.kernel_interpret of the operands.
    :return: (B, P, W) float32 surrogate scores, +inf outside windows.
    """
    b, p = ti.shape
    scalar = pl.BlockSpec((1,), lambda i, j: (i * p + j,))
    return pl.pallas_call(
        _list_kernel,
        grid=(b, p),
        in_specs=[scalar, scalar, scalar, scalar,
                  pl.BlockSpec((1, t.shape[1]), lambda i, j: (i, 0)),
                  pl.BlockSpec(db3.shape, lambda i, j: (0, 0, 0)),
                  pl.BlockSpec(s2t.shape, lambda i, j: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, W), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((b, p, W), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ivf_list_scan",
    )(ti.reshape(-1), c0.reshape(-1), lo.reshape(-1), hi.reshape(-1),
      t.astype(jnp.float32), db3, s2t)
