"""
Device/layout helpers shared by all kernels: padding of the feature dim to
a multiple of 128 (the tensor-core-friendly width every kernel tiles by),
capacity scheduling for growable device arrays, and the one decision on
how the Pallas kernels run (compiled on a GPU, interpreted on the CPU).
"""
from __future__ import annotations

import numpy as np

LANE = 128

# Row-capacity quantum: device row counts are always 1024 * 2^m so any two
# capacities (and the scan chunk size) divide each other — keeps the jit
# cache small and streaming chunking exact.
_CAP_BASE = 1024


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``.

    >>> round_up(130, 128)
    256
    >>> round_up(128, 128)
    128
    """
    return -(-x // m) * m


def pow2_at_least(x: int, lo: int = 1) -> int:
    """Smallest power of two >= ``x``, floored at ``lo`` (itself assumed a
    power of two). The shape-rounding primitive every store uses to bound
    jit-cache growth on batch/k/window dims.

    >>> pow2_at_least(5)
    8
    >>> pow2_at_least(3, lo=8)
    8
    """
    p = lo
    while p < x:
        p *= 2
    return p


def pad_dim(d: int) -> int:
    """Pad feature dim to a multiple of 128.

    >>> pad_dim(100)
    128
    >>> pad_dim(300)
    384
    """
    return max(round_up(d, LANE), LANE)


def capacity_for(n: int) -> int:
    """Smallest 1024*2^m >= n.

    >>> capacity_for(1)
    1024
    >>> capacity_for(3000)
    4096
    """
    cap = _CAP_BASE
    while cap < n:
        cap *= 2
    return cap


def pad_rows_np(mat: np.ndarray, rows: int, cols: int,
                dtype=np.float32) -> np.ndarray:
    """Zero-pad a host matrix to (rows, cols)."""
    n, d = mat.shape
    out = np.zeros((rows, cols), dtype=dtype)
    out[:n, :d] = mat
    return out


#: Database rows per tile of the tiled layouts and the fused scan's
#: row-capacity quantum (capacities are 1024 * 2^m, so every capacity at
#: or above it divides evenly).
TILE_N = 4096

#: Segment width: rows that collapse to one stage-1 minimum in the
#: two-stage exact scans (ops/scan.streamed_segment_minima).
SEG = 128


def kernel_interpret(x) -> bool:
    """The one decision on how a Pallas kernel runs, taken from where its
    operands live (``x``: a ``jax.Array``, sharded or not):

    - ``gpu`` — compiled for the card (returns False);
    - ``cpu`` — the Pallas interpreter (returns True; what the tests run);
    - anything else — ``ValueError``: there is no kernel for it and no
      silent fallback.

    Call it outside ``jit`` (tracers carry no placement) and pass the
    result down as the kernels' static ``interpret`` argument.
    """
    platform = next(iter(x.devices())).platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise ValueError(
        f"No Pallas kernel tier for platform {platform!r}: the kernels "
        "compile for 'gpu' and interpret on 'cpu'.")


def on_gpu(x) -> bool:
    """True when ``x`` (a ``jax.Array``) lives on a GPU. The routing gates
    use it to choose the paths measured faster on the card (the two-stage
    flat scan, the ±1 Hamming engine); the CPU keeps the streaming XLA
    scans."""
    return next(iter(x.devices())).platform == "gpu"


def kernel_tier() -> str:
    """Which tier the compute kernels run at in this process:

    - ``"gpu-triton"`` — the default backend is a CUDA GPU; the Pallas
      kernels compile through Triton.
    - ``"cpu-interpret"`` — the CPU backend; the kernels execute through
      the Pallas interpreter.
      Correct, and what CI exercises, but a service operator should not
      serve traffic from this tier.
    - ``"unavailable"`` — jax failed to initialize a backend, or the
      backend is one the kernels do not support.
    """
    try:
        import jax
        backend = jax.default_backend()
    except Exception:  # pragma: no cover - broken jax install
        return "unavailable"
    return {"gpu": "gpu-triton", "cpu": "cpu-interpret"}.get(
        backend, "unavailable")


def device_report(flags: tuple = ()) -> dict:
    """Honest runtime-capability report shared by every impl's
    ``usability_report()`` (the reference gates ``is_usable()`` on
    backend importability, faiss.py:86-89; here the backend always
    imports but may be DEGRADED — this is the distinguishing signal).

    :param flags: env-var kill switches relevant to the caller (e.g.
        ``("SMQTK_TPU_NO_NATIVE",)``); any that are set are reported and
        mark the impl degraded.
    :return: dict with ``backend``, ``devices``, ``kernel_tier``,
        ``disabled_flags`` and the summary bool ``degraded`` (True when
        the kernels are not compiled for a GPU or any engine is
        flag-disabled).
    """
    import os
    tier = kernel_tier()
    try:
        import jax
        backend = jax.default_backend()
        n_dev = len(jax.devices())
    except Exception:  # pragma: no cover - broken jax install
        backend, n_dev = None, 0
    disabled = [f for f in flags if os.environ.get(f)]
    return {
        "backend": backend,
        "devices": n_dev,
        "kernel_tier": tier,
        "disabled_flags": disabled,
        "degraded": tier != "gpu-triton" or bool(disabled),
    }
