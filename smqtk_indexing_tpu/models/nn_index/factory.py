"""
FAISS-style factory-string construction.

Convenience parity with the reference's ``factory_string`` configuration
surface (/root/reference/smqtk_indexing/impls/nn_index/faiss.py:182-199 —
``faiss.index_factory('IDMap,Flat')`` etc.): maps the common factory
strings onto this package's implementations so configs written against the
FAISS wrapper translate mechanically.

Supported grammar (comma-separated, 'IDMap' prefix ignored — UID mapping is
always on here):

- ``Flat``                      -> FlatNearestNeighborsIndex
- ``SQ8``                       -> FlatNearestNeighborsIndex(dtype='sq8')
  (int8 scalar quantization, 4x capacity — the FAISS ``SQ8`` codec)
- ``SQfp16``                    -> dtype='bfloat16' (half storage; bf16
  keeps f32's exponent range at the same 2 bytes/dim and is the tensor
  cores' half format); ``SQ4``/``SQ6`` are rejected
  with a pointer to SQ8/PQ
- ``PQ<M>`` / ``PQ<M>x8``       -> FlatNearestNeighborsIndex(
  dtype='pq<M>') (product quantization, M bytes/vector: ~32x capacity at
  d=128/PQ16 — served by the dequantize-then-scan matrix formulation,
  ops/pq.py; only 8-bit sub-codes are supported, as in the reference's
  default)
- ``IVF<nlist>,Flat``           -> IvfNearestNeighborsIndex(n_lists=nlist)
- ``IVF<nlist>,SQ8``            -> IvfNearestNeighborsIndex(n_lists=nlist,
  dtype='sq8')
- ``IVF<nlist>,PQ<M>``          -> IvfNearestNeighborsIndex(n_lists=nlist,
  dtype='pq<M>', pq_residual=True for L2 (and for cosine when
  storage='code' — unit-sphere codes make the L2 residual pipeline
  cosine ranking) — FAISS builds this factory config with
  ``by_residual=True``, so codes quantize x - centroid(list); pass
  ``pq_residual=False`` for raw-row codes; inner_product opts out
  automatically)
- ``OPQ<M>,PQ<M>`` / ``OPQ<M>,IVF<nlist>,PQ<M>`` -> the same with
  dtype='opq<M>' (FAISS's OPQ rotation pre-transform, faiss.py:182-199:
  an orthogonal matrix learned to minimize PQ reconstruction error —
  ops/opq.py; the OPQ<M> and PQ<M> subquantizer counts must agree, and
  the dimension-reducing ``OPQ<M>_<D>`` form is not supported)

Extra constructor options pass through ``kwargs`` — notably
``storage='code'`` turns 'IVF<n>,SQ8' / 'IVF<n>,PQ<M>' into the
code-resident tier (codes-only host mirror + the tiled list
scan; FAISS's own IVF codecs likewise never retain float
originals).
"""
from __future__ import annotations

import re
from typing import Any

from smqtk_indexing_tpu.models.nn_index.flat import FlatNearestNeighborsIndex
from smqtk_indexing_tpu.models.nn_index.ivf import IvfNearestNeighborsIndex

_METRIC_MAP = {
    # Reference metric labels (faiss.py:51-67) -> our metric names.
    "l2": "euclidean",
    "euclidean": "euclidean",
    "ip": "inner_product",
    "inner_product": "inner_product",
    "cosine": "cosine",
}


def index_from_factory_string(factory_string: str,
                              metric: str = "l2",
                              **kwargs: Any):
    """
    Build an index from a FAISS-style factory string.

    :param factory_string: e.g. ``'Flat'``, ``'IDMap,Flat'``,
        ``'IVF4096,Flat'``.
    :param metric: Reference metric label ('l2' | 'ip' | 'cosine' | ...).
    :param kwargs: Forwarded to the implementation constructor.
    :raises ValueError: Unsupported factory string or metric label.
    """
    if metric.lower() not in _METRIC_MAP:
        raise ValueError(
            f"Unsupported metric label {metric!r}; "
            f"supported: {sorted(_METRIC_MAP)}")
    m = _METRIC_MAP[metric.lower()]
    parts = [p.strip() for p in factory_string.split(",")
             if p.strip() and p.strip().lower() != "idmap"]
    # 'SQfp16' (FAISS's half-precision scalar quantizer) maps to the
    # bfloat16 tier: same 2 bytes/dim and intent (half storage, near-f32
    # recall); bf16 keeps f32's exponent range and is the tensor cores'
    # half format.
    codecs = {"flat": "float32", "sq8": "sq8", "sqfp16": "bfloat16"}
    for p in parts:
        if re.fullmatch(r"SQ[46]", p, flags=re.IGNORECASE):
            raise ValueError(
                f"{factory_string!r}: 4/6-bit scalar quantizers are not "
                "supported; use 'SQ8' (4x) or 'PQ<M>' (up to 32x+) for "
                "the capacity axis.")

    opq_m = None
    if parts and re.fullmatch(r"OPQ(\d+)", parts[0],
                              flags=re.IGNORECASE):
        opq_m = int(parts[0][3:])
        parts = parts[1:]
    elif parts and re.fullmatch(r"OPQ\d+_\d+", parts[0],
                                flags=re.IGNORECASE):
        raise ValueError(
            f"{factory_string!r}: the dimension-reducing 'OPQ<M>_<D>' "
            "pre-transform is not supported (rotation-only 'OPQ<M>' is).")

    def _pq_dtype(part: str):
        pq = re.fullmatch(r"PQ(\d+)(x8)?", part, flags=re.IGNORECASE)
        if pq is None:
            return None
        m_sub = int(pq.group(1))
        if opq_m is not None:
            if opq_m != m_sub:
                raise ValueError(
                    f"{factory_string!r}: OPQ{opq_m} pre-transform must "
                    f"match the PQ subquantizer count (PQ{m_sub}).")
            return f"opq{m_sub}"
        return f"pq{m_sub}"

    if opq_m is not None and not any(_pq_dtype(p) for p in parts):
        raise ValueError(
            f"{factory_string!r}: 'OPQ<M>' is a PQ pre-transform — it "
            "must be followed by a matching 'PQ<M>' codec.")
    if len(parts) == 1:
        if parts[0].lower() in codecs:
            return FlatNearestNeighborsIndex(
                metric=m, dtype=codecs[parts[0].lower()], **kwargs)
        pq_dt = _pq_dtype(parts[0])
        if pq_dt is not None:
            return FlatNearestNeighborsIndex(metric=m, dtype=pq_dt,
                                             **kwargs)
        if re.fullmatch(r"PQ\d+x\d+", parts[0], flags=re.IGNORECASE):
            raise ValueError(
                f"{factory_string!r}: only 8-bit PQ sub-codes are "
                "supported (e.g. 'PQ16' or 'PQ16x8').")
    ivf = re.fullmatch(r"IVF(\d+)", parts[0], flags=re.IGNORECASE)
    if ivf and len(parts) == 2 and parts[1].lower() in codecs:
        return IvfNearestNeighborsIndex(
            metric=m, n_lists=int(ivf.group(1)),
            dtype=codecs[parts[1].lower()], **kwargs)
    if ivf and len(parts) == 2 and _pq_dtype(parts[1]) is not None:
        # FAISS builds 'IVF<n>,PQ<M>' with by_residual=True (L2): codes
        # quantize x - centroid(list). Match that default here; explicit
        # kwargs override/opt out. Cosine gets the same default on the
        # code tier only (its codes carry unit-sphere rows, so the L2
        # residual pipeline IS cosine ranking there); inner_product has
        # no residual mode.
        kwargs.setdefault(
            "pq_residual",
            m == "euclidean"
            or (m == "cosine" and kwargs.get("storage") == "code"))
        return IvfNearestNeighborsIndex(
            metric=m, n_lists=int(ivf.group(1)),
            dtype=_pq_dtype(parts[1]), **kwargs)
    raise ValueError(
        f"Unsupported factory string {factory_string!r}; supported: "
        "'Flat', 'IDMap,Flat', 'SQ8', 'IDMap,SQ8', 'PQ<M>', "
        "'IVF<nlist>,Flat', 'IVF<nlist>,SQ8', 'IVF<nlist>,PQ<M>', "
        "'OPQ<M>,PQ<M>', 'OPQ<M>,IVF<nlist>,PQ<M>'.")
