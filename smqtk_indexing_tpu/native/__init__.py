"""
Native (C++) host runtime: on-demand g++ build + ctypes bindings with
transparent numpy fallback.

See ``_native.cpp`` for what is native and why. ``lib()`` returns the
loaded ctypes library or None when compilation is unavailable; the
functional wrappers below always work (falling back to numpy), so callers
never branch.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

LOG = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "_native.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_dir() -> str:
    d = os.environ.get("SMQTK_TPU_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), "smqtk_native")
    os.makedirs(d, exist_ok=True)
    return d


def lib() -> Optional[ctypes.CDLL]:
    """Compile (once, content-hashed cache) and load the native library."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SMQTK_TPU_NO_NATIVE"):
            return None
        try:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            so_path = os.path.join(_build_dir(), f"_native_{tag}.so")
            if not os.path.exists(so_path):
                cmd = ["g++", "-O3", "-march=native", "-std=c++17",
                       "-shared", "-fPIC", _SRC, "-o", so_path + ".tmp"]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(so_path + ".tmp", so_path)
                LOG.info("Built native library: %s", so_path)
            cdll = ctypes.CDLL(so_path)
            cdll.pack_bits_u32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            cdll.unpack_bits_u32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            cdll.hamming_topk_host.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            for fn in ("read_fvecs", "read_bvecs"):
                g = getattr(cdll, fn)
                g.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_void_p]
                g.restype = ctypes.c_int64
            _lib = cdll
        except Exception:
            LOG.warning("Native library unavailable; using numpy "
                        "fallbacks.", exc_info=True)
            _lib = None
        return _lib


def available() -> bool:
    return lib() is not None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def pack_bits(bools: np.ndarray) -> np.ndarray:
    """(n, bits) bool -> (n, ceil(bits/32)) uint32 (native or numpy)."""
    bools = np.ascontiguousarray(bools, dtype=np.uint8)
    n, bits = bools.shape
    words = (bits + 31) // 32
    cdll = lib()
    if cdll is None:
        from smqtk_indexing_tpu.utils import bits as bits_util
        return bits_util.pack_bit_vectors_u32(bools.astype(bool))
    out = np.empty((n, words), dtype=np.uint32)
    cdll.pack_bits_u32(_ptr(bools), n, bits, _ptr(out))
    return out


def unpack_bits(packed: np.ndarray, bits: int) -> np.ndarray:
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n = packed.shape[0]
    cdll = lib()
    if cdll is None:
        from smqtk_indexing_tpu.utils import bits as bits_util
        return bits_util.unpack_bit_vectors_u32(packed, bits)
    out = np.empty((n, bits), dtype=np.uint8)
    cdll.unpack_bits_u32(_ptr(packed), n, bits, _ptr(out))
    return out.astype(bool)


def hamming_topk(db: np.ndarray, valid: np.ndarray, q: np.ndarray,
                 k: int) -> Tuple[np.ndarray, np.ndarray]:
    """
    Host Hamming top-k over (n, words) packed codes for (b, words) queries.
    Ascending (dists (b, k) int32, rows (b, k) int32); unfilled slots
    INT32_MAX / -1.
    """
    db = np.ascontiguousarray(db, dtype=np.uint32)
    q = np.ascontiguousarray(q, dtype=np.uint32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    n, words = db.shape
    b = q.shape[0]
    cdll = lib()
    if cdll is None:
        # numpy fallback: popcount via uint8 view + bit-count LUT.
        lut = np.array([bin(i).count("1") for i in range(256)],
                       dtype=np.int32)
        d8 = db.view(np.uint8).reshape(n, -1)
        q8 = q.view(np.uint8).reshape(b, -1)
        dists = lut[d8[None, :, :] ^ q8[:, None, :]].sum(-1)
        dists = np.where(valid[None, :].astype(bool), dists,
                         np.iinfo(np.int32).max)
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        dd = np.take_along_axis(dists, order, axis=1).astype(np.int32)
        rr = order.astype(np.int32)
        rr[dd == np.iinfo(np.int32).max] = -1
        if dd.shape[1] < k:  # fewer rows than k: pad like the native path
            pad = k - dd.shape[1]
            dd = np.pad(dd, ((0, 0), (0, pad)), constant_values=np.iinfo(
                np.int32).max)
            rr = np.pad(rr, ((0, 0), (0, pad)), constant_values=-1)
        return dd, rr
    out_d = np.empty((b, k), dtype=np.int32)
    out_r = np.empty((b, k), dtype=np.int32)
    cdll.hamming_topk_host(_ptr(db), _ptr(valid), _ptr(q), n, words, b, k,
                           _ptr(out_d), _ptr(out_r))
    return out_d, out_r


def read_vecs(path: str, max_n: int, dim: int) -> np.ndarray:
    """
    Read a TexMex .fvecs/.bvecs file into a (rows, dim) float32 matrix
    (native fast path; numpy fallback).

    :raises IOError: unreadable file.
    :raises ValueError: row dimensionality mismatch.
    """
    is_b = path.endswith(".bvecs")
    cdll = lib()
    if cdll is not None:
        out = np.empty((max_n, dim), dtype=np.float32)
        fn = cdll.read_bvecs if is_b else cdll.read_fvecs
        r = fn(path.encode(), max_n, dim, _ptr(out))
        if r == -1:
            raise IOError(f"Cannot open {path}")
        if r == -2:
            raise ValueError(f"Malformed vec file {path} (dim != {dim})")
        return out[:r]
    raw = np.fromfile(path, dtype=np.uint8 if is_b else np.float32)
    if is_b:
        row_bytes = 4 + dim
        rows = min(len(raw) // row_bytes, max_n)
        mat = raw[:rows * row_bytes].reshape(rows, row_bytes)
        # Per-row dim header check, mirroring the fvecs fallback (and the
        # native reader's -2 contract): a malformed .bvecs must raise, not
        # silently misparse.
        dims = np.ascontiguousarray(mat[:, :4]).view(np.int32).ravel()
        if rows and not np.all(dims == dim):
            raise ValueError(f"Malformed vec file {path} (dim != {dim})")
        return mat[:, 4:].astype(np.float32)
    row_words = 1 + dim
    rows = min(len(raw) // row_words, max_n)
    mat = raw[:rows * row_words].reshape(rows, row_words)
    dims = mat[:, 0].view(np.int32)
    if rows and not np.all(dims == dim):
        raise ValueError(f"Malformed vec file {path} (dim != {dim})")
    return mat[:, 1:].copy()
