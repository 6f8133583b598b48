"""ctypes binding to the host DPs with float64 accumulation
(``csrc/dp_core.cpp``).

Port of the JAX package's ``ops/dp_native.py``: the ``native`` banded-DP
backend of the per-pair aligner (``--dp_backend native``), and a float64
parity oracle for the float32 DPs. The source is the port's own copy of
``native/dp_core.cpp``; g++ builds it at first use into
``svecalign_tpu_torch/build/`` with ``native/build.py``'s flags, so that
the two packages' builds agree bit for bit. ``native/`` is never loaded,
and a failed build raises.
"""

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.ops._build import build_host_library

# native/build.py's flags: the same compiler and flags give the same bits
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build_host_library("dp_core", GXX_FLAGS)))
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.sva_dense_dp.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, f64p, i32p]
            lib.sva_dense_dp.restype = None
            lib.sva_banded_dp.argtypes = [
                f32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i32p, i32p, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                f64p, i32p, i32p, i32p]
            lib.sva_banded_dp.restype = None
            _lib_handle = lib
    return _lib_handle


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _host_f32(costs) -> np.ndarray:
    """Contiguous float32 host costs from a tensor on any device or an array."""
    if isinstance(costs, torch.Tensor):
        costs = costs.detach().float().cpu().numpy()
    return np.ascontiguousarray(costs, dtype=np.float32)


def dense_dp_native(costs, pen: float) -> Tuple[np.ndarray, np.ndarray]:
    """(n, m) float32 costs -> (csum float64, bp int32), sizes + 1."""
    costs = _host_f32(costs)
    if costs.ndim != 2:
        raise ValueError(f"dense costs must be (n, m), got {costs.shape}")
    n, m = costs.shape
    csum = np.empty((n + 1, m + 1), dtype=np.float64)
    bp = np.empty((n + 1, m + 1), dtype=np.int32)
    _lib().sva_dense_dp(_ptr(costs, ctypes.c_float), n, m, pen,
                        _ptr(csum, ctypes.c_double), _ptr(bp, ctypes.c_int32))
    return csum, bp


def run_banded_dp_native(
    costs,
    b_offset_in: np.ndarray,
    alignment_types: List[Tuple[int, int]],
    del_penalty: float,
    x_in_size: int,
    y_in_size: int,
):
    """Same contract as ``ops.dp.run_banded_dp`` (host csum float64, xp,
    yp, b_offset_out), float64 accumulation. ``costs`` (T, A, B) may lie
    on the card: it comes to the host here, once per level, as in JAX."""
    costs = _host_f32(costs)
    if costs.ndim != 3:
        raise ValueError(f"banded costs must be (T, A, B), got {costs.shape}")
    T, A, B = costs.shape
    if len(alignment_types) != T:
        raise ValueError(f"{len(alignment_types)} alignment types for {T} cost planes")
    b_off = np.ascontiguousarray(b_offset_in, dtype=np.int32)
    if b_off.shape != (A,):
        raise ValueError(f"b_offset must be ({A},), got {b_off.shape}")
    xo = np.ascontiguousarray([x for x, _ in alignment_types], dtype=np.int32)
    yo = np.ascontiguousarray([y for _, y in alignment_types], dtype=np.int32)

    csum = np.empty((A + 2, B), dtype=np.float64)
    xp = np.empty((A + 2, B), dtype=np.int32)
    yp = np.empty((A + 2, B), dtype=np.int32)
    b_off_out = np.empty((A + 2,), dtype=np.int32)
    _lib().sva_banded_dp(
        _ptr(costs, ctypes.c_float), _ptr(b_off, ctypes.c_int32), T, A, B,
        _ptr(xo, ctypes.c_int32), _ptr(yo, ctypes.c_int32),
        del_penalty, x_in_size, y_in_size,
        _ptr(csum, ctypes.c_double), _ptr(xp, ctypes.c_int32),
        _ptr(yp, ctypes.c_int32), _ptr(b_off_out, ctypes.c_int32),
    )
    return csum, xp, yp, b_off_out
