"""Wrapper of the dense-DP CUDA kernel (``csrc/dense_dp.cu``).

The kernel is the fused form of the JAX package's
``svecalign_tpu/ops/dp.py::dense_dp_scan`` (a ``lax.scan`` over
anti-diagonals) and ``dense_reassemble`` (the host gather into node
layout): a bucket of P ragged pairs in one launch, one thread block per
pair, the backpointer plane written in (N+1, M+1) node layout. It is
bound by its N + M + 1 dependent anti-diagonal steps (latency), not by
its traffic; see the source for the design.

On a CPU tensor the wrapper runs the plain version
(:func:`svecalign_tpu_torch.ops.dp.dense_dp_batched`); on a CUDA tensor it
launches the kernel or raises. ``LAUNCHES["dense_dp"]`` counts launches.
"""

import ctypes
from typing import Optional, Tuple

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.ops.dp_cuda import _check, _smem_optin

KERNEL = "dense_dp"

LAUNCHES = {KERNEL: 0}

MAX_THREADS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.dense_dp_smem_bytes.argtypes = [_I, _I]
        lib.dense_dp_smem_bytes.restype = ctypes.c_size_t
        lib.dense_dp_launch.argtypes = [
            _P, _P, _P, _P,  # costs, pens, x_sizes, y_sizes
            _I, _I, _I,  # P, N, M
            _P, _P, _I, _P,  # bp, csum (or null), threads, stream
        ]
        lib.dense_dp_launch.restype = _I
        lib._typed = True
    return lib


def block_threads(N: int, M: int) -> int:
    """Threads of a block: one per cell of the longest anti-diagonal
    (min(N, M) + 1 cells), in whole warps, at most MAX_THREADS (longer
    diagonals are looped over)."""
    return min(MAX_THREADS, -(-(min(N, M) + 1) // 32) * 32)


def dense_dp_cuda(
    costs: torch.Tensor,  # (P, N, M) float32
    pens: torch.Tensor,  # (P,) float32
    x_sizes: torch.Tensor,  # (P,) int32
    y_sizes: torch.Tensor,  # (P,) int32
    with_csum: bool = False,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Dense DP of a bucket of ragged pairs. Returns (csum, bp): bp
    (P, N+1, M+1) int8 in node layout (0 = diag, 1 = left, 2 = up, 4 at
    the origin, -1 outside a pair's (x_size+1, y_size+1) rectangle); csum
    (P, N+1, M+1) float32 (+inf outside) when ``with_csum``, else None (the
    traceback never reads it)."""
    dev = costs.device
    if dev.type == "cpu":
        csum, bp = dp_ops.dense_dp_batched(costs, pens, x_sizes, y_sizes)
        return (csum if with_csum else None), bp
    if dev.type != "cuda":
        raise ValueError(f"dense_dp_cuda: unsupported device {dev}")
    if costs.dim() != 3:
        raise ValueError(f"costs must be (P, N, M), got {tuple(costs.shape)}")
    P, N, M = costs.shape
    _check("costs", costs, torch.float32, (P, N, M), dev)
    _check("pens", pens, torch.float32, (P,), dev)
    _check("x_sizes", x_sizes, torch.int32, (P,), dev)
    _check("y_sizes", y_sizes, torch.int32, (P,), dev)

    bp = torch.full((P, N + 1, M + 1), -1, dtype=torch.int8, device=dev)
    csum = None
    if with_csum:
        csum = torch.full((P, N + 1, M + 1), dp_ops.INF, dtype=torch.float32, device=dev)
    if P == 0:
        return csum, bp

    lib = _lib()
    smem = lib.dense_dp_smem_bytes(N, M)
    if smem > _smem_optin(dev.index or 0):
        raise ValueError(
            f"dense_dp_cuda: a diagonal of {min(N, M) + 1} cells needs {smem} bytes of "
            "shared memory, more than a block may have"
        )
    with torch.cuda.device(dev):
        err = lib.dense_dp_launch(
            costs.data_ptr(), pens.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(),
            P, N, M, bp.data_ptr(), None if csum is None else csum.data_ptr(),
            block_threads(N, M), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_dp kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, KERNEL)
    return csum, bp
