"""Wrapper of the dense-DP CUDA kernel (``csrc/dense_dp.cu``).

The kernel is the fused form of the JAX package's
``svecalign_tpu/ops/dp.py::dense_dp_scan`` (a ``lax.scan`` over
anti-diagonals) and ``dense_reassemble`` (the host gather into node
layout): a bucket of P ragged pairs in one launch, one thread block per
pair, the backpointer plane written in (N+1, M+1) node layout. It is
bound by its N + M + 1 dependent anti-diagonal steps (latency), not by
its traffic: strips of rows, a few rows a lane, so that a step's chain
stays inside one warp; costs and backpointers pass through shared-memory
tiles. See the source for the design. The wrapper launches by the
source's own geometry; :func:`dense_dp_plan` is its Python copy.

On a CPU tensor the wrapper runs the plain version
(:func:`svecalign_tpu_torch.ops.dp.dense_dp_batched`); on a CUDA tensor it
launches the kernel or raises. ``LAUNCHES["dense_dp"]`` counts launches.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.ops.dp_cuda import _check, _smem_optin

KERNEL = "dense_dp"

LAUNCHES = {KERNEL: 0}

# the source's DP_MAX_WARPS, DP_MAX_ROWS, DP_STATIC_SMEM and warp_smem(R)
MAX_WARPS = 8  # compute warps; a helper warp each
MAX_ROWS = 2
STATIC_SMEM = 1024


def warp_smem(rows: int) -> int:
    """Shared memory of one warp at ``rows`` rows a lane: for each row of a
    lane and each of two blocks a 32 x 33 fp32 cost tile and a 32 x 36-byte
    bp tile, and a queue of 256 8-byte entries to the next strip."""
    return rows * (2 * 32 * 33 * 4 + 2 * 32 * 36) + 256 * 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.dense_dp_plan.argtypes = [_I, _I, _I, _P]
        lib.dense_dp_plan.restype = _I
        lib.dense_dp_launch.argtypes = [
            _P, _P, _P, _P,  # costs, pens, x_sizes, y_sizes
            _I, _I, _I,  # P, N, M
            _P, _P, _P, _I, _P,  # bp, csum (or null), wrap (or null), smem_optin, stream
        ]
        lib.dense_dp_launch.restype = _I
        lib._typed = True
    return lib


class DensePlan(NamedTuple):
    warps: int  # a block's warps: one per strip of 32 x rows rows
    smem_bytes: int  # dynamic shared memory of a block
    wrap: bool  # strips can outnumber the warps: the launch takes a wrap queue
    rows: int  # rows a lane


def dense_dp_plan(N: int, M: int, smem_optin: int) -> DensePlan:
    """The launch geometry over (N, M) cost matrices, a copy of the source's
    ``dense_dp_plan`` for the CPU tests, which have no nvcc to build the
    source (the wrapper calls the source's own; ``chip_smoke.py`` holds
    the two to each other): rows on lanes, ceil(N / 256) rows a lane
    (eight warps take up to 512 rows), at most MAX_ROWS; a compute warp
    per strip of 32 x rows rows (and a helper warp each that moves its
    tiles), at most MAX_WARPS and as many as ``smem_optin`` bytes of
    shared memory hold (``warp_smem`` each); strips past the last warp go
    round again, and the last warp hands over to the first through a queue
    of M 8-byte entries a pair in device memory (``wrap``). Raises
    ValueError where ``smem_optin`` does not hold the warps needed (one
    for a single strip, else two)."""
    rows = min(max(-(-N // 256), 1), MAX_ROWS)
    strips = -(-N // (32 * rows))
    warps = min(max(strips, 1), MAX_WARPS, (smem_optin - STATIC_SMEM) // warp_smem(rows))
    need = 2 if strips > 1 else 1
    if warps < need:
        raise ValueError(
            f"dense_dp_cuda: {need} warp(s) of {warp_smem(rows)} bytes of shared memory for "
            f"{N} x {M} costs do not fit the {smem_optin} bytes a block may have")
    return DensePlan(warps, warps * warp_smem(rows), strips > warps, rows)


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

    # the kernel writes every node, the -1 / +inf outside each rectangle too
    bp = torch.empty((P, N + 1, M + 1), dtype=torch.int8, device=dev)
    csum = torch.empty((P, N + 1, M + 1), dtype=torch.float32, device=dev) if with_csum else None
    if P == 0:
        return csum, bp

    lib = _lib()
    smem_optin = _smem_optin(dev.index or 0)
    plan = (ctypes.c_int * 4)()  # warps, shared memory, wrap, rows a lane
    if lib.dense_dp_plan(N, M, smem_optin, plan) != 0:
        raise ValueError(
            f"dense_dp_cuda: {plan[0]} warp(s) of {plan[1] // plan[0]} bytes of shared memory "
            f"for {N} x {M} costs do not fit the {smem_optin} bytes a block may have")
    wrap = torch.empty((P, M), dtype=torch.int64, device=dev) if plan[2] else None
    with torch.cuda.device(dev):
        err = lib.dense_dp_launch(
            costs.data_ptr(), pens.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(),
            P, N, M, bp.data_ptr(), None if csum is None else csum.data_ptr(),
            None if wrap is None else wrap.data_ptr(), smem_optin,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_dp kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, KERNEL)
    return csum, bp
