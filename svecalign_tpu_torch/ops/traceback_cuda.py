"""Wrappers of the traceback-walk CUDA kernels (``csrc/traceback_walk.cu``).

The kernels are the fused forms of the JAX package's
``svecalign_tpu/ops/dp.py::dense_traceback_scan`` and
``banded_traceback_scan`` (``lax.scan`` programs of N + M + 1 and A + 2
steps): every pair of a bucket follows its backpointers from
(x_size, y_size) to the origin on the card, and only the visited path is
pulled instead of the planes. Each is a chain of dependent loads
(latency-bound); see the source.

On CPU tensors the wrappers run the plain versions
(:func:`svecalign_tpu_torch.ops.dp.dense_traceback_walk`,
:func:`svecalign_tpu_torch.ops.dp.banded_traceback_walk`); on CUDA tensors
they launch the kernels or raise. ``LAUNCHES`` counts launches by kernel.
"""

import ctypes

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.ops.dp_cuda import _check

SOURCE = "traceback_walk"
DENSE, BANDED = "dense_traceback_walk", "banded_traceback_walk"

LAUNCHES = {DENSE: 0, BANDED: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.dense_walk_launch.argtypes = [
            _P, _P, _P, _I, _I, _I,  # bp, x_sizes, y_sizes, P, N, M
            _P, _P, _P, _P,  # xs, ys, vs, stream
        ]
        lib.dense_walk_launch.restype = _I
        lib.banded_walk_launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # csum, xp, yp, boff_out, x_sizes, y_sizes
            _I, _I, _I, _I,  # P, A + 2, B, bp_int8
            _P, _P, _P, _P, _P, _P,  # xs, ys, xps, yps, cs, stream
        ]
        lib.banded_walk_launch.restype = _I
        lib._typed = True
    return lib


def dense_traceback_walk_cuda(bp: torch.Tensor, x_sizes: torch.Tensor, y_sizes: torch.Tensor):
    """Walk the node-layout dense planes ``bp`` (P, N+1, M+1) int8 from
    (x_sizes[p], y_sizes[p]) to the origin. Returns (xs, ys (P, N+M+1)
    int32, vs (P, N+M+1) int8)."""
    dev = bp.device
    if dev.type == "cpu":
        return dp_ops.dense_traceback_walk(bp, x_sizes, y_sizes)
    if dev.type != "cuda":
        raise ValueError(f"dense_traceback_walk_cuda: unsupported device {dev}")
    if bp.dim() != 3:
        raise ValueError(f"bp must be (P, N+1, M+1), got {tuple(bp.shape)}")
    P, rmax, cmax = bp.shape
    _check("bp", bp, torch.int8, (P, rmax, cmax), dev)
    _check("x_sizes", x_sizes, torch.int32, (P,), dev)
    _check("y_sizes", y_sizes, torch.int32, (P,), dev)
    steps = rmax + cmax - 1
    xs = torch.empty((P, steps), dtype=torch.int32, device=dev)
    ys = torch.empty((P, steps), dtype=torch.int32, device=dev)
    vs = torch.empty((P, steps), dtype=torch.int8, device=dev)
    if P == 0:
        return xs, ys, vs
    with torch.cuda.device(dev):
        err = _lib().dense_walk_launch(
            bp.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(), P, rmax - 1, cmax - 1,
            xs.data_ptr(), ys.data_ptr(), vs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_traceback_walk kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, DENSE)
    return xs, ys, vs


def banded_traceback_walk_cuda(
    csum: torch.Tensor,  # (P, A+2, B) float32
    xp: torch.Tensor,  # (P, A+2, B) int8 or int32
    yp: torch.Tensor,  # (P, A+2, B)
    b_offset_out: torch.Tensor,  # (P, A+2) int32
    x_sizes: torch.Tensor,  # (P,) int32
    y_sizes: torch.Tensor,  # (P,) int32
):
    """Walk the banded planes from (x_sizes[p], y_sizes[p]) to the origin.
    Returns (xs, ys (P, A+2) int32, xps, yps (P, A+2) in the planes' dtype,
    cs (P, A+2) float32)."""
    dev = xp.device
    if dev.type == "cpu":
        return dp_ops.banded_traceback_walk(csum, xp, yp, b_offset_out, x_sizes, y_sizes)
    if dev.type != "cuda":
        raise ValueError(f"banded_traceback_walk_cuda: unsupported device {dev}")
    if xp.dim() != 3:
        raise ValueError(f"xp must be (P, A+2, B), got {tuple(xp.shape)}")
    if xp.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"backpointers must be int8 or int32, got {xp.dtype}")
    P, a2, B = xp.shape
    _check("csum", csum, torch.float32, (P, a2, B), dev)
    _check("xp", xp, xp.dtype, (P, a2, B), dev)
    _check("yp", yp, xp.dtype, (P, a2, B), dev)
    _check("b_offset_out", b_offset_out, torch.int32, (P, a2), dev)
    _check("x_sizes", x_sizes, torch.int32, (P,), dev)
    _check("y_sizes", y_sizes, torch.int32, (P,), dev)
    xs = torch.empty((P, a2), dtype=torch.int32, device=dev)
    ys = torch.empty((P, a2), dtype=torch.int32, device=dev)
    xps = torch.empty((P, a2), dtype=xp.dtype, device=dev)
    yps = torch.empty((P, a2), dtype=xp.dtype, device=dev)
    cs = torch.empty((P, a2), dtype=torch.float32, device=dev)
    if P == 0:
        return xs, ys, xps, yps, cs
    with torch.cuda.device(dev):
        err = _lib().banded_walk_launch(
            csum.data_ptr(), xp.data_ptr(), yp.data_ptr(), b_offset_out.data_ptr(),
            x_sizes.data_ptr(), y_sizes.data_ptr(), P, a2, B, int(xp.dtype == torch.int8),
            xs.data_ptr(), ys.data_ptr(), xps.data_ptr(), yps.data_ptr(), cs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"banded_traceback_walk kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, BANDED)
    return xs, ys, xps, yps, cs
