"""Wrappers of the traceback-walk CUDA kernels (``csrc/traceback_walk.cu``).

The kernels are the fused forms of the JAX package's
``svecalign_tpu/ops/dp.py::dense_traceback_scan`` and
``banded_traceback_scan`` (``lax.scan`` programs of N + M + 1 and A + 2
steps): every pair of a bucket follows its backpointers from
(x_size, y_size) to the origin on the card, and only the visited path is
pulled instead of the planes. Each is a chain of dependent steps
(latency-bound), and both take every device-memory load off it. The dense
walk: a copier warp streams the pair's int8 plane, from the walk's start
down, into a ring of shared-memory slots by 1-D bulk copies (TMA) ahead of
one walking thread, which makes one shared-memory load and two
multiply-adds a step and stops at the first cell that does not move. The
banded walk: producer warps turn the planes into a ring of successor
indices in shared memory ahead of the walking thread, which follows one
shared-memory load a step and stops at the origin. In both the block writes the outputs
afterwards. The wrappers launch by the sources' own ring plans;
:func:`dense_walk_plan` and :func:`banded_walk_plan` are their Python
copies. See the source.

On CPU tensors the wrappers run the plain versions
(:func:`svecalign_tpu_torch.ops.dp.dense_traceback_walk`,
:func:`svecalign_tpu_torch.ops.dp.banded_traceback_walk`); on CUDA tensors
they launch the kernels or raise. ``LAUNCHES`` counts launches by kernel.
A launch's host work is kept small: each ring plan is read once per
shape, the stream is read raw, the source makes the tensors' device
current, and the outputs come from two or three allocations.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.ops.dp_cuda import _check, _smem_optin

SOURCE = "traceback_walk"
DENSE, BANDED = "dense_traceback_walk", "banded_traceback_walk"

LAUNCHES = {DENSE: 0, BANDED: 0}

# the source's WALK_CHUNK_SHIFT, WALK_RING_BYTES, WALK_MAX_SLOTS,
# WALK_MAX_RECORDS, WALK_STATIC_SMEM (the banded walk)
WALK_CHUNK_SHIFT = 9
WALK_RING_BYTES = 1 << 16
WALK_MAX_SLOTS = 64
WALK_MAX_RECORDS = 1 << 14
WALK_STATIC_SMEM = 1024
# the source's DWALK_CHUNK_SHIFT, DWALK_MAX_SLOTS, DWALK_MAX_RECORDS,
# DWALK_GUARD, DWALK_STATIC_SMEM (the dense walk)
DWALK_CHUNK_SHIFT = 12
DWALK_MAX_SLOTS = 32
DWALK_MAX_RECORDS = 1 << 14
DWALK_GUARD = 256
DWALK_STATIC_SMEM = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.dense_walk_plan.argtypes = [_I, _I, _I, _P]
        lib.dense_walk_plan.restype = _I
        lib.dense_walk_launch.argtypes = [
            _P, _P, _P, _I, _I, _I,  # bp, x_sizes, y_sizes, P, N, M
            _I, _I, _P, _P, _P, _P,  # smem_optin, device, xs, ys, vs, stream
        ]
        lib.dense_walk_launch.restype = _I
        lib.banded_walk_plan.argtypes = [_I, _I, _I, _P]
        lib.banded_walk_plan.restype = _I
        lib.banded_walk_launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # csum, xp, yp, boff_out, x_sizes, y_sizes
            _I, _I, _I, _I, _I, _I,  # P, A + 2, B, bp_int8, smem_optin, device
            _P, _P, _P, _P, _P, _P,  # xs, ys, xps, yps, cs, stream
        ]
        lib.banded_walk_launch.restype = _I
        lib._typed = True
    return lib


class WalkPlan(NamedTuple):
    row_shift: int  # a ring row holds 1 << row_shift successors (>= B)
    chunk_shift: int  # a chunk of the ring is 1 << chunk_shift rows
    slots: int  # chunks in the ring (a power of two)
    smem_bytes: int  # dynamic shared memory: the ring, then the records
    records: int  # the walk's first steps recorded in shared memory


class DenseWalkPlan(NamedTuple):
    slots: int  # chunks of 2**DWALK_CHUNK_SHIFT bytes in the ring
    wrap: bool  # slots are reused, in order (a power of two of them)
    smem_bytes: int  # dynamic shared memory: the ring, the records, DWALK_GUARD
    records: int  # room for the walk's records in shared memory (0: they go to xs)


def dense_walk_plan(N: int, M: int, smem_optin: int) -> DenseWalkPlan:
    """The dense walk's ring for planes of (N + 1) x (M + 1) int8 pointers, a
    copy of the source's ``dense_walk_plan`` for the CPU tests, which have
    no nvcc to build the source (the wrapper calls the source's own;
    ``chip_smoke.py`` holds the two to each other). A pair's walk reads
    bytes [0, k0] of its plane, which starts anywhere in a chunk of
    2**DWALK_CHUNK_SHIFT bytes aligned in absolute address, so it touches at
    most (plane + chunk - 2) // chunk + 1 chunks: the ring has that many
    slots where they are at most DWALK_MAX_SLOTS, else DWALK_MAX_SLOTS
    slots reused in order. After the ring, room for the walk's records:
    N + M + 1 steps and the three a turn of four may overrun, rounded up
    to 4; none where that is over DWALK_MAX_RECORDS (the walk records into
    its output instead); then DWALK_GUARD bytes, which a turn's loads may
    reach past the ring's top on corrupt pointers. Raises ValueError where a side is negative, where
    the ring, the records and the kernel's static shared memory do not fit
    ``smem_optin`` bytes, or where the walker's coordinates (a shared
    address or a chunk offset, plus the plane's bytes and four rows) do not
    fit 31 bits."""
    chunk = 1 << DWALK_CHUNK_SHIFT
    plane = (N + 1) * (M + 1)
    need = (plane + chunk - 2) // chunk + 1
    wrap = need > DWALK_MAX_SLOTS
    slots = DWALK_MAX_SLOTS if wrap else need
    steps = N + M + 1
    records = (steps + 6) & ~3 if steps + 3 <= DWALK_MAX_RECORDS else 0
    nbytes = slots * chunk + 4 * records + DWALK_GUARD
    if N < 0 or M < 0:
        raise ValueError(f"dense_traceback_walk_cuda: a side of {N} x {M}")
    if nbytes + DWALK_STATIC_SMEM > smem_optin:
        raise ValueError(
            f"dense_traceback_walk_cuda: planes of {N + 1} x {M + 1} need {nbytes} bytes of "
            f"shared memory for the ring and the walk's records, more than the {smem_optin} a "
            "block may have")
    if plane + chunk + 4 * (M + 1) + (1 << 18) > 2**31 - 1:
        raise ValueError(f"dense_traceback_walk_cuda: planes of {N + 1} x {M + 1} do not fit "
                         "31-bit coordinates")
    return DenseWalkPlan(slots, wrap, nbytes, records)


def _ceil_log2(v: int) -> int:
    return max(int(v) - 1, 0).bit_length()


def banded_walk_plan(a2: int, B: int, smem_optin: int) -> WalkPlan:
    """The banded walk's ring for planes of ``a2`` rows of B cells, a copy of the
    source's ``banded_walk_plan`` for the CPU tests, which have no nvcc to
    build the source (the wrapper calls the source's own;
    ``chip_smoke.py`` holds the two to each other): rows of 2**ceil(log2
    B) int32 successors, chunks of 2**WALK_CHUNK_SHIFT cells (whole rows,
    one at least), and as many rows as WALK_RING_BYTES hold, or the
    plane's rows rounded up to a power of two, whichever is less; after
    the ring, room for the walk's records (a2 + 3 rounded up to 4, for the
    three steps a turn of four may overrun; at most WALK_MAX_RECORDS, past
    which a walk records into its output instead). Raises ValueError where
    one chunk, the records and the kernel's static shared memory do not
    fit ``smem_optin`` bytes (B over 2**15 on an H100), or where a cell
    index does not fit 31 bits."""
    row_shift = _ceil_log2(B)
    chunk_shift = max(WALK_CHUNK_SHIFT - row_shift, 0)
    row_bytes = 4 << row_shift
    cap_rows = max(1 << chunk_shift, 1 << _ceil_log2(a2))
    rows = 1 << chunk_shift
    while (rows * 2 <= cap_rows and rows * 2 * row_bytes <= WALK_RING_BYTES
           and (rows * 2) >> chunk_shift <= WALK_MAX_SLOTS):
        rows *= 2
    records = (a2 + 6) & ~3 if a2 + 3 < WALK_MAX_RECORDS else WALK_MAX_RECORDS
    nbytes = rows * row_bytes + 4 * records
    if nbytes + WALK_STATIC_SMEM > smem_optin:
        raise ValueError(
            f"banded_traceback_walk_cuda: a band of B={B} needs {nbytes} bytes of shared "
            f"memory for one ring chunk and the walk's records, more than the {smem_optin} "
            "a block may have")
    if a2 << row_shift > 2**31 - 1:
        raise ValueError(f"banded_traceback_walk_cuda: {a2} rows of B={B} cells do not fit "
                         "31-bit cell indices")
    return WalkPlan(row_shift, chunk_shift, rows >> chunk_shift, nbytes, records)


@lru_cache(maxsize=None)
def _source_plan(name: str, a: int, b: int, smem_optin: int):
    """The source's plan ``name`` (``dense_walk_plan`` or
    ``banded_walk_plan``) for a shape, once per shape: (refused, its
    numbers)."""
    plan = (ctypes.c_int * (4 if name == "dense_walk_plan" else 5))()
    refused = getattr(_lib(), name)(a, b, smem_optin, plan) != 0
    return refused, tuple(plan)


def dense_traceback_walk_cuda(bp: torch.Tensor, x_sizes: torch.Tensor, y_sizes: torch.Tensor):
    """Walk the node-layout dense planes ``bp`` (P, N+1, M+1) int8 from
    (x_sizes[p], y_sizes[p]) to the origin. Returns (xs, ys (P, N+M+1)
    int32, vs (P, N+M+1) int8). Raises ValueError where the source's plan
    refuses the planes (over 2**31 bytes a pair)."""
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
    xs, ys = torch.empty((2, P, steps), dtype=torch.int32, device=dev).unbind(0)
    vs = torch.empty((P, steps), dtype=torch.int8, device=dev)
    if P == 0:
        return xs, ys, vs
    index = dev.index
    optin = _smem_optin(index)
    refused, plan = _source_plan("dense_walk_plan", rmax - 1, cmax - 1, optin)
    if refused:
        raise ValueError(
            f"dense_traceback_walk_cuda: planes of {rmax} x {cmax} need {plan[2]} bytes of shared "
            f"memory for the ring and the walk's records (at most {optin} a block) and "
            "coordinates of 31 bits")
    err = _lib().dense_walk_launch(
        bp.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(), P, rmax - 1, cmax - 1, optin,
        index, xs.data_ptr(), ys.data_ptr(), vs.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index))
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
    cs (P, A+2) float32). Raises ValueError where the band does not fit
    the ring's shared memory (B over 2**15 on an H100)."""
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
    xs, ys = torch.empty((2, P, a2), dtype=torch.int32, device=dev).unbind(0)
    xps, yps = torch.empty((2, P, a2), dtype=xp.dtype, device=dev).unbind(0)
    cs = torch.empty((P, a2), dtype=torch.float32, device=dev)
    if P == 0:
        return xs, ys, xps, yps, cs
    index = dev.index
    optin = _smem_optin(index)
    refused, plan = _source_plan("banded_walk_plan", a2, B, optin)
    if refused:
        raise ValueError(
            f"banded_traceback_walk_cuda: {a2} rows of a band of B={B} need {plan[3]} bytes of "
            f"shared memory for one ring chunk and the walk's records (at most {optin} a "
            "block) and cell indices of 31 bits")
    err = _lib().banded_walk_launch(
        csum.data_ptr(), xp.data_ptr(), yp.data_ptr(), b_offset_out.data_ptr(),
        x_sizes.data_ptr(), y_sizes.data_ptr(), P, a2, B, int(xp.dtype == torch.int8), optin,
        index, xs.data_ptr(), ys.data_ptr(), xps.data_ptr(), yps.data_ptr(), cs.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"banded_traceback_walk kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, BANDED)
    return xs, ys, xps, yps, cs
