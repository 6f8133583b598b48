"""Wrapper of the banded-DP CUDA kernel (``csrc/banded_dp.cu``).

The kernel replaces the TPU kernel
``svecalign_tpu/ops/dp_pallas.py::banded_dp_pallas_batched``: P pairs in
one launch, the same inputs, the same outputs, bit for bit. It is bound by
the A + 2 dependent anti-diagonal steps (latency), not by its few MB of
traffic; see the source for the design.

The source holds two kernels and :func:`banded_dp_route` picks one by
shape alone:

- ``"warp"``: one warp per pair, the cost rows staged ``WARP_STAGES``
  steps ahead of the wavefront in shared memory and the pair's offsets
  row held there too, so the loop over anti-diagonals makes no global
  load. For B <= 32 when its shared memory fits.
- ``"block"``: one thread block per pair, threads looping over band
  lanes, the ring in global scratch when it does not fit on chip. The
  general route.

On a CPU tensor the wrapper runs the plain version
(:func:`svecalign_tpu_torch.ops.dp.banded_dp_batched`); on a CUDA tensor it
launches a kernel or raises. ``LAUNCHES["banded_dp"]`` counts launches,
``LAUNCHES["banded_dp_warp"]`` and ``LAUNCHES["banded_dp_block"]`` count
them by route.
"""

import ctypes
from functools import lru_cache
from typing import Optional, Sequence

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as dp_ops

KERNEL = "banded_dp"

ROUTES = ("warp", "block")
LAUNCHES = {KERNEL: 0, **{f"{KERNEL}_{r}": 0 for r in ROUTES}}

WARP_SIZE = 32
# cost stages of the warp route (DP_STAGES in the source): a step's rows
# are requested WARP_STAGES - 1 steps before the wavefront reads them
WARP_STAGES = 16

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.banded_dp_smem_optin.argtypes = [_I]
        lib.banded_dp_smem_optin.restype = _I
        lib.banded_dp_smem_bytes.argtypes = [_I, _I, _I]
        lib.banded_dp_smem_bytes.restype = ctypes.c_size_t
        lib.banded_dp_launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # costs, boff_out, pens, x/y sizes, types
            _I, _I, _I, _I, _I, _I,  # n_types, T, P, A, B, K
            _P, _P, _P, _I,  # csum, xp, yp, bp_int8
            _P, _I, _P,  # ring scratch, threads, stream
        ]
        lib.banded_dp_launch.restype = _I
        lib.banded_dp_warp_stages.argtypes = []
        lib.banded_dp_warp_stages.restype = _I
        lib.banded_dp_warp_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
        lib.banded_dp_warp_smem_bytes.restype = ctypes.c_size_t
        lib.banded_dp_warp_launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # costs, boff_out, pens, x/y sizes, types
            _I, _I, _I, _I, _I, _I,  # n_types, T, P, A, B, K
            _P, _P, _P, _I, _P,  # csum, xp, yp, bp_int8, stream
        ]
        lib.banded_dp_warp_launch.restype = _I
        lib._typed = True
    return lib


@lru_cache(maxsize=None)
def _type_table(xo: tuple, yo: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor([xo, yo], dtype=torch.int32, device=device)


@lru_cache(maxsize=None)
def _smem_optin(device_index: int) -> int:
    return _lib().banded_dp_smem_optin(device_index)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def warp_padded_types(B: int, n_types: int) -> int:
    """The warp route's type count: where two band rows fit one warp
    (2 B <= 32) the types are split over its two halves, and each half
    takes them four at a time."""
    m = 4 * (2 if 2 * B <= WARP_SIZE else 1)
    return -(-n_types // m) * m


def warp_smem_bytes(B: int, K: int, T: int, A: int, n_types: int) -> int:
    """Dynamic shared memory of the warp route, as the source lays it
    out (``banded_dp_warp_smem_bytes`` there): the cost stages (a row per
    padded type), the csum ring of K + 1 rows of B + 2K floats and one row
    of +inf, the pair's A + 2 node offsets, and per padded type 8 bytes of
    type table and the 8-byte ring offsets of 64 steps; each segment
    rounded up to 16 bytes."""
    ntp = warp_padded_types(B, n_types)
    return (
        _round16(WARP_STAGES * ntp * B * 4)
        + _round16((K + 2) * (B + 2 * K) * 4)
        + _round16((A + 2) * 4)
        + (1 + 64) * ntp * 8
    )


def banded_dp_route(B: int, K: int, T: int, A: int, n_types: int, smem_optin: int) -> str:
    """Which kernel a problem of this shape takes: ``"warp"`` when a band
    row fits one warp (B <= 32), a type's offsets fit the 16 bits its tag
    gives each (K < 2**15) and the warp route's shared memory fits the
    ``smem_optin`` bytes a block may opt in to, else ``"block"``."""
    fits = warp_smem_bytes(B, K, T, A, n_types) <= smem_optin
    if B <= WARP_SIZE and K < 2**15 and fits:
        return "warp"
    return "block"


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def banded_dp_cuda_batched(
    costs: torch.Tensor,  # (P, T, A, B) float32
    b_offset_in: torch.Tensor,  # (P, A) int32
    b_offset_out: torch.Tensor,  # (P, A+2) int32
    x_offsets: Sequence[int],
    y_offsets: Sequence[int],
    del_penalty: torch.Tensor,  # (P,) float32
    x_in_size: torch.Tensor,  # (P,) int32
    y_in_size: torch.Tensor,  # (P,) int32
    route: Optional[str] = None,
):
    """P-pair banded DP (the ``banded_dp_pallas_batched`` signature).
    Returns (csum (P, A+2, B) float32, xp, yp (P, A+2, B) int8, or int32
    when a type offset exceeds 127). ``route`` is for measurements: it
    forces a kernel, and raises where the shape does not admit it; left
    ``None``, :func:`banded_dp_route` picks."""
    dev = costs.device
    if dev.type == "cpu":
        return dp_ops.banded_dp_batched(
            costs, b_offset_in, b_offset_out, x_offsets, y_offsets,
            del_penalty, x_in_size, y_in_size,
        )
    if dev.type != "cuda":
        raise ValueError(f"banded_dp_cuda_batched: unsupported device {dev}")
    if costs.dim() != 4:
        raise ValueError(f"costs must be (P, T, A, B), got {tuple(costs.shape)}")
    P, T, A, B = costs.shape
    if len(x_offsets) != T or len(y_offsets) != T:
        raise ValueError(f"{T} cost types but {len(x_offsets)} type offsets")
    _check("costs", costs, torch.float32, (P, T, A, B), dev)
    _check("b_offset_in", b_offset_in, torch.int32, (P, A), dev)
    _check("b_offset_out", b_offset_out, torch.int32, (P, A + 2), dev)
    _check("del_penalty", del_penalty, torch.float32, (P,), dev)
    _check("x_in_size", x_in_size, torch.int32, (P,), dev)
    _check("y_in_size", y_in_size, torch.int32, (P,), dev)

    xo, yo, K, bp_dtype = dp_ops.dp_types(x_offsets, y_offsets)
    n_types = len(xo)
    types = _type_table(tuple(xo), tuple(yo), dev)
    csum = torch.empty((P, A + 2, B), dtype=torch.float32, device=dev)
    xp = torch.empty((P, A + 2, B), dtype=bp_dtype, device=dev)
    yp = torch.empty((P, A + 2, B), dtype=bp_dtype, device=dev)
    if P == 0:
        return csum, xp, yp

    lib = _lib()
    smem_optin = _smem_optin(dev.index or 0)
    admitted = banded_dp_route(B, K, T, A, n_types, smem_optin)
    if route is None:
        route = admitted
    elif route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    elif route == "warp" and admitted != "warp":
        raise ValueError(f"the warp route does not take B={B} K={K} T={T} A={A}")
    head = (
        costs.data_ptr(), b_offset_out.data_ptr(), del_penalty.data_ptr(),
        x_in_size.data_ptr(), y_in_size.data_ptr(), types.data_ptr(),
        n_types, T, P, A, B, K,
        csum.data_ptr(), xp.data_ptr(), yp.data_ptr(),
        int(bp_dtype == torch.int8),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "warp":
            err = lib.banded_dp_warp_launch(*head, stream)
        else:
            # the ring lives in shared memory where it fits, else in global scratch
            ring = None
            if lib.banded_dp_smem_bytes(B, K, n_types) > smem_optin:
                ring = torch.empty((P, K + 1, B + 2 * K), dtype=torch.float32, device=dev)
            threads = min(512, -(-B // 32) * 32)
            err = lib.banded_dp_launch(
                *head, None if ring is None else ring.data_ptr(), threads, stream)
    if err != 0:
        raise RuntimeError(f"banded_dp kernel launch ({route} route) failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, KERNEL, f"{KERNEL}_{route}")
    return csum, xp, yp


def run_banded_dp_cuda(costs, b_offset_in, alignment_types, del_penalty,
                       x_in_size, y_in_size):
    """One pair through the kernel, with the JAX ``run_banded_dp``
    signature and outputs (csum float64 host, xp, yp, b_offset_out)."""
    return dp_ops.run_banded_per_pair(
        banded_dp_cuda_batched, costs, b_offset_in, alignment_types,
        del_penalty, x_in_size, y_in_size,
    )
