"""Wrapper of the rel-key flash-attention CUDA kernels
(``csrc/relkey_attention.cu``).

The kernels replace the TPU kernel
``svecalign_tpu/ops/attention_pallas.py::relkey_flash_attention``: the same
(B, T, H, 64) inputs and output, the same math (see
:mod:`svecalign_tpu_torch.ops.attention`). Two routes, by dtype:

- bf16 (the main path): the tensor-core kernel (``wgmma``, TMA). It takes
  the (C, 64) distance table and computes the 73-wide projection
  p = (q . table^T) / sqrt(dh), rounded to bf16, itself.
- fp32: the CUDA-core kernel. As on the TPU, p is computed before the
  kernel (:func:`~svecalign_tpu_torch.ops.attention.relkey_projection`).

Either kernel rebuilds the (T, T) bias from p tile by tile. The inputs are
checked before a route is chosen, so a CPU caller gets the errors a card
caller would. On a CPU tensor the wrapper then runs the plain version
(:func:`svecalign_tpu_torch.ops.attention.relkey_attention`); on a CUDA
tensor it launches a kernel or raises. ``LAUNCHES["relkey_attention"]``
counts launches of either; a launch captured into a CUDA graph (the
encoders' per-shape programs, ``models/encode_common.py``) is counted at
each replay, not at its capture (``ops/_build.py::count_launch``).

The launch is safe to capture: it goes on the current stream, the
kernels' shared-memory limits are raised once per device by the first
launch there (an eager one: a capture's warm-up), and the TMA
descriptors are kernel parameters, copied into the graph by value.
"""

import ctypes
from typing import Optional

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import attention

KERNEL = "relkey_attention"
HEAD_DIM = 64  # the only head size the kernels (and the TPU kernel) take
MAX_C = 128  # table rows: the TPU kernel's C_PAD, one TMA box here
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {KERNEL: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# launch codes of the bf16 route that are not CUDA errors
_ENCODE_ERRORS = {
    -1: "the driver has no cuTensorMapEncodeTiled",
    -2: "the driver refused a tensor map",
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        for fn in (lib.relkey_attention_bf16_launch, lib.relkey_attention_fp32_launch):
            fn.argtypes = [
                _P, _P, _P, _P, _P, _P,  # q, k, v, table (bf16) or p (fp32), lengths, out
                _I, _I, _I, _I, _I, _I,  # B, T, H, C, left, right
                _P,  # stream
            ]
            fn.restype = _I
        lib.relkey_attention_bf16_occupancy.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
        lib.relkey_attention_bf16_occupancy.restype = _I
        lib._typed = True
    return lib


def bf16_occupancy(C: int = 73):
    """(dynamic shared memory in bytes, CTAs per SM) of the bf16 kernel with
    a C-row table on the current card."""
    smem, ctas = _I(), _I()
    err = _lib().relkey_attention_bf16_occupancy(C, ctypes.byref(smem), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"relkey_attention occupancy query failed: CUDA error {err}")
    return smem.value, ctas.value


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(q: torch.Tensor, table: torch.Tensor, left: int, right: int) -> None:
    """Raise ValueError on what neither kernel takes: a head size other
    than 64, a clip window with C = left + right + 1 over 128 rows, a
    table that is not (C, 64), a dtype other than fp32 or bf16."""
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be (B, T, H, {HEAD_DIM}), got {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {DTYPES}, got {q.dtype}")
    if left < 0 or right < 0:
        raise ValueError(f"clip window must be non-negative, got ({left}, {right})")
    C = left + right + 1
    if C > MAX_C:
        raise ValueError(f"clip window ({left}, {right}) needs {C} table rows, at most {MAX_C}")
    if tuple(table.shape) != (C, HEAD_DIM):
        raise ValueError(f"table must be ({C}, {HEAD_DIM}), got {tuple(table.shape)}")


def relkey_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, left: int = 64, right: int = 8,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh) + rel-key bias + key mask) v, the
    ``relkey_flash_attention`` signature: (B, T, H, 64) q, k, v in fp32 or
    bf16; (left + right + 1, 64) table, at most 128 rows; (B,) int32
    lengths (None: all T keys valid). Returns (B, T, H, 64) in q's dtype;
    rows at or past a length hold unspecified but finite values."""
    _check_inputs(q, table, left, right)
    dev = q.device
    if dev.type == "cpu":
        return attention.relkey_attention(q, k, v, table, lengths, left, right)
    if dev.type != "cuda":
        raise ValueError(f"relkey_attention_cuda: unsupported device {dev}")
    B, T, H, _ = q.shape
    C = left + right + 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, (B, T, H, HEAD_DIM), dev)
    if lengths is not None:
        _check("lengths", lengths, torch.int32, (B,), dev)

    bf16 = q.dtype == torch.bfloat16
    if bf16:
        tab = table.to(device=dev, dtype=q.dtype).contiguous()
        _check("table", tab, q.dtype, (C, HEAD_DIM), dev)
    else:
        tab = attention.relkey_projection(q, table.to(dev)).contiguous()  # p
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch = _lib().relkey_attention_bf16_launch if bf16 else _lib().relkey_attention_fp32_launch
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tab.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            B, T, H, C, left, right, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        why = _ENCODE_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"relkey_attention kernel launch failed: {why}")
    _build.count_launch(LAUNCHES, KERNEL)
    return out
