"""Wrapper of the rel-key flash-attention CUDA kernel
(``csrc/relkey_attention.cu``).

The kernel replaces the TPU kernel
``svecalign_tpu/ops/attention_pallas.py::relkey_flash_attention``: the same
(B, T, H, 64) inputs and output, the same math (see
:mod:`svecalign_tpu_torch.ops.attention`). As on the TPU, the 73-wide
projection p = (q . table^T) / sqrt(dh), rounded to q's dtype, is computed
before the kernel (:func:`~svecalign_tpu_torch.ops.attention.relkey_projection`);
the kernel rebuilds the (T, T) bias from it tile by tile.

On a CPU tensor the wrapper runs the plain version
(:func:`svecalign_tpu_torch.ops.attention.relkey_attention`); on a CUDA
tensor it launches the kernel or raises. ``LAUNCHES["relkey_attention"]``
counts launches.
"""

import ctypes
from typing import Optional

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import attention

KERNEL = "relkey_attention"
HEAD_DIM = 64  # the only head size the kernel (and the TPU kernel) takes
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {KERNEL: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.relkey_attention_launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # q, k, v, p, lengths, out
            _I, _I, _I, _I, _I, _I,  # B, T, H, C, left, right
            _I, _P,  # is_bf16, stream
        ]
        lib.relkey_attention_launch.restype = _I
        lib._typed = True
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def relkey_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, left: int = 64, right: int = 8,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh) + rel-key bias + key mask) v, the
    ``relkey_flash_attention`` signature: (B, T, H, 64) q, k, v in fp32 or
    bf16; (left + right + 1, 64) table; (B,) int32 lengths (None: all T
    keys valid). Returns (B, T, H, 64) in q's dtype; rows at or past a
    length hold unspecified but finite values."""
    dev = q.device
    if dev.type == "cpu":
        return attention.relkey_attention(q, k, v, table, lengths, left, right)
    if dev.type != "cuda":
        raise ValueError(f"relkey_attention_cuda: unsupported device {dev}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be (B, T, H, {HEAD_DIM}), got {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {DTYPES}, got {q.dtype}")
    B, T, H, _ = q.shape
    C = left + right + 1
    if left < 0 or right < 0:
        raise ValueError(f"clip window must be non-negative, got ({left}, {right})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, (B, T, H, HEAD_DIM), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if tuple(table.shape) != (C, HEAD_DIM):
        raise ValueError(f"table must be ({C}, {HEAD_DIM}), got {tuple(table.shape)}")
    if lengths is not None:
        _check("lengths", lengths, torch.int32, (B,), dev)

    p = attention.relkey_projection(q, table.to(dev)).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().relkey_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            B, T, H, C, left, right, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"relkey_attention kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out
