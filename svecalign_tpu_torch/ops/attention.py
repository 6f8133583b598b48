"""Rel-key attention of the w2v-BERT trunk, the plain PyTorch version.

The function of the TPU kernel
``svecalign_tpu/ops/attention_pallas.py::relkey_flash_attention`` and of
its CUDA counterpart ``csrc/relkey_attention.cu``, in their (B, T, H, dh)
layout:

    out = softmax(q k^T / sqrt(dh) + bias + key_pad_mask) v
    bias[l, r] = p[l, clip(r - l, -left, right) + left]
    p = (q . table^T) / sqrt(dh), rounded to q's dtype

Scores and the softmax are fp32; probabilities are cast to v's dtype
before the value product, and the output to q's dtype, as the kernels do.
Key columns at or past ``lengths[b]`` get the finite ``NEG``, so a batch
row that is only padding (length 0) still averages to finite values.
Query rows at or past the length are unspecified but finite.

It materialises the (B, H, T, T) scores: it is the reference the tests
and ``chip_smoke.py`` hold the kernel to, and the CPU path.
"""

import math
from typing import Optional

import numpy as np
import torch

NEG = -0.7 * float(np.finfo(np.float32).max)


def relkey_projection(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """p = (q . table^T) / sqrt(dh): (B, T, H, dh) x (C, dh) -> (B, T, H, C),
    computed in fp32 from the table in q's dtype, rounded to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    tab = table.to(q.dtype).float()
    return (torch.matmul(q.float(), tab.t()) * scale).to(q.dtype)


def relkey_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, left: int = 64, right: int = 8,
) -> torch.Tensor:
    """(B, T, H, dh) q, k, v; (left + right + 1, dh) table; (B,) int
    lengths (None: all T keys valid) -> (B, T, H, dh) in q's dtype."""
    b, t, h, dh = q.shape
    if table.shape[0] != left + right + 1:
        raise ValueError(f"table has {table.shape[0]} rows, want {left + right + 1}")
    scale = 1.0 / math.sqrt(dh)
    p = relkey_projection(q, table).float().permute(0, 2, 1, 3)  # (B, H, T, C)
    qf, kf = (a.float().permute(0, 2, 1, 3) for a in (q, k))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # (B, H, T, T)
    pos = torch.arange(t, device=q.device)
    dist = torch.clamp(pos[None, :] - pos[:, None], -left, right) + left  # (T, T)
    scores = scores + p[:, :, pos[:, None], dist]
    if lengths is not None:
        keep = pos[None, :] < lengths.to(q.device)[:, None]  # (B, T)
        scores = torch.where(keep[:, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float().permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).to(q.dtype)
