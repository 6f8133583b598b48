"""flax's LayerNorm as the speech encoders compute it, in plain PyTorch.

The plain version of the LayerNorm kernel (``csrc/layer_norm.cu``,
wrapper ``ops/layer_norm_cuda.py``), the arithmetic every CPU call runs
(``models/w2v_bert.py::FlaxLayerNorm``), and what the kernel's backward
differentiates: flax ``LayerNorm(dtype=float32)``,
fp32 statistics with the fast variance E[x^2] - E[x]^2 clipped at 0,
scale and bias in fp32. Two fused steps of its callers ride along:

- ``conv_bias``: a conv's bias added to ``x`` in ``x``'s dtype first, as
  a conv on a card adds it after the convolution (the conv then runs
  without one);
- ``out_dtype`` and ``gelu_out``: the result rounded to ``out_dtype``
  (fp32 by default), then, with ``gelu_out``, the JAX package's GELU of it
  (:func:`gelu`).
"""

from typing import Optional

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_gelu``: tanh approximation below 32 bits, exact
    erf in fp32."""
    if x.dtype.itemsize < 4:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def flax_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    axis: int = -1, channel_axis: int = -1,
                    out_dtype: Optional[torch.dtype] = None,
                    conv_bias: Optional[torch.Tensor] = None,
                    gelu_out: bool = False) -> torch.Tensor:
    """Statistics over ``axis``; ``weight``, ``bias`` and ``conv_bias`` lie
    along ``channel_axis`` (``axis != channel_axis`` is flax's
    ``GroupNorm`` with one group per channel)."""
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype).view(shape)
    x = x.float()
    mu = x.mean(axis, keepdim=True)
    var = torch.clamp((x * x).mean(axis, keepdim=True) - mu * mu, min=0.0)
    y = (x - mu) * (torch.rsqrt(var + eps) * weight.float().view(shape)) \
        + bias.float().view(shape)
    if out_dtype is not None:
        y = y.to(out_dtype)
    return gelu(y) if gelu_out else y
