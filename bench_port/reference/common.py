"""What the plain references share: parameter specs, seeded weights, the
precision of a forward, and LayerNorm.

A spec is a list of ``(name, shape, kind, dtype)``; the names are the
state_dict keys of the encoder that the program serves, so the harness can
hand the same tensors to the program and to the reference. ``kind`` sets the
draw: ``kernel`` N(0, 1/fan_in) (fan_in: every axis but the first, torch's
layout), ``bias`` N(0, 0.02^2), ``scale`` 1 + N(0, 0.05^2), ``shift``
N(0, 0.02^2), ``table`` N(0, 1/rows), ``query`` N(0, 1). ``dtype`` is the
type the weight is served in.

This module imports nothing of the program.
"""

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str, torch.dtype]]


def served_dtype(cfg: dict) -> torch.dtype:
    """The type the configuration serves its products' weights in."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]


def _std_mean(shape, kind) -> Tuple[float, float]:
    if kind == "kernel":
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return fan_in ** -0.5, 0.0
    if kind in ("bias", "shift"):
        return 0.02, 0.0
    if kind == "scale":
        return 0.05, 1.0
    if kind == "table":
        return shape[0] ** -0.5, 0.0
    if kind == "query":
        return 1.0, 0.0
    raise ValueError(f"unknown parameter kind {kind!r}")


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``spec`` from ``seed``: one normal draw for all of
    them by a generator on ``device``, each leaf a slice of it, scaled and
    cast to its served dtype. The same seed gives the same tensors."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    total = sum(_numel(shape) for _, shape, _, _ in spec)
    flat = torch.randn(total, generator=gen, device=dev)
    out, off = {}, 0
    for name, shape, kind, dtype in spec:
        n = _numel(shape)
        std, mean = _std_mean(shape, kind)
        out[name] = (flat[off:off + n] * std + mean).view(shape).to(dtype)
        off += n
    del flat
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def layer_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float,
               dim: int = -1) -> torch.Tensor:
    """LayerNorm over ``dim`` with the scale and shift along that dim, fp32."""
    x = x.float()
    mu = x.mean(dim, keepdim=True)
    var = ((x - mu) ** 2).mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x - mu) / torch.sqrt(var + eps) * w[name + ".weight"].float().view(shape) \
        + w[name + ".bias"].float().view(shape)


class Precision:
    """How the reference computes its products. ``fp32``: float32 with TF32
    off, the reference. ``fp8``: every product's operands rounded to
    float8 e4m3 with a per-tensor scale first, the control that the
    comparison has to fail (one step below the bf16 the configurations
    state)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.mode == "fp32":
            return t
        amax = t.abs().amax().clamp(min=1e-12)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    def linear(self, x, w: Dict[str, torch.Tensor], name: str, bias: bool = True):
        b = w.get(name + ".bias") if bias else None
        return F.linear(self.q(x), self.q(w[name + ".weight"]),
                        None if b is None else b.float())

    def conv1d(self, x, weight, bias=None, **kw):
        return F.conv1d(self.q(x), self.q(weight), None if bias is None else bias.float(), **kw)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def fp32_only() -> None:
    """TF32 off for every float32 product the reference makes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
