"""Contrastive fine-tuning of the SpeechLASER encoder on mined pairs.

Port of the JAX package's ``models/training.py``: the tsvs the pipeline
mines are paired speech clips, and a symmetric InfoNCE objective on them
adapts the encoder to the mined domain. Plain PyTorch on
``models/laser_encoder.py::LaserSpeechEncoder`` (never
``SpeechLaserModel``, which stores its weights in bf16 for inference):
fp32 master parameters, compute in the config's dtype, one
``torch.optim.AdamW`` over every parameter in one group (optax's ``adamw``
with no mask decays biases and norm scales too; both decay from the old
parameter).

:func:`shard_train_step` runs the step over a ``(data, model)`` mesh in
one process, as the port's mesh does everywhere (``parallel/mesh.py``):

- each data shard forwards its rows of the batch on its devices, and the
  embeddings are gathered on the mesh's first device, where the loss is
  the global batch's, as JAX's jitted step computes it (per-shard losses
  would change the negatives, and so the function);
- model shards hold their column or row slices (``shard_params`` by
  ``encoder_param_spec``, JAX's rule: biases replicate): the q/k/v
  projections by heads and ``ffn_in`` by columns, each shard adding its
  columns' part of the bias; ``attn/out`` and ``ffn_out`` by rows,
  their products reduced by a copy to the data shard's first device and
  a sum in fp32, to which the bias is added once; the next layer's input
  is copied back to every model shard. The copies are differentiable, so
  autograd builds the backward's reductions;
- one AdamW step on the master copy (on the mesh's first device).

``SVECALIGN_TRAIN_PROFILE=1`` fills :data:`step_seconds` by phase
(forward, on a mesh the forward's ``tp_reduce``, backward, optimizer):
the host seconds of the phase spans ``train.<phase>`` (``utils/trace.py``,
on the device, not synchronised).

The design is one process, not ``torch.distributed`` with one process per
card: NCCL refuses two ranks on one card, and ``Mesh([[cuda:0, cuda:0]])``
runs the tensor-parallel path on a machine of one card.
"""

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from svecalign_tpu_torch.models.laser_encoder import (
    LaserEncoderConfig,
    LaserSpeechEncoder,
    frame_mask,
    gelu,
    masked_max_pool,
    positional,
)
from svecalign_tpu_torch.models.w2v_bert import compute_dtype
from svecalign_tpu_torch.parallel.mesh import Mesh, model_slice, shard_params, shard_slices
from svecalign_tpu_torch.utils import trace
from svecalign_tpu_torch.utils.torch_setup import resolve_device

BATCH_KEYS = ("src_wav", "src_len", "tgt_wav", "tgt_len")
TRAIN_PROFILE_ENV = "SVECALIGN_TRAIN_PROFILE"

step_seconds: dict = {}
"""Seconds by phase of the steps taken under ``SVECALIGN_TRAIN_PROFILE=1``."""

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# back to unit variance by this constant (flax.linen.initializers)
TRUNC_NORMAL_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    temperature: float = 0.05


def info_nce_loss(emb0: torch.Tensor, emb1: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives (paired rows are
    positives), fp32 logits."""
    e0 = emb0 / (torch.linalg.vector_norm(emb0, dim=-1, keepdim=True) + 1e-6)
    e1 = emb1 / (torch.linalg.vector_norm(emb1, dim=-1, keepdim=True) + 1e-6)
    logits = torch.matmul(e0.float(), e1.float().T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def init_params(model: nn.Module, seed: int) -> None:
    """flax's default initialisers, drawn from ``torch.Generator(seed)``:
    kernels lecun-normal (truncated at 2 sigma, fan-in = every axis of the
    torch weight but its first), biases 0, norm scales 1. This is the one
    place where the two packages start apart: ``jax.random`` draws cannot
    be reproduced, so parity is held from the same weights carried across
    by ``models/param_utils.py::params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if name.endswith("bias"):
                p.zero_()
            elif not isinstance(mod, (nn.Linear, nn.Conv1d)):
                p.fill_(1.0)  # the norms' scales
            else:
                std = float(np.prod(p.shape[1:])) ** -0.5 / TRUNC_NORMAL_STD
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
                p.copy_(w)


def make_optimizer(model: nn.Module, train_config: TrainConfig) -> torch.optim.AdamW:
    """optax's ``adamw``: every parameter decayed, b1 0.9, b2 0.999, eps
    1e-8 (the defaults of both libraries)."""
    return torch.optim.AdamW(model.parameters(), lr=train_config.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=train_config.weight_decay)


def make_train_state(
    model_config: LaserEncoderConfig,
    train_config: TrainConfig = TrainConfig(),
    seed: int = 0,
    device="cuda",
) -> Tuple[LaserSpeechEncoder, torch.optim.AdamW]:
    """(model, optimizer): fp32 parameters on ``device`` freshly
    initialised by :func:`init_params`, and a fresh AdamW."""
    dev = resolve_device(device)
    model = LaserSpeechEncoder(model_config)
    init_params(model, seed)
    model.to(dev)
    return model, make_optimizer(model, train_config)


def _batch_tensors(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k in BATCH_KEYS:
        v = batch[k]
        out[k] = (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
    return out


def _update(model, opt, train_config, embed: Callable) -> Callable:
    """A step: zero the gradients, ``embed(batch, clock)`` -> (emb0, emb1)
    on one device, InfoNCE, backward, one AdamW step. Returns the detached
    loss; the gradients stay on the parameters until the next step."""
    dev = next(model.parameters()).device

    def train_step(batch) -> torch.Tensor:
        trace.TRAIN.switch(dev)
        clock = trace.TRAIN.phases("train.", dev, step_seconds)
        opt.zero_grad(set_to_none=True)
        emb0, emb1 = embed(batch, clock)
        loss = info_nce_loss(emb0, emb1, train_config.temperature)
        clock.mark("forward")
        loss.backward()
        clock.mark("backward")
        opt.step()
        clock.mark("optimizer")
        return loss.detach()

    return train_step


def make_train_step(model: LaserSpeechEncoder, opt, train_config: TrainConfig) -> Callable:
    """One update step on the model's device: forward both sides, InfoNCE,
    AdamW. ``step(batch)`` takes numpy arrays or tensors under
    ``BATCH_KEYS`` and returns the loss."""
    dev = next(model.parameters()).device

    def embed(batch, clock):
        b = _batch_tensors(batch, dev)
        return model(b["src_wav"], b["src_len"]), model(b["tgt_wav"], b["tgt_len"])

    return _update(model, opt, train_config, embed)


# ---------------------------------------------------------------------------
# the tensor-parallel forward
# ---------------------------------------------------------------------------


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _linear(x, w, b, dt):
    """flax ``Dense(dtype=dt)`` on given weights."""
    return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))


def _cols(bias: torch.Tensor, j: int, m: int) -> torch.Tensor:
    """Model shard ``j``'s part of the (replicated) bias of a column-split
    product."""
    return bias[model_slice(bias.shape[0], j, m)]


def _reduce(parts: List[torch.Tensor], bias: torch.Tensor, dt) -> torch.Tensor:
    """The all-reduce after a row-split product: every shard's partial
    copied to the first's device and summed in fp32, the bias added once,
    rounded to the compute dtype once."""
    dev = bias.device
    total = bias.float()
    for p in parts:
        total = total + p.to(dev).float()
    return total.to(dt)


def _tp_layer(model, l: int, shards: List[Dict], devs: List[torch.device], x, mask, clock):
    """``TransformerLayer.forward`` of layer ``l`` with its attention heads
    and FFN columns split over the model shards."""
    cfg = model.cfg
    dt = compute_dtype(cfg)
    pre = f"layer_{l}."
    layer = getattr(model, f"layer_{l}")
    p0 = shards[0]
    b, t, _ = x.shape
    dh = cfg.encoder_dim // cfg.encoder_heads

    y = functional_call(layer.attn_norm, _sub(p0, pre + "attn_norm"), (x,))
    m = len(shards)
    parts = []
    for j, (p, dev) in enumerate(zip(shards, devs)):
        yj, mj = y.to(dev), mask.to(dev)
        q, k, v = (_linear(yj, p[f"{pre}attn.{n}.weight"], _cols(p[f"{pre}attn.{n}.bias"], j, m),
                           dt).view(b, t, -1, dh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mj[:, None, None, :])
        parts.append(_linear(o.transpose(1, 2).reshape(b, t, -1), p[pre + "attn.out.weight"],
                             None, dt))
    clock.mark("forward")
    x = x + _reduce(parts, p0[pre + "attn.out.bias"], dt)
    clock.mark("tp_reduce")

    y = functional_call(layer.ffn_norm, _sub(p0, pre + "ffn_norm"), (x,))
    parts = []
    for j, (p, dev) in enumerate(zip(shards, devs)):
        h = gelu(_linear(y.to(dev), p[pre + "ffn_in.weight"], _cols(p[pre + "ffn_in.bias"], j, m),
                         dt))
        parts.append(_linear(h, p[pre + "ffn_out.weight"], None, dt))
    clock.mark("forward")
    x = x + _reduce(parts, p0[pre + "ffn_out.bias"], dt)
    clock.mark("tp_reduce")
    return x


def tp_forward(model: LaserSpeechEncoder, shards: List[Dict], devs: List[torch.device],
               wav: torch.Tensor, lengths: torch.Tensor, clock) -> torch.Tensor:
    """``LaserSpeechEncoder.forward`` of one data shard, its weights in
    ``shards`` (one ``state_dict`` slice per model shard, on ``devs``):
    the replicated parts run on ``devs[0]``, the layers split."""
    cfg = model.cfg
    dt = compute_dtype(cfg)
    p0 = shards[0]
    feats = functional_call(model.feature_extractor, _sub(p0, "feature_extractor"), (wav,))
    mask = frame_mask(cfg, lengths, feats.shape[1])
    x = functional_call(model.post_extract_norm, _sub(p0, "post_extract_norm"), (feats,))
    x = _linear(x, p0["post_extract_proj.weight"], p0["post_extract_proj.bias"], dt)
    x = x + positional(cfg, x, p0["pos_conv.weight"], p0["pos_conv.bias"])
    for l in range(cfg.encoder_layers):
        x = _tp_layer(model, l, shards, devs, x, mask, clock)
    x = functional_call(model.encoder_norm, _sub(p0, "encoder_norm"), (x,))
    return masked_max_pool(x, mask)


def shard_train_step(model: LaserSpeechEncoder, opt, train_config: TrainConfig,
                     mesh: Mesh) -> Callable:
    """The train step over ``mesh``: batch rows over the data axis,
    weights over the model axis (module docstring). The model's master
    parameters must lie on ``mesh.first``; the batch's rows must split
    evenly over the data axis, the heads and FFN units over the model
    axis. A 1 x 1 mesh is :func:`make_train_step`."""
    first = mesh.first
    if next(model.parameters()).device != first:
        raise ValueError(f"the master parameters must lie on the mesh's first device {first}")
    if mesh.size == 1:
        return make_train_step(model, opt, train_config)
    cfg, n_model = model.cfg, mesh.shape["model"]
    if cfg.encoder_heads % n_model or cfg.encoder_ffn_dim % n_model:
        raise ValueError(f"{cfg.encoder_heads} heads and an FFN of {cfg.encoder_ffn_dim} do not "
                         f"split over {n_model} model shards")
    grid = mesh.grid
    master = dict(model.named_parameters())

    def embed(batch, clock):
        b = _batch_tensors(batch, first)
        shards = shard_params(master, mesh)
        out = {"src": [], "tgt": []}
        for i, rows in enumerate(shard_slices(b["src_wav"].shape[0], mesh)):
            devs = grid[i]
            for side in ("src", "tgt"):
                emb = tp_forward(model, shards[i], devs, b[f"{side}_wav"][rows].to(devs[0]),
                                 b[f"{side}_len"][rows].to(devs[0]), clock)
                out[side].append(emb.to(first))
        return torch.cat(out["src"]), torch.cat(out["tgt"])

    return _update(model, opt, train_config, embed)

