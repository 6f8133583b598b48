"""The w2v-BERT 2.0 conformer encoder (SONAR's speech trunk) in PyTorch.

Port of the JAX package's ``models/w2v_bert.py``. Module and attribute
names are the flax module names, so a flax parameter path maps to a
``state_dict`` key by ``/`` -> ``.`` (``models/param_utils.py``):

  fp_layer_norm + fp_projection on stacked 160-dim mels
  -> layers_0 .. layers_{N-1}, each:
       ffn1 (LN -> Linear -> swish -> Linear), half-step residual
       self_attn (LN -> MHSA with the relative_key distance term)
       conv_module (LN -> pointwise 2H + GLU -> CAUSAL depthwise conv k=31
                    -> LN -> swish -> pointwise), residual
       ffn2 half-step residual, final_layer_norm

``conv_module="symmetric"`` is FastConformer's conv module instead
(Parakeet, ``models/parakeet.py``): LN -> pointwise 2H with a bias + GLU
-> padded frames zeroed -> symmetric depthwise conv (pad (k - 1) / 2
each side) with a bias -> BatchNorm over its running statistics, in fp32
-> swish -> pointwise with a bias. The default ``"causal"`` form, its
parameters and its arithmetic are untouched by the other's presence.

Numerics follow the flax modules, so that fp32 agrees tightly and bf16
loosely:

- parameters are fp32; a Linear or the depthwise conv casts its input and
  weights to the compute dtype, as flax ``Dense(dtype=...)`` does;
- LayerNorms compute in fp32 with flax's fast variance, E[x^2] - E[x]^2
  clipped at 0, and return the compute dtype where a dense follows
  (``FlaxLayerNorm``: one kernel on a card);
- the residual stream is in the compute dtype; softmax runs in fp32 and is
  cast back.

Rel-key attention (``position_embeddings_type="relative_key"``) has two
routes, chosen by ``attention_backend``:

- ``"cuda"``: the hand-written kernel (``ops/attention_cuda.py``), under the
  JAX kernel's condition (head size 64, even head count); it raises on a
  CPU tensor or a shape the kernel does not take;
- ``"torch"``: the plain path, the HF formulation of the JAX "xla" backend
  (materialised (B, H, T, T) scores with an additive finfo.min key bias);
- ``"auto"``: the kernel for CUDA tensors under that condition, else plain.

``ATTENTION_CALLS`` counts the self-attention calls per route, as the
kernels' launches are counted: a call captured into a CUDA graph counts
at each replay (``ops/_build.py::count_launch``).

The Transformer-XL ``relative`` flavor takes the plain path on every
device, as in JAX (the kernel is gated on ``relative_key``):
(q + u) k^T plus the shifted (q + v) pe^T over a sinusoidal table of
2T - 1 positions, projected by ``linear_pos`` (no bias). The table is
built in numpy fp32 as JAX builds it, cached per length and device on the
model, and cast to the compute dtype before ``linear_pos``. Its score
tensor is (B, H, T, 2T - 1), twice the rel-key path's.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svecalign_tpu_torch.ops import _build, layer_norm, layer_norm_cuda

BACKENDS = ("auto", "cuda", "torch")

ATTENTION_CALLS = {"cuda": 0, "torch": 0}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class W2vBertConfig:
    feature_projection_input_dim: int = 160
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5
    position_embeddings_type: str = "relative_key"  # relative_key|relative|none
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    dtype: str = "float32"
    # "auto": the CUDA kernel for CUDA tensors, the plain path elsewhere;
    # "cuda" forces the kernel, "torch" the plain path. Like the JAX fused
    # kernel, the kernel rebuilds key masking from lengths = sum(pad_mask),
    # which equals the mask only for contiguous padding (the SONAR
    # frontend builds exactly that mask)
    attention_backend: str = "auto"
    # "causal": w2v-BERT's conv module; "symmetric": FastConformer's
    # (biases, symmetric depthwise padding, BatchNorm; see the module doc)
    conv_module: str = "causal"
    # True: each layer hands the next its final LayerNorm's output in fp32,
    # so that the residual stream is fp32 between and inside the layers
    # (Parakeet); False: in the compute dtype (SONAR)
    residual_fp32: bool = False

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads


def compute_dtype(cfg) -> torch.dtype:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}")
    return DTYPES[cfg.dtype]


class FlaxLayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)``: fp32 statistics with the fast
    variance E[x^2] - E[x]^2 (clipped at 0), fp32 output. ``weight`` is
    flax's ``scale``.

    The statistics run over ``axis`` and the scale and bias lie along
    ``channel_axis``; both are the last axis by default. On a channels-first
    (B, C, T) tensor, ``axis=1, channel_axis=1`` is a LayerNorm over the
    channels and ``axis=2, channel_axis=1`` a flax ``GroupNorm`` with one
    group per channel (each channel over the whole length).

    A call may fuse its neighbours in (``ops/layer_norm.py``): ``dtype``
    rounds the output to it, ``conv_bias`` is a conv's bias added to ``x``
    first, ``gelu_out`` applies the JAX package's GELU after the rounding.

    Where the call runs: a CUDA tensor goes to the LayerNorm kernel
    (``ops/layer_norm_cuda.py``), which launches or raises, under autograd
    too (the trainer's forward); a tensor on any other device runs the
    plain arithmetic (``ops/layer_norm.py``). The GroupNorm form has no
    kernel and raises on a CUDA tensor (wav2vec2-base's layer 0, which no
    configuration runs)."""

    def __init__(self, dim: int, eps: float, axis: int = -1, channel_axis: int = -1):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.channel_axis = channel_axis
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                conv_bias: Optional[torch.Tensor] = None, gelu_out: bool = False) -> torch.Tensor:
        axis, channel_axis = self.axis % x.dim(), self.channel_axis % x.dim()
        if not x.is_cuda:
            return layer_norm.flax_layer_norm(x, self.weight, self.bias, self.eps, axis,
                                              channel_axis, dtype, conv_bias, gelu_out)
        if axis != channel_axis:
            raise ValueError("FlaxLayerNorm: the GroupNorm form (statistics over axis "
                             f"{axis}, channels along {channel_axis}) has no CUDA kernel")
        return layer_norm_cuda.flax_layer_norm_cuda(x, self.weight, self.bias, self.eps, axis,
                                                    dtype, conv_bias, gelu_out)


def sinusoidal_rel_pe(seq_len: int, d_model: int) -> np.ndarray:
    """Transformer-XL relative positional table, length 2T - 1, laid out
    [pos T-1 .. 1, 0, -1 .. -(T-1)] exactly like HF's
    Wav2Vec2BertRelPositionalEmbedding (positive part flipped, negative
    part from index 1). numpy fp32, the JAX package's arithmetic."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model)
    )
    pe_pos = np.zeros((seq_len, d_model), np.float32)
    pe_neg = np.zeros((seq_len, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(position * div_term)
    pe_pos[:, 1::2] = np.cos(position * div_term)
    pe_neg[:, 0::2] = np.sin(-position * div_term)
    pe_neg[:, 1::2] = np.cos(-position * div_term)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)  # (2T-1, d)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class _FeedForward(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        dt = compute_dtype(self.cfg)
        x = F.silu(dense(self.intermediate_dense, x, dt))  # hidden_act = swish
        return dense(self.output_dense, x, dt)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        if cfg.position_embeddings_type not in ("relative_key", "relative", "none"):
            raise ValueError(f"unknown position_embeddings_type {cfg.position_embeddings_type!r}")
        self.cfg = cfg
        self.attention_backend = cfg.attention_backend
        h = cfg.hidden_size
        self.linear_q = nn.Linear(h, h)
        self.linear_k = nn.Linear(h, h)
        self.linear_v = nn.Linear(h, h)
        self.linear_out = nn.Linear(h, h)
        if cfg.position_embeddings_type == "relative_key":
            n_pos = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
            self.distance_embedding = nn.Parameter(torch.zeros(n_pos, cfg.head_size))
        if cfg.position_embeddings_type == "relative":
            nh, dh = cfg.num_attention_heads, cfg.head_size
            self.pos_bias_u = nn.Parameter(torch.zeros(nh, dh))
            self.pos_bias_v = nn.Parameter(torch.zeros(nh, dh))
            self.linear_pos = nn.Linear(h, h, bias=False)

    def _use_kernel(self, x: torch.Tensor) -> bool:
        cfg, backend = self.cfg, self.attention_backend
        if backend not in BACKENDS:
            raise ValueError(f"attention_backend must be one of {BACKENDS}, got {backend!r}")
        fits = (cfg.position_embeddings_type == "relative_key"
                and cfg.head_size == 64 and cfg.num_attention_heads % 2 == 0)
        if backend == "cuda":
            if not x.is_cuda:
                raise RuntimeError("attention_backend='cuda' needs CUDA tensors")
            if not fits:
                raise ValueError("attention_backend='cuda' needs relative_key attention, "
                                 "head size 64 and an even head count")
            return True
        return backend == "auto" and fits and x.is_cuda

    def forward(self, x, attn_bias, lengths=None, rel_pe=None):
        """x: (B, T, H); attn_bias: (B, 1, 1, T) additive fp32 or None;
        lengths: (B,) int32 valid-frame counts (the kernel's form of
        attn_bias); rel_pe: (2T - 1, H) fp32 sinusoidal table of the
        'relative' flavor."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        b, t, _ = x.shape
        nh, dh = cfg.num_attention_heads, cfg.head_size
        q = dense(self.linear_q, x, dt).view(b, t, nh, dh)
        k = dense(self.linear_k, x, dt).view(b, t, nh, dh)
        v = dense(self.linear_v, x, dt).view(b, t, nh, dh)
        if self._use_kernel(x):
            from svecalign_tpu_torch.ops.attention_cuda import relkey_attention_cuda

            _build.count_launch(ATTENTION_CALLS, "cuda")
            out = relkey_attention_cuda(
                q, k, v, self.distance_embedding.to(dt), lengths,
                left=cfg.left_max_position_embeddings,
                right=cfg.right_max_position_embeddings,
            )
            return dense(self.linear_out, out.reshape(b, t, nh * dh), dt)

        _build.count_launch(ATTENTION_CALLS, "torch")
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, T, dh)
        if cfg.position_embeddings_type == "relative":
            # Transformer-XL: (q + u) k^T + shifted (q + v) pe^T, / sqrt(dh)
            pe = dense(self.linear_pos, rel_pe.to(dt), dt)
            pe = pe.view(-1, nh, dh).transpose(0, 1)  # (H, 2T-1, dh)
            q_u = q + self.pos_bias_u[None, :, None, :].to(dt)
            q_v = q + self.pos_bias_v[None, :, None, :].to(dt)
            scores_ac = torch.matmul(q_u, k.transpose(-1, -2))
            scores_bd = torch.matmul(q_v, pe.transpose(-1, -2)[None])  # (B, H, T, 2T-1)
            # shift trick (HF _apply_relative_embeddings step 5)
            r = scores_bd.shape[-1]
            bd = F.pad(scores_bd, (1, 0))
            bd = bd.reshape(b, nh, r + 1, t)[:, :, 1:].reshape(b, nh, t, r)
            scores = (scores_ac + bd[..., : r // 2 + 1]) / math.sqrt(dh)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if cfg.position_embeddings_type == "relative_key":
            left = cfg.left_max_position_embeddings
            pos = torch.arange(t, device=x.device)
            distance = torch.clamp(pos[None, :] - pos[:, None], -left,
                                   cfg.right_max_position_embeddings)
            rel = self.distance_embedding[distance + left].to(dt)  # (T, T, dh)
            scores = scores + torch.einsum("bhld,lrd->bhlr", q, rel) / math.sqrt(dh)
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, nh * dh)
        return dense(self.linear_out, out, dt)


class _ConvModule(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        if cfg.conv_module not in ("causal", "symmetric"):
            raise ValueError(f"unknown conv_module {cfg.conv_module!r}")
        self.cfg = cfg
        h, ks = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        sym = cfg.conv_module == "symmetric"
        if sym and ks % 2 != 1:
            raise ValueError(f"a symmetric depthwise conv needs an odd kernel, got {ks}")
        self.layer_norm = FlaxLayerNorm(h, cfg.layer_norm_eps)
        self.pointwise_conv1 = nn.Linear(h, 2 * h, bias=sym)
        self.depthwise_conv = nn.Conv1d(h, h, ks, groups=h, bias=sym)
        if sym:
            self.batch_norm = nn.BatchNorm1d(h)
        else:
            self.depthwise_layer_norm = FlaxLayerNorm(h, cfg.layer_norm_eps)
        self.pointwise_conv2 = nn.Linear(h, h, bias=sym)

    def forward(self, x, pad_mask):
        """pad_mask: (B, T) bool, True = valid. The depthwise conv is CAUSAL
        (left pad k - 1), or symmetric in the FastConformer form."""
        if self.cfg.conv_module == "symmetric":
            return self._symmetric(x, pad_mask)
        cfg = self.cfg
        dt = compute_dtype(cfg)
        h = cfg.hidden_size
        x = self.layer_norm(x, dt)
        if pad_mask is not None:
            x = torch.where(pad_mask[:, :, None], x, torch.zeros((), dtype=dt, device=x.device))
        x = dense(self.pointwise_conv1, x, dt)
        x = x[..., :h] * torch.sigmoid(x[..., h:])  # GLU over channels
        x = F.pad(x.transpose(1, 2), (cfg.conv_depthwise_kernel_size - 1, 0))
        x = F.conv1d(x, self.depthwise_conv.weight.to(dt), groups=h).transpose(1, 2)
        x = F.silu(self.depthwise_layer_norm(x, dt))
        return dense(self.pointwise_conv2, x, dt)

    def _symmetric(self, x, pad_mask):
        """FastConformer: the pointwise conv's bias makes padded frames
        non-zero, so they are zeroed after the GLU; the BatchNorm is the
        inference form, a per-channel affine of the running statistics in
        fp32."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        h = cfg.hidden_size
        x = dense(self.pointwise_conv1, self.layer_norm(x, dt), dt)
        x = x[..., :h] * torch.sigmoid(x[..., h:])  # GLU over channels
        if pad_mask is not None:
            x = torch.where(pad_mask[:, :, None], x, torch.zeros((), dtype=dt, device=x.device))
        conv = self.depthwise_conv
        x = F.conv1d(x.transpose(1, 2), conv.weight.to(dt), conv.bias.to(dt),
                     padding=(cfg.conv_depthwise_kernel_size - 1) // 2, groups=h)
        bn = self.batch_norm
        x = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return dense(self.pointwise_conv2, F.silu(x).to(dt).transpose(1, 2), dt)


class W2vBertEncoderLayer(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = FlaxLayerNorm(h, eps)
        self.ffn1 = _FeedForward(cfg)
        self.self_attn_layer_norm = FlaxLayerNorm(h, eps)
        self.self_attn = _SelfAttention(cfg)
        self.conv_module = _ConvModule(cfg)
        self.ffn2_layer_norm = FlaxLayerNorm(h, eps)
        self.ffn2 = _FeedForward(cfg)
        self.final_layer_norm = FlaxLayerNorm(h, eps)

    def forward(self, x, attn_bias, pad_mask, lengths=None, rel_pe=None):
        dt = compute_dtype(self.cfg)
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x, dt))
        x = x + self.self_attn(self.self_attn_layer_norm(x, dt), attn_bias, lengths, rel_pe)
        x = x + self.conv_module(x, pad_mask)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x, dt))
        return self.final_layer_norm(x, torch.float32 if self.cfg.residual_fp32 else dt)


class W2vBertModel(nn.Module):
    """fp_layer_norm + fp_projection + conformer layers ==
    Wav2Vec2BertModel with add_adapter=False."""

    def __init__(self, cfg: W2vBertConfig = W2vBertConfig()):
        super().__init__()
        self.cfg = cfg
        compute_dtype(cfg)
        self.fp_layer_norm = FlaxLayerNorm(cfg.feature_projection_input_dim, cfg.layer_norm_eps)
        self.fp_projection = nn.Linear(cfg.feature_projection_input_dim, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):  # flax names: layers_0, layers_1, ...
            self.add_module(f"layers_{i}", W2vBertEncoderLayer(cfg))
        self._rel_pe = {}  # (T, device) -> the 'relative' flavor's fp32 table

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_hidden_layers)]

    def set_attention_backend(self, backend: str) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"attention_backend must be one of {BACKENDS}, got {backend!r}")
        for layer in self.layers():
            layer.self_attn.attention_backend = backend

    def forward(self, feats: torch.Tensor, pad_mask: Optional[torch.Tensor] = None):
        """feats: (B, T, feature_projection_input_dim) stacked log-mels;
        pad_mask: (B, T) bool, True = valid frame. Returns (B, T, H) in the
        compute dtype."""
        dt = compute_dtype(self.cfg)
        x = dense(self.fp_projection, self.fp_layer_norm(feats, dt), dt)
        attn_bias = lengths = None
        if pad_mask is not None:
            x = torch.where(pad_mask[:, :, None], x, torch.zeros((), dtype=dt, device=x.device))
            neg = torch.finfo(torch.float32).min
            attn_bias = torch.where(pad_mask[:, None, None, :], 0.0, neg).float()
            # contiguous-padding form for the kernel (the frontend builds
            # pad_mask as arange < lengths)
            lengths = pad_mask.sum(dim=1, dtype=torch.int32)
        rel_pe = None
        if self.cfg.position_embeddings_type == "relative":
            rel_pe = self.rel_pe(x.shape[1], x.device)
        for layer in self.layers():
            x = layer(x, attn_bias, pad_mask, lengths, rel_pe)
        return x

    def rel_pe(self, t: int, device: torch.device) -> torch.Tensor:
        return cached_rel_pe(self._rel_pe, t, self.cfg.hidden_size, device)


def cached_rel_pe(cache: dict, t: int, d_model: int, device) -> torch.Tensor:
    """The (2t - 1, d_model) fp32 table of the 'relative' flavor on
    ``device``, made once per length and device into ``cache``, at an eager
    call (an encoder's warm-up runs before any CUDA graph's capture)."""
    key = (t, torch.device(device))
    if key not in cache:
        cache[key] = torch.from_numpy(sinusoidal_rel_pe(t, d_model)).to(device)
    return cache[key]
