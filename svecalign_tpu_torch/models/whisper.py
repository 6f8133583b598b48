"""Whisper (Radford et al., arXiv:2212.04356), the ASR of the audit stage,
as openai's ``model.py`` writes it, with the caches of a batched decode.

Nothing of the JAX package corresponds: the JAX package reached Whisper
only through the optional ``whisper`` import of its audit CLI. The layer
equations, in openai's module and parameter names (so that openai's
checkpoint loads by name):

- **Encoder**: ``gelu(conv1)`` (Conv1d n_mels -> d, kernel 3, pad 1),
  ``gelu(conv2)`` (Conv1d d -> d, kernel 3, stride 2, pad 1: 3000 mel
  frames -> 1500 positions), plus fixed sinusoids (``[sin, cos]`` of
  ``arange(n_ctx) * exp(-ln(10000) / (d/2 - 1) * arange(d/2))``), then
  ``n_audio_layer`` blocks of ``x + attn(attn_ln x)`` and ``x +
  mlp(mlp_ln x)`` (``mlp`` = Linear(d, 4d), exact GELU, Linear(4d, d)),
  then ``ln_post``.
- **Attention**: query, value and out projections with a bias, the key
  projection without; scores ``q k^T / sqrt(d_head)``, the softmax in
  fp32.
- **Decoder**: the token embedding plus a learned positional table of
  ``n_text_ctx`` rows, sliced at the cache's offset; ``n_text_layer``
  blocks of causal self-attention, cross-attention on the encoder's
  output (``cross_attn_ln``) and the MLP; ``ln``; logits = ``x @
  token_embedding.weight.T``.

Departures, each deliberate:

- Served in bf16 products with an fp32 residual stream, fp32 LayerNorms
  (their outputs cast to bf16 for the products) and fp32 logits (the
  final LayerNorm's output times an fp32 copy of the bf16 token
  embedding, made once: :meth:`TextDecoder.logit_table`), as the port's
  other configurations serve; openai serves
  fp16, its residual stream too (``dtype="float32"`` gives a float32
  model, the CPU tests' route).
- openai scales q and k each by ``d_head ** -0.25`` before their product;
  here ``F.scaled_dot_product_attention`` applies ``d_head ** -0.5`` to
  the product (the same in exact arithmetic; the plain reference,
  ``bench_port/reference/whisper.py``, scales as openai does).
- Decoding keeps two caches (:class:`TextDecoder`): the cross-attention
  K/V, computed once per clip and layer from the encoder's output
  (:meth:`TextDecoder.cross_kv`), and the self-attention K/V, one tensor
  per layer of ``(B, heads, length, d_head)`` written at the step's
  offset (:meth:`TextDecoder.new_cache`). openai's hooks that grow a
  concatenated cache are not copied.
- The decoder's attention runs on PyTorch's flash, memory-efficient or
  plain SDPA kernels, never cuDNN's (:data:`DECODE_BACKENDS`): cuDNN
  builds an execution plan for each new shape, and the self-attention's
  length grows by one a step. The encoder's fixed shape may take cuDNN's.

:data:`DIMS` holds the published sizes of the multilingual models (openai
``__init__.py``'s checkpoints); :func:`load_checkpoint` reads openai's
``torch.save`` file, ``{"dims", "model_state_dict"}``, the file that
``whisper.load_model(size, download_root=root)`` reads as
``<root>/<size>.pt``.
"""

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KV = Tuple[torch.Tensor, torch.Tensor]  # one layer's keys and values
# the decoder's attention backends: cuDNN's is left out, as it builds an
# execution plan for every new shape, and the self-attention's length grows
# by one every step
DECODE_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


@dataclass(frozen=True)
class WhisperDims:
    """openai's ``ModelDimensions``, by the same names."""

    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int


def _dims(d: int, heads: int, layers: int, n_mels: int = 80, n_vocab: int = 51865,
          text_layers: Optional[int] = None) -> WhisperDims:
    return WhisperDims(n_mels, 1500, d, heads, layers, n_vocab, 448, d, heads,
                       layers if text_layers is None else text_layers)


DIMS: Dict[str, WhisperDims] = {
    "tiny": _dims(384, 6, 4),
    "base": _dims(512, 8, 6),
    "small": _dims(768, 12, 12),
    "medium": _dims(1024, 16, 24),
    "large-v1": _dims(1280, 20, 32),
    "large-v2": _dims(1280, 20, 32),
    "large-v3": _dims(1280, 20, 32, n_mels=128, n_vocab=51866),
    "turbo": _dims(1280, 20, 32, n_mels=128, n_vocab=51866, text_layers=4),
}
"""Published sizes of the multilingual checkpoints (openai ``model.py``'s
``ModelDimensions`` as each ``.pt`` file stores them)."""


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """openai's encoder position table: (length, channels) fp32, sines then
    cosines."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of the fp32 residual stream in fp32, cast to ``dtype``."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, heads, T, d_head)."""
        b, t, d = x.shape
        return x.view(b, t, self.n_head, d // self.n_head).transpose(1, 2)

    def kv(self, x: torch.Tensor) -> KV:
        """Keys and values of ``x``, each (B, heads, T, d_head), contiguous."""
        return (self.heads(self.key(x)).contiguous(), self.heads(self.value(x)).contiguous())

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
        """``out(softmax(q k^T / sqrt(d_head)) v)`` with q from ``x`` (B, T, d)."""
        b, t, d = x.shape
        o = F.scaled_dot_product_attention(self.heads(self.query(x)), k, v, attn_mask=mask,
                                           is_causal=causal)
        return self.out(o.transpose(1, 2).reshape(b, t, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        self.cross_attn = MultiHeadAttention(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = nn.LayerNorm(n_state) if cross_attention else None
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state)

    @property
    def dtype(self) -> torch.dtype:
        """The products' dtype."""
        return self.mlp[0].weight.dtype

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(_norm(self.mlp_ln, x, self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's block on the fp32 residual stream: full
        self-attention, then the MLP."""
        h = _norm(self.attn_ln, x, self.dtype)
        a = self.attn
        x = x + a.attend(h, a.heads(a.key(h)), a.heads(a.value(h)))
        return self._mlp(x)

    def decode(self, x: torch.Tensor, offset: int, cache: KV, cross: KV) -> torch.Tensor:
        """The decoder's block on positions ``offset .. offset + T - 1``: this
        block's self-attention K/V written into ``cache`` there, the queries
        attending every cached position up to their own."""
        t = x.shape[1]
        h = _norm(self.attn_ln, x, self.dtype)
        k, v = self.attn.kv(h)
        ck, cv = cache
        ck[:, :, offset:offset + t] = k
        cv[:, :, offset:offset + t] = v
        end = offset + t
        mask = None
        if t > 1 and offset:
            mask = (torch.arange(end, device=x.device)[None, :]
                    <= offset + torch.arange(t, device=x.device)[:, None])
        x = x + self.attn.attend(h, ck[:, :, :end], cv[:, :, :end], mask=mask,
                                 causal=t > 1 and not offset)
        h = _norm(self.cross_attn_ln, x, self.dtype)
        x = x + self.cross_attn.attend(h, *cross)
        return self._mlp(x)


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", sinusoids(dims.n_audio_ctx, d))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, dims.n_audio_head)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = nn.LayerNorm(d)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 2 n_audio_ctx) fp32 log-mel -> (B, n_audio_ctx, d) in
        the compute dtype."""
        dt = self.conv1.weight.dtype
        x = F.gelu(self.conv1(mel.to(dt)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        if x.shape[1:] != self.positional_embedding.shape:
            raise ValueError(f"the encoder takes {2 * self.positional_embedding.shape[0]} mel "
                             f"frames, got {mel.shape[-1]}")
        x = x + self.positional_embedding
        for block in self.blocks:
            x = block(x)
        return _norm(self.ln_post, x, dt)


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_text_state
        self.token_embedding = nn.Embedding(dims.n_vocab, d)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, dims.n_text_head, True)
                                    for _ in range(dims.n_text_layer))
        self.ln = nn.LayerNorm(d)

    def cross_kv(self, xa: torch.Tensor, out: Optional[List[KV]] = None) -> List[KV]:
        """Every layer's cross-attention K/V of the encoder's output
        (B, n_audio_ctx, d): once per clip, read by every step. ``out``
        (as :meth:`new_cache` of ``n_audio_ctx`` positions makes it) takes
        them layer by layer, in place."""
        if out is None:
            return [block.cross_attn.kv(xa) for block in self.blocks]
        for block, (k, v) in zip(self.blocks, out):
            a = block.cross_attn
            k.copy_(a.heads(a.key(xa)))
            v.copy_(a.heads(a.value(xa)))
        return out

    def new_cache(self, batch: int, length: int) -> List[KV]:
        """Every layer's self-attention K/V for ``length`` positions:
        (B, heads, length, d_head) each, in the compute dtype, unset."""
        w = self.token_embedding.weight
        h = self.blocks[0].attn.n_head
        shape = (batch, h, length, w.shape[1] // h)
        return [(torch.empty(shape, dtype=w.dtype, device=w.device),
                 torch.empty(shape, dtype=w.dtype, device=w.device)) for _ in self.blocks]

    def logit_table(self) -> torch.Tensor:
        """The logits' matrix: the token embedding in fp32. A table in
        another dtype is cast into one fp32 copy, kept and cast again only
        after the embedding changed in place, so that a step reads the
        table once and does not cast it; the copy keeps its storage, so a
        program captured on it reads the new values."""
        w = self.token_embedding.weight
        if w.dtype == torch.float32:
            return w
        table = getattr(self, "_table", None)
        if table is None or table.shape != w.shape or table.device != w.device:
            table = self._table = torch.empty(w.shape, dtype=torch.float32, device=w.device)
            self._table_version = None
        if self._table_version != w._version:
            table.copy_(w)
            self._table_version = w._version
        return table

    def forward(self, tokens: torch.Tensor, offset: int, cache: List[KV],
                cross: List[KV]) -> torch.Tensor:
        """(B, T) token ids at positions ``offset ..`` -> (B, T, n_vocab)
        fp32 logits; ``cache`` holds positions ``0 .. offset - 1`` and gets
        these."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens).float() + self.positional_embedding[offset:offset + t]
        with sdpa_kernel(DECODE_BACKENDS):
            for block, kv, xkv in zip(self.blocks, cache, cross):
                x = block.decode(x, offset, kv, xkv)
        return F.linear(_norm(self.ln, x, torch.float32), self.logit_table())


class Whisper(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)


def build(dims: WhisperDims, device, dtype: str = "bfloat16") -> Whisper:
    """A :class:`Whisper` on ``device`` with its weights unset (fill them by
    :func:`load_weights`): products' weights, biases and both embeddings in
    ``dtype``, LayerNorms in fp32, the encoder's sinusoids computed."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
    with torch.device("meta"):
        model = Whisper(dims)
    model = model.to_empty(device=device)
    dt = DTYPES[dtype]
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Embedding)):
            mod.to(dt)
    model.decoder.positional_embedding.data = model.decoder.positional_embedding.data.to(dt)
    model.encoder.positional_embedding.copy_(sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    return model.eval().requires_grad_(False)


def load_weights(model: Whisper, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` (openai's parameter names) into ``model``, each
    tensor cast to its parameter's dtype. Every parameter must be given,
    no unknown name is allowed; the encoder's sinusoids may be."""
    params = dict(model.named_parameters())
    extra = set(state) - set(params) - {"encoder.positional_embedding"}
    missing = set(params) - set(state)
    if extra or missing:
        raise ValueError(f"the weights differ from the model's parameters: missing "
                         f"{sorted(missing)[:4]}, unknown {sorted(extra)[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            w = state[name]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{name}: model {tuple(p.shape)}, weights {tuple(w.shape)}")
            p.copy_(w)
    model.decoder.logit_table()


def load_checkpoint(path: Union[str, Path], device, dtype: str = "bfloat16") -> Whisper:
    """openai's checkpoint file (``{"dims", "model_state_dict"}``, as
    ``whisper.load_model`` reads it) as a model on ``device``. Raises,
    naming the path, where there is no such file: nothing is downloaded."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no Whisper checkpoint at {path}: openai's <size>.pt is "
                                f"needed there (nothing is downloaded)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = build(WhisperDims(**ckpt["dims"]), device, dtype)
    load_weights(model, ckpt["model_state_dict"])
    return model


def cache_bytes(model: Whisper, rows: int, length: int) -> int:
    """Bytes of a batch's cross- and self-attention K/V: ``rows`` clips,
    ``length`` self-attention positions."""
    dims = model.dims
    item = model.decoder.token_embedding.weight.element_size()
    return int(2 * dims.n_text_layer * rows * dims.n_text_state * item
               * (dims.n_audio_ctx + length))

