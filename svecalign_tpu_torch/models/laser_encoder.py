"""SpeechLASER speech encoder in PyTorch: the stage-5.3 default embedder.

Port of the JAX package's ``models/laser_encoder.py``: a wav2vec2-large
family encoder (``feat_extract_norm="layer"``, ``do_stable_layer_norm``):

  raw 16 kHz waveform -> strided conv feature extractor (320x) ->
  post_extract_norm + post_extract_proj -> + GELU(positional conv) ->
  pre-norm transformer layers -> encoder_norm -> masked max pool over time

one ``encoder_dim`` vector per waveform, written by the embed stage as a
stopes ``.npy``. Module and attribute names are the flax module names, so
a flax parameter path maps to a ``state_dict`` key by ``/`` -> ``.``
(``models/param_utils.py``).

Numerics follow the flax modules:

- convs and Dense layers compute in the compute dtype (bf16 on the main
  path); every LayerNorm (epsilon 1e-6, flax's fast variance) computes in
  fp32 and returns the compute dtype where a dense or conv follows
  (``encoder_norm`` fp32, for the pool); the extractor casts back to it
  before its GELU (on a card the conv's bias add, the norm, the cast and
  the GELU are one launch of the LayerNorm kernel:
  ``models/w2v_bert.py::FlaxLayerNorm``); the residual stream is in the
  compute dtype;
- GELU is the tanh approximation below 32 bits and exact erf in fp32;
- attention scales the query by 1/sqrt(head size) and masks padded keys.
  The JAX package runs it as plain XLA (its Pallas kernel was measured
  slower there), so the port runs ``F.scaled_dot_product_attention`` with
  the key mask: there is no TPU kernel on this path;
- the masked max pool is fp32.

The positional conv mixes padded frames into valid ones, so a row's
embedding depends on its bucket's width: the buckets are the JAX ones.

The extractor and the positional conv run a batch in row groups of at
most ``CONV_GROUP_SAMPLES`` rows x samples (:func:`conv_groups`), one
after another: above that cuDNN runs the positional conv on its
implicit-GEMM fallback kernels. Every op of the two is per row, so the
rows are those of one call. ``SpeechLaserModel`` counts the extractor's
groups of each chunk (each shard's on a mesh) in the tracer's counter
``embed.extractor_groups``.

``SpeechLaserModel`` is the model's shape policy (its length buckets in
samples, rows per chunk from ``max_tokens``) and its forward; the host
wrapper it inherits (``models/encode_common.py::SpanEncoderMixin``) loads
the weights, chunks, runs each chunk's forward (extractor, trunk, pool)
through the program cache (``utils/programs.py``: a replayed CUDA graph
per replica and chunk shape on a card, the JAX package's jitted program
per bucket), splits chunks over a mesh and pulls the rows. With a mesh a
chunk's row count rounds up to a multiple of the shard count, as in JAX.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from svecalign_tpu_torch.models.encode_common import SpanEncoderMixin
from svecalign_tpu_torch.models.w2v_bert import FlaxLayerNorm, compute_dtype, dense
from svecalign_tpu_torch.ops.layer_norm import gelu
from svecalign_tpu_torch.utils import trace

FLAX_EPS = 1e-6  # flax LayerNorm / GroupNorm default epsilon

# The most rows x samples that one call of a conv takes: the extractor's
# convs on a group's waveforms, the positional conv on a group's frames
# (x 320, the samples they cover). Measured (measure/extractor_convs.py;
# H100 80GB HBM3, torch 2.11.0+cu128, cuDNN 9.22, heuristic choice): the
# positional conv runs a cutlass tensor-op kernel (2.5-5.6 ms) up to 8 rows
# of 60 s (7.68 M samples) and 100 rows of 4 s, and falls to cuDNN's
# implicit_convolve_sgemm + precomputed_convolve_sgemm (74-88 ms) from
# 25 rows of 20 s (8.0 M) and 128 rows of 4 s, at every bucket; the
# extractor's layers 1-6 take tensor-op kernels at every size measured
# (0.77-9.6 M) and its layer 0 (one input channel) the implicit-GEMM
# kernel at every size. Groups halve the extractor's intermediates too.
CONV_GROUP_SAMPLES = 7_680_000


def conv_groups(rows: int, samples: int) -> int:
    """The row groups a LASER conv runs (rows, samples) of input in: the
    fewest that keep each at most :data:`CONV_GROUP_SAMPLES` (as even as
    ``tensor_split`` makes them)."""
    return max(1, min(rows, -(-rows * samples // CONV_GROUP_SAMPLES)))


def by_row_groups(fn, x: torch.Tensor, groups: int) -> torch.Tensor:
    """``fn`` over ``groups`` row groups of ``x`` in turn, concatenated
    along the rows: ``fn(x)`` where ``fn`` works row by row."""
    parts = x.tensor_split(groups)
    return fn(x) if len(parts) == 1 else torch.cat([fn(part) for part in parts])


@dataclasses.dataclass(frozen=True)
class LaserEncoderConfig:
    # conv feature extractor: (dim, kernel, stride) per layer; 320x total
    conv_layers: tuple = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    # "layer" = per-layer LayerNorm (wav2vec2-large / XLSR / SpeechLASER);
    # "group" = GroupNorm on layer 0 only (wav2vec2-base)
    extractor_mode: str = "layer"
    conv_bias: bool = True
    encoder_dim: int = 1024
    encoder_layers: int = 24
    encoder_heads: int = 16
    encoder_ffn_dim: int = 4096
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    dtype: str = "bfloat16"  # compute dtype; params are fp32 or stored in it

    def receptive_field(self):
        """(samples per frame, hop in samples) of the VALID conv stack."""
        size, hop = 1, 1
        for _, k, s in reversed(self.conv_layers):
            size = (size - 1) * s + k
        for _, _, s in self.conv_layers:
            hop *= s
        return size, hop


class HeadsDense(nn.Linear):
    """A flax ``DenseGeneral`` of attention, stored as a plain Linear:
    ``side="in"`` is a query/key/value projection (kernel (d, heads, dh),
    bias (heads, dh)); ``side="out"`` the output projection (kernel
    (heads, dh, d), bias (d,)). ``models/param_utils.py`` maps the leaves."""

    def __init__(self, d: int, heads: int, side: str):
        super().__init__(d, d)
        self.flax_heads = heads
        self.flax_leaves = ({"weight": ("kernel", "heads_in"), "bias": ("bias", "heads_bias")}
                            if side == "in" else
                            {"weight": ("kernel", "heads_out"), "bias": ("bias", "plain")})


class ConvFeatureExtractor(nn.Module):
    """(B, samples) fp32 -> (B, frames, conv_dim) in the compute dtype."""

    def __init__(self, cfg: LaserEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.layer_mode = cfg.extractor_mode == "layer"
        in_dim = 1
        for i, (dim, kernel, stride) in enumerate(cfg.conv_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                in_dim, dim, kernel, stride=stride,
                bias=cfg.conv_bias if self.layer_mode else False))
            if self.layer_mode:
                self.add_module(f"layer_norm_{i}", FlaxLayerNorm(dim, FLAX_EPS, axis=1,
                                                                 channel_axis=1))
            in_dim = dim
        if not self.layer_mode:
            # GroupNorm(num_groups=channels): each channel over the padded length
            self.group_norm = FlaxLayerNorm(cfg.conv_layers[0][0], FLAX_EPS, axis=2,
                                            channel_axis=1)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """The rows in :func:`conv_groups` groups, one after another (every
        op of the stack, the norms too, is per row)."""
        return by_row_groups(self._stack, wav, conv_groups(*wav.shape)).transpose(1, 2)

    def _stack(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, conv_dim, frames), channels-first."""
        dt = compute_dtype(self.cfg)
        x = wav[:, None, :]  # (B, 1, T): torch convs are channels-first
        for i, (_, _, stride) in enumerate(self.cfg.conv_layers):
            conv = getattr(self, f"conv_{i}")
            w = conv.weight.to(dt)
            if self.layer_mode and x.is_cuda and conv.bias is not None:
                # a conv on a card adds its bias in a pass of its own over
                # the output, in the compute dtype: the LayerNorm kernel
                # takes that add in, bit for bit, with the norm, the cast
                # and the GELU
                x = F.conv1d(x.to(dt), w, stride=stride)
                x = getattr(self, f"layer_norm_{i}")(x, dt, conv.bias, gelu_out=True)
                continue
            bias = None if conv.bias is None else conv.bias.to(dt)
            x = F.conv1d(x.to(dt), w, bias, stride=stride)
            # back to the compute dtype before the activation, as in JAX
            if self.layer_mode:
                x = getattr(self, f"layer_norm_{i}")(x, dt, gelu_out=True)
            elif i == 0:
                x = self.group_norm(x, dt, gelu_out=True)
            else:
                x = gelu(x)
        return x


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, key mask) by
    ``F.scaled_dot_product_attention``."""

    def __init__(self, cfg: LaserEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.encoder_dim, cfg.encoder_heads
        self.query = HeadsDense(d, h, "in")
        self.key = HeadsDense(d, h, "in")
        self.value = HeadsDense(d, h, "in")
        self.out = HeadsDense(d, h, "out")

    def forward(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """y: (B, T, d); mask: (B, T) bool, True = valid key."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        b, t, d = y.shape
        h = cfg.encoder_heads
        q, k, v = (dense(m, y, dt).view(b, t, h, d // h).transpose(1, 2)
                   for m in (self.query, self.key, self.value))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :])
        return dense(self.out, out.transpose(1, 2).reshape(b, t, d), dt)


class TransformerLayer(nn.Module):
    """Pre-norm ("stable layer norm") transformer layer, wav2vec2-large style."""

    def __init__(self, cfg: LaserEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_dim
        self.attn_norm = FlaxLayerNorm(d, FLAX_EPS)
        self.attn = MultiHeadAttention(cfg)
        self.ffn_norm = FlaxLayerNorm(d, FLAX_EPS)
        self.ffn_in = nn.Linear(d, cfg.encoder_ffn_dim)
        self.ffn_out = nn.Linear(cfg.encoder_ffn_dim, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.cfg)
        x = x + self.attn(self.attn_norm(x, dt), mask)
        y = gelu(dense(self.ffn_in, self.ffn_norm(x, dt), dt))
        return x + dense(self.ffn_out, y, dt)


def positional(cfg: LaserEncoderConfig, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """GELU of the positional conv of (B, frames, d) ``x`` in the compute
    dtype, its rows in :func:`conv_groups` groups (by the samples its
    frames cover)."""
    dt = compute_dtype(cfg)
    w, b = weight.to(dt), bias.to(dt)

    def conv(part):
        # same-padded; the trailing frame of the even kernel is dropped
        return F.conv1d(part.transpose(1, 2), w, b, padding=cfg.conv_pos_kernel // 2,
                        groups=cfg.conv_pos_groups)

    hop = cfg.receptive_field()[1]
    pos = by_row_groups(conv, x, conv_groups(x.shape[0], x.shape[1] * hop))
    return gelu(pos[:, :, : x.shape[1]].transpose(1, 2))


def frame_mask(cfg: LaserEncoderConfig, lengths: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, n_frames) bool validity from (B,) sample lengths: frames whose
    whole receptive field is inside the length, at least one per row
    (floor division, as in JAX, also for length-0 padding rows)."""
    size, hop = cfg.receptive_field()
    frame_len = torch.div(lengths.long() - size, hop, rounding_mode="floor") + 1
    frame_len = torch.clamp(frame_len, min=1)
    return torch.arange(n_frames, device=lengths.device)[None, :] < frame_len[:, None]


def masked_max_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """LASER pooling: max over valid frames, fp32."""
    neg = torch.finfo(torch.float32).min
    return torch.where(mask[:, :, None], x.float(), neg).amax(dim=1)


class LaserSpeechEncoder(nn.Module):
    """wav2vec2-large-style encoder with LASER max pooling."""

    def __init__(self, cfg: LaserEncoderConfig = LaserEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        compute_dtype(cfg)
        d, c = cfg.encoder_dim, cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.post_extract_norm = FlaxLayerNorm(c, FLAX_EPS)
        self.post_extract_proj = nn.Linear(c, d)
        self.pos_conv = nn.Conv1d(d, d, cfg.conv_pos_kernel, padding=cfg.conv_pos_kernel // 2,
                                  groups=cfg.conv_pos_groups)
        for i in range(cfg.encoder_layers):  # flax names: layer_0, layer_1, ...
            self.add_module(f"layer_{i}", TransformerLayer(cfg))
        self.encoder_norm = FlaxLayerNorm(d, FLAX_EPS)

    def trunk(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, frames, conv_dim) extractor output -> (B, frames, d) fp32
        hidden states (after encoder_norm)."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        x = dense(self.post_extract_proj, self.post_extract_norm(feats, dt), dt)
        x = x + positional(cfg, x, self.pos_conv.weight, self.pos_conv.bias)
        for i in range(cfg.encoder_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.encoder_norm(x)

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor, return_hidden: bool = False):
        """wav: (B, samples) fp32 at 16 kHz; lengths: (B,) valid samples.
        Returns (B, encoder_dim) fp32 embeddings, or ((B, frames, d) hidden
        states, (B, frames) mask) when ``return_hidden``."""
        feats = self.feature_extractor(wav)
        mask = frame_mask(self.cfg, lengths.to(feats.device), feats.shape[1])
        x = self.trunk(feats, mask)
        if return_hidden:
            return x, mask
        return masked_max_pool(x, mask)


class SpeechLaserModel(SpanEncoderMixin):
    """SpeechLASER's shape policy and forward (the host wrapper is
    :class:`~svecalign_tpu_torch.models.encode_common.SpanEncoderMixin`)."""

    # length buckets in samples at 16 kHz, the JAX package's: 8 and 14 s fill
    # the gaps where overlap windows fall; 45/60 s exist for embed_align
    # spans. Longer inputs truncate, loudly.
    BUCKETS = (4 * 16000, 8 * 16000, 14 * 16000, 20 * 16000, 30 * 16000,
               45 * 16000, 60 * 16000)

    def __init__(
        self,
        config: LaserEncoderConfig = LaserEncoderConfig(),
        ckpt_path: Optional[str] = None,
        max_tokens: int = 150 * 16000,
        seed: int = 0,
        upload_dtype: str = "int16",
        device="cuda",
        mesh=None,
    ):
        self.max_tokens = max_tokens
        super().__init__(LaserSpeechEncoder, config, ckpt_path, seed, upload_dtype, device, mesh)

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return self.BUCKETS[-1]

    # --- SpanEncoderMixin hooks (units: samples at 16 kHz) ---

    def _span_buckets(self):
        return self.BUCKETS

    def _bucket_width(self, bucket: int) -> int:
        return bucket

    def _rows_per_chunk(self, bucket: int) -> int:
        rows = max(1, self.max_tokens // bucket)
        # round up so that a chunk splits evenly over the data axis
        return -(-rows // self.data_shards) * self.data_shards

    def _span_plan(self, start: int, ln: int):
        bucket = self._bucket(ln)
        return bucket, (start, ln, min(ln, bucket)), ln > self.BUCKETS[-1]

    def _span_forward(self, rows_q, row_scales, lengths, bucket, eager: bool = False):
        """The mixin's, after counting ``embed.extractor_groups``: the row
        groups the chunk's extractor runs, each shard's on a mesh. Counted
        here on the host, as a captured forward runs without Python."""
        rows = rows_q.shape[0] // self.data_shards
        trace.count("embed.extractor_groups",
                    self.data_shards * conv_groups(rows, rows_q.shape[1]))
        return super()._span_forward(rows_q, row_scales, lengths, bucket, eager)

    def _forward(self, model, rows_q, row_scales, lengths, bucket):
        """(rows, bucket) int16 or fp32 waveforms, (rows,) scales and
        sample lengths on ``model``'s device -> (rows, encoder_dim) fp32.
        Spans ``embed.frontend``, ``embed.trunk``, ``embed.pooler`` (none
        inside a capture)."""
        dev = rows_q.device
        with trace.EMBED.span("embed.frontend", dev):
            wav = rows_q.float() * row_scales[:, None]
            feats = model.feature_extractor(wav)
        with trace.EMBED.span("embed.trunk", dev):
            mask = frame_mask(self.config, lengths, feats.shape[1])
            x = model.trunk(feats, mask)
        with trace.EMBED.span("embed.pooler", dev):
            return masked_max_pool(x, mask)

    @property
    def _embed_dim(self) -> int:
        return self.config.encoder_dim

    @property
    def _trunc_unit(self) -> str:
        return f"{self.BUCKETS[-1] // 16000} s"
