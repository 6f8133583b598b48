"""SONAR speech encoder in PyTorch: the stage-5.3 embedder.

Port of the JAX package's ``models/sonar_encoder.py``: a w2v-BERT 2.0
conformer trunk (:mod:`svecalign_tpu_torch.models.w2v_bert`) plus an
attention pooler, one ``pool_dim`` vector per waveform, written by the
embed stage as headerless raw fp16/fp32 rows. The frontend reproduces
SeamlessM4TFeatureExtractor semantics as the JAX one does: kaldi 80-mel
log-fbank on the 16-bit-scaled waveform (``ops/fbank.py``), per-utterance
per-bin normalisation over valid frames (ddof = 1), stride-2 stacking to
160 dims.

``SonarSpeechModel`` is the model's shape policy (frame buckets, a fixed
``batch_size`` of rows a chunk, rounded up to a multiple of a mesh's
shard count as in JAX) and its forward (frontend, trunk with the rel-key
kernel on a card, pooler); the host wrapper it inherits
(``models/encode_common.py::SpanEncoderMixin``) loads the weights (the
pooler's ``out_proj`` kept fp32), chunks, uploads each chunk as per-row
int16 (or fp32), runs its forward through the program cache
(``utils/programs.py``: a replayed CUDA graph per replica and chunk shape
on a card; the trunk's attention routes are part of a program's key),
splits chunks over a mesh and pulls the rows.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from svecalign_tpu_torch.models.encode_common import SpanEncoderMixin
from svecalign_tpu_torch.models.w2v_bert import (
    W2vBertConfig,
    W2vBertModel,
    compute_dtype,
    dense,
)
from svecalign_tpu_torch.ops.fbank import fbank_device
from svecalign_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class SonarEncoderConfig:
    n_mels: int = 80
    model_dim: int = 1024
    n_layers: int = 24  # w2v-BERT 2.0 / SONAR speech trunk depth
    n_heads: int = 16
    ffn_dim: int = 4096
    conv_kernel: int = 31
    pool_dim: int = 1024
    position_embeddings_type: str = "relative_key"
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    dtype: str = "bfloat16"
    attention_backend: str = "auto"  # the CUDA rel-key kernel on the card

    def trunk_config(self) -> W2vBertConfig:
        return W2vBertConfig(
            feature_projection_input_dim=2 * self.n_mels,
            hidden_size=self.model_dim,
            num_hidden_layers=self.n_layers,
            num_attention_heads=self.n_heads,
            intermediate_size=self.ffn_dim,
            conv_depthwise_kernel_size=self.conv_kernel,
            position_embeddings_type=self.position_embeddings_type,
            left_max_position_embeddings=self.left_max_position_embeddings,
            right_max_position_embeddings=self.right_max_position_embeddings,
            dtype=self.dtype,
            attention_backend=self.attention_backend,
        )


class AttentionPooler(nn.Module):
    """Learned-query multi-head attention pooling: one query attends over
    the encoder states, output projected to ``pool_dim`` in fp32."""

    def __init__(self, cfg: SonarEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.model_dim
        self.query = nn.Parameter(torch.zeros(1, 1, d))
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, cfg.pool_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = compute_dtype(cfg)
        b, t, d = x.shape
        nh = cfg.n_heads
        dh = d // nh
        q = dense(self.q_proj, self.query.expand(b, 1, d), dt)
        k = dense(self.k_proj, x, dt)
        v = dense(self.v_proj, x, dt)
        q = q.view(b, 1, nh, dh).transpose(1, 2)
        k = k.view(b, t, nh, dh).transpose(1, 2)
        v = v.view(b, t, nh, dh).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(dh))
        neg = torch.finfo(torch.float32).min
        scores = torch.where(mask[:, None, None, :], scores.float(), neg)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, d)
        return dense(self.out_proj, out, torch.float32)


class SonarSpeechEncoder(nn.Module):
    """w2v-BERT trunk + attention pooler: stacked mels -> (B, pool_dim)."""

    def __init__(self, cfg: SonarEncoderConfig = SonarEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.trunk = W2vBertModel(cfg.trunk_config())
        self.pooler = AttentionPooler(cfg)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.pooler(self.trunk(feats, mask), mask).float()


def sonar_frontend(wav: torch.Tensor, lengths: torch.Tensor, n_frames: int, n_mels: int):
    """SeamlessM4TFeatureExtractor-equivalent frontend on (B, n_samples)
    fp32 waveforms: kaldi fbank on the 16-bit-scaled waveform, per-row
    per-bin normalisation over valid frames (ddof = 1), stride-2 stacking.
    Returns (feats (B, n_frames // 2, 2 n_mels) fp32, mask (B, n_frames // 2)
    bool)."""
    feats = fbank_device(wav * 32768.0, 16000, n_mels, 400, 160, n_frames)  # (B, T, n_mels)
    t = feats.shape[1]
    lengths = lengths.to(feats.device)
    n_valid = torch.clamp(lengths, min=1)
    m = (torch.arange(t, device=feats.device)[None, :] < n_valid[:, None])[:, :, None]
    n = n_valid.float()[:, None, None]
    mean = torch.where(m, feats, 0.0).sum(dim=1, keepdim=True) / n
    var = torch.where(m, torch.square(feats - mean), 0.0).sum(dim=1, keepdim=True) / torch.clamp(
        n - 1.0, min=1.0)
    feats = torch.where(m, (feats - mean) / torch.sqrt(var + 1e-7), 0.0)
    # stride-2 stacking; HF keeps attention rows where frame % 2 == 1, so
    # the stacked valid count is lengths // 2
    t2 = t - t % 2
    feats = feats[:, :t2].reshape(feats.shape[0], t2 // 2, 2 * n_mels)
    mask2 = torch.arange(t2 // 2, device=feats.device)[None, :] < (lengths // 2)[:, None]
    return feats, mask2


class SonarSpeechModel(SpanEncoderMixin):
    """SONAR's shape policy and forward (the host wrapper is
    :class:`~svecalign_tpu_torch.models.encode_common.SpanEncoderMixin`)."""

    # 10 ms frames (pre-stack), the JAX package's buckets: 700/1400 fill
    # the 500 -> 1000 -> 2000 gaps where overlap windows fall; 4500/6000
    # exist for embed_align spans. Longer inputs truncate, loudly.
    BUCKET_FRAMES = (200, 500, 700, 1000, 1400, 2000, 3000, 4500, 6000)
    KEEP_FP32 = ("pooler.out_proj",)

    def __init__(
        self,
        config: SonarEncoderConfig = SonarEncoderConfig(),
        ckpt_path: Optional[str] = None,
        batch_size: int = 16,
        seed: int = 0,
        upload_dtype: str = "int16",
        device="cuda",
        mesh=None,
    ):
        self.batch_size = batch_size  # rounded up to the mesh's shard count
        super().__init__(SonarSpeechEncoder, config, ckpt_path, seed, upload_dtype, device, mesh)

    def _fit_rows_to_mesh(self) -> None:
        self.batch_size = -(-self.batch_size // self.data_shards) * self.data_shards

    def _bucket(self, n: int) -> int:
        for b in self.BUCKET_FRAMES:
            if n <= b:
                return b
        return self.BUCKET_FRAMES[-1]

    # --- SpanEncoderMixin hooks (buckets in 10 ms frames) ---

    def _span_buckets(self):
        return self.BUCKET_FRAMES

    def _bucket_width(self, bucket: int) -> int:
        return 400 + (bucket - 1) * 160  # frames -> samples

    def _rows_per_chunk(self, bucket: int) -> int:
        return self.batch_size

    def _span_plan(self, start: int, ln: int):
        n_frames = 0 if ln < 400 else 1 + (ln - 400) // 160
        bucket = self._bucket(n_frames)
        width = self._bucket_width(bucket)
        return (bucket, (start, min(ln, width), min(n_frames, bucket)),
                n_frames > self.BUCKET_FRAMES[-1])

    def _forward_variant(self, model):
        return tuple(layer.self_attn.attention_backend for layer in model.trunk.layers())

    def _forward(self, model, rows_q, row_scales, lengths, bucket):
        """(rows, samples) int16 or fp32 waveforms, (rows,) scales and
        frame lengths on ``model``'s device -> (rows, pool_dim) fp32.
        Spans ``embed.frontend``, ``embed.trunk``, ``embed.pooler`` (none
        inside a capture)."""
        dev = rows_q.device
        with trace.EMBED.span("embed.frontend", dev):
            wav = rows_q.float() * row_scales[:, None]
            feats, mask2 = sonar_frontend(wav, lengths, bucket, self.config.n_mels)
        with trace.EMBED.span("embed.trunk", dev):
            x = model.trunk(feats, mask2)
        with trace.EMBED.span("embed.pooler", dev):
            return model.pooler(x, mask2).float()

    @property
    def _embed_dim(self) -> int:
        return self.config.pool_dim

    @property
    def _trunc_unit(self) -> str:
        return f"{self.BUCKET_FRAMES[-1]} x 10 ms"
