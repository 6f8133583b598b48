"""Plain Whisper: log-mel, encoder, and the decoder's full teacher-forced
forward with no cache.

The published equations (Radford et al., arXiv:2212.04356; openai's
``model.py`` and ``audio.py``), in float32 with TF32 off, over a dict of
weights keyed by openai's parameter names (the program's state_dict):

  30 s of 16 kHz samples (zero-padded) -> centred STFT of 400 points at
  hop 160, periodic Hann window, power of every bin, last frame dropped
  -> Slaney mel filters (librosa's ``filters.mel(sr=16000, n_fft=400)``,
  unit-area triangles from 0 Hz to Nyquist) -> log10 clamped at 1e-10,
  floored at the clip's maximum less 8, (x + 4) / 4
  -> encoder: gelu(conv1 k3 p1), gelu(conv2 k3 s2 p1), + sinusoids,
     blocks of x + attn(LN x), x + mlp(LN x) (Linear 4d, exact GELU,
     Linear d), LN
  -> decoder over the whole token sequence at once: token table +
     positional rows, blocks of causal self-attention, cross-attention on
     the encoder's output and the MLP (each pre-LN, residual), LN,
     logits = x @ token_table^T.

Attention as openai writes it: q and k each scaled by d_head^-0.25, the
key projection without a bias, the softmax in float32, a causal mask of
-inf above the diagonal. LayerNorm epsilon 1e-5. This module imports
nothing of the program.
"""

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, Spec, layer_norm, served_dtype

SAMPLE_RATE = 16000
N_FFT, HOP = 400, 160
N_SAMPLES = 30 * SAMPLE_RATE
EPS = 1e-5


def param_spec(cfg: dict) -> Spec:
    """The weights by openai's names: products and both tables in the
    served dtype, LayerNorms in float32."""
    bf, f32 = served_dtype(cfg), torch.float32
    da, dt = cfg["n_audio_state"], cfg["n_text_state"]

    def norm(name, dim):
        return [(name + ".weight", (dim,), "scale", f32), (name + ".bias", (dim,), "shift", f32)]

    def lin(name, o, i, bias=True):
        return [(name + ".weight", (o, i), "kernel", bf)] + (
            [(name + ".bias", (o,), "bias", bf)] if bias else [])

    def attn(name, d):
        return (lin(name + ".query", d, d) + lin(name + ".key", d, d, bias=False)
                + lin(name + ".value", d, d) + lin(name + ".out", d, d))

    def block(p, d, cross):
        out = attn(p + "attn", d) + norm(p + "attn_ln", d)
        if cross:
            out += attn(p + "cross_attn", d) + norm(p + "cross_attn_ln", d)
        return out + lin(p + "mlp.0", 4 * d, d) + lin(p + "mlp.2", d, 4 * d) + norm(p + "mlp_ln", d)

    spec = [("encoder.conv1.weight", (da, cfg["n_mels"], 3), "kernel", bf),
            ("encoder.conv1.bias", (da,), "bias", bf),
            ("encoder.conv2.weight", (da, da, 3), "kernel", bf),
            ("encoder.conv2.bias", (da,), "bias", bf)]
    for i in range(cfg["n_audio_layer"]):
        spec += block(f"encoder.blocks.{i}.", da, False)
    spec += norm("encoder.ln_post", da)
    spec += [("decoder.token_embedding.weight", (cfg["n_vocab"], dt), "kernel", bf),
             ("decoder.positional_embedding", (cfg["n_text_ctx"], dt), "table", bf)]
    for i in range(cfg["n_text_layer"]):
        spec += block(f"decoder.blocks.{i}.", dt, True)
    return spec + norm("decoder.ln", dt)


def _hz_to_mel(f: float) -> float:
    """Slaney: 3 mels per 200 Hz below 1 kHz, log steps of ln(6.4) / 27 above."""
    if f < 1000.0:
        return 3.0 * f / 200.0
    return 15.0 + math.log(f / 1000.0) / (math.log(6.4) / 27.0)


def _mel_to_hz(m: float) -> float:
    if m < 15.0:
        return 200.0 * m / 3.0
    return 1000.0 * math.exp((m - 15.0) * math.log(6.4) / 27.0)


def mel_filters(n_mels: int) -> torch.Tensor:
    """(n_mels, N_FFT // 2 + 1) float32: filter m rises from edge m to edge
    m + 1 and falls to edge m + 2 (edges equally spaced in Slaney mels over
    0 Hz .. Nyquist), scaled by 2 / (edge m + 2 - edge m)."""
    top = _hz_to_mel(SAMPLE_RATE / 2.0)
    edges = [_mel_to_hz(top * k / (n_mels + 1)) for k in range(n_mels + 2)]
    out = np.zeros((n_mels, N_FFT // 2 + 1))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        for b in range(N_FFT // 2 + 1):
            f = b * SAMPLE_RATE / N_FFT
            rise, fall = (f - lo) / (mid - lo), (hi - f) / (hi - mid)
            out[m, b] = max(0.0, min(rise, fall)) * 2.0 / (hi - lo)
    return torch.from_numpy(out.astype(np.float32))


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, N_SAMPLES) float32 -> (B, n_mels, 3000) float32."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2
    mel = mel_filters(n_mels).to(audio.device) @ power
    logs = torch.clamp(mel, min=1e-10).log10()
    floor = logs.flatten(1).max(dim=1).values[:, None, None] - 8.0
    return (torch.maximum(logs, floor) + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    half = channels // 2
    inc = math.log(10000.0) / (half - 1)
    t = torch.arange(length, dtype=torch.float64)[:, None] * torch.exp(
        -inc * torch.arange(half, dtype=torch.float64))[None, :]
    return torch.cat([t.sin(), t.cos()], dim=1).float()


def _attention(prec: Precision, w, name: str, x, xa, heads: int, causal: bool):
    b, t, d = x.shape
    dh = d // heads
    scale = dh ** -0.25
    q = prec.linear(x, w, name + ".query").view(b, t, heads, dh).permute(0, 2, 1, 3) * scale
    k = prec.linear(xa, w, name + ".key", bias=False).view(b, -1, heads, dh).permute(0, 2, 3, 1)
    v = prec.linear(xa, w, name + ".value").view(b, -1, heads, dh).permute(0, 2, 1, 3)
    qk = prec.matmul(q, k * scale)
    if causal:
        qk = qk + torch.full((t, t), float("-inf"), device=x.device).triu(1)
    p = torch.softmax(qk.float(), dim=-1)
    o = prec.matmul(p, v).permute(0, 2, 1, 3).reshape(b, t, d)
    return prec.linear(o, w, name + ".out")


def _mlp(prec: Precision, w, p: str, x):
    h = layer_norm(x, w, p + "mlp_ln", EPS)
    return x + prec.linear(F.gelu(prec.linear(h, w, p + "mlp.0")), w, p + "mlp.2")


def encode(cfg: dict, w: Dict[str, torch.Tensor], mel: torch.Tensor,
           prec: Precision = Precision()) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, n_audio_ctx, d) float32."""
    x = F.gelu(prec.conv1d(mel, w["encoder.conv1.weight"], w["encoder.conv1.bias"], padding=1))
    x = F.gelu(prec.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"], stride=2,
                           padding=1))
    x = x.transpose(1, 2) + sinusoids(cfg["n_audio_ctx"], cfg["n_audio_state"]).to(x.device)
    for i in range(cfg["n_audio_layer"]):
        p = f"encoder.blocks.{i}."
        h = layer_norm(x, w, p + "attn_ln", EPS)
        x = x + _attention(prec, w, p + "attn", h, h, cfg["n_audio_head"], False)
        x = _mlp(prec, w, p, x)
    return layer_norm(x, w, "encoder.ln_post", EPS)


def logits(cfg: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor, xa: torch.Tensor,
           prec: Precision = Precision()) -> torch.Tensor:
    """The teacher-forced forward of (B, T) ids over the encoder's output
    ``xa``: (B, T, n_vocab) float32, row t the logits after token t."""
    t = tokens.shape[1]
    table = w["decoder.token_embedding.weight"].float()
    x = table[tokens] + w["decoder.positional_embedding"].float()[:t]
    for i in range(cfg["n_text_layer"]):
        p = f"decoder.blocks.{i}."
        h = layer_norm(x, w, p + "attn_ln", EPS)
        x = x + _attention(prec, w, p + "attn", h, h, cfg["n_text_head"], True)
        h = layer_norm(x, w, p + "cross_attn_ln", EPS)
        x = x + _attention(prec, w, p + "cross_attn", h, xa, cfg["n_text_head"], False)
        x = _mlp(prec, w, p, x)
    return prec.matmul(layer_norm(x, w, "decoder.ln", EPS), table.T)
