"""Plain SONAR speech encoder: kaldi log-mel fbank, the w2v-BERT 2.0
conformer and SONAR's attention pooler.

The published equations (SONAR, arXiv:2308.11466; w2v-BERT 2.0 as
Wav2Vec2BertModel without adapter), in float32 with TF32 off, over a dict
of weights:

  window -> 80-bin kaldi fbank on the 16-bit-scaled samples (25 ms povey
  windows at 10 ms, DC removal, preemphasis 0.97, power spectrum of a
  512-point FFT, triangular mel banks from 20 Hz to Nyquist, log floored
  at FLT_EPSILON) -> per-bin normalisation over the window's frames
  (mean, variance with ddof 1, eps 1e-7) -> stack frame pairs to 160 dims
  (valid stacked frames: frames // 2)
  -> LN, projection to 1024, padded frames zeroed
  -> 24 conformer layers, each:
       x + 0.5 FFN(LN x)             (swish, 4096)
       x + MHSA(LN x)                (16 heads of 64; scores q.k + q.r_(j-i),
                                      r a learned table over distances
                                      clamped to [-64, 8]; padded keys masked)
       x + Conv(x)                   (LN, padded frames zeroed, pointwise to
                                      2048, GLU, causal depthwise kernel 31,
                                      LN, swish, pointwise)
       x + 0.5 FFN(LN x); LN
  -> pooler: one learned query attends over the valid frames (16 heads),
     output projection to 1024.

A window's embedding depends only on its own samples: every padded frame
is masked or zeroed before it can reach a valid one (the depthwise conv is
causal). This module imports nothing of the program.
"""

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, Spec, layer_norm, served_dtype

EPS = 1e-5
FLT_EPSILON = 1.1920928955078125e-07


def param_spec(cfg: dict) -> Spec:
    bf, f32 = served_dtype(cfg), torch.float32
    d, f, n_mels = cfg["model_dim"], cfg["ffn_dim"], cfg["n_mels"]
    n_pos = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    dh = d // cfg["n_heads"]

    def norm(name, dim):
        return [(name + ".weight", (dim,), "scale", f32), (name + ".bias", (dim,), "shift", f32)]

    def lin(name, o, i, bias=True, dtype=bf):
        return [(name + ".weight", (o, i), "kernel", dtype)] + (
            [(name + ".bias", (o,), "bias", dtype)] if bias else [])

    spec = norm("trunk.fp_layer_norm", 2 * n_mels) + lin("trunk.fp_projection", d, 2 * n_mels)
    for i in range(cfg["n_layers"]):
        p = f"trunk.layers_{i}."
        for ffn in ("ffn1", "ffn2"):
            spec += norm(p + ffn + "_layer_norm", d)
            spec += lin(p + ffn + ".intermediate_dense", f, d) + lin(p + ffn + ".output_dense", d, f)
        spec += norm(p + "self_attn_layer_norm", d)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec += lin(p + "self_attn." + proj, d, d)
        spec += [(p + "self_attn.distance_embedding", (n_pos, dh), "table", f32)]
        spec += norm(p + "conv_module.layer_norm", d)
        spec += lin(p + "conv_module.pointwise_conv1", 2 * d, d, bias=False)
        spec += [(p + "conv_module.depthwise_conv.weight", (d, 1, cfg["conv_kernel"]),
                  "kernel", bf)]
        spec += norm(p + "conv_module.depthwise_layer_norm", d)
        spec += lin(p + "conv_module.pointwise_conv2", d, d, bias=False)
        spec += norm(p + "final_layer_norm", d)
    spec += [("pooler.query", (1, 1, d), "query", f32)]
    for proj in ("q_proj", "k_proj", "v_proj"):
        spec += lin("pooler." + proj, d, d)
    spec += lin("pooler.out_proj", cfg["pool_dim"], d, dtype=f32)
    return spec


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(n_mels: int, n_fft: int, sr: float, low: float = 20.0) -> np.ndarray:
    """Kaldi's triangular banks, (n_mels, n_fft // 2), Nyquist bin left out."""
    n_bins = n_fft // 2
    mel_low, mel_high = _mel_scale(low), _mel_scale(0.5 * sr)
    delta = (mel_high - mel_low) / (n_mels + 1)
    freqs = _mel_scale(sr / n_fft * np.arange(n_bins))
    banks = np.zeros((n_mels, n_bins), np.float64)
    for m in range(n_mels):
        left = mel_low + m * delta
        center, right = left + delta, left + 2 * delta
        banks[m] = np.maximum(0.0, np.minimum((freqs - left) / (center - left),
                                              (right - freqs) / (right - center)))
    return banks


def fbank(samples: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """(n_frames, n_mels) kaldi log-mel fbank of (n,) fp32 samples in
    16-bit scale: frame i starts at 160 i and is 400 samples long."""
    dev = samples.device
    frames = samples[: 400 + (n_frames - 1) * 160].unfold(0, 400, 160).double()
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    n = np.arange(400)
    window = torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * n / 399)) ** 0.85).to(dev)
    frames = (frames - 0.97 * prev) * window
    power = torch.fft.rfft(frames, n=512, dim=1).abs().square()[:, :256]
    banks = torch.from_numpy(mel_banks(n_mels, 512, 16000.0)).to(dev)
    mel = power @ banks.T
    return torch.log(torch.clamp(mel, min=FLT_EPSILON)).float()


def features(cfg: dict, samples: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(n_frames // 2, 2 n_mels) normalised, stacked features of one window."""
    x = fbank(samples * 32768.0, n_frames, cfg["n_mels"])
    mean = x.mean(dim=0, keepdim=True)
    var = ((x - mean) ** 2).sum(dim=0, keepdim=True) / max(n_frames - 1, 1)
    x = (x - mean) / torch.sqrt(var + 1e-7)
    t2 = n_frames - n_frames % 2
    return x[:t2].reshape(t2 // 2, 2 * cfg["n_mels"])


def _swish(x):
    return x * torch.sigmoid(x)


def forward(cfg: dict, w: Dict[str, torch.Tensor], feats: torch.Tensor, lengths: torch.Tensor,
            prec: Precision) -> torch.Tensor:
    """(B, T, 160) stacked features, (B,) valid stacked frames -> (B, 1024)."""
    b, t, _ = feats.shape
    d, nh = cfg["model_dim"], cfg["n_heads"]
    dh = d // nh
    mask = torch.arange(t, device=feats.device)[None, :] < lengths[:, None]
    neg = torch.finfo(torch.float32).min
    key_bias = torch.where(mask, 0.0, neg)[:, None, None, :]
    left, right = cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"]
    pos = torch.arange(t, device=feats.device)
    dist = torch.clamp(pos[None, :] - pos[:, None], -left, right) + left  # (T query, T key)

    x = prec.linear(layer_norm(feats, w, "trunk.fp_layer_norm", EPS), w, "trunk.fp_projection")
    x = torch.where(mask[:, :, None], x, 0.0)
    for i in range(cfg["n_layers"]):
        p = f"trunk.layers_{i}."

        def ffn(y, name):
            y = _swish(prec.linear(y, w, p + name + ".intermediate_dense"))
            return prec.linear(y, w, p + name + ".output_dense")

        x = x + 0.5 * ffn(layer_norm(x, w, p + "ffn1_layer_norm", EPS), "ffn1")
        y = layer_norm(x, w, p + "self_attn_layer_norm", EPS)
        q, k, v = (prec.linear(y, w, p + "self_attn." + n).view(b, t, nh, dh).transpose(1, 2)
                   for n in ("linear_q", "linear_k", "linear_v"))
        table = w[p + "self_attn.distance_embedding"].float()
        # q . r_(j - i): the table's products per query, then each key's distance
        qr = prec.matmul(q, table.T)  # (B, H, T, n_pos)
        rel = torch.gather(qr, 3, dist[None, None].expand(b, nh, t, t))
        scores = (prec.matmul(q, k.transpose(-1, -2)) + rel) / math.sqrt(dh) + key_bias
        att = prec.matmul(torch.softmax(scores, dim=-1), v)
        x = x + prec.linear(att.transpose(1, 2).reshape(b, t, d), w, p + "self_attn.linear_out")

        y = layer_norm(x, w, p + "conv_module.layer_norm", EPS)
        y = torch.where(mask[:, :, None], y, 0.0)
        y = prec.linear(y, w, p + "conv_module.pointwise_conv1", bias=False)
        y = y[..., :d] * torch.sigmoid(y[..., d:])
        y = F.pad(y.transpose(1, 2), (cfg["conv_kernel"] - 1, 0))
        y = prec.conv1d(y, w[p + "conv_module.depthwise_conv.weight"], groups=d).transpose(1, 2)
        y = _swish(layer_norm(y, w, p + "conv_module.depthwise_layer_norm", EPS))
        x = x + prec.linear(y, w, p + "conv_module.pointwise_conv2", bias=False)

        x = x + 0.5 * ffn(layer_norm(x, w, p + "ffn2_layer_norm", EPS), "ffn2")
        x = layer_norm(x, w, p + "final_layer_norm", EPS)

    qv = prec.linear(w["pooler.query"].float().expand(b, 1, d), w, "pooler.q_proj")
    kv = prec.linear(x, w, "pooler.k_proj")
    vv = prec.linear(x, w, "pooler.v_proj")
    qv = qv.view(b, 1, nh, dh).transpose(1, 2)
    kv = kv.view(b, t, nh, dh).transpose(1, 2)
    vv = vv.view(b, t, nh, dh).transpose(1, 2)
    scores = prec.matmul(qv, kv.transpose(-1, -2)) / math.sqrt(dh) + key_bias
    out = prec.matmul(torch.softmax(scores, dim=-1), vv).transpose(1, 2).reshape(b, d)
    return prec.linear(out, w, "pooler.out_proj")


def frames_of(n_samples: int) -> int:
    return 0 if n_samples < 400 else 1 + (n_samples - 400) // 160


def embed_windows(cfg: dict, w: Dict[str, torch.Tensor], audio, windows: Sequence, device,
                  prec: Precision, rows: int = 8) -> torch.Tensor:
    """Embed (start, end) sample windows of one fp32 waveform (numpy),
    ``rows`` windows of similar length at a time (each padded to the
    longest of its group; padding never reaches a valid frame). Returns
    (len(windows), pool_dim) fp32 on the host, in ``windows``' order."""
    cap = cfg["bucket_frames"][-1]
    info = []
    for i, (s, e) in enumerate(windows):
        nf = min(frames_of(max(min(e, len(audio)) - s, 0)), cap)
        info.append((nf, i))
    info.sort()
    out = torch.empty((len(windows), cfg["pool_dim"]), dtype=torch.float32)
    for c0 in range(0, len(info), rows):
        part = info[c0:c0 + rows]
        feats = []
        for nf, i in part:
            s, _ = windows[i]
            seg = torch.from_numpy(audio[s:s + 400 + max(nf - 1, 0) * 160]).to(device)
            feats.append(features(cfg, seg, nf) if nf >= 2 else
                         torch.zeros((0, 2 * cfg["n_mels"]), device=device))
        t = max(f.shape[0] for f in feats)
        batch = torch.zeros((len(part), max(t, 1), 2 * cfg["n_mels"]), device=device)
        lengths = torch.zeros((len(part),), dtype=torch.int64, device=device)
        for r, f in enumerate(feats):
            batch[r, :f.shape[0]] = f
            lengths[r] = f.shape[0]
        with torch.inference_mode():
            emb = forward(cfg, w, batch, lengths, prec)
        out[[i for _, i in part]] = emb.cpu()
    return out
