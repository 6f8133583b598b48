"""Plain SpeechLASER encoder: wav2vec 2.0 large with LASER max pooling.

The published layer equations (wav2vec 2.0, arXiv:2006.11477, the "large"
layout with per-layer extractor LayerNorms and pre-norm Transformer
layers; SpeechLASER, Duquenne et al. 2021, max-pools the last hidden
states), in float32 with TF32 off, over a dict of weights:

  waveform (zero-padded to its length bucket)
  -> 7 convs (512 channels; kernels 10,3,3,3,3,2,2; strides 5,2,2,2,2,2,2),
     each followed by a LayerNorm over channels and GELU
  -> LayerNorm, projection 512 -> 1024
  -> + GELU(grouped positional conv: kernel 128, 16 groups, same padding,
     the even kernel's last frame dropped)
  -> 24 x [x + MHA(LN(x)) with padded keys masked; x + FFN(LN(x)), GELU]
  -> LayerNorm -> max over the valid frames.

A frame is valid when its whole receptive field lies inside the
waveform's length (at least one frame a row). The positional conv reads
padded frames into valid ones, so a window's embedding depends on the
width it is padded to; the length buckets are the configuration's.

This module imports nothing of the program.
"""

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, Spec, layer_norm, served_dtype

EPS = 1e-6


def param_spec(cfg: dict) -> Spec:
    bf, f32 = served_dtype(cfg), torch.float32
    spec = []
    c_in = 1
    for i, (dim, k, _) in enumerate(cfg["conv_layers"]):
        spec += [(f"feature_extractor.conv_{i}.weight", (dim, c_in, k), "kernel", bf),
                 (f"feature_extractor.conv_{i}.bias", (dim,), "bias", bf),
                 (f"feature_extractor.layer_norm_{i}.weight", (dim,), "scale", f32),
                 (f"feature_extractor.layer_norm_{i}.bias", (dim,), "shift", f32)]
        c_in = dim
    d, f = cfg["encoder_dim"], cfg["encoder_ffn_dim"]
    g, kp = cfg["conv_pos_groups"], cfg["conv_pos_kernel"]
    spec += [("post_extract_norm.weight", (c_in,), "scale", f32),
             ("post_extract_norm.bias", (c_in,), "shift", f32),
             ("post_extract_proj.weight", (d, c_in), "kernel", bf),
             ("post_extract_proj.bias", (d,), "bias", bf),
             ("pos_conv.weight", (d, d // g, kp), "kernel", bf),
             ("pos_conv.bias", (d,), "bias", bf)]
    for i in range(cfg["encoder_layers"]):
        p = f"layer_{i}."
        for norm in ("attn_norm", "ffn_norm"):
            spec += [(p + norm + ".weight", (d,), "scale", f32),
                     (p + norm + ".bias", (d,), "shift", f32)]
        for proj in ("query", "key", "value", "out"):
            spec += [(p + f"attn.{proj}.weight", (d, d), "kernel", bf),
                     (p + f"attn.{proj}.bias", (d,), "bias", bf)]
        spec += [(p + "ffn_in.weight", (f, d), "kernel", bf), (p + "ffn_in.bias", (f,), "bias", bf),
                 (p + "ffn_out.weight", (d, f), "kernel", bf),
                 (p + "ffn_out.bias", (d,), "bias", bf)]
    spec += [("encoder_norm.weight", (d,), "scale", f32),
             ("encoder_norm.bias", (d,), "shift", f32)]
    return spec


def receptive_field(cfg: dict):
    size, hop = 1, 1
    for _, k, s in reversed(cfg["conv_layers"]):
        size = (size - 1) * s + k
    for _, _, s in cfg["conv_layers"]:
        hop *= s
    return size, hop


def bucket_of(cfg: dict, n_samples: int) -> int:
    for b in cfg["buckets_samples"]:
        if n_samples <= b:
            return b
    return cfg["buckets_samples"][-1]


def forward(cfg: dict, w: Dict[str, torch.Tensor], wav: torch.Tensor, lengths: torch.Tensor,
            prec: Precision) -> torch.Tensor:
    """(B, width) fp32 waveforms, zero past ``lengths`` -> (B, d) fp32."""
    x = wav.float()[:, None, :]
    for i, (_, _, stride) in enumerate(cfg["conv_layers"]):
        x = prec.conv1d(x, w[f"feature_extractor.conv_{i}.weight"],
                        w[f"feature_extractor.conv_{i}.bias"], stride=stride)
        x = F.gelu(layer_norm(x, w, f"feature_extractor.layer_norm_{i}", EPS, dim=1))
    x = x.transpose(1, 2)  # (B, T, C)
    t = x.shape[1]
    size, hop = receptive_field(cfg)
    frame_len = torch.clamp((lengths.long() - size) // hop + 1, min=1)
    mask = torch.arange(t, device=x.device)[None, :] < frame_len[:, None]

    x = prec.linear(layer_norm(x, w, "post_extract_norm", EPS), w, "post_extract_proj")
    kp = cfg["conv_pos_kernel"]
    pos = prec.conv1d(x.transpose(1, 2), w["pos_conv.weight"], w["pos_conv.bias"],
                      padding=kp // 2, groups=cfg["conv_pos_groups"])
    x = x + F.gelu(pos[:, :, :t].transpose(1, 2))

    b = x.shape[0]
    d, h = cfg["encoder_dim"], cfg["encoder_heads"]
    dh = d // h
    neg = torch.finfo(torch.float32).min
    key_bias = torch.where(mask, 0.0, neg)[:, None, None, :]
    for i in range(cfg["encoder_layers"]):
        p = f"layer_{i}."
        y = layer_norm(x, w, p + "attn_norm", EPS)
        q, k, v = (prec.linear(y, w, p + f"attn.{n}").view(b, t, h, dh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + key_bias
        att = prec.matmul(torch.softmax(scores, dim=-1), v)
        x = x + prec.linear(att.transpose(1, 2).reshape(b, t, d), w, p + "attn.out")
        y = F.gelu(prec.linear(layer_norm(x, w, p + "ffn_norm", EPS), w, p + "ffn_in"))
        x = x + prec.linear(y, w, p + "ffn_out")
    x = layer_norm(x, w, "encoder_norm", EPS)
    return torch.where(mask[:, :, None], x, neg).amax(dim=1)


def embed_windows(cfg: dict, w: Dict[str, torch.Tensor], audio, windows: Sequence, device,
                  prec: Precision, rows: int = 8) -> torch.Tensor:
    """Embed (start, end) sample windows of one fp32 waveform (numpy), each
    zero-padded to its length bucket, ``rows`` windows of one bucket at a
    time. Returns (len(windows), d) fp32 on the host, in ``windows``' order."""
    out = torch.empty((len(windows), cfg["encoder_dim"]), dtype=torch.float32)
    by_bucket: Dict[int, List[int]] = {}
    for i, (s, e) in enumerate(windows):
        ln = max(min(e, len(audio)) - s, 0)
        by_bucket.setdefault(bucket_of(cfg, ln), []).append(i)
    for bucket, ids in sorted(by_bucket.items()):
        for c0 in range(0, len(ids), rows):
            part = ids[c0:c0 + rows]
            wav = torch.zeros((len(part), bucket), dtype=torch.float32)
            lengths = torch.zeros((len(part),), dtype=torch.int64)
            for r, i in enumerate(part):
                s, e = windows[i]
                seg = torch.from_numpy(audio[s:min(e, len(audio))][:bucket])
                wav[r, :len(seg)] = seg
                lengths[r] = len(seg)
            with torch.inference_mode():
                emb = forward(cfg, w, wav.to(device), lengths.to(device), prec)
            out[part] = emb.cpu()
    return out
