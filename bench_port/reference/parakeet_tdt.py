"""Plain Parakeet-TDT: NeMo's log-mel, the FastConformer encoder, the LSTM
prediction network, the joint, and greedy token-and-duration decoding,
one clip at a time.

The published equations (FastConformer, arXiv:2305.05084; TDT,
arXiv:2304.06795; NeMo's ``AudioToMelSpectrogramPreprocessor``,
``ConformerEncoder``, ``RNNTDecoder``, ``RNNTJoint`` and greedy TDT
decoding), in float32 with TF32 off, over a dict of weights keyed by the
program's parameter names:

  16 kHz samples -> pre-emphasis 0.97 -> frames of 512 samples every 160
  (the signal zero-padded by 256 each side), a 400-point symmetric Hann
  window centred in them, the power of each of the 257 bins -> Slaney mel
  filters (unit-area triangles from 0 Hz to Nyquist, n_fft 512)
  -> ln(x + 2^-24) -> each mel normalised over the clip's length // 160
  frames (mean; standard deviation with n - 1, plus 1e-5)
  -> stem: conv 3x3 s2 (1 -> C), ReLU, then [depthwise 3x3 s2, pointwise
     1x1, ReLU] per further factor 2, the (C, mel) plane flattened
     channel-major, Linear to d; times sqrt(d)
  -> blocks: x + FF(LN x) / 2 (swish); x + MHSA(LN x), where a head's score
     of query i and key j is ((q_i + u) . k_j + (q_i + v) . P(i - j)) /
     sqrt(d_head) and P(r) is ``linear_pos`` of the sinusoid
     [sin(r w_0), cos(r w_0), ...] with w_m = 10000^(-2m / d); x + Conv(x)
     (LN, pointwise to 2d, GLU, depthwise k symmetric with a bias, BatchNorm
     by its running statistics, swish, pointwise); x + FF(LN x) / 2; LN
  -> prediction network: an embedding (the blank, id V, embeds to zeros),
     LSTM layers (gates i, f, g, o); the start is one step on the blank
     from a zero state
  -> joint: ReLU(enc(f_t) + pred(g)), Linear to V + 1 token and
     len(durations) duration logits.

Greedy TDT (:func:`greedy`), per clip: at frame t < T, k = argmax of the
token logits, d = durations[argmax of the duration logits] (the first
index on a tie); a blank with d = 0 advances by 1; a token is emitted at
t and steps the prediction network, and its ``max_symbols``-th at t with
d = 0 advances by 1; then t += d.

Departures from NeMo, each deliberate:

- One clip at a time and unpadded, so nothing is masked: the stem's convs
  see zeros past the clip as NeMo's masked batch does, and the encoder
  attends the clip's own frames only.
- LayerNorms compute the variance in two passes (NeMo's ``nn.LayerNorm``);
  the program uses the port's one-pass fp32 statistics.
- The sinusoid table is computed in float64 and rounded once; NeMo builds
  it in float32.
- No dither, no padding of the features to a multiple of 16 (both NeMo
  training-time or batching options), no language model, no text: the
  tokenizer's vocabulary is not in the repository.

This module imports nothing of the program.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, Spec, layer_norm, served_dtype
from bench_port.reference.whisper import _hz_to_mel, _mel_to_hz

SAMPLE_RATE = 16000
N_FFT, WIN, HOP = 512, 400, 160
PREEMPH = 0.97
LOG_GUARD = 2.0 ** -24
STD_EPS = 1e-5
EPS = 1e-5


def param_spec(cfg: dict) -> Spec:
    """The weights by the program's names: products, their biases, the
    relative biases and the embedding in the served dtype, LayerNorms and
    BatchNorms (scale, shift, running mean and variance) in float32."""
    bf, f32 = served_dtype(cfg), torch.float32
    d, c, ff, k = cfg["d_model"], cfg["subsampling_channels"], cfg["ff_dim"], cfg["conv_kernel"]
    h, dh = cfg["n_heads"], cfg["d_model"] // cfg["n_heads"]
    ph, jh = cfg["pred_hidden"], cfg["joint_hidden"]

    def norm(name, dim):
        return [(name + ".weight", (dim,), "scale", f32), (name + ".bias", (dim,), "shift", f32)]

    def lin(name, o, *i, bias=True):
        return [(name + ".weight", (o, *i), "kernel", bf)] + (
            [(name + ".bias", (o,), "bias", bf)] if bias else [])

    spec = lin("encoder.pre_encode.conv.0", c, 1, 3, 3)
    idx = 2
    for _ in range(int(math.log2(cfg["subsampling_factor"])) - 1):
        spec += lin(f"encoder.pre_encode.conv.{idx}", c, 1, 3, 3)
        spec += lin(f"encoder.pre_encode.conv.{idx + 1}", c, c, 1, 1)
        idx += 3
    spec += lin("encoder.pre_encode.out", d, c * (cfg["n_mels"] // cfg["subsampling_factor"]))
    for i in range(cfg["n_layers"]):
        p = f"encoder.layers_{i}."
        for ffn in ("ffn1", "ffn2"):
            spec += norm(p + ffn + "_layer_norm", d)
            spec += lin(p + ffn + ".intermediate_dense", ff, d) + lin(p + ffn + ".output_dense",
                                                                      d, ff)
        spec += norm(p + "self_attn_layer_norm", d)
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec += lin(p + "self_attn." + name, d, d)
        spec += lin(p + "self_attn.linear_pos", d, d, bias=False)
        spec += [(p + "self_attn.pos_bias_u", (h, dh), "bias", bf),
                 (p + "self_attn.pos_bias_v", (h, dh), "bias", bf)]
        m = p + "conv_module."
        spec += norm(m + "layer_norm", d) + lin(m + "pointwise_conv1", 2 * d, d)
        spec += lin(m + "depthwise_conv", d, 1, k)
        spec += norm(m + "batch_norm", d)
        spec += [(m + "batch_norm.running_mean", (d,), "shift", f32),
                 (m + "batch_norm.running_var", (d,), "scale", f32)]
        spec += lin(m + "pointwise_conv2", d, d)
        spec += norm(p + "final_layer_norm", d)
    spec += [("decoder.embed.weight", (cfg["vocab_size"] + 1, ph), "query", bf)]
    for layer in range(cfg["pred_layers"]):
        spec += [(f"decoder.lstm.weight_ih_l{layer}", (4 * ph, ph), "kernel", bf),
                 (f"decoder.lstm.weight_hh_l{layer}", (4 * ph, ph), "kernel", bf),
                 (f"decoder.lstm.bias_ih_l{layer}", (4 * ph,), "bias", bf),
                 (f"decoder.lstm.bias_hh_l{layer}", (4 * ph,), "bias", bf)]
    n_out = cfg["vocab_size"] + 1 + len(cfg["durations"])
    return (spec + lin("joint.enc", jh, d) + lin("joint.pred", jh, ph)
            + lin("joint.out", n_out, jh))


def mel_filters(n_mels: int) -> torch.Tensor:
    """(n_mels, N_FFT // 2 + 1) float32 Slaney triangles over 0 Hz ..
    Nyquist, filter m from edge m to edge m + 2 scaled by 2 / its width."""
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
    """(n,) float32 samples -> (n // 160, n_mels) normalised features (the
    clip's valid frames)."""
    x = audio.float()
    x = torch.cat([x[:1], x[1:] - PREEMPH * x[:-1]])
    n_frames = 1 + len(x) // HOP
    x = F.pad(x, (N_FFT // 2, N_FFT // 2))
    frames = torch.stack([x[i * HOP:i * HOP + N_FFT] for i in range(n_frames)])
    k = torch.arange(WIN, dtype=torch.float64)
    hann = (0.5 - 0.5 * torch.cos(2 * math.pi * k / (WIN - 1))).float().to(x.device)
    pad = (N_FFT - WIN) // 2
    window = F.pad(hann, (pad, N_FFT - WIN - pad))
    power = torch.fft.rfft(frames * window).abs() ** 2
    mel = torch.log(power @ mel_filters(n_mels).to(x.device).T + LOG_GUARD)
    valid = mel[:len(audio) // HOP]
    mean = valid.mean(dim=0)
    std = valid.std(dim=0, unbiased=True)
    return (valid - mean) / (std + STD_EPS)


def rel_positions(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d): the sinusoid of relative positions t - 1, ..., -(t - 1)."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float64)[:, None]
    w = torch.pow(10000.0, -torch.arange(0, d, 2, dtype=torch.float64) / d)[None, :]
    pe = torch.zeros((2 * t - 1, d), dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * w)
    pe[:, 1::2] = torch.cos(pos * w)
    return pe.float().to(device)


def _attention(cfg, w, p: str, x, prec: Precision):
    t, d = x.shape
    h = cfg["n_heads"]
    dh = d // h
    q = prec.linear(x, w, p + "linear_q").view(t, h, dh).transpose(0, 1)
    k = prec.linear(x, w, p + "linear_k").view(t, h, dh).transpose(0, 1)
    v = prec.linear(x, w, p + "linear_v").view(t, h, dh).transpose(0, 1)
    pos = prec.linear(rel_positions(t, d, x.device), w, p + "linear_pos", bias=False)
    pos = pos.view(2 * t - 1, h, dh).transpose(0, 1)  # (h, 2t - 1, dh), row r: i - j = t - 1 - r
    u = w[p + "pos_bias_u"].float()[:, None, :]
    vb = w[p + "pos_bias_v"].float()[:, None, :]
    content = prec.matmul(q + u, k.transpose(1, 2))
    position = prec.matmul(q + vb, pos.transpose(1, 2))  # (h, t, 2t - 1)
    i = torch.arange(t, device=x.device)
    row = (t - 1 - i[:, None] + i[None, :]).expand(h, t, t)  # table row of (i, j)
    scores = (content + position.gather(2, row)) / math.sqrt(dh)
    out = prec.matmul(torch.softmax(scores, dim=-1), v).transpose(0, 1).reshape(t, d)
    return prec.linear(out, w, p + "linear_out")


def _conv_module(cfg, w, p: str, x, prec: Precision):
    d, k = cfg["d_model"], cfg["conv_kernel"]
    y = prec.linear(layer_norm(x, w, p + "layer_norm", EPS), w, p + "pointwise_conv1")
    y = (y[:, :d] * torch.sigmoid(y[:, d:])).T[None]  # (1, d, t)
    y = prec.conv1d(y, w[p + "depthwise_conv.weight"], w[p + "depthwise_conv.bias"],
                    padding=(k - 1) // 2, groups=d)[0].T
    bn = p + "batch_norm."
    y = ((y - w[bn + "running_mean"].float()) / torch.sqrt(w[bn + "running_var"].float() + EPS)
         * w[bn + "weight"].float() + w[bn + "bias"].float())
    return prec.linear(F.silu(y), w, p + "pointwise_conv2")


def _ffn(w, p: str, x, prec: Precision):
    y = F.silu(prec.linear(layer_norm(x, w, p + "_layer_norm", EPS), w, p + ".intermediate_dense"))
    return prec.linear(y, w, p + ".output_dense")


def encode(cfg: dict, w: Dict[str, torch.Tensor], mel: torch.Tensor,
           prec: Precision = Precision()) -> torch.Tensor:
    """(L, n_mels) features -> (T', d) float32 encoder output."""
    x = mel.float()[None, None]
    idx = 0
    x = F.relu(F.conv2d(prec.q(x), prec.q(w["encoder.pre_encode.conv.0.weight"]),
                        w["encoder.pre_encode.conv.0.bias"].float(), stride=2, padding=1))
    idx = 2
    c = cfg["subsampling_channels"]
    for _ in range(int(math.log2(cfg["subsampling_factor"])) - 1):
        dw, pw = f"encoder.pre_encode.conv.{idx}.", f"encoder.pre_encode.conv.{idx + 1}."
        x = F.conv2d(prec.q(x), prec.q(w[dw + "weight"]), w[dw + "bias"].float(), stride=2,
                     padding=1, groups=c)
        x = F.relu(F.conv2d(prec.q(x), prec.q(w[pw + "weight"]), w[pw + "bias"].float()))
        idx += 3
    _, _, t, f = x.shape
    x = prec.linear(x[0].permute(1, 0, 2).reshape(t, c * f), w, "encoder.pre_encode.out")
    x = x * math.sqrt(cfg["d_model"])
    for i in range(cfg["n_layers"]):
        p = f"encoder.layers_{i}."
        x = x + 0.5 * _ffn(w, p + "ffn1", x, prec)
        x = x + _attention(cfg, w, p + "self_attn.", layer_norm(x, w, p + "self_attn_layer_norm",
                                                                EPS), prec)
        x = x + _conv_module(cfg, w, p + "conv_module.", x, prec)
        x = x + 0.5 * _ffn(w, p + "ffn2", x, prec)
        x = layer_norm(x, w, p + "final_layer_norm", EPS)
    return x


def pred_step(cfg: dict, w, token: int, state, prec: Precision):
    """One prediction-network step on ``token`` from ``state`` (a list of
    (h, c) per layer, or None for zeros): returns (g, new state)."""
    ph = cfg["pred_hidden"]
    table = w["decoder.embed.weight"]
    x = (torch.zeros(ph, device=table.device) if token == cfg["vocab_size"]
         else table[token].float())
    new = []
    for layer in range(cfg["pred_layers"]):
        h, c = state[layer] if state else (torch.zeros(ph, device=x.device),) * 2
        s = f"decoder.lstm.{{}}_l{layer}"
        gates = (F.linear(prec.q(x), prec.q(w[s.format("weight_ih")]))
                 + F.linear(prec.q(h), prec.q(w[s.format("weight_hh")]))
                 + w[s.format("bias_ih")].float() + w[s.format("bias_hh")].float())
        i, f, g, o = gates.chunk(4)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        new.append((h, c))
        x = h
    return x, new


def joint(w, f_proj: torch.Tensor, g: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Logits (V + 1 + durations) of a projected frame and a prediction."""
    z = torch.relu(f_proj + prec.linear(g, w, "joint.pred"))
    return prec.linear(z, w, "joint.out")


def frames_projected(cfg: dict, w, audio: torch.Tensor, prec: Precision) -> torch.Tensor:
    """enc(f_t) of every frame of one clip, (T', joint_hidden)."""
    return prec.linear(encode(cfg, w, log_mel(audio, cfg["n_mels"]), prec), w, "joint.enc")


def greedy(cfg: dict, w, audio: torch.Tensor, prec: Precision = Precision()
           ) -> Tuple[List[Tuple[int, int, int]], int]:
    """Free-running greedy TDT of one clip: its path, ``(t, k, d)`` at every
    point visited, and T."""
    f = frames_projected(cfg, w, audio, prec)
    blank, v1 = cfg["vocab_size"], cfg["vocab_size"] + 1
    g, state = pred_step(cfg, w, blank, None, prec)
    t, sym, path = 0, 0, []
    while t < f.shape[0]:
        lg = joint(w, f[t], g, prec)
        k = int(lg[:v1].argmax())
        d = cfg["durations"][int(lg[v1:].argmax())]
        if k == blank:
            d = max(d, 1)
        else:
            g, state = pred_step(cfg, w, k, state, prec)
            sym += 1
            if sym >= cfg["max_symbols"] and d == 0:
                d = 1
        path.append((t, k, d))
        if d > 0:
            sym = 0
        t += d
    return path, f.shape[0]


def teacher_forced(cfg: dict, w, audio: torch.Tensor, path: Sequence[Tuple[int, int, int]],
                   prec: Precision = Precision()) -> torch.Tensor:
    """The joint's logits at every point of ``path`` (the program's), the
    prediction network stepped on each token the path emits:
    (len(path), V + 1 + durations) float32."""
    f = frames_projected(cfg, w, audio, prec)
    blank = cfg["vocab_size"]
    g, state = pred_step(cfg, w, blank, None, prec)
    out = []
    for t, k, _ in path:
        out.append(joint(w, f[min(int(t), f.shape[0] - 1)], g, prec))
        if int(k) != blank:
            g, state = pred_step(cfg, w, int(k), state, prec)
    n_out = cfg["vocab_size"] + 1 + len(cfg["durations"])
    return torch.stack(out) if out else torch.zeros((0, n_out), device=f.device)
