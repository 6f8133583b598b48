"""NVIDIA's Parakeet-TDT (FastConformer encoder, token-and-duration
transducer), the audit stage's second ASR.

Nothing of the JAX package corresponds. The layer equations are NeMo's
``ConformerEncoder`` (FastConformer, arXiv:2305.05084), ``RNNTDecoder``
and ``RNNTJoint`` with TDT's duration outputs (arXiv:2304.06795), as
``transformers``' ``ParakeetEncoder`` writes the encoder:

- **Stem** (``encoder.pre_encode``, NeMo's ``dw_striding`` subsampling):
  conv 3x3 stride 2 (1 -> C), ReLU, then per further factor of 2 a
  depthwise conv 3x3 stride 2 and a pointwise 1x1 conv, ReLU; every
  conv's output zeroed past its valid frames (``(L - 1) // 2 + 1`` after
  a stride); then (B, C, T', F') -> (B, T', C F') and a Linear to d.
- **Blocks**: the output scaled by sqrt(d) (``xscaling``), positions T' - 1
  .. -(T' - 1) of the Transformer-XL sinusoid table, then the blocks of
  ``models/w2v_bert.py`` (``W2vBertEncoderLayer``): FF/2 -> relative MHSA
  ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_head) with biases on q,
  k, v and out -> FastConformer's conv module (``conv_module="symmetric"``:
  biased pointwise 2d, GLU, padded frames zeroed, symmetric depthwise k
  with a bias, BatchNorm, SiLU, pointwise) -> FF/2 -> LayerNorm. Padded
  keys are masked out of every query's softmax.
- **Prediction network** (``decoder``): an embedding of V + 1 rows (the
  blank, id V, is the last row and embeds to zeros, NeMo's
  ``padding_idx``), then ``pred_layers`` LSTM layers of ``pred_hidden``;
  its top output is g. Decoding starts from one step on the blank from a
  zero state (NeMo's start symbol).
- **Joint**: z = ReLU(enc(f_t) + pred(g)), then ``out`` (``joint_net.2``)
  to V + 1 token logits and ``len(durations)`` duration logits. ``enc``
  runs once per frame after the encoder (:meth:`Parakeet.encode`).

Precision: bf16 products, an fp32 residual stream (the stem's output
cast up; each block's adds in fp32 and its final LayerNorm's output kept
in fp32, ``W2vBertConfig.residual_fp32``), as Whisper's, fp32 LayerNorms
(their outputs cast to bf16 for the products), the BatchNorm in fp32 (``F.batch_norm``
of the bf16 conv output cast up), the LSTM's gates, cell and hidden state
in fp32 (its two products bf16), the joint's sum in fp32 and its output
product in fp32 from an fp32 copy of the bf16 weights, made once
(:meth:`Joint.out_fp32`), so that the logits are fp32.

:func:`step` is one iteration of greedy TDT decoding over a batch of rows,
each at its own frame (:class:`LoopState`), the rule of NeMo's batched
greedy TDT: per live row at frame t < T, k = argmax of the token logits
and d = durations[argmax of the duration logits] (first index on a tie);
a blank with d = 0 advances 1; a token is emitted at t and steps the
LSTM, and if it is the row's ``max_symbols``-th at t with d = 0 the row
advances 1 (forced); then t += d. A row is done at t >= T (or at its
budget of tokens).

:func:`load_nemo` reads a ``.nemo`` archive (a tar of
``model_config.yaml`` and ``model_weights.ckpt``) by NeMo's key names.
"""

import io
import math
import tarfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from svecalign_tpu_torch.models.w2v_bert import (
    W2vBertConfig,
    W2vBertEncoderLayer,
    cached_rel_pe,
    dense,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParakeetConfig:
    """Parakeet-TDT's sizes; the defaults are parakeet-tdt-0.6b-v3's."""

    n_mels: int = 128
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 8
    ff_dim: int = 4096
    conv_kernel: int = 9
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    xscaling: bool = True
    vocab_size: int = 8192  # tokens; the blank is id vocab_size
    pred_hidden: int = 640
    pred_layers: int = 2
    joint_hidden: int = 640
    durations: Tuple[int, ...] = (0, 1, 2, 3, 4)
    max_symbols: int = 10
    dtype: str = "bfloat16"

    @property
    def blank(self) -> int:
        return self.vocab_size

    @property
    def n_outputs(self) -> int:
        return self.vocab_size + 1 + len(self.durations)

    def conformer(self) -> W2vBertConfig:
        return W2vBertConfig(
            hidden_size=self.d_model, num_hidden_layers=self.n_layers,
            num_attention_heads=self.n_heads, intermediate_size=self.ff_dim,
            conv_depthwise_kernel_size=self.conv_kernel, position_embeddings_type="relative",
            dtype=self.dtype, attention_backend="torch", conv_module="symmetric",
            residual_fp32=True)


def subsampled_frames(frames, cfg: ParakeetConfig):
    """Encoder frames of ``frames`` mel frames: ``(L - 1) // 2 + 1`` per
    stride-2 conv (kernel 3, padding 1). Ints or an int tensor."""
    for _ in range(int(math.log2(cfg.subsampling_factor))):
        frames = (frames - 1) // 2 + 1
    return frames


class ConvStem(nn.Module):
    """``pre_encode``: NeMo's ``conv`` Sequential by its indices (ReLUs at
    1, 4, 7, ...), then ``out``."""

    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.subsampling_channels
        layers = [nn.Conv2d(1, c, 3, 2, 1), nn.ReLU()]
        for _ in range(int(math.log2(cfg.subsampling_factor)) - 1):
            layers += [nn.Conv2d(c, c, 3, 2, 1, groups=c), nn.Conv2d(c, c, 1), nn.ReLU()]
        self.conv = nn.Sequential(*layers)
        self.out = nn.Linear(c * (cfg.n_mels // cfg.subsampling_factor), cfg.d_model)

    def forward(self, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) fp32 features, (B,) valid frames -> (B, T', d)."""
        dt = DTYPES[self.cfg.dtype]
        x = mel.to(dt)[:, None]
        for layer in self.conv:
            if isinstance(layer, nn.ReLU):
                x = F.relu(x)
                continue
            x = F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt), layer.stride, layer.padding,
                         groups=layer.groups)
            if layer.stride != (1, 1):
                lengths = (lengths - 1) // 2 + 1
            valid = torch.arange(x.shape[2], device=x.device) < lengths[:, None]
            x = x * valid[:, None, :, None].to(dt)
        b, c, t, f = x.shape
        return dense(self.out, x.transpose(1, 2).reshape(b, t, c * f), dt)


class ParakeetEncoder(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.cfg = cfg
        self.pre_encode = ConvStem(cfg)
        conformer = cfg.conformer()
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", W2vBertEncoderLayer(conformer))
        self._rel_pe = {}  # (T', device) -> the fp32 sinusoid table

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, mel: torch.Tensor, mel_frames: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) fp32, (B,) valid mel frames -> (B, T', d) fp32;
        frames past a row's ``subsampled_frames`` are padding."""
        cfg = self.cfg
        x = self.pre_encode(mel, mel_frames).float()
        if cfg.xscaling:
            x = x * math.sqrt(cfg.d_model)
        lengths = subsampled_frames(mel_frames, cfg)
        pad_mask = torch.arange(x.shape[1], device=x.device) < lengths[:, None]
        attn_bias = torch.where(pad_mask[:, None, None, :], 0.0,
                                torch.finfo(torch.float32).min).float()
        rel_pe = cached_rel_pe(self._rel_pe, x.shape[1], cfg.d_model, x.device)
        for layer in self.layers():
            x = layer(x, attn_bias, pad_mask, None, rel_pe)
        return x


class PredictionNetwork(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size + 1, cfg.pred_hidden)
        self.lstm = nn.LSTM(cfg.pred_hidden, cfg.pred_hidden, cfg.pred_layers)
        self._cat = None

    def fused(self):
        """Per layer the bf16 [W_ih | W_hh] and the fp32 b_ih + b_hh, made
        once (at the first eager step)."""
        if self._cat is None:
            lstm, out = self.lstm, []
            for layer in range(self.cfg.pred_layers):
                w = torch.cat([getattr(lstm, f"weight_ih_l{layer}"),
                               getattr(lstm, f"weight_hh_l{layer}")], dim=1)
                b = (getattr(lstm, f"bias_ih_l{layer}").float()
                     + getattr(lstm, f"bias_hh_l{layer}").float())
                out.append((w.to(DTYPES[self.cfg.dtype]), b))
            self._cat = out
        return self._cat

    def step(self, tokens: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """One LSTM step of every row on ``tokens`` (B,) from (layers, B, H)
        fp32 states: returns the new (h, c), fp32; h[-1] is g."""
        dt = DTYPES[self.cfg.dtype]
        x = self.embed.weight.to(dt)[tokens]
        hs, cs = [], []
        for layer, (w, b) in enumerate(self.fused()):
            gates = F.linear(torch.cat([x, h[layer].to(dt)], dim=1), w).float() + b
            i, f, g, o = gates.chunk(4, dim=1)
            c_new = torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            hs.append(h_new)
            cs.append(c_new)
            x = h_new.to(dt)
        return torch.stack(hs), torch.stack(cs)


class Joint(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.Linear(cfg.d_model, cfg.joint_hidden)
        self.pred = nn.Linear(cfg.pred_hidden, cfg.joint_hidden)
        self.out = nn.Linear(cfg.joint_hidden, cfg.n_outputs)
        self._out32 = None

    def out_fp32(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 copies of ``out``'s weight and bias, made once."""
        if self._out32 is None:
            self._out32 = (self.out.weight.float(), self.out.bias.float())
        return self._out32

    def project_pred(self, g: torch.Tensor) -> torch.Tensor:
        return dense(self.pred, g, DTYPES[self.cfg.dtype]).float()

    def logits(self, f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """fp32 (..., n_outputs) from the projected frame and prediction."""
        w, b = self.out_fp32()
        return F.linear(torch.relu(f + p), w, b)


class Parakeet(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ParakeetEncoder(cfg)
        self.decoder = PredictionNetwork(cfg)
        self.joint = Joint(cfg)

    def encode(self, mel: torch.Tensor, mel_frames: torch.Tensor) -> torch.Tensor:
        """The encoder and the joint's frame projection: (B, T', joint_hidden)
        fp32."""
        x = self.encoder(mel, mel_frames)
        return dense(self.joint.enc, x, DTYPES[self.cfg.dtype]).float()

    def start(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The state after the start symbol: (h, c) of one LSTM step on the
        blank from zeros, (layers, 1, H) each, and its projected g (1,
        joint_hidden), all fp32."""
        cfg = self.cfg
        zeros = torch.zeros((cfg.pred_layers, 1, cfg.pred_hidden), device=device)
        h, c = self.decoder.step(torch.full((1,), cfg.blank, device=device), zeros, zeros)
        return h, c, self.joint.project_pred(h[-1])


@dataclass
class LoopState:
    """The device buffers of a batched greedy TDT decode, updated in place
    by :func:`step`. ``f`` holds the encoder's projected frames; ``ring``
    and ``path`` the logits and ``(t, k, d, live)`` of each row at each of
    the last ``ring`` iterations (a program's)."""

    f: torch.Tensor  # (B, T', J) fp32
    frames: torch.Tensor  # (B,) int64, T of each row
    budget: torch.Tensor  # (B,) int64, tokens a row may emit
    t: torch.Tensor  # (B,) int64, the frame pointer
    sym: torch.Tensor  # (B,) int64, symbols emitted at t
    n_emit: torch.Tensor  # (B,)
    points: torch.Tensor  # (B,) int64, iterations a row was live in
    tokens: torch.Tensor  # (B, E) int64
    token_frames: torch.Tensor  # (B, E) int64
    h: torch.Tensor  # (layers, B, H) fp32
    c: torch.Tensor
    p: torch.Tensor  # (B, J) fp32, the projected g
    ring: torch.Tensor  # (B, K, n_outputs) fp32
    path: torch.Tensor  # (B, K, 4) int64
    counters: torch.Tensor  # (2,) int64: live row-iterations, forced advances
    done: torch.Tensor  # () bool
    rows: torch.Tensor  # (B,) arange
    durations: torch.Tensor  # (n_durations,) int64

    @staticmethod
    def new(model: Parakeet, batch: int, frames: int, ring: int, device) -> "LoopState":
        cfg = model.cfg
        dev = torch.device(device)

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        e = max(1, frames * cfg.max_symbols)
        return LoopState(
            f=z(batch, frames, cfg.joint_hidden, dtype=torch.float32), frames=z(batch),
            budget=z(batch), t=z(batch), sym=z(batch), n_emit=z(batch), points=z(batch),
            tokens=z(batch, e),
            token_frames=z(batch, e), h=z(cfg.pred_layers, batch, cfg.pred_hidden,
                                         dtype=torch.float32),
            c=z(cfg.pred_layers, batch, cfg.pred_hidden, dtype=torch.float32),
            p=z(batch, cfg.joint_hidden, dtype=torch.float32),
            ring=z(batch, ring, cfg.n_outputs, dtype=torch.float32), path=z(batch, ring, 4),
            counters=z(2), done=z(dtype=torch.bool), rows=torch.arange(batch, device=dev),
            durations=torch.tensor(cfg.durations, device=dev))

    def reset(self, start, frames: torch.Tensor, budget: torch.Tensor) -> None:
        """Every row at frame 0 after the start symbol; ``frames`` and
        ``budget`` (B,) int64 on the state's device."""
        h, c, p = start
        self.frames.copy_(frames)
        self.budget.copy_(budget)
        for x in (self.t, self.sym, self.n_emit, self.points, self.counters):
            x.zero_()
        self.h.copy_(h.expand_as(self.h))
        self.c.copy_(c.expand_as(self.c))
        self.p.copy_(p.expand_as(self.p))
        self.done.copy_((self.frames <= 0).all())

    def finish(self) -> None:
        """Every row done (the state a program is first captured in, so
        that its warm-up and first replay change nothing)."""
        self.t.copy_(self.frames)


def live_rows(st: LoopState) -> torch.Tensor:
    return (st.t < st.frames) & (st.n_emit < st.budget)


def step(model: Parakeet, st: LoopState, j: int) -> None:
    """One greedy TDT iteration of every row, in place; the iteration's
    logits and ``(t, k, d, live)`` go to slot ``j`` of the ring."""
    cfg = model.cfg
    live = live_rows(st)
    tt = st.t.clamp(max=st.f.shape[1] - 1)
    logits = model.joint.logits(st.f[st.rows, tt], st.p)
    st.ring[:, j] = logits
    k = logits[:, :cfg.blank + 1].argmax(dim=1)
    d = st.durations[logits[:, cfg.blank + 1:].argmax(dim=1)]
    blank = k == cfg.blank
    emit = live & ~blank
    d = torch.where(blank & (d == 0), 1, d)
    # the token goes to the row's next slot; a row that emits nothing writes
    # there too, and the slot is overwritten at its next emission
    slot = st.n_emit.clamp(max=st.tokens.shape[1] - 1)
    st.tokens[st.rows, slot] = k
    st.token_frames[st.rows, slot] = st.t
    st.n_emit.add_(emit)
    h, c = model.decoder.step(k, st.h, st.c)
    gate = emit[None, :, None]
    st.h.copy_(torch.where(gate, h, st.h))
    st.c.copy_(torch.where(gate, c, st.c))
    st.p.copy_(torch.where(emit[:, None], model.joint.project_pred(h[-1]), st.p))
    st.sym.add_(emit)
    forced = emit & (st.sym >= cfg.max_symbols) & (d == 0)
    d = torch.where(forced, 1, d)
    st.path[:, j] = torch.stack([st.t, k, d, live.long()], dim=1)
    st.t.add_(torch.where(live, d, 0))
    st.sym.masked_fill_(live & (d > 0), 0)
    st.points.add_(live)
    st.counters.add_(torch.stack([live.sum(), forced.sum()]))


def run_iterations(model: Parakeet, st: LoopState, iterations: int) -> torch.Tensor:
    """``iterations`` steps, slot j of the ring the j-th; returns the done
    flag (every row done), written into ``st.done``."""
    for j in range(iterations):
        step(model, st, j)
    st.done.copy_(~live_rows(st).any())
    return st.done


def build(cfg: ParakeetConfig, device) -> Parakeet:
    """A :class:`Parakeet` on ``device`` with its weights unset (fill them
    by :func:`load_weights`): products' weights, biases and the embedding in
    the compute dtype, LayerNorms and BatchNorms in fp32."""
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}")
    with torch.device("meta"):
        model = Parakeet(cfg)
    model = model.to_empty(device=device)
    dt = DTYPES[cfg.dtype]
    for name, p in model.named_parameters():
        if "layer_norm" not in name and ".batch_norm." not in name:
            p.data = p.data.to(dt)
    return model.eval().requires_grad_(False)


def weight_names(model: Parakeet):
    """The names :func:`load_weights` needs: every parameter and every
    BatchNorm's running statistics."""
    return [n for n, _ in model.named_parameters()] + [
        n for n, _ in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


def load_weights(model: Parakeet, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` (the port's names, :func:`weight_names`) into
    ``model``, each tensor cast to its target's dtype. Every name must be
    given and no other (a BatchNorm's ``num_batches_tracked`` may be)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    need = set(weight_names(model))
    extra = {n for n in state if n not in need and not n.endswith("num_batches_tracked")}
    missing = need - set(state)
    if extra or missing:
        raise ValueError(f"the weights differ from the model's: missing {sorted(missing)[:4]}, "
                         f"unknown {sorted(extra)[:4]}")
    with torch.no_grad():
        for name in need:
            w, p = state[name], targets[name]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{name}: model {tuple(p.shape)}, weights {tuple(w.shape)}")
            p.copy_(w)
    model.decoder._cat = None
    model.joint._out32 = None
    model.decoder.fused()
    model.joint.out_fp32()


# NeMo's key prefixes -> the port's (the rest of each key is the same)
_NEMO_LAYER = {
    "norm_feed_forward1": "ffn1_layer_norm", "feed_forward1.linear1": "ffn1.intermediate_dense",
    "feed_forward1.linear2": "ffn1.output_dense", "norm_self_att": "self_attn_layer_norm",
    "self_attn.linear_q": "self_attn.linear_q", "self_attn.linear_k": "self_attn.linear_k",
    "self_attn.linear_v": "self_attn.linear_v", "self_attn.linear_out": "self_attn.linear_out",
    "self_attn.linear_pos": "self_attn.linear_pos", "self_attn.pos_bias_u":
    "self_attn.pos_bias_u", "self_attn.pos_bias_v": "self_attn.pos_bias_v",
    "norm_conv": "conv_module.layer_norm", "conv.pointwise_conv1": "conv_module.pointwise_conv1",
    "conv.depthwise_conv": "conv_module.depthwise_conv", "conv.batch_norm":
    "conv_module.batch_norm", "conv.pointwise_conv2": "conv_module.pointwise_conv2",
    "norm_feed_forward2": "ffn2_layer_norm", "feed_forward2.linear1": "ffn2.intermediate_dense",
    "feed_forward2.linear2": "ffn2.output_dense", "norm_out": "final_layer_norm",
}
_NEMO_TOP = {"decoder.prediction.embed": "decoder.embed",
             "decoder.prediction.dec_rnn.lstm": "decoder.lstm",
             "joint.enc": "joint.enc", "joint.pred": "joint.pred",
             "joint.joint_net.2": "joint.out", "encoder.pre_encode": "encoder.pre_encode"}
# kept out of the model: the preprocessor's window and filters, the encoder's
# positional table (both computed here), BatchNorm step counts
_NEMO_SKIP = ("preprocessor.", "encoder.pos_enc.", "num_batches_tracked")


def from_nemo_name(key: str) -> Optional[str]:
    """The port's name of a NeMo state_dict key; None for a key the port
    computes itself; KeyError for a key it does not know."""
    if key.startswith(_NEMO_SKIP[:2]) or key.endswith(_NEMO_SKIP[2]):
        return None
    if key.startswith("encoder.layers."):
        _, _, idx, rest = key.split(".", 3)
        for nemo, port in _NEMO_LAYER.items():
            if rest == nemo or rest.startswith(nemo + "."):
                return f"encoder.layers_{idx}.{port}{rest[len(nemo):]}"
    for nemo, port in _NEMO_TOP.items():
        if key.startswith(nemo + "."):
            return port + key[len(nemo):]
    raise KeyError(f"unknown NeMo key {key!r}")


def config_from_nemo(conf: dict, dtype: str = "bfloat16") -> ParakeetConfig:
    """A :class:`ParakeetConfig` from a ``model_config.yaml`` (NeMo's
    ``EncDecRNNTBPEModel`` with TDT's loss)."""
    enc, dec, joint = conf["encoder"], conf["decoder"], conf["joint"]
    if enc.get("subsampling", "dw_striding") != "dw_striding":
        raise ValueError(f"only dw_striding subsampling is ported, got {enc['subsampling']!r}")
    if enc.get("self_attention_model", "rel_pos") != "rel_pos":
        raise ValueError("only rel_pos self-attention is ported")
    durations = tuple(conf.get("model_defaults", {}).get("tdt_durations")
                      or joint.get("durations") or ())
    greedy = conf.get("decoding", {}).get("greedy", {}) or {}
    return ParakeetConfig(
        n_mels=int(enc["feat_in"]), d_model=int(enc["d_model"]), n_layers=int(enc["n_layers"]),
        n_heads=int(enc["n_heads"]), ff_dim=int(enc["d_model"] * enc["ff_expansion_factor"]),
        conv_kernel=int(enc["conv_kernel_size"]),
        subsampling_factor=int(enc["subsampling_factor"]),
        subsampling_channels=int(enc["subsampling_conv_channels"]),
        xscaling=bool(enc.get("xscaling", True)), vocab_size=int(dec["vocab_size"]),
        pred_hidden=int(dec["prednet"]["pred_hidden"]),
        pred_layers=int(dec["prednet"]["pred_rnn_layers"]),
        joint_hidden=int(joint["jointnet"]["joint_hidden"]), durations=durations,
        max_symbols=int(greedy.get("max_symbols") or 10), dtype=dtype)


def _member(tar: tarfile.TarFile, name: str) -> bytes:
    for m in tar.getmembers():
        if m.isfile() and Path(m.name).name == name:
            return tar.extractfile(m).read()
    raise FileNotFoundError(f"no {name} in the archive")


def load_nemo(path: Union[str, Path], device, dtype: str = "bfloat16") -> Parakeet:
    """A ``.nemo`` archive as a model on ``device``: its config from
    ``model_config.yaml``, its weights from ``model_weights.ckpt`` by NeMo's
    key names (NeMo's pointwise Conv1d weights (o, i, 1) squeezed into the
    port's Linear ones). Raises, naming the path, where there is no such
    file: nothing is downloaded."""
    import yaml

    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no Parakeet archive at {path}: NVIDIA's .nemo file is "
                                f"needed there (nothing is downloaded)")
    with tarfile.open(path, "r:*") as tar:
        conf = yaml.safe_load(_member(tar, "model_config.yaml"))
        raw = torch.load(io.BytesIO(_member(tar, "model_weights.ckpt")), map_location="cpu",
                         weights_only=True)
    model = build(config_from_nemo(conf, dtype), device)
    shapes = {n: t.shape for n, t in list(model.named_parameters()) + list(model.named_buffers())}
    state = {}
    for key, w in raw.items():
        name = from_nemo_name(key)
        if name is None:
            continue
        if name in shapes and w.dim() == 3 and len(shapes[name]) == 2 and w.shape[-1] == 1:
            w = w[..., 0]
        state[name] = w
    load_weights(model, state)
    return model
