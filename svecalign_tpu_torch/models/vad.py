"""Voice activity detection in PyTorch.

Port of the JAX package's ``models/vad.py``. Two interchangeable
probability models feed one copy of the silero ``get_speech_timestamps``
hysteresis post-processing (the output contract of reference
svecalign/preprocess/segment.py:84-128: "start end" frame lines at 16 kHz;
the reference pins silero-vad v4.0, preprocess/segment.py:49-52):

- :class:`SileroV4VAD`: the silero v4 network graph (torch-stft
  conv-basis STFT frontend -> SileroVadBlock conv stack -> LSTM decoder ->
  conv + sigmoid head), an ``nn.Module`` on the device it is given, with
  weights from an .npz produced by ``tools/convert_torch_ckpt.py silero``
  on the published ``silero_vad.jit`` or a weights dict in that layout
  (geometry read from the tensor shapes), or seeded random weights drawn
  as the JAX package draws them.
- :class:`EnergyVAD`: the weight-free adaptive log-energy model, a numpy
  copy, bit-equal to JAX's.

The JAX graph runs the file's chunks as a ``lax.scan`` whose step runs an
inner scan of the LSTM over the chunk's frames, carrying the LSTM state
from chunk to chunk. The two scans are one recurrence over all frames of
the file in order, and stacking the layers per step equals running them
layer after layer. So the port computes the features of all chunks at
once (the chunk is the batch axis), runs one ``nn.LSTM`` (cuDNN on the
card; gate order i, f, g, o as in JAX) over the file's concatenated frame
sequence (in calls of :data:`LSTM_FRAMES` frames, the state carried), and
the head over all frames. :func:`lstm_plain` is JAX's
``lstm_step`` loop, kept as the reference that tests hold ``nn.LSTM`` to.
The int16 quantisation by the peak scale stays on the host, bit for bit;
dequantisation runs on the device.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.phase_clock import PhaseClock
from svecalign_tpu_torch.utils.torch_setup import resolve_device

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
# chunks whose features are computed in one pass: bounds the frontend's
# memory (~150 MB of fp32 frames and products a pass) for files of any length
FEATURE_CHUNKS = 8192
# frames per nn.LSTM call, the state carried from call to call (one
# recurrence): cuDNN refuses sequences of 65,536 frames or more (an H100
# run: 65,535 runs, 65,536 fails), and an hour is 225,000
LSTM_FRAMES = 8192

# seconds by phase of SileroV4VAD.forward (features incl. upload, LSTM,
# head), summed over calls while SVECALIGN_VAD_PROFILE=1
vad_seconds: dict = {}
VAD_PROFILE_ENV = "SVECALIGN_VAD_PROFILE"


# ---------------------------------------------------------------------------
# Silero v4 probability network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SileroV4Config:
    """Geometry of the v4 graph. Everything weight-shaped (channel counts,
    kernel sizes, LSTM layout) is re-derived from the checkpoint at load
    time; the fields here cover the wiring the weights cannot encode
    (sample chunking, STFT hop, reflection pad, conv strides, temporal
    pooling of the per-frame head outputs into the per-chunk probability).
    """

    window_size: int = 1536  # samples per chunk @16 kHz (v4 default)
    n_fft: int = 256
    hop: int = 64
    pad: int = 64  # ReflectionPad1d on both sides before the STFT conv
    # channel plan when initializing WITHOUT a checkpoint (matches the v4
    # tensor shapes: 129-bin magnitude -> first_layer -> 4 encoder blocks)
    first_out: int = 128
    encoder_out: Tuple[int, ...] = (128, 64, 64, 128)
    encoder_stride: Tuple[int, ...] = (2, 2, 1, 1)
    kernel: int = 3
    lstm_hidden: int = 64
    lstm_layers: int = 2


def _v4_random_weights(cfg: SileroV4Config, seed: int = 0) -> dict:
    """Random weights in the exact v4 state-dict layout (torch conv (out,
    in, k); LSTM (4h, in)). Used when no checkpoint is available — keeps
    the graph runnable for plumbing tests and benchmarks."""
    rng = np.random.default_rng(seed)
    bins = cfg.n_fft // 2 + 1

    def conv(out, cin, k):
        return rng.normal(0, (cin * k) ** -0.5, (out, cin, k)).astype(np.float32)

    w = {"feature_extractor.forward_basis_buffer": _fourier_basis(cfg.n_fft)}
    w["first_layer.0.reparam_conv.weight"] = conv(cfg.first_out, bins, cfg.kernel)
    w["first_layer.0.reparam_conv.bias"] = np.zeros(cfg.first_out, np.float32)
    cin = cfg.first_out
    for i, out in enumerate(cfg.encoder_out):
        w[f"encoder.{i}.reparam_conv.weight"] = conv(out, cin, cfg.kernel)
        w[f"encoder.{i}.reparam_conv.bias"] = np.zeros(out, np.float32)
        cin = out
    h = cfg.lstm_hidden
    for j in range(cfg.lstm_layers):
        lin = cin if j == 0 else h
        sfx = f"_l{j}" if cfg.lstm_layers > 1 else ""
        w[f"decoder.rnn.weight_ih{sfx}"] = rng.normal(0, lin**-0.5, (4 * h, lin)).astype(np.float32)
        w[f"decoder.rnn.weight_hh{sfx}"] = rng.normal(0, h**-0.5, (4 * h, h)).astype(np.float32)
        w[f"decoder.rnn.bias_ih{sfx}"] = np.zeros(4 * h, np.float32)
        w[f"decoder.rnn.bias_hh{sfx}"] = np.zeros(4 * h, np.float32)
    w["decoder.decoder.2.weight"] = conv(1, h, 1)
    w["decoder.decoder.2.bias"] = np.zeros(1, np.float32)
    return w


def _fourier_basis(n_fft: int) -> np.ndarray:
    """torch-stft forward basis: [real; imag] DFT rows x hann window,
    shape (2*(n_fft//2+1), 1, n_fft) — the layout of v4's
    ``feature_extractor.forward_basis_buffer``."""
    bins = n_fft // 2 + 1
    fourier = np.fft.fft(np.eye(n_fft))[:bins]
    basis = np.vstack([np.real(fourier), np.imag(fourier)]).astype(np.float32)
    window = np.hanning(n_fft).astype(np.float32)
    return (basis * window[None, :])[:, None, :]


def _load_weights(ckpt_path: str) -> dict:
    data = np.load(ckpt_path)
    weights = {k: np.asarray(v, np.float32) for k, v in data.items()}
    # 16k branch preferred when both are present
    if any(k.startswith("_model.") for k in weights):
        weights = {k[len("_model."):]: v for k, v in weights.items() if k.startswith("_model.")}
    if "feature_extractor.forward_basis_buffer" not in weights:
        raise ValueError(
            f"{ckpt_path} is not a silero v4 checkpoint (missing "
            "feature_extractor.forward_basis_buffer; keys look like "
            f"{sorted(weights)[:3]}...). Re-export the pinned torchscript model "
            "with `python tools/convert_torch_ckpt.py silero <silero_vad.jit>`."
        )
    logger.info(f"Loaded silero weights from {ckpt_path}")
    return weights


def _lstm_layout(w: dict) -> List[Tuple[np.ndarray, ...]]:
    """[(w_ih, w_hh, b_ih, b_hh)] per layer, from LSTMCell names
    (weight_ih) or nn.LSTM names (weight_ih_l{j})."""
    names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    if "decoder.rnn.weight_ih" in w:
        return [tuple(w[f"decoder.rnn.{k}"] for k in names)]
    layers = []
    j = 0
    while f"decoder.rnn.weight_ih_l{j}" in w:
        layers.append(tuple(w[f"decoder.rnn.{k}_l{j}"] for k in names))
        j += 1
    if not layers:
        raise KeyError("no decoder.rnn.* LSTM weights in checkpoint")
    return layers


def lstm_plain(x: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, ...]]) -> torch.Tensor:
    """The stacked LSTM as the JAX package's ``lstm_step`` runs it, one
    frame at a time from a zero state: (L, C) inputs -> (L, h) outputs of
    the last layer. ``layers`` holds (w_ih, w_hh, b_ih, b_hh) per layer.
    The reference of :class:`SileroV4VAD`'s ``nn.LSTM``; no production
    path runs it."""
    hdim = layers[0][1].shape[1]
    state = [(x.new_zeros(hdim), x.new_zeros(hdim)) for _ in layers]
    out = x.new_empty((x.shape[0], hdim))
    for t in range(x.shape[0]):
        inp = x[t]
        for j, (w_ih, w_hh, b_ih, b_hh) in enumerate(layers):
            h_prev, c_prev = state[j]
            gates = w_ih @ inp + w_hh @ h_prev + b_ih + b_hh
            i_g, f_g, g_g, o_g = gates.chunk(4)
            c = torch.sigmoid(f_g) * c_prev + torch.sigmoid(i_g) * torch.tanh(g_g)
            h = torch.sigmoid(o_g) * torch.tanh(c)
            state[j] = (h, c)
            inp = h
        out[t] = inp
    return out


class SileroV4VAD(nn.Module):
    """Silero v4 VAD graph as an ``nn.Module``, the LSTM state carried
    across the file's chunks.

    Weight layout is the v4 torchscript state dict (``_model.`` prefix
    stripped): ``feature_extractor.forward_basis_buffer``,
    ``first_layer.0.reparam_conv.*``, ``encoder.{i}.reparam_conv.*``,
    ``decoder.rnn.*`` (LSTMCell or multi-layer LSTM ``_l{j}`` names), and
    ``decoder.decoder.2.*`` (the 1x1 conv head before the sigmoid), from
    ``ckpt_path`` (.npz) or ``weights``; without either, seeded random
    weights (:func:`_v4_random_weights`). Channel counts, kernel sizes and
    the LSTM layout come from the tensor shapes; the wiring the weights
    cannot encode (strides, reflection pad, temporal pooling) from
    :class:`SileroV4Config`.
    """

    def __init__(self, config: SileroV4Config = SileroV4Config(),
                 ckpt_path: Optional[str] = None, seed: int = 0,
                 weights: Optional[dict] = None, device="cuda"):
        super().__init__()
        self.config = config
        if weights is not None:
            self.weights = {k: np.asarray(v, np.float32) for k, v in weights.items()}
        elif ckpt_path:
            self.weights = _load_weights(ckpt_path)
        else:
            self.weights = _v4_random_weights(config, seed)
            logger.warning(
                "SileroV4VAD initialized with RANDOM weights; use --vad_model "
                "energy or provide --vad_ckpt for meaningful segmentation."
            )
        w = self.weights
        basis = w["feature_extractor.forward_basis_buffer"][:, 0, :]  # (2 * bins, n_fft)
        self.bins = basis.shape[0] // 2
        self.register_buffer("basis_t", torch.from_numpy(basis.T.copy()))
        n_enc = 0
        while f"encoder.{n_enc}.reparam_conv.weight" in w:
            n_enc += 1
        keys = ["first_layer.0.reparam_conv"] + [f"encoder.{i}.reparam_conv" for i in range(n_enc)]
        strides = [1] + [config.encoder_stride[i] if i < len(config.encoder_stride) else 1
                         for i in range(n_enc)]
        self.convs = nn.ModuleList()
        for key, stride in zip(keys, strides):
            cw = torch.from_numpy(w[f"{key}.weight"])
            conv = nn.Conv1d(cw.shape[1], cw.shape[0], cw.shape[2], stride=stride,
                             padding=cw.shape[2] // 2)
            with torch.no_grad():
                conv.weight.copy_(cw)
                conv.bias.copy_(torch.from_numpy(w[f"{key}.bias"]))
            self.convs.append(conv)
        layers = _lstm_layout(w)
        hidden = layers[0][1].shape[1]
        self.lstm = nn.LSTM(layers[0][0].shape[1], hidden, num_layers=len(layers),
                            batch_first=True)
        with torch.no_grad():
            for j, layer in enumerate(layers):
                for name, arr in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"), layer):
                    getattr(self.lstm, f"{name}_l{j}").copy_(torch.from_numpy(arr))
        head_w = w["decoder.decoder.2.weight"][:, :, 0]  # (1, h)
        self.head = nn.Linear(hidden, head_w.shape[0])
        with torch.no_grad():
            self.head.weight.copy_(torch.from_numpy(head_w))
            self.head.bias.copy_(torch.from_numpy(w["decoder.decoder.2.bias"]))
        self.device = resolve_device(device)
        self.to(self.device).eval()

    @property
    def window_size(self) -> int:
        return self.config.window_size

    def lstm_layers(self) -> List[Tuple[torch.Tensor, ...]]:
        """The LSTM's (w_ih, w_hh, b_ih, b_hh) per layer, for :func:`lstm_plain`."""
        return [tuple(getattr(self.lstm, f"{n}_l{j}")
                      for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                for j in range(self.lstm.num_layers)]

    def features(self, chunks: torch.Tensor) -> torch.Tensor:
        """(N, window) fp32 chunks -> (N, T', C) conv-stack features: the
        reflection pad, 256-point frames at the hop, the basis product in
        fp32, and the strided conv + ReLU stack, with the chunk as the
        batch axis."""
        cfg = self.config
        x = F.pad(chunks[:, None, :], (cfg.pad, cfg.pad), mode="reflect")[:, 0]
        proj = x.unfold(-1, cfg.n_fft, cfg.hop) @ self.basis_t  # (N, T, 2 * bins)
        re, im = proj[..., :self.bins], proj[..., self.bins:]
        x = torch.sqrt(re * re + im * im + 1e-12).transpose(1, 2)  # (N, bins, T)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return x.transpose(1, 2)

    def recur(self, seq: torch.Tensor) -> torch.Tensor:
        """(L, C) frames -> (L, h): ``nn.LSTM`` from a zero state over the
        whole sequence, :data:`LSTM_FRAMES` frames a call, the state
        carried across calls."""
        state, outs = None, []
        for lo in range(0, seq.shape[0], LSTM_FRAMES):
            out, state = self.lstm(seq[None, lo:lo + LSTM_FRAMES], state)
            outs.append(out[0])
        return torch.cat(outs)

    @torch.no_grad()
    def forward(self, chunks_i16: torch.Tensor, scale: float,
                plain_lstm: bool = False) -> torch.Tensor:
        """(N, window) int16 chunks (on any device) and their scale ->
        (N,) speech probabilities on the model's device. ``plain_lstm``
        runs :func:`lstm_plain` in the place of ``nn.LSTM``."""
        clock = PhaseClock(self.device, vad_seconds, VAD_PROFILE_ENV)
        chunks_i16 = chunks_i16.to(self.device)
        feats = torch.cat([
            self.features(chunks_i16[lo:lo + FEATURE_CHUNKS].to(torch.float32) * scale)
            for lo in range(0, chunks_i16.shape[0], FEATURE_CHUNKS)])  # (N, T', C)
        n, t, c = feats.shape
        clock.mark("features")
        seq = feats.reshape(n * t, c)
        if plain_lstm:
            hs = lstm_plain(seq, self.lstm_layers())
        else:
            hs = self.recur(seq)
        clock.mark("lstm")
        logits = self.head(torch.relu(hs)).reshape(n, t)
        probs = torch.sigmoid(logits).mean(dim=1)
        clock.mark("head")
        return probs

    def quantize(self, audio: np.ndarray) -> Tuple[np.ndarray, float]:
        """(n_chunks, window) int16 chunks of ``audio`` at the peak scale
        and that scale, on the host, bit for bit as the JAX package."""
        w = self.config.window_size
        n_chunks = -(-len(audio) // w)
        peak = float(np.max(np.abs(audio))) if len(audio) else 0.0
        scale = peak / 32767.0 if peak > 0 else 1.0
        padded = np.zeros(n_chunks * w, dtype=np.int16)
        padded[: len(audio)] = np.rint(np.asarray(audio) / scale).astype(np.int16)
        return padded.reshape(n_chunks, w), scale

    def speech_probs(self, audio: np.ndarray, plain_lstm: bool = False) -> np.ndarray:
        chunks, scale = self.quantize(audio)
        if chunks.shape[0] == 0:
            return np.zeros(0, np.float32)
        return self(torch.from_numpy(chunks), scale, plain_lstm).cpu().numpy()


class EnergyVAD:
    """Adaptive log-energy VAD: per-chunk RMS energy, threshold placed
    between the noise floor and the speech level percentiles, smoothed to a
    pseudo-probability. Weight-free and deterministic."""

    def __init__(self, window_size: int = 1536, floor_pct: float = 10.0,
                 speech_pct: float = 90.0, smooth: int = 3):
        self._window = window_size
        self.floor_pct = floor_pct
        self.speech_pct = speech_pct
        self.smooth = smooth

    @property
    def window_size(self) -> int:
        return self._window

    def speech_probs(self, audio: np.ndarray) -> np.ndarray:
        w = self._window
        n_chunks = -(-len(audio) // w)
        padded = np.zeros(n_chunks * w, dtype=np.float32)
        padded[: len(audio)] = audio
        chunks = padded.reshape(n_chunks, w)

        energy = np.sqrt(np.mean(np.square(chunks), axis=1) + 1e-12)
        log_e = np.log(energy + 1e-12)

        lo = np.percentile(log_e, self.floor_pct)
        hi = np.percentile(log_e, self.speech_pct)
        if hi - lo < 1e-3:  # silence-only or constant signal
            return np.zeros(n_chunks, dtype=np.float32)
        mid = (lo + hi) / 2
        scale = max((hi - lo) / 8, 1e-3)
        probs = 1.0 / (1.0 + np.exp(-(log_e - mid) / scale))

        if self.smooth > 1:
            kernel = np.ones(self.smooth) / self.smooth
            probs = np.convolve(probs, kernel, mode="same")
        return probs.astype(np.float32)


# ---------------------------------------------------------------------------
# Timestamp post-processing (silero get_speech_timestamps semantics)
# ---------------------------------------------------------------------------


def probs_to_timestamps(
    speech_probs: np.ndarray,
    audio_length_samples: int,
    window_size_samples: int,
    threshold: float = 0.5,
    min_speech_duration_ms: int = 250,
    max_speech_duration_s: float = float("inf"),
    min_silence_duration_ms: int = 100,
    speech_pad_ms: int = 30,
    sampling_rate: int = SAMPLE_RATE,
) -> List[dict]:
    """Hysteresis segmentation of per-chunk speech probabilities into
    [{'start': sample, 'end': sample}] spans, matching silero-VAD v4's
    post-processing behavior (threshold / neg-threshold trigger, minimum
    silence and speech durations, max-speech splitting, boundary padding).
    """
    min_speech_samples = sampling_rate * min_speech_duration_ms / 1000
    speech_pad_samples = sampling_rate * speech_pad_ms / 1000
    max_speech_samples = (
        sampling_rate * max_speech_duration_s
        - window_size_samples
        - 2 * speech_pad_samples
    )
    min_silence_samples = sampling_rate * min_silence_duration_ms / 1000
    min_silence_samples_at_max_speech = sampling_rate * 98 / 1000

    triggered = False
    speeches: List[dict] = []
    current: dict = {}
    neg_threshold = threshold - 0.15
    temp_end = 0
    prev_end = next_start = 0

    for i, prob in enumerate(speech_probs):
        pos = window_size_samples * i
        if prob >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos

        if prob >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue

        if triggered and (pos - current["start"]) > max_speech_samples:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:
                    triggered = False
                else:
                    current["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                current["end"] = pos
                speeches.append(current)
                current = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue

        if prob < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if (pos - temp_end) > min_silence_samples_at_max_speech:
                prev_end = temp_end
            if (pos - temp_end) < min_silence_samples:
                continue
            current["end"] = temp_end
            if (current["end"] - current["start"]) > min_speech_samples:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False
            continue

    if current and (audio_length_samples - current["start"]) > min_speech_samples:
        current["end"] = audio_length_samples
        speeches.append(current)

    for i, speech in enumerate(speeches):
        if i == 0:
            speech["start"] = int(max(0, speech["start"] - speech_pad_samples))
        if i != len(speeches) - 1:
            silence = speeches[i + 1]["start"] - speech["end"]
            if silence < 2 * speech_pad_samples:
                speech["end"] += int(silence // 2)
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - silence // 2)
                )
            else:
                speech["end"] = int(
                    min(audio_length_samples, speech["end"] + speech_pad_samples)
                )
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - speech_pad_samples)
                )
        else:
            speech["end"] = int(
                min(audio_length_samples, speech["end"] + speech_pad_samples)
            )

    return speeches


def get_speech_timestamps(audio: np.ndarray, model, **kwargs) -> List[dict]:
    """End-to-end: probability model + hysteresis post-processing."""
    probs = model.speech_probs(np.asarray(audio, dtype=np.float32))
    return probs_to_timestamps(
        probs, len(audio), model.window_size, **kwargs
    )
