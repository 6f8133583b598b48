"""Kaldi-compatible log-mel filterbank features, batched over rows.

Port of the JAX package's ``ops/fbank.py`` (``mel_banks``,
``povey_window``, the ``_frames_to_mel`` tail and ``fbank_device``):
80 mel bins, 25 ms povey windows at 10 ms shift, preemphasis 0.97,
per-frame DC removal, power spectrum, snip_edges, as
``torchaudio.compliance.kaldi.fbank`` with dither 0.

Plain PyTorch on either device: framing is an ``unfold``, the FFT is
``torch.fft.rfft`` (cuFFT on the card) and the mel projection an fp32
matmul, in full fp32 (TF32 off, as the JAX ``Precision.HIGHEST``).
"""

import math
from functools import lru_cache

import numpy as np
import torch

MEL_LOW_FREQ = 20.0
EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's log floor


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(
    num_bins: int, window_size_padded: int, sample_rate: float,
    low_freq: float = MEL_LOW_FREQ, high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank matrix (num_bins, n_fft_bins),
    n_fft_bins = window_size_padded // 2 (nyquist bin excluded)."""
    n_fft_bins = window_size_padded // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range [{low_freq}, {high_freq}] for nyquist {nyquist}")

    fft_bin_width = sample_rate / window_size_padded
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, n_fft_bins), dtype=np.float32)
    fft_freqs = _mel_scale(fft_bin_width * np.arange(n_fft_bins))
    for m in range(num_bins):
        left = mel_low + m * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (fft_freqs - left) / (center - left)
        down = (right - fft_freqs) / (right - center)
        bins[m] = np.maximum(0.0, np.minimum(up, down))
    return bins


def povey_window(window_size: int) -> np.ndarray:
    """Kaldi's 'povey' window: hann ** 0.85."""
    n = np.arange(window_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_size - 1))
    return (hann**0.85).astype(np.float32)


@lru_cache(maxsize=None)
def _constants(frame_length: int, num_mel_bins: int, sample_rate: int, device: torch.device):
    padded = 1 << math.ceil(math.log2(frame_length))  # round_to_power_of_two
    window = torch.from_numpy(povey_window(frame_length)).to(device)
    banks_t = torch.from_numpy(mel_banks(num_mel_bins, padded, float(sample_rate)).T.copy())
    return padded, window, banks_t.to(device)


def frames_to_mel(
    frames: torch.Tensor, sample_rate: int, num_mel_bins: int, preemphasis: float,
) -> torch.Tensor:
    """Per-frame tail on (..., frame_length) fp32 frames: DC removal,
    preemphasis, povey window, power spectrum, mel projection, log floor.
    Returns (..., num_mel_bins) fp32."""
    frame_length = frames.shape[-1]
    padded, window, banks_t = _constants(frame_length, num_mel_bins, sample_rate, frames.device)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - preemphasis * prev) * window
    spec = torch.fft.rfft(frames, n=padded, dim=-1)
    power = spec.abs().square()[..., : padded // 2]
    mel = torch.matmul(power, banks_t)
    return torch.log(torch.clamp(mel, min=EPSILON))


def fbank_device(
    waveform: torch.Tensor,
    sample_rate: int,
    num_mel_bins: int,
    frame_length: int,
    frame_shift: int,
    n_frames: int,
    preemphasis: float = 0.97,
) -> torch.Tensor:
    """Fbank of (..., n_samples) fp32 waveforms -> (..., n_frames,
    num_mel_bins): frame i starts at sample i * frame_shift (snip_edges).
    The rows must hold at least frame_length + (n_frames - 1) * frame_shift
    samples."""
    need = frame_length + (n_frames - 1) * frame_shift
    if waveform.shape[-1] < need:
        raise ValueError(f"{n_frames} frames need {need} samples, got {waveform.shape[-1]}")
    frames = waveform[..., :need].unfold(-1, frame_length, frame_shift)
    return frames_to_mel(frames, sample_rate, num_mel_bins, preemphasis)
