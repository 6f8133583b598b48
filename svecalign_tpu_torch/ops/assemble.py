"""Overlap-window assembly on the device for the embed stage.

Port of the JAX package's ``ops/assemble.py``. The concat stage's overlap
windows cover each sample many times over, so the waveform goes to the
device once (int16 quantized per 1 s block, or fp32 for the exact path),
is dequantised there once per file (:func:`dequant`), and each chunk of
windows is gathered out of it by start index (:func:`assemble`). In int16
mode the gathered rows are requantized per row, so they enter the forward
in the same (int16, scales, lengths) form as the host-staged path; fp32
mode passes values through bit-exactly.

Rounding is half to even everywhere (``np.rint`` on the host,
``torch.round`` on the device), as ``np.rint``/``jnp.rint`` in JAX.
"""

from typing import Tuple

import numpy as np
import torch

WAVE_BLOCK = 16000  # per-block quantization granularity (1 s @ 16 kHz)

# powers-of-2 seconds: a handful of upload shapes covers minutes-to-hours;
# waveforms past the largest bucket fall back to host-sliced encode()
WAVE_BUCKETS_S = (30, 60, 120, 240, 480, 960, 1920, 3840, 7680)


def quantize_wave(waveform: np.ndarray, wave_len: int, fp32: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Pad to wave_len and quantize per WAVE_BLOCK -> (wave, block_scales).

    fp32 mode returns the padded wave unchanged with unit scales (the
    dequant multiply is then exact).
    """
    n_blocks = wave_len // WAVE_BLOCK
    padded = np.zeros(wave_len, np.float32)
    padded[: len(waveform)] = waveform
    if fp32:
        return padded, np.ones(n_blocks, np.float32)
    blocks = padded.reshape(n_blocks, WAVE_BLOCK)
    peaks = np.max(np.abs(blocks), axis=1)
    scales = np.where(peaks > 0, peaks / 32767.0, 1.0).astype(np.float32)
    wave = np.rint(blocks / scales[:, None]).astype(np.int16).reshape(-1)
    return wave, scales


def dequant(wave: torch.Tensor, block_scales: torch.Tensor, slack: int) -> torch.Tensor:
    """(wave, block_scales) on the device -> the fp32 wave followed by
    ``slack`` zeros, so that a window gather never runs off the end
    (slack >= the largest window width)."""
    w = wave.float().reshape(-1, WAVE_BLOCK) * block_scales[:, None]
    return torch.cat([w.reshape(-1), torch.zeros(slack, dtype=torch.float32, device=w.device)])


def assemble(w: torch.Tensor, idx: torch.Tensor, width: int, fp32: bool):
    """(padded fp32 wave, (rows, 3) ``[start, n_samples, out_len]``) ->
    (rows, row_scales, out_lens): gather a ``width``-sample window at each
    start, zero past n_samples, pass out_len through (the forward's length
    unit: 10 ms frames for SONAR). int16 mode requantizes each row
    (peak / 32767) as the host staging does; fp32 passes values through."""
    n_rows = idx.shape[0]
    offs = torch.arange(width, device=w.device)
    n_samples = torch.clamp(idx[:, 1], max=width)
    rows = w[idx[:, 0, None] + offs[None, :]]
    rows = torch.where(offs[None, :] < n_samples[:, None], rows, 0.0)
    if fp32:
        return rows, torch.ones(n_rows, dtype=torch.float32, device=w.device), idx[:, 2]
    peak = rows.abs().amax(dim=1)
    scale = torch.where(peak > 0, peak / 32767.0, 1.0)
    rows_q = torch.round(rows / scale[:, None]).to(torch.int16)
    return rows_q, scale, idx[:, 2]
