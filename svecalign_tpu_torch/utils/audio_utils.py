"""Audio loading for the embed stage (the JAX package's
``utils/audio_utils.py``: ``SAMPLE_RATE`` and ``load_waveform``).

16 kHz frames everywhere; ``start``/``end`` are frame offsets, matching
``soundfile.read`` in the reference (svecalign/utils/audio_utils.py:15-23).
"""

from pathlib import Path
from typing import Optional, Union

import numpy as np

from svecalign_tpu_torch.utils import audio_io

SAMPLE_RATE = 16000


def load_waveform(
    path: Union[str, Path],
    start: int = 0,
    end: Optional[int] = None,
    sr: int = SAMPLE_RATE,
) -> np.ndarray:
    """Read (a slice of) an audio file as a float32 (n,) or (n, ch) waveform."""
    waveform, file_sr = audio_io.read(str(path), start=start, stop=end)
    if file_sr != sr:
        raise ValueError(f"{path}: expected sample rate {sr}, got {file_sr}")
    return waveform
