"""Hour-long plenary documents for the stage-5.3 cells, made from a seed.

A document is a 16 kHz PCM16 WAV, its VAD-like segments and the concat
windows that stage 5.1 would cut from them. The segment layout of each
document comes from a structure seed named in the traffic file, so every
run seed embeds the same set of window lengths; the run seed picks the
order of the documents and draws the audio itself (speech-like tones in
noise over the segments, near silence between them), on the device, in
a few large calls. WAVs are written with the standard library: nothing
here is made by the program under test.
"""

import wave
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

SR = 16000


class Document(NamedTuple):
    stem: str
    wav: Path
    segments: List[Tuple[int, int]]
    windows: List[Tuple[int, int]]  # in the concat file's line order
    seconds: int


def vad_segments(rng: np.random.Generator, seconds: int, segment_s=(0.5, 3.0),
                 gap_s=(0.1, 0.8), sr: int = SR) -> List[Tuple[int, int]]:
    """VAD-like (start, end) sample spans over ``seconds`` of audio: speech
    uniform in ``segment_s`` seconds, pauses uniform in ``gap_s``."""
    segs, t = [], int(rng.uniform(*gap_s) * sr)
    while True:
        dur = int(rng.uniform(*segment_s) * sr)
        if t + dur > seconds * sr:
            return segs
        segs.append((t, t + dur))
        t += dur + int(rng.uniform(*gap_s) * sr)


def concat_windows(segs, max_run: int = 5, max_dur_s: float = 20.0, sr: int = SR) -> List[str]:
    """Stage 5.1's rule at its defaults, written out plainly: every run of
    up to ``max_run`` consecutive segments from each anchor, stopping at
    the first whose extent passes ``max_dur_s``; lines sorted as strings,
    as the stage writes them."""
    cap = int(max_dur_s * sr)
    lines = []
    for k in range(len(segs)):
        anchor = segs[k][0]
        for _, stop in segs[k:k + max_run]:
            if stop - anchor > cap:
                break
            lines.append(f"{anchor} {stop}")
    return sorted(lines)


def synth_audio(segs, seconds: int, seed: int, device) -> np.ndarray:
    """(seconds * SR,) int16 samples: noise at 0.003 everywhere, and over
    each segment three harmonics of a gliding-free f0 in 90-250 Hz plus
    noise, under a flattened Hann envelope. Drawn on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    n = seconds * SR
    n_seg = len(segs)
    starts = torch.tensor([s for s, _ in segs], dtype=torch.int64, device=dev)
    lens = torch.tensor([e - s for s, e in segs], dtype=torch.int64, device=dev)
    # float64 throughout: a last-place difference between two vector math
    # paths cannot reach the int16 samples
    params = torch.rand((n_seg, 5), generator=gen, device=dev, dtype=torch.float64)
    f0 = 90.0 + 160.0 * params[:, 0]
    amp = 0.05 + 0.25 * params[:, 1]
    phases = 6.3 * params[:, 2:5]
    wave_f = 0.003 * torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    seg_id = torch.repeat_interleave(torch.arange(n_seg, device=dev), lens)
    pos = torch.arange(seg_id.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    t = pos.double() / SR
    voiced = torch.zeros_like(t)
    for h in (1, 2, 3):
        voiced += torch.sin(2 * np.pi * f0[seg_id] * h * t + phases[seg_id, h - 1]) / h
    span = (lens[seg_id] - 1).clamp(min=1).double()
    hann = 0.5 - 0.5 * torch.cos(2 * np.pi * pos.double() / span)
    env = amp[seg_id] * hann.clamp(min=0) ** 0.2
    noise = torch.randn(t.numel(), generator=gen, device=dev, dtype=torch.float64)
    idx = starts[seg_id] + pos
    wave_f[idx] += env * (0.6 * voiced + 0.4 * noise)
    pcm = torch.round(wave_f.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    return pcm.cpu().numpy()


def write_wav(path: Path, pcm: np.ndarray, sr: int = SR) -> None:
    """A mono PCM16 WAV by the standard library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())


def read_wav(path: Path) -> np.ndarray:
    """A PCM16 WAV's samples as fp32 in [-1, 1), as the WAV's integers / 32768."""
    with wave.open(str(path), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32768.0


def document_order(seed: int, n_docs: int) -> List[int]:
    """Which structure each document slot takes: a permutation from the seed."""
    return [int(i) for i in np.random.default_rng([int(seed), 1]).permutation(n_docs)]


def write_documents(root: Path, traffic: dict, seed: int, device) -> List[Document]:
    """Write the traffic's documents under ``root``: ``raw_audios/{stem}.wav``
    and ``cat_segs/{lang}/{stem}.txt`` (the concat windows). Returns them in
    the order the window cycles through them."""
    seconds = int(traffic["doc_seconds"])
    lang = traffic["lang"]
    docs = []
    for slot, k in enumerate(document_order(seed, len(traffic["structure_seeds"]))):
        segs = vad_segments(np.random.default_rng(int(traffic["structure_seeds"][k])), seconds,
                            traffic["segment_s"], traffic["gap_s"])
        lines = concat_windows(segs, traffic["max_run"], traffic["max_window_s"])
        stem = f"doc{slot}_{lang}"
        wav = Path(root) / "raw_audios" / f"{stem}.wav"
        write_wav(wav, synth_audio(segs, seconds, int(seed) * 7919 + slot, device))
        cat = Path(root) / "cat_segs" / lang / f"{stem}.txt"
        cat.parent.mkdir(parents=True, exist_ok=True)
        cat.write_text("".join(line + "\n" for line in lines), encoding="utf-8")
        windows = [tuple(int(v) for v in line.split()) for line in lines]
        docs.append(Document(stem, wav, segs, windows, seconds))
    return docs
