"""The port's batched fbank and untranslated-segment detection
(``ops/fbank.py``: ``fbank``, ``fbank_frames``, ``fbank_batch``;
``utils/audio_utils.py``: ``binary_search``, ``compute_fbank_dist``,
``Segment``, ``find_untranslated_segs``) against the JAX package's, on the
CPU, on the same seeded numpy inputs.

Tolerances: log-mel within 1e-3 absolute (the two packages' fp32 FFTs and
mel products round differently; ~1e-4 measured); ``binary_search`` and
``compute_fbank_dist`` equal (the same numpy arithmetic on the same
arrays); ``find_untranslated_segs`` returns the same pairs on WAV pairs
whose candidates' MSEs lie well away from the threshold (checked).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.ops import fbank as jfbank
from svecalign_tpu.utils import audio_utils as jau
from svecalign_tpu_torch.ops import fbank as tfbank
from svecalign_tpu_torch.utils import audio_io as taudio
from svecalign_tpu_torch.utils import audio_utils as tau

torch.set_num_threads(2)

LOGMEL_ATOL = 1e-3
SR = 16000


def _noise(rng, n, amp=0.3):
    return (amp * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n", [399, 400, 401, 16000, 80000, 123457])
def test_fbank_matches_jax(n):
    rng = np.random.default_rng(n)
    w = _noise(rng, n) * np.linspace(0.05, 1.0, n, dtype=np.float32)
    want = jfbank.fbank(w)
    got = tfbank.fbank(w, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == ((0 if n < 400 else 1 + (n - 400) // 160), 80)
    if got.size:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGMEL_ATOL)


def test_fbank_frames_matches_jax():
    """Frames at arbitrary start offsets of one flat buffer: the batched
    entry's layout, segment boundaries in the start vector alone."""
    rng = np.random.default_rng(1)
    samples = _noise(rng, 50000)
    starts = np.sort(rng.integers(0, 50000 - 400, 700)).astype(np.int64)
    want = np.asarray(jfbank.fbank_frames_device(jnp.asarray(samples),
                                                 jnp.asarray(starts.astype(np.int32)),
                                                 SR, 80, 400))
    got = tfbank.fbank_frames(torch.from_numpy(samples), torch.from_numpy(starts), SR, 80, 400)
    assert got.shape == (700, 80) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL)


def test_fbank_batch_matches_jax(monkeypatch):
    """Mixed lengths, shorter-than-a-frame and empty waveforms, a
    (channels, n) waveform (first channel); the frame chunk cut small so
    that the batch runs in several passes, as an hour of audio does."""
    rng = np.random.default_rng(2)
    waves = [_noise(rng, n) for n in (16000, 0, 399, 400, 48000, 2500)]
    waves.append(np.stack([_noise(rng, 9000), _noise(rng, 9000)]))
    want = jfbank.fbank_batch(waves)
    monkeypatch.setattr(tfbank, "FRAME_CHUNK", 97)
    got = tfbank.fbank_batch(waves, device="cpu")
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        if w.size:
            np.testing.assert_allclose(g, w, rtol=0, atol=LOGMEL_ATOL)
    # each waveform alone gives its rows of the batch
    for g, w in zip(got, waves):
        np.testing.assert_allclose(tfbank.fbank(w, device="cpu"), g, rtol=0, atol=1e-5)
    assert tfbank.fbank_batch([np.zeros(100, np.float32)], device="cpu")[0].shape == (0, 80)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_search_and_fbank_dist_equal_jax(seed):
    rng = np.random.default_rng(seed)
    arr = np.sort(rng.uniform(0, 1000, 50))
    for target in np.concatenate([rng.uniform(-10, 1010, 200), arr, [arr[0], arr[-1]]]):
        assert tau.binary_search(arr, target) == jau.binary_search(arr, target)
    for n1, n2 in [(30, 30), (30, 41), (41, 30), (0, 12), (5, 60)]:
        a = rng.standard_normal((n1, 80)).astype(np.float32)
        b = rng.standard_normal((n2, 80)).astype(np.float32)
        if n1 and n2 > n1:
            b[7:7 + n1] = a + 0.01 * rng.standard_normal((n1, 80)).astype(np.float32)
        assert tau.compute_fbank_dist(a, b) == jau.compute_fbank_dist(a, b)
    # the reference's excluded final offset: a copy at the last offset is not found
    a = rng.standard_normal((10, 80)).astype(np.float32)
    b = np.concatenate([rng.standard_normal((5, 80)).astype(np.float32), a])
    assert tau.compute_fbank_dist(a, b) == jau.compute_fbank_dist(a, b) > 0


def write_untrans_pair(root, seed, max_frame_diff):
    """Two WAVs of 40 s and their segments, the midpoint-nearest target of
    each source segment being: an exact copy (planted, flagged); a copy
    one sample past the duration gate; other content of the same duration
    (a pure tone against noise); a copy 30 dB quieter (same duration,
    large log-mel distance); or unrelated speech-like noise. Returns
    (src wav, tgt wav, src segs, tgt segs, planted pairs)."""
    rng = np.random.default_rng(seed)
    n = 40 * SR
    src = _noise(rng, n, 0.003)
    tgt = _noise(rng, n, 0.003)
    src_segs, tgt_segs, planted = [], [], []
    t = SR // 2
    kinds = ["copy", "past_gate", "tone", "quiet", "copy", "unrelated", "past_gate", "copy"]
    for k, kind in enumerate(kinds):
        dur = int(rng.uniform(0.8, 2.5) * SR)
        s, e = t, t + dur
        src[s:e] += _noise(rng, dur, rng.uniform(0.05, 0.3)) * np.hanning(dur).astype(np.float32)
        src_segs.append((s, e))
        te = e
        if kind == "copy":
            tgt[s:e] = src[s:e]
            planted.append((k, k))
        elif kind == "past_gate":
            te = e + max_frame_diff + 1
            tgt[s:te] = src[s:te]
        elif kind == "tone":
            tgt[s:e] += 0.2 * np.sin(2 * np.pi * 440 * np.arange(dur) / SR).astype(np.float32)
        elif kind == "quiet":
            tgt[s:e] += 0.03 * src[s:e]
        else:
            tgt[s:e] += _noise(rng, dur, 0.2)
        tgt_segs.append((s, te))
        t = te + int(rng.uniform(0.6, 1.2) * SR)
    paths = []
    for name, wave in (("src", src), ("tgt", tgt)):
        p = Path(root) / f"{name}_{seed}.wav"
        taudio.write(str(p), np.clip(wave, -1, 1), SR)
        paths.append(p)
    return paths[0], paths[1], src_segs, tgt_segs, planted


@pytest.mark.parametrize("seed", [0, 1])
def test_find_untranslated_segs_matches_jax(tmp_path, seed):
    gate = int(0.1 * SR)
    src_wav, tgt_wav, src_segs, tgt_segs, planted = write_untrans_pair(tmp_path, seed, gate)
    want = jau.find_untranslated_segs(src_segs, tgt_segs, src_wav, tgt_wav, gate, 5.0)
    got = tau.find_untranslated_segs(src_segs, tgt_segs, src_wav, tgt_wav, gate, 5.0,
                                     device="cpu")
    assert got == want == planted
    # the data keeps every verdict away from the threshold
    for i, j in zip(range(len(src_segs)), range(len(tgt_segs))):
        fa = tau.Segment(*src_segs[i], src_wav).fbank(device="cpu")
        fb = tau.Segment(*tgt_segs[j], tgt_wav).fbank(device="cpu")
        assert abs(tau.compute_fbank_dist(fa, fb) - 5.0) > 0.5
    assert tau.find_untranslated_segs([], tgt_segs, src_wav, tgt_wav, gate, 5.0,
                                      device="cpu") == []


def test_segment_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    wav = tmp_path / "a.wav"
    stereo = np.stack([_noise(rng, 30000), _noise(rng, 30000)], axis=1)
    taudio.write(str(wav), stereo, SR)
    t, j = tau.Segment(1234, 20000, wav), jau.Segment(1234, 20000, wav)
    assert (t.start, t.end, t.mid, t.duration, t.path) == (j.start, j.end, j.mid, j.duration,
                                                           j.path)
    np.testing.assert_array_equal(t.waveform, j.waveform)
    np.testing.assert_allclose(t.fbank(device="cpu"), j.fbank(), rtol=0, atol=LOGMEL_ATOL)
    got = tau.batch_segment_fbanks([t, tau.Segment(0, 5000, wav)], device="cpu")
    np.testing.assert_allclose(got[0], j.fbank(), rtol=0, atol=LOGMEL_ATOL)
    with pytest.raises(ValueError):
        tau.Segment(5, 5, wav)
    with pytest.raises(FileNotFoundError):
        tau.Segment(0, 5, tmp_path / "missing.wav")
