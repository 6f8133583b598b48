"""The port's VAD (``models/vad.py``) against the JAX package's, on the CPU.

- ``_v4_random_weights``: the same numpy draws, equal leaf by leaf;
- ``EnergyVAD``: numpy, bit-equal;
- ``probs_to_timestamps``: the same spans on seeded probability traces,
  with and without the ``max_speech_duration_s`` split;
- ``SileroV4VAD``: speech probabilities within 1e-5 of JAX's on 30 s of
  audio (fp32 convs, products and LSTM in both; ~1e-7 measured), and
  equal timestamps, at the full v4 geometry (random weights), for a
  1-layer LSTMCell checkpoint and a 2-layer ``_l{j}`` checkpoint written
  as ``.npz``;
- ``nn.LSTM`` against ``lstm_plain`` (JAX's ``lstm_step`` loop) within
  1e-6 on the hidden outputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svecalign_tpu.models import vad as jvad
from svecalign_tpu_torch.models import vad as tvad

torch.set_num_threads(2)

PROB_ATOL = 1e-5
LSTM_ATOL = 1e-6


def speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    w = (0.003 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    for s, e in cs.vad_segments(rng, seconds):
        w[s:e] += cs.front_speech(rng, e - s)
    return w


def threshold_between(probs, margin=2e-5):
    """A threshold near the median of ``probs`` that no probability lies
    within ``margin`` of, so both packages' hysteresis sees the same
    crossings (random weights squeeze the probabilities around 0.5)."""
    p = np.sort(probs)
    mids = (p[1:] + p[:-1]) / 2
    ok = (p[1:] - p[:-1]) > 2 * margin
    k = np.flatnonzero(ok)[np.argmin(np.abs(np.flatnonzero(ok) - len(p) // 2))]
    return float(mids[k])


@pytest.mark.parametrize("cfg", [tvad.SileroV4Config(),
                                 tvad.SileroV4Config(lstm_layers=1),
                                 tvad.SileroV4Config(encoder_out=(64, 32), lstm_hidden=32)])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_weights_equal_leaf_by_leaf(cfg, seed):
    want = jvad._v4_random_weights(jvad.SileroV4Config(**dataclasses.asdict(cfg)), seed)
    got = tvad._v4_random_weights(cfg, seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["speech", "silence", "constant", "short"])
def test_energy_vad_bit_equal(kind):
    w = {"speech": speechlike(20, 1), "silence": np.zeros(16000 * 3, np.float32),
         "constant": np.full(16000 * 2, 0.1, np.float32),
         "short": speechlike(20, 2)[:1000]}[kind]
    for kw in ({}, {"smooth": 1, "floor_pct": 20.0}):
        want = jvad.EnergyVAD(**kw).speech_probs(w)
        got = tvad.EnergyVAD(**kw).speech_probs(w)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (tvad.get_speech_timestamps(w, tvad.EnergyVAD(**kw))
                == jvad.get_speech_timestamps(w, jvad.EnergyVAD(**kw)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [{}, {"max_speech_duration_s": 3.0},
                                {"max_speech_duration_s": 1.5, "min_silence_duration_ms": 300,
                                 "speech_pad_ms": 100, "threshold": 0.6}])
def test_probs_to_timestamps_equal(seed, kw):
    rng = np.random.default_rng(seed)
    # runs of speech and silence with noisy probabilities
    runs = np.repeat(rng.random(60) < 0.6, rng.integers(1, 40, 60))
    probs = np.clip(np.where(runs, 0.8, 0.1) + 0.25 * rng.standard_normal(runs.size), 0, 1)
    n = runs.size * 1536 - int(rng.integers(0, 1536))
    want = jvad.probs_to_timestamps(probs, n, 1536, **kw)
    got = tvad.probs_to_timestamps(probs, n, 1536, **kw)
    assert got == want and len(got) > 1


def _compare_silero(jmodel, tmodel, audio):
    want = np.asarray(jmodel.speech_probs(audio))
    got = tmodel.speech_probs(audio)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    thr = threshold_between(want)
    spans = tvad.probs_to_timestamps(got, len(audio), 1536, threshold=thr)
    assert spans == jvad.probs_to_timestamps(want, len(audio), 1536, threshold=thr)
    assert spans  # the threshold splits the file into speech and silence
    assert spans == tvad.get_speech_timestamps(audio, tmodel, threshold=thr)


def test_silero_full_geometry_matches_jax():
    audio = speechlike(30, 3)
    _compare_silero(jvad.SileroV4VAD(seed=5), tvad.SileroV4VAD(seed=5, device="cpu"), audio)


@pytest.mark.parametrize("layers", [1, 2])
def test_silero_npz_checkpoint_matches_jax(tmp_path, layers):
    """A 1-layer checkpoint with LSTMCell names; a 2-layer one with nn.LSTM
    names under the torchscript ``_model.`` prefix (and a stray 8 kHz
    branch that the loaders drop)."""
    cfg = jvad.SileroV4Config(lstm_layers=layers, encoder_out=(96, 64, 64, 128))
    w = jvad._v4_random_weights(cfg, seed=11)
    rng = np.random.default_rng(12)
    for k, v in w.items():  # non-zero biases, so that they are loaded too
        if "bias" in k:
            w[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    if layers == 1:
        assert "decoder.rnn.weight_ih" in w
        arrays = w
    else:
        assert "decoder.rnn.weight_ih_l1" in w
        arrays = {f"_model.{k}": v for k, v in w.items()}
        arrays["_model_8k.first_layer.0.reparam_conv.bias"] = np.zeros(3, np.float32)
    path = tmp_path / "silero.npz"
    np.savez(path, **arrays)
    tmodel = tvad.SileroV4VAD(ckpt_path=str(path), device="cpu")
    assert tmodel.lstm.num_layers == layers and tmodel.convs[1].out_channels == 96
    _compare_silero(jvad.SileroV4VAD(ckpt_path=str(path)), tmodel, speechlike(30, 4))
    # a weights dict loads the same model
    same = tvad.SileroV4VAD(weights=tmodel.weights, device="cpu")
    for a, b in zip(same.state_dict().values(), tmodel.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_silero_rejects_other_checkpoints(tmp_path):
    path = tmp_path / "old.npz"
    np.savez(path, **{"encoder.0.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not a silero v4 checkpoint"):
        tvad.SileroV4VAD(ckpt_path=str(path), device="cpu")


def test_silero_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvad.SileroV4VAD()


@pytest.mark.parametrize("layers", [1, 2])
def test_nn_lstm_matches_lstm_plain(layers, monkeypatch):
    """One nn.LSTM over the file's concatenated frames equals the step
    loop carried across chunks; also in blocks, the state carried by
    hand, as the JAX scan over chunks carries it."""
    model = tvad.SileroV4VAD(tvad.SileroV4Config(lstm_layers=layers), seed=2, device="cpu")
    chunks, scale = model.quantize(speechlike(8, 5))
    feats = model.features(torch.from_numpy(chunks).float() * scale)
    seq = feats.reshape(-1, feats.shape[-1])
    assert feats.shape[1:] == (6, 128) and seq.shape[0] == 6 * chunks.shape[0]
    with torch.no_grad():
        got = model.lstm(seq[None])[0][0]
        want = tvad.lstm_plain(seq, model.lstm_layers())
        torch.testing.assert_close(got, want, rtol=0, atol=LSTM_ATOL)
        # the model's calls of LSTM_FRAMES frames, here 7 (not a chunk's 6)
        monkeypatch.setattr(tvad, "LSTM_FRAMES", 7)
        torch.testing.assert_close(model.recur(seq), want, rtol=0, atol=LSTM_ATOL)
        # the same recurrence chunk by chunk, the state carried across
        state, outs = None, []
        for lo in range(0, seq.shape[0], 6):
            out, state = model.lstm(seq[None, lo:lo + 6], state)
            outs.append(out[0])
        torch.testing.assert_close(torch.cat(outs), want, rtol=0, atol=LSTM_ATOL)
    probs = model.speech_probs(speechlike(8, 5))
    np.testing.assert_allclose(model.speech_probs(speechlike(8, 5), plain_lstm=True), probs,
                               rtol=0, atol=LSTM_ATOL)


def test_silero_quantisation_and_feature_blocks(monkeypatch):
    """int16 chunks at the peak scale as JAX makes them; features computed
    in blocks of chunks equal one pass."""
    audio = speechlike(6, 6)
    model = tvad.SileroV4VAD(device="cpu")
    chunks, scale = model.quantize(audio)
    peak = float(np.max(np.abs(audio)))
    assert chunks.dtype == np.int16 and scale == peak / 32767.0
    np.testing.assert_array_equal(chunks.reshape(-1)[:len(audio)],
                                  np.rint(audio / scale).astype(np.int16))
    whole = model.speech_probs(audio)
    monkeypatch.setattr(tvad, "FEATURE_CHUNKS", 7)
    np.testing.assert_allclose(model.speech_probs(audio), whole, rtol=0, atol=1e-7)
    assert model.speech_probs(np.zeros(0, np.float32)).shape == (0,)
