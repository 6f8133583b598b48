"""The port's stage-5.3 CLI (svecalign_tpu_torch.seg_align.embed --device
cpu) against the JAX CLI (svecalign_tpu.seg_align.embed) on a synthetic
WAV written by the port's writer, both with the SONAR or the SpeechLASER
model of a small config loaded from one npz (each package's
``_build_embed_model`` is patched to build it; the loaders' memos are
cleared around each run).

The SONAR ``.embed`` files hold headerless fp16 rows, the SpeechLASER ones
a stopes ``.npy`` of fp16 rows; port and JAX rows agree to one fp16 step
at the rows' magnitude (the fp32 encoders differ by ~1e-5 relative before
the cast). Also: the port's WAV reader equals the JAX package's native
reader bit for bit, and its writer writes the same bytes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.seg_align import embed as jembed
from svecalign_tpu.utils import audio_io as jaudio
from svecalign_tpu.utils import embed_model_utils as jemu
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.seg_align import embed as tembed
from svecalign_tpu_torch.utils import audio_io as taudio
from svecalign_tpu_torch.utils import embed_model_utils as temu

torch.set_num_threads(2)

SMALL = dict(n_mels=80, model_dim=128, n_layers=2, n_heads=2, ffn_dim=256,
             conv_kernel=31, pool_dim=128)
LASER_SMALL = dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_dim=128,
                   encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256, conv_pos_kernel=16,
                   conv_pos_groups=4, dtype="float32")
STEM = "doc_en"
# one fp16 step at the rows' magnitude (|x| < 2), plus the fp32 difference
FP16_ATOL = 2.0**-9


def _wave(seconds=24, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    w[10 * 16000 : 13 * 16000] *= 0.01  # a quiet stretch
    return w


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A metadata file, one WAV, its concat windows, and the npz weights."""
    root = tmp_path_factory.mktemp("embed")
    wav = root / "raw" / f"{STEM}.wav"
    wav.parent.mkdir()
    taudio.write(str(wav), _wave(), 16000)
    (root / "metadata.tsv").write_text(f"{wav}\t{root / 'raw' / 'doc_de.wav'}\n")
    # overlapping windows of up to 3 consecutive pseudo-segments, sorted as
    # strings like the concat stage's files; one overruns the file end
    segs = [(s, s + d) for s, d in zip(range(0, 22 * 16000, 27000), [9000, 21000, 15000] * 20)]
    spans = sorted({f"{segs[i][0]} {segs[j][1]}" for i in range(len(segs))
                    for j in range(i, min(i + 3, len(segs)))} | {f"{23 * 16000} {26 * 16000}"})
    cdir = root / "cat" / "en"
    cdir.mkdir(parents=True)
    (cdir / f"{STEM}.txt").write_text("".join(s + "\n" for s in spans))
    model = jsonar.SonarSpeechEncoder(jsonar.SonarEncoderConfig(**SMALL, dtype="float32"))
    params = jparams.numpy_init(model, (jnp.zeros((1, 50, 160)), jnp.ones((1, 50), bool)), seed=4)
    npz = root / "small.npz"
    jparams.save_params_npz(params, str(npz))
    laser = jlaser.LaserSpeechEncoder(jlaser.LaserEncoderConfig(**LASER_SMALL))
    params = jparams.numpy_init(laser, (jnp.zeros((1, 4000)), jnp.zeros((1,), jnp.int32)), seed=4)
    laser_npz = root / "laser.npz"
    jparams.save_params_npz(params, str(laser_npz))
    return dict(root=root, wav=wav, npz=str(npz), laser_npz=str(laser_npz), n_rows=len(spans))


def _argv(corpus, out, upload, assembly, kind="sonar"):
    root = corpus["root"]
    return [str(root / "metadata.tsv"), str(out), "--concat_dir", str(root / "cat"),
            "--lang", "en", "--embed_model_type", kind, "--batch_size", "4",
            "--upload_precision", upload, "--window_assembly", assembly]


def _small(model):
    if hasattr(model, "BUCKETS"):  # SpeechLASER, in samples
        model.BUCKETS = (16000, 32000, 80000)
    else:
        model.BUCKET_FRAMES = (100, 250, 700)
    model.WAVE_BUCKETS_S = (30,)
    return model


@pytest.fixture
def patched_loaders(corpus, monkeypatch):
    def jbuild(embed_model_type, *args, **kwargs):
        upload = kwargs.get("upload_precision", args[7] if len(args) > 7 else "int16")
        if embed_model_type == "speech_laser":
            return _small(jlaser.SpeechLaserModel(
                jlaser.LaserEncoderConfig(**LASER_SMALL), ckpt_path=corpus["laser_npz"],
                max_tokens=64000, upload_dtype=upload))
        return _small(jsonar.SonarSpeechModel(
            jsonar.SonarEncoderConfig(**SMALL, dtype="float32", attention_backend="xla"),
            ckpt_path=corpus["npz"], batch_size=4, upload_dtype=upload))

    def tbuild(embed_model_type, *args, **kwargs):
        upload = kwargs.get("upload_precision", args[7] if len(args) > 7 else "int16")
        if embed_model_type == "speech_laser":
            return _small(tlaser.SpeechLaserModel(
                tlaser.LaserEncoderConfig(**LASER_SMALL), ckpt_path=corpus["laser_npz"],
                max_tokens=64000, upload_dtype=upload, device="cpu"))
        return _small(tsonar.SonarSpeechModel(
            tsonar.SonarEncoderConfig(**SMALL, dtype="float32"),
            ckpt_path=corpus["npz"], batch_size=4, upload_dtype=upload, device="cpu"))

    monkeypatch.setattr(jemu, "_build_embed_model", jbuild)
    monkeypatch.setattr(temu, "_build_embed_model", tbuild)
    jemu._model_memo.clear()
    temu._model_memo.clear()
    yield
    jemu._model_memo.clear()
    temu._model_memo.clear()


def _rows(path, dim=128):
    return np.fromfile(path, dtype=np.float16).reshape(-1, dim).astype(np.float32)


@pytest.mark.parametrize("upload", ["fp32", "int16"])
@pytest.mark.parametrize("assembly", ["device", "host"])
def test_cli_matches_jax_cli(corpus, patched_loaders, tmp_path, monkeypatch, upload, assembly):
    tembed.main(_argv(corpus, tmp_path / "torch", upload, assembly) + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["embed"] + _argv(corpus, tmp_path / "jax", upload, assembly))
    jembed.main()

    got_path = tmp_path / "torch" / "en" / f"{STEM}.embed"
    got, want = _rows(got_path), _rows(tmp_path / "jax" / "en" / f"{STEM}.embed")
    assert got.shape == (corpus["n_rows"], 128) and np.isfinite(got).all()
    assert not list((tmp_path / "torch" / "en").glob("*.tmp.embed"))  # atomic rename
    np.testing.assert_allclose(got, want, rtol=0, atol=FP16_ATOL)

    # skip-existing: a second run leaves the file alone
    mtime = got_path.stat().st_mtime_ns
    tembed.main(_argv(corpus, tmp_path / "torch", upload, assembly) + ["--device", "cpu"])
    assert got_path.stat().st_mtime_ns == mtime


def test_cli_fp32_rows_and_sharding(corpus, patched_loaders, tmp_path):
    """--embed_fp32 writes fp32 rows; shard 0 of 2 of a one-file list is
    empty (round(0.5) == 0) and raises, as the JAX helper asserts."""
    tembed.main(_argv(corpus, tmp_path, "fp32", "device") + ["--device", "cpu", "--embed_fp32"])
    rows = np.fromfile(tmp_path / "en" / f"{STEM}.embed", dtype=np.float32).reshape(-1, 128)
    assert rows.shape[0] == corpus["n_rows"] and np.isfinite(rows).all()
    with pytest.raises(ValueError, match="empty shard"):
        tembed.main(_argv(corpus, tmp_path / "s", "fp32", "device")
                    + ["--device", "cpu", "--n_shard", "2", "--rank", "0"])


def test_default_device_raises_without_card(corpus, tmp_path, monkeypatch):
    """No --device on a machine without CUDA raises: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tembed.main(_argv(corpus, tmp_path, "int16", "device"))


@pytest.mark.parametrize("upload", ["fp32", "int16"])
@pytest.mark.parametrize("assembly", ["device", "host"])
def test_laser_cli_matches_jax_cli(corpus, patched_loaders, tmp_path, monkeypatch, upload,
                                   assembly):
    """SpeechLASER writes a stopes .npy of fp16 rows, one per window line,
    within one fp16 step of the JAX CLI's at the rows' magnitude."""
    argv = lambda out: _argv(corpus, out, upload, assembly, kind="speech_laser")
    tembed.main(argv(tmp_path / "torch") + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["embed"] + argv(tmp_path / "jax"))
    jembed.main()

    got_path = tmp_path / "torch" / "en" / f"{STEM}.embed"
    assert got_path.read_bytes()[:6] == b"\x93NUMPY"
    got = np.load(got_path)
    want = np.load(tmp_path / "jax" / "en" / f"{STEM}.embed")
    assert got.dtype == want.dtype == np.float16
    assert got.shape == (corpus["n_rows"], 128) and np.isfinite(got).all()
    assert not list((tmp_path / "torch" / "en").glob("*.tmp.embed"))
    step = float(np.spacing(np.float16(np.abs(want).max())))
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0,
                               atol=step)


def test_laser_is_the_default_and_raises_without_card(corpus, tmp_path, monkeypatch):
    """With no --embed_model_type the stage runs SpeechLASER; with no
    --device on a machine without CUDA it raises."""
    argv = _argv(corpus, tmp_path, "int16", "device")
    i = argv.index("--embed_model_type")
    del argv[i:i + 2]
    assert tembed.parse_args(argv).embed_model_type == "speech_laser"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tembed.main(argv)


def test_laser_fp32_rows(corpus, patched_loaders, tmp_path):
    """--embed_fp32 writes a .npy of fp32 rows."""
    tembed.main(_argv(corpus, tmp_path, "fp32", "device", kind="speech_laser")
                + ["--device", "cpu", "--embed_fp32"])
    rows = np.load(tmp_path / "en" / f"{STEM}.embed")
    assert rows.dtype == np.float32 and rows.shape == (corpus["n_rows"], 128)


# --- WAV IO ----------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_reader_equals_native(tmp_path, channels):
    """The port's reader equals the JAX package's native reader bit for
    bit, whole and with start/stop, mono and stereo; the writers write the
    same bytes (clipping and truncation included)."""
    rng = np.random.default_rng(channels)
    wav = (rng.standard_normal((9000, channels)) * 0.5).astype(np.float32)
    wav[:5] = [[1.7] * channels, [-1.3] * channels, [1.0] * channels, [-1.0] * channels,
               [0.99999] * channels]
    if channels == 1:
        wav = wav[:, 0]
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    taudio.write(str(ours), wav, 16000)
    jaudio.write(str(theirs), wav, 16000)
    assert ours.read_bytes() == theirs.read_bytes()
    assert taudio.info(str(ours)) == jaudio.info(str(ours))
    for start, stop in [(0, None), (1234, 5678), (8000, 20000), (9500, None)]:
        got, sr = taudio.read(str(ours), start=start, stop=stop)
        want, jsr = jaudio.read(str(ours), start=start, stop=stop)
        assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ogg_raises_naming_roadmap(tmp_path, monkeypatch):
    """.ogg is read through the port's own libvorbis binding; where the
    system's Vorbis libraries are missing, it raises and names them (no
    other format stands in), and a missing file raises."""
    with pytest.raises(IOError):
        taudio.read(str(tmp_path / "x.ogg"))
    monkeypatch.setattr(taudio, "VORBIS_LIBS", ("libvorbisfile-missing.so.3",))
    monkeypatch.setattr(taudio, "_ogg_lib", None)
    monkeypatch.setattr(taudio, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="libvorbisfile-missing.so.3"):
        taudio.write(str(tmp_path / "y.ogg"), np.zeros(100, np.float32), 16000)
    assert not (tmp_path / "y.ogg").exists()
