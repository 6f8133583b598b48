"""The port's training CLI (svecalign_tpu_torch.train --device cpu)
against the JAX CLI (svecalign_tpu.train) on a tiny mined tsv over
synthetic WAV files: the same batches from the same tsv and seed, both
started from one ``--init_ckpt``, and the written ``encoder_final.npz``
files within the training tests' bounds; then a second run in the same
output directory resumes as the JAX CLI's does (parameters from the
newest checkpoint, a fresh optimizer, the batcher from its first draw).

Bounds, with both encoders in fp32: parameters within 2 lr a step (and 4
ulp of their own rounding) of JAX's (Adam moves a parameter by about lr sign(g), and a gradient near
zero may take either sign), and at least 99% of them within 1e-5; the
losses JAX logs (4 decimals) equal the port's to that rounding. At the
CLIs' default bf16 compute, one step: the loss within 3e-2 relative,
parameters within 2 lr.
"""

import functools
import logging
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu import train as jtrain
from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu_torch import train as ttrain
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import param_utils as tparams
from svecalign_tpu_torch.utils import audio_io

torch.set_num_threads(2)

SR = 16000
N_FILES = 3
N_ROWS = 16
LR = 1e-4
TINY = ["--encoder_layers", "2", "--encoder_dim", "64", "--max_seconds", "0.25",
        "--batch_size", "8", "--lr", str(LR)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A mined tsv of N_ROWS pairs (spans of 0.1-0.4 s, some longer than
    --max_seconds, some shorter) over 2 s WAV files, and one init npz."""
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    files = []
    for k in range(N_FILES):
        for side in ("src", "tgt"):
            path = root / f"{side}{k}.wav"
            audio_io.write(str(path), (0.3 * rng.standard_normal(2 * SR)).astype(np.float32), SR)
            files.append(str(path))
    lines = []
    for r in range(N_ROWS):
        k = r % N_FILES
        fields = [f"{1.0 + 0.01 * r:.4f}"]
        for side in range(2):
            ln = int(rng.integers(SR // 10, 4 * SR // 10))
            start = int(rng.integers(0, 2 * SR - ln))
            fields.append(f"{files[2 * k + side]} {start} {start + ln} 16")
        lines.append("\t".join(fields) + "\n")
    tsv = root / "align.tsv"
    tsv.write_text("".join(lines))

    cfg = jlaser.LaserEncoderConfig(encoder_layers=2, encoder_dim=64)
    params = jparams.numpy_init(jlaser.LaserSpeechEncoder(cfg),
                                (jnp.zeros((1, 4000), jnp.float32), jnp.array([4000])), seed=1)
    init = root / "init.npz"
    jparams.save_params_npz(params, str(init))
    return {"root": root, "tsv": str(tsv), "init": str(init)}


def test_rows_and_batches_bit_equal(corpus):
    rows = ttrain.load_rows(corpus["tsv"], 1.05)
    assert rows == jtrain.load_rows(corpus["tsv"], 1.05) and len(rows) == N_ROWS - 5
    n = int(0.25 * SR)
    got, want = ttrain.ClipBatcher(rows, 4, n, 7), jtrain.ClipBatcher(rows, 4, n, 7)
    for _ in range(5):
        g, w = got.next_batch(), want.next_batch()
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="at least 2"):
        ttrain.ClipBatcher(rows[:1], 1, n, 0)


def _run_jax(argv, monkeypatch, caplog):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with caplog.at_level(logging.INFO):
        jtrain.main()
    return {int(r.getMessage().split()[1][:-1]): float(r.getMessage().split()[-1])
            for r in caplog.records if r.getMessage().startswith("step ")}


def _assert_close(got_npz, want_npz, n_steps, share_1e5=0.99):
    got, want = tparams.load_params_npz(got_npz), tparams.load_params_npz(want_npz)
    assert got.keys() == want.keys()
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    # 2 lr a step, and the rounding of the parameters themselves (4 ulp)
    ulps = np.concatenate([4 * np.spacing(np.abs(want[k])).ravel() for k in want])
    assert (diffs <= 2 * LR * n_steps + ulps).all(), diffs.max()
    assert (diffs <= 1e-5).mean() >= share_1e5, (diffs <= 1e-5).mean()


def _assert_logged(jax_logged, port_losses, start, rtol=0.0):
    assert jax_logged
    for step, loss in jax_logged.items():
        assert abs(port_losses[step - start] - loss) <= 5.1e-5 + rtol * abs(loss), (step, loss)


def _fp32(monkeypatch):
    """Both CLIs' encoders in fp32 compute (their default is bf16)."""
    for mod in (jlaser, tlaser):
        monkeypatch.setattr(mod, "LaserEncoderConfig",
                            functools.partial(mod.LaserEncoderConfig, dtype="float32"))


def test_cli_matches_jax_cli_and_resumes(corpus, tmp_path, monkeypatch, caplog):
    """fp32: 3 steps with a checkpoint at 3, then a second run in the same
    directories to step 5 (resumed at 3), each against the JAX CLI."""
    _fp32(monkeypatch)
    out, jout = tmp_path / "port_out", tmp_path / "jax_out"
    args = ["--steps", "3", "--save_every", "3", "--init_ckpt", corpus["init"], *TINY]
    res = ttrain.main([corpus["tsv"], str(out), *args, "--device", "cpu"])
    assert res["start_step"] == 0 and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert (out / "ckpt" / "3" / ttrain.CKPT_FILE).exists()
    _assert_logged(_run_jax([corpus["tsv"], str(jout), *args], monkeypatch, caplog),
                   res["losses"], 0)
    _assert_close(res["final"], str(jout / "encoder_final.npz"), 3)

    more = ["--steps", "5"]
    res2 = ttrain.main([corpus["tsv"], str(out), *args, *more, "--device", "cpu"])
    assert res2["start_step"] == 3 and len(res2["losses"]) == 2
    caplog.clear()
    _assert_logged(_run_jax([corpus["tsv"], str(jout), *args, *more], monkeypatch, caplog),
                   res2["losses"], 3)
    _assert_close(res2["final"], str(jout / "encoder_final.npz"), 5)

    # the shared format loads into the port's inference wrapper, every leaf
    model = tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(encoder_layers=2, encoder_dim=64),
                                    ckpt_path=res2["final"], device="cpu")
    assert set(tparams.load_params_npz(res2["final"])) == {
        "/".join(p) for p, *_ in tparams._leaf_map(model.model)}


def test_cli_default_bf16_close_to_jax_cli(corpus, tmp_path, monkeypatch, caplog):
    """The CLIs' default bf16 compute, one step: the loss within bf16's
    3e-2, parameters within 2 lr (bf16 moves more gradients near zero
    across sign; at this width a step moves the loss by ~20%, so later
    losses are held in fp32 only)."""
    args = ["--steps", "1", "--init_ckpt", corpus["init"], *TINY]
    res = ttrain.main([corpus["tsv"], str(tmp_path / "port"), *args, "--device", "cpu"])
    assert all(np.isfinite(res["losses"]))
    _assert_logged(_run_jax([corpus["tsv"], str(tmp_path / "jax"), *args], monkeypatch, caplog),
                   res["losses"], 0, rtol=3e-2)
    _assert_close(res["final"], str(tmp_path / "jax" / "encoder_final.npz"), 1, share_1e5=0.0)


def test_foreign_checkpoint_and_no_card(corpus, tmp_path, monkeypatch):
    (tmp_path / "ckpt" / "7").mkdir(parents=True)
    with pytest.raises(ValueError, match="holds no params.pt"):
        ttrain.main([corpus["tsv"], str(tmp_path), *TINY, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main([corpus["tsv"], str(tmp_path / "x"), *TINY])


def test_phase_train_rehearsal(tmp_path):
    """chip_smoke.phase_train on the CPU at a tiny size: the gate (the
    "card" is the CPU here), the CLI, the fixed-batch steps lowering the
    loss, the two-shard mesh."""
    import chip_smoke

    tiny = ["--encoder_layers", "2", "--encoder_dim", "64", "--max_seconds", "0.5",
            "--batch_size", "4"]
    out = chip_smoke.phase_train(
        tmp_path, "cpu", gate={"encoder_layers": 1, "encoder_dim": 64, "dtype": "float32"},
        gate_batch=(2, 0.5), cli_args=tiny,
        full=tlaser.LaserEncoderConfig(encoder_layers=2, encoder_dim=64), fixed_batch=(4, 0.5),
        fixed_steps=3, tp_steps=2, pairs=8)
    assert len(out["cli_losses"]) == chip_smoke.TRAIN_CLI_STEPS
    losses = out["fixed_losses"]
    assert np.mean(losses[len(losses) // 2:]) < losses[0]
    assert set(out["splits"]["one device"]) == {"forward", "backward", "optimizer", "wall"}
    assert set(out["splits"]["two model shards"]) == {"forward", "tp_reduce", "backward",
                                                      "optimizer", "wall"}
