"""A whole embed run on the CPU at a tiny size: the stage-5.3 CLI with
2-layer encoders of the same layout (the program's model builder patched,
as the port's own tests do), the harness's weights, window and check. At
float32 the plain references must agree with the program to rounding;
each fault of the timed path must make the run incorrect."""

import copy

import pytest

from bench_port import harness, run

LASER_TINY = dict(conv_layers=[[32, 10, 5], [32, 3, 2], [32, 3, 2], [32, 3, 2], [32, 3, 2],
                               [32, 2, 2], [32, 2, 2]],
                  encoder_dim=64, encoder_layers=2, encoder_heads=4, encoder_ffn_dim=128,
                  conv_pos_kernel=16, conv_pos_groups=4, compute_dtype="float32")
SONAR_TINY = dict(model_dim=64, n_layers=2, n_heads=4, ffn_dim=128, pool_dim=64,
                  compute_dtype="float32")


def tiny_cell(name, overrides, doc_seconds=40):
    cell = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["config_data"].update(overrides)
    cell["traffic_data"]["doc_seconds"] = doc_seconds
    cell["check"]["sample_windows"] = 24
    cell["device"] = "cpu"
    if "--max_tokens" in cell["stage_args"]:  # chunks of a few rows, as full as the real ones
        cell["stage_args"] = ["--max_tokens", "640000"]
    return cell


@pytest.fixture
def tiny_models(monkeypatch):
    from svecalign_tpu_torch.models import laser_encoder, sonar_encoder
    from svecalign_tpu_torch.utils import embed_model_utils

    def build(kind, sl_ckpt_dir, sl_ckpt_name, max_tokens, sonar_name, sonar_fp16,
              compile_sonar, batch_size, upload_precision, device, mesh):
        if kind == "speech_laser":
            c = dict(LASER_TINY)
            cfg = laser_encoder.LaserEncoderConfig(
                conv_layers=tuple(tuple(x) for x in c["conv_layers"]),
                encoder_dim=c["encoder_dim"], encoder_layers=c["encoder_layers"],
                encoder_heads=c["encoder_heads"], encoder_ffn_dim=c["encoder_ffn_dim"],
                conv_pos_kernel=c["conv_pos_kernel"], conv_pos_groups=c["conv_pos_groups"],
                dtype="float32")
            return laser_encoder.SpeechLaserModel(cfg, max_tokens=max_tokens,
                                                  upload_dtype=upload_precision, device=device)
        cfg = sonar_encoder.SonarEncoderConfig(
            model_dim=64, n_layers=2, n_heads=4, ffn_dim=128, pool_dim=64, dtype="float32")
        return sonar_encoder.SonarSpeechModel(cfg, batch_size=batch_size,
                                              upload_dtype=upload_precision, device=device)

    monkeypatch.setattr(embed_model_utils, "_build_embed_model", build)
    monkeypatch.setattr(embed_model_utils, "_model_memo", {})


@pytest.mark.parametrize("name,overrides", [("laser.embed_plenary", LASER_TINY),
                                            ("sonar.embed_plenary", SONAR_TINY)])
def test_tiny_run_agrees_with_reference(tiny_models, name, overrides):
    cell = tiny_cell(name, overrides)
    correct, record, metrics = run.run_cell(cell, 2**31 + 11, 0.01, False, 0.0,
                                            require_card=False)
    gap = {c.name: c.value for c in record.checks}["row_rel_gap_max"]
    assert correct, record.checks
    assert gap < 1e-3, gap
    assert record.attempted == 1 and record.failed == 0
    assert set(metrics) == {"embed_audio_s_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["row_altered", "half_batch"])
def test_tiny_run_fails_when_broken(tiny_models, fault):
    cell = tiny_cell("laser.embed_plenary", LASER_TINY)
    correct, record, _ = run.run_cell(cell, 5, 0.01, False, 0.0, faults=(fault,),
                                      require_card=False)
    assert not correct, record.checks


def test_tiny_control_reads_above_the_program(tiny_models, tmp_path):
    """The fp8 control departs from the float32 reference by far more than
    the program at float32 does."""
    from bench_port.drivers import embed_stage

    cell = tiny_cell("laser.embed_plenary", LASER_TINY)
    gap = embed_stage.control(cell, 2**31 + 11, tmp_path)
    assert gap > 1e-2, gap
