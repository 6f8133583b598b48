"""``chip_smoke.py``'s stage-5.3 LASER phase and post-align chain
(5.1 -> 5.3 -> 5.2 -> 5.4 -> 6.1 -> 6.3 -> 6.4 -> 6.5 -> 6.6 ... 6.10),
and its pipeline phase (11), rehearsed on the CPU: the same phase
functions at a tiny width on a 2-minute document (the pipeline: two pairs
of 40 s a side, documents of 60 s), so that their control flow,
file layout and checks run before the card sees them. The encoders are
2-layer, 128-wide (LASER keeps the full conv geometry: 400-sample frames
every 320); the rel-key "kernel" is its plain version, counted as a
launch, since the CUDA kernel runs only on the card, and so is each
LayerNorm call. Also the smoke's operation count.
"""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.models import w2v_bert
from svecalign_tpu_torch.ops import attention, attention_cuda, layer_norm_cuda
from svecalign_tpu_torch.utils import embed_model_utils as temu

torch.set_num_threads(2)

LASER_TINY = tlaser.LaserEncoderConfig(
    conv_layers=tuple((32, k, s) for _, k, s in tlaser.LaserEncoderConfig().conv_layers),
    encoder_dim=128, encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256,
    conv_pos_kernel=16, conv_pos_groups=4)
SONAR_TINY = tsonar.SonarEncoderConfig(model_dim=128, n_layers=2, n_heads=2, ffn_dim=256,
                                       pool_dim=1024)


@pytest.fixture
def tiny_card(monkeypatch):
    """Tiny encoders from the loaders; the plain rel-key attention and
    each LayerNorm call counted as a kernel launch; no device to
    synchronise."""
    build = temu._build_embed_model

    def tiny(*args, **kwargs):
        p = inspect.signature(build).bind(*args, **kwargs)
        p.apply_defaults()
        p = p.arguments
        if p["embed_model_type"] == "speech_laser":
            return tlaser.SpeechLaserModel(LASER_TINY, max_tokens=p["max_tokens"],
                                           upload_dtype=p["upload_precision"],
                                           device=p["device"], mesh=p["mesh"])
        return tsonar.SonarSpeechModel(SONAR_TINY, batch_size=4,
                                       upload_dtype=p["upload_precision"], device=p["device"],
                                       mesh=p["mesh"])

    def plain_kernel(q, k, v, table, lengths=None, left=64, right=8):
        attention_cuda.LAUNCHES["relkey_attention"] += 1
        return attention.relkey_attention(q, k, v, table, lengths, left, right)

    monkeypatch.setattr(temu, "_build_embed_model", tiny)
    monkeypatch.setattr(w2v_bert._SelfAttention, "_use_kernel",
                        lambda self, x: self.attention_backend == "auto")
    monkeypatch.setattr(attention_cuda, "relkey_attention_cuda", plain_kernel)
    norm_forward = w2v_bert.FlaxLayerNorm.forward

    def counted_norm(self, x, *args, **kwargs):
        layer_norm_cuda.LAUNCHES["layer_norm"] += 1
        return norm_forward(self, x, *args, **kwargs)

    monkeypatch.setattr(w2v_bert.FlaxLayerNorm, "forward", counted_norm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "DOC_SECONDS", 120)
    temu._model_memo.clear()
    yield
    temu._model_memo.clear()


def test_laser_phase_and_chain_rehearsal(tiny_card, tmp_path, capsys):
    device = torch.device("cpu")
    laser = cs.phase_laser_path(tmp_path, device)
    result = cs.phase_chain(tmp_path, device, laser)
    out = capsys.readouterr().out
    assert "[laser] --upload_precision fp32" in out and "(bit-equal)" in out
    assert f"[laser] layer_norm launches {laser['norm_launches']} over" in out
    assert laser["norm_launches"] > 0
    assert "stage 6.3 (--max_num_align 3 --max_sil 1.0 --max_dur 20.0" in out
    assert out.count("stage 6.5") == 4
    # the chain starts from the stage-5.1 windows and stage 5.2, and ends in the mined tsv
    assert "[chain] stage 5.2 on a stage-4.2 output" in out
    assert "[chain] mined tsv:" in out and "6.10 sorted them by margin" in out
    assert set(result) == {(label, kind) for label, _ in cs.CHAIN_TRAFFIC
                           for kind in ("speech_laser", "sonar")}
    # the coverage chains are no concat window: stage 6.5 embeds them, and
    # the SONAR run goes through the (counted) rel-key kernel
    for kind in ("speech_laser", "sonar"):
        _, hits, misses, chunks = result["coverage", kind]
        assert misses > 0 and sum(chunks.values()) > 0


def test_laser_row_flops_at_full_width():
    """~38 GFLOP per second of padded audio at the 8-s bucket: trunk dense
    30.2, extractor 4.9, attention 2.0, projection + positional conv 0.9."""
    parts = cs.laser_row_flops(tlaser.LaserEncoderConfig(), 8 * 16000)
    per_s = {k: v / 8 / 1e9 for k, v in parts.items()}
    np.testing.assert_allclose(per_s["trunk dense"], 30.2, rtol=0.01)
    np.testing.assert_allclose(per_s["extractor"], 4.9, rtol=0.03)
    np.testing.assert_allclose(per_s["attention"], 2.0, rtol=0.03)
    np.testing.assert_allclose(per_s["projection + positional conv"], 0.89, rtol=0.03)


def test_pipeline_phase_rehearsal(tiny_card, tmp_path, capsys, monkeypatch):
    """Phase 11 end to end on the CPU: both LASER runs, the tree
    comparison, the cache stats and upload bytes, stage 5.4 in a process of
    its own, the mined-duplicate gate and the SONAR run's launch count."""
    monkeypatch.setattr(cs, "DOC_SECONDS", 60)
    # chunks of 40 s of samples, not the pipeline's 600 s: on 40 s documents
    # those would be nearly all padding rows
    tiny = temu._build_embed_model

    def capped(*args, **kwargs):
        p = inspect.signature(temu.load_embed_model).bind(*args, **kwargs)
        p.apply_defaults()
        p.arguments["max_tokens"] = min(p.arguments["max_tokens"], 40 * 16000)
        return tiny(**p.arguments)

    monkeypatch.setattr(temu, "_build_embed_model", capped)
    res = cs.phase_pipeline(tmp_path, torch.device("cpu"), seconds=40, n_planted=2)
    out = capsys.readouterr().out
    assert "[pipeline] fused against unfused:" in out and "'miss': 0" in out
    assert "(the id maps alone)" in out and "files identical" in out
    assert "[time] stage 5.4 in the fused pipeline:" in out and "2 pairs from the cache" in out
    assert "no row pairs a planted copy with its source" in out
    assert out.count("[pipeline] device memory,") == 3
    assert res["sonar"] > 0 and len(res["plan"]) == 1
