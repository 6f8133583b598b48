"""The ASR cell's files on the CPU: the counts by hand, the traffic's
clips and windows, a whole ASR run at a tiny width (the harness's
weights, window and check; at float32 the reference must agree with the
program to rounding) and its fault; on a card, the cell's control and
its fault."""

import copy
import math

import numpy as np
import pytest

from bench_port import harness, run
from bench_port.counts import whisper_counts
from bench_port.drivers import asr_stage
from bench_port.gen import plenary
from bench_port.reference import common
from bench_port.reference import whisper as ref

WHISPER_TINY = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                    n_text_state=64, n_text_head=4, n_text_layer=2, compute_dtype="float32")


def tiny_asr_cell(doc_seconds=150, clips_per_side=12, batch=8):
    cell = copy.deepcopy(harness.load_cell("whisper.asr_clips"))
    cell["config_data"].update(WHISPER_TINY)
    cell["traffic_data"].update(doc_seconds=doc_seconds, clips_per_side=clips_per_side)
    cell["asr_options"]["batch"] = batch
    cell["device"] = "cpu"
    return cell


def test_whisper_counts_by_hand():
    cfg = harness.load_cell("whisper.asr_clips")["config_data"]
    t, d, m, L, V = 1500, 1280, 128, 32, 51866
    # convs: 3000 frames x 128 mels x 3 taps -> 1280, then 1500 x 1280 x 3 -> 1280
    convs = 2 * 3000 * m * 3 * d + 2 * t * d * 3 * d
    # a layer: q, k, v, out (4 d^2) and the MLP (8 d^2) a position, scores and
    # weighted values (2 T^2 d each)
    layer = 2 * t * (4 * d * d + 8 * d * d) + 2 * 2 * t * t * d
    assert whisper_counts.encoder_flops(cfg) == convs + L * layer
    assert abs(whisper_counts.encoder_flops(cfg) / 1e12 - 2.2738) < 1e-3
    assert whisper_counts.cross_kv_flops(cfg) == L * 2 * 2 * t * d * d
    # one step, 64 live rows at 40 positions: the weights once (self 4 d^2 +
    # cross 2 d^2 + MLP 8 d^2 bf16 with biases, three fp32 LayerNorms a
    # layer, the final LayerNorm, the token table) and each row's K/V
    weights = L * (2 * (14 * d * d + (4 + 3 + 4) * d) + 4 * 3 * 2 * d) + 4 * 2 * d + 2 * V * d
    assert whisper_counts.decoder_step_weight_bytes(cfg) == weights
    row = L * 2 * 2 * d * (t + 40 + 1) + 4 * V
    assert whisper_counts.decode_step_bytes(cfg, 64, 40) == weights + 64 * row
    flops = 64 * (L * (2 * 14 * d * d + 4 * d * (40 + t)) + 2 * V * d)
    assert whisper_counts.decode_step_flops(cfg, 64, 40) == flops
    assert whisper_counts.decode_step_bound_s(cfg, 64, 40) == (weights + 64 * row) / 3.35e12
    assert whisper_counts.batch_steps([3, 1, 2]) == [(2, 5), (1, 6)]


def test_audit_clips_follow_the_seed(tmp_path):
    """Every run seed transcribes the same clips with the same budgets (the
    order comes from the traffic's order_seed); the seed draws the audio."""
    cell = tiny_asr_cell(doc_seconds=120)
    traffic = cell["traffic_data"]
    a, b, c = (asr_stage.sides_of(plenary.write_documents(tmp_path / n, traffic, s, "cpu"), s)
               for n, s in (("a", 2**31 + 5), ("b", 2**31 + 5), ("c", 2**31 + 6)))
    oa, oc = asr_stage.clip_orders(a, traffic), asr_stage.clip_orders(c, traffic)
    assert [d.windows for d in a] == [d.windows for d in c] and oa == oc
    assert all(x.wav.read_bytes() == y.wav.read_bytes() for x, y in zip(a, b))
    assert all(x.wav.read_bytes() != y.wav.read_bytes() for x, y in zip(a, c))
    assert asr_stage.make_call(a, oa, traffic, 1, 7)[:2] == asr_stage.make_call(c, oc, traffic,
                                                                                1, 9)[:2]
    # the sides are the structures, whatever slot the seed gave each
    hour = harness.load_cell("whisper.asr_clips")["traffic_data"]
    for seed, docs in ((2**31 + 5, a), (2**31 + 6, c)):
        segs = plenary.vad_segments(np.random.default_rng(hour["structure_seeds"][0]), 120,
                                    hour["segment_s"], hour["gap_s"])
        assert docs[0].segments == segs
    other = asr_stage.clip_orders(a, dict(traffic, order_seed=traffic["order_seed"] + 1))
    assert other != oa
    for doc, order in zip(a, oa):
        lens = [(doc.windows[i][1] - doc.windows[i][0]) / 16000 for i in order]
        assert min(lens) >= 1.0 and max(lens) <= 18.5
        assert len(order) == sum(e - s >= 16000 for s, e in doc.windows)
    clips, budgets, keep = asr_stage.make_call(a, oa, traffic, 0, 3)
    assert len(clips) == 2 * traffic["clips_per_side"]
    assert [s for s, _ in clips] == [0] * 12 + [1] * 12
    for (side, i), bud in zip(clips, budgets):
        s, e = a[side].windows[i]
        assert bud == math.ceil(4 * (e - s) / 16000)
    assert len(keep) == 8 and sorted({k % 8 for k in keep}) == list(range(8))
    assert int(np.argmax(budgets)) in keep
    assert asr_stage.make_call(a, oa, traffic, 0, 4)[2] != keep


def test_whisper_config_matches_the_published_widths():
    cell = harness.load_cell("whisper.asr_clips")
    cfg = cell["config_data"]
    assert cfg["name"] == cell["config"] and cfg["compute_dtype"] == "bfloat16"
    assert (cfg["n_audio_layer"], cfg["n_text_layer"], cfg["n_audio_state"], cfg["n_mels"],
            cfg["n_vocab"], cfg["n_audio_head"], cfg["ffn_dim"]) == (32, 32, 1280, 128, 51866,
                                                                    20, 5120)
    # the spec is the program's state_dict, 1.55 B parameters
    n = sum(int(np.prod(shape)) for _, shape, _, _ in ref.param_spec(cfg))
    assert abs(n / 1e9 - 1.55) < 0.02
    assert cell["asr_options"]["batch"] == 64 and cell["traffic_data"]["clips_per_side"] == 256


def test_tiny_asr_run_agrees_with_reference():
    cell = tiny_asr_cell()
    correct, record, metrics = run.run_cell(cell, 2**31 + 11, 0.01, False, 0.0,
                                            require_card=False)
    checks = {c.name: c.value for c in record.checks}
    assert correct, record.checks
    assert checks["clips_with_bad_tokens"] == 0 and checks["logit_rel_gap_max"] < 1e-4
    assert record.attempted == 24 and record.failed == 0
    assert set(metrics) == {"embed_audio_s_per_s", "peak_mem_gib", "setup_s"}
    # every clip decoded its budget: 4 + ceil(4 tokens a second x its length)
    call = record.items[0]
    assert [len(t.prompt) + len(t.tokens) for t in call["transcripts"]] == [
        4 + b for b in call["budgets"]]


def test_tiny_asr_run_fails_when_cross_kv_is_broken():
    cell = tiny_asr_cell()
    correct, record, _ = run.run_cell(cell, 5, 0.01, False, 0.0, faults=("cross_kv_altered",),
                                      require_card=False)
    assert not correct, record.checks
    gap = {c.name: c.value for c in record.checks}["logit_rel_gap_max"]
    assert gap > 0.05


def test_tiny_control_reads_above_the_program(tmp_path):
    cell = tiny_asr_cell(doc_seconds=60, clips_per_side=8)
    assert asr_stage.control(cell, 3, tmp_path, n_clips=2) > 1e-3


@pytest.mark.card
def test_whisper_control_fails_the_limit(card, tmp_path):
    """The reference in fp8 products against float32 at the cell's widths;
    the printed numbers set the limit."""
    cell = harness.load_cell("whisper.asr_clips")
    got = [asr_stage.control(cell, s, tmp_path / str(s)) for s in (11, 2**31 + 7)]
    print("whisper.asr_clips control logit_rel_gap_max", got)
    assert min(got) > cell["check"]["logit_rel_gap_max"]


def test_reference_weights_follow_the_spec():
    cfg = dict(harness.load_cell("whisper.asr_clips")["config_data"], **WHISPER_TINY)
    w = common.make_weights(ref.param_spec(cfg), 3, "cpu")
    assert w["encoder.conv1.weight"].shape == (64, 80, 3)
    assert "encoder.blocks.0.attn.key.bias" not in w
    assert w["decoder.token_embedding.weight"].shape == (51866, 64)


@pytest.mark.card
def test_whisper_run_fails_when_cross_kv_is_broken(card):
    """Every eighth row's cross-attention K/V altered, at the cell's widths:
    the kept clips at each row position modulo 8 catch it."""
    correct, record, _ = run.run_cell("whisper.asr_clips", 2**31 + 99, 5, False, 0.0,
                                      faults=("cross_kv_altered",))
    gap = {c.name: c.value for c in record.checks}["logit_rel_gap_max"]
    print("whisper.asr_clips cross_kv_altered logit_rel_gap_max", gap)
    assert not correct
