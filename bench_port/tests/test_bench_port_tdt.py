"""The Parakeet-TDT cell's files on the CPU: the counts by hand, the
harness's weights and warm-up, a whole run at a tiny width (the harness's
weights, window and check; at float32 the reference must agree with the
program to rounding) and its fault; on a card, the cell's control and its
fault at the cell's widths (``python3 -m pytest
bench_port/tests/test_bench_port_tdt.py -m card -s``)."""

import copy

import numpy as np
import pytest

from bench_port import harness, run
from bench_port.counts import parakeet_counts
from bench_port.drivers import asr_stage, tdt_stage
from bench_port.gen import plenary
from bench_port.reference import parakeet_tdt as ref

TINY = dict(n_mels=32, d_model=64, n_layers=2, n_heads=4, head_dim=16, ff_dim=128,
            subsampling_channels=16, vocab_size=40, pred_hidden=32, joint_hidden=32,
            compute_dtype="float32")
CONTROL_SEEDS = (2147483901, 2147483902, 2147483903)


def tiny_tdt_cell(doc_seconds=150, clips_per_side=12, batch=8):
    cell = copy.deepcopy(harness.load_cell("parakeet.asr_clips"))
    cell["config_data"].update(TINY)
    cell["config_data"]["emission"]["frame_units"] = 8  # of the tiny joint's 32
    cell["traffic_data"].update(doc_seconds=doc_seconds, clips_per_side=clips_per_side)
    cell["asr_options"]["batch"] = batch
    cell["device"] = "cpu"
    return cell


def test_parakeet_counts_by_hand():
    cfg = harness.load_cell("parakeet.asr_clips")["config_data"]
    n = 16000 * 10 + 123  # 10 s: 1000 mel frames, 500, 250, 125 after the strides
    assert parakeet_counts.valid_frames(cfg, n) == (1000, 125)
    c, d, t, ff, k = 256, 1024, 125, 4096, 9
    stem = (2 * 9 * c * 500 * 64 + (2 * 9 * c * 250 * 32 + 2 * c * c * 250 * 32)
            + (2 * 9 * c * 125 * 16 + 2 * c * c * 125 * 16) + 2 * c * 16 * d * t)
    # a block: two feed-forwards (8 d ff a frame), q k v out (8 d^2), the conv
    # module's pointwise convs (6 d^2) and depthwise (2 k d), linear_pos over
    # 2t - 1 positions, the content and position scores and the values
    block = (t * (8 * d * ff + 8 * d * d + 6 * d * d + 2 * k * d) + 2 * (2 * t - 1) * d * d
             + 2 * t * t * d + 2 * t * (2 * t - 1) * d + 2 * t * t * d)
    assert parakeet_counts.encoder_flops(cfg, n) == stem + 24 * block + 2 * t * d * 640
    assert abs(parakeet_counts.encoder_flops(cfg, n) / 10 / 1e9 - 16.3) < 0.1
    # an iteration reads the LSTM's [W_ih | W_hh] (bf16) and fp32 biases, the
    # joint's pred (bf16) and out (its fp32 copy) once
    weights = 2 * (2 * 2560 * 1280 + 4 * 2560) + 2 * (640 * 640 + 640) + 4 * (8198 * 640 + 8198)
    assert parakeet_counts.iteration_weight_bytes(cfg) == weights
    assert abs(weights / 1e6 - 34.97) < 0.01
    row = 2 * 8198 * 640 + 2 * 2 * 2560 * 1280 + 2 * 640 * 640
    assert parakeet_counts.iteration_row_flops(cfg) == row
    assert parakeet_counts.loop_bound_s(cfg, 10, 300) == (10 * weights + 300 * 4 * 640) / 3.35e12


def test_config_matches_the_published_widths():
    cell = harness.load_cell("parakeet.asr_clips")
    cfg = cell["config_data"]
    assert cfg["name"] == cell["config"] and cfg["compute_dtype"] == "bfloat16"
    assert (cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["head_dim"], cfg["ff_dim"],
            cfg["conv_kernel"], cfg["subsampling_channels"], cfg["n_mels"], cfg["vocab_size"],
            cfg["pred_hidden"], cfg["pred_layers"], cfg["joint_hidden"]) == (
        24, 1024, 8, 128, 4096, 9, 256, 128, 8192, 640, 2, 640)
    assert cfg["reduced"] == ["weights", "corpus_documents", "emission"]
    n = sum(int(np.prod(shape)) for _, shape, _, _ in ref.param_spec(cfg))
    assert n == cfg["parameters"]
    assert cell["asr_options"]["batch"] == 64 and cell["traffic"] == "audit_clips"


def test_harness_weights_set_the_emission():
    """The harness's weights, then the seed's emission fitted on a few
    clips: the blank and duration rows read the frame units alone, each
    duration wins its share of the fitted frames, and the largest token
    logit passes the blank's at the token share of the fitted points."""
    import torch

    cfg = copy.deepcopy(dict(harness.load_cell("parakeet.asr_clips")["config_data"], **TINY))
    cfg["emission"]["frame_units"] = n = 8
    w = tdt_stage.weights_of(cfg, 3, "cpu")
    v, e = cfg["vocab_size"], cfg["emission"]
    assert not w["decoder.embed.weight"][v].any()
    assert not w["joint.pred.weight"][:n].any() and w["joint.pred.weight"][n:].all()
    assert not w["joint.out.weight"][v:, n:].any() and w["joint.out.weight"][v:, :n].all()
    plain = tdt_stage.common.make_weights(ref.param_spec(cfg), 3, "cpu")
    name = "encoder.layers_1.ffn2.output_dense.weight"
    assert np.allclose(w[name], plain[name] * cfg["residual_scale"])
    assert np.array_equal(w["encoder.layers_1.ffn2.intermediate_dense.weight"],
                          plain["encoder.layers_1.ffn2.intermediate_dense.weight"])

    gen = torch.Generator().manual_seed(0)
    audios = [0.1 * torch.randn(16000 * s, generator=gen) for s in (20, 25, 30)]
    fit = tdt_stage.emission_fit(cfg, w, audios)
    tdt_stage.set_emission(cfg, w, fit)
    assert torch.equal(w["joint.out.weight"][v:], tdt_stage.weights_of(cfg, 3, "cpu", fit)[
        "joint.out.weight"][v:])
    prec = tdt_stage.common.Precision()
    f = torch.cat([ref.frames_projected(cfg, w, a, prec) for a in audios])
    g, _ = ref.pred_step(cfg, w, v, None, prec)
    lg = ref.joint(w, f, g, prec)
    assert abs(lg[:, v + 1:].sub(lg[:, v + 1:].mean(0)).std(0).mean() - e["row_std"]) < 0.05
    shares = torch.bincount(lg[:, v + 1:].argmax(1), minlength=5) / len(lg)
    assert np.allclose(shares, e["duration_shares"], atol=0.02), shares
    emit = (lg[:, :v].max(1).values > lg[:, v]).float().mean()
    assert abs(emit - e["token_share"]) < 0.15  # the start's state of the fit's eight


def test_warm_up_covers_every_bucket_a_batch_can_take(tmp_path):
    """A batch's bucket is its longest clip's: the warm-up has one batch
    for each bucket that a clip of the traffic falls in."""
    from svecalign_tpu_torch.analysis import tdt
    from svecalign_tpu_torch.models import parakeet

    cell = tiny_tdt_cell(doc_seconds=300)
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    docs = asr_stage.sides_of(plenary.write_documents(tmp_path, traffic, 5, "cpu"), 5)
    orders = asr_stage.clip_orders(docs, traffic)
    model = parakeet.build(tdt_stage.model_config(cfg), "cpu")
    tr = tdt.TdtTranscriber(model, batch=8, bucket_s=(4, 8, 12, 30))
    warm = tdt_stage.warm_clips(tr, docs, orders, 8)
    every = {tr.bucket_of(tdt_stage.clip_len(docs, (s, i))) for s, o in enumerate(orders)
             for i in o}
    assert [tr.bucket_of(max(tdt_stage.clip_len(docs, c) for c in b)) for b in warm] == sorted(
        every)
    assert all(len(b) == 8 for b in warm)


def test_tiny_tdt_run_agrees_with_reference():
    cell = tiny_tdt_cell()
    correct, record, metrics = run.run_cell(cell, 2**31 + 11, 0.01, False, 0.0,
                                            require_card=False)
    checks = {c.name: c.value for c in record.checks}
    assert correct, record.checks
    assert checks["clips_with_bad_paths"] == 0 and checks["logit_rel_gap_max"] < 1e-4
    assert record.attempted == 24 and record.failed == 0
    assert set(metrics) == {"embed_audio_s_per_s", "peak_mem_gib", "setup_s"}
    ts = record.items[0]["transcripts"]
    assert sum(len(t.tokens) for t in ts) > 0 and all(t.path is not None for j, t in
                                                      enumerate(ts) if j in record.items[0]["keep"])


def test_bad_paths_are_caught():
    """Each rule of the path check, broken on a copy of a sound call."""
    cell = tiny_tdt_cell()
    _, record, _ = run.run_cell(cell, 7, 0.01, False, 0.0, require_card=False)
    call = record.items[0]
    assert tdt_stage.bad_clips(cell, call) == 0
    kept = call["keep"][0]
    free = next(j for j in range(len(call["transcripts"])) if j not in call["keep"]
                and len(call["transcripts"][j].tokens) > 1)

    def broken(j, **change):
        c = copy.deepcopy(call)
        for k, v in change.items():
            setattr(c["transcripts"][j], k, v(getattr(c["transcripts"][j], k)))
        return tdt_stage.bad_clips(cell, c)

    blank = cell["config_data"]["vocab_size"]
    assert broken(free, frames=lambda f: f[::-1] if f[0] != f[-1] else f[:-1]) == 1
    assert broken(free, tokens=lambda t: [blank] + t[1:]) == 1
    assert broken(free, ends=lambda e: [(e[0][0], e[0][0] - 1)]) == 1
    assert broken(free, frames=lambda f: [f[0]] * len(f) if len(f) > 10 else f + [f[-1]] * 11,
                  tokens=lambda t: t if len(t) > 10 else t + [0] * 11) == 1
    assert broken(kept, logits=lambda lg: lg[:, ::-1].copy()) == 1
    assert broken(kept, path=lambda p: p[:-1]) == 1


def test_tiny_tdt_run_fails_when_frames_are_altered():
    cell = tiny_tdt_cell()
    correct, record, _ = run.run_cell(cell, 5, 0.01, False, 0.0, faults=("frames_altered",),
                                      require_card=False)
    assert not correct, record.checks
    gap = {c.name: c.value for c in record.checks}["logit_rel_gap_max"]
    assert gap > 0.05


def test_tiny_control_reads_above_the_program(tmp_path):
    cell = tiny_tdt_cell(doc_seconds=60, clips_per_side=8)
    assert tdt_stage.control(cell, 3, tmp_path, n_clips=2) > 1e-3


@pytest.mark.card
def test_tdt_control_fails_the_limit(card, tmp_path):
    """The reference in fp8 products against float32 at the cell's widths,
    on three seeds; the printed numbers set the limit."""
    cell = harness.load_cell("parakeet.asr_clips")
    limit = cell["check"]["logit_rel_gap_max"]
    got = [tdt_stage.control(cell, s, tmp_path / str(s)) for s in CONTROL_SEEDS]
    print(f"control parakeet.asr_clips: logit_rel_gap_max {got} against limit {limit}")
    assert min(got) > limit


@pytest.mark.card
def test_tdt_run_fails_when_frames_are_altered(card):
    """Every eighth row's projected frames altered, at the cell's widths:
    the kept clips at each row position modulo 8 catch it."""
    correct, record, _ = run.run_cell("parakeet.asr_clips", 2147483911, 1.0, False, 0.0,
                                      faults=("frames_altered",))
    print("fault parakeet.asr_clips frames_altered: "
          + ", ".join(f"{c.name} {c.value}" for c in record.checks))
    assert not correct



def test_readers_read_the_tracer_or_nothing(monkeypatch):
    """The four readers after a tiny run: with the tracer's ASR area off
    they read nothing; with it on, the occupancy reads the traced
    counters' share, while the spans, which hold no device seconds on the
    CPU, read nothing. None raises."""
    from svecalign_tpu_torch.utils import trace

    readers = [harness.load_reader(n) for n in ("tdt.encode_mfu_pct", "tdt.loop_share_pct",
                                                "tdt.loop_roofline_pct",
                                                "tdt.loop_occupancy_pct")]
    cell = tiny_tdt_cell()
    try:
        for on in (False, True):
            if on:
                monkeypatch.setenv(tdt_stage.PROFILE_ENV, "1")
            else:
                monkeypatch.delenv(tdt_stage.PROFILE_ENV, raising=False)
            trace.ASR.switch()
            trace.reset()
            _, record, _ = run.run_cell(cell, 9, 0.01, False, 0.0, require_card=False)
            got = [read(record) for read in readers]
            assert got[:3] == [None] * 3
            if not on:
                assert got[3] is None
                continue
            counts = trace.traced_counts()
            assert counts["asr.tdt_iterations"] > 0
            assert got[3] == 100.0 * counts["asr.tdt_row_iterations"] / (
                counts["asr.tdt_iterations"] * cell["asr_options"]["batch"])
            assert 0 < got[3] <= 100
    finally:
        monkeypatch.delenv(tdt_stage.PROFILE_ENV, raising=False)
        trace.ASR.switch()
        trace.reset()
