"""The port's Whisper (``models/whisper.py``, ``analysis/asr.py``, the
log-mel of ``ops/fbank.py``) against the benchmark's plain reference
(``bench_port/reference/whisper.py``) on the CPU at a small size with
seeded random weights, and the reference against ``transformers`` where
that imports. Whisper has no counterpart in the JAX package, so its
parity is held to these two, not to JAX.

Tolerances, as relative L2 gaps: float32 agrees to rounding, 1e-5 for
the logits and 2e-5 for the encoder's output (the sums of two convs and
of attention over 1500 positions, in another order than the reference's:
5e-6 here); bf16 products round every operand and the residual stream to
8 bits of mantissa, 2^-9 relative, which through the 2 + 2 layers here
leaves encoder and logits ~0.6% from the float32 reference: 0.02 holds
that with 3x room."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port.reference import common
from bench_port.reference import whisper as ref
from svecalign_tpu_torch.analysis import asr
from svecalign_tpu_torch.analysis import dump_alignments
from svecalign_tpu_torch.models import whisper
from svecalign_tpu_torch.ops.fbank import slaney_mel_filters, whisper_log_mel
from svecalign_tpu_torch.utils import audio_io, trace
from tests.rerun_graph import RerunGraph

EOT = 50257


def small_cfg(n_mels=80, n_vocab=51866, dtype="float32"):
    return dict(n_mels=n_mels, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
                n_audio_layer=2, n_vocab=n_vocab, n_text_ctx=448, n_text_state=64,
                n_text_head=4, n_text_layer=2, compute_dtype=dtype)


def dims_of(cfg):
    return whisper.WhisperDims(**{k: cfg[k] for k in whisper.WhisperDims.__dataclass_fields__})


def model_and_weights(cfg, seed=5):
    w = common.make_weights(ref.param_spec(cfg), seed, "cpu")
    m = whisper.build(dims_of(cfg), "cpu", cfg["compute_dtype"])
    whisper.load_weights(m, w)
    return m, w


def clips(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = [np.arange(int(16000 * s)) / 16000 for s in seconds]
    return [(0.1 * np.sin(2 * np.pi * (120 + 40 * k) * x) + 0.02 * rng.standard_normal(len(x)))
            .astype(np.float32) for k, x in enumerate(t)]


def padded(cs):
    out = torch.zeros(len(cs), 480000)
    for i, c in enumerate(cs):
        out[i, :len(c)] = torch.from_numpy(c[:480000])
    return out


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture
def clean_tracer(monkeypatch):
    monkeypatch.delenv("SVECALIGN_ASR_PROFILE", raising=False)
    trace.ASR.switch()
    trace.reset()
    yield
    monkeypatch.delenv("SVECALIGN_ASR_PROFILE", raising=False)
    trace.ASR.switch()
    trace.reset()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_reference(n_mels):
    audio = padded(clips([3.2, 11.0, 30.0]))
    got = whisper_log_mel(audio, n_mels)
    want = ref.log_mel(audio, n_mels)
    assert got.shape == (3, n_mels, 3000)
    assert float((got - want).abs().max()) < 1e-5
    assert np.abs(slaney_mel_filters(n_mels) - ref.mel_filters(n_mels).numpy()).max() < 1e-8


def test_log_mel_floor_is_per_clip():
    """A clip's features do not depend on a louder batch-mate."""
    cs = clips([4.0, 6.0])
    cs[1] = cs[1] * 50
    both = whisper_log_mel(padded(cs), 80)
    alone = whisper_log_mel(padded(cs[:1]), 80)
    assert torch.equal(both[:1], alone)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 0.02)])
def test_encoder_matches_reference(dtype, tol):
    cfg = small_cfg(dtype=dtype)
    m, w = model_and_weights(cfg)
    mel = ref.log_mel(padded(clips([5.0, 2.0])), cfg["n_mels"])
    with torch.no_grad():
        got = m.encoder(mel).float()
        want = ref.encode(cfg, w, mel)
    assert got.shape == (2, 1500, 64)
    assert rel(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.02)])
def test_cached_decoding_matches_teacher_forced_forward(dtype, tol):
    """Prefill and 10 cached steps give the logits of the full forward
    over the same ids, at every position."""
    cfg = small_cfg(dtype=dtype)
    m, w = model_and_weights(cfg)
    mel = ref.log_mel(padded(clips([7.0, 3.0])), cfg["n_mels"])
    ids = torch.tensor([[50258, 50259, 50360, 50364] + [11, 2000, 3, 40000, 5, 6, 7, 8, 9, 10],
                        [50258, 50261, 50360, 50364] + [50, 51, 52, 53, 54, 55, 56, 57, 58, 59]])
    with torch.no_grad():
        dec = m.decoder
        cross = dec.cross_kv(m.encoder(mel))
        cache = dec.new_cache(2, ids.shape[1])
        steps = [dec(ids[:, :4], 0, cache, cross)]
        for j in range(4, ids.shape[1]):
            steps.append(dec(ids[:, j:j + 1], j, cache, cross))
        got = torch.cat(steps, dim=1)
        want = ref.logits(cfg, w, ids, ref.encode(cfg, w, mel))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 14, 51866)
    for r in range(2):
        for t in range(14):
            assert rel(got[r, t], want[r, t]) < tol, (r, t)
    # a prefill of more than one token past the start attends causally too
    with torch.no_grad():
        cache = dec.new_cache(2, ids.shape[1])
        first = dec(ids[:, :6], 0, cache, cross)
        rest = dec(ids[:, 6:], 6, cache, cross)
    assert rel(torch.cat([first, rest], 1), want) < tol


def test_transcripts_follow_the_reference_greedily():
    """Every sampled id is the argmax of the reference's teacher-forced
    logits at its position, under the filters."""
    cfg = small_cfg()
    m, w = model_and_weights(cfg)
    cs = clips([3.0, 8.0, 1.5])
    out = asr.Transcriber(m, batch=2).transcribe(cs, ["en", "de", "en"], [6, 10, 4],
                                                keep_logits=[0, 1, 2])
    xa = ref.encode(cfg, w, ref.log_mel(padded(cs), cfg["n_mels"]))
    for i, t in enumerate(out):
        assert t.prompt == [50258, 50259 if i != 1 else 50261, 50360, 50364]
        n = len(t.logits)
        ids = torch.tensor([(t.prompt + t.tokens + [EOT])[:4 + n - 1]])
        with torch.no_grad():
            want = ref.logits(cfg, w, ids, xa[i:i + 1])[0, 3:]
        assert rel(torch.from_numpy(t.logits), want) < 1e-5
        filt = want.clone()
        filt[0, [220, EOT]] = -math.inf
        picked = filt.argmax(1).tolist()
        assert picked[:len(t.tokens)] == t.tokens


def test_batch_mates_do_not_change_a_clip():
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    cs = clips([6.0, 2.0, 12.0, 4.0, 9.0])
    tr = asr.Transcriber(m, batch=5, suppress_tokens=[EOT])
    alone = tr.transcribe([cs[2]], "en", 12, keep_logits=[0])[0]
    among = tr.transcribe(cs, ["de", "en", "en", "de", "en"], [3, 20, 12, 7, 5],
                          keep_logits=[2])[2]
    assert alone.tokens == among.tokens and len(alone.tokens) == 12
    np.testing.assert_allclose(alone.logits, among.logits, rtol=1e-5, atol=1e-5)


def test_rows_end_at_eot_and_at_their_budgets(clean_tracer):
    """A model whose logits always favour <|endoftext|> ends every row at
    its second sampled position (suppress_blank holds the first); with
    <|endoftext|> suppressed each row samples exactly its budget."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    with torch.no_grad():
        m.decoder.ln.weight.zero_()
        m.decoder.ln.bias.copy_(torch.linspace(-1, 1, 64))
        m.decoder.token_embedding.weight[EOT] = 10 * m.decoder.ln.bias
    cs = clips([2.0, 5.0, 3.0])
    trace.count("asr.steps", 0)
    out = asr.Transcriber(m, batch=3).transcribe(cs, "en", [40, 40, 1], keep_logits=[0, 2])
    assert [len(t.tokens) for t in out] == [1, 1, 1]
    assert out[0].tokens[0] != EOT and len(out[0].logits) == 2 and len(out[2].logits) == 1
    # every row done after two steps: the decode stops at the next check
    assert trace.counts["asr.steps"] == asr.DONE_CHECK_EVERY - 1
    out = asr.Transcriber(m, batch=2, suppress_tokens=[EOT]).transcribe(cs, "en", [3, 7, 1])
    assert [len(t.tokens) for t in out] == [3, 7, 1]
    assert all(EOT not in t.tokens for t in out)


def test_long_clips_are_decoded_in_30s_pieces():
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    cs = clips([70.0])
    tr = asr.Transcriber(m, batch=2, suppress_tokens=[EOT])
    got = tr.transcribe(cs, "en", 5, keep_logits=[0])[0]
    pieces = tr.transcribe([cs[0][:480000], cs[0][480000:960000], cs[0][960000:]], "en", 5)
    assert got.tokens == sum((p.tokens for p in pieces), []) and len(got.tokens) == 15
    assert got.logits.shape == (15, 51866)


def test_special_tokens_follow_openais_layout():
    v3, v2 = asr.special_tokens(51866), asr.special_tokens(51865)
    assert v3.prompt("en") == [50258, 50259, 50360, 50364]
    assert v3.prompt("de")[1] == 50261 and v2.prompt("de") == [50258, 50261, 50359, 50363]
    assert v3.prompt("yue")[1] == 50358 and len(v3.languages) == 100
    with pytest.raises(ValueError):
        v2.prompt("yue")
    with pytest.raises(ValueError):
        asr.special_tokens(51864)


def write_checkpoint(root: Path, size: str, cfg, seed=7):
    """An openai-layout ``<root>/<size>.pt``: fp16 weights by openai's names,
    the encoder's sinusoids among them, and the dims."""
    w = common.make_weights(ref.param_spec(cfg), seed, "cpu")
    state = {k: v.to(torch.float16) for k, v in w.items()}
    state["encoder.positional_embedding"] = ref.sinusoids(1500, cfg["n_audio_state"])
    dims = {k: cfg[k] for k in whisper.WhisperDims.__dataclass_fields__}
    root.mkdir(parents=True, exist_ok=True)
    torch.save({"dims": dims, "model_state_dict": state}, str(root / f"{size}.pt"))
    return {k: v.float() for k, v in state.items()}


def test_openai_checkpoint_loads_and_gives_the_reference_logits(tmp_path):
    cfg = small_cfg(n_vocab=51865)
    w = write_checkpoint(tmp_path, "tiny-test", cfg)
    m = whisper.load_checkpoint(tmp_path / "tiny-test.pt", "cpu", "float32")
    assert m.dims == dims_of(cfg)
    mel = ref.log_mel(padded(clips([4.0])), 80)
    ids = torch.tensor([[50258, 50259, 50359, 50363, 17, 18]])
    with torch.no_grad():
        cross = m.decoder.cross_kv(m.encoder(mel))
        got = m.decoder(ids, 0, m.decoder.new_cache(1, 6), cross)
        want = ref.logits(cfg, w, ids, ref.encode(cfg, w, mel))
    assert rel(got, want) < 1e-5
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "absent.pt")):
        whisper.load_checkpoint(tmp_path / "absent.pt", "cpu")


def _audit_inputs(tmp_path):
    rng = np.random.default_rng(3)
    segs = {"en": [(1600, 40000), (48000, 100000), (110000, 130000)],
            "de": [(800, 30000), (36000, 90000), (95000, 140000)]}
    for lang in ("en", "de"):
        audio_io.write(str(tmp_path / f"doc_{lang}.wav"),
                       (0.1 * rng.standard_normal(160000)).astype(np.float32), 16000)
        (tmp_path / "seg" / lang).mkdir(parents=True)
        (tmp_path / "seg" / lang / f"doc_{lang}.txt").write_text(
            "".join(f"{s} {e}\n" for s, e in segs[lang]))
    (tmp_path / "align" / "en-de").mkdir(parents=True)
    (tmp_path / "align" / "en-de" / "doc_en-doc_de.txt").write_text(
        "[0]:[0]:0.3\n[1, 2]:[1]:0.4\n[]:[2]:1.0\n")
    (tmp_path / "meta.tsv").write_text(f"{tmp_path / 'doc_en.wav'}\t{tmp_path / 'doc_de.wav'}\n")
    return segs


def test_dump_alignments_asr_writes_the_ids_into_the_pages(tmp_path, clean_tracer):
    cfg = small_cfg(n_vocab=51865)
    _audit_inputs(tmp_path)
    write_checkpoint(tmp_path / "ckpt", "tiny-test", cfg)
    argv = [str(tmp_path / "meta.tsv"), str(tmp_path / "out"), "--align_dir",
            str(tmp_path / "align"), "--seg_dir", str(tmp_path / "seg"), "--src_lang", "en",
            "--tgt_lang", "de", "--asr", "--whisper_size", "tiny-test", "--whisper_root",
            str(tmp_path / "ckpt"), "--device", "cpu"]
    dump_alignments.main(argv)
    page = (tmp_path / "out" / "doc_en-doc_de" / "page0.html").read_text()
    # the same transcriber on the same spans gives the ids the page shows
    tr = asr.Transcriber(whisper.load_checkpoint(tmp_path / "ckpt" / "tiny-test.pt", "cpu"))
    src, tgt = asr.transcribe_sides(tr, [(str(tmp_path / "doc_en.wav"),
                                          [(1600, 40000), (48000, 130000)], "en"),
                                         (str(tmp_path / "doc_de.wav"),
                                          [(800, 30000), (36000, 90000)], "de")])
    for t in src + tgt:
        assert t.tokens and f"<br>{' '.join(map(str, t.tokens))}" in page
    assert page.count("<audio controls") == 4
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "none" / "tiny-test.pt")):
        dump_alignments.main([str(tmp_path / "none") if a == str(tmp_path / "ckpt") else a
                              for a in argv])


def test_asr_spans_and_counters(tmp_path, clean_tracer, monkeypatch):
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    _audit_inputs(tmp_path)
    monkeypatch.setenv("SVECALIGN_ASR_PROFILE", "1")
    tr = asr.Transcriber(m, batch=2, suppress_tokens=[EOT])
    spans = [(1600, 40000), (48000, 100000), (110000, 130000)]
    asr.transcribe_sides(tr, [(str(tmp_path / "doc_en.wav"), spans, "en")], [3, 9, 5])
    totals = trace.totals()
    for name in ("asr.call", "asr.read"):
        assert totals[name].count == 1
    for name in ("asr.mel", "asr.encode", "asr.cross_kv", "asr.decode", "asr.prefill",
                 "asr.write"):
        assert totals[name].count == 2, name  # one a batch
    assert totals["asr.step"].count == (9 - 1) + (5 - 1)  # one a step after the prefill
    assert totals["asr.read"].host_only and totals["asr.write"].host_only
    steps = trace.spans("asr.step")
    decodes = {s.id for s in trace.spans("asr.decode")}
    assert all(s.parent in decodes for s in steps)
    counts = trace.traced_counts()
    assert counts["asr.clips"] == 3 and counts["asr.steps"] == 12
    assert counts["asr.tokens"] == 3 + 9 + 5
    # the last batch is filled to the batch size with silent rows
    assert counts["asr.cache_bytes"] == (whisper.cache_bytes(m, 2, 4 + 9 - 1)
                                         + whisper.cache_bytes(m, 2, 4 + 5 - 1))


@pytest.fixture
def hf(monkeypatch):
    for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
        monkeypatch.setenv(var, "0")
    return pytest.importorskip("transformers")


@pytest.mark.parametrize("n_mels", [80, 128])
def test_reference_log_mel_matches_transformers(hf, n_mels):
    from transformers.audio_utils import mel_filter_bank

    filters = mel_filter_bank(201, n_mels, 0.0, 8000.0, 16000, norm="slaney", mel_scale="slaney")
    assert np.abs(ref.mel_filters(n_mels).numpy() - filters.T).max() < 1e-8
    fe = hf.WhisperFeatureExtractor(feature_size=n_mels)
    audio = padded(clips([2.5, 17.0]))
    want = fe._np_extract_fbank_features(audio.numpy(), "cpu")
    got = ref.log_mel(audio, n_mels).numpy()
    assert np.abs(got - want).max() < 1e-4


def test_reference_matches_transformers_whisper(hf):
    cfg = small_cfg()
    w = {k: v.float() for k, v in common.make_weights(ref.param_spec(cfg), 9, "cpu").items()}
    conf = hf.WhisperConfig(vocab_size=cfg["n_vocab"], num_mel_bins=80, d_model=64,
                            encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
                            max_source_positions=1500, max_target_positions=448,
                            activation_function="gelu")
    model = hf.WhisperForConditionalGeneration(conf).eval()
    names = {"attn.query": "self_attn.q_proj", "attn.key": "self_attn.k_proj",
             "attn.value": "self_attn.v_proj", "attn.out": "self_attn.out_proj",
             "attn_ln": "self_attn_layer_norm", "cross_attn.query": "encoder_attn.q_proj",
             "cross_attn.key": "encoder_attn.k_proj", "cross_attn.value": "encoder_attn.v_proj",
             "cross_attn.out": "encoder_attn.out_proj", "cross_attn_ln": "encoder_attn_layer_norm",
             "mlp.0": "fc1", "mlp.2": "fc2", "mlp_ln": "final_layer_norm"}
    state = {}
    for k, v in w.items():
        side, rest = k.split(".", 1)
        if rest.startswith("blocks."):
            _, i, name = rest.split(".", 2)
            mod, leaf = name.rsplit(".", 1)
            state[f"model.{side}.layers.{i}.{names[mod]}.{leaf}"] = v
        else:
            hf_name = {"conv1.weight": "conv1.weight", "conv1.bias": "conv1.bias",
                       "conv2.weight": "conv2.weight", "conv2.bias": "conv2.bias",
                       "ln_post.weight": "layer_norm.weight", "ln_post.bias": "layer_norm.bias",
                       "token_embedding.weight": "embed_tokens.weight",
                       "positional_embedding": "embed_positions.weight",
                       "ln.weight": "layer_norm.weight", "ln.bias": "layer_norm.bias"}[rest]
            state[f"model.{side}.{hf_name}"] = v
    state["model.encoder.embed_positions.weight"] = ref.sinusoids(1500, 64)
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and set(missing) <= {"proj_out.weight"}
    model.tie_weights()
    mel = ref.log_mel(padded(clips([6.0])), 80)
    ids = torch.tensor([[50258, 50259, 50360, 50364, 100, 200, 300]])
    with torch.no_grad():
        out = model(input_features=mel, decoder_input_ids=ids)
        xa = ref.encode(cfg, w, mel)
        want = ref.logits(cfg, w, ids, xa)
    assert rel(xa, out.encoder_last_hidden_state) < 1e-5
    assert rel(want, out.logits) < 1e-5


@pytest.mark.parametrize("size,params", [("large-v3", 1_543_490_560), ("medium", 763_857_920),
                                         ("tiny", 37_760_640)])
def test_published_sizes(size, params):
    """The table's sizes give the checkpoints' tensor counts (the published
    1.54 B, 764 M and 37.8 M, the encoder's sinusoids included)."""
    with torch.device("meta"):
        m = whisper.Whisper(whisper.DIMS[size])
    assert sum(v.numel() for v in m.state_dict().values()) == params


def test_programs_give_the_eager_transcripts():
    """The card's route (the encoder and every step a program of fixed
    shape over buffers allocated once) gives the eager route's ids and
    logits; a program per step index, captured once, serves every batch."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    cs = clips([3.0, 8.0, 1.5, 5.0, 2.2])
    budgets, keep = [6, 10, 4, 9, 3], [0, 1, 3, 4]
    want = asr.Transcriber(m, batch=2).transcribe(cs, "en", budgets, keep_logits=keep)
    RerunGraph.captures.clear()
    tr = asr.Transcriber(m, batch=2, graph_type=RerunGraph)
    got = tr.transcribe(cs, "en", budgets, keep_logits=keep)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        if w.logits is not None:
            np.testing.assert_allclose(g.logits, w.logits, rtol=1e-6, atol=1e-6)
    keys = set(tr.programs.programs)
    assert sum(k[0] == "whisper.encoder" for k in keys) == 1
    assert {k[3] for k in keys if k[0] == "whisper.step"} == set(range(1, 10))
    assert len(RerunGraph.captures) == len(keys)
    ptr = tr._cross[0][0].data_ptr()
    tr.transcribe(cs[:2], "de", 4)
    assert len(RerunGraph.captures) == len(keys) and tr._cross[0][0].data_ptr() == ptr


def test_programs_count_their_cache_buffers_once(clean_tracer):
    """On the card's route ``asr.cache_bytes`` counts the buffers the
    programs allocate, once: the cross K/V and the self-attention K/V of
    ``n_text_ctx`` positions, whatever the batches' budgets."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    tr = asr.Transcriber(m, batch=2, graph_type=RerunGraph)
    tr.transcribe(clips([3.0, 8.0, 1.5]), "en", [6, 10, 4])
    tr.transcribe(clips([2.0]), "de", 3)
    assert trace.counts["asr.cache_bytes"] == whisper.cache_bytes(m, 2, cfg["n_text_ctx"])
    k, v = tr._cache[0]
    assert k.shape[2] == v.shape[2] == cfg["n_text_ctx"]


def test_bf16_logits_read_one_fp32_copy_of_the_table():
    """A bf16 model's logits take the token embedding in fp32 from one
    copy, kept across steps and refreshed in its own storage when the
    embedding changes in place; an fp32 model's table is the embedding."""
    m, _ = model_and_weights(small_cfg(dtype="bfloat16"))
    dec = m.decoder
    table = dec.logit_table()
    w = dec.token_embedding.weight
    assert table.dtype == torch.float32 and torch.equal(table, w.float())
    assert dec.logit_table() is table
    with torch.no_grad():
        w[EOT] = 1.0
    again = dec.logit_table()
    assert again.data_ptr() == table.data_ptr() and torch.equal(again[EOT], torch.ones(64))
    f32, _ = model_and_weights(small_cfg())
    assert f32.decoder.logit_table() is f32.decoder.token_embedding.weight
