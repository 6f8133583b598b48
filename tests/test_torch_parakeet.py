"""The port's Parakeet-TDT (``models/parakeet.py``, ``analysis/tdt.py``,
the log-mel of ``ops/fbank.py``) on the CPU at a small size with seeded
random weights: the encoder against ``transformers``' ``ParakeetEncoder``
with the same weights, the front end and the decode loop against the
benchmark's plain reference (``bench_port/reference/parakeet_tdt.py``).
Parakeet has no counterpart in the JAX package, so its parity is held to
these two, not to JAX.

Tolerances, as relative L2 gaps: float32 agrees to rounding. The encoder
1e-5 (the sums of the stem's convs, the attention and the depthwise conv
in another order than the other side's: ~2e-7 here); the log-mel 1e-4
absolute on normalised features (``torch.stft`` against explicit frames
and an FFT: the log of a bin near the 2^-24 guard magnifies rounding,
~1e-5 here); the joint's logits 1e-5 (~4e-6 here). Paths are compared
exactly: the same argmax on logits that agree to rounding. bf16 products
round every operand to 8 bits of mantissa, 2^-9 relative, which through
the 2 blocks here leaves the logits ~1% from float32: 0.05 holds that with
room."""

import io
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from bench_port.reference import common
from bench_port.reference import parakeet_tdt as ref
from svecalign_tpu_torch.analysis import asr, dump_alignments, tdt
from svecalign_tpu_torch.models import parakeet, w2v_bert
from svecalign_tpu_torch.ops.fbank import parakeet_frames, parakeet_log_mel
from svecalign_tpu_torch.utils import audio_io, trace
from svecalign_tpu_torch.utils.audio_utils import load_waveform
from tests.rerun_graph import RerunGraph

SMALL = dict(n_mels=32, d_model=64, n_layers=2, n_heads=4, ff_dim=128, conv_kernel=9,
             subsampling_factor=8, subsampling_channels=16, xscaling=True, vocab_size=40,
             pred_hidden=32, pred_layers=2, joint_hidden=32, durations=[0, 1, 2, 3, 4],
             max_symbols=10, compute_dtype="float32")


def small_cfg(**kw):
    return dict(SMALL, **kw)


def model_cfg(cfg):
    keys = set(parakeet.ParakeetConfig.__dataclass_fields__) - {"durations", "dtype"}
    return parakeet.ParakeetConfig(**{k: cfg[k] for k in keys if k in cfg},
                                   durations=tuple(cfg["durations"]), dtype=cfg["compute_dtype"])


def make_weights(cfg, seed=5, blank=0.6, durations=(0.5, 0.4, 0.4, 0.2, 0.0), row_scale=1.0):
    """Seeded weights with the blank's embedding row zero, and the joint's
    blank and duration rows scaled and biased (``emission``)."""
    w = common.make_weights(ref.param_spec(cfg), seed, "cpu")
    v = cfg["vocab_size"]
    w["decoder.embed.weight"][v] = 0
    w["joint.out.weight"][v:] *= row_scale
    w["joint.out.bias"][v] = blank
    w["joint.out.bias"][v + 1:] = torch.tensor(durations)
    return w


def model_and_weights(cfg, **kw):
    w = make_weights(cfg, **kw)
    m = parakeet.build(model_cfg(cfg), "cpu")
    parakeet.load_weights(m, w)
    return m, w


def clips(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = [np.arange(int(16000 * s)) / 16000 for s in seconds]
    return [(0.1 * np.sin(2 * np.pi * (120 + 40 * k) * x) * (1 + np.sin(3 * x))
             + 0.03 * rng.standard_normal(len(x))).astype(np.float32) for k, x in enumerate(t)]


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


@pytest.fixture
def hf(monkeypatch):
    for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
        monkeypatch.setenv(var, "0")
    return pytest.importorskip("transformers")


HF_LAYER = {"feed_forward1.linear1": "ffn1.intermediate_dense",
            "feed_forward1.linear2": "ffn1.output_dense",
            "feed_forward2.linear1": "ffn2.intermediate_dense",
            "feed_forward2.linear2": "ffn2.output_dense", "self_attn.q_proj": "self_attn.linear_q",
            "self_attn.k_proj": "self_attn.linear_k", "self_attn.v_proj": "self_attn.linear_v",
            "self_attn.o_proj": "self_attn.linear_out",
            "self_attn.relative_k_proj": "self_attn.linear_pos",
            "self_attn.bias_u": "self_attn.pos_bias_u", "self_attn.bias_v": "self_attn.pos_bias_v",
            "conv.pointwise_conv1": "conv_module.pointwise_conv1",
            "conv.depthwise_conv": "conv_module.depthwise_conv",
            "conv.norm": "conv_module.batch_norm", "conv.pointwise_conv2":
            "conv_module.pointwise_conv2", "norm_feed_forward1": "ffn1_layer_norm",
            "norm_self_att": "self_attn_layer_norm", "norm_conv": "conv_module.layer_norm",
            "norm_feed_forward2": "ffn2_layer_norm", "norm_out": "final_layer_norm"}


def _from_hf(name: str) -> str:
    if name.startswith("subsampling.layers."):
        return "encoder.pre_encode.conv." + name[len("subsampling.layers."):]
    if name.startswith("subsampling.linear."):
        return "encoder.pre_encode.out." + name[len("subsampling.linear."):]
    _, i, rest = name.split(".", 2)
    for a, b in HF_LAYER.items():
        if rest == a or rest.startswith(a + "."):
            return f"encoder.layers_{i}.{b}{rest[len(a):]}"
    raise KeyError(name)


def test_encoder_matches_transformers(hf):
    """Three rows of different lengths in one padded batch, against
    ``transformers``' encoder with the attention mask (its SDPA route, which
    leaves fully masked rows finite), at the valid frames; the same weights,
    the BatchNorms' running statistics drawn."""
    cfg = small_cfg()
    hc = hf.ParakeetEncoderConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_kernel_size=9, subsampling_conv_channels=16, num_mel_bins=32, dropout=0.0,
        layerdrop=0.0, activation_dropout=0.0, attention_dropout=0.0)
    hc._attn_implementation = "sdpa"
    torch.manual_seed(0)
    ref_enc = hf.ParakeetEncoder(hc).eval()
    with torch.no_grad():
        for p in ref_enc.parameters():
            p.normal_(0.0, 0.3 if p.dim() > 1 else 0.1)
        for mod in ref_enc.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0.0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    m, w = model_and_weights(cfg)
    for name, t in ref_enc.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if "pointwise_conv" in name and t.dim() == 3:
            t = t[..., 0]
        w[_from_hf(name)] = t
    parakeet.load_weights(m, w)
    lens = torch.tensor([101, 77, 40])
    mask = torch.arange(101)[None] < lens[:, None]
    mel = torch.randn(3, 101, 32) * mask[:, :, None]
    with torch.no_grad():
        want = ref_enc(mel, attention_mask=mask).last_hidden_state
        got = m.encoder(mel, lens)
    frames = parakeet.subsampled_frames(lens, model_cfg(cfg))
    assert frames.tolist() == [13, 10, 5] and got.shape == want.shape
    for r, n in enumerate(frames.tolist()):
        assert rel(got[r, :n], want[r, :n]) < 1e-5


def test_symmetric_conv_module_leaves_the_causal_form_bit_equal():
    """SONAR's conv module (the default ``causal`` form) computes what it
    computed before the FastConformer form was added: the same parameters
    and the same arithmetic, written out here."""
    cfg = w2v_bert.W2vBertConfig(hidden_size=32, num_attention_heads=4, intermediate_size=64,
                                 conv_depthwise_kernel_size=31, dtype="bfloat16")
    mod = w2v_bert._ConvModule(cfg)
    assert {n for n, _ in mod.named_parameters()} == {
        "layer_norm.weight", "layer_norm.bias", "pointwise_conv1.weight",
        "depthwise_conv.weight", "depthwise_layer_norm.weight", "depthwise_layer_norm.bias",
        "pointwise_conv2.weight"}
    torch.manual_seed(1)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.2)
        x = torch.randn(2, 50, 32).bfloat16()
        mask = torch.arange(50)[None] < torch.tensor([50, 31])[:, None]
        dt = torch.bfloat16
        y = mod.layer_norm(x, dt)
        y = torch.where(mask[:, :, None], y, torch.zeros((), dtype=dt))
        y = w2v_bert.dense(mod.pointwise_conv1, y, dt)
        y = y[..., :32] * torch.sigmoid(y[..., 32:])
        y = torch.nn.functional.pad(y.transpose(1, 2), (30, 0))
        y = torch.nn.functional.conv1d(y, mod.depthwise_conv.weight.to(dt), groups=32)
        y = torch.nn.functional.silu(mod.depthwise_layer_norm(y.transpose(1, 2), dt))
        want = w2v_bert.dense(mod.pointwise_conv2, y, dt)
        assert torch.equal(mod(x, mask), want)


def test_log_mel_matches_reference():
    """Batched and padded to one length against the reference one clip at
    a time, at each clip's valid frames; the padded frames are zero."""
    cs = clips([1.37, 2.0, 0.71])
    n = 40000
    audio = torch.zeros(3, n)
    for i, c in enumerate(cs):
        audio[i, :len(c)] = torch.from_numpy(c)
    lens = torch.tensor([len(c) for c in cs])
    got = parakeet_log_mel(audio, lens, 32)
    assert got.shape == (3, n // 160 + 1, 32)
    for i, c in enumerate(cs):
        want = ref.log_mel(torch.from_numpy(c), 32)
        k = parakeet_frames(len(c))
        assert want.shape == (k, 32)
        assert float((got[i, :k] - want).abs().max()) < 1e-4
        assert not got[i, k:].any()


def test_filler_rows_have_no_frames():
    audio = torch.zeros(2, 3200)
    got = parakeet_log_mel(audio, torch.tensor([0, 3200]), 32)
    assert torch.isfinite(got).all() and not got[0].any()


@pytest.mark.parametrize("seed", [5, 6])
def test_loop_follows_the_reference(seed):
    """In float32 the batched loop's path of every clip is the
    reference's free-running greedy path, and its kept logits are the
    reference's teacher-forced ones, point by point."""
    cfg = small_cfg()
    m, w = model_and_weights(cfg, seed=seed)
    cs = clips([1.3, 2.7, 0.6, 3.9, 2.2], seed=seed)
    got = tdt.TdtTranscriber(m, batch=3, bucket_s=(2, 4)).transcribe(
        cs, "en", keep_logits=range(5))
    common.fp32_only()
    emitted = 0
    for c, t in zip(cs, got):
        audio = torch.from_numpy(c)
        path, n = ref.greedy(cfg, w, audio)
        assert [tuple(p) for p in t.path.tolist()] == [tuple(p) for p in path]
        assert t.ends == [(n, t.path[-1, 0] + t.path[-1, 2])] and t.points == len(path)
        assert t.tokens == [k for _, k, _ in path if k != cfg["vocab_size"]]
        assert t.frames == [f for f, k, _ in path if k != cfg["vocab_size"]]
        want = ref.teacher_forced(cfg, w, audio, t.path)
        gaps = (torch.from_numpy(t.logits) - want).norm(dim=1) / want.norm(dim=1)
        assert float(gaps.max()) < 1e-5
        emitted += len(t.tokens)
    steps = np.concatenate([t.path for t in got])
    assert emitted > 20 and (steps[:, 1] == cfg["vocab_size"]).any()
    assert len(set(steps[:, 2].tolist())) >= 2


def test_blank_with_no_duration_advances_one_frame(clean_tracer):
    """Every point a blank of duration 0: each advances by 1, no token."""
    cfg = small_cfg()
    m, w = model_and_weights(cfg, blank=50.0, durations=(5.0, 0, 0, 0, 0), row_scale=0.0)
    (t,) = tdt.TdtTranscriber(m, batch=2, bucket_s=(2,)).transcribe(clips([1.5]), "en",
                                                                    keep_logits=[0])
    n = t.ends[0][0]
    assert t.tokens == [] and t.path.tolist() == [[f, cfg["vocab_size"], 1] for f in range(n)]
    path, _ = ref.greedy(cfg, w, torch.from_numpy(clips([1.5])[0]))
    assert [tuple(p) for p in t.path.tolist()] == path


def test_max_symbols_forces_the_frame_on(clean_tracer):
    """Every point a token of duration 0: ``max_symbols`` tokens a frame,
    the last of them advancing by 1 (forced), as the reference does."""
    cfg = small_cfg()
    m, w = model_and_weights(cfg, blank=-50.0, durations=(5.0, 0, 0, 0, 0), row_scale=0.0)
    monkey = clips([1.2])
    (t,) = tdt.TdtTranscriber(m, batch=2, bucket_s=(2,)).transcribe(monkey, "en",
                                                                    keep_logits=[0])
    n = t.ends[0][0]
    assert len(t.tokens) == 10 * n and t.frames == [f for f in range(n) for _ in range(10)]
    assert t.path[:, 2].tolist() == ([0] * 9 + [1]) * n
    assert trace.counts["asr.tdt_forced"] == n
    path, _ = ref.greedy(cfg, w, torch.from_numpy(monkey[0]))
    assert [tuple(p) for p in t.path.tolist()] == path


def test_a_clip_does_not_depend_on_its_batch_mates():
    """A clip alone (its own bucket) and among longer ones (a longer
    bucket, other rows): the same path, tokens and frames, and logits
    equal to rounding."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    cs = clips([1.1, 3.6, 2.9, 3.3])
    (alone,) = tdt.TdtTranscriber(m, batch=1, bucket_s=(1.5, 4)).transcribe(
        cs[:1], "en", keep_logits=[0])
    among = tdt.TdtTranscriber(m, batch=4, bucket_s=(1.5, 4)).transcribe(
        cs, "en", keep_logits=[0])[0]
    assert alone.tokens == among.tokens and alone.frames == among.frames
    assert np.array_equal(alone.path, among.path) and alone.ends == among.ends
    np.testing.assert_allclose(alone.logits, among.logits, rtol=1e-5, atol=1e-5)


def test_programs_give_the_eager_transcripts(monkeypatch):
    """The card's route (the encoder and the loop programs of fixed shape
    over a state allocated once per bucket, each loop program first
    captured over a finished state) gives the eager route's transcripts; a
    program per (batch, bucket) serves every later batch."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    cs = clips([1.3, 2.7, 0.6, 3.9, 2.2, 1.0, 0.4])
    keep = [0, 3, 5]
    monkeypatch.setattr(tdt, "LOOP_ITERATIONS", 3)  # several programs a batch
    want = tdt.TdtTranscriber(m, batch=2, bucket_s=(2, 4)).transcribe(cs, "en", keep_logits=keep)
    RerunGraph.captures.clear()
    tr = tdt.TdtTranscriber(m, batch=2, bucket_s=(2, 4), graph_type=RerunGraph)
    got = tr.transcribe(cs, "en", keep_logits=keep)
    for g, w in zip(got, want):
        assert (g.tokens, g.frames, g.ends, g.points) == (w.tokens, w.frames, w.ends, w.points)
        if w.logits is not None:
            assert np.array_equal(g.path, w.path)
            np.testing.assert_allclose(g.logits, w.logits, rtol=1e-6, atol=1e-6)
    keys = set(tr.programs.programs)
    assert keys == {("tdt.encoder", 2, 32000), ("tdt.encoder", 2, 64000),
                    ("tdt.loop", 2, 32000, 3), ("tdt.loop", 2, 64000, 3)}
    assert len(RerunGraph.captures) == 4 and set(tr.states) == {32000, 64000}
    state = tr.states[64000].t.data_ptr()
    again = tr.transcribe(cs[3:4], "de", keep_logits=[0])
    assert len(RerunGraph.captures) == 4 and tr.states[64000].t.data_ptr() == state
    assert again[0].tokens == want[3].tokens


def test_token_caps_end_a_row():
    cfg = small_cfg()
    m, _ = model_and_weights(cfg, blank=-50.0, durations=(0, 0, 5.0, 0, 0), row_scale=0.0)
    got = tdt.TdtTranscriber(m, batch=2, bucket_s=(4,)).transcribe(clips([2.0, 3.0]), "en", [3, 7])
    assert [len(t.tokens) for t in got] == [3, 7]
    with pytest.raises(ValueError, match="cap"):
        tdt.TdtTranscriber(m, batch=2, bucket_s=(4,)).transcribe(clips([2.0]), "en", 0)


def test_long_clips_are_decoded_in_pieces():
    """A clip over the largest bucket: pieces of that length, each from
    frame 0 of its own, their frames laid end to end."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    c = clips([5.0])[0]
    tr = tdt.TdtTranscriber(m, batch=2, bucket_s=(2,))
    (whole,) = tr.transcribe([c], "en")
    parts = tr.transcribe([c[:32000], c[32000:64000], c[64000:]], "en")
    assert whole.tokens == [k for p in parts for k in p.tokens]
    assert whole.ends == [p.ends[0] for p in parts]
    offsets = np.cumsum([0] + [p.ends[0][0] for p in parts])
    assert whole.frames == [f + o for p, o in zip(parts, offsets) for f in p.frames]


def test_spans_and_counters(tmp_path, clean_tracer, monkeypatch):
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    _audit_inputs(tmp_path)
    monkeypatch.setenv("SVECALIGN_ASR_PROFILE", "1")
    monkeypatch.setattr(tdt, "LOOP_ITERATIONS", 4)
    tr = tdt.TdtTranscriber(m, batch=2, bucket_s=(4,))
    spans = [(1600, 40000), (48000, 100000), (110000, 130000)]
    (got,) = asr.transcribe_sides(tr, [(str(tmp_path / "doc_en.wav"), spans, "en")])
    totals = trace.totals()
    for name in ("asr.mel", "asr.encode", "asr.decode", "asr.write"):
        assert totals[name].count == 2, name  # one a batch
    loops = totals["asr.tdt_loop"].count
    # each batch waits for every program's flag but its last one's
    assert totals["asr.tdt_check"].count == loops - 2 and totals["asr.tdt_check"].host_only
    decodes = {s.id for s in trace.spans("asr.decode")}
    assert all(s.parent in decodes for s in trace.spans("asr.tdt_loop"))
    counts = trace.traced_counts()
    assert counts["asr.clips"] == 3 and counts["asr.tdt_iterations"] == 4 * loops
    assert counts["asr.tokens"] == sum(len(t.tokens) for t in got)
    assert counts["asr.tdt_row_iterations"] == sum(t.points for t in got)
    assert "asr.tdt_forced" in counts
    # each batch runs whole programs until its longest row is done, and one
    # more, queued before the flag that ends it was read
    first, second = got[:2], got[2:]
    assert loops == sum(-(-max(t.points for t in b) // 4) + 1 for b in (first, second))



def test_sides_share_batches(tmp_path, clean_tracer, monkeypatch):
    """A call packs both sides' clips into shared batches in call order
    (3 + 2 clips in two batches of 4, not three), reads each span's own
    samples, and gives each clip the transcript it has alone."""
    cfg = small_cfg()
    m, _ = model_and_weights(cfg)
    _audit_inputs(tmp_path)
    monkeypatch.setenv("SVECALIGN_ASR_PROFILE", "1")
    tr = tdt.TdtTranscriber(m, batch=4, bucket_s=(4, 8))
    en = [(1600, 40000), (48000, 100000), (110000, 130000)]
    de = [(800, 30000), (36000, 90000)]
    sides = [(str(tmp_path / "doc_en.wav"), en, "en"), (str(tmp_path / "doc_de.wav"), de, "de")]
    src, tgt = asr.transcribe_sides(tr, sides, keep_logits=[1, 3])
    totals = trace.totals()
    assert totals["asr.read"].count == 1 and totals["asr.read"].host_only
    assert totals["asr.mel"].count == totals["asr.write"].count == 2
    assert [t.logits is not None for t in src + tgt] == [False, True, False, True, False]
    for (path, spans, _), got in zip(sides, (src, tgt)):
        audio = load_waveform(path)
        for (s, e), t in zip(spans, got):
            (alone,) = tdt.TdtTranscriber(m, batch=1, bucket_s=(4, 8)).transcribe(
                [audio[s:e]], "en")
            assert t.tokens == alone.tokens and t.frames == alone.frames

def test_published_sizes():
    """The defaults are parakeet-tdt-0.6b-v3's: 627.5 M weights as the
    benchmark's spec counts them (the BatchNorms' running statistics
    included), its names the loader's."""
    with torch.device("meta"):
        m = parakeet.Parakeet(parakeet.ParakeetConfig())
    shapes = {n: t.shape for n, t in list(m.named_parameters()) + list(m.named_buffers())}
    cfg = dict(SMALL, n_mels=128, d_model=1024, n_layers=24, n_heads=8, ff_dim=4096,
               subsampling_channels=256, vocab_size=8192, pred_hidden=640, joint_hidden=640)
    spec = ref.param_spec(cfg)
    assert set(parakeet.weight_names(m)) == {name for name, _, _, _ in spec}
    assert all(tuple(shapes[name]) == tuple(shape) for name, shape, _, _ in spec)
    assert sum(int(np.prod(shape)) for _, shape, _, _ in spec) == 627_499_654


def _nemo_name(name: str) -> str:
    """The port's name back to NeMo's (the loader's map, inverted)."""
    for nemo, port in parakeet._NEMO_TOP.items():
        if name.startswith(port + ".") and not name.startswith("encoder.layers_"):
            return nemo + name[len(port):]
    idx, rest = name[len("encoder.layers_"):].split(".", 1)
    for nemo, port in parakeet._NEMO_LAYER.items():
        if rest == port or rest.startswith(port + "."):
            return f"encoder.layers.{idx}.{nemo}{rest[len(port):]}"
    raise KeyError(name)


def write_nemo(path: Path, cfg, w):
    """A ``.nemo`` archive as NeMo writes one: ``model_config.yaml`` and
    ``model_weights.ckpt`` (NeMo's names; pointwise convs as Conv1d; the
    preprocessor's buffers and step counts beside them)."""
    state = {}
    for name, t in w.items():
        if "pointwise_conv" in name and "conv_module" in name and name.endswith("weight"):
            t = t[..., None]
        state[_nemo_name(name)] = t
    state["preprocessor.featurizer.window"] = torch.ones(400)
    state["encoder.layers.0.conv.batch_norm.num_batches_tracked"] = torch.tensor(3)
    conf = {"encoder": {"feat_in": cfg["n_mels"], "n_layers": cfg["n_layers"],
                        "d_model": cfg["d_model"], "n_heads": cfg["n_heads"],
                        "ff_expansion_factor": cfg["ff_dim"] // cfg["d_model"],
                        "conv_kernel_size": cfg["conv_kernel"], "subsampling": "dw_striding",
                        "subsampling_factor": 8, "subsampling_conv_channels": 16,
                        "self_attention_model": "rel_pos", "xscaling": True},
            "decoder": {"vocab_size": cfg["vocab_size"],
                        "prednet": {"pred_hidden": 32, "pred_rnn_layers": 2}},
            "joint": {"jointnet": {"joint_hidden": 32}, "num_extra_outputs": 5},
            "model_defaults": {"tdt_durations": [0, 1, 2, 3, 4]},
            "decoding": {"strategy": "greedy_batch", "greedy": {"max_symbols": 10}}}
    buf = io.BytesIO()
    torch.save(state, buf)
    with tarfile.open(path, "w") as tar:
        for name, data in (("./model_config.yaml", yaml.safe_dump(conf).encode()),
                           ("./model_weights.ckpt", buf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def test_nemo_archive_loads_by_nemos_names(tmp_path):
    cfg = small_cfg()
    m, w = model_and_weights(cfg)
    write_nemo(tmp_path / "tiny.nemo", cfg, w)
    loaded = parakeet.load_nemo(tmp_path / "tiny.nemo", "cpu", dtype="float32")
    assert loaded.cfg == m.cfg
    for name, t in w.items():
        assert torch.equal(dict(loaded.state_dict())[name], t), name
    cs = clips([1.4, 2.2])
    a = tdt.TdtTranscriber(m, batch=2).transcribe(cs, "en")
    b = tdt.TdtTranscriber(loaded, batch=2).transcribe(cs, "en")
    assert [t.tokens for t in a] == [t.tokens for t in b]
    with pytest.raises(FileNotFoundError, match="absent.nemo"):
        parakeet.load_nemo(tmp_path / "absent.nemo", "cpu")
    with pytest.raises(KeyError, match="unknown NeMo key"):
        parakeet.from_nemo_name("encoder.layers.0.mystery.weight")


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


def test_dump_alignments_asr_with_parakeet(tmp_path, clean_tracer):
    """``--asr --asr_model parakeet-tdt`` writes the ids the transcriber
    gives into the pages; Whisper stays the default model; a missing
    archive raises and names its path."""
    cfg = small_cfg()
    _, w = model_and_weights(cfg)
    _audit_inputs(tmp_path)
    write_nemo(tmp_path / "tiny.nemo", cfg, w)
    argv = [str(tmp_path / "meta.tsv"), str(tmp_path / "out"), "--align_dir",
            str(tmp_path / "align"), "--seg_dir", str(tmp_path / "seg"), "--src_lang", "en",
            "--tgt_lang", "de", "--asr", "--asr_model", "parakeet-tdt", "--parakeet_ckpt",
            str(tmp_path / "tiny.nemo"), "--device", "cpu"]
    dump_alignments.main(argv)
    page = (tmp_path / "out" / "doc_en-doc_de" / "page0.html").read_text()
    tr = tdt.TdtTranscriber(parakeet.load_nemo(tmp_path / "tiny.nemo", "cpu"))
    src, tgt = asr.transcribe_sides(tr, [(str(tmp_path / "doc_en.wav"),
                                          [(1600, 40000), (48000, 130000)], "en"),
                                         (str(tmp_path / "doc_de.wav"),
                                          [(800, 30000), (36000, 90000)], "de")])
    for t in src + tgt:
        assert t.tokens and f"<br>{' '.join(map(str, t.tokens))}" in page
    assert page.count("<audio controls") == 4
    assert dump_alignments.parse_args(argv[:2]).asr_model == "whisper"
    with pytest.raises(FileNotFoundError, match="none.nemo"):
        dump_alignments.main([str(tmp_path / "none.nemo") if a.endswith("tiny.nemo") else a
                              for a in argv])
    with pytest.raises(ValueError, match="--parakeet_ckpt"):
        dump_alignments.main([a for a in argv if not a.endswith("tiny.nemo")
                              and a != "--parakeet_ckpt"])


def test_bf16_logits_stay_near_float32():
    """bf16 products against the float32 reference on the bf16 model's own
    path: the logits within 0.05 (module docstring)."""
    cfg = small_cfg(compute_dtype="bfloat16")
    m, w = model_and_weights(cfg)
    cs = clips([2.2, 1.4])
    got = tdt.TdtTranscriber(m, batch=2, bucket_s=(4,)).transcribe(cs, "en", keep_logits=[0, 1])
    common.fp32_only()
    for c, t in zip(cs, got):
        want = ref.teacher_forced(cfg, w, torch.from_numpy(c), t.path)
        gaps = (torch.from_numpy(t.logits) - want).norm(dim=1) / want.norm(dim=1)
        assert 1e-5 < float(gaps.max()) < 0.05
