"""The port's SpeechLASER embedder (svecalign_tpu_torch.models.laser_encoder)
against the JAX package's, module by module, from the same weights: the
JAX numpy init, saved with ``save_params_npz`` and read by both; and
against ``transformers.Wav2Vec2Model`` through the JAX package's
checkpoint converter (``tools/convert_torch_ckpt.py``).

The config is small (3 conv layers of 32 channels, receptive field 30
samples and hop 20; d = 128 in 2 heads of 64, 2 layers, FFN 256,
positional conv 16 in 4 groups), in both extractor modes.

Tolerances, stated per check, as max |port - JAX| / max |JAX|: fp32 within
1e-4 (float rounding: the summation orders of the convs and matmuls
differ); bf16 within 3e-2, the two frameworks rounding at other places
(flax rounds a Dense's product before its bias), with every row's cosine
>= 0.999.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import param_utils as tparams
from svecalign_tpu_torch.models import w2v_bert as tw2v

torch.set_num_threads(2)

SMALL = dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_dim=128,
             encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256, conv_pos_kernel=16,
             conv_pos_groups=4)
DTYPES = ("float32", "bfloat16")
MODES = ("layer", "group")
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MIN_COSINE = 0.999


def jax_cfg(dtype="float32", mode="layer"):
    return jlaser.LaserEncoderConfig(**SMALL, extractor_mode=mode, dtype=dtype)


def port_cfg(dtype="float32", mode="layer"):
    return tlaser.LaserEncoderConfig(**SMALL, extractor_mode=mode, dtype=dtype)


def _init_args():
    return (jnp.zeros((1, 4000), jnp.float32), jnp.zeros((1,), jnp.int32))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per extractor mode: (JAX params tree, npz path) of the JAX numpy
    init, seed 3."""
    out = {}
    for mode in MODES:
        params = jparams.numpy_init(jlaser.LaserSpeechEncoder(jax_cfg(mode=mode)), _init_args(),
                                    seed=3)
        if mode == "group":  # scales other than 1 make the check meaningful
            gn = params["params"]["feature_extractor"]["group_norm"]
            rng = np.random.default_rng(8)
            gn["scale"] = rng.uniform(0.5, 1.5, gn["scale"].shape).astype(np.float32)
            gn["bias"] = rng.normal(0, 0.1, gn["bias"].shape).astype(np.float32)
        path = tmp_path_factory.mktemp("laser") / f"small_{mode}.npz"
        jparams.save_params_npz(params, str(path))
        out[mode] = (params, str(path))
    return out


@pytest.fixture(scope="module")
def port_models(weights):
    """The port's encoder per (extractor mode, compute dtype), from the npz."""
    out = {}
    for mode in MODES:
        flat = tparams.load_params_npz(weights[mode][1])
        for dtype in DTYPES:
            m = tlaser.LaserSpeechEncoder(port_cfg(dtype, mode))
            m.load_state_dict(tparams.params_from_jax(flat, m, source="npz"))
            out[mode, dtype] = m.eval().requires_grad_(False)
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def min_cosine(got, want):
    """The least cosine over the rows (the first axis) that are not zero
    in ``want`` (a silent row's hidden states are the norms' zero bias)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    keep = np.linalg.norm(want, axis=1) > 0
    got, want = got[keep], want[keep]
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    return float(cos.min())


def assert_close(got, want, dtype):
    assert rel_err(got, want) < REL_TOL[dtype]
    if dtype != "float32":
        assert min_cosine(got, want) >= MIN_COSINE


def _wav(b=3, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((b, n))).astype(np.float32)


# --- parameters ------------------------------------------------------------


def _flat(params):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params["params"]).items()}


@pytest.mark.parametrize("mode", MODES)
def test_params_from_jax_round_trip(weights, mode):
    """The JAX tree through an npz loads into the port with no missing or
    extra key, each leaf in the torch layout: strided and grouped conv
    kernels, the 3-D attention kernels and their biases, norm scales."""
    params, path = weights[mode]
    m = tlaser.LaserSpeechEncoder(port_cfg(mode=mode))
    state = tparams.params_from_jax(tparams.load_params_npz(path), m)
    res = m.load_state_dict(state, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    flat = _flat(params)
    assert len(flat) == len(state)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    eq = np.testing.assert_array_equal
    eq(sd["feature_extractor.conv_0.weight"], flat["feature_extractor/conv_0/kernel"].transpose(2, 1, 0))
    eq(sd["feature_extractor.conv_1.weight"], flat["feature_extractor/conv_1/kernel"].transpose(2, 1, 0))
    eq(sd["pos_conv.weight"], flat["pos_conv/kernel"].transpose(2, 1, 0))
    assert sd["pos_conv.weight"].shape == (128, 32, 16)
    q = flat["layer_1/attn/query/kernel"]  # (d, heads, dh)
    assert q.shape == (128, 2, 64)
    eq(sd["layer_1.attn.query.weight"], q.reshape(128, 128).T)
    eq(sd["layer_1.attn.value.bias"], flat["layer_1/attn/value/bias"].reshape(-1))
    o = flat["layer_0/attn/out/kernel"]  # (heads, dh, d)
    eq(sd["layer_0.attn.out.weight"], o.reshape(128, 128).T)
    eq(sd["layer_0.attn.out.bias"], flat["layer_0/attn/out/bias"])
    eq(sd["layer_0.ffn_in.weight"], flat["layer_0/ffn_in/kernel"].T)
    eq(sd["encoder_norm.weight"], flat["encoder_norm/scale"])
    if mode == "group":
        eq(sd["feature_extractor.group_norm.weight"], flat["feature_extractor/group_norm/scale"])
        eq(sd["feature_extractor.group_norm.bias"], flat["feature_extractor/group_norm/bias"])
        assert "feature_extractor.conv_0.bias" not in sd
    else:
        eq(sd["feature_extractor.layer_norm_2.weight"],
           flat["feature_extractor/layer_norm_2/scale"])


@pytest.mark.parametrize("mode", MODES)
def test_random_init_equals_jax_numpy_init(mode):
    """No checkpoint: the port draws the JAX package's numpy init for the
    same seed, leaf for leaf (each leaf at its flax shape, fan_in over all
    but its last axis)."""
    params = jparams.numpy_init(jlaser.LaserSpeechEncoder(jax_cfg(mode=mode)), _init_args(),
                                seed=5)
    m = tlaser.LaserSpeechEncoder(port_cfg(mode=mode))
    want = tparams.params_from_jax(_flat(params), m)
    got = tparams.params_from_jax({}, m, seed=5)
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def test_params_from_jax_rejects_bad_leaves(weights):
    flat = tparams.load_params_npz(weights["layer"][1])
    m = tlaser.LaserSpeechEncoder(port_cfg())
    with pytest.raises(KeyError, match="unknown parameter"):
        tparams.params_from_jax({**flat, "layer_0/attn/extra/kernel": np.zeros(3)}, m)
    for name, shape in [("layer_0/attn/query/kernel", (128, 128)),  # a 2-D attention kernel
                        ("layer_0/attn/out/kernel", (2, 128, 64)),
                        ("pos_conv/kernel", (16, 128, 128))]:  # an ungrouped conv
        bad = dict(flat)
        bad[name] = np.zeros(shape, np.float32)
        with pytest.raises(ValueError, match="shape mismatch"):
            tparams.params_from_jax(bad, m)


def test_full_width_leaves_match_jax():
    """At full width (7 conv layers, 24 layers, d = 1024, 16 heads) the
    port names every leaf of the JAX tree at its flax shape, so a
    full-width ``save_params`` npz loads with no missing or unknown leaf."""
    from flax.traverse_util import flatten_dict

    shapes = jax.eval_shape(jlaser.LaserSpeechEncoder(jlaser.LaserEncoderConfig()).init,
                            jax.random.PRNGKey(0), *_init_args())
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes["params"]).items()}
    with torch.device("meta"):
        m = tlaser.LaserSpeechEncoder(tlaser.LaserEncoderConfig())
    got = {"/".join(path): shape for path, _, _, shape in tparams._leaf_map(m)}
    assert got == want
    assert list(got) == sorted(got)  # the JAX flattening (and init) order
    assert got["layer_23/attn/query/kernel"] == (1024, 16, 64)
    assert got["pos_conv/kernel"] == (128, 64, 1024)
    n = sum(int(np.prod(s)) for s in got.values())
    assert 310e6 < n < 320e6
    assert tlaser.LaserEncoderConfig().receptive_field() == (400, 320)


# --- modules ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_extractor_matches_jax(weights, port_models, mode, dtype):
    """The conv feature extractor, (B, samples) -> (B, frames, 32), in the
    compute dtype; the group norm spans the whole padded length."""
    wav = _wav()
    wav[2, 1200:] = 0.0  # a padded row
    want = jlaser.ConvFeatureExtractor(jax_cfg(dtype, mode)).apply(
        {"params": weights[mode][0]["params"]["feature_extractor"]}, jnp.asarray(wav))
    got = port_models[mode, dtype].feature_extractor(torch.from_numpy(wav))
    assert got.dtype == tw2v.DTYPES[dtype] and tuple(got.shape) == tuple(want.shape)
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_layer_matches_jax(weights, port_models, dtype):
    """One pre-norm layer with a key mask: the residual stream in the
    compute dtype; padded query rows are compared too (they attend)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, 128)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 23, 1])[:, None]
    jdt = jnp.dtype(dtype)
    want = jlaser.TransformerLayer(jax_cfg(dtype)).apply(
        {"params": weights["layer"][0]["params"]["layer_0"]}, jnp.asarray(x, jdt),
        jnp.asarray(mask))
    tdt = tw2v.DTYPES[dtype]
    got = port_models["layer", dtype].layer_0(torch.from_numpy(x).to(tdt), torch.from_numpy(mask))
    assert got.dtype == tdt
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_encoder_matches_jax(weights, port_models, mode, dtype):
    """The whole encoder: fp32 hidden states (valid frames) and the masked
    max-pooled rows, a length-0 padding row included."""
    wav = _wav(4, 2400, seed=1)
    lengths = np.array([2400, 1500, 31, 0], np.int32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    jm = jlaser.LaserSpeechEncoder(jax_cfg(dtype, mode))
    p = weights[mode][0]
    jx, jmask = jm.apply(p, jnp.asarray(wav), jnp.asarray(lengths), return_hidden=True)
    jpool = jm.apply(p, jnp.asarray(wav), jnp.asarray(lengths))
    tm = port_models[mode, dtype]
    tx, tmask = tm(torch.from_numpy(wav), torch.from_numpy(lengths), return_hidden=True)
    tpool = tm(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tx.dtype == torch.float32 and tpool.dtype == torch.float32
    assert torch.isfinite(tpool).all()
    valid = np.asarray(jmask)[:, :, None]
    assert_close(np.where(valid, tx.numpy(), 0), np.where(valid, np.asarray(jx), 0), dtype)
    assert_close(tpool.numpy(), np.asarray(jpool), dtype)


def test_gelu_flavours():
    """tanh approximation below 32 bits, exact erf in fp32, as JAX's _gelu:
    fp32 within 1e-6 (the two erf implementations differ in the far left
    tail, where GELU is below 1e-5); bf16 within one bf16 step at unit
    magnitude (XLA evaluates the tanh form with bf16 intermediates, torch
    in fp32 and rounds once)."""
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    np.testing.assert_allclose(tlaser.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jlaser._gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jlaser._gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tlaser.gelu(xb).float().numpy()
    assert tlaser.gelu(xb).dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7)


@pytest.mark.parametrize("full_width", [False, True])
def test_frame_mask_matches_jax(full_width):
    """Frame validity from sample lengths: 0, below one receptive field,
    exact multiples of the hop past it, and one sample short of them;
    at least one frame per row, floor division for negative numerators."""
    if full_width:
        jcfg, tcfg, size, hop = jlaser.LaserEncoderConfig(), tlaser.LaserEncoderConfig(), 400, 320
    else:
        jcfg, tcfg, size, hop = jax_cfg(), port_cfg(), 30, 20
    assert tcfg.receptive_field() == (size, hop)
    lengths = np.array([0, 1, size - 1, size, size + hop - 1, size + hop, size + 7 * hop,
                        7 * hop, 7 * hop - 1], np.int32)
    n_frames = 12
    # JAX computes the mask inside __call__; reproduce its two lines
    frame_len = (jnp.asarray(lengths) - size) // hop + 1
    want = np.asarray(jnp.arange(n_frames)[None, :] < jnp.maximum(frame_len, 1)[:, None])
    got = tlaser.frame_mask(tcfg, torch.from_numpy(lengths), n_frames).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum(1).tolist()[:6] == [1, 1, 1, 1, 1, 2]


# --- encode and encode_spans --------------------------------------------------------

SPANS = [
    (0, 16000),            # exactly the small bucket
    (8000, 38000),         # crosses 1 s blocks
    (30000, 55000),        # mid-file
    (20 * 16000, 20 * 16000 + 24000),  # quiet region
    (600000, 624000),      # tail
    (632000, 640000),      # runs to the last sample
    (632000, 700000),      # overruns the file end (host slicing truncates)
    (100, 120),            # shorter than one receptive field
]


def _document(seconds=40, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    w[20 * 16000 : 25 * 16000] *= 0.01  # per-block scales differ from per-window
    return w


def _small_buckets(m):
    m.BUCKETS = (16000, 32000)
    m.WAVE_BUCKETS_S = (10, 41)
    return m


@pytest.fixture(scope="module")
def encoders(weights):
    """(JAX, port) SpeechLaserModel per upload dtype, fp32 compute, from
    the same npz, with shrunk buckets (4 and 2 rows per chunk)."""
    out = {}
    for up in ("fp32", "int16"):
        j = jlaser.SpeechLaserModel(jax_cfg(), ckpt_path=weights["layer"][1],
                                    max_tokens=4 * 16000, upload_dtype=up)
        t = tlaser.SpeechLaserModel(port_cfg(), ckpt_path=weights["layer"][1],
                                    max_tokens=4 * 16000, upload_dtype=up, device="cpu")
        out[up] = (_small_buckets(j), _small_buckets(t))
    return out


@pytest.mark.parametrize("upload", ["fp32", "int16"])
def test_encode_and_spans_match_jax(encoders, upload):
    jm, tm = encoders[upload]
    w = _document()
    pieces = [w[s:e] for s, e in SPANS]
    want = jm.encode(pieces)
    got = tm.encode(pieces)
    assert got.shape == (len(SPANS), 128) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert rel_err(got, want) < REL_TOL["float32"]

    want_s = jm.encode_spans(w, SPANS)
    got_s = tm.encode_spans(w, SPANS)
    assert rel_err(got_s, want_s) < REL_TOL["float32"]
    if upload == "fp32":
        # the JAX contract: fp32 upload makes encode_spans equal encode
        np.testing.assert_array_equal(got_s, got)
    np.testing.assert_array_equal(tm.encode_spans(w, SPANS, fp16_pull=True),
                                  got_s.astype(np.float16))
    np.testing.assert_array_equal(tm.encode(pieces, fp16_pull=True), got.astype(np.float16))


def test_rows_per_chunk_and_truncation(encoders, caplog):
    """max(1, max_tokens // bucket) rows per chunk (37 ... 2 at full width
    and 2.4 M samples); an input past the largest bucket is truncated to it
    with a warning and equals its prefix's embedding."""
    import logging

    full = tlaser.SpeechLaserModel.__new__(tlaser.SpeechLaserModel)
    full.max_tokens = 150 * 16000
    assert [full._rows_per_chunk(b) for b in tlaser.SpeechLaserModel.BUCKETS] == \
        [37, 18, 10, 7, 5, 3, 2]
    _, tm = encoders["fp32"]
    assert tm._rows_per_chunk(16000) == 4 and tm._rows_per_chunk(10**6) == 1
    w = _document(3)
    with caplog.at_level(logging.WARNING):
        got = tm.encode([w])
    assert any("TRUNCATED" in r.message for r in caplog.records)
    np.testing.assert_array_equal(got, tm.encode([w[:32000]]))


# --- the convs' row groups ------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_row_groups_equal_one_call(port_models, mode, monkeypatch):
    """7 rows in 3 groups of 3, 2 and 2 rows, a padded row among them: the
    extractor's output and the encoder's hidden states (its positional
    conv in groups too) are bit-equal in fp32 to the rows in one call
    (every op of the extractor, the group norm too, is per row)."""
    model = port_models[mode, "float32"]
    wav = _wav(7, 2000, seed=5)
    wav[4, 900:] = 0.0
    wav = torch.from_numpy(wav)
    lengths = torch.tensor([2000, 2000, 1500, 2000, 900, 31, 2000])
    assert tlaser.conv_groups(7, 2000) == 1
    want = model.feature_extractor(wav), model(wav, lengths, return_hidden=True)[0]
    monkeypatch.setattr(tlaser, "CONV_GROUP_SAMPLES", 3 * 2000)
    # the positional conv's 99 frames cover 99 x 20 samples
    assert tlaser.conv_groups(7, 2000) == tlaser.conv_groups(7, 99 * 20) == 3
    assert [len(p) for p in wav.tensor_split(3)] == [3, 2, 2]
    got = model.feature_extractor(wav), model(wav, lengths, return_hidden=True)[0]
    assert got[0].shape == want[0].shape == (7, 99, 32)
    assert got[1].shape == want[1].shape == (7, 99, 128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_conv_group_counts():
    """At the committed limit: a 600 s chunk (150 rows of 4 s, 30 of 20 s,
    13 of 45 s) in two groups, a four-card shard of it (38 rows of 4 s),
    the CLI's 150 s chunk (37 rows) and the trainer's 16 clips of 10 s in
    one; groups as even as ``tensor_split`` makes them."""
    want = {(150, 64000): 2, (38, 64000): 1, (30, 320000): 2, (13, 720000): 2,
            (37, 64000): 1, (16, 160000): 1, (10, 960000): 2, (8, 960000): 1}
    assert {shape: tlaser.conv_groups(*shape) for shape in want} == want
    assert [len(p) for p in torch.zeros(13, 1).tensor_split(2)] == [7, 6]
    assert tlaser.conv_groups(0, 64000) == 1 and tlaser.conv_groups(3, 10**8) == 3


@pytest.mark.parametrize("shards,limit,groups", [(1, None, 3), (1, 32000, 6), (2, None, 6),
                                                 (2, 16000, 8)])
def test_extractor_groups_counter(encoders, shards, limit, groups, monkeypatch):
    """``embed.extractor_groups`` counts each chunk's row groups, each
    shard's on a mesh: SPANS make one chunk of 4 rows of 16000 samples and
    two of 2 rows of 32000. The rows are those of one group a chunk."""
    from svecalign_tpu_torch.parallel.mesh import Mesh
    from svecalign_tpu_torch.utils import trace

    _, tm = encoders["fp32"]
    if shards > 1:
        tm = tm.with_mesh(Mesh(["cpu"] * shards))
    w = _document()
    want = tm.encode_spans(w, SPANS)
    if limit is not None:
        monkeypatch.setattr(tlaser, "CONV_GROUP_SAMPLES", limit)
    before = trace.counts["embed.extractor_groups"]
    got = tm.encode_spans(w, SPANS)
    assert trace.counts["embed.extractor_groups"] - before == groups
    np.testing.assert_array_equal(got, want)


# --- against transformers ---------------------------------------------------------------


def test_port_matches_hf_wav2vec2():
    """A random ``transformers.Wav2Vec2Model`` of the SpeechLASER family
    (layer-normed extractor, stable layer norm), converted with the JAX
    package's mapping: the port's fp32 hidden states match HF's within
    1e-3, the JAX-vs-HF test's tolerance (HF's LayerNorm epsilon is 1e-5,
    flax's 1e-6)."""
    transformers = pytest.importorskip("transformers")
    from tools.convert_torch_ckpt import map_hf_wav2vec2_state

    hf_cfg = transformers.Wav2Vec2Config(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
        conv_dim=[32, 32, 32], conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2], conv_bias=True,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
        feat_extract_norm="layer", hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, apply_spec_augment=False)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2Model(hf_cfg).eval()
    cfg = tlaser.LaserEncoderConfig(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_dim=64, encoder_layers=3,
        encoder_heads=4, encoder_ffn_dim=128, conv_pos_kernel=16, conv_pos_groups=4,
        dtype="float32")
    m = tlaser.LaserSpeechEncoder(cfg)
    flat = map_hf_wav2vec2_state(hf.state_dict(), num_heads=4)
    m.load_state_dict(tparams.params_from_jax(flat, m, source="hf"))
    wav = _wav(2, 8000)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
        got, _ = m.eval()(torch.from_numpy(wav), torch.tensor([8000, 8000]), return_hidden=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
