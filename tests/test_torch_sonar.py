"""The port's SONAR embedder (svecalign_tpu_torch.models) against the JAX
package's, module by module, from the same weights: the JAX numpy init,
saved with ``save_params_npz`` and read by both.

The config is small but meets the rel-key kernel's condition (d = 128,
2 heads of 64, 2 layers, FFN 256, pool 128, conv k = 31). JAX runs its
"xla" attention backend; the port its plain path on the CPU.

Tolerances, stated per check: fp32 agrees to float rounding (the
summation order of the FFT and the matmuls differs); bf16 rounds at other
places in the two frameworks (flax rounds a Dense's product before its
bias, cuBLAS/oneDNN round once), so it is held by relative error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.models import w2v_bert as jw2v
from svecalign_tpu.ops import fbank as jfbank
from svecalign_tpu_torch.models import param_utils as tparams
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.models import w2v_bert as tw2v
from svecalign_tpu_torch.ops import fbank as tfbank

torch.set_num_threads(2)

SMALL = dict(n_mels=80, model_dim=128, n_layers=2, n_heads=2, ffn_dim=256,
             conv_kernel=31, pool_dim=128)
DTYPES = ("float32", "bfloat16")


def jax_cfg(dtype="float32", **over):
    return jsonar.SonarEncoderConfig(**SMALL, dtype=dtype, attention_backend="xla", **over)


def port_cfg(dtype="float32", **over):
    return tsonar.SonarEncoderConfig(**SMALL, dtype=dtype, attention_backend="torch", **over)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params tree, npz path) of the JAX numpy init, seed 3."""
    model = jsonar.SonarSpeechEncoder(jax_cfg())
    args = (jnp.zeros((1, 50, 160)), jnp.ones((1, 50), bool))
    params = jparams.numpy_init(model, args, seed=3)
    path = tmp_path_factory.mktemp("sonar") / "small.npz"
    jparams.save_params_npz(params, str(path))
    return params, str(path)


@pytest.fixture(scope="module")
def port_models(weights):
    """The port's encoder per compute dtype, loaded from the npz."""
    flat = tparams.load_params_npz(weights[1])
    out = {}
    for dtype in DTYPES:
        m = tsonar.SonarSpeechEncoder(port_cfg(dtype))
        m.load_state_dict(tparams.params_from_jax(flat, m, source="npz"))
        out[dtype] = m.eval().requires_grad_(False)
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def feats_and_mask(seed, b=3, t=60, lens=(60, 41, 0)):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 160)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return feats, mask


# --- parameters ------------------------------------------------------------


def test_params_from_jax_round_trip(weights):
    """The JAX tree through an npz loads into the port with no missing or
    extra key, each leaf in the torch layout."""
    from flax.traverse_util import flatten_dict

    params, path = weights
    m = tsonar.SonarSpeechEncoder(port_cfg())
    state = tparams.params_from_jax(tparams.load_params_npz(path), m)
    res = m.load_state_dict(state, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params["params"]).items()}
    assert len(flat) == len(state)
    sd = m.state_dict()
    np.testing.assert_array_equal(
        sd["trunk.layers_1.ffn1.intermediate_dense.weight"].numpy(),
        flat["trunk/layers_1/ffn1/intermediate_dense/kernel"].T)
    np.testing.assert_array_equal(
        sd["trunk.layers_0.conv_module.depthwise_conv.weight"].numpy(),
        flat["trunk/layers_0/conv_module/depthwise_conv/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["trunk.layers_0.self_attn_layer_norm.weight"].numpy(),
        flat["trunk/layers_0/self_attn_layer_norm/scale"])
    np.testing.assert_array_equal(
        sd["trunk.layers_0.self_attn.distance_embedding"].numpy(),
        flat["trunk/layers_0/self_attn/distance_embedding"])
    np.testing.assert_array_equal(sd["pooler.query"].numpy(), flat["pooler/query"])


def test_random_init_equals_jax_numpy_init(weights):
    """No checkpoint: the port draws the JAX package's numpy init for the
    same seed, leaf for leaf."""
    m = tsonar.SonarSpeechEncoder(port_cfg())
    want = tparams.params_from_jax(tparams.load_params_npz(weights[1]), m)
    got = tparams.params_from_jax({}, m, seed=3)
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def test_params_from_jax_rejects_bad_leaves(weights):
    flat = tparams.load_params_npz(weights[1])
    m = tsonar.SonarSpeechEncoder(port_cfg())
    with pytest.raises(KeyError, match="unknown parameter"):
        tparams.params_from_jax({**flat, "pooler/extra/kernel": np.zeros(3)}, m)
    bad = dict(flat)
    bad["pooler/q_proj/kernel"] = np.zeros((128, 64), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tparams.params_from_jax(bad, m)


def test_missing_leaves_drawn_and_logged(weights, caplog):
    """A trunk-only checkpoint: the pooler is drawn with the numpy init and
    a warning names the gap."""
    import logging

    flat = {k: v for k, v in tparams.load_params_npz(weights[1]).items()
            if not k.startswith("pooler/")}
    m = tsonar.SonarSpeechEncoder(port_cfg())
    with caplog.at_level(logging.WARNING):
        state = tparams.params_from_jax(flat, m, source="trunk.npz")
    assert any("not in the checkpoint" in r.message for r in caplog.records)
    assert torch.isfinite(state["pooler.q_proj.weight"]).all()


# --- frontend ----------------------------------------------------------------


def test_fbank_device_matches_jax():
    """Batched fbank against the JAX fbank per row, fp32: log-mels agree to
    1e-3 absolute (float rounding of the FFT, amplified by the log where a
    bin's energy is small)."""
    rng = np.random.default_rng(0)
    n_frames = 90
    wav = (rng.standard_normal((3, 400 + 89 * 160)) * 3000).astype(np.float32)
    wav[2, 4000:] = 0.0  # silence: the log floor
    want = np.stack([np.asarray(jfbank.fbank_device(jnp.asarray(w), 16000, 80, 400, 160, n_frames))
                     for w in wav])
    got = tfbank.fbank_device(torch.from_numpy(wav), 16000, 80, 400, 160, n_frames).numpy()
    assert got.shape == (3, n_frames, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_sonar_frontend_matches_jax():
    """Frontend features (normalised over valid frames, stride-2 stacked)
    and the stacked mask, fp32: features to 1e-3 absolute (normalised
    log-mels, unit scale), the mask exactly; a length-0 row stays finite."""
    rng = np.random.default_rng(1)
    n_frames = 100
    wav = (rng.standard_normal((3, 400 + 99 * 160)) * 0.1).astype(np.float32)
    lengths = np.array([100, 37, 0], np.int32)
    jf, jm = jsonar.sonar_frontend(jnp.asarray(wav), jnp.asarray(lengths), n_frames, 80)
    tf, tm = tsonar.sonar_frontend(torch.from_numpy(wav), torch.from_numpy(lengths), n_frames, 80)
    assert tuple(tf.shape) == (3, 50, 160)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert torch.isfinite(tf).all()
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-3)


# --- trunk and pooler ----------------------------------------------------------

# max |port - JAX| / max |JAX| per compute dtype: fp32 rounding only;
# bf16 a few bf16 steps (2^-8 = 3.9e-3 each) accumulated over the layers
REL_TOL = {"float32": 5e-6, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_matches_jax(weights, port_models, dtype):
    feats, mask = feats_and_mask(5)
    x = (feats[..., :128] * 0.5).astype(np.float32)
    lengths = mask.sum(1).astype(np.int32)
    bias = np.where(mask[:, None, None, :], 0.0, np.finfo(np.float32).min).astype(np.float32)
    jdt = jnp.dtype(dtype)
    layer = jw2v.W2vBertEncoderLayer(jax_cfg(dtype).trunk_config())
    want = layer.apply({"params": weights[0]["params"]["trunk"]["layers_0"]},
                       jnp.asarray(x, jdt), jnp.asarray(bias), jnp.asarray(mask), None,
                       jnp.asarray(lengths))
    tdt = tw2v.DTYPES[dtype]
    got = port_models[dtype].trunk.layers_0(
        torch.from_numpy(x).to(tdt), torch.from_numpy(bias), torch.from_numpy(mask),
        torch.from_numpy(lengths))
    assert got.dtype == tdt
    valid = mask[:, :, None]
    want = np.where(valid, np.asarray(want.astype(jnp.float32)), 0)
    got = np.where(valid, got.float().numpy(), 0)
    assert rel_err(got, want) < REL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_trunk_and_pooler_match_jax(weights, port_models, dtype):
    """The whole W2vBertModel and the AttentionPooler on its output (each
    fed the same input), valid rows; padding rows stay finite."""
    feats, mask = feats_and_mask(6)
    p = weights[0]["params"]
    jcfg = jax_cfg(dtype)
    jx = jw2v.W2vBertModel(jcfg.trunk_config()).apply(
        {"params": p["trunk"]}, jnp.asarray(feats), jnp.asarray(mask))
    model = port_models[dtype]
    tx = model.trunk(torch.from_numpy(feats), torch.from_numpy(mask))
    assert torch.isfinite(tx).all()
    valid = mask[:, :, None]
    jx32 = np.asarray(jx.astype(jnp.float32))
    assert rel_err(np.where(valid, tx.float().numpy(), 0), np.where(valid, jx32, 0)) < REL_TOL[dtype]

    # the pooler, both fed the JAX trunk output
    jpool = jsonar.AttentionPooler(jcfg).apply({"params": p["pooler"]}, jx, jnp.asarray(mask))
    tpool = model.pooler(torch.from_numpy(jx32).to(tw2v.DTYPES[dtype]), torch.from_numpy(mask))
    assert tpool.dtype == torch.float32 and torch.isfinite(tpool).all()
    assert rel_err(tpool.numpy(), np.asarray(jpool)) < REL_TOL[dtype]


def test_attention_backend_rules():
    cfg = tw2v.W2vBertConfig(hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=64, attention_backend="cuda")
    model = tw2v.W2vBertModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        model(torch.zeros(1, 8, 160), torch.ones(1, 8, dtype=torch.bool))
    model.set_attention_backend("auto")  # CPU tensors: the plain path
    before = dict(tw2v.ATTENTION_CALLS)
    model(torch.zeros(1, 8, 160), torch.ones(1, 8, dtype=torch.bool))
    assert tw2v.ATTENTION_CALLS["torch"] == before["torch"] + 1
    assert tw2v.ATTENTION_CALLS["cuda"] == before["cuda"]
    # the 'relative' flavor builds and runs the plain path, also under "auto"
    rel = tw2v.W2vBertModel(tw2v.W2vBertConfig(
        hidden_size=128, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        position_embeddings_type="relative"))
    before = dict(tw2v.ATTENTION_CALLS)
    out = rel(torch.zeros(1, 8, 160), torch.ones(1, 8, dtype=torch.bool))
    assert out.shape == (1, 8, 128) and torch.isfinite(out).all()
    assert tw2v.ATTENTION_CALLS["torch"] == before["torch"] + 1


# --- the Transformer-XL 'relative' flavor ------------------------------------------


@pytest.mark.parametrize("t", [1, 2, 7, 60, 333])
def test_relative_table_bit_equal(t):
    got = tw2v.sinusoidal_rel_pe(t, 128)
    want = jw2v._sinusoidal_rel_pe(t, 128)
    assert got.dtype == want.dtype == np.float32 and got.shape == (2 * t - 1, 128)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def relative_models(tmp_path_factory):
    """(JAX params, port encoder per dtype) of the 'relative' flavor, from
    the JAX numpy init (seed 4; pos_bias_u/v drawn non-zero)."""
    model = jsonar.SonarSpeechEncoder(jax_cfg(position_embeddings_type="relative"))
    params = jparams.numpy_init(model, (jnp.zeros((1, 50, 160)), jnp.ones((1, 50), bool)),
                                seed=4)
    path = tmp_path_factory.mktemp("sonar_rel") / "rel.npz"
    jparams.save_params_npz(params, str(path))
    flat = tparams.load_params_npz(str(path))
    out = {}
    for dtype in DTYPES:
        m = tsonar.SonarSpeechEncoder(port_cfg(dtype, position_embeddings_type="relative"))
        m.load_state_dict(tparams.params_from_jax(flat, m, source="npz"))
        out[dtype] = m.eval().requires_grad_(False)
    assert {"pos_bias_u", "pos_bias_v"} <= {
        k.rsplit(".", 1)[-1] for k in out["float32"].state_dict()}
    return params, out


@pytest.mark.parametrize("dtype", DTYPES)
def test_relative_trunk_and_encoder_match_jax(relative_models, dtype):
    """W2vBertModel and the whole SONAR encoder (trunk + pooler) of the
    'relative' flavor against JAX, valid rows."""
    params, models = relative_models
    feats, mask = feats_and_mask(8)
    jcfg = jax_cfg(dtype, position_embeddings_type="relative")
    jx = jw2v.W2vBertModel(jcfg.trunk_config()).apply(
        {"params": params["params"]["trunk"]}, jnp.asarray(feats), jnp.asarray(mask))
    model = models[dtype]
    before = dict(tw2v.ATTENTION_CALLS)
    tx = model.trunk(torch.from_numpy(feats), torch.from_numpy(mask))
    assert tw2v.ATTENTION_CALLS["torch"] == before["torch"] + 2
    assert tx.dtype == tw2v.DTYPES[dtype] and torch.isfinite(tx).all()
    valid = mask[:, :, None]
    jx32 = np.asarray(jx.astype(jnp.float32))
    assert rel_err(np.where(valid, tx.float().numpy(), 0), np.where(valid, jx32, 0)) < REL_TOL[dtype]

    rows = mask.any(1)
    jemb = jsonar.SonarSpeechEncoder(jcfg).apply(params, jnp.asarray(feats), jnp.asarray(mask))
    temb = model(torch.from_numpy(feats), torch.from_numpy(mask))
    assert rel_err(temb.numpy()[rows], np.asarray(jemb)[rows]) < REL_TOL[dtype]


def test_chip_smoke_relative_encoder_rehearsal(weights):
    """chip_smoke's relative-flavor encoders, built from a loaded bf16
    model on the CPU: the flavor's leaves drawn, the rel-key tables dropped,
    and the bf16 encoder's rows at cosine >= 0.99 to the fp32 one's."""
    import chip_smoke
    from svecalign_tpu_torch.models import encode_common

    model = tsonar.SonarSpeechModel(port_cfg("bfloat16"), ckpt_path=weights[1], batch_size=2,
                                    device="cpu")
    rel, ref = chip_smoke.sonar_relative_encoder(model)
    keys = set(rel.state_dict())
    assert "trunk.layers_0.self_attn.pos_bias_u" in keys
    assert not any("distance_embedding" in k for k in keys)
    assert rel.trunk.layers_0.self_attn.linear_pos.weight.dtype == torch.bfloat16
    assert ref.trunk.layers_0.self_attn.linear_pos.weight.dtype == torch.float32
    wav = [np.random.default_rng(k).standard_normal(16000 + 4000 * k).astype(np.float32) * 0.1
           for k in range(2)]
    bucket = model._bucket(1 + (len(wav[1]) - 400) // 160)
    padded, scales = encode_common.stage_rows(wav, 2, model._bucket_width(bucket), True)
    lengths = torch.tensor([min(1 + (len(w) - 400) // 160, bucket) for w in wav],
                           dtype=torch.int32)
    args = (torch.from_numpy(padded), torch.from_numpy(scales), lengths, bucket, lambda k: None)
    got = model._forward(rel, *args).numpy()
    want = model._forward(ref, *args).numpy()
    assert np.isfinite(got).all()
    assert chip_smoke._row_cosines(got, want).min() >= chip_smoke.MIN_COSINE


# --- encode and encode_spans ----------------------------------------------------

SPANS = [
    (0, 16000),            # exactly a bucket's worth
    (8000, 38000),         # crosses 1 s blocks
    (30000, 55000),        # mid-file
    (20 * 16000, 20 * 16000 + 24000),  # quiet region
    (600000, 624000),      # tail
    (632000, 640000),      # runs to the last sample
    (632000, 700000),      # overruns the file end (host slicing truncates)
    (100, 300),            # shorter than one frame: a length-0 row
]


def _wave(seconds=40, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    w[20 * 16000 : 25 * 16000] *= 0.01  # per-block scales differ from per-window
    return w


def _small_buckets(m):
    m.BUCKET_FRAMES = (100, 250)
    m.WAVE_BUCKETS_S = (10, 41)
    return m


@pytest.fixture(scope="module")
def encoders(weights):
    """(JAX, port) SonarSpeechModel per upload dtype, fp32 compute, from
    the same npz, with shrunk buckets."""
    out = {}
    for up in ("fp32", "int16"):
        j = jsonar.SonarSpeechModel(jax_cfg(), ckpt_path=weights[1], batch_size=4, upload_dtype=up)
        t = tsonar.SonarSpeechModel(port_cfg(), ckpt_path=weights[1], batch_size=4,
                                    upload_dtype=up, device="cpu")
        out[up] = (_small_buckets(j), _small_buckets(t))
    return out


# port vs JAX rows, fp32 compute: max |diff| / max |row| (the pooled rows
# inherit the fbank's float rounding through the trunk)
ENCODE_TOL = 5e-5


@pytest.mark.parametrize("upload", ["fp32", "int16"])
def test_encode_and_spans_match_jax(encoders, upload):
    jm, tm = encoders[upload]
    w = _wave()
    pieces = [w[s:e] for s, e in SPANS]
    want = jm.encode(pieces)
    got = tm.encode(pieces)
    assert got.shape == (len(SPANS), 128) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert rel_err(got, want) < ENCODE_TOL

    want_s = jm.encode_spans(w, SPANS)
    got_s = tm.encode_spans(w, SPANS)
    assert rel_err(got_s, want_s) < ENCODE_TOL
    if upload == "fp32":
        # the JAX contract: fp32 upload makes encode_spans equal encode
        np.testing.assert_array_equal(got_s, got)
    # fp16_pull: the device cast equals the host cast
    np.testing.assert_array_equal(tm.encode_spans(w, SPANS, fp16_pull=True),
                                  got_s.astype(np.float16))


def test_encode_spans_long_wave_falls_back(encoders):
    _, tm = encoders["fp32"]
    w = _wave()
    old = tm.WAVE_BUCKETS_S
    tm.WAVE_BUCKETS_S = (1,)
    try:
        got = tm.encode_spans(w, SPANS[:3])
    finally:
        tm.WAVE_BUCKETS_S = old
    np.testing.assert_array_equal(got, tm.encode([w[s:e] for s, e in SPANS[:3]]))


def test_assemble_matches_jax():
    """Per-block quantize on the host, dequant + window gather + per-row
    requantize on the device: identical int16 rows, scales and lengths."""
    from svecalign_tpu.ops import assemble as jasm
    from svecalign_tpu_torch.ops import assemble as tasm

    w = _wave(12)
    wave_len, width, slack = 16 * 16000, 16000, 20000
    idx = np.array([[0, 16000, 99], [5000, 12000, 74], [180000, 15000, 93], [0, 0, 0]], np.int32)
    for fp32 in (False, True):
        jw, js = jasm.quantize_wave(w, wave_len, fp32)
        tw, ts = tasm.quantize_wave(w, wave_len, fp32)
        np.testing.assert_array_equal(tw, jw)
        jd = jasm.get_dequant(wave_len, slack)(jnp.asarray(jw), jnp.asarray(js))
        td = tasm.dequant(torch.from_numpy(tw), torch.from_numpy(ts), slack)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        jr = jasm.get_assembler(wave_len + slack, width, fp32)(jd, jnp.asarray(idx))
        tr = tasm.assemble(td, torch.from_numpy(idx).long(), width, fp32)
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
