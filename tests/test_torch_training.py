"""The port's encoder training (svecalign_tpu_torch.models.training) and
its tensor-parallel rules (parallel/mesh.py) against the JAX package's,
at the tiny geometry of ``__graft_entry__.dryrun_multichip`` in fp32,
from the same weights (the JAX numpy init, carried across by
``params_from_jax``).

Tolerances, stated per check:
- ``info_nce_loss``: rtol 1e-6;
- the loss of a step: 1e-5; every gradient: atol 1e-6 of ``jax.grad``;
- parameters after each step: within 2 lr (and 4 ulp of their own
  rounding) of JAX's everywhere (Adam's
  first steps move a parameter by about lr sign(g), and a gradient near
  zero may take either sign under another summation order: JAX's own
  one-device and mesh steps differ so), and within 1e-5 wherever |g| >
  1e-4 at every step so far;
- the 8-shard mesh at ``model_parallel=2`` (JAX on conftest's 8 CPU
  devices, the port on 8 CPU shards) to the same bounds, against the
  one-device port step and against JAX's ``shard_train_step``;
- ``save_params_npz``: JAX's forward on the port's file within 5e-6.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.models import training as jtraining
from svecalign_tpu.parallel import mesh as jmesh
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import param_utils as tparams
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.models import training as ttraining
from svecalign_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

# __graft_entry__.py:51-58
CFG = dict(conv_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)), encoder_dim=64,
           encoder_layers=2, encoder_heads=4, encoder_ffn_dim=128, conv_pos_kernel=16,
           conv_pos_groups=4, dtype="float32")
N_SAMPLES = 4000
BATCH = 8  # the 8-device mesh at model_parallel=2: 4 data shards x 2 rows
N_STEPS = 3
TCFG = dict(learning_rate=1e-4, weight_decay=0.01, temperature=0.05)
LR = TCFG["learning_rate"]


def make_batch(seed, batch=BATCH, n=N_SAMPLES):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("src", "tgt"):
        out[f"{side}_wav"] = rng.standard_normal((batch, n)).astype(np.float32)
        out[f"{side}_len"] = rng.integers(n // 2, n + 1, batch).astype(np.int32)
    return out


BATCHES = [make_batch(10 + k) for k in range(N_STEPS)]


def flat_np(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree["params"]).items()}


def jax_run(step, params, opt_state, grad_fn):
    """JAX's loss, gradients (at the step's input) and params after each
    step, as torch-layout host arrays keyed like the port's state_dict."""
    out = []
    for b in BATCHES:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads = grad_fn(params, jb)
        params, opt_state, loss = step(params, opt_state, jb)
        out.append((float(loss), flat_np(grads), flat_np(jax.device_get(params))))
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX numpy init (seed 0) written as npz, and JAX's one-device
    and 8-device (model_parallel=2) runs of N_STEPS steps from it."""
    cfg = jlaser.LaserEncoderConfig(**CFG)
    model = jlaser.LaserSpeechEncoder(cfg)
    args = (jnp.zeros((1, N_SAMPLES), jnp.float32), jnp.array([N_SAMPLES]))
    params = jparams.numpy_init(model, args, seed=0)
    path = tmp_path_factory.mktemp("train") / "init.npz"
    jparams.save_params_npz(params, str(path))

    tcfg = jtraining.TrainConfig(**TCFG)
    opt = optax.adamw(tcfg.learning_rate, weight_decay=tcfg.weight_decay)

    def loss_fn(p, b):
        return jtraining.info_nce_loss(model.apply(p, b["src_wav"], b["src_len"]),
                                       model.apply(p, b["tgt_wav"], b["tgt_len"]),
                                       tcfg.temperature)

    grad_fn = jax.jit(jax.grad(loss_fn))
    one = jax_run(jax.jit(jtraining.make_train_step(model, opt, tcfg)), params,
                  opt.init(params), grad_fn)
    mesh = jmesh.make_mesh(n_devices=8, model_parallel=2)
    step, sp, so = jtraining.shard_train_step(model, opt, tcfg, mesh, params, opt.init(params))
    sharded = jax_run(step, sp, so, grad_fn)
    return {"npz": str(path), "params": params, "model": model, "one": one,
            "sharded": sharded, "mesh": mesh}


def port_model(npz, dtype="float32"):
    model = tlaser.LaserSpeechEncoder(tlaser.LaserEncoderConfig(**{**CFG, "dtype": dtype}))
    model.load_state_dict(tparams.params_from_jax(tparams.load_params_npz(npz), model))
    return model


def port_run(npz, mesh=None, dtype="float32"):
    """The port's (loss, grads, params) after each step, in the flax
    layout (``params_to_jax``)."""
    model = port_model(npz, dtype)
    tcfg = ttraining.TrainConfig(**TCFG)
    opt = ttraining.make_optimizer(model, tcfg)
    step = (ttraining.make_train_step(model, opt, tcfg) if mesh is None
            else ttraining.shard_train_step(model, opt, tcfg, mesh))
    out = []
    for b in BATCHES:
        loss = float(step(b))
        grads = tparams.params_to_jax(_grads_as_params(model))
        out.append((loss, grads, tparams.params_to_jax(model)))
    return out


def _grads_as_params(model):
    """A copy of ``model`` whose parameters are its gradients, for
    ``params_to_jax``'s layout map."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(out.parameters(), model.parameters()):
            p.copy_(g.grad)
    return out


@pytest.fixture(scope="module")
def port_one(jax_side):
    return port_run(jax_side["npz"])


@pytest.fixture(scope="module")
def port_sharded(jax_side):
    return port_run(jax_side["npz"], tmesh.make_mesh(8, model_parallel=2, device="cpu"))


def assert_run_close(got, want, n_steps=N_STEPS):
    """``got`` and ``want`` runs agree to the module's bounds, step by step."""
    big = None  # where |g| > 1e-4 at every step so far
    for s in range(n_steps):
        (gl, gg, gp), (wl, wg, wp) = got[s], want[s]
        assert abs(gl - wl) <= 1e-5, (s, gl, wl)
        assert gg.keys() == wg.keys() == gp.keys() == wp.keys()
        step_big = {}
        for k in wg:
            np.testing.assert_allclose(gg[k], wg[k], rtol=0, atol=1e-6, err_msg=f"grad {k}, step {s}")
            step_big[k] = np.abs(wg[k]) > 1e-4
        big = step_big if big is None else {k: big[k] & step_big[k] for k in big}
        for k in wp:
            d = np.abs(gp[k] - wp[k])
            assert (d <= 2 * LR + 4 * np.spacing(np.abs(wp[k]))).all(), (k, s, d.max())
            assert (d[big[k]] <= 1e-5).all(), (k, s, d[big[k]].max())


# --- the loss and the steps -----------------------------------------------------------


@pytest.mark.parametrize("b,d,seed", [(8, 64, 0), (5, 1024, 1)])
def test_info_nce_loss_matches_jax(b, d, seed):
    rng = np.random.default_rng(seed)
    e0 = rng.standard_normal((b, d)).astype(np.float32)
    # partly aligned rows: a loss of order 1 (near 0, rtol reads rounding)
    e1 = (0.1 * e0 + rng.standard_normal((b, d))).astype(np.float32)
    want = float(jtraining.info_nce_loss(jnp.asarray(e0), jnp.asarray(e1), 0.05))
    got = float(ttraining.info_nce_loss(torch.from_numpy(e0), torch.from_numpy(e1), 0.05))
    assert 0.1 < want < 10
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_one_step_matches_jax(jax_side, port_one):
    assert_run_close(port_one, jax_side["one"], n_steps=1)


def test_three_steps_match_jax(jax_side, port_one):
    assert_run_close(port_one, jax_side["one"])
    # the three batches moved the loss
    assert len({round(loss, 6) for loss, _, _ in port_one}) == N_STEPS


def test_jax_mesh_step_matches_its_one_device_step(jax_side):
    """The bounds hold for JAX against itself (one device and the mesh)."""
    assert_run_close(jax_side["sharded"], jax_side["one"])


def test_sharded_step_matches_one_device(port_sharded, port_one):
    assert_run_close(port_sharded, port_one)


def test_sharded_step_matches_jax_sharded(jax_side, port_sharded):
    assert_run_close(port_sharded, jax_side["sharded"])


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)])
def test_mesh_shapes_match_one_device(jax_side, port_one, grid):
    """Data-only, model-only and both: one step each equals the one-device step."""
    mesh = tmesh.Mesh([["cpu"] * grid[1]] * grid[0])
    assert_run_close(port_run(jax_side["npz"], mesh)[:1], port_one, n_steps=1)


def test_bf16_sharded_step_close_to_one_device(jax_side):
    """bf16 compute: the tensor-parallel reduce sums in fp32, so the mesh's
    loss stays within bf16 rounding of the one-device loss."""
    mesh = tmesh.make_mesh(4, model_parallel=2, device="cpu")
    one = port_run(jax_side["npz"], dtype="bfloat16")
    sharded = port_run(jax_side["npz"], mesh, dtype="bfloat16")
    for (gl, _, gp), (wl, _, wp) in zip(sharded, one):
        assert np.isfinite(gl) and abs(gl - wl) <= 3e-2 * abs(wl)
        for k in wp:
            d = np.abs(gp[k] - wp[k])
            assert (d <= 2 * N_STEPS * LR + 4 * np.spacing(np.abs(wp[k]))).all(), k


def test_step_profile(jax_side, monkeypatch):
    """SVECALIGN_TRAIN_PROFILE=1 fills step_seconds by phase; off, nothing."""
    model = port_model(jax_side["npz"])
    tcfg = ttraining.TrainConfig(**TCFG)
    opt = ttraining.make_optimizer(model, tcfg)
    ttraining.step_seconds.clear()
    ttraining.make_train_step(model, opt, tcfg)(BATCHES[0])
    assert ttraining.step_seconds == {}
    monkeypatch.setenv(ttraining.TRAIN_PROFILE_ENV, "1")
    ttraining.shard_train_step(model, opt, tcfg, tmesh.Mesh([["cpu", "cpu"]]))(BATCHES[0])
    assert set(ttraining.step_seconds) == {"forward", "tp_reduce", "backward", "optimizer"}
    assert all(v >= 0 for v in ttraining.step_seconds.values())
    ttraining.step_seconds.clear()


def test_shard_train_step_checks(jax_side):
    model = port_model(jax_side["npz"])
    tcfg = ttraining.TrainConfig(**TCFG)
    opt = ttraining.make_optimizer(model, tcfg)
    with pytest.raises(ValueError, match="4 heads .* do not split over 8 model shards"):
        ttraining.shard_train_step(model, opt, tcfg, tmesh.make_mesh(8, model_parallel=8,
                                                                     device="cpu"))
    with pytest.raises(ValueError, match="first device"):
        ttraining.shard_train_step(model, opt, tcfg, tmesh.Mesh([["meta", "meta"]]))
    step = ttraining.shard_train_step(model, opt, tcfg, tmesh.make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="does not split evenly over 3 data shards"):
        step(BATCHES[0])


# --- the partition rules ---------------------------------------------------------------


def _torch_axis(spec, kind, ndim):
    """The torch axis of a flax PartitionSpec's "model" entry."""
    axes = [a for a, name in enumerate(tuple(spec) + (None,) * ndim) if name == "model"]
    if not axes:
        return None
    (a,) = axes
    if kind == "dense":
        return 1 - a
    if kind == "conv":
        return 2 - a
    if kind == "heads_in":  # (d, heads, dh) -> (heads dh, d)
        return {0: 1, 1: 0}[a]
    if kind == "heads_out":  # (heads, dh, d) -> (d, heads dh)
        return {0: 1, 2: 0}[a]
    return {"heads_bias": 0}.get(kind, a)


@pytest.mark.parametrize("which,n_split", [("laser", 12), ("relative_key", 3), ("relative", 4)])
def test_encoder_param_spec_matches_jax_on_every_leaf(jax_side, which, n_split):
    """Every leaf of the tiny LASER (6 split a layer) and of a one-layer
    SONAR (q, k, v and, in the 'relative' flavor, linear_pos)."""
    if which == "laser":
        model = port_model(jax_side["npz"])
        flat = flat_np(jax_side["params"])
    else:
        cfg = dict(n_mels=80, model_dim=128, n_layers=1, n_heads=2, ffn_dim=256,
                   position_embeddings_type=which)
        model = tsonar.SonarSpeechEncoder(tsonar.SonarEncoderConfig(**cfg))
        jm = jsonar.SonarSpeechEncoder(jsonar.SonarEncoderConfig(**cfg))
        flat = flat_np(jparams.numpy_init(jm, (jnp.zeros((1, 50, 160)), jnp.ones((1, 50), bool))))
    state = model.state_dict()
    leaves = tparams._leaf_map(model)
    assert len(leaves) == len(flat)
    split = 0
    for path, key, kind, _ in leaves:
        want = jmesh.encoder_param_spec(path, flat["/".join(path)])
        got = tmesh.encoder_param_spec(key, state[key])
        assert got == _torch_axis(want, kind, len(path)), (key, want, got)
        split += got is not None
    assert split == n_split


def test_shard_params_layout(jax_side):
    model = port_model(jax_side["npz"])
    mesh = tmesh.make_mesh(4, model_parallel=2, device="cpu")
    state = dict(model.named_parameters())
    shards = tmesh.shard_params(state, mesh)
    assert len(shards) == 2 and all(len(row) == 2 for row in shards)
    for key, value in state.items():
        axis = tmesh.encoder_param_spec(key, value)
        for row in shards:
            if axis is None:
                assert row[0][key] is row[1][key]
                torch.testing.assert_close(row[0][key], value, rtol=0, atol=0)
            else:
                assert row[0][key].shape[axis] == value.shape[axis] // 2
                torch.testing.assert_close(torch.cat([row[0][key], row[1][key]], axis), value,
                                           rtol=0, atol=0)
    # the shards' gradients reach the master
    sum(t.sum() for row in shards for p in row for t in p.values()).backward()
    assert all(p.grad is not None for p in model.parameters())


def test_mesh_grid_and_data_devices():
    mesh = tmesh.Mesh([["cpu", "cpu"]])
    assert mesh.grid == [[torch.device("cpu")] * 2] and mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="tensor parallelism, for training"):
        mesh.data_devices


# --- weights both ways and the fresh init -----------------------------------------------


def test_params_to_jax_inverts_params_from_jax(jax_side):
    model = port_model(jax_side["npz"])
    got = tparams.params_to_jax(model)
    want = tparams.load_params_npz(jax_side["npz"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_save_params_npz_loads_in_jax(jax_side, tmp_path):
    """The port's file read by JAX's load_params_npz: JAX's forward on it
    equals the port's forward within 5e-6 (a trained, not the initial,
    model)."""
    model = port_model(jax_side["npz"])
    tcfg = ttraining.TrainConfig(**TCFG)
    ttraining.make_train_step(model, ttraining.make_optimizer(model, tcfg), tcfg)(BATCHES[0])
    path = tmp_path / "encoder_final.npz"
    tparams.save_params_npz(model, str(path))
    b = BATCHES[1]
    with torch.no_grad():
        got = model(torch.from_numpy(b["src_wav"]), torch.from_numpy(b["src_len"])).numpy()
    want = jax_side["model"].apply(jparams.load_params_npz(str(path)), jnp.asarray(b["src_wav"]),
                                   jnp.asarray(b["src_len"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-6)


def test_fresh_init_is_flax_default_and_seeded():
    cfg = tlaser.LaserEncoderConfig(**CFG)
    m0, opt = ttraining.make_train_state(cfg, seed=3, device="cpu")
    m1, _ = ttraining.make_train_state(cfg, seed=3, device="cpu")
    m2, _ = ttraining.make_train_state(cfg, seed=4, device="cpu")
    assert isinstance(opt, torch.optim.AdamW) and len(opt.param_groups) == 1
    assert opt.param_groups[0]["weight_decay"] == 0.01 and opt.param_groups[0]["lr"] == 1e-4
    s0, s1, s2 = m0.state_dict(), m1.state_dict(), m2.state_dict()
    for key, w in s0.items():
        torch.testing.assert_close(w, s1[key], rtol=0, atol=0)
        if key.endswith("bias"):
            assert (w == 0).all(), key
        elif w.dim() == 1:
            assert (w == 1).all(), key
        else:
            assert not torch.equal(w, s2[key]), key
            fan_in = int(np.prod(w.shape[1:]))
            bound = 2 * fan_in ** -0.5 / ttraining.TRUNC_NORMAL_STD
            assert w.abs().max() <= bound * (1 + 1e-6), key
            if w.numel() >= 4096:  # unit variance after truncation, as flax's lecun_normal
                assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.05, key
