"""The LayerNorm of the speech encoders on the CPU
(``models/w2v_bert.py::FlaxLayerNorm``, ``ops/layer_norm.py``,
``ops/layer_norm_cuda.py``): which calls go to the kernel's wrapper, the
fused arguments against the composition they replace (bit-equal), the
wrapper's layouts and refusals, the channels-first kernel's plan, the
tracer counter of its launches, and the norms a chunk's forward runs.
The kernel itself is held to the plain version on the card
(``tests/test_torch_layer_norm_card.py``)."""

import pytest
import torch

from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import w2v_bert as tw2v
from svecalign_tpu_torch.ops import _build, layer_norm, layer_norm_cuda
from svecalign_tpu_torch.utils import trace

STATIC_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block takes without an opt-in
H100_SMEM_SM = 233472  # shared memory of one SM, 1 KB reserved a block
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _norm(dim, axis=-1, channel_axis=-1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    norm = tw2v.FlaxLayerNorm(dim, 1e-6, axis, channel_axis)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(dim, generator=gen))
        norm.bias.copy_(0.2 * torch.randn(dim, generator=gen))
    return norm.requires_grad_(False)


def _x(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(shape, generator=gen) + 0.5).to(dtype)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, x, weight, bias, eps, axis, dtype, conv_bias, gelu_out):
        self.calls.append((tuple(x.shape), axis, dtype, conv_bias is not None, gelu_out))
        return layer_norm.flax_layer_norm(x, weight, bias, eps, axis, axis, dtype, conv_bias,
                                          gelu_out)


@pytest.mark.parametrize("case,route", [
    ("inference_rows", "kernel"),
    ("inference_channels_first", "kernel"),
    ("no_grad_weights_trained", "kernel"),
    ("cpu_tensor", "plain"),
    ("records_grad", "kernel"),
    ("records_grad_input", "kernel"),
    ("group_norm", "raises"),
    ("group_norm_cpu", "plain"),
])
def test_dispatch_rule(case, route, monkeypatch):
    """A CUDA tensor goes to the kernel's wrapper whether or not autograd
    records the call (the trainer's forward); a CPU tensor takes the plain
    arithmetic; the GroupNorm form raises on a CUDA tensor and runs the
    plain arithmetic on the CPU. A CUDA tensor is played by ``is_cuda``
    patched true on a CPU tensor."""
    rec = _Recorder()
    monkeypatch.setattr(layer_norm_cuda, "flax_layer_norm_cuda", rec)
    if case not in ("cpu_tensor", "group_norm_cpu"):
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    axis = channel_axis = -1
    x = _x((2, 5, 16), torch.float32)
    norm = _norm(16)
    grad = False
    if case == "inference_channels_first":
        axis = channel_axis = 1
        norm = _norm(16, 1, 1)
        x = _x((2, 16, 5), torch.float32)
    elif case == "no_grad_weights_trained":
        norm.requires_grad_(True)  # a trainer's weights, under no_grad
    elif case == "records_grad":
        norm.requires_grad_(True)
        grad = True
    elif case == "records_grad_input":
        x.requires_grad_(True)
        grad = True
    elif case.startswith("group_norm"):
        axis, channel_axis = 2, 1
        norm = _norm(16, 2, 1)
        x = _x((2, 16, 5), torch.float32)
    if route == "raises":
        with pytest.raises(ValueError, match="GroupNorm form"):
            norm(x, torch.bfloat16)
        assert rec.calls == []
        return
    with torch.set_grad_enabled(grad):
        if case == "no_grad_weights_trained":
            with torch.no_grad():
                y = norm(x, torch.bfloat16)
        else:
            y = norm(x, torch.bfloat16)
    assert (len(rec.calls) == 1) == (route == "kernel"), rec.calls
    if route == "kernel":
        assert rec.calls[0] == (tuple(x.shape), axis % 3, torch.bfloat16, False, False)
    want = layer_norm.flax_layer_norm(x.detach(), norm.weight.detach(), norm.bias.detach(),
                                      norm.eps, axis, channel_axis, torch.bfloat16)
    assert torch.equal(y.detach(), want)
    assert y.requires_grad == (case in ("records_grad", "records_grad_input"))


def _plain_launch(calls):
    """A stand-in for the kernel's launch on a CPU tensor: the plain
    version, counted."""
    def launch(x, weight, bias, conv_bias, eps, axis, out_dtype, gelu_out, kind):
        calls.append(kind)
        return layer_norm.flax_layer_norm(x, weight, bias, eps, axis, axis, out_dtype,
                                          conv_bias, gelu_out).contiguous()
    return launch


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["rows", "channels_first", "transposed"])
def test_grad_recording_call_launches_and_differentiates_the_plain_version(form, dtype, fused,
                                                                          monkeypatch):
    """Under autograd the wrapper launches (the launch played by the plain
    version on the CPU) and its backward gives the plain version's
    gradients, bit for bit, for ``x``, the scale, the bias and the conv
    bias; inputs that need no gradient get none."""
    calls = []
    monkeypatch.setattr(layer_norm_cuda, "_launch", _plain_launch(calls))
    dt = DTYPES[dtype]
    axis, shape = {"rows": (2, (3, 7, 24)), "channels_first": (1, (3, 24, 7)),
                   "transposed": (2, (3, 24, 7))}[form]
    gen = torch.Generator().manual_seed(3)
    weight = (1 + 0.3 * torch.randn(24, generator=gen)).requires_grad_(True)
    bias = (0.2 * torch.randn(24, generator=gen)).requires_grad_(fused)
    conv_bias = (0.5 * torch.randn(24, generator=gen)).to(dt).requires_grad_(True)
    g_out = torch.randn(shape if form != "transposed" else (3, 7, 24), generator=gen).to(dt)
    grads = []
    for run in ("kernel", "plain"):
        x = _x(shape, dt).requires_grad_(True)
        xv = x.transpose(1, 2) if form == "transposed" else x
        leaves = [x, weight, bias, conv_bias]
        pre = conv_bias if fused else None
        if run == "kernel":
            y = layer_norm_cuda.flax_layer_norm_cuda(xv, weight, bias, 1e-6, axis, dt, pre, fused)
        else:
            y = layer_norm.flax_layer_norm(xv, weight, bias, 1e-6, axis, axis, dt, pre, fused)
        assert y.requires_grad and y.dtype == dt
        wanted = [t for t in leaves if t.requires_grad and (t is not conv_bias or fused)]
        grads.append((y.detach(), torch.autograd.grad(y, wanted, g_out)))
    assert calls == [layer_norm_cuda.layout(xv, axis)]
    (y_k, g_k), (y_p, g_p) = grads
    assert torch.equal(y_k, y_p)
    assert len(g_k) == len(g_p) == 2 + 2 * int(fused)
    for a, b in zip(g_k, g_p):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["rows", "channels_first", "transposed", "group_norm"])
def test_fused_arguments_equal_the_composition(dtype, form):
    """``norm(x, dt)`` is ``norm(x).to(dt)``, and ``norm(x, dt, b,
    gelu_out=True)`` is ``gelu(norm(x + b.to(dt)).to(dt))`` (the
    extractor's conv bias, cast and GELU), bit for bit on the CPU."""
    dt = DTYPES[dtype]
    axis, channel_axis, shape = {"rows": (-1, -1, (3, 7, 24)),
                                 "channels_first": (1, 1, (3, 24, 7)),
                                 "transposed": (2, 2, (3, 24, 7)),
                                 "group_norm": (2, 1, (3, 24, 7))}[form]
    norm = _norm(24, axis, channel_axis)
    x = _x(shape, dt)
    if form == "transposed":
        x = x.transpose(1, 2)
    conv_bias = (0.5 * torch.randn(24, generator=torch.Generator().manual_seed(5))).to(dt)
    bshape = [1, 1, 1]
    bshape[channel_axis] = -1
    with torch.inference_mode():
        assert torch.equal(norm(x, dt), norm(x).to(dt))
        assert norm(x).dtype == torch.float32 and norm(x, dt).dtype == dt
        fused = norm(x, dt, conv_bias, gelu_out=True)
        want = layer_norm.gelu(norm(x + conv_bias.view(bshape)).to(dt))
        assert fused.dtype == dt and torch.equal(fused, want)
        assert torch.equal(norm(x, dt, gelu_out=True), layer_norm.gelu(norm(x).to(dt)))


@pytest.mark.parametrize("form,shape,axis,want", [
    ("contiguous rows", (4, 9, 32), -1, "rows"),
    ("2-D rows", (7, 160), 1, "rows"),
    ("rows of a longer T", (3, 20, 32), 2, "rows"),
    ("channels-first", (2, 32, 11), 1, "channels_first"),
    ("transposed channels-first", (2, 32, 11), 2, "channels_first"),
])
def test_wrapper_layouts_on_cpu(form, shape, axis, want):
    """The wrapper names the two layouts the kernel reads and, on a CPU
    tensor, raises once the inputs have passed (the plain version is the
    module's to run: ``FlaxLayerNorm`` on the CPU)."""
    x = _x(shape, torch.bfloat16)
    if form == "rows of a longer T":
        x = x[:, :13]
    elif form == "transposed channels-first":
        x = x.transpose(1, 2)
    norm = _norm(x.shape[axis])
    assert layer_norm_cuda.layout(x, axis) == want
    with pytest.raises(ValueError, match="unsupported device cpu"):
        layer_norm_cuda.flax_layer_norm_cuda(x, norm.weight, norm.bias, 1e-6, axis,
                                             torch.bfloat16)
    if x.dim() == 3:
        module = _norm(x.shape[axis], axis, axis)
        want_y = layer_norm.flax_layer_norm(x, module.weight, module.bias, 1e-6, axis, axis,
                                            torch.bfloat16)
        assert torch.equal(module(x, torch.bfloat16), want_y)


@pytest.mark.parametrize("what,make,match", [
    ("width not a multiple of 8", lambda: (_x((2, 12), torch.float32), -1), "width 12"),
    ("width over the limit", lambda: (_x((2, 1032), torch.float32), -1), "width 1032"),
    ("fp16 input", lambda: (_x((2, 16), torch.float16), -1), "dtypes"),
    ("statistics over the first axis", lambda: (_x((16, 4, 3), torch.float32), 0),
     "neither layout"),
    ("a 4-D channels-first tensor", lambda: (_x((2, 16, 3, 3), torch.float32), 1),
     "neither layout"),
])
def test_wrapper_refuses(what, make, match):
    x, axis = make()
    norm = _norm(x.shape[axis])
    with pytest.raises(ValueError, match=match):
        layer_norm_cuda.flax_layer_norm_cuda(x, norm.weight, norm.bias, 1e-6, axis)


def test_wrapper_refuses_a_meta_device():
    x = torch.empty((2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm_cuda.flax_layer_norm_cuda(x, torch.ones(16), torch.zeros(16), 1e-6)


@pytest.mark.parametrize("C,in_size,frames,smem", [
    (512, 2, 16, 20608),  # the extractor, post_extract_norm (bf16)
    (1024, 2, 8, 22592),  # SONAR's depthwise_layer_norm (bf16)
    (512, 4, 8, 20544),  # fp32 forwards
    (1024, 4, 8, 38976),
    (160, 4, 16, 13056),
    (8, 2, 64, 5664),
    (1016, 2, 8, 22432),
    (1016, 4, 8, 38688),
])
def test_channels_first_plan(C, in_size, frames, smem):
    """The Python copy of the source's plan: the largest tile of 64, 32,
    16 or 8 frames within 16 KB (8 past it), every width's block under the
    48 KB that needs no opt-in, eight blocks of 256 threads an SM (its
    thread limit) at the encoders' bf16 widths."""
    assert layer_norm_cuda.cfirst_plan(C, in_size) == (frames, smem)
    assert smem <= STATIC_SMEM_LIMIT  # the kernel sets no shared-memory attribute
    assert C * frames * in_size <= layer_norm_cuda.TILE_BYTES or frames == 8
    if C in (512, 1024) and in_size == 2:
        assert 8 * (smem + 1024) <= H100_SMEM_SM


def test_every_width_fits_without_an_opt_in():
    assert max(layer_norm_cuda.cfirst_plan(C, size)[1]
               for C in range(8, layer_norm_cuda.MAX_WIDTH + 1, 8)
               for size in (2, 4)) <= STATIC_SMEM_LIMIT


def test_plan_constants_are_the_sources():
    import re
    from pathlib import Path

    src = (Path(layer_norm_cuda.__file__).resolve().parent.parent / "csrc" / "layer_norm.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src.read_text()))
    assert int(consts["THREADS"]) == layer_norm_cuda.THREADS
    assert int(consts["UNIT"]) == layer_norm_cuda.UNIT
    assert int(consts["MAX_WIDTH"]) == layer_norm_cuda.MAX_WIDTH
    assert eval(consts["TILE_BYTES"]) == layer_norm_cuda.TILE_BYTES


def test_launch_counter_counts_at_each_replay():
    """A launch recorded during a capture counts in ``LAUNCHES`` and in
    the tracer's counter at each replay of the record, not when made."""
    launches = {"k": 0}
    before = trace.counts["norm.launches"]
    with _build.holding_launches() as record:
        _build.count_launch(launches, "k", counter="norm.launches")
        _build.count_launch(launches, "k", counter="norm.launches")
    assert launches["k"] == 0 and trace.counts["norm.launches"] == before
    for _ in range(3):
        _build.count_replay(record)
    assert launches["k"] == 6 and trace.counts["norm.launches"] == before + 6
    _build.count_launch(launches, "k")  # no counter: LAUNCHES alone
    assert launches["k"] == 7 and trace.counts["norm.launches"] == before + 6


def _norm_calls(model, run):
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in model.modules() if isinstance(m, tw2v.FlaxLayerNorm)]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


@pytest.mark.parametrize("rows,limit", [(4, 10**12), (4, 4 * 16000)])
def test_laser_norms_a_chunk(rows, limit, monkeypatch):
    """SpeechLASER runs 7 extractor norms a row group, then
    ``post_extract_norm``, two norms a layer and ``encoder_norm``: at full
    depth 64 on a 600 s chunk (two groups), 57 on a shard of one group."""
    monkeypatch.setattr(tlaser, "CONV_GROUP_SAMPLES", limit)
    cfg = tlaser.LaserEncoderConfig(
        conv_layers=tlaser.LaserEncoderConfig().conv_layers, encoder_dim=64, encoder_layers=3,
        encoder_heads=2, encoder_ffn_dim=128, conv_pos_kernel=16, conv_pos_groups=4)
    model = tlaser.LaserSpeechEncoder(cfg).eval()
    wav = _x((rows, 8 * 16000), torch.float32) * 0.05
    groups = tlaser.conv_groups(rows, wav.shape[1])
    n = _norm_calls(model, lambda: model(wav, torch.full((rows,), wav.shape[1])))
    assert n == 7 * groups + 2 + 2 * cfg.encoder_layers
    assert 7 * 2 + 2 + 2 * 24 == 64 and 7 + 2 + 2 * 24 == 57


def test_sonar_norms_a_chunk():
    """SONAR's trunk runs ``fp_layer_norm`` and six norms a conformer
    layer: 145 at 24 layers."""
    cfg = tw2v.W2vBertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=64, attention_backend="torch")
    model = tw2v.W2vBertModel(cfg).eval()
    n = _norm_calls(model, lambda: model(_x((2, 10, 160), torch.float32),
                                         torch.ones(2, 10, dtype=torch.bool)))
    assert n == 1 + 6 * cfg.num_hidden_layers
    assert 1 + 6 * tw2v.W2vBertConfig().num_hidden_layers == 145
