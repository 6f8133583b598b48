"""The LayerNorm kernel (``csrc/layer_norm.cu``, ``ops/layer_norm_cuda.py``)
on a card, against its plain version (``ops/layer_norm.py``) run on the
same card: every combination the encoders call (both layouts and the
transposed output, widths 160, 512 and 1024, bf16 and fp32 in and out,
with and without the conv-bias prologue and the GELU epilogue; ragged T,
one row, T off the tile), its refusals, a CUDA-graph replay against its
eager launch, and a 600 s SpeechLASER chunk and a SONAR chunk by replay
against the plain arithmetic. This file imports no JAX, so that it runs
on the card's machine, without the tests' conftest:

    python -m pytest --noconftest tests/test_torch_layer_norm_card.py -q -s
"""

import pytest
import torch

from svecalign_tpu_torch.ops import layer_norm, layer_norm_cuda

# the parity tests' bf16 tolerances (tests/test_torch_laser.py)
REL_TOL, MIN_COSINE = 3e-2, 0.999
FP32_REL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of the last place of the larger
    of the two (bf16: 8 bits of significand), over the values that are
    not within 2^-10 of the output's largest magnitude of zero, and
    infinity if any value is off by more than one such unit plus 2^-16 of
    that magnitude. Near zero an output is x - mu for x close to mu, and
    the fp32 statistics' order of summation, which differs between the
    kernel and the plain version, moves it by a few fp32 units of mu:
    many of its bf16 units."""
    g, w = got.float(), want.float()
    a = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7)
    scale = float(w.abs().max()) if w.numel() else 0.0
    gap = (g - w).abs()
    if bool((gap > ulp + scale * 2.0 ** -16).any()):
        return float("inf")
    away = a >= scale * 2.0 ** -10
    return float((gap / ulp)[away].max()) if bool(away.any()) else 0.0


def hold(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.isfinite(got).all(), what
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        assert ulps <= 1.0, f"{what}: {ulps} bf16 ulps"
        return ulps
    gap = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert gap <= FP32_REL, f"{what}: fp32 relative gap {gap:.3e}"
    return gap


def operands(card, C, in_dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    w = 1 + 0.3 * torch.randn(C, device=card, generator=gen)
    b = 0.2 * torch.randn(C, device=card, generator=gen)
    conv_bias = (0.5 * torch.randn(C, device=card, generator=gen)).to(in_dtype)
    return w, b, conv_bias, gen


def make_x(card, shape, dtype, gen):
    # an offset and a spread per channel, as activations have
    return (2 * torch.randn(shape, device=card, generator=gen) + 0.7).to(dtype)


# (layout, shape of the memory, axis, how x is viewed)
LAYOUTS = {
    "rows": lambda B, C, T: ((B, T, C), 2, None),
    "rows_strided": lambda B, C, T: ((B, T + 5, C), 2, "slice"),
    "channels_first": lambda B, C, T: ((B, C, T), 1, None),
    "transposed": lambda B, C, T: ((B, C, T), 2, "transpose"),
}
SIZES = ((3, 1000), (1, 77), (2, 64), (5, 3))  # ragged T, one row, a whole tile, T under a tile


def epilogue_ulps(got, want) -> float:
    """The largest gap in units of the last place of the larger value,
    everywhere (the GELU epilogue against PyTorch's GELU of the kernel's
    own rounded output: the same input, so no slack near zero)."""
    g, w = got.float(), want.float()
    a = torch.maximum(g.abs(), w.abs())
    bits = 7 if got.dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - bits)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.card
@pytest.mark.parametrize("C", [160, 512, 1024])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_matches_plain(card, layout, C):
    """The norm (with and without the conv bias) against the plain
    version: bf16 outputs within one bf16 unit, fp32 outputs within 1e-5
    of the largest; the GELU epilogue against PyTorch's GELU of the
    kernel's own output, within one unit of its dtype (a GELU of the
    plain version's output would pass a one-unit difference of the norm
    through a slope up to 1.13 onto a value up to half as large)."""
    worst = {}
    before = layer_norm_cuda.LAUNCHES["layer_norm"]
    n = 0
    for in_dtype in DTYPES:
        for out_dtype in DTYPES:
            for with_bias in (False, True):
                for B, T in SIZES:
                    w, b, cb, gen = operands(card, C, in_dtype, seed=n)
                    shape, axis, view = LAYOUTS[layout](B, C, T)
                    x = make_x(card, shape, in_dtype, gen)
                    if view == "slice":
                        x = x[:, :T]
                    elif view == "transpose":
                        x = x.transpose(1, 2)
                    pre = cb if with_bias else None
                    assert layer_norm_cuda.layout(x, axis) == (
                        "rows" if layout.startswith("rows") else "channels_first")
                    args = (x, w, b, 1e-5, axis)
                    got = layer_norm_cuda.flax_layer_norm_cuda(*args, out_dtype, pre)
                    got_gelu = layer_norm_cuda.flax_layer_norm_cuda(*args, out_dtype, pre, True)
                    torch.cuda.synchronize(card)
                    n += 2
                    want = layer_norm.flax_layer_norm(*args, axis, out_dtype, pre)
                    assert got.is_contiguous() and got_gelu.is_contiguous()
                    what = (f"{layout} C={C} {in_dtype}->{out_dtype} bias={with_bias} "
                            f"B={B} T={T}")
                    key = str(out_dtype)
                    worst[key] = max(worst.get(key, 0.0), hold(got, want, what))
                    ulps = epilogue_ulps(got_gelu, layer_norm.gelu(got))
                    assert ulps <= 1.0, f"{what}: the GELU epilogue {ulps} units off"
                    worst[key + " gelu"] = max(worst.get(key + " gelu", 0.0), ulps)
    assert layer_norm_cuda.LAUNCHES["layer_norm"] == before + n
    print(f"{layout} C={C}: worst {worst}")


@pytest.mark.card
def test_kernel_refuses(card):
    w, b = torch.ones(16, device=card), torch.zeros(16, device=card)
    for x, axis, match in (
            (torch.zeros(2, 12, device=card), -1, "width 12"),
            (torch.zeros(2, 4096, device=card), -1, "width 4096"),
            (torch.zeros(2, 16, device=card, dtype=torch.float16), -1, "dtypes"),
            (torch.zeros(16, 4, 3, device=card), 0, "neither layout"),
            (torch.zeros(2, 16, device=card).t().contiguous().t(), 1, "neither layout")):
        ww, bb = torch.ones(x.shape[axis], device=card), torch.zeros(x.shape[axis], device=card)
        with pytest.raises(ValueError, match=match):
            layer_norm_cuda.flax_layer_norm_cuda(x, ww, bb, 1e-5, axis)
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm_cuda.flax_layer_norm_cuda(torch.zeros(2, 16, device="meta"), w, b, 1e-5)
    # rows off a 16-byte boundary
    buf = torch.zeros(2 * 16 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        layer_norm_cuda.flax_layer_norm_cuda(buf[1:].view(2, 16), w, b, 1e-5)


@pytest.mark.card
def test_plan_is_the_sources(card):
    for C in range(8, layer_norm_cuda.MAX_WIDTH + 1, 8):
        for size in (2, 4):
            assert layer_norm_cuda.source_cfirst_plan(C, size) == layer_norm_cuda.cfirst_plan(C, size)


@pytest.mark.card
@pytest.mark.parametrize("layout", ["rows", "channels_first", "transposed"])
def test_replay_equals_eager(card, layout):
    """A captured launch replays bit-equal to the eager one, on new
    inputs copied into the graph's static input."""
    C, B, T = 512, 4, 1999
    w, b, cb, gen = operands(card, C, torch.bfloat16, seed=7)
    shape, axis, view = LAYOUTS[layout](B, C, T)
    static = make_x(card, shape, torch.bfloat16, gen)

    def fn():
        x = static.transpose(1, 2) if view == "transpose" else static
        return layer_norm_cuda.flax_layer_norm_cuda(x, w, b, 1e-6, axis, torch.bfloat16, cb,
                                                    gelu_out=layout != "rows")

    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        fn()  # warm-up: the shared-memory limits, the library
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for seed in (1, 2):
        static.copy_(make_x(card, shape, torch.bfloat16, torch.Generator(device=card)
                            .manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize(card)
        assert torch.equal(out, fn())


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["rows", "channels_first", "transposed"])
def test_grad_recording_call_launches(card, layout, dtype):
    """Under autograd (the trainer's forward) the wrapper launches the
    kernel, once, and its output holds to the plain version as an
    inference call's does; the gradients of ``x``, the scale, the bias
    and the conv bias are the plain version's at the same inputs, bit for
    bit (the backward recomputes it)."""
    C, B, T = 512, 2, 301
    w, b, cb, gen = operands(card, C, dtype, seed=11)
    shape, axis, view = LAYOUTS[layout](B, C, T)
    base = make_x(card, shape, dtype, gen)
    results = []
    for run in ("kernel", "plain"):
        x = base.clone().requires_grad_(True)
        leaves = [x] + [t.clone().requires_grad_(True) for t in (w, b, cb)]
        xv = x.transpose(1, 2) if view == "transpose" else x
        before = layer_norm_cuda.LAUNCHES["layer_norm"]
        if run == "kernel":
            y = layer_norm_cuda.flax_layer_norm_cuda(xv, *leaves[1:3], 1e-6, axis, dtype,
                                                     leaves[3], True)
        else:
            y = layer_norm.flax_layer_norm(xv, *leaves[1:3], 1e-6, axis, axis, dtype,
                                           leaves[3], True)
        launched = layer_norm_cuda.LAUNCHES["layer_norm"] - before
        g_out = torch.randn(y.shape, device=card, generator=torch.Generator(device=card)
                            .manual_seed(5)).to(dtype)
        results.append((y.detach(), torch.autograd.grad(y, leaves, g_out), launched))
    (y_k, g_k, n_k), (y_p, g_p, n_p) = results
    assert (n_k, n_p) == (1, 0)
    epilogue = epilogue_ulps(y_k, layer_norm.gelu(
        layer_norm_cuda.flax_layer_norm_cuda(base.transpose(1, 2) if view == "transpose"
                                             else base, w, b, 1e-6, axis, dtype, cb)))
    assert epilogue <= 1.0, epilogue
    for name, got, want in zip(("x", "scale", "bias", "conv bias"), g_k, g_p):
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.card
def test_training_step_on_the_kernel(card, monkeypatch):
    """A training forward and backward of a small fp32 SpeechLASER encoder
    (the extractor at full width, two layers at d = 64) on the card, every
    norm on the kernel, against the same step with every norm on the plain
    arithmetic, held to the bounds of the trainer's card-against-CPU gate
    (``chip_smoke.py::hold_train_steps``): the loss within 1e-4, each
    gradient within 1e-5 of its largest magnitude where that is over 1,
    else absolute."""
    from svecalign_tpu_torch.models import laser_encoder as tlaser
    from svecalign_tpu_torch.utils.torch_setup import resolve_device

    resolve_device(card)  # fp32 pinned (no TF32), as the trainer runs
    cfg = tlaser.LaserEncoderConfig(encoder_dim=64, encoder_layers=2, encoder_heads=2,
                                    encoder_ffn_dim=128, conv_pos_kernel=16, conv_pos_groups=4,
                                    dtype="float32")
    torch.manual_seed(0)
    model = tlaser.LaserSpeechEncoder(cfg).to(card)
    gen = torch.Generator(device=card).manual_seed(1)
    wav = 0.05 * torch.randn(2, 16000, device=card, generator=gen)
    lengths = torch.tensor([16000, 12000], device=card)

    def step():
        model.zero_grad(set_to_none=True)
        loss = model(wav, lengths).square().mean()
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = layer_norm_cuda.LAUNCHES["layer_norm"]
    loss, grads = step()
    assert layer_norm_cuda.LAUNCHES["layer_norm"] - before == 7 + 2 + 2 * cfg.encoder_layers
    want_loss, want = _plain_forward(monkeypatch, step)
    gaps = {name: float((g - want[name]).abs().max()) / max(1.0, float(want[name].abs().max()))
            for name, g in grads.items()}
    print(f"training step: loss {loss:.7f} against {want_loss:.7f}, the largest gradient gap "
          f"{max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
    assert abs(loss - want_loss) <= 1e-4
    for name, gap in gaps.items():
        assert gap <= 1e-5, name


def _plain_forward(monkeypatch, forward):
    """``forward()`` with every FlaxLayerNorm call on the plain arithmetic."""
    from svecalign_tpu_torch.models import w2v_bert

    def plain(x, weight, bias, eps, axis, dtype, conv_bias, gelu_out):
        return layer_norm.flax_layer_norm(x, weight, bias, eps, axis, axis, dtype, conv_bias,
                                          gelu_out)

    with monkeypatch.context() as m:
        m.setattr(w2v_bert.layer_norm_cuda, "flax_layer_norm_cuda", plain)
        return forward()


def _hold_rows(got, want, what):
    got, want = got.float().cpu(), want.float().cpu()
    gap = float((got - want).norm(dim=1).max() / want.norm(dim=1).min())
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1).min().item()
    print(f"{what}: rows against the plain norms: relative gap {gap:.5f}, least cosine {cos:.6f}")
    assert torch.isfinite(got).all() and gap < REL_TOL and cos >= MIN_COSINE


def _chunk(model, card, bucket, min_len, seed=0):
    rows, width = model._rows_per_chunk(bucket), model._bucket_width(bucket)
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randint(-8000, 8000, (rows, width), device=card, dtype=torch.int16, generator=gen)
    scales = torch.full((rows,), 1 / 32768, device=card)
    lengths = torch.randint(min_len, bucket + 1, (rows,), device=card, generator=gen,
                            dtype=torch.int32)
    return q, scales, lengths


@pytest.mark.card
def test_laser_600s_chunk_by_replay(card, monkeypatch):
    """A 600 s SpeechLASER chunk (150 rows of 4 s, two row groups) by
    replay, every norm on the kernel (64 launches a replay), against the
    eager forward with every norm on the plain arithmetic."""
    from svecalign_tpu_torch.models import laser_encoder as tlaser

    model = tlaser.SpeechLaserModel(max_tokens=600 * 16000, device=card)
    q, scales, lengths = _chunk(model, card, 64000, 16000)
    model._span_forward(q, scales, lengths, 64000)  # capture
    before = layer_norm_cuda.LAUNCHES["layer_norm"]
    got = model._span_forward(q, scales, lengths, 64000)
    assert layer_norm_cuda.LAUNCHES["layer_norm"] - before == 64
    want = _plain_forward(monkeypatch, lambda: model._span_forward(q, scales, lengths, 64000,
                                                                    eager=True))
    _hold_rows(got, want, "LASER 600 s chunk")


@pytest.mark.card
def test_sonar_chunk_by_replay(card, monkeypatch):
    """A SONAR chunk (16 rows at the 500-frame bucket) by replay, every
    norm on the kernel (145 launches a replay), against the eager forward
    with every norm on the plain arithmetic."""
    from svecalign_tpu_torch.models import sonar_encoder as tsonar

    model = tsonar.SonarSpeechModel(device=card)
    q, scales, lengths = _chunk(model, card, 500, 250)
    model._span_forward(q, scales, lengths, 500)
    before = layer_norm_cuda.LAUNCHES["layer_norm"]
    got = model._span_forward(q, scales, lengths, 500)
    assert layer_norm_cuda.LAUNCHES["layer_norm"] - before == 145
    want = _plain_forward(monkeypatch, lambda: model._span_forward(q, scales, lengths, 500,
                                                                    eager=True))
    _hold_rows(got, want, "SONAR chunk")
