"""SpeechLASER's convs at a 600 s chunk's shape on a card
(``svecalign_tpu_torch/models/laser_encoder.py``: ``conv_groups``). A
chunk of 150 rows of 4 s runs each conv in two row groups, since in one
call of 150 rows cuDNN runs the positional conv on its implicit-GEMM
fallback kernels (``measure/extractor_convs.py``). This file imports no
JAX, so that it runs on the card's machine, without the tests' conftest:

    python -m pytest --noconftest tests/test_torch_laser_card.py -q -s
"""

import pytest
import torch

from svecalign_tpu_torch.models import laser_encoder as tlaser

FALLBACKS = ("implicit_convolve_sgemm", "precomputed_convolve_sgemm")
# the parity tests' bf16 tolerances (tests/test_torch_laser.py)
REL_TOL, MIN_COSINE = 3e-2, 0.999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def conv_kernels(prof) -> list:
    """(input shape, kernel names) of each ``aten::conv1d`` call, in call
    order: the kernels of the call and of every op under it."""
    out = []
    for ev in prof.events():
        if ev.name == "aten::conv1d":
            names, stack = set(), [ev]
            while stack:
                e = stack.pop()
                names.update(k.name for k in e.kernels)
                stack.extend(e.cpu_children)
            out.append((tuple(ev.input_shapes[0]), names))
    return out


def chunk_forward(model, card):
    """The forward of one 600 s chunk at the 4 s bucket, eager, in bf16,
    under the profiler: (pooled rows, each conv call's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    rows, bucket = model._rows_per_chunk(64000), 64000
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randint(-8000, 8000, (rows, bucket), device=card, dtype=torch.int16,
                      generator=gen)
    scales = torch.full((rows,), 1 / 32768, device=card)
    lengths = torch.randint(16000, bucket + 1, (rows,), device=card, generator=gen)
    with torch.inference_mode():
        model._forward(model.model, q, scales, lengths, bucket)  # cuDNN chooses
        torch.cuda.synchronize(card)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            out = model._forward(model.model, q, scales, lengths, bucket)
            torch.cuda.synchronize(card)
    return out.float().cpu(), conv_kernels(prof)


@pytest.mark.card
def test_600s_chunk_convs_run_tensor_op_kernels(card, monkeypatch):
    """150 rows of 4 s in two groups of 75: the positional conv and the
    extractor's layers 1-6 run no fallback kernel. The extractor's layer 0
    (one input channel) runs ``implicit_convolve_sgemm`` at every size
    measured, so it is the one conv left out. The pooled rows match those
    of one call a conv within the bf16 tolerance."""
    model = tlaser.SpeechLaserModel(max_tokens=600 * 16000, device=card)
    assert model._rows_per_chunk(64000) == 150 and tlaser.conv_groups(150, 64000) == 2
    got, calls = chunk_forward(model, card)
    n_convs = len(model.config.conv_layers) + 1  # the extractor's and the positional conv
    assert len(calls) == 2 * n_convs and all(names for _, names in calls), calls
    for shape, names in calls:
        print(shape, sorted(n[:70] for n in names))
        if shape[1] != 1:  # not the extractor's layer 0
            assert not any(f in n for n in names for f in FALLBACKS), (shape, names)
    assert {shape for shape, _ in calls if shape[1] == 1024} == {(75, 1024, 199)}

    monkeypatch.setattr(tlaser, "CONV_GROUP_SAMPLES", 10**12)
    want, one_call = chunk_forward(model, card)
    assert len(one_call) == n_convs
    print("one call:", [(shape, sorted(n[:40] for n in names)) for shape, names in one_call])
    gap = float((got - want).abs().max() / want.abs().max())
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1).min().item()
    print(f"rows against one call: max gap {gap:.5f}, least cosine {cos:.6f}")
    assert torch.isfinite(got).all() and gap < REL_TOL and cos >= MIN_COSINE
