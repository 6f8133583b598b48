"""The tracer's spans on ``torch.profiler``'s clock
(``svecalign_tpu_torch/utils/trace.py``): a span's start agrees with a
``record_function`` range's, and on a card a device span's entry event,
put on the host clock by its device's anchor, agrees with the start of
the kernel it precedes in the profiler's trace, and its device seconds
with the kernel's. On a mesh of two cards, the shards' ``embed.replay``
intervals, each on its own card's clock, show the two cards replaying
a chunk at the same time. This file imports no JAX, so that it runs on
the card's machine, without the tests' conftest:

    python -m pytest --noconftest tests/test_torch_trace_clock.py -q
"""

import pytest
import torch

from svecalign_tpu_torch.utils import trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def embed_area():
    trace.reset()
    trace.EMBED.force(True)
    yield
    trace.EMBED.force(False)
    trace.reset()


def test_span_start_is_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.EMBED.span("clock"), record_function("clock"):
            pass
    rf = next(ev for ev in prof.profiler.kineto_results.events() if ev.name() == "clock")
    span = trace.spans("clock")[0]
    assert abs(span.start_ns - rf.start_ns()) < 1_000_000, (span.start_ns, rf.start_ns())


@pytest.mark.card
def test_device_span_is_on_the_profilers_device_clock(card):
    """A float32 product of 4096 x 4096 (a few ms) inside a device span,
    under the profiler: its entry event within 1 ms of the product's
    first kernel, and the kernels inside the span's device interval (its
    device seconds hold the launch's gaps too); the span itself is no
    event of the profiler's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 4096, device=card)
    x @ x
    trace.EMBED.switch(card)  # the anchor, before the traced work
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.EMBED.span("product", card):
            x @ x
        torch.cuda.synchronize(card)
    events = prof.profiler.kineto_results.events()
    kernels = [ev for ev in events if ev.device_type() == DeviceType.CUDA]
    assert kernels and not any(ev.name() == "product" for ev in events)
    k0 = min(ev.start_ns() for ev in kernels)
    k1 = max(ev.start_ns() + ev.duration_ns() for ev in kernels)
    span = trace.spans("product")[0]
    seen = [(ev.name()[:60], ev.start_ns() - k0, ev.duration_ns()) for ev in kernels]
    assert abs(span.device_start_ns - k0) < 1_000_000, (span.device_start_ns - k0, seen)
    end = span.device_start_ns + span.device_s * 1e9
    slack = 100_000  # an event's stamp against CUPTI's, ns
    assert span.device_start_ns - slack <= k0 and k1 <= end + slack, (
        span.device_start_ns - k0, end - k1, span.device_s, seen)


@pytest.mark.card
def test_mesh_shards_replay_at_the_same_time(tmp_path):
    """A 10-minute document through SpeechLASER (random weights, the
    stage CLI's 150 s chunks, int16 uploads) on a mesh of two cards, its
    shapes captured first: on most chunks shard 1's replay starts on its
    card before shard 0's ends on the first card (every shard's copy-in
    is queued before any replay), and the rows are bit-equal to the same
    model's eager rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import numpy as np

    from chip_smoke import replay_overlap, write_synthetic_document
    from svecalign_tpu_torch.parallel.mesh import Mesh
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.audio_utils import load_waveform

    paths, lines = write_synthetic_document(tmp_path / "doc", 600, seed=0)
    wave = load_waveform(str(paths["wav"]), sr=16000)
    spans = [tuple(map(int, line.split())) for line in lines]
    model = embed_model_utils.load_embed_model(
        "speech_laser", mesh=Mesh(["cuda:0", "cuda:1"]), max_tokens=150 * 16000,
        upload_precision="int16", device="cuda:0")
    model.encode_spans(wave, spans, fp16_pull=True)  # every shape captured
    trace.reset()
    got = model.encode_spans(wave, spans, fp16_pull=True)
    kept = trace.spans()
    issues = [s.id for s in kept if s.name == "mesh.issue"]
    replays = {i: sorted((s for s in kept if s.name == "embed.replay" and s.parent == i),
                         key=lambda s: s.id) for i in issues}
    assert issues and all(len(r) == 2 and r[0].device == "cuda:0" and r[1].device == "cuda:1"
                          and all(s.device_s is not None for s in r) for r in replays.values())
    overlapping = [r[1].device_start_ns < r[0].device_start_ns + r[0].device_s * 1e9
                   for r in replays.values()]
    assert sum(overlapping) > len(overlapping) / 2, [
        ((r[1].device_start_ns - r[0].device_start_ns) * 1e-6, r[0].device_s * 1e3)
        for r in replays.values()]
    assert trace.totals()["mesh.scatter"].count == len(issues)
    overlap = replay_overlap(kept)
    assert len(overlap) == len(issues) and sum(overlap) / len(overlap) > 0.5, overlap
    want = model.encode_spans(wave, spans, fp16_pull=True, eager=True)
    np.testing.assert_array_equal(got, want)
