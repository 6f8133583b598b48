"""The port's program cache (``svecalign_tpu_torch/utils/programs.py``) on
the CPU, through the stand-ins for ``torch.cuda.CUDAGraph`` here and in
``tests/rerun_graph.py``:

- CUDA graphs asked for on the CPU are refused; with no stand-in the
  CPU's cache runs the forward eagerly (no capture, no replay counted, no
  ``embed.replay`` span), and an encoder on it keeps no programs;
- a failed capture raises to the caller and stores nothing, and the
  cache's next capture takes a fresh arena.

The encoders' and Whisper's routes through the cache are in
``test_torch_span_graphs.py`` and ``test_torch_whisper.py``.
"""

import numpy as np
import pytest
import torch

from svecalign_tpu_torch.models import encode_common
from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.utils import trace
from svecalign_tpu_torch.utils.programs import CudaGraph, Programs
from tests.rerun_graph import RerunGraph
from tests.test_torch_span_graphs import KINDS, document, make_model

torch.set_num_threads(2)


class FailingGraph(RerunGraph):
    def capture(self, fn):
        raise RuntimeError("capture refused: operation not permitted when stream is capturing")


class FailOnceGraph(RerunGraph):
    """Its first capture fails; arenas are numbered."""

    arenas = []
    failures = 0

    @staticmethod
    def arena(device):
        FailOnceGraph.arenas.append(len(FailOnceGraph.arenas))
        return FailOnceGraph.arenas[-1]

    def capture(self, fn):
        if not FailOnceGraph.failures:
            FailOnceGraph.failures += 1
            raise RuntimeError("capture refused once")
        return super().capture(fn)


@pytest.fixture(autouse=True)
def _no_captures_left():
    RerunGraph.captures.clear()
    yield
    RerunGraph.captures.clear()


def test_cuda_program_cache_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Programs(torch.device("cpu"), CudaGraph)
    # the CPU's route is the eager forward, chosen by the cache, not a fallback
    model = make_model("speech_laser", graph_type=None)
    wave, spans = document("speech_laser")
    model.encode_spans(wave, spans)
    assert model.program_stats() == [] and not RerunGraph.captures


def test_cpu_cache_runs_the_forward_eagerly():
    """With no stand-in the CPU's cache replays nothing: ``run`` is the
    forward of the inputs, its launches counted as they are made, with no
    capture, no replay counted and no ``embed.replay`` span; ``load``
    copies nothing."""
    cache = Programs(torch.device("cpu"))
    assert not cache.replays and cache.pool_bytes() == 0
    launches = {"k": 0}

    def forward(x, y):
        _build.count_launch(launches, "k")
        return x * 2 + y

    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    try:
        trace.reset()
        encode_common.start_encode_profile()
        assert not cache.load(("k",), (x, y))
        for _ in range(2):
            assert torch.equal(cache.run(("k",), forward, (x, y)), x * 2 + y)
        assert "embed.replay" not in trace.totals()
        assert not {"embed.replays", "embed.captures"} & set(trace.traced_counts())
    finally:
        encode_common.stop_encode_profile()
        trace.reset()
    assert launches["k"] == 2 and not cache.programs and not RerunGraph.captures


@pytest.mark.parametrize("kind", KINDS)
def test_failed_capture_raises_and_stores_nothing(kind):
    model = make_model(kind, graph_type=FailingGraph)
    wave, spans = document(kind)
    with pytest.raises(RuntimeError, match="capture refused"):
        model.encode_spans(wave, spans)
    with pytest.raises(RuntimeError, match="capture refused"):
        model.encode([wave[s:e] for s, e in spans])
    assert all(not s["capture_s"] for s in model.program_stats())


def test_capture_after_a_failed_one_takes_a_fresh_arena():
    FailOnceGraph.arenas.clear()
    FailOnceGraph.failures = 0
    model = make_model("speech_laser", graph_type=FailOnceGraph)
    wave, spans = document("speech_laser")
    with pytest.raises(RuntimeError, match="capture refused once"):
        model.encode_spans(wave, spans)
    programs = model._programs(0)
    assert len(programs.failed) == 1 and not programs.programs
    assert programs.arena == 1 and FailOnceGraph.arenas == [0, 1]
    np.testing.assert_array_equal(model.encode_spans(wave, spans),
                                  model.encode_spans(wave, spans, eager=True))
    assert len(programs.programs) == 3 and programs.arena == 1
