"""The port's tracer (``svecalign_tpu_torch/utils/trace.py``) on the CPU.

The card's timing events are played by stand-ins behind
``trace.CudaEvents``' interface (``trace.event_type``), as
``utils.programs.Programs`` takes a stand-in for ``CUDAGraph``:

- off, a span is one shared object: nothing is recorded and no event
  made, in the stages too;
- spans record their parent, request id and self time;
- ``device_s`` and ``device_idle_s`` come out right on a fake device
  clock, and an event that has not completed waits for a later flush;
- no span path synchronises (``torch.cuda.synchronize`` raises), with
  the stages' spans on;
- (``test_torch_trace_clock.py``: the clock spans share with
  ``torch.profiler``);
- counters count for life and, while tracing is on, for the trace;
- ``chip_smoke.replay_overlap`` reads how far a mesh chunk's shard
  replays ran at the same time from their resolved spans;
- the benchmark's readers of the tracer return a number on a tiny stage
  run and None with tracing off.
"""

import time
import types

import numpy as np
import pytest
import torch

from bench_port import harness
from chip_smoke import cli_argv, replay_overlap, write_synthetic_corpus
from svecalign_tpu_torch.models import encode_common
from svecalign_tpu_torch.parallel.mesh import Mesh
from svecalign_tpu_torch.seg_align import align as talign
from svecalign_tpu_torch.seg_align import embed as tembed
from svecalign_tpu_torch.utils import audio_io, trace
from svecalign_tpu_torch.vecalign import batch
from tests.test_torch_span_graphs import chunks_per_bucket, document, make_model

torch.set_num_threads(2)


class StampEvents:
    """Events of a device that is never behind: each completes when it is
    recorded, at the host's clock (its time in ms since the anchor's)."""

    records = 0

    @classmethod
    def record(cls, device):
        cls.records += 1
        return time.perf_counter_ns()

    @classmethod
    def anchor(cls, device):
        t = cls.record(device)
        return t, t

    @staticmethod
    def done(ev):
        return True

    @staticmethod
    def ms(a, b):
        return (b - a) * 1e-6

    @staticmethod
    def capturing(device):
        return False


class ClockEvents(StampEvents):
    """Events whose completion times (device ms) the test sets in order;
    none has completed while ``ready`` is False."""

    times = []
    ready = True

    @classmethod
    def record(cls, device):
        cls.records += 1
        return {"t": cls.times.pop(0)}

    @classmethod
    def anchor(cls, device):
        return cls.record(device), FakeTime.now

    @classmethod
    def done(cls, ev):
        return cls.ready

    @staticmethod
    def ms(a, b):
        return b["t"] - a["t"]


class FakeTime:
    """``trace.time``: host ns the test sets; the wall clock 5 us ahead."""

    now = 10**9

    @staticmethod
    def perf_counter_ns():
        return FakeTime.now

    @staticmethod
    def time_ns():
        return FakeTime.now + 5_000


@pytest.fixture(autouse=True)
def clean_tracer(monkeypatch):
    """Every area off and the tracer empty around each test."""
    for var in ("SVECALIGN_EMBED_PROFILE", "SVECALIGN_ALIGN_PROFILE", "SVECALIGN_SEARCH_PROFILE",
                "SVECALIGN_VAD_PROFILE", "SVECALIGN_UNTRANS_PROFILE", "SVECALIGN_TRAIN_PROFILE"):
        monkeypatch.delenv(var, raising=False)

    def off():
        for area in trace.AREAS.values():
            area.forced = False
            area.switch()
        trace.reset()

    off()
    yield
    encode_common.stop_encode_profile()
    monkeypatch.undo()
    off()


def test_off_spans_record_nothing_and_make_no_event(monkeypatch):
    StampEvents.records = 0
    monkeypatch.setattr(trace, "event_type", StampEvents)
    a = trace.EMBED.span("x", "cpu")
    assert a is trace.EMBED.span("y", "cpu", host_only=True)
    assert a is trace.ALIGN.phases("p.", "cpu", {})
    with a as s:
        s.mark("phase")
    assert s.host_s == 0.0
    model = make_model("speech_laser")
    wave, spans = document("speech_laser")
    model.encode_spans(wave, spans)
    assert StampEvents.records == 0 and not trace.totals() and not trace.spans()
    assert not trace.traced_counts() and trace.counts["embed.replays"] > 0


def test_spans_record_parent_request_and_self_time(monkeypatch):
    monkeypatch.setattr(trace, "time", FakeTime)
    trace.EMBED.force(True)
    with trace.EMBED.span("outer", request="doc") as outer:
        FakeTime.now += 10_000
        with trace.EMBED.span("inner"):
            FakeTime.now += 30_000
        with trace.EMBED.span("other", request="own"):
            FakeTime.now += 5_000
        FakeTime.now += 1_000
    got = {s.name: s for s in trace.spans()}
    assert got["inner"].parent == got["outer"].id == got["other"].parent
    assert got["outer"].parent is None
    assert [got[k].request for k in ("outer", "inner", "other")] == ["doc", "doc", "own"]
    assert outer.host_s == got["outer"].host_s == pytest.approx(46e-6)
    assert got["outer"].self_s == pytest.approx(11e-6)
    assert got["inner"].self_s == got["inner"].host_s == pytest.approx(30e-6)
    # on the profiler's (wall) clock: the offset taken at switch-on
    assert got["inner"].start_ns == 10**9 + 10_000 + 5_000
    t = trace.totals()
    assert (t["outer"].count, t["outer"].self_s) == (1, pytest.approx(11e-6))


def test_device_and_idle_seconds_on_a_fake_device_clock(monkeypatch):
    """Anchor at device 0 ms = host 1 s. A host-only span from 1.010 s to
    1.040 s whose entry event completes at device 25 ms (the queue drains
    at host 1.025 s) leaves the card idle 15 ms; a device span with events
    at 50 and 80 ms has 30 ms of device time. An event that has not
    completed is resolved by a later flush."""
    monkeypatch.setattr(trace, "time", FakeTime)
    monkeypatch.setattr(trace, "event_type", ClockEvents)
    FakeTime.now = 10**9
    ClockEvents.times = [0.0, 25.0, 50.0, 80.0]
    ClockEvents.ready = False
    trace.ALIGN.force(True)
    trace.ALIGN.switch("cpu")  # the anchor: device 0 ms at host 1 s
    FakeTime.now += 10_000_000
    with trace.ALIGN.span("host", "cpu", host_only=True):
        FakeTime.now += 30_000_000
    with trace.ALIGN.span("dev", "cpu"):
        FakeTime.now += 1_000
    trace.flush()
    assert all(s.device_s is None and s.device_idle_s is None for s in trace.spans())
    ClockEvents.ready = True
    got = {s.name: s for s in trace.spans()}
    assert got["host"].device_s is None
    assert got["host"].device_idle_s == pytest.approx(0.015)
    assert got["dev"].device_s == pytest.approx(0.030) and got["dev"].device_idle_s is None
    t = trace.totals()
    assert (t["host"].device_idle_s, t["dev"].device_s) == (pytest.approx(0.015),
                                                            pytest.approx(0.030))
    assert t["host"].host_only and not t["dev"].host_only
    # a queue still busy past the span's end: no idle time
    ClockEvents.times = [100.0]
    with trace.ALIGN.span("busy", "cpu", host_only=True):
        FakeTime.now += 1_000_000
    assert trace.spans("busy")[0].device_idle_s == 0.0


def test_phases_tile_and_fill_their_sink(monkeypatch):
    monkeypatch.setattr(trace, "time", FakeTime)
    monkeypatch.setattr(trace, "event_type", ClockEvents)
    ClockEvents.ready = True
    ClockEvents.times = [0.0, 1.0, 4.0, 9.0]
    sink = {}
    trace.ALIGN.force(True)
    with trace.ALIGN.span("parent"):
        clock = trace.ALIGN.phases("p.", "cpu", sink)
        FakeTime.now += 2_000
        clock.mark("a")
        FakeTime.now += 3_000
        clock.mark("b")
    assert sink == {"a": pytest.approx(2e-6), "b": pytest.approx(3e-6)}
    got = {s.name: s for s in trace.spans()}
    assert got["p.a"].parent == got["p.b"].parent == got["parent"].id
    assert got["p.a"].device_s == pytest.approx(0.003) and got["p.b"].device_s == pytest.approx(
        0.005)
    assert got["parent"].self_s == pytest.approx(0.0)


def test_no_span_synchronises_or_runs_inside_a_capture(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(trace, "event_type", StampEvents)
    encode_common.start_encode_profile()
    model = make_model("speech_laser")
    wave, spans = document("speech_laser")
    n_chunks = sum(chunks_per_bucket(model, spans, len(wave)).values())
    model.encode_spans(wave, spans)  # captures every shape, then replays
    t = trace.totals()
    assert t["embed.replay"].count == n_chunks and t["embed.assemble"].count == n_chunks + 1
    assert t["embed.pull"].count == 1 and t["embed.plan"].count == 1
    assert not {"embed.frontend", "embed.trunk", "embed.pooler"} & set(t)  # warm-up, capture
    assert trace.traced_counts()["embed.captures"] == 3
    paths, _, _ = write_synthetic_corpus(tmp_path / "c", [(40, 36), (30, 33), (44, 40)], dim=16,
                                         seed=5)
    monkeypatch.setenv("SVECALIGN_ALIGN_PROFILE", "1")
    talign.main(cli_argv(paths, tmp_path / "out", "cpu",
                         ["--max_size_full_dp", "16", "--costs_sample_size", "300",
                          "--pair_batch", "2"]))
    t = trace.totals()
    assert t["align.load"].count == 3 and t["align.pyramid"].count == 2
    assert t["align.downsample"].count == 2 and t["align.call"].count == 1


def test_counters_count_for_life_and_for_the_trace():
    before = dict(batch.upload_stats)
    trace.count("align.upload_bytes", 10)
    assert batch.upload_stats["bytes"] == before["bytes"] + 10 and not trace.traced_counts()
    trace.ALIGN.force(True)
    trace.count("align.upload_bytes", 5)
    assert trace.traced_counts() == {"align.upload_bytes": 5}
    assert dict(batch.upload_stats)["bytes"] == before["bytes"] + 15
    with pytest.raises(KeyError):
        batch.upload_stats["nope"]


def test_replay_overlap_of_resolved_spans():
    """``chip_smoke.replay_overlap``: per mesh chunk, 0 where the
    shards' replays ran one after another, 1 where each lay within the
    longest one's stretch; chunks of one shard or with a span unresolved,
    and replays outside a ``mesh.issue`` (one device's), are left out."""

    def span(name, sid, parent=None, start_ms=None, ms=None):
        s = trace.Span()
        s.name, s.id, s.parent = name, sid, parent
        s.device_start_ns = None if start_ms is None else round(start_ms * 1e6)
        s.device_s = None if ms is None else ms * 1e-3
        return s

    spans = [span("mesh.issue", i) for i in range(1, 6)] + [span("embed.file", 6)]
    spans += [span("embed.replay", 10 + k, parent, start, ms) for k, (parent, start, ms) in
              enumerate([(1, 0, 10), (1, 10, 10),  # in turn
                         (2, 0, 10), (2, 2, 6), (2, 1, 9),  # inside the first
                         (3, 0, 10), (3, 5, 10),  # half
                         (4, 0, 10),  # one shard
                         (5, 0, 10), (5, None, None),  # unresolved
                         (6, 0, 10), (6, 0, 10), (None, 0, 10)])]  # one device's
    assert replay_overlap(spans) == pytest.approx([0.0, 1.0, 0.5])


# --- the benchmark's readers of the tracer ---------------------------------

def _embed_run(tmp_path, monkeypatch, mesh=None):
    """One stage-5.3 CLI call on a tiny LASER model (stand-in graphs and
    events) over a 40 s WAV; returns the harness record."""
    model = make_model("speech_laser", mesh=mesh)
    wave, spans = document("speech_laser")
    wav = tmp_path / "raw" / "doc_en.wav"
    wav.parent.mkdir(parents=True)
    audio_io.write(str(wav), wave, 16000)
    (tmp_path / "md.tsv").write_text(f"{wav}\t{wav}\n")
    (tmp_path / "cat" / "en").mkdir(parents=True)
    (tmp_path / "cat" / "en" / "doc_en.txt").write_text("".join(f"{s} {e}\n" for s, e in spans))
    monkeypatch.setattr(tembed, "load_embed_model", lambda *a, **k: model)
    monkeypatch.setattr(trace, "event_type", StampEvents)
    argv = [str(tmp_path / "md.tsv"), str(tmp_path / "out"), "--concat_dir",
            str(tmp_path / "cat"), "--lang", "en", "--device", "cpu"]
    tembed.main(argv)  # warm-up: every shape captured, tracing off
    monkeypatch.setenv("SVECALIGN_EMBED_PROFILE", "1")
    (tmp_path / "out" / "en" / "doc_en.embed").unlink()
    tembed.main(argv)
    assert encode_common.encode_profile["read_s"] > 0
    assert encode_common.encode_profile["assemble_s"] > 0
    record = harness.Record(cell={}, seed=0, chips=1 if mesh is None else 2)
    record.counters["audio_s"] = len(wave) / 16000
    return record


@pytest.mark.parametrize("name", ["embed.replay_ms_p95", "embed.host_idle_s_per_hour",
                                  "embed.window_captures"])
def test_embed_readers(name, tmp_path, monkeypatch):
    read = harness.load_reader(name)
    record = _embed_run(tmp_path, monkeypatch)
    value = read(record)
    assert value is not None and value >= 0
    if name == "embed.window_captures":
        assert value == 0  # the warm-up call captured every shape
    else:
        assert value > 0
    trace.reset()
    assert read(record) is None


def test_mesh_issue_reader(tmp_path, monkeypatch):
    read = harness.load_reader("mesh.issue_ms_per_chunk")
    record = _embed_run(tmp_path, monkeypatch, mesh=Mesh(["cpu", "cpu"]))
    assert read(record) > 0
    assert trace.totals()["mesh.issue"].count == trace.totals()["embed.replay"].count // 2
    trace.reset()
    assert read(record) is None


def test_align_host_idle_reader(tmp_path, monkeypatch):
    read = harness.load_reader("align.host_idle_ms_per_pair")
    paths, _, _ = write_synthetic_corpus(tmp_path / "c", [(40, 36), (30, 33), (44, 40)], dim=16,
                                         seed=5)
    argv = cli_argv(paths, tmp_path / "out", "cpu",
                    ["--max_size_full_dp", "16", "--costs_sample_size", "300",
                     "--pair_batch", "2"])
    monkeypatch.setattr(trace, "event_type", StampEvents)
    record = types.SimpleNamespace(counters={"pairs": 3})
    talign.main(argv)
    assert read(record) is None  # tracing off
    monkeypatch.setenv("SVECALIGN_ALIGN_PROFILE", "1")
    talign.main(argv)
    value = read(record)
    spans = trace.spans()
    loads = [s for s in spans if s.name == "align.load"]
    # the loads' children are inside them: counted once
    assert value == pytest.approx(1e3 * sum(
        s.device_idle_s for s in spans if s.name in ("align.load", "align.write")) / 3)
    assert len(loads) == 3 and all(s.device_idle_s > 0 for s in loads)
    assert np.isfinite(value) and value > 0
