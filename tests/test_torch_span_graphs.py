"""The encoders' per-shape programs (one ``svecalign_tpu_torch.utils.
programs.Programs`` per replica) on the CPU, through the stand-in for
``torch.cuda.CUDAGraph`` in ``tests/rerun_graph.py``.

On a card every ``_span_forward`` replays a CUDA graph captured once per
(replica, bucket, rows, width, input dtypes). The CPU has no graphs, so
the stand-in plays one: its capture runs the forward into the static
output, and each replay runs it again from the static inputs into that
same output, as a graph's replay overwrites its output. Through it:

- ``encode_spans`` and the host-sliced ``encode`` equal the eager rows bit
  for bit, for SpeechLASER and SONAR at the tiny geometries of their
  parity tests, on a document with at least two chunks in each of three
  buckets and a partial tail chunk (two chunks of one bucket in a row
  would share the static output if a replay's rows were not copied out),
  with ``keep_device`` and ``fp16_pull`` too;
- each (replica, shape) is captured once over a document and its second
  run; a copy of the model and a changed attention route get programs of
  their own;
- a 2-shard CPU mesh: one set of programs per replica, rows bit-equal to
  the mesh's eager rows and within cosine 1 - 1e-5 of one device's (the
  forward runs on half the rows: CPU products may round differently);
- on a mesh of 2 and 4 CPU shards every shard's copy-in is queued before
  the chunk's first replay, with rows bit-equal to the former order's
  (each shard's copy-in and replay in turn), and one ``mesh.scatter``
  span a chunk counts the bytes sent to the shards other than the first;
  one device copies in, then replays;
- launches inside a program count at each replay, per shard too; the
  tracer sees one span a replayed chunk (``embed.replay``) and the eager
  forward's three;
- the slice as a whole against the JAX package's jitted encoders, at the
  parity tests' tolerance (fp32 uploads and compute, as every test here
  runs: 5e-5 of the largest
  row value for SONAR, whose rows inherit the fbank's rounding; 1e-4 for
  SpeechLASER).

The cache's own cases (the CPU refusal, failed captures) are in
``tests/test_torch_programs.py``.
"""

import copy

import numpy as np
import pytest
import torch

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu_torch.models import encode_common
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.parallel.mesh import Mesh, run_on_shards, shard_slices
from svecalign_tpu_torch.utils import programs, trace
from tests.rerun_graph import RerunGraph
from tests.test_torch_laser import SMALL as LASER_SMALL
from tests.test_torch_sonar import SMALL as SONAR_SMALL

torch.set_num_threads(2)

KINDS = ("speech_laser", "sonar")
JAX_TOL = {"speech_laser": 1e-4, "sonar": 5e-5}
MESH_MIN_COSINE = 1 - 1e-5


# buckets and rows per chunk: three buckets, two full chunks and a partial
# tail in each
LASER_BUCKETS = (8000, 16000, 32000)  # 8, 4 and 2 rows a chunk at 64000 tokens
SONAR_BUCKETS = (50, 100, 250)  # frames; 2 rows a chunk


def make_model(kind, mesh=None, graph_type=RerunGraph):
    if kind == "speech_laser":
        m = tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(**LASER_SMALL, dtype="float32"),
                                    max_tokens=64000, upload_dtype="fp32", device="cpu",
                                    mesh=mesh)
        m.BUCKETS = LASER_BUCKETS
    else:
        m = tsonar.SonarSpeechModel(
            tsonar.SonarEncoderConfig(**SONAR_SMALL, dtype="float32", attention_backend="torch"),
            batch_size=2, upload_dtype="fp32", device="cpu", mesh=mesh)
        m.BUCKET_FRAMES = SONAR_BUCKETS
    m.WAVE_BUCKETS_S = (10, 41)
    m.graph_type = graph_type
    return m


def document(kind, seconds=40, seed=0):
    """A waveform and spans that fill each of the three buckets with two
    full chunks and a partial tail (spans in the order that mixes them)."""
    rng = np.random.default_rng(seed)
    wave = (0.3 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    if kind == "speech_laser":
        lengths = {8000: (6000, 17), 16000: (12000, 9), 32000: (30000, 5)}
    else:  # samples of 40, 90 and 200 frames
        lengths = {50: (400 + 39 * 160, 5), 100: (400 + 89 * 160, 5), 250: (400 + 199 * 160, 5)}
    spans = []
    for k in range(max(n for _, n in lengths.values())):
        for ln, n in lengths.values():
            if k < n:
                s = int(rng.integers(0, len(wave) - ln))
                spans.append((s, s + ln - int(rng.integers(0, 100))))
    return wave, spans


def chunks_per_bucket(model, spans, n):
    counts = {}
    for s, e in spans:
        b = model._span_plan(s, max(min(e, n) - s, 0))[0]
        counts[b] = counts.get(b, 0) + 1
    return {b: -(-c // model._rows_per_chunk(b)) for b, c in counts.items()}


@pytest.fixture(autouse=True)
def _no_captures_left():
    RerunGraph.captures.clear()
    yield
    RerunGraph.captures.clear()


@pytest.fixture(scope="module", params=KINDS)
def model_and_doc(request):
    kind = request.param
    model = make_model(kind)
    wave, spans = document(kind)
    plan = chunks_per_bucket(model, spans, len(wave))
    assert len(plan) == 3 and all(c >= 3 for c in plan.values()), plan
    assert all(sum(1 for s, e in spans if model._span_plan(s, e - s)[0] == b)
               % model._rows_per_chunk(b) for b in plan), "every bucket ends in a partial chunk"
    return kind, model, wave, spans


def test_encode_spans_replays_equal_eager_rows(model_and_doc):
    kind, model, wave, spans = model_and_doc
    model.__dict__.pop("_span_programs", None)
    want = model.encode_spans(wave, spans, eager=True)
    assert not RerunGraph.captures
    got = model.encode_spans(wave, spans)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    # two rows of a bucket's first and second chunk differ: no shared output
    assert len({row.tobytes() for row in got}) == len(spans)
    np.testing.assert_array_equal(model.encode_spans(wave, spans), want)


def test_host_sliced_encode_replays_equal_eager_rows(model_and_doc):
    kind, model, wave, spans = model_and_doc
    pieces = [wave[s:e] for s, e in spans]
    want = model.encode(pieces, eager=True)
    got = model.encode(pieces)
    np.testing.assert_array_equal(got, want)
    # fp32 uploads: host slicing equals device assembly, through programs too
    np.testing.assert_array_equal(got, model.encode_spans(wave, spans))


@pytest.mark.parametrize("route", ["encode_spans", "encode"])
def test_keep_device_and_fp16_pull_through_programs(model_and_doc, route, monkeypatch):
    kind, model, wave, spans = model_and_doc
    monkeypatch.setattr(encode_common.embed_cache, "max_rows", 64)

    def run(**kw):
        if route == "encode_spans":
            return model.encode_spans(wave, spans, **kw)
        return model.encode([wave[s:e] for s, e in spans], **kw)

    want_out, want_dev = run(keep_device=True, fp16_pull=True, eager=True)
    got_out, got_dev = run(keep_device=True, fp16_pull=True)
    assert got_out.dtype == np.float16
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_dev.numpy(), want_dev.numpy())
    np.testing.assert_array_equal(got_dev[: len(spans)].numpy(), got_out)
    out32, dev32 = run(keep_device=True)
    np.testing.assert_array_equal(out32.astype(np.float16), got_out)
    np.testing.assert_array_equal(dev32.numpy(), got_dev.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_each_shape_is_captured_once(kind):
    model = make_model(kind)
    wave, spans = document(kind)
    plan = chunks_per_bucket(model, spans, len(wave))
    for _ in range(2):  # a document, then the next file of the run
        model.encode_spans(wave, spans)
    assert len(RerunGraph.captures) == len(plan) == 3
    (stats,) = model.program_stats()
    assert stats["replica"] == 0 and stats["device"] == "cpu" and stats["pool_bytes"] == 0
    assert sorted(key[0] for key in stats["capture_s"]) == sorted(plan)
    rows = {key[0]: key[1] for key in stats["capture_s"]}
    assert rows == {b: model._rows_per_chunk(b) for b in plan}

    # the host-sliced encode hands int32 lengths: programs of their own
    model.encode([wave[s:e] for s, e in spans])
    assert len(RerunGraph.captures) == 6
    # a copy (another row count, say) and a new mesh start with no programs
    other = copy.copy(model)
    assert other.program_stats() == [] and len(model.program_stats()[0]["capture_s"]) == 6
    assert model.with_mesh(Mesh(["cpu"])).program_stats() == []


def test_attention_route_is_part_of_the_key():
    model = make_model("sonar")
    wave, spans = document("sonar")
    plain = model.encode_spans(wave, spans)
    n = len(RerunGraph.captures)
    model.model.trunk.set_attention_backend("auto")  # the plain path too, on the CPU
    np.testing.assert_array_equal(model.encode_spans(wave, spans), plain)
    assert len(RerunGraph.captures) == 2 * n


@pytest.mark.parametrize("kind", KINDS)
def test_two_shard_mesh_has_programs_per_replica(kind):
    mesh = Mesh(["cpu", "cpu"])
    model = make_model(kind, mesh=mesh)
    one = make_model(kind)
    wave, spans = document(kind)
    assert model.data_shards == 2 and model._replicas[0] is model._replicas[1]
    want = model.encode_spans(wave, spans, eager=True)
    got = model.encode_spans(wave, spans)
    np.testing.assert_array_equal(got, want)
    single = one.encode_spans(wave, spans, eager=True)
    cos = (got * single).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(single, axis=1))
    assert cos.min() >= MESH_MIN_COSINE
    stats = model.program_stats()
    assert [s["replica"] for s in stats] == [0, 1]
    assert stats[0]["capture_s"].keys() == stats[1]["capture_s"].keys()
    assert len(stats[0]["capture_s"]) == 3 and len(RerunGraph.captures) == 6
    half = {key[1] for key in stats[0]["capture_s"]}
    assert half == {model._rows_per_chunk(b) // 2 for b in chunks_per_bucket(model, spans,
                                                                             len(wave))}
    out, dev = model.encode_spans(wave, spans, keep_device=True, fp16_pull=True)
    np.testing.assert_array_equal(out, want.astype(np.float16))
    np.testing.assert_array_equal(dev[: len(spans)].numpy(), out)


class OrderGraph(RerunGraph):
    """A :class:`RerunGraph` whose arenas are numbered, one a replica in
    the order they are made (by shard), and whose replays are logged with
    their shard in :attr:`log`; :func:`log_loads` logs the copy-ins."""

    log = []
    arenas = 0

    @staticmethod
    def arena(device):
        OrderGraph.arenas += 1
        return OrderGraph.arenas - 1

    def __init__(self, device, arena):
        super().__init__(device, arena)
        self.shard = arena

    def replay(self):
        OrderGraph.log.append(("replay", self.shard))
        super().replay()


def log_loads(monkeypatch):
    load = programs.Programs.load

    def logged(cache, key, inputs):
        done = load(cache, key, inputs)
        if done:
            OrderGraph.log.append(("load", cache.arena))
        return done

    monkeypatch.setattr(programs.Programs, "load", logged)


def parent_order(model):
    """The mesh branch of ``_span_forward`` in its former order: each
    shard's copy-in and replay in turn, then the gather."""

    @torch.inference_mode()
    def forward(rows_q, row_scales, lengths, bucket, eager=False):
        outs = run_on_shards(model.mesh, lambda i, dev, sl: model._replay(
            i, rows_q[sl], row_scales[sl], lengths[sl], bucket),
            shard_slices(rows_q.shape[0], model.mesh))
        return torch.cat([o.to(model.device) for o in outs])

    return forward


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_queues_every_copy_in_before_any_replay(kind, shards, monkeypatch):
    """On a mesh every shard's copy-in is queued before the first replay
    of the chunk (a copy between cards runs on the first card's stream,
    behind whatever it holds), and the rows are bit-equal to those of the
    former order, each shard's copy-in and replay in turn. One device
    copies in, then replays, as before."""
    OrderGraph.arenas = 0
    model = make_model(kind, mesh=Mesh(["cpu"] * shards), graph_type=OrderGraph)
    wave, spans = document(kind)
    n_chunks = sum(chunks_per_bucket(model, spans, len(wave)).values())
    log_loads(monkeypatch)
    model.encode_spans(wave, spans)  # captures every shape
    OrderGraph.log.clear()
    got = model.encode_spans(wave, spans)
    per_shard = [("load", i) for i in range(shards)] + [("replay", i) for i in range(shards)]
    assert OrderGraph.log == per_shard * n_chunks

    OrderGraph.arenas = 0
    parent = copy.copy(model)  # programs of its own
    parent._span_forward = parent_order(parent)
    parent.encode_spans(wave, spans)
    OrderGraph.log.clear()
    want = parent.encode_spans(wave, spans)
    assert OrderGraph.log == [(step, i) for i in range(shards)
                              for step in ("load", "replay")] * n_chunks
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, model.encode_spans(wave, spans, eager=True))

    OrderGraph.arenas = 0
    one = make_model(kind, graph_type=OrderGraph)
    one.encode_spans(wave, spans)
    OrderGraph.log.clear()
    one.encode_spans(wave, spans)
    assert OrderGraph.log == [("load", 0), ("replay", 0)] * sum(
        chunks_per_bucket(one, spans, len(wave)).values())


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_scatter_span_and_bytes(shards):
    """``mesh.scatter``: one span a mesh chunk, inside ``mesh.issue``;
    ``mesh.scatter_bytes``: the input bytes copied to the shards other
    than the first (fp32 rows, fp32 scales, int64 lengths). On one
    device neither."""
    model = make_model("speech_laser", mesh=Mesh(["cpu"] * shards) if shards > 1 else None)
    wave, spans = document("speech_laser")
    plan = chunks_per_bucket(model, spans, len(wave))
    model.encode_spans(wave, spans)  # captures every shape
    try:
        trace.reset()
        encode_common.start_encode_profile()
        model.encode_spans(wave, spans)
        got = trace.totals()
        counts = trace.traced_counts()
    finally:
        encode_common.stop_encode_profile()
        trace.reset()
    if shards == 1:
        assert "mesh.scatter" not in got and "mesh.issue" not in got
        assert "mesh.scatter_bytes" not in counts
        return
    want = sum(n * model._rows_per_chunk(b) * (shards - 1) // shards
               * (4 * model._bucket_width(b) + 4 + 8) for b, n in plan.items())
    assert got["mesh.scatter"].count == got["mesh.issue"].count == sum(plan.values())
    assert counts["mesh.scatter_bytes"] == want
    scatter = trace.spans("mesh.scatter")
    issue = {s.id for s in trace.spans("mesh.issue")}
    assert all(s.parent in issue for s in scatter)


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]])
def test_launches_count_at_each_replay(mesh):
    """A launch made inside the forward is held at capture and counted
    once a replay (per shard on a mesh); the warm-up's is not counted."""
    model = make_model("speech_laser", mesh=None if mesh is None else Mesh(mesh))
    wave, spans = document("speech_laser")
    counts = {"k": 0}
    forward = model._forward

    def counted(*args):
        _build.count_launch(counts, "k")
        return forward(*args)

    model._forward = counted
    n_chunks = sum(chunks_per_bucket(model, spans, len(wave)).values())
    _build.SHARD_LAUNCHES.clear()
    model.encode_spans(wave, spans)
    shards = 1 if mesh is None else 2
    assert counts["k"] == n_chunks * shards
    if mesh is not None:
        assert [_build.SHARD_LAUNCHES[(i, "k")] for i in range(2)] == [n_chunks] * 2
    model.encode_spans(wave, spans, eager=True)
    assert counts["k"] == 2 * n_chunks * shards


def test_replay_is_one_timed_phase():
    """With the EMBED spans on, a replayed chunk is one ``embed.replay``
    span (its capture opens none); the eager forward is three spans a
    chunk, ``embed.frontend``, ``embed.trunk`` and ``embed.pooler``."""
    model = make_model("speech_laser")
    wave, spans = document("speech_laser")
    n_chunks = sum(chunks_per_bucket(model, spans, len(wave)).values())
    split = ("embed.frontend", "embed.trunk", "embed.pooler")
    try:
        trace.reset()
        encode_common.start_encode_profile()
        model.encode_spans(wave, spans)
        got = trace.totals()
        assert got["embed.replay"].count == n_chunks and got["embed.replay"].host_s > 0
        assert not set(split) & set(got)
        trace.reset()
        model.encode_spans(wave, spans, eager=True)
        got = trace.totals()
        assert "embed.replay" not in got
        assert all(got[k].count == n_chunks and got[k].host_s > 0 for k in split)
    finally:
        encode_common.stop_encode_profile()
        trace.reset()


@pytest.mark.parametrize("kind", KINDS)
def test_programs_match_the_jax_package(kind):
    """The slice as a whole: rows through the programs against the JAX
    package's encoders (one jitted program per bucket), same seeded
    weights, fp32 uploads and compute."""
    model = make_model(kind)
    wave, spans = document(kind)
    if kind == "speech_laser":
        jm = jlaser.SpeechLaserModel(jlaser.LaserEncoderConfig(**LASER_SMALL, dtype="float32"),
                                     max_tokens=64000, upload_dtype="fp32")
        jm.BUCKETS = LASER_BUCKETS
    else:
        jm = jsonar.SonarSpeechModel(
            jsonar.SonarEncoderConfig(**SONAR_SMALL, dtype="float32", attention_backend="xla"),
            batch_size=2, upload_dtype="fp32")
        jm.BUCKET_FRAMES = SONAR_BUCKETS
    jm.WAVE_BUCKETS_S = (10, 41)
    want = np.asarray(jm.encode_spans(wave, spans))
    got = model.encode_spans(wave, spans)
    assert len(RerunGraph.captures) == 3
    assert np.abs(got - want).max() / np.abs(want).max() < JAX_TOL[kind]
