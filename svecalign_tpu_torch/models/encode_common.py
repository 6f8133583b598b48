"""The span-encode loop shared by the speech encoders, and the phase
timers of an encode.

Port of the JAX package's ``models/encode_common.py``.
``SpanEncoderMixin.encode_spans`` embeds overlap windows of ONE waveform:
the waveform goes to the device once (int16 per 1 s block, or fp32), is
dequantised there once, and each chunk of windows is gathered out of it
(``ops/assemble.py``) and encoded. The model supplies its shape policy
through the same hooks as in JAX:

    _span_plan(start, ln)     -> (bucket, (start, n_samples, out_len), truncated?)
    _span_buckets()           -> the bucket list (model units)
    _bucket_width(bucket)     -> window width in SAMPLES
    _rows_per_chunk(bucket)   -> batch rows for that bucket
    _span_forward(rows, scales, lengths, bucket) -> (rows, dim) embeddings

plus ``_embed_dim``, ``_trunc_unit``, ``upload_dtype`` and ``device``;
``_span_forward`` calls the model's ``_forward(module, rows, scales,
lengths, bucket)`` on its replica of the weights.

Per-shape programs (the JAX package's ``jax.jit`` of the forward, one
compiled program per bucket and row count): on a card every
``_span_forward`` replays a CUDA graph, captured at the first chunk of its
shape, per replica and per (bucket, rows, width, input dtypes), and kept
for the model's life (:class:`SpanPrograms`). The capture follows
PyTorch's recipe: one eager warm-up on a side stream (it fills what the
forward caches on first use: the fbank constants, cuFFT plans, cuDNN's
and cuBLAS's choices and workspace, the kernels' libraries and
attributes), then ``torch.cuda.graph`` under ``torch.inference_mode()``.
A replay copies the chunk into the graph's static inputs, replays, and
copies the static output out, so the next replay of the shape cannot
overwrite rows a caller holds. A replica's graphs share one memory pool
(one bucket's activations at a time, not all nine) and one side stream.
A capture that fails raises; nothing falls back to the eager forward. The
eager forward runs on the CPU, where it is the tests' route, and wherever
a caller passes ``eager=True`` (the card's comparisons). What stays
outside the graph, as it stays outside the JAX program: the waveform's
upload and the windows' gather (``ops/assemble.py``), the pulls. Kernel
launches inside a graph are counted at each replay (``ops/_build.py``).

Data parallelism (the JAX package's mesh branch): with a mesh of more
than one data shard (``parallel/mesh.py``; by default every local card
when there is more than one, as in JAX), the weights are replicated on
every shard's device (:func:`place_model`), each chunk's rows are split
into contiguous slices, one per shard, and the rows come back to the
mesh's first device, ``self.device``, in row order. Chunks keep a row
count that is a multiple of the shard count. One thread queues every
shard's copy-in, then every shard's replay (``parallel.mesh.run_on_shards``),
and only then gathers their outputs, so distinct cards run their shards at
the same time, as the JAX program's shards do. The copy-ins go first
because a copy between cards runs on the source card's stream, the first
card's: a copy queued after that card's replay would start its own card
only when that replay ended. Each replica has its own programs, also
where two shards share a card.

``keep_device`` (the fused pipeline's handoff, ``utils/embed_cache.py``)
also writes every chunk's rows, as fp16, into one (embed_cache.max_rows,
dim) buffer on the device (the mesh's first) and returns it beside the
host rows.

Left out, as TPU workarounds whose flags keep their meaning: the compile
prewarm threads (a capture is lazy, at its shape's first chunk), the
``SVECALIGN_FUSED_CHUNK`` one-program chunk, the 2048-row accumulator
pulls (:func:`pull_rows` pulls the buffer with one copy), the staging
thread pool and buffer donation. Outputs stay on the device until one
pull at the end of the call.

Spans (``utils/trace.py``, the ``EMBED`` area: ``SVECALIGN_EMBED_PROFILE=1``
at a stage's entry, or :func:`start_encode_profile`): ``embed.quantize``
(the waveform's int16 blocks on the host, host-only), ``embed.plan`` (the
span plan, host-only), ``embed.assemble`` (the waveform's upload and each
chunk's gather, on the device), ``embed.replay`` (a program's copy-in and
replay; on a mesh one per shard, on the shard's device, and the replay
alone once the shape is captured), ``mesh.issue`` (per chunk on a mesh:
every shard's issue and the gather on the first device, host) and inside
it ``mesh.scatter`` (the queueing of every shard's copy-in, host),
``embed.pull`` (on the device), and in the eager forward
``embed.frontend``, ``embed.trunk`` and ``embed.pooler``; no span runs
inside a capture. Counters: ``embed.captures``, ``embed.replays``,
``embed.upload_bytes``, ``embed.pull_bytes``, ``mesh.scatter_bytes`` (the
input bytes the scatter copies to the shards other than the first). The
tracer's events are resolved after each pull, where the host has waited
for the device.
"""

import copy
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.parallel.mesh import Mesh, default_mesh, run_on_shards, shard_slices
from svecalign_tpu_torch.utils import embed_cache, trace
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.torch_setup import resolve_device

logger = logging.getLogger(__name__)

encode_profile = None
"""Stage 5.3's seconds while the ``EMBED`` spans are on, filled by
``seg_align/embed.py`` from them: ``read_s``, the host seconds of
``embed.read``, and ``assemble_s``, the device seconds of
``embed.assemble``. A stage call switched on by its variable starts it
afresh; :func:`start_encode_profile` starts it for a library caller, and
the stage then adds every file to it. None while off."""

PROFILE_KEYS = ("read_s", "assemble_s")


def start_encode_profile() -> dict:
    """Hold the ``EMBED`` spans on (as ``SVECALIGN_EMBED_PROFILE=1`` does at
    a stage's entry) until :func:`stop_encode_profile`; returns
    :data:`encode_profile`, zeroed."""
    global encode_profile
    trace.EMBED.force(True)
    encode_profile = dict.fromkeys(PROFILE_KEYS, 0.0)
    return encode_profile


def stop_encode_profile() -> None:
    """Stop holding the ``EMBED`` spans on; :data:`encode_profile` goes."""
    global encode_profile
    encode_profile = None
    trace.EMBED.force(False)


def switch_profile(device) -> bool:
    """A stage's entry: switch the ``EMBED`` spans by their variable (or
    keep them held on) and anchor ``device``; a call switched on by the
    variable starts :data:`encode_profile` afresh."""
    global encode_profile
    on = trace.EMBED.switch(device)
    if not trace.EMBED.forced:
        encode_profile = dict.fromkeys(PROFILE_KEYS, 0.0) if on else None
    return on


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the interface :class:`SpanPrograms`
    uses (a test puts a stand-in with the same methods in
    :attr:`SpanEncoderMixin.graph_type`):

    - ``arena(device)``: what one replica's graphs share, one memory pool
      (``torch.cuda.graph_pool_handle()``) and the side stream that warms
      up and captures them all;
    - ``CudaGraph(device, arena)``; ``warm_up(fn)`` runs ``fn`` eagerly
      on the side stream, after the work queued before it; ``capture(fn)``
      captures ``fn`` into the graph and returns its output, the graph's
      static output; ``replay()`` launches the graph on the device's
      current stream;
    - ``arena_bytes(device, arena)``: the device bytes the pool holds.
    """

    @staticmethod
    def arena(device: torch.device):
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def __init__(self, device: torch.device, arena):
        self.device = device
        self.pool, self.stream = arena
        self.graph = torch.cuda.CUDAGraph()

    def warm_up(self, fn: Callable) -> None:
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                fn()

    def capture(self, fn: Callable):
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            try:
                # "thread_local": only this thread is held to what a capture
                # allows, so that another thread (the pipeline's
                # --overlap_untrans) may go on using the card meanwhile
                with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = fn()
            except BaseException:
                # a failed capture_end leaves the allocator routing to the
                # pool, and no later capture into it could begin
                end = getattr(torch._C, "_cuda_endAllocateToPool", None)
                if end is not None:
                    try:
                        end(self.device.index, self.pool)
                    except RuntimeError:  # the capture had ended the routing
                        pass
                raise
            finally:
                # a failed capture leaves the side stream current
                torch.cuda.set_stream(current)
            current.wait_stream(self.stream)
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    @staticmethod
    def arena_bytes(device: torch.device, arena) -> int:
        pool = tuple(arena[0])
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg.get("device") == device.index
                   and tuple(seg.get("segment_pool_id", ())) == pool)


class Program(NamedTuple):
    """One captured forward: its graph, the static inputs it reads and
    the static output it writes (alive as long as the graph), the kernel
    launches it holds (counted at each replay) and the wall seconds of
    its warm-up and capture."""

    graph: object
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    launches: list
    capture_s: float


class SpanPrograms:
    """The per-shape programs of ONE replica of an encoder on ``device``:
    a dict from a shape key to a :class:`Program`, one memory pool and one
    side stream for all of them (``graph_type.arena``). ``graph_type``
    None is :class:`CudaGraph`, which needs a card: on any other device
    the constructor raises (the CPU's route is the eager forward, which
    the caller chooses; this class never runs it)."""

    def __init__(self, device, graph_type=None):
        device = torch.device(device)
        if graph_type is None:
            if device.type != "cuda":
                raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
            graph_type = CudaGraph
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.graph_type = device, graph_type
        self.arena = graph_type.arena(device)
        self.programs: Dict[tuple, Program] = {}
        self.failed: list = []

    def load(self, key: tuple, inputs: Sequence[torch.Tensor]) -> bool:
        """Copy ``inputs`` into the static inputs of ``key``'s program,
        without replaying it; False, and nothing copied, where ``key`` has
        no program yet. A copy from another device runs on that device's
        current stream, after the two streams' work queued so far."""
        prog = self.programs.get(key)
        if prog is None:
            return False
        for static, x in zip(prog.inputs, inputs):
            static.copy_(x)
        return True

    def run(self, key: tuple, forward: Callable, inputs: Sequence[torch.Tensor],
            loaded: bool = False) -> torch.Tensor:
        """``forward(*inputs)`` by the program of ``key``: captured at the
        key's first call, from static copies of ``inputs``, then replayed
        with ``inputs`` copied in (``loaded``: :meth:`load` has copied them
        in already). Returns the static output, which the next replay of
        ``key`` overwrites. A failed capture raises and stores no program;
        the replica's later captures take a fresh pool and stream
        (:attr:`failed` keeps the failed graphs)."""
        with trace.EMBED.span("embed.replay", self.device):
            prog = self.programs.get(key)
            if prog is None:
                prog = self._capture(forward, inputs)
                self.programs[key] = prog
            elif not loaded:
                self.load(key, inputs)
            prog.graph.replay()
        trace.count("embed.replays")
        _build.count_replay(prog.launches)
        return prog.output

    def _capture(self, forward: Callable, inputs: Sequence[torch.Tensor]) -> Program:
        trace.count("embed.captures")
        t0 = time.perf_counter()
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x)
        graph = self.graph_type(self.device, self.arena)
        # set-up, as a program's compile is: its launches not counted, no span
        with _build.holding_launches(), trace.holding():
            graph.warm_up(lambda: forward(*static))
        try:
            with _build.holding_launches() as launches, trace.holding():
                output = graph.capture(lambda: forward(*static))
        except BaseException:
            # later captures take a fresh pool and stream; the failed graph
            # is kept, as the allocator may still refer to it
            self.failed.append(graph)
            self.arena = self.graph_type.arena(self.device)
            raise
        return Program(graph, static, output, launches, time.perf_counter() - t0)

    def pool_bytes(self) -> int:
        return self.graph_type.arena_bytes(self.device, self.arena)


def _copy_to(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` itself where it already lives on ``device``, else a copy there."""
    p = next(module.parameters(), None)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return module if p is not None and p.device == device else copy.deepcopy(module).to(device)


def place_model(model: torch.nn.Module, device, mesh: Optional[Mesh], move: bool = True):
    """Put an encoder's weights where it runs: ``(device, mesh, replicas)``.
    ``mesh`` None takes :func:`parallel.mesh.default_mesh`; with no mesh,
    or one of a single data shard, the model runs on that one device and
    the returned mesh is None. Otherwise the device is the mesh's first
    and ``replicas`` holds one copy of ``model`` per data shard, made once
    per distinct device. ``move``: ``model`` itself goes to the first
    device (a model just built); else it stays where it is, untouched."""
    if mesh is None:
        mesh = default_mesh(device)
    devs = [resolve_device(device)] if mesh is None else mesh.data_devices
    distinct = list(dict.fromkeys(devs))
    placed = {d: _copy_to(model, d) for d in distinct[1:]}
    placed[distinct[0]] = model.to(distinct[0]) if move else _copy_to(model, distinct[0])
    return devs[0], (mesh if len(devs) > 1 else None), [placed[d] for d in devs]


def stage_rows(pieces, rows: int, width: int, fp32: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The host staging of ``encode()``: ``pieces`` (1-D fp32 waveforms,
    each cut to ``width``) padded into (rows, width) fp32 or int16 and
    their (rows,) scales. int16 scales each row to its own peak, rounded
    half to even (``np.rint``), exactly the JAX package's staging; padding
    rows are zeros with scale 1."""
    padded = np.zeros((rows, width), dtype=np.float32 if fp32 else np.int16)
    scales = np.ones((rows,), dtype=np.float32)
    for row, w in enumerate(pieces):
        w = w[:width]
        if fp32:
            padded[row, : len(w)] = w
        else:
            peak = float(np.max(np.abs(w))) if len(w) else 0.0
            s = peak / 32767.0 if peak > 0 else 1.0
            padded[row, : len(w)] = np.rint(w / s).astype(np.int16)
            scales[row] = s
    return padded, scales


def pull_rows(pending: Sequence[Tuple[List[int], torch.Tensor]], n: int, dim: int,
              fp16: bool, device: torch.device, keep_device: bool = False):
    """Scatter each chunk's device rows into one (n, dim) host array
    (float16 when ``fp16``: the rows were cast on the device); padding
    rows of a chunk (past its index list) are dropped.

    ``keep_device``: also write each chunk's rows, as fp16 (the ``.embed``
    file's dtype), into one zeroed (embed_cache.max_rows, dim) buffer on
    ``device`` with ``index_copy_``, and return ``(out, buffer)``; the
    buffer is None when ``n`` exceeds ``embed_cache.max_rows``. Its first
    ``n`` rows are bit-equal to the rows the writer stores. With ``fp16``
    the host rows are one copy of ``buffer[:n]`` (the JAX package pulls
    its buffer in 2048-row slices, a transfer-size workaround)."""
    dev = None
    with trace.EMBED.span("embed.pull", device):
        if keep_device and n <= embed_cache.max_rows:
            dev = torch.zeros((embed_cache.max_rows, dim), dtype=torch.float16, device=device)
            for ids, emb in pending:
                dev.index_copy_(0, torch.tensor(ids, dtype=torch.int64, device=device),
                                emb[: len(ids)].half())
        if dev is not None and fp16:
            out = dev[:n].cpu().numpy()
        else:
            out = np.zeros((n, dim), dtype=np.float16 if fp16 else np.float32)
            if pending:
                ids = np.concatenate([np.asarray(i, np.int64) for i, _ in pending])
                rows = torch.cat([emb[: len(i)] for i, emb in pending]).cpu().numpy()
                out[ids] = rows
    trace.count("embed.pull_bytes", out.nbytes)
    trace.flush()  # the host has waited for the device: resolve the spans' events
    return (out, dev) if keep_device else out


class SpanEncoderMixin:
    """encode_spans() for models exposing the hook set described above."""

    mesh: Optional[Mesh] = None
    _replicas: Sequence[torch.nn.Module] = ()
    graph_type = None
    """How a forward runs: None replays a :class:`CudaGraph` per shape on
    a card and runs the eager forward on the CPU; a class with
    :class:`CudaGraph`'s interface (a test's stand-in) is used on any
    device."""

    @property
    def data_shards(self) -> int:
        return 1 if self.mesh is None else len(self.mesh.data_devices)

    def _fit_rows_to_mesh(self) -> None:
        """Hook for a model with a fixed chunk row count: round it up to a
        multiple of :attr:`data_shards`."""

    def _forward_variant(self, model: torch.nn.Module) -> tuple:
        """What besides the shapes picks the kernels of ``model``'s forward
        (a SONAR trunk's attention routes): part of a program's key."""
        return ()

    def __copy__(self):
        """A shallow copy with no programs of its own yet: a copy may
        change its shapes (rows per chunk) or its replicas."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other._span_programs = {}
        return other

    def with_mesh(self, mesh: Optional[Mesh]) -> "SpanEncoderMixin":
        """The same model, its weights placed over ``mesh`` (None: the
        default mesh); ``self`` is left as it is. Replicas are copies of
        this model's weights: nothing is initialised or read again."""
        other = copy.copy(self)
        other.device, other.mesh, other._replicas = place_model(
            self.model, self.device, mesh, move=False)
        other.model = other._replicas[0]
        other._fit_rows_to_mesh()
        return other

    def _programs(self, i: int) -> SpanPrograms:
        """Replica ``i``'s programs, made at its first use."""
        progs = self.__dict__.setdefault("_span_programs", {})
        if i not in progs:
            dev = self.device if self.mesh is None else self.mesh.data_devices[i]
            progs[i] = SpanPrograms(dev, self.graph_type)
        return progs[i]

    def program_stats(self) -> List[dict]:
        """Per replica with programs: its device, each program's key and
        capture seconds, and the bytes of its graph pool."""
        progs = self.__dict__.get("_span_programs", {})
        return [{"replica": i, "device": str(pr.device), "pool_bytes": pr.pool_bytes(),
                 "capture_s": {key: prog.capture_s for key, prog in pr.programs.items()}}
                for i, pr in sorted(progs.items())]

    def _program_key(self, i: int, inputs, bucket) -> tuple:
        """The key of replica ``i``'s program for ``inputs`` (rows, scales,
        lengths) of ``bucket``."""
        return (bucket, *inputs[0].shape, *(x.dtype for x in inputs),
                self._forward_variant(self._replicas[i]))

    def _replay(self, i: int, rows_q, row_scales, lengths, bucket,
                loaded: bool = False) -> torch.Tensor:
        """Replica ``i``'s forward of one chunk (or shard) by its program;
        returns the program's static output. ``loaded``: the program's
        :meth:`SpanPrograms.load` has copied the inputs in."""
        model = self._replicas[i]
        inputs = (rows_q, row_scales, lengths)
        return self._programs(i).run(
            self._program_key(i, inputs, bucket),
            lambda q, s, n: self._forward(model, q, s, n, bucket), inputs, loaded)

    @torch.inference_mode()
    def _span_forward(self, rows_q, row_scales, lengths, bucket, eager: bool = False):
        """(rows, width) int16 or fp32 waveforms, (rows,) scales and
        lengths on ``self.device`` -> (rows, dim) fp32 there, a tensor of
        its own; with a mesh, each shard's slice of the rows on its own
        replica and device. On a card by the replay of the chunk shape's
        program (:class:`SpanPrograms`); on the CPU, or with ``eager``, by
        the eager forward."""
        if eager or (self.graph_type is None and self.device.type != "cuda"):
            if self.mesh is None:
                return self._forward(self._replicas[0], rows_q, row_scales, lengths, bucket)

            def shard(i, dev, sl):
                return self._forward(self._replicas[i], rows_q[sl].to(dev),
                                     row_scales[sl].to(dev), lengths[sl].to(dev),
                                     bucket).to(self.device)

            with trace.EMBED.span("mesh.issue"):
                return torch.cat(run_on_shards(self.mesh, shard,
                                               shard_slices(rows_q.shape[0], self.mesh)))
        if self.mesh is None:
            return self._replay(0, rows_q, row_scales, lengths, bucket).clone()
        # Every shard's copy-in first, then every shard's replay, then the
        # gather (a copy) in row order. A copy between cards runs on the
        # source card's stream, the first card's: queued behind that card's
        # replay, it would hold its own card until that replay ended.
        shards = [(rows_q[sl], row_scales[sl], lengths[sl])
                  for sl in shard_slices(rows_q.shape[0], self.mesh)]
        with trace.EMBED.span("mesh.issue"):
            with trace.EMBED.span("mesh.scatter"):
                loaded = run_on_shards(self.mesh, lambda i, dev, x: self._programs(i).load(
                    self._program_key(i, x, bucket), x), shards)
            trace.count("mesh.scatter_bytes", sum(x.nbytes for part, done in
                                                  zip(shards[1:], loaded[1:]) if done
                                                  for x in part))
            outs = run_on_shards(
                self.mesh, lambda i, dev, x: self._replay(i, *x, bucket, loaded[i]), shards)
            return torch.cat([o.to(self.device) for o in outs])

    def encode_spans(self, waveform, spans, keep_device: bool = False,
                     fp16_pull: bool = False, eager: bool = False):
        """Encode (start, end) sample spans of ONE waveform -> (N, dim).

        Equivalent to ``encode([waveform[s:e] for s, e in spans])``: bit-equal
        in fp32 upload mode, within about one quantization step in int16
        mode (per 1 s block, then per row on the device). Waveforms longer
        than the largest wave bucket fall back to host-sliced encode().
        ``fp16_pull`` casts the rows to fp16 on the device. ``keep_device``
        returns ``(out, device fp16 rows)``, as :func:`pull_rows` says.
        ``eager`` runs the eager forward where a card would replay a
        program (``_span_forward``).
        """
        from svecalign_tpu_torch.ops import assemble

        waveform = np.asarray(waveform, dtype=np.float32)
        if waveform.ndim == 2:
            waveform = waveform[:, 0]
        buckets_s = sorted(self.WAVE_BUCKETS_S or assemble.WAVE_BUCKETS_S)
        wave_len = next((b * 16000 for b in buckets_s if len(waveform) <= b * 16000), None)
        if wave_len is None:
            logger.warning(
                f"encode_spans: waveform of {len(waveform) / 16000:.0f} s "
                f"exceeds the largest wave bucket ({buckets_s[-1]} s); "
                "falling back to host-sliced encode()"
            )
            return self.encode([waveform[s:e] for s, e in spans], keep_device=keep_device,
                               fp16_pull=fp16_pull, eager=eager)

        fp32 = self.upload_dtype == "fp32"
        dev = self.device
        with trace.EMBED.span("embed.quantize", dev, host_only=True):
            wave_host, block_scales = assemble.quantize_wave(waveform, wave_len, fp32)
        with trace.EMBED.span("embed.assemble", dev):
            slack = max(self._bucket_width(b) for b in self._span_buckets())
            wave_dev = assemble.dequant(torch.from_numpy(wave_host).to(dev),
                                        torch.from_numpy(block_scales).to(dev), slack)
        trace.count("embed.upload_bytes", wave_host.nbytes + block_scales.nbytes)

        by_bucket: dict = {}
        n_truncated = 0
        with trace.EMBED.span("embed.plan", dev, host_only=True):
            for i, (s, e) in enumerate(spans):
                # clamp to the waveform like host slicing (waveform[s:e] is
                # short when e overruns the file)
                ln = max(min(e, len(waveform)) - s, 0)
                bucket, idx_row, truncated = self._span_plan(s, ln)
                n_truncated += truncated
                by_bucket.setdefault(bucket, []).append((i, idx_row))
        if n_truncated:
            logger.warning(
                f"{n_truncated}/{len(spans)} spans exceed the largest "
                f"length bucket ({self._trunc_unit}) and are TRUNCATED "
                "to it -- their embeddings cover only the prefix"
            )

        pending = []
        for bucket, items in sorted(by_bucket.items()):
            rows = self._rows_per_chunk(bucket)
            width = self._bucket_width(bucket)
            for c0 in range(0, len(items), rows):
                chunk = items[c0:c0 + rows]
                # [start, n_samples, out_len] per row; padding rows read
                # nothing (n_samples 0) and have length 0
                idx = np.zeros((rows, 3), np.int64)
                idx[: len(chunk)] = [idx_row for _, idx_row in chunk]
                with trace.EMBED.span("embed.assemble", dev):
                    rows_q, row_scales, lengths = assemble.assemble(
                        wave_dev, torch.from_numpy(idx).to(dev), width, fp32)
                trace.count("embed.upload_bytes", idx.nbytes)
                emb = self._span_forward(rows_q, row_scales, lengths, bucket, eager)
                pending.append(([i for i, _ in chunk], emb.half() if fp16_pull else emb))
        return pull_rows(pending, len(spans), self._embed_dim, fp16_pull, dev, keep_device)
