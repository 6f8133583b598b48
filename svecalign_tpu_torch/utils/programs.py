"""The port's program cache: one place that decides whether a forward is
replayed from a CUDA graph or run eagerly.

A :class:`Programs` holds the per-shape programs of ONE replica of a
model on one device (the JAX package's ``jax.jit``: one compiled program
per shape). The speech encoders (``models/encode_common.py``: one cache
per replica, a program per bucket, rows, width and input dtypes) and
Whisper's transcriber (``analysis/asr.py``: the encoder and one program
per decode step) run every forward through :meth:`Programs.run`:

- on a card (or with a stand-in graph type, the tests' route on the
  CPU) the forward is captured at its key's first call and replayed
  after. The capture follows PyTorch's recipe: one eager warm-up on a
  side stream (it fills what the forward caches on first use: the fbank
  constants, cuFFT plans, cuDNN's and cuBLAS's choices and workspace,
  the kernels' libraries and attributes), then ``torch.cuda.graph`` on
  that stream. A replay copies the inputs into the graph's static
  inputs, replays, and returns the static output, which the next replay
  of the key overwrites. A cache's graphs share one memory pool (one
  shape's activations at a time) and one side stream. A capture that
  fails raises; nothing falls back to the eager forward;
- anywhere else, or where the caller passes ``eager=True`` (the card's
  comparisons), it is the forward of the inputs moved to the cache's
  device: no capture, no static copy, no span and no count.

Names the benchmark reads, kept as they are: the span ``embed.replay``
(a replay with its copy-in, on the device; ``embed.replay_ms_p95``), the
counters ``embed.replays`` and ``embed.captures``
(``embed.window_captures``, ``embed.extractor_groups_per_replay``), and
the kernel launches a capture holds, counted at each replay
(``ops/_build.py``). Whisper's programs count under the same names. No
span runs inside a warm-up or capture.
"""

import time
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.utils import trace


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the interface :class:`Programs`
    uses (a test passes a stand-in with the same methods as
    ``graph_type``):

    - ``arena(device)``: what one cache's graphs share, one memory pool
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


class Programs:
    """The per-shape programs of ONE replica of a model on ``device``: a
    dict from a shape key to a :class:`Program`, one memory pool and one
    side stream for all of them (``graph_type.arena``). ``graph_type``
    None is :class:`CudaGraph` on a card and no graph elsewhere (every
    :meth:`run` eager); a stand-in class is used on any device.
    :class:`CudaGraph` asked for on another device than a card raises."""

    def __init__(self, device, graph_type=None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if graph_type is None and device.type == "cuda":
            graph_type = CudaGraph
        if graph_type is CudaGraph and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device, self.graph_type = device, graph_type
        self.arena = None if graph_type is None else graph_type.arena(device)
        self.programs: Dict[tuple, Program] = {}
        self.failed: list = []

    @property
    def replays(self) -> bool:
        """Whether :meth:`run` captures and replays (else every run is the
        eager forward): what a caller allocates once for its programs it
        allocates per call where this is False."""
        return self.graph_type is not None

    def load(self, key: tuple, inputs: Sequence[torch.Tensor]) -> bool:
        """Copy ``inputs`` into the static inputs of ``key``'s program,
        without replaying it; False, and nothing copied, where ``key`` has
        no program (yet, or on the eager route). A copy from another
        device runs on that device's current stream, after the two
        streams' work queued so far."""
        prog = self.programs.get(key)
        if prog is None:
            return False
        for static, x in zip(prog.inputs, inputs):
            static.copy_(x)
        return True

    def run(self, key: tuple, forward: Callable, inputs: Sequence[torch.Tensor],
            loaded: bool = False, eager: bool = False) -> torch.Tensor:
        """``forward(*inputs)``. Replaying (:attr:`replays`, and not
        ``eager``): by the program of ``key``, captured at the key's first
        call from static copies of ``inputs``, then replayed with
        ``inputs`` copied in (``loaded``: :meth:`load` has copied them in
        already); returns the static output, which the next replay of
        ``key`` overwrites. A failed capture raises and stores no program;
        the cache's later captures take a fresh pool and stream
        (:attr:`failed` keeps the failed graphs). Else ``forward`` of the
        inputs moved to :attr:`device`, eagerly."""
        if eager or not self.replays:
            return forward(*(x.to(self.device) for x in inputs))
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
        return 0 if self.arena is None else self.graph_type.arena_bytes(self.device, self.arena)
