"""The speech encoders' host wrapper, shared by SpeechLASER and SONAR,
and the phase timers of an encode.

Port of the JAX package's ``models/encode_common.py``.
:class:`SpanEncoderMixin` holds everything but a model's shape policy and
its forward: the weights' set-up, the host-sliced ``encode``,
``encode_spans`` and the one chunk loop under both, the per-chunk forward
on one device or a mesh, and the pull. ``encode_spans`` embeds overlap
windows of ONE waveform: the waveform goes to the device once (int16 per
1 s block, or fp32), is dequantised there once, and each chunk of
windows is gathered out of it (``ops/assemble.py``); ``encode`` stages
each chunk's rows on the host (:func:`stage_rows`) and uploads them. The
model supplies its shape policy through the same hooks as in JAX:

    _span_plan(start, ln)     -> (bucket, (start, n_samples, out_len), truncated?)
    _span_buckets()           -> the bucket list (model units)
    _bucket_width(bucket)     -> window width in SAMPLES
    _rows_per_chunk(bucket)   -> batch rows for that bucket
    _forward(module, rows, scales, lengths, bucket) -> (rows, dim) embeddings

plus ``_embed_dim`` and ``_trunc_unit``.

Every chunk's forward goes through a replica's program cache
(``utils/programs.py``, one :class:`~svecalign_tpu_torch.utils.programs.Programs`
per replica, a program per bucket, rows, width, input dtypes and
``_forward_variant``, kept for the model's life): on a card it replays a
CUDA graph captured at its shape's first chunk, on the CPU, or with
``eager=True`` (the card's comparisons), it runs the eager forward. What
stays outside the graph, as it stays outside the JAX program: the
waveform's upload and the windows' gather, the pulls.

Data parallelism (the JAX package's mesh branch): with a mesh of more
than one data shard (``parallel/mesh.py``; by default every local card
when there is more than one, as in JAX), the weights are replicated on
every shard's device (:func:`place_model`), each chunk's rows are split
into contiguous slices, one per shard, and the rows come back to the
mesh's first device, ``self.device``, in row order. Chunks keep a row
count that is a multiple of the shard count. One thread queues every
shard's copy-in, then every shard's replay or forward
(``parallel.mesh.run_on_shards``), and only then gathers their outputs, so
distinct cards run their shards at the same time, as the JAX program's
shards do. The copy-ins go first because a copy between cards runs on
the source card's stream, the first card's: a copy queued after that
card's replay would start its own card only when that replay ended.
Each replica has its own programs, also where two shards share a card.

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
chunk's gather, on the device), ``embed.replay`` (the program cache's; on
a mesh one per shard, on the shard's device), ``mesh.issue`` (per chunk
on a mesh: every shard's issue and the gather on the first device, host)
and inside it ``mesh.scatter`` (the queueing of every shard's copy-in,
host), ``embed.pull`` (on the device), and in the eager forward
``embed.frontend``, ``embed.trunk`` and ``embed.pooler``; no span runs
inside a capture. Counters: ``embed.captures`` and ``embed.replays`` (the
program cache's), ``embed.upload_bytes``, ``embed.pull_bytes``,
``mesh.scatter_bytes`` (the input bytes the scatter copies to the shards
other than the first). The tracer's events are resolved after each pull,
where the host has waited for the device.
"""

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from svecalign_tpu_torch.models.param_utils import load_params_npz, params_from_jax
from svecalign_tpu_torch.models.w2v_bert import compute_dtype
from svecalign_tpu_torch.ops import _build, assemble, layer_norm_cuda
from svecalign_tpu_torch.parallel.mesh import Mesh, default_mesh, run_on_shards, shard_slices
from svecalign_tpu_torch.utils import embed_cache, trace
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.programs import Programs
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
    """A speech encoder's host wrapper for a model that supplies the hooks
    described above: the weights' set-up, ``encode`` and ``encode_spans``."""

    mesh: Optional[Mesh] = None
    _replicas: Sequence[nn.Module] = ()
    graph_type = None
    """The program caches' graph type (``utils/programs.py``): None
    replays a CUDA graph per shape on a card and runs the eager forward on
    the CPU; a class with ``programs.CudaGraph``'s interface (a test's
    stand-in) is used on any device."""
    WAVE_BUCKETS_S: Sequence[int] = assemble.WAVE_BUCKETS_S
    """``encode_spans``' waveform buckets, in seconds (a test sets its own)."""
    KEEP_FP32: Tuple[str, ...] = ()
    """Names of Linear and Conv modules whose weights stay fp32."""

    def __init__(self, encoder: Callable[..., nn.Module], config, ckpt_path: Optional[str],
                 seed: int, upload_dtype: str, device, mesh: Optional[Mesh]):
        """Build ``encoder(config)`` on the meta device, load its weights
        from a JAX ``.npz`` (``save_params_npz``) or, without one, from the
        JAX package's numpy init for ``seed`` (so that both packages hold
        the same random weights), store every Linear and Conv weight not
        in :attr:`KEEP_FP32` in the compute dtype once (the same rounding
        as flax's per-call cast; the LayerNorms stay fp32), and place the
        weights on every data shard's device (:func:`place_model`).
        ``upload_dtype``: int16 (half the bytes) or fp32 (exact)."""
        if upload_dtype not in ("int16", "fp32"):
            raise ValueError(f"upload_dtype must be int16 or fp32, got {upload_dtype!r}")
        self.config = config
        self.upload_dtype = upload_dtype
        if resolve_device(device).type == "cuda":  # no card and no device="cpu": raise
            # nvcc builds the LayerNorm kernel while the weights are made
            _build.prebuild([layer_norm_cuda.KERNEL])

        with torch.device("meta"):
            model = encoder(config)
        flat = load_params_npz(ckpt_path) if ckpt_path else {}
        state = params_from_jax(flat, model, seed=seed, source=ckpt_path or "random init")
        model.load_state_dict(state, assign=True)
        name = type(self).__name__
        if ckpt_path:
            logger.info(f"Loaded {name} params from {ckpt_path}")
        else:
            logger.warning(f"{name} initialized with RANDOM weights (no checkpoint given); "
                           "embeddings are not meaningful for mining.")
        dt = compute_dtype(config)
        for mod_name, mod in model.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)) and mod_name not in self.KEEP_FP32:
                mod.to(dt)
        self.device, self.mesh, self._replicas = place_model(
            model.eval().requires_grad_(False), device, mesh)
        self.model = self._replicas[0]
        self._fit_rows_to_mesh()

    @property
    def data_shards(self) -> int:
        return 1 if self.mesh is None else len(self.mesh.data_devices)

    def _fit_rows_to_mesh(self) -> None:
        """Hook for a model with a fixed chunk row count: round it up to a
        multiple of :attr:`data_shards`."""

    def _forward_variant(self, model: nn.Module) -> tuple:
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

    def _programs(self, i: int) -> Programs:
        """Replica ``i``'s program cache, made at its first use."""
        progs = self.__dict__.setdefault("_span_programs", {})
        if i not in progs:
            dev = self.device if self.mesh is None else self.mesh.data_devices[i]
            progs[i] = Programs(dev, self.graph_type)
        return progs[i]

    def program_stats(self) -> List[dict]:
        """Per replica whose cache replays: its device, each program's key
        and capture seconds, and the bytes of its graph pool."""
        progs = self.__dict__.get("_span_programs", {})
        return [{"replica": i, "device": str(pr.device), "pool_bytes": pr.pool_bytes(),
                 "capture_s": {key: prog.capture_s for key, prog in pr.programs.items()}}
                for i, pr in sorted(progs.items()) if pr.replays]

    def _program_key(self, i: int, inputs, bucket) -> tuple:
        """The key of replica ``i``'s program for ``inputs`` (rows, scales,
        lengths) of ``bucket``."""
        return (bucket, *inputs[0].shape, *(x.dtype for x in inputs),
                self._forward_variant(self._replicas[i]))

    def _replay(self, i: int, rows_q, row_scales, lengths, bucket,
                loaded: bool = False, eager: bool = False) -> torch.Tensor:
        """Replica ``i``'s forward of one chunk (or shard) through its
        program cache (:meth:`Programs.run`: on a replay, the program's
        static output). ``loaded``: :meth:`Programs.load` has copied the
        inputs in."""
        model = self._replicas[i]
        inputs = (rows_q, row_scales, lengths)
        return self._programs(i).run(
            self._program_key(i, inputs, bucket),
            lambda q, s, n: self._forward(model, q, s, n, bucket), inputs, loaded, eager)

    @torch.inference_mode()
    def _span_forward(self, rows_q, row_scales, lengths, bucket, eager: bool = False):
        """(rows, width) int16 or fp32 waveforms, (rows,) scales and
        lengths on ``self.device`` -> (rows, dim) fp32 there, a tensor of
        its own; with a mesh, each shard's slice of the rows on its own
        replica and device. ``eager``: the eager forward where a card
        would replay the chunk shape's program."""
        if self.mesh is None:
            # a replay returns the program's output, which the next overwrites
            return self._replay(0, rows_q, row_scales, lengths, bucket, eager=eager).clone()
        # Every shard's copy-in first, then every shard's replay, then the
        # gather (a copy) in row order. A copy between cards runs on the
        # source card's stream, the first card's: queued behind that card's
        # replay, it would hold its own card until that replay ended.
        shards = [(rows_q[sl], row_scales[sl], lengths[sl])
                  for sl in shard_slices(rows_q.shape[0], self.mesh)]
        with trace.EMBED.span("mesh.issue"):
            with trace.EMBED.span("mesh.scatter"):
                loaded = run_on_shards(self.mesh, lambda i, dev, x: not eager and self._programs(
                    i).load(self._program_key(i, x, bucket), x), shards)
            trace.count("mesh.scatter_bytes", sum(x.nbytes for part, done in
                                                  zip(shards[1:], loaded[1:]) if done
                                                  for x in part))
            outs = run_on_shards(self.mesh, lambda i, dev, x: self._replay(
                i, *x, bucket, loaded[i], eager), shards)
            return torch.cat([o.to(self.device) for o in outs])

    def _encode_chunks(self, plans, make_chunk: Callable, keep_device: bool, fp16_pull: bool,
                       eager: bool):
        """The chunk loop of :meth:`encode` and :meth:`encode_spans`.
        ``plans``: per input, ``(bucket, item, truncated?)``. Each bucket's
        items go in chunks of ``_rows_per_chunk(bucket)`` rows;
        ``make_chunk(bucket, rows, items)`` puts a chunk's (rows, scales,
        lengths) on ``self.device`` (padding rows have length 0); the rows
        come back in input order (:func:`pull_rows`)."""
        by_bucket: dict = {}
        for i, (bucket, item, _) in enumerate(plans):
            by_bucket.setdefault(bucket, []).append((i, item))
        n_truncated = sum(truncated for *_, truncated in plans)
        if n_truncated:
            logger.warning(
                f"{n_truncated}/{len(plans)} inputs exceed the largest length bucket "
                f"({self._trunc_unit}) and are TRUNCATED to it -- their embeddings cover "
                "only the prefix"
            )
        pending = []
        for bucket, items in sorted(by_bucket.items()):
            rows = self._rows_per_chunk(bucket)
            for c0 in range(0, len(items), rows):
                chunk = items[c0:c0 + rows]
                emb = self._span_forward(*make_chunk(bucket, rows, [x for _, x in chunk]),
                                         bucket, eager)
                pending.append(([i for i, _ in chunk], emb.half() if fp16_pull else emb))
        return pull_rows(pending, len(plans), self._embed_dim, fp16_pull, self.device,
                         keep_device)

    def encode(self, waveforms, keep_device: bool = False, fp16_pull: bool = False,
               eager: bool = False):
        """Encode waveforms -> (N, dim) float32 (float16 under
        ``fp16_pull``: cast on the device, bit-equal to the writer's host
        fp32 -> fp16 cast). Each input is planned as a span of its own;
        each chunk's rows are staged on the host, cut to their bucket's
        width and padded to a fixed (rows, width) shape. ``keep_device``
        returns ``(out, device fp16 rows)`` (:func:`pull_rows`). ``eager``:
        the eager forward where a card would replay the chunk shape's
        program."""
        fp32 = self.upload_dtype == "fp32"
        plans = []
        for w in waveforms:
            w = np.asarray(w, dtype=np.float32)
            if w.ndim == 2:
                w = w[:, 0]  # channel 0, as slice_segments/encode_spans
            bucket, (_, _, out_len), truncated = self._span_plan(0, len(w))
            plans.append((bucket, (w, out_len), truncated))

        def stage(bucket, rows, items):
            padded, scales = stage_rows([w for w, _ in items], rows, self._bucket_width(bucket),
                                        fp32)
            lengths = np.zeros((rows,), dtype=np.int32)
            lengths[: len(items)] = [out_len for _, out_len in items]
            return tuple(torch.from_numpy(a).to(self.device) for a in (padded, scales, lengths))

        return self._encode_chunks(plans, stage, keep_device, fp16_pull, eager)

    def encode_spans(self, waveform, spans, keep_device: bool = False,
                     fp16_pull: bool = False, eager: bool = False):
        """Encode (start, end) sample spans of ONE waveform -> (N, dim).

        Equivalent to ``encode([waveform[s:e] for s, e in spans])``: bit-equal
        in fp32 upload mode, within about one quantization step in int16
        mode (per 1 s block, then per row on the device). Waveforms longer
        than the largest wave bucket fall back to host-sliced encode().
        ``fp16_pull``, ``keep_device`` and ``eager`` as in :meth:`encode`.
        """
        waveform = np.asarray(waveform, dtype=np.float32)
        if waveform.ndim == 2:
            waveform = waveform[:, 0]
        buckets_s = sorted(self.WAVE_BUCKETS_S)
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

        with trace.EMBED.span("embed.plan", dev, host_only=True):
            # clamp to the waveform like host slicing (waveform[s:e] is
            # short when e overruns the file)
            plans = [self._span_plan(s, max(min(e, len(waveform)) - s, 0)) for s, e in spans]

        def gather(bucket, rows, items):
            # [start, n_samples, out_len] per row; padding rows read
            # nothing (n_samples 0) and have length 0
            idx = np.zeros((rows, 3), np.int64)
            idx[: len(items)] = items
            with trace.EMBED.span("embed.assemble", dev):
                chunk = assemble.assemble(wave_dev, torch.from_numpy(idx).to(dev),
                                          self._bucket_width(bucket), fp32)
            trace.count("embed.upload_bytes", idx.nbytes)
            return chunk

        return self._encode_chunks(plans, gather, keep_device, fp16_pull, eager)
