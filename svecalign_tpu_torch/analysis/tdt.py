"""Batched greedy transcription with Parakeet-TDT: the audit stage's
second ASR, beside Whisper's (``analysis/asr.py``).

``analysis/dump_alignments.py --asr --asr_model parakeet-tdt`` runs it
through ``asr.transcribe_sides``, which takes either transcriber: both
have ``transcribe(clips, langs, max_tokens, keep_logits)``. A call takes
clips (1-D fp32 waveforms at 16 kHz) and returns, for each, the token ids
of greedy token-and-duration decoding (``models/parakeet.py``):

- a clip longer than the largest bucket is cut into pieces of that
  length, each decoded as its own row, and the pieces' ids are joined;
- rows go in the call's order, ``batch`` at a time (the last batch filled
  with silent rows of no frames), every batch padded to the smallest of
  the bucket lengths (:data:`BUCKETS_S`, 10 s to 20 s in steps of 2 s,
  then 30 s: a batch of 64 audit clips pads to its longest, 11-18 s)
  that holds its longest row: NeMo's normalised
  log-mel of every row (``ops/fbank.py::parakeet_log_mel``, on the card)
  -> the encoder and the joint's frame projection, one program per
  (batch, bucket) -> the decode loop, every row at its own frame pointer,
  in programs of :data:`LOOP_ITERATIONS` iterations over state buffers
  (``models/parakeet.py::LoopState``) allocated once per bucket. The host
  queues each program before it waits, once, for the "every row done"
  flag of the one before, so that the card runs a program while the host
  launches the next; a batch so runs one program more than its rows need,
  and a row that is done keeps being computed and changes nothing;
- the host queues the next batch's upload, log-mel and encoder before it
  waits for a batch's results (one copy, queued behind its last program),
  so that the card encodes while the host writes the transcripts; no copy
  to the card waits for the card's queue (the host's lists go through
  pinned memory);
- the encoder and the loop run through one program cache
  (``utils/programs.py``, as the stage-5.3 encoders and Whisper do): on a
  card they are CUDA graphs captured at a key's first use and replayed.
  A loop program is first captured over a state in which every row is
  done, so that its warm-up and first replay change nothing, then the
  batch's state is set. On the CPU both run eagerly, over a state
  allocated per batch.

:data:`LOOP_ITERATIONS` is 16: a batch of the audit's clips runs ~6
iterations a second of its longest row (~70-110 a batch); a program's
launch costs the host about half of its device time (the graph's nodes)
and is hidden behind the program before it, while each batch runs its
last program and a half of iterations after every row is done: 16 keeps
that tail to ~20% of a batch's loop, and fewer iterations a program would
make the launches, not the card, the loop's pace.

A clip's ids, frames and logits do not depend on its batch-mates: each
row has its own features' statistics, the stem and the conv modules zero
every frame past a row's own length, and padded keys are masked out of
every softmax. ``langs`` is accepted for the call's contract and not
used: the model detects the language itself. ``max_tokens`` caps the
tokens a piece emits (a row is done at its cap); None is no cap but T
frames x ``max_symbols``.

Spans (``utils/trace.py``'s ``ASR`` area, ``SVECALIGN_ASR_PROFILE=1``):
per batch ``asr.mel``, ``asr.encode`` and ``asr.decode`` (on the card;
``asr.decode`` holds one ``asr.tdt_loop`` a program launch, on the card,
and one ``asr.tdt_check`` a wait for the done flag, on the host, and ends
with the results' copy queued), then ``asr.write`` (host-only: the wait
for those results, after the next batch is queued, and the transcripts).
Counters: ``asr.clips``; ``asr.tokens`` (tokens emitted);
``asr.tdt_iterations`` (loop iterations run, ``LOOP_ITERATIONS`` a
program); ``asr.tdt_row_iterations`` (the live rows summed over the
iterations, counted on the card); ``asr.tdt_forced`` (advances forced by
the ``max_symbols`` rule).

Departures from NeMo's ``transcribe()``: transcripts are token ids, as
the SentencePiece vocabulary is not in the repository; no timestamps,
no chunked streaming; a clip over the largest bucket is decoded in
independent pieces.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from svecalign_tpu_torch.analysis.asr import SAMPLE_RATE, Transcript, batches, pieces
from svecalign_tpu_torch.models import parakeet
from svecalign_tpu_torch.ops.fbank import parakeet_frames, parakeet_log_mel
from svecalign_tpu_torch.utils import trace
from svecalign_tpu_torch.utils.programs import Programs

LOOP_ITERATIONS = 16
BUCKETS_S = (10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 30.0)
NO_CAP = 2 ** 62


@dataclass
class TdtTranscript(Transcript):
    """A clip's result: ``tokens`` and the encoder frame of each
    (``frames``; a piece's frames follow the previous pieces'), each
    piece's ``(T, frame the loop ended at)`` in ``ends``, the points the
    loop visited (iterations the clip's rows were live in) in ``points``;
    for a clip in
    ``keep_logits``, every point the loop visited as ``(t, k, d)`` rows of
    ``path`` and the raw fp32 joint logits there (``logits``, the token
    logits then the duration logits). ``prompt`` is empty."""

    frames: List[int] = field(default_factory=list)
    points: int = 0
    ends: List[Tuple[int, int]] = field(default_factory=list)
    path: Optional[np.ndarray] = None


class TdtTranscriber:
    """Greedy batched TDT decoding with one loaded
    :class:`~svecalign_tpu_torch.models.parakeet.Parakeet`."""

    def __init__(self, model: parakeet.Parakeet, batch: int = 64,
                 bucket_s: Sequence[float] = BUCKETS_S, graph_type=None):
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.model, self.batch, self.iterations = model, batch, LOOP_ITERATIONS
        self.device = model.joint.out.weight.device
        self.buckets = sorted({int(round(s * SAMPLE_RATE)) for s in bucket_s})
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"bucket lengths must be positive, got {bucket_s}")
        # graph_type: a stand-in for the CUDA graph (the tests' programs on the CPU)
        self.programs = Programs(self.device, graph_type)
        self.states: Dict[int, parakeet.LoopState] = {}  # bucket -> the programs' state
        # two host copies of the done flag, taken in turns (pinned on a card)
        self._flags = [torch.zeros((), dtype=torch.bool, pin_memory=self.device.type == "cuda")
                       for _ in range(2)]
        self._start = None

    def bucket_of(self, n_samples: int) -> int:
        return next(b for b in self.buckets if b >= n_samples)

    def transcribe(self, clips: Sequence[np.ndarray], langs: Union[str, Sequence[str]],
                   max_tokens: Union[None, int, Sequence[int]] = None,
                   keep_logits: Sequence[int] = ()) -> List[TdtTranscript]:
        """Transcripts of ``clips``; ``langs`` one code for all or one per
        clip (checked, not used), ``max_tokens`` a cap per piece (one for
        all or one per clip, None for none), ``keep_logits`` the clips
        whose path and logits are kept."""
        n = len(clips)
        langs = [langs] * n if isinstance(langs, str) else list(langs)
        if max_tokens is None:
            max_tokens = NO_CAP
        caps = [int(max_tokens)] * n if np.isscalar(max_tokens) else list(map(int, max_tokens))
        if len(langs) != n or len(caps) != n:
            raise ValueError(f"{n} clips, {len(langs)} languages, {len(caps)} caps")
        if any(c < 1 for c in caps):
            raise ValueError("a cap of tokens must be at least 1")
        keep = set(keep_logits)
        out = [TdtTranscript([]) for _ in range(n)]
        trace.count("asr.clips", n)
        silent = np.zeros(0, dtype=np.float32)
        with torch.inference_mode():
            if self._start is None:
                self._start = self.model.start(self.device)
            pulled = None  # the batch before's results, on their way to the host
            # batch b + 1 is queued on the card before the host waits for
            # batch b's results, so that the card encodes it while the host
            # writes b's transcripts
            for part in batches(pieces(clips, self.buckets[-1]), self.batch):
                fill = self.batch - len(part)
                part_caps = [caps[i] for i, _ in part] + [1] * fill
                part_keep = [i in keep for i, _ in part] + [False] * fill
                staged = self._encode(part + [(None, silent)] * fill)
                if pulled is not None:
                    self._write(*pulled, out)
                pulled = self._decode(staged, part_caps, part_keep)
            if pulled is not None:
                self._write(*pulled, out)
        return out

    def _state(self, bucket: int, frames: int) -> parakeet.LoopState:
        if not self.programs.replays:
            return parakeet.LoopState.new(self.model, self.batch, frames, self.iterations,
                                          self.device)
        if bucket not in self.states:
            self.states[bucket] = parakeet.LoopState.new(self.model, self.batch, frames,
                                                         self.iterations, self.device)
        return self.states[bucket]

    def _to_device(self, values, dtype=torch.int64) -> torch.Tensor:
        """A host list on the card without waiting for the card's queue (a
        copy from pageable memory waits for it)."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied to pinned host memory behind the card's queue (read
        it once an event recorded after the copy is done)."""
        if self.device.type != "cuda":
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x, non_blocking=True)

    def _encode(self, part):
        """Queue one batch's upload, log-mel, encoder and frame projection:
        returns ``(part, bucket, frames, f)``."""
        dev, model, cfg = self.device, self.model, self.model.cfg
        lens = [len(a) for _, a in part]
        bucket = self.bucket_of(max(lens))
        with trace.ASR.span("asr.mel", dev):
            flat = torch.empty(sum(lens), dtype=torch.float32,
                               pin_memory=dev.type == "cuda")
            np.concatenate([a for _, a in part], out=flat.numpy())
            flat = flat.to(dev, non_blocking=True)
            audio = torch.zeros((len(part), bucket), dtype=torch.float32, device=dev)
            for r, (start, n) in enumerate(zip(np.cumsum([0] + lens[:-1]), lens)):
                audio[r, :n] = flat[start:start + n]
            samples = self._to_device(lens)
            mel = parakeet_log_mel(audio, samples, cfg.n_mels)
            mel_frames = parakeet_frames(samples)
        with trace.ASR.span("asr.encode", dev):
            f = self.programs.run(("tdt.encoder", len(part), bucket), model.encode,
                                  (mel, mel_frames))
        frames = [parakeet.subsampled_frames(parakeet_frames(n), cfg) for n in lens]
        return part, bucket, frames, f

    def _decode(self, staged, caps, keep):
        """The loop over one batch, then its results queued for the host:
        returns ``(part, frames, keep, results, kept logits and path, the
        copies' event)``."""
        part, bucket, frames, f = staged
        dev = self.device
        with trace.ASR.span("asr.decode", dev):
            st = self._state(bucket, f.shape[1])
            st.f.copy_(f)
            kept = self._loop(st, bucket, frames, caps, keep)
            # one copy of every result, queued behind the loop's last program
            res = torch.cat([st.n_emit, st.t, st.points, st.counters, st.tokens.flatten(),
                             st.token_frames.flatten()])
            res = self._to_host(res)
            if kept is not None:
                kept = tuple(self._to_host(x) for x in kept)
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
        return part, frames, keep, res, kept, ev

    def _write(self, part, frames, keep, res, kept, ev, out) -> None:
        with trace.ASR.span("asr.write", self.device, host_only=True):
            if ev is not None:
                ev.synchronize()
            b = len(part)
            res = res.numpy()
            n_emit, t_end, points = res[:b], res[b:2 * b], res[2 * b:3 * b]
            counters = res[3 * b:3 * b + 2]
            tokens, token_frames = res[3 * b + 2:].reshape(2, b, -1)
            if kept is not None:
                kept = tuple(x.numpy() for x in kept)
            k = 0
            for r, (i, _) in enumerate(part):
                if i is None:  # a silent row filling the batch
                    continue
                o = out[i]
                offset = sum(e[0] for e in o.ends)
                m = int(n_emit[r])
                o.tokens.extend(tokens[r, :m].tolist())
                o.frames.extend((token_frames[r, :m] + offset).tolist())
                o.ends.append((frames[r], int(t_end[r])))
                o.points += int(points[r])
                if keep[r]:
                    logits, path = kept
                    live = path[k, :, 3] == 1
                    pts = path[k, live, :3].copy()
                    pts[:, 0] += offset
                    o.path = pts if o.path is None else np.concatenate([o.path, pts])
                    lg = logits[k, live]
                    o.logits = lg if o.logits is None else np.concatenate([o.logits, lg])
                    k += 1
            trace.count("asr.tokens", int(sum(int(n_emit[r]) for r, (i, _) in enumerate(part)
                                              if i is not None)))
            trace.count("asr.tdt_row_iterations", int(counters[0]))
            trace.count("asr.tdt_forced", int(counters[1]))
        trace.flush()

    def _loop(self, st: parakeet.LoopState, bucket: int, frames, caps, keep):
        """The loop's programs over one batch until every row is done:
        returns the kept rows' (logits, path) of every iteration, on the
        card (None if no row is kept)."""
        dev, model, k_iter = self.device, self.model, self.iterations
        key = ("tdt.loop", self.batch, bucket, k_iter)

        def loop():
            return parakeet.run_iterations(model, st, k_iter)

        if self.programs.replays and key not in self.programs.programs:
            st.finish()
            self.programs.run(key, loop, ())
        st.reset(self._start, self._to_device(frames), self._to_device(caps))
        keep_idx = self._to_device([r for r in range(len(keep)) if keep[r]])
        chunks = []
        finished = not any(frames)
        pending = None  # the last program's done flag on the host, and its event
        launches = 0
        while not finished:
            with trace.ASR.span("asr.tdt_loop", dev):
                done = self.programs.run(key, loop, ())
            trace.count("asr.tdt_iterations", k_iter)
            if len(keep_idx):
                chunks.append((st.ring.index_select(0, keep_idx),
                               st.path.index_select(0, keep_idx)))
            # the flag is copied out before the next program overwrites it, and
            # read once that program is queued: the card runs one program
            # while the host launches the next (a launch of a 16-iteration
            # program takes the host about half the program's device time)
            flag = self._flags[launches % 2]
            launches += 1
            flag.copy_(done, non_blocking=True)
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
            if pending is not None:
                with trace.ASR.span("asr.tdt_check", dev, host_only=True):
                    if pending[1] is not None:
                        pending[1].synchronize()
                    finished = bool(pending[0])
            pending = (flag, ev)
        if not len(keep_idx):
            return None
        if chunks:
            return (torch.cat([c[0] for c in chunks], dim=1),
                    torch.cat([c[1] for c in chunks], dim=1))
        return (torch.zeros((len(keep_idx), 0, model.cfg.n_outputs), device=dev),
                torch.zeros((len(keep_idx), 0, 4), dtype=torch.int64, device=dev))
