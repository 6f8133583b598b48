"""Batched greedy transcription with Whisper: the audit stage's ASR.

``analysis/dump_alignments.py --asr`` transcribes both sides of every
dumped alignment; this module is what it calls. A call takes clips (the
aligned spans of one or more audio files) and returns, for each, the
token ids that greedy decoding at temperature 0 gives:

- a clip longer than 30 s is cut into 30 s pieces, each decoded as its
  own row, and the pieces' ids are joined;
- rows go in the call's order, ``batch`` at a time (the last batch
  filled with silent rows of budget 1, so that every batch has one
  shape): Whisper's log-mel of every row padded to 30 s
  (``ops/fbank.py::whisper_log_mel``, on the card) -> the encoder -> every
  layer's cross-attention K/V, once per row -> the prefill of the prompt
  ``<|startoftranscript|> <|lang|> <|transcribe|> <|notimestamps|>``
  (eager) -> one greedy step a token through the self-attention cache,
  every row in the same step, until every row has sampled
  ``<|endoftext|>`` or its own budget of tokens (``max_tokens``, openai's
  ``sample_len``; default ``n_text_ctx // 2``). A row that is done keeps
  being computed and its tokens are dropped; the check whether every row
  is done waits for the card every :data:`DONE_CHECK_EVERY` steps only;
- the encoder and every step run through one program cache
  (``utils/programs.py``, as the stage-5.3 encoders do): on a card they
  are programs of fixed shape, captured at their first use and replayed
  (one program for the encoder and one per step index, sharing one
  memory pool), and the caches are buffers allocated once, the
  cross-attention K/V copied in per batch and the self-attention K/V of
  ``n_text_ctx`` positions, of which step j reads the first 4 + j. An
  eager step launches ~22 kernels a layer, and at large-v3 on an H100 its
  host time (17-28 ms) is longer than its device time (~12 ms); replayed,
  the step is bound by the card. On the CPU both run eagerly, over
  caches allocated per batch;
- logit filters, as openai's ``DecodingTask`` applies them: ``suppress_blank``
  (``" "`` and ``<|endoftext|>`` at the first sampled position) and the
  ids of ``suppress_tokens`` at every position.

A clip's ids and logits do not depend on its batch-mates: every row has
its own log-mel floor, nothing is masked across rows, and all rows of a
step attend the same number of positions.

Departures from openai's ``transcribe()``, each deliberate:

- **Text.** The tokenizer's vocabulary (openai's ``multilingual.tiktoken``)
  is not in the repository and nothing is downloaded, so a transcript is
  token ids; decoding them to text, and openai's default non-speech list
  (``suppress_tokens="-1"``, built from the vocabulary), wait for such a
  file. The special ids are openai's tokenizer layout for a multilingual
  vocabulary (:func:`special_tokens`); English-only vocabularies are
  refused.
- **No temperature fallback, timestamps or language detection.** Decoding
  is greedy at temperature 0 with ``<|notimestamps|>``; the language is
  the caller's (the CLI's ``--src_lang`` / ``--tgt_lang``); a clip is
  decoded in 30 s pieces without a previous-text prompt.
- **The log-mel floor per piece.** The floor of the log-mel (its maximum
  less 8) is taken over each 30 s piece; openai's ``transcribe()`` takes
  it once, over the whole clip, so the pieces of a clip longer than 30 s
  whose loudest piece is not theirs get other features here.
- **No beam search, no length penalty.**

Spans (``utils/trace.py``, the ``ASR`` area, ``SVECALIGN_ASR_PROFILE=1``
at a call's entry): ``asr.call`` (host, the call's request id),
``asr.read`` (the wait for the first batch's clips, read on a thread
that reads the rest while the card works, host-only), and per batch
``asr.mel``, ``asr.encode``, ``asr.cross_kv`` and ``asr.decode`` (on the
card; ``asr.decode`` holds ``asr.prefill`` and one ``asr.step`` a step,
and ends with the pull of the batch's ids), then ``asr.write`` (the ids
and kept logits unpacked into transcripts, host-only). Counters:
``asr.clips``, ``asr.tokens`` (positions sampled, each row up to its
``<|endoftext|>`` or budget), ``asr.steps`` (decode steps after the
prefill), ``asr.cache_bytes`` (the cross- and self-attention K/V
allocated: eagerly, each batch's, for its rows and the self-attention to
its last position; on a card, the programs' buffers once, the
self-attention's at ``n_text_ctx`` positions).
"""

import itertools
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from svecalign_tpu_torch.models import whisper
from svecalign_tpu_torch.ops.fbank import whisper_log_mel
from svecalign_tpu_torch.utils import trace
from svecalign_tpu_torch.utils.audio_utils import load_waveform
from svecalign_tpu_torch.utils.programs import Programs

SAMPLE_RATE = 16000
N_SAMPLES = 30 * SAMPLE_RATE  # one piece: Whisper's 30 s input
DONE_CHECK_EVERY = 16  # steps between the decode's waits for "every row done"

LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl", "ar", "sv",
    "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro", "da", "hu", "ta", "no",
    "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr",
    "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu",
    "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl",
    "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su", "yue",
)
"""openai's language tokens in id order (``tokenizer.py``'s ``LANGUAGES``);
``yue`` only in the 51866-token vocabulary of large-v3."""

_calls = itertools.count()


@dataclass(frozen=True)
class SpecialTokens:
    """openai's special ids for a multilingual vocabulary."""

    eot: int
    sot: int
    transcribe: int
    notimestamps: int
    blank: int  # " ", GPT-2's byte-level id 220, the first of suppress_blank's two
    languages: Tuple[str, ...]

    def prompt(self, lang: str) -> List[int]:
        """``<|startoftranscript|> <|lang|> <|transcribe|> <|notimestamps|>``."""
        if lang not in self.languages:
            raise ValueError(f"no language token for {lang!r} in this vocabulary")
        return [self.sot, self.sot + 1 + self.languages.index(lang), self.transcribe,
                self.notimestamps]


def special_tokens(n_vocab: int) -> SpecialTokens:
    """The special ids of openai's multilingual tokenizer of ``n_vocab``
    tokens: 51865 (99 languages) or 51866 (large-v3, 100). After
    ``<|startoftranscript|>`` (50258) come the languages, then translate,
    transcribe, startoflm, startofprev, nospeech, notimestamps."""
    if n_vocab not in (51865, 51866):
        raise ValueError(f"only openai's multilingual vocabularies (51865, 51866 tokens) are "
                         f"known, got {n_vocab}")
    langs = LANGUAGES if n_vocab == 51866 else LANGUAGES[:-1]
    sot = 50258
    transcribe = sot + 1 + len(langs) + 1
    return SpecialTokens(eot=50257, sot=sot, transcribe=transcribe,
                         notimestamps=transcribe + 4, blank=220, languages=langs)


@dataclass
class Transcript:
    """One clip's result: its prompt, the ids sampled (the pieces' joined,
    each piece's ``<|endoftext|>`` left out) and, for a clip in
    ``keep_logits``, the raw fp32 logits (before the filters) of every
    position sampled, ``<|endoftext|>``'s included."""

    prompt: List[int]
    tokens: List[int] = field(default_factory=list)
    logits: Optional[np.ndarray] = None


class Transcriber:
    """Greedy batched decoding with one loaded :class:`whisper.Whisper`:
    the encoder and each step index run through one
    :class:`~svecalign_tpu_torch.utils.programs.Programs`, which on a card
    replays them over K/V buffers allocated at the first batch; on the
    CPU all runs eagerly, over K/V allocated per batch."""

    def __init__(self, model: whisper.Whisper, batch: int = 64,
                 suppress_tokens: Sequence[int] = (), suppress_blank: bool = True,
                 graph_type=None):
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.model, self.batch = model, batch
        self.device = model.decoder.token_embedding.weight.device
        self.special = special_tokens(model.dims.n_vocab)
        self.suppress_tokens = sorted(set(int(t) for t in suppress_tokens))
        self.suppress_blank = suppress_blank
        # graph_type: a stand-in for the CUDA graph (the tests' programs on the CPU)
        self.programs = Programs(self.device, graph_type)
        self._cross = self._cache = None  # the programs' K/V buffers

    def transcribe(self, clips: Sequence[np.ndarray], langs: Union[str, Sequence[str]],
                   max_tokens: Union[None, int, Sequence[int]] = None,
                   keep_logits: Sequence[int] = ()) -> List[Transcript]:
        """Transcripts of ``clips`` (1-D fp32 waveforms at 16 kHz), each in
        its language (one code for all, or one per clip), each with its
        budget of sampled tokens per 30 s piece (one for all, or one per
        clip); ``keep_logits`` lists the clips whose logits are kept."""
        n = len(clips)
        langs = [langs] * n if isinstance(langs, str) else list(langs)
        ctx = self.model.dims.n_text_ctx
        if max_tokens is None:
            max_tokens = ctx // 2
        budgets = [int(max_tokens)] * n if np.isscalar(max_tokens) else list(map(int, max_tokens))
        if len(langs) != n or len(budgets) != n:
            raise ValueError(f"{n} clips, {len(langs)} languages, {len(budgets)} budgets")
        for b in budgets:
            if not 1 <= b <= ctx - 4:
                raise ValueError(f"a budget must lie in [1, {ctx - 4}], got {b}")
        keep = set(keep_logits)
        out = [Transcript(self.special.prompt(lang)) for lang in langs]
        trace.count("asr.clips", n)
        silent = np.zeros(0, dtype=np.float32)
        with torch.inference_mode():
            for part in batches(pieces(clips, N_SAMPLES), self.batch):
                fill = self.batch - len(part)
                self._batch(part + [(None, silent)] * fill,
                            [out[i].prompt for i, _ in part] + [out[part[0][0]].prompt] * fill,
                            [budgets[i] for i, _ in part] + [1] * fill,
                            [i in keep for i, _ in part] + [False] * fill, out)
        return out

    def _batch(self, part, prompts, budgets, keep, out) -> None:
        dev, model = self.device, self.model
        with trace.ASR.span("asr.mel", dev):
            lens = [len(a) for _, a in part]
            flat = torch.from_numpy(np.concatenate([a for _, a in part])).to(dev)
            audio = torch.zeros((len(part), N_SAMPLES), dtype=torch.float32, device=dev)
            for r, (start, n) in enumerate(zip(np.cumsum([0] + lens[:-1]), lens)):
                audio[r, :n] = flat[start:start + n]
            mel = whisper_log_mel(audio, model.dims.n_mels)
        with trace.ASR.span("asr.encode", dev):
            xa = self.programs.run(("whisper.encoder", tuple(mel.shape)), model.encoder, (mel,))
        with trace.ASR.span("asr.cross_kv", dev):
            if self.programs.replays and self._cross is None:
                self._cross = model.decoder.new_cache(len(part), model.dims.n_audio_ctx)
                self._cache = model.decoder.new_cache(len(part), model.dims.n_text_ctx)
                trace.count("asr.cache_bytes",
                            whisper.cache_bytes(model, len(part), model.dims.n_text_ctx))
            cross = model.decoder.cross_kv(xa, self._cross)
        with trace.ASR.span("asr.decode", dev):
            tokens, kept = self._decode(cross, prompts, budgets, keep)
        with trace.ASR.span("asr.write", dev, host_only=True):
            eot, k, sampled = self.special.eot, 0, 0
            for r, (i, _) in enumerate(part):
                if i is None:  # a silent row filling the batch
                    continue
                row = tokens[r, :budgets[r]]
                ends = np.flatnonzero(row == eot)
                n = int(ends[0]) if len(ends) else len(row)
                m = min(n + 1, len(row))  # positions sampled, <|endoftext|>'s included
                sampled += m
                out[i].tokens.extend(int(t) for t in row[:n])
                if keep[r]:
                    got = kept[k, :m]
                    k += 1
                    out[i].logits = got if out[i].logits is None else np.concatenate(
                        [out[i].logits, got])
            trace.count("asr.tokens", sampled)
        trace.flush()

    def _decode(self, cross, prompts, budgets, keep):
        """Prefill and greedy steps for one batch: returns its (rows, max
        budget) int64 ids on the host (``<|endoftext|>`` after a row is
        done) and the kept rows' (k, max budget, n_vocab) fp32 logits."""
        dev, dec, sp = self.device, self.model.decoder, self.special
        b, steps, p = len(budgets), max(budgets), len(prompts[0])
        cache = self._cache
        if not self.programs.replays:
            cache = dec.new_cache(b, p + steps - 1)
            trace.count("asr.cache_bytes", whisper.cache_bytes(self.model, b, p + steps - 1))
        ids = torch.full((b, steps), sp.eot, dtype=torch.int64, device=dev)
        budget = torch.tensor(budgets, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        keep_rows = [r for r in range(b) if keep[r]]
        kept = keep_idx = None
        if keep_rows:
            kept = torch.empty((len(keep_rows), steps, dec.token_embedding.num_embeddings),
                               dtype=torch.float32, device=dev)
            keep_idx = torch.tensor(keep_rows, device=dev)
        suppress = (torch.tensor(self.suppress_tokens, device=dev)
                    if self.suppress_tokens else None)
        first = torch.tensor([sp.blank, sp.eot], device=dev) if self.suppress_blank else None

        def pick(logits: torch.Tensor, j: int) -> torch.Tensor:
            if kept is not None:
                kept[:, j] = logits.index_select(0, keep_idx)
            if suppress is not None:
                logits.index_fill_(1, suppress, float("-inf"))
            if j == 0 and first is not None:
                logits.index_fill_(1, first, float("-inf"))
            tok = torch.where(done, sp.eot, logits.argmax(-1))
            ids[:, j] = tok
            done.logical_or_(tok == sp.eot).logical_or_(budget <= j + 1)
            return tok

        def step(tokens: torch.Tensor, offset: int) -> torch.Tensor:
            return dec(tokens, offset, cache, cross)[:, -1]

        with trace.ASR.span("asr.prefill", dev):
            tok = pick(step(torch.tensor(prompts, device=dev), 0), 0)
        ran = 0
        for j in range(1, steps):
            if j % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            with trace.ASR.span("asr.step", dev):
                logits = self.programs.run(("whisper.step", b, p, j),
                                           lambda t, o=p + j - 1: step(t, o), (tok[:, None],))
                tok = pick(logits, j)
            ran += 1
        trace.count("asr.steps", ran)
        return ids.cpu().numpy(), (None if kept is None else kept.cpu().numpy())


def pieces(clips: Sequence[np.ndarray], size: int):
    """Each clip's pieces of at most ``size`` samples, in order, as ``(clip
    index, samples)``; a clip of no samples is one empty piece. Lazy: a
    clip is taken when its batch is made (a read in flight is waited for
    then)."""
    for i, clip in enumerate(clips):
        clip = np.asarray(clip, dtype=np.float32)
        for lo in range(0, max(len(clip), 1), size):
            yield i, clip[lo:lo + size]


def batches(rows, batch: int):
    """``rows`` in lists of ``batch``, the last one shorter."""
    rows = iter(rows)
    while part := list(itertools.islice(rows, batch)):
        yield part


class _Reads(Sequence):
    """The clips of a call, read on a thread in order: an item waits for
    its read."""

    def __init__(self, reads):
        self.reads = reads

    def __len__(self):
        return len(self.reads)

    def __getitem__(self, i):
        return self.reads[i].result()


def _read_span(path: str, start: int, end: int) -> np.ndarray:
    audio = load_waveform(path, start, end)
    return audio[:, 0] if audio.ndim == 2 else audio


def transcribe_sides(transcriber,
                     sides: Sequence[Tuple[str, Sequence[Tuple[int, int]], str]],
                     max_tokens: Union[None, int, Sequence[int]] = None,
                     keep_logits: Sequence[int] = (),
                     request=None) -> List[List[Transcript]]:
    """One call: the spans (start and end samples) of each side's audio
    file, each side in its language (``sides``: ``(path, spans, lang)``),
    transcribed together, in order, by ``transcriber`` (Whisper's
    :class:`Transcriber` or Parakeet's ``analysis.tdt.TdtTranscriber``: a
    ``device`` and ``transcribe(clips, langs, max_tokens, keep_logits)``);
    returns the transcripts side by side. ``max_tokens`` and
    ``keep_logits`` index the clips of all sides in order. A thread reads
    the spans in order while the transcriber works on the batches before,
    which take their clips as they come; ``asr.read`` is the wait for the
    first batch's clips, which nothing on the card hides."""
    dev = transcriber.device
    trace.ASR.switch(dev)
    request = f"call {next(_calls)}" if request is None else request
    langs = [lang for _, spans, lang in sides for _ in spans]
    with trace.ASR.span("asr.call", request=request), ThreadPoolExecutor(1) as pool:
        reads = [pool.submit(_read_span, path, s, e) for path, spans, _ in sides
                 for s, e in spans]
        with trace.ASR.span("asr.read", dev, host_only=True):
            for read in reads[:transcriber.batch]:
                read.result()
        got = transcriber.transcribe(_Reads(reads), langs, max_tokens, keep_logits)
    bounds = np.cumsum([0] + [len(spans) for _, spans, _ in sides])
    return [got[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
