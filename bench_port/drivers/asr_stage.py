"""The audit stage's ASR through the port's transcriber, one audited pair a
call: the path ``analysis/dump_alignments.py --asr`` takes
(``analysis.asr.transcribe_sides``).

Set-up: the documents (``gen/plenary.py``; the first structure is the
``en`` side of the pair, the second the ``de`` side), each side's clips
(its stage-5.1 windows of at least ``min_clip_s``) in an order drawn from
the traffic's ``order_seed`` (so every run seed transcribes the same clips
with the same budgets; the run seed draws the audio, the weights and the
logits kept), Whisper at the configuration's widths with the harness's
weights drawn from the seed on the card (``reference/common.py::
make_weights``), and one warm-up call of one batch that holds the clip of
the largest budget, which captures the encoder's program and every
step's; set-up's objects are then collected and frozen out of the
collector's scans, as in the align cell. Window: calls back to back
until ``seconds`` have passed, the call in flight finished and counted;
call k transcribes the k-th run of ``clips_per_side`` clips of each side,
each clip with a budget of ceil(``tokens_per_s`` x its duration) tokens
and ``<|endoftext|>`` suppressed, and keeps the logits of 8 clips: the
call's clip with the largest budget and one clip at each other row
position modulo 8 of a batch, drawn from the seed. Check: every clip holds its prompt and its
budget of ids, every kept clip's ids are the argmax of its own filtered
logits (``clips_with_bad_tokens``); the kept clips of the call with the
window's largest budget are computed again by the plain reference
(``reference/whisper.py``: float32, teacher-forced on the program's ids,
from the same weights and the WAV's samples) and each position's logits
compared by their relative L2 gap (``logit_rel_gap_max``).
"""

import gc
import math
import os
import time
from pathlib import Path

import numpy as np

from bench_port import harness
from bench_port.gen import plenary
from bench_port.reference import common
from bench_port.reference import whisper as ref

PROFILE_ENV = "SVECALIGN_ASR_PROFILE"
KEPT = 8
LANG_IDS = {"en": 50259, "de": 50261}  # openai's language tokens: en, zh, de, ...


def dims_of(cfg: dict) -> dict:
    """The configuration's ``WhisperDims`` fields."""
    keys = ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
            "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")
    return {k: int(cfg[k]) for k in keys}


def sides_of(docs, seed: int):
    """The documents by structure (the traffic's ``structure_seeds`` in
    order), whatever slot the run seed gave each."""
    order = plenary.document_order(seed, len(docs))
    return [docs[order.index(k)] for k in range(len(docs))]


def clip_orders(docs, traffic: dict):
    """Each side's eligible windows (indices into its document's windows),
    in an order drawn from the traffic's ``order_seed``."""
    least = traffic["min_clip_s"] * plenary.SR
    out = []
    for side, doc in enumerate(docs):
        ok = [i for i, (s, e) in enumerate(doc.windows) if e - s >= least]
        rng = np.random.default_rng([int(traffic["order_seed"]), 3, side])
        out.append([ok[i] for i in rng.permutation(len(ok))])
    return out


def budget_of(n_samples: int, tokens_per_s: float) -> int:
    return max(1, math.ceil(tokens_per_s * n_samples / plenary.SR))


def make_call(docs, orders, traffic: dict, k: int, seed: int):
    """Call ``k``: ``(clips, budgets, keep)``; ``clips`` holds ``(side,
    window index)`` in the call's order (every clip of the first side, then
    the second's)."""
    n = int(traffic["clips_per_side"])
    clips = [(side, order[(k * n + j) % len(order)])
             for side, order in enumerate(orders) for j in range(n)]
    budgets = budgets_of(docs, clips, traffic)
    return clips, budgets, keep_rows(budgets, seed, k)


def budgets_of(docs, clips, traffic: dict):
    return [budget_of(docs[side].windows[i][1] - docs[side].windows[i][0],
                      traffic["tokens_per_s"]) for side, i in clips]


def keep_rows(budgets, seed: int, k: int):
    """The clip with the largest budget, and one clip at each other row
    position modulo 8 of a batch, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 4, int(k) % 2**32])
    top = int(np.argmax(budgets))
    keep = [top]
    for r in range(KEPT):
        if r != top % KEPT:
            idx = np.arange(r, len(budgets), KEPT)
            keep.append(int(rng.choice(idx)))
    return sorted(keep)


def _break(transcriber, faults):
    """Wrap the decoder's cross-attention K/V with the faults asked for."""
    dec = transcriber.model.decoder
    orig = dec.cross_kv

    def broken(xa, out=None):
        out = orig(xa, out)
        if "cross_kv_altered" in faults:
            for k, v in out:
                k[::8] = k[::8].roll(1, dims=2)
                v[::8] = -v[::8]
        return out

    dec.cross_kv = broken


def _sides(docs, clips, traffic):
    """The call's ``sides`` argument: each side's WAV, spans and language."""
    langs = traffic["langs"]
    return [(str(doc.wav), [doc.windows[i] for s, i in clips if s == side], langs[side])
            for side, doc in enumerate(docs)]


def run(record, tmp: Path, seconds: float, trace: bool, t_start: float, faults=()) -> None:
    import torch

    from svecalign_tpu_torch.analysis import asr
    from svecalign_tpu_torch.models import whisper

    cell, seed = record.cell, record.seed
    cfg, traffic, opts = cell["config_data"], cell["traffic_data"], cell["asr_options"]
    device = cell.get("device", "cuda")
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device(device)

    docs = sides_of(plenary.write_documents(tmp / "in", traffic, seed, dev0), seed)
    orders = clip_orders(docs, traffic)

    spec = ref.param_spec(cfg)
    weight_seed = seed * 1_000_003 + 17
    model = whisper.build(whisper.WhisperDims(**dims_of(cfg)), dev0, cfg["compute_dtype"])
    weights = common.make_weights(spec, weight_seed, dev0)
    whisper.load_weights(model, weights)
    del weights
    eot = asr.special_tokens(cfg["n_vocab"]).eot
    transcriber = asr.Transcriber(model, batch=int(opts["batch"]),
                                  suppress_tokens=[eot] if traffic["suppress_eot"] else [],
                                  suppress_blank=bool(opts["suppress_blank"]))
    if faults:
        _break(transcriber, faults)
    # warm-up: one batch of the last call's clips that a window could reach,
    # with the clip of the largest budget of all, so that the encoder's and
    # every step's program are captured before the window
    every = [(side, i) for side, order in enumerate(orders) for i in order]
    longest = every[int(np.argmax(budgets_of(docs, every, traffic)))]
    warm = sorted([longest] + make_call(docs, orders, traffic, -1, seed)[0][:transcriber.batch - 1])
    asr.transcribe_sides(transcriber, _sides(docs, warm, traffic),
                         budgets_of(docs, warm, traffic))

    spans = harness.Spans(trace)
    if trace:
        os.environ[PROFILE_ENV] = "1"
    window = harness.ProfiledWindow(record.chips) if trace else None
    done = []
    gc.collect()
    gc.freeze()
    if window is not None:
        window.__enter__()
    t_setup = time.perf_counter()
    record.e2e["setup_s"] = t_setup - t_start
    try:
        k = 0
        while True:
            clips, budgets, keep = make_call(docs, orders, traffic, k, seed)
            t_call = time.perf_counter()
            with spans("bench.asr_call"):
                got = asr.transcribe_sides(transcriber, _sides(docs, clips, traffic), budgets,
                                           keep_logits=keep)
            now = time.perf_counter()
            print(f"asr call {k}: {len(clips)} clips in {now - t_call:.3f} s")
            done.append(dict(clips=clips, budgets=budgets, keep=keep,
                             transcripts=[t for side in got for t in side]))
            k += 1
            if now - t_setup >= seconds:
                break
    finally:
        if window is not None:
            window.__exit__(None, None, None)
        os.environ.pop(PROFILE_ENV, None)
        gc.unfreeze()
    record.window_s = now - t_setup
    record.trace = window.summary if window is not None else None
    audio_s = sum((docs[s].windows[i][1] - docs[s].windows[i][0]) / plenary.SR
                  for call in done for s, i in call["clips"])
    record.e2e["embed_audio_s_per_s"] = audio_s / record.window_s
    peak = torch.cuda.max_memory_reserved(dev0) if device == "cuda" else 0
    record.counters.update(memory_peak_bytes=peak, audio_s=audio_s)
    record.e2e["peak_mem_gib"] = peak / 2**30
    record.items = done
    record.attempted = sum(len(call["clips"]) for call in done)

    # the program's state goes before the reference runs
    del model, transcriber
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    check(record, cell, docs, spec, weight_seed, dev0)


def bad_clips(cell, call) -> int:
    """Clips whose prompt or id count is wrong, or (kept clips) whose ids
    are not the argmax of their own logits under the call's filters."""
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    from_ids = _special(cfg)
    bad = 0
    for j, ((side, _), budget, t) in enumerate(zip(call["clips"], call["budgets"],
                                                  call["transcripts"])):
        ok = (t.prompt == prompt_of(from_ids, traffic["langs"][side])
              and len(t.prompt) + len(t.tokens) == 4 + budget)
        if ok and j in call["keep"]:
            logits = np.array(t.logits, dtype=np.float32, copy=True)
            ok = logits.shape == (budget, cfg["n_vocab"])
            if ok:
                if traffic["suppress_eot"]:
                    logits[:, from_ids["eot"]] = -np.inf
                if cell["asr_options"]["suppress_blank"]:
                    logits[0, [from_ids["blank"], from_ids["eot"]]] = -np.inf
                ok = logits.argmax(axis=1).tolist() == list(t.tokens)
        bad += not ok
    return bad


def _special(cfg: dict) -> dict:
    """openai's multilingual special ids (the configuration's assumed
    ``prompt_ids``), computed here without the program."""
    n_lang = 100 if cfg["n_vocab"] == 51866 else 99
    transcribe = 50258 + 1 + n_lang + 1
    return {"eot": 50257, "sot": 50258, "transcribe": transcribe,
            "notimestamps": transcribe + 4, "blank": 220}


def prompt_of(ids: dict, lang: str):
    return [ids["sot"], LANG_IDS[lang], ids["transcribe"], ids["notimestamps"]]


def sample(record):
    """(call, clip) pairs to hold to the reference: the kept clips of the
    call with the window's largest budget."""
    best = max(range(len(record.items)), key=lambda c: max(record.items[c]["budgets"]))
    return [(best, j) for j in record.items[best]["keep"]][:record.cell["check"]["sample_clips"]]


def check(record, cell, docs, spec, weight_seed, dev, precision: str = "fp32"):
    """Fills ``record.checks``: ``clips_with_bad_tokens`` over every clip of
    every finished call, ``logit_rel_gap_max`` over the sample."""
    import torch

    bad = sum(bad_clips(cell, call) for call in record.items)
    gaps = []
    picked = [(c, j) for c, j in sample(record)
              if record.items[c]["transcripts"][j].logits is not None]
    for (c, j), want in zip(picked, reference_logits(record, cell, docs, picked, spec,
                                                     weight_seed, dev, precision)):
        got = np.asarray(record.items[c]["transcripts"][j].logits, dtype=np.float32)
        if got.shape != tuple(want.shape):
            gaps.append(float("inf"))
            continue
        g = torch.from_numpy(got)
        gaps.extend(((g - want).norm(dim=1) / want.norm(dim=1)).tolist())
    record.checks = [harness.Check("clips_with_bad_tokens", float(bad), 0.0),
                     harness.Check("logit_rel_gap_max", max(gaps) if gaps else float("nan"),
                                   float(cell["check"]["logit_rel_gap_max"]))]


def _clip_audio(docs, side: int, i: int, dev):
    import torch

    s, e = docs[side].windows[i]
    audio = plenary.read_wav(docs[side].wav)[s:e]
    out = torch.zeros((1, ref.N_SAMPLES), dtype=torch.float32, device=dev)
    out[0, :len(audio)] = torch.from_numpy(audio).to(dev)
    return out


def reference_logits(record, cell, docs, picked, spec, weight_seed, dev, precision: str):
    """The reference's teacher-forced logits at every sampled position of
    each picked clip, on the program's ids, (positions, n_vocab) each."""
    import torch

    cfg = cell["config_data"]
    common.fp32_only()
    weights = common.make_weights(spec, weight_seed, dev)
    prec = common.Precision(precision)
    out = []
    with torch.no_grad():
        for c, j in picked:
            call = record.items[c]
            side, i = call["clips"][j]
            t = call["transcripts"][j]
            xa = ref.encode(cfg, weights, ref.log_mel(_clip_audio(docs, side, i, dev),
                                                      cfg["n_mels"]), prec)
            n = len(t.logits)
            ids = torch.tensor([(t.prompt + list(t.tokens))[:len(t.prompt) + n - 1]],
                               device=dev)
            out.append(ref.logits(cfg, weights, ids, xa, prec)[0, len(t.prompt) - 1:].cpu())
    del weights
    return out


def control(cell: dict, seed: int, tmp: Path, n_clips: int = 8):
    """The comparison with the reference in the program's place, computed
    one precision step below the configuration's (fp8 products for bf16):
    for ``n_clips`` clips of the first call (the largest budget first),
    the float32 reference decodes greedily under the cell's filters by full
    teacher-forced forwards, and the fp8 reference's logits on those ids
    are compared with the float32 ones, position by position. Returns the
    largest relative L2 gap. Needs no program."""
    import torch

    cfg, traffic = cell["config_data"], cell["traffic_data"]
    dev = torch.device("cuda", 0) if cell.get("device", "cuda") == "cuda" else torch.device("cpu")
    docs = sides_of(plenary.write_documents(tmp, traffic, seed, dev), seed)
    orders = clip_orders(docs, traffic)
    clips, budgets, keep = make_call(docs, orders, traffic, 0, seed)
    picked = keep[:n_clips]
    seed = int(seed) % (2**63)
    spec = ref.param_spec(cfg)
    common.fp32_only()
    weights = common.make_weights(spec, seed * 1_000_003 + 17, dev)
    ids = _special(cfg)
    worst = 0.0
    with torch.no_grad():
        for j in picked:
            side, i = clips[j]
            mel = ref.log_mel(_clip_audio(docs, side, i, dev), cfg["n_mels"])
            xa32 = ref.encode(cfg, weights, mel)
            xa8 = ref.encode(cfg, weights, mel, common.Precision("fp8"))
            seq = prompt_of(ids, traffic["langs"][side])
            for step in range(budgets[j]):
                lg = ref.logits(cfg, weights, torch.tensor([seq], device=dev), xa32)[0, -1]
                if traffic["suppress_eot"]:
                    lg[ids["eot"]] = -float("inf")
                if step == 0 and cell["asr_options"]["suppress_blank"]:
                    lg[[ids["blank"], ids["eot"]]] = -float("inf")
                seq.append(int(lg.argmax()))
            toks = torch.tensor([seq[:-1]], device=dev)
            want = ref.logits(cfg, weights, toks, xa32)[0, 3:]
            got = ref.logits(cfg, weights, toks, xa8, common.Precision("fp8"))[0, 3:]
            worst = max(worst, float(((got - want).norm(dim=1) / want.norm(dim=1)).max()))
    return worst
