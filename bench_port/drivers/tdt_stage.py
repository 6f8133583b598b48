"""The audit stage's ASR through the port's Parakeet-TDT transcriber, one
audited pair a call: the path ``analysis/dump_alignments.py --asr
--asr_model parakeet-tdt`` takes (``analysis.asr.transcribe_sides`` with
``analysis.tdt.TdtTranscriber``).

The traffic is the Whisper cell's (``audit_clips``), and so are the
clips of each call, their order and the kept clips: this module takes
``asr_stage``'s helpers for them (``sides_of``, ``clip_orders``,
``make_call``, ``_sides``); the budgets ``make_call`` gives pick the kept
clips only (the longest clip of the call and one clip at each other row
position modulo 8), as no budget applies to a transducer.

Set-up: the documents, Parakeet at the configuration's widths with the
harness's weights drawn from the seed on the card
(``reference/common.py::make_weights``; the blank's embedding row zeroed,
NeMo's ``padding_idx``, and the joint's blank and duration rows fitted to
the configuration's ``emission`` on the reference's frames of 16 clips of
the first call, :func:`emission_fit`), and a warm-up of one batch for every
bucket that a clip of the traffic falls in (a batch's bucket is that of
its longest clip), which captures every encoder and loop program the
window can use; set-up's objects are then collected and frozen out of the
collector's scans. Window: calls back to back until ``seconds`` have
passed, the call in flight finished and counted. Check: every clip's path
is a TDT path (``clips_with_bad_paths``: frames never go back, every
piece reaches its T, at most ``max_symbols`` tokens a frame, no blank
emitted; a kept clip's points are also the argmax walk of its own kept
logits under the decoding rule, and its tokens and frames those the
walk emits); the kept clips of the call with the window's longest clip
are computed again by the plain reference (``reference/parakeet_tdt.py``:
float32, teacher-forced on the program's path, from the same weights and
the WAV's samples) and each point's logits compared by their relative L2
gap (``logit_rel_gap_max``).
"""

import gc
import os
import time
from pathlib import Path

import numpy as np

from bench_port import harness
from bench_port.drivers import asr_stage
from bench_port.gen import plenary
from bench_port.reference import common
from bench_port.reference import parakeet_tdt as ref

PROFILE_ENV = "SVECALIGN_ASR_PROFILE"
MODEL_KEYS = ("n_mels", "d_model", "n_layers", "n_heads", "ff_dim", "conv_kernel",
              "subsampling_factor", "subsampling_channels", "xscaling", "vocab_size",
              "pred_hidden", "pred_layers", "joint_hidden", "max_symbols")


def model_config(cfg: dict):
    """The configuration's ``ParakeetConfig``."""
    from svecalign_tpu_torch.models import parakeet

    return parakeet.ParakeetConfig(**{k: cfg[k] for k in MODEL_KEYS},
                                   durations=tuple(cfg["durations"]), dtype=cfg["compute_dtype"])


RESIDUAL_OUTPUTS = ("output_dense.weight", "linear_out.weight", "pointwise_conv2.weight")
FIT_CLIPS, FIT_STATES, FIT_SEED, FIT_STEPS = 16, 8, 7, 200  # the emission's fit


def weights_of(cfg: dict, seed: int, dev, fit=None):
    """The harness's weights of a run: the spec's draws, each block's
    residual output projections scaled by the configuration's
    ``residual_scale``, the blank's embedding row zeroed, the joint's
    first ``frame_units`` hidden units made the frame's alone (their rows
    of ``joint.pred`` zero) and its blank and duration rows made to read
    those units alone; then the seed's ``fit`` (:func:`emission_fit`) set
    if given (:func:`set_emission`)."""
    w = common.make_weights(ref.param_spec(cfg), seed, dev)
    for name in w:
        if name.startswith("encoder.layers_") and name.endswith(RESIDUAL_OUTPUTS):
            w[name] *= cfg["residual_scale"]
    v, n = cfg["vocab_size"], cfg["emission"]["frame_units"]
    w["decoder.embed.weight"][v] = 0
    w["joint.pred.weight"][:n] = 0
    w["joint.out.weight"][v:, n:] = 0
    if fit is not None:
        set_emission(cfg, w, fit)
    return w


def set_emission(cfg: dict, w, fit) -> None:
    """The blank's and the durations' rows of ``joint.out`` scaled by the
    fit's scales and their biases set to its biases, in place."""
    v = cfg["vocab_size"]
    scales, biases = fit
    rows = w["joint.out.weight"][v:]
    rows.copy_(rows.float() * scales.to(rows.device)[:, None])
    w["joint.out.bias"][v:] = biases.to(rows.device)


def fit_audios(docs, orders, traffic: dict, seed: int, dev):
    """The clips the emission is fitted on: :data:`FIT_CLIPS` of the first
    call's, spread over both sides."""
    clips = asr_stage.make_call(docs, orders, traffic, 0, seed)[0]
    return [_clip_audio(docs, *c, dev) for c in clips[::max(1, len(clips) // FIT_CLIPS)]]


def emission_fit(cfg: dict, w, audios):
    """The seed's scales and biases of the joint's blank and duration rows
    (``emission``), fitted on the frames of ``audios`` (the reference's
    float32 frames), each with :data:`FIT_STATES` states of the prediction
    network (its start, then random tokens): each row's product has the
    standard deviation ``row_std`` over the frames; each duration wins
    its ``duration_shares`` entry of the frames; and the blank's bias is
    set so that the largest token logit passes the blank's logit at a
    ``token_share`` of the (frame, state) points. Random weights give
    every seed its own means and spreads of these products (the frames
    share a large common part, which each random row reads as a constant
    of the seed), and so its own rates of tokens and loop points; fitted,
    the durations move from frame to frame with the audio (0-4; a token
    at a frame of duration 0 stays there, up to ``max_symbols``) at shares
    that do not move from seed to seed."""
    import torch

    v, e, prec = cfg["vocab_size"], cfg["emission"], common.Precision()
    dev = w["joint.out.weight"].device
    tokens = torch.randint(0, v, (FIT_STATES - 1,),
                           generator=torch.Generator().manual_seed(FIT_SEED)).tolist()
    g, state = ref.pred_step(cfg, w, v, None, prec)
    gs = [g]
    for k in tokens:
        g, state = ref.pred_step(cfg, w, k, state, prec)
        gs.append(g)
    p = prec.linear(torch.stack(gs), w, "joint.pred")
    with torch.no_grad():
        f = torch.cat([ref.frames_projected(cfg, w, a, prec) for a in audios])
        z = torch.relu(f[:, None] + p[None]).flatten(0, 1)
        top = prec.linear(z, w, "joint.out")[:, :v].max(dim=1).values
        prod = prec.linear(z, {"r.weight": w["joint.out.weight"][v:]}, "r", bias=False)
    scales = e["row_std"] / prod.std(dim=0)
    prod = prod * scales
    # each duration wins its share of the frames: the biases from zero by a
    # fixed number of steps against the log of each share's miss
    want = torch.tensor(e["duration_shares"], device=dev)
    dur = prod[::FIT_STATES, 1:]
    biases = torch.zeros_like(want)
    for _ in range(FIT_STEPS):
        got = torch.bincount((dur + biases).argmax(dim=1), minlength=len(want)) / len(dur)
        biases += 0.2 * e["row_std"] * (want.log() - got.clamp(min=1e-4).log())
        biases -= biases.mean()
    blank = torch.quantile(top - prod[:, 0], 1 - e["token_share"])
    return scales, torch.cat([blank[None], biases])


def weight_seed(seed: int) -> int:
    return seed * 1_000_003 + 29


def _break(model, faults):
    """Wrap the encoder's output with the faults asked for: every eighth
    row's projected frames shifted by one frame and negated."""
    orig = model.encode

    def broken(mel, frames):
        out = orig(mel, frames)
        if "frames_altered" in faults:
            out[::8] = -out[::8].roll(1, dims=1)
        return out

    model.encode = broken


def clip_len(docs, clip) -> int:
    side, i = clip
    s, e = docs[side].windows[i]
    return e - s


def warm_clips(transcriber, docs, orders, batch: int):
    """One batch of clips for every bucket a clip of the traffic falls in:
    the longest clip of that bucket and the traffic's ``batch - 1``
    shortest clips, so that the batch takes that bucket."""
    every = sorted(((side, i) for side, order in enumerate(orders) for i in order),
                   key=lambda c: clip_len(docs, c))
    by_bucket = {}
    for clip in every:  # shortest first: the last clip of a bucket is its longest
        by_bucket[transcriber.bucket_of(min(clip_len(docs, clip), transcriber.buckets[-1]))] = clip
    return [sorted([by_bucket[b]] + every[:batch - 1]) for b in sorted(by_bucket)]


def run(record, tmp: Path, seconds: float, trace: bool, t_start: float, faults=()) -> None:
    import torch

    from svecalign_tpu_torch.analysis import asr, tdt
    from svecalign_tpu_torch.models import parakeet
    from svecalign_tpu_torch.utils.trace import counts as trace_counts

    cell, seed = record.cell, record.seed
    cfg, traffic, opts = cell["config_data"], cell["traffic_data"], cell["asr_options"]
    device = cell.get("device", "cuda")
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device(device)

    docs = asr_stage.sides_of(plenary.write_documents(tmp / "in", traffic, seed, dev0), seed)
    orders = asr_stage.clip_orders(docs, traffic)

    model = parakeet.build(model_config(cfg), dev0)
    weights = weights_of(cfg, weight_seed(seed), dev0)
    fit = emission_fit(cfg, weights, fit_audios(docs, orders, traffic, seed, dev0))
    set_emission(cfg, weights, fit)
    parakeet.load_weights(model, weights)
    del weights
    transcriber = tdt.TdtTranscriber(model, batch=int(opts["batch"]))
    if faults:
        _break(model, faults)
    for warm in warm_clips(transcriber, docs, orders, transcriber.batch):
        asr.transcribe_sides(transcriber, asr_stage._sides(docs, warm, traffic))

    spans = harness.Spans(trace)
    if trace:
        os.environ[PROFILE_ENV] = "1"
    window = harness.ProfiledWindow(record.chips) if trace else None
    done = []
    gc.collect()
    gc.freeze()
    if window is not None:
        window.__enter__()
    forced = trace_counts.get("asr.tdt_forced", 0)
    t_setup = time.perf_counter()
    record.e2e["setup_s"] = t_setup - t_start
    try:
        k = 0
        while True:
            clips, _, keep = asr_stage.make_call(docs, orders, traffic, k, seed)
            t_call = time.perf_counter()
            with spans("bench.asr_call"):
                got = asr.transcribe_sides(transcriber, asr_stage._sides(docs, clips, traffic),
                                           keep_logits=keep)
            now = time.perf_counter()
            print(f"tdt call {k}: {len(clips)} clips in {now - t_call:.3f} s")
            done.append(dict(clips=clips, keep=keep, lens=[clip_len(docs, c) for c in clips],
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
    audio_s = sum(sum(call["lens"]) for call in done) / plenary.SR
    record.e2e["embed_audio_s_per_s"] = audio_s / record.window_s
    peak = torch.cuda.max_memory_reserved(dev0) if device == "cuda" else 0
    record.counters.update(memory_peak_bytes=peak, audio_s=audio_s,
                           tokens=sum(len(t.tokens) for c in done for t in c["transcripts"]))
    record.e2e["peak_mem_gib"] = peak / 2**30
    record.items = done
    record.attempted = sum(len(call["clips"]) for call in done)
    kept = [c["transcripts"][j].path for c in done for j in c["keep"]]
    kept = np.concatenate(kept) if kept else np.zeros((0, 3), np.int64)
    print(f"tdt window: {record.counters['tokens'] / audio_s:.3f} tokens and "
          f"{sum(t.points for c in done for t in c['transcripts']) / audio_s:.3f} points a "
          f"second of audio, {trace_counts.get('asr.tdt_forced', 0) - forced:d} forced "
          f"advances; the kept clips' points: durations "
          f"{np.bincount(kept[:, 2], minlength=len(cfg['durations'])).tolist()}, "
          f"{int(np.sum((kept[:, 1] != cfg['vocab_size']) & (kept[:, 2] == 0)))} tokens "
          f"staying on their frame")

    # the program's state goes before the reference runs
    del model, transcriber
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    check(record, cell, docs, dev0, fit)


def walk_ok(cfg: dict, t) -> bool:
    """A kept clip's points are the argmax walk of its own logits: each
    point's token and duration follow from its logits by the decoding
    rule, each point's frame from the one before, the walk ends at T, and
    the tokens it emits, at their frames, are the transcript's."""
    v1 = cfg["vocab_size"] + 1
    durations, cap = cfg["durations"], cfg["max_symbols"]
    logits, path = np.asarray(t.logits, dtype=np.float32), np.asarray(t.path)
    if len(t.ends) != 1 or logits.shape != (len(path), v1 + len(durations)):
        return False
    frame, sym, emitted = 0, 0, []
    for (pt, k, d), lg in zip(path.tolist(), logits):
        want_k = int(lg[:v1].argmax())
        want_d = durations[int(lg[v1:].argmax())]
        if k == cfg["vocab_size"]:
            want_d = max(want_d, 1)
        else:
            emitted.append((k, pt))
            sym += 1
            if sym >= cap and want_d == 0:
                want_d = 1
        if (pt, k, d) != (frame, want_k, want_d):
            return False
        if d > 0:
            sym = 0
        frame += d
    return frame >= t.ends[0][0] and emitted == list(zip(t.tokens, t.frames))


def bad_clips(cell, call) -> int:
    """Clips whose path breaks a rule of TDT decoding, or (kept clips)
    whose points are not the argmax walk of their own logits."""
    cfg = cell["config_data"]
    bad = 0
    for j, t in enumerate(call["transcripts"]):
        frames = np.asarray(t.frames, dtype=np.int64)
        tokens = np.asarray(t.tokens, dtype=np.int64)
        _, per_frame = np.unique(frames, return_counts=True)
        ok = (len(frames) == len(tokens) and bool(np.all(np.diff(frames) >= 0))
              and (not len(per_frame) or per_frame.max() <= cfg["max_symbols"])
              and bool(np.all((tokens >= 0) & (tokens < cfg["vocab_size"])))
              and bool(t.ends) and all(end >= n for n, end in t.ends)
              and (not len(frames) or frames.max() < sum(n for n, _ in t.ends)))
        if ok and j in call["keep"]:
            ok = t.logits is not None and walk_ok(cfg, t)
        bad += not ok
    return bad


def sample(record):
    """(call, clip) pairs to hold to the reference: the kept clips of the
    call with the window's longest clip."""
    best = max(range(len(record.items)), key=lambda c: max(record.items[c]["lens"]))
    return [(best, j) for j in record.items[best]["keep"]][:record.cell["check"]["sample_clips"]]


def _clip_audio(docs, side: int, i: int, dev):
    import torch

    s, e = docs[side].windows[i]
    return torch.from_numpy(plenary.read_wav(docs[side].wav)[s:e].copy()).to(dev)


def check(record, cell, docs, dev, fit, precision: str = "fp32"):
    """Fills ``record.checks``: ``clips_with_bad_paths`` over every clip of
    every finished call, ``logit_rel_gap_max`` over the sample."""
    import torch

    cfg = cell["config_data"]
    bad = sum(bad_clips(cell, call) for call in record.items)
    gaps = []
    common.fp32_only()
    weights = weights_of(cfg, weight_seed(record.seed), dev, fit)
    prec = common.Precision(precision)
    with torch.no_grad():
        for c, j in sample(record):
            t = record.items[c]["transcripts"][j]
            if t.logits is None or t.path is None:
                gaps.append(float("inf"))
                continue
            side, i = record.items[c]["clips"][j]
            want = ref.teacher_forced(cfg, weights, _clip_audio(docs, side, i, dev), t.path,
                                      prec).cpu()
            got = torch.from_numpy(np.asarray(t.logits, dtype=np.float32))
            if got.shape != tuple(want.shape):
                gaps.append(float("inf"))
                continue
            gaps.extend(((got - want).norm(dim=1) / want.norm(dim=1)).tolist())
    del weights
    record.checks = [harness.Check("clips_with_bad_paths", float(bad), 0.0),
                     harness.Check("logit_rel_gap_max", max(gaps) if gaps else float("nan"),
                                   float(cell["check"]["logit_rel_gap_max"]))]


def control(cell: dict, seed: int, tmp: Path, n_clips: int = 8):
    """The comparison with the reference in the program's place, computed
    one precision step below the configuration's (fp8 products for bf16):
    for ``n_clips`` kept clips of the first call (the longest first), the
    float32 reference decodes greedily, and the fp8 reference's logits on
    that path are compared with the float32 ones, point by point. Returns
    the largest relative L2 gap. Needs no program."""
    import torch

    cfg, traffic = cell["config_data"], cell["traffic_data"]
    dev = torch.device("cuda", 0) if cell.get("device", "cuda") == "cuda" else torch.device("cpu")
    docs = asr_stage.sides_of(plenary.write_documents(tmp, traffic, seed, dev), seed)
    orders = asr_stage.clip_orders(docs, traffic)
    clips, _, keep = asr_stage.make_call(docs, orders, traffic, 0, seed)
    picked = sorted(keep, key=lambda j: -clip_len(docs, clips[j]))[:n_clips]
    common.fp32_only()
    weights = weights_of(cfg, weight_seed(int(seed) % (2**63)), dev)
    set_emission(cfg, weights, emission_fit(cfg, weights,
                                            fit_audios(docs, orders, traffic, seed, dev)))
    worst = 0.0
    with torch.no_grad():
        for j in picked:
            audio = _clip_audio(docs, *clips[j], dev)
            path, _ = ref.greedy(cfg, weights, audio)
            want = ref.teacher_forced(cfg, weights, audio, path)
            got = ref.teacher_forced(cfg, weights, audio, path, common.Precision("fp8"))
            worst = max(worst, float(((got - want).norm(dim=1) / want.norm(dim=1)).max()))
    return worst
