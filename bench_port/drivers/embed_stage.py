"""Stage 5.3 through its CLI, one hour-long document a call.

Set-up: the documents (``gen/plenary.py``), the encoder through the
stage's own loader (``load_embed_model``, memoised, so every CLI call of
the run reuses it) with the weights replaced by the harness's, drawn from
the seed on the card (``reference/common.py::make_weights``), and one
warm-up call whose windows put one chunk in every length bucket that the
documents use, so that every shape's CUDA graph is captured before the
window. Window: ``seg_align.embed.main`` on the documents in turn, each
into a fresh output directory, until ``seconds`` have passed; the
document in flight is finished and counted. Check: a sample of the
windows of every document finished, drawn from the seed with the longest
window of each document and of each bucket in it, embedded again by the
plain reference in float32 from the same weights and audio; each row's
relative L2 gap is compared with the cell's limit.
"""

import gc
import os
import time
from pathlib import Path

import numpy as np

from bench_port import harness
from bench_port.gen import plenary
from bench_port.reference import common, laser, sonar

REFERENCES = {"speech_laser": laser, "sonar": sonar}
PROFILE_ENV = "SVECALIGN_EMBED_PROFILE"


def _bucket(cfg: dict, kind: str, n_samples: int) -> int:
    if kind == "speech_laser":
        return laser.bucket_of(cfg, n_samples)
    nf = sonar.frames_of(n_samples)
    return next((b for b in cfg["bucket_frames"] if nf <= b), cfg["bucket_frames"][-1])


def _argv(cell: dict, meta: Path, out: Path, cat_root: Path, device: str):
    kind = cell["config_data"]["embed_model_type"]
    return [str(meta), str(out), "--concat_dir", str(cat_root),
            "--lang", cell["traffic_data"]["lang"], "--embed_model_type", kind,
            "--device", device, *cell["stage_args"]]


def _load_model(stage, embed_model_utils, argv):
    """The model as the CLI's ``main`` will ask the memo for it."""
    from svecalign_tpu_torch.utils.torch_setup import resolve_device

    args = stage.parse_args(argv)
    return embed_model_utils.load_embed_model(
        args.embed_model_type, sl_ckpt_dir=args.sl_ckpt_dir, sl_ckpt_name=args.sl_ckpt_name,
        max_tokens=args.max_tokens, sonar_name=args.sonar_name,
        batch_size=args.batch_size or 16, upload_precision=args.upload_precision,
        device=resolve_device(args.device))


def fill_weights(model, weights: dict) -> None:
    """Copy the harness's weights into every replica of ``model``; the
    replica's parameters must be exactly the spec's, by name, shape and
    dtype."""
    import torch

    seen = set()
    for replica in model._replicas:
        if id(replica) in seen:
            continue
        seen.add(id(replica))
        params = dict(replica.named_parameters())
        if set(params) != set(weights):
            raise ValueError(f"the program's parameters differ from the spec: "
                             f"{sorted(set(params) ^ set(weights))[:4]}")
        with torch.no_grad():
            for name, p in params.items():
                w = weights[name]
                if p.shape != w.shape or p.dtype != w.dtype:
                    raise ValueError(f"{name}: program {tuple(p.shape)} {p.dtype}, "
                                     f"spec {tuple(w.shape)} {w.dtype}")
                p.copy_(w)


def _break(model, faults, chips):
    """Wrap the model's per-chunk forward with the faults asked for."""
    orig = model._span_forward

    def broken(rows_q, row_scales, lengths, bucket, eager=False):
        out = orig(rows_q, row_scales, lengths, bucket, eager).clone()
        n = out.shape[0]
        if "row_altered" in faults:
            out[::8] = out[::8].roll(1, dims=1)
        if "half_batch" in faults:
            out[n // 2:] = out[: n - n // 2].clone()
        if "no_exchange" in faults:
            out[n // chips:] = 0
        return out

    model._span_forward = broken


def _read_rows(path: Path, kind: str, dim: int):
    if kind == "speech_laser":
        return np.load(path).astype(np.float32)
    return np.fromfile(path, dtype=np.float16).reshape(-1, dim).astype(np.float32)


def run(record, tmp: Path, seconds: float, trace: bool, t_start: float, faults=()) -> None:
    import torch

    from svecalign_tpu_torch.models import encode_common
    from svecalign_tpu_torch.seg_align import embed as stage
    from svecalign_tpu_torch.utils import embed_model_utils

    cell, seed = record.cell, record.seed
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    kind = cfg["embed_model_type"]
    ref = REFERENCES[kind]
    device = cell.get("device", "cuda")
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device(device)
    lang = traffic["lang"]

    docs = plenary.write_documents(tmp / "in", traffic, seed, dev0)
    metas = []
    for doc in docs:
        meta = tmp / "in" / f"{doc.stem}.tsv"
        meta.write_text(f"{doc.wav}\t{doc.wav}\n", encoding="utf-8")
        metas.append(meta)
    cat_root = tmp / "in" / "cat_segs"

    # warm-up: the first window of each bucket that the documents use, read
    # from the first document that has one
    warm_cat, warm_meta, covered = tmp / "warm_cat", tmp / "warm.tsv", set()
    (warm_cat / lang).mkdir(parents=True)
    warm_lines = []
    for doc in docs:
        first = {}
        for s, e in doc.windows:
            b = _bucket(cfg, kind, e - s)
            if b not in covered:
                first.setdefault(b, (s, e))
        if first:
            covered |= set(first)
            (warm_cat / lang / f"{doc.stem}.txt").write_text(
                "".join(f"{s} {e}\n" for s, e in first.values()), encoding="utf-8")
            warm_lines.append(f"{doc.wav}\t{doc.wav}\n")
    warm_meta.write_text("".join(warm_lines), encoding="utf-8")

    spec = ref.param_spec(cfg)
    weight_seed = seed * 1_000_003 + 17
    model = _load_model(stage, embed_model_utils, _argv(cell, metas[0], tmp / "o", cat_root,
                                                         device))
    weights = common.make_weights(spec, weight_seed, dev0)
    fill_weights(model, weights)
    del weights
    if faults:
        _break(model, faults, record.chips)
    n_models = len(embed_model_utils._model_memo)
    stage.main(_argv(cell, warm_meta, tmp / "warm_out", warm_cat, device))
    if len(embed_model_utils._model_memo) != n_models:
        raise RuntimeError("the stage built a second model: the memo key differs")

    spans = harness.Spans(trace)
    if trace:
        os.environ[PROFILE_ENV] = "1"
    window = harness.ProfiledWindow(record.chips) if trace else None
    done = []
    read_s = assemble_s = 0.0
    if window is not None:
        window.__enter__()  # the profiler's own start-up stays out of the window
    t_setup = time.perf_counter()
    record.e2e["setup_s"] = t_setup - t_start
    try:
        k = 0
        while True:
            doc = docs[k % len(docs)]
            out = tmp / "out" / str(k)
            with spans("bench.embed_cli"):
                stage.main(_argv(cell, metas[k % len(docs)], out, cat_root, device))
            now = time.perf_counter()
            prof = encode_common.encode_profile
            if trace and prof is not None:
                read_s += prof.get("read_s", 0.0)
                assemble_s += prof.get("assemble_s", 0.0)
            done.append((doc, out / lang / f"{doc.stem}.embed"))
            k += 1
            if now - t_setup >= seconds:
                break
    finally:
        if window is not None:
            window.__exit__(None, None, None)
        os.environ.pop(PROFILE_ENV, None)
        encode_common.stop_encode_profile()
    record.window_s = now - t_setup
    record.trace = window.summary if window is not None else None
    audio_s = sum(doc.seconds for doc, _ in done)
    record.e2e["embed_audio_s_per_s"] = audio_s / record.window_s
    peak = max(torch.cuda.max_memory_reserved(d) for d in range(record.chips)) \
        if device == "cuda" else 0
    record.counters.update(memory_peak_bytes=peak, audio_s=audio_s)
    if trace:
        record.counters.update(read_s=read_s, assemble_s=assemble_s)
    record.e2e["peak_mem_gib"] = peak / 2**30
    record.items = done
    record.attempted = len(done)

    # the program's state goes before the reference runs
    del model
    embed_model_utils._model_memo.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    check(record, cell, done, spec, weight_seed, dev0)


def sample(record, done, n: int):
    """(instance, window index) pairs to check: the longest window of each
    finished document and of each of its buckets, then draws from the
    seed up to ``n``."""
    cfg = record.cell["config_data"]
    kind = cfg["embed_model_type"]
    rng = np.random.default_rng([record.seed, 2])
    picked = set()
    for inst, (doc, _) in enumerate(done):
        longest = {}
        for i, (s, e) in enumerate(doc.windows):
            b = _bucket(cfg, kind, e - s)
            if b not in longest or e - s > doc.windows[longest[b]][1] - doc.windows[longest[b]][0]:
                longest[b] = i
        picked.update((inst, i) for i in longest.values())
    total = sum(len(doc.windows) for doc, _ in done)
    while len(picked) < min(n, total):
        inst = int(rng.integers(len(done)))
        picked.add((inst, int(rng.integers(len(done[inst][0].windows)))))
    return sorted(picked)


def check(record, cell, done, spec, weight_seed, dev, precision: str = "fp32"):
    """Hold the rows the window wrote to the plain reference; fills
    ``record.checks`` and counts documents with missing or broken rows."""
    cfg = cell["config_data"]
    kind = cfg["embed_model_type"]
    dim = cfg.get("encoder_dim", cfg.get("pool_dim"))
    rows, missing = {}, 0
    for inst, (doc, path) in enumerate(done):
        got = _read_rows(path, kind, dim) if path.is_file() else None
        if got is None or got.shape != (len(doc.windows), dim) or not np.isfinite(got).all():
            missing += 1
            record.failed += 1
        else:
            rows[inst] = got
    gaps = rel_gaps(record, cell, done, rows, spec, weight_seed, dev, precision)
    record.checks = [harness.Check("docs_with_bad_rows", float(missing), 0.0),
                     harness.Check("row_rel_gap_max", max(gaps) if gaps else float("nan"),
                                   float(cell["check"]["row_rel_gap_max"]))]


def rel_gaps(record, cell, done, rows, spec, weight_seed, dev, precision: str,
             keep: bool = False):
    """||program - reference|| / ||reference|| for each sampled row; with
    ``keep``, the reference's rows themselves (``rows`` unused)."""
    import torch

    cfg = cell["config_data"]
    ref = REFERENCES[cfg["embed_model_type"]]
    common.fp32_only()
    weights = common.make_weights(spec, weight_seed, dev)
    picked = [(inst, i) for inst, i in sample(record, done, cell["check"]["sample_windows"])
              if keep or inst in rows]
    out = []
    by_doc = {}
    for inst, i in picked:
        by_doc.setdefault(done[inst][0].stem, []).append((inst, i))
    for stem, items in by_doc.items():
        doc = next(d for d, _ in done if d.stem == stem)
        audio = plenary.read_wav(doc.wav)
        wins = [doc.windows[i] for _, i in items]
        want = ref.embed_windows(cfg, weights, audio, wins, dev, common.Precision(precision))
        for (inst, i), r in zip(items, want):
            if keep:
                out.append(r)
            else:
                p = torch.from_numpy(rows[inst][i])
                out.append(float((p - r).norm() / r.norm()))
    del weights
    return out


def control(cell: dict, seed: int, tmp: Path, n_docs: int = 2):
    """The comparison with the reference in the program's place, computed
    one precision step below the configuration's (fp8 products for bf16):
    the largest relative gap over the sample a run of ``n_docs`` finished
    documents would check. Needs no program."""
    import torch

    traffic = cell["traffic_data"]
    dev = torch.device("cuda", 0) if cell.get("device", "cuda") == "cuda" else torch.device("cpu")
    docs = plenary.write_documents(tmp, traffic, seed, dev)
    done = [(docs[k % len(docs)], None) for k in range(n_docs)]
    record = harness.Record(cell=cell, seed=int(seed) % (2**63), chips=int(cell["chips"]))
    spec = REFERENCES[cell["config_data"]["embed_model_type"]].param_spec(cell["config_data"])
    weight_seed = record.seed * 1_000_003 + 17
    want = rel_gaps(record, cell, done, None, spec, weight_seed, dev, "fp32", keep=True)
    got = rel_gaps(record, cell, done, None, spec, weight_seed, dev, "fp8", keep=True)
    return max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))
