"""Which cuDNN kernels run SpeechLASER's convs (the extractor's seven and
the trunk's positional conv), by input shape, on one card:

    PYTHONPATH=. python3 measure/extractor_convs.py [--out FILE] [--quick]

from a checkout's root. Part 1 (``convs``): each of the extractor's seven
``F.conv1d`` calls alone, as ``ConvFeatureExtractor._stack`` makes it
(bf16 input of the shape the previous layer gives, bf16 weights and bias,
channels-first), once to let cuDNN choose, then three calls under
``torch.profiler``: every device kernel's name and device ms a call.
Shapes: the rows of a chunk at each length bucket for a range of samples
a call (rows x samples), which includes a 600 s chunk's (150 rows of
4 s, 30 of 20 s, 13 of 45 s) and a four-card shard's (38 rows of 4 s).
Part 2 (``groups``): the whole extractor (random weights, bf16) at chunk
shapes run in g row groups, as ``ConvFeatureExtractor.forward`` runs
them: device ms a call by CUDA events (median of five), the peak memory
the call allocates, the conv kernels one profiled call ran, and the
largest gap of the output to the one-group output (max |a - b| / max |b|).
Part 3 (``model``): the program's own chunk forward, ``SpeechLaserModel.
_span_forward`` at a 600 s chunk of each length bucket (random weights),
its CUDA graph captured, then two replays and one eager forward under the
profiler: device ms a chunk by kernel name; in one call a conv and in
``conv_groups``' groups, each with the graph pool's size. Part 4 (``posconv``): the
trunk's positional conv alone (``LaserSpeechEncoder.trunk``'s call: a
transposed (rows, frames, 1024) bf16 input, kernel 128 in 16 groups) over
rows at each bucket's frames, the most a group holds under
``CONV_GROUP_SAMPLES`` among them, as part 1. Prints one JSON object a shape
and writes them all to ``--out``. Needs a card; without one it exits 2.
"""

import argparse
import json
import statistics
import sys

import torch
import torch.nn.functional as F

FALLBACKS = ("implicit_convolve_sgemm", "precomputed_convolve_sgemm")
BUCKETS_S = (4, 8, 14, 20, 30, 45, 60)
# samples a call (millions) of the sweep: a 600 s chunk holds ~9.6 M
SWEEP_M = (9.6, 8.0, 7.2, 6.4, 5.6, 4.8, 4.0, 3.6, 3.2, 2.8, 2.4, 2.0, 1.6, 1.2, 0.8)
GROUP_SHAPES = ((150, 64000, range(1, 9)), (75, 128000, range(1, 6)),
                (30, 320000, range(1, 7)), (13, 720000, range(1, 6)), (38, 64000, (1, 2)))


def kernels(prof, reps: int) -> dict:
    """Device ms a call by kernel name (copies and sets included)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            out[ev.name()] = out.get(ev.name(), 0.0) + ev.duration_ns() * 1e-6 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled(fn, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernels(prof, reps)


def layer_inputs(cfg, rows: int, samples: int, dev):
    """(input shape, weight, bias, stride) of each conv for a (rows, samples)
    chunk."""
    out, c_in, t = [], 1, samples
    for dim, k, s in cfg.conv_layers:
        w = torch.randn(dim, c_in, k, device=dev, dtype=torch.bfloat16) * (c_in * k) ** -0.5
        b = torch.randn(dim, device=dev, dtype=torch.bfloat16) * 0.1
        out.append(((rows, c_in, t), w, b, s))
        c_in, t = dim, (t - k) // s + 1
    return out


def conv_shapes(cfg, dev, quick: bool):
    sweep = SWEEP_M[::3] if quick else SWEEP_M
    shapes = []
    for b in BUCKETS_S:
        samples = b * 16000
        for m in sweep:
            rows = round(m * 1e6 / samples)
            if rows >= 1 and (rows, samples) not in shapes:
                shapes.append((rows, samples))
    for rs in ((150, 64000), (75, 64000), (38, 64000), (19, 64000), (37, 64000),
               (30, 320000), (15, 320000), (13, 720000), (7, 720000), (6, 720000)):
        if rs not in shapes:
            shapes.append(rs)
    for rows, samples in shapes:
        rec = {"part": "convs", "rows": rows, "samples": samples,
               "rows_x_samples": rows * samples, "layers": []}
        for i, (shape, w, b, s) in enumerate(layer_inputs(cfg, rows, samples, dev)):
            x = torch.randn(shape, device=dev, dtype=torch.bfloat16)
            F.conv1d(x, w, b, stride=s)  # cuDNN chooses
            ks = profiled(lambda: F.conv1d(x, w, b, stride=s), 3)
            rec["layers"].append({"layer": i, "input": list(shape), "ms": sum(ks.values()),
                                  "fallback": any(f in k for k in ks for f in FALLBACKS),
                                  "kernels": {k[:90]: round(v, 4) for k, v in ks.items()}})
            del x
        rec["fallback_layers"] = [r["layer"] for r in rec["layers"] if r["fallback"]]
        rec["ms"] = sum(r["ms"] for r in rec["layers"])
        yield rec


def group_runs(cfg, dev):
    from svecalign_tpu_torch.models.laser_encoder import ConvFeatureExtractor

    ext = ConvFeatureExtractor(cfg).to(dev).eval().requires_grad_(False)
    for mod in ext.modules():
        if isinstance(mod, torch.nn.Conv1d):
            mod.to(torch.bfloat16)
    for rows, samples, gs in GROUP_SHAPES:
        wav = 0.3 * torch.randn(rows, samples, device=dev)
        ref = None
        for g in gs:
            def run():
                return torch.cat([ext._stack(p) for p in wav.tensor_split(g)])

            with torch.inference_mode():
                out = run()
                ref = out.float() if ref is None else ref
                gap = float((out.float() - ref).abs().max() / ref.abs().max())
                del out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                times = []
                for _ in range(5):
                    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    a.record()
                    run()
                    z.record()
                    z.synchronize()
                    times.append(a.elapsed_time(z))
                peak = torch.cuda.max_memory_allocated() - base
                ks = profiled(run, 1)
            convs = {k[:90]: round(v, 3) for k, v in ks.items() if "conv" in k.lower()
                     or "fprop" in k or "sgemm" in k or "xmma" in k}
            yield {"part": "groups", "rows": rows, "samples": samples, "groups": g,
                   "ms": statistics.median(times), "ms_all": [round(t, 3) for t in times],
                   "peak_gib": peak / 2**30, "gap_to_one_group": gap,
                   "fallback": any(f in k for k in ks for f in FALLBACKS), "conv_kernels": convs}


def model_runs(dev):
    import copy
    import gc

    import numpy as np

    from svecalign_tpu_torch.models import laser_encoder

    base = laser_encoder.SpeechLaserModel(max_tokens=600 * 16000, device=dev)
    committed = laser_encoder.CONV_GROUP_SAMPLES
    gen = np.random.default_rng(0)
    for limit in (10**12, committed):
        laser_encoder.CONV_GROUP_SAMPLES = limit
        model = copy.copy(base)  # programs of its own
        for bucket in model.BUCKETS:
            rows = model._rows_per_chunk(bucket)
            q = torch.from_numpy(gen.integers(-8000, 8000, (rows, bucket),
                                              dtype=np.int16)).to(dev)
            scales = torch.full((rows,), 1 / 32768, device=dev)
            lengths = torch.full((rows,), bucket, dtype=torch.int32, device=dev)
            for eager in (False, True):
                def run():
                    return model._span_forward(q, scales, lengths, bucket, eager)

                run()
                ks = profiled(run, 2)
                yield {"part": "model", "limit": limit, "bucket": bucket, "rows": rows,
                       "groups": laser_encoder.conv_groups(rows, bucket), "eager": eager,
                       "ms": sum(ks.values()),
                       "fallback_ms": sum(v for k, v in ks.items()
                                          if any(f in k for f in FALLBACKS)),
                       "kernels": {k[:90]: round(v, 4) for k, v in list(ks.items())[:14]}}
        yield {"part": "model", "limit": limit, "pool_gib": model.program_stats()[0]["pool_bytes"]
               / 2**30, "max_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    laser_encoder.CONV_GROUP_SAMPLES = committed


def posconv_runs(cfg, dev):
    from svecalign_tpu_torch.models.laser_encoder import CONV_GROUP_SAMPLES

    d, k, g = cfg.encoder_dim, cfg.conv_pos_kernel, cfg.conv_pos_groups
    w = torch.randn(d, d // g, k, device=dev, dtype=torch.bfloat16) * (d // g * k) ** -0.5
    b = torch.randn(d, device=dev, dtype=torch.bfloat16) * 0.1
    size, hop = cfg.receptive_field()
    for bucket_s in BUCKETS_S:
        samples = bucket_s * 16000
        frames = (samples - size) // hop + 1
        top = 600 // bucket_s
        edge = CONV_GROUP_SAMPLES // samples  # the most rows a group holds
        for rows in sorted({top, edge, *(r for r in (128, 100, 75, 64, 50, 38, 32, 25, 19, 12,
                                                     8, 4) if r < top)}, reverse=True):
            x = torch.randn(rows, frames, d, device=dev, dtype=torch.bfloat16)

            def run():
                return F.conv1d(x.transpose(1, 2), w, b, padding=k // 2, groups=g)

            run()
            ks = profiled(run, 3)
            yield {"part": "posconv", "bucket_s": bucket_s, "rows": rows, "frames": frames,
                   "rows_x_samples": rows * samples, "ms": sum(ks.values()),
                   "fallback": any(f in n for n in ks for f in FALLBACKS),
                   "kernels": {n[:90]: round(v, 4) for n, v in ks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="extractor_convs.json")
    ap.add_argument("--quick", action="store_true", help="every third sweep point")
    ap.add_argument("--parts", default="convs,groups,model,posconv",
                    help="comma-separated parts to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from svecalign_tpu_torch.models.laser_encoder import LaserEncoderConfig

    dev = torch.device("cuda", 0)
    cfg = LaserEncoderConfig()
    head = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version(),
            "cudnn_benchmark": torch.backends.cudnn.benchmark}
    print(json.dumps(head), flush=True)
    recs = [head]
    parts = args.parts.split(",")
    with torch.inference_mode():
        if "convs" in parts:
            for rec in conv_shapes(cfg, dev, args.quick):
                recs.append(rec)
                print(json.dumps({k: rec[k] for k in ("rows", "samples", "rows_x_samples", "ms",
                                                       "fallback_layers")}), flush=True)
        if "posconv" in parts:
            for rec in posconv_runs(cfg, dev):
                recs.append(rec)
                print(json.dumps({k: v for k, v in rec.items() if k != "kernels"}), flush=True)
    runs = []
    if "groups" in parts:
        runs.append(group_runs(cfg, dev))
    if "model" in parts:
        runs.append(model_runs(dev))
    for run in runs:
        for rec in run:
            recs.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "conv_kernels"}), flush=True)
    with open(args.out, "w") as f:
        json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
