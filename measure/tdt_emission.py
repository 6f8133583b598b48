"""Choose the emission of the benchmark's Parakeet-TDT cell on a card: for
each seed, the full-width model with the harness's weights
(``bench_port/drivers/tdt_stage.py::weights_of``), its emission fitted
for each setting asked for (``emission_fit``), transcribes the cell's first
call, and the tokens, loop points and forced advances a second of audio
are printed, with the durations of the points of 64 kept clips.

    python3 measure/tdt_emission.py --seeds 1 2 3 \\
        --shares 0.03,0.25,0.45,0.2,0.07 --token_share 0.55
"""

import argparse
import copy
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness  # noqa: E402
from bench_port.drivers import asr_stage, tdt_stage  # noqa: E402
from bench_port.gen import plenary  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--shares", nargs="+", default=None,
                   help="duration shares, comma-separated, one setting each")
    p.add_argument("--token_share", type=float, nargs="+", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from svecalign_tpu_torch.analysis import asr, tdt
    from svecalign_tpu_torch.models import parakeet
    from svecalign_tpu_torch.utils import trace

    cell = harness.load_cell("parakeet.asr_clips")
    traffic, dev = cell["traffic_data"], torch.device(args.device)
    base = cell["config_data"]
    shares = ([[float(x) for x in s.split(",")] for s in args.shares] if args.shares
              else [base["emission"]["duration_shares"]])
    token_shares = args.token_share or [base["emission"]["token_share"]]
    v = base["vocab_size"]
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            docs = asr_stage.sides_of(plenary.write_documents(Path(tmp) / str(seed), traffic,
                                                              seed, dev), seed)
            orders = asr_stage.clip_orders(docs, traffic)
            clips = asr_stage.make_call(docs, orders, traffic, 0, seed)[0]
            sides = asr_stage._sides(docs, clips, traffic)
            keep = list(range(0, len(clips), max(1, len(clips) // 64)))
            audio_s = sum(tdt_stage.clip_len(docs, c) for c in clips) / plenary.SR
            audios = tdt_stage.fit_audios(docs, orders, traffic, seed, dev)
            w = tdt_stage.weights_of(base, tdt_stage.weight_seed(seed), dev)
            rows, bias = w["joint.out.weight"][v:].clone(), w["joint.out.bias"][v:].clone()
            model = parakeet.build(tdt_stage.model_config(base), dev)
            tr = None
            for share in shares:
                for token_share in token_shares:
                    cfg = copy.deepcopy(base)
                    cfg["emission"].update(duration_shares=share, token_share=token_share)
                    w["joint.out.weight"][v:], w["joint.out.bias"][v:] = rows, bias
                    tdt_stage.set_emission(cfg, w, tdt_stage.emission_fit(cfg, w, audios))
                    if tr is None:
                        parakeet.load_weights(model, w)
                        tr = tdt.TdtTranscriber(model, batch=int(cell["asr_options"]["batch"]))
                    else:  # in place: the captured programs read these tensors
                        out = model.joint.out
                        out.weight.copy_(w["joint.out.weight"])
                        out.bias.copy_(w["joint.out.bias"])
                        w32, b32 = model.joint.out_fp32()
                        w32.copy_(out.weight.float())
                        b32.copy_(out.bias.float())
                    before = dict(trace.counts)
                    t0 = time.perf_counter()
                    got = asr.transcribe_sides(tr, sides, keep_logits=keep)
                    wall = time.perf_counter() - t0
                    ts = [t for side in got for t in side]
                    tokens = sum(len(t.tokens) for t in ts)
                    points = sum(t.points for t in ts)
                    forced = trace.counts["asr.tdt_forced"] - before.get("asr.tdt_forced", 0)
                    iters = (trace.counts["asr.tdt_iterations"]
                             - before.get("asr.tdt_iterations", 0))
                    path = np.concatenate([ts[j].path for j in keep])
                    hist = np.bincount(path[:, 2], minlength=5) / len(path)
                    stay = np.mean((path[:, 1] != v) & (path[:, 2] == 0))
                    print(f"seed {seed} shares {share} token_share {token_share}: "
                          f"{tokens / audio_s:.3f} tokens/s, {points / audio_s:.3f} points/s "
                          f"of audio, {forced} forced, {iters} iterations, kept points' "
                          f"durations {np.round(hist, 4).tolist()}, tokens staying "
                          f"{stay:.4f}; {len(clips)} clips, {audio_s:.1f} s, wall {wall:.2f} s",
                          flush=True)
            del model, tr, w
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
