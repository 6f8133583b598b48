"""Time the two traceback-walk wrappers of the tree it is run from, on the
card: device ms by CUDA-graph replay, eager ms (the wrapper called back to
back between CUDA events) and host us a call (the wrapper's own work, with
no synchronisation inside the loop), at the stage-5.4 main path's shapes:
the dense walk at P = 1 (300 x 275) and at the 16-pair run's last bucket
(P = 8), the banded walk at P = 1 (1200 x 1100) and at that bucket.

Run from the root of a checkout (it imports that checkout's
``svecalign_tpu_torch`` and ``chip_smoke``), so that two trees can be
compared in one call, in turns:

    python3 measure/walk_times.py --label change
    (cd parent && python3 ../measure/walk_times.py --label parent)

Prints one JSON line. Needs one CUDA GPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def host_us(fn, reps=200, runs=5):
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(out))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("walk_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from svecalign_tpu_torch.ops import _build, dense_dp_cuda, dp_cuda, traceback_cuda
    from svecalign_tpu_torch.vecalign.batch import _band_pad

    _build.build_all(["dense_dp", "banded_dp", "traceback_walk"])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(8642)
    pairs, n_pad, m_pad, depth = cs.bucket_plan(cs.BUCKET_SIZES)[-1]
    top = [(n >> depth, m >> depth) for n, m in pairs]
    dense = {
        1: cs._dense_problem(rng, [(300, 275)], dev, ties=False),
        len(pairs): cs._dense_problem(rng, top, dev, ties=False,
                                      pad=(n_pad >> depth, m_pad >> depth)),
    }
    banded = {
        1: cs._random_band_problem(rng, [(1200, 1100)], cs.DEFAULT_TYPES, 8, dev),
        len(pairs): cs._random_band_problem(rng, pairs, cs.DEFAULT_TYPES, 8, dev,
                                            a_pad=_band_pad(n_pad, m_pad)),
    }
    out = {"label": args.label, "card": cs._card_line(), "dense": {}, "banded": {}}
    for P, a in dense.items():
        _, bp = dense_dp_cuda.dense_dp_cuda(*a)
        walk = (bp, a[2], a[3])

        def fn(walk=walk):
            return traceback_cuda.dense_traceback_walk_cuda(*walk)

        out["dense"][P] = {"ms": cs._graph_time_ms(fn), "eager_ms": cs._cuda_time_ms(fn, reps=50),
                           "host_us": host_us(fn), "shape": list(bp.shape)}
    for P, a in banded.items():
        planes = dp_cuda.banded_dp_cuda_batched(*a)
        walk = (*planes, a[2], a[6], a[7])

        def fn(walk=walk):
            return traceback_cuda.banded_traceback_walk_cuda(*walk)

        out["banded"][P] = {"ms": cs._graph_time_ms(fn), "eager_ms": cs._cuda_time_ms(fn, reps=50),
                            "host_us": host_us(fn), "shape": list(planes[1].shape)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
