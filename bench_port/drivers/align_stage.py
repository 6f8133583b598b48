"""Stage 5.4 through its CLI: every pair of the traffic in one call, in
buckets of ``--pair_batch``.

Set-up: the pairs (``gen/pairs.py``) and one warm-up call, which builds
the DP and walk kernels (once per checkout) and runs every bucket shape.
Window: ``seg_align.align.main`` over all pairs, each call into a fresh
output directory, until ``seconds`` have passed; the call in flight is
finished and counted. Check: every pair is aligned again by the plain
reference (``reference/vecalign.py``) from the same files, once, and
every call's file of every pair is held to it: the widest gap between
the two sides' costs of an alignment, an alignment that only one side has
counting as a gap of 1; a file missing or empty counts as failed.
"""

import gc
import os
import time
from pathlib import Path

import numpy as np

from bench_port import harness
from bench_port.gen import pairs as gen_pairs
from bench_port.reference import vecalign as ref

PROFILE_ENV = "SVECALIGN_ALIGN_PROFILE"
KERNELS = (("dense_dp_cuda", "dense_dp_cuda"), ("dp_cuda", "banded_dp_cuda_batched"),
           ("traceback_cuda", "dense_traceback_walk_cuda"),
           ("traceback_cuda", "banded_traceback_walk_cuda"))


def _argv(cell: dict, root: Path, out: Path, device: str):
    src, tgt = cell["traffic_data"]["langs"]
    return [str(root / "metadata.tsv"), str(out), "--src_lang", src, "--tgt_lang", tgt,
            "--seg_dir", str(root / "segments"), "--concat_dir", str(root / "cat_segs"),
            "--embed_dir", str(root / "embeds"), "--is_stopes_embed", "--device", device,
            *cell["stage_args"]]


class LaunchLog:
    """Records the shapes of each launch of the four kernels by wrapping
    their wrappers (traced runs only); the wrappers run unchanged."""

    def __init__(self, record):
        from svecalign_tpu_torch.ops import dense_dp_cuda, dp_cuda, traceback_cuda

        self.modules = {"dense_dp_cuda": dense_dp_cuda, "dp_cuda": dp_cuda,
                        "traceback_cuda": traceback_cuda}
        self.record = record
        self.saved = []

    def __enter__(self):
        for mod_name, fn_name in KERNELS:
            mod = self.modules[mod_name]
            orig = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._wrap(fn_name, orig))
        return self

    def _wrap(self, fn_name, orig):
        def wrapped(*args, **kwargs):
            self.record.launches.append((fn_name, _shapes(fn_name, args)))
            return orig(*args, **kwargs)

        return wrapped

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)
        return False


def _shapes(fn_name: str, args) -> dict:
    if fn_name == "dense_dp_cuda":
        costs, _, xs, ys = args[:4]
        return {"P": costs.shape[0], "x": xs.tolist(), "y": ys.tolist()}
    if fn_name == "banded_dp_cuda_batched":
        costs, xs, ys = args[0], args[6], args[7]
        return {"T": costs.shape[1], "B": costs.shape[3], "x": xs.tolist(), "y": ys.tolist()}
    if fn_name == "dense_traceback_walk_cuda":
        bp, xs, ys = args[:3]
        return {"steps": bp.shape[1] + bp.shape[2] - 1, "x": xs.tolist(), "y": ys.tolist()}
    xp, xs, ys = args[1], args[4], args[5]
    return {"a2": xp.shape[1], "x": xs.tolist(), "y": ys.tolist()}


def _break(faults):
    """Break the stage's results where they are produced."""
    from svecalign_tpu_torch.vecalign import batch

    orig = batch.run_staged

    def broken(handle, **kwargs):
        out = orig(handle, **kwargs)
        n = len(out)
        if "half_batch" in faults:
            out = out[: n - n // 2] + out[: n // 2]
        if "row_altered" in faults or "slot_altered" in faults:
            altered = []
            for k, (aligns, scores) in enumerate(out):
                # one alignment's cost in every pair, or in the bucket's last slot alone
                if "row_altered" in faults or k == n - 1:
                    scores = scores.copy()
                    scores[len(scores) // 2] += 0.01
                altered.append((aligns, scores))
            out = altered
        return out

    batch.run_staged = broken
    return orig


def run(record, tmp: Path, seconds: float, trace: bool, t_start: float, faults=()) -> None:
    import torch

    from svecalign_tpu_torch.seg_align import align as stage
    from svecalign_tpu_torch.vecalign import batch

    cell, seed = record.cell, record.seed
    traffic = cell["traffic_data"]
    device = cell.get("device", "cuda")
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device(device)
    root = tmp / "in"
    pairs = gen_pairs.write_pairs(root, traffic, seed, dev0)
    orig = _break(faults) if faults else None
    try:
        stage.main(_argv(cell, root, tmp / "warm_out", device))
        if trace:
            os.environ[PROFILE_ENV] = "1"
            batch.phase_seconds.clear()
        spans = harness.Spans(trace)
        window = harness.ProfiledWindow(record.chips) if trace else None
        launches = LaunchLog(record) if trace else None
        calls, load_s = [], 0.0
        # every window starts with set-up's garbage collected and set-up's
        # objects out of the collector's scans: the stage's own objects are
        # collected as they come
        gc.collect()
        gc.freeze()
        if window is not None:
            window.__enter__()  # the profiler's own start-up stays out of the window
            launches.__enter__()
        t_setup = time.perf_counter()
        record.e2e["setup_s"] = t_setup - t_start
        try:
            k = 0
            while True:
                out = tmp / "out" / str(k)
                with spans("bench.align_cli"):
                    prof = stage.main(_argv(cell, root, out, device))
                now = time.perf_counter()
                load_s += prof["load"]
                calls.append(out)
                k += 1
                if now - t_setup >= seconds:
                    break
        finally:
            if window is not None:
                launches.__exit__(None, None, None)
                window.__exit__(None, None, None)
            os.environ.pop(PROFILE_ENV, None)
            gc.unfreeze()
    finally:
        if orig is not None:
            batch.run_staged = orig
    record.window_s = now - t_setup
    record.trace = window.summary if window is not None else None
    n_pairs = len(pairs) * len(calls)
    record.e2e["align_pairs_per_s"] = n_pairs / record.window_s
    peak = max(torch.cuda.max_memory_reserved(d) for d in range(record.chips)) \
        if device == "cuda" else 0
    record.e2e["peak_mem_gib"] = peak / 2**30
    record.counters.update(memory_peak_bytes=peak, pairs=n_pairs, load_s=load_s)
    if trace:
        record.counters["pyramid_s"] = sum(batch.phase_seconds.values())
    record.items = pairs
    record.attempted = n_pairs
    check(record, cell, root, pairs, calls, dev0)


def _read_lines(path: Path):
    """(alignment, score) of each ``[x]:[y]:cost`` line, or None."""
    if not path.is_file():
        return None
    out = []
    for line in path.read_text(encoding="utf-8").splitlines():
        key, cost = line.rsplit(":", 1)
        out.append((key, float(cost)))
    return out


def reference_lines(cell: dict, root: Path, pair, n_pad: int, m_pad: int, dev,
                    precision: str = "fp32"):
    """The plain reference's lines for one pair of the input tree."""
    import torch

    traffic = cell["traffic_data"]
    opts = dict(cell["align_options"])
    src, tgt = traffic["langs"]
    sides = []
    for lang in (src, tgt):
        name = f"{pair.stem}_{lang}"
        segs = (root / "segments" / lang / f"{name}.txt").read_text().splitlines()
        cat = (root / "cat_segs" / lang / f"{name}.txt").read_text().splitlines()
        rows = torch.from_numpy(np.load(root / "embeds" / lang / f"{name}.embed"))
        sides.append((rows, ref.overlap_ids(segs, cat, opts["alignment_max_size"] - 1)))
    depth = ref.depth_of(n_pad, m_pad, opts["max_size_full_dp"])
    aligns, scores = ref.align_pair(sides[0][0], sides[0][1], sides[1][0], sides[1][1], depth,
                                    opts, dev, precision)
    return [(line.rsplit(":", 1)[0], float(line.rsplit(":", 1)[1]))
            for line in ref.format_lines(aligns, scores)]


def _pad(cell: dict, pairs):
    """Each pair's bucket's padded sizes, as the stage buckets them."""
    sizes = [p.sizes for p in pairs]
    pad = {}
    for bucket in ref.buckets(sizes, cell["align_options"]["pair_batch"]):
        n_pad = ref.grid_dim(max(sizes[k][0] for k in bucket))
        m_pad = ref.grid_dim(max(sizes[k][1] for k in bucket))
        pad.update({k: (n_pad, m_pad) for k in bucket})
    return pad


def check(record, cell, root: Path, pairs, calls, dev):
    """Fill ``record.checks``: every pair file of every call there and held
    to the float32 reference."""
    src, tgt = cell["traffic_data"]["langs"]
    got = {}
    for out in calls:
        for k, pair in enumerate(pairs):
            lines = _read_lines(out / f"{src}-{tgt}" / f"{pair.stem}_{src}-{pair.stem}_{tgt}.txt")
            if not lines:
                record.failed += 1
            got[out, k] = lines
    pad = _pad(cell, pairs)
    gap = 0.0
    for k in range(len(pairs)):
        want = dict(reference_lines(cell, root, pairs[k], *pad[k], dev))
        for out in calls:
            have = dict(got[out, k] or [])
            # an alignment that one side has and the other lacks is a gap of 1,
            # past any cost difference rounding can make
            gap = max([gap] + [1.0 for a in set(want) ^ set(have)]
                      + [abs(want[a] - have[a]) for a in set(want) & set(have)])
    record.checks = [harness.Check("pair_files_missing", float(record.failed), 0.0),
                     harness.Check("cost_gap_max", gap, float(cell["check"]["cost_gap_max"]))]


def control(cell: dict, seed: int, tmp: Path):
    """The comparison with the reference in the program's place, its
    products' operands in bfloat16 (one step below the stage's float32):
    the checks' readings over every pair, as a run checks them. Needs no
    program."""
    import torch

    dev = torch.device("cuda", 0) if cell.get("device", "cuda") == "cuda" else torch.device("cpu")
    pairs = gen_pairs.write_pairs(tmp, cell["traffic_data"], seed, dev)
    record = harness.Record(cell=cell, seed=int(seed) % (2**63), chips=int(cell["chips"]))
    src, tgt = cell["traffic_data"]["langs"]
    out = tmp / "control_out"
    for k in range(len(pairs)):
        lines = reference_lines(cell, tmp, pairs[k], *_pad(cell, pairs)[k], dev, "bf16")
        path = out / f"{src}-{tgt}" / f"{pairs[k].stem}_{src}-{pairs[k].stem}_{tgt}.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(f"{a}:%.6f\n" % c for a, c in lines), encoding="utf-8")
    record.failed = 0
    check(record, cell, tmp, pairs, [out], dev)
    return {c.name: c.value for c in record.checks}
