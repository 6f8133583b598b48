"""Drive the PyTorch port on one NVIDIA H100: `python3 chip_smoke.py`.

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the port from ``svecalign_tpu_torch/csrc``
   (one nvcc per source, all at once) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card, in
   every geometry its original admits: the banded DP (both routes), the
   dense DP and the dense walk on ragged buckets (both orientations, sizes
   off the strip width, strips past the last warp, empty sides), the
   banded walk on every banded case's planes and on its own edge cases
   (a ring that wraps, int32 planes, a long tail, buckets of 1-64 pairs,
   walks past the shared-memory records, corrupt pointers and starts),
   the rel-key attention (up to T = 3000), the LayerNorm (both layouts,
   fp32 and bf16 in and out, its conv-bias prologue and GELU epilogue);
   the dense DP's, the banded walk's and the LayerNorm's launch plans
   against the sources' own;
3. run the stage-5.4 CLI (``svecalign_tpu_torch.seg_align.align``) on a
   synthetic hour-scale plenary pair written from a seed: the launch
   counts show it went through the kernels, its output must equal a run
   with the plain DP, and it must recover the planted 1-1 pairs; with
   ``--dp_backend native`` (the host float64 DP) the same alignments, and
   level by level the kernel's pointers and its csum within 1e-5; then the
   same CLI with ``--pair_batch 8`` on 16 such pairs of mixed sizes (the
   batched aligner): launches are counted per bucket and level, not per
   pair, no DP plane is pulled, every pair is covered in order with its
   planted pairs recovered; and at library level a ``sampling="paired"``
   bucket must equal one per-pair run per pair;
4. time each kernel against its plain version and its bound at the main
   paths' shapes, both stage-5.4 runs by phase, and the traceback walks on
   the card against pull + host walk in turns; the DPs' and walks' latency
   bounds are chains of dependent steps, at latencies that a probe
   (``csrc/chain_latency_probe.cu``) measures on the card; the dense DP and
   the walks by CUDA-graph replay and eagerly, the dense DP and the banded
   walk against their first designs' times (it fails if either is not
   under them);
5. run the stage-5.3 CLI (``svecalign_tpu_torch.seg_align.embed``) with the
   full-width 24-layer SONAR encoder (bf16, random weights from a seed) on
   a synthetic 10-minute document written from a seed: the rel-key kernel
   must run 24 times per chunk (counted at each replay of the encoder's
   CUDA graphs, one captured per bucket) and the plain attention never, the
   rows must be finite and agree (per-row cosine >= 0.99) with a run on the
   plain attention path; the rows by graph replay against the eager
   forward (per-row cosine >= 0.99999), the CLI's warm wall by graph and
   eagerly in turns, capture seconds per bucket, the graph pool's bytes and
   peak memory; a forward that synchronises must make its capture raise to
   the caller; then the stage's phases, and the kernel timed at
   each of the run's buckets against SDPA and its bound (and against its
   plain version at the modal bucket); the Transformer-XL ``relative``
   flavor on one chunk of every bucket (the plain attention path): finite
   rows, per-row cosine >= 0.99 to an fp32 forward of the same weights,
   and its time per minute of audio.

6. run the stage-5.3 CLI with the full-width SpeechLASER encoder, the
   pipeline's default (bf16, random weights from a seed), on the same
   document: one fp16 ``.npy`` row per window, all finite, a sample of
   every bucket's windows against an fp32 forward of the same weights,
   device window assembly against host slicing with fp32 uploads; graph
   replay against the eager forward as in phase 5; walls, phases and the
   share of the bf16 peak;
7. the post-align chain through the port's CLIs: LASER stage 5.3 on a
   second document, stage 5.4 over the pair, stages 6.1, 6.3 (at the
   pipeline's settings: chains of up to 3 contiguous alignments, gaps of
   1 s or less, 20 s or less on both sides) and 6.4 (1 s or more on both
   sides), then stage 6.5 with LASER and with SONAR on 6.4's output; again
   from 6.3 with chains of up to 6 alignments, which stage 6.5 must embed
   (coverage): every tsv line at its stage-5.3 row or at a finite row of
   the 6.5 file that equals encode_spans of its span; SONAR's runs launch
   the rel-key kernel 24 times per chunk and the plain attention never;
8. kernel coverage beyond the chain: SONAR's encode_spans at the long
   buckets (25-60 s spans, T = 1500-3000), which stage 6.5 meets only
   where one alignment is that long, against the plain attention path,
   and the kernel timed there against SDPA and its bound;
9. mining at a corpus size users run: stages 6.6 and 6.7 through their
   CLIs on a synthetic corpus of 100 pairs and 2^18 rows a language
   (planted pairs), the Flat tier searched tiled: the index file against
   the normalized rows, sampled margins against float64 on the card, the
   planted pairs over margin 1; first and warm walls, the search split
   into products, top-k and merge against its fp32 bound, peak memory;
   coverage on 2^15 rows: IVF at the full probe against Flat and at the
   default probe, k-means reproducible bit for bit, the int8 corpus and
   fp16 query uploads within tolerance of fp32;
10. the front of the pipeline at hour scale: stages 4.1 (energy VAD on
   both sides, the Silero v4 graph on the card), 4.2 and 6.2 through
   their CLIs on a synthetic hour-long pair with planted untranslated
   segments: the planted speech found, Silero on the card against the CPU
   path with the plain LSTM loop, every planted pair flagged and dropped,
   the card's verdicts equal to the CPU path's, walls and splits, the
   LSTM against its latency bound; an .ogg round trip;
11. the whole graph through ``svecalign_tpu_torch.pipeline``: all 16
   stages on two hour-long pairs with planted untranslated segments,
   full-width SpeechLASER, ``--pair_batch 2``, once unfused and once
   ``--fused --overlap_untrans``: every output file equal (margins within
   1e-5), the row cache hit for every document, the fused stage 5.4
   uploading the id maps alone and equal to a stage-5.4 run in a process
   of its own, its kernels launched once a bucket and level and the plain
   DP never, no untranslated duplicate mined, device memory back where it
   was; then SONAR ``--fused`` on phase 7's documents (the rel-key kernel
   24 times a chunk, the plain attention never);
12. several cards in one process (``parallel/mesh.py``), each sharded
   path against the same path on one device: phase 2's kernel checks on
   every card of the mesh; stage 5.4's 16 pairs at ``--pair_batch 8``
   over the mesh, bit-equal in paired and in shared mode, the kernels
   launched on every shard; full-width LASER and SONAR data-parallel on
   the 10-minute document (rows at cosine >= 0.999, the rel-key kernel on
   every shard, graph replay against the eager forward at cosine >=
   0.99999, walls by graph and eagerly); the sharded Flat search over the
   mining corpus, the
   sharded IVF and int8 tiers and ``score_align --sharded_index``; and,
   with two or more cards, the pipeline with ``--data_parallel 0
   --sharded_index --fused`` against one card. On one card the mesh is
   two shards of it, and the pipeline bullet is skipped;
13. encoder training (``models/training.py``, ``train.py``) on a mined
   tsv of 64 same-span pairs: a 2-layer d = 1024 fp32 step on the card
   against the same step on the CPU, and on two model shards of the card
   (``Mesh([[cuda:0, cuda:0]])``, tensor parallel) against one device, to
   the CPU tests' bounds times 10; the training CLI at its defaults (24
   layers, d = 1024, batch 8, 10 s clips, bf16) for 4 steps with finite
   losses, its ``encoder_final.npz`` loaded into ``SpeechLaserModel``;
   8 steps on one batch lowering its loss (the later half's mean under the
   first), timed (s per step, clips/s,
   TFLOP/s, peak memory), and the two-shard mesh's overhead.

Phase 7 begins with the windows of both documents written by the
stage-5.1 CLI, the stage-4.2 CLI's flags and stage 5.2, runs stage 6.2
between 6.1 and 6.3, and ends in the mined tsv: stages 6.6-6.10 on the
pipeline-settings traffic.

``--checks`` runs phases 1-2 only; ``--dp`` runs phases 1-4 (stage 5.4
alone: no SONAR model is built) and prints their ``[time]`` lines;
``--ablation`` runs what ``--dp`` does and, in phase 4, measurement builds
that no path of the port runs: the dense DP's first design in ablation
modes (``measure/dense_dp_ablation.cu``), the shipped dense DP by strip
count, and the banded walk with 1-15 producer warps (its source built
with ``-DWALK_PRODUCERS=k``);
``--embed`` runs phases 1, 2, 5 and 6 (without the chain);
``--laser`` runs phases 1, 2 and 6-8; ``--mining`` phases 1, 2 and 9 and
``--front`` phases 1, 2 and 10 (no encoder is built), ``--pipeline``
phases 1, 2 and 11, ``--multi`` phases 1, 2 and 12, ``--train`` phases 1,
2 and 13; ``--norm`` builds, checks the LayerNorm kernel and times it at
the encoders' shapes against its plain version and its bytes bound (the
times also run in phase 5); ``--profile``
profiles one warm stage-5.3 run with each encoder instead, by graph replay
and with the eager forward.

Prints one JSON ``kernels`` line before the last; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports only the
port, torch and numpy.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SRC_LANG, TGT_LANG = "en", "de"
N_SRC, N_TGT = 1200, 1100  # segments of an hour-scale plenary pair
STEM = "20180313-0900-PLENARY-SYN"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bf16 dense tensor cores
H100_SM_CLOCK_HZ = 1.98e9  # H100 SXM maximum SM clock, where the device's cannot be read
# Cycles of the banded DP's dependent chain (see _chain_cycles_per_step), as
# phase_chain_latencies measured them on an NVIDIA H100 80GB HBM3 at 700 W
# with csrc/chain_latency_probe.cu (a shuffle 26.00, a shared-memory store, barrier and
# load 28.00, an fp32 operation 5.10); a run on a card measures anew and uses
# its own, these serve where no card is at hand
ROW_HANDOVER_CYCLES = 26.0  # a row from the lanes that wrote it to those that read it
ALU_CYCLES = 5.1  # one dependent fp32 add, minimum or select
DOC_SECONDS = 600  # the stage-5.3 document: 10 minutes of 16 kHz audio
MIN_COSINE = 0.99  # kernel run vs plain-attention run, per .embed row
MIN_RECALL = 0.95  # of a synthetic pair's planted 1-1 alignments


# ---------------------------------------------------------------------------
# Synthetic plenary pair (also written by the CPU tests at a small size)
# ---------------------------------------------------------------------------


def _plant_alignment(rng, n_src, n_tgt):
    """A monotone planted alignment covering exactly n_src x n_tgt
    segments: mostly 1-1, with 2-1/1-2 merges and deletions."""
    kinds = [(1, 1), (2, 1), (1, 2), (1, 0), (0, 1)]
    probs = [0.875, 0.1, 0.015, 0.005, 0.005]
    blocks, i, j = [], 0, 0
    while i < n_src or j < n_tgt:
        dx, dy = kinds[rng.choice(len(kinds), p=probs)]
        if i + dx > n_src or j + dy > n_tgt:
            dx, dy = (1, 0) if i < n_src else (0, 1)
        blocks.append((list(range(i, i + dx)), list(range(j, j + dy))))
        i, j = i + dx, j + dy
    return blocks


def write_synthetic_pair(root, n_src=N_SRC, n_tgt=N_TGT, dim=1024, seed=0, n_ignore=0,
                         stem=STEM):
    """Write one synthetic document pair in the stage-5.4 input layout:
    ``root/metadata.tsv``, ``segments/{lang}/``, ``cat_segs/{lang}/``
    (concat lines for overlaps up to 5, as ``-a 6`` reads), ``embeds/{lang}/``
    (stopes ``.embed``: fp16 .npy rows) and, when ``n_ignore`` > 0,
    ``ignore/{src}-{tgt}/`` untranslated-concat ids. Overlap embeddings
    are noisy sums of per-segment content vectors built from a planted
    monotone alignment. ``stem`` names the pair's files; the metadata file
    is rewritten to hold this pair alone (``paths["audio"]`` is its line's
    two entries). Returns (paths dict, planted alignment)."""
    from svecalign_tpu_torch.utils.embedding_utils import write_stopes_embedding

    max_overlaps, noise = 5, 0.5
    rng = np.random.default_rng(seed)
    root = Path(root)
    blocks = _plant_alignment(rng, n_src, n_tgt)
    content = [np.zeros((n_src, dim), np.float32), np.zeros((n_tgt, dim), np.float32)]
    for xs, ys in blocks:
        # a block's meaning is a sum of parts: the side with more segments
        # says one part per segment, the other side says them all at once
        parts = rng.standard_normal((max(len(xs), len(ys)), dim)).astype(np.float32)
        for side, ids in ((0, xs), (1, ys)):
            for k, seg in enumerate(ids):
                content[side][seg] = parts[k] if len(ids) > 1 else parts.sum(0)
    paths = {"root": root, "metadata": root / "metadata.tsv"}
    audio = []
    for side, (lang, n) in enumerate(((SRC_LANG, n_src), (TGT_LANG, n_tgt))):
        name = f"{stem}_{lang}"
        audio.append(f"raw_audios/{lang}/{name}.ogg")
        durs = rng.integers(16000, 200000, n)
        gaps = rng.integers(800, 16000, n)
        starts = np.cumsum(gaps + np.concatenate([[0], durs[:-1]]))
        ends = starts + durs
        seg_lines = [f"{s} {e}\n" for s, e in zip(starts, ends)]
        cat_lines, rows = [], []
        for i in range(n):
            for j in range(i, min(n, i + max_overlaps)):
                cat_lines.append(f"{starts[i]} {ends[j]}\n")
                # an overlap's embedding: its unit meaning plus noise
                v = content[side][i:j + 1].sum(0)
                v = v / np.linalg.norm(v)
                rows.append(v + noise / np.sqrt(dim) * rng.standard_normal(dim).astype(np.float32))
        for kind, lines in (("segments", seg_lines), ("cat_segs", cat_lines)):
            d = root / kind / lang
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{name}.txt").write_text("".join(lines), encoding="utf-8")
        d = root / "embeds" / lang
        d.mkdir(parents=True, exist_ok=True)
        write_stopes_embedding(np.stack(rows), str(d / f"{name}.embed"), fp16=True)
        if n_ignore:
            d = root / "ignore" / f"{SRC_LANG}-{TGT_LANG}"
            d.mkdir(parents=True, exist_ok=True)
            ign = sorted({(int(i), int(i) + int(k)) for i, k in zip(
                rng.integers(0, n - max_overlaps, n_ignore),
                rng.integers(0, max_overlaps, n_ignore))})
            tag = "src" if side == 0 else "tgt"
            (d / f"{stem}_{SRC_LANG}-{stem}_{TGT_LANG}.{tag}.txt").write_text(
                "".join(f"{i} {j}\n" for i, j in ign), encoding="utf-8")
    paths["audio"] = tuple(audio)
    paths["metadata"].write_text("\t".join(audio) + "\n", encoding="utf-8")
    return paths, blocks


def write_synthetic_corpus(root, sizes, dim=1024, seed=100, n_ignore=0):
    """Write one pair per (n_src, n_tgt) of ``sizes`` into one stage-5.4
    input tree (stems ``{STEM}-00``, ``-01``, ...; seeds ``seed``,
    ``seed + 1``, ...) and a metadata file that lists them all. Returns
    (paths dict, [stem], [planted alignment])."""
    stems, planted, lines = [], [], []
    for k, (n_src, n_tgt) in enumerate(sizes):
        stems.append(f"{STEM}-{k:02d}")
        paths, blocks = write_synthetic_pair(root, n_src, n_tgt, dim, seed + k, n_ignore,
                                             stem=stems[-1])
        planted.append(blocks)
        lines.append("\t".join(paths["audio"]) + "\n")
    paths["metadata"].write_text("".join(lines), encoding="utf-8")
    return paths, stems, planted


def cli_argv(paths, out_dir, device, extra=()):
    """argv of the stage-5.4 CLI for a pair written by write_synthetic_pair."""
    root = paths["root"]
    argv = [
        str(paths["metadata"]), str(out_dir),
        "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG,
        "--seg_dir", str(root / "segments"), "--concat_dir", str(root / "cat_segs"),
        "--embed_dir", str(root / "embeds"), "--is_stopes_embed",
        "-a", "6", "--device", device,
    ]
    if (root / "ignore").exists():
        argv += ["--ign_indices_dir", str(root / "ignore")]
    return argv + list(extra)


def output_path(out_dir, stem=STEM):
    return Path(out_dir) / f"{SRC_LANG}-{TGT_LANG}" / f"{stem}_{SRC_LANG}-{stem}_{TGT_LANG}.txt"


# ---------------------------------------------------------------------------
# Phase helpers
# ---------------------------------------------------------------------------


def _log(msg):
    print(msg, flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _cuda_time_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_time_ms(fn, reps=20, replays=5):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call work (argument checks, allocation, launch) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def _random_band_problem(rng, sizes, types, w2, device, a_pad=0):
    """Batched banded-DP inputs for pairs of (n, m) sizes on random
    monotone search paths, padded to one A (the longest path, or ``a_pad``
    if that is longer) as the batched aligner pads them; costs in quarter
    steps and pen = 0.5 force exact ties."""
    import torch

    from svecalign_tpu_torch.ops import costs as costs_ops
    from svecalign_tpu_torch.ops import dp as dp_ops

    T, B = len(types), 2 * w2
    probs = []
    for n, m in sizes:
        steps = np.array([0] * n + [1] * m)
        rng.shuffle(steps)
        ys = np.concatenate([[0], np.cumsum(steps)])
        xs = np.arange(len(ys)) - ys
        b_off = costs_ops.path_to_band_offsets(list(zip(xs, ys)), w2)
        cost = np.round(rng.uniform(0, 2, (T, len(b_off), B)) * 4) / 4
        probs.append((cost.astype(np.float32), b_off, n, m))
    P = len(sizes)
    A = max(a_pad, max(c.shape[1] for c, *_ in probs))
    costs = np.full((P, T, A, B), np.inf, np.float32)
    boff_in = np.zeros((P, A), np.int32)
    boff_out = np.zeros((P, A + 2), np.int32)
    for i, (cost, b_off, n, m) in enumerate(probs):
        a = cost.shape[1]
        costs[i, :, :a] = cost
        boff_in[i, :a] = b_off
        boff_in[i, a:] = b_off[-1]
        boff_out[i] = dp_ops.extend_band_offsets(boff_in[i])

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return (
        dev(costs), dev(boff_in), dev(boff_out),
        tuple(x for x, _ in types), tuple(y for _, y in types),
        dev(np.full(P, 0.5, np.float32)),
        dev([n for n, _ in sizes], torch.int32), dev([m for _, m in sizes], torch.int32),
    )


def _compare_planes(got, want):
    """xp/yp equal, csum bit-equal (else finite masks equal and max
    relative difference under 1e-6). Returns the max abs csum error."""
    import torch

    csum_g, xp_g, yp_g = got
    csum_w, xp_w, yp_w = want
    if not (torch.equal(xp_g, xp_w) and torch.equal(yp_g, yp_w)):
        n_bad = int((xp_g != xp_w).sum() + (yp_g != yp_w).sum())
        raise AssertionError(f"backpointers differ in {n_bad} cells")
    if torch.equal(csum_g, csum_w):
        return 0.0
    fin = torch.isfinite(csum_w)
    if not torch.equal(torch.isfinite(csum_g), fin):
        raise AssertionError("csum finite masks differ")
    diff = (csum_g[fin] - csum_w[fin]).abs()
    rel = float((diff / csum_w[fin].abs().clamp(min=1e-30)).max())
    _log(f"    csum not bit-equal: max relative difference {rel:.3e}")
    if rel >= 1e-6:
        raise AssertionError(f"csum relative difference {rel} >= 1e-6")
    return float(diff.max())


DEFAULT_TYPES = [(x, y) for x in range(1, 6) for y in range(1, 6) if x + y <= 6]

MANY_TO_ONE_TYPES = [(k, 1) for k in range(1, 51)]
P8_SIZES = [(300 + 7 * k, 290 - 5 * k) for k in range(8)]
# 64 pairs of mixed sizes, padded to the longest as a bucket is
P64_SIZES = [(120 + (37 * k) % 200, 110 + (53 * k) % 190) for k in range(64)]

# (name, pair sizes, types, width_over2, route it must take): every
# geometry the TPU kernel admits, at the main path's shapes where the main
# path has them, and the edges of the warp route (B <= 32): 4-byte copies
# (B = 6, and a misaligned cost tensor), fewer steps than cost stages,
# padding rows, the counts of type quads a lane group that its kernels are
# unrolled for (1, 3, 5) and others, which its loop kernel takes, with the
# types split over two half-warps (B <= 16) and not, int32 backpointers, the
# first B past a warp, and T = 50 with its large stages
KERNEL_CASES = [
    ("default P=1 (T=15, B=16, K=6)", [(1200, 1100)], DEFAULT_TYPES, 8, "warp"),
    ("default P=8", P8_SIZES, DEFAULT_TYPES, 8, "warp"),
    ("default P=64, mixed sizes", P64_SIZES, DEFAULT_TYPES, 8, "warp"),
    ("coarse (T=1, K=2)", [(600, 550)], [(1, 1)], 8, "warp"),
    ("three types (T=3, one quad a half-warp)", [(310, 290)], [(1, 1), (1, 2), (2, 1)], 8, "warp"),
    ("ten types (T=10, two quads a half-warp: loop kernel)", [(250, 260)], DEFAULT_TYPES[:10], 8, "warp"),
    ("twelve types at B=32 (four quads: loop kernel)", [(240, 200)], DEFAULT_TYPES[:12], 16, "warp"),
    ("a full warp (B=32, five quads)", [(400, 380), (90, 130)], DEFAULT_TYPES, 16, "warp"),
    ("narrowest band (B=6, 4-byte copies)", [(200, 190), (50, 61)], DEFAULT_TYPES, 3, "warp"),
    ("misaligned costs (B=16, 4-byte copies)", [(210, 205)], DEFAULT_TYPES, 8, "warp"),
    ("tiny pairs (3, 2) and (1, 1)", [(3, 2), (1, 1)], DEFAULT_TYPES, 8, "warp"),
    ("one tiny pair (1, 1)", [(1, 1)], [(1, 1)], 3, "warp"),
    ("int32 backpointers (a type offset of 130)", [(300, 20)], [(1, 1), (130, 1)], 8, "warp"),
    ("first band past a warp (B=34)", [(300, 280)], DEFAULT_TYPES, 17, "block"),
    ("wide band (B=140, K=3)", [(500, 450), (420, 470)], [(1, 1), (1, 2), (2, 1)], 70, "block"),
    ("many-to-one narrow (T=50, K=51, B=32)", [(300, 120), (100, 40)], MANY_TO_ONE_TYPES, 16, "warp"),
    ("many-to-one narrow (T=50, K=51, B=16, half-warps)", [(280, 100)], MANY_TO_ONE_TYPES, 8, "warp"),
    ("many-to-one (T=50, K=51)", [(300, 120)], MANY_TO_ONE_TYPES, 30, "block"),
    ("many-to-one wide (ring in global memory)", [(150, 60)], MANY_TO_ONE_TYPES, 600, "block"),
]


def _ragged(rng, n, lo, hi, zeros=0):
    lens = rng.integers(lo, hi + 1, n)
    lens[:zeros] = 0
    return tuple(int(x) for x in lens)


_ARNG = np.random.default_rng(77)
# (name, B, H, T, lengths (None: all T valid), left, right): the four
# geometries of the tests, the asymmetric clip, a ragged chunk with
# padding-only rows, chunks of the main path's 700-, 1400- and 2000-frame
# buckets (T = 350, 700 and 1000 after stacking), the 200-frame bucket with
# short rows, a T that is no multiple of a tile with the last batch row
# ragged, lengths that are whole key tiles, the asymmetric clip with
# lengths, and the long buckets (3000, 4500 and 6000 frames: T = 1500,
# 2250 and 3000; spans of 20-60 s) with ragged lengths and a length-0
# row, at few batch rows (the plain version's fp32 scores are
# B x H x T^2)
ATTN_CASES = [
    ("test geometry B=2 H=4 T=200", 2, 4, 200, (200, 150), 64, 8),
    ("test geometry B=1 H=2 T=128", 1, 2, 128, (128,), 64, 8),
    ("test geometry B=1 H=2 T=300", 1, 2, 300, (300,), 64, 8),
    ("test geometry B=2 H=2 T=384", 2, 2, 384, (384, 40), 64, 8),
    ("asymmetric clip (16, 4), no lengths", 1, 2, 260, None, 16, 4),
    ("ragged chunk B=16 with length-0 rows", 16, 16, 350, _ragged(_ARNG, 16, 1, 350, 3), 64, 8),
    ("main-path chunk B=16 H=16 T=350", 16, 16, 350, _ragged(_ARNG, 16, 250, 350), 64, 8),
    ("main-path chunk B=16 H=16 T=700", 16, 16, 700, _ragged(_ARNG, 16, 500, 700), 64, 8),
    ("main-path chunk B=16 H=16 T=1000", 16, 16, 1000, _ragged(_ARNG, 16, 700, 1000), 64, 8),
    ("main-path chunk B=16 H=16 T=100, lengths 20-100", 16, 16, 100, _ragged(_ARNG, 16, 20, 100), 64, 8),
    ("T=130, last batch row ragged", 3, 4, 130, (130, 130, 77), 64, 8),
    ("lengths of whole key tiles (128, 256)", 2, 4, 300, (128, 256), 64, 8),
    ("clip (16, 4), C=21, with lengths", 2, 4, 200, (200, 133), 16, 4),
    ("long bucket B=2 H=16 T=1500", 2, 16, 1500, _ragged(_ARNG, 2, 1000, 1500), 64, 8),
    ("long bucket B=2 H=16 T=2250", 2, 16, 2250, _ragged(_ARNG, 2, 1500, 2250), 64, 8),
    ("long bucket B=3 H=16 T=3000 with a length-0 row", 3, 16, 3000,
     _ragged(_ARNG, 2, 2000, 3000) + (0,), 64, 8),
]
# |kernel - plain| <= atol + rtol |plain| on valid rows. fp32: the tests'
# tolerance (summation order and FMA only). bf16: about one bf16 step of
# the output, which both round to, after probabilities rounded to bf16 at
# different points (the kernel before normalising, as the TPU kernel does)
ATTN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}


def attention_inputs(rng, B, H, T, lens, left, right, dtype, device):
    """Seeded (q, k, v, table, lengths) for rel-key attention."""
    import torch

    def t(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    q, k, v = (t(B, T, H, 64) for _ in range(3))
    table = t(left + right + 1, 64, scale=0.02)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k, v, table, lengths


def compare_attention(got, want, lengths, dtype_name):
    """Max abs error on valid rows; raises when a row is not finite or the
    error passes ATTN_TOL."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    B, T = got.shape[:2]
    valid = torch.ones((B, T), dtype=torch.bool, device=got.device)
    if lengths is not None:
        valid = torch.arange(T, device=got.device)[None, :] < lengths[:, None].long()
    g, w = got.float()[valid], want.float()[valid]
    if g.numel() == 0:
        return 0.0
    atol, rtol = ATTN_TOL[dtype_name]
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        # where the misses are: (batch row, time step) of the valid rows, head, column
        idx = valid.nonzero()[bad.any(-1).any(-1).nonzero()[:, 0]]
        raise AssertionError(
            f"max abs err {float(err.max())} over atol {atol} + rtol {rtol}: "
            f"{int(bad.sum())} of {bad.numel()} values, in {idx.shape[0]} rows, first "
            f"(b, t) {idx[:4].tolist()}; heads {bad.any(-1).any(0).nonzero()[:, 0].tolist()[:8]}, "
            f"columns {bad.any(1).any(0).nonzero()[:, 0].tolist()[:16]}")
    return float(err.max())


def phase_attention_checks(device):
    """relkey_attention kernel against its plain version on the card, in
    fp32 and bf16, in every geometry of ATTN_CASES. Returns the max abs
    error on valid rows."""
    import torch

    from svecalign_tpu_torch.ops import attention, attention_cuda

    for C in (21, 73, 128):
        smem, ctas = attention_cuda.bf16_occupancy(C)
        _log(f"[check] relkey_attention bf16 kernel with a {C}-row table: {smem} bytes of dynamic "
             f"shared memory, {ctas} CTAs per SM")
    rng = np.random.default_rng(4321)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, B, H, T, lens, left, right in ATTN_CASES:
            args = attention_inputs(rng, B, H, T, lens, left, right, dtype, device)
            got = attention_cuda.relkey_attention_cuda(*args, left=left, right=right)
            torch.cuda.synchronize()
            want = attention.relkey_attention(*args, left=left, right=right)
            err = compare_attention(got, want, args[4], dname)
            max_err = max(max_err, err)
            _log(f"[check] relkey_attention {dname} {name}: ok (max abs err {err:.3e})")
    return max_err


# The LayerNorm kernel at the main path's shapes: (name, memory shape,
# axis, view, in dtype, out dtype, conv bias and GELU fused)
NORM_TIMES = (
    ("extractor layer 0, a 600 s group (75 x 512 x 12799)", (75, 512, 12799), 1, None,
     "bfloat16", "bfloat16", True),
    ("extractor layer 0 without the bias and GELU (the epilogue's cost)", (75, 512, 12799), 1,
     None, "bfloat16", "bfloat16", False),
    ("post_extract_norm, a 600 s chunk (150 x 199 x 512)", (150, 512, 199), 2, "transpose",
     "bfloat16", "bfloat16", False),
    ("LASER trunk norm, a 600 s chunk (29850 x 1024)", (150, 199, 1024), 2, None,
     "bfloat16", "bfloat16", False),
    ("LASER encoder_norm, fp32 out (29850 x 1024)", (150, 199, 1024), 2, None,
     "bfloat16", "float32", False),
    ("SONAR norm, modal bucket (16 x 250 x 1024)", (16, 250, 1024), 2, None,
     "bfloat16", "bfloat16", False),
    ("SONAR depthwise_layer_norm, modal bucket (16 x 1024 x 250)", (16, 1024, 250), 2,
     "transpose", "bfloat16", "bfloat16", False),
)
# (memory shape, axis, view) of the kernel checks: both layouts and the
# transposed output at the encoders' widths, ragged T, one row
NORM_CHECKS = (
    ((3, 1000, 1024), 2, None), ((1, 77, 160), 2, None), ((2, 40, 512), 2, "slice"),
    ((3, 512, 12799), 1, None), ((1, 512, 3), 1, None), ((2, 1024, 251), 2, "transpose"),
    ((4, 512, 199), 2, "transpose"),
)


def _norm_operands(shape, axis, view, in_dtype, device, seed):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    C = shape[1] if view == "transpose" or axis == 1 else shape[-1]
    x = (2 * torch.randn(shape, device=device, generator=gen) + 0.7).to(in_dtype)
    if view == "transpose":
        x = x.transpose(1, 2)
    elif view == "slice":
        x = x[:, : shape[1] - 5]
    w = 1 + 0.3 * torch.randn(C, device=device, generator=gen)
    b = 0.2 * torch.randn(C, device=device, generator=gen)
    cb = (0.5 * torch.randn(C, device=device, generator=gen)).to(in_dtype)
    return x, w, b, cb


def _bf16_ulps(got, want):
    """The largest gap in bf16 units of the last place over the values
    not within 2^-10 of the output's largest magnitude of zero, infinity
    where any gap passes one unit plus 2^-16 of that magnitude (near zero
    the fp32 statistics' order of summation decides;
    ``tests/test_torch_layer_norm_card.py::bf16_ulps``)."""
    import torch

    g, w = got.float(), want.float()
    a = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7)
    scale = float(w.abs().max())
    gap = (g - w).abs()
    if bool((gap > ulp + scale * 2.0 ** -16).any()):
        return float("inf")
    away = a >= scale * 2.0 ** -10
    return float((gap / ulp)[away].max()) if bool(away.any()) else 0.0


def phase_norm_checks(device):
    """The LayerNorm kernel against its plain version on the card: the
    source's channels-first plan against the wrapper's copy, then every
    NORM_CHECKS geometry in bf16 and fp32 in and out, with and without the
    conv bias and GELU. Returns the largest bf16 gap in ulps and fp32 gap
    (relative to the output's largest value)."""
    import torch

    from svecalign_tpu_torch.ops import layer_norm, layer_norm_cuda

    for C in range(8, layer_norm_cuda.MAX_WIDTH + 1, 8):
        for size in (2, 4):
            if layer_norm_cuda.source_cfirst_plan(C, size) != layer_norm_cuda.cfirst_plan(C, size):
                raise AssertionError(f"layer_norm: the wrapper's plan of C={C}, {size}-byte "
                                     "inputs is not the source's")
    worst_ulps, worst_rel, gelu_equal, n = 0.0, 0.0, 0, 0
    dts = (torch.float32, torch.bfloat16)
    for shape, axis, view in NORM_CHECKS:
        for in_dt in dts:
            for out_dt in dts:
                for with_bias in (False, True):
                    x, w, b, cb = _norm_operands(shape, axis, view, in_dt, device, n)
                    args, pre = (x, w, b, 1e-5, axis), cb if with_bias else None
                    got = layer_norm_cuda.flax_layer_norm_cuda(*args, out_dt, pre)
                    got_gelu = layer_norm_cuda.flax_layer_norm_cuda(*args, out_dt, pre, True)
                    torch.cuda.synchronize()
                    want = layer_norm.flax_layer_norm(*args, axis, out_dt, pre)
                    n += 1
                    what = f"{tuple(x.shape)} axis {axis} {in_dt}->{out_dt} bias={with_bias}"
                    if not (torch.isfinite(got).all() and torch.isfinite(got_gelu).all()):
                        raise AssertionError(f"layer_norm {what}: not finite")
                    if out_dt == torch.bfloat16:
                        ulps = _bf16_ulps(got, want)
                        worst_ulps = max(worst_ulps, ulps)
                        if ulps > 1.0:
                            raise AssertionError(f"layer_norm {what}: {ulps} bf16 ulps")
                    else:
                        rel = float((got - want).abs().max() / want.abs().max())
                        worst_rel = max(worst_rel, rel)
                        if rel > 1e-5:
                            raise AssertionError(f"layer_norm {what}: fp32 gap {rel:.3e}")
                    # the epilogue against PyTorch's GELU of the kernel's own output
                    gap = (got_gelu.float() - layer_norm.gelu(got).float()).abs()
                    gelu_equal += int(not bool(gap.any()))
                    if float((gap / got_gelu.float().abs().clamp_min(1e-30)).max()) > 2 ** -7:
                        raise AssertionError(f"layer_norm {what}: the GELU epilogue is off")
    _log(f"[check] layer_norm: {n} cases ok (bf16 outputs within {worst_ulps:.2f} ulp, "
         f"fp32 within {worst_rel:.2e} relative; the GELU epilogue bit-equal to PyTorch's in "
         f"{gelu_equal} of {n})")
    return worst_ulps, worst_rel


def phase_norm_times(device):
    """Device ms a launch of the LayerNorm kernel and of its plain version
    (both as CUDA-graph replays) at NORM_TIMES' shapes, beside the bytes
    bound at 3.35 TB/s (x read once, the output written once, the C-wide
    operands). Returns the rows."""
    import torch
    import torch.nn.functional as F

    from svecalign_tpu_torch.ops import layer_norm, layer_norm_cuda

    rows = []
    for name, shape, axis, view, in_name, out_name, fused in NORM_TIMES:
        in_dt, out_dt = getattr(torch, in_name), getattr(torch, out_name)
        x, w, b, cb = _norm_operands(shape, axis, view, in_dt, device, 0)
        pre = cb if fused else None
        C = x.shape[axis]
        kernel = lambda: layer_norm_cuda.flax_layer_norm_cuda(x, w, b, 1e-6, axis, out_dt, pre,
                                                              fused)
        plain = lambda: layer_norm.flax_layer_norm(x, w, b, 1e-6, axis, axis, out_dt, pre, fused)
        reps = 20 if x.numel() < 1e8 else 4
        ms = _graph_time_ms(kernel, reps=reps)
        plain_ms = _graph_time_ms(plain, reps=max(1, reps // 4), replays=3)
        library_ms = None
        if view is None and axis == x.dim() - 1:
            # PyTorch's own LayerNorm over the last axis (two-pass variance;
            # the port never calls it): the yardstick of the rows route
            wl, bl = w.to(in_dt), b.to(in_dt)
            library_ms = _graph_time_ms(lambda: F.layer_norm(x, (C,), wl, bl, 1e-6), reps=reps)
        moved = x.numel() * (in_dt.itemsize + out_dt.itemsize) + C * (8 + in_dt.itemsize)
        bound_ms = moved / 3.35e12 * 1e3
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "gb_per_s": moved / ms * 1e-6})
        library = "" if library_ms is None else f", F.layer_norm {library_ms:.4f} ms"
        _log(f"[time] layer_norm {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms{library}), bound "
             f"{bound_ms:.4f} ms by bytes ({moved / 1e6:.1f} MB), {moved / ms * 1e-6:.0f} GB/s, "
             f"{bound_ms / ms:.1%} of the bound")
    return rows


def phase_build():
    from svecalign_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    _log(f"[build] {len(logs)} kernel(s) in {time.perf_counter() - t0:.1f}s")
    for name, out in logs.items():  # registers, stack and spills per kernel function
        for line in out.splitlines():
            if any(key in line for key in ("ptxas", "spill", "stack frame")) or "error" in line.lower():
                _log(f"    {name}: {line.strip()}")


def _misalign(t):
    """The same values in storage that starts 4 bytes past a 16-byte
    boundary (contiguous, as the wrapper requires)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


def _route_taken(dp_cuda, before):
    """The route of the one launch since ``before`` (a copy of LAUNCHES)."""
    took = [r for r in dp_cuda.ROUTES
            if dp_cuda.LAUNCHES[f"banded_dp_{r}"] != before[f"banded_dp_{r}"]]
    if len(took) != 1 or dp_cuda.LAUNCHES["banded_dp"] != before["banded_dp"] + 1:
        raise AssertionError(f"one launch expected, counts went {before} -> {dp_cuda.LAUNCHES}")
    return took[0]


def phase_kernel_checks(device):
    import torch

    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.ops import dp_cuda

    lib = dp_cuda._lib()
    if lib.banded_dp_warp_stages() != dp_cuda.WARP_STAGES:
        raise AssertionError("the wrapper's WARP_STAGES is not the source's DP_STAGES")
    rng = np.random.default_rng(1234)
    max_err = 0.0
    for name, sizes, types, w2, want_route in KERNEL_CASES:
        args = _random_band_problem(rng, sizes, types, w2, device)
        if "misaligned" in name:
            args = (_misalign(args[0]),) + args[1:]
        P, T, A, B = args[0].shape
        K = dp_ops.dp_types(args[3], args[4])[2]
        smem = dp_cuda.warp_smem_bytes(B, K, T, A, T + 2)
        if lib.banded_dp_warp_smem_bytes(B, K, T, A, T + 2) != smem:
            raise AssertionError("the wrapper's and the source's warp shared-memory sizes differ")
        want = dp_ops.banded_dp_batched(*args)
        # the route the shape gives, then (where that is the warp route)
        # the block kernel forced on the same inputs
        for forced in (None, "block") if want_route == "warp" else (None,):
            before = dict(dp_cuda.LAUNCHES)
            got = dp_cuda.banded_dp_cuda_batched(*args, route=forced)
            torch.cuda.synchronize()
            route = _route_taken(dp_cuda, before)
            if route != (forced or want_route):
                raise AssertionError(f"{name}: took the {route} route, want {forced or want_route}")
            err = _compare_planes(got, want)
            max_err = max(max_err, err)
            _log(f"[check] banded_dp {name}: P={P} T={T} A={A} B={B} K={K} {route} route"
                 + (f" ({smem} bytes of shared memory)" if route == "warp" else "")
                 + (" (forced)" if forced else "") + f" ok (max abs err {err})")
        _check_banded_walk(name, got, args[2], args[6], args[7])
    phase_walk_checks(device)
    return max_err


def _max_abs_diff(got, want):
    """Largest |got - want| over the cells where ``want`` is finite."""
    import torch

    fin = torch.isfinite(want.double())
    if not bool(fin.any()):
        return 0.0
    return float((got.double()[fin] - want.double()[fin]).abs().max())


def _assert_all_equal(what, got, want):
    """Every emitted array equal to the plain version's in dtype and value.
    Returns the measured max abs difference over all of them (0.0 where it
    does not raise)."""
    import torch

    err = max(_max_abs_diff(g, w) for g, w in zip(got, want))
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: emitted array {k} differs from the plain version's "
                                 f"(max abs difference over all arrays {err})")
    return err


def _check_banded_walk(name, planes, boff_out, x_sizes, y_sizes):
    """The banded walk kernel on a banded DP's planes: every emitted array
    equal to the plain walk's, and the alignments and scores rebuilt from
    the path equal to the host walk's on the pulled planes."""
    import torch

    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.ops import traceback_cuda
    from svecalign_tpu_torch.vecalign.traceback import (
        sparse_alignments_from_steps, sparse_traceback)

    got = traceback_cuda.banded_traceback_walk_cuda(*planes, boff_out, x_sizes, y_sizes)
    torch.cuda.synchronize()
    want = dp_ops.banded_traceback_walk(*planes, boff_out, x_sizes, y_sizes)
    _assert_all_equal(f"banded_traceback_walk {name}", got, want)
    steps = [t.cpu().numpy() for t in got]
    csum, xp, yp = (t.cpu().numpy() for t in planes)
    for i in range(xp.shape[0]):
        a_dev, s_dev = sparse_alignments_from_steps(*(t[i] for t in steps))
        a_host, s_host = sparse_traceback(
            csum[i].astype(np.float64), xp[i], yp[i], boff_out[i].cpu().numpy(),
            int(x_sizes[i]), int(y_sizes[i]))
        if a_dev != a_host or not np.array_equal(s_dev, s_host):
            raise AssertionError(f"banded_traceback_walk {name}: pair {i} differs from the host walk")
    _log(f"[check] banded_traceback_walk {name}: P={xp.shape[0]} steps={xp.shape[1]} "
         f"{xp.dtype} pointers: five arrays equal, alignments and scores equal to the host walk's")


P32_SIZES = P64_SIZES[:32]
# (name, pair sizes, types, width_over2, a_pad): the banded walk's edges
# beyond KERNEL_CASES' planes: a ring that wraps several times (A2 far over
# the ring's 1024 rows of B = 16), int32 planes over a long band, a walk
# that reaches the origin in a handful of steps beside a long one (a long
# tail), the buckets of 1, 8, 32 and 64 pairs of the main path's band, a
# band of one row a chunk (B = 1200), and a walk longer than the records
# that shared memory holds
WALK_CASES = [
    ("a ring that wraps five times (A2 = 6002, B = 16)", [(3100, 2900)], DEFAULT_TYPES, 8, 0),
    ("int32 planes over a long band (a type offset of 130)", [(1500, 60)],
     [(1, 1), (130, 1)], 8, 0),
    ("a walk of a handful of steps and a long tail", [(2000, 1900), (3, 2)], DEFAULT_TYPES, 8, 0),
    ("P = 1 at the main path's band", [(1200, 1100)], DEFAULT_TYPES, 8, 0),
    ("P = 8 padded past the longest pair", P8_SIZES, DEFAULT_TYPES, 8, 700),
    ("P = 32", P32_SIZES, DEFAULT_TYPES, 8, 0),
    ("P = 64", P64_SIZES, DEFAULT_TYPES, 8, 0),
    ("a chunk of one row (B = 1200)", [(200, 150)], [(1, 1), (1, 2), (2, 1)], 600, 0),
    ("a walk past the shared-memory records (over 16384 steps)", [(17000, 16800)], [(1, 1)],
     8, 0),
]
# (name, what is done to the first case's planes or sizes) for the steps
# whose successor is no band cell of a lower row: the walker follows them
# from device memory, clamped, as the plain version does
WALK_FAULTS = [
    ("an unreached cell's pointers (-42) mid-path", "neg"),
    ("zero pointers mid-path (the walk stays there)", "zero"),
    ("pointers that move up a row mid-path", "up"),
    ("a start past the band's last lane", "start_b"),
    ("a start past the last row", "start_a"),
]


def _walk_fault(kind, planes, boff_out, x_sizes, y_sizes):
    """Planes and sizes with one fault of WALK_FAULTS put in at the middle
    step of each pair's plain walk."""
    from svecalign_tpu_torch.ops import dp as dp_ops

    csum, xp, yp = (t.clone() for t in planes)
    x_sizes, y_sizes = x_sizes.clone(), y_sizes.clone()
    if kind == "start_b":
        y_sizes += xp.shape[2]
        x_sizes -= xp.shape[2]
    elif kind == "start_a":
        x_sizes += xp.shape[1]
    else:
        xs, ys = dp_ops.banded_traceback_walk(csum, xp, yp, boff_out, x_sizes, y_sizes)[:2]
        for i in range(xp.shape[0]):
            taken = int(((xs[i] != 0) | (ys[i] != 0)).sum())
            x, y = int(xs[i, taken // 2]), int(ys[i, taken // 2])
            a = x + y
            b = y - int(boff_out[i, a])
            vx, vy = {"neg": (dp_ops.NEG_BP, dp_ops.NEG_BP), "zero": (0, 0), "up": (-1, 0)}[kind]
            xp[i, a, b], yp[i, a, b] = vx, vy
    return (csum, xp, yp), x_sizes, y_sizes


def phase_walk_checks(device):
    """The banded walk kernel on the planes of WALK_CASES, and on the first
    case's planes with each fault of WALK_FAULTS: all five arrays equal to
    the plain walk's (and, without faults, the alignments to the host
    walk's); the wrapper's ring plan equal to the source's over the shapes
    of both and a band too wide for it refused by both."""
    import ctypes

    import torch

    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.ops import dp_cuda, traceback_cuda

    lib = traceback_cuda._lib()
    optin = dp_cuda._smem_optin(device.index or 0)
    plan = (ctypes.c_int * 5)()
    for a2, B in ((2693, 16), (6002, 16), (2, 6), (974, 140), (212, 1200), (50, 1 << 14),
                  (50, 1 << 15), (50, 1 << 16), (40000, 16)):
        refused = lib.banded_walk_plan(a2, B, optin, plan)
        try:
            want = tuple(traceback_cuda.banded_walk_plan(a2, B, optin))
        except ValueError:
            want = None
        if (want is None) != bool(refused) or (want is not None and tuple(plan) != want):
            raise AssertionError(f"banded_walk_plan({a2}, {B}): the source gives "
                                 f"{tuple(plan)} (refused {refused}), the wrapper {want}")
    # the wrapper raises, launching nothing, where the source's plan refuses
    wide = torch.zeros((1, 3, 1 << 16), dtype=torch.int8, device=device)
    ones = torch.ones(1, dtype=torch.int32, device=device)
    before = traceback_cuda.LAUNCHES["banded_traceback_walk"]
    try:
        traceback_cuda.banded_traceback_walk_cuda(
            wide.float(), wide, wide, torch.zeros((1, 3), dtype=torch.int32, device=device),
            ones, ones)
    except ValueError as e:
        _log(f"[check] banded_traceback_walk, a band of 2**16 lanes: refused ({e})")
    else:
        raise AssertionError("banded_traceback_walk_cuda took a band of 2**16 lanes")
    if traceback_cuda.LAUNCHES["banded_traceback_walk"] != before:
        raise AssertionError("banded_traceback_walk_cuda counted a launch it refused")
    rng = np.random.default_rng(97531)
    first = None
    for name, sizes, types, w2, a_pad in WALK_CASES:
        args = _random_band_problem(rng, sizes, types, w2, device, a_pad=a_pad)
        planes = dp_cuda.banded_dp_cuda_batched(*args)
        wplan = traceback_cuda.banded_walk_plan(planes[1].shape[1], planes[1].shape[2], optin)
        _check_banded_walk(f"{name} ({wplan.slots} slots of {1 << wplan.chunk_shift} rows)",
                           planes, args[2], args[6], args[7])
        first = first or (planes, args[2], args[6], args[7])
    planes, boff_out, x_sizes, y_sizes = first
    for name, kind in WALK_FAULTS:
        f_planes, f_x, f_y = _walk_fault(kind, planes, boff_out, x_sizes, y_sizes)
        got = traceback_cuda.banded_traceback_walk_cuda(*f_planes, boff_out, f_x, f_y)
        torch.cuda.synchronize()
        _assert_all_equal(f"banded_traceback_walk {name}", got,
                          dp_ops.banded_traceback_walk(*f_planes, boff_out, f_x, f_y))
        _log(f"[check] banded_traceback_walk {name}: five arrays equal to the plain walk's")


P8_DENSE_SIZES = [(300 - 17 * k, 275 - 11 * ((5 * k) % 8)) for k in range(8)]
# (name, pair sizes; the bucket is padded to the largest of each side):
# the main path's 300 x 275, N != M either way, a side of 1, the smallest
# pair, a side longer than a block has threads, a diagonal longer than a
# block has threads (looped over), and a ragged bucket with distinct pens
DENSE_CASES = [
    ("300 x 275 (the main path's, P = 1)", [(300, 275)]),
    ("N < M", [(40, 57)]),
    ("N > M", [(130, 31)]),
    ("N = 1", [(1, 30)]),
    ("M = 1", [(30, 1)]),
    ("(1, 1)", [(1, 1)]),
    ("a side over the block's threads (1500 x 40)", [(1500, 40)]),
    ("a diagonal over the block's threads (1100 x 1300)", [(1100, 1300)]),
    ("P = 8, ragged sizes, distinct pens", P8_DENSE_SIZES),
    ("P = 3 with an empty side and a (1, 1)", [(0, 7), (1, 1), (12, 9)]),
    ("off the strip width, n <= m (97 x 131)", [(97, 131)]),
    ("off the strip width, n > m (131 x 97)", [(131, 97)]),
    ("one strip and one row over (33 x 200)", [(33, 200)]),
    ("strips past the last warp, n > m (800 x 530)", [(800, 530)]),
    ("both orientations in one bucket", [(40, 97), (97, 40), (64, 64), (1, 200), (200, 1)]),
    ("empty sides, P = 3", [(0, 0), (9, 0), (0, 33)]),
]


def _dense_problem(rng, sizes, device, ties=True, pad=(0, 0)):
    """A bucket's dense-DP inputs: costs (P, N, M) padded to the largest
    pair (or to ``pad`` where that is larger), distinct pens, sizes. Costs
    in quarter steps and pens in eighths make exact ties common."""
    import torch

    P = len(sizes)
    N, M = max(pad[0], max(n for n, _ in sizes)), max(pad[1], max(m for _, m in sizes))
    costs = rng.uniform(0, 2, (P, N, M)).astype(np.float32)
    pens = rng.uniform(0.2, 0.9, P).astype(np.float32)
    if ties:
        costs, pens = np.round(costs * 4) / 4, np.round(pens * 8) / 8
    return (torch.from_numpy(costs).to(device), torch.from_numpy(pens).to(device),
            torch.tensor([n for n, _ in sizes], dtype=torch.int32, device=device),
            torch.tensor([m for _, m in sizes], dtype=torch.int32, device=device))


# (name, kind) of the dense walk's checks beyond the planes the dense DP
# writes. Each kind up to "origin" is put into every DENSE_CASES bucket's
# planes or starts, on each pair's plain walk (at its middle step where it
# is a cell's): pointers that do not move, moves clamped at row 0 and column
# 0, starts clamped into the plane. The rest are planes of their own: one of
# several MB (the ring reused many times over), a walk longer than the
# records shared memory holds, and a bucket of 64 pairs.
DENSE_WALK_FAULTS = [
    ("a pointer of 3 at the middle step", "p3"),
    ("a pointer of 4 at the middle step", "p4"),
    ("a pointer of -1 at the middle step", "pm1"),
    ("a pointer of 127 at the middle step", "p127"),
    ("a pointer of -128 at the middle step", "m128"),
    ("up on a row-0 cell (up a column to row 0)", "up_row0"),
    ("left on a column-0 cell (left along a row to column 0)", "left_col0"),
    ("diag at (1, 0) (up column 0 to it)", "diag_10"),
    ("diag down column 0", "diag_col0"),
    ("diag along row 0 (the origin's pointer 0)", "diag_row0"),
    ("starts past N", "start_n"),
    ("starts past M", "start_m"),
    ("negative starts", "start_neg"),
    ("a start at (0, 0)", "origin"),
    ("a plane of several MB (2000 x 3000, P = 2)", "plane_mb"),
    ("a walk past the shared-memory records (90000 x 1)", "long"),
    ("P = 64", "p64"),
]
DENSE_WALK_OWN_PLANES = ("plane_mb", "long", "p64")


def _dense_walk_fault(kind, bp, x_sizes, y_sizes, walk):
    """A bucket's planes and starts (on the CPU) with one fault of
    DENSE_WALK_FAULTS put in; ``walk`` is their plain walk."""
    b, xs, ys = bp.clone(), x_sizes.clone(), y_sizes.clone()
    if kind == "start_n":
        xs += b.shape[1] + 4
    elif kind == "start_m":
        ys += b.shape[2] + 6
    elif kind == "start_neg":
        xs[0::2] = -3
        ys[1::2] = -5
    elif kind == "origin":
        xs[:] = 0
        ys[:] = 0
    else:
        px, py, _ = walk
        for i in range(b.shape[0]):
            taken = int(((px[i] != 0) | (py[i] != 0)).sum())
            if not taken:
                continue
            xm, ym = int(px[i, taken // 2]), int(py[i, taken // 2])
            if kind in ("p3", "p4", "pm1", "p127", "m128"):
                b[i, xm, ym] = {"p3": 3, "p4": 4, "pm1": -1, "p127": 127, "m128": -128}[kind]
            elif kind == "up_row0" and ym > 0:
                b[i, :xm + 1, ym] = 2
            elif kind == "left_col0" and xm > 0:
                b[i, xm, :ym + 1] = 1
            elif kind == "diag_10" and xm > 0:
                b[i, xm, 1:ym + 1] = 1
                b[i, 2:xm + 1, 0] = 2
                b[i, 1, 0] = 0
            elif kind == "diag_col0" and xm > 0:
                b[i, xm, 1:ym + 1] = 1
                b[i, 1:xm + 1, 0] = 0
            elif kind == "diag_row0" and ym > 0:
                b[i, 1:xm + 1, ym] = 2
                b[i, 0, :ym + 1] = 0
    return b, xs, ys


def _dense_walk_plane(kind, rng, device):
    """The planes and starts of an own-plane kind of DENSE_WALK_FAULTS, on
    the CPU: random pointers (0-2 inside, left along row 0 and up column 0,
    as the DP writes them) started at the far corner, or the dense DP's
    planes for 64 pairs of 100-300 segments a side."""
    import torch

    from svecalign_tpu_torch.ops import dense_dp_cuda

    if kind == "p64":
        sizes = [tuple(int(v) for v in rng.integers(100, 301, 2)) for _ in range(64)]
        args = _dense_problem(rng, sizes, device, ties=False)
        _, bp = dense_dp_cuda.dense_dp_cuda(*args)
        return bp.cpu(), args[2].cpu(), args[3].cpu()
    P, N, M = {"plane_mb": (2, 2000, 3000), "long": (1, 90000, 1)}[kind]
    b = rng.choice(np.array([0, 1, 2], dtype=np.int8), (P, N + 1, M + 1), p=[0.4, 0.2, 0.4])
    b[:, 0, :], b[:, :, 0], b[:, 0, 0] = 1, 2, 4
    full = torch.full((P,), 0, dtype=torch.int32)
    return torch.from_numpy(b), full + N, full + M


def phase_dense_checks(device):
    """The dense-DP kernel against dense_dp_batched in every case of
    DENSE_CASES (bp and csum equal exactly, on each pair's rectangle and
    outside it), then the dense walk kernel on those planes against the
    plain walk and the host walk, and on the planes and starts of
    DENSE_WALK_FAULTS against the plain walk (on the CPU); the wrapper's
    ring plan equal to the source's, and planes of 2**31 bytes refused by
    the wrapper. Returns the measured max abs csum error over the finite
    cells of all cases."""
    import torch

    from svecalign_tpu_torch.ops import dense_dp_cuda, traceback_cuda
    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.vecalign.traceback import dense_alignments_from_steps, dense_traceback

    import ctypes

    from svecalign_tpu_torch.ops import dp_cuda

    optin = dp_cuda._smem_optin(device.index or 0)
    lib = dense_dp_cuda._lib()
    plan = (ctypes.c_int * 4)()
    for N, M, limit in ((300, 275, optin), (176, 160, optin), (1100, 1300, optin), (0, 7, optin),
                        (1500, 40, optin), (4000, 4000, optin), (300, 275, 60000),
                        (20, 30, 20000), (131, 97, optin), (800, 530, optin)):
        refused = lib.dense_dp_plan(N, M, limit, plan)
        try:
            want = tuple(dense_dp_cuda.dense_dp_plan(N, M, limit))
        except ValueError:
            want = None
        if (want is None) != bool(refused) or (want is not None and tuple(plan) != want):
            raise AssertionError(f"dense_dp_plan({N}, {M}, {limit}): the source gives "
                                 f"{tuple(plan)} (refused {refused}), the wrapper {want}")
    wlib = traceback_cuda._lib()
    for N, M, limit in ((176, 160, optin), (300, 275, optin), (1100, 1300, optin),
                        (90000, 1, optin), (0, 0, optin), (1500, 40, optin), (2000, 3000, optin),
                        (0, 126976, optin), (0, 126977, optin), (300, 275, 50000),
                        (46340, 46340, optin)):
        refused = wlib.dense_walk_plan(N, M, limit, plan)
        try:
            want = tuple(traceback_cuda.dense_walk_plan(N, M, limit))
        except ValueError:
            want = None
        if (want is None) != bool(refused) or (want is not None and tuple(plan) != want):
            raise AssertionError(f"dense_walk_plan({N}, {M}, {limit}): the source gives "
                                 f"{tuple(plan)} (refused {refused}), the wrapper {want}")
    # the wrapper raises, launching nothing, where the source's plan refuses
    huge = torch.empty((1, 46341, 46341), dtype=torch.int8, device=device)
    ones = torch.ones(1, dtype=torch.int32, device=device)
    before = traceback_cuda.LAUNCHES["dense_traceback_walk"]
    try:
        traceback_cuda.dense_traceback_walk_cuda(huge, ones, ones)
    except ValueError as e:
        _log(f"[check] dense_traceback_walk, a plane of 46341 x 46341: refused ({e})")
    else:
        raise AssertionError("dense_traceback_walk_cuda took a plane of 46341 x 46341")
    if traceback_cuda.LAUNCHES["dense_traceback_walk"] != before:
        raise AssertionError("dense_traceback_walk_cuda counted a launch it refused")
    del huge
    rng = np.random.default_rng(2468)
    max_err = 0.0
    planes = []
    for name, sizes in DENSE_CASES:
        for ties in (True, False):
            args = _dense_problem(rng, sizes, device, ties)
            before = dense_dp_cuda.LAUNCHES["dense_dp"]
            csum, bp = dense_dp_cuda.dense_dp_cuda(*args, with_csum=True)
            none, bp_only = dense_dp_cuda.dense_dp_cuda(*args)
            torch.cuda.synchronize()
            if dense_dp_cuda.LAUNCHES["dense_dp"] != before + 2:
                raise AssertionError("two launches expected")
            want_csum, want_bp = dp_ops.dense_dp_batched(*args)
            if none is not None or not torch.equal(bp_only, bp):
                raise AssertionError(f"dense_dp {name}: the run without csum differs")
            if not torch.equal(bp, want_bp):
                raise AssertionError(f"dense_dp {name}: bp differs in "
                                     f"{int((bp != want_bp).sum())} nodes")
            err = _max_abs_diff(csum, want_csum)
            max_err = max(max_err, err)
            if not torch.equal(csum, want_csum):
                raise AssertionError(f"dense_dp {name}: csum not bit-equal (max abs err {err})")
            P, N, M = args[0].shape
            dplan = dense_dp_cuda.dense_dp_plan(N, M, optin)
            strips = -(-N // (32 * dplan.rows))
            _log(f"[check] dense_dp {name}{'' if ties else ', no ties'}: P={P} N={N} M={M} "
                 f"{dplan.rows} rows a lane, {dplan.warps} warps for {strips} strips: bp and "
                 "csum equal")

            got = traceback_cuda.dense_traceback_walk_cuda(bp, args[2], args[3])
            torch.cuda.synchronize()
            _assert_all_equal(f"dense_traceback_walk {name}", got,
                              dp_ops.dense_traceback_walk(bp, args[2], args[3]))
            steps = [t.cpu().numpy() for t in got]
            bp_h = bp.cpu().numpy()
            for i, (n, m) in enumerate(sizes):
                if (dense_alignments_from_steps(*(t[i] for t in steps))
                        != dense_traceback(bp_h[i][:n + 1, :m + 1])):
                    raise AssertionError(f"dense_traceback_walk {name}: pair {i} differs "
                                         "from the host walk")
        wplan = traceback_cuda.dense_walk_plan(N, M, optin)
        _log(f"[check] dense_traceback_walk {name} ({wplan.slots} slots"
             f"{', reused' if wplan.wrap else ''}): three arrays equal, alignments equal to "
             "the host walk's")
        planes.append((bp.cpu(), args[2].cpu(), args[3].cpu(), [t.cpu() for t in got]))
    for name, kind in DENSE_WALK_FAULTS:
        if kind in DENSE_WALK_OWN_PLANES:
            cases = [_dense_walk_plane(kind, rng, device)]
        else:
            cases = [_dense_walk_fault(kind, *c) for c in planes]
        for b, xs, ys in cases:
            got = traceback_cuda.dense_traceback_walk_cuda(b.to(device), xs.to(device),
                                                           ys.to(device))
            _assert_all_equal(f"dense_traceback_walk {name}", [t.cpu() for t in got],
                              dp_ops.dense_traceback_walk(b, xs, ys))
        wplan = traceback_cuda.dense_walk_plan(b.shape[1] - 1, b.shape[2] - 1, optin)
        _log(f"[check] dense_traceback_walk {name}: three arrays equal to the plain walk's in "
             f"{len(cases)} bucket(s) (the last P={b.shape[0]}, {b.shape[1]} x {b.shape[2]}, "
             f"{wplan.slots} slots{', reused' if wplan.wrap else ''}, "
             f"{wplan.records or 'no'} records in shared memory)")
    return max_err


def _pyramid_depth(n, m, max_size_full_dp=300):
    depth = 0
    while n * m > max_size_full_dp**2:
        depth, n, m = depth + 1, n // 2, m // 2
    return depth


def _align_kwargs(paths, dp_backend, device="cuda"):
    """The stage CLI's per-pair call (seg_align/align.py::_run_pairs) for
    the synthetic pair, with its defaults and -a 6."""
    root = paths["root"]
    name = {lang: f"{STEM}_{lang}" for lang in (SRC_LANG, TGT_LANG)}
    return dict(
        src=str(root / "segments" / SRC_LANG / f"{name[SRC_LANG]}.txt"),
        tgt=str(root / "segments" / TGT_LANG / f"{name[TGT_LANG]}.txt"),
        src_embed=[str(root / "cat_segs" / SRC_LANG / f"{name[SRC_LANG]}.txt"),
                   str(root / "embeds" / SRC_LANG / f"{name[SRC_LANG]}.embed")],
        tgt_embed=[str(root / "cat_segs" / TGT_LANG / f"{name[TGT_LANG]}.txt"),
                   str(root / "embeds" / TGT_LANG / f"{name[TGT_LANG]}.embed")],
        src_stopes=True, tgt_stopes=True, alignment_max_size=6, many_to_one=None,
        search_buffer_size=5, del_percentile_frac=0.2, max_size_full_dp=300,
        costs_sample_size=20000, num_samps_for_norm=100, overlap_segments=True,
        print_aligned_text=False, seed=42, dp_backend=dp_backend, device=device,
    )


def read_output(path):
    """(spans, costs) of a ``[x]:[y]:cost`` alignment file."""
    spans, costs = [], []
    for line in Path(path).read_text().splitlines():
        x, y, c = line.split(":")
        spans.append((x, y))
        costs.append(float(c))
    return spans, np.array(costs)


def phase_main_path(workdir, n_src, n_tgt):
    """Stage 5.4 through the CLI on the card, one pair at a time; returns
    the plain-DP run's stack (its level inputs feed the timings), the
    launch counts, the pair's paths and the warm wall time."""
    import torch

    from svecalign_tpu_torch.ops import dp_cuda
    from svecalign_tpu_torch.seg_align import align as stage
    from svecalign_tpu_torch.vecalign import vecalign as per_pair

    t0 = time.perf_counter()
    paths, planted = write_synthetic_pair(workdir / "pair", n_src, n_tgt, seed=0)
    _log(f"[main] wrote a {n_src} x {n_tgt} segment pair (1024-d fp16 stopes rows, "
         f"{len(planted)} planted blocks) in {time.perf_counter() - t0:.1f}s")

    _reset_launches()
    t0 = time.perf_counter()
    runtimes = stage.main(cli_argv(paths, workdir / "out", "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    n_levels = max(_pyramid_depth(n_src, n_tgt), 1)
    _log(f"[main] stage-5.4 CLI on the card: {wall:.3f}s wall (first run), launches {launches}, "
         f"{n_levels} banded level(s)")
    if launches["banded_dp"] != n_levels:
        raise AssertionError(f"banded_dp launched {launches['banded_dp']} times, want {n_levels}")
    if launches["banded_dp_warp"] != n_levels or launches["banded_dp_block"] != 0:
        raise AssertionError(f"every banded level must take the warp route: {launches}")
    if launches["dense_dp"] != 1:
        raise AssertionError(f"dense_dp launched {launches['dense_dp']} times, want 1")

    spans, costs = read_output(output_path(workdir / "out"))
    stack = per_pair.align(**_align_kwargs(paths, "torch"))
    want_spans = [(str(x), str(y)) for x, y in stack[0]["final_alignments"]]
    if spans != want_spans:
        raise AssertionError("kernel run and plain-DP run give different alignments")
    cost_diff = float(np.abs(costs - stack[0]["alignment_scores"]).max())
    if cost_diff > 1e-6:  # includes the file's rounding to 6 decimals (<= 5e-7)
        raise AssertionError(f"costs differ from the plain-DP run by {cost_diff}")
    _log(f"[main] equals the plain-DP run: {len(spans)} identical alignments, "
         f"max cost difference {cost_diff:.2e}")

    one_one = {(str(x), str(y)) for x, y in planted if len(x) == len(y) == 1}
    recall = len(one_one & set(spans)) / len(one_one)
    _log(f"[main] recall of the {len(one_one)} planted 1-1 pairs: {recall:.4f}")
    if recall < MIN_RECALL:
        raise AssertionError(f"planted 1-1 recall {recall} < {MIN_RECALL}")
    phase_native(workdir, paths, spans, costs)

    # a second CLI run: warm wall time and phases
    t0 = time.perf_counter()
    runtimes = stage.main(cli_argv(paths, workdir / "out2", "cuda"))
    torch.cuda.synchronize()
    _log(f"[time] stage-5.4 CLI, one pair at a time, warm: {time.perf_counter() - t0:.3f}s wall "
         f"(first run {wall:.3f}s)")
    warm = time.perf_counter() - t0
    for key, val in runtimes[0].items():
        _log(f"[time]    {key}: {val * 1e3:.3f} ms")
    return stack, launches, paths, warm


NATIVE_CSUM_TOL = 1e-5  # rtol and atol: float64 host csum against the kernel's float32


def phase_native(workdir, paths, spans, costs, device="cuda"):
    """The ``native`` backend (the host float64 banded DP) on the main
    path's pair: the CLI's alignments equal the kernel run's (``spans``,
    ``costs``), and level by level the same pointers and a csum within
    ``NATIVE_CSUM_TOL``; walls against the kernel route's. On the CPU (a
    rehearsal) the plain DP stands in for the kernel."""
    from svecalign_tpu_torch.seg_align import align as stage
    from svecalign_tpu_torch.vecalign import vecalign as per_pair

    route = "cuda" if device == "cuda" else "torch"
    t0 = time.perf_counter()
    runtimes = stage.main(cli_argv(paths, workdir / "out_native", device,
                                   ["--dp_backend", "native"]))
    wall = time.perf_counter() - t0
    got_spans, got_costs = read_output(output_path(workdir / "out_native"))
    if got_spans != spans:
        raise AssertionError("--dp_backend native and the kernel give different alignments")
    cost_diff = float(np.abs(got_costs - costs).max())
    if cost_diff > 1e-5:
        raise AssertionError(f"--dp_backend native costs differ from the kernel's by {cost_diff}")

    stacks = {b: per_pair.align(**_align_kwargs(paths, b, device)) for b in (route, "native")}
    worst_abs = worst_rel = 0.0
    levels = sorted(d for d in stacks[route] if "a_b_xp" in stacks[route][d])
    for d in levels:
        want, got = stacks[route][d], stacks["native"][d]
        for key in ("a_b_xp", "a_b_yp"):
            if not np.array_equal(got[key], want[key]):
                n = int((np.asarray(got[key]) != np.asarray(want[key])).sum())
                raise AssertionError(f"native {key} differs from the kernel's at level {d} "
                                     f"({n} cells)")
        c_n, c_k = np.asarray(got["a_b_csum"]), np.asarray(want["a_b_csum"])
        fin = np.isfinite(c_n)
        if not np.array_equal(fin, np.isfinite(c_k)):
            raise AssertionError(f"native and kernel csum differ in finiteness at level {d}")
        diff = np.abs(c_n[fin] - c_k[fin])
        if (diff > NATIVE_CSUM_TOL * (1 + np.abs(c_n[fin]))).any():
            raise AssertionError(f"native csum differs from the kernel's by {diff.max()} at "
                                 f"level {d}")
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / np.maximum(np.abs(c_n[fin]), 1e-30)).max()))
    if stacks["native"][0]["final_alignments"] != stacks[route][0]["final_alignments"]:
        raise AssertionError("native and kernel stacks give different alignments")
    _log(f"[main] --dp_backend native: {len(spans)} alignments equal to the kernel run's (costs "
         f"within {cost_diff:.2e}); at {len(levels)} banded level(s) the same pointers, csum "
         f"within {worst_abs:.3e} ({worst_rel:.3e} relative; tolerance {NATIVE_CSUM_TOL:g})")
    dp_keys = ("Upsample DP", "Final DP")
    _log(f"[time] stage-5.4 CLI --dp_backend native (host float64 DP, first run: g++ builds "
         f"dp_core.cpp in it): {wall:.3f}s wall; " + ", ".join(f"{k} {runtimes[0][k] * 1e3:.3f} ms" for k in dp_keys)
         + "; the kernel route's library run: "
         + ", ".join(f"{k} {stacks[route][0]['runtimes'][k] * 1e3:.3f} ms" for k in dp_keys)
         + "; the native library run: "
         + ", ".join(f"{k} {stacks['native'][0]['runtimes'][k] * 1e3:.3f} ms" for k in dp_keys))
    return wall


def _chain_cycles_per_step(x_offsets, y_offsets, handover=ROW_HANDOVER_CYCLES,
                           alu=ALU_CYCLES):
    """Cycles that one anti-diagonal's result must follow the one before's
    by, whatever the kernel: the length of the chain of dependent
    operations from row a - 1 to row a. Only the candidates of span
    xo + yo = 1 read row a - 1: the two deletions (0, 1) and (1, 0), which
    every type set has, and any given type of that span. Every other
    candidate reads rows a - 2 and older and can be reduced to one value
    ahead of the step, off the chain. The chain is then: row a - 1 passes
    from the lanes that wrote it to the lanes that read it (``handover``:
    a warp shuffle, or a shared-memory store, barrier and load, whichever
    the card does faster), one add of the cost, a minimum over the span-1
    candidates and the one merged rest (a tree of ceil(log2(n + 1)) levels,
    one minimum instruction a level: the winner's tag feeds no later step
    and is selected beside the chain), and one select that puts the edge
    and out-of-grid cells in. ``alu`` is the latency of one such dependent
    fp32 operation. Both latencies are measured on the card by
    phase_chain_latencies; the defaults are what it measured on an H100."""
    n_span1 = 2 + sum(1 for x, y in zip(x_offsets, y_offsets) if x + y == 1)
    depth = int(np.ceil(np.log2(n_span1 + 1)))
    return handover + alu * (1 + depth + 1)


def _bound_ms(P, A, B, x_offsets, y_offsets, bp_bytes, sm_clock_hz=H100_SM_CLOCK_HZ,
              handover=ROW_HANDOVER_CYCLES, alu=ALU_CYCLES):
    """Least time for the banded DP of P pairs over A + 2 anti-diagonals of
    B lanes with the given types (the two deletions are added to them),
    the largest of three: bytes (every needed input read once: costs, node
    offsets, penalties, sizes; every output written once: csum + two
    backpointer planes) at the memory rate; operations (one add and one
    compare per cell and type) at the fp32 rate; and latency, the A + 2
    anti-diagonals one after the other at _chain_cycles_per_step cycles
    each at ``sm_clock_hz`` (pairs run side by side, so P does not enter).
    Returns (ms, "bytes", "operations" or "latency")."""
    T = len(x_offsets)
    n_types = T + 2
    read = P * (T * A * B * 4 + (A + 2) * 4 + 12) + 2 * n_types * 4
    write = P * (A + 2) * B * (4 + 2 * bp_bytes)
    ops = 2 * P * (A + 2) * B * n_types
    step = _chain_cycles_per_step(x_offsets, y_offsets, handover, alu)
    bounds = {
        "bytes": (read + write) / H100_BYTES_PER_S * 1e3,
        "operations": ops / H100_FP32_OPS_PER_S * 1e3,
        "latency": (A + 2) * step / sm_clock_hz * 1e3,
    }
    by = max(bounds, key=bounds.get)
    return bounds[by], by


PROBE_LINKS = 1 << 14  # dependent links per chain of the latency probe


def phase_chain_latencies(device):
    """The card's latencies, in SM cycles, of the operations on the banded
    DP's step-to-step chain, from csrc/chain_latency_probe.cu: one dependent
    fp32 operation, a warp shuffle, and a shared-memory store, barrier and
    load. The least of five runs each (a chain cannot run faster than its
    latency, only be disturbed). Returns (handover, alu, smem): the cheaper
    way to hand a row over, the fp32 operation, and the shared-memory round
    trip."""
    import ctypes

    import torch

    from svecalign_tpu_torch.ops import _build

    lib = _build.load("chain_latency_probe")
    lib.chain_latency_probe.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.chain_latency_probe.restype = ctypes.c_int
    cycles = torch.zeros(3, dtype=torch.int64, device=device)
    sink = torch.zeros(96, dtype=torch.float32, device=device)
    runs = []
    for _ in range(5):
        err = lib.chain_latency_probe(PROBE_LINKS, 1, 0.5, 1e30, cycles.data_ptr(),
                                      sink.data_ptr(),
                                      torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"chain_latency_probe launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        runs.append(cycles.cpu().numpy() / PROBE_LINKS)
    pair, shuffle, smem = np.min(runs, axis=0)
    alu = pair / 2  # a link of the first chain is an add and a minimum
    if not (0.5 < alu < 100 and 1 < shuffle < 1000 and 1 < smem < 1000):
        raise AssertionError(f"implausible latencies: {alu}, {shuffle}, {smem} cycles")
    _log(f"[probe] dependent chains of {PROBE_LINKS} links on this card, SM cycles per link: "
         f"fp32 add or minimum {alu:.2f}, warp shuffle {shuffle:.2f}, shared-memory store + "
         f"barrier + load {smem:.2f}")
    return float(min(shuffle, smem)), float(alu), float(smem)


def _sm_clock_hz():
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def _level_args(lvl, device):
    """The wrapper's arguments for one banded level of a pyramid stack."""
    import torch

    from svecalign_tpu_torch.ops import dp as dp_ops

    types = lvl["alignment_types"]
    b_in = np.asarray(lvl["b_offset"], np.int32)
    return (
        lvl["a_b_costs"][None].contiguous(),
        torch.from_numpy(b_in)[None].to(device),
        torch.from_numpy(dp_ops.extend_band_offsets(b_in))[None].to(device),
        tuple(x for x, _ in types), tuple(y for _, y in types),
        torch.tensor([lvl["del_penalty"]], dtype=torch.float32).to(device),
        torch.tensor([lvl["size0"]], dtype=torch.int32).to(device),
        torch.tensor([lvl["size1"]], dtype=torch.int32).to(device),
    )


def phase_times(stack, device):
    """Kernel vs plain version on each banded level's real inputs from the
    main path (the warp route the level takes and, in turns with it, the
    block kernel forced on the same inputs). The totals carry the probe's
    latencies and the SM clock for the other kernels' bounds."""
    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.ops import dp_cuda

    clock = _sm_clock_hz()
    handover, alu, smem_trip = phase_chain_latencies(device)
    totals = {"ms": 0.0, "block_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bytes_bound_ms": 0.0, "err": 0.0}
    bound_by = set()
    for depth in sorted(d for d in stack if "a_b_costs" in stack[d]):
        args = _level_args(stack[depth], device)
        err = _compare_planes(dp_cuda.banded_dp_cuda_batched(*args),
                              dp_ops.banded_dp_batched(*args))
        runs = [_cuda_time_ms(lambda: dp_cuda.banded_dp_cuda_batched(*args, route=r), reps=50)
                for r in ("block", None, None, "block")]
        ms, block_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
        plain = _cuda_time_ms(lambda: dp_ops.banded_dp_batched(*args), reps=3, warmup=1)
        P, T, A, B = args[0].shape
        xo, yo = args[3], args[4]
        bound, by = _bound_ms(P, A, B, xo, yo, 1, clock, handover, alu)
        bytes_bound = _bound_ms(P, A, B, xo, yo, 1, float("inf"))[0]
        _log(f"[time] banded_dp depth {depth} (P={P} T={T} A={A} B={B}): warp kernel {ms:.4f} ms "
             f"({runs[1]:.4f}, {runs[2]:.4f}; {ms / (A + 2) * 1e3:.4f} us per anti-diagonal), "
             f"block kernel {block_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}; "
             f"{block_ms / (A + 2) * 1e3:.4f} us per anti-diagonal), plain {plain:.3f} ms, "
             f"bound {bound:.6f} ms ({by}: {A + 2} dependent steps of "
             f"{_chain_cycles_per_step(xo, yo, handover, alu):.2f} cycles at {clock / 1e6:.0f} MHz; by bytes or "
             f"operations {bytes_bound:.6f} ms), kernel / bound {ms / bound:.2f}, err {err}")
        totals["ms"] += ms
        totals["block_ms"] += block_ms
        totals["plain_ms"] += plain
        totals["bound_ms"] += bound
        totals["bytes_bound_ms"] += bytes_bound
        totals["err"] = max(totals["err"], err)
        bound_by.add(by)
    _log(f"[time] banded_dp per stage-5.4 run (sum of its levels): warp kernel "
         f"{totals['ms']:.4f} ms, block kernel {totals['block_ms']:.4f} ms, bound "
         f"{totals['bound_ms']:.6f} ms, kernel / bound {totals['ms'] / totals['bound_ms']:.2f}")

    totals["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "latency"
    totals["probe"] = {"clock": clock, "alu": alu, "smem": smem_trip, "handover": handover}
    return totals


# (label, pair sizes, types, width_over2) timed on both routes: buckets of
# 1, 8 and 64 pairs at the stage defaults, and the other kernels of the warp
# route (five quads of types at B = 32, 4-byte copies, the loop kernel at
# 2, 4, 7 and 13 quads)
ROUTE_TIME_CASES = [
    ("a bucket of 1", P8_SIZES[-1:], DEFAULT_TYPES, 8),
    ("a bucket of 8", P8_SIZES, DEFAULT_TYPES, 8),
    ("a bucket of 64", P64_SIZES, DEFAULT_TYPES, 8),
    ("a full warp", [(400, 380)], DEFAULT_TYPES, 16),
    ("narrowest band", [(200, 190)], DEFAULT_TYPES, 3),
    ("many-to-one, B=32", [(300, 120)], MANY_TO_ONE_TYPES, 16),
    ("many-to-one, B=16", [(280, 100)], MANY_TO_ONE_TYPES, 8),
    ("ten types, B=16", [(250, 260)], DEFAULT_TYPES[:10], 8),
    ("twelve types, B=32", [(240, 200)], DEFAULT_TYPES[:12], 16),
]


def phase_route_times(device):
    """The warp kernel beside the block kernel forced on the same inputs,
    in turns, at ROUTE_TIME_CASES. Pairs of a bucket run side by side, so a
    launch should take about what its longest pair takes alone. Fails if
    the warp route, which the shape rule gives all of them, is the slower
    one anywhere."""
    from svecalign_tpu_torch.ops import dp_cuda

    rng = np.random.default_rng(4242)
    for label, sizes, types, w2 in ROUTE_TIME_CASES:
        args = _random_band_problem(rng, sizes, types, w2, device)
        runs = [_cuda_time_ms(lambda: dp_cuda.banded_dp_cuda_batched(*args, route=r), reps=20)
                for r in ("block", None, None, "block")]
        ms, block_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
        P, T, A, B = args[0].shape
        _log(f"[time] banded_dp {label} (P={P} T={T} A={A} B={B}): warp kernel {ms:.4f} ms per "
             f"launch ({ms / (A + 2) * 1e3:.4f} us per anti-diagonal, {ms / P:.4f} ms per pair), "
             f"block kernel {block_ms:.4f} ms")
        if ms > block_ms:
            raise AssertionError(f"{label}: the warp route ({ms} ms) is slower than the block "
                                 f"route ({block_ms} ms)")


# ---------------------------------------------------------------------------
# Stage 5.4 in buckets: the batched aligner
# ---------------------------------------------------------------------------

PAIR_BATCH = 8
# 16 hour-scale pairs, 900-1300 segments a side, two buckets of 8
BUCKET_SIZES = [(900 + (97 * k) % 401, 900 + (131 * k + 50) % 401) for k in range(16)]
PAIRED_GATE_PAIRS = 4  # equal-sized pairs of the library-level gate


class _env:
    """Set environment variables for a block, then put back what was there."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bucket_plan(sizes, pair_batch=PAIR_BATCH):
    """The batched CLI's buckets for pairs of ``sizes``: sorted by n + m,
    cut into runs of ``pair_batch``; per bucket (pair sizes, padded n,
    padded m, pyramid depth) under the default shape grid."""
    from svecalign_tpu_torch.vecalign import batch

    order = sorted(sizes, key=lambda nm: nm[0] + nm[1])
    plan = []
    for k in range(0, len(order), pair_batch):
        pairs = order[k:k + pair_batch]
        n_pad = batch._grid_dim(max(n for n, _ in pairs))
        m_pad = batch._grid_dim(max(m for _, m in pairs))
        plan.append((pairs, n_pad, m_pad, _pyramid_depth(n_pad, m_pad)))
    return plan


def _run_batched_cli(paths, out_dir, pair_batch=PAIR_BATCH):
    import torch

    from svecalign_tpu_torch.seg_align import align as stage

    t0 = time.perf_counter()
    prof = stage.main(cli_argv(paths, out_dir, "cuda", ["--pair_batch", str(pair_batch)]))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, prof


def _spans_cover(spans, n_src, n_tgt):
    """Whether the alignment lines cover both documents exactly once, in order."""
    xs = [i for x, _ in spans for i in json.loads(x)]
    ys = [j for _, y in spans for j in json.loads(y)]
    return xs == list(range(n_src)) and ys == list(range(n_tgt))


def phase_bucket_path(workdir, single_paths, per_pair_warm):
    """Stage 5.4 through the CLI with --pair_batch 8 on 16 hour-scale pairs:
    the launch counts (per bucket, not per pair), no plane pulled, each
    pair covered in order with its planted 1-1 pairs recovered; then the
    walls, the aligner's phases, and the walks on against off in turns, on
    the buckets and on a bucket of one pair. Returns (launches, plan)."""
    from svecalign_tpu_torch.vecalign import batch

    t0 = time.perf_counter()
    paths, stems, planted = write_synthetic_corpus(workdir / "corpus", BUCKET_SIZES)
    n_pairs = len(BUCKET_SIZES)
    _log(f"[bucket] wrote {n_pairs} pairs of {min(min(s) for s in BUCKET_SIZES)}-"
         f"{max(max(s) for s in BUCKET_SIZES)} segments a side (1024-d fp16 stopes rows) in "
         f"{time.perf_counter() - t0:.1f}s")
    plan = bucket_plan(BUCKET_SIZES)
    for k, (pairs, n_pad, m_pad, depth) in enumerate(plan):
        state = 2 * len(pairs) * 5 * 4 * 1024 * (n_pad + m_pad) / 2
        _log(f"[bucket] bucket {k}: P={len(pairs)} padded to {n_pad} x {m_pad}, pyramid depth "
             f"{depth} (dense level {n_pad >> depth} x {m_pad >> depth}), overlap tensors "
             f"{state / 1e9:.3f} GB")
    n_levels = sum(max(depth, 1) for *_, depth in plan)

    _reset_launches()
    pulls0 = dict(batch.pull_stats)
    wall, _ = _run_batched_cli(paths, workdir / "bout")
    launches = _launches()
    pulls = {k: v - pulls0[k] for k, v in batch.pull_stats.items()}
    _log(f"[bucket] stage-5.4 CLI, --pair_batch {PAIR_BATCH}, on the card: {wall:.3f}s wall (first "
         f"run), launches {launches}, pulled {pulls}")
    want = {"dense_dp": len(plan), "banded_dp": n_levels, "banded_dp_warp": n_levels,
            "banded_dp_block": 0, "dense_traceback_walk": len(plan),
            "banded_traceback_walk": n_levels}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times over {len(plan)} "
                                 f"buckets and {n_levels} banded levels, want {count}")
    if pulls["plane_bytes"] != 0 or pulls["step_bytes"] == 0:
        raise AssertionError(f"with the walks on only paths are pulled, got {pulls}")
    recalls = []
    for stem, blocks, (n_src, n_tgt) in zip(stems, planted, BUCKET_SIZES):
        spans, _ = read_output(output_path(workdir / "bout", stem))
        if not _spans_cover(spans, n_src, n_tgt):
            raise AssertionError(f"{stem}: the alignment does not cover both documents in order")
        one_one = {(str(x), str(y)) for x, y in blocks if len(x) == len(y) == 1}
        recalls.append(len(one_one & set(spans)) / len(one_one))
        if recalls[-1] < MIN_RECALL:
            raise AssertionError(f"{stem}: planted 1-1 recall {recalls[-1]} < {MIN_RECALL}")
    _log(f"[bucket] {n_pairs} pairs covered exactly once in order; recall of the planted 1-1 "
         f"pairs {min(recalls):.4f}-{max(recalls):.4f}")

    warm, _ = _run_batched_cli(paths, workdir / "bout2")
    _log(f"[time] stage-5.4 CLI, --pair_batch {PAIR_BATCH}, warm: {warm:.3f}s wall for {n_pairs} "
         f"pairs, {warm / n_pairs:.4f}s a pair (first run {wall:.3f}s); one pair at a time, warm: "
         f"{per_pair_warm:.4f}s a pair (a 1200 x 1100 pair)")
    batch.phase_seconds.clear()
    with _env(SVECALIGN_ALIGN_PROFILE="1"):
        prof_wall, prof = _run_batched_cli(paths, workdir / "bout3")
    _log(f"[time] batched aligner phases (a traced run, host seconds, {prof_wall:.3f}s "
         f"wall, {prof['buckets']} buckets): "
         + " | ".join(f"{k} {prof[k]:.3f}s" for k in ("load", "stage", "pyramid", "write")))
    _log("[time]    inside the pyramid: "
         + " | ".join(f"{k} {v * 1e3:.1f} ms" for k, v in batch.phase_seconds.items()))

    # the walks on the device against pull + host walk, end to end: eight
    # warm CLI runs in turns (the host's speed moves the wall by ~10%
    # between runs, so two runs a setting do not separate them)
    for label, p, n in (("16 pairs in 2 buckets", paths, n_pairs),
                        ("one 1200 x 1100 pair, a bucket of 1", single_paths, 1)):
        runs = {"0": [], "1": []}
        for k, setting in enumerate(("0", "1", "1", "0", "0", "1", "1", "0")):
            batch.phase_seconds.clear()
            with _env(SVECALIGN_DEVICE_TRACEBACK=setting, SVECALIGN_ALIGN_PROFILE="1"):
                run_wall, run_prof = _run_batched_cli(p, workdir / f"tb{n}_{k}")
            tb_s = batch.phase_seconds["dense traceback"] + batch.phase_seconds["banded traceback"]
            runs[setting].append((run_wall, run_prof["pyramid"], tb_s))
        for setting, name in (("1", "walks on the card"), ("0", "pull + host walk")):
            wall_s, pyr_s, tb_s = np.mean(runs[setting], axis=0)
            _log(f"[time] SVECALIGN_DEVICE_TRACEBACK={setting} ({name}) on {label}, four warm "
                 f"CLI runs, traced (host seconds of the phase spans): wall {wall_s:.4f}s ("
                 + ", ".join(f"{r[0]:.3f}" for r in runs[setting])
                 + f"), pyramid {pyr_s:.4f}s, of it walks or pulls and the rebuilding of the "
                 f"alignments {tb_s:.4f}s")
    return launches, plan


def _overlap_tensors(paths, stem):
    """A written pair's two (5, n, 1024) fp16 overlap tensors."""
    from svecalign_tpu_torch.utils.embedding_utils import make_doc_embedding, read_in_embeddings

    root, out = paths["root"], []
    for lang in (SRC_LANG, TGT_LANG):
        name = f"{stem}_{lang}"
        sent2id, rows = read_in_embeddings(
            str(root / "cat_segs" / lang / f"{name}.txt"),
            str(root / "embeds" / lang / f"{name}.embed"), use_stopes=True)
        lines = (root / "segments" / lang / f"{name}.txt").read_text().splitlines(True)
        out.append(make_doc_embedding(sent2id, rows, lines, 5, overlap_segments=True,
                                      dtype=np.float16))
    return tuple(out)


def phase_paired_gate(workdir):
    """Library level: a bucket of equal-sized pairs with the shape grid off
    and sampling="paired" must give the alignments of one pyramid.vecalign
    run per pair with the same seed, scores within 1e-5."""
    from svecalign_tpu_torch.vecalign import batch, pyramid

    paths, stems, _ = write_synthetic_corpus(
        workdir / "equal", [(N_SRC, N_TGT)] * PAIRED_GATE_PAIRS, seed=300)
    pairs = [_overlap_tensors(paths, stem) for stem in stems]
    kw = dict(final_alignment_types=DEFAULT_TYPES, del_percentile_frac=0.2, width_over2=8,
              max_size_full_dp=300, costs_sample_size=20000, num_samps_for_norm=100, seed=42)
    with _env(SVECALIGN_SHAPE_GRID="off"):
        got = batch.vecalign_batched(pairs, sampling="paired", device="cuda", **kw)
    worst = 0.0
    for i, ((v0, v1), (aligns, scores)) in enumerate(zip(pairs, got)):
        stack = pyramid.vecalign(v0, v1, device="cuda", **kw)
        want, want_scores = stack[0]["final_alignments"], stack[0]["alignment_scores"]
        if aligns != want:
            k = next((j for j, (a, b) in enumerate(zip(aligns, want)) if a != b),
                     min(len(aligns), len(want)))
            raise AssertionError(
                f"paired bucket, pair {i}: alignment {k} differs from the per-pair run: "
                f"{aligns[k:k + 2]} (costs {scores[k:k + 2]}) against {want[k:k + 2]} "
                f"(costs {want_scores[k:k + 2]})")
        worst = max(worst, float(np.abs(scores - want_scores).max()))
    if worst > 1e-5:
        raise AssertionError(f"paired bucket: scores differ from the per-pair runs by {worst}")
    _log(f"[bucket] sampling=\"paired\", grid off, {len(pairs)} pairs of {N_SRC} x {N_TGT}: "
         f"alignments identical to {len(pairs)} pyramid.vecalign runs, max score difference "
         f"{worst:.2e}")


def _dense_bounds(sizes, P, N, M, probe):
    """Least times for the dense DP of pairs of ``sizes`` in (N, M) planes:
    bytes (each pair's costs read once, sizes and pens, the whole bp planes
    written once) at the memory rate, operations (three adds and two
    compares a cell) at the fp32 rate, and latency: the longest pair's
    n + m + 1 dependent steps of one shared-memory round trip and three
    fp32 operations (an add, two compare/selects) at the SM clock."""
    cells = sum(n * m for n, m in sizes)
    nbytes = 4 * cells + 12 * P + P * (N + 1) * (M + 1)
    steps = max(n + m + 1 for n, m in sizes)
    return {
        "bytes": nbytes / H100_BYTES_PER_S * 1e3,
        "operations": 5 * cells / H100_FP32_OPS_PER_S * 1e3,
        "latency": steps * (probe["smem"] + 3 * probe["alu"]) / probe["clock"] * 1e3,
    }


def _walk_bounds(steps_taken, P, steps_emitted, read_bytes, write_bytes, probe):
    """Least times for a walk: bytes (what the visited nodes hold read once,
    the emitted arrays written once), operations (about four a step), and
    latency: the longest walk's dependent steps at one shared-memory round
    trip and two fp32-operation latencies each (what a walk over planes
    held on chip would pay; a global load on the chain costs several times
    that)."""
    total = sum(steps_taken)
    return {
        "bytes": (total * read_bytes + P * steps_emitted * write_bytes) / H100_BYTES_PER_S * 1e3,
        "operations": 4 * total / H100_FP32_OPS_PER_S * 1e3,
        "latency": max(steps_taken) * (probe["smem"] + 2 * probe["alu"]) / probe["clock"] * 1e3,
    }


def _binding(bounds):
    """(ms, name): the largest of the bytes, operations and latency bounds,
    the least time the card could take for the work."""
    by = max(bounds, key=bounds.get)
    return bounds[by], by


def _median_ms(fns, reps):
    """Median wall ms of each of ``fns`` (which end on the host), called in
    turns ``reps`` times with the device idle before each call. The median
    sets aside the calls that the interpreter's collector or another
    tenant of the host disturbed."""
    import torch

    out = [[] for _ in fns]
    for _ in range(reps):
        for k, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out[k].append((time.perf_counter() - t0) * 1e3)
    return [float(np.median(o)) for o in out]


def _route_times(label, fetch_device, fetch_host, rebuild_device, rebuild_host):
    """One level's traceback by both routes, in wall ms. Each route is a
    fetch that ends with numpy arrays on the host (walk kernel + pull of the
    path, or pull of the planes), timed 15 times in turns, and a rebuild in
    Python (the alignments from the walked path, or the host walk over the
    planes), timed 5 times in turns. Fails if the routes' alignments
    differ. Returns (device route ms, host route ms)."""
    if rebuild_device(fetch_device()) != rebuild_host(fetch_host()):
        raise AssertionError(f"{label}: the two routes differ")
    f_dev, f_host = _median_ms((fetch_device, fetch_host), reps=15)
    steps, planes = fetch_device(), fetch_host()
    r_dev, r_host = _median_ms((lambda: rebuild_device(steps), lambda: rebuild_host(planes)),
                               reps=5)
    _log(f"[time] routes of {label}, median host wall: walk on the card + path pull "
         f"{f_dev:.3f} ms, rebuild {r_dev:.3f} ms, together {f_dev + r_dev:.3f} ms; plane pull "
         f"{f_host:.3f} ms, host walk {r_host:.3f} ms, together {f_host + r_host:.3f} ms")
    return f_dev + r_dev, f_host + r_host


WALK_ROUTE_BUCKETS = (32, 64)  # synthetic buckets beyond the CLI run's, walk routes only
WALK_PRODUCER_SWEEP = (1, 3, 6, 9, 12, 15)  # producer warps of the banded walk (--ablation)
# The first designs' kernel ms per launch at the main path's shapes (P = 1
# and P = 8; NVIDIA H100 80GB HBM3, 700 W): _cuda_time_ms of the wrapper for
# the dense DP and the banded walk, device time by CUDA-graph replay for the
# dense walk (one thread a pair, its pointers loaded from device memory).
# The redesigned kernels' device times must come in under them
FIRST_DESIGN_MS = {"dense_dp": {1: 0.1984, 8: 0.1007},
                   "banded_traceback_walk": {1: 0.3047, 8: 0.2609},
                   "dense_traceback_walk": {1: 0.0575, 8: 0.0334}}


def _host_us(fn, reps):
    """Host microseconds a call of ``fn``, the median of five runs of
    ``reps`` calls each (the device synchronised before each run, not
    inside it)."""
    import torch

    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(runs))


def walk_wrapper_host_parts(dense_args, banded_args):
    """What the two walk wrappers' host work is made of, in host us a call:
    each wrapper whole (back to back, so a call's host work, not the
    device, sets the pace where it is the longer), then each part alone:
    an argument check, an output allocation and the unbind that makes two
    outputs of one, the device guard and the stream as the wrappers took
    them before (``torch.cuda.device``, ``torch.cuda.current_stream``)
    and as they take them now (in the source; the raw stream), the
    shared-memory limit by ctypes, the ring plan by ctypes on every call
    (before) and memoised (now), the launch count, and each launch alone
    (the ctypes call: the device check, the shared-memory attribute, the
    launch and its error check).
    Returns {part: us}."""
    import ctypes

    import torch

    from svecalign_tpu_torch.ops import _build, dp_cuda, traceback_cuda
    from svecalign_tpu_torch.ops.dp_cuda import _check

    bp, x_sizes, y_sizes = dense_args
    dev, index = bp.device, bp.device.index
    P, rmax, cmax = bp.shape
    steps = rmax + cmax - 1
    xp = banded_args[1]
    _, a2, B = xp.shape
    lib = traceback_cuda._lib()
    optin = dp_cuda._smem_optin(index)
    xs, ys, vs = traceback_cuda.dense_traceback_walk_cuda(*dense_args)
    bouts = traceback_cuda.banded_traceback_walk_cuda(*banded_args)
    counts, scratch = dict(traceback_cuda.LAUNCHES), dict(traceback_cuda.LAUNCHES)

    def old_guard():
        with torch.cuda.device(dev):
            pass

    def old_plan():
        plan = (ctypes.c_int * 5)()
        lib.banded_walk_plan(a2, B, dp_cuda._smem_optin(index), plan)

    def dense_launch():
        lib.dense_walk_launch(bp.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(), P, rmax - 1,
                              cmax - 1, optin, index, xs.data_ptr(), ys.data_ptr(), vs.data_ptr(),
                              torch._C._cuda_getCurrentRawStream(index))

    def banded_launch():
        lib.banded_walk_launch(*(t.data_ptr() for t in banded_args), P, a2, B,
                               int(xp.dtype == torch.int8), optin, index,
                               *(t.data_ptr() for t in bouts),
                               torch._C._cuda_getCurrentRawStream(index))

    parts = {
        "dense wrapper": lambda: traceback_cuda.dense_traceback_walk_cuda(*dense_args),
        "banded wrapper": lambda: traceback_cuda.banded_traceback_walk_cuda(*banded_args),
        "_check": lambda: _check("bp", bp, torch.int8, (P, rmax, cmax), dev),
        "torch.empty": lambda: torch.empty((P, steps), dtype=torch.int32, device=dev),
        "torch.empty + unbind": lambda: torch.empty((2, P, steps), dtype=torch.int32,
                                                    device=dev).unbind(0),
        "torch.cuda.device guard": old_guard,
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "shared-memory limit by ctypes": lambda: dp_cuda._smem_optin(index),
        "banded plan by ctypes (with the limit)": old_plan,
        "banded plan memoised": lambda: traceback_cuda._source_plan("banded_walk_plan", a2, B,
                                                                    optin),
        "count_launch": lambda: _build.count_launch(scratch, traceback_cuda.DENSE),
        "dense launch alone": dense_launch,
        "banded launch alone": banded_launch,
    }
    # a launch's calls are few enough a run that the launch queue never fills
    out = {name: _host_us(fn, reps=200 if "wrapper" in name or "launch" in name else 2000)
           for name, fn in parts.items()}
    for k in traceback_cuda.LAUNCHES:
        traceback_cuda.LAUNCHES[k] = counts[k]
    _log("[time] walk wrappers' host work, us a call (P = "
         f"{P}; dense {rmax} x {cmax}, banded {a2} x {B}): "
         + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def _kernel_times(fn):
    """(device ms per call by CUDA-graph replay, eager ms per call) of a
    wrapper whose only device work is its kernel's launch (outputs from
    torch.empty): graph replay leaves the host's per-call work out, the
    eager time keeps it."""
    graph = float(np.mean([_graph_time_ms(fn) for _ in range(2)]))
    eager = float(np.mean([_cuda_time_ms(fn, reps=50) for _ in range(2)]))
    return graph, eager


SLOWER_THAN_FIRST_DESIGN = []


def _faster_than_first_design(name, P, ms):
    """Note a redesigned kernel's device time that is not under its first
    design's; phase_slice_times fails at its end if any is."""
    if ms >= FIRST_DESIGN_MS[name][P]:
        SLOWER_THAN_FIRST_DESIGN.append(f"{name} at P = {P}: {ms:.4f} ms, not under the first "
                                        f"design's {FIRST_DESIGN_MS[name][P]} ms")


def _measurement_builds():
    """Build the measurement libraries of ``--ablation``, which no path of
    the port runs: ``measure/dense_dp_ablation.cu`` with the dense DP's
    flags, ``csrc/traceback_walk.cu`` with ``-DWALK_PRODUCERS=k`` for each
    k of WALK_PRODUCER_SWEEP and with ``-DDWALK_CLOCKS`` (the dense walk's
    phases in cycles); one nvcc each, all started together,
    into the port's build directory. Returns {name: ctypes.CDLL}; raises
    if a build fails."""
    import ctypes
    import hashlib

    from svecalign_tpu_torch.ops import _build

    root = Path(__file__).resolve().parent
    builds = {"dense_dp_ablation": (root / "measure" / "dense_dp_ablation.cu",
                                    _build.nvcc_flags("dense_dp"))}
    for k in WALK_PRODUCER_SWEEP:
        builds[f"traceback_walk_p{k}"] = (_build.CSRC_DIR / "traceback_walk.cu",
                                          _build.nvcc_flags("traceback_walk")
                                          + (f"-DWALK_PRODUCERS={k}",))
    builds["traceback_walk_clocks"] = (_build.CSRC_DIR / "traceback_walk.cu",
                                       _build.nvcc_flags("traceback_walk") + ("-DDWALK_CLOCKS",))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0, outs, procs = time.perf_counter(), {}, {}
    for name, (src, flags) in builds.items():
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
        outs[name] = _build.BUILD_DIR / f"lib{name}-{digest}.so"
        if not outs[name].exists():
            procs[name] = subprocess.Popen(
                [_build.find_nvcc(), *flags, "-o", str(outs[name]), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = [f"{name}: nvcc exit {proc.returncode}\n{proc.communicate()[0]}"
              for name, proc in procs.items() if proc.wait() != 0]
    if failed:
        raise RuntimeError("measurement build failed\n" + "\n".join(failed))
    _log(f"[build] {len(procs)} measurement build(s) in {time.perf_counter() - t0:.1f}s")
    return {name: ctypes.CDLL(str(out)) for name, out in outs.items()}


def _walk_by_producers(label, walk_args, libs):
    """The banded walk in the measurement builds with k producer warps
    (``libs`` from _measurement_builds): each held to the plain version,
    then timed by CUDA-graph replay of its launch."""
    import torch

    from svecalign_tpu_torch.ops import dp_cuda, traceback_cuda
    from svecalign_tpu_torch.ops import dp as dp_ops

    xp = walk_args[1]
    P, a2, B = xp.shape
    outs = [torch.empty((P, a2), dtype=t, device=xp.device)
            for t in (torch.int32, torch.int32, xp.dtype, xp.dtype, torch.float32)]
    optin = dp_cuda._smem_optin(xp.device.index or 0)
    argtypes = traceback_cuda._lib().banded_walk_launch.argtypes
    want = dp_ops.banded_traceback_walk(*walk_args)
    times = {}
    for k in WALK_PRODUCER_SWEEP:
        fn = libs[f"traceback_walk_p{k}"].banded_walk_launch
        fn.argtypes = argtypes

        def launch(fn=fn):
            err = fn(*(t.data_ptr() for t in walk_args), P, a2, B, int(xp.dtype == torch.int8),
                     optin, xp.device.index, *(o.data_ptr() for o in outs),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"banded walk with {k} producer warps: CUDA error {err}")

        launch()
        _assert_all_equal(f"banded_traceback_walk with {k} producer warps, {label}", outs, want)
        times[k] = _graph_time_ms(launch)
    _log(f"[time] banded_traceback_walk {label}, graph replay by producer warps: "
         + ", ".join(f"{k}: {v:.4f} ms" for k, v in times.items()))


DWALK_CLOCK_NAMES = ("set-up", "first chunk", "walk", "drain and barrier", "write-out")


def _dense_walk_clocks(label, walk_args, libs, graph_ms, clock_hz):
    """The dense walk in the measurement build with ``-DDWALK_CLOCKS``
    (``libs`` from _measurement_builds), held to the plain version: each
    block's clock64 at its phases' ends, and its records, turns of four
    and single steps. Logs, for the block of the longest walk, the cycles
    of each phase and the walk's cycles a record, and the build's time by
    graph replay beside the shipped kernel's ``graph_ms`` (the launch and
    what no block's clock sees make the difference)."""
    import ctypes

    import torch

    from svecalign_tpu_torch.ops import dp_cuda, traceback_cuda
    from svecalign_tpu_torch.ops import dp as dp_ops

    bp, x_sizes, y_sizes = walk_args
    P, rmax, cmax = bp.shape
    outs = [torch.empty((P, rmax + cmax - 1), dtype=t, device=bp.device)
            for t in (torch.int32, torch.int32, torch.int8)]
    lib = libs["traceback_walk_clocks"]
    fn = lib.dense_walk_launch
    fn.argtypes = traceback_cuda._lib().dense_walk_launch.argtypes
    lib.dense_walk_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def launch():
        err = fn(bp.data_ptr(), x_sizes.data_ptr(), y_sizes.data_ptr(), P, rmax - 1, cmax - 1,
                 dp_cuda._smem_optin(bp.device.index), bp.device.index,
                 *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"dense walk, clocks build: CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    _assert_all_equal(f"dense_traceback_walk, clocks build, {label}", outs,
                      dp_ops.dense_traceback_walk(*walk_args))
    clocks = np.zeros((min(P, 64), 11), dtype=np.int64)
    if lib.dense_walk_clocks(clocks.ctypes.data, clocks.shape[0]) != 0:
        raise RuntimeError("dense_walk_clocks failed")
    c = clocks[int(np.argmax(clocks[:, 6]))]
    phases = np.diff(c[:6])
    ms = _graph_time_ms(launch)
    _log(f"[time] dense_traceback_walk {label}, clocks build, the longest walk's block ({c[6]} "
         f"records: {c[7]} turns of four, {c[8]} single steps), cycles: "
         + ", ".join(f"{n} {v}" for n, v in zip(DWALK_CLOCK_NAMES, phases))
         + f"; the top chunk issued at {c[9] - c[1]} and completed at {c[10] - c[1]} cycles "
         f"after the set-up; the walk {phases[2] / max(c[6], 1):.1f} cycles a record; the block "
         f"{(c[5] - c[0]) / clock_hz * 1e3:.4f} ms; this build {ms:.4f} ms by graph replay, the "
         f"shipped kernel {graph_ms:.4f}")


DENSE_STRIP_ROWS = (32, 64, 128, 160, 256, 300)
ABLATION_MODES = ("first design", "no bp or csum store", "costs pre-staged",
                  "costs pre-staged, no store", "barrier only")


def _diag_major_costs(costs, x_sizes, y_sizes):
    """The (P, N + M + 2, min(N, M) + 1) copy of ``costs`` that the first
    design's thread s reads at anti-diagonal d as [p, d, s] (measure/
    dense_dp_ablation.cu, modes 2-3), +inf where its cell has no cost."""
    import torch

    P, N, M = costs.shape
    w = min(N, M) + 1
    out = torch.full((P, N + M + 2, w), float("inf"), dtype=torch.float32, device=costs.device)
    d = torch.arange(N + M + 2, device=costs.device)[:, None]
    slot = torch.arange(w, device=costs.device)[None, :]
    for p, (n, m) in enumerate(zip(x_sizes.tolist(), y_sizes.tolist())):
        r = slot.expand(len(d), w) if n <= m else d - slot
        c = d - r
        ok = (slot <= min(n, m)) & (r >= 1) & (c >= 1) & (r <= n) & (c <= m)
        out[p] = torch.where(ok, costs[p, (r - 1).clamp(0, N - 1), (c - 1).clamp(0, M - 1)],
                             out[p])
    return out


def phase_dense_ablation(label, args, sizes, latency_bound, libs):
    """The first design's ablation builds (measure/dense_dp_ablation.cu,
    ``libs`` from _measurement_builds) on the same inputs, graph-replay ms
    each and cycles per step of the longest pair, beside the shipped
    kernel: what the first design's ~680 cycles a step were spent on.
    Modes 0 and 2 are held to the plain version first; at P = 1 also the
    shipped kernel by strip count."""
    import ctypes

    import torch

    from svecalign_tpu_torch.ops import dense_dp_cuda, dp_cuda
    from svecalign_tpu_torch.ops import dp as dp_ops

    lib = libs["dense_dp_ablation"]
    lib.dense_dp_ablation_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.dense_dp_ablation_launch.restype = ctypes.c_int
    costs, pens, xs, ys = args
    P, N, M = costs.shape
    staged = _diag_major_costs(costs, xs, ys)
    bp = torch.full((P, N + 1, M + 1), -1, dtype=torch.int8, device=costs.device)
    threads = min(1024, -(-(min(N, M) + 1) // 32) * 32)
    steps = max(n + m + 1 for n, m in sizes)
    clock = _sm_clock_hz()

    def launch(mode):
        err = lib.dense_dp_ablation_launch(
            mode, (staged if mode in (2, 3) else costs).data_ptr(), pens.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), P, N, M, bp.data_ptr(), None, threads,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"dense_dp_ablation mode {mode}: CUDA error {err}")

    for mode in (0, 2):
        bp.fill_(-1)
        launch(mode)
        if not torch.equal(bp, dp_ops.dense_dp_batched(*args)[1]):
            raise AssertionError(f"dense_dp_ablation mode {mode} ({ABLATION_MODES[mode]}): bp "
                                 "differs from the plain version's")
    times = {m: _graph_time_ms(lambda m=m: launch(m)) for m in range(len(ABLATION_MODES))}
    times["shipped"] = _graph_time_ms(lambda: dense_dp_cuda.dense_dp_cuda(*args))
    if P == 1:
        # the shipped kernel by strip count: one pair of S rows x 275 columns
        rng = np.random.default_rng(1357)
        per = []
        for S in DENSE_STRIP_ROWS:
            sargs = _dense_problem(rng, [(S, 275)], costs.device, ties=False)
            ms = _graph_time_ms(lambda: dense_dp_cuda.dense_dp_cuda(*sargs))
            sp = dense_dp_cuda.dense_dp_plan(S, 275, dp_cuda._smem_optin(costs.device.index or 0))
            per.append(f"{S} rows ({sp.rows} a lane, {sp.warps} warps) {ms:.4f} ms, "
                       f"{ms * 1e-3 * clock / (S + 275 + 1):.0f} cycles an anti-diagonal")
        _log("[time] dense_dp by strips, graph replay: " + "; ".join(per))
    _log(f"[time] dense_dp ablation, {label} ({P} x {N} x {M}, {threads} threads, longest pair "
         f"{steps} steps), graph replay, ms (cycles a step at {clock / 1e6:.0f} MHz): "
         + ", ".join(f"{ABLATION_MODES[k] if k != 'shipped' else 'the shipped kernel'} "
                     f"{v:.4f} ({v * 1e-3 * clock / steps:.0f})" for k, v in times.items())
         + f"; latency bound {latency_bound:.6f} ({latency_bound * 1e-3 * clock / steps:.1f})")


def phase_slice_times(stack, plan, probe, device, ablation=False):
    """The dense-DP and walk kernels at the main paths' shapes, P = 1 (the
    per-pair run's own dense level and final banded level) and the last
    bucket's (P = 8): kernel ms against the plain version and the bounds,
    the measured difference from the plain version, each walk's route
    (kernel, pull of the path, rebuilding the alignments) against the host
    route (pull of the planes, host walk), the banded walk's also at
    buckets of WALK_ROUTE_BUCKETS pairs, and the banded DP per bucket
    launch at each of the bucket's levels; with ``ablation``, the
    measurement builds of _measurement_builds beside the dense DP and the
    banded walk. Returns the ``kernels`` line's numbers for the three
    kernels: times at P = 8, the error over all."""
    import torch

    from svecalign_tpu_torch.ops import dense_dp_cuda, dp_cuda, traceback_cuda
    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.vecalign import traceback as tb
    from svecalign_tpu_torch.vecalign.batch import _band_pad

    libs = _measurement_builds() if ablation else None
    rng = np.random.default_rng(8642)
    pairs, n_pad, m_pad, depth = plan[-1]
    P = len(pairs)
    out = {}

    # dense DP and dense walk
    top = stack[max(stack)]
    n1, m1 = top["costs_1to1"].shape
    one = (top["costs_1to1"][None].contiguous(),
           torch.tensor([top["del_penalty"]], dtype=torch.float32, device=device),
           torch.tensor([n1], dtype=torch.int32, device=device),
           torch.tensor([m1], dtype=torch.int32, device=device))
    top_sizes = [(n >> depth, m >> depth) for n, m in pairs]
    bucket = _dense_problem(rng, top_sizes, device, ties=False, pad=(n_pad >> depth, m_pad >> depth))
    dense_err = walk_err = 0.0
    for label, args, sizes in (("P=1, the per-pair run's level", one, [(n1, m1)]),
                               (f"P={P}, the bucket's level", bucket, top_sizes)):
        Pn, N, M = args[0].shape
        csum, bp = dense_dp_cuda.dense_dp_cuda(*args, with_csum=True)
        want_csum, want_bp = dp_ops.dense_dp_batched(*args)
        err = max(_max_abs_diff(csum, want_csum), _max_abs_diff(bp, want_bp))
        dense_err = max(dense_err, err)
        if not (torch.equal(bp, want_bp) and torch.equal(csum, want_csum)):
            raise AssertionError(f"dense_dp {label}: differs from the plain version's by {err}")
        ms, eager = _kernel_times(lambda: dense_dp_cuda.dense_dp_cuda(*args))
        plain = _cuda_time_ms(lambda: dp_ops.dense_dp_batched(*args), reps=2, warmup=1)
        bounds = _dense_bounds(sizes, Pn, N, M, probe)
        _log(f"[time] dense_dp {label} ({Pn} x {N} x {M}, longest pair "
             f"{max(n + m + 1 for n, m in sizes)} steps): kernel {ms:.4f} ms by graph replay, "
             f"{eager:.4f} ms eager (the first design's eager: "
             f"{FIRST_DESIGN_MS['dense_dp'][Pn]}), plain loop "
             f"{plain:.3f} ms, max abs difference {err}, bounds: bytes {bounds['bytes']:.6f}, "
             f"operations {bounds['operations']:.6f}, latency {bounds['latency']:.6f} ms "
             f"({probe['smem']:.2f} + 3 x {probe['alu']:.2f} cycles a step at "
             f"{probe['clock'] / 1e6:.0f} MHz); kernel / latency bound "
             f"{ms / bounds['latency']:.2f}")
        _faster_than_first_design("dense_dp", Pn, ms)
        out["dense_dp"] = {"ms": ms, "eager_ms": eager, "plain_ms": plain, "bounds": bounds}
        if ablation:
            phase_dense_ablation(label, args, sizes, bounds["latency"], libs)

        walk_args = (bp, args[2], args[3])
        got = traceback_cuda.dense_traceback_walk_cuda(*walk_args)
        err = _assert_all_equal(f"dense_traceback_walk {label}", got,
                                dp_ops.dense_traceback_walk(*walk_args))
        walk_err = max(walk_err, err)
        taken = [int(((x != 0) | (y != 0)).sum()) + 1
                 for x, y in zip(got[0].cpu().numpy(), got[1].cpu().numpy())]
        wms, weager = _kernel_times(lambda: traceback_cuda.dense_traceback_walk_cuda(*walk_args))
        wplain = _cuda_time_ms(lambda: dp_ops.dense_traceback_walk(*walk_args), reps=2, warmup=1)
        wbounds = _walk_bounds(taken, Pn, N + M + 1, 1, 9, probe)
        _log(f"[time] dense_traceback_walk {label} ({N + M + 1} steps emitted, longest walk "
             f"{max(taken)}): kernel {wms:.4f} ms by graph replay, {weager:.4f} ms eager (the "
             f"first design's by graph replay: {FIRST_DESIGN_MS['dense_traceback_walk'][Pn]}), "
             f"plain loop {wplain:.3f} ms, max abs difference {err}, bounds: bytes "
             f"{wbounds['bytes']:.6f}, operations {wbounds['operations']:.6f}, latency "
             f"{wbounds['latency']:.6f} ms; kernel / latency bound "
             f"{wms / wbounds['latency']:.2f}, {wms * 1e-3 * probe['clock'] / max(taken):.1f} "
             "cycles a step of the longest walk")
        _faster_than_first_design("dense_traceback_walk", Pn, wms)
        if ablation:
            _dense_walk_clocks(label, walk_args, libs, wms, probe["clock"])
        _route_times(
            f"the dense level, {label}",
            lambda: [t.cpu().numpy() for t in traceback_cuda.dense_traceback_walk_cuda(*walk_args)],
            lambda: bp.cpu().numpy(),
            lambda steps: [tb.dense_alignments_from_steps(*(t[i] for t in steps))
                           for i in range(Pn)],
            lambda bp_h: [tb.dense_traceback(bp_h[i][:n + 1, :m + 1])
                          for i, (n, m) in enumerate(sizes)])
        out["dense_traceback_walk"] = {"ms": wms, "eager_ms": weager, "plain_ms": wplain,
                                       "bounds": wbounds}
        dense_walk_args = walk_args
    out["dense_dp"]["err"], out["dense_traceback_walk"]["err"] = dense_err, walk_err

    # banded walk: the per-pair run's final level, the bucket's, and larger buckets
    a_pad = _band_pad(n_pad, m_pad)
    cases = [("P=1, the per-pair run's final level", _level_args(stack[0], device)),
             (f"P={P}, the bucket's final level",
              _random_band_problem(rng, pairs, DEFAULT_TYPES, 8, device, a_pad=a_pad))]
    cases += [(f"P={n}, the bucket's pairs {n // P} times over",
               _random_band_problem(rng, pairs * (n // P), DEFAULT_TYPES, 8, device, a_pad=a_pad))
              for n in WALK_ROUTE_BUCKETS]
    walk_err, routes = 0.0, {}
    for label, args in cases:
        planes = dp_cuda.banded_dp_cuda_batched(*args)
        walk_args = (*planes, args[2], args[6], args[7])
        Pn, a2, B = planes[1].shape
        got = traceback_cuda.banded_traceback_walk_cuda(*walk_args)
        err = _assert_all_equal(f"banded_traceback_walk {label}", got,
                                dp_ops.banded_traceback_walk(*walk_args))
        walk_err = max(walk_err, err)
        taken = [int(((x != 0) | (y != 0)).sum()) + 1
                 for x, y in zip(got[0].cpu().numpy(), got[1].cpu().numpy())]
        wms, weager = _kernel_times(
            lambda: traceback_cuda.banded_traceback_walk_cuda(*walk_args))
        wplain = _cuda_time_ms(lambda: dp_ops.banded_traceback_walk(*walk_args), reps=2, warmup=1)
        wbounds = _walk_bounds(taken, Pn, a2, 10, 14, probe)
        was = FIRST_DESIGN_MS["banded_traceback_walk"].get(Pn)
        _log(f"[time] banded_traceback_walk {label} (P={Pn}, {a2} steps emitted, B={B}, longest "
             f"walk {max(taken)}): kernel {wms:.4f} ms by graph replay, {weager:.4f} ms eager"
             + (f" (the first design's eager: {was})" if was else "") + f", plain loop {wplain:.3f} ms, "
             f"max abs difference {err}, bounds: bytes {wbounds['bytes']:.6f}, operations "
             f"{wbounds['operations']:.6f}, latency {wbounds['latency']:.6f} ms; kernel / latency "
             f"bound {wms / wbounds['latency']:.2f}")
        if was:
            _faster_than_first_design("banded_traceback_walk", Pn, wms)
            if ablation:
                _walk_by_producers(label, walk_args, libs)
        x_sizes, y_sizes = args[6].tolist(), args[7].tolist()
        boff_h = args[2].cpu().numpy()
        routes[Pn] = _route_times(
            f"the final banded level, {label}",
            lambda: [t.cpu().numpy()
                     for t in traceback_cuda.banded_traceback_walk_cuda(*walk_args)],
            lambda: [t.cpu().numpy() for t in planes],
            lambda steps: [tb.sparse_alignments_from_steps(*(t[i] for t in steps))[0]
                           for i in range(Pn)],
            lambda h: [tb.sparse_traceback(h[0][i].astype(np.float64), h[1][i], h[2][i], boff_h[i],
                                           x_sizes[i], y_sizes[i])[0] for i in range(Pn)])
        if Pn == P:
            out["banded_traceback_walk"] = {"ms": wms, "eager_ms": weager, "plain_ms": wplain,
                                            "bounds": wbounds}
            banded_walk_args = walk_args
    out["banded_traceback_walk"]["err"] = walk_err
    walk_wrapper_host_parts(dense_walk_args, banded_walk_args)
    _log("[time] final banded level, walk on the card against pull + host walk, ms (device "
         "route / host route): "
         + ", ".join(f"P={n}: {d:.3f} / {h:.3f}" for n, (d, h) in routes.items()))

    for d in range(max(depth, 1)):
        sizes = [(n >> d, m >> d) for n, m in pairs]
        types = DEFAULT_TYPES if d == 0 else [(1, 1)]
        args = _random_band_problem(rng, sizes, types, 8, device,
                                    a_pad=_band_pad(n_pad >> d, m_pad >> d))
        before = dict(dp_cuda.LAUNCHES)
        dp_cuda.banded_dp_cuda_batched(*args)
        route = _route_taken(dp_cuda, before)
        ms = _cuda_time_ms(lambda: dp_cuda.banded_dp_cuda_batched(*args), reps=20)
        Pn, T, A, B = args[0].shape
        _log(f"[time] banded_dp per bucket launch, the bucket's level {d} (P={Pn} T={T} A={A} "
             f"B={B}, {route} route): {ms:.4f} ms, {ms / Pn:.4f} ms a pair")
    if SLOWER_THAN_FIRST_DESIGN:
        raise AssertionError("; ".join(SLOWER_THAN_FIRST_DESIGN))
    return out


# ---------------------------------------------------------------------------
# Stage 5.3: the SONAR embed stage
# ---------------------------------------------------------------------------


def vad_segments(rng, seconds, sr=16000):
    """VAD-like (start, end) sample spans: 0.5-3 s of speech, 0.1-0.8 s
    gaps, over ``seconds`` of audio."""
    segs, t = [], int(rng.uniform(0.1, 0.8) * sr)
    while True:
        dur = int(rng.uniform(0.5, 3.0) * sr)
        if t + dur > seconds * sr:
            return segs
        segs.append((t, t + dur))
        t += dur + int(rng.uniform(0.1, 0.8) * sr)


def concat_windows(segs, max_run=5, max_dur_s=20.0, sr=16000):
    """The concat stage's rule, written out plainly (every run of up to
    ``max_run`` consecutive segments from each anchor, stopping at the
    first whose extent passes ``max_dur_s``; lines sorted as strings): the
    check of the windows that the stage-5.1 CLI writes."""
    cap = int(max_dur_s * sr)
    lines = []
    for k in range(len(segs)):
        anchor = segs[k][0]
        for _, stop in segs[k:k + max_run]:
            if stop - anchor > cap:
                break
            lines.append(f"{anchor} {stop}")
    return sorted(lines)


def write_synthetic_document(root, seconds, seed=0, lang=SRC_LANG):
    """One side of a stage-5.3 input tree: a 16 kHz PCM16 WAV
    ``raw_audios/{lang}/{STEM}_{lang}.wav`` (speech-like tones in noise over
    VAD-like segments, near silence between them) written by the port's
    writer, its segments ``segments/{lang}/``, and ``root/metadata.tsv``,
    which names the pair's two WAVs whichever side is written; then the
    port's stage-5.1 CLI (``seg_align.concat_segs``, its defaults: runs of
    up to 5 segments within 20 s) writes the concat windows
    ``cat_segs/{lang}/`` (``{STEM}_{lang}.txt``), which must equal
    :func:`concat_windows`. Returns (paths dict, window lines)."""
    from svecalign_tpu_torch.seg_align import concat_segs
    from svecalign_tpu_torch.utils import audio_io

    sr = 16000
    rng = np.random.default_rng(seed)
    root = Path(root)
    segs = vad_segments(rng, seconds, sr)
    wave = (0.003 * rng.standard_normal(seconds * sr)).astype(np.float32)
    for s, e in segs:
        t = np.arange(e - s, dtype=np.float32) / sr
        f0 = rng.uniform(90, 250)
        voiced = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in (1, 2, 3))
        amp = rng.uniform(0.05, 0.3) * np.hanning(e - s).astype(np.float32) ** 0.2
        wave[s:e] += amp * (0.6 * voiced + 0.4 * rng.standard_normal(e - s)).astype(np.float32)
    name = f"{STEM}_{lang}"
    wav = root / "raw_audios" / lang / f"{name}.wav"
    wav.parent.mkdir(parents=True, exist_ok=True)
    audio_io.write(str(wav), np.clip(wave, -1.0, 1.0), sr)
    d = root / "segments" / lang
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.txt").write_text("".join(f"{s} {e}\n" for s, e in segs), encoding="utf-8")
    src, tgt = (root / "raw_audios" / x / f"{STEM}_{x}.wav" for x in (SRC_LANG, TGT_LANG))
    (root / "metadata.tsv").write_text(f"{src}\t{tgt}\n", encoding="utf-8")
    concat_segs.main([str(root / "metadata.tsv"), str(root / "cat_segs"), "--seg_dir",
                      str(root / "segments"), "--lang", lang,
                      *(["--use_tgt"] if lang == TGT_LANG else [])])
    lines = (root / "cat_segs" / lang / f"{name}.txt").read_text(encoding="utf-8").splitlines()
    if lines != concat_windows(segs):
        raise AssertionError(f"stage 5.1 wrote {len(lines)} windows for {name}, which differ "
                             f"from the {len(concat_windows(segs))} of the rule")
    return {"root": root, "metadata": root / "metadata.tsv", "wav": wav,
            "n_segments": len(segs), "segments": segs}, lines


def embed_argv(paths, out_dir, device="cuda", extra=(), kind="sonar", lang=SRC_LANG):
    """argv of the stage-5.3 CLI (the ``kind`` encoder, defaults otherwise)
    for the ``lang`` side of a document written by write_synthetic_document."""
    return [str(paths["metadata"]), str(out_dir), "--concat_dir", str(paths["root"] / "cat_segs"),
            "--lang", lang, "--embed_model_type", kind, "--device", device,
            *(["--use_tgt"] if lang == TGT_LANG else []), *extra]


def embed_output(out_dir, lang=SRC_LANG):
    return Path(out_dir) / lang / f"{STEM}_{lang}.embed"


def _reset_launches():
    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.ops import (attention_cuda, dense_dp_cuda, dp_cuda, layer_norm_cuda,
                                         traceback_cuda)

    for counts in (dp_cuda.LAUNCHES, dense_dp_cuda.LAUNCHES, traceback_cuda.LAUNCHES,
                   attention_cuda.LAUNCHES, layer_norm_cuda.LAUNCHES, w2v_bert.ATTENTION_CALLS):
        for name in counts:
            counts[name] = 0


def _launches():
    from svecalign_tpu_torch.ops import (attention_cuda, dense_dp_cuda, dp_cuda, layer_norm_cuda,
                                         traceback_cuda)

    return {**dp_cuda.LAUNCHES, **dense_dp_cuda.LAUNCHES, **traceback_cuda.LAUNCHES,
            **attention_cuda.LAUNCHES, **layer_norm_cuda.LAUNCHES}


def _bucket_plan(model, lines, n_samples):
    """{bucket: [length of each window]} as the encoder buckets them, in
    its units (SONAR: 10 ms frames; SpeechLASER: samples)."""
    plan = {}
    for line in lines:
        s, e = map(int, line.split())
        bucket, (_, _, n_frames), _ = model._span_plan(s, max(min(e, n_samples) - s, 0))
        plan.setdefault(bucket, []).append(n_frames)
    return plan


def _run_embed(stage, paths, out_dir, **kw):
    import torch

    t0 = time.perf_counter()
    stage.main(embed_argv(paths, out_dir, **kw))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


GRAPH_MIN_COSINE = 0.99999  # a row replayed from a CUDA graph against the eager forward's
GRAPH_TURNS = ("graph", "eager", "eager", "graph")  # the stage-5.3 CLI's warm runs, in turns


def _traced_embed(run):
    """``run()`` with the ``EMBED`` spans on, from a reset tracer: (its
    wall, the tracer's totals by span name)."""
    from svecalign_tpu_torch.models import encode_common
    from svecalign_tpu_torch.utils import trace

    trace.reset()
    encode_common.start_encode_profile()
    try:
        wall = run()
    finally:
        encode_common.stop_encode_profile()
    return wall, trace.totals()


def replay_overlap(spans) -> list:
    """How far a mesh chunk's shards ran at the same time, from the
    tracer's resolved spans (``trace.spans()``): the ``embed.replay`` spans
    grouped by their ``mesh.issue`` parent; per chunk of two or more
    shards whose spans are all resolved, (the sum of the replays' device
    seconds less the length of their union) over (that sum less the
    longest): 0 where they ran one after another, 1 where each lay within
    the longest one's stretch."""
    issues = {s.id for s in spans if s.name == "mesh.issue"}
    chunks = {}
    for s in spans:
        if s.name == "embed.replay" and s.parent in issues:
            chunks.setdefault(s.parent, []).append(s)
    out = []
    for group in chunks.values():
        if len(group) < 2 or any(s.device_s is None for s in group):
            continue
        iv = sorted((s.device_start_ns * 1e-9, s.device_start_ns * 1e-9 + s.device_s)
                    for s in group)
        union, end = 0.0, iv[0][0]
        for a, b in iv:
            union += max(b - max(a, end), 0.0)
            end = max(end, b)
        total = sum(s.device_s for s in group)
        longest = max(s.device_s for s in group)
        # the intervals' ends are rounded to ns: a serial chunk may read a hair below 0
        out.append(max(total - union, 0.0) / (total - longest) if total > longest else 1.0)
    return out


def _mesh_overlap(run) -> str:
    """``run()``, a mesh's encode, with the ``EMBED`` spans on: the mean over
    its chunks of how far the shards' replays ran at the same time
    (:func:`replay_overlap`: 0 one after another, 1 together), as text."""
    from svecalign_tpu_torch.utils import trace

    _traced_embed(run)
    overlap = replay_overlap(trace.spans())
    if not overlap:
        return "shards' replay overlap not measured (no device spans)"
    return (f"shards' replay overlap mean {np.mean(overlap):.3f} over {len(overlap)} chunks, "
            f"min {min(overlap):.3f}")


def _span_report(totals) -> str:
    """Each span name's count, host seconds, device seconds and (a
    host-only span) the card's idle seconds."""
    return " | ".join(
        f"{name} x{t.count} host {t.host_s:.3f}s device {t.device_s:.3f}s"
        + (f" idle {t.device_idle_s:.3f}s" if t.host_only else "")
        for name, t in sorted(totals.items()))


@contextlib.contextmanager
def eager_forward(model):
    """Within the block every forward of ``model`` runs eagerly, also one
    that a CLI makes through the loader's memo: ``eager=True`` where no
    argument reaches the model. The comparison route; a card's main path
    replays a CUDA graph per shape."""
    span_forward = type(model)._span_forward

    def eager(rows_q, row_scales, lengths, bucket, _eager=False):
        return span_forward(model, rows_q, row_scales, lengths, bucket, True)

    model._span_forward = eager
    try:
        yield
    finally:
        del model._span_forward


def _peak_above(device, fn):
    """(fn(), the peak of allocated device bytes during it above what was
    allocated before; 0 on the CPU)."""
    import torch

    if device.type != "cuda":
        return fn(), 0
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) - base


def log_programs(label, model):
    """Each replica's programs: capture seconds (warm-up and capture) by
    shape and the bytes of its graph pool. Returns the total capture
    seconds and pool bytes."""
    total_s = total_bytes = 0
    for st in model.program_stats():
        caps = st["capture_s"]
        total_s += sum(caps.values())
        total_bytes += st["pool_bytes"]
        _log(f"[graphs] {label} replica {st['replica']} on {st['device']}: {len(caps)} programs, "
             f"graph pool {st['pool_bytes'] / 2**30:.3f} GiB; capture seconds by (bucket, rows, "
             "width): " + ", ".join(f"({k[0]}, {k[1]}, {k[2]}) {v:.3f}"
                                   for k, v in sorted(caps.items(), key=lambda kv: kv[0][:3])))
    return total_s, total_bytes


def graphs_against_eager(label, model, run_cli, waveform, spans, device):
    """Stage 5.3 on the card by CUDA-graph replay (the main path) against
    the eager forward of the same model: ``encode_spans`` of the document's
    windows in fp32 both ways, per-row cosine >= GRAPH_MIN_COSINE and the
    max abs difference; then the stage-5.3 CLI (``run_cli(name)`` -> wall)
    warm, in the turns of GRAPH_TURNS, with the peak of allocated memory
    above what was allocated before each run. Returns the mean walls by
    route, the peaks and the row gate's numbers."""
    got = model.encode_spans(waveform, spans)
    want = model.encode_spans(waveform, spans, eager=True)
    cos = _row_cosines(got, want)
    diff = float(np.abs(got - want).max())
    _log(f"[graphs] {label} encode_spans of the {len(spans)} windows, fp32 rows by graph replay "
         f"against the eager forward: per-row cosine min {cos.min():.8f}, max abs difference "
         f"{diff:.3e}{' (bit-equal)' if np.array_equal(got, want) else ''}")
    if cos.min() < GRAPH_MIN_COSINE or not np.isfinite(got).all():
        raise AssertionError(f"{label}: graph rows against eager, min cosine {cos.min()} < "
                             f"{GRAPH_MIN_COSINE} (or not finite)")
    walls, peaks = {"graph": [], "eager": []}, {"graph": 0, "eager": 0}
    for route in GRAPH_TURNS:
        name = f"turn_{route}{len(walls[route])}"
        if route == "eager":
            with eager_forward(model):
                wall, peak = _peak_above(device, lambda: run_cli(name))
        else:
            wall, peak = _peak_above(device, lambda: run_cli(name))
        walls[route].append(wall)
        peaks[route] = max(peaks[route], peak)
    audio_min = DOC_SECONDS / 60
    mean = {k: float(np.mean(v)) for k, v in walls.items()}
    _log(f"[time] {label} stage-5.3 CLI, warm, in turns ({', '.join(GRAPH_TURNS)}): graph "
         f"{mean['graph']:.3f}s ({', '.join(f'{w:.3f}' for w in walls['graph'])}), "
         f"{mean['graph'] / audio_min:.4f}s per minute of audio; eager {mean['eager']:.3f}s "
         f"({', '.join(f'{w:.3f}' for w in walls['eager'])}), {mean['eager'] / audio_min:.4f}s "
         f"per minute; eager / graph {mean['eager'] / mean['graph']:.3f}; peak allocated above "
         f"before: graph {peaks['graph'] / 2**30:.3f} GiB, eager {peaks['eager'] / 2**30:.3f} GiB")
    return {"graph_s": mean["graph"], "eager_s": mean["eager"], "peaks": peaks,
            "min_cos": float(cos.min()), "max_abs": diff}


def phase_capture_failure(model, waveform, spans, device):
    """A forward that synchronises the device cannot be captured: the
    capture raises, the error reaches encode_spans' caller, no program is
    kept, and the model's rows are what they were afterwards. On the CPU
    (no graphs) nothing is checked."""
    import torch

    from svecalign_tpu_torch.parallel.mesh import Mesh

    if device.type != "cuda":
        _log("[graphs] capture failure: not checked on the CPU (no graphs)")
        return
    probe = model.with_mesh(Mesh([torch.device("cuda", torch.cuda.current_device())]))
    forward = probe._forward

    def syncing(*args):
        torch.cuda.synchronize()
        return forward(*args)

    probe._forward = syncing
    try:
        probe.encode_spans(waveform, spans)
    except RuntimeError as e:
        err = e
    else:
        raise AssertionError("a forward that synchronises was captured")
    finally:
        del probe._forward
    if any(st["capture_s"] for st in probe.program_stats()):
        raise AssertionError("a failed capture left a program behind")
    cos = _row_cosines(probe.encode_spans(waveform, spans), model.encode_spans(waveform, spans))
    if cos.min() < GRAPH_MIN_COSINE:
        raise AssertionError(f"after a failed capture, rows at cosine {cos.min()} to the model's")
    why = " <- ".join(str(x).strip().splitlines()[0] for x in (err, err.__context__) if x)
    _log(f"[graphs] a forward that synchronises: its capture raised to the caller "
         f"({type(err).__name__}: {why}); no program kept; then a capture of the forward: rows "
         f"at cosine min {cos.min():.8f} to the model's (the failed capture's pool routing "
         f"ended by torch._C._cuda_endAllocateToPool: "
         f"{hasattr(torch._C, '_cuda_endAllocateToPool')})")


def phase_embed_path(workdir, device):
    """Stage 5.3 through the CLI on the card at full width; returns what
    the timings need (each bucket's window frame counts and chunks, the
    modal bucket) and the launches."""
    import torch

    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.seg_align import embed as stage
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.audio_utils import load_waveform

    t0 = time.perf_counter()
    paths, lines = write_synthetic_document(workdir / "doc", DOC_SECONDS)
    n_samples = DOC_SECONDS * 16000
    _log(f"[embed] wrote a {DOC_SECONDS} s 16 kHz document: {paths['n_segments']} VAD-like "
         f"segments, {len(lines)} concat windows, in {time.perf_counter() - t0:.1f}s")

    # the CLI's own loader and memo: the CLI runs below reuse this model
    t0 = time.perf_counter()
    model = embed_model_utils.load_embed_model("sonar", max_tokens=150 * 16000, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.model.parameters())
    _log(f"[embed] weight init (numpy seed 0, {n_params} parameters, config {model.config}): "
         f"{init_s:.3f}s")

    plan = _bucket_plan(model, lines, n_samples)
    n_chunks = sum(-(-len(v) // model.batch_size) for v in plan.values())
    for bucket in sorted(plan):
        frames = plan[bucket]
        _log(f"[embed] bucket {bucket} frames (T = {bucket // 2} after stacking): "
             f"{len(frames)} windows, {-(-len(frames) // model.batch_size)} chunks, "
             f"mean {np.mean(frames) / 100:.2f} s")
    mean_s = np.mean([np.mean(v) for v in plan.values() for _ in v]) / 100
    _log(f"[embed] {len(lines)} windows in {n_chunks} chunks of {model.batch_size}, "
         f"mean window {mean_s:.2f} s")

    _reset_launches()
    wall, peak_first = _peak_above(device, lambda: _run_embed(stage, paths, workdir / "out"))
    launches = _launches()
    calls = dict(w2v_bert.ATTENTION_CALLS)
    n_layers = model.config.n_layers
    _log(f"[embed] stage-5.3 CLI on the card: {wall:.3f}s wall (first run, capturing a CUDA "
         f"graph per bucket; peak allocated {peak_first / 2**30:.3f} GiB above before), "
         f"launches {launches}, attention calls by route {calls}")
    capture_s, pool_bytes = log_programs("SONAR", model)
    if launches["relkey_attention"] != n_layers * n_chunks:
        raise AssertionError(f"relkey_attention launched {launches['relkey_attention']} "
                             f"times, want {n_layers} x {n_chunks}")
    if calls["torch"] != 0:
        raise AssertionError(f"the plain attention ran {calls['torch']} times")
    norms = 1 + 6 * n_layers  # fp_layer_norm, six a conformer layer
    if launches["layer_norm"] != norms * n_chunks:
        raise AssertionError(f"layer_norm launched {launches['layer_norm']} times, want "
                             f"{norms} x {n_chunks}")

    rows = np.fromfile(embed_output(workdir / "out"), dtype=np.float16)
    if rows.size != len(lines) * model.config.pool_dim:
        raise AssertionError(f".embed holds {rows.size} values, want {len(lines)} x "
                             f"{model.config.pool_dim}")
    rows = rows.reshape(len(lines), model.config.pool_dim).astype(np.float32)
    if not np.isfinite(rows).all():
        raise AssertionError(".embed has non-finite values")
    _log(f"[embed] .embed: {rows.shape[0]} x {rows.shape[1]} fp16 rows, all finite, "
         f"row norms {np.linalg.norm(rows, axis=1).min():.3f}-{np.linalg.norm(rows, axis=1).max():.3f}")

    waveform = load_waveform(str(paths["wav"]), sr=16000)
    spans = [tuple(map(int, line.split())) for line in lines]
    turns = graphs_against_eager("SONAR", model,
                                 lambda name: _run_embed(stage, paths, workdir / name),
                                 waveform, spans, device)
    wall_warm = turns["graph_s"]
    phase_capture_failure(model, waveform, spans[:8], device)
    wall_prof, spans_prof = _traced_embed(lambda: _run_embed(stage, paths, workdir / "out_prof"))
    audio_min = DOC_SECONDS / 60
    _log(f"[time] stage-5.3 CLI, warm: {wall_warm:.3f}s wall (first run {wall:.3f}s, "
         f"{capture_s:.3f}s of it capturing), {wall_warm / audio_min:.3f}s per minute of audio")
    _log(f"[time] stage-5.3 spans (a traced run, the forward by graph replay, "
         f"{wall_prof:.3f}s wall): weight init {init_s:.3f}s (once per process) | "
         + _span_report(spans_prof))

    model.model.trunk.set_attention_backend("torch")
    try:
        _reset_launches()
        with eager_forward(model):  # no graphs kept of a comparison's route
            wall_plain = _run_embed(stage, paths, workdir / "out_plain")
        if _launches()["relkey_attention"] != 0:
            raise AssertionError("the plain-attention run launched the kernel")
    finally:
        model.model.trunk.set_attention_backend("auto")
    plain = np.fromfile(embed_output(workdir / "out_plain"), dtype=np.float16)
    plain = plain.reshape(rows.shape).astype(np.float32)
    cos = (rows * plain).sum(1) / np.maximum(
        np.linalg.norm(rows, axis=1) * np.linalg.norm(plain, axis=1), 1e-30)
    _log(f"[embed] against the plain-attention run ({wall_plain:.3f}s wall): per-row cosine "
         f"min {cos.min():.6f}, mean {cos.mean():.6f}; max abs row difference "
         f"{np.abs(rows - plain).max():.4e}")
    if cos.min() < MIN_COSINE:
        raise AssertionError(f"min per-row cosine {cos.min()} < {MIN_COSINE}")
    phase_sonar_relative(model, paths, lines, device)
    return {"plan": plan, "modal_bucket": max(plan, key=lambda b: len(plan[b])),
            "chunks": {b: -(-len(v) // model.batch_size) for b, v in plan.items()},
            "batch_size": model.batch_size, "n_heads": model.config.n_heads,
            "n_layers": n_layers, "graphs": {**turns, "capture_s": capture_s,
                                            "pool_bytes": pool_bytes}}, launches


def sonar_relative_encoder(model, seed=0):
    """The SONAR encoder of ``model`` (a loaded ``SonarSpeechModel``) in the
    Transformer-XL ``relative`` flavor: its weights, stored as the model
    stores them, and the flavor's own leaves (``pos_bias_u``,
    ``pos_bias_v``, ``linear_pos``) drawn N(0, 1/fan_in) from
    ``torch.Generator(seed)``, as the numpy init draws kernels; the rel-key
    tables are dropped. Returns (bf16 encoder, fp32 encoder of the same
    weights)."""
    import dataclasses

    import torch

    from svecalign_tpu_torch.models.sonar_encoder import SonarSpeechEncoder

    cfg = dataclasses.replace(model.config, position_embeddings_type="relative")
    have = model.model.state_dict()
    gen = torch.Generator().manual_seed(seed)
    out = []
    for dtype in (cfg.dtype, "float32"):
        with torch.device("meta"):
            enc = SonarSpeechEncoder(dataclasses.replace(cfg, dtype=dtype))
        state = {}
        for k, p in enc.state_dict().items():
            if k in have:
                v = have[k]
            elif not out:  # drawn once, shared by both encoders
                fan_in = p.shape[-1] if k.endswith("linear_pos.weight") else p.shape[0]
                v = (torch.randn(p.shape, generator=gen) * fan_in ** -0.5).to(model.device)
                if k.endswith("linear_pos.weight"):
                    v = v.to(have[k.replace("linear_pos", "linear_q")].dtype)
            else:
                v = out[0].state_dict()[k]
            state[k] = v.float() if dtype == "float32" else v
        enc.load_state_dict(state, assign=True)
        out.append(enc.eval().requires_grad_(False))
    return out[0], out[1]


def phase_sonar_relative(model, paths, lines, device):
    """The ``relative`` flavor at full width on the card: one chunk of
    every bucket of the 10-minute document through the bf16 encoder, finite
    rows, per-row cosine >= MIN_COSINE to an fp32 forward of the same
    weights, and its time per minute of audio beside the rel-key model's on
    the same chunks (the flavor takes the plain attention path, as in
    JAX)."""
    import torch

    from svecalign_tpu_torch.models import encode_common, w2v_bert
    from svecalign_tpu_torch.utils.audio_utils import load_waveform

    rel, ref = sonar_relative_encoder(model)
    waveform = load_waveform(str(paths["wav"]), sr=16000)
    n_samples = len(waveform)
    by_bucket = {}
    for line in lines:
        s, e = map(int, line.split())
        bucket, (start, ln, n_frames), _ = model._span_plan(s, max(min(e, n_samples) - s, 0))
        by_bucket.setdefault(bucket, []).append((start, ln, n_frames))
    worst, t_rel, t_key, audio_s = 1.0, 0.0, 0.0, 0.0
    for bucket, items in sorted(by_bucket.items()):
        chunk = items[: model.batch_size]
        width = model._bucket_width(bucket)
        padded, scales = encode_common.stage_rows(
            [waveform[s:s + ln] for s, ln, _ in chunk], model.batch_size, width, True)
        lengths = np.zeros(model.batch_size, np.int32)
        lengths[: len(chunk)] = [min(n, bucket) for *_, n in chunk]
        args = [torch.from_numpy(a).to(device) for a in (padded, scales, lengths)]

        def fwd(m):
            with torch.inference_mode():
                return model._forward(m, *args, bucket)

        calls = dict(w2v_bert.ATTENTION_CALLS)
        got = fwd(rel)
        if w2v_bert.ATTENTION_CALLS["torch"] - calls["torch"] != rel.cfg.n_layers:
            raise AssertionError("the relative flavor did not take the plain attention path")
        want = fwd(ref)
        rows = got[: len(chunk)].cpu().numpy()
        if not np.isfinite(rows).all():
            raise AssertionError(f"relative flavor: non-finite rows at bucket {bucket}")
        cos = _row_cosines(rows, want[: len(chunk)].cpu().numpy())
        worst = min(worst, float(cos.min()))
        del want
        ms = _cuda_time_ms(lambda: fwd(rel), reps=2, warmup=1)
        ms_key = _cuda_time_ms(lambda: fwd(model.model), reps=2, warmup=1)
        t_rel, t_key = t_rel + ms / 1e3, t_key + ms_key / 1e3
        audio_s += sum(ln for _, ln, _ in chunk) / 16000
        _log(f"[embed] relative flavor, bucket {bucket} frames: {len(chunk)} windows, rows "
             f"finite, per-row cosine to the fp32 forward min {cos.min():.6f}; {ms:.1f} ms a "
             f"chunk (the rel-key model's {ms_key:.1f} ms)")
    del rel, ref
    torch.cuda.empty_cache()
    if worst < MIN_COSINE:
        raise AssertionError(f"relative flavor against fp32: min per-row cosine {worst} < "
                             f"{MIN_COSINE}")
    _log(f"[time] SONAR relative flavor, one chunk of each of {len(by_bucket)} buckets "
         f"({audio_s:.1f} s of audio): {t_rel:.3f}s, {t_rel / (audio_s / 60):.3f}s per minute "
         f"of audio (the rel-key kernel model on the same chunks: {t_key:.3f}s, "
         f"{t_key / (audio_s / 60):.3f}s per minute); min cosine {worst:.6f}")
    return {"s_per_min": t_rel / (audio_s / 60), "key_s_per_min": t_key / (audio_s / 60)}


def _attention_bound_ms(B, T, H, lengths, C=73, elem_bytes=2):
    """Least time for rel-key attention on these inputs: what the function
    reads and writes once (q, k, v, the (C, 64) table and the (B,) int32
    lengths in, the output out), against 4 x 64 operations per (valid
    query, valid key, head) pair at the bf16 tensor-core peak. Returns
    (ms, "bytes" or "operations")."""
    ops = 4 * H * 64 * float(np.sum(np.square(np.asarray(lengths, np.float64))))
    nbytes = (4 * B * T * H * 64 + C * 64) * elem_bytes + 4 * B
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_BF16_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _sdpa_args(q, k, v, table, lengths):
    """SDPA's inputs for the same function: (B, H, T, dh) views and the
    rel-key bias with the key mask as one materialised (B, H, T, T) bf16
    attn_mask (built here, outside any timing)."""
    import torch

    from svecalign_tpu_torch.ops import attention

    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    dist = torch.clamp(pos[None, :] - pos[:, None], -64, 8) + 64
    p = attention.relkey_projection(q, table).permute(0, 2, 1, 3)  # (B, H, T, C)
    mask = p[:, :, pos[:, None], dist].float()
    keep = pos[None, :] < lengths[:, None]
    mask = torch.where(keep[:, None, None, :], mask, attention.NEG).to(torch.bfloat16)
    return tuple(a.permute(0, 2, 1, 3) for a in (q, k, v)) + (mask,)


def phase_attention_times(info, device):
    """The kernel against SDPA (the bias and key mask materialised as a
    (B, H, T, T) attn_mask) and the bound at each bucket of the stage-5.3
    run: B = batch rows, T = frames / 2, bf16, the lengths of the bucket's
    first chunk. Each is timed two ways, in turns (kernel, SDPA, SDPA,
    kernel): replayed from a CUDA graph (device time per call: ``ms`` and
    ``library_ms``) and called eagerly back to back (host work included:
    ``eager_ms`` and ``library_eager_ms``). The plain version is timed
    eagerly at the modal bucket only. Returns the modal bucket's numbers
    and the per-bucket rows."""
    import torch
    import torch.nn.functional as F

    from svecalign_tpu_torch.ops import attention, attention_cuda

    B, H = info["batch_size"], info["n_heads"]
    rows, modal = [], None
    for bucket in sorted(info["plan"]):
        frames = list(info["plan"][bucket][:B]) + [0] * max(0, B - len(info["plan"][bucket]))
        lens = tuple(min(f, bucket) // 2 for f in frames)
        row = _time_attention_bucket(bucket, lens, H, info["n_layers"] * info["chunks"][bucket],
                                     device, with_plain=bucket == info["modal_bucket"])
        if "plain_ms" in row:
            modal = row
        rows.append(row)
    per_run = sum(r["launches"] * r["ms"] for r in rows)
    _log(f"[time] relkey_attention per stage-5.3 run, sum of launches x kernel ms (graph) over "
         f"the buckets: {per_run:.3f} ms")
    modal["err"] = max(r["err"] for r in rows)
    return modal, rows


PLAIN_ROWS_LONG_T = 2  # batch rows held against the plain version past T = 1000


def _time_attention_bucket(bucket, lens, H, launches, device, with_plain=False):
    """One bucket's row of phase_attention_times: q, k, v at (B, T = bucket
    / 2, H, 64) bf16 with ``lens``, the kernel held against the plain
    version (on the first PLAIN_ROWS_LONG_T batch rows past T = 1000, where
    the plain version's fp32 scores would take tens of GB), timed against
    SDPA in turns by graph replay and eagerly, its bound; the plain version
    timed when ``with_plain``."""
    import torch
    import torch.nn.functional as F

    from svecalign_tpu_torch.ops import attention, attention_cuda

    B, T = len(lens), bucket // 2
    rng = np.random.default_rng(99 + bucket)
    q, k, v, table, lengths = attention_inputs(rng, B, H, T, lens, 64, 8, torch.bfloat16, device)
    got = attention_cuda.relkey_attention_cuda(q, k, v, table, lengths)
    n = B if T <= 1000 else PLAIN_ROWS_LONG_T
    want = attention.relkey_attention(q[:n], k[:n], v[:n], table, lengths[:n])
    err = compare_attention(got[:n], want, lengths[:n], "bfloat16")
    sdpa = _sdpa_args(q, k, v, table, lengths)
    lib = F.scaled_dot_product_attention(*sdpa[:3], attn_mask=sdpa[3]).permute(0, 2, 1, 3)
    lib_err = float((lib[:n].float() - want.float())[
        (torch.arange(T, device=device)[None, :] < lengths[:n, None])].abs().max())

    def kernel():
        return attention_cuda.relkey_attention_cuda(q, k, v, table, lengths)

    def library():
        return F.scaled_dot_product_attention(*sdpa[:3], attn_mask=sdpa[3])

    g = [_graph_time_ms(f) for f in (kernel, library, library, kernel)]
    e = [_cuda_time_ms(f, reps=20) for f in (kernel, library, library, kernel)]
    ms, library_ms = (g[0] + g[3]) / 2, (g[1] + g[2]) / 2
    bound, by = _attention_bound_ms(B, T, H, lens)
    row = {"T": T, "launches": launches, "ms": ms,
           "library_ms": library_ms, "eager_ms": (e[0] + e[3]) / 2,
           "library_eager_ms": (e[1] + e[2]) / 2, "bound_ms": bound, "bound_by": by,
           "err": err, "lengths": (min(lens), max(lens))}
    if with_plain:
        row["plain_ms"] = _cuda_time_ms(
            lambda: attention.relkey_attention(q, k, v, table, lengths), reps=5, warmup=1)
    del q, k, v, table, lengths, got, want, sdpa, lib
    torch.cuda.empty_cache()
    _log(f"[time] relkey_attention bucket {bucket} frames (B={B} H={H} T={T} bf16, lengths "
         f"{min(lens)}-{max(lens)}, {launches} launches per run): kernel {ms:.4f} ms "
         f"({g[0]:.4f}, {g[3]:.4f}; eager {row['eager_ms']:.4f}), SDPA with a materialised "
         f"bias {library_ms:.4f} ms ({g[1]:.4f}, {g[2]:.4f}; eager "
         f"{row['library_eager_ms']:.4f}; its max abs diff to plain {lib_err:.3e}), bound "
         f"{bound:.6f} ms ({by}), kernel / SDPA {ms / library_ms:.3f}, kernel / bound "
         f"{ms / bound:.2f}, err {err:.3e} (first {n} rows)"
         + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row else ""))
    return row


# ---------------------------------------------------------------------------
# Stage 5.3 with SpeechLASER, and the chain 5.3 -> 5.4 -> 6.1 -> 6.3 -> 6.4 -> 6.5
# ---------------------------------------------------------------------------

SPAN_MIN_COSINE = 0.999  # a stage-6.5 row against encode_spans of its span
UPLOAD_MIN_COSINE = 0.9999  # fp32 upload: device against host window assembly
LASER_SAMPLES_PER_BUCKET = 4  # windows per bucket held against the fp32 forward
MISS_SAMPLES = 8  # stage-6.5 rows held against encode_spans, per run
# stages 6.3 and 6.4 at the pipeline's settings; a second run of 6.3 at
# --max_num_align 6 gives stage 6.5 spans to embed (coverage, see phase_chain)
CONCAT_ARGS = ("--max_sil", "1.0", "--max_dur", "20.0", "--apply_dur_cond_to_both_sides")
CHAIN_TRAFFIC = (("pipeline settings", 3), ("coverage", 6))  # (label, --max_num_align)
# stage 6.9 at svecalign_tpu/pipeline.py's settings
OVERLAP_ARGS = ("--min_audio_length", "2000", "--mining_threshold", "0.0", "--max_overlap", "0.8")
MIN_DUR_S = 1.0
KEEP_SHARE = 0.8  # share of the non-deletions under stage 6.1's cost limit
LONG_SPAN_SECONDS = (25, 35, 50, 60)  # SONAR spans of the 3000-6000-frame buckets


def _row_cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
                                       1e-30)


def laser_row_flops(cfg, width):
    """Operations (two per multiply-add) of one row of ``width`` samples
    through the LASER encoder, by part: the conv extractor, the projection
    and positional conv, the trunk's dense layers, attention's two
    products over the padded frames."""
    n, c_in, ext = width, 1, 0.0
    for dim, k, stride in cfg.conv_layers:
        n = (n - k) // stride + 1
        ext += 2.0 * n * dim * c_in * k
        c_in = dim
    d, f = cfg.encoder_dim, cfg.encoder_ffn_dim
    return {
        "extractor": ext,
        "projection + positional conv": 2.0 * n * c_in * d
        + 2.0 * n * d * (d // cfg.conv_pos_groups) * cfg.conv_pos_kernel,
        "trunk dense": cfg.encoder_layers * 2.0 * n * (4 * d * d + 2 * d * f),
        "attention": cfg.encoder_layers * 4.0 * n * n * d,
    }


def _laser_fp32_reference(model):
    """An fp32-compute LaserSpeechEncoder holding the bf16 model's weights."""
    import dataclasses

    import torch

    from svecalign_tpu_torch.models.laser_encoder import LaserSpeechEncoder

    with torch.device("meta"):
        ref = LaserSpeechEncoder(dataclasses.replace(model.config, dtype="float32"))
    ref.load_state_dict({k: v.float() for k, v in model.model.state_dict().items()}, assign=True)
    return ref.eval().requires_grad_(False)


def _read_rows(path, kind, dim=1024):
    """A stage-5.3/6.5 ``.embed`` file as fp32 rows: a stopes .npy for
    SpeechLASER, headerless fp16 for SONAR."""
    if kind == "speech_laser":
        return np.load(path).astype(np.float32)
    return np.fromfile(path, dtype=np.float16).reshape(-1, dim).astype(np.float32)


def phase_laser_path(workdir, device):
    """Stage 5.3 through the CLI on the card with the full-width SpeechLASER
    encoder, the pipeline's default (bf16, random weights from numpy seed
    0), on the 10-minute document: one fp16 .npy row per window, all
    finite; a sample of every bucket's windows against an fp32 forward of
    the same weights; with fp32 uploads, device window assembly against
    host slicing; walls, phases and the share of the bf16 peak. Returns
    what the chain needs."""
    import torch

    from svecalign_tpu_torch.models.laser_encoder import conv_groups
    from svecalign_tpu_torch.seg_align import embed as stage
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.audio_utils import load_waveform

    dev = device.type
    t0 = time.perf_counter()
    paths, lines = write_synthetic_document(workdir, DOC_SECONDS, seed=0)
    n_samples = DOC_SECONDS * 16000
    _log(f"[laser] wrote a {DOC_SECONDS} s 16 kHz document: {paths['n_segments']} VAD-like "
         f"segments, {len(lines)} concat windows, in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    model = embed_model_utils.load_embed_model("speech_laser", max_tokens=150 * 16000,
                                               device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.config
    n_params = sum(p.numel() for p in model.model.parameters())
    _log(f"[laser] weight init (numpy seed 0, {n_params} parameters, config {cfg}): {init_s:.3f}s")

    plan = _bucket_plan(model, lines, n_samples)  # {bucket: [samples of each window]}
    rows_of = {b: model._rows_per_chunk(b) for b in plan}
    chunks = {b: -(-len(v) // rows_of[b]) for b, v in plan.items()}
    parts = {}
    for b in plan:
        for key, val in laser_row_flops(cfg, b).items():
            parts[key] = parts.get(key, 0.0) + chunks[b] * rows_of[b] * val
    flops = sum(parts.values())
    padded_s = sum(chunks[b] * rows_of[b] * b for b in plan) / 16000
    audio_s = sum(sum(v) for v in plan.values()) / 16000
    for b in sorted(plan):
        _log(f"[laser] bucket {b // 16000} s: {len(plan[b])} windows, {chunks[b]} chunks of "
             f"{rows_of[b]} rows, mean {np.mean(plan[b]) / 16000:.2f} s")
    _log(f"[laser] {len(lines)} windows, {audio_s:.1f} s of audio, {padded_s:.1f} s as padded "
         f"chunks (padding rows included), {sum(chunks.values())} chunks; {flops / 1e15:.4f} "
         "PFLOP: " + ", ".join(f"{k} {v / 1e12:.1f} TFLOP" for k, v in parts.items()))

    out = workdir / "emb"
    _reset_launches()
    wall, peak_first = _peak_above(
        device, lambda: _run_embed(stage, paths, out, kind="speech_laser", device=dev))
    capture_s, pool_bytes = log_programs("LASER", model)
    # seven extractor norms a row group, post_extract_norm, two a layer,
    # encoder_norm: 57 a chunk of one group, 64 of two (a 600 s chunk)
    norm_launches = _launches()["layer_norm"]
    shards = model.data_shards
    per_chunk = {b: shards * (len(cfg.conv_layers) * conv_groups(rows_of[b] // shards, b)
                              + 2 + 2 * cfg.encoder_layers) for b in plan}
    want_norms = sum(chunks[b] * per_chunk[b] for b in plan)
    _log(f"[laser] layer_norm launches {norm_launches} over {sum(chunks.values())} chunks "
         f"(a chunk's by bucket: {per_chunk})")
    if norm_launches != want_norms:
        raise AssertionError(f"layer_norm launched {norm_launches} times, want {want_norms}")
    rows = np.load(embed_output(out))
    if rows.dtype != np.float16 or rows.shape != (len(lines), cfg.encoder_dim):
        raise AssertionError(f".embed holds {rows.dtype} {rows.shape}, want float16 "
                             f"({len(lines)}, {cfg.encoder_dim})")
    rows = rows.astype(np.float32)
    if not np.isfinite(rows).all():
        raise AssertionError(".embed has non-finite values")
    norms = np.linalg.norm(rows, axis=1)
    _log(f"[laser] stage-5.3 CLI (--embed_model_type speech_laser, defaults) on the card: "
         f"{wall:.3f}s wall (first run, {capture_s:.3f}s of it capturing a CUDA graph per "
         f"bucket; peak allocated {peak_first / 2**30:.3f} GiB above before); .embed: a stopes "
         f".npy of {rows.shape[0]} x {rows.shape[1]} fp16 rows, all finite, row norms "
         f"{norms.min():.3f}-{norms.max():.3f}")

    waveform = load_waveform(str(paths["wav"]), sr=16000)
    spans = [tuple(map(int, line.split())) for line in lines]
    turns = graphs_against_eager(
        "LASER", model,
        lambda name: _run_embed(stage, paths, workdir / name, kind="speech_laser", device=dev),
        waveform, spans, device)
    wall_warm = turns["graph_s"]
    wall_prof, spans_prof = _traced_embed(
        lambda: _run_embed(stage, paths, workdir / "emb_prof", kind="speech_laser", device=dev))
    audio_min = DOC_SECONDS / 60
    _log(f"[time] LASER stage-5.3 CLI, warm: {wall_warm:.3f}s wall, {wall_warm / audio_min:.3f}s "
         f"per minute of audio (first run {wall:.3f}s, {wall / audio_min:.3f}s per minute); "
         f"{flops / wall_warm / 1e12:.1f} TFLOP/s over the warm wall, "
         f"{100 * flops / wall_warm / H100_BF16_OPS_PER_S:.1f}% of the bf16 dense peak")
    replay_s = spans_prof["embed.replay"].device_s if "embed.replay" in spans_prof else 0.0
    _log(f"[time] LASER stage-5.3 spans (a traced run, the forward by graph replay, "
         f"{wall_prof:.3f}s wall): weight init {init_s:.3f}s (once per process) | "
         + _span_report(spans_prof)
         + f"; the forward (extractor, trunk, pool) at "
         f"{flops / max(replay_s, 1e-9) / 1e12:.1f} TFLOP/s of the replays' device time")

    # a sample of every bucket's windows against an fp32 forward of the
    # same weights, padded to the same bucket
    by_bucket = {}
    for i, (s, e) in enumerate(spans):
        by_bucket.setdefault(model._bucket(min(e, n_samples) - s), []).append(i)
    ref = _laser_fp32_reference(model)
    worst = 1.0
    for b, ids in sorted(by_bucket.items()):
        pick = ids[:: max(1, len(ids) // LASER_SAMPLES_PER_BUCKET)][:LASER_SAMPLES_PER_BUCKET]
        wav = np.zeros((len(pick), b), np.float32)
        lengths = np.zeros(len(pick), np.int32)
        for r, i in enumerate(pick):
            w = waveform[spans[i][0]:spans[i][1]][:b]
            wav[r, :len(w)], lengths[r] = w, len(w)
        with torch.inference_mode():
            want = ref(torch.from_numpy(wav).to(device), torch.from_numpy(lengths).to(device))
        cos = _row_cosines(rows[pick], want.cpu().numpy())
        worst = min(worst, float(cos.min()))
        _log(f"[laser] bucket {b // 16000} s: {len(pick)} windows against an fp32 forward of the "
             f"same weights, per-row cosine min {cos.min():.6f}")
    del ref
    torch.cuda.empty_cache()
    if worst < MIN_COSINE:
        raise AssertionError(f"LASER rows against the fp32 forward: min cosine {worst} < "
                             f"{MIN_COSINE}")

    # fp32 uploads: device window assembly against host slicing
    model.upload_dtype = "fp32"
    try:
        on_dev = model.encode_spans(waveform, spans)
        on_host = model.encode([waveform[s:e] for s, e in spans])
    finally:
        model.upload_dtype = "int16"
    cos = _row_cosines(on_dev, on_host)
    _log(f"[laser] --upload_precision fp32: --window_assembly device against host, per-row "
         f"cosine min {cos.min():.8f}, max abs difference {np.abs(on_dev - on_host).max():.3e}"
         f"{' (bit-equal)' if np.array_equal(on_dev, on_host) else ''}")
    if cos.min() < UPLOAD_MIN_COSINE:
        raise AssertionError(f"device and host assembly: min cosine {cos.min()} < "
                             f"{UPLOAD_MIN_COSINE}")
    return {"paths": paths, "lines": lines, "waveform": waveform, "emb_dir": out,
            "graphs": {**turns, "capture_s": capture_s, "pool_bytes": pool_bytes},
            "norm_launches": norm_launches}


def _span_chunks(model, spans, n_samples):
    """{bucket: chunks} of ``model``'s encode_spans over ``spans``."""
    counts = {}
    for s, e in spans:
        bucket = model._span_plan(s, max(min(e, n_samples) - s, 0))[0]
        counts[bucket] = counts.get(bucket, 0) + 1
    return {b: -(-n // model._rows_per_chunk(b)) for b, n in counts.items()}


def _stage_6_5(kind, model, root, adir, emb_dir, spans, laser, dev):
    """Stage 6.5 through its CLI on the source side of ``adir``'s
    alignments (source spans ``spans``) with the ``kind`` encoder and its
    stage-5.3 rows in ``emb_dir``; the checks of phase_chain. Returns (wall,
    hits, misses, chunks by bucket, log text)."""
    import torch

    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.postprocess import embed_align

    hit_file = embed_output(emb_dir)
    n_hit_rows = _read_rows(hit_file, kind).shape[0]
    out = root / f"ea_{kind}_{adir.name}"
    _reset_launches()
    t0 = time.perf_counter()
    embed_align.main([str(laser["paths"]["metadata"]), str(out), "--align_dir", str(adir),
                      "--seg_dir", str(root / "segments"),
                      "--concat_seg_dir", str(root / "cat_segs"),
                      "--concat_seg_embed_dir", str(emb_dir), "--embed_model_type", kind,
                      "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG, "--device", dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = _launches(), dict(w2v_bert.ATTENTION_CALLS)
    name = f"{STEM}_{SRC_LANG}-{STEM}_{TGT_LANG}.src"
    tsv = (out / f"{SRC_LANG}-{TGT_LANG}" / f"{name}.tsv").read_text().splitlines()
    if len(tsv) != len(spans):
        raise AssertionError(f"6.5 {kind}: {len(tsv)} tsv lines for {len(spans)} alignments")
    miss_file = out / f"{SRC_LANG}-{TGT_LANG}" / f"{name}.embed"
    hits, misses = 0, []
    for i, line in enumerate(tsv):
        path, row = line.split("\t")
        row = int(row)
        if path == hit_file.as_posix():
            if not (0 <= row < n_hit_rows and laser["lines"][row] == "%d %d" % spans[i]):
                raise AssertionError(f"6.5 {kind}: line {i} points at stage-5.3 row {row}, "
                                     "which is not its span")
            hits += 1
        elif path == miss_file.as_posix():
            misses.append((i, row))
        else:
            raise AssertionError(f"6.5 {kind}: line {i} points at {path}")
    msg = ""
    if misses:
        got = _read_rows(miss_file, kind)
        if max(r for _, r in misses) >= len(got) or not np.isfinite(got).all():
            raise AssertionError(f"6.5 {kind}: a miss row is out of its file ({len(got)} rows) "
                                 "or not finite")
        longest = max(misses, key=lambda m: spans[m[0]][1] - spans[m[0]][0])
        sample = sorted(set(misses[:: max(1, len(misses) // MISS_SAMPLES)][:MISS_SAMPLES - 1]
                            + [longest]))
        want = model.encode_spans(laser["waveform"], [spans[i] for i, _ in sample],
                                  fp16_pull=True)
        cos = _row_cosines(got[[r for _, r in sample]], want.astype(np.float32))
        if cos.min() < SPAN_MIN_COSINE:
            raise AssertionError(f"6.5 {kind}: miss rows against encode_spans, min cosine "
                                 f"{cos.min()} < {SPAN_MIN_COSINE}")
        secs = [(spans[i][1] - spans[i][0]) / 16000 for i, _ in misses]
        msg = (f"; miss spans {min(secs):.2f}-{max(secs):.2f} s, {len(got)} finite rows, "
               f"{len(sample)} against encode_spans: cosine min {cos.min():.6f}")
    chunks = _span_chunks(model, [spans[i] for i, _ in misses], DOC_SECONDS * 16000)
    if kind == "sonar":
        want_launches = model.config.n_layers * sum(chunks.values())
        if launches["relkey_attention"] != want_launches or calls["torch"] != 0:
            raise AssertionError(f"6.5 sonar: relkey_attention launched "
                                 f"{launches['relkey_attention']} times, want {want_launches}; "
                                 f"plain attention {calls['torch']}")
        msg += (f"; relkey_attention launches {launches['relkey_attention']}, plain attention "
                f"calls {calls['torch']}")
    return wall, hits, len(misses), chunks, msg


def phase_chain(workdir, device, laser):
    """The post-align chain on the card, every stage through its CLI:
    stage 5.3 with SpeechLASER on a second document (the target side, seed
    1; both documents' windows written by the stage-5.1 CLI), the stage-4.2
    CLI on both documents' segments (its flags equal to the CPU path's, as
    in :func:`phase_front`), stage 5.2 on its output, stage 5.4 over both,
    stage 6.1 at the cost that keeps ``KEEP_SHARE`` of the non-deletions
    (random weights make the costs meaningless), stage 6.2 on 6.1's output
    (its drops equal to the CPU path's, its survivors byte-equal to their
    lines), then for each of ``CHAIN_TRAFFIC`` stage 6.3
    (``CONCAT_ARGS``), stage 6.4 (``MIN_DUR_S``) and stage 6.5 on 6.4's
    output with SpeechLASER and with SONAR (whose stage 5.3 runs on the
    source side first). On the first traffic the chain then runs to the
    mined tsv (:func:`_chain_mining`): stage 6.5 on the target side, 6.6,
    6.7, 6.8, 6.9 and 6.10 at the pipeline's settings.

    The first traffic is the pipeline's (chains of up to 3 alignments).
    With random weights stage 5.4 aligns one segment to one, so such a
    chain covers at most 3 segments and is a concat window (runs of up to
    5 segments within 20 s): stage 6.5 finds every span among the
    stage-5.3 rows. The second (chains of up to 6) is coverage: its chains
    of 6 segments within 20 s are no window, so stage 6.5 embeds them.
    Checks: 6.1 keeps no deletion and no cost over the limit; 6.3's chains
    are contiguous and within 20 s on both sides; 6.4 keeps only spans of
    ``MIN_DUR_S`` or more; each 6.5 tsv has one line per alignment, hits
    pointing at the stage-5.3 row of the same span, misses into the 6.5
    file's finite rows, of which a sample equals encode_spans of the same
    spans (the coverage traffic must have misses); the SONAR runs launch
    the rel-key kernel 24 times per chunk and the plain attention never.
    Returns {(traffic, encoder): (6.5 wall, hits, misses, chunks)}."""
    import torch

    from svecalign_tpu_torch.postprocess import concat_aligns, filter_by_cost, filter_by_dur
    from svecalign_tpu_torch.seg_align import align, detect_untranslate_concats
    from svecalign_tpu_torch.seg_align import embed as stage
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.file_utils import (
        alignments_to_timestamps, read_alignments, read_alignments_with_score, read_segments)

    dev, root, paths = device.type, Path(workdir), laser["paths"]
    tgt_paths, tgt_lines = write_synthetic_document(root, DOC_SECONDS, seed=1, lang=TGT_LANG)
    wall = _run_embed(stage, tgt_paths, laser["emb_dir"], kind="speech_laser", lang=TGT_LANG,
                      device=dev)
    tgt_rows = np.load(embed_output(laser["emb_dir"], TGT_LANG))
    if tgt_rows.shape[0] != len(tgt_lines) or not np.isfinite(tgt_rows.astype(np.float32)).all():
        raise AssertionError(f"target .embed: {tgt_rows.shape}, want {len(tgt_lines)} finite rows")
    n_src, n_tgt = paths["n_segments"], tgt_paths["n_segments"]
    _log(f"[chain] target side: {n_tgt} segments, {len(tgt_lines)} windows, LASER stage 5.3 "
         f"{wall:.3f}s wall; source side: {n_src} segments, {len(laser['lines'])} windows")

    langs = ["--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG]
    pair = f"{STEM}_{SRC_LANG}-{STEM}_{TGT_LANG}"
    src_segs = read_segments(root / "segments" / SRC_LANG / f"{STEM}_{SRC_LANG}.txt")
    tgt_segs = read_segments(root / "segments" / TGT_LANG / f"{STEM}_{TGT_LANG}.txt")
    audio = (paths["wav"], tgt_paths["wav"])
    wall, flags = run_untrans_segs(paths, root / "untrans_segs", dev)
    _, cpu_flags = run_untrans_segs(paths, root / "untrans_segs_cpu", "cpu")
    mses = untrans_candidates(src_segs, tgt_segs, *audio)
    _verdicts_agree("chain stage 4.2", flags, cpu_flags, mses)
    t0 = time.perf_counter()
    detect_untranslate_concats.main([str(paths["metadata"]), str(root / "untrans_cats"),
                                     "--seg_dir", str(root / "segments"),
                                     "--identical_seg_dir", str(root / "untrans_segs")] + langs)
    wall52 = time.perf_counter() - t0
    ign = [(root / "untrans_cats" / f"{SRC_LANG}-{TGT_LANG}" / f"{pair}.{side}.txt")
           .read_text().splitlines() for side in ("src", "tgt")]
    _log(f"[chain] stage 5.2 on a stage-4.2 output of {len(flags)} flagged pairs ({len(mses)} "
         f"candidates past the duration gate; the CLI on {dev} {wall:.3f}s, its flags equal "
         f"to the CPU path's): ignore files of {len(ign[0])} and {len(ign[1])} windows, "
         f"{wall52:.3f}s wall")

    _reset_launches()
    t0 = time.perf_counter()
    align.main([str(paths["metadata"]), str(root / "align"), "--src_lang", SRC_LANG,
                "--tgt_lang", TGT_LANG, "--seg_dir", str(root / "segments"),
                "--concat_dir", str(root / "cat_segs"), "--embed_dir", str(laser["emb_dir"]),
                "--is_stopes_embed", "-a", "6", "--ign_indices_dir", str(root / "untrans_cats"),
                "--device", dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans, costs = read_output(output_path(root / "align"))
    if not _spans_cover(spans, n_src, n_tgt):
        raise AssertionError("stage 5.4 does not cover both documents in order")
    kept_costs = [c for (x, y), c in zip(spans, costs) if x != "[]" and y != "[]"]
    max_cost = float(np.quantile(kept_costs, KEEP_SHARE))
    _log(f"[chain] stage 5.4 (-a 6, LASER stopes rows): {wall:.3f}s wall, launches "
         f"{_launches()}, {len(spans)} alignments, {len(spans) - len(kept_costs)} deletions, "
         f"costs {min(kept_costs):.4f}-{max(kept_costs):.4f}")

    seg_args = ["--seg_dir", str(root / "segments")]
    t0 = time.perf_counter()
    filter_by_cost.main([str(paths["metadata"]), str(root / "align_f"), "--align_dir",
                         str(root / "align"), "--max_cost", repr(max_cost)] + langs)
    wall = time.perf_counter() - t0
    kept = read_alignments_with_score(output_path(root / "align_f"))
    if not kept or any(not x or not y or c > max_cost for x, y, c in kept):
        raise AssertionError("stage 6.1 kept a deletion or a cost over its limit, or nothing")
    _log(f"[chain] stage 6.1 at --max_cost {max_cost:.6f} (the {KEEP_SHARE} quantile of the "
         f"non-deletion costs): kept {len(kept)} of {len(spans)}, no deletion, no cost over "
         f"the limit, {wall:.3f}s wall")
    lines = output_path(root / "align_f").read_text().splitlines()
    wall, survivors = run_untrans_align(paths, root / "align_f", root / "align_u", dev)
    _, cpu_survivors = run_untrans_align(paths, root / "align_f", root / "align_u_cpu", "cpu")
    dropped = dropped_rows("chain stage 6.2", lines, survivors)
    mses = align_mses([(a, b) for a, b, _ in kept], src_segs, tgt_segs, *audio)
    _verdicts_agree("chain stage 6.2", dropped,
                    dropped_rows("chain stage 6.2 CPU", lines, cpu_survivors), mses)
    kept = read_alignments_with_score(output_path(root / "align_u"))
    _log(f"[chain] stage 6.2 on {dev}: dropped {len(dropped)} of {len(lines)} ({len(mses)} "
         f"past the duration gate), the survivors byte-equal to their lines, drops equal to "
         f"the CPU path's, {wall:.3f}s wall")
    anchors = {(tuple(a), tuple(b)) for a, b, _ in kept}

    def secs(segs, ids):
        return (segs[ids[-1]][1] - segs[ids[0]][0]) / 16000

    sonar_emb = root / "emb_sonar"
    wall = _run_embed(stage, paths, sonar_emb, kind="sonar", device=dev)
    _log(f"[chain] SONAR stage 5.3 on the source side: {wall:.3f}s wall")
    models = {kind: embed_model_utils.load_embed_model(kind, max_tokens=150 * 16000,
                                                       device=device)
              for kind in ("speech_laser", "sonar")}

    result = {}
    for label, max_num in CHAIN_TRAFFIC:
        cdir, ddir = root / f"align_c{max_num}", root / f"align_d{max_num}"
        t0 = time.perf_counter()
        concat_aligns.main([str(paths["metadata"]), str(cdir), "--max_num_align", str(max_num),
                            *CONCAT_ARGS, "--align_dir", str(root / "align_u")]
                           + seg_args + langs)
        host = {"6.3": time.perf_counter() - t0}
        t0 = time.perf_counter()
        filter_by_dur.main([str(paths["metadata"]), str(ddir), "--align_dir", str(cdir),
                            "--min_dur", str(MIN_DUR_S)] + seg_args + langs)
        host["6.4"] = time.perf_counter() - t0
        chained = read_alignments(output_path(cdir))
        final = read_alignments(output_path(ddir))
        for x, y in chained:
            if x != list(range(x[0], x[-1] + 1)) or y != list(range(y[0], y[-1] + 1)):
                raise AssertionError(f"stage 6.3 wrote a chain that is not contiguous: {x}:{y}")
        longer = [(x, y) for x, y in chained if (tuple(x), tuple(y)) not in anchors]
        if any(max(secs(src_segs, x), secs(tgt_segs, y)) > 20.0 for x, y in longer):
            raise AssertionError("stage 6.3 chained past 20 s")
        if not final or any(min(secs(src_segs, x), secs(tgt_segs, y)) < MIN_DUR_S
                            for x, y in final):
            raise AssertionError("stage 6.4 kept a span under its floor, or nothing")
        durs = [secs(src_segs, x) for x, _ in final]
        n_segs = [len(x) for x, _ in final]
        _log(f"[chain] {label}: stage 6.3 (--max_num_align {max_num} {' '.join(CONCAT_ARGS)}) "
             f"{len(chained)} alignments, {len(longer)} of them chains; stage 6.4 (--min_dur "
             f"{MIN_DUR_S}) kept {len(final)}, source spans {min(durs):.2f}-{max(durs):.2f} s "
             f"of {min(n_segs)}-{max(n_segs)} segments; host walls "
             + ", ".join(f"{k} {v:.3f}s" for k, v in host.items()))
        src_spans = alignments_to_timestamps(final, src_segs, tgt_segs, ignore_empty=False)[0]
        for kind, emb_dir in (("speech_laser", laser["emb_dir"]), ("sonar", sonar_emb)):
            wall, hits, misses, chunks, msg = _stage_6_5(kind, models[kind], root, ddir,
                                                         emb_dir, src_spans, laser, dev)
            if label == "coverage" and not misses:
                raise AssertionError(f"6.5 {kind} on the coverage traffic embedded nothing")
            result[label, kind] = (wall, hits, misses, chunks)
            _log(f"[chain] {label}: stage 6.5 {kind} on the 6.4 output: {wall:.3f}s wall, "
                 f"{len(final)} tsv lines: {hits} hits at their stage-5.3 rows, {misses} misses "
                 f"in {sum(chunks.values())} chunks {dict(sorted(chunks.items()))}" + msg)
        if label == CHAIN_TRAFFIC[0][0]:
            _chain_mining(root, paths, ddir, final, src_segs, tgt_segs, laser, dev)
    return result


def _chain_mining(root, paths, ddir, final, src_segs, tgt_segs, laser, dev):
    """The chain's end, through the CLIs at svecalign_tpu/pipeline.py's
    settings: stage 6.5 with SpeechLASER on the target side (its source
    side ran in phase_chain, into the same directory), 6.6 for both
    languages (``--embed_fp16 --embed_stopes --sample_ratio 0.5``), 6.7
    (``--k 16``, ratio margin), 6.8, 6.9 (``OVERLAP_ARGS``) and 6.10.
    Checks: the sorted tsv is in descending margin order, and every row's
    two spans are those of one stage-6.4 alignment (``final``), of the
    pair's two audio files."""
    import torch

    from svecalign_tpu_torch.postprocess import (
        embed_align, prep_index, prep_tsv, remove_overlaps, score_align, sort_tsv)
    from svecalign_tpu_torch.utils import file_utils
    from svecalign_tpu_torch.utils.file_utils import alignments_to_timestamps

    meta, langs = str(paths["metadata"]), ["--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG]
    ea = root / f"ea_speech_laser_{ddir.name}"
    walls = {}
    t0 = time.perf_counter()
    embed_align.main([meta, str(ea), "--align_dir", str(ddir), "--seg_dir",
                      str(root / "segments"), "--concat_seg_dir", str(root / "cat_segs"),
                      "--concat_seg_embed_dir", str(laser["emb_dir"]), "--embed_model_type",
                      "speech_laser", "--use_tgt", "--device", dev] + langs)
    torch.cuda.synchronize()
    walls["6.5 tgt"] = time.perf_counter() - t0
    idx, mrg, tsv = root / "mine_index", root / "mine_margins", root / "mine_tsv"
    t0 = time.perf_counter()
    for use_tgt in ([], ["--use_tgt"]):
        prep_index.main([meta, str(idx), "--data_dir", str(ea), "--embed_fp16",
                         "--sample_ratio", "0.5", "--embed_stopes", "--device", dev]
                        + langs + use_tgt)
    walls["6.6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    score_align.main([meta, str(mrg), "--embed_dir", str(ea), "--align_dir", str(ddir),
                      "--index_dir", str(idx), "--embed_fp16", "--k", str(MINING_K),
                      "--embed_stopes", "--device", dev] + langs)
    walls["6.7"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep_tsv.main([meta, str(tsv), "--align_dir", str(mrg), "--seg_dir", str(root / "segments")]
                  + langs)
    walls["6.8"] = time.perf_counter() - t0
    d = tsv / f"{SRC_LANG}-{TGT_LANG}"
    t0 = time.perf_counter()
    remove_overlaps.main(["--output_dir", str(d), "--output_filename", "align.rm_overlap.tsv.gz",
                          "--mining_result_path", str(d / "align.tsv.gz"), *OVERLAP_ARGS])
    walls["6.9"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sort_tsv.main(["--in_tsv", str(d / "align.rm_overlap.tsv.gz"),
                   "--out_tsv", str(d / "align.rm_overlap.sort.tsv.gz")])
    walls["6.10"] = time.perf_counter() - t0

    src_audio, tgt_audio = file_utils.read_metadata(meta)[0]
    s_times, t_times, _ = alignments_to_timestamps(final, src_segs, tgt_segs, ignore_empty=False)
    spans = {(f"{src_audio} {s0} {s1} 16", f"{tgt_audio} {t0} {t1} 16")
             for (s0, s1), (t0, t1) in zip(s_times, t_times)}
    with file_utils.open(d / "align.tsv.gz") as fp:
        n_mined = sum(1 for _ in fp)
    with file_utils.open(d / "align.rm_overlap.sort.tsv.gz") as fp:
        rows = [line.rstrip("\n").split("\t") for line in fp]
    margins = [float(r[0]) for r in rows]
    if not rows or margins != sorted(margins, reverse=True):
        raise AssertionError("the sorted tsv is empty or not in descending margin order")
    stray = [r for r in rows if (r[1], r[2]) not in spans]
    if stray:
        raise AssertionError(f"{len(stray)} sorted-tsv rows are no stage-6.4 alignment, e.g. "
                             f"{stray[0]}")
    if n_mined != len(final):
        raise AssertionError(f"stage 6.8 wrote {n_mined} rows for {len(final)} alignments")
    _log(f"[chain] mined tsv: 6.7 scored the {len(final)} alignments (margins "
         f"{min(margins):.4f}-{max(margins):.4f} after 6.9), 6.9 kept {len(rows)}, 6.10 sorted "
         "them by margin; every row's spans are a stage-6.4 alignment's; walls "
         + ", ".join(f"{k} {v:.3f}s" for k, v in walls.items()))


def phase_sonar_long_spans(device, waveform):
    """SONAR's encode_spans over spans of LONG_SPAN_SECONDS (the 3000,
    4500 and 6000-frame buckets, T = 1500-3000 in the trunk), twice: the
    rel-key kernel 24 times per chunk, then the plain attention path at 4
    rows a chunk; rows per-row cosine >= MIN_COSINE. Kernel coverage: the
    pipeline's stage 6.3 chains stop at 20 s, so stage 6.5 reaches these
    buckets only where one alignment is that long. Returns the kernel
    run's chunks by bucket."""
    import torch

    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.utils import embed_model_utils

    model = embed_model_utils.load_embed_model("sonar", max_tokens=150 * 16000, device=device)
    spans = [(k * 70 * 16000, (k * 70 + sec) * 16000)
             for k, sec in enumerate(LONG_SPAN_SECONDS * 2)]
    chunks = _span_chunks(model, spans, len(waveform))
    _reset_launches()
    t0 = time.perf_counter()
    got = model.encode_spans(waveform, spans)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launches()["relkey_attention"]
    if n != model.config.n_layers * sum(chunks.values()) or w2v_bert.ATTENTION_CALLS["torch"]:
        raise AssertionError(f"long spans: relkey_attention launched {n} times for chunks "
                             f"{chunks}; plain {w2v_bert.ATTENTION_CALLS['torch']}")
    batch_size = model.batch_size
    model.model.trunk.set_attention_backend("torch")
    model.batch_size = 4
    try:
        plain = model.encode_spans(waveform, spans, eager=True)  # no graphs kept of it
    finally:
        model.model.trunk.set_attention_backend("auto")
        model.batch_size = batch_size
    cos = _row_cosines(got, plain)
    _log(f"[long] SONAR encode_spans over {len(spans)} spans of {sorted(set(LONG_SPAN_SECONDS))} s "
         f"(chunks by frame bucket {dict(sorted(chunks.items()))}): {wall:.3f}s wall, "
         f"relkey_attention launches {n}; against the plain attention path per-row cosine min "
         f"{cos.min():.6f}, all finite {bool(np.isfinite(got).all())}")
    if cos.min() < MIN_COSINE or not np.isfinite(got).all():
        raise AssertionError(f"long spans: min cosine {cos.min()} < {MIN_COSINE}")
    return chunks


LONG_BUCKETS = (3000, 4500, 6000)  # SONAR frame buckets of spans of 20-60 s


def phase_long_attention_times(device, chunks, n_layers=24, batch=16, heads=16):
    """The kernel against SDPA and its bound at the long buckets, B = 16
    rows of ragged lengths (half to all of T); launches are those of the
    long-span run (``phase_sonar_long_spans``)."""
    rng = np.random.default_rng(5)
    for bucket in LONG_BUCKETS:
        T = bucket // 2
        lens = tuple(int(x) for x in rng.integers(T // 2, T + 1, batch))
        _time_attention_bucket(bucket, lens, heads, n_layers * chunks.get(bucket, 0), device)


# ---------------------------------------------------------------------------
# Mining: stages 6.6 and 6.7 at a corpus size users run
# ---------------------------------------------------------------------------

MINING_PAIRS = 100  # hour-scale document pairs of one language pair's corpus
MINING_ROWS = 1 << 18  # alignments a language: ~2,600 a pair (the chain's 455 on 10 minutes, x6)
MINING_SUBSET_PAIRS = 12
MINING_SUBSET_ROWS = 1 << 15  # the IVF, int8 and fp16-upload coverage runs
MINING_DIM = 1024
MINING_K = 16  # svecalign_tpu/pipeline.py's --knn_k
MINING_IVF = "IVF256"
PLANTED_NOISE = 1.0  # a planted pair: one latent vector plus noise of the same scale, per side
MARGIN_CHECK_ROWS = 4096  # margins held against a float64 recomputation on the card
MARGIN_RTOL = 1e-5
MIN_PLANTED_SHARE = 0.99  # of planted pairs whose ratio margin is over 1
CHEAP_TIER_TOL = (0.03, 1e-3)  # rtol, atol: int8 corpus / fp16 upload against fp32 margins
PREP_ARGS = ("--embed_fp16", "--embed_stopes", "--sample_ratio", "0.5")  # pipeline.py's 6.6


def write_mining_corpus(root, n_pairs, n_rows, dim, seed):
    """Stage 6.5's output for a corpus, in the layout stages 6.6 and 6.7
    read (as ``tests/test_fused.py::_write_mining_fixture`` writes it):
    ``metadata.tsv``; per pair and side a stopes fp16 ``.npy`` embed file
    ``embeds/{src}-{tgt}/{pair}.{side}.embed`` and its pointer tsv, one
    line per row; per pair an alignment file ``aligns/{src}-{tgt}/`` of
    ``[i]:[i]``. ``n_rows`` rows a language over ``n_pairs`` pairs; row i
    of a pair's two sides is one latent vector plus independent noise of
    the same scale (the planted pairs). Returns the per-pair row counts."""
    from svecalign_tpu_torch.utils.embedding_utils import write_stopes_embedding

    root = Path(root)
    embed_dir = root / "embeds" / f"{SRC_LANG}-{TGT_LANG}"
    align_dir = root / "aligns" / f"{SRC_LANG}-{TGT_LANG}"
    embed_dir.mkdir(parents=True, exist_ok=True)
    align_dir.mkdir(parents=True, exist_ok=True)
    meta, sizes = [], []
    for p, sides in enumerate(mining_pair_rows(n_pairs, n_rows, dim, seed)):
        n = len(sides["src"])
        sizes.append(n)
        src, tgt = f"MINE-{p:03d}_{SRC_LANG}", f"MINE-{p:03d}_{TGT_LANG}"
        pid = f"{src}-{tgt}"
        meta.append(f"/audio/{SRC_LANG}/{src}.wav\t/audio/{TGT_LANG}/{tgt}.wav\n")
        for side, rows in sides.items():
            path = embed_dir / f"{pid}.{side}.embed"
            write_stopes_embedding(rows, str(path), fp16=True)
            (embed_dir / f"{pid}.{side}.tsv").write_text(
                "".join(f"{path.as_posix()}\t{i}\n" for i in range(n)))
        (align_dir / f"{pid}.txt").write_text("".join(f"[{i}]:[{i}]\n" for i in range(n)))
    (root / "metadata.tsv").write_text("".join(meta))
    return sizes


def mining_pair_rows(n_pairs, n_rows, dim, seed):
    """The rows of :func:`write_mining_corpus`, pair by pair, as fp32
    ``{"src": rows, "tgt": rows}`` before the fp16 file write."""
    rng = np.random.default_rng(seed)
    for p in range(n_pairs):
        n = n_rows // n_pairs + (p < n_rows % n_pairs)
        latent = rng.standard_normal((n, dim), dtype=np.float32)
        yield {side: latent + PLANTED_NOISE * rng.standard_normal((n, dim), dtype=np.float32)
               for side in ("src", "tgt")}


def _mining_rows(root, side, sizes):
    """The corpus rows of one side, fp32, in metadata order."""
    d = Path(root) / "embeds" / f"{SRC_LANG}-{TGT_LANG}"
    return np.concatenate([
        np.load(d / f"MINE-{p:03d}_{SRC_LANG}-MINE-{p:03d}_{TGT_LANG}.{side}.embed")
        .astype(np.float32) for p in range(len(sizes))])


def _run_prep_index(root, out, dev, extra=()):
    from svecalign_tpu_torch.postprocess import prep_index

    t0 = time.perf_counter()
    for use_tgt in ([], ["--use_tgt"]):
        prep_index.main([str(root / "metadata.tsv"), str(root / out), "--data_dir",
                         str(root / "embeds"), "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG,
                         *PREP_ARGS, *use_tgt, *extra, "--device", dev])
    return time.perf_counter() - t0


def _run_score_align(root, index, out, dev, extra=(), mesh=None):
    """Stage 6.7 through its CLI (``mesh``: the devices of
    ``--sharded_index``); returns (wall, margins in metadata order as
    np.float32, alignment columns)."""
    from svecalign_tpu_torch.postprocess import score_align

    t0 = time.perf_counter()
    score_align.main([str(root / "metadata.tsv"), str(root / out), "--embed_dir",
                      str(root / "embeds"), "--align_dir", str(root / "aligns"), "--src_lang",
                      SRC_LANG, "--tgt_lang", TGT_LANG, "--index_dir", str(root / index),
                      "--embed_fp16", "--embed_stopes", "--k", str(MINING_K), *extra,
                      "--device", dev], mesh=mesh)
    return (time.perf_counter() - t0, *_read_margins(root, out))


def _read_margins(root, out):
    """(margins in metadata order as np.float32, alignment columns) of a
    stage-6.7 output ``root / out``."""
    d = root / out / f"{SRC_LANG}-{TGT_LANG}"
    cols, margins = [], []
    for line in (root / "metadata.tsv").read_text().splitlines():
        src, tgt = (Path(x).stem for x in line.split("\t"))
        for row in (d / f"{src}-{tgt}.txt").read_text().splitlines():
            head, margin = row.rsplit(":", 1)
            cols.append(head)
            margins.append(margin)
    return np.asarray(margins, dtype=np.float32), cols


def _float64_margins(device, x, y, rows, k, chunk=1024):
    """Ratio margins of ``rows`` from scratch in float64 on ``device``:
    squared L2 to every corpus row, the k smallest, their mean cosine in
    both directions. ``x``/``y`` are the L2-normalized fp32 corpora."""
    import torch

    xc = torch.from_numpy(x).to(device, torch.float64)
    yc = torch.from_numpy(y).to(device, torch.float64)
    out = []
    for r0 in range(0, len(rows), chunk):
        r = torch.from_numpy(np.asarray(rows[r0:r0 + chunk])).to(device)
        qx, qy = xc[r], yc[r]
        avg = []
        for q, corpus in ((qx, yc), (qy, xc)):
            d2 = (q * q).sum(1, keepdim=True) + (corpus * corpus).sum(1)[None] \
                - 2.0 * q @ corpus.T
            avg.append((2.0 - torch.topk(d2, k, dim=1, largest=False).values.mean(1)) / 2.0)
            del d2
        out.append(((qx * qy).sum(1) / ((avg[0] + avg[1]) / 2.0)).cpu().numpy())
    return np.concatenate(out)


def _mining_gate_planted(what, margins):
    share = float(np.mean(margins > 1.0))
    if share < MIN_PLANTED_SHARE:
        raise AssertionError(f"{what}: {share:.4f} of the planted pairs have a ratio margin "
                             f"over 1, want >= {MIN_PLANTED_SHARE}")
    return share


def phase_mining(workdir, device):
    """Stages 6.6 and 6.7 through their CLIs on the card, at the
    pipeline's settings (``PREP_ARGS``; ``--k 16``, ratio margin) on a
    synthetic corpus of ``MINING_PAIRS`` pairs, ``MINING_ROWS`` rows a
    language: the Flat tier (the size rule's choice), searched tiled.
    Both stages run twice (first and warm walls); the warm 6.7 reports its
    peak device memory. Gates: ``Flat.populate.idx`` read back equals the
    L2-normalized rows; ``MARGIN_CHECK_ROWS`` sampled margins equal a
    float64 recomputation on the card within ``MARGIN_RTOL``; at least
    ``MIN_PLANTED_SHARE`` of the planted pairs score over 1. Then one
    direction's search alone, split into products, top-k and merge
    (``SVECALIGN_SEARCH_PROFILE=1``), against the fp32 bound. Coverage on
    a ``MINING_SUBSET_ROWS``-row corpus: ``MINING_IVF`` at the full probe
    equals Flat within ``MARGIN_RTOL``, at the default probe passes the
    planted gate; two k-means trainings on one sample give bit-equal
    centroids; ``--corpus_quant int8`` and ``--query_upload fp16`` stay
    within ``CHEAP_TIER_TOL`` of the fp32 margins. Returns the numbers."""
    import torch

    from svecalign_tpu_torch.ops import topk
    from svecalign_tpu_torch.postprocess import prep_index, score_align
    from svecalign_tpu_torch.utils import trace
    from svecalign_tpu_torch.utils.embedding_utils import load_sent_embeddings
    from svecalign_tpu_torch.utils.index_utils import load_index, read_flat_index

    dev, root = device.type, Path(workdir) / "mining"
    t0 = time.perf_counter()
    sizes = write_mining_corpus(root, MINING_PAIRS, MINING_ROWS, MINING_DIM, seed=200)
    n = sum(sizes)
    _log(f"[mining] wrote a corpus of {len(sizes)} pairs, {n} rows a language "
         f"({min(sizes)}-{max(sizes)} a pair, {MINING_DIM}-d fp16 stopes rows), in "
         f"{time.perf_counter() - t0:.1f}s")

    walls = {}
    for run in ("first", "warm"):
        with _env(SVECALIGN_SEARCH_PROFILE="1" if run == "warm" else "0"):
            walls["6.6", run] = _run_prep_index(root, "index", dev)
    prep_phases = dict(prep_index.phase_seconds)
    x_rows, y_rows = _mining_rows(root, "src", sizes), _mining_rows(root, "tgt", sizes)
    x, y = topk.normalize_l2(x_rows), topk.normalize_l2(y_rows)
    del x_rows, y_rows
    for lang, want in ((SRC_LANG, x), (TGT_LANG, y)):
        path = root / "index" / f"{SRC_LANG}-{TGT_LANG}" / lang / "Flat.populate.idx"
        if not np.array_equal(read_flat_index(path), want):
            raise AssertionError(f"{path} is not the L2-normalized rows")
    _log(f"[time] stage 6.6 (Flat, both languages): first {walls['6.6', 'first']:.3f}s, warm "
         f"{walls['6.6', 'warm']:.3f}s wall; warm phases of the second language "
         + ", ".join(f"{k} {v:.3f}s" for k, v in prep_phases.items())
         + "; Flat.populate.idx equals the L2-normalized rows (both languages)")

    walls["6.7", "first"], _, _ = _run_score_align(root, "index", "margins_first", dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with _env(SVECALIGN_SEARCH_PROFILE="1"):
        walls["6.7", "warm"], margins, _ = _run_score_align(root, "index", "margins", dev)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    phases = dict(score_align.phase_seconds)
    if margins.shape != (n,) or not np.isfinite(margins).all():
        raise AssertionError(f"stage 6.7: {margins.shape} margins, want {n} finite ones")
    share = _mining_gate_planted("stage 6.7 (Flat)", margins)
    rows = np.sort(np.random.default_rng(7).choice(n, size=min(MARGIN_CHECK_ROWS, n),
                                                    replace=False))
    t0 = time.perf_counter()
    want = _float64_margins(device, x, y, rows, MINING_K)
    rel = np.abs(margins[rows] - want) / np.abs(want)
    if rel.max() > MARGIN_RTOL:
        raise AssertionError(f"stage 6.7 margins against float64: max relative error "
                             f"{rel.max():.3e} > {MARGIN_RTOL}")
    flops = 2 * 2.0 * n * n * MINING_DIM  # both directions
    bound_s = flops / H100_FP32_OPS_PER_S
    _log(f"[time] stage 6.7 (Flat, tiled, k {MINING_K}, {n} queries a direction): first "
         f"{walls['6.7', 'first']:.3f}s, warm {walls['6.7', 'warm']:.3f}s wall; warm phases "
         + ", ".join(f"{k} {v:.3f}s" for k, v in phases.items())
         + f"; search + margins {flops / phases['search'] / 1e12:.2f} TFLOP/s "
         f"({100 * bound_s / phases['search']:.1f}% of the fp32 peak, bound {bound_s:.3f}s); "
         + (f"peak device memory {peak / 2**30:.2f} GiB" if peak is not None
            else "peak device memory not measured (no card)"))
    _log(f"[mining] margins: {share:.4f} of the planted pairs over 1 (median "
         f"{float(np.median(margins)):.4f}); {len(rows)} sampled against float64 on the card: "
         f"max relative error {rel.max():.3e} ({time.perf_counter() - t0:.1f}s)")

    # one direction's search alone, split by phase
    index = load_index(root / "index" / f"{SRC_LANG}-{TGT_LANG}" / TGT_LANG /
                       "Flat.populate.idx", device=device)
    index.search(x[:score_align.CHUNK_ROWS], MINING_K)  # upload the corpus, warm up
    trace.reset()
    os.environ["SVECALIGN_SEARCH_PROFILE"] = "1"
    try:
        t0 = time.perf_counter()
        for q0 in range(0, n, score_align.CHUNK_ROWS):
            index.search(x[q0:q0 + score_align.CHUNK_ROWS], MINING_K)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["SVECALIGN_SEARCH_PROFILE"]
    # each phase's device seconds on a card (its spans' events), host seconds elsewhere
    split = {k[len("search."):]: t.device_s if dev == "cuda" else t.host_s
             for k, t in trace.totals().items() if k.startswith("search.")}
    one_dir = flops / 2
    _log(f"[time] Flat search, one direction ({n} x {n}, {n // score_align.CHUNK_ROWS or 1} "
         f"chunks of {min(n, score_align.CHUNK_ROWS)} queries, blocks of {index.BLOCK} rows, "
         f"{'device' if dev == 'cuda' else 'host'} seconds by phase): {wall:.3f}s wall; "
         + ", ".join(f"{k} {v:.3f}s" for k, v in split.items())
         + f"; products {one_dir / split['products'] / 1e12:.2f} TFLOP/s against "
         f"{H100_FP32_OPS_PER_S / 1e12:.0f} (fp32, TF32 off), bound {one_dir / H100_FP32_OPS_PER_S:.3f}s")
    del index, x, y
    if dev == "cuda":
        torch.cuda.empty_cache()

    # coverage on a subset corpus
    sub = root / "subset"
    sub_sizes = write_mining_corpus(sub, MINING_SUBSET_PAIRS, MINING_SUBSET_ROWS, MINING_DIM,
                                    seed=201)
    _run_prep_index(sub, "flat", dev)
    _, flat, cols = _run_score_align(sub, "flat", "m_flat", dev)
    nlist = int(MINING_IVF[3:])
    t0 = time.perf_counter()
    _run_prep_index(sub, "ivf", dev, ["--index_type", MINING_IVF])
    ivf_wall = time.perf_counter() - t0
    cov = {}
    for probe in (str(nlist), "128"):
        wall, got, got_cols = _run_score_align(sub, "ivf", f"m_ivf{probe}", dev,
                                               ["--num_probe", probe])
        if got_cols != cols:
            raise AssertionError(f"{MINING_IVF} --num_probe {probe}: alignment columns differ")
        cov[probe] = (wall, float(np.max(np.abs(got - flat) / np.abs(flat))),
                      _mining_gate_planted(f"{MINING_IVF} --num_probe {probe}", got))
    if cov[str(nlist)][1] > MARGIN_RTOL:
        raise AssertionError(f"{MINING_IVF} at the full probe against Flat: max relative "
                             f"error {cov[str(nlist)][1]:.3e} > {MARGIN_RTOL}")
    sample = topk.normalize_l2(load_sent_embeddings(
        str(sub / "ivf" / f"{SRC_LANG}-{TGT_LANG}" / SRC_LANG / "sample.embed"),
        use_stopes=True))
    cents = []
    for _ in range(2):
        ivf = topk.IVFIndex(dim=MINING_DIM, nlist=nlist, device=device)
        ivf.train(sample)
        cents.append(ivf.centroids)
    if not np.array_equal(cents[0], cents[1]):
        raise AssertionError("two k-means trainings on one sample differ")
    rtol, atol = CHEAP_TIER_TOL
    cheap = {}
    for flag, value in (("--corpus_quant", "int8"), ("--query_upload", "fp16")):
        wall, got, _ = _run_score_align(sub, "flat", f"m_{value}", dev, [flag, value])
        err = np.abs(got - flat)
        if not np.all(err <= atol + rtol * np.abs(flat)):
            raise AssertionError(f"{flag} {value}: margins off the fp32 ones by up to "
                                 f"{err.max():.3e}")
        cheap[value] = (wall, float(err.max()))
    _log(f"[mining] coverage on {sum(sub_sizes)} rows a language: {MINING_IVF} stage 6.6 "
         f"{ivf_wall:.3f}s; stage 6.7 at --num_probe {nlist}: {cov[str(nlist)][0]:.3f}s, max "
         f"relative error to Flat {cov[str(nlist)][1]:.3e}; at --num_probe 128: "
         f"{cov['128'][0]:.3f}s, {cov['128'][2]:.4f} of the planted pairs over 1; two "
         f"trainings ({sample.shape[0]} rows, {nlist} lists) bit-equal; "
         + "; ".join(f"{k}: {w:.3f}s, max margin difference {e:.3e}"
                     for k, (w, e) in cheap.items()))
    return {"walls": walls, "phases": phases, "split": split, "peak": peak, "n": n}


# ---------------------------------------------------------------------------
# Phase 10: the front of the pipeline (stages 4.1, 4.2 and 6.2) at hour scale
# ---------------------------------------------------------------------------


FRONT_SECONDS = 3600  # a plenary side: nothing is cut
FRONT_PLANTED = 20  # untranslated segments planted in the target side
PLANT_MARGIN_S = 0.5  # copied surroundings on each side of a planted segment
MIN_VAD_COVER = 0.5  # of a planted speech segment, by the stage-4.1 segments
MIN_VAD_SHARE = 0.95  # of the planted speech segments so covered
SILERO_SLICE_S = 600  # the stage-4.1 Silero slice held against the CPU path
SILERO_TOL = 1e-4  # speech probabilities, card (nn.LSTM) against CPU (lstm_plain)
PLAIN_LSTM_S = 120  # audio whose features the card's lstm_plain runs over
LSTM_TOL = 1e-5  # nn.LSTM against lstm_plain on the card, hidden outputs
FBANK_TOL = 1e-3  # log-mel, fbank_batch on the card against CPU fbank per segment
FBANK_SAMPLE = 64  # segments of that check
THRES_RTOL = 1e-3  # a verdict may differ between card and CPU only this near the threshold
UNTRANS_THRES = 5.0  # --fbank_dist_thres of stages 4.2 and 6.2 (their default)
DUR_DIFF = {"4.2": 0.1, "6.2": 0.5}  # --dur_diff of each stage (their defaults)
OGG_MIN_SNR_DB = 3.0  # a Vorbis round trip at quality 0.4 (7-18 dB on this traffic)


def front_speech(rng, n, sr=16000):
    """``n`` samples of speech-like sound: a gliding f0 with five harmonics
    of random weights, and noise in a random formant-like band, under a
    syllable-rate envelope."""
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    f0 = rng.uniform(90, 250) * (1 + rng.uniform(-0.3, 0.3) * t / max(float(t[-1]), 1e-3))
    phase = (2 * np.pi * np.cumsum(f0, dtype=np.float64) / sr).astype(np.float32)
    voiced = sum(np.float32(rng.uniform(0.1, 1.0) / h)
                 * np.sin(h * phase + np.float32(rng.uniform(0, 6.3))) for h in range(1, 6))
    m = 1 << (n - 1).bit_length()  # a fast FFT length; the band noise is cut to n
    freqs = np.fft.rfftfreq(m, 1 / sr)
    centre, width = rng.uniform(300, 4000), rng.uniform(200, 1500)
    band = np.fft.irfft(np.fft.rfft(rng.standard_normal(m))
                        * np.exp(-0.5 * ((freqs - centre) / width) ** 2), m)[:n]
    band = (band / (band.std() + 1e-9)).astype(np.float32)
    mix = np.float32(rng.uniform(0.3, 0.9))
    env = 1 + 0.5 * np.sin(np.float32(2 * np.pi * rng.uniform(3, 6)) * t
                           + np.float32(rng.uniform(0, 6.3)))
    taper = (0.5 - 0.5 * np.cos(np.float32(2 * np.pi / max(n - 1, 1)) * np.arange(
        n, dtype=np.float32))) ** np.float32(0.2)
    amp = np.float32(rng.uniform(0.05, 0.3)) * taper * env
    return amp * (mix * voiced / np.float32(1.5) + (1 - mix) * band)


def write_front_pair(root, seconds=FRONT_SECONDS, n_planted=FRONT_PLANTED, seed=300,
                     stem=STEM):
    """A stage-4 input tree: per side a 16 kHz PCM16 WAV
    ``raw_audios/{lang}/{stem}_{lang}.wav`` of :func:`front_speech` over
    :func:`vad_segments` (0.003 noise between), its segments
    ``segments/{lang}/`` (the truth), and ``metadata.tsv``. In the target
    side ``n_planted`` untranslated segments: exact copies of source
    segments' samples at the same spans, with ``PLANT_MARGIN_S`` of copied
    surroundings each side; the target segments the copies overlap are
    cleared, and the copied segment takes their place, so the
    midpoint-nearest target segment of each copied source segment is its
    copy. Returns a dict with the paths, both segment lists and the planted
    (source, target) index pairs."""
    from svecalign_tpu_torch.utils import audio_io

    sr = 16000
    rng = np.random.default_rng(seed)
    root = Path(root)
    segs, waves = {}, {}
    for lang in (SRC_LANG, TGT_LANG):
        segs[lang] = vad_segments(rng, seconds, sr)
        waves[lang] = (0.003 * rng.standard_normal(seconds * sr)).astype(np.float32)
        for s, e in segs[lang]:
            waves[lang][s:e] += front_speech(rng, e - s, sr)
    src, margin = segs[SRC_LANG], int(PLANT_MARGIN_S * sr)
    picks = np.unique(np.linspace(2, len(src) - 3, n_planted).astype(int))
    tgt = segs[TGT_LANG]
    for i in picks:
        lo, hi = src[i][0] - margin, src[i][1] + margin
        waves[TGT_LANG][lo:hi] = waves[SRC_LANG][lo:hi]
        tgt = [(a, b) for a, b in tgt if b <= lo or a >= hi] + [src[i]]
    segs[TGT_LANG] = tgt = sorted(tgt)
    planted = [(int(i), tgt.index(src[i])) for i in picks]
    paths = {"root": root, "metadata": root / "metadata.tsv", "segments": segs,
             "planted": planted}
    for lang in (SRC_LANG, TGT_LANG):
        name = f"{stem}_{lang}"
        wav = root / "raw_audios" / lang / f"{name}.wav"
        wav.parent.mkdir(parents=True, exist_ok=True)
        audio_io.write(str(wav), np.clip(waves[lang], -1.0, 1.0), sr)
        d = root / "segments" / lang
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.txt").write_text("".join(f"{s} {e}\n" for s, e in segs[lang]),
                                       encoding="utf-8")
        paths[lang] = wav
    paths["metadata"].write_text(f"{paths[SRC_LANG]}\t{paths[TGT_LANG]}\n", encoding="utf-8")
    return paths


def vad_cover_share(truth, found, n_samples, hop=160):
    """Share of the ``truth`` spans that the ``found`` spans cover for
    ``MIN_VAD_COVER`` or more of their length (at 10 ms resolution)."""
    mask = np.zeros(n_samples // hop + 1, bool)
    for a, b in found:
        mask[a // hop:-(-b // hop)] = True
    covered = [mask[s // hop:max(e // hop, s // hop + 1)].mean() >= MIN_VAD_COVER
               for s, e in truth]
    return float(np.mean(covered))


def _timed(fn, sync=True):
    import torch

    t0 = time.perf_counter()
    out = fn()
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _first_and_warm(fn, env, sink):
    """``fn(run)`` for run "first" and "warm", the warm one with the phase
    clock of environment variable ``env`` on (its seconds summed into
    ``sink``). Returns ({run: what fn returned}, the warm run's split)."""
    out = {}
    for run in ("first", "warm"):
        os.environ[env] = "1" if run == "warm" else "0"
        sink.clear()
        try:
            out[run] = fn(run)
        finally:
            os.environ.pop(env)
    return out, dict(sink)


def _cpu_mses(span_pairs, src_audio, tgt_audio):
    """The port's CPU path's sliding fbank MSE of each ((s0, s1), (t0, t1))
    span pair."""
    from svecalign_tpu_torch.utils.audio_utils import (
        Segment, batch_segment_fbanks, compute_fbank_dist)

    segs = ([Segment(s0, s1, src_audio) for (s0, s1), _ in span_pairs]
            + [Segment(t0, t1, tgt_audio) for _, (t0, t1) in span_pairs])
    fb = batch_segment_fbanks(segs, device="cpu")
    n = len(span_pairs)
    return [compute_fbank_dist(fb[k], fb[n + k]) for k in range(n)]


def untrans_candidates(src_segs, tgt_segs, src_audio, tgt_audio, dur_diff=DUR_DIFF["4.2"]):
    """{(i, j): CPU MSE} of stage 4.2's candidates: each source segment and
    its midpoint-nearest target segment, within the duration gate."""
    from svecalign_tpu_torch.utils.audio_utils import binary_search

    mids = np.array([(s + e) / 2 for s, e in tgt_segs], dtype=float)
    gate = int(dur_diff * 16000)
    cands = []
    for i, (s, e) in enumerate(src_segs):
        j = binary_search(mids, (s + e) / 2)
        if abs((e - s) - (tgt_segs[j][1] - tgt_segs[j][0])) <= gate:
            cands.append((i, j))
    mses = _cpu_mses([(src_segs[i], tgt_segs[j]) for i, j in cands], src_audio, tgt_audio)
    return dict(zip(cands, mses))


def align_mses(aligns, src_segs, tgt_segs, src_audio, tgt_audio, dur_diff=DUR_DIFF["6.2"]):
    """{row: CPU MSE} of the alignments that pass stage 6.2's duration gate."""
    from svecalign_tpu_torch.utils.file_utils import alignments_to_timestamps

    s_times, t_times, _ = alignments_to_timestamps(aligns, src_segs, tgt_segs,
                                                   ignore_empty=False)
    gate = int(dur_diff * 16000)
    rows = [r for r, (s, t) in enumerate(zip(s_times, t_times))
            if abs((s[1] - s[0]) - (t[1] - t[0])) <= gate]
    mses = _cpu_mses([(s_times[r], t_times[r]) for r in rows], src_audio, tgt_audio)
    return dict(zip(rows, mses))


def _verdicts_agree(what, card, cpu, mses, thres=UNTRANS_THRES):
    """The card's verdicts must equal the CPU path's, except where the CPU
    MSE lies within ``THRES_RTOL`` of the threshold. Returns those."""
    near = {k for k in card ^ cpu if abs(mses.get(k, np.inf) - thres) <= THRES_RTOL * thres}
    if (card ^ cpu) - near:
        raise AssertionError(f"{what}: card and CPU verdicts differ away from the threshold: "
                             f"{sorted((card ^ cpu) - near)[:10]}")
    if near:
        _log(f"[front] {what}: verdicts differ at the threshold, allowed: "
             + ", ".join(f"{k} (CPU MSE {mses[k]:.6f})" for k in sorted(near)))
    return near


def run_untrans_segs(paths, out_dir, dev, extra=()):
    """The stage-4.2 CLI on a tree written by write_front_pair or
    write_synthetic_document; returns its (wall, set of flagged pairs)."""
    from svecalign_tpu_torch.preprocess import detect_untranslate_segs

    wall, _ = _timed(lambda: detect_untranslate_segs.main(
        [str(paths["metadata"]), str(out_dir), "--seg_dir", str(paths["root"] / "segments"),
         "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG, "--device", dev, *extra]))
    d = Path(out_dir) / f"{SRC_LANG}-{TGT_LANG}"
    pair = f"{STEM}_{SRC_LANG}-{STEM}_{TGT_LANG}"
    rows = [(d / f"{pair}.{side}.txt").read_text().split() for side in ("src", "tgt")]
    return wall, {(int(i), int(j)) for i, j in zip(*rows)}


def run_untrans_align(paths, align_dir, out_dir, dev):
    """The stage-6.2 CLI; returns its (wall, output lines, or None where it
    wrote no file)."""
    from svecalign_tpu_torch.postprocess import filter_untrans_align

    wall, _ = _timed(lambda: filter_untrans_align.main(
        [str(paths["metadata"]), str(out_dir), "--align_dir", str(align_dir), "--seg_dir",
         str(paths["root"] / "segments"), "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG,
         "--device", dev]))
    out = output_path(out_dir)
    return wall, (out.read_text().splitlines() if out.exists() else None)


def dropped_rows(what, lines, kept):
    """Rows of ``lines`` that stage 6.2 dropped; its survivors must be the
    other lines, byte for byte and in order."""
    kept = kept or []
    dropped = {r for r, line in enumerate(lines) if line not in set(kept)}
    if kept != [line for r, line in enumerate(lines) if r not in dropped]:
        raise AssertionError(f"{what}: stage 6.2's survivors are not its input lines in order")
    return dropped


def _lstm_bound_s(steps, hidden, handover, alu, clock_hz):
    """Least time of ``steps`` dependent LSTM steps (the layers of a stack
    overlap): a step hands h over to the lanes of the next step's products
    (``handover`` cycles), reduces a ``hidden``-term dot product as a tree
    (log2(hidden) dependent adds), then c = f * c + i * g, tanh(c) and
    h = o * tanh(c) (three more dependent operations after the last add)."""
    return steps * (handover + (np.log2(hidden) + 3) * alu) / clock_hz


def phase_front(workdir, device, seconds=FRONT_SECONDS, n_planted=FRONT_PLANTED,
                latencies=None, clock_hz=H100_SM_CLOCK_HZ):
    """Stages 4.1, 4.2 and 6.2 through their CLIs on a pair written by
    :func:`write_front_pair` (``seconds`` a side, ``n_planted`` planted
    untranslated segments). Stage 4.1 with the energy VAD (both sides) and
    with the Silero v4 graph at its full geometry on seeded random weights
    (source side), first and warm; stage 4.2 on the writer's segments and
    stage 6.2 on alignments that pair each planted copy with its source
    plus 1-1 alignments of the other segments, each on ``device`` (first
    and warm) and with ``--device cpu``. Gates: ``MIN_VAD_SHARE`` of the
    planted speech segments covered by the energy VAD; Silero on the card
    within ``SILERO_TOL`` of the CPU path with ``lstm_plain`` on a
    ``SILERO_SLICE_S`` slice, and nn.LSTM within ``LSTM_TOL`` of
    ``lstm_plain`` on the card; every planted pair flagged by 4.2 and
    dropped by 6.2; card and CPU verdicts equal (:func:`_verdicts_agree`);
    6.2's survivors byte-equal to their input lines; ``fbank_batch`` on
    the card within ``FBANK_TOL`` of CPU ``fbank`` per segment; an .ogg
    round trip where the host's Vorbis libraries load. ``latencies``:
    (handover, alu) cycles of :func:`phase_chain_latencies`, for the
    LSTM's bound. Returns the numbers."""
    import torch

    from svecalign_tpu_torch.models import vad
    from svecalign_tpu_torch.ops.fbank import fbank, fbank_batch
    from svecalign_tpu_torch.preprocess import segment
    from svecalign_tpu_torch.utils import audio_io, audio_utils
    from svecalign_tpu_torch.utils.file_utils import read_segments

    dev, root = device.type, Path(workdir) / "front"
    hours = seconds / 3600
    t0 = time.perf_counter()
    paths = write_front_pair(root, seconds, n_planted)
    src_segs, tgt_segs = paths["segments"][SRC_LANG], paths["segments"][TGT_LANG]
    planted = set(paths["planted"])
    _log(f"[front] wrote a {seconds} s pair: {len(src_segs)} {SRC_LANG} and {len(tgt_segs)} "
         f"{TGT_LANG} segments, {len(planted)} planted untranslated segments, in "
         f"{time.perf_counter() - t0:.1f}s")
    res = {"hours": hours}

    # stage 4.1, energy VAD (the default), both sides
    walls, found = {}, {}
    for run in ("first", "warm"):
        for lang in (SRC_LANG, TGT_LANG):
            out = root / f"vad_energy_{run}"
            walls[run, lang], _ = _timed(lambda: segment.main(
                [str(paths["metadata"]), str(out), "--lang", lang, "--device", dev,
                 *(["--use_tgt"] if lang == TGT_LANG else [])]))
            found[lang] = read_segments(out / lang / f"{STEM}_{lang}.txt")
    for lang in (SRC_LANG, TGT_LANG):
        share = vad_cover_share(paths["segments"][lang], found[lang], seconds * 16000)
        if share < MIN_VAD_SHARE:
            raise AssertionError(f"stage 4.1 energy, {lang}: {share:.4f} of the planted speech "
                                 f"segments covered {MIN_VAD_COVER} or more, want "
                                 f"{MIN_VAD_SHARE}")
        _log(f"[front] stage 4.1 energy, {lang}: {len(found[lang])} segments found for "
             f"{len(paths['segments'][lang])} planted, {share:.4f} of the planted covered "
             f"{MIN_VAD_COVER} or more; walls first {walls['first', lang]:.3f}s, warm "
             f"{walls['warm', lang]:.3f}s")
    res["4.1 energy"] = {k: v for k, v in walls.items()}

    # stage 4.1, the Silero v4 graph (random seeded weights) on the card
    walls, split = _first_and_warm(lambda run: _timed(lambda: segment.main(
        [str(paths["metadata"]), str(root / f"vad_silero_{run}"), "--lang", SRC_LANG,
         "--vad_model", "silero_jax", "--device", dev]))[0],
        vad.VAD_PROFILE_ENV, vad.vad_seconds)
    n_silero = len(read_segments(root / "vad_silero_warm" / SRC_LANG / f"{STEM}_{SRC_LANG}.txt"))
    model = vad.SileroV4VAD(device=dev)
    wave = audio_utils.load_waveform(paths[SRC_LANG])
    steps = -(-len(wave) // model.window_size) * 6
    bound = None
    if latencies is not None:
        bound = _lstm_bound_s(steps, model.lstm.hidden_size, latencies[0], latencies[1],
                              clock_hz)
    _log(f"[front] stage 4.1 silero_jax on {dev} ({SRC_LANG}, random weights, full v4 "
         f"geometry): {n_silero} segments; walls first {walls['first']:.3f}s, warm "
         f"{walls['warm']:.3f}s; warm split " + ", ".join(f"{k} {v:.3f}s" for k, v in
                                                         split.items())
         + f"; LSTM {steps} steps a layer ({model.lstm.num_layers} layers), "
         f"{steps / split['lstm']:.0f} frames/s"
         + (f", latency bound {bound * 1e3:.3f} ms ({split['lstm'] / bound:.1f}x)"
            if bound else ""))
    res["4.1 silero"] = {"walls": walls, "split": split, "steps": steps, "bound_s": bound}

    sl = wave[:SILERO_SLICE_S * 16000]
    cpu_model = vad.SileroV4VAD(device="cpu")
    t_cpu, want = _timed(lambda: cpu_model.speech_probs(sl, plain_lstm=True), sync=False)
    got = model.speech_probs(sl)
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not err <= SILERO_TOL:
        raise AssertionError(f"Silero on {dev} vs CPU lstm_plain over {SILERO_SLICE_S} s: "
                             f"max difference {err:.3e}, want {SILERO_TOL}")
    chunks, scale = model.quantize(wave[:PLAIN_LSTM_S * 16000])
    with torch.no_grad():
        feats = model.features(torch.from_numpy(chunks).to(model.device).float() * scale)
        seq = feats.reshape(-1, feats.shape[-1])
        lstm_err = float((model.recur(seq) - vad.lstm_plain(seq, model.lstm_layers()))
                         .abs().max())
    if not lstm_err <= LSTM_TOL:
        raise AssertionError(f"nn.LSTM vs lstm_plain on {dev}: max difference {lstm_err:.3e}")
    _log(f"[front] Silero on {dev} against the CPU path with lstm_plain over {len(sl) / 16000:.0f} "
         f"s: max probability difference {err:.3e} (CPU {t_cpu:.1f}s); nn.LSTM against "
         f"lstm_plain on {dev} over {seq.shape[0]} frames: max hidden difference {lstm_err:.3e}")
    res["silero err"], res["lstm err"] = err, lstm_err

    # stage 4.2 on the writer's segment files
    mses = untrans_candidates(src_segs, tgt_segs, paths[SRC_LANG], paths[TGT_LANG])
    resident = torch.cuda.memory_allocated() if dev == "cuda" else 0
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs, split = _first_and_warm(lambda run: run_untrans_segs(paths, root / f"untrans_{run}", dev),
                                  audio_utils.UNTRANS_PROFILE_ENV, audio_utils.untrans_seconds)
    peak = torch.cuda.max_memory_allocated() - resident if dev == "cuda" else 0
    walls = {run: wall for run, (wall, _) in runs.items()}
    flags = runs["warm"][1]
    walls["cpu"], cpu_flags = run_untrans_segs(paths, root / "untrans_cpu", "cpu")
    if planted - flags:
        raise AssertionError(f"stage 4.2 missed planted pairs {sorted(planted - flags)}")
    _verdicts_agree("stage 4.2", flags, cpu_flags, mses)
    q = np.quantile(list(mses.values()), [0, 0.01, 0.5, 0.99, 1]) if mses else []
    _log(f"[front] stage 4.2 on {dev}: {len(flags)} pairs flagged, all {len(planted)} planted "
         f"among them, {len(flags - planted)} unplanted; {len(mses)} candidates past the "
         f"duration gate, CPU MSE quantiles 0/1/50/99/100% "
         + "/".join(f"{v:.3f}" for v in q)
         + f" (threshold {UNTRANS_THRES}); walls first {walls['first']:.3f}s, warm "
         f"{walls['warm']:.3f}s, CPU path {walls['cpu']:.3f}s; warm split "
         + ", ".join(f"{k} {v:.3f}s" for k, v in split.items())
         + f"; peak device memory {peak / 2**20:.1f} MiB above the {resident / 2**20:.1f} "
         "MiB resident before")
    res["4.2"] = {"walls": walls, "split": split, "peak": peak, "flagged": len(flags),
                  "candidates": len(mses)}

    rng = np.random.default_rng(301)
    sample = sorted(rng.choice(len(src_segs), min(FBANK_SAMPLE, len(src_segs)), replace=False))
    waves = [audio_utils.Segment(*src_segs[i], paths[SRC_LANG]).mono() for i in sample]
    got = fbank_batch(waves, device=dev)
    ferr = max(float(np.abs(g - fbank(w, device="cpu")).max()) for g, w in zip(got, waves))
    if not ferr <= FBANK_TOL:
        raise AssertionError(f"fbank_batch on {dev} vs CPU fbank: {ferr:.3e} > {FBANK_TOL}")
    _log(f"[front] fbank_batch on {dev} against CPU fbank per segment, {len(sample)} segments "
         f"({sum(len(g) for g in got)} frames): max log-mel difference {ferr:.3e}")
    res["fbank err"] = ferr

    # stage 6.2: the planted pairs plus 1-1 alignments of the other segments
    others = sorted(zip([i for i in range(len(src_segs)) if i not in {a for a, _ in planted}],
                        [j for j in range(len(tgt_segs)) if j not in {b for _, b in planted}]))
    rows = sorted(list(planted) + others)
    lines = [f"[{i}]:[{j}]:{0.1 + 0.5 * ((7 * i) % 97) / 97:.6f}" for i, j in rows]
    adir = root / "align_6.1" / f"{SRC_LANG}-{TGT_LANG}"
    adir.mkdir(parents=True, exist_ok=True)
    (adir / f"{STEM}_{SRC_LANG}-{STEM}_{TGT_LANG}.txt").write_text("\n".join(lines) + "\n")
    mses62 = align_mses([([i], [j]) for i, j in rows], src_segs, tgt_segs, paths[SRC_LANG],
                        paths[TGT_LANG])
    runs, split = _first_and_warm(
        lambda run: run_untrans_align(paths, root / "align_6.1", root / f"align_6.2_{run}", dev),
        audio_utils.UNTRANS_PROFILE_ENV, audio_utils.untrans_seconds)
    runs["cpu"] = run_untrans_align(paths, root / "align_6.1", root / "align_6.2_cpu", "cpu")
    walls = {run: wall for run, (wall, _) in runs.items()}
    dropped = {run: dropped_rows(f"stage 6.2 {run}", lines, kept)
               for run, (_, kept) in runs.items()}
    card_dropped = dropped["warm"]
    planted_rows = {r for r, ij in enumerate(rows) if ij in planted}
    if planted_rows - card_dropped:
        raise AssertionError(f"stage 6.2 kept planted alignments {sorted(planted_rows - card_dropped)}")
    _verdicts_agree("stage 6.2", card_dropped, dropped["cpu"], mses62)
    _log(f"[front] stage 6.2 on {dev}: {len(lines)} alignments, {len(mses62)} past the "
         f"duration gate, {len(card_dropped)} dropped (all {len(planted_rows)} planted), the "
         f"{len(lines) - len(card_dropped)} survivors byte-equal to their input lines; walls "
         f"first {walls['first']:.3f}s, warm {walls['warm']:.3f}s, CPU path {walls['cpu']:.3f}s; "
         "warm split " + ", ".join(f"{k} {v:.3f}s" for k, v in split.items()))
    res["6.2"] = {"walls": walls, "split": split, "alignments": len(lines),
                  "dropped": len(card_dropped)}

    # .ogg: host IO, no part of the card's path
    seg = audio_utils.Segment(*src_segs[0], paths[SRC_LANG])
    ogg = root / "clip.ogg"
    try:
        seg.save(str(ogg))
    except RuntimeError as e:
        _log(f"[front] .ogg: the host's Vorbis libraries do not load ({e}); no round trip")
        return res
    want = seg.mono()
    got, sr = audio_io.read(str(ogg))
    if audio_io.info(str(ogg)) != (16000, len(want), 1) or sr != 16000:
        raise AssertionError(f".ogg info {audio_io.info(str(ogg))} for {len(want)} samples")
    snr = 10 * np.log10(np.sum(want.astype(np.float64) ** 2)
                        / np.sum((got.astype(np.float64) - want) ** 2))
    if not snr >= OGG_MIN_SNR_DB:
        raise AssertionError(f".ogg round trip SNR {snr:.2f} dB < {OGG_MIN_SNR_DB}")
    _log(f"[front] .ogg round trip of a {len(want) / 16000:.2f} s segment at quality 0.4: info "
         f"equal, SNR {snr:.2f} dB against the WAV samples")
    res["ogg snr"] = snr
    return res


# ---------------------------------------------------------------------------
# Phase 11: the whole graph, svecalign_tpu_torch.pipeline, in one process
# ---------------------------------------------------------------------------

PIPE_SECONDS = 3600  # a plenary side, as in phase 10: nothing is cut
PIPE_SEEDS = (300, 301)  # one hour-long pair per seed
PIPE_PLANTED = 20  # untranslated segments planted in each target side
PIPE_BATCH = 2  # --pair_batch: the two pairs form one bucket
PIPE_OVERLAPS = 5  # -a 6: the id maps hold 5 overlap rows a segment
# device bytes a pipeline run may leave allocated beyond the weights it
# loads: the cuBLAS workspace of a thread's first product (stage 4.2 runs
# on a thread of its own under --overlap_untrans)
MEMORY_SLACK = 64 << 20
SONAR_PIPE_MAX_TOKENS = 150 * 16000  # the SONAR run's --embed_max_tokens (SONAR ignores it;
# the stage-5.3 CLI's default keeps phase 5's loaded model in the memo)


def write_pipeline_corpus(root, seconds=PIPE_SECONDS, n_planted=PIPE_PLANTED, seeds=PIPE_SEEDS):
    """A stage-4 input tree of one :func:`write_front_pair` pair per seed
    (stems ``{STEM}-0``, ``-1``, ...) and one metadata file naming them all.
    Returns (metadata path, [the writer's dict per pair])."""
    root = Path(root)
    pairs, lines = [], []
    for k, seed in enumerate(seeds):
        paths = write_front_pair(root, seconds, n_planted, seed=seed, stem=f"{STEM}-{k}")
        pairs.append(paths)
        lines.append(paths["metadata"].read_text(encoding="utf-8"))
    meta = root / "metadata.tsv"
    meta.write_text("".join(lines), encoding="utf-8")
    return meta, pairs


class _counting:
    """Count the calls of (owner, attribute name) functions in a block."""

    def __init__(self, *targets):
        self.targets = targets
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name)) for owner, name in self.targets]
        for owner, name, fn in self.saved:
            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                return _fn(*args, **kwargs)

            setattr(owner, name, counted)
        return self.calls

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _weight_bytes():
    """Device bytes that every loaded encoder holds for its life: the
    parameters and buffers, and the static inputs and outputs of its CUDA
    graphs (a graph's working memory is in its pool, where it counts as
    free between replays)."""
    from svecalign_tpu_torch.utils import embed_model_utils

    total = 0
    for m in embed_model_utils._model_memo.values():
        tensors = [*m.model.parameters(), *m.model.buffers()]
        for programs in m.__dict__.get("_span_programs", {}).values():
            for prog in programs.programs.values():
                tensors += [*prog.inputs, prog.output]
        total += sum(t.numel() * t.element_size() for t in tensors)
    return total


def run_pipeline(meta, out, dev, extra=()):
    """One in-process run of ``svecalign_tpu_torch.pipeline`` (all 16 stages)
    on ``dev``, with the kernel counters zeroed just before. Returns the
    wall, the pipeline's stage_seconds, the kernel launches, the align
    stage's phase dict, the cache stats, the stage-5.4 upload bytes, and
    device memory: before, after and the peak above before, and the
    loaded weights' bytes before and after."""
    import torch

    from svecalign_tpu_torch import pipeline
    from svecalign_tpu_torch.seg_align import align
    from svecalign_tpu_torch.utils import embed_cache
    from svecalign_tpu_torch.vecalign import batch

    cuda = dev == "cuda"
    for k in embed_cache.stats:
        embed_cache.stats[k] = 0
    up0, w0 = batch.upload_stats["bytes"], _weight_bytes()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    profs = []
    align_main = align.main
    align.main = lambda argv=None: profs.append(align_main(argv)) or profs[-1]
    _reset_launches()
    try:
        t0 = time.perf_counter()
        # the ALIGN spans fill the stage seconds and stage 5.4's phases
        with _env(SVECALIGN_ALIGN_PROFILE="1"):
            pipeline.main([str(meta), str(out), "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG,
                           "--device", dev, *extra])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        align.main = align_main
    return {"wall": wall, "stages": dict(pipeline.stage_seconds), "launches": _launches(),
            "align": profs[0], "stats": dict(embed_cache.stats),
            "upload": batch.upload_stats["bytes"] - up0, "mem_before": mem0,
            "mem_after": torch.cuda.memory_allocated() if cuda else 0,
            "peak": torch.cuda.max_memory_allocated() - mem0 if cuda else 0,
            "weights": (w0, _weight_bytes())}


def _lines_and_scores(path, tsv):
    """(lines without their margin, margins) of a stage-6.7 file or, with
    ``tsv``, a stage-6.8-6.10 ``.tsv.gz``."""
    import gzip

    if tsv:
        with gzip.open(path, "rt", encoding="utf-8") as fp:
            rows = [line.rstrip("\n").split("\t", 1) for line in fp]
        return [r[1] for r in rows], np.array([float(r[0]) for r in rows])
    rows = [line.rsplit(":", 1) for line in Path(path).read_text().splitlines()]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def compare_pipeline_runs(a, b, margin_rtol=0.0, only=None):
    """Hold every file of pipeline output tree ``a`` against ``b``'s: equal
    bytes (``.gz`` once decompressed), but for the out dir inside stage
    6.5's pointer tsvs and, with ``margin_rtol``, the margins of stages
    6.7-6.10: the rest of each line equal, margins within that relative
    tolerance; in the mined tsvs (6.8-6.10) the same rows, in an order that
    may differ between margins that close (stage 6.10 sorts by margin, and
    the check that it did comes from the margins' order in each file).
    ``only``: the top-level directories to compare (default: all).
    Raises AssertionError; returns the number of files compared."""
    import gzip

    a, b = Path(a), Path(b)
    fa, fb = ({p.relative_to(root) for p in root.rglob("*")
               if p.is_file() and (only is None or p.relative_to(root).parts[0] in only)}
              for root in (a, b))
    if fa != fb or not fa:
        raise AssertionError(f"{a} and {b} hold other files: {sorted(fa ^ fb)[:5]}")
    for rel in sorted(fa):
        pa, pb = a / rel, b / rel
        top = rel.parts[0]
        if margin_rtol and (top.endswith("_margin") or top.endswith("_tsvs")):
            tsv = top.endswith("_tsvs")
            (la, ma), (lb, mb) = (_lines_and_scores(p, tsv) for p in (pa, pb))
            if tsv:
                if "sort" in rel.name and (np.any(np.diff(ma) > 0) or np.any(np.diff(mb) > 0)):
                    raise AssertionError(f"{rel}: not in descending margin order")
                order_a, order_b = np.argsort(la, kind="stable"), np.argsort(lb, kind="stable")
                la, ma = [la[i] for i in order_a], ma[order_a]
                lb, mb = [lb[i] for i in order_b], mb[order_b]
            if la != lb:
                raise AssertionError(f"{rel}: {sum(x != y for x, y in zip(la, lb))} lines differ "
                                     f"({len(la)} and {len(lb)} lines)")
            if not np.allclose(ma, mb, rtol=margin_rtol, atol=0):
                err = float(np.max(np.abs(ma - mb) / np.abs(mb)))
                raise AssertionError(f"{rel}: margins {err:.3e} apart, beyond rtol {margin_rtol}")
        elif rel.suffix == ".tsv":
            same = (pa.read_text(encoding="utf-8").replace(str(a), "OUT")
                    == pb.read_text(encoding="utf-8").replace(str(b), "OUT"))
            if not same:
                raise AssertionError(f"{rel}: the pointer tsvs differ")
        elif rel.suffix == ".gz":  # the gzip header holds a time stamp
            if gzip.decompress(pa.read_bytes()) != gzip.decompress(pb.read_bytes()):
                raise AssertionError(f"{rel}: differs")
        elif pa.read_bytes() != pb.read_bytes():
            raise AssertionError(f"{rel}: differs")
    return len(fa)


def mined_duplicates(tsv, pairs, dur_diff=DUR_DIFF["6.2"], thres=UNTRANS_THRES):
    """Untranslated duplicates among the rows of a mined ``.tsv.gz``:
    (rows, rows past stage 6.2's duration gate, rows under the MSE
    threshold there on the CPU path, rows that pair a planted copy with its
    source (both spans within ``dur_diff`` of the copied span), rows whose
    target span overlaps a planted copy). ``pairs``: the writer's dicts."""
    import gzip

    copies = {}
    for p in pairs:
        spans = [p["segments"][SRC_LANG][i] for i, _ in p["planted"]]
        copies[str(p[TGT_LANG])] = (str(p[SRC_LANG]), spans)
    with gzip.open(tsv, "rt", encoding="utf-8") as fp:
        rows = [line.rstrip("\n").split("\t") for line in fp]
    gate, by_doc = int(dur_diff * 16000), {}
    exact = overlapping = 0
    for _, src, tgt in rows:
        s_path, s0, s1, _ = src.rsplit(" ", 3)
        t_path, t0, t1, _ = tgt.rsplit(" ", 3)
        s0, s1, t0, t1 = int(s0), int(s1), int(t0), int(t1)
        for a, b in copies.get(t_path, (None, []))[1]:
            if t0 < b and a < t1:
                overlapping += 1
            if max(abs(s0 - a), abs(s1 - b), abs(t0 - a), abs(t1 - b)) <= gate:
                exact += 1
        if abs((s1 - s0) - (t1 - t0)) <= gate:
            by_doc.setdefault((s_path, t_path), []).append(((s0, s1), (t0, t1)))
    mses = [m for (s_path, t_path), spans in by_doc.items()
            for m in _cpu_mses(spans, s_path, t_path)]
    return len(rows), len(mses), sum(m < thres for m in mses), exact, overlapping


def phase_pipeline(workdir, device, seconds=PIPE_SECONDS, n_planted=PIPE_PLANTED):
    """The whole graph through ``python -m svecalign_tpu_torch.pipeline``'s
    entry point, in this process: all 16 stages on a corpus of
    :func:`write_pipeline_corpus` (two hour-long pairs, ``PIPE_PLANTED``
    planted untranslated segments each), full-width SpeechLASER (random
    weights from seed 0), ``--pair_batch 2``: once unfused, once ``--fused
    --overlap_untrans``. Gates: every file of the two runs equal, margins
    within ``MARGIN_RTOL``; the cache hit for every document, no miss and
    no rejection; the fused align uploads the id maps alone; stage 5.4
    re-run as a separate CLI process on the run's ``.embed`` files writes
    identical alignments; on the card the stage-5.4 kernels launch once a
    bucket and level and the plain DP and walks never run; no mined row is
    an untranslated duplicate by stage 6.2's own test and none pairs a
    planted copy with its source; device memory after the fused run back
    to what it was plus the weights loaded. Then SONAR ``--fused`` on
    phase 7's two 10-minute documents: the rel-key kernel ``n_layers``
    times a chunk and the plain attention never. Logs the walls and stage
    seconds, stage 5.4's phases fused against unfused, peak memory.
    Returns the launches of both pipelines' runs."""
    import torch

    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.models.sonar_encoder import SonarSpeechModel
    from svecalign_tpu_torch.ops import dp as dp_ops
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.file_utils import read_segments

    dev, root = device.type, Path(workdir) / "pipeline"
    cuda = dev == "cuda"
    t0 = time.perf_counter()
    meta, pairs = write_pipeline_corpus(root / "in", seconds, n_planted)
    _log(f"[pipeline] wrote {len(pairs)} pairs of {seconds} s a side, {n_planted} planted "
         f"untranslated segments in each target side, in {time.perf_counter() - t0:.1f}s")

    plain = [(dp_ops, name) for name in ("banded_dp_batched", "dense_dp_batched",
                                         "dense_traceback_walk", "banded_traceback_walk")]
    runs = {}
    for label, flags in (("unfused", []), ("fused", ["--fused", "--overlap_untrans"])):
        with _counting(*plain) as plain_calls:
            runs[label] = run = run_pipeline(meta, root / label, dev,
                                             ["--pair_batch", str(PIPE_BATCH), *flags])
        run["plain"] = dict(plain_calls)
        _log(f"[pipeline] {label} ({' '.join(flags) or 'the defaults'}, --pair_batch "
             f"{PIPE_BATCH}): {run['wall']:.3f}s wall; stage seconds: "
             + " | ".join(f"{k} {v:.3f}" for k, v in run["stages"].items()))
        _log(f"[time] pipeline {label}: {run['wall']:.3f}s wall, stage 5.3 "
             f"{run['stages']['embed']:.3f}s of it "
             f"({100 * run['stages']['embed'] / run['wall']:.1f}%; the encoder by CUDA-graph "
             "replay)")

    sizes = []
    for p in pairs:
        name = Path(p[SRC_LANG]).stem.rsplit("_", 1)[0]
        sizes.append(tuple(len(read_segments(root / "unfused" / "segments" / lang /
                                             f"{name}_{lang}.txt")) for lang in (SRC_LANG, TGT_LANG)))
    plan = bucket_plan(sizes, PIPE_BATCH)
    n_levels = sum(max(depth, 1) for *_, depth in plan)
    want = {"dense_dp": len(plan), "banded_dp": n_levels, "banded_dp_warp": n_levels,
            "banded_dp_block": 0, "dense_traceback_walk": len(plan),
            "banded_traceback_walk": n_levels}
    for label, run in runs.items():
        got = {k: run["launches"][k] for k in want}
        if cuda and (got != want or any(run["plain"].values())):
            raise AssertionError(f"{label}: stage 5.4 launched {got}, want {want} ({len(plan)} "
                                 f"buckets, {n_levels} banded levels); plain calls {run['plain']}")
    _log(f"[pipeline] stage 5.4 on {sizes} segments (stage 4.1's): {len(plan)} bucket(s), "
         f"{n_levels} banded level(s); launches per run {want if cuda else 'none (CPU)'}; plain "
         f"DP and walk calls {runs['unfused']['plain']} and {runs['fused']['plain']}")

    fused, unfused = runs["fused"], runs["unfused"]
    stats = fused["stats"]
    if stats["hit"] != 2 * len(pairs) or stats["miss"] or stats["rejected"] or stats["gather_miss"]:
        raise AssertionError(f"fused run's cache stats {stats}: want a hit for each of the "
                             f"{2 * len(pairs)} documents and no miss or rejection")
    ids_bytes = sum(4 * PIPE_OVERLAPS * len(bp) * (n_pad + m_pad) for bp, n_pad, m_pad, _ in plan)
    if fused["upload"] != ids_bytes:
        raise AssertionError(f"fused stage 5.4 uploaded {fused['upload']} bytes, want the id "
                             f"maps' {ids_bytes}")
    if fused["align"]["fused"] != len(pairs):
        raise AssertionError(f"fused stage 5.4 staged {fused['align']['fused']} pairs from the "
                             "cache")
    n_files = compare_pipeline_runs(root / "unfused", root / "fused", MARGIN_RTOL)
    _log(f"[pipeline] fused against unfused: {n_files} files equal (margins within rtol "
         f"{MARGIN_RTOL}); cache stats {stats}; stage-5.4 uploads {unfused['upload']} bytes "
         f"unfused (rows and id maps), {fused['upload']} fused (the id maps alone)")
    for label, run in runs.items():
        a = run["align"]
        _log(f"[time] stage 5.4 in the {label} pipeline: {run['stages']['align']:.3f}s wall; "
             f"load {a['load']:.3f}s, stage {a['stage']:.3f}s, pyramid {a['pyramid']:.3f}s, "
             f"write {a['write']:.3f}s ({a['buckets']} bucket(s), {a['fused']} pairs from the "
             "cache)")

    # stage 5.4 again, in a process of its own, on the fused run's files
    out = root / "align_rerun"
    argv = [sys.executable, "-m", "svecalign_tpu_torch.seg_align.align", str(meta), str(out),
            "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG,
            "--seg_dir", str(root / "fused" / "segments"),
            "--concat_dir", str(root / "fused" / "cat_segs"),
            "--embed_dir", str(root / "fused" / "embeds"), "--is_stopes_embed", "-a", "6",
            "--ign_indices_dir", str(root / "fused" / "untrans_cat_seg_ids"),
            "--pair_batch", str(PIPE_BATCH), "--device", dev]
    repo = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"stage 5.4 in its own process failed:\n{proc.stderr[-3000:]}")
    n_align = compare_pipeline_runs(root / "fused" / "alignments", out)
    _log(f"[pipeline] stage 5.4 re-run as a separate CLI process on the fused run's .embed files: "
         f"{n_align} alignment files identical ({time.perf_counter() - t0:.1f}s with the "
         "process start)")

    tsv = next((root / "fused").glob(f"*_tsvs/{SRC_LANG}-{TGT_LANG}/align.rm_overlap.sort.tsv.gz"))
    n_rows, n_gated, dups, exact, overlapping = mined_duplicates(tsv, pairs)
    if dups or exact:
        raise AssertionError(f"mined tsv: {dups} untranslated duplicates by stage 6.2's test, "
                             f"{exact} rows pairing a planted copy with its source")
    _log(f"[pipeline] mined tsv: {n_rows} rows; {n_gated} within stage 6.2's duration gate, none "
         f"under its MSE threshold on the CPU path; no row pairs a planted copy with its source; "
         f"{overlapping} row(s) hold part of a planted copy beside other speech (stage 4.1's "
         "segments there differ between the sides, so 4.2 and 6.2 see no duplicate)")

    for label, run in runs.items():
        _log_memory(label, run)
    _check_memory("fused", fused)
    # (cuBLAS's workspaces stay: a captured graph holds the workspace of the
    # stream it was captured on, so none may be dropped while graphs live)

    # SONAR, fused, on phase 7's two 10-minute documents
    sroot = root / "sonar_in"
    write_synthetic_document(sroot, DOC_SECONDS, seed=0)
    paths, _ = write_synthetic_document(sroot, DOC_SECONDS, seed=1, lang=TGT_LANG)
    for k in w2v_bert.ATTENTION_CALLS:
        w2v_bert.ATTENTION_CALLS[k] = 0
    with _counting((SonarSpeechModel, "_span_forward")) as chunks:
        sonar = run_pipeline(paths["metadata"], root / "sonar", dev,
                             ["--embed_model_type", "sonar", "--fused",
                              "--embed_max_tokens", str(SONAR_PIPE_MAX_TOKENS)])
    n_layers = next(m for m in embed_model_utils._model_memo.values()
                    if isinstance(m, SonarSpeechModel)).config.n_layers
    launches = sonar["launches"]["relkey_attention"]
    if launches != n_layers * chunks["_span_forward"] or not chunks["_span_forward"]:
        raise AssertionError(f"SONAR pipeline: {launches} rel-key launches for "
                             f"{chunks['_span_forward']} chunks of {n_layers} layers")
    if w2v_bert.ATTENTION_CALLS["torch"]:
        raise AssertionError(f"SONAR pipeline ran the plain attention: {w2v_bert.ATTENTION_CALLS}")
    s = sonar["stats"]
    if s["hit"] != 2 or s["miss"] or s["rejected"] or s["gather_miss"]:
        raise AssertionError(f"SONAR pipeline's cache stats {s}")
    _log_memory("SONAR", sonar)
    _check_memory("SONAR", sonar)
    _log(f"[pipeline] SONAR --fused on two {DOC_SECONDS} s documents: {sonar['wall']:.3f}s wall; "
         f"{chunks['_span_forward']} chunks, {launches} rel-key launches ({n_layers} a chunk), "
         f"plain attention calls {w2v_bert.ATTENTION_CALLS['torch']}; cache stats {s}; stage "
         "seconds: " + " | ".join(f"{k} {v:.3f}" for k, v in sonar["stages"].items()))
    return {"laser": fused["launches"], "sonar": launches, "plan": plan}


def _log_memory(label, run):
    w0, w1 = run["weights"]
    _log(f"[pipeline] device memory, {label}: {run['mem_before'] / 2**20:.1f} MiB before, "
         f"{run['mem_after'] / 2**20:.1f} MiB after (loaded weights and graph buffers "
         f"{w1 / 2**20:.1f} MiB, {(w1 - w0) / 2**20:.1f} of them new), peak "
         f"{run['peak'] / 2**30:.3f} GiB above before")


def _check_memory(label, run):
    """A fused run leaves nothing on the device but the weights (and graph
    buffers) it loaded."""
    grown = run["mem_after"] - run["mem_before"] - (run["weights"][1] - run["weights"][0])
    if grown > MEMORY_SLACK:
        raise AssertionError(f"{label} pipeline left {grown / 2**20:.1f} MiB on the device beyond "
                             f"the weights it loaded (slack {MEMORY_SLACK >> 20} MiB)")


# ---------------------------------------------------------------------------
# Phase 12: several cards in one process (parallel/mesh.py)
# ---------------------------------------------------------------------------

MULTI_ONE_CARD_SHARDS = 2  # shards of the mesh on a machine of one card
MULTI_MIN_COSINE = 0.999  # data-parallel rows against one device's (bf16 drifts with batch shape)
MULTI_SEARCH_TOL = (1e-4, 1e-5)  # rtol, atol: sharded kNN distances against one device's
MULTI_HOST_DIRS = ("segments", "untrans_segs", "cat_segs", "untrans_cat_seg_ids")
MULTI_PIPE_STAGES = "segment,untrans_segs,concat_segs,untrans_concats,embed"
PIPE_MAX_TOKENS = 600 * 16000  # the pipeline's --embed_max_tokens


def multi_mesh(device):
    """The mesh of phase 12: every card when there are two or more, else
    ``MULTI_ONE_CARD_SHARDS`` shards on the one device. Returns (mesh,
    whether the shards share a device)."""
    import torch

    from svecalign_tpu_torch.parallel.mesh import Mesh, make_mesh

    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        return make_mesh(device="cuda"), False
    first = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" \
        else torch.device("cpu")
    return Mesh([first] * MULTI_ONE_CARD_SHARDS), True


def _multi_kernel_checks(mesh):
    """Phase 2's checks on every card of the mesh that phase 2 did not run
    on (the current device). Returns {device: (banded, dense, attention)
    max abs errors}."""
    import torch

    errs = {}
    for d in dict.fromkeys(mesh.data_devices):
        if d.type != "cuda" or d.index == torch.cuda.current_device():
            continue
        t0 = time.perf_counter()
        with torch.cuda.device(d):
            errs[str(d)] = (phase_kernel_checks(d), phase_dense_checks(d),
                            phase_attention_checks(d))
        _log(f"[multi] kernel checks on {d}: every kernel equal to its plain version (max abs "
             f"errors {errs[str(d)]}) in {time.perf_counter() - t0:.1f}s")
    return errs


def load_bucket_pairs(paths, stems, overlaps=5):
    """(stem, rows0, ids0, rows1, ids1) of each pair written by
    :func:`write_synthetic_corpus`, loaded as the batched stage-5.4 CLI
    loads them (fp16 rows, overlap id maps) and sorted as it buckets them."""
    from svecalign_tpu_torch.utils.embedding_utils import make_doc_ids, read_in_embeddings

    root, out = paths["root"], []
    for stem in stems:
        item = [stem]
        for lang in (SRC_LANG, TGT_LANG):
            name = f"{stem}_{lang}"
            sent2id, rows = read_in_embeddings(
                str(root / "cat_segs" / lang / f"{name}.txt"),
                str(root / "embeds" / lang / f"{name}.embed"), use_stopes=True)
            lines = (root / "segments" / lang / f"{name}.txt").read_text().splitlines(True)
            item += [rows.astype(np.float16),
                     make_doc_ids(sent2id, rows.shape[0], lines, overlaps, overlap_segments=True)]
        out.append(tuple(item))
    out.sort(key=lambda it: it[2].shape[1] + it[4].shape[1])
    return out


def _align_kwargs_cli(alignment_max_size=6, **over):
    """The batched CLI's pyramid arguments at its defaults (``over``
    replaces some)."""
    import math

    from svecalign_tpu_torch.vecalign.vecalign import make_alignment_types

    kw = dict(final_alignment_types=make_alignment_types(alignment_max_size),
              del_percentile_frac=0.2, width_over2=math.ceil((alignment_max_size - 1) / 2) + 5,
              max_size_full_dp=300, costs_sample_size=20000, num_samps_for_norm=100, seed=42)
    kw.update(over)
    return kw


def _multi_align(workdir, device, mesh, sizes, dim, kw, pair_batch=PAIR_BATCH, corpus=None):
    """Stage 5.4's buckets staged over the mesh against the same buckets
    on one device, in paired and in shared mode: every alignment and cost
    bit-equal, and on the card each shard launching the dense DP and walk
    once a bucket and the banded DP and walk once a banded level. Then the
    warm walls per pair, one device and the mesh in turns. ``corpus``:
    (paths, stems) of pairs of ``sizes`` already written (else they are
    written here)."""
    from svecalign_tpu_torch.ops import _build
    from svecalign_tpu_torch.parallel import mesh as mesh_mod
    from svecalign_tpu_torch.vecalign import batch

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    paths, stems = corpus or write_synthetic_corpus(workdir / "corpus", sizes, dim=dim)[:2]
    pairs = load_bucket_pairs(paths, stems)
    buckets = [pairs[k:k + pair_batch] for k in range(0, len(pairs), pair_batch)]
    _log(f"[multi] stage 5.4: {len(pairs)} pairs written and loaded in "
         f"{time.perf_counter() - t0:.1f}s; buckets of {[len(b) for b in buckets]} pairs")
    sharding, n_shards = mesh_mod.batch_sharding(mesh), len(mesh.data_devices)
    plan = bucket_plan(sizes, pair_batch)
    n_levels = sum(max(depth, 1) for *_, depth in plan)
    want = {"dense_dp": len(plan), "dense_traceback_walk": len(plan), "banded_dp": n_levels,
            "banded_dp_warp": n_levels, "banded_traceback_walk": n_levels}

    def run(sampling, sharded):
        return [r for b in buckets for r in batch.run_staged(
            batch.stage_rows_upload([p[1:] for p in b], sharding=sharding) if sharded
            else batch.stage_rows_upload([p[1:] for p in b], device=device),
            sampling=sampling, **kw)]

    def hold(what, got, whole):
        for (stem, *_), (a, c), (wa, wc) in zip(pairs, got, whole):
            if a != wa or not np.array_equal(c, wc):
                k = next((j for j, (x, y) in enumerate(zip(a, wa)) if x != y), None)
                raise AssertionError(
                    f"{what}, {stem}: the sharded bucket differs from the unsharded one (first "
                    f"alignment difference at {k}, max cost difference "
                    f"{np.abs(np.asarray(c) - np.asarray(wc)).max() if len(c) == len(wc) else 'n/a'})")

    for sampling in ("paired", "shared"):
        whole = run(sampling, False)
        _reset_launches()
        _build.SHARD_LAUNCHES.clear()
        got = run(sampling, True)
        per_shard = {k: [_build.SHARD_LAUNCHES[(i, k)] for i in range(n_shards)] for k in want}
        hold(f"{sampling} mode", got, whole)
        if cuda and any(v != [want[k]] * n_shards for k, v in per_shard.items()):
            raise AssertionError(f"{sampling} mode: launches per shard {per_shard}, want "
                                 f"{want} on each of {n_shards} shards")
        _log(f"[multi] stage 5.4, sampling={sampling!r}: {len(pairs)} pairs over {n_shards} shards "
             f"bit-equal to the unsharded buckets (alignments and costs); launches per shard "
             f"{per_shard if cuda else 'none (CPU)'}")

    walls = {"one": [], "mesh": []}
    for label in ("one", "mesh", "mesh", "one"):
        t0 = time.perf_counter()
        got = run("shared", label == "mesh")
        walls[label].append(time.perf_counter() - t0)
        hold(f"shared mode, {label}", got, whole)
    one, multi = (float(np.mean(walls[k])) / len(pairs) for k in ("one", "mesh"))
    _log(f"[time] multi stage 5.4, {len(pairs)} pairs at --pair_batch {pair_batch}, shared "
         f"mode, warm, staging included: one device {one:.4f}s a pair, {n_shards} shards "
         f"{multi:.4f}s a pair ({one / multi:.2f}x); runs "
         + ", ".join(f"{k} {v:.3f}s" for k, vs in walls.items() for v in vs))
    return {"one_s": one, "mesh_s": multi}


def _multi_encode(workdir, device, mesh, seconds, kinds, pipeline_chunks=False):
    """Stage 5.3's encoders on the document of phases 5-7, on one device
    and data-parallel over the mesh, through the model loader the CLI
    calls: every row finite, per-row cosine >= MULTI_MIN_COSINE to the
    one-device rows; SONAR launching the rel-key kernel on every shard for
    every layer of every chunk and the plain attention never. Then warm
    walls per minute of audio, in turns; with ``pipeline_chunks``, LASER
    also at the pipeline's 600 s chunks (``--embed_max_tokens``)."""
    import copy

    import torch

    from svecalign_tpu_torch.models import w2v_bert
    from svecalign_tpu_torch.ops import _build
    from svecalign_tpu_torch.parallel.mesh import Mesh
    from svecalign_tpu_torch.utils import embed_model_utils
    from svecalign_tpu_torch.utils.audio_utils import load_waveform

    cuda = device.type == "cuda"
    paths, lines = write_synthetic_document(workdir / "doc", seconds, seed=0)
    waveform = load_waveform(str(paths["wav"]), sr=16000)
    spans = [tuple(map(int, line.split())) for line in lines]
    n_shards = len(mesh.data_devices)
    out = {}
    for kind in kinds:
        kw = dict(max_tokens=150 * 16000, batch_size=16, upload_precision="int16", device=device)
        t0 = time.perf_counter()
        one = embed_model_utils.load_embed_model(kind, mesh=Mesh([mesh.first]), **kw)
        dp = embed_model_utils.load_embed_model(kind, mesh=mesh, **kw)
        if dp.data_shards != n_shards or one.data_shards != 1:
            raise AssertionError(f"{kind}: {dp.data_shards} and {one.data_shards} data shards")
        _log(f"[multi] {kind}: models on one device and over {n_shards} shards in "
             f"{time.perf_counter() - t0:.1f}s (weights loaded once, then replicated)")

        def encode(model, eager=False):
            t = time.perf_counter()
            rows = model.encode_spans(waveform, spans, fp16_pull=True, eager=eager)
            if cuda:
                for d in dict.fromkeys(mesh.data_devices):
                    torch.cuda.synchronize(d)
            return rows, time.perf_counter() - t

        want, first_one = encode(one)
        _reset_launches()
        _build.SHARD_LAUNCHES.clear()
        with _counting((type(dp), "_span_forward")) as calls:
            got, first_mesh = encode(dp)
        got32 = got.astype(np.float32)
        if got.shape != want.shape or not np.isfinite(got32).all():
            raise AssertionError(f"{kind}: data-parallel rows {got.shape}, want {want.shape}, "
                                 "all finite")
        cos = _row_cosines(got32, want.astype(np.float32))
        if cos.min() < MULTI_MIN_COSINE:
            raise AssertionError(f"{kind}: data-parallel rows against one device's: min cosine "
                                 f"{cos.min():.6f} < {MULTI_MIN_COSINE}")
        msg = ""
        if kind == "sonar":
            chunks = calls["_span_forward"]
            per_shard = [_build.SHARD_LAUNCHES[(i, "relkey_attention")] for i in range(n_shards)]
            want_launches = dp.config.n_layers * chunks
            if cuda and (per_shard != [want_launches] * n_shards
                         or w2v_bert.ATTENTION_CALLS["torch"]):
                raise AssertionError(f"SONAR data-parallel: rel-key launches per shard "
                                     f"{per_shard}, want {want_launches} ({chunks} chunks); "
                                     f"plain attention calls {w2v_bert.ATTENTION_CALLS}")
            msg = (f"; {chunks} chunks of {dp.batch_size} rows, rel-key launches per shard "
                   f"{per_shard if cuda else 'none (CPU)'}, plain attention calls "
                   f"{w2v_bert.ATTENTION_CALLS['torch'] if cuda else 'all (CPU)'}")
        _log(f"[multi] {kind} stage 5.3 over {n_shards} shards: {got.shape[0]} rows, all finite, "
             f"per-row cosine to one device min {cos.min():.6f}{msg}")

        # warm, after the gate's runs: by graph replay (the main path), then eagerly
        minutes = seconds / 60
        (gm, wm), (_, w1) = encode(dp), encode(one)
        (em, wm_e), (_, w1_e) = encode(dp, eager=True), encode(one, eager=True)
        w1, wm, w1_e, wm_e = (w / minutes for w in (w1, wm, w1_e, wm_e))
        overlap = _mesh_overlap(lambda: encode(dp))
        ge = _row_cosines(gm.astype(np.float32), em.astype(np.float32))
        if ge.min() < GRAPH_MIN_COSINE:
            raise AssertionError(f"{kind} over {n_shards} shards: graph rows against eager, min "
                                 f"cosine {ge.min()} < {GRAPH_MIN_COSINE}")
        _log(f"[graphs] {kind} over {n_shards} shards, fp16 rows by graph replay against the "
             f"eager forward: per-row cosine min {ge.min():.8f}, max abs difference "
             f"{np.abs(gm.astype(np.float32) - em.astype(np.float32)).max():.3e}"
             f"{' (bit-equal)' if np.array_equal(gm, em) else ''}; programs per replica "
             f"{[len(st['capture_s']) for st in dp.program_stats()]}")
        _log(f"[time] multi stage 5.3 {kind}, encode_spans of the {seconds} s document, warm: "
             f"one device {w1:.4f}s per minute of audio, {n_shards} shards {wm:.4f}s "
             f"({w1 / wm:.2f}x; {overlap}); eager forward: one device {w1_e:.4f}s, "
             f"{n_shards} shards "
             f"{wm_e:.4f}s ({w1_e / wm_e:.2f}x); first runs {first_one:.3f}s and "
             f"{first_mesh:.3f}s")
        out[kind] = {"one_s_per_min": w1, "mesh_s_per_min": wm, "min_cos": float(cos.min()),
                     "eager_one_s_per_min": w1_e, "eager_mesh_s_per_min": wm_e,
                     "graph_eager_min_cos": float(ge.min())}
        if pipeline_chunks and kind == "speech_laser":
            big = [copy.copy(m) for m in (one, dp)]
            for m in big:
                m.max_tokens = PIPE_MAX_TOKENS
            walls = [[encode(m)[1] for _ in range(2)] for m in big]  # first, warm
            w1, wm = (w[1] / minutes for w in walls)
            overlap = _mesh_overlap(lambda: encode(big[1]))
            _log(f"[time] multi stage 5.3 speech_laser at the pipeline's {PIPE_MAX_TOKENS // 16000} s "
                 "chunks, warm: one "
                 f"device {w1:.4f}s per minute of audio, {n_shards} shards {wm:.4f}s "
                 f"({w1 / wm:.2f}x; {overlap}); first runs {walls[0][0]:.3f}s and "
                 f"{walls[1][0]:.3f}s")
            out["speech_laser_600s"] = {"one_s_per_min": w1, "mesh_s_per_min": wm}
    return out


def _sorted_ids_equal(a, b):
    return np.array_equal(np.sort(a, axis=1), np.sort(b, axis=1))


def _hold_search(what, d, i, d_ref, i_ref):
    rtol, atol = MULTI_SEARCH_TOL
    if not np.allclose(d, d_ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: distances off one device's by up to "
                             f"{np.abs(d - d_ref).max():.3e}")
    if not _sorted_ids_equal(i, i_ref):
        bad = int(np.sum(np.any(np.sort(i, 1) != np.sort(i_ref, 1), axis=1)))
        raise AssertionError(f"{what}: {bad} rows hold other neighbours than one device's")
    return float(np.abs(d - d_ref).max())


def _multi_search(workdir, device, mesh, n_rows, sub_rows, dim, mining_root=None):
    """Stage 6.7's kNN tiers sharded over the mesh against one device:
    ``ShardedFlatIndex`` over the mining phase's corpus (``n_rows`` rows a
    language), one direction; ``ShardedIVFIndex`` and the int8 tier on its
    coverage corpus (``sub_rows``). Gates: distances within
    MULTI_SEARCH_TOL and the same neighbour sets; then stage 6.7's margins
    through the CLI with ``--sharded_index`` (Flat, IVF at the default
    probe, int8) within MARGIN_RTOL of the same CLI without it.
    ``mining_root``: phase 9's directory, whose corpus files, coverage
    indexes and margins are read instead of made again."""
    import torch

    from svecalign_tpu_torch.ops import topk
    from svecalign_tpu_torch.utils.index_utils import load_index

    dev, n_shards = device.type, len(mesh.data_devices)
    t0 = time.perf_counter()
    if mining_root is not None:
        queries, corpus = (topk.normalize_l2(_mining_rows(mining_root, side, [0] * MINING_PAIRS))
                           for side in ("src", "tgt"))
        made = "read from phase 9's files"
    else:
        rows = {side: [] for side in ("src", "tgt")}
        for pair in mining_pair_rows(MINING_PAIRS, n_rows, dim, seed=200):
            for side, r in pair.items():
                rows[side].append(r.astype(np.float16))
        queries, corpus = (topk.normalize_l2(np.concatenate(rows[s])) for s in ("src", "tgt"))
        del rows
        made = "made"
    n_rows = len(corpus)
    _log(f"[multi] stage 6.7: the mining phase's corpus, {n_rows} rows a language, {made} in "
         f"{time.perf_counter() - t0:.1f}s")

    def timed(index, q):
        """The search in stage 6.7's chunks of queries (its CHUNK_ROWS)."""
        from svecalign_tpu_torch.postprocess.score_align import CHUNK_ROWS

        index.search(q[:8], MINING_K)  # the corpus upload, outside the timed search
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        parts = [index.search(q[q0:q0 + CHUNK_ROWS], MINING_K)
                 for q0 in range(0, len(q), CHUNK_ROWS)]
        wall = time.perf_counter() - t
        return np.concatenate([d for d, _ in parts]), np.concatenate([i for _, i in parts]), wall

    flat = topk.FlatIndex(dim, device=device)
    flat.add(corpus)
    d1, i1, one_s = timed(flat, queries)
    del flat
    sharded = topk.ShardedFlatIndex(corpus, mesh, device=device)
    d2, i2, mesh_s = timed(sharded, queries)
    del sharded
    err = _hold_search("ShardedFlatIndex", d2, i2, d1, i1)
    if dev == "cuda":
        torch.cuda.empty_cache()
    _log(f"[multi] ShardedFlatIndex over {n_shards} shards, {n_rows} x {n_rows}, k {MINING_K}: "
         f"distances within {err:.3e} of one device's, the same neighbour sets")
    _log(f"[time] multi stage 6.7 Flat search, one direction, {n_rows} queries over {n_rows} rows: "
         f"one device {one_s:.3f}s, {n_shards} shards {mesh_s:.3f}s ({one_s / mesh_s:.2f}x)")

    # the coverage corpus: phase 9's, with its indexes and unsharded margins
    tiers = (("flat", "flat", "m_flat", ()), ("ivf", "ivf", "m_ivf128", ("--num_probe", "128")),
             ("int8", "flat", "m_int8", ("--corpus_quant", "int8")))
    if mining_root is not None:
        sub = Path(mining_root) / "subset"
    else:
        sub = workdir / "subset"
        write_mining_corpus(sub, MINING_SUBSET_PAIRS, sub_rows, dim, seed=201)
        _run_prep_index(sub, "flat", dev)
        _run_prep_index(sub, "ivf", dev, ["--index_type", MINING_IVF])
        for _, index, out, extra in tiers:
            _run_score_align(sub, index, out, dev, extra)
    q_sub, c_sub = (topk.normalize_l2(_mining_rows(sub, side, [0] * MINING_SUBSET_PAIRS))
                    for side in ("src", "tgt"))
    idx = sub / "ivf" / f"{SRC_LANG}-{TGT_LANG}"
    one_ivf = load_index(next((idx / TGT_LANG).glob("*.populate.idx")), device=device)
    d1, i1 = one_ivf.search(q_sub, MINING_K)
    d2, i2 = topk.ShardedIVFIndex(one_ivf, mesh).search(q_sub, MINING_K)
    errs = {"ivf": _hold_search("ShardedIVFIndex", d2, i2, d1, i1)}
    q8 = topk.FlatIndex(dim, corpus_quant="int8", device=device)
    q8.add(c_sub)
    d1, i1 = q8.search(q_sub, MINING_K)
    d2, i2 = topk.ShardedFlatIndex(c_sub, mesh, corpus_quant="int8", device=device).search(
        q_sub, MINING_K)
    errs["int8"] = _hold_search("ShardedFlatIndex int8", d2, i2, d1, i1)
    margins = {}
    for label, index, out, extra in tiers:
        want, cols = _read_margins(sub, out)
        _, got, got_cols = _run_score_align(sub, index, f"{out}_sharded", dev,
                                            (*extra, "--sharded_index"), mesh=mesh)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        if got_cols != cols or rel > MARGIN_RTOL:
            raise AssertionError(f"score_align --sharded_index ({label}): margins {rel:.3e} from "
                                 f"the unsharded CLI's (rtol {MARGIN_RTOL}), columns equal: "
                                 f"{got_cols == cols}")
        margins[label] = rel
    _log(f"[multi] on the {len(c_sub)}-row coverage corpus: ShardedIVFIndex ({MINING_IVF}, the "
         f"default probe) and the int8 ShardedFlatIndex within {errs} of one device's, the same "
         "neighbour sets; score_align --sharded_index margins within "
         + ", ".join(f"{k} {v:.3e}" for k, v in margins.items()) + " of the unsharded CLI's")
    return {"one_s": one_s, "mesh_s": mesh_s}


def _one_card_pipeline(meta, out, dev):
    """Stages 4.1-5.3 of the pipeline in a process of its own that sees one
    card (``CUDA_VISIBLE_DEVICES=0``). Returns its stage breakdown line."""
    repo = str(Path(__file__).resolve().parent)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "0",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    argv = [sys.executable, "-m", "svecalign_tpu_torch.pipeline", str(meta), str(out),
            "--src_lang", SRC_LANG, "--tgt_lang", TGT_LANG, "--stages", MULTI_PIPE_STAGES,
            "--device", dev]
    proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the one-card pipeline failed:\n{proc.stderr[-3000:]}")
    return next((line.split("stage breakdown: ", 1)[1]
                 for line in (proc.stdout + proc.stderr).splitlines() if "stage breakdown: " in line),
                "not logged")


def _multi_pipeline(workdir, device, mesh, seconds, one_card=_one_card_pipeline):
    """The whole graph with ``--data_parallel 0 --sharded_index --fused``
    over every local device (full-width SpeechLASER on the documents of
    phase 7) against one card: stages 4.1-5.2 byte-identical to a one-card
    run's, its ``.embed`` rows at per-row cosine >= MULTI_MIN_COSINE; a
    one-device stage 5.4 on the run's own ``.embed`` files equal to its
    stage-5.4 output, and a one-device stage 6.7 on its own index files
    within MARGIN_RTOL of its margins. ``one_card(meta, out, dev)`` runs
    stages 4.1-5.3 on one device (and may return its stage breakdown)."""
    from svecalign_tpu_torch.ops import _build
    from svecalign_tpu_torch.postprocess import score_align
    from svecalign_tpu_torch.seg_align import align
    from svecalign_tpu_torch.utils.embedding_utils import load_stopes_embeddings

    dev, root = device.type, Path(workdir) / "pipeline"
    write_synthetic_document(root / "in", seconds, seed=0)
    paths, _ = write_synthetic_document(root / "in", seconds, seed=1, lang=TGT_LANG)
    meta, out = paths["metadata"], root / "multi"
    _build.SHARD_LAUNCHES.clear()
    run = run_pipeline(meta, out, dev, ["--data_parallel", "0", "--sharded_index", "--fused"])
    n_shards = len(mesh.data_devices)
    per_shard = [_build.SHARD_LAUNCHES[(i, "banded_dp")] for i in range(n_shards)]
    if dev == "cuda" and (min(per_shard) < 1 or len(set(per_shard)) != 1):
        raise AssertionError(f"the pipeline's stage 5.4 launched the banded DP {per_shard} times "
                             "on the shards")
    s = run["stats"]
    if s["hit"] != 2 or s["miss"] or s["rejected"]:
        raise AssertionError(f"the sharded pipeline's cache stats {s}")
    _log(f"[multi] pipeline --data_parallel 0 --sharded_index --fused over {n_shards} devices: "
         f"{run['wall']:.3f}s wall; banded DP launches per shard {per_shard}; cache stats {s}; "
         "stage seconds: " + " | ".join(f"{k} {v:.3f}" for k, v in run["stages"].items()))

    t0 = time.perf_counter()
    breakdown = one_card(meta, root / "one", dev)
    n_host = compare_pipeline_runs(out, root / "one", only=MULTI_HOST_DIRS)
    worst = 1.0
    for lang in (SRC_LANG, TGT_LANG):
        name = f"{lang}/{STEM}_{lang}.embed"
        a, b = (load_stopes_embeddings(str(r / "embeds" / name)).astype(np.float32)
                for r in (out, root / "one"))
        worst = min(worst, float(_row_cosines(a, b).min()))
    if worst < MULTI_MIN_COSINE:
        raise AssertionError(f"the sharded pipeline's .embed rows against one card's: min "
                             f"cosine {worst:.6f} < {MULTI_MIN_COSINE}")
    _log(f"[multi] one-card stages 4.1-5.3 ({time.perf_counter() - t0:.1f}s with the process "
         f"start; stage seconds, each encoder's build included: {breakdown}): {n_host} files of "
         f"stages 4.1-5.2 byte-identical; .embed rows at per-row cosine >= {worst:.6f}")

    rerun = root / "rerun"
    align.main([str(meta), str(rerun / "alignments"), "--src_lang", SRC_LANG, "--tgt_lang",
                TGT_LANG, "--seg_dir", str(out / "segments"), "--concat_dir",
                str(out / "cat_segs"), "--embed_dir", str(out / "embeds"), "--is_stopes_embed",
                "-a", "6", "--ign_indices_dir", str(out / "untrans_cat_seg_ids"),
                "--pair_batch", "2", "--device", dev])
    n_align = compare_pipeline_runs(out, rerun, only=("alignments",))
    mrg = next(p.name for p in out.iterdir() if p.name.endswith("_margin"))
    base = mrg[:-len("_margin")]
    score_align.main([str(meta), str(rerun / mrg), "--embed_dir", str(out / f"{base}_embed"),
                      "--align_dir", str(out / base), "--src_lang", SRC_LANG, "--tgt_lang",
                      TGT_LANG, "--index_dir", str(out / f"{base}_embed_indexes"),
                      "--embed_fp16", "--k", str(MINING_K), "--embed_stopes", "--device", dev])
    n_mrg = compare_pipeline_runs(out, rerun, margin_rtol=MARGIN_RTOL, only=(mrg,))
    _log(f"[multi] one-device stage 5.4 on the run's .embed files: {n_align} alignment files "
         f"identical; one-device stage 6.7 on its index files: {n_mrg} margin files within "
         f"rtol {MARGIN_RTOL}")
    return run["wall"]


def phase_multi(workdir, device, mesh=None, sizes=BUCKET_SIZES, dim=1024, doc_seconds=DOC_SECONDS,
                kinds=("speech_laser", "sonar"), search_rows=MINING_ROWS,
                sub_rows=MINING_SUBSET_ROWS, align_kw=None, pipeline=None, corpus=None,
                mining_root=None, **pipe_kw):
    """Phase 12: every sharded path of the port against the same path on
    one device. On a machine of one card the mesh is
    ``MULTI_ONE_CARD_SHARDS`` shards of that card, built through the same
    library entries the CLIs call, and the pipeline bullet (which needs
    the CLIs' own meshes: every card) is skipped; with two or more cards
    the mesh is every card. ``pipeline`` (default: whether the shards have
    cards of their own) runs the pipeline bullet. ``corpus`` (phase 3's
    (paths, stems)) and ``mining_root`` (phase 9's directory) are read
    instead of written again. Returns the walls."""
    t_phase = time.perf_counter()
    if mesh is None:
        mesh, shared = multi_mesh(device)
    else:
        shared = len(set(mesh.data_devices)) < len(mesh.data_devices)
    n_shards = len(mesh.data_devices)
    _log(f"[multi] mesh {mesh}: {n_shards} data shards"
         + (" sharing one device (the machine has one card)" if shared else ""))
    times = {}
    t0 = time.perf_counter()
    checks = _multi_kernel_checks(mesh) if device.type == "cuda" else {}
    times["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    align = _multi_align(workdir, device, mesh, sizes, dim, align_kw or _align_kwargs_cli(),
                         corpus=corpus)
    times["align"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encode = _multi_encode(workdir, device, mesh, doc_seconds, kinds, pipeline_chunks=not shared)
    times["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    search = _multi_search(workdir, device, mesh, search_rows, sub_rows, dim, mining_root)
    times["search"] = time.perf_counter() - t0
    if pipeline is None:
        pipeline = not shared
    if pipeline:
        t0 = time.perf_counter()
        _multi_pipeline(workdir, device, mesh, doc_seconds, **pipe_kw)
        times["pipeline"] = time.perf_counter() - t0
    else:
        _log("[multi] the pipeline bullet is skipped: its CLIs shard over every card, and this "
             "machine has one")
    _log(f"[time] multi phase: {time.perf_counter() - t_phase:.1f}s; "
         + " | ".join(f"{k} {v:.1f}s" for k, v in times.items()))
    return {"align": align, "encode": encode, "search": search, "checks": checks,
            "times": times}


TRAIN_PAIRS = 64  # rows of the training tsv: one pair of same-span clips each
TRAIN_SPAN_S = 10  # a row every 10 s of the two sides, 6-12 s long (the CLI crops at 10 s)
TRAIN_CLI_STEPS = 4  # full-width steps of the training CLI at its defaults
TRAIN_FIXED_STEPS = 8  # full-width steps on one fixed batch, which must lower its loss
TRAIN_TP_STEPS = 3  # full-width steps on two model shards of one card (the first warms up)
TRAIN_GATE = {"encoder_layers": 2, "encoder_dim": 1024, "dtype": "float32"}  # card vs CPU
TRAIN_GATE_BATCH = (4, 2.0)  # rows, seconds of the gate's batch
TRAIN_TOL_SCALE = 10  # the CPU tests' step bounds, scaled: loss 1e-5, gradients 1e-6, 1e-5


def write_train_tsv(root, n_pairs=TRAIN_PAIRS, span_s=TRAIN_SPAN_S, seed=400):
    """A mined tsv (``score \\t src span \\t tgt span``) of ``n_pairs``
    same-span rows over a :func:`write_front_pair` pair: row k covers
    6-12 s from about k * ``span_s`` s in both sides. Returns its path."""
    sr = 16000
    rng = np.random.default_rng(seed)
    paths = write_front_pair(root, seconds=n_pairs * span_s + 20, n_planted=4, seed=seed)
    lines = []
    for k in range(n_pairs):
        start = k * span_s * sr + int(rng.integers(0, sr))
        end = start + int(rng.integers(6 * sr, 12 * sr))
        lines.append(f"{1.1 + 0.001 * k:.4f}\t{paths[SRC_LANG]} {start} {end} 16"
                     f"\t{paths[TGT_LANG]} {start} {end} 16\n")
    tsv = Path(root) / "align.rm_overlap.sort.tsv"
    tsv.write_text("".join(lines), encoding="utf-8")
    return tsv


def _train_step_record(model, step, batch):
    """One step: (loss, {name: gradient}, {name: parameter after}) on the host."""
    loss = float(step(batch))
    grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return loss, grads, params


def hold_train_steps(what, got, want, lr, scale=TRAIN_TOL_SCALE):
    """``got`` and ``want`` (:func:`_train_step_record`) agree to the CPU
    tests' bounds times ``scale``: the loss; every gradient tensor within
    1e-6 x scale of its own largest magnitude where that is over 1 (the
    extractor's first bias sums its gradient over every frame of the batch
    and reaches ~10: fp32 rounds it at ~1e-6 relative), else absolute;
    every parameter within 2 lr (and 4 ulp), and within 1e-5 x scale
    wherever |g| > 1e-4. Returns the largest gradient difference (relative
    to that scale) and parameter difference."""
    import torch

    (gl, gg, gp), (wl, wg, wp) = got, want
    if abs(gl - wl) > 1e-5 * scale:
        raise AssertionError(f"{what}: loss {gl} against {wl}")
    g_err = 0.0
    for k in wg:
        err = float((gg[k] - wg[k]).abs().max()) / max(1.0, float(wg[k].abs().max()))
        if err > 1e-6 * scale:
            raise AssertionError(f"{what}: gradient {k} differs by {err} (scaled)")
        g_err = max(g_err, err)
    p_err = 0.0
    for k in wp:
        d = (gp[k] - wp[k]).abs()
        ulps = 4 * torch.from_numpy(np.spacing(np.abs(wp[k].numpy())))
        big = wg[k].abs() > 1e-4
        if (d > 2 * lr + ulps).any() or (d[big] > 1e-5 * scale).any():
            raise AssertionError(f"{what}: parameter {k} differs by {float(d.max())}")
        p_err = max(p_err, float(d.max()))
    return g_err, p_err


def phase_train(workdir, device, gate=TRAIN_GATE, gate_batch=TRAIN_GATE_BATCH, cli_args=(),
                full=None, fixed_batch=(8, 10.0), fixed_steps=TRAIN_FIXED_STEPS,
                tp_steps=TRAIN_TP_STEPS, pairs=TRAIN_PAIRS):
    """Encoder training (``models/training.py``, ``train.py``) on the card:
    a 2-layer d = 1024 fp32 step on the card against the same step on the
    CPU, and on two model shards of the card against one device; the
    training CLI at its defaults (24 layers, d = 1024, batch 8, 10 s clips,
    bf16 compute) for a few steps, finite losses, its encoder_final.npz
    loaded into SpeechLaserModel; steps on one fixed batch lowering its
    loss, timed: s per step, clips/s, TFLOP/s (3x the forward's
    operations), peak memory, and the two-shard mesh's overhead.
    ``cli_args``, ``full`` (a LaserEncoderConfig), the batches, the step
    counts and ``pairs`` cut it to size for a rehearsal on the CPU."""
    import torch

    from svecalign_tpu_torch import train as cli
    from svecalign_tpu_torch.models import training
    from svecalign_tpu_torch.models.laser_encoder import LaserEncoderConfig, SpeechLaserModel
    from svecalign_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # a mesh names its cards
        dev = torch.device("cuda", torch.cuda.current_device())
    tsv = write_train_tsv(workdir / "corpus", n_pairs=pairs)
    rows = cli.load_rows(str(tsv), 0.0)
    tcfg = training.TrainConfig()
    lr = tcfg.learning_rate
    _log(f"[train] wrote a mined tsv of {len(rows)} same-span pairs in "
         f"{time.perf_counter() - t_phase:.1f}s")

    # the gate: one fp32 step, card against CPU, and two model shards against one device
    cfg = LaserEncoderConfig(**gate)
    n_rows, seconds = gate_batch
    batch = cli.ClipBatcher(rows, n_rows, int(seconds * 16000), 0).next_batch()
    init, _ = training.make_train_state(cfg, tcfg, seed=0, device="cpu")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    recs = {}
    for name, where, mesh in (("cpu", "cpu", None), ("card", dev, None),
                              ("card, 2 model shards", dev, Mesh([[dev, dev]]))):
        model = training.LaserSpeechEncoder(cfg).to(where)
        model.load_state_dict(init)
        opt = training.make_optimizer(model, tcfg)
        step = (training.make_train_step(model, opt, tcfg) if mesh is None
                else training.shard_train_step(model, opt, tcfg, mesh))
        recs[name] = _train_step_record(model, step, batch)
        del model, opt, step
    g1, p1 = hold_train_steps("card against CPU", recs["card"], recs["cpu"], lr)
    g2, p2 = hold_train_steps("two model shards against one device", recs["card, 2 model shards"],
                              recs["card"], lr)
    _log(f"[train] gate ({gate['encoder_layers']} layers, d = {gate['encoder_dim']}, fp32, "
         f"{n_rows} x {seconds} s): loss card {recs['card'][0]:.7f}, CPU {recs['cpu'][0]:.7f}, "
         f"two model shards {recs['card, 2 model shards'][0]:.7f}; card against CPU: gradients "
         f"within {g1:.3e}, parameters {p1:.3e}; two shards against one device: gradients "
         f"{g2:.3e}, parameters {p2:.3e} (bounds: loss {1e-5 * TRAIN_TOL_SCALE:g}, gradients "
         f"{1e-6 * TRAIN_TOL_SCALE:g} of each tensor's largest magnitude where over 1, "
         f"parameters 2 lr = {2 * lr:g}, and {1e-5 * TRAIN_TOL_SCALE:g} where |g| > 1e-4)")
    del recs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the CLI at its defaults
    out = workdir / "train_out"
    t0 = time.perf_counter()
    res = cli.main([str(tsv), str(out), "--steps", str(TRAIN_CLI_STEPS),
                    "--device", dev.type, *cli_args])
    cli_wall = time.perf_counter() - t0
    if not np.isfinite(res["losses"]).all() or len(res["losses"]) != TRAIN_CLI_STEPS:
        raise AssertionError(f"training CLI losses {res['losses']}")
    _log(f"[train] CLI ({' '.join(cli_args) or 'defaults'}): {TRAIN_CLI_STEPS} steps in "
         f"{cli_wall:.3f}s wall (weight init, wav reads and the first step's warm-up included), "
         f"losses {', '.join(f'{x:.5f}' for x in res['losses'])}")
    full = full or LaserEncoderConfig()
    loaded = SpeechLaserModel(full, ckpt_path=res["final"], device=dev)
    emb = loaded.encode([np.asarray(batch["src_wav"][0][: batch["src_len"][0]])])
    if not np.isfinite(emb).all():
        raise AssertionError("the trained encoder's rows are not finite")
    del loaded
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # steps on one fixed batch: the loss must fall; times, rate, memory
    b = cli.ClipBatcher(rows, fixed_batch[0], int(fixed_batch[1] * 16000), 1).next_batch()
    resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    model, opt = training.make_train_state(full, tcfg, seed=1, device=dev)
    step = training.make_train_step(model, opt, tcfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(fixed_steps):
        t0 = time.perf_counter()
        losses.append(float(step(b)))  # the loss's pull waits for the step
        times.append(time.perf_counter() - t0)
    # the training's own: weights, gradients, moments and activations
    peak = torch.cuda.max_memory_allocated(dev) - resident if dev.type == "cuda" else 0
    # Adam at lr 1e-4 from a random init moves every weight by ~lr a step,
    # and the loss of a batch of 8 pairs swings from step to step: the
    # later half's mean is held under the first loss
    late = float(np.mean(losses[len(losses) // 2:]))
    if not late < losses[0]:
        raise AssertionError(f"{fixed_steps} steps on one batch did not lower its loss: {losses}")
    s_step = float(np.median(times[1:]))
    n_clips = 2 * len(b["src_len"])
    flops = 3 * n_clips * sum(laser_row_flops(full, b["src_wav"].shape[1]).values())
    _log(f"[train] {fixed_steps} steps on one batch of {n_clips // 2} pairs: loss "
         + ", ".join(f"{x:.5f}" for x in losses) + f"; the later half's mean {late:.5f}")
    _log(f"[time] train step ({full.encoder_layers} layers, d = {full.encoder_dim}, {full.dtype} "
         f"compute, fp32 "
         f"master, {n_clips} clips of {b['src_wav'].shape[1] / 16000:g} s): {s_step:.4f} s per step "
         f"(median of {fixed_steps - 1} warm steps; first {times[0]:.4f} s), "
         f"{n_clips / s_step:.2f} clips/s, {flops / s_step / 1e12:.1f} TFLOP/s counting 3x the "
         f"forward's {flops / 3e12:.2f} TFLOP, {100 * flops / s_step / H100_BF16_OPS_PER_S:.1f}% "
         f"of the bf16 dense peak; peak memory {peak / 2**30:.2f} GiB (above the "
         f"{resident / 2**30:.2f} GiB resident before)")

    # the same model and batch on two model shards of the card
    tp_step = training.shard_train_step(model, training.make_optimizer(model, tcfg), tcfg,
                                        Mesh([[dev, dev]]))
    tp_times = []
    for _ in range(tp_steps):
        t0 = time.perf_counter()
        loss = float(tp_step(b))
        tp_times.append(time.perf_counter() - t0)
    s_tp = float(np.median(tp_times[1:]))
    _log(f"[time] train step on two model shards of one card: {s_tp:.4f} s per step (median of "
         f"{tp_steps - 1} warm steps, loss {loss:.5f}), {s_tp / s_step:.3f}x the one-device step")

    # one step of each by phase (the phase spans' host seconds)
    splits = {}
    os.environ[training.TRAIN_PROFILE_ENV] = "1"
    try:
        for name, fn in (("one device", step), ("two model shards", tp_step)):
            training.step_seconds.clear()
            t0 = time.perf_counter()
            fn(b)
            splits[name] = dict(training.step_seconds, wall=time.perf_counter() - t0)
    finally:
        del os.environ[training.TRAIN_PROFILE_ENV]
    for name, split in splits.items():
        _log(f"[time] train step by phase ({name}, host seconds, {split['wall']:.4f}s): "
             + " | ".join(f"{k} {v:.4f}s" for k, v in split.items() if k != "wall"))
    del model, opt, step, tp_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _log(f"[time] train phase: {time.perf_counter() - t_phase:.1f}s")
    return {"s_per_step": s_step, "clips_per_s": n_clips / s_step, "tflops": flops / s_step / 1e12,
            "peak_gib": peak / 2**30, "tp_ratio": s_tp / s_step, "cli_losses": res["losses"],
            "fixed_losses": losses, "splits": splits}


KERNEL_CLASSES = (  # (class, substrings of a CUDA kernel's name), first match wins
    ("relkey_attention kernel", ("relkey_attention",)),
    ("SDPA attention (LASER)", ("fmha", "flash", "attention")),
    # cuDNN's implicit-GEMM convolutions are named fprop
    ("convolutions (SONAR's depthwise, LASER's extractor and positional)", ("conv", "fprop")),
    ("matmul (cuBLAS/CUTLASS)", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("fft", ("fft", "radix")),
    ("reductions and softmax", ("reduce", "softmax", "norm")),
    # dtype casts are copy kernels; "nocast" in a name is not one
    ("copies and casts", ("copy", "memcpy", "memset", "fill")),
)


def profile_embed(device, kind="sonar"):
    """``--profile``: one warm stage-5.3 run of the 10-minute document with
    the ``kind`` encoder under torch.profiler, by CUDA-graph replay (the
    main path) and then with the eager forward. Prints, for each, the
    device time by kernel class and the top kernels, and the device's
    busy share of the run's wall time (the profiler's own overhead
    included in that wall)."""
    from svecalign_tpu_torch.seg_align import embed as stage
    from svecalign_tpu_torch.utils import embed_model_utils

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as td:
        paths, lines = write_synthetic_document(Path(td) / "doc", DOC_SECONDS)
        model = embed_model_utils.load_embed_model(kind, max_tokens=150 * 16000, device=device)
        for route in ("graph", "eager"):
            with contextlib.ExitStack() as stack:
                if route == "eager":
                    stack.enter_context(eager_forward(model))
                _run_embed(stage, paths, Path(td) / f"warm_{route}", kind=kind)
                _profile_run(f"{kind} ({route})", len(lines),
                             lambda: _run_embed(stage, paths, Path(td) / f"prof_{route}",
                                                kind=kind))


def _profile_run(label, n_windows, run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + us, evt.count)
    if not kernels:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    total_s = sum(us for us, _ in kernels.values()) / 1e6
    classes = {}
    for name, (us, _) in kernels.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)),
                   "other elementwise")
        classes[cls] = classes.get(cls, 0.0) + us / 1e6
    _log(f"[profile] {label} stage-5.3 warm run under torch.profiler: {wall:.3f}s wall, "
         f"{n_windows} windows; device busy {total_s:.3f}s ({100 * total_s / wall:.1f}% of the "
         "wall)")
    for cls, sec in sorted(classes.items(), key=lambda kv: -kv[1]):
        _log(f"[profile]   {cls}: {sec:.3f}s ({100 * sec / total_s:.1f}% of device time)")
    for name, (us, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        _log(f"[profile]     {us / 1e3:10.3f} ms  x{count:<6d} {name[:110]}")


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="only build and profile one warm stage-5.3 run with each "
                           "encoder (device time by kernel) instead of the phases above")
    mode.add_argument("--checks", action="store_true",
                      help="only build and hold each kernel against its plain version "
                           "(phases 1-2); prints no result line")
    mode.add_argument("--dp", action="store_true",
                      help="only stage 5.4: build, hold the DP and walk kernels against "
                           "their plain versions, run the stage per pair and in buckets and "
                           "time the kernels (no SONAR model is built); prints no result line")
    mode.add_argument("--ablation", action="store_true",
                      help="what --dp does, and in phase 4 the measurement builds: the dense "
                           "DP's first design in ablation modes, the dense DP by strip count, "
                           "the banded walk by producer warps; prints no result line")
    mode.add_argument("--embed", action="store_true",
                      help="only build, the kernel checks and stage 5.3 with each encoder "
                           "(phases 1, 2, 5 and 6 without the chain: graph replay against the "
                           "eager forward, capture seconds, graph pools); prints no result line")
    mode.add_argument("--laser", action="store_true",
                      help="only build, the kernel checks, LASER stage 5.3, the post-align "
                           "chain, SONAR's long spans and the attention kernel at the long "
                           "buckets (phases 1, 2, 6-8); prints no result line")
    mode.add_argument("--mining", action="store_true",
                      help="only build, the kernel checks and the mining phase (phases 1, 2, "
                           "9; no encoder is built); prints no result line")
    mode.add_argument("--pipeline", action="store_true",
                      help="only build, the kernel checks and the pipeline (phases 1, 2, 11: "
                           "all 16 stages on two hour-long pairs, unfused and fused, then "
                           "SONAR fused); prints no result line")
    mode.add_argument("--multi", action="store_true",
                      help="only build, the kernel checks and the sharded paths (phases 1, 2, "
                           "12: stages 5.4, 5.3 and 6.7 over a mesh against one device, and with "
                           "two or more cards the whole pipeline); prints no result line")
    mode.add_argument("--train", action="store_true",
                      help="only build, the kernel checks and encoder training (phases 1, 2, "
                           "13: a card-against-CPU gate, the training CLI at full width, timed "
                           "steps); prints no result line")
    mode.add_argument("--norm", action="store_true",
                      help="only build, the LayerNorm kernel's checks and its times at the "
                           "encoders' shapes against its plain version and its bound; prints "
                           "no result line")
    mode.add_argument("--front", action="store_true",
                      help="only build, the kernel checks and the front of the pipeline "
                           "(phases 1, 2, 10: stages 4.1, 4.2, 6.2 at hour scale; no encoder "
                           "is built); prints no result line")
    args = parser.parse_args(argv)
    args.dp = args.dp or args.ablation
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from svecalign_tpu_torch.utils.torch_setup import resolve_device

    t_start = time.perf_counter()
    device = resolve_device("cuda")
    phase_build()
    card = _card_line()
    _log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.profile:
        for kind in ("sonar", "speech_laser"):
            profile_embed(device, kind)
        return 0
    if args.norm:
        phase_norm_checks(device)
        phase_norm_times(device)
        _log(f"[done] LayerNorm phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    check_err = phase_kernel_checks(device)
    dense_err = phase_dense_checks(device)
    if not args.dp:
        attn_err = phase_attention_checks(device)
        norm_err = phase_norm_checks(device)
    if args.checks:
        _log(f"[done] kernel checks passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.mining:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mining_") as td:
            phase_mining(Path(td), device)
        _log(f"[done] mining phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.front:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_front_") as td:
            phase_front(Path(td), device, latencies=phase_chain_latencies(device)[:2],
                        clock_hz=_sm_clock_hz())
        _log(f"[done] front phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.train:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as td:
            phase_train(Path(td), device)
        _log(f"[done] train phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.pipeline:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as td:
            phase_pipeline(Path(td), device)
        _log(f"[done] pipeline phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.multi:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as td:
            phase_multi(Path(td), device)
        _log(f"[done] multi phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.embed:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_embed_") as td:
            phase_embed_path(Path(td) / "sonar", device)
            phase_laser_path(Path(td) / "laser", device)
        _log(f"[done] stage-5.3 phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    if not args.laser:
        # kept until phase 12, which reads the 16-pair corpus again
        dp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
        td = Path(dp_dir.name)
        stack, launches, single_paths, per_pair_warm = phase_main_path(td, N_SRC, N_TGT)
        bucket_launches, plan = phase_bucket_path(td, single_paths, per_pair_warm)
        phase_paired_gate(td)
        t = phase_times(stack, device)
        phase_route_times(device)
        fused = phase_slice_times(stack, plan, t["probe"], device, ablation=args.ablation)
        if args.dp:
            _log(f"[done] stage-5.4 phases passed in {time.perf_counter() - t_start:.1f}s")
            return 0
        with tempfile.TemporaryDirectory(prefix="chip_smoke_embed_") as td:
            info, embed_launches = phase_embed_path(Path(td), device)
        a, _ = phase_attention_times(info, device)
        norm_times = phase_norm_times(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as td:
        laser = phase_laser_path(Path(td), device)
        phase_chain(Path(td), device, laser)
        long_chunks = phase_sonar_long_spans(device, laser["waveform"])
    phase_long_attention_times(device, long_chunks)
    if args.laser:
        _log(f"[done] LASER and chain phases passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    mining_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mining_")  # read by phase 12
    phase_mining(Path(mining_dir.name), device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_front_") as td:
        probe = t["probe"]
        phase_front(Path(td), device, latencies=(probe["handover"], probe["alu"]),
                    clock_hz=probe["clock"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as td:
        pipe = phase_pipeline(Path(td), device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as td:
        phase_multi(Path(td), device, corpus=(
            {"root": Path(dp_dir.name) / "corpus"},
            [f"{STEM}-{k:02d}" for k in range(len(BUCKET_SIZES))]),
            mining_root=Path(mining_dir.name) / "mining")
    dp_dir.cleanup()
    mining_dir.cleanup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as td:
        phase_train(Path(td), device)
    kernels = [{
        "name": "banded_dp", "route": "cuda",
        "source": "svecalign_tpu_torch/csrc/banded_dp.cu",
        "replaces": "svecalign_tpu/ops/dp_pallas.py:70",
        "launches": launches["banded_dp"], "pipeline_launches": pipe["laser"]["banded_dp"],
        "max_abs_err": max(check_err, t["err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bytes_bound_ms": t["bytes_bound_ms"],
        "block_route_ms": t["block_ms"], "library_ms": None,
    }, {
        "name": "relkey_attention", "route": "cuda",
        "source": "svecalign_tpu_torch/csrc/relkey_attention.cu",
        "replaces": "svecalign_tpu/ops/attention_pallas.py:200",
        "launches": embed_launches["relkey_attention"], "pipeline_launches": pipe["sonar"],
        "max_abs_err": max(attn_err, a["err"]),
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
    }]
    kernels.append({
        "name": "layer_norm", "route": "cuda", "source": "svecalign_tpu_torch/csrc/layer_norm.cu",
        "replaces": None, "launches": embed_launches["layer_norm"],
        "laser_launches": laser["norm_launches"], "pipeline_launches": None,
        "max_bf16_ulps": norm_err[0], "max_fp32_rel": norm_err[1], "times": norm_times,
        "library_ms": next(r["library_ms"] for r in norm_times
                           if r["name"].startswith("LASER trunk")),
    })
    for name, source, replaces in (
            ("dense_dp", "dense_dp.cu", "svecalign_tpu/ops/dp.py:49"),
            ("dense_traceback_walk", "traceback_walk.cu", "svecalign_tpu/ops/dp.py:215"),
            ("banded_traceback_walk", "traceback_walk.cu", "svecalign_tpu/ops/dp.py:243")):
        row = fused[name]
        bound, by = _binding(row["bounds"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"svecalign_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": bucket_launches[name],
            "pipeline_launches": pipe["laser"][name],
            "max_abs_err": max(row["err"], dense_err) if name == "dense_dp" else row["err"],
            "ms": row["ms"], "eager_ms": row["eager_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "bytes_bound_ms": max(row["bounds"]["bytes"], row["bounds"]["operations"]),
            "library_ms": None,
        })
    _log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s. banded_dp: "
         "times per stage-5.4 run of one pair (sum over its banded levels), launches of that "
         f"run ({bucket_launches['banded_dp']} over the bucket run); no single PyTorch call "
         "computes it, so library_ms is null. dense_dp and the two walks: launches of the "
         f"--pair_batch {PAIR_BATCH} run of {len(BUCKET_SIZES)} pairs, device times per launch "
         "(CUDA-graph replay; eager_ms the wrapper called back to back) at its last bucket's "
         "shapes, max_abs_err measured there and at P = 1 against the plain "
         "versions, bound_ms the largest of bytes, operations and the dependent steps' latency "
         "(bytes_bound_ms: the larger of the first two). relkey_attention: device times per launch "
         "(CUDA-graph replay) at the stage-5.3 modal bucket (every bucket, and eager times, "
         "above); launches per stage-5.3 run, counted at each replay of the encoder's CUDA "
         "graphs (24 a chunk), not at their warm-up or capture. pipeline_launches: the launches "
         "of one run of the whole pipeline (phase 11: stage 5.4 of the LASER run, stages 5.3 "
         "and 6.5 of the SONAR run)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
