"""Stage 5.4 — alignment CLI, per pair or in buckets of pairs.

Port of the JAX package's ``seg_align/align.py`` (reference
svecalign/seg_align/align.py): validates that segments / concats / embeds
(and optional ignore indices) exist for every pair, then aligns each pair
with the coarse-to-fine DP aligner on the card, writing ``[x]:[y]:cost``
lines to ``OUT/{src}-{tgt}/{srcstem}-{tgtstem}.txt``. With ``--pair_batch
P`` (P > 1) the pairs are sorted by size and aligned P at a time by the
batched pyramid (``vecalign/batch.py``): each bucket uploads its raw fp16
(or int8 / int4) embedding rows once and gathers the overlap tensors on
the device. In a fused pipeline run (``utils/embed_cache.py`` enabled) the
pairs whose rows the embed stage left on the card skip the ``.embed``
read and the upload (``vecalign/batch.py::stage_rows_device``); the
batched driver then runs even at ``--pair_batch 1``, as in JAX. With
``--data_parallel N`` (0 = every local card) each bucket's pairs split
over a mesh of N devices (``parallel/mesh.py``), each shard's pyramid on
its own card; it implies the batched driver, and ``--pair_batch`` rounds
up to a multiple of N, a short bucket repeating its last pair (whose
results are dropped), as in JAX.

CLI: ``python -m svecalign_tpu_torch.seg_align.align METADATA OUT_DIR
--src_lang S --tgt_lang T --seg_dir D --concat_dir C --embed_dir E
[--is_stopes_embed] [--fp16_embed] [-a 6] [...] [--ign_indices_dir I]
[--device {cuda,cpu}]``

The flags are the JAX CLI's. Those whose path is not ported yet exit with
an error that names the ROADMAP item; ``--upload_quant`` acts on the
batched path only, so at ``--pair_batch 1`` it is accepted, as the JAX CLI
accepts it. ``SVECALIGN_ALIGN_PROFILE=1`` logs the batched path's phases;
``--profile_dir D`` writes a torch.profiler Chrome trace of the alignment
loop to ``D/align_trace.json``.
"""

import argparse
import contextlib
import math
import os
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.file_utils import check_exist, read_metadata
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device
from svecalign_tpu_torch.vecalign.vecalign import align as vecalign_func

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str, help="dir to save alignments.")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="the dir for raw segments.")
    parser.add_argument("--concat_dir", type=str, required=True,
                        help="the dir for concatenated segments.")
    parser.add_argument("--embed_dir", type=str, required=True,
                        help="Dir to embedding files.")
    parser.add_argument("--is_stopes_embed", action="store_true", default=False,
                        help="whether the embeddings are .npy (stopes/SpeechLASER flavor).")
    parser.add_argument("--fp16_embed", action="store_true", default=False,
                        help="whether raw embeddings are fp16 (SONAR flavor).")
    parser.add_argument("-a", "--alignment_max_size", dest="alignment_max_size",
                        type=int, default=6,
                        help="Searches for alignments up to size N-M, where N+M <= this value.")
    parser.add_argument("--search_buffer_size", type=int, default=5,
                        help="Width (one side) of search buffer.")
    parser.add_argument("-d", "--del_percentile_frac", dest="del_percentile_frac",
                        type=float, default=0.2,
                        help="Deletion penalty percentile (as a fraction).")
    parser.add_argument("--max_size_full_dp", type=int, default=300,
                        help="Maximum size N for full N^2 DP.")
    parser.add_argument("--costs_sample_size", type=int, default=20000,
                        help="Sample size for the deletion-penalty cost distribution.")
    parser.add_argument("--num_samps_for_norm", type=int, default=100,
                        help="Number of samples used for normalizing embeddings.")
    parser.add_argument("--ign_indices_dir", type=str, default=None,
                        help="if provided, some segments will be ignored when loading embeddings.")
    parser.add_argument("--seed", type=int, default=42,
                        help="RNG seed (new; the reference is unseeded).")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="if set, write a torch.profiler Chrome trace of the "
                             "alignment loop into this directory.")
    parser.add_argument("--pair_batch", type=int, default=1,
                        help="align this many document pairs per device program "
                             "(batched pyramid; one launch per level and bucket).")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="shard each bucket's pair axis over this many local "
                             "devices (parallel/mesh.py; the DP is per pair, so no "
                             "collective is needed). 0 = all local devices. Implies "
                             "the batched driver; pair_batch is rounded up to a "
                             "multiple of the device count.")
    parser.add_argument("--upload_quant", type=str, default="fp16",
                        choices=["fp16", "int8", "int4"],
                        help="embedding upload precision of the batched path "
                             "(no effect at --pair_batch 1): int8 halves the "
                             "host->device bytes (per-row scales; ~0.3%% cosine "
                             "noise), int4 packs two codes per byte (quarter of "
                             "fp16; ~2%% cosine noise).")
    parser.add_argument("--dp_backend", type=str, default="auto",
                        choices=["auto", "cuda", "torch", "pallas", "xla", "native"],
                        help="banded-DP kernel: the CUDA kernel (card), the plain "
                             "torch loop, native (the host float64 DP, "
                             "ops/dp_native.py; with --pair_batch > 1 it is ignored "
                             "with a warning, as in the JAX CLI), or auto (cuda on "
                             "the card, torch on the CPU; the JAX package's auto "
                             "takes native on the CPU). pallas/xla are the JAX "
                             "package's.")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or, when asked, on the CPU.")
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Exit with an error naming the ROADMAP item for every flag whose path
    this package does not have yet; nothing is quietly ignored."""
    unported = []
    if args.dp_backend in ("pallas", "xla"):
        unported.append(
            f"--dp_backend {args.dp_backend}: a JAX backend; this package has "
            "cuda, torch and native (ROADMAP.md Queue 2 item 2)"
        )
    if unported:
        raise SystemExit("not ported yet:\n  " + "\n  ".join(unported))


class PairTask(NamedTuple):
    """Resolved per-document-pair file paths, index 0 = src / 1 = tgt.

    Each input field holds one path per side; ``ignores`` entries are
    ``None`` when no untranslated-concat id file exists for that side.
    """

    segs: Tuple[str, str]
    concats: Tuple[str, str]
    embeds: Tuple[str, str]
    ignores: Tuple[Optional[str], Optional[str]]
    out_path: str


# input kinds a pair needs before it can be aligned: field name -> suffix
_PAIR_INPUTS = (("segs", ".txt"), ("concats", ".txt"), ("embeds", ".embed"))


def collect_pair_tasks(
    audio_pairs: Sequence[Tuple[str, str]],
    dirs: Dict[str, Tuple[Path, Path]],
    out_dir: Path,
    ign_indices_dir: Optional[Path] = None,
) -> List[PairTask]:
    """Resolve each metadata pair's stage inputs into a :class:`PairTask`.

    ``dirs`` maps each input kind of ``_PAIR_INPUTS`` to its (src, tgt)
    directory pair. Pairs missing any required file are dropped (with a
    warning via ``check_exist``); ignore-index files are optional.
    """
    tasks = []
    for audio in audio_pairs:
        names = tuple(Path(a).name for a in audio)
        stems = tuple(Path(a).stem for a in audio)
        found = {
            kind: tuple(
                (d / n).with_suffix(suffix)
                for d, n in zip(dirs[kind], names)
            )
            for kind, suffix in _PAIR_INPUTS
        }
        if not all(check_exist(p) for kind, _ in _PAIR_INPUTS for p in found[kind]):
            continue

        ignores: Tuple[Optional[str], Optional[str]] = (None, None)
        if ign_indices_dir is not None:
            cand = [
                ign_indices_dir / f"{stems[0]}-{stems[1]}.{side}.txt"
                for side in ("src", "tgt")
            ]
            ignores = tuple(
                p.as_posix() if check_exist(p) else None for p in cand
            )

        tasks.append(
            PairTask(
                segs=tuple(p.as_posix() for p in found["segs"]),
                concats=tuple(p.as_posix() for p in found["concats"]),
                embeds=tuple(p.as_posix() for p in found["embeds"]),
                ignores=ignores,
                out_path=(out_dir / f"{stems[0]}-{stems[1]}.txt").as_posix(),
            )
        )
    return tasks


@contextlib.contextmanager
def _profile_trace(profile_dir: Optional[str], device):
    """Trace the enclosed block with torch.profiler (CPU and, on the card,
    CUDA activity) into ``profile_dir/align_trace.json``; nothing when
    ``profile_dir`` is unset."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(profile_dir) / "align_trace.json"))


def main(argv=None):
    """Run the stage on ``argv`` (default: the command line). Returns each
    aligned pair's phase wall times (the pyramid's ``runtimes``) or, with
    ``--pair_batch`` > 1 or the fused handoff on, the batched path's phase
    wall times (one dict: load, stage, pyramid, write, buckets, and fused:
    the pairs staged from the device)."""
    args = parse_args(argv)
    logger.info(args)
    check_ported(args)
    device = resolve_device(args.device)  # no card and no --device cpu: raise here

    src_lang, tgt_lang = args.src_lang, args.tgt_lang
    out_dir = Path(args.out_dir) / f"{src_lang}-{tgt_lang}"
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.ign_indices_dir is None:
        ign_indices_dir = None
    else:
        ign_indices_dir = Path(args.ign_indices_dir) / f"{src_lang}-{tgt_lang}"
        logger.info(f"Will ignore segments indicated by {ign_indices_dir}")

    all_pairs = read_metadata(args.metadata)
    valid_pairs = collect_pair_tasks(
        all_pairs,
        {
            "segs": (Path(args.seg_dir) / src_lang, Path(args.seg_dir) / tgt_lang),
            "concats": (Path(args.concat_dir) / src_lang, Path(args.concat_dir) / tgt_lang),
            "embeds": (Path(args.embed_dir) / src_lang, Path(args.embed_dir) / tgt_lang),
        },
        out_dir,
        ign_indices_dir,
    )
    with _profile_trace(args.profile_dir, device):
        # the fused handoff and the mesh live in the batched driver, so use
        # it (even at batch 1) whenever the embed stage may have left rows
        # on the card or a mesh is asked for
        if args.pair_batch > 1 or embed_cache.enabled or args.data_parallel != 1:
            if args.pair_batch <= 1:
                logger.info(
                    "fused handoff: using the batched aligner driver even at "
                    "pair_batch 1 (its seeded sampling differs slightly from "
                    "the per-pair path)"
                )
            if args.dp_backend == "native":
                logger.warning(
                    "--dp_backend native is ignored with --pair_batch > 1: "
                    "the batched pyramid runs on the device (cuda/torch)."
                )
            return _run_pairs_batched(args, valid_pairs)
        return _run_pairs(args, valid_pairs)


def _run_pairs_batched(args, valid_pairs):
    """Batched path: bucket pairs by size and run the batched pyramid."""
    from svecalign_tpu_torch.utils.embedding_utils import (
        make_doc_ids,
        read_in_embeddings,
        read_sent2id,
    )
    from svecalign_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from svecalign_tpu_torch.vecalign.batch import (
        bucket_shape,
        run_staged,
        stage_rows_device,
        stage_rows_upload,
        sync_staged,
    )
    from svecalign_tpu_torch.vecalign.vecalign import (
        load_ignore_index_file,
        make_alignment_types,
        print_alignments,
    )

    types = make_alignment_types(args.alignment_max_size)
    width_over2 = math.ceil((args.alignment_max_size - 1) / 2.0) + args.search_buffer_size

    # SVECALIGN_ALIGN_PROFILE=1: log the wall time of this function's phases
    # (pair loading, per-bucket staging / pyramid / write)
    profile = os.environ.get("SVECALIGN_ALIGN_PROFILE") == "1"
    prof = {"load": 0.0, "stage": 0.0, "pyramid": 0.0, "write": 0.0}
    t_phase = time.perf_counter()

    loaded = []        # file-backed pairs: fp16 rows uploaded per bucket
    fused_loaded = []  # fused-pipeline pairs: rows already on the device
    for pair in valid_pairs:
        seg_lines = []
        for p in pair.segs:
            with open(p, encoding="utf-8") as fp:
                seg_lines.append(fp.readlines())
        cached = [embed_cache.get(p) for p in pair.embeds]
        if all(c is not None for c in cached):
            # the embed stage left the rows on the card: no file read, no upload
            sent2id = [read_sent2id(p) for p in pair.concats]
            n_rows = [c[0] for c in cached]
            embs = [c[1] for c in cached]
        else:
            cached = None
            sent2id, embs = [], []
            for concat_p, embed_p in zip(pair.concats, pair.embeds):
                s2i, emb = read_in_embeddings(
                    concat_p, embed_p, args.is_stopes_embed, args.fp16_embed,
                )
                sent2id.append(s2i)
                embs.append(emb.astype(np.float16))
            n_rows = [e.shape[0] for e in embs]
        # raw fp16 rows + index maps: the overlap tensor is gathered on
        # device (uploading it materialized repeats every row ~n_overlaps x)
        ids = [
            make_doc_ids(
                sent2id[side], n_rows[side], seg_lines[side],
                args.alignment_max_size - 1,
                ignore_indices=load_ignore_index_file(pair.ignores[side])
                if pair.ignores[side] else None,
                overlap_segments=True,
            )
            for side in (0, 1)
        ]
        item = (pair, embs[0], ids[0], embs[1], ids[1])
        (fused_loaded if cached is not None else loaded).append(item)
    prof["load"] = time.perf_counter() - t_phase

    kwargs = dict(
        final_alignment_types=types,
        del_percentile_frac=args.del_percentile_frac,
        width_over2=width_over2,
        max_size_full_dp=args.max_size_full_dp,
        costs_sample_size=args.costs_sample_size,
        num_samps_for_norm=args.num_samps_for_norm,
        seed=args.seed,
        dp_backend=args.dp_backend if args.dp_backend != "native" else "auto",
    )

    if fused_loaded:
        logger.info(
            f"fused pipeline: {len(fused_loaded)}/{len(fused_loaded) + len(loaded)} "
            "pairs use device-resident embeddings (no re-upload)"
        )
    if embed_cache.enabled and loaded:
        # in a fused run every pair should be cached: a fallback means the
        # document exceeded the row cap, the byte cap rejected it, or a
        # resumed run skipped the embed stage
        names = ", ".join(Path(p.embeds[0]).stem for p, *_ in loaded[:5])
        logger.warning(
            f"fused handoff MISSED {len(loaded)} pair(s) -- falling back to "
            f"the file+upload path for: {names}"
            + (" ..." if len(loaded) > 5 else "")
            + f" (cache stats: {embed_cache.stats})"
        )

    # several devices: each bucket's pairs split over a mesh's data axis;
    # every device stage partitions with no cross-pair dependence
    sharding = None
    pair_batch = args.pair_batch
    if args.data_parallel != 1:
        mesh = make_mesh(n_devices=args.data_parallel or None, device=args.device)
        n_dev = mesh.shape["data"]
        sharding = batch_sharding(mesh)
        pair_batch = -(-max(pair_batch, 1) // n_dev) * n_dev
        logger.info(f"data-parallel aligner: {mesh}, pair_batch {pair_batch}")

    def pad_bucket(bucket):
        """With a mesh, repeat the last pair until the bucket splits evenly
        over it; the repeats' results are dropped by the result zip."""
        if sharding is None:
            return bucket
        return bucket + bucket[-1:] * (-len(bucket) % sharding.mesh.shape["data"])

    def stage_upload(bucket):
        return stage_rows_upload(
            [(e0, i0, e1, i1) for _, e0, i0, e1, i1 in pad_bucket(bucket)],
            quantize=args.upload_quant, device=args.device, sharding=sharding,
        )

    def stage_device(bucket):
        return stage_rows_device(
            [(e0, i0, e1, i1) for _, e0, i0, e1, i1 in pad_bucket(bucket)],
            sharding=sharding)

    # bucket by size so padding stays modest; fused pairs form their own
    # buckets. The JAX CLI pads a device-staged tail bucket up to the full
    # pair_batch (a compile rule); here a tail keeps its size, so fused and
    # unfused runs of one corpus form the same buckets.
    buckets = []
    for items, stage in ((loaded, stage_upload), (fused_loaded, stage_device)):
        items.sort(key=lambda it: it[2].shape[1] + it[4].shape[1])
        buckets += [(items[s0: s0 + pair_batch], stage)
                    for s0 in range(0, len(items), pair_batch)]

    # bucket i + 1 is staged after bucket i's pyramid, on the same thread:
    # the stage time is logged so that overlapping the two can be judged
    for bi in my_tqdm(range(len(buckets))):
        bucket, stage = buckets[bi]
        t0 = time.perf_counter()
        handle = stage(bucket)
        sync_staged(handle)
        t1 = time.perf_counter()
        results = run_staged(handle, **kwargs)
        t2 = time.perf_counter()
        for (pair, *_), (aligns, scores) in zip(bucket, results):
            with open(pair.out_path, mode="w") as fp:
                print_alignments(aligns, scores=scores, ofile=fp)
        t3 = time.perf_counter()
        prof["stage"] += t1 - t0
        prof["pyramid"] += t2 - t1
        prof["write"] += t3 - t2
        if profile:
            P, n_pad, m_pad = bucket_shape(handle)
            logger.info(
                f"align profile: bucket {bi} P={P} n={n_pad} m={m_pad} "
                f"stage={t1 - t0:.3f}s pyramid={t2 - t1:.3f}s "
                f"write={t3 - t2:.3f}s"
            )
    prof["buckets"] = len(buckets)
    prof["fused"] = len(fused_loaded)
    if profile:
        logger.info(
            "align profile: load=%.3fs stage=%.3fs pyramid=%.3fs "
            "write=%.3fs (%d buckets)"
            % (prof["load"], prof["stage"], prof["pyramid"], prof["write"],
               len(buckets))
        )
    return prof


def _run_pairs(args, valid_pairs):
    return [
        vecalign_func(
            src=pair.segs[0],
            tgt=pair.segs[1],
            src_embed=[pair.concats[0], pair.embeds[0]],
            src_stopes=args.is_stopes_embed,
            src_fp16=args.fp16_embed,
            tgt_embed=[pair.concats[1], pair.embeds[1]],
            tgt_stopes=args.is_stopes_embed,
            tgt_fp16=args.fp16_embed,
            alignment_max_size=args.alignment_max_size,
            many_to_one=None,
            search_buffer_size=args.search_buffer_size,
            del_percentile_frac=args.del_percentile_frac,
            max_size_full_dp=args.max_size_full_dp,
            costs_sample_size=args.costs_sample_size,
            num_samps_for_norm=args.num_samps_for_norm,
            overlap_segments=True,
            print_aligned_text=False,
            print_results=True,
            save_aligned_text_to_file=pair.out_path,
            verbose=False,
            src_ignore_indices=pair.ignores[0],
            tgt_ignore_indices=pair.ignores[1],
            seed=args.seed,
            dp_backend=args.dp_backend,
            device=args.device,
        )[0]["runtimes"]
        for pair in my_tqdm(valid_pairs)
    ]


if __name__ == "__main__":
    main()
