"""One-command mining orchestrator: run all 16 stages end to end.

Port of the JAX package's ``pipeline.py``. The reference orchestrates the
stage graph with a bash script of CLI calls (example/voxpopuli/run.sh);
this driver runs the same graph in one process, with the same filesystem
contract: every stage still writes the standard directory tree, so resume
(skip-existing), inspection and mixing with manual CLI runs keep working.
``--stages`` selects a subset; ``--rank/--n_shard`` shards the heavy
stages across hosts.

``--fused`` keeps each document's embedding rows on the card from stage
5.3 through 5.4, 6.5, 6.6 and 6.7 (``utils/embed_cache.py``): stage 5.4
then skips the ``.embed`` read and upload, 6.6 gathers a Flat corpus on
the card and 6.7 its queries; the handoff is turned off when the run
ends. ``--overlap_untrans`` runs stages 4.2 and 5.2 on a background thread
during 5.1 and 5.3, joined before 5.4.

The flags are the JAX pipeline's plus ``--device``, forwarded to every
stage CLI that has it: the pipeline runs on the card unless ``--device
cpu`` is given, and raises without a card. ``--data_parallel`` (other
than 1) and ``--sharded_index`` are forwarded as in JAX: the align stage
splits each bucket's pairs over that many local devices and score_align
shards its corpora over them (``parallel/mesh.py``). The embed stages need
no flag: both encoders split their chunks' rows over every local card
when there is more than one.

CLI: ``python -m svecalign_tpu_torch.pipeline METADATA OUT_DIR --src_lang
en --tgt_lang de [--stages segment,...,sort] [--vad_model energy]
[--sl_ckpt_dir D] [--max_cost 0.7] [--pair_batch 8] [--fused]
[--overlap_untrans] [--device {cuda,cpu}] [...]``
"""

import argparse
import importlib
import threading
import time
from pathlib import Path

from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)

STAGES = [
    "segment",            # 4.1
    "untrans_segs",       # 4.2
    "concat_segs",        # 5.1
    "untrans_concats",    # 5.2
    "embed",              # 5.3
    "align",              # 5.4
    "filter_cost",        # 6.1
    "filter_untrans",     # 6.2
    "concat_aligns",      # 6.3
    "filter_dur",         # 6.4
    "embed_align",        # 6.5
    "prep_index",         # 6.6
    "score_align",        # 6.7
    "prep_tsv",           # 6.8
    "remove_overlaps",    # 6.9
    "sort",               # 6.10
]

PKG = "svecalign_tpu_torch"
# the CLI module of each stage
MODULES = {
    "segment": f"{PKG}.preprocess.segment",
    "untrans_segs": f"{PKG}.preprocess.detect_untranslate_segs",
    "concat_segs": f"{PKG}.seg_align.concat_segs",
    "untrans_concats": f"{PKG}.seg_align.detect_untranslate_concats",
    "embed": f"{PKG}.seg_align.embed",
    "align": f"{PKG}.seg_align.align",
    "filter_cost": f"{PKG}.postprocess.filter_by_cost",
    "filter_untrans": f"{PKG}.postprocess.filter_untrans_align",
    "concat_aligns": f"{PKG}.postprocess.concat_aligns",
    "filter_dur": f"{PKG}.postprocess.filter_by_dur",
    "embed_align": f"{PKG}.postprocess.embed_align",
    "prep_index": f"{PKG}.postprocess.prep_index",
    "score_align": f"{PKG}.postprocess.score_align",
    "prep_tsv": f"{PKG}.postprocess.prep_tsv",
    "remove_overlaps": f"{PKG}.postprocess.remove_overlaps",
    "sort": f"{PKG}.postprocess.sort_tsv",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--stages", type=str, default=",".join(STAGES),
                        help="comma-separated subset of: " + ",".join(STAGES))
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--n_shard", type=int, default=1)
    # knobs forwarded to the stages (reference defaults)
    parser.add_argument("--vad_model", type=str, default="energy")
    parser.add_argument("--vad_ckpt", type=str, default=None)
    parser.add_argument("--embed_model_type", type=str, default="speech_laser")
    parser.add_argument("--sl_ckpt_dir", type=str, default=None)
    parser.add_argument("--src_ckpt_name", type=str, default=None)
    parser.add_argument("--tgt_ckpt_name", type=str, default=None)
    parser.add_argument("--alignment_max_size", type=int, default=6)
    parser.add_argument("--pair_batch", type=int, default=1)
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="shard the align stage's pair axis over this many "
                             "local devices (0 = all). See seg_align.align. (The "
                             "embed stages need no flag: both encoders split "
                             "their batch rows over every visible card.)")
    parser.add_argument("--sharded_index", action="store_true", default=False,
                        help="score_align: shard the loaded kNN corpora (Flat "
                             "or IVF) row-wise over the local devices.")
    parser.add_argument("--fused", action="store_true", default=False,
                        help="fused embed->align handoff: keep each document's "
                             "embedding rows on the card between the stages, so "
                             "that align, prep_index and score_align skip the "
                             ".embed read and upload (utils/embed_cache.py). The "
                             ".embed files are still written. Fused align always "
                             "uses the batched driver, whose seeded sampling "
                             "differs slightly from the per-pair path: at "
                             "--pair_batch 1 outputs can differ from the same "
                             "command without --fused (a mode switch, not "
                             "nondeterminism).")
    parser.add_argument("--fused_max_rows", type=int, default=0,
                        help="row cap per cached document; bigger documents fall "
                             "back to the file+upload path. 0 (default) = "
                             "auto-size from the concat files right before the "
                             "embed stage.")
    parser.add_argument("--embed_max_tokens", type=int, default=600 * 16000,
                        help="embed-stage batch size in SAMPLES (the stage "
                             "CLI's --max_tokens keeps the reference default "
                             "150 s; the JAX pipeline's 600 s is kept, since "
                             ".embed bytes depend on it).")
    parser.add_argument("--window_assembly", type=str, default="device",
                        choices=["device", "host"],
                        help="embed stages: 'device' uploads each waveform once "
                             "and gathers the overlap windows on the card; "
                             "'host' stages every padded window batch from the "
                             "host.")
    parser.add_argument("--overlap_untrans", action="store_true", default=False,
                        help="run the untranslated-duplicate stages "
                             "(detect_untranslate_segs + _concats) on a "
                             "background thread concurrently with "
                             "concat_segs + embed, joining before align. Their "
                             "outputs feed only align and filter_untrans, so "
                             "outputs are byte-identical either way; "
                             "stage_seconds then counts the overlapped wall twice.")
    parser.add_argument("--corpus_quant", type=str, default="fp16",
                        choices=["fp16", "int8"],
                        help="score_align device-corpus precision: int8 halves "
                             "fp16's memory (~1e-3 margin noise); fp16 is exact.")
    parser.add_argument("--knn_k", type=int, default=16,
                        help="score_align --k (neighbors per margin denominator). "
                             "Corpora smaller than k collapse the margin scores "
                             "(reference semantics): lower this for tiny corpora.")
    parser.add_argument("--max_cost", type=float, default=0.7)
    parser.add_argument("--max_num_align", type=int, default=3)
    parser.add_argument("--min_dur", type=float, default=1.0)
    parser.add_argument("--min_audio_length", type=int, default=2000)
    parser.add_argument("--mining_threshold", type=float, default=0.0)
    parser.add_argument("--max_overlap", type=float, default=0.8)
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run the card's stages on the card (default) or on "
                             "the CPU; forwarded to every stage CLI that has it.")
    return parser.parse_args(argv)


def _auto_size_fused_cache(cat_dir: Path, langs) -> None:
    """Derive the fused cache's per-document row cap from the concat files
    (one line = one embedding row, known before any embedding happens),
    rounded up to a multiple of 1024 and at least 4096: with the old fixed
    4096 the hour-scale documents the pipeline targets (~10k rows) fell off
    the fused path without a word."""
    largest = 0
    for lang in langs:
        for txt in (cat_dir / lang).glob("*.txt"):
            with open(txt, "rb") as fp:
                largest = max(largest, sum(1 for _ in fp))
    if largest == 0:
        logger.warning(
            f"fused auto-size: no concat files under {cat_dir}; keeping "
            f"max_rows={embed_cache.max_rows}"
        )
        return
    embed_cache.max_rows = max(4096, -(-largest // 1024) * 1024)
    logger.info(
        f"fused cache auto-sized: max_rows={embed_cache.max_rows} "
        f"(largest concat document: {largest} rows)"
    )


stage_seconds: dict = {}
"""Wall seconds per stage module of the last pipeline run (cumulative:
segment, concat_segs and embed run once per language). Logged at the end
of :func:`main`. Under ``--overlap_untrans`` the two threads write
different keys."""


def _invoke(module: str, *argv: str) -> None:
    """Run a stage CLI in-process: ``module.main(argv)``. Every stage main
    takes its argv, so no stage reads ``sys.argv`` (safe on the
    ``--overlap_untrans`` thread)."""
    logger.info(f">>> {module} {' '.join(argv)}")
    mod = importlib.import_module(module)
    t0 = time.perf_counter()
    try:
        mod.main(list(argv))
    finally:
        name = module.rpartition(".")[2]
        stage_seconds[name] = stage_seconds.get(name, 0.0) + time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages: {unknown}")
    resolve_device(args.device)  # no card and no --device cpu: raise here
    stage_seconds.clear()

    if args.fused:
        embed_cache.enable(rows=args.fused_max_rows or 4096)

    out = Path(args.out_dir)
    meta = args.metadata
    sl, tl = args.src_lang, args.tgt_lang
    seg = str(out / "segments")
    unsegs = str(out / "untrans_segs")
    cat = str(out / "cat_segs")
    uncats = str(out / "untrans_cat_seg_ids")
    emb = str(out / "embeds")
    ali = str(out / "alignments")
    ali_c = f"{ali}_{args.max_cost}"
    ali_cc = f"{ali_c}_clean"
    ali_cat = f"{ali_cc}_cat{args.max_num_align}"
    ali_min = f"{ali_cat}_min{args.min_dur:g}s"
    ali_emb = f"{ali_min}_embed"
    ali_idx = f"{ali_min}_embed_indexes"
    ali_mrg = f"{ali_min}_margin"
    ali_tsv = f"{ali_min}_tsvs"
    shard = ["--rank", str(args.rank), "--n_shard", str(args.n_shard)]
    langs = ["--src_lang", sl, "--tgt_lang", tl]
    dev = ["--device", args.device]
    # embed-file format follows the embedder: SpeechLASER writes stopes
    # .npy, SONAR headerless raw rows (reference embed_model_utils.py)
    stopes = args.embed_model_type == "speech_laser"

    def run(stage, *argv):
        _invoke(MODULES[stage], *argv)

    if "segment" in stages:
        for lang, tgt in [(sl, []), (tl, ["--use_tgt"])]:
            run("segment", meta, seg, "--lang", lang, "--vad_model", args.vad_model,
                *(["--vad_ckpt", args.vad_ckpt] if args.vad_ckpt else []),
                *shard, *tgt, *dev)

    def untrans_segs():
        if "untrans_segs" in stages:
            run("untrans_segs", meta, unsegs, "--seg_dir", seg, *langs, *dev)

    def untrans_concats():
        if "untrans_concats" in stages:
            run("untrans_concats", meta, uncats, "--seg_dir", seg,
                "--identical_seg_dir", unsegs, *langs)

    # --overlap_untrans: stages 4.2 and 5.2 need only the segments and the
    # audio, and feed only align and filter_untrans: run them beside 5.1 and
    # 5.3 and join before align. Only when embed runs in this invocation.
    untrans_thread = None
    untrans_exc: list = []
    if args.overlap_untrans and "embed" in stages:
        def untrans_bg():
            try:
                untrans_segs()
                untrans_concats()
            except BaseException as e:  # re-raised at the join
                untrans_exc.append(e)

        untrans_thread = threading.Thread(target=untrans_bg, name="untrans")
        untrans_thread.start()
    else:
        untrans_segs()
    if "concat_segs" in stages:
        for lang, tgt in [(sl, []), (tl, ["--use_tgt"])]:
            run("concat_segs", meta, cat, "--seg_dir", seg, "--lang", lang, *tgt)
    if untrans_thread is None:
        untrans_concats()
    if "embed" in stages:
        if args.fused and not args.fused_max_rows:
            _auto_size_fused_cache(Path(cat), [sl, tl])
        for lang, name, tgt in [(sl, args.src_ckpt_name, []),
                                (tl, args.tgt_ckpt_name, ["--use_tgt"])]:
            ck = []
            if args.sl_ckpt_dir and name:
                ck = ["--sl_ckpt_dir", args.sl_ckpt_dir, "--sl_ckpt_name", name]
            run("embed", meta, emb, "--concat_dir", cat, "--lang", lang,
                "--embed_model_type", args.embed_model_type,
                "--window_assembly", args.window_assembly,
                "--max_tokens", str(args.embed_max_tokens), *ck, *shard, *tgt, *dev)
    if untrans_thread is not None:
        untrans_thread.join()
        if untrans_exc:
            raise untrans_exc[0]
    if "align" in stages:
        # SONAR writes headerless raw fp16: align must be told, or it parses
        # the bytes as fp32 (stopes .npy carries its dtype in the header)
        run("align", meta, ali, *langs, "--seg_dir", seg, "--concat_dir", cat,
            "--embed_dir", emb, *(["--is_stopes_embed"] if stopes else ["--fp16_embed"]),
            "-a", str(args.alignment_max_size), "--ign_indices_dir", uncats,
            "--pair_batch", str(args.pair_batch),
            *(["--data_parallel", str(args.data_parallel)] if args.data_parallel != 1 else []),
            *dev)
    if args.fused and not ({"embed_align", "prep_index", "score_align"} & set(stages)):
        # no consumer left (embed_align reuses the cached overlap rows;
        # prep_index and score_align gather from the cache): free the
        # memory right after the align stage
        embed_cache.clear()
    if "filter_cost" in stages:
        run("filter_cost", meta, ali_c, "--align_dir", ali, "--max_cost", str(args.max_cost),
            *langs)
    if "filter_untrans" in stages:
        run("filter_untrans", meta, ali_cc, "--align_dir", ali_c, *langs, "--seg_dir", seg, *dev)
    if "concat_aligns" in stages:
        run("concat_aligns", meta, ali_cat, "--max_num_align", str(args.max_num_align),
            "--align_dir", ali_cc, "--seg_dir", seg, *langs, "--apply_dur_cond_to_both_sides")
    if "filter_dur" in stages:
        run("filter_dur", meta, ali_min, "--align_dir", ali_cat, "--seg_dir", seg, *langs,
            "--min_dur", str(args.min_dur))
    if "embed_align" in stages:
        for name, tgt in [(args.src_ckpt_name, []), (args.tgt_ckpt_name, ["--use_tgt"])]:
            ck = []
            if args.sl_ckpt_dir and name:
                ck = ["--sl_ckpt_dir", args.sl_ckpt_dir, "--sl_ckpt_name", name]
            # the same --max_tokens as the embed stage, or load_embed_model's
            # memo misses and a second encoder is built
            run("embed_align", meta, ali_emb, *langs, "--align_dir", ali_min,
                "--seg_dir", seg, "--concat_seg_dir", cat, "--concat_seg_embed_dir", emb,
                "--embed_model_type", args.embed_model_type,
                "--window_assembly", args.window_assembly,
                "--max_tokens", str(args.embed_max_tokens), *ck, *tgt, *dev)
    if "prep_index" in stages:
        for tgt in ([], ["--use_tgt"]):
            run("prep_index", meta, ali_idx, "--data_dir", ali_emb, *langs, "--embed_fp16",
                "--sample_ratio", "0.5", *(["--embed_stopes"] if stopes else []), *tgt, *dev)
    if "score_align" in stages:
        run("score_align", meta, ali_mrg, "--embed_dir", ali_emb, "--align_dir", ali_min,
            *langs, "--index_dir", ali_idx, "--embed_fp16", "--k", str(args.knn_k),
            *(["--embed_stopes"] if stopes else []),
            *(["--sharded_index"] if args.sharded_index else []),
            *(["--corpus_quant", "int8"] if args.corpus_quant == "int8" else []), *dev)
    if "prep_tsv" in stages:
        run("prep_tsv", meta, ali_tsv, *langs, "--align_dir", ali_mrg, "--seg_dir", seg)
    if "remove_overlaps" in stages:
        run("remove_overlaps", "--output_dir", f"{ali_tsv}/{sl}-{tl}",
            "--output_filename", "align.rm_overlap.tsv.gz",
            "--mining_result_path", f"{ali_tsv}/{sl}-{tl}/align.tsv.gz",
            "--min_audio_length", str(args.min_audio_length),
            "--mining_threshold", str(args.mining_threshold),
            "--max_overlap", str(args.max_overlap))
    if "sort" in stages:
        run("sort", "--in_tsv", f"{ali_tsv}/{sl}-{tl}/align.rm_overlap.tsv.gz",
            "--out_tsv", f"{ali_tsv}/{sl}-{tl}/align.rm_overlap.sort.tsv.gz")
    if args.fused:
        logger.info(f"embed_cache stats: {embed_cache.stats}")
        # the JAX pipeline only clears, leaving the handoff on for whatever
        # runs next in the process
        embed_cache.disable()
    breakdown = " | ".join(f"{k} {v:.1f}s" for k, v in stage_seconds.items())
    logger.info(f"stage breakdown: {breakdown}")
    logger.info("Pipeline finished!")


if __name__ == "__main__":
    main()
