"""Stage 6.5 -- embed the final alignments, reusing concat-segment embeddings.

Port of the JAX package's ``postprocess/embed_align.py``. For each
alignment's merged (start, end) span on one side: if that exact span is a
line of the stage-5.3 concat-segment list, point to its existing
embedding row; otherwise embed the span on the card. Output per pair:
``{src}-{tgt}.{src|tgt}.embed`` with only the fresh rows (a stopes ``.npy``
for SpeechLASER, headerless raw rows for SONAR; not written when every
span is reused) and ``{src}-{tgt}.{src|tgt}.tsv`` of ``embed_file_path \\t
row_id`` pointers, one line per alignment, written last: the tsv alone
marks the pair as done. Atomic renames, as in JAX. While the fused handoff
is on (``utils/embed_cache.py``) the fresh rows also stay on the card,
keyed by their ``.embed`` path, for stages 6.6 and 6.7.

CLI: ``python -m svecalign_tpu_torch.postprocess.embed_align METADATA
OUT_DIR --src_lang S --tgt_lang T --align_dir A --seg_dir D
--concat_seg_dir C --concat_seg_embed_dir E [--use_tgt] [embed-model
flags of stage 5.3] [--device {cuda,cpu}]``

The flags are the JAX CLI's plus ``--device``: the stage runs on the card
unless ``--device cpu`` is given, and raises without a card.
"""

import argparse
from pathlib import Path
from typing import Dict, List, Tuple, Union

from svecalign_tpu_torch.utils.embed_model_utils import (
    add_embed_args,
    embed_segments_to_file,
    load_embed_model,
)
from svecalign_tpu_torch.utils.file_utils import (
    alignments_to_timestamps,
    delete_if_exist,
    read_metadata,
    read_segments,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str,
                        help="where to save the embeddings and tsvs.")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--align_dir", type=str, required=True,
                        help="where the alignments are saved.")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="the dir for all segments.")
    parser.add_argument("--concat_seg_dir", type=str, required=True,
                        help="dir for all concatenated segments")
    parser.add_argument("--concat_seg_embed_dir", type=str, required=True,
                        help="dir for all concatenated segments' embeddings")
    parser.add_argument("--use_tgt", action="store_true", default=False,
                        help="whether to embed target side.")
    add_embed_args(parser)
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or on the CPU.")
    return parser.parse_args(argv)


def find_reusable_embeddings(
    all_segments: List[Tuple[int, int]],
    overlap_seg_path: Path,
) -> Tuple[Dict[int, int], List[int]]:
    """Map alignment spans onto existing concat-segment embedding rows.

    Returns (alignment id -> concat embedding row) for hits and the list of
    alignment ids that still need embedding."""
    existed = read_segments(overlap_seg_path)
    existed_to_id = {seg: _id for _id, seg in enumerate(existed)}

    id_mapping: Dict[int, int] = {}
    miss_ids: List[int] = []
    for ii, seg in enumerate(all_segments):
        if seg in existed_to_id:
            id_mapping[ii] = existed_to_id[seg]
        else:
            miss_ids.append(ii)
    return id_mapping, miss_ids


def load_one_side_alignments(
    align_path: Union[str, Path],
    src_seg_path: Union[str, Path],
    tgt_seg_path: Union[str, Path],
    embed_source: bool,
) -> List[Tuple[int, int]]:
    """One side's (start, end) span per alignment; a deletion raises (stage
    6.1 removes them)."""
    src_segs = read_segments(src_seg_path)
    tgt_segs = read_segments(tgt_seg_path)
    src_aligns, tgt_aligns, _ = alignments_to_timestamps(
        align_path, src_segs, tgt_segs, ignore_empty=False
    )
    return src_aligns if embed_source else tgt_aligns


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    device = resolve_device(args.device)

    all_pairs = read_metadata(args.metadata)

    embed_src = not args.use_tgt
    src_lang, tgt_lang = args.src_lang, args.tgt_lang
    embed_lang = src_lang if embed_src else tgt_lang
    file_suffix = "src" if embed_src else "tgt"
    logger.info(f"Will process {file_suffix}. Lang={embed_lang}. Suffix={file_suffix}")

    align_dir = Path(args.align_dir) / f"{src_lang}-{tgt_lang}"
    seg_dir = Path(args.seg_dir)
    concat_seg_dir = Path(args.concat_seg_dir) / embed_lang
    concat_seg_embed_dir = Path(args.concat_seg_embed_dir) / embed_lang

    out_dir = Path(args.out_dir) / f"{src_lang}-{tgt_lang}"
    out_dir.mkdir(parents=True, exist_ok=True)

    embed_model = load_embed_model(
        args.embed_model_type,
        sl_ckpt_dir=args.sl_ckpt_dir,
        sl_ckpt_name=args.sl_ckpt_name,
        max_tokens=args.max_tokens,
        sonar_name=args.sonar_name,
        batch_size=args.batch_size or 16,
        upload_precision=args.upload_precision,
        device=device,
    )

    for src_aud_path, tgt_aud_path in my_tqdm(all_pairs):
        src_stem = Path(src_aud_path).stem
        tgt_stem = Path(tgt_aud_path).stem

        embed_stem = src_stem if embed_src else tgt_stem
        embed_aud_path = src_aud_path if embed_src else tgt_aud_path

        tsv_out_path = out_dir / f"{src_stem}-{tgt_stem}.{file_suffix}.tsv"
        embed_out_path = out_dir / f"{src_stem}-{tgt_stem}.{file_suffix}.embed"
        if tsv_out_path.exists():
            continue  # the tsv alone marks this pair as processed

        delete_if_exist(embed_out_path)

        in_align_path = align_dir / f"{src_stem}-{tgt_stem}.txt"
        if not in_align_path.exists():
            logger.warning(f"{in_align_path.as_posix()} not exist. Skip.")
            continue

        all_segments = load_one_side_alignments(
            in_align_path,
            src_seg_path=seg_dir / src_lang / f"{src_stem}.txt",
            tgt_seg_path=seg_dir / tgt_lang / f"{tgt_stem}.txt",
            embed_source=embed_src,
        )

        reuse_map, miss_seg_ids = find_reusable_embeddings(
            all_segments, concat_seg_dir / f"{embed_stem}.txt"
        )
        logger.info(f"{src_stem}-{tgt_stem}: n_hit={len(reuse_map)} | n_miss={len(miss_seg_ids)}")

        miss_seg_to_embed_id = {}
        if miss_seg_ids:
            miss_segments = [all_segments[_id] for _id in miss_seg_ids]
            tmp_embed = embed_out_path.with_suffix(".tmp")
            delete_if_exist(tmp_embed)
            embed_segments_to_file(
                embed_model,
                args.embed_model_type,
                embed_aud_path,
                miss_segments,
                str(tmp_embed),
                fp16=not args.embed_fp32,
                cache_key=str(embed_out_path),
                window_assembly=args.window_assembly,
            )
            tmp_embed.replace(embed_out_path)
            miss_seg_to_embed_id = {seg: ii for ii, seg in enumerate(miss_segments)}

        overlap_embed_path = concat_seg_embed_dir / f"{embed_stem}.embed"
        tmp_tsv = tsv_out_path.with_suffix(".tmp")
        delete_if_exist(tmp_tsv)
        with open(tmp_tsv, mode="w") as fp:
            for ii, seg in enumerate(all_segments):
                if ii in reuse_map:
                    fp.write(f"{overlap_embed_path.as_posix()}\t{reuse_map[ii]}\n")
                else:
                    fp.write(f"{embed_out_path.as_posix()}\t{miss_seg_to_embed_id[seg]}\n")
        tmp_tsv.replace(tsv_out_path)

    logger.info("Finished!")


if __name__ == "__main__":
    main()
