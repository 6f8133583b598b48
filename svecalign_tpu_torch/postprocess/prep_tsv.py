"""Stage 6.8 — flatten per-pair alignment files into the global mined tsv.

Port of the JAX package's ``postprocess/prep_tsv.py``, host only; its
output is the JAX CLI's, byte for byte once decompressed.

Every surviving alignment becomes one row of ``align.tsv.gz``::

    <margin>\t<src_audio> <start> <end> 16\t<tgt_audio> <start> <end> 16

where start/end are 16 kHz frame offsets covering the aligned segment
group (first segment's start to last segment's end), and rows are ordered
best-margin-first across the whole corpus. Downstream consumers (overlap
removal, training-manifest cuts) take score-ranked prefixes of this file,
so the global ordering is part of the format contract
(reference: svecalign/postprocess/prep_tsv.py).

CLI: ``python -m svecalign_tpu_torch.postprocess.prep_tsv METADATA OUT_DIR
--src_lang S --tgt_lang T --align_dir A --seg_dir D``
"""

import argparse
from pathlib import Path
from typing import List, Tuple

import svecalign_tpu_torch.utils.file_utils as file_utils
from svecalign_tpu_torch.utils.file_utils import (
    alignments_to_timestamps,
    read_alignments_with_score,
    read_segments,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)

# third field of each span triple: the corpus sample rate in kHz
SAMPLE_RATE_KHZ = 16


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired src/tgt audio paths")
    parser.add_argument("out_dir", type=str,
                        help="destination root; tsv lands under <out>/<sl>-<tl>/")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--align_dir", type=str, required=True,
                        help="root of the scored alignment files")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the original VAD segment files")
    return parser.parse_args(argv)


def rows_for_pair(
    align_path,
    src_seg_path,
    tgt_seg_path,
    src_audio: str,
    tgt_audio: str,
) -> List[Tuple[float, str]]:
    """Render one document pair's alignments as (margin, tsv row) tuples.

    The alignment file is parsed once; its index spans are resolved to
    frame ranges against the segment tables. Empty-side alignments are a
    format violation at this stage (deletions were filtered upstream), so
    ``ignore_empty=False`` lets the resolver raise on them.
    """
    scored = read_alignments_with_score(align_path)
    spans = [(src_ids, tgt_ids) for src_ids, tgt_ids, _ in scored]
    src_times, tgt_times, n = alignments_to_timestamps(
        spans, read_segments(src_seg_path), read_segments(tgt_seg_path),
        ignore_empty=False,
    )
    assert n == len(scored)

    out = []
    for (s0, s1), (t0, t1), (_, _, margin) in zip(src_times, tgt_times, scored):
        margin = float(margin)
        row = (f"{margin}"
               f"\t{src_audio} {s0} {s1} {SAMPLE_RATE_KHZ}"
               f"\t{tgt_audio} {t0} {t1} {SAMPLE_RATE_KHZ}")
        out.append((margin, row))
    return out


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    pair_root = f"{args.src_lang}-{args.tgt_lang}"
    align_root = Path(args.align_dir) / pair_root
    seg_root = Path(args.seg_dir)

    dst_dir = Path(args.out_dir) / pair_root
    dst_dir.mkdir(parents=True, exist_ok=True)
    dst = dst_dir / "align.tsv.gz"
    if dst.exists():
        raise FileExistsError(f"{dst} exists. Will not overwrite.")

    corpus: List[Tuple[float, str]] = []
    for src_audio, tgt_audio in my_tqdm(file_utils.read_metadata(args.metadata)):
        src_stem = Path(src_audio).stem
        tgt_stem = Path(tgt_audio).stem
        align_path = align_root / f"{src_stem}-{tgt_stem}.txt"
        if not align_path.exists():
            logger.warning(f"no alignment file {align_path}; skipping pair")
            continue
        corpus.extend(rows_for_pair(
            align_path,
            seg_root / args.src_lang / f"{src_stem}.txt",
            seg_root / args.tgt_lang / f"{tgt_stem}.txt",
            src_audio, tgt_audio,
        ))

    # stable sort on the margin alone: equal-margin rows keep corpus order
    corpus.sort(key=lambda scored: scored[0], reverse=True)

    with file_utils.open(dst, mode="w") as fp:
        fp.writelines(row + "\n" for _, row in corpus)
    logger.info(f"wrote {len(corpus)} rows to {dst}")


if __name__ == "__main__":
    main()
