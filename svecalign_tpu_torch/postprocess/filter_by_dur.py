"""Stage 6.4 -- require a minimum duration on both sides of an alignment.

Port of the JAX package's ``postprocess/filter_by_dur.py``, host only.
Sub-second clips carry too little signal for the margin scorer and for
encoder training, so any alignment whose source or target span is
shorter than ``--min_dur`` (default 1 s) is dropped. Surviving lines are
passed through byte for byte; a pair with no survivor gets no file.

CLI: ``python -m svecalign_tpu_torch.postprocess.filter_by_dur METADATA
OUT_DIR --align_dir A --seg_dir D --src_lang S --tgt_lang T
[--min_dur 1.0]``
"""

import argparse
from pathlib import Path

from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE
from svecalign_tpu_torch.utils.file_utils import (
    alignments_to_timestamps,
    read_lines,
    read_metadata,
    read_segments,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired audio paths, one doc pair per line")
    parser.add_argument("out_dir", type=str,
                        help="root of the filtered alignment tree")
    parser.add_argument("--align_dir", type=str, required=True,
                        help="root of the concatenated alignment tree (stage 6.3 output)")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the VAD segment tree (frame timestamps)")
    parser.add_argument("--min_dur", type=float, default=1.0,
                        help="minimum span duration in seconds, enforced on both sides")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    return parser.parse_args(argv)


def do_filter(align_path: Path, src_seg_path: Path, tgt_seg_path: Path, min_frames: int,
              out_path: Path) -> None:
    """Keep the alignment lines whose source and target spans each cover at
    least ``min_frames`` samples; write nothing if none qualify."""
    spans_src, spans_tgt, n_aligns = alignments_to_timestamps(
        align_path, read_segments(src_seg_path), read_segments(tgt_seg_path),
        ignore_empty=True)
    raw_lines = read_lines(align_path)
    keep = [raw_lines[i] for i in range(n_aligns)
            if spans_src[i][1] - spans_src[i][0] >= min_frames
            and spans_tgt[i][1] - spans_tgt[i][0] >= min_frames]
    if not keep:
        logger.info(f"every alignment in {align_path.as_posix()} is under the duration "
                    f"floor; not writing {out_path.as_posix()}")
        return
    with open(out_path, mode="w") as fp:
        fp.writelines(line + "\n" for line in keep)


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    pair_dir = f"{args.src_lang}-{args.tgt_lang}"
    align_dir = Path(args.align_dir) / pair_dir
    seg_dir = Path(args.seg_dir)
    out_dir = Path(args.out_dir) / pair_dir
    out_dir.mkdir(parents=True, exist_ok=True)

    min_frames = int(SAMPLE_RATE * args.min_dur)
    logger.info(f"Duration floor: {args.min_dur:g} s = {min_frames} frames")

    for src_audio, tgt_audio in my_tqdm(read_metadata(args.metadata)):
        src_stem, tgt_stem = Path(src_audio).stem, Path(tgt_audio).stem
        align_path = align_dir / f"{src_stem}-{tgt_stem}.txt"
        if not align_path.exists():
            logger.warning(f"no alignment file {align_path.as_posix()}; skipping")
            continue
        do_filter(align_path, seg_dir / args.src_lang / f"{src_stem}.txt",
                  seg_dir / args.tgt_lang / f"{tgt_stem}.txt", min_frames,
                  out_dir / f"{src_stem}-{tgt_stem}.txt")
    logger.info("Duration filter done.")


if __name__ == "__main__":
    main()
