"""Stage 5.1 — enumerate candidate spans: runs of consecutive VAD segments.

Port of the JAX package's ``seg_align/concat_segs.py``, host only; its
files are the JAX CLI's, byte for byte.

The aligner scores *groups* of adjacent segments against each other, so
this stage expands each document's VAD table into every run of 1..N
consecutive segments whose audio extent (first start to last end,
including inter-segment silence) fits a duration cap. Each run becomes a
``"start end"`` frame-range line; the file is sorted lexicographically on
those strings and its line order is the row order of the embedding matrix
produced downstream — reordering here would silently scramble every
embedding lookup (reference: svecalign/seg_align/concat_segs.py, itself
derived from vecalign's overlap.py).

CLI: ``python -m svecalign_tpu_torch.seg_align.concat_segs METADATA OUT_DIR
--seg_dir D --lang L [--use_tgt] [--num_overlaps 5] [--max_dur 20.0]``
"""

import argparse
from pathlib import Path
from typing import Iterator, List, Tuple

from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE
from svecalign_tpu_torch.utils.file_utils import read_metadata, read_segments
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired src/tgt audio paths")
    parser.add_argument("out_dir", type=str,
                        help="destination root; files land under <out>/<lang>/")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the per-document VAD segment files")
    parser.add_argument("--lang", type=str, required=True)
    parser.add_argument("--use_tgt", action="store_true", default=False,
                        help="take column 2 of the metadata instead of column 1")
    parser.add_argument("--num_overlaps", type=int, default=5,
                        help="longest run of consecutive segments to span")
    parser.add_argument("--max_dur", type=float, default=20.0,
                        help="duration cap per span, seconds of audio extent")
    return parser.parse_args(argv)


def iter_spans(
    segs: List[Tuple[int, int]],
    max_run: int,
    frame_cap: int,
) -> Iterator[Tuple[int, int]]:
    """Yield the frame extent of every admissible segment run.

    A run is anchored at segment k and extends over at most ``max_run``
    consecutive segments; its extent is (segs[k].start, last.end).
    Extension stops at the FIRST segment whose end overflows the cap —
    VAD tables are monotone, so no later end can fit either. An anchor
    whose own segment already overflows contributes no spans at all.
    """
    if max_run <= 0:
        raise ValueError(f"max_run must be positive, got {max_run}")
    for k in range(len(segs)):
        anchor = segs[k][0]
        for _, stop in segs[k:k + max_run]:
            if stop - anchor > frame_cap:
                break
            yield anchor, stop


def write_span_file(
    in_path,
    out_path: Path,
    num_overlaps: int,
    max_dur: float = 30.0,
    sample_rate: int = SAMPLE_RATE,
) -> None:
    """Expand one document's VAD table into its sorted span file."""
    frame_cap = int(max_dur * sample_rate)
    spans = iter_spans(read_segments(in_path), num_overlaps, frame_cap)

    # lexicographic sort of the *strings* is the format contract: the
    # embedding stage re-reads this file and trusts line order as row order
    lines = sorted(f"{lo} {hi}" for lo, hi in spans)
    if not lines:
        logger.warning(f"no admissible spans in {in_path}")

    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, mode="w") as fp:
        fp.writelines(line + "\n" for line in lines)


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    side = 1 if args.use_tgt else 0
    documents = sorted({pair[side] for pair in read_metadata(args.metadata)})

    seg_root = Path(args.seg_dir) / args.lang
    dst_root = Path(args.out_dir) / args.lang
    dst_root.mkdir(parents=True, exist_ok=True)

    for audio_path in my_tqdm(documents):
        stem = Path(audio_path).stem
        write_span_file(
            in_path=seg_root / f"{stem}.txt",
            out_path=dst_root / f"{stem}.txt",
            num_overlaps=args.num_overlaps,
            max_dur=args.max_dur,
        )
    logger.info("Finished!")


if __name__ == "__main__":
    main()
