"""Stage 5.2 — project untranslated-segment flags onto the span table.

Port of the JAX package's ``seg_align/detect_untranslate_concats.py``,
host only; its files are the JAX CLI's, byte for byte.

Stage 4 flagged individual VAD segments as "identical across languages"
(untranslated boilerplate). The embedding loader, however, works in span
space — runs of consecutive segments produced by concat_segs — so this
stage replays the same run-admission rule and records, for each anchor
whose run touches a flagged segment, the pair ``anchor first_flagged``.
The loader zeroes every span row from that point on (reference:
svecalign/seg_align/detect_untranslate_concats.py).

CLI: ``python -m svecalign_tpu_torch.seg_align.detect_untranslate_concats
METADATA OUT_DIR --seg_dir D --identical_seg_dir U --src_lang S --tgt_lang T``
"""

import argparse
from pathlib import Path
from typing import List, Set, Tuple

from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE
from svecalign_tpu_torch.utils.file_utils import read_metadata, read_segments
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired src/tgt audio paths")
    parser.add_argument("out_dir", type=str,
                        help="destination root; files land under <out>/<sl>-<tl>/")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the per-document VAD segment files")
    parser.add_argument("--identical_seg_dir", type=str, required=True,
                        help="root of the stage-4 untranslated segment-id files")
    parser.add_argument("--src_lang", required=True, type=str)
    parser.add_argument("--tgt_lang", required=True, type=str)
    parser.add_argument("--num_overlaps", type=int, default=5,
                        help="longest run of consecutive segments to span "
                             "(must match concat_segs)")
    parser.add_argument("--max_dur", type=float, default=20.0,
                        help="duration cap per span, seconds (must match concat_segs)")
    return parser.parse_args(argv)


def read_flagged_ids(path) -> Set[int]:
    """One integer segment index per line."""
    with open(path) as fp:
        return {int(line.strip()) for line in fp}


def flag_hits_per_anchor(
    segs: List[Tuple[int, int]],
    flagged: Set[int],
    max_run: int,
    frame_cap: int,
) -> List[Tuple[int, int]]:
    """Walk each anchor's admissible run; report its first flagged member.

    The run-admission rule must mirror concat_segs.iter_spans exactly
    (same cap, same first-overflow stop), because the output indexes into
    the span table that rule generated. A run with no flagged member
    contributes nothing; one hit per anchor suffices since the loader
    zeroes all longer spans of the same anchor anyway.
    """
    if max_run <= 0:
        raise ValueError(f"max_run must be positive, got {max_run}")
    hits = []
    for k, (lo, hi) in enumerate(segs):
        if hi - lo > frame_cap:
            continue  # anchor inadmissible: it anchors no spans at all
        for j in range(k, min(k + max_run, len(segs))):
            if segs[j][1] - lo > frame_cap:
                break
            if j in flagged:
                hits.append((k, j))
                break
    return hits


def main(argv=None):
    """argv=None reads sys.argv (CLI contract); the pipeline's overlapped
    untrans thread passes an explicit list so two concurrently-running
    stages never race on the process-global sys.argv."""
    args = parse_args(argv)
    logger.info(args)

    pair_root = f"{args.src_lang}-{args.tgt_lang}"
    seg_root = Path(args.seg_dir)
    flags_root = Path(args.identical_seg_dir) / pair_root

    dst_root = Path(args.out_dir) / pair_root
    dst_root.mkdir(parents=True, exist_ok=True)

    frame_cap = int(args.max_dur * SAMPLE_RATE)

    for src_audio, tgt_audio in my_tqdm(read_metadata(args.metadata)):
        pair_stem = f"{Path(src_audio).stem}-{Path(tgt_audio).stem}"
        for side, lang, audio in (("src", args.src_lang, src_audio),
                                  ("tgt", args.tgt_lang, tgt_audio)):
            hits = flag_hits_per_anchor(
                read_segments(seg_root / lang / f"{Path(audio).stem}.txt"),
                read_flagged_ids(flags_root / f"{pair_stem}.{side}.txt"),
                max_run=args.num_overlaps,
                frame_cap=frame_cap,
            )
            with open(dst_root / f"{pair_stem}.{side}.txt", mode="w") as fp:
                fp.writelines(f"{k} {j}\n" for k, j in hits)

    logger.info("Finished!")


if __name__ == "__main__":
    main()
