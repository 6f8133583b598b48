"""Stage 6.3 -- grow training clips by chaining adjacent alignments.

Port of the JAX package's ``postprocess/concat_aligns.py``, host only.
Mined alignments are short; training wants clips up to ~20 s. This stage
emits, per anchor alignment, the anchor itself plus every prefix-chain of
up to ``--max_num_align`` following alignments that stays admissible:
both sides contiguous in segment-id space, inter-clip silence at most
``--max_sil`` seconds on both sides, and the source-side extent at most
``--max_dur`` seconds (the target side too with
``--apply_dur_cond_to_both_sides``). Chains grow strictly stepwise: the
first inadmissible extension ends the anchor's chain. Scores do not
survive this stage. The output is byte for byte the JAX CLI's.

CLI: ``python -m svecalign_tpu_torch.postprocess.concat_aligns METADATA
OUT_DIR --max_num_align 3 --align_dir A --seg_dir D --src_lang S
--tgt_lang T [--max_sil 1.0] [--max_dur 20.0]
[--apply_dur_cond_to_both_sides]``
"""

import argparse
from pathlib import Path
from typing import List, Tuple

from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE
from svecalign_tpu_torch.utils.file_utils import (
    read_alignments,
    read_metadata,
    read_segments,
    write_alignment,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)

SegTable = List[Tuple[int, int]]
Alignment = Tuple[List[int], List[int]]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired src/tgt audio paths")
    parser.add_argument("out_dir", type=str,
                        help="destination root for the chained alignment files")
    parser.add_argument("--max_num_align", type=int,
                        help="chain length cap, in alignments")
    parser.add_argument("--align_dir", type=str, required=True,
                        help="root of the cost-filtered alignment files")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the per-document VAD segment files")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--max_sil", type=float, default=1.0,
                        help="longest admissible silence between chained clips, seconds")
    parser.add_argument("--max_dur", type=float, default=20.0,
                        help="longest admissible chained extent, seconds")
    parser.add_argument("--apply_dur_cond_to_both_sides", action="store_true",
                        default=False,
                        help="enforce --max_dur on the target side too "
                             "(default: source side only)")
    return parser.parse_args(argv)


def chain_alignments(
    alignments: List[Alignment],
    src_seg_to_frames: SegTable,
    tgt_seg_to_frames: SegTable,
    max_num_align: int,
    max_sil: float,
    max_dur: float,
    sample_rate: int,
    apply_dur_cond_to_both_sides: bool = False,
) -> List[Alignment]:
    """Each anchor plus all its admissible prefix-chains, in order: anchor
    0's chains (shortest first), then anchor 1's, and so on. The order is
    part of the file contract."""
    assert max_num_align >= 1, max_num_align

    def extent_s(table, ids, nxt):  # chain's first segment to the candidate's last
        return (table[nxt[-1]][1] - table[ids[0]][0]) / sample_rate

    def gap_s(table, ids, nxt):  # silence between the chain's end and the candidate
        return (table[nxt[0]][0] - table[ids[-1]][1]) / sample_rate

    out: List[Alignment] = []
    for base in range(len(alignments)):
        chain_src = list(alignments[base][0])
        chain_tgt = list(alignments[base][1])
        out.append((chain_src, chain_tgt))  # the unchained anchor always ships

        for cand in range(base + 1, min(base + max_num_align, len(alignments))):
            nxt_src, nxt_tgt = alignments[cand]
            admissible = (
                extent_s(src_seg_to_frames, chain_src, nxt_src) <= max_dur
                and (not apply_dur_cond_to_both_sides
                     or extent_s(tgt_seg_to_frames, chain_tgt, nxt_tgt) <= max_dur)
                and nxt_src[0] == chain_src[-1] + 1
                and nxt_tgt[0] == chain_tgt[-1] + 1
                and gap_s(src_seg_to_frames, chain_src, nxt_src) <= max_sil
                and gap_s(tgt_seg_to_frames, chain_tgt, nxt_tgt) <= max_sil
            )
            if not admissible:
                break
            chain_src = chain_src + nxt_src
            chain_tgt = chain_tgt + nxt_tgt
            out.append((chain_src, chain_tgt))
    return out


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    pair_root = f"{args.src_lang}-{args.tgt_lang}"
    align_root = Path(args.align_dir) / pair_root
    seg_root = Path(args.seg_dir)
    dst_root = Path(args.out_dir) / pair_root
    dst_root.mkdir(parents=True, exist_ok=True)

    for src_audio, tgt_audio in my_tqdm(read_metadata(args.metadata)):
        src_stem, tgt_stem = Path(src_audio).stem, Path(tgt_audio).stem
        align_path = align_root / f"{src_stem}-{tgt_stem}.txt"
        if not align_path.exists():
            logger.warning(f"{align_path.as_posix()} not exist. Skip.")
            continue
        alignments = read_alignments(align_path)
        if not alignments:
            logger.warning(f"{align_path.as_posix()} is empty. Skip.")
            continue
        chained = chain_alignments(
            alignments=alignments,
            src_seg_to_frames=read_segments(seg_root / args.src_lang / f"{src_stem}.txt"),
            tgt_seg_to_frames=read_segments(seg_root / args.tgt_lang / f"{tgt_stem}.txt"),
            max_num_align=args.max_num_align,
            max_sil=args.max_sil,
            max_dur=args.max_dur,
            sample_rate=SAMPLE_RATE,
            apply_dur_cond_to_both_sides=args.apply_dur_cond_to_both_sides,
        )
        write_alignment(chained, dst_root / f"{src_stem}-{tgt_stem}.txt")
    logger.info("Finished!")


if __name__ == "__main__":
    main()
