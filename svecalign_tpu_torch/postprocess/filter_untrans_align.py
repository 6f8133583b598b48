"""Stage 6.2 — drop alignments whose two sides are the same audio.

Port of the JAX package's ``postprocess/filter_untrans_align.py``; its
files are the JAX CLI's, byte for byte.

Interpretation sessions sometimes carry the floor language through both
channels, so a "translation pair" can be the identical clip twice. For
every alignment, the merged source span and merged target span are
compared: if their durations differ by at most ``--dur_diff`` seconds AND
the best sliding-window fbank MSE between them is at most
``--fbank_dist_thres``, the alignment is judged untranslated and removed.
Survivors keep their original file lines (scores intact). A pair whose
alignments are ALL untranslated writes no output file: downstream stages
treat a missing file as "no alignments" (the reference instead crashes on
the rename of a tmp file it never wrote; reference
svecalign/postprocess/filter_untrans_align.py:110,172).

Two phases per document pair: the duration gate on the host, then one
fbank batch of the suspects' spans on the card and the MSE verdicts on
the host. Workers over document pairs, skip-existing, atomic tmp-rename.

CLI: ``python -m svecalign_tpu_torch.postprocess.filter_untrans_align
METADATA OUT_DIR --align_dir A --src_lang S --tgt_lang T --seg_dir D
[--dur_diff 0.5] [--fbank_dist_thres 5.0] [--n_proc N] [--save_audio]
[--device {cuda,cpu}]``
"""

import argparse
from pathlib import Path
from typing import List, Optional, Tuple

from svecalign_tpu_torch.utils.audio_utils import (
    SAMPLE_RATE,
    Segment,
    batch_segment_fbanks,
    compute_fbank_dist,
    untrans_clock,
)
from svecalign_tpu_torch.utils.file_utils import (
    alignments_to_timestamps,
    delete_if_exist,
    read_alignments,
    read_lines,
    read_metadata,
    read_segments,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.mp_utils import start_multi_processes
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired src/tgt audio paths")
    parser.add_argument("out_dir", type=str,
                        help="destination root for the cleaned alignment files")
    parser.add_argument("--align_dir", type=str, required=True,
                        help="root of the cost-filtered alignment files")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="root of the per-document VAD segment files")
    parser.add_argument("--dur_diff", type=float, default=0.5,
                        help="duration-difference gate, seconds: wider apart "
                             "than this and the pair cannot be identical")
    parser.add_argument("--fbank_dist_thres", type=float, default=5.0,
                        help="sliding-window fbank MSE at or below this "
                             "marks the pair identical")
    parser.add_argument("--n_proc", type=int, default=1,
                        help="worker processes over document pairs")
    parser.add_argument("--save_audio", action="store_true", default=False,
                        help="dump detected duplicates as ogg under "
                             "<out_dir>/wavs for human audit")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="where the fbanks run (the MSE runs on the host)")
    return parser.parse_args(argv)


def filter_one_pair(
    align_path,
    src_segs: List[Tuple[int, int]],
    tgt_segs: List[Tuple[int, int]],
    src_audio_path,
    tgt_audio_path,
    max_frame_diff: int,
    fbank_dist_thres: float,
    out_path: Path,
    audio_out_dir: Optional[Path] = None,
    device="cuda",
) -> int:
    """Classify one pair's alignments; write survivors; return #duplicates.

    Survivors are written as their ORIGINAL lines (the score suffix must
    ride along untouched). When nothing survives, no file is written.
    """
    clock = untrans_clock(device)
    alignments = read_alignments(align_path)
    src_times, tgt_times, n = alignments_to_timestamps(
        align=alignments, src_segs=src_segs, tgt_segs=tgt_segs, ignore_empty=False
    )
    if n != len(alignments):
        raise ValueError(f"{align_path}: {len(alignments)} alignments gave {n} spans")

    spans = [
        (Segment(start=s0, end=s1, path=src_audio_path),
         Segment(start=t0, end=t1, path=tgt_audio_path))
        for (s0, s1), (t0, t1) in zip(src_times, tgt_times)
    ]
    # phase 1, duration gate (no audio read): rows wider apart than the
    # gate cannot be identical and survive immediately
    suspects = [
        row for row, (s, t) in enumerate(spans)
        if abs(s.duration - t.duration) <= max_frame_diff
    ]
    clock.mark("gate")
    # phase 2: fbanks of all suspect rows of this pair in one batch on
    # the device, sliding-MSE verdicts on the host
    fbanks = batch_segment_fbanks(
        [spans[r][0] for r in suspects] + [spans[r][1] for r in suspects], device, clock
    )
    identical = {
        row
        for pos, row in enumerate(suspects)
        if compute_fbank_dist(fbanks[pos], fbanks[len(suspects) + pos])
        <= fbank_dist_thres
    }
    clock.mark("mse")

    survivors: List[int] = [row for row in range(n) if row not in identical]
    if audio_out_dir and identical:
        audio_out_dir.mkdir(parents=True, exist_ok=True)
        for row in sorted(identical):
            spans[row][0].save((audio_out_dir / f"{row}.src.ogg").as_posix())
            spans[row][1].save((audio_out_dir / f"{row}.tgt.ogg").as_posix())

    if not survivors:
        logger.info(f"{align_path} is completely filtered out.")
    else:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        raw_lines = read_lines(align_path)
        with open(out_path, mode="w") as fp:
            fp.writelines(raw_lines[row] + "\n" for row in survivors)
    return len(identical)


def filter_pair_shard(
    pid: int,
    audio_pairs: List[Tuple[str, str]],
    align_dir: Path,
    seg_dir: Path,
    src_lang: str,
    tgt_lang: str,
    max_frame_diff: int,
    fbank_dist_thres: float,
    out_dir: Path,
    audio_out_dir: Optional[Path] = None,
    device: str = "cuda",
):
    """One worker's share of document pairs (mp_utils entry point)."""
    n_dupes = 0
    for src_audio, tgt_audio in my_tqdm(audio_pairs, desc=f"[Proc {pid}]"):
        pair_stem = f"{Path(src_audio).stem}-{Path(tgt_audio).stem}"

        align_path = align_dir / f"{pair_stem}.txt"
        if not align_path.exists():
            logger.warning(f"{align_path.as_posix()} not exist. Skip.")
            continue
        final_path = out_dir / f"{pair_stem}.txt"
        if final_path.exists():
            continue  # resumed run: already done

        staging = final_path.with_suffix(".tmp")
        delete_if_exist(staging)
        n_dupes += filter_one_pair(
            align_path=align_path,
            src_segs=read_segments(seg_dir / src_lang / f"{Path(src_audio).stem}.txt"),
            tgt_segs=read_segments(seg_dir / tgt_lang / f"{Path(tgt_audio).stem}.txt"),
            src_audio_path=src_audio,
            tgt_audio_path=tgt_audio,
            max_frame_diff=max_frame_diff,
            fbank_dist_thres=fbank_dist_thres,
            out_path=staging,
            audio_out_dir=(audio_out_dir / pair_stem) if audio_out_dir else None,
            device=device,
        )
        # a completely-filtered pair wrote no staging file; the absence of
        # the final file is the downstream signal for "no alignments"
        if staging.exists():
            staging.replace(final_path)

    logger.info(f"Found {n_dupes} duplications!")


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    resolve_device(args.device)  # raises here, not in a worker, without a card

    dst_root = Path(args.out_dir) / f"{args.src_lang}-{args.tgt_lang}"
    dst_root.mkdir(parents=True, exist_ok=True)

    audio_out_dir = None
    if args.save_audio:
        audio_out_dir = dst_root / "wavs"
        audio_out_dir.mkdir(parents=True, exist_ok=True)

    start_multi_processes(
        read_metadata(args.metadata),
        args.n_proc,
        filter_pair_shard,
        align_dir=Path(args.align_dir) / f"{args.src_lang}-{args.tgt_lang}",
        seg_dir=Path(args.seg_dir),
        src_lang=args.src_lang,
        tgt_lang=args.tgt_lang,
        max_frame_diff=int(args.dur_diff * SAMPLE_RATE),
        fbank_dist_thres=args.fbank_dist_thres,
        out_dir=dst_root,
        audio_out_dir=audio_out_dir,
        device=args.device,
    )


if __name__ == "__main__":
    main()
