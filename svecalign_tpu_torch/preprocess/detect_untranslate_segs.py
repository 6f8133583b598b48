"""Stage 4.2 — detect identical (untranslated) segments between the sides.

Port of the JAX package's ``preprocess/detect_untranslate_segs.py``; its
files are the JAX CLI's, byte for byte. For each source segment, find
the nearest target segment by midpoint; flag the pair identical when the
duration difference and the sliding-window fbank MSE are both under
threshold. Emits index pairs, one per line, into
``OUT/{src}-{tgt}/{srcstem}-{tgtstem}.{src,tgt}.txt``; both files are
always written, empty when nothing is flagged, through a tmp file and a
rename, and a pair whose two files exist is skipped. (Reference
svecalign/preprocess/detect_untranslate_segs.py.)

The fbanks of a pair's candidate segments are one batch on the card; the
MSE verdicts run on the host.

CLI: ``python -m svecalign_tpu_torch.preprocess.detect_untranslate_segs
METADATA OUT_DIR --seg_dir D --src_lang S --tgt_lang T [--dur_diff 0.1]
[--fbank_dist_thres 5.0] [--n_proc N] [--device {cuda,cpu}]``
"""

import argparse
from pathlib import Path
from typing import List, Tuple

from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE, find_untranslated_segs
from svecalign_tpu_torch.utils.file_utils import read_metadata, read_segments
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.mp_utils import start_multi_processes
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str, help="the output dir.")
    parser.add_argument("--seg_dir", type=str, required=True,
                        help="the dir for all segments.")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--dur_diff", type=float, default=0.1,
                        help="the max time difference between two segments. in second")
    parser.add_argument("--fbank_dist_thres", type=float, default=5.0,
                        help="the MSE threshold between two fbank.")
    parser.add_argument("--n_proc", type=int, default=1, help="Num of processes.")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="where the fbanks run (the MSE runs on the host)")
    return parser.parse_args(argv)


def detect(
    pid: int,
    pairs: List[Tuple[str, str]],
    src_seg_dir: Path,
    tgt_seg_dir: Path,
    max_frame_diff: int,
    fbank_dist_thres: float,
    out_dir: Path,
    device: str = "cuda",
):
    for src_audio_path, tgt_audio_path in my_tqdm(pairs, desc=f"[Proc {pid}]"):
        src_name = Path(src_audio_path).stem
        tgt_name = Path(tgt_audio_path).stem

        src_out_path = out_dir / f"{src_name}-{tgt_name}.src.txt"
        tgt_out_path = out_dir / f"{src_name}-{tgt_name}.tgt.txt"
        if src_out_path.exists() and tgt_out_path.exists():
            continue  # skip processed inputs

        duplicates = find_untranslated_segs(
            read_segments(src_seg_dir / f"{src_name}.txt"),
            read_segments(tgt_seg_dir / f"{tgt_name}.txt"),
            src_audio_path, tgt_audio_path, max_frame_diff, fbank_dist_thres, device=device,
        )

        # always write (possibly empty) outputs, atomically
        tmp_src = out_dir / f"{src_name}-{tgt_name}.src.txt.tmp"
        tmp_tgt = out_dir / f"{src_name}-{tgt_name}.tgt.txt.tmp"
        with open(tmp_src, mode="w") as src_fp, open(tmp_tgt, mode="w") as tgt_fp:
            for _src_dup, _tgt_dup in duplicates:
                src_fp.write(f"{_src_dup}\n")
                tgt_fp.write(f"{_tgt_dup}\n")
        tmp_src.replace(src_out_path)
        tmp_tgt.replace(tgt_out_path)


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    resolve_device(args.device)  # raises here, not in a worker, without a card

    out_dir = Path(args.out_dir) / f"{args.src_lang}-{args.tgt_lang}"
    out_dir.mkdir(parents=True, exist_ok=True)

    start_multi_processes(
        read_metadata(args.metadata),
        args.n_proc,
        detect,
        src_seg_dir=Path(args.seg_dir) / args.src_lang,
        tgt_seg_dir=Path(args.seg_dir) / args.tgt_lang,
        max_frame_diff=int(args.dur_diff * SAMPLE_RATE),
        fbank_dist_thres=args.fbank_dist_thres,
        out_dir=out_dir,
        device=args.device,
    )
    logger.info("Finished!")


if __name__ == "__main__":
    main()
