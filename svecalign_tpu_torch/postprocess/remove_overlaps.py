"""Stage 6.9 — remove redundant overlapping alignments from the mined tsv.

Port of the JAX package's ``postprocess/remove_overlaps.py``, host only;
its output is the JAX CLI's, byte for byte once decompressed.

Native reimplementation of the stopes ``PostProcessAudioModule`` boundary
(reference svecalign/postprocess/remove_overlaps.py:6,40-62 wraps it as a
black box). Semantics:

1. drop lines with score below ``--mining_threshold``;
2. drop lines whose SOURCE span is shorter than ``--min_audio_length`` ms
   (verified against the committed example: the target side is not
   length-filtered there);
3. greedy dedup in score order (best first): drop a line when BOTH its
   source and target spans overlap an already-kept line of the same audio
   with intersection-over-union > ``--max_overlap``;
4. output sorted by source span start (stable), matching the committed
   example's ordering; a separate sort stage re-sorts by score.

Parity note: stopes is an external black box here; on the committed example
this reimplementation keeps 298 lines vs stopes' 300, agreeing on 92% of
lines. The divergent cases are equal-cost tie-breaks of near-duplicate
chains whose resolution in stopes is provably not a function of the two
lines' spans and scores alone (structurally identical cases resolve both
ways in its output), so exact emulation is not possible from behavior; this
version is deterministic and documented instead.

CLI: ``python -m svecalign_tpu_torch.postprocess.remove_overlaps --output_dir D
--output_filename F --mining_result_path P --min_audio_length MS
--mining_threshold T [--max_overlap 0.2]``
"""

import argparse
from collections import defaultdict
from pathlib import Path
from typing import List, Tuple

import svecalign_tpu_torch.utils.file_utils as file_utils
from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)

Span = Tuple[str, int, int]  # (audio path, start frame, end frame)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=Path, required=True)
    parser.add_argument("--output_filename", type=str, required=True)
    parser.add_argument("--mining_result_path", type=Path, required=True,
                        help="The input alignment tsv file.")
    parser.add_argument("--min_audio_length", type=int, required=True,
                        help="Source spans shorter than this will be dropped. In milliseconds.")
    parser.add_argument("--mining_threshold", type=float, required=True,
                        help="Alignments whose scores are lower than this will be dropped.")
    parser.add_argument("--max_overlap", type=float, default=0.2,
                        help="The maximum admissible overlap ratio (IoU).")
    return parser.parse_args(argv)


def _parse_side(field: str) -> Span:
    path, start, end, _factor = field.rsplit(" ", 3)
    return path, int(start), int(end)


def _iou(a: Span, b: Span) -> float:
    if a[0] != b[0]:
        return 0.0
    inter = max(0, min(a[2], b[2]) - max(a[1], b[1]))
    union = max(a[2], b[2]) - min(a[1], b[1])
    return inter / union if union else 0.0


def remove_overlaps(
    lines: List[str],
    min_audio_length_ms: int,
    mining_threshold: float,
    max_overlap: float,
    ms_per_frame: float = 1 / 16.0,
) -> List[str]:
    """Filter + dedup mined tsv lines (already sorted by score descending)."""
    candidates = []
    for line in lines:
        score_s, src_f, tgt_f = line.split("\t")
        if float(score_s) < mining_threshold:
            continue
        src = _parse_side(src_f)
        if (src[2] - src[1]) * ms_per_frame < min_audio_length_ms:
            continue
        candidates.append((float(score_s), src, _parse_side(tgt_f), line))

    # _iou is zero across different audio files, so a candidate can only be
    # redundant against kept lines sharing its SOURCE path — bucketing the
    # greedy scan by that path keeps the semantics bit-identical while
    # cutting the quadratic term by the corpus document count (measured
    # 82.2 s -> 8.6 s on a 42k-line / 128-document mined tsv)
    kept = []
    kept_by_src = defaultdict(list)
    for score, src, tgt, line in candidates:
        redundant = any(
            _iou(src, k_src) > max_overlap and _iou(tgt, k_tgt) > max_overlap
            for k_src, k_tgt in kept_by_src[src[0]]
        )
        if not redundant:
            kept.append((score, src, tgt, line))
            kept_by_src[src[0]].append((src, tgt))

    kept.sort(key=lambda item: (item[1][0], item[1][1]))
    logger.info(f"Kept {len(kept)}/{len(lines)} alignments.")
    return [line for _, _, _, line in kept]


def run(
    output_dir: Path,
    output_filename: str,
    mining_result_path: Path,
    min_audio_length: int,
    mining_threshold: float,
    max_overlap: float = 0.2,
) -> None:
    out_path = output_dir / output_filename
    if out_path.exists():
        raise FileExistsError(f"The output path {out_path} already exists!")
    output_dir.mkdir(parents=True, exist_ok=True)

    with file_utils.open(mining_result_path) as fp:
        lines = [line.rstrip("\n") for line in fp]

    kept = remove_overlaps(lines, min_audio_length, mining_threshold, max_overlap)

    with file_utils.open(out_path, mode="w") as fp:
        for line in kept:
            fp.write(line + "\n")
    logger.info(f"Output to {out_path}")


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    run(**vars(args))


if __name__ == "__main__":
    main()
