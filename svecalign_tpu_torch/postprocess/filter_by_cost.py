"""Stage 6.1 -- drop deletions and alignments the DP scored poorly.

Port of the JAX package's ``postprocess/filter_by_cost.py``, host only:
deletions (one empty side) carry no parallel audio, and a high DP cost
means the aligner matched spans it was not confident about (the paper's
threshold is 0.7). The output keeps the ``[src]:[tgt]:cost`` line format,
byte for byte as the JAX CLI writes it, so the rest of the postprocess
chain re-reads it. A pair that loses over half of its alignments is
counted: that usually signals an upstream problem (wrong language
pairing, bad VAD).

CLI: ``python -m svecalign_tpu_torch.postprocess.filter_by_cost METADATA
OUT_DIR --align_dir A --max_cost 0.7 --src_lang S --tgt_lang T``
"""

import argparse
from pathlib import Path

from svecalign_tpu_torch.utils.file_utils import read_alignments_with_score, read_metadata
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="tsv of paired audio paths, one doc pair per line")
    parser.add_argument("out_dir", type=str,
                        help="root of the filtered alignment tree")
    parser.add_argument("--align_dir", type=str, required=True,
                        help="root of the raw alignment tree (stage 5.4 output)")
    parser.add_argument("--max_cost", type=float, required=True,
                        help="drop alignments costlier than this (paper: 0.7)")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    return parser.parse_args(argv)


def do_filter(in_path: str, out_path: str, max_cost: float) -> float:
    """Filter one pair's alignment file by ``max_cost`` and return the
    survival rate.

    Deletions are always dropped. An output that would be empty is not
    written at all (downstream stages treat a missing file as "no
    alignments", as the reference does).
    """
    if not Path(in_path).exists():
        # upstream stages skip invalid pairs without writing a file; a
        # missing input means "no alignments", not a crash
        logger.warning(f"{in_path} does not exist; skipping pair")
        return 1.0

    survivors = []
    total = n_deletion = n_over_cost = 0
    for src_ids, tgt_ids, cost in read_alignments_with_score(in_path):
        total += 1
        if not src_ids or not tgt_ids:
            n_deletion += 1
        elif cost > max_cost:
            n_over_cost += 1
        else:
            survivors.append(f"{src_ids}:{tgt_ids}:{cost}\n")

    if survivors:
        with open(out_path, mode="w") as fp:
            fp.writelines(survivors)
    else:
        logger.warning(f"nothing survived the cost gate; not writing {out_path}")

    logger.debug(
        f"{Path(in_path).name}: kept {len(survivors)}/{total} "
        f"(cost-gated {n_over_cost}, deletions {n_deletion}, bound {max_cost})"
    )
    # an empty input file has nothing to lose: survival is 1.0
    return len(survivors) / total if total else 1.0


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    pair_dir = f"{args.src_lang}-{args.tgt_lang}"
    align_dir = Path(args.align_dir) / pair_dir
    out_dir = Path(args.out_dir) / pair_dir
    out_dir.mkdir(parents=True, exist_ok=True)

    doc_pairs = read_metadata(args.metadata)
    suspicious = []
    for src_audio, tgt_audio in my_tqdm(doc_pairs):
        name = f"{Path(src_audio).stem}-{Path(tgt_audio).stem}"
        survival = do_filter(
            in_path=(align_dir / f"{name}.txt").as_posix(),
            out_path=(out_dir / f"{name}.txt").as_posix(),
            max_cost=args.max_cost,
        )
        if survival < 0.5:
            suspicious.append(name)

    logger.info(
        f"{len(suspicious)} of {len(doc_pairs)} pairs lost over half their "
        "alignments to the cost gate -- worth a manual look"
    )
    logger.debug(suspicious)
    logger.info("Cost filter done.")


if __name__ == "__main__":
    main()
