"""Stage 6.10 — order the mined tsv by margin, best first.

Port of the JAX package's ``postprocess/sort_tsv.py``, host only; its
output is the JAX CLI's, byte for byte once decompressed.

Final pipeline stage: consumers of the mined corpus take a top-score
prefix, so the tsv must be globally ordered by the margin in column one.
The sort is stable — rows with equal margins keep their incoming order —
and the destination must not already exist (the reference refuses to
clobber a finished mining run; svecalign/postprocess/sort_tsv.py).

CLI: ``python -m svecalign_tpu_torch.postprocess.sort_tsv --in_tsv IN --out_tsv OUT``
(both paths may be .gz/.xz; compression is inferred from the suffix).
"""

import argparse
from pathlib import Path
from typing import List, Tuple

import svecalign_tpu_torch.utils.file_utils as file_utils
from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--in_tsv", type=str, required=True,
                        help="mined tsv to sort (score\\tsrc span\\ttgt span)")
    parser.add_argument("--out_tsv", type=str, required=True,
                        help="destination; must not already exist")
    return parser.parse_args(argv)


def load_scored_rows(path) -> List[Tuple[float, str]]:
    """Parse the tsv into (margin, full row) pairs, validating the 3-column
    shape as a side effect of the split."""
    rows = []
    with file_utils.open(path) as fp:
        for raw in fp:
            row = raw.strip()
            margin, _src_span, _tgt_span = row.split("\t")
            rows.append((float(margin), row))
    return rows


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    dst = Path(args.out_tsv)
    if dst.exists():
        raise FileExistsError(f"refusing to overwrite {dst}")
    dst.parent.mkdir(parents=True, exist_ok=True)

    logger.info(f"Sorting {args.in_tsv} by margin (descending)")
    rows = load_scored_rows(args.in_tsv)
    # sort on the margin alone (never the text) so ties keep file order;
    # Python's sort is stable under reverse=True
    rows.sort(key=lambda scored: scored[0], reverse=True)

    with file_utils.open(dst, mode="w") as fp:
        fp.writelines(row + "\n" for _, row in rows)
    logger.info(f"Wrote {len(rows)} rows to {dst}")


if __name__ == "__main__":
    main()
