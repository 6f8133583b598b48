"""The ported stages' slice of the L0 file contract.

Copied from the JAX package's ``utils/file_utils.py`` (the readers the
aligner and the embed stage need). Formats (bit-compatible with the
reference, reference svecalign/utils/file_utils.py):

- metadata.tsv    : ``src_audio \t tgt_audio`` per line
- segment files   : ``start end`` integer sample offsets per line
- alignment files : ``[src ids]:[tgt ids]`` or ``[src ids]:[tgt ids]:cost``
                    (Python-list repr, ast.literal_eval parseable)
"""

from ast import literal_eval
from pathlib import Path
from typing import List, Tuple, Union

from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


def read_lines(path: PathLike) -> List[str]:
    with open(path) as fp:
        return [line.strip() for line in fp]


def read_metadata(path: PathLike) -> List[Tuple[str, str]]:
    """Parse a metadata tsv of ``src_audio \t tgt_audio`` document pairs."""
    return [tuple(line.split("\t")) for line in read_lines(path)]


def read_segments(path: PathLike) -> List[Tuple[int, int]]:
    """Read a segment file: one ``start end`` integer-frame pair per line."""
    res = []
    with open(path) as fp:
        for line in fp:
            parts = line.strip().split(" ")
            if len(parts) != 2:
                raise ValueError(f"{path}: want 'start end', got {line.strip()!r}")
            res.append((int(parts[0]), int(parts[1])))
    return res


def check_exist(path: PathLike) -> bool:
    path = Path(path)
    if not path.exists():
        logger.warning(f"{path} does not exist.")
        return False
    return True


def read_alignments(fin: PathLike) -> List[Tuple[List[int], List[int]]]:
    """Read ``[src ids]:[tgt ids](:score)`` lines; scores are dropped."""
    alignments = []
    with open(fin, encoding="utf-8") as infile:
        for line in infile:
            fields = [x.strip() for x in line.split(":") if len(x.strip())]
            if len(fields) < 2:
                raise Exception(
                    f'Got line "{line.strip()}", which does not have at least '
                    f'two ":" separated fields'
                )
            try:
                src = literal_eval(fields[0])
                tgt = literal_eval(fields[1])
            except Exception:
                raise Exception(f'Failed to parse line "{line.strip()}"')
            alignments.append((src, tgt))
    return alignments
