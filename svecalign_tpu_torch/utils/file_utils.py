"""The ported stages' slice of the L0 file contract.

Copied from the JAX package's ``utils/file_utils.py`` (what the aligner,
the embed stages and the postprocess stages read and write). Formats
(bit-compatible with the reference, reference
svecalign/utils/file_utils.py):

- metadata.tsv    : ``src_audio \t tgt_audio`` per line
- segment files   : ``start end`` integer sample offsets per line
- alignment files : ``[src ids]:[tgt ids]`` or ``[src ids]:[tgt ids]:cost``
                    (Python-list repr, ast.literal_eval parseable)
- transparent .gz / .xz open
"""

import builtins
import gzip
import lzma
from ast import literal_eval
from pathlib import Path
from typing import IO, List, Optional, Tuple, Union

from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


def read_lines(path: PathLike) -> List[str]:
    with open(path) as fp:
        return [line.strip() for line in fp]


def read_metadata(path: PathLike) -> List[Tuple[str, str]]:
    """Parse a metadata tsv of ``src_audio \t tgt_audio`` document pairs."""
    return [tuple(line.split("\t")) for line in read_lines(path)]


def delete_if_exist(path: PathLike, verbose: bool = False) -> None:
    path = Path(path)
    if path.exists():
        if verbose:
            logger.warning(f"{path} exists. Remove.")
        path.unlink()


def open(filename: PathLike, mode: str = "rt", encoding: Optional[str] = "utf-8") -> IO:
    """Open a file, transparently handling .gz and .xz compression."""
    if len(mode) == 1:
        mode += "t"
    if "b" in mode:
        encoding = None
    filename = Path(filename)
    if filename.suffix == ".gz":
        return gzip.open(filename, mode=mode, encoding=encoding)
    if filename.suffix == ".xz":
        return lzma.open(filename, mode=mode, encoding=encoding)
    return builtins.open(filename, mode=mode, encoding=encoding)


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


def write_segments(segments: List[Tuple[int, int]], path: PathLike) -> None:
    with open(path, mode="w") as fp:
        for start, end in segments:
            fp.write(f"{start} {end}\n")


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


def read_alignments_with_score(fin: PathLike) -> List[Tuple[List[int], List[int], float]]:
    """Read ``[src ids]:[tgt ids]:score`` lines, keeping the score."""
    alignments = []
    with open(fin) as infile:
        for line in infile:
            fields = [x.strip() for x in line.split(":") if len(x.strip())]
            if len(fields) != 3:
                raise ValueError(f'Got line "{line.strip()}", which does not have three '
                                 '":" separated fields')
            try:
                src = literal_eval(fields[0])
                tgt = literal_eval(fields[1])
                score = float(fields[2])
            except Exception:
                raise Exception(f'Failed to parse line "{line.strip()}"')
            alignments.append((src, tgt, score))
    return alignments


def write_alignment(alignments: List[Tuple[List[int], List[int]]], path: PathLike) -> None:
    """Write alignments as ``[src ids]:[tgt ids]`` lines (list repr)."""
    with open(path, mode="w") as fp:
        for src_segs, tgt_segs in alignments:
            fp.write(f"{src_segs}:{tgt_segs}\n")


def alignments_to_timestamps(
    align: Union[PathLike, list],
    src_segs: List[Tuple[int, int]],
    tgt_segs: List[Tuple[int, int]],
    ignore_empty: bool = True,
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], int]:
    """Resolve alignment index spans into (first.start, last.end) frame pairs.

    Deletions (an empty side) are skipped when ``ignore_empty`` else raise.
    """
    if isinstance(align, (str, Path)):
        alignments = read_alignments(align)
    elif isinstance(align, list):
        alignments = align
    else:
        raise TypeError(f"{align} type is unexpected. {type(align)}")

    src_aligns = []
    tgt_aligns = []
    for src, tgt in alignments:
        if not src or not tgt:
            if ignore_empty:
                continue
            raise Exception("Got empty alignments!")
        src_aligns.append((src_segs[src[0]][0], src_segs[src[-1]][1]))
        tgt_aligns.append((tgt_segs[tgt[0]][0], tgt_segs[tgt[-1]][1]))
    return src_aligns, tgt_aligns, len(src_aligns)
