"""Hour-scale document pairs for the stage-5.4 cells, made from a seed.

Each pair is a stage-5.4 input tree: segment files, concat lines for
overlaps of up to ``max_overlaps`` segments, and stopes ``.embed`` files
(a standard ``.npy`` of fp16 rows, one per concat line) whose rows are
built from a planted monotone alignment (mostly one to one, with merges
and deletions): an overlap's row is the normalised sum of its segments'
content vectors plus noise. The pair sizes come from the traffic file, so
every seed aligns the same sizes; the seed draws the alignments, the
content and the noise (on the device, in a few large calls).
"""

from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

Block = Tuple[List[int], List[int]]


class Pair(NamedTuple):
    stem: str
    sizes: Tuple[int, int]
    planted: List[Block]


KINDS = [(1, 1), (2, 1), (1, 2), (1, 0), (0, 1)]
KIND_P = [0.875, 0.1, 0.015, 0.005, 0.005]


def plant_alignment(rng: np.random.Generator, n_src: int, n_tgt: int) -> List[Block]:
    """A monotone alignment covering exactly n_src x n_tgt segments."""
    blocks, i, j = [], 0, 0
    while i < n_src or j < n_tgt:
        dx, dy = KINDS[rng.choice(len(KINDS), p=KIND_P)]
        if i + dx > n_src or j + dy > n_tgt:
            dx, dy = (1, 0) if i < n_src else (0, 1)
        blocks.append((list(range(i, i + dx)), list(range(j, j + dy))))
        i, j = i + dx, j + dy
    return blocks


def _content(blocks, sizes, dim, gen, dev):
    """Per-segment content vectors of both sides: a block's meaning is a
    sum of parts; the side with more segments says one part per segment,
    the other says them all at once."""
    n_parts = sum(max(len(xs), len(ys)) for xs, ys in blocks)
    parts = torch.randn((n_parts, dim), generator=gen, device=dev)
    content = [torch.zeros((sizes[0], dim), device=dev), torch.zeros((sizes[1], dim), device=dev)]
    k = 0
    for xs, ys in blocks:
        n = max(len(xs), len(ys))
        for side, ids in ((0, xs), (1, ys)):
            if len(ids) > 1:
                content[side][ids] = parts[k:k + n]
            elif ids:
                content[side][ids[0]] = parts[k:k + n].sum(0)
        k += n
    return content


def overlap_rows(content: torch.Tensor, max_overlaps: int, noise: float, gen) -> torch.Tensor:
    """Rows in concat-line order (i, then j = i .. i + max_overlaps - 1):
    the normalised sum of segments i..j plus noise / sqrt(dim)."""
    n, dim = content.shape
    csum = torch.cat([torch.zeros((1, dim), device=content.device), content.cumsum(0)])
    i = torch.arange(n, device=content.device)[:, None]
    j = i + torch.arange(max_overlaps, device=content.device)[None, :]
    keep = (j < n).reshape(-1)
    i, j = i.expand_as(j).reshape(-1)[keep], j.reshape(-1)[keep]
    v = csum[j + 1] - csum[i]
    v = v / v.norm(dim=1, keepdim=True)
    return v + noise / dim ** 0.5 * torch.randn(v.shape, generator=gen, device=content.device)


def write_pairs(root: Path, traffic: dict, seed: int, device) -> List[Pair]:
    """Write every pair of the traffic under ``root`` (``segments/``,
    ``cat_segs/``, ``embeds/`` by language, ``metadata.tsv``)."""
    root = Path(root)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    src, tgt = traffic["langs"]
    o, dim = traffic["max_overlaps"], traffic["dim"]
    pairs, meta = [], []
    for k, (n_src, n_tgt) in enumerate(traffic["sizes"]):
        rng = np.random.default_rng([int(seed), k])
        blocks = plant_alignment(rng, n_src, n_tgt)
        content = _content(blocks, (n_src, n_tgt), dim, gen, dev)
        stem = f"pair{k:02d}"
        audio = []
        for side, (lang, n) in enumerate(((src, n_src), (tgt, n_tgt))):
            name = f"{stem}_{lang}"
            audio.append(f"raw_audios/{lang}/{name}.wav")
            durs = rng.integers(16000, 200000, n)
            gaps = rng.integers(800, 16000, n)
            starts = np.cumsum(gaps + np.concatenate([[0], durs[:-1]]))
            ends = starts + durs
            cat = [f"{starts[i]} {ends[j]}\n" for i in range(n) for j in range(i, min(n, i + o))]
            for kind, lines in (("segments", [f"{s} {e}\n" for s, e in zip(starts, ends)]),
                                ("cat_segs", cat)):
                d = root / kind / lang
                d.mkdir(parents=True, exist_ok=True)
                (d / f"{name}.txt").write_text("".join(lines), encoding="utf-8")
            rows = overlap_rows(content[side], o, traffic["noise"], gen)
            d = root / "embeds" / lang
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"{name}.embed.npy", rows.half().cpu().numpy())
            (d / f"{name}.embed.npy").rename(d / f"{name}.embed")
        meta.append("\t".join(audio) + "\n")
        pairs.append(Pair(stem, (n_src, n_tgt), blocks))
    (root / "metadata.tsv").write_text("".join(meta), encoding="utf-8")
    return pairs
