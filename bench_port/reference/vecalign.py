"""Plain coarse-to-fine Vecalign for one document pair, as stage 5.4 runs it
in buckets with shared sampling.

Vecalign (Thompson and Koehn, EMNLP 2019) over speech segments: overlap
vectors of up to ``max_overlaps`` consecutive segments, a pyramid that
halves both documents until a dense DP of at most ``max_size_full_dp``^2
cells fits, a 1-1 dense DP at the top, then a banded DP along each
upsampled path, width ``width_over2`` each side, with every alignment type
of up to ``alignment_max_size`` segments at the bottom. A span of n and m
segments costs 2 n m (1 - cos) / (1e-6 + norm_x + norm_y), where the norms
are 1 - the mean similarity against sampled rows of the other side. The
deletion penalty is the ``del_percentile_frac`` point of the sampled cost
distribution (a 1000-bin histogram read at 27 interior knots).

What the bucketed stage fixes, and this follows: the pyramid's depth comes
from the bucket's padded sizes (pairs sorted by size, ``pair_batch`` a
bucket, sizes rounded up to the shape grid: eight steps an octave, at
least 64); the sampling's uniforms come from one generator per depth and
role, seeded from the stage's ``--seed``, shared by the bucket's pairs,
each scaling them to its own sizes. Products and DP sums in float32; ties
go to the first candidate in type order (the given types, then (0, 1),
then (1, 0)); the dense DP prefers diagonal, then left, then up.

This module imports nothing of the program.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Alignment = Tuple[List[int], List[int]]
NUM_BINS = 1000
INF = np.float32(np.inf)
ROLE_NORM1, ROLE_NORM0, ROLE_KNOB = 0, 1, 2


# --- inputs ---------------------------------------------------------------


def overlap_ids(seg_lines: Sequence[str], cat_lines: Sequence[str], max_overlaps: int):
    """(max_overlaps, n) embedding row of the overlap of segments i..i+j at
    [j, i + j], -1 where the concat file has no such line."""
    row_of: Dict[str, int] = {}
    for r, line in enumerate(cat_lines):
        row_of.setdefault(line.strip(), r)
    segs = [line.split() for line in seg_lines]
    n = len(segs)
    out = np.full((max_overlaps, n), -1, dtype=np.int64)
    for i in range(n):
        for j in range(max_overlaps):
            if i + j >= n:
                break
            out[j, i + j] = row_of.get(f"{segs[i][0]} {segs[i + j][1]}", -1)
    return out


def norm1(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.sqrt((v * v).sum(-1, keepdim=True)) + 1e-5)


def overlap_tensor(rows: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    rows = rows.float()
    rows = torch.where(torch.isnan(rows).any(-1, keepdim=True), 0.0, rows)
    idx = torch.from_numpy(ids).to(rows.device)
    v = torch.where((idx >= 0)[..., None], rows[idx.clamp(min=0)], 0.0)
    return norm1(v)


def downsample(v: torch.Tensor) -> torch.Tensor:
    o, n, d = v.shape
    half = v[:, : n - n % 2].reshape(o, n // 2, 2, d).sum(2)
    return norm1(half - half.mean(1, keepdim=True))


# --- the bucket -----------------------------------------------------------


def grid_dim(n: int, floor: int = 64) -> int:
    n = max(int(n), floor)
    p = 1 << (n - 1).bit_length()
    step = p // 16
    return -(-n // step) * step


def buckets(sizes: Sequence[Tuple[int, int]], pair_batch: int) -> List[List[int]]:
    order = sorted(range(len(sizes)), key=lambda k: sizes[k][0] + sizes[k][1])
    return [order[s:s + pair_batch] for s in range(0, len(order), pair_batch)]


def depth_of(n_pad: int, m_pad: int, max_size_full_dp: int) -> int:
    depth = 0
    while n_pad * m_pad > max_size_full_dp ** 2:
        depth += 1
        n_pad //= 2
        m_pad //= 2
    return depth


def draws(device, seed: int, depth: int, role: int, shape) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + depth * 16 + role) % (2**63))
    return torch.rand(shape, generator=gen, device=device)


def uniform_index(u: torch.Tensor, hi: int) -> torch.Tensor:
    hi = max(hi, 1)
    return torch.minimum((u * hi).long(), torch.tensor(hi - 1, device=u.device))


# --- costs and penalties --------------------------------------------------


def operands(v: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operands: float32, or rounded to bfloat16 for the control
    (one step below the float32 the stage states), summed in float32."""
    if precision == "fp32":
        return v
    if precision == "bf16":
        return v.bfloat16().float()
    raise ValueError(f"precision must be fp32 or bf16, got {precision!r}")


def margins(v: torch.Tensor, other: torch.Tensor, n_other: int, u: torch.Tensor):
    """1 - mean similarity of every overlap vector of ``v`` against the
    rows of ``other`` that the uniforms ``u`` (planes, samples) pick."""
    idx = uniform_index(u, n_other)
    sample = torch.stack([other[p, idx[p]] for p in range(other.shape[0])]).reshape(
        -1, other.shape[-1])
    return 1.0 - torch.einsum("ond,sd->ons", v, sample).mean(-1)


def del_penalty(v0, v1, n0, n1, h0, h1, u, S: int, frac: float) -> torch.Tensor:
    dev = v0.device
    if h0 * h1 < S:
        ar = torch.arange(h0 * h1, device=dev)
        xs, ys = ar // h1, ar % h1
    else:
        xs, ys = uniform_index(u[0], h0), uniform_index(u[1], h1)
    scores = 2.0 * (1.0 - (v0[0, xs] * v1[0, ys]).sum(-1)) / (n0[0, xs] + n1[0, ys])
    smax = scores.max().clamp(min=0.0)
    scale = NUM_BINS / smax if smax > 0 else torch.tensor(0.0, device=dev)
    bins = torch.floor(scores * scale).long().clamp(0, NUM_BINS - 1)
    counts = torch.bincount(bins, minlength=NUM_BINS)
    res_max = smax if smax > 0 else torch.tensor(1e-4, device=dev)
    cdf = counts.cumsum(0) / counts.sum().clamp(min=1).float()
    knots = torch.linspace(0.0, 1.0, 29, device=dev)
    idx = torch.searchsorted(cdf, knots[1:-1].contiguous())
    y = torch.cat([torch.zeros(1, device=dev), idx.float() / NUM_BINS * res_max, res_max[None]])
    x = torch.tensor(frac, dtype=torch.float32, device=dev)
    i = int(torch.searchsorted(knots, x, right=True).clamp(1, len(knots) - 1))
    return y[i - 1] + (x - knots[i - 1]) / (knots[i] - knots[i - 1]) * (y[i] - y[i - 1])


def dense_costs(v0, v1, n0, n1) -> np.ndarray:
    sim = v0 @ v1.T
    return (2.0 * (1.0 - sim) / (1e-6 + n0[:, None] + n1[None, :])).cpu().numpy()


def banded_costs(v0, v1, n0, n1, boff: np.ndarray, types, width_over2: int) -> np.ndarray:
    """(types, A, 2 width_over2) costs along the band, +inf off the document."""
    A, B = len(boff), 2 * width_over2
    yy = torch.from_numpy(boff.astype(np.int64)).to(v0.device)[:, None] + torch.arange(
        B, device=v0.device)
    xx = torch.arange(A, device=v0.device)[:, None] - yy
    s0, s1 = v0.shape[1], v1.shape[1]
    ok = (xx >= 0) & (xx < s0) & (yy >= 0) & (yy < s1)
    xc, yc = xx.clamp(0, s0 - 1), yy.clamp(0, s1 - 1)
    out = []
    for xo, yo in types:
        sim = (v0[xo - 1, xc] * v1[yo - 1, yc]).sum(-1)
        c = 2.0 * xo * yo * ((1.0 - sim) / (1e-6 + n0[xo - 1, xc] + n1[yo - 1, yc]))
        out.append(torch.where(ok, c, torch.inf))
    return torch.stack(out).cpu().numpy()


# --- the DPs --------------------------------------------------------------


def dense_dp(costs: np.ndarray, pen: np.float32) -> np.ndarray:
    """Move matrix (0 diag, 1 left, 2 up) of the 1-1 DP, node layout."""
    n, m = costs.shape
    csum = np.full((n + 1, m + 1), INF, np.float32)
    bp = np.zeros((n + 1, m + 1), np.int8)
    csum[0, :] = np.arange(m + 1, dtype=np.float32) * pen
    csum[:, 0] = np.arange(n + 1, dtype=np.float32) * pen
    bp[0, 1:], bp[1:, 0], bp[0, 0] = 1, 2, 4
    for r in range(1, n + 1):
        for c in range(1, m + 1):
            val, b = csum[r - 1, c - 1] + costs[r - 1, c - 1], 0
            left = csum[r, c - 1] + pen
            if left < val:
                val, b = left, 1
            up = csum[r - 1, c] + pen
            if up < val:
                val, b = up, 2
            csum[r, c], bp[r, c] = val, b
    return bp


def dense_traceback(bp: np.ndarray) -> List[Alignment]:
    xx, yy = bp.shape[0] - 1, bp.shape[1] - 1
    out = []
    while xx or yy:
        v = bp[xx, yy]
        if v == 0:
            out.append(([xx - 1], [yy - 1]))
            xx, yy = xx - 1, yy - 1
        elif v == 1:
            out.append(([], [yy - 1]))
            yy -= 1
        else:
            out.append(([xx - 1], []))
            xx -= 1
    return out[::-1]


def banded_dp(costs: np.ndarray, boff: np.ndarray, types, pen: np.float32, x_in: int, y_in: int):
    """csum, xp, yp over node rows a = x + y and band lanes b = y - boff_out[a];
    each row takes every move type at once (rows of ``cand``), the first
    type in order winning a tie."""
    T, A, B = costs.shape
    xo = np.array([t[0] for t in types] + [0, 1], np.int64)
    yo = np.array([t[1] for t in types] + [1, 0], np.int64)
    step = xo + yo
    boff_out = np.concatenate([[boff[0], boff[0]], boff + 1]).astype(np.int64)
    a2 = A + 2
    csum = np.full((a2, B), INF, np.float32)
    xp = np.full((a2, B), -42, np.int32)
    yp = np.full((a2, B), -42, np.int32)
    lanes = np.arange(B)
    pens = np.full((2, B), pen, np.float32)
    for a in range(a2):
        yy = boff_out[a] + lanes
        xx = a - yy
        pa = a - step
        pb = yy[None, :] - yo[:, None] - boff_out[np.maximum(pa, 0)][:, None]
        px, py = xx[None, :] - xo[:, None], yy[None, :] - yo[:, None]
        ok = ((pa >= 0)[:, None] & (xx >= 1) & (xx <= x_in) & (yy >= 1) & (yy <= y_in)
              & (pb >= 0) & (pb < B) & (px >= 0) & (px <= x_in) & (py >= 0) & (py <= y_in))
        cost = np.concatenate([costs[:, a - 2] if a >= 2 else np.full((T, B), INF, np.float32),
                               pens])
        prev = csum[np.maximum(pa, 0)[:, None], np.minimum(np.maximum(pb, 0), B - 1)]
        cand = np.where(ok, prev + cost, INF)
        best_t = np.argmin(cand, axis=0)
        best = cand[best_t, lanes]
        reach = best < INF
        row_c = np.where(reach, best, INF)
        row_x = np.where(reach, xo[best_t], -42)
        row_y = np.where(reach, yo[best_t], -42)
        edge_y = (xx == 0) & (yy >= 0) & (yy <= y_in)
        edge_x = ~edge_y & (yy == 0) & (xx >= 0) & (xx <= x_in)
        row_c = np.where(edge_y, pen * yy.astype(np.float32), row_c)
        row_x, row_y = np.where(edge_y, 0, row_x), np.where(edge_y, 1, row_y)
        row_c = np.where(edge_x, pen * xx.astype(np.float32), row_c)
        row_x, row_y = np.where(edge_x, 1, row_x), np.where(edge_x, 0, row_y)
        csum[a], xp[a], yp[a] = row_c, row_x, row_y
    return csum, xp, yp, boff_out


def banded_traceback(csum, xp, yp, boff_out, x_in: int, y_in: int):
    xx, yy = x_in, y_in
    aligns, cum = [], []
    while True:
        a = xx + yy
        b = yy - boff_out[a]
        cum.append(np.float64(csum[a, b]))
        if xx == 0 and yy == 0:
            break
        dx, dy = int(xp[a, b]), int(yp[a, b])
        if dx < 0 or dy < 0:
            raise ValueError("the banded DP left the origin unreachable")
        aligns.append((list(range(xx - dx, xx)), list(range(yy - dy, yy))))
        xx, yy = xx - dx, yy - dy
    aligns.reverse()
    cum.reverse()
    scores = np.clip(np.array(cum[1:]) - np.array(cum[:-1]), 0, None)
    for k, (x, y) in enumerate(aligns):
        scores[k] = 0.0 if not x or not y else scores[k] / len(x) / len(y)
    return aligns, scores


# --- the pyramid's bookkeeping --------------------------------------------


def append_slant(path, xwidth: int, ywidth: int) -> None:
    nn = xwidth + ywidth
    xstart, ystart = path[-1]
    for ii in range(1, nn + 1):
        x = xstart + round(xwidth * ii / nn)
        y = ystart + round(ywidth * ii / nn)
        lastx, lasty = path[-1]
        delta = x + y - lastx - lasty
        if delta == 1:
            path.append((x, y))
        elif delta == 2:
            path.append((x - 1, y))
        elif delta == 0:
            path.append((x + 1, y))


def search_path(algn: List[Alignment]):
    path, xdel, ydel = [(0, 0)], 0, 0
    for x, y in algn:
        if x and y:
            append_slant(path, xdel, ydel)
            xdel = ydel = 0
            append_slant(path, len(x), len(y))
        elif x:
            xdel += len(x)
        else:
            ydel += len(y)
    append_slant(path, xdel, ydel)
    return path


def upsample(algn: List[Alignment]) -> List[Alignment]:
    def up(xx):
        return list(range(min(xx) * 2, (max(xx) + 1) * 2))

    out = []
    for xx, yy in algn:
        if not xx:
            out += [([], [y]) for y in up(yy)]
        elif not yy:
            out += [([x], []) for x in up(xx)]
        else:
            out.append((up(xx), up(yy)))
    return out


def extend(algn: List[Alignment], size0: int, size1: int) -> None:
    xmax = max((v for x, _ in algn for v in x), default=0)
    ymax = max((v for _, y in algn for v in y), default=0)
    extra_x = list(range(xmax + 1, size0 + 1))
    extra_y = list(range(ymax + 1, size1 + 1))
    if not extra_x:
        algn += [([], [y]) for y in extra_y]
    elif not extra_y:
        algn += [([x], []) for x in extra_x]
    else:
        algn.append((extra_x, extra_y))


# --- one pair -------------------------------------------------------------


def align_pair(rows0, ids0, rows1, ids1, depth_max: int, opts: dict, device,
               precision: str = "fp32"):
    """Alignments and scores of one pair, as its bucket runs it; every
    product's operands in ``precision`` (``operands``)."""
    types = [(x, y) for x in range(1, opts["alignment_max_size"])
             for y in range(1, opts["alignment_max_size"]) if x + y <= opts["alignment_max_size"]]
    w2 = math.ceil((opts["alignment_max_size"] - 1) / 2.0) + opts["search_buffer_size"]
    seed, S, frac = opts["seed"], opts["costs_sample_size"], opts["del_percentile_frac"]
    o = ids0.shape[0]
    samps = math.ceil(opts["num_samps_for_norm"] / o)
    v = {0: (overlap_tensor(rows0.to(device), ids0), overlap_tensor(rows1.to(device), ids1))}
    for d in range(1, depth_max + 1):
        v[d] = (downsample(v[d - 1][0]), downsample(v[d - 1][1]))
    v = {d: (operands(a, precision), operands(b, precision)) for d, (a, b) in v.items()}
    level = {}
    for d in range(depth_max + 1):
        v0, v1 = v[d]
        h0, h1 = v0.shape[1], v1.shape[1]
        n0 = margins(v0, v1, h1, draws(device, seed, d, ROLE_NORM1, (o, samps)))
        n1 = margins(v1, v0, h0, draws(device, seed, d, ROLE_NORM0, (o, samps)))
        level[d] = (v0, v1, n0, n1)
    pens = {}
    for d in range(depth_max + 1):
        v0, v1, n0, n1 = level[d]
        u = draws(device, seed, d, ROLE_KNOB, (2, S))
        pens[d] = np.float32(del_penalty(v0, v1, n0, n1, v0.shape[1], v1.shape[1], u, S,
                                         frac).item())
    v0, v1, n0, n1 = level[depth_max]
    aligns = dense_traceback(dense_dp(dense_costs(v0[0], v1[0], n0[0], n1[0]), pens[depth_max]))
    scores = None
    for d in ([0] if depth_max == 0 else range(depth_max - 1, -1, -1)):
        v0, v1, n0, n1 = level[d]
        s0, s1 = v0.shape[1], v1.shape[1]
        if depth_max > 0:
            aligns = upsample(aligns)
            extend(aligns, s0, s1)
        path = np.asarray(search_path(aligns), dtype=np.int64)
        boff = (path[:, 1] - w2).astype(np.int64)
        lvl_types = types if d == 0 else [(1, 1)]
        costs = banded_costs(v0, v1, n0, n1, boff, lvl_types, w2)
        csum, xp, yp, boff_out = banded_dp(costs, boff, lvl_types, pens[d], s0, s1)
        aligns, scores = banded_traceback(csum, xp, yp, boff_out, s0, s1)
    return aligns, scores


def format_lines(aligns: List[Alignment], scores) -> List[str]:
    """The stage's ``[x]:[y]:cost`` lines."""
    return [f"{x}:{y}:%.6f" % s for (x, y), s in zip(aligns, scores)]
