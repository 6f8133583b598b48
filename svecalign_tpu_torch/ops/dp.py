"""Plain PyTorch versions of the alignment DPs.

Semantics of the JAX package's ``ops/dp.py`` (itself the reference Cython
kernels, reference svecalign/vecalign/dp_core.pyx:79-141 ``dense_dp`` and
:269-405 ``sparse_dp``), written as loops over anti-diagonals with every
cell of an anti-diagonal computed at once:

- :func:`dense_dp`: the 3-move (diag/left/up) DP over an (N, M) 1-1 cost
  matrix, priority diag > left > up, returned in (N+1, M+1) node layout;
  :func:`dense_dp_batched` runs it over a bucket of ragged pairs. This is
  the yardstick of the CUDA kernel in
  :mod:`svecalign_tpu_torch.ops.dense_dp_cuda` and the CPU path of its
  wrapper.
- :func:`banded_dp_batched` (one pair: :func:`run_banded_dp`): the banded
  DP along a search path in rotated coordinates (a, b) = (x + y, y - b_offset[a]).
  For a fixed anti-diagonal ``a`` and type (xo, yo), every band cell's
  predecessor sits at ONE uniform shift ``b_offset_out[a] - yo -
  b_offset_out[a - xo - yo]``, so a row is a gather, an add and a
  first-minimum over types. This is the yardstick of the CUDA kernel in
  :mod:`svecalign_tpu_torch.ops.dp_cuda` and the CPU path of its wrapper.
- :func:`dense_traceback_walk`, :func:`banded_traceback_walk`: follow the
  backpointers from (x_size, y_size) to the origin for every pair of a
  bucket at once and emit only the visited path; the yardsticks of the
  kernels in :mod:`svecalign_tpu_torch.ops.traceback_cuda`.
  :func:`device_traceback_enabled` says whether an aligner walks on the
  device or pulls the planes and walks on the host.

Each candidate is one fp32 add of the same two operands as in the JAX
scan, the Pallas kernel and the CUDA kernel, and ties keep the first
minimum in type order (given types, then (0, 1), then (1, 0)), so all of
them agree bit for bit.
"""

import os
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

NEG_BP = -42  # backpointer marker for unreachable cells (dp_core.pyx:367-368)

INF = float("inf")


# ---------------------------------------------------------------------------
# Dense DP
# ---------------------------------------------------------------------------


def dense_dp(costs: torch.Tensor, pen) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense DP by anti-diagonal wavefront.

    costs: (N, M) float32; pen: the deletion penalty (cast to float32).
    Returns (csum (N+1, M+1) float32, bp (N+1, M+1) int8) on costs' device:
    bp is 0 = diag, 1 = left/insertion, 2 = up/deletion, 4 at the origin.
    Every cell of diagonal d reads only diagonals d-1 and d-2, so a step is
    a handful of vector ops with the candidates of the sequential
    recurrence (exact ties resolve the same way).
    """
    dev = costs.device
    n, m = costs.shape
    rmax, cmax = n + 1, m + 1
    n_diags = rmax + cmax - 1
    pen = torch.as_tensor(pen, dtype=torch.float32, device=dev)

    r = torch.arange(rmax, device=dev)
    if n == 0 or m == 0:
        # an empty side: only the boundary row or column exists
        edge = (r[:, None] + torch.arange(cmax, device=dev)[None, :]).float() * pen
        bp = torch.full((rmax, cmax), 1 if n == 0 else 2, dtype=torch.int8, device=dev)
        bp[0, 0] = 4
        return edge, bp
    d = torch.arange(n_diags, device=dev)[:, None]
    c = d - r  # (n_diags, rmax): column of node (r, d - r)
    cost_valid = (r >= 1) & (c >= 1) & (r - 1 < n) & (c - 1 < m)
    cost_diag = torch.where(
        cost_valid,
        costs[(r - 1).clamp(0, n - 1), (c - 1).clamp(0, m - 1)],
        INF,
    )
    on_grid = (c >= 0) & (c < cmax)

    # boundary row/column (dp_core.pyx:107-119), in the JAX order
    row0 = (r == 0).expand_as(c)
    col0 = (c == 0) & (r > 0)
    origin = row0 & (c == 0)
    edge = row0 | col0
    edge_val = torch.where(row0, c.float() * pen, r.float() * pen)
    edge_val = torch.where(origin, 0.0, edge_val)
    edge_bp = torch.where(row0, 1, 2)
    edge_bp = torch.where(origin, 4, edge_bp).to(torch.int8)

    # vals[k + 2, 1 + r] holds diagonal k; the two leading rows and the
    # leading column stay +inf, so "diagonal d-2 at r-1" is a plain slice
    vals = torch.full((n_diags + 2, rmax + 1), INF, device=dev)
    bps = torch.empty((n_diags, rmax), dtype=torch.int8, device=dev)
    for k in range(n_diags):
        p1, p2 = vals[k + 1], vals[k]
        cost0 = p2[:-1] + cost_diag[k]  # diag move, from (r-1, c-1)
        cost1 = p1[1:] + pen  # left move, from (r, c-1)
        cost2 = p1[:-1] + pen  # up move, from (r-1, c)
        left = cost1 < cost0
        val = torch.where(left, cost1, cost0)
        bp = left.to(torch.int8)
        up = cost2 < val
        bp = torch.where(up, 2, bp).to(torch.int8)
        val = torch.where(up, cost2, val)
        val = torch.where(edge[k], edge_val[k], val)
        bp = torch.where(edge[k], edge_bp[k], bp)
        vals[k + 2, 1:] = torch.where(on_grid[k], val, INF)
        bps[k] = torch.where(on_grid[k], bp, -1)

    rr = torch.arange(rmax, device=dev)[:, None]
    cc = torch.arange(cmax, device=dev)[None, :]
    return vals[rr + cc + 2, rr + 1], bps[rr + cc, rr]


def dense_dp_batched(
    costs: torch.Tensor,  # (P, N, M) float32
    pens: torch.Tensor,  # (P,) float32
    x_sizes: torch.Tensor,  # (P,) int32
    y_sizes: torch.Tensor,  # (P,) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense DP of a bucket of ragged pairs: pair p's DP runs over its own
    costs[p, :x_sizes[p], :y_sizes[p]]. Returns (csum (P, N+1, M+1) float32,
    bp (P, N+1, M+1) int8); nodes outside a pair's (x_size+1, y_size+1)
    rectangle hold +inf and -1 (no node inside reads one outside, and the
    traceback starts at (x_size, y_size))."""
    P, N, M = costs.shape
    csum = torch.full((P, N + 1, M + 1), INF, dtype=torch.float32, device=costs.device)
    bp = torch.full((P, N + 1, M + 1), -1, dtype=torch.int8, device=costs.device)
    for p, (n, m) in enumerate(zip(x_sizes.tolist(), y_sizes.tolist())):
        n, m = min(max(n, 0), N), min(max(m, 0), M)
        csum[p, :n + 1, :m + 1], bp[p, :n + 1, :m + 1] = dense_dp(costs[p, :n, :m], pens[p])
    return csum, bp


# ---------------------------------------------------------------------------
# Traceback walks on the planes' device
# ---------------------------------------------------------------------------


def device_traceback_enabled(device=None) -> bool:
    """Whether the batched aligner walks the backpointers on the device and
    pulls only the visited path, or pulls the planes and walks on the host.
    ``SVECALIGN_DEVICE_TRACEBACK={1,0,auto}``: ``1``/``0`` force either;
    ``auto`` (the default) is on for a CUDA ``device`` and off on the CPU
    (the pull is free there). Outputs are identical either way. The
    per-pair pyramid does not ask: one pair's planes are small, and it
    always walks on the host."""
    v = os.environ.get("SVECALIGN_DEVICE_TRACEBACK", "auto").lower()
    if v in ("1", "on", "true"):
        return True
    if v in ("0", "off", "false"):
        return False
    return device is not None and torch.device(device).type == "cuda"


def dense_traceback_walk(
    bp: torch.Tensor,  # (P, N+1, M+1) int8, node layout
    x_sizes: torch.Tensor,  # (P,) int32
    y_sizes: torch.Tensor,  # (P,) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk every pair's dense backpointers from (x_size, y_size) to the
    origin. Returns (xs, ys (P, N+M+1) int32, vs (P, N+M+1) int8): the
    visited node and its pointer per step; N + M + 1 steps bound any
    unit-step path, and a walk that has reached the origin stays there
    (its pointer is 4). The JAX package's ``dense_traceback_scan`` on node
    layout."""
    P, rmax, cmax = bp.shape
    steps = rmax + cmax - 1
    dev = bp.device
    pair = torch.arange(P, device=dev)
    xx = x_sizes.long().clamp(0, rmax - 1)
    yy = y_sizes.long().clamp(0, cmax - 1)
    xs = torch.empty((P, steps), dtype=torch.int32, device=dev)
    ys = torch.empty((P, steps), dtype=torch.int32, device=dev)
    vs = torch.empty((P, steps), dtype=torch.int8, device=dev)
    for i in range(steps):
        v = bp[pair, xx, yy]
        xs[:, i], ys[:, i], vs[:, i] = xx, yy, v
        moving = (xx != 0) | (yy != 0)
        xx = (xx - (moving & ((v == 0) | (v == 2))).long()).clamp(min=0)
        yy = (yy - (moving & ((v == 0) | (v == 1))).long()).clamp(min=0)
    return xs, ys, vs


def banded_traceback_walk(
    csum: torch.Tensor,  # (P, A+2, B) float32
    xp: torch.Tensor,  # (P, A+2, B) int8 or int32
    yp: torch.Tensor,  # (P, A+2, B)
    b_offset_out: torch.Tensor,  # (P, A+2) int32
    x_sizes: torch.Tensor,  # (P,) int32
    y_sizes: torch.Tensor,  # (P,) int32
):
    """Walk every pair's banded planes from (x_size, y_size) to the origin.
    Returns (xs, ys (P, A+2) int32, xps, yps (P, A+2) in the planes' dtype,
    cs (P, A+2) float32): the visited node, its two pointers and its
    cumulative cost per step; a walk that has reached the origin stays
    there. The JAX package's ``banded_traceback_scan``; plane indices are
    clamped, so corrupt pointers give a path the host conversion rejects."""
    P, a2, B = xp.shape
    dev = xp.device
    pair = torch.arange(P, device=dev)
    boff = b_offset_out.long()
    xx, yy = x_sizes.long(), y_sizes.long()
    xs = torch.empty((P, a2), dtype=torch.int32, device=dev)
    ys = torch.empty((P, a2), dtype=torch.int32, device=dev)
    xps = torch.empty((P, a2), dtype=xp.dtype, device=dev)
    yps = torch.empty((P, a2), dtype=yp.dtype, device=dev)
    cs = torch.empty((P, a2), dtype=torch.float32, device=dev)
    for i in range(a2):
        aa = (xx + yy).clamp(0, a2 - 1)
        bb = (yy - boff[pair, aa]).clamp(0, B - 1)
        vx, vy = xp[pair, aa, bb], yp[pair, aa, bb]
        xs[:, i], ys[:, i], xps[:, i], yps[:, i] = xx, yy, vx, vy
        cs[:, i] = csum[pair, aa, bb]
        moving = (xx != 0) | (yy != 0)
        xx = torch.where(moving, xx - vx.long(), xx)
        yy = torch.where(moving, yy - vy.long(), yy)
    return xs, ys, xps, yps, cs


# ---------------------------------------------------------------------------
# Banded (sparse) DP
# ---------------------------------------------------------------------------


def extend_band_offsets(b_offset_in: np.ndarray) -> np.ndarray:
    """Node-space band offsets: two replicated points at the front, then +1.

    Matches reference dp_core.pyx:315-328 — costs live between nodes, so the
    node grid is shifted by (x=+1, y=+1), i.e. (a=+2, b=+1) in rotated
    coordinates.
    """
    b_offset_in = np.asarray(b_offset_in, dtype=np.int32)
    first = b_offset_in[0]
    return np.concatenate([[first, first], b_offset_in + 1]).astype(np.int32)


def dp_types(x_offsets: Sequence[int], y_offsets: Sequence[int]):
    """The DP's full type list: the given types, then (0, 1) and (1, 0)
    (dp_core.pyx:305-307), with K = the largest span (ring depth) and the
    backpointer dtype (int8 unless an offset exceeds 127)."""
    xo = [int(v) for v in x_offsets] + [0, 1]
    yo = [int(v) for v in y_offsets] + [1, 0]
    K = max(x + y for x, y in zip(xo, yo))
    bp_dtype = torch.int8 if max(xo + yo) <= 127 else torch.int32
    return xo, yo, K, bp_dtype


def banded_dp_batched(
    costs: torch.Tensor,  # (P, T, A, B) float32
    b_offset_in: torch.Tensor,  # (P, A) int32 (unused: kept for the signature)
    b_offset_out: torch.Tensor,  # (P, A+2) int32
    x_offsets: Sequence[int],
    y_offsets: Sequence[int],
    del_penalty: torch.Tensor,  # (P,) float32
    x_in_size: torch.Tensor,  # (P,) int32
    y_in_size: torch.Tensor,  # (P,) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P-pair banded DP, the signature of the JAX package's
    ``banded_dp_pallas_batched``. Returns (csum (P, A+2, B) float32,
    xp, yp (P, A+2, B) int8 or int32). Everything that does not depend on
    earlier rows (indices, masks, cost rows, edge values) is built up
    front; the loop over anti-diagonals keeps the sequential part only."""
    dev = costs.device
    P, T, A, B = costs.shape
    a2 = A + 2
    xo_l, yo_l, K, bp_dtype = dp_types(x_offsets, y_offsets)
    n_types = len(xo_l)
    xo = torch.tensor(xo_l, device=dev)
    yo = torch.tensor(yo_l, device=dev)
    span = xo + yo

    boff = b_offset_out.long()
    pen = del_penalty.float()
    x_in = x_in_size.long()[:, None, None]
    y_in = y_in_size.long()[:, None, None]

    aa = torch.arange(a2, device=dev)
    band = torch.arange(B, device=dev)
    prev_row = aa[:, None] - span  # (a2, n_types)
    prev_ok = prev_row >= 0
    prev_row = prev_row.clamp(min=0)
    boff_prev = boff[:, prev_row]  # (P, a2, n_types)
    shift = boff[:, :, None] - yo - boff_prev
    # history rows are padded by K +inf lanes on each side: |shift| <= K
    cols = K + shift[..., None] + band  # (P, a2, n_types, B)

    yy = boff[:, :, None] + band  # (P, a2, B)
    xx = aa[:, None] - yy
    cell_ok = (xx - 1 >= 0) & (xx - 1 < x_in) & (yy - 1 >= 0) & (yy - 1 < y_in)
    xx_prev = xx[:, :, None, :] - xo[:, None]  # (P, a2, n_types, B)
    yy_prev = yy[:, :, None, :] - yo[:, None]
    x_in4, y_in4 = x_in[..., None], y_in[..., None]
    valid = (
        cell_ok[:, :, None]
        & (xx_prev >= 0) & (xx_prev < x_in4 + 1)
        & (yy_prev >= 0) & (yy_prev < y_in4 + 1)
        & prev_ok[None, :, :, None]
    )

    # cost of each type per row: cost row aa-2 for the given types (+inf
    # for aa < 2), the deletion penalty for (0, 1) and (1, 0)
    cost_all = torch.full((P, a2, n_types, B), INF, device=dev)
    cost_all[:, 2:, :T] = costs.permute(0, 2, 1, 3)
    cost_all[:, :, T:] = pen[:, None, None, None]

    # all-insertion column x = 0, then all-deletion row y = 0
    edge_y = (xx == 0) & (yy >= 0) & (yy < y_in + 1)
    edge_x = ~edge_y & (yy == 0) & (xx >= 0) & (xx < x_in + 1)
    edge_y_val = pen[:, None, None] * yy.float()
    edge_x_val = pen[:, None, None] * xx.float()

    hist = torch.full((P, a2, B + 2 * K), INF, device=dev)
    xp = torch.empty((P, a2, B), dtype=bp_dtype, device=dev)
    yp = torch.empty((P, a2, B), dtype=bp_dtype, device=dev)
    for a in range(a2):
        prev = torch.gather(hist[:, prev_row[a]], 2, cols[:, a])  # (P, n_types, B)
        cand = torch.where(valid[:, a], prev + cost_all[:, a], INF)
        best, best_t = torch.min(cand, dim=1)  # first minimum wins
        reach = best < INF
        val = torch.where(reach, best, INF)
        bxp = torch.where(reach, xo[best_t], NEG_BP)
        byp = torch.where(reach, yo[best_t], NEG_BP)
        ey, ex = edge_y[:, a], edge_x[:, a]
        val = torch.where(ey, edge_y_val[:, a], val)
        bxp = torch.where(ey, 0, bxp)
        byp = torch.where(ey, 1, byp)
        val = torch.where(ex, edge_x_val[:, a], val)
        bxp = torch.where(ex, 1, bxp)
        byp = torch.where(ex, 0, byp)
        hist[:, a, K:K + B] = val
        xp[:, a] = bxp
        yp[:, a] = byp
    return hist[:, :, K:K + B], xp, yp


def run_banded_per_pair(
    batched_fn: Callable,
    costs: torch.Tensor,
    b_offset_in: np.ndarray,
    alignment_types: List[Tuple[int, int]],
    del_penalty: float,
    x_in_size: int,
    y_in_size: int,
):
    """Run a batched banded DP on one pair with the reference ``sparse_dp``
    signature. The penalty arrives as a Python float64 and is cast to
    float32 here, as the JAX wrappers do. Returns host (csum float64, xp,
    yp, b_offset_out): one pull of the planes for the host traceback."""
    dev = costs.device
    b_off_in = np.asarray(b_offset_in, dtype=np.int32)
    b_off_out = extend_band_offsets(b_off_in)
    csum, xp, yp = batched_fn(
        costs[None].float().contiguous(),
        torch.from_numpy(b_off_in)[None].to(dev),
        torch.from_numpy(b_off_out)[None].to(dev),
        tuple(x for x, _ in alignment_types),
        tuple(y for _, y in alignment_types),
        torch.tensor([del_penalty], dtype=torch.float32).to(dev),
        torch.tensor([x_in_size], dtype=torch.int32).to(dev),
        torch.tensor([y_in_size], dtype=torch.int32).to(dev),
    )
    return (
        csum[0].cpu().numpy().astype(np.float64),
        xp[0].cpu().numpy(),
        yp[0].cpu().numpy(),
        b_off_out,
    )


def run_banded_dp(costs, b_offset_in, alignment_types, del_penalty,
                  x_in_size, y_in_size):
    """The plain banded DP with the JAX ``run_banded_dp`` signature and
    outputs (csum float64 host, xp, yp, b_offset_out)."""
    return run_banded_per_pair(
        banded_dp_batched, costs, b_offset_in, alignment_types,
        del_penalty, x_in_size, y_in_size,
    )
