"""The coarse-to-fine aligner driver, one document pair at a time.

Port of the JAX package's ``vecalign/pyramid.py`` (reference
svecalign/vecalign/dp_utils.py:381-537 ``vecalign``): build a pyramid by
repeatedly halving both documents until a full dense DP fits (<=
max_size_full_dp^2 cells), align at the coarsest level with a dense DP,
then refine level by level with a banded DP along the upsampled path.

Device/host split:
- normalisation, downsampling, margin normalizers, dense and banded cost
  tensors, the dense DP and the banded DP run on ``device``; on the card
  both DPs are CUDA kernels (the banded one unless ``dp_backend="torch"``
  asks for the plain torch loop), on the CPU the plain torch loops;
  ``dp_backend="native"`` runs the banded DP on the host in float64
  (``ops/dp_native.py``): each level's costs come to the host, as in JAX;
- path bookkeeping (upsample / extend / slant) and the tracebacks are
  tiny, irregular host code: each level pulls its planes once (one
  pair's planes are small; the walk kernels serve the batched aligner).

Every random draw comes from one numpy ``default_rng(seed)`` in the JAX
package's order, so both packages see the same samples.
"""

from collections import OrderedDict
from time import perf_counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.ops import costs as costs_ops
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.ops import dense_dp_cuda, dp_cuda
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.torch_setup import resolve_device
from svecalign_tpu_torch.vecalign.deletion import make_del_knob
from svecalign_tpu_torch.vecalign.traceback import dense_traceback, sparse_traceback

logger = logging.getLogger("vecalign")

Alignment = Tuple[List[int], List[int]]

DP_BACKENDS = ("auto", "cuda", "torch", "native")


# ---------------------------------------------------------------------------
# Search-path bookkeeping (host; reference dp_utils.py:177-275)
# ---------------------------------------------------------------------------


def append_slant(path: List[Tuple[int, int]], xwidth: int, ywidth: int) -> None:
    """Append a quantized straight line from path[-1] by (xwidth, ywidth),
    stepping exactly one position in x XOR y each time. (dp_utils.py:177-196)."""
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


def alignment_to_search_path(algn: List[Alignment]) -> List[Tuple[int, int]]:
    """Convert an alignment into a monotone unit-step search path, slanting
    straight lines through deletion blocks. (dp_utils.py:199-225)."""
    path = [(0, 0)]
    xdel, ydel = 0, 0
    for x, y in algn:
        if len(x) and len(y):
            append_slant(path, xdel, ydel)
            xdel, ydel = 0, 0
            append_slant(path, len(x), len(y))
        elif len(x):
            xdel += len(x)
        elif len(y):
            ydel += len(y)
    append_slant(path, xdel, ydel)
    return path


def extend_alignments(course_alignments: List[Alignment], size0: int, size1: int) -> None:
    """Extend alignments (in place) to reach new endpoints (size0, size1);
    needed because downsampling truncates odd tails. (dp_utils.py:228-258)."""
    xmax = 0
    ymax = 0
    for x, y in course_alignments:
        for xval in x:
            xmax = max(xmax, xval)
        for yval in y:
            ymax = max(ymax, yval)

    if xmax > size0 or ymax > size1:
        raise Exception("asked to extend alignments but already bigger than requested")

    extra_x = list(range(xmax + 1, size0 + 1))
    extra_y = list(range(ymax + 1, size1 + 1))

    logger.debug("extending alignments in x by %d and y by %d", len(extra_x), len(extra_y))

    if len(extra_x) == 0:
        for yval in extra_y:
            course_alignments.append(([], [yval]))
    elif len(extra_y) == 0:
        for xval in extra_x:
            course_alignments.append(([xval], []))
    else:
        course_alignments.append((extra_x, extra_y))


def upsample_alignment(algn: List[Alignment]) -> List[Alignment]:
    """Map alignment indices to the next-finer pyramid level (x2).
    (dp_utils.py:261-275)."""

    def up_one(xx):
        return list(range(min(xx) * 2, (max(xx) + 1) * 2))

    new_algn: List[Alignment] = []
    for xx, yy in algn:
        if len(xx) == 0:
            for yyy in up_one(yy):
                new_algn.append(([], [yyy]))
        elif len(yy) == 0:
            for xxx in up_one(xx):
                new_algn.append(([xxx], []))
        else:
            new_algn.append((up_one(xx), up_one(yy)))
    return new_algn


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def pick_banded_dp(dp_backend: str, device: torch.device):
    """The banded-DP function for ``dp_backend`` on ``device``: 'cuda' is
    the hand-written kernel (card only), 'torch' the plain loop, 'native'
    the host float64 DP (costs pulled to the host; its planes are host
    arrays, so nothing of it is walked on the device), 'auto' the kernel
    for CUDA tensors and the plain loop for CPU tensors. The JAX package's
    'auto' takes 'native' on the CPU; this one keeps the plain loop there."""
    if dp_backend not in DP_BACKENDS:
        raise ValueError(f"dp_backend must be one of {DP_BACKENDS}, got {dp_backend!r}")
    if dp_backend == "auto":
        dp_backend = "cuda" if device.type == "cuda" else "torch"
    if dp_backend == "cuda":
        if device.type != "cuda":
            raise ValueError("dp_backend 'cuda' runs on the card: use device='cuda'")
        return dp_cuda.run_banded_dp_cuda
    if dp_backend == "native":
        from svecalign_tpu_torch.ops.dp_native import run_banded_dp_native

        return run_banded_dp_native
    return dp_ops.run_banded_dp


def state_from_jax_stack(stack: dict, device) -> dict:
    """Turn a numpy-ified JAX pyramid stack into the port's tensors, depth
    by depth: ``v0``, ``v1``, ``n0``, ``n1`` (float32 tensors on
    ``device``), ``del_penalty`` (float), and where the level has them
    ``b_offset`` (host int32), ``a_b_costs`` and ``costs_1to1`` (tensors).
    Feeding one JAX level's exact inputs into each port function localises
    any drift to one module."""
    device = torch.device(device)
    out = {}
    for depth, entry in stack.items():
        st = {
            k: torch.tensor(np.asarray(entry[k]), dtype=torch.float32, device=device)
            for k in ("v0", "v1", "n0", "n1")
        }
        st["del_penalty"] = float(entry["del_penalty"])
        if "b_offset" in entry:
            st["b_offset"] = np.asarray(entry["b_offset"], dtype=np.int32)
        for k in ("a_b_costs", "costs_1to1"):
            if k in entry:
                st[k] = torch.tensor(np.asarray(entry[k]), dtype=torch.float32, device=device)
        out[depth] = st
    return out


def vecalign(
    vecs0: np.ndarray,
    vecs1: np.ndarray,
    final_alignment_types: List[Tuple[int, int]],
    del_percentile_frac: float,
    width_over2: int,
    max_size_full_dp: int,
    costs_sample_size: int,
    num_samps_for_norm: int,
    norms0: Optional[np.ndarray] = None,
    norms1: Optional[np.ndarray] = None,
    seed: int = 42,
    dp_backend: str = "auto",
    device="cuda",
) -> dict:
    """Coarse-to-fine alignment of two overlap tensors.

    vecs0/vecs1: (num_overlaps, num_segments, dim) overlap tensors (numpy,
    fp16 or fp32). Returns the DP stack: stack[0]['final_alignments'] is
    the result, stack[0]['alignment_scores'] the per-alignment costs and
    stack[0]['runtimes'] the wall time of each phase (the device is
    synchronised at each phase's end). Matches the JAX package's
    ``pyramid.vecalign`` with the same seed. ``device`` defaults to the
    card; ``dp_backend``: auto | cuda | torch | native (see
    :func:`pick_banded_dp`). Every backend's planes are walked on the host.
    """
    dev = resolve_device(device)
    banded_dp_fn = pick_banded_dp(dp_backend, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if width_over2 < 3:
        logger.warning(
            "width_over2 was set to %d, which does not make sense. increasing to 3.",
            width_over2,
        )
        width_over2 = 3

    rng = np.random.default_rng(seed)
    runtimes = OrderedDict()

    # normalize on the device: fp16 inputs upload at half size
    t0 = perf_counter()
    v0 = costs_ops.upcast_norm1(torch.as_tensor(vecs0).to(dev))
    v1 = costs_ops.upcast_norm1(torch.as_tensor(vecs1).to(dev))

    # pyramid depth: halve until the dense DP fits
    s0, s1 = v0.shape[1], v1.shape[1]
    max_depth = 0
    while s0 * s1 > max_size_full_dp**2:
        max_depth += 1
        s0 = s0 // 2
        s1 = s1 // 2

    stack = {0: {"v0": v0, "v1": v1}}
    for depth in range(1, max_depth + 1):
        stack[depth] = {
            "v0": costs_ops.downsample_vectors(stack[depth - 1]["v0"]),
            "v1": costs_ops.downsample_vectors(stack[depth - 1]["v1"]),
        }
    sync()
    runtimes["Downsample embeddings"] = perf_counter() - t0

    # margin normalizers + alignment types per depth
    t0 = perf_counter()
    for depth in stack:
        stack[depth]["size0"] = stack[depth]["v0"].shape[1]
        stack[depth]["size1"] = stack[depth]["v1"].shape[1]
        stack[depth]["alignment_types"] = (
            final_alignment_types if depth == 0 else [(1, 1)]
        )
        for side, norms, vecs in (("0", norms0, vecs0), ("1", norms1, vecs1)):
            other = "1" if side == "0" else "0"
            if depth == 0 and norms is not None:
                if norms.shape != vecs.shape[:2]:
                    raise Exception(f"norms{side} wrong shape")
                stack[depth]["n" + side] = torch.as_tensor(norms, dtype=torch.float32).to(dev)
            else:
                stack[depth]["n" + side] = costs_ops.compute_norms(
                    stack[depth]["v" + side], stack[depth]["v" + other],
                    num_samps_for_norm, rng,
                )
    sync()
    runtimes["Normalize embeddings"] = perf_counter() - t0

    # deletion penalty per depth (host: sampled percentile)
    t0 = perf_counter()
    for depth in stack:
        knob = make_del_knob(
            e_laser=stack[depth]["v0"][0],
            f_laser=stack[depth]["v1"][0],
            e_laser_norms=stack[depth]["n0"][0],
            f_laser_norms=stack[depth]["n1"][0],
            sample_size=costs_sample_size,
            rng=rng,
        )
        stack[depth]["del_knob"] = knob
        stack[depth]["del_penalty"] = knob.percentile_frac_to_del_penalty(
            del_percentile_frac
        )
        logger.debug("del_penalty at depth %d: %f", depth, stack[depth]["del_penalty"])
    runtimes["Compute deletion penalties"] = perf_counter() - t0

    # dense DP at the coarsest level (1-1 alignments only)
    top = stack[max_depth]
    t0 = perf_counter()
    top["costs_1to1"] = costs_ops.dense_costs(
        top["v0"][0], top["v1"][0], top["n0"][0], top["n1"][0]
    )
    sync()
    runtimes["Full DP make features"] = perf_counter() - t0

    t0 = perf_counter()
    _, bp = dense_dp_cuda.dense_dp_cuda(
        top["costs_1to1"][None].contiguous(),
        torch.tensor([top["del_penalty"]], dtype=torch.float32).to(dev),
        torch.tensor([top["size0"]], dtype=torch.int32).to(dev),
        torch.tensor([top["size1"]], dtype=torch.int32).to(dev),
    )
    top["x_y_tb"] = bp[0].cpu().numpy()
    runtimes["Full DP"] = perf_counter() - t0
    t0 = perf_counter()
    top["alignments"] = dense_traceback(top["x_y_tb"])
    runtimes["Full DP traceback"] = perf_counter() - t0

    # refine level by level
    cost_t, dp_t, tb_t = [], [], []
    upsample_depths = [0] if max_depth == 0 else list(reversed(range(0, max_depth)))
    for depth in upsample_depths:
        level = stack[depth]
        if max_depth > 0:
            course_alignments = upsample_alignment(stack[depth + 1]["alignments"])
            extend_alignments(course_alignments, level["size0"], level["size1"])
        else:
            course_alignments = level["alignments"]

        level["searchpath"] = alignment_to_search_path(course_alignments)
        types = level["alignment_types"]

        t0 = perf_counter()
        level["b_offset"] = costs_ops.path_to_band_offsets(level["searchpath"], width_over2)
        level["a_b_costs"] = costs_ops.banded_costs(
            level["v0"], level["v1"], level["n0"], level["n1"],
            level["b_offset"],
            tuple(x for x, _ in types),
            tuple(y for _, y in types),
            width_over2,
        )
        sync()
        cost_t.append(perf_counter() - t0)

        t0 = perf_counter()
        csum, xp, yp, b_off_out = banded_dp_fn(
            level["a_b_costs"], level["b_offset"], types,
            level["del_penalty"], level["size0"], level["size1"],
        )
        level["a_b_csum"], level["a_b_xp"], level["a_b_yp"] = csum, xp, yp
        level["new_b_offset"] = b_off_out
        dp_t.append(perf_counter() - t0)

        t0 = perf_counter()
        akey = "final_alignments" if depth == 0 else "alignments"
        level[akey], level["alignment_scores"] = sparse_traceback(
            csum, xp, yp, b_off_out, level["size0"], level["size1"]
        )
        tb_t.append(perf_counter() - t0)

    runtimes["Upsample DP compute costs"] = sum(cost_t[:-1])
    runtimes["Upsample DP"] = sum(dp_t[:-1])
    runtimes["Upsample DP traceback"] = sum(tb_t[:-1])
    runtimes["Final DP compute costs"] = cost_t[-1]
    runtimes["Final DP"] = dp_t[-1]
    runtimes["Final DP traceback"] = tb_t[-1]
    stack[0]["runtimes"] = runtimes

    max_key_len = max(len(key) for key in runtimes)
    for key, val in runtimes.items():
        if val > 5e-5:
            logger.info(
                key + " took " + "." * (max_key_len + 5 - len(key)) + f"{val:.4f}s".rjust(7)
            )

    return stack
