"""Host-side tracebacks and score post-processing.

Copied from the JAX package's ``vecalign/traceback.py``. The host walks
(:func:`sparse_traceback`, :func:`dense_traceback`) read the whole
backpointer planes, one pull per level; ``*_alignments_from_steps`` rebuild
the same alignments from a path that was walked on the device
(:mod:`svecalign_tpu_torch.ops.traceback_cuda`). Semantics match reference
svecalign/vecalign/dp_utils.py:105-174.
"""

from typing import List, Tuple

import numpy as np

Alignment = Tuple[List[int], List[int]]


def xy2ab_w_offset(xx: int, yy: int, bb_offset: np.ndarray) -> Tuple[int, int]:
    """(x, y) -> rotated band coordinates (a, b). (dp_utils.py:82-86)."""
    aa = xx + yy
    bb = yy - bb_offset[aa]
    return aa, bb


def process_scores(scores: np.ndarray, alignments: List[Alignment]) -> np.ndarray:
    """Per-alignment scores: cost delta normalized by span sizes; deletions
    report 0. (dp_utils.py:89-102)."""
    scores = np.clip(scores, a_min=0, a_max=None)
    for ii, (x_algn, y_algn) in enumerate(alignments):
        if len(x_algn) == 0 or len(y_algn) == 0:
            scores[ii] = 0.0
        else:
            scores[ii] = scores[ii] / len(x_algn) / len(y_algn)
    return scores


def sparse_traceback(
    a_b_csum: np.ndarray,
    a_b_xp: np.ndarray,
    a_b_yp: np.ndarray,
    b_offset: np.ndarray,
    xsize: int,
    ysize: int,
) -> Tuple[List[Alignment], np.ndarray]:
    """Walk back through the banded DP's backpointer planes from
    (xsize, ysize) to (0, 0). (dp_utils.py:105-143)."""
    alignments: List[Alignment] = []
    xx, yy = xsize, ysize
    cum_costs = []

    while True:
        aa, bb = xy2ab_w_offset(xx, yy, b_offset)
        cum_costs.append(a_b_csum[aa, bb])

        xp = int(a_b_xp[aa, bb])
        yp = int(a_b_yp[aa, bb])

        if xx == yy == 0:
            break
        if xx < 0 or yy < 0:
            raise Exception("traceback bug")

        alignments.append((list(range(xx - xp, xx)), list(range(yy - yp, yy))))
        xx -= xp
        yy -= yp

    alignments.reverse()
    cum_costs.reverse()
    costs = np.array(cum_costs[1:]) - np.array(cum_costs[:-1])
    scores = process_scores(costs, alignments)
    return alignments, scores


def sparse_alignments_from_steps(
    xs: np.ndarray,
    ys: np.ndarray,
    xps: np.ndarray,
    yps: np.ndarray,
    cs: np.ndarray,
) -> Tuple[List[Alignment], np.ndarray]:
    """Rebuild alignments + scores from a device-walked banded path
    (ops.dp.banded_traceback_walk). Same order of operations as
    :func:`sparse_traceback`: the cumulative cost is recorded BEFORE the
    origin check, so the (0, 0) node's csum is included."""
    alignments: List[Alignment] = []
    cum_costs = []
    for xx, yy, xp, yp, cc in zip(xs, ys, xps, yps, cs):
        xx, yy = int(xx), int(yy)
        cum_costs.append(np.float64(cc))
        if xx == yy == 0:
            break
        if xx < 0 or yy < 0:
            raise Exception("traceback bug")
        alignments.append(
            (list(range(xx - int(xp), xx)), list(range(yy - int(yp), yy)))
        )
    else:
        # the device walk emits exactly A+2 >= x0+y0+1 steps, enough for
        # any unit-step path; not reaching (0, 0) means corrupt pointers
        raise Exception("traceback bug")

    alignments.reverse()
    cum_costs.reverse()
    costs = np.array(cum_costs[1:]) - np.array(cum_costs[:-1])
    scores = process_scores(costs, alignments)
    return alignments, scores


def dense_alignments_from_steps(
    xs: np.ndarray, ys: np.ndarray, vs: np.ndarray
) -> List[Alignment]:
    """Rebuild alignments from a device-walked dense path
    (ops.dp.dense_traceback_walk); semantics of :func:`dense_traceback`."""
    alignments: List[Alignment] = []
    for xx, yy, v in zip(xs, ys, vs):
        xx, yy = int(xx), int(yy)
        if xx == yy == 0:
            break
        if v == 0:
            alignments.append(([xx - 1], [yy - 1]))
        elif v == 1:
            alignments.append(([], [yy - 1]))
        elif v == 2:
            alignments.append(([xx - 1], []))
        else:
            raise Exception("got unknown value")
    else:
        raise Exception("traceback bug")

    alignments.reverse()
    return alignments


def dense_traceback(x_y_tb: np.ndarray) -> List[Alignment]:
    """Walk the dense DP's move matrix (0=diag, 1=left, 2=up).
    (dp_utils.py:146-174)."""
    xsize, ysize = x_y_tb.shape
    xx, yy = xsize - 1, ysize - 1

    alignments: List[Alignment] = []
    while True:
        if xx == yy == 0:
            break
        bp = int(x_y_tb[xx, yy])
        if bp == 0:
            xp, yp = 1, 1
            alignments.append(([xx - 1], [yy - 1]))
        elif bp == 1:
            xp, yp = 0, 1
            alignments.append(([], [yy - 1]))
        elif bp == 2:
            xp, yp = 1, 0
            alignments.append(([xx - 1], []))
        else:
            raise Exception("got unknown value")
        xx -= xp
        yy -= yp

    alignments.reverse()
    return alignments
