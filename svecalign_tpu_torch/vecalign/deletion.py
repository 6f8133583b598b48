"""Deletion-penalty estimation via sampled cost percentiles.

Semantics match reference svecalign/vecalign/dp_utils.py:43-79
(``DeletionKnob``) and :278-323 (``make_del_knob``), as in the JAX
package's ``vecalign/deletion.py``: the samples come from a caller-provided
seeded numpy generator, so the port draws the same index pairs as the JAX
package from the same seed.
"""

import numpy as np
import torch

from svecalign_tpu_torch.ops.costs import score_pairs
from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)


NUM_BINS = 1000


class DeletionKnob:
    """Map a percentile fraction to a deletion penalty via a sampled-cost CDF."""

    def __init__(self, samp: np.ndarray, res_min: float, res_max: float):
        self.res_min = res_min
        self.res_max = res_max
        if self.res_min >= self.res_max:
            logger.warning("res_max <= res_min, increasing it")
            self.res_max = self.res_min + 1e-4

        self.hist, self.bin_edges = np.histogram(
            samp, bins=NUM_BINS, range=[self.res_min, self.res_max], density=True
        )
        dx = self.bin_edges[1] - self.bin_edges[0]
        self.cdf = np.cumsum(self.hist) * dx
        self._build_interp()

    def _build_interp(self):
        num_pts = 30
        interp_points = [(0, self.res_min)]
        for knob_val in np.linspace(0, 1, num_pts - 1)[1:-1]:
            cdf_idx = np.searchsorted(self.cdf, knob_val)
            cdf_val = self.res_min + cdf_idx / float(NUM_BINS) * (
                self.res_max - self.res_min
            )
            interp_points.append((knob_val, cdf_val))
        interp_points.append((1, self.res_max))
        self.x, self.y = zip(*interp_points)

    def percentile_frac_to_del_penalty(self, knob_val: float) -> float:
        return float(np.interp([knob_val], self.x, self.y)[0])


def device_del_penalty(
    counts: torch.Tensor, smax: torch.Tensor, frac: float, valid: torch.Tensor
) -> torch.Tensor:
    """Deletion penalties for a batch, on the tensors' device.

    counts: (P, NUM_BINS) sampled-cost histograms (int); smax: (P,) sample
    maxima; valid: (P,) bool — invalid pairs get the 0.5 placeholder.
    Mirrors :class:`DeletionKnob` built from a histogram and
    ``percentile_frac_to_del_penalty`` (cdf -> 27 interior interpolation
    points -> linear interpolation), so no histogram leaves the device.
    float32 against the host's float64 can shift a bin boundary
    (~res_max / 1000)."""
    dev = counts.device
    p = counts.shape[0]
    res_max = torch.where(smax > 0, smax, 1e-4).float()
    total = counts.sum(dim=1, keepdim=True).clamp(min=1)
    cdf = counts.cumsum(dim=1) / total.float()
    knots = torch.linspace(0.0, 1.0, 29, device=dev)
    kvs = knots[1:-1]  # 27 interior knob points
    idx = torch.searchsorted(cdf, kvs.expand(p, -1).contiguous())  # (P, 27)
    cdf_val = idx.float() / NUM_BINS * res_max[:, None]
    y = torch.cat([torch.zeros((p, 1), device=dev), cdf_val, res_max[:, None]], dim=1)
    # linear interpolation of (knots, y) at frac, written out
    x = torch.tensor(frac, dtype=torch.float32, device=dev)
    i = torch.searchsorted(knots, x, right=True).clamp(1, knots.shape[0] - 1)
    dx = knots[i] - knots[i - 1]
    pen = y[:, i - 1] + (x - knots[i - 1]) / dx * (y[:, i] - y[:, i - 1])
    pen = torch.where(x <= knots[0], y[:, 0], torch.where(x >= knots[-1], y[:, -1], pen))
    return torch.where(valid, pen, 0.5)


def make_del_knob(
    e_laser,
    f_laser,
    e_laser_norms,
    f_laser_norms,
    sample_size: int,
    rng: np.random.Generator,
) -> DeletionKnob:
    """Estimate the cost distribution from random index pairs
    (dp_utils.py:278-323). The vectors and norms are tensors on the
    aligner's device; only the sampled scores come back."""
    e_size = e_laser.shape[0]
    f_size = f_laser.shape[0]

    if e_size > 0 and f_size > 0 and sample_size > 0:
        if e_size * f_size < sample_size:
            # small problem: compute the full cross product
            x_idxs, y_idxs = np.meshgrid(
                np.arange(e_size, dtype=np.int32),
                np.arange(f_size, dtype=np.int32),
                indexing="ij",
            )
            x_idxs = x_idxs.ravel()
            y_idxs = y_idxs.ravel()
        else:
            x_idxs = rng.integers(0, e_size, size=sample_size).astype(np.int32)
            y_idxs = rng.integers(0, f_size, size=sample_size).astype(np.int32)

        random_scores = score_pairs(
            x_idxs, y_idxs, e_laser_norms, f_laser_norms, e_laser, f_laser
        )
        min_score = 0
        max_score = float(random_scores.max())
    else:
        random_scores = np.array([0.0, 0.5, 1.0])
        min_score = 0
        max_score = 1

    return DeletionKnob(random_scores, min_score, max_score)
