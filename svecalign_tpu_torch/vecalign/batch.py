"""Batched multi-pair alignment: many document pairs per device program.

Port of the JAX package's ``vecalign/batch.py``. The per-pair aligner
(pyramid.py) pays a few host<->device round trips per level whatever the
size, so a mining run over thousands of document pairs leaves the card
idle. This module pads a bucket of pairs to common shapes and runs every
device stage — normalization, masked pyramid downsampling, margin
normalizers, deletion-knob sampling, dense costs + DP, banded costs + DP,
the traceback walks — with a leading pair axis, so the launch count per
LEVEL does not grow with the bucket. Host bookkeeping (search paths,
turning a walked path into alignment lists) stays per pair.

On the card the dense DP, the banded DP and the two walks are the
hand-written kernels of ``ops/dense_dp_cuda.py``, ``ops/dp_cuda.py`` and
``ops/traceback_cuda.py``, one launch each per bucket and level; on CPU
tensors their wrappers run the plain versions of ``ops/dp.py``.

Semantics match pyramid.vecalign per pair, with one deliberate deviation in
the default mode: the pyramid's mean-removal during downsampling is computed
with per-pair validity masks (so padding rows don't shift the mean), making
padded and unpadded pairs equivalent; sampling draws come from seeded
generators on the device, one per depth and role, drawn once per bucket
and shared by its pairs (each scales them to its own sizes, as each pair's
own stream starts from the seed in paired mode), so a pair's draws do not
depend on its bucket. The draws are torch's, not ``jax.random``'s: shared
mode agrees with the JAX package in quality, not bit for bit. Pairs whose
size product is below costs_sample_size use the exhaustive index cross
product for the deletion knob (masked on device), matching
make_del_knob's small-problem branch (reference dp_utils.py:278-323).

``sampling="paired"`` instead gives every pair its own seeded numpy stream
reproducing pyramid.vecalign's exact draw order (norm samples for every
depth, then knob samples for every depth) and evaluates the deletion knob
on the host — so a bucket of same-sized pairs is sample-identical to
per-pair runs, and to the JAX package's paired mode. Costs one extra host
pull per depth.

Staging: :func:`stage_rows_upload` uploads a bucket's rows from the host;
:func:`stage_rows_device` gathers them from rows the embed stage left on
the device (the fused pipeline, ``utils/embed_cache.py``), uploading only
the id maps.

Several devices (``sharding=parallel.mesh.batch_sharding(mesh)``, the
counterpart of the JAX package's pair-axis ``NamedSharding``): the
bucket's pairs split into contiguous slices over the mesh's data axis,
each shard staged on its own device at the whole bucket's padded shapes,
and :func:`run_staged` runs the pyramid of each shard on its device, the
shards in turn on the calling thread (a shard's pyramid pulls each
level's paths to the host, so the shards overlap little; a worker thread
per shard was measured slower still: ``parallel/mesh.py::run_on_shards``).
No collective is needed: the DP has no cross-pair dependence. The shared
mode's draws are made once per bucket, before the split, so a sharded
bucket equals the unsharded one; results come back in pair order.
"""

import math
import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.ops import costs as costs_ops
from svecalign_tpu_torch.ops import dense_dp_cuda, dp_cuda, traceback_cuda
from svecalign_tpu_torch.ops import dp as dp_ops
from svecalign_tpu_torch.parallel.mesh import Mesh, Sharding, run_on_shards, shard_slices
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.phase_clock import PhaseClock
from svecalign_tpu_torch.utils.torch_setup import resolve_device
from svecalign_tpu_torch.vecalign.deletion import NUM_BINS, DeletionKnob, device_del_penalty
from svecalign_tpu_torch.vecalign.pyramid import (
    DP_BACKENDS,
    alignment_to_search_path,
    extend_alignments,
    upsample_alignment,
)
from svecalign_tpu_torch.vecalign.traceback import (
    dense_alignments_from_steps,
    dense_traceback,
    sparse_alignments_from_steps,
    sparse_traceback,
)

logger = logging.getLogger("vecalign.batch")

Alignment = Tuple[List[int], List[int]]

# the gate lives with the walks (ops.dp); re-exported for callers
device_traceback_enabled = dp_ops.device_traceback_enabled

# the batched pyramid runs on the device: the host 'native' DP is per pair
BATCHED_DP_BACKENDS = tuple(b for b in DP_BACKENDS if b != "native")


# ---------------------------------------------------------------------------
# batched device ops
# ---------------------------------------------------------------------------


def _downsample_masked(vecs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(P, n_overlaps, b, d) -> halved, with per-pair masked mean removal.

    Equivalent to ops.costs.downsample_vectors applied per pair at its true
    length: pairs are summed, the mean is taken over each pair's valid
    halved rows only, and invalid rows are zeroed.
    """
    p, n, b, d = vecs.shape
    half = vecs[:, :, : b - b % 2].reshape(p, n, b // 2, 2, d).sum(dim=3)
    new_sizes = sizes // 2
    row = torch.arange(b // 2, device=vecs.device)
    vmask = (row[None, :] < new_sizes[:, None])[:, None, :, None]  # (P, 1, b//2, 1)
    denom = new_sizes.clamp(min=1).float()[:, None, None, None]
    mean = torch.where(vmask, half, 0.0).sum(dim=2, keepdim=True) / denom
    half = torch.where(vmask, half - mean, 0.0)
    return costs_ops.make_norm1(half) * vmask


def _batched_dense_costs(vecs0, vecs1, norms0, norms1) -> torch.Tensor:
    """ops.costs.dense_costs with a leading pair axis: (P, N, d), (P, M, d),
    (P, N), (P, M) -> (P, N, M)."""
    sim = torch.matmul(vecs0, vecs1.transpose(1, 2))
    denom = 1e-6 + norms0[:, :, None] + norms1[:, None, :]
    return 2.0 * (1.0 - sim) / denom


def _batched_norms_from_sample(vecs0: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """ops.costs.compute_norms_from_sample with a leading pair axis:
    (P, o, N, d) against (P, S, d) -> (P, o, N)."""
    sim = torch.einsum("pond,psd->pons", vecs0, sample)
    return 1.0 - sim.mean(dim=-1)


def _batched_gather_sample(vecs1: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    # vecs1: (P, n_overlaps, b, d); idxs: (P, n_overlaps, s)
    gathered = torch.take_along_dim(vecs1, idxs.long()[:, :, :, None], dim=2)
    return gathered.reshape(vecs1.shape[0], -1, vecs1.shape[-1])


# ---------------------------------------------------------------------------
# device-side sampling (shared mode): uniforms come from generators on the
# device, so nothing but the (P,) size vectors is uploaded per depth
# ---------------------------------------------------------------------------

_ROLE_NORM1, _ROLE_NORM0, _ROLE_KNOB = 0, 1, 2


def _stream(device: torch.device, seed: int, depth: int, role: int) -> torch.Generator:
    """One seeded generator on ``device`` per role and depth (in the place
    of the JAX package's ``fold_in``): a depth's draws do not depend on how
    many other depths drew before it."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + depth * 16 + role) % (2**63))
    return gen


def _draw(device: torch.device, seed: int, depth: int, role: int, shape) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` from the (depth, role) stream."""
    return torch.rand(shape, generator=_stream(device, seed, depth, role), device=device)


def _shared_draws(device, seed: int, max_depth: int, o0: int, o1: int, num_samps_for_norm: int,
                  S: int) -> dict:
    """Every uniform a shared-mode bucket draws, for each depth: the norm
    samples of both sides and the knob's (x, y) pairs. No axis is the
    bucket's: every pair scales the same draws to its own sizes, so a
    pair's draws depend neither on the bucket's size nor on its other
    pairs, and a bucket drawn once before it is split over a mesh equals
    the unsharded one."""
    samps1 = math.ceil(num_samps_for_norm / o1)
    samps0 = math.ceil(num_samps_for_norm / o0)
    out = {}
    for depth in range(max_depth + 1):
        out[depth, _ROLE_NORM1] = _draw(device, seed, depth, _ROLE_NORM1, (o1, samps1))
        out[depth, _ROLE_NORM0] = _draw(device, seed, depth, _ROLE_NORM0, (o0, samps0))
        out[depth, _ROLE_KNOB] = _draw(device, seed, depth, _ROLE_KNOB, (2, S))
    return out


def _uniform_index(u: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Indices in [0, hi) for each pair: (P,) ``hi`` (>= 1) times the
    uniforms ``u`` shared by the pairs -> (P,) + u.shape."""
    hi = hi.reshape(hi.shape + (1,) * u.dim())
    return torch.minimum((u[None] * hi).long(), hi.long() - 1)


def _device_norm_sample(u, vecs1, h_sizes1) -> torch.Tensor:
    """Index every pair's overlap planes with the (o1, samps) uniforms
    ``u`` and gather the sample matrix. Size-0 pairs gather row 0 (zero
    padding -> the compute_norms 'ones' fallback)."""
    idx = _uniform_index(u, h_sizes1.clamp(min=1))
    return _batched_gather_sample(vecs1, idx)


def _device_knob_penalty(u, v0, v1, n0, n1, h0, h1, S: int, frac: float) -> torch.Tensor:
    """Deletion penalties for a bucket with NO index upload: random pair
    draws from the (2, S) uniforms ``u`` (or the exhaustive cross product
    for pairs smaller than the sample budget, reference
    dp_utils.py:278-323) are indexed, scored, histogrammed and
    percentile-interpolated on device."""
    dev = v0.device
    h0, h1 = h0.long(), h1.long()
    hx = h0.clamp(min=1)
    hy = h1.clamp(min=1)
    xs = _uniform_index(u[0], hx)
    ys = _uniform_index(u[1], hy)
    small = (h0 * h1 < S) & (h0 > 0) & (h1 > 0)
    ar = torch.arange(S, device=dev)
    ex_x = torch.minimum(ar[None, :] // hy[:, None], hx[:, None] - 1)
    ex_y = ar[None, :] % hy[:, None]
    x_idx = torch.where(small[:, None], ex_x, xs)
    y_idx = torch.where(small[:, None], ex_y, ys)
    valid_pair = (h0 > 0) & (h1 > 0)
    n_valid = torch.where(valid_pair, torch.where(small, h0 * h1, S), 0)

    counts, smax = _batched_score_hist(v0, v1, n0, n1, x_idx, y_idx, n_valid)
    return device_del_penalty(counts, smax, frac, valid_pair)


def _batched_score_pairs_flat(vecs0, vecs1, norms0, norms1, x_idx, y_idx) -> torch.Tensor:
    """ops.costs.score_pairs with a leading pair axis: (P, n, d), (P, m, d),
    (P, n), (P, m) and (P, S) index pairs -> (P, S) costs."""
    x, y = x_idx.long(), y_idx.long()
    rows0 = torch.take_along_dim(vecs0, x[:, :, None], dim=1)
    rows1 = torch.take_along_dim(vecs1, y[:, :, None], dim=1)
    dots = torch.einsum("psd,psd->ps", rows0, rows1)
    return 2.0 * (1.0 - dots) / (norms0.gather(1, x) + norms1.gather(1, y))


# gathered-row memory cap for the knob sampler: P * s_chunk rows * 1024 fp32
# * 2 sides ~ 1 GB at this budget (the flat gather is P x S x d fp32:
# 5.2 GB a side at P = 64, S = 20000, d = 1024)
_SCORE_GATHER_CELLS = 1 << 17


def _batched_score_pairs(vecs0, vecs1, norms0, norms1, x_idx, y_idx) -> torch.Tensor:
    """The flat version over chunks of the sample axis, so the gathered
    (P, chunk, d) row matrices stay bounded. Per-row arithmetic is
    unchanged, so results equal the flat version exactly."""
    P, S = x_idx.shape
    s_chunk = max(256, _SCORE_GATHER_CELLS // max(P, 1))
    return torch.cat([
        _batched_score_pairs_flat(vecs0, vecs1, norms0, norms1,
                                  x_idx[:, s:s + s_chunk], y_idx[:, s:s + s_chunk])
        for s in range(0, S, s_chunk)
    ], dim=1)


def _batched_score_hist(vecs0, vecs1, norms0, norms1, x_idx, y_idx, n_valid=None):
    """Sampled-cost histograms for the deletion knob, computed on device.

    Returns (counts (P, NUM_BINS) int32, smax (P,)). Binning matches
    np.histogram(range=[0, smax]) (right-closed last bin) up to float
    rounding at bin edges. ``n_valid`` (P,) counts how many leading entries
    of each pair's index row are real (shorter when a small pair enumerates
    its exhaustive cross product); the rest are excluded.
    """
    scores = _batched_score_pairs(vecs0, vecs1, norms0, norms1, x_idx, y_idx)
    dev = scores.device
    if n_valid is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=dev)
    else:
        mask = torch.arange(scores.shape[1], device=dev)[None, :] < n_valid[:, None]
    smax = torch.where(mask, scores, -torch.inf).max(dim=1).values.clamp(min=0.0)  # (P,)
    scale = torch.where(smax > 0, NUM_BINS / smax, 0.0)
    bins = torch.floor(scores * scale[:, None]).long().clamp(0, NUM_BINS - 1)
    counts = torch.zeros((scores.shape[0], NUM_BINS), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, bins, mask.to(torch.int32))
    return counts, smax


def _batched_banded_costs(
    v0, v1, n0, n1, boff_in: np.ndarray, path_lens: Sequence[int],
    h_sizes0: np.ndarray, h_sizes1: np.ndarray,
    x_offsets, y_offsets, width_over2: int, chunk: int = 512,
) -> torch.Tensor:
    """Banded costs of a bucket: (P, T, a_pad, B), +inf past each pair's own
    path. One ops.costs.banded_costs call per pair on the pair's true
    sizes and its own path's offsets (``boff_in[i, :path_lens[i]]``, host
    ints: the windows are cut with them), so every block equals the
    per-pair path's by construction."""
    P, a_pad = boff_in.shape
    out = torch.full(
        (P, len(x_offsets), a_pad, 2 * width_over2), torch.inf,
        dtype=torch.float32, device=v0.device,
    )
    for i in range(P):
        s0, s1, a_len = int(h_sizes0[i]), int(h_sizes1[i]), int(path_lens[i])
        out[i, :, :a_len] = costs_ops.banded_costs(
            v0[i, :, :s0], v1[i, :, :s1], n0[i, :, :s0], n1[i, :, :s1],
            boff_in[i, :a_len], x_offsets, y_offsets, width_over2, chunk=chunk,
        )
    return out


# anti-diagonals per windowed cost tile, in both sampling modes: the
# per-pair aligner's chunk, so a pair's banded costs are the per-pair
# path's, whatever its bucket. (The JAX package takes 4096 / P in shared
# mode: there one chunk's tile spans the bucket; here the loop is per pair.)
BANDED_CHUNK = 512


def _band_pad(n_level: int, m_level: int) -> int:
    """Band length that bounds every search path of a level padded to
    (n_level, m_level): a unit-step path over an (s0, s1) pair has
    s0 + s1 + 1 nodes, and extend_alignments appends one alignment past
    the level's sizes below the top of a pyramid, which adds two. (The JAX
    package takes n_level + m_level + 1 and fails on a pair whose sizes
    both sit on the shape grid; padding rows change no result.)"""
    return n_level + m_level + 3


def _prep_band_offsets(boff_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upload-once band offsets: the node-space extension (reference
    dp_core.pyx:315-328 — two replicated points at the front, then +1) is
    derived on the device, so only the cost-space offsets are uploaded, once
    per level."""
    b = boff_in.to(torch.int32)
    first = b[:, :1]
    return b, torch.cat([first, first, b + 1], dim=1)


class ShardedBucket(NamedTuple):
    """A bucket staged over a mesh's data axis: ``shards[i]`` is the
    ``(v0, v1, sizes0, sizes1)`` handle of the i-th contiguous slice of
    the pairs, on the i-th data device, padded to the whole bucket's
    shapes."""

    mesh: Mesh
    shards: list


def _pair_mesh(handle):
    """The mesh a staged bucket is sharded over, or None (the JAX
    package's test of a pair-sharded array)."""
    return handle.mesh if isinstance(handle, ShardedBucket) else None


def bucket_shape(handle) -> Tuple[int, int, int]:
    """(pairs, padded source segments, padded target segments) of a
    staged bucket, sharded or not."""
    shards = handle.shards if isinstance(handle, ShardedBucket) else [handle]
    v0, v1 = shards[0][0], shards[0][1]
    return sum(h[0].shape[0] for h in shards), v0.shape[2], v1.shape[2]


def sync_staged(handle) -> None:
    """Wait for a staged bucket's device work (the stage phase's end)."""
    shards = handle.shards if isinstance(handle, ShardedBucket) else [handle]
    for h in shards:
        if h[0].is_cuda:
            torch.cuda.synchronize(h[0].device)


def _run_batched_banded_dp(
    costs, boff_in, boff_out, x_offsets, y_offsets, pens, xs, ys,
    dp_backend: str = "auto",
):
    """Banded DP for a bucket, one launch: the CUDA kernel on the card, the
    plain loop on the CPU, by the rule of ``pyramid.pick_banded_dp``. The
    host 'native' backend is per pair only."""
    if dp_backend not in BATCHED_DP_BACKENDS:
        raise ValueError(f"dp_backend must be one of {BATCHED_DP_BACKENDS}, got {dp_backend!r}")
    dev = costs.device
    if dp_backend == "auto":
        dp_backend = "cuda" if dev.type == "cuda" else "torch"
    if dp_backend == "cuda":
        if dev.type != "cuda":
            raise ValueError("dp_backend 'cuda' runs on the card: use device='cuda'")
        fn = dp_cuda.banded_dp_cuda_batched
    else:
        fn = dp_ops.banded_dp_batched
    return fn(costs.contiguous(), boff_in, boff_out, x_offsets, y_offsets, pens, xs, ys)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def _gather_overlaps(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(P, rows, d) fp32 rows + (P, n_overlaps, n) row ids (-1 = zero) ->
    (P, n_overlaps, n, d) normalized overlap tensors."""
    P, o, n = ids.shape
    flat = ids.clamp(min=0).long().reshape(P, o * n, 1)
    gathered = torch.take_along_dim(emb, flat, dim=1).reshape(P, o, n, emb.shape[-1])
    vecs = torch.where((ids >= 0)[:, :, :, None], gathered, 0.0)
    return costs_ops.make_norm1(vecs)


def _build_doc_tensors_q(emb_i8: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor):
    """int8 variant: (P, rows, d) int8 + (P, rows) fp32 per-row scales,
    half the fp16 upload. NaN rows were mapped to scale 0 on the host, so
    they dequantize to zero vectors."""
    return _gather_overlaps(emb_i8.float() * scale[:, :, None], ids)


def _quantize_rows(emb: np.ndarray):
    """Per-row symmetric int8 quantization; NaN rows -> scale 0 (zero vector
    on device, the reference's NaN semantics, embedding_utils.py:183-190)."""
    m = np.abs(emb.astype(np.float32, copy=False)).max(axis=-1)
    m = np.where(np.isnan(m), 0.0, m)
    scale = (m / 127.0).astype(np.float32)
    denom = np.where(scale == 0.0, 1.0, scale)[..., None]
    with np.errstate(invalid="ignore"):
        q = np.rint(emb.astype(np.float32) / denom)
        q = np.where(np.isnan(q), 0.0, np.clip(q, -127, 127)).astype(np.int8)
    return q, scale


def _quantize_rows4(emb: np.ndarray):
    """Per-row symmetric int4 quantization, two codes packed per byte —
    quarter of the fp16 upload. Codes in [-7, 7]; NaN rows -> scale 0.

    Packing is HALF-BLOCK, not interleaved: byte j holds columns j (low
    nibble) and j + d/2 (high nibble), so the device unpack is two
    contiguous halves concatenated."""
    m = np.abs(emb.astype(np.float32, copy=False)).max(axis=-1)
    m = np.where(np.isnan(m), 0.0, m)
    scale = (m / 7.0).astype(np.float32)
    denom = np.where(scale == 0.0, 1.0, scale)[..., None]
    with np.errstate(invalid="ignore"):
        q = np.rint(emb.astype(np.float32) / denom)
        q = np.where(np.isnan(q), 0.0, np.clip(q, -7, 7)).astype(np.int8)
    half = q.shape[-1] // 2
    lo = q[..., :half] & 0xF
    hi = (q[..., half:] & 0xF) << 4
    return (lo | hi).astype(np.int8), scale


def _build_doc_tensors_q4(packed: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor):
    """int4 variant of _build_doc_tensors_q: unpack two nibbles per byte
    (arithmetic shifts sign-extend), dequantize, gather, normalize."""
    lo = (packed << 4) >> 4  # low nibble, sign-extended int8
    hi = packed >> 4  # high nibble (arithmetic shift keeps sign)
    q = torch.cat([lo, hi], dim=-1)  # half-block layout
    return _gather_overlaps(q.float() * scale[:, :, None], ids)


def _build_doc_tensors_flat(bank: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """(R, d) fp16 document bank + (P, n_overlaps, n) bank row ids (-1 =
    zero row) -> (P, n_overlaps, n, d) fp32 normalized overlap tensors.

    Gather first: rows are picked in fp16 and only the gathered block is
    cast to fp32 (the JAX package's fp32 cast of whole per-pair stacks was
    its out-of-memory at ``--pair_batch 128``). NaN rows zero after the
    gather, so the result equals :func:`_build_doc_tensors` on the same
    rows bit for bit."""
    g = bank[gids.clamp(min=0).long()].float()
    g = torch.where(torch.isnan(g).any(dim=-1, keepdim=True), 0.0, g)
    vecs = torch.where((gids >= 0)[:, :, :, None], g, 0.0)
    return costs_ops.make_norm1(vecs)


def _build_doc_tensors(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(P, rows, d) raw embeddings + (P, n_overlaps, n) row ids (-1 = zero)
    -> (P, n_overlaps, n, d) fp32 normalized overlap tensors, on device.

    NaN rows zero out here (reference embedding_utils.py:183-190) so the
    host staging path never has to scan the fp16 rows."""
    emb = emb.float()
    emb = torch.where(torch.isnan(emb).any(dim=-1, keepdim=True), 0.0, emb)
    return _gather_overlaps(emb, ids)


upload_stats = {"bytes": 0, "buckets": 0, "level_bytes": 0}
"""Cumulative host->device staging bytes. ``bytes`` = bucket staging
(embeddings/ids/scales); ``level_bytes`` = the per-refinement-level
band-offset uploads."""

pull_stats = {"plane_bytes": 0, "step_bytes": 0}
"""Cumulative device->host traceback bytes: whole DP planes (host walks)
and walked paths (device walks)."""

phase_seconds = {}
"""With SVECALIGN_ALIGN_PROFILE=1: cumulative wall seconds of the batched
pyramid by phase, the device synchronised at each phase's end (summed over
the shards of a sharded bucket)."""



def shape_grid_mode() -> str:
    """Padded-shape bucketing mode (SVECALIGN_SHAPE_GRID env var).

    Rounding the padded doc dims up to a coarse grid (floor 64) and
    deriving the band length from the padded dims (instead of the
    data-dependent longest search path) gives same-class buckets the same
    shapes. All batched compute is masked by the per-pair true sizes, so
    extra padding never changes valid cells; the one semantic shift is
    that pyramid depth follows the gridded dims, so a pair's level count
    depends on its size class rather than on its bucket-mates' exact
    sizes. The default is kept from the JAX package so that both give the
    same results.

    - ``"0"`` / ``"off"``: exact bucket-max padding;
    - ``"pow2"``: next power of two;
    - ``"quarter"``: next multiple of pow2/8 — 4 grid points per octave;
    - ``"eighth"``: next multiple of pow2/16 — 8 points per octave;
    - ``"1"``: the default mode (``eighth``).
    """
    v = os.environ.get("SVECALIGN_SHAPE_GRID", "1")
    if v in ("0", "off"):
        return "off"
    if v == "1":
        return "eighth"
    return v


def _grid_dim(n: int, floor: int = 64) -> int:
    """Round up to the active grid (see :func:`shape_grid_mode`)."""
    n = max(int(n), floor)
    p = 1 << (n - 1).bit_length()  # next pow2 >= n
    mode = shape_grid_mode()
    if mode == "pow2":
        return p
    step = p // (8 if mode == "quarter" else 16)
    return -(-n // step) * step


def _grid_rows(r: int) -> int:
    """Embedding-row counts round to multiples of 256: they are upload
    bytes, so <=256 rows of zero padding (~0.5 MB fp16) beat the doc-dim
    grid's inflation."""
    return -(-int(r) // 256) * 256


def _pad_id_maps(pairs):
    """Pad each pair's (ids0, ids1) overlap-id maps to one
    (P, n_over, n_pad) int32 block (-1 = PAD) and collect the per-pair true
    sizes."""
    P = len(pairs)
    assert P > 0
    n_over0 = pairs[0][1].shape[0]
    n_over1 = pairs[0][3].shape[0]
    n_pad = max(p[1].shape[1] for p in pairs)
    m_pad = max(p[3].shape[1] for p in pairs)
    if shape_grid_mode() != "off":
        n_pad, m_pad = _grid_dim(n_pad), _grid_dim(m_pad)
    ids0 = np.full((P, n_over0, n_pad), -1, dtype=np.int32)
    ids1 = np.full((P, n_over1, m_pad), -1, dtype=np.int32)
    for i, (_, i0, _, i1) in enumerate(pairs):
        ids0[i, :, : i0.shape[1]] = i0
        ids1[i, :, : i1.shape[1]] = i1
    sizes0 = np.array([p[1].shape[1] for p in pairs], dtype=np.int32)
    sizes1 = np.array([p[3].shape[1] for p in pairs], dtype=np.int32)
    return ids0, ids1, sizes0, sizes1


def _check_sharding(sharding, n_pairs: int):
    if not isinstance(sharding, Sharding) or not sharding.batch:
        raise TypeError("sharding must be parallel.mesh.batch_sharding(mesh)")
    return shard_slices(n_pairs, sharding.mesh)  # raises unless P splits evenly


def stage_rows_upload(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    quantize=False,
    device="cuda",
    sharding=None,
):
    """Pad a bucket of (emb_rows0, ids0, emb_rows1, ids1) pairs, upload it
    to ``device`` and build the overlap tensors there. Returns an opaque
    handle for :func:`run_staged`.

    ``quantize``: False/"fp16" uploads the raw dtype; True/"int8" per-row
    symmetric int8 (+ fp32 scales) — half the fp16 bytes, ~0.3% cosine
    noise; "int4" packs two codes per byte — quarter of fp16, ~2% cosine
    noise.

    ``sharding``: ``parallel.mesh.batch_sharding(mesh)`` splits the pairs
    over the mesh's data axis (``len(pairs)`` must divide evenly): each
    shard's rows travel straight to its device, padded to the whole
    bucket's shapes, and ``device`` is not used."""
    if sharding is not None:
        slices = _check_sharding(sharding, len(pairs))
        padded = _pad_bucket_rows(pairs)
        devs = sharding.mesh.data_devices
        shards = [_upload_padded(tuple(a[sl] for a in padded), quantize, d)
                  for sl, d in zip(slices, devs)]
        handle = ShardedBucket(sharding.mesh, shards)
    else:
        handle = _upload_padded(_pad_bucket_rows(pairs), quantize, resolve_device(device))
    upload_stats["buckets"] += 1
    return handle


def _pad_bucket_rows(pairs):
    """The host side of :func:`stage_rows_upload`: (emb0, emb1, ids0, ids1,
    sizes0, sizes1), each with a leading pair axis, padded to the bucket's
    (gridded) shapes."""
    P = len(pairs)
    dim = pairs[0][0].shape[1]
    in_dtype = pairs[0][0].dtype

    r0 = max(p[0].shape[0] for p in pairs)
    r1 = max(p[2].shape[0] for p in pairs)
    if shape_grid_mode() != "off":
        r0, r1 = _grid_rows(r0), _grid_rows(r1)
    ids0, ids1, sizes0, sizes1 = _pad_id_maps(pairs)

    emb0 = np.zeros((P, r0, dim), dtype=in_dtype)
    emb1 = np.zeros((P, r1, dim), dtype=in_dtype)
    for i, (e0, _, e1, _) in enumerate(pairs):
        # NaN rows are zeroed on device in _build_doc_tensors
        emb0[i, : e0.shape[0]] = e0
        emb1[i, : e1.shape[0]] = e1
    return emb0, emb1, ids0, ids1, sizes0, sizes1


def _upload_padded(padded, quantize, dev: torch.device):
    """Upload one padded bucket (or shard of one) to ``dev`` and build its
    overlap tensors there; counts the bytes in ``upload_stats``."""
    emb0, emb1, ids0, ids1, sizes0, sizes1 = padded
    mode = {False: "fp16", True: "int8"}.get(quantize, quantize)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if mode in ("int4", "int8"):
        quant, build = {
            "int4": (_quantize_rows4, _build_doc_tensors_q4),
            "int8": (_quantize_rows, _build_doc_tensors_q),
        }[mode]
        q0, s0 = quant(emb0)
        q1, s1 = quant(emb1)
        v0 = build(put(q0), put(s0), put(ids0))
        v1 = build(put(q1), put(s1), put(ids1))
        staged = (q0, s0, q1, s1, ids0, ids1)
    elif mode == "fp16":
        v0 = _build_doc_tensors(put(emb0), put(ids0))
        v1 = _build_doc_tensors(put(emb1), put(ids1))
        staged = (emb0, emb1, ids0, ids1)
    else:
        raise ValueError(f"quantize must be fp16, int8 or int4, got {quantize!r}")
    upload_stats["bytes"] += sum(a.nbytes for a in staged)
    return (v0, v1, sizes0, sizes1)


def stage_rows_device(pairs, sharding=None):
    """The fused pipeline's staging: each pair is (rows0, ids0, rows1,
    ids1), where the rows are the (embed_cache.max_rows, d) fp16 tensors
    the embed stage left on the device (``utils/embed_cache.py``). Only
    the id maps are uploaded; ``upload_stats`` counts them alone.

    The pairs' documents are deduplicated (by identity) into one fp16 bank,
    so a document in several pairs is stored once; the id maps are rebased
    to bank rows and the overlap tensors gathered from the bank in fp16
    (:func:`_build_doc_tensors_flat`). The JAX package pads the bank's
    document count to a power of two, an XLA shape rule; here the bank
    holds the distinct documents only.

    ``sharding`` (``parallel.mesh.batch_sharding(mesh)``): the pairs split
    over the mesh's data axis as in :func:`stage_rows_upload`, and each
    shard's bank holds the documents of its own pairs, copied from the
    device that caches them to the shard's device. (The JAX package
    replicates the whole bank on every device.)"""
    ids0, ids1, sizes0, sizes1 = _pad_id_maps(pairs)
    if sharding is None:
        handle = _stage_bank(pairs, ids0, ids1, sizes0, sizes1, None)
    else:
        slices = _check_sharding(sharding, len(pairs))
        handle = ShardedBucket(sharding.mesh, [
            _stage_bank(pairs[sl], ids0[sl], ids1[sl], sizes0[sl], sizes1[sl], dev)
            for sl, dev in zip(slices, sharding.mesh.data_devices)])
    upload_stats["buckets"] += 1
    return handle


def _stage_bank(pairs, ids0, ids1, sizes0, sizes1, device):
    """One device's part of :func:`stage_rows_device`: the bank of the
    pairs' distinct documents on ``device`` (None: where they are cached),
    and the overlap tensors gathered from it."""
    slot_of, unique = {}, []
    for p in pairs:
        for rows in (p[0], p[2]):
            if id(rows) not in slot_of:
                slot_of[id(rows)] = len(unique)
                unique.append(rows)
    first = unique[0]
    if any((u.shape, u.dtype, u.device) != (first.shape, first.dtype, first.device)
           for u in unique):
        raise ValueError("the cached rows must share one (max_rows, dim) shape, dtype "
                         "and device")
    rows = first.shape[0]
    bank = torch.cat(unique) if len(unique) > 1 else first
    if device is not None:
        bank = bank.to(device)

    slot0 = np.array([slot_of[id(p[0])] for p in pairs], np.int32)
    slot1 = np.array([slot_of[id(p[2])] for p in pairs], np.int32)
    gids0 = np.where(ids0 >= 0, ids0 + slot0[:, None, None] * rows, -1).astype(np.int32)
    gids1 = np.where(ids1 >= 0, ids1 + slot1[:, None, None] * rows, -1).astype(np.int32)
    v0 = _build_doc_tensors_flat(bank, torch.from_numpy(gids0).to(bank.device))
    v1 = _build_doc_tensors_flat(bank, torch.from_numpy(gids1).to(bank.device))
    upload_stats["bytes"] += gids0.nbytes + gids1.nbytes
    return (v0, v1, sizes0, sizes1)


def run_staged(handle, **kwargs) -> List[Tuple[List[Alignment], np.ndarray]]:
    """Run the batched pyramid on a bucket staged by stage_rows_upload or
    stage_rows_device. A sharded bucket runs each shard's pyramid on its
    device, shard after shard, and returns every pair's result in pair
    order."""
    if not isinstance(handle, ShardedBucket):
        v0, v1, sizes0, sizes1 = handle
        return _vecalign_batched_core(v0, v1, sizes0, sizes1, **kwargs)
    draws = None
    if kwargs.get("sampling", "shared") == "shared":
        # drawn once, before the split, on the first shard's device
        v0, v1 = handle.shards[0][0], handle.shards[0][1]
        draws = _shared_draws(
            v0.device, kwargs.get("seed", 42), _max_depth(v0, v1, kwargs["max_size_full_dp"]),
            v0.shape[1], v1.shape[1], kwargs["num_samps_for_norm"], kwargs["costs_sample_size"])

    def run(_, dev, shard):
        v0, v1, sizes0, sizes1 = shard
        mine = None if draws is None else {key: u.to(dev) for key, u in draws.items()}
        return _vecalign_batched_core(v0, v1, sizes0, sizes1, draws=mine, **kwargs)

    return [r for part in run_on_shards(handle.mesh, run, handle.shards) for r in part]


def vecalign_batched_from_rows(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    quantize=False,
    device="cuda",
    **kwargs,
) -> List[Tuple[List[Alignment], np.ndarray]]:
    """Like :func:`vecalign_batched`, but each pair is
    (emb_rows0 (r0, d), ids0 (n_overlaps, n0), emb_rows1, ids1) — raw
    embedding rows (any float dtype) plus make_doc_ids index maps. The
    overlap tensors are gathered and normalized on device.
    """
    return run_staged(stage_rows_upload(pairs, quantize=quantize, device=device), **kwargs)


def vecalign_batched(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    final_alignment_types: List[Tuple[int, int]],
    del_percentile_frac: float,
    width_over2: int,
    max_size_full_dp: int,
    costs_sample_size: int,
    num_samps_for_norm: int,
    seed: int = 42,
    sampling: str = "shared",
    dp_backend: str = "auto",
    device="cuda",
) -> List[Tuple[List[Alignment], np.ndarray]]:
    """Align a bucket of document pairs in one batched pyramid on
    ``device`` (the card unless "cpu" is asked for).

    pairs: [(vecs0, vecs1)] overlap tensors, (n_overlaps, n_i, dim) each;
    n_overlaps and dim must agree across the bucket (pad counts differ).
    Returns [(final_alignments, alignment_scores)] per pair.
    """
    dev = resolve_device(device)
    P = len(pairs)
    assert P > 0

    n_over0 = pairs[0][0].shape[0]
    n_over1 = pairs[0][1].shape[0]
    dim = pairs[0][0].shape[2]
    sizes0 = np.array([v0.shape[1] for v0, _ in pairs], dtype=np.int32)
    sizes1 = np.array([v1.shape[1] for _, v1 in pairs], dtype=np.int32)
    n_pad = int(sizes0.max())
    m_pad = int(sizes1.max())
    if shape_grid_mode() != "off":
        n_pad, m_pad = _grid_dim(n_pad), _grid_dim(m_pad)

    # pad in the pairs' own dtype (fp16 halves the upload); upcast on device
    in_dtype = pairs[0][0].dtype
    v0 = np.zeros((P, n_over0, n_pad, dim), dtype=in_dtype)
    v1 = np.zeros((P, n_over1, m_pad, dim), dtype=in_dtype)
    for i, (a, b) in enumerate(pairs):
        v0[i, :, : a.shape[1]] = a
        v1[i, :, : b.shape[1]] = b

    # normalize; padding rows stay zero (zero norm -> zero vector)
    v0 = costs_ops.upcast_norm1(torch.from_numpy(v0).to(dev))
    v1 = costs_ops.upcast_norm1(torch.from_numpy(v1).to(dev))
    return _vecalign_batched_core(
        v0, v1, sizes0, sizes1,
        final_alignment_types=final_alignment_types,
        del_percentile_frac=del_percentile_frac,
        width_over2=width_over2,
        max_size_full_dp=max_size_full_dp,
        costs_sample_size=costs_sample_size,
        num_samps_for_norm=num_samps_for_norm,
        seed=seed,
        sampling=sampling,
        dp_backend=dp_backend,
    )


def _pull(tensors, kind: str):
    """One device->host pull of several tensors, counted in pull_stats."""
    out = [t.cpu().numpy() for t in tensors]
    pull_stats[kind] += sum(a.nbytes for a in out)
    return out


def _max_depth(v0: torch.Tensor, v1: torch.Tensor, max_size_full_dp: int) -> int:
    """The bucket's pyramid depth, from its padded shapes."""
    s0, s1 = v0.shape[2], v1.shape[2]
    depth = 0
    while s0 * s1 > max_size_full_dp**2:
        depth += 1
        s0 //= 2
        s1 //= 2
    return depth


def _vecalign_batched_core(
    v0: torch.Tensor,
    v1: torch.Tensor,
    sizes0: np.ndarray,
    sizes1: np.ndarray,
    final_alignment_types: List[Tuple[int, int]],
    del_percentile_frac: float,
    width_over2: int,
    max_size_full_dp: int,
    costs_sample_size: int,
    num_samps_for_norm: int,
    seed: int = 42,
    sampling: str = "shared",
    dp_backend: str = "auto",
    draws=None,
) -> List[Tuple[List[Alignment], np.ndarray]]:
    """Shared pyramid over device-resident normalized (P, o, n, d) tensors.
    ``draws``: shared mode's uniforms (:func:`_shared_draws`), when the
    caller drew them for a bucket it split; else they are drawn here."""
    if sampling not in ("shared", "paired"):
        raise ValueError(f"sampling must be 'shared' or 'paired', got {sampling!r}")
    if width_over2 < 3:
        width_over2 = 3
    dev = v0.device
    P = v0.shape[0]
    clock = PhaseClock(dev, phase_seconds, "SVECALIGN_ALIGN_PROFILE")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # shared pyramid depth from the padded shapes
    max_depth = _max_depth(v0, v1, max_size_full_dp)

    # sizes live twice: numpy for host bookkeeping (traceback bounds, paired
    # draws) and ONE device copy per side reused by every level
    d_sizes0 = put(sizes0.astype(np.int32))
    d_sizes1 = put(sizes1.astype(np.int32))
    stack = {0: {"v0": v0, "v1": v1, "h_sizes0": sizes0, "h_sizes1": sizes1,
                 "d_sizes0": d_sizes0, "d_sizes1": d_sizes1}}
    for depth in range(1, max_depth + 1):
        prev = stack[depth - 1]
        stack[depth] = {
            "v0": _downsample_masked(prev["v0"], prev["d_sizes0"]),
            "v1": _downsample_masked(prev["v1"], prev["d_sizes1"]),
            "h_sizes0": prev["h_sizes0"] // 2,
            "h_sizes1": prev["h_sizes1"] // 2,
            "d_sizes0": prev["d_sizes0"] // 2,
            "d_sizes1": prev["d_sizes1"] // 2,
        }
    clock.mark("downsample")

    paired = sampling == "paired"
    pair_rngs = [np.random.default_rng(seed) for _ in range(P)] if paired else None
    if not paired and draws is None:
        draws = _shared_draws(dev, seed, max_depth, v0.shape[1], v1.shape[1],
                              num_samps_for_norm, costs_sample_size)

    # margin normalizers for every depth BEFORE any knob draw (the per-pair
    # aligner's order, so "paired" RNG streams line up with pyramid.vecalign)
    for depth in sorted(stack):
        e = stack[depth]
        e["alignment_types"] = final_alignment_types if depth == 0 else [(1, 1)]
        h_sizes0 = e["h_sizes0"]
        h_sizes1 = e["h_sizes1"]
        o0, o1 = e["v0"].shape[1], e["v1"].shape[1]
        samps1 = math.ceil(num_samps_for_norm / o1)
        samps0 = math.ceil(num_samps_for_norm / o0)

        if paired:
            # per-pair host streams; a size-0 pair draws nothing (its
            # gathered rows are zero, so the normalizers land on
            # compute_norms' "ones" fallback exactly)
            idx1 = np.zeros((P, o1, samps1), dtype=np.int32)
            idx0 = np.zeros((P, o0, samps0), dtype=np.int32)
            for i in range(P):
                if h_sizes1[i] > 0 and samps1:
                    idx1[i] = pair_rngs[i].integers(0, h_sizes1[i], size=(o1, samps1))
                if h_sizes0[i] > 0 and samps0:
                    idx0[i] = pair_rngs[i].integers(0, h_sizes0[i], size=(o0, samps0))
            sample1 = _batched_gather_sample(e["v1"], put(idx1))
            sample0 = _batched_gather_sample(e["v0"], put(idx0))
        else:
            # shared mode: the indices come from device uniforms — no upload
            sample1 = _device_norm_sample(draws[depth, _ROLE_NORM1], e["v1"], e["d_sizes1"])
            sample0 = _device_norm_sample(draws[depth, _ROLE_NORM0], e["v0"], e["d_sizes0"])
        e["n0"] = _batched_norms_from_sample(e["v0"], sample1)
        e["n1"] = _batched_norms_from_sample(e["v1"], sample0)
    clock.mark("norms")

    # deletion penalties per depth; pairs smaller than the sample budget use
    # the exhaustive index cross product (reference dp_utils.py:278-323's
    # small-problem branch), masked on device
    for depth in sorted(stack):
        e = stack[depth]
        h_sizes0 = e["h_sizes0"]
        h_sizes1 = e["h_sizes1"]
        S = costs_sample_size

        if paired:
            # host draws (pair-RNG order) + host knob, bit-matching
            # make_del_knob / DeletionKnob
            x_idx = np.zeros((P, S), dtype=np.int32)
            y_idx = np.zeros((P, S), dtype=np.int32)
            n_valid = np.zeros(P, dtype=np.int32)
            for i in range(P):
                e_size, f_size = int(h_sizes0[i]), int(h_sizes1[i])
                r = pair_rngs[i]
                if e_size > 0 and f_size > 0 and S > 0:
                    if e_size * f_size < S:
                        xi, yi = np.meshgrid(
                            np.arange(e_size, dtype=np.int32),
                            np.arange(f_size, dtype=np.int32),
                            indexing="ij",
                        )
                        n = e_size * f_size
                        x_idx[i, :n] = xi.ravel()
                        y_idx[i, :n] = yi.ravel()
                        n_valid[i] = n
                    else:
                        x_idx[i] = r.integers(0, e_size, size=S).astype(np.int32)
                        y_idx[i] = r.integers(0, f_size, size=S).astype(np.int32)
                        n_valid[i] = S

            scores = _batched_score_pairs(
                e["v0"][:, 0], e["v1"][:, 0], e["n0"][:, 0], e["n1"][:, 0],
                put(x_idx), put(y_idx),
            ).cpu().numpy().astype(np.float32)
            pens = np.empty(P, dtype=np.float32)
            for i in range(P):
                if n_valid[i]:
                    samp = scores[i, : n_valid[i]]
                    knob = DeletionKnob(samp, 0, float(samp.max()))
                else:
                    knob = DeletionKnob(np.array([0.0, 0.5, 1.0]), 0, 1)
                pens[i] = knob.percentile_frac_to_del_penalty(del_percentile_frac)
            e["del_penalty"] = put(pens)
        else:
            # fully on device: draws -> scores -> histogram -> percentile
            e["del_penalty"] = _device_knob_penalty(
                draws[depth, _ROLE_KNOB],
                e["v0"][:, 0], e["v1"][:, 0], e["n0"][:, 0], e["n1"][:, 0],
                e["d_sizes0"], e["d_sizes1"],
                S=S, frac=del_percentile_frac,
            )
    clock.mark("penalties")

    # dense level
    top = stack[max_depth]
    device_tb = device_traceback_enabled(device=dev)
    costs = _batched_dense_costs(
        top["v0"][:, 0], top["v1"][:, 0], top["n0"][:, 0], top["n1"][:, 0]
    )
    clock.mark("dense costs")
    _, bp = dense_dp_cuda.dense_dp_cuda(
        costs.contiguous(), top["del_penalty"], top["d_sizes0"], top["d_sizes1"]
    )
    clock.mark("dense dp")
    if device_tb:
        # the bp planes never leave the device; only the path steps do
        steps = traceback_cuda.dense_traceback_walk_cuda(bp, top["d_sizes0"], top["d_sizes1"])
        sxs, sys_, svs = _pull(steps, "step_bytes")
        top["alignments"] = [
            dense_alignments_from_steps(sxs[i], sys_[i], svs[i]) for i in range(P)
        ]
    else:
        (bp_h,) = _pull((bp,), "plane_bytes")
        top["alignments"] = [
            dense_traceback(bp_h[i][: top["h_sizes0"][i] + 1, : top["h_sizes1"][i] + 1])
            for i in range(P)
        ]
    clock.mark("dense traceback")

    # refinement levels
    upsample_depths = [0] if max_depth == 0 else list(reversed(range(0, max_depth)))
    for depth in upsample_depths:
        e = stack[depth]
        types = e["alignment_types"]
        x_offsets = tuple(x for x, _ in types)
        y_offsets = tuple(y for _, y in types)

        paths = []
        for i in range(P):
            if max_depth > 0:
                coarse = upsample_alignment(stack[depth + 1]["alignments"][i])
                extend_alignments(coarse, int(e["h_sizes0"][i]), int(e["h_sizes1"][i]))
            else:
                coarse = stack[0]["alignments"][i]
            paths.append(alignment_to_search_path(coarse))

        # band length from the shapes (not the data), so the banded levels'
        # shapes are the same across buckets of a class
        if shape_grid_mode() != "off":
            a_pad = _band_pad(e["v0"].shape[2], e["v1"].shape[2])
        else:
            a_pad = max(len(p) for p in paths)
        boff_in = np.zeros((P, a_pad), dtype=np.int32)
        for i, path in enumerate(paths):
            bo = costs_ops.path_to_band_offsets(path, width_over2)
            boff_in[i, : len(bo)] = bo
            boff_in[i, len(bo):] = bo[-1]  # replicate; cells are invalid anyway
        # host copy of the node-space extension for sparse_traceback; the
        # device copy is derived on device from the single boff_in upload
        # (unused when the traceback itself runs on device)
        boff_out = None
        if not device_tb:
            boff_out = np.stack(
                [dp_ops.extend_band_offsets(boff_in[i]) for i in range(P)]
            )
        upload_stats["level_bytes"] += boff_in.nbytes
        d_boff_in, d_boff_out = _prep_band_offsets(put(boff_in))
        clock.mark("search paths")

        band_costs = _batched_banded_costs(
            e["v0"], e["v1"], e["n0"], e["n1"], boff_in, [len(p) for p in paths],
            e["h_sizes0"], e["h_sizes1"], x_offsets, y_offsets, width_over2,
            chunk=BANDED_CHUNK,
        )
        clock.mark("banded costs")
        csum, xp, yp = _run_batched_banded_dp(
            band_costs, d_boff_in, d_boff_out, x_offsets, y_offsets,
            e["del_penalty"], e["d_sizes0"], e["d_sizes1"], dp_backend=dp_backend,
        )
        clock.mark("banded dp")
        e["alignments"] = []
        e["alignment_scores"] = []
        if device_tb:
            # walk the pointers on device; ONE pull of the visited path
            steps = traceback_cuda.banded_traceback_walk_cuda(
                csum, xp, yp, d_boff_out, e["d_sizes0"], e["d_sizes1"]
            )
            sx_h, sy_h, sxp_h, syp_h, cs_h = _pull(steps, "step_bytes")
            for i in range(P):
                aligns, scores = sparse_alignments_from_steps(
                    sx_h[i], sy_h[i], sxp_h[i], syp_h[i], cs_h[i]
                )
                e["alignments"].append(aligns)
                e["alignment_scores"].append(scores)
        else:
            # ONE pull for the whole bucket
            csum_h, xp_h, yp_h = _pull((csum, xp, yp), "plane_bytes")
            for i in range(P):
                aligns, scores = sparse_traceback(
                    csum_h[i].astype(np.float64),
                    xp_h[i],
                    yp_h[i],
                    boff_out[i],
                    int(e["h_sizes0"][i]),
                    int(e["h_sizes1"][i]),
                )
                e["alignments"].append(aligns)
                e["alignment_scores"].append(scores)
        clock.mark("banded traceback")

    return list(zip(stack[0]["alignments"], stack[0]["alignment_scores"]))
