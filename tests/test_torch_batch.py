"""The port's batched aligner (svecalign_tpu_torch.vecalign.batch) and what
it is built on, against the JAX package on the CPU.

- the plain dense DP of a ragged bucket against ``_batched_dense_bp``
  (bp equal on each pair's rectangle) and the plain traceback walks against
  ``dense_traceback_scan`` / ``banded_traceback_scan`` (every emitted array
  equal); ``*_alignments_from_steps`` against the host tracebacks;
- the batched tensor functions (masked downsampling, score histogram,
  deletion penalty) within rtol 1e-6; histogram counts may move by one
  sample per pair across a bin edge (fp32 products summed in another
  order), which is allowed and counted;
- the staging functions: quantizers bit-equal, ``_build_doc_tensors*``
  within atol 1e-6 with NaN rows zeroed, the shape grid equal in every mode;
- ``vecalign_batched(sampling="paired")``: alignments identical to the JAX
  package's, scores within rtol 1e-5 (fp32 dot products summed in another
  order), with the shape grid on and off, and identical with the walks on
  the device and on the host; shared mode (torch's generator, not
  ``jax.random``'s) is held to the JAX tests' quality gates.

All inputs come from numpy seeds; sizes are small (d = 16-32, n <= 100,
max_size_full_dp = 20-24 forces pyramid levels)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svecalign_tpu.ops import costs as jcosts
from svecalign_tpu.ops import dp as jdp
from svecalign_tpu.vecalign import batch as jbatch
from svecalign_tpu.vecalign import deletion as jdel
from svecalign_tpu.vecalign import traceback as jtb
from svecalign_tpu_torch.ops import dense_dp_cuda, traceback_cuda
from svecalign_tpu_torch.ops import dp as tdp
from svecalign_tpu_torch.vecalign import batch as tbatch
from svecalign_tpu_torch.vecalign import deletion as tdel
from svecalign_tpu_torch.vecalign import pyramid as tpyr
from svecalign_tpu_torch.vecalign import traceback as ttb
from tests.test_dp import _make_path

torch.set_num_threads(1)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# dense DP of a bucket, the walks, the conversions
# ---------------------------------------------------------------------------


H100_SMEM_OPTIN = 232448  # shared memory a block of an H100 may opt in to

RAGGED = [
    [(12, 9), (7, 12), (12, 12)],
    [(1, 5), (30, 1), (1, 1), (30, 41)],
    [(64, 57)],
]


def _dense_bucket(rng, sizes, ties):
    P = len(sizes)
    N, M = max(n for n, _ in sizes), max(m for _, m in sizes)
    costs = rng.uniform(0, 1, (P, N, M)).astype(np.float32)
    pens = rng.uniform(0.1, 0.5, P).astype(np.float32)
    if ties:
        costs, pens = np.round(costs * 4) / 4, np.round(pens * 8) / 8
    xs = np.array([n for n, _ in sizes], np.int32)
    ys = np.array([m for _, m in sizes], np.int32)
    return costs, pens.astype(np.float32), xs, ys


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("sizes", RAGGED)
def test_dense_dp_batched_matches_jax_bucket(sizes, ties):
    rng = np.random.default_rng(len(sizes) + 10 * ties)
    costs, pens, xs, ys = _dense_bucket(rng, sizes, ties)
    # the JAX bucket computes every padded plane whole; a pair's rectangle
    # reads nothing outside it, so the rectangles must agree
    want = jbatch._batched_dense_bp(jnp.asarray(costs), jnp.asarray(pens))
    csum, bp = tdp.dense_dp_batched(_t(costs), _t(pens), _t(xs), _t(ys))
    assert bp.dtype == torch.int8 and bp.shape == want.shape
    for p, (n, m) in enumerate(sizes):
        # a pair smaller than the bucket: its own DP, on its own costs
        own = jdp.dense_dp_bp(jnp.asarray(costs[p, :n, :m]), jnp.float32(pens[p]))
        np.testing.assert_array_equal(bp[p, :n + 1, :m + 1].numpy(), own)
        if (n, m) == costs.shape[1:]:
            np.testing.assert_array_equal(bp[p].numpy(), want[p])
        assert (bp[p, n + 1:] == -1).all() and (bp[p, :, m + 1:] == -1).all()
        assert torch.isinf(csum[p, n + 1:]).all() and torch.isinf(csum[p, :, m + 1:]).all()
        assert torch.isfinite(csum[p, :n + 1, :m + 1]).all()


def test_dense_dp_wrapper_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(3)
    args = tuple(_t(a) for a in _dense_bucket(rng, RAGGED[0], True))
    want_csum, want_bp = tdp.dense_dp_batched(*args)
    before = dict(dense_dp_cuda.LAUNCHES)
    none, bp = dense_dp_cuda.dense_dp_cuda(*args)
    csum, bp2 = dense_dp_cuda.dense_dp_cuda(*args, with_csum=True)
    assert dense_dp_cuda.LAUNCHES == before == {"dense_dp": 0}
    assert none is None and torch.equal(bp, want_bp) and torch.equal(bp2, want_bp)
    assert torch.equal(csum, want_csum)


@pytest.mark.parametrize("N,M,n,m", [(300, 275, 300, 275), (1500, 40, 1500, 40), (40, 1500, 7, 900),
                                     (2000, 3000, 5, 5), (1, 1, 1, 1)])
def test_dense_dp_block_threads(N, M, n, m):
    """A block's threads over an N x M bucket holding an n x m pair: a warp
    per strip of 32 x rows rows (ceil(N / 256) rows a lane, at most 2), at
    most 8; strips past the eighth warp go round again (wrap), so every
    shape gets a block."""
    rows, warps, wrap = {
        (300, 275): (2, 5, False),  # 5 strips of 64 rows
        (1500, 40): (2, 8, True),  # 24 strips
        (40, 1500): (1, 2, False),  # 2 strips of 32
        (2000, 3000): (2, 8, True),  # 32 strips
        (1, 1): (1, 1, False),
    }[(N, M)]
    assert n <= N and m <= M
    plan = dense_dp_cuda.dense_dp_plan(N, M, H100_SMEM_OPTIN)
    assert (plan.rows, plan.warps, plan.wrap) == (rows, warps, wrap)
    assert plan.smem_bytes == plan.warps * dense_dp_cuda.warp_smem(plan.rows) <= H100_SMEM_OPTIN


@pytest.mark.parametrize("n,m", [(1, 1), (3, 9), (17, 13), (64, 41)])
def test_dense_walk_matches_jax_scan(n, m):
    rng = np.random.default_rng(n * 100 + m)
    for _ in range(3):
        costs = rng.standard_normal((n, m)).astype(np.float32)
        pen = np.float32(rng.uniform(0.2, 1.5))
        _, bd = jdp.dense_dp_scan(jnp.asarray(costs), jnp.asarray(pen))
        want = jax.jit(jdp.dense_traceback_scan)(bd, jnp.int32(n), jnp.int32(m))
        _, bp = tdp.dense_dp(_t(costs), pen)
        sizes = (_t([n], torch.int32), _t([m], torch.int32))
        got = tdp.dense_traceback_walk(bp[None], *sizes)
        for g, w in zip(got, want):
            assert g.dtype == _t(w).dtype
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        via_wrapper = traceback_cuda.dense_traceback_walk_cuda(bp[None], *sizes)
        assert all(torch.equal(a, b) for a, b in zip(via_wrapper, got))
        steps = [g[0].numpy() for g in got]
        host = ttb.dense_traceback(bp.numpy())
        assert ttb.dense_alignments_from_steps(*steps) == host
        assert host == jtb.dense_traceback(np.asarray(jdp.dense_dp_bp(jnp.asarray(costs), pen)))


def test_dense_walk_of_a_ragged_bucket_matches_jax_scan():
    """Pairs smaller than the planes: the JAX walk runs over planes
    computed whole, the port's over planes that hold -1 outside each
    pair's rectangle; the visited paths are the same."""
    rng = np.random.default_rng(21)
    sizes = [(12, 9), (7, 12), (12, 12), (1, 3)]
    costs, pens, xs, ys = _dense_bucket(rng, sizes, True)
    _, bd = jax.vmap(jdp.dense_dp_scan)(jnp.asarray(costs), jnp.asarray(pens))
    want = jax.vmap(jdp.dense_traceback_scan)(bd, jnp.asarray(xs), jnp.asarray(ys))
    _, bp = tdp.dense_dp_batched(_t(costs), _t(pens), _t(xs), _t(ys))
    got = tdp.dense_traceback_walk(bp, _t(xs), _t(ys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# A 3 x 3 plane the dense DP could write (origin 4, left along row 0, up
# column 0, diag inside), and the faults the dense walk kernel is held to on
# the card: (edits {(x, y): pointer}, start (x_size, y_size), the five steps'
# xs, ys, vs, derived by hand). A cell whose move goes nowhere (a pointer
# outside 0-2, up at row 0, left at column 0, the origin) is repeated to the
# end with its pointer; diag is clamped to up at column 0 and to left at row
# 0; starts are clamped into the plane.
DENSE_PLANE = [[4, 1, 1], [2, 0, 0], [2, 0, 0]]
DENSE_WALK_STEPS = {
    "diag to the origin": ({}, (2, 2), [2, 1, 0, 0, 0], [2, 1, 0, 0, 0], [0, 0, 4, 4, 4]),
    "a pointer of 3": ({(1, 1): 3}, (2, 2), [2, 1, 1, 1, 1], [2, 1, 1, 1, 1], [0, 3, 3, 3, 3]),
    "a pointer of 4 off the origin": ({(1, 1): 4}, (2, 2), [2, 1, 1, 1, 1], [2, 1, 1, 1, 1],
                                      [0, 4, 4, 4, 4]),
    "a pointer of -1": ({(2, 2): 1, (2, 1): -1}, (2, 2), [2, 2, 2, 2, 2], [2, 1, 1, 1, 1],
                        [1, -1, -1, -1, -1]),
    "a pointer of 127": ({(1, 1): 127}, (2, 2), [2, 1, 1, 1, 1], [2, 1, 1, 1, 1],
                         [0, 127, 127, 127, 127]),
    "a pointer of -128": ({(1, 1): -128}, (2, 2), [2, 1, 1, 1, 1], [2, 1, 1, 1, 1],
                          [0, -128, -128, -128, -128]),
    "up at row 0": ({(1, 2): 2, (0, 2): 2}, (1, 2), [1, 0, 0, 0, 0], [2, 2, 2, 2, 2],
                    [2, 2, 2, 2, 2]),
    "left at column 0": ({(2, 1): 1, (2, 0): 1}, (2, 1), [2, 2, 2, 2, 2], [1, 0, 0, 0, 0],
                         [1, 1, 1, 1, 1]),
    "diag at (1, 0)": ({(1, 0): 0}, (2, 0), [2, 1, 0, 0, 0], [0, 0, 0, 0, 0], [2, 0, 4, 4, 4]),
    "diag down column 0, the origin's pointer 7": ({(2, 0): 0, (1, 0): 0, (0, 0): 7}, (2, 0),
                                                   [2, 1, 0, 0, 0], [0, 0, 0, 0, 0],
                                                   [0, 0, 7, 7, 7]),
    "diag along row 0, the origin's pointer 0": ({(0, 2): 0, (0, 1): 0, (0, 0): 0}, (0, 2),
                                                 [0, 0, 0, 0, 0], [2, 1, 0, 0, 0],
                                                 [0, 0, 0, 0, 0]),
    "a start past N and below 0": ({}, (5, -4), [2, 1, 0, 0, 0], [0, 0, 0, 0, 0],
                                   [2, 2, 4, 4, 4]),
    "a start below 0 and past M": ({}, (-1, 9), [0, 0, 0, 0, 0], [2, 1, 0, 0, 0],
                                   [1, 1, 4, 4, 4]),
    "a start at the origin": ({}, (0, 0), [0] * 5, [0] * 5, [4] * 5),
}


@pytest.mark.parametrize("case", list(DENSE_WALK_STEPS))
def test_dense_walk_steps_on_hand_built_planes(case):
    """The plain dense walk (and the wrapper on the CPU) on the faults the
    kernel is held to on the card, against steps derived by hand; in a
    bucket beside an unfaulted pair, which must not change."""
    edits, (x0, y0), xs, ys, vs = DENSE_WALK_STEPS[case]
    plane = torch.tensor([DENSE_PLANE, DENSE_PLANE], dtype=torch.int8)
    for (x, y), v in edits.items():
        plane[1, x, y] = v
    sizes = _t([2, x0], torch.int32), _t([2, y0], torch.int32)
    for walk in (tdp.dense_traceback_walk, traceback_cuda.dense_traceback_walk_cuda):
        got = walk(plane, *sizes)
        assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.int8]
        for g, clean, want in zip(got, ([2, 1, 0, 0, 0], [2, 1, 0, 0, 0], [0, 0, 4, 4, 4]),
                                  (xs, ys, vs)):
            assert g[0].tolist() == clean
            assert g[1].tolist() == want


@pytest.mark.parametrize("seed,n,m,w2,odd", [(5, 30, 26, 4, True), (6, 41, 44, 8, False),
                                             (7, 3, 2, 3, False)])
def test_banded_walk_matches_jax_scan(seed, n, m, w2, odd):
    rng = np.random.default_rng(seed)
    path = _make_path(rng, n, m)
    boff_in = jcosts.path_to_band_offsets(path, w2)
    boff_out = jdp.extend_band_offsets(boff_in)
    types = [(1, 1), (1, 2), (2, 1)]
    B = 2 * w2 + int(odd)
    costs = rng.standard_normal((len(types), len(boff_in), B)).astype(np.float32)
    csum, xp, yp = jdp.banded_dp(
        jnp.asarray(costs), jnp.asarray(boff_in), jnp.asarray(boff_out),
        tuple(x for x, _ in types), tuple(y for _, y in types),
        np.float32(0.8), jnp.int32(n), jnp.int32(m))
    want = jax.jit(jdp.banded_traceback_scan)(
        csum, xp, yp, jnp.asarray(boff_out), jnp.int32(n), jnp.int32(m))
    args = (_t(csum)[None], _t(xp)[None], _t(yp)[None], _t(boff_out)[None],
            _t([n], torch.int32), _t([m], torch.int32))
    got = tdp.banded_traceback_walk(*args)
    for g, w in zip(got, want):
        assert g.dtype == _t(w).dtype
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    before = dict(traceback_cuda.LAUNCHES)
    via_wrapper = traceback_cuda.banded_traceback_walk_cuda(*args)
    assert traceback_cuda.LAUNCHES == before  # a plain run is no launch
    assert all(torch.equal(a, b) for a, b in zip(via_wrapper, got))

    steps = [g[0].numpy() for g in got]
    got_a, got_s = ttb.sparse_alignments_from_steps(*steps)
    host_a, host_s = ttb.sparse_traceback(
        np.asarray(csum).astype(np.float64), np.asarray(xp), np.asarray(yp), boff_out, n, m)
    jax_a, jax_s = jtb.sparse_alignments_from_steps(*(np.asarray(w) for w in want))
    assert got_a == host_a == jax_a
    np.testing.assert_array_equal(got_s, host_s)
    np.testing.assert_array_equal(got_s, jax_s)


def test_from_steps_reject_a_walk_that_never_arrives():
    xs = np.array([3, 3, 3], np.int32)
    with pytest.raises(Exception, match="traceback bug"):
        ttb.dense_alignments_from_steps(xs, xs, np.array([0, 0, 0], np.int8))
    with pytest.raises(Exception, match="traceback bug"):
        ttb.sparse_alignments_from_steps(xs, xs, xs * 0, xs * 0, xs.astype(np.float32))


@pytest.mark.parametrize("value,device,want", [
    ("1", "cpu", True), ("on", "cpu", True), ("true", None, True), ("0", "cuda", False),
    ("off", "cuda", False), ("auto", "cuda", True), ("auto", "cpu", False),
    (None, "cuda", True), (None, None, False),
])
def test_device_traceback_gate(monkeypatch, value, device, want):
    if value is None:
        monkeypatch.delenv("SVECALIGN_DEVICE_TRACEBACK", raising=False)
    else:
        monkeypatch.setenv("SVECALIGN_DEVICE_TRACEBACK", value)
    assert tbatch.device_traceback_enabled(device=device) is want


# ---------------------------------------------------------------------------
# batched tensor functions
# ---------------------------------------------------------------------------


def _unit(rng, *shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return np.array(jcosts.make_norm1(jnp.asarray(v)))


def test_downsample_masked_matches_jax():
    rng = np.random.default_rng(0)
    vecs = _unit(rng, 4, 3, 21, 16)
    sizes = np.array([21, 20, 7, 0], np.int32)
    for p, n in enumerate(sizes):
        vecs[p, :, n:] = 0.0
    want = jbatch._downsample_masked(jnp.asarray(vecs), jnp.asarray(sizes))
    got = tbatch._downsample_masked(_t(vecs), _t(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # a pair at its true length equals the per-pair downsampling
    own = tbatch.costs_ops.downsample_vectors(_t(vecs[1, :, :20]))
    np.testing.assert_allclose(got[1, :, :10].numpy(), own.numpy(), rtol=1e-5, atol=1e-6)


def test_score_hist_matches_jax():
    rng = np.random.default_rng(3)
    v0, v1 = _unit(rng, 2, 40, 32), _unit(rng, 2, 45, 32)
    n0 = rng.uniform(0.8, 1.2, (2, 40)).astype(np.float32)
    n1 = rng.uniform(0.8, 1.2, (2, 45)).astype(np.float32)
    x_idx = rng.integers(0, 40, (2, 5000)).astype(np.int32)
    y_idx = rng.integers(0, 45, (2, 5000)).astype(np.int32)
    n_valid = np.array([5000, 1234], np.int32)
    jargs = [jnp.asarray(a) for a in (v0, v1, n0, n1, x_idx, y_idx)]
    targs = [_t(a) for a in (v0, v1, n0, n1, x_idx, y_idx)]

    want_scores = np.asarray(jbatch._batched_score_pairs(*jargs))
    got_scores = tbatch._batched_score_pairs(*targs).numpy()
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6, atol=1e-7)

    for nv in (None, n_valid):
        want_c, want_m = jbatch._batched_score_hist(*jargs, None if nv is None else jnp.asarray(nv))
        got_c, got_m = tbatch._batched_score_hist(*targs, None if nv is None else _t(nv))
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6)
        assert got_c.dtype == torch.int32
        np.testing.assert_array_equal(got_c.sum(1).numpy(), np.asarray(want_c).sum(1))
        # a score at a bin edge may fall on the other side: at most one
        # sample moved per pair (two counts changed by one)
        moved = np.abs(got_c.numpy() - np.asarray(want_c)).sum(1)
        assert (moved <= 2).all(), moved


def test_score_pairs_chunked_equals_flat(monkeypatch):
    rng = np.random.default_rng(4)
    v0, v1 = _t(_unit(rng, 3, 20, 16)), _t(_unit(rng, 3, 25, 16))
    n0, n1 = torch.ones(3, 20), torch.ones(3, 25)
    x = _t(rng.integers(0, 20, (3, 1000)).astype(np.int32))
    y = _t(rng.integers(0, 25, (3, 1000)).astype(np.int32))
    flat = tbatch._batched_score_pairs_flat(v0, v1, n0, n1, x, y)
    assert torch.equal(tbatch._batched_score_pairs(v0, v1, n0, n1, x, y), flat)  # one chunk
    monkeypatch.setattr(tbatch, "_SCORE_GATHER_CELLS", 3 * 256)  # s_chunk = 256 < S
    assert torch.equal(tbatch._batched_score_pairs(v0, v1, n0, n1, x, y), flat)


@pytest.mark.parametrize("frac", [0.1, 0.2, 0.5, 0.9])
def test_device_del_penalty_matches_jax(frac):
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 100, (3, tdel.NUM_BINS)).astype(np.int32)
    counts[1, :500] = 0  # skewed distribution
    smax = np.array([1.7, 0.9, 0.0], np.float32)  # includes degenerate max = 0
    valid = np.array([True, True, False])
    want = jbatch._batched_del_penalty(
        jnp.asarray(counts), jnp.asarray(smax), frac, jnp.asarray(valid))
    got = tdel.device_del_penalty(_t(counts), _t(smax), frac, _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got[2] == 0.5 and tdel.NUM_BINS == jdel.NUM_BINS
    for i in range(2):  # and the host knob, within a bin width
        host = jdel.DeletionKnob.from_histogram(
            counts[i], 0.0, float(smax[i])).percentile_frac_to_del_penalty(frac)
        assert abs(float(got[i]) - host) <= 2.0 * smax[i] / tdel.NUM_BINS + 1e-6


def test_band_offsets_prep_and_chunk_rule():
    b = np.array([[-3, -3, -2, -1], [0, 1, 1, 2]], np.int32)
    b_in, b_out = tbatch._prep_band_offsets(_t(b))
    want_in, want_out = jbatch._prep_band_offsets(jnp.asarray(b))
    np.testing.assert_array_equal(b_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(b_out.numpy(), np.asarray(want_out))
    assert b_out.dtype == torch.int32
    # the per-pair aligner's chunk in both sampling modes, whatever the
    # bucket's size (JAX's shared mode takes 4096 / P: its tile spans the bucket)
    assert tbatch.BANDED_CHUNK == 512
    assert jbatch._banded_chunk_for_batch(8) == tbatch.BANDED_CHUNK


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def _rows_with_nan(rng, r, d):
    emb = rng.standard_normal((r, d)).astype(np.float16)
    emb[3] = np.nan
    emb[5, 2] = np.nan
    emb[7] = 0
    return emb


@pytest.mark.parametrize("fn", ["_quantize_rows", "_quantize_rows4"])
def test_quantizers_bit_equal(fn):
    emb = _rows_with_nan(np.random.default_rng(1), 40, 32)
    got_q, got_s = getattr(tbatch, fn)(emb[None])
    want_q, want_s = getattr(jbatch, fn)(emb[None])
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("mode", ["fp16", "int8", "int4"])
def test_build_doc_tensors_match_jax(mode):
    rng = np.random.default_rng(2)
    emb = np.stack([_rows_with_nan(rng, 40, 32), _rows_with_nan(rng, 40, 32)])
    ids = rng.integers(-1, 40, (2, 3, 17)).astype(np.int32)
    ids[0, 0, :3] = [3, 5, 7]  # a NaN row, a row with one NaN, a zero row
    if mode == "fp16":
        want = jbatch._build_doc_tensors(jnp.asarray(emb), jnp.asarray(ids))
        got = tbatch._build_doc_tensors(_t(emb), _t(ids))
    else:
        quant = tbatch._quantize_rows if mode == "int8" else tbatch._quantize_rows4
        jbuild = jbatch._build_doc_tensors_q if mode == "int8" else jbatch._build_doc_tensors_q4
        tbuild = tbatch._build_doc_tensors_q if mode == "int8" else tbatch._build_doc_tensors_q4
        q, s = quant(emb)
        want = jbuild(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids))
        got = tbuild(_t(q), _t(s), _t(ids))
    assert got.shape == (2, 3, 17, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert not got[0, 0, :3].any()  # NaN and zero rows come out as zero vectors
    assert not got[_t(ids) < 0].any() and torch.isfinite(got).all()


GRID_MODES = ["0", "off", "1", "pow2", "quarter", "eighth"]


@pytest.mark.parametrize("mode", GRID_MODES)
def test_shape_grid_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", mode)
    assert tbatch.shape_grid_mode() == jbatch.shape_grid_mode()
    assert (tbatch.shape_grid_mode() != "off") == jbatch.shape_grid_enabled()
    for n in (1, 63, 64, 65, 100, 300, 1100, 1200, 1300, 2049, 5000):
        assert tbatch._grid_dim(n) == jbatch._grid_dim(n)
        assert tbatch._grid_rows(n) == jbatch._grid_rows(n)


def test_shape_grid_default_is_eighth(monkeypatch):
    monkeypatch.delenv("SVECALIGN_SHAPE_GRID", raising=False)
    assert tbatch.shape_grid_mode() == jbatch.shape_grid_mode() == "eighth"
    assert tbatch._grid_dim(1300) == 1408 and tbatch._grid_rows(257) == 512


def test_upload_byte_accounting(monkeypatch):
    """fp16, int8 and int4 stage 1, 1/2 and 1/4 of the embedding bytes
    (grid off: gridded row counts would blur the ratios with padding)."""
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", "0")
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((200, 64)).astype(np.float16)
    ids = np.arange(200, dtype=np.int32)[None, :].repeat(3, axis=0)
    readings = {}
    for mode in ("fp16", "int8", "int4"):
        before = dict(tbatch.upload_stats)
        v0, v1, s0, s1 = tbatch.stage_rows_upload([(emb, ids, emb, ids)], quantize=mode,
                                                  device="cpu")
        readings[mode] = tbatch.upload_stats["bytes"] - before["bytes"]
        assert tbatch.upload_stats["buckets"] == before["buckets"] + 1
        assert v0.shape == (1, 3, 200, 64) and s0.tolist() == [200]
    ids_bytes, scales = 2 * ids.nbytes, 2 * 200 * 4
    assert readings["fp16"] - ids_bytes == 2 * emb.nbytes
    assert readings["int8"] - ids_bytes - scales == emb.nbytes
    assert readings["int4"] - ids_bytes - scales == emb.nbytes // 2
    with pytest.raises(ValueError, match="fp16, int8 or int4"):
        tbatch.stage_rows_upload([(emb, ids, emb, ids)], quantize="int2", device="cpu")


def test_unported_staging_names_its_roadmap_item():
    """The upload staging's mesh branch (once a stub naming its ROADMAP
    item): each shard holds its slice of the bucket, padded to the whole
    bucket's shapes, bit-equal to the unsharded staging, in every upload
    precision; the bytes are those of the unsharded bucket; a sharding
    other than ``batch_sharding`` or an uneven split raises."""
    from svecalign_tpu_torch.parallel.mesh import Mesh, batch_sharding, replicated

    rng = np.random.default_rng(13)
    pairs = []
    for n0, n1 in [(30, 28), (12, 40), (25, 25), (40, 9)]:
        e0, e1 = _rows_with_nan(rng, n0 + 4, 16), _rows_with_nan(rng, n1 + 4, 16)
        pairs.append((e0, rng.integers(-1, n0 + 4, (3, n0)).astype(np.int32),
                      e1, rng.integers(-1, n1 + 4, (3, n1)).astype(np.int32)))
    mesh = Mesh(["cpu", "cpu"])
    for mode in ("fp16", "int8", "int4"):
        before = tbatch.upload_stats["bytes"]
        whole = tbatch.stage_rows_upload(pairs, quantize=mode, device="cpu")
        nbytes = tbatch.upload_stats["bytes"] - before
        sharded = tbatch.stage_rows_upload(pairs, quantize=mode, sharding=batch_sharding(mesh))
        assert tbatch.upload_stats["bytes"] - before == 2 * nbytes
        assert tbatch._pair_mesh(sharded) is mesh and tbatch._pair_mesh(whole) is None
        for i, shard in enumerate(sharded.shards):
            for got, want in zip(shard, whole):
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want)[2 * i:2 * i + 2])
    with pytest.raises(TypeError, match="batch_sharding"):
        tbatch.stage_rows_upload(pairs, sharding=replicated(mesh))
    with pytest.raises(ValueError, match="evenly"):
        tbatch.stage_rows_upload(pairs[:3], sharding=batch_sharding(mesh))


# ---------------------------------------------------------------------------
# the batched pyramid
# ---------------------------------------------------------------------------


TYPES = [(x, y) for x in range(1, 4) for y in range(1, 4) if x + y <= 4]
KW = dict(
    final_alignment_types=TYPES,
    del_percentile_frac=0.2,
    width_over2=5,
    max_size_full_dp=300,
    costs_sample_size=500,
    num_samps_for_norm=30,
)


def _pair(rng, n, m, d=32, n_overlaps=3):
    base = rng.standard_normal((n_overlaps, max(n, m), d)).astype(np.float32)
    v0 = base[:, :n].copy()
    v1 = base[:, :m] + 0.1 * rng.standard_normal((n_overlaps, m, d)).astype(np.float32)
    return (np.array(jcosts.make_norm1(jnp.asarray(v0))),
            np.array(jcosts.make_norm1(jnp.asarray(v1))))


def _covers(aligns, v0, v1):
    return ([i for x, _ in aligns for i in x] == list(range(v0.shape[1]))
            and [j for _, y in aligns for j in y] == list(range(v1.shape[1])))


# ragged pairs with one small pair (12 x 14 = 168 < 500 samples: the
# exhaustive cross product) under a forced pyramid, and a depth-0 bucket
BUCKETS = {
    "ragged, depth >= 1": ([(50, 47), (61, 44), (12, 14), (90, 70)], 20),
    "depth 0": ([(20, 25), (31, 18)], 300),
}


@pytest.mark.parametrize("grid", ["1", "off"])
@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_paired_mode_matches_jax(monkeypatch, bucket, grid):
    sizes, max_size = BUCKETS[bucket]
    rng = np.random.default_rng(len(bucket))
    pairs = [_pair(rng, n, m) for n, m in sizes]
    kw = {**KW, "max_size_full_dp": max_size, "sampling": "paired", "seed": 7}
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", grid)
    monkeypatch.setenv("SVECALIGN_DEVICE_TRACEBACK", "0")
    want = jbatch.vecalign_batched(pairs, **kw)
    host = tbatch.vecalign_batched(pairs, device="cpu", **kw)
    monkeypatch.setenv("SVECALIGN_DEVICE_TRACEBACK", "1")
    before = dict(tbatch.pull_stats)
    walked = tbatch.vecalign_batched(pairs, device="cpu", **kw)
    # with the walks on, only paths are pulled
    assert tbatch.pull_stats["plane_bytes"] == before["plane_bytes"]
    assert tbatch.pull_stats["step_bytes"] > before["step_bytes"]
    for (v0, v1), (a_w, s_w), (a_h, s_h), (a_d, s_d) in zip(pairs, want, host, walked):
        assert a_h == a_w and _covers(a_h, v0, v1)
        np.testing.assert_allclose(s_h, s_w, rtol=1e-5, atol=1e-6)
        assert a_d == a_h
        np.testing.assert_array_equal(s_d, s_h)  # the two tracebacks: bit-equal


def test_paired_mode_from_rows_matches_jax(monkeypatch):
    """Raw fp16 rows + id maps through staging (NaN row, PAD ids)."""
    monkeypatch.setenv("SVECALIGN_DEVICE_TRACEBACK", "0")
    rng = np.random.default_rng(7)
    pairs = []
    for k in range(3):
        n, m = 30 + 7 * k, 33 + (k % 2) * 9
        e0 = rng.standard_normal((3 * n, 32)).astype(np.float16)
        e1 = rng.standard_normal((3 * m, 32)).astype(np.float16)
        e0[1] = np.nan
        ids0 = rng.integers(0, 3 * n, size=(3, n)).astype(np.int32)
        ids1 = rng.integers(0, 3 * m, size=(3, m)).astype(np.int32)
        ids0[2, n - 1] = -1  # a PAD entry
        pairs.append((e0, ids0, e1, ids1))
    kw = {**KW, "max_size_full_dp": 16, "seed": 3, "sampling": "paired"}
    want = jbatch.vecalign_batched_from_rows(pairs, **kw)
    got = tbatch.vecalign_batched_from_rows(pairs, device="cpu", **kw)
    for (a_w, s_w), (a_g, s_g) in zip(want, got):
        assert a_g == a_w
        np.testing.assert_allclose(s_g, s_w, rtol=1e-5, atol=1e-6)


def test_paired_bucket_equals_per_pair_runs(monkeypatch):
    """Same-sized pairs, grid off: the bucket is sample-identical to one
    pyramid.vecalign run per pair with the same seed."""
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", "off")
    rng = np.random.default_rng(5)
    pairs = [_pair(rng, 64, 57) for _ in range(3)]
    kw = {**KW, "max_size_full_dp": 20, "seed": 11}
    got = tbatch.vecalign_batched(pairs, sampling="paired", device="cpu", **kw)
    for (v0, v1), (aligns, scores) in zip(pairs, got):
        single = tpyr.vecalign(v0, v1, device="cpu", **kw)
        assert aligns == single[0]["final_alignments"]
        np.testing.assert_allclose(scores, single[0]["alignment_scores"], rtol=0, atol=1e-5)


def test_pair_on_the_shape_grid_aligns(monkeypatch):
    """A pair whose sizes both sit on the shape grid (88 and 80 are
    multiples of the grid's step) under a pyramid: its search paths have
    s0 + s1 + 3 nodes, two more than the padded dims + 1 that the JAX
    package allows for (it fails on this bucket); the port's band length
    bounds them, and padding rows change no result."""
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", "1")
    assert tbatch._grid_dim(88) == 88 and tbatch._grid_dim(80) == 80
    assert tbatch._band_pad(44, 40) == 87
    rng = np.random.default_rng(8)
    pairs = [_pair(rng, 88, 80), _pair(rng, 70, 66)]
    kw = {**KW, "max_size_full_dp": 24, "sampling": "paired"}
    with pytest.raises(ValueError, match="broadcast"):
        jbatch.vecalign_batched(pairs, **kw)
    gridded = tbatch.vecalign_batched(pairs, device="cpu", **kw)
    for (v0, v1), (aligns, scores) in zip(pairs, gridded):
        assert _covers(aligns, v0, v1)
        # the same pyramid (depth 2 either way) with exact padding
    monkeypatch.setenv("SVECALIGN_SHAPE_GRID", "off")
    exact = tbatch.vecalign_batched(pairs, device="cpu", **kw)
    want = jbatch.vecalign_batched(pairs, **kw)
    for (a_g, s_g), (a_e, s_e), (a_w, s_w) in zip(gridded, exact, want):
        assert a_g == a_e == a_w
        np.testing.assert_allclose(s_g, s_e, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s_e, s_w, rtol=1e-5, atol=1e-6)


def test_shared_mode_covers_documents():
    rng = np.random.default_rng(0)
    pairs = [_pair(rng, 37, 35), _pair(rng, 28, 31), _pair(rng, 40, 22)]
    results = tbatch.vecalign_batched(pairs, device="cpu", **KW)
    assert len(results) == 3
    for (v0, v1), (aligns, scores) in zip(pairs, results):
        assert _covers(aligns, v0, v1) and len(aligns) == len(scores)
    # seeded: the same bucket gives the same result
    again = tbatch.vecalign_batched(pairs, device="cpu", **KW)
    assert [a for a, _ in again] == [a for a, _ in results]


def test_shared_mode_matches_unbatched_quality():
    """The shared and the per-pair aligner draw their samples differently from the
    same seed, so near-tie merges can differ; the JAX tests' gate: strong
    agreement plus identical coverage (padding inert)."""
    rng = np.random.default_rng(1)
    pairs = [_pair(rng, n, m) for n, m in [(30, 30), (25, 25), (18, 18)]]
    batched = tbatch.vecalign_batched(pairs, device="cpu", **KW)
    for (v0, v1), (aligns, _) in zip(pairs, batched):
        single = tpyr.vecalign(v0.copy(), v1.copy(), device="cpu", **KW)
        a_set = set((tuple(x), tuple(y)) for x, y in aligns)
        s_set = set((tuple(x), tuple(y)) for x, y in single[0]["final_alignments"])
        assert len(a_set & s_set) / max(len(s_set), 1) >= 0.7
        assert _covers(aligns, v0, v1)


@pytest.mark.parametrize("device_tb", ["0", "1"])
def test_shared_mode_with_pyramid_depth(monkeypatch, device_tb):
    """Forced downsampling with mixed sizes, with both tracebacks."""
    monkeypatch.setenv("SVECALIGN_DEVICE_TRACEBACK", device_tb)
    rng = np.random.default_rng(2)
    pairs = [_pair(rng, 50, 47), _pair(rng, 61, 44), _pair(rng, 9, 61)]
    results = tbatch.vecalign_batched(pairs, device="cpu", **{**KW, "max_size_full_dp": 20})
    for (v0, v1), (aligns, _) in zip(pairs, results):
        assert _covers(aligns, v0, v1)


def test_device_knob_uses_the_exhaustive_cross_product_for_small_pairs():
    """A pair with size0 * size1 < S enumerates every index pair once, so
    its penalty does not depend on the generator's seed; a large pair's does."""
    rng = np.random.default_rng(9)
    v0 = np.zeros((2, 30, 16), np.float32)
    v1 = np.zeros((2, 30, 16), np.float32)
    v0[0, :12], v1[0, :14] = _unit(rng, 12, 16), _unit(rng, 14, 16)
    v0[1], v1[1] = _unit(rng, 30, 16), _unit(rng, 30, 16)
    n0 = n1 = torch.ones(2, 30)
    h0, h1 = _t([12, 30], torch.int32), _t([14, 30], torch.int32)
    pens = [tbatch._device_knob_penalty(
        tbatch._draw(torch.device("cpu"), seed, 0, 2, (2, 500)), _t(v0), _t(v1), n0, n1, h0, h1,
        S=500, frac=0.2) for seed in (1, 2)]
    assert pens[0][0] == pens[1][0] and pens[0][1] != pens[1][1]
    x, y = np.meshgrid(np.arange(12), np.arange(14), indexing="ij")
    scores = tbatch._batched_score_pairs(
        _t(v0[:1]), _t(v1[:1]), n0[:1], n1[:1], _t(x.ravel()[None]), _t(y.ravel()[None]))[0]
    host = tdel.DeletionKnob(scores.numpy(), 0, float(scores.max()))
    assert abs(float(pens[0][0]) - host.percentile_frac_to_del_penalty(0.2)) <= \
        2.0 * float(scores.max()) / tdel.NUM_BINS + 1e-6


def test_backend_rule_and_argument_checks():
    rng = np.random.default_rng(3)
    pairs = [_pair(rng, 20, 18)]
    with pytest.raises(ValueError, match="runs on the card"):
        tbatch.vecalign_batched(pairs, device="cpu", dp_backend="cuda", **KW)
    with pytest.raises(ValueError, match="dp_backend"):
        tbatch.vecalign_batched(pairs, device="cpu", dp_backend="pallas", **KW)
    with pytest.raises(ValueError, match="sampling"):
        tbatch.vecalign_batched(pairs, device="cpu", sampling="both", **KW)
    (aligns, _), = tbatch.vecalign_batched(pairs, device="cpu", dp_backend="torch", **KW)
    assert _covers(aligns, *pairs[0])


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.vecalign_batched([_pair(rng, 20, 18)], **KW)
    emb = rng.standard_normal((20, 16)).astype(np.float16)
    ids = np.arange(20, dtype=np.int32)[None]
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.stage_rows_upload([(emb, ids, emb, ids)])
