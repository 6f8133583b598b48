"""The port's plain DPs (svecalign_tpu_torch.ops.dp) against the JAX
package: the banded DP against both the XLA scan ``banded_dp`` and the
Pallas kernel ``banded_dp_pallas_batched`` (interpret mode on the CPU), the
dense DP against ``dense_dp``. Backpointers and finite masks must be equal;
csum agrees within rtol 1e-6 (the arithmetic is the same fp32 adds, so it
is bit-equal in practice). The CUDA kernel is held to the same plain
version on the card by ``chip_smoke.py``; here its wrapper is checked to
take the plain version for CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.ops import costs as jcosts
from svecalign_tpu.ops import dp as jdp
from svecalign_tpu_torch.ops import dp as tdp
from svecalign_tpu_torch.ops import dp_cuda
from tests.test_dp import _make_path

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


DEFAULT_TYPES = [(x, y) for x in range(1, 6) for y in range(1, 6) if x + y <= 6]


def _problem(rng, n, m, types, w2, ties=True):
    path = _make_path(rng, n, m)
    b_off = jcosts.path_to_band_offsets(path, w2)
    cost = rng.uniform(0, 2, (len(types), len(path), 2 * w2)).astype(np.float32)
    pen = float(rng.uniform(0.2, 0.8))
    if ties:
        # quarter steps make equal-cost candidates common (tie-breaking)
        cost = np.round(cost * 4) / 4
        pen = 0.5
    return cost, b_off, pen


def _assert_planes_equal(got, want):
    csum_g, xp_g, yp_g = (np.asarray(v) for v in got)
    csum_w, xp_w, yp_w = (np.asarray(v) for v in want)
    finite = np.isfinite(csum_w)
    np.testing.assert_array_equal(np.isfinite(csum_g), finite)
    np.testing.assert_allclose(csum_g[finite], csum_w[finite], rtol=1e-6)
    np.testing.assert_array_equal(xp_g, xp_w)
    np.testing.assert_array_equal(yp_g, yp_w)


@pytest.mark.parametrize(
    "seed,n,m,types,w2",
    [
        (0, 40, 36, DEFAULT_TYPES, 8),  # the CLI's 15 types, K = 6
        (1, 40, 36, DEFAULT_TYPES, 8),
        (2, 30, 33, [(1, 1)], 8),  # coarse levels: one type, K = 2
        (3, 60, 55, [(1, 1), (1, 2), (2, 1)], 70),  # wide band, B + K > 128
        (4, 120, 40, [(k, 1) for k in range(1, 51)], 30),  # many-to-one K = 51
    ],
)
def test_banded_dp_matches_jax(seed, n, m, types, w2, interpret_mode):
    from svecalign_tpu.ops.dp_pallas import run_banded_dp_pallas

    rng = np.random.default_rng(seed)
    cost, b_off, pen = _problem(rng, n, m, types, w2)

    got = tdp.run_banded_dp(torch.from_numpy(cost), b_off, types, pen, n, m)
    xla = jdp.run_banded_dp(cost, b_off, types, pen, n, m)
    pallas = run_banded_dp_pallas(cost, b_off, types, pen, n, m)
    np.testing.assert_array_equal(got[3], xla[3])
    _assert_planes_equal(got[:3], xla[:3])
    _assert_planes_equal(got[:3], pallas[:3])
    assert got[1].dtype == np.int8 and got[0].dtype == np.float64


def test_banded_dp_batched_matches_pallas_batched(interpret_mode):
    """P = 3 pairs of unequal A, padded to one A as the batched driver
    pads them: every pair's planes equal the Pallas kernel's."""
    from svecalign_tpu.ops.dp_pallas import banded_dp_pallas_batched

    rng = np.random.default_rng(11)
    types = DEFAULT_TYPES
    w2 = 8
    pairs = [_problem(rng, n, m, types, w2) + (n, m)
             for n, m in [(20, 18), (15, 19), (12, 12)]]
    P = len(pairs)
    a_pad = max(c.shape[1] for c, *_ in pairs)
    costs = np.full((P, len(types), a_pad, 2 * w2), np.inf, np.float32)
    boff_in = np.zeros((P, a_pad), np.int32)
    boff_out = np.zeros((P, a_pad + 2), np.int32)
    pens = np.zeros(P, np.float32)
    sizes = np.zeros((2, P), np.int32)
    for i, (cost, b_off, pen, n, m) in enumerate(pairs):
        a = cost.shape[1]
        costs[i, :, :a] = cost
        boff_in[i, :a] = b_off
        boff_in[i, a:] = b_off[-1]
        boff_out[i] = jdp.extend_band_offsets(boff_in[i])
        pens[i], sizes[0, i], sizes[1, i] = pen, n, m

    x_off = tuple(x for x, _ in types)
    y_off = tuple(y for _, y in types)
    want = banded_dp_pallas_batched(
        jnp.asarray(costs), jnp.asarray(boff_in), jnp.asarray(boff_out),
        x_off, y_off, jnp.asarray(pens),
        jnp.asarray(sizes[0]), jnp.asarray(sizes[1]),
    )
    args = (
        torch.from_numpy(costs), torch.from_numpy(boff_in),
        torch.from_numpy(boff_out), x_off, y_off, torch.from_numpy(pens),
        torch.from_numpy(sizes[0]), torch.from_numpy(sizes[1]),
    )
    got = tdp.banded_dp_batched(*args)
    _assert_planes_equal(got, want)

    # the kernel's wrapper takes the plain version for CPU tensors, and a
    # plain run is no launch
    before = dp_cuda.LAUNCHES["banded_dp"]
    via_wrapper = dp_cuda.banded_dp_cuda_batched(*args)
    assert dp_cuda.LAUNCHES["banded_dp"] == before
    for g, w in zip(via_wrapper, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,ties", [((12, 9), True), ((1, 5), False), ((30, 41), True), ((64, 57), False)])
def test_dense_dp_matches_jax(seed, shape, ties):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, shape).astype(np.float32)
    pen = float(rng.uniform(0.1, 0.5))
    if ties:
        cost = np.round(cost * 4) / 4
        pen = 0.25
    want_csum, want_bp = jdp.dense_dp(jnp.asarray(cost), jnp.float32(pen))
    csum, bp = tdp.dense_dp(torch.from_numpy(cost), pen)
    assert csum.shape == (shape[0] + 1, shape[1] + 1)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(want_bp))
    np.testing.assert_allclose(csum.numpy(), np.asarray(want_csum), rtol=1e-6)


@pytest.mark.parametrize("shape", [(0, 7), (5, 0), (0, 0)])
def test_dense_dp_with_an_empty_side(shape):
    """Only the boundary row or column exists: insertions along row 0,
    deletions along column 0, the origin marked 4."""
    csum, bp = tdp.dense_dp(torch.zeros(shape), 0.25)
    n, m = shape
    assert csum.shape == bp.shape == (n + 1, m + 1)
    assert bp[0, 0] == 4 and (bp.flatten()[1:] == (1 if n == 0 else 2)).all()
    np.testing.assert_array_equal(csum.flatten().numpy(), 0.25 * np.arange(n + m + 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_dp_batched_is_dense_dp_per_pair(seed):
    """The bucket's plain version: each pair's own dense_dp on its own
    rectangle, -1 / +inf outside; the per-pair pyramid's P = 1 call with
    full sizes equals dense_dp."""
    rng = np.random.default_rng(seed)
    sizes = [(9, 12), (14, 3), (1, 1), (0, 4)]
    costs = torch.from_numpy(np.round(rng.uniform(0, 1, (4, 14, 12)) * 4).astype(np.float32) / 4)
    pens = torch.tensor([0.25, 0.5, 0.125, 0.375])
    xs = torch.tensor([n for n, _ in sizes], dtype=torch.int32)
    ys = torch.tensor([m for _, m in sizes], dtype=torch.int32)
    csum, bp = tdp.dense_dp_batched(costs, pens, xs, ys)
    for p, (n, m) in enumerate(sizes):
        want_csum, want_bp = tdp.dense_dp(costs[p, :n, :m], pens[p])
        assert torch.equal(bp[p, :n + 1, :m + 1], want_bp)
        assert torch.equal(csum[p, :n + 1, :m + 1], want_csum)
        assert int((bp[p] != -1).sum()) == (n + 1) * (m + 1)
    full = tdp.dense_dp_batched(costs[:1], pens[:1], torch.tensor([14], dtype=torch.int32),
                                torch.tensor([12], dtype=torch.int32))
    one = tdp.dense_dp(costs[0], pens[0])
    assert torch.equal(full[0][0], one[0]) and torch.equal(full[1][0], one[1])


def test_extend_band_offsets_matches_jax():
    b = np.array([-3, -3, -2, -1, -1, 0], np.int32)
    np.testing.assert_array_equal(tdp.extend_band_offsets(b), jdp.extend_band_offsets(b))


H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on an H100


@pytest.mark.parametrize(
    "B,K,T,A,smem_optin,want",
    [
        (16, 6, 15, 2303, H100_SMEM_OPTIN, "warp"),  # the stage's final level
        (16, 2, 1, 1153, H100_SMEM_OPTIN, "warp"),  # its coarse level
        (32, 6, 15, 2303, H100_SMEM_OPTIN, "warp"),  # a full warp
        (6, 6, 15, 400, H100_SMEM_OPTIN, "warp"),  # the narrowest band
        (32, 51, 50, 421, H100_SMEM_OPTIN, "warp"),  # many-to-one: 100 KB of stages fit
        (34, 6, 15, 2303, H100_SMEM_OPTIN, "block"),  # first band past a warp
        (140, 3, 3, 951, H100_SMEM_OPTIN, "block"),
        (1200, 51, 50, 211, H100_SMEM_OPTIN, "block"),
        (16, 2**15, 1, 100, 2**40, "block"),  # a type offset past the tag's 16 bits
        (16, 6, 15, 2303, 44 * 1024, "block"),  # stages + ring fit, the offsets row does not
        (16, 6, 15, 60000, H100_SMEM_OPTIN, "block"),  # a path too long to hold on chip
    ],
)
def test_banded_dp_route_by_shape(B, K, T, A, smem_optin, want):
    n_types = T + 2
    assert dp_cuda.banded_dp_route(B, K, T, A, n_types, smem_optin) == want
    need = dp_cuda.warp_smem_bytes(B, K, T, A, n_types)
    if want == "warp":
        assert need <= smem_optin
    elif B <= 32 and K < 2**15:
        # refused for shared memory alone: without the offsets row it would fit
        assert need > smem_optin
        assert dp_cuda.warp_smem_bytes(B, K, T, 0, n_types) <= smem_optin


def test_warp_smem_bytes_layout():
    """Stages (a row per type, 17 padded to 24: two halves of a warp take
    12 each), ring (K + 1 rows and one of +inf), offsets row rounded up to
    16 bytes, and 65 8-byte entries per padded type (the type table and
    the ring offsets of 64 steps), at the stage's final level (T = 15, B = 16, K = 6, A = 2303); at B = 32 one group of lanes
    takes all the types, 17 padded to 20."""
    assert dp_cuda.warp_padded_types(16, 17) == 24
    assert dp_cuda.warp_padded_types(32, 17) == 20
    assert dp_cuda.warp_padded_types(16, 3) == 8
    stages = dp_cuda.WARP_STAGES * 24 * 16 * 4
    ring = 8 * (16 + 12) * 4
    offsets = -(-(2305 * 4) // 16) * 16
    types = 65 * 24 * 8
    assert dp_cuda.warp_smem_bytes(16, 6, 15, 2303, 17) == stages + ring + offsets + types
    assert dp_cuda.warp_smem_bytes(16, 6, 15, 2303, 17) == 24576 + 896 + 9232 + 12480


@pytest.mark.parametrize("w2,sizes", [(8, [(20, 18), (7, 9)]), (16, [(15, 12)]), (3, [(9, 11)]),
                                      (17, [(14, 14)])])
def test_wrapper_on_cpu_takes_the_plain_version(w2, sizes):
    """Whatever route the shape would take on the card, a CPU tensor goes
    through the plain version, counts no launch and returns its planes; a
    forced route changes nothing there."""
    from chip_smoke import _random_band_problem

    args = _random_band_problem(np.random.default_rng(5), sizes, DEFAULT_TYPES, w2, "cpu")
    want = tdp.banded_dp_batched(*args)
    before = dict(dp_cuda.LAUNCHES)
    for route in (None, "block"):
        got = dp_cuda.banded_dp_cuda_batched(*args, route=route)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert dp_cuda.LAUNCHES == before
    assert set(before) == {"banded_dp", "banded_dp_warp", "banded_dp_block"}


@pytest.mark.parametrize("types,A,n_cycles", [(DEFAULT_TYPES, 2303, 46.4), ([(1, 1)], 1153, 46.4)])
def test_banded_dp_bound_is_the_dependent_chain(types, A, n_cycles):
    """chip_smoke's bound at the stage's two banded levels (P = 1, B = 16):
    A + 2 steps of one row handover (26 cycles, a shuffle on an H100), one
    add, a two-level minimum over the two deletions and the merged rest,
    and one select (5.1 cycles each) at the SM clock. The types of span 2
    and more are off the chain, so T = 15 and T = 1 cost the same a step.
    It is far above the bytes and the operations, which the function must
    still report when the clock is taken out."""
    from chip_smoke import (H100_BYTES_PER_S, H100_FP32_OPS_PER_S, _bound_ms,
                            _chain_cycles_per_step)

    xo, yo = [x for x, _ in types], [y for _, y in types]
    T, n_types, B = len(types), len(types) + 2, 16
    assert _chain_cycles_per_step(xo, yo) == pytest.approx(n_cycles)
    ms, by = _bound_ms(1, A, B, xo, yo, 1, sm_clock_hz=1.98e9)
    assert by == "latency"
    assert ms == pytest.approx((A + 2) * n_cycles / 1.98e9 * 1e3, rel=1e-12)
    nbytes = T * A * B * 4 + (A + 2) * 4 + 12 + 2 * n_types * 4 + (A + 2) * B * 6
    ops = 2 * (A + 2) * B * n_types
    ms_rest, by_rest = _bound_ms(1, A, B, xo, yo, 1, sm_clock_hz=float("inf"))
    assert by_rest == "bytes"
    assert ms_rest == pytest.approx(nbytes / H100_BYTES_PER_S * 1e3, rel=1e-12)
    assert ms_rest > ops / H100_FP32_OPS_PER_S * 1e3
    assert ms > 20 * ms_rest
    # a bucket of pairs runs side by side: the chain does not grow with P,
    # the bytes do and take over in the end
    assert _bound_ms(8, A, B, xo, yo, 1, sm_clock_hz=1.98e9) == (pytest.approx(ms), "latency")
    ms_many, by_many = _bound_ms(1024, A, B, xo, yo, 1, sm_clock_hz=1.98e9)
    assert by_many == "bytes" and ms_many > 2 * ms


def test_chain_counts_only_the_types_that_read_the_last_row():
    """A given type of span 1 joins the two deletions on the chain (three
    candidates and the rest: still two levels; four: three levels); the
    measured latencies replace the defaults."""
    from chip_smoke import _chain_cycles_per_step

    assert _chain_cycles_per_step([1, 2], [1, 1]) == pytest.approx(26 + 5.1 * 4)
    assert _chain_cycles_per_step([1, 1], [1, 0]) == pytest.approx(26 + 5.1 * 4)
    assert _chain_cycles_per_step([1, 0, 1], [0, 1, 1]) == pytest.approx(26 + 5.1 * 5)
    assert _chain_cycles_per_step([1], [1], handover=30.0, alu=5.0) == 30 + 5 * 4
