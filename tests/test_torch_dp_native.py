"""The port's host float64 DPs (svecalign_tpu_torch.ops.dp_native, built
from its own copy of dp_core.cpp) against the JAX package's
(svecalign_tpu.ops.dp_native, built from native/): bit-equal on the
cross-backend fuzz cases and on dense cases, since both are the same
source under the same g++ flags. Then the stage-5.4 CLI with
``--dp_backend native --device cpu`` against the JAX CLI with
``--dp_backend native``: the same alignment lines, costs within 1e-5 (the
DP is the same code, but its float32 cost tensors come from two
frameworks' matmuls, which round differently in the last bits)."""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import cli_argv, output_path, read_output, write_synthetic_pair
from svecalign_tpu.ops import costs as jcosts
from svecalign_tpu.ops import dp_native as jnative
from svecalign_tpu.seg_align import align as jalign
from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import dp as tdp
from svecalign_tpu_torch.ops import dp_native as tnative
from svecalign_tpu_torch.seg_align import align as talign
from svecalign_tpu_torch.vecalign import batch as tbatch
from svecalign_tpu_torch.vecalign import pyramid as tpyramid
from tests.test_dp import _make_path
from tests.test_fuzz_backends import CASES

torch.set_num_threads(1)


def _banded_problem(n, m, types, w2, seed):
    rng = np.random.default_rng(seed)
    b_off = jcosts.path_to_band_offsets(_make_path(rng, n, m), w2)
    cost = rng.uniform(0, 2, (len(types), len(b_off), 2 * w2)).astype(np.float32)
    return cost, b_off, float(rng.uniform(0.2, 0.8))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,m,types,w2,seed", CASES)
def test_banded_bit_equal_to_jax(n, m, types, w2, seed):
    cost, b_off, pen = _banded_problem(n, m, types, w2, seed)
    want = jnative.run_banded_dp_native(cost, b_off, types, pen, n, m)
    _assert_same(tnative.run_banded_dp_native(cost, b_off, types, pen, n, m), want)
    # a tensor input (the pyramid's costs) gives the same bits
    _assert_same(tnative.run_banded_dp_native(torch.from_numpy(cost), b_off, types, pen, n, m),
                 want)


@pytest.mark.parametrize("n,m,seed", [(1, 1, 0), (37, 23, 1), (64, 150, 2)])
def test_dense_bit_equal_to_jax(n, m, seed):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 2, (n, m)).astype(np.float32)
    pen = float(rng.uniform(0.2, 0.8))
    _assert_same(tnative.dense_dp_native(cost, pen), jnative.dense_dp_native(cost, pen))


@pytest.mark.parametrize("n,m,types,w2,seed", CASES[:3])
def test_banded_agrees_with_plain_dp(n, m, types, w2, seed):
    """float64 against the float32 plain DP: same pointers, csum within
    float32 rounding."""
    cost, b_off, pen = _banded_problem(n, m, types, w2, seed)
    c_n, xp_n, yp_n, bo_n = tnative.run_banded_dp_native(cost, b_off, types, pen, n, m)
    c_t, xp_t, yp_t, bo_t = tdp.run_banded_dp(torch.from_numpy(cost), b_off, types, pen, n, m)
    np.testing.assert_array_equal(bo_t, bo_n)
    np.testing.assert_array_equal(xp_t, xp_n)
    np.testing.assert_array_equal(yp_t, yp_n)
    fin = np.isfinite(c_n)
    np.testing.assert_array_equal(np.isfinite(c_t), fin)
    np.testing.assert_allclose(c_t[fin], c_n[fin], rtol=1e-5, atol=1e-5)


def test_backend_rules_and_failed_build(tmp_path):
    assert tpyramid.pick_banded_dp("native", torch.device("cpu")) is tnative.run_banded_dp_native
    assert tpyramid.pick_banded_dp("auto", torch.device("cpu")) is tdp.run_banded_dp
    with pytest.raises(ValueError, match="dp_backend"):
        tbatch._run_batched_banded_dp(torch.zeros(1, 1, 1, 1), None, None, (1,), (1,), None,
                                      None, None, dp_backend="native")
    assert tnative.GXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build dp_core.cpp"):
        _build.build_host_library("dp_core", ("-shared", "--no-such-flag"), build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_cli_native_matches_jax_cli(tmp_path, monkeypatch):
    paths, _ = write_synthetic_pair(tmp_path / "pair", n_src=90, n_tgt=84, dim=64, seed=5,
                                    n_ignore=5)
    # --max_size_full_dp 24 makes a pyramid of depth 2 at this size
    extra = ["--max_size_full_dp", "24", "--costs_sample_size", "3000",
             "--dp_backend", "native"]
    talign.main(cli_argv(paths, tmp_path / "torch", "cpu", extra))

    jax_argv = cli_argv(paths, tmp_path / "jax", "cpu", extra)
    i = jax_argv.index("--device")
    del jax_argv[i:i + 2]
    monkeypatch.setattr(sys, "argv", ["align"] + jax_argv)
    jalign.main()

    got_spans, got_costs = read_output(output_path(tmp_path / "torch"))
    want_spans, want_costs = read_output(output_path(tmp_path / "jax"))
    assert got_spans and got_spans == want_spans
    np.testing.assert_allclose(got_costs, want_costs, rtol=0, atol=1e-5)


def test_phase_native_rehearsal(tmp_path):
    """chip_smoke.phase_native on the CPU (the plain DP in the kernel's
    place), on a pair of one banded level."""
    import chip_smoke

    paths, _ = write_synthetic_pair(tmp_path / "pair", n_src=90, n_tgt=84, dim=64, seed=6)
    talign.main(cli_argv(paths, tmp_path / "out", "cpu"))
    spans, costs = read_output(output_path(tmp_path / "out"))
    assert chip_smoke.phase_native(tmp_path, paths, spans, costs, device="cpu") > 0
