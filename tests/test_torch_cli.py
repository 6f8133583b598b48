"""The port's stage-5.4 CLI (svecalign_tpu_torch.seg_align.align --device
cpu) against the JAX CLI (svecalign_tpu.seg_align.align --dp_backend xla)
on a synthetic pair written by chip_smoke's writer at a small size: the
alignment lines must be identical and the costs equal within 1e-5."""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import cli_argv, output_path, read_output, write_synthetic_pair
from svecalign_tpu.seg_align import align as jalign
from svecalign_tpu_torch.seg_align import align as talign
from svecalign_tpu_torch.vecalign import vecalign as tvecalign

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    paths, planted = write_synthetic_pair(
        tmp_path_factory.mktemp("pair"), n_src=90, n_tgt=84, dim=64, seed=5, n_ignore=5)
    return paths, planted


def test_cli_matches_jax_cli(pair, tmp_path, monkeypatch):
    paths, planted = pair
    # --max_size_full_dp 24 makes a pyramid of depth 2 at this size
    extra = ["--max_size_full_dp", "24", "--costs_sample_size", "3000"]
    runtimes = talign.main(cli_argv(paths, tmp_path / "torch", "cpu", extra))
    assert len(runtimes) == 1 and runtimes[0]["Final DP"] > 0

    jax_argv = cli_argv(paths, tmp_path / "jax", "cpu", extra)
    i = jax_argv.index("--device")
    jax_argv[i:i + 2] = ["--dp_backend", "xla"]
    monkeypatch.setattr(sys, "argv", ["align"] + jax_argv)
    jalign.main()

    got_spans, got_costs = read_output(output_path(tmp_path / "torch"))
    want_spans, want_costs = read_output(output_path(tmp_path / "jax"))
    assert got_spans == want_spans
    np.testing.assert_allclose(got_costs, want_costs, rtol=0, atol=1e-5)

    # the synthetic pair is alignable: most planted 1-1 pairs come back
    one_one = {(str(x), str(y)) for x, y in planted if len(x) == len(y) == 1}
    assert len(one_one & set(got_spans)) / len(one_one) >= 0.9


def test_default_device_raises_without_card(pair, tmp_path, monkeypatch):
    """No --device on a machine without CUDA raises: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths, _ = pair
    argv = cli_argv(paths, tmp_path, "cpu")
    del argv[argv.index("--device"):argv.index("--device") + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        talign.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvecalign.main(["-s", "x", "-t", "y", "--src_embed", "a", "b", "--tgt_embed", "c", "d"])


@pytest.mark.parametrize("flags", [
    ["--dp_backend", "xla"], ["--dp_backend", "pallas"],
])
def test_unported_flags_exit_naming_roadmap(pair, tmp_path, flags):
    paths, _ = pair
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        talign.main(cli_argv(paths, tmp_path, "cpu", flags))
