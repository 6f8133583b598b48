"""The port's stage-5.4 CLI with --pair_batch > 1 (the batched aligner) on
the CPU, on five synthetic pairs written by chip_smoke's writer at a small
size: two buckets at --pair_batch 3, with fp16, int8 and int4 uploads.
Every pair gets its file, is covered exactly once in order and recovers
its planted 1-1 pairs: recall >= 0.9 for all three (found: 0.921-0.961 per
pair, the same for fp16, int8 and int4: the int4 upload's ~2% cosine noise
moves no alignment at this size). The
batched aligner samples on the device with torch's generator, so it is held
to quality and to the per-pair CLI's output (>= 0.7 common alignments), not
to the JAX CLI bit for bit (tests/test_torch_batch.py does that in paired
mode)."""

import json
import logging

import pytest
import torch

from chip_smoke import (cli_argv, output_path, read_output, write_synthetic_corpus,
                        write_synthetic_pair)
from svecalign_tpu_torch.seg_align import align as talign

torch.set_num_threads(1)

SIZES = [(70, 66), (52, 58), (88, 80), (61, 61), (45, 50)]
# --max_size_full_dp 24 gives a pyramid of depth 2 at these sizes
EXTRA = ["--max_size_full_dp", "24", "--costs_sample_size", "3000", "--pair_batch", "3"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(tmp_path_factory.mktemp("corpus"), SIZES, dim=64, seed=40,
                                  n_ignore=3)


def _recall_and_cover(out_dir, stem, blocks, n_src, n_tgt):
    spans, costs = read_output(output_path(out_dir, stem))
    assert [i for x, _ in spans for i in json.loads(x)] == list(range(n_src))
    assert [j for _, y in spans for j in json.loads(y)] == list(range(n_tgt))
    assert (costs >= 0).all()
    one_one = {(str(x), str(y)) for x, y in blocks if len(x) == len(y) == 1}
    return len(one_one & set(spans)) / len(one_one), set(spans)


@pytest.mark.parametrize("quant", ["fp16", "int8", "int4"])
def test_batched_cli_aligns_every_pair(corpus, tmp_path, quant):
    paths, stems, planted = corpus
    prof = talign.main(cli_argv(paths, tmp_path, "cpu", EXTRA + ["--upload_quant", quant]))
    assert prof["buckets"] == 2 and prof["pyramid"] > 0 and prof["load"] > 0
    for stem, blocks, (n_src, n_tgt) in zip(stems, planted, SIZES):
        recall, _ = _recall_and_cover(tmp_path, stem, blocks, n_src, n_tgt)
        assert recall >= 0.9, (stem, quant, recall)


def test_batched_cli_agrees_with_per_pair_cli(corpus, tmp_path):
    paths, stems, planted = corpus
    talign.main(cli_argv(paths, tmp_path / "batched", "cpu", EXTRA))
    talign.main(cli_argv(paths, tmp_path / "single", "cpu", EXTRA[:4]))
    for stem, blocks, (n_src, n_tgt) in zip(stems, planted, SIZES):
        _, batched = _recall_and_cover(tmp_path / "batched", stem, blocks, n_src, n_tgt)
        _, single = _recall_and_cover(tmp_path / "single", stem, blocks, n_src, n_tgt)
        assert len(batched & single) / len(single) >= 0.7


def test_batched_cli_is_seeded(corpus, tmp_path):
    paths, stems, _ = corpus
    for out in ("a", "b"):
        talign.main(cli_argv(paths, tmp_path / out, "cpu", EXTRA))
    for stem in stems:
        assert (output_path(tmp_path / "a", stem).read_text()
                == output_path(tmp_path / "b", stem).read_text())
    talign.main(cli_argv(paths, tmp_path / "c", "cpu", EXTRA + ["--seed", "7"]))
    assert all(output_path(tmp_path / "c", stem).exists() for stem in stems)


def test_align_profile_logs_the_phases(corpus, tmp_path, monkeypatch, caplog):
    from svecalign_tpu_torch.vecalign import batch

    paths, _, _ = corpus
    monkeypatch.setenv("SVECALIGN_ALIGN_PROFILE", "1")
    batch.phase_seconds.clear()
    with caplog.at_level(logging.INFO):
        talign.main(cli_argv(paths, tmp_path, "cpu", EXTRA))
    lines = [r.getMessage() for r in caplog.records if "align profile" in r.getMessage()]
    assert sum("bucket" in line and "P=" in line for line in lines) == 2
    assert any("load=" in line and "(2 buckets)" in line for line in lines)
    assert {"downsample", "norms", "penalties", "dense dp", "banded costs", "banded dp",
            "banded traceback"} <= set(batch.phase_seconds)


@pytest.mark.parametrize("pair_batch", ["1", "2"])
def test_profile_dir_writes_a_trace(tmp_path, pair_batch):
    """--profile_dir on the per-pair path and on the batched path."""
    paths, _ = write_synthetic_pair(tmp_path / "pair", n_src=24, n_tgt=22, dim=16, seed=3)
    extra = ["--costs_sample_size", "200", "--pair_batch", pair_batch,
             "--profile_dir", str(tmp_path / "trace")]
    talign.main(cli_argv(paths, tmp_path / "out", "cpu", extra))
    trace = tmp_path / "trace" / "align_trace.json"
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()[:2000]
    assert output_path(tmp_path / "out").exists()


def test_native_backend_is_ignored_with_a_warning_in_batched_mode(corpus, tmp_path, caplog):
    paths, stems, _ = corpus
    with caplog.at_level(logging.WARNING):
        talign.main(cli_argv(paths, tmp_path, "cpu", EXTRA + ["--dp_backend", "native"]))
    assert any("native is ignored" in r.getMessage() for r in caplog.records)
    assert all(output_path(tmp_path, stem).exists() for stem in stems)


def test_batched_default_device_raises_without_card(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths, _, _ = corpus
    argv = cli_argv(paths, tmp_path, "cpu", EXTRA)
    del argv[argv.index("--device"):argv.index("--device") + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        talign.main(argv)


def test_data_parallel_still_exits_naming_its_item(corpus, tmp_path, monkeypatch):
    """--data_parallel (once an exit naming its ROADMAP item) on a CPU
    mesh: at --pair_batch 3 over 2 shards the batch rounds up to 4, the
    tail bucket of one pair repeats it to split evenly, and every file
    equals a one-device run at --pair_batch 4 (a pair's result depends on
    neither its shard nor its bucket-mates). --data_parallel 0 takes every
    local device (SVECALIGN_CPU_DEVICES); more cards than are present
    raise."""
    paths, stems, _ = corpus
    prof = talign.main(cli_argv(paths, tmp_path / "dp2", "cpu", EXTRA + ["--data_parallel", "2"]))
    assert prof["buckets"] == 2
    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "4")
    talign.main(cli_argv(paths, tmp_path / "dp0", "cpu", EXTRA + ["--data_parallel", "0"]))
    one = EXTRA[:-1] + ["4"]
    talign.main(cli_argv(paths, tmp_path / "one", "cpu", one))
    for stem in stems:
        want = output_path(tmp_path / "one", stem).read_text()
        assert output_path(tmp_path / "dp2", stem).read_text() == want
        assert output_path(tmp_path / "dp0", stem).read_text() == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="asked for 2 cards, 1 present"):
        talign.main(cli_argv(paths, tmp_path / "x", "cuda", EXTRA + ["--data_parallel", "2"]))
