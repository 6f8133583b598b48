"""The benchmark's data-driven layout, its names, its generators, its
counts and what its runs may import, on the CPU."""

import ast
import copy
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench_port import harness
from bench_port.counts import attention_bound, dp_bounds, encoder_flops
from bench_port.gen import pairs as gen_pairs
from bench_port.gen import plenary

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["source"]) and _line_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line_ok(m["layer"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_has_its_files():
    """Cells, configurations, traffic, drivers and readers are found by name."""
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert harness.load_driver(cell["driver"]).run
        e2e, per_layer = harness.cell_metrics(BENCH, w["name"])
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and per_layer
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_new_cell_is_a_new_file(tmp_path, monkeypatch):
    """A later cell adds files and entries and edits none: the harness finds
    it by name."""
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / sub)
    cell = json.loads((tmp_path / "workloads" / "laser.embed_plenary.json").read_text())
    cell["traffic"] = "plenary_half_hour"
    (tmp_path / "workloads" / "laser.embed_half.json").write_text(json.dumps(cell))
    traffic = json.loads((tmp_path / "traffic" / "plenary_hour.json").read_text())
    traffic["doc_seconds"] = 1800
    (tmp_path / "traffic" / "plenary_half_hour.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics" / "embed.windows.py").write_text(
        "def read(record):\n    return float(len(record.items))\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    loaded = harness.load_cell("laser.embed_half")
    assert loaded["traffic_data"]["doc_seconds"] == 1800
    assert harness.load_reader("embed.windows")(harness.Record(loaded, 1, 1)) == 0.0
    bench = copy.deepcopy(BENCH)
    bench["per_layer"].append({"name": "embed.windows", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "embed_audio_s_per_s"})
    e2e, per_layer = harness.cell_metrics(bench, "laser.embed_half")
    assert [m["name"] for m in e2e] == ["peak_mem_gib", "setup_s"]
    assert "embed.windows" not in [m["name"] for m in per_layer]


def test_plenary_documents_follow_the_seed(tmp_path):
    traffic = dict(harness.load_cell("laser.embed_plenary")["traffic_data"], doc_seconds=30)
    a = plenary.write_documents(tmp_path / "a", traffic, 2**31 + 3, "cpu")
    b = plenary.write_documents(tmp_path / "b", traffic, 2**31 + 3, "cpu")
    c = plenary.write_documents(tmp_path / "c", traffic, 2**31 + 4, "cpu")
    for x, y in zip(a, b):
        assert x.windows == y.windows and x.wav.read_bytes() == y.wav.read_bytes()
    assert any(x.wav.read_bytes() != y.wav.read_bytes() for x, y in zip(a, c))
    # every seed embeds the same windows, in another order of documents
    assert sorted(map(str, (d.windows for d in a))) == sorted(map(str, (d.windows for d in c)))
    segs = a[0].segments
    lo, hi = traffic["segment_s"]
    assert all(lo * 16000 <= e - s <= hi * 16000 for s, e in segs)
    assert all(e - s <= 20 * 16000 for s, e in a[0].windows)


def test_a_traffic_file_takes_its_base_mix(tmp_path, monkeypatch):
    """A mix that names a ``base`` holds only what it changes; the four-card
    cell runs cell 1's documents from one set of parameters."""
    shutil.copytree(harness.HERE / "traffic", tmp_path / "traffic")
    (tmp_path / "traffic" / "plenary_short.json").write_text(
        json.dumps({"base": "plenary_hour_mesh", "doc_seconds": 600}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    hour = harness.load_traffic("plenary_hour")
    short = harness.load_traffic("plenary_short")
    assert short["doc_seconds"] == 600 and "base" not in short
    assert {k: v for k, v in short.items() if k not in ("doc_seconds", "note")} == {
        k: v for k, v in hour.items() if k not in ("doc_seconds", "note")}
    monkeypatch.undo()
    one, four = (harness.load_cell(n)["traffic_data"]
                 for n in ("laser.embed_plenary", "laser.embed_plenary_4chip"))
    assert {k: v for k, v in one.items() if k != "note"} == {
        k: v for k, v in four.items() if k != "note"}


def test_pairs_follow_the_seed(tmp_path):
    traffic = dict(harness.load_cell("laser.align_bucket8")["traffic_data"],
                   sizes=[[40, 35], [30, 33]], dim=16)
    gen_pairs.write_pairs(tmp_path / "a", traffic, 9, "cpu")
    gen_pairs.write_pairs(tmp_path / "b", traffic, 9, "cpu")
    gen_pairs.write_pairs(tmp_path / "c", traffic, 10, "cpu")
    name = "embeds/de/pair01_de.embed"
    rows = np.load(tmp_path / "a" / name)
    assert rows.dtype == np.float16 and rows.shape == (33 * 5 - 10, 16)
    assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert (tmp_path / "a" / name).read_bytes() != (tmp_path / "c" / name).read_bytes()


def test_plant_alignment_covers_both_sides():
    blocks = gen_pairs.plant_alignment(np.random.default_rng(0), 50, 47)
    assert sum((len(x) for x, _ in blocks)) == 50 and sum((len(y) for _, y in blocks)) == 47


def test_encoder_flops_by_hand():
    cfg = {"conv_layers": [[4, 2, 2]], "encoder_dim": 8, "encoder_ffn_dim": 16,
           "conv_pos_groups": 2, "conv_pos_kernel": 3, "encoder_layers": 1}
    # 10 samples -> 5 frames; conv 2*5*4*1*2, projection 2*5*4*8, positional
    # conv 2*5*8*4*3, layer 2*5*(4*64 + 2*128) + 4*25*8
    want = 80 + 320 + 960 + 2 * 5 * (256 + 256) + 800
    assert encoder_flops.laser_window_flops(cfg, 10) == want
    scfg = {"bucket_frames": [200], "model_dim": 8, "ffn_dim": 16, "n_heads": 2, "n_mels": 2,
            "left_max_position_embeddings": 1, "right_max_position_embeddings": 1,
            "conv_kernel": 3, "n_layers": 1, "pool_dim": 8}
    # 720 samples -> 3 frames of 10 ms -> t = 1
    n10, t = 3, 1
    want = (2 * n10 * 256 * 2 + 2 * t * 4 * 8
            + (4 * t * 8 * 16 * 2 + 2 * t * 4 * 64 + 2 * t * 8 * 3 + 4 * t * 8
               + 2 * t * 8 * 16 + 2 * t * 8 * 3 + 2 * t * 64)
            + 2 * 2 * t * 64 + 4 * t * 8 + 2 * 64 + 2 * 64)
    assert encoder_flops.sonar_window_flops(scfg, 720) == want


def test_attention_bound_by_hand():
    # one launch, B = 2, T = 4, H = 1, lengths 4 and 2
    s, kind = attention_bound.attention_bound_s(2, 4, 1, [4, 2], C=3)
    ops = 4 * 64 * (16 + 4)
    nbytes = (4 * 2 * 4 * 64 + 3 * 64) * 2 + 8
    assert s == max(ops / 989e12, nbytes / 3.35e12) and kind == "bytes"
    cfg = {"bucket_frames": [200, 500], "n_layers": 2}
    launches = attention_bound.sonar_launches(cfg, 2, [400 + 160 * 99, 400 + 160 * 300, 400])
    assert launches == [(2, 100, [50, 0])] * 2 + [(2, 250, [150, 0])] * 2


def test_dp_bounds_by_hand():
    s = dp_bounds.launch_bound_s("dense_dp_cuda", {"x": [3], "y": [2]})
    assert s == max((4 * 6 + 12) / 3.35e12, 30 / 67e12)
    s = dp_bounds.launch_bound_s("banded_dp_cuda_batched", {"T": 2, "B": 4, "x": [3], "y": [2]})
    assert s == max((4 * 2 * 6 * 4 + 6 * 8 * 4) / 3.35e12, 2 * 4 * 8 * 4 / 67e12)
    s = dp_bounds.launch_bound_s("dense_traceback_walk_cuda", {"steps": 9, "x": [3], "y": [2]})
    assert s == (6 + 81) / 3.35e12
    s = dp_bounds.launch_bound_s("banded_traceback_walk_cuda", {"a2": 8, "x": [3], "y": [2]})
    assert s == (36 + 112) / 3.35e12


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_references_import_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        names = set(_top_imports(path))
        assert not names & {"svecalign_tpu_torch", "svecalign_tpu", "jax", "jaxlib", "flax"}, path


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    """Import every module a run can load and the port's stage entries, in a
    fresh process, and compare top-level names as whole words."""
    code = (
        "import sys, importlib, pathlib\n"
        "import bench_port.run, bench_port.harness\n"
        "from bench_port.drivers import embed_stage, align_stage\n"
        "from svecalign_tpu_torch.seg_align import embed, align\n"
        "from svecalign_tpu_torch.models import laser_encoder, sonar_encoder\n"
        "from bench_port import harness\n"
        "for p in (harness.HERE / 'metrics').glob('*.py'): harness.load_reader(p.stem)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in harness.FORBIDDEN_MODULES]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert harness.FORBIDDEN_MODULES == ("jax", "jaxlib", "flax", "svecalign_tpu")


def test_without_a_card_the_command_fails_and_prints_no_result():
    """No CUDA device: exit 2, nothing on standard output, no CPU fallback."""
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "import sys; from bench_port import run\n"
            "sys.exit(run.main(['--workload', 'laser.embed_plenary', '--seed', '3',"
            " '--seconds', '1', '--trace', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.parametrize("name", ["laser.embed_plenary", "sonar.embed_plenary",
                                  "laser.embed_plenary_4chip", "laser.align_bucket8"])
def test_cell_config_matches_its_reference(name):
    """Each configuration's file names the widths its reference reads."""
    cell = harness.load_cell(name)
    cfg = cell["config_data"]
    assert cfg["compute_dtype"] == "bfloat16" and cfg["name"] == cell["config"]
    assert cell["check"] and cell["why"]
