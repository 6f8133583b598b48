"""The port's one-command pipeline (svecalign_tpu_torch.pipeline) against the
JAX package's (svecalign_tpu.pipeline), on the CPU.

Corpus: two synthetic pairs written by ``chip_smoke.write_front_pair``
(seeds 300 and 301, 40 s a side, two planted untranslated segments each),
all 16 stages from the WAVs, the energy VAD, SpeechLASER at a tiny width
(2 layers, d = 128, the full conv geometry) with the JAX package's numpy
init (seed 0) on both sides, ``--max_cost 1000`` (random weights: keep the
cost gate open) and ``--knn_k 4``.

- Port against JAX, ``--pair_batch 1`` (per-pair numpy sampling on both):
  stages 4.1, 4.2, 5.1 and 5.2 byte-identical; ``.embed`` rows within one
  fp16 step. From the JAX run's stage-5.3 files (the ``--stages`` subset):
  alignments identical, costs within 1e-5 (6.1-6.4: the costs' last
  printed digit follows the fp32 summation order), 6.5's tsvs identical
  up to the out dir and its rows within one fp16 step; from the JAX run's
  6.5 output: index files byte-identical, margins within 1e-5 relative,
  the mined tsvs identical but for the margins.
- ``--fused`` against unfused, both at ``--pair_batch 2``: every file
  identical but for the margins (1e-5 relative) and the out dir in 6.5's
  tsvs; the cache hit for every document, no miss.
- ``--overlap_untrans`` against serial: every file identical.
- The argv each stage gets equals the JAX pipeline's, plus ``--device``
  where the stage CLI has it.
"""

import inspect
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import svecalign_tpu.pipeline as jpl
from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.utils import embed_cache as jcache
from svecalign_tpu.utils import embed_model_utils as jemu
from svecalign_tpu_torch import pipeline as tpl
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils import embed_model_utils as temu

torch.set_num_threads(2)

LASER_TINY = dict(
    conv_layers=tuple((32, k, s) for _, k, s in jlaser.LaserEncoderConfig().conv_layers),
    encoder_dim=128, encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256,
    conv_pos_kernel=16, conv_pos_groups=4, dtype="float32")
SECONDS = 40
COMMON = ["--src_lang", "en", "--tgt_lang", "de", "--max_cost", "1000", "--knn_k", "4",
          "--embed_max_tokens", str(40 * 16000)]
MIN = "alignments_1000.0_clean_cat3_min1s"
HOST_DIRS = ("segments", "untrans_segs", "cat_segs", "untrans_cat_seg_ids")
ALIGN_DIRS = ("alignments", "alignments_1000.0", "alignments_1000.0_clean",
              "alignments_1000.0_clean_cat3", MIN)
COST_ATOL = 1e-5
MARGIN_RTOL = 1e-5


def _bound(build, args, kwargs):
    p = inspect.signature(build).bind(*args, **kwargs)
    p.apply_defaults()
    return p.arguments


@pytest.fixture(scope="module")
def tiny_loaders():
    """Both packages' encoder loaders build the tiny LASER (seed-0 weights)."""
    jbuild, tbuild = jemu._build_embed_model, temu._build_embed_model

    def jtiny(*args, **kwargs):
        p = _bound(jbuild, args, kwargs)
        return jlaser.SpeechLaserModel(jlaser.LaserEncoderConfig(**LASER_TINY),
                                       max_tokens=p["max_tokens"],
                                       upload_dtype=p["upload_precision"])

    def ttiny(*args, **kwargs):
        p = _bound(tbuild, args, kwargs)
        return tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(**LASER_TINY),
                                       max_tokens=p["max_tokens"],
                                       upload_dtype=p["upload_precision"], device=p["device"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jemu, "_build_embed_model", jtiny)
        mp.setattr(temu, "_build_embed_model", ttiny)
        jemu._model_memo.clear()
        temu._model_memo.clear()
        yield
    jemu._model_memo.clear()
    temu._model_memo.clear()


def _reset_stats(cache):
    cache.disable()
    for k in cache.stats:
        cache.stats[k] = 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_loaders):
    """J: the JAX pipeline; A: the port, --pair_batch 2; B: A --fused; C: A
    --overlap_untrans; S: the port's stages 5.4-6.5 from J's 5.3 outputs;
    S2: its stages 6.6-6.10 from J's 6.5 outputs."""
    root = tmp_path_factory.mktemp("pipeline")
    lines = []
    for k, seed in enumerate((300, 301)):
        paths = cs.write_front_pair(root / "in", SECONDS, n_planted=2, seed=seed, stem=f"doc{k}")
        lines.append(paths["metadata"].read_text())
    meta = root / "in" / "metadata.tsv"
    meta.write_text("".join(lines))
    out = {k: root / k for k in ("J", "A", "B", "C", "S", "S2")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["pipeline", str(meta), str(out["J"]), *COMMON])
        jpl.main()
    _reset_stats(jcache)

    def port(run, *extra):
        tpl.main([str(meta), str(out[run]), *COMMON, "--device", "cpu", *extra])

    port("A", "--pair_batch", "2")
    _reset_stats(embed_cache)
    port("B", "--pair_batch", "2", "--fused")
    stats = dict(embed_cache.stats)
    _reset_stats(embed_cache)
    port("C", "--pair_batch", "2", "--overlap_untrans")

    for d in (*HOST_DIRS, "embeds"):
        shutil.copytree(out["J"] / d, out["S"] / d)
    port("S", "--stages", "align,filter_cost,filter_untrans,concat_aligns,filter_dur,embed_align")
    for d in ("segments", MIN, f"{MIN}_embed"):
        shutil.copytree(out["J"] / d, out["S2"] / d)
    port("S2", "--stages", "prep_index,score_align,prep_tsv,remove_overlaps,sort")
    return {"out": out, "stats": stats}


def _files(root, sub=""):
    base = Path(root) / sub
    return {p.relative_to(root): p for p in sorted(base.rglob("*")) if p.is_file()}


def _align_lines(path):
    """(the ``[x]:[y]`` parts, the costs) of an alignment file; stages 6.3
    and 6.4 write no cost (zeros then)."""
    keys, costs = [], []
    for line in Path(path).read_text().splitlines():
        *key, last = line.split(":")
        if len(key) == 1:  # "[x]:[y]"
            key, last = key + [last], "0"
        keys.append(tuple(key))
        costs.append(float(last))
    return keys, np.array(costs)


def test_host_stages_byte_identical_to_jax(runs):
    j, a = runs["out"]["J"], runs["out"]["A"]
    assert cs.compare_pipeline_runs(j, a, only=HOST_DIRS) == 16
    # the planted untranslated segments were found
    assert any(f.read_text().strip() for f in _files(a, "untrans_segs").values())


def test_embed_rows_within_one_fp16_step_of_jax(runs):
    j, a = runs["out"]["J"], runs["out"]["A"]
    fj = _files(j, "embeds")
    assert len(fj) == 4 and fj.keys() == _files(a, "embeds").keys()
    for rel, p in fj.items():
        want, got = np.load(p), np.load(a / rel)
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        step = float(np.spacing(np.float16(np.abs(want).max())))
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0,
                                   atol=step)


def test_stages_after_embed_match_jax_from_the_same_files(runs):
    j, s, s2 = (runs["out"][k] for k in ("J", "S", "S2"))
    for d in ALIGN_DIRS:
        fj, fs = _files(j, d), _files(s, d)
        assert fj.keys() == fs.keys() and fj, d
        for rel, p in fj.items():
            (kj, cj), (ks, cs_) = _align_lines(p), _align_lines(fs[rel])
            assert kj == ks and kj, rel
            np.testing.assert_allclose(cs_, cj, rtol=0, atol=COST_ATOL, err_msg=str(rel))
    # 6.5: the pointer tsvs equal up to the out dir, fresh rows within a step
    fj, fs = _files(j, f"{MIN}_embed"), _files(s, f"{MIN}_embed")
    assert fj.keys() == fs.keys() and fj
    for rel, p in fj.items():
        if rel.suffix == ".tsv":
            assert p.read_text().replace(str(j), "OUT") == fs[rel].read_text().replace(
                str(s), "OUT"), rel
        else:
            want, got = np.load(p).astype(np.float32), np.load(fs[rel]).astype(np.float32)
            step = float(np.spacing(np.float16(np.abs(want).max())))
            np.testing.assert_allclose(got, want, rtol=0, atol=step)
    # 6.6-6.10 from the JAX run's 6.5 output
    assert cs.compare_pipeline_runs(
        j, s2, MARGIN_RTOL, only=(f"{MIN}_embed_indexes", f"{MIN}_margin", f"{MIN}_tsvs")) == 11


def test_fused_equals_unfused(runs):
    a, b = runs["out"]["A"], runs["out"]["B"]
    assert cs.compare_pipeline_runs(a, b, MARGIN_RTOL) > 40
    stats = runs["stats"]
    assert stats["hit"] == 4 and stats["miss"] == 0 and stats["rejected"] == 0
    assert stats["gather_miss"] == 0 and stats["gather"] == 4
    assert not embed_cache.enabled  # the pipeline turns the handoff off when it ends


def test_overlap_untrans_equals_serial(runs):
    assert cs.compare_pipeline_runs(runs["out"]["A"], runs["out"]["C"]) > 40


# --- argv of the stages -------------------------------------------------------------


def _record(monkeypatch, pl, *argv, port=True):
    """{stage module's last name: [argv, ...]} of one pipeline call with
    ``_invoke`` recording instead of running."""
    calls = {}
    if port:
        monkeypatch.setattr(pl, "_invoke", lambda mod, *a: calls.setdefault(
            mod.rsplit(".", 1)[1], []).append(a))
        pl.main(list(argv))
    else:
        monkeypatch.setattr(pl, "_invoke", lambda mod, *a, threadsafe=False: calls.setdefault(
            mod.rsplit(".", 1)[1], []).append(a))
        monkeypatch.setattr(sys, "argv", ["pipeline", *argv])
        pl.main()
    return calls


def _drop_device(argv):
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        del argv[i:i + 2]
    return tuple(argv)


DEVICE_STAGES = {"segment", "detect_untranslate_segs", "embed", "align", "filter_untrans_align",
                 "embed_align", "prep_index", "score_align"}


@pytest.mark.parametrize("extra", [
    [],
    ["--embed_model_type", "sonar", "--pair_batch", "8", "--corpus_quant", "int8"],
    ["--sl_ckpt_dir", "/ck", "--src_ckpt_name", "en.npz", "--tgt_ckpt_name", "de.npz",
     "--vad_ckpt", "v.npz", "--max_cost", "0.5", "--min_dur", "1.5", "--rank", "1", "--n_shard",
     "2", "--window_assembly", "host"],
])
def test_stage_argv_equals_jax_plus_device(tmp_path, monkeypatch, extra):
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    argv = [str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de", *extra]
    want = _record(monkeypatch, jpl, *argv, port=False)
    got = _record(monkeypatch, tpl, *argv, "--device", "cpu")
    assert list(got) == list(want) and len(got) == 16
    for stage, calls in got.items():
        assert [_drop_device(a) for a in calls] == want[stage], stage
        for a in calls:
            assert (a[-2:] == ("--device", "cpu")) == (stage in DEVICE_STAGES), stage


def test_stage_modules_have_main_taking_argv():
    """Every stage CLI's main takes argv, and exactly the DEVICE_STAGES
    have a --device option."""
    import importlib

    assert list(tpl.MODULES) == tpl.STAGES == jpl.STAGES
    for stage, module in tpl.MODULES.items():
        mod = importlib.import_module(module)
        assert "argv" in inspect.signature(mod.main).parameters, stage
        has_device = '"--device"' in inspect.getsource(mod.parse_args)
        assert has_device == (module.rsplit(".", 1)[1] in DEVICE_STAGES), stage


def test_format_flags_follow_the_embedder(tmp_path, monkeypatch):
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    base = [str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de",
            "--stages", "align,prep_index,score_align", "--device", "cpu"]
    laser = _record(monkeypatch, tpl, *base)
    assert "--is_stopes_embed" in laser["align"][0] and "--fp16_embed" not in laser["align"][0]
    assert all("--embed_stopes" in a for a in laser["prep_index"] + laser["score_align"])
    sonar = _record(monkeypatch, tpl, *base, "--embed_model_type", "sonar")
    assert "--fp16_embed" in sonar["align"][0] and "--is_stopes_embed" not in sonar["align"][0]
    assert not any("--embed_stopes" in a for a in sonar["prep_index"] + sonar["score_align"])
    assert all("--embed_fp16" in a for a in sonar["prep_index"])


def test_embed_stages_share_one_encoder(tmp_path, monkeypatch):
    """embed and embed_align get the same --max_tokens and --window_assembly
    (load_embed_model memoises on its arguments: a mismatch builds a second
    encoder)."""
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    calls = _record(monkeypatch, tpl, str(meta), str(tmp_path / "out"), "--src_lang", "en",
                    "--tgt_lang", "de", "--stages", "embed,embed_align", "--device", "cpu")
    for name in ("--max_tokens", "--window_assembly", "--device"):
        values = {a[a.index(name) + 1] for a in calls["embed"] + calls["embed_align"]}
        assert len(values) == 1, name
    assert calls["embed"][0][calls["embed"][0].index("--max_tokens") + 1] == str(600 * 16000)


def test_fused_cache_autosizes_for_large_documents(tmp_path, monkeypatch):
    for lang, n in (("en", 5000), ("de", 1)):
        d = tmp_path / "out" / "cat_segs" / lang
        d.mkdir(parents=True)
        (d / f"doc_{lang}.txt").write_text("".join(f"{i} {i + 10}\n" for i in range(n)))
    meta = tmp_path / "md.tsv"
    meta.write_text("/a/doc_en.ogg\t/a/doc_de.ogg\n")
    seen = []
    monkeypatch.setattr(tpl, "_invoke", lambda *a: seen.append(embed_cache.max_rows))
    base = [str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de", "--fused",
            "--stages", "embed", "--device", "cpu"]
    try:
        tpl.main(base)
        assert seen == [5120, 5120]  # 5000 rounded up to 1024s, before the embed stage
        tpl.main(base + ["--fused_max_rows", "2048"])  # an explicit cap wins
        assert seen[2:] == [2048, 2048]
        (tmp_path / "out" / "cat_segs" / "en" / "doc_en.txt").write_text("0 1\n")
        tpl.main(base)
        assert seen[4:] == [4096, 4096]  # never below 4096
    finally:
        _reset_stats(embed_cache)


def test_mesh_flags_forwarded_and_the_stages_name_item_20(tmp_path, monkeypatch):
    """--data_parallel reaches the align stage (only when not 1) and
    --sharded_index score_align, with the JAX pipeline's argv; the stages
    (which once raised, naming ROADMAP item 20) take them: on 8 CPU
    shards, with no pair to align or score here."""
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    base = [str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de",
            "--stages", "align,score_align"]
    plain = _record(monkeypatch, tpl, *base, "--device", "cpu")
    assert "--data_parallel" not in plain["align"][0]
    assert "--sharded_index" not in plain["score_align"][0]
    meshy = _record(monkeypatch, tpl, *base, "--device", "cpu", "--data_parallel", "8",
                    "--sharded_index")
    a = meshy["align"][0]
    assert a[a.index("--data_parallel") + 1] == "8"
    assert "--sharded_index" in meshy["score_align"][0]
    want = _record(monkeypatch, jpl, *base, "--data_parallel", "8", "--sharded_index",
                   port=False)
    for stage in ("align", "score_align"):
        assert [_drop_device(x) for x in meshy[stage]] == [tuple(x) for x in want[stage]]

    from svecalign_tpu_torch.postprocess import score_align
    from svecalign_tpu_torch.seg_align import align

    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "8")
    assert align.main(list(a))["buckets"] == 0
    (tmp_path / "out").mkdir(exist_ok=True)
    score_align.main(list(meshy["score_align"][0]))


def test_no_card_raises_and_unknown_stages_are_refused(tmp_path, monkeypatch):
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    base = [str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de"]
    ran = []
    monkeypatch.setattr(tpl, "_invoke", lambda *a: ran.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.main(base)
    with pytest.raises(ValueError, match="unknown stages"):
        tpl.main(base + ["--stages", "segment,bogus", "--device", "cpu"])
    assert not ran


def test_invoke_passes_argv_and_overlap_errors_reach_the_caller(tmp_path, monkeypatch):
    """``_invoke`` hands argv to main and leaves sys.argv alone; an error
    on the --overlap_untrans thread is raised after the join."""
    import types

    got = []
    fake = types.SimpleNamespace(main=lambda argv: got.append((argv, list(sys.argv))))
    monkeypatch.setitem(sys.modules, "fake_stage_mod", fake)
    before = list(sys.argv)
    tpl._invoke("fake_stage_mod", "a", "--b")
    assert got == [(["a", "--b"], before)] and tpl.stage_seconds["fake_stage_mod"] >= 0

    def invoke(mod, *argv):
        if mod.endswith("detect_untranslate_segs"):
            raise OSError("untrans failed")

    monkeypatch.setattr(tpl, "_invoke", invoke)
    meta = tmp_path / "md.tsv"
    meta.write_text("/a_en.ogg\t/a_de.ogg\n")
    with pytest.raises(OSError, match="untrans failed"):
        tpl.main([str(meta), str(tmp_path / "out"), "--src_lang", "en", "--tgt_lang", "de",
                  "--overlap_untrans", "--stages", "untrans_segs,embed,align", "--device", "cpu"])
