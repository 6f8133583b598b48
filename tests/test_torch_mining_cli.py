"""The port's mining CLIs against the JAX package's, on the CPU: stage 6.6
(``postprocess.prep_index``), 6.7 (``score_align``), the host stages 6.8
(``prep_tsv``), 6.9 (``remove_overlaps``), 6.10 (``sort_tsv``), 5.1
(``seg_align.concat_segs``) and 5.2 (``detect_untranslate_concats``).

Same inputs, written from numpy seeds, through both CLIs. Files are
compared byte for byte; the ``.gz`` tsvs once decompressed (a gzip header
holds the time it was written). Stage 6.7's margins agree within 1e-5
relative and its alignment columns are identical; with ``--corpus_quant
int8`` or ``--query_upload fp16`` within the int8 tier's tolerance of the
JAX tests (rtol 0.03, atol 1e-3) of the JAX CLI's same run.
"""

import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svecalign_tpu.postprocess import prep_index as jprep
from svecalign_tpu.postprocess import prep_tsv as jtsv
from svecalign_tpu.postprocess import remove_overlaps as jrm
from svecalign_tpu.postprocess import score_align as jscore
from svecalign_tpu.postprocess import sort_tsv as jsort
from svecalign_tpu.seg_align import concat_segs as jconcat
from svecalign_tpu.seg_align import detect_untranslate_concats as juntrans
from svecalign_tpu.utils import index_utils as jidx
from svecalign_tpu_torch.postprocess import prep_index as tprep
from svecalign_tpu_torch.postprocess import prep_tsv as ttsv
from svecalign_tpu_torch.postprocess import remove_overlaps as trm
from svecalign_tpu_torch.postprocess import score_align as tscore
from svecalign_tpu_torch.postprocess import sort_tsv as tsort
from svecalign_tpu_torch.seg_align import concat_segs as tconcat
from svecalign_tpu_torch.seg_align import detect_untranslate_concats as tuntrans
from svecalign_tpu_torch.utils import file_utils as tfu
from svecalign_tpu_torch.utils import index_utils as tidx
from svecalign_tpu_torch.utils.embedding_utils import write_stopes_embedding

torch.set_num_threads(2)

LANGS = ["--src_lang", "en", "--tgt_lang", "de"]
DIM = 32
PAIRS = [(f"doc{i}_en", f"doc{i}_de", n) for i, n in enumerate((23, 31, 17, 28, 20))]


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + [str(a) for a in argv])
    module.main()


def _run_both(tmod, jmod, argv_of, monkeypatch):
    """Run the port's CLI into ``argv_of("torch")`` and the JAX CLI into
    ``argv_of("jax")``."""
    tmod.main([str(a) for a in argv_of("torch")])
    _run_jax(jmod, argv_of("jax"), monkeypatch)


def _assert_trees_equal(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        got, want = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.suffix == ".gz":
            got, want = gzip.decompress(got), gzip.decompress(want)
        assert got == want, rel


# --- stages 6.6 and 6.7 -------------------------------------------------------------


@pytest.fixture(scope="module")
def mining(tmp_path_factory):
    """Stage-6.5 output as the mining stages read it: per pair and side a
    stopes fp16 embed file of fresh rows, a per-document pool file, and a
    pointer tsv mixing both (rows reused across files, as stage 6.5
    writes them); per pair an alignment file; a metadata tsv that also
    names a pair without embeddings. Row i of a pair's two sides shares a
    latent vector."""
    root = tmp_path_factory.mktemp("mining")
    rng = np.random.default_rng(3)
    embed_root, align_root = root / "embeds" / "en-de", root / "aligns" / "en-de"
    embed_root.mkdir(parents=True)
    align_root.mkdir(parents=True)
    meta = []
    for src, tgt, n in PAIRS:
        pid = f"{src}-{tgt}"
        meta.append(f"/audio/{src}.wav\t/audio/{tgt}.wav\n")
        latent = rng.standard_normal((n, DIM)).astype(np.float32)
        for side, stem in (("src", src), ("tgt", tgt)):
            rows = latent + 0.6 * rng.standard_normal((n, DIM)).astype(np.float32)
            fresh, pool = embed_root / f"{pid}.{side}.embed", embed_root / f"{stem}.pool.embed"
            write_stopes_embedding(rows, str(fresh), fp16=True)
            write_stopes_embedding(np.concatenate([rng.standard_normal((3, DIM)), rows]),
                                   str(pool), fp16=True)
            with open(embed_root / f"{pid}.{side}.tsv", "w") as fp:
                fp.writelines(f"{pool.as_posix()}\t{i + 3}\n" if i % 3 == 1 else
                              f"{fresh.as_posix()}\t{i}\n" for i in range(n))
        with open(align_root / f"{pid}.txt", "w") as fp:
            fp.writelines(f"[{i}]:[{i}]:0.1\n" for i in range(n))
    meta.append("/audio/missing_en.wav\t/audio/missing_de.wav\n")
    (root / "metadata.tsv").write_text("".join(meta))
    return root


def _prep_argv(root, out, extra=()):
    return [root / "metadata.tsv", root / out, "--data_dir", root / "embeds", *LANGS,
            "--embed_fp16", "--embed_stopes", "--sample_ratio", "0.5", *extra]


def _score_argv(root, out, idx, extra=()):
    return [root / "metadata.tsv", root / out, "--embed_dir", root / "embeds", "--align_dir",
            root / "aligns", *LANGS, "--index_dir", root / idx, "--embed_fp16",
            "--embed_stopes", *extra]


@pytest.fixture(scope="module")
def flat_indexes(mining):
    """Stage 6.6 (Flat, the size rule's choice) through both CLIs, both
    languages; run once for the module."""
    mp = pytest.MonkeyPatch()
    try:
        for use_tgt in ([], ["--use_tgt"]):
            tprep.main([str(a) for a in _prep_argv(mining, "idx_torch", use_tgt + ["--device",
                                                                                   "cpu"])])
            _run_jax(jprep, _prep_argv(mining, "idx_jax", use_tgt), mp)
    finally:
        mp.undo()
    return mining


def test_prep_index_flat_files_match_jax(flat_indexes):
    root = flat_indexes
    _assert_trees_equal(root / "idx_torch", root / "idx_jax")
    for lang in ("en", "de"):
        d = root / "idx_torch" / "en-de" / lang
        assert sorted(p.name for p in d.iterdir()) == [
            "Flat.populate.idx", "Flat.train.idx", "sample.embed"]
        vecs = tidx.read_flat_index(d / "Flat.populate.idx")
        assert vecs.shape == (sum(n for *_, n in PAIRS), DIM)
        np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, rtol=1e-6)
        assert tidx.read_flat_index(d / "Flat.train.idx").shape == (0, DIM)
        assert set(tprep.phase_seconds) == {"sample", "train", "populate", "write"}


@pytest.mark.parametrize("margin", ["ratio", "distance"])
def test_score_align_flat_matches_jax(flat_indexes, monkeypatch, margin):
    root = flat_indexes
    tscore.main([str(a) for a in _score_argv(root, f"mrg_t_{margin}", "idx_torch",
                                             ["--k", "4", "--margin", margin, "--device",
                                              "cpu"])])
    _run_jax(jscore, _score_argv(root, f"mrg_j_{margin}", "idx_jax",
                                 ["--k", "4", "--margin", margin]), monkeypatch)
    _assert_margins(root / f"mrg_t_{margin}", root / f"mrg_j_{margin}", rtol=1e-5, atol=0)
    if margin == "ratio":  # the planted pairs stand out
        scores = [c for p in (root / f"mrg_t_{margin}" / "en-de").iterdir()
                  for *_, c in tfu.read_alignments_with_score(p)]
        assert np.mean(np.asarray(scores) > 1.0) > 0.9


def _assert_margins(got_dir, want_dir, rtol, atol):
    names = sorted(p.name for p in (want_dir / "en-de").iterdir())
    assert names == sorted(p.name for p in (got_dir / "en-de").iterdir())
    assert len(names) == len(PAIRS)
    for name in names:
        got = [line.rsplit(":", 1) for line in
               (got_dir / "en-de" / name).read_text().splitlines()]
        want = [line.rsplit(":", 1) for line in
                (want_dir / "en-de" / name).read_text().splitlines()]
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([float(g[1]) for g in got], [float(w[1]) for w in want],
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("extra", [["--corpus_quant", "int8"], ["--query_upload", "fp16"]],
                         ids=["int8", "fp16_upload"])
def test_score_align_cheap_tiers_match_jax(flat_indexes, monkeypatch, extra):
    root, tag = flat_indexes, extra[-1]
    tscore.main([str(a) for a in _score_argv(root, f"mrg_t_{tag}", "idx_torch",
                                             ["--k", "4", "--device", "cpu"] + extra)])
    _run_jax(jscore, _score_argv(root, f"mrg_j_{tag}", "idx_jax", ["--k", "4"] + extra),
             monkeypatch)
    _assert_margins(root / f"mrg_t_{tag}", root / f"mrg_j_{tag}", rtol=1e-5, atol=1e-6)
    _run_jax(jscore, _score_argv(root, "mrg_j_exact", "idx_jax", ["--k", "4"]), monkeypatch)
    _assert_margins(root / f"mrg_t_{tag}", root / "mrg_j_exact", rtol=0.03, atol=1e-3)


def test_ivf_index_and_scores_match_jax(flat_indexes, monkeypatch):
    """IVF8 through both stage-6.6 CLIs: the port trains on its own
    device, so its centroids agree within 1e-5 and its files read in the
    JAX package; stage 6.7 of both CLIs on the JAX files (each package
    reading them) gives the same margins, at a partial probe and at the
    full probe, where they equal the Flat margins."""
    root = flat_indexes
    for use_tgt in ([], ["--use_tgt"]):
        extra = use_tgt + ["--index_type", "IVF8", "--sample_ratio", "1.0"]
        tprep.main([str(a) for a in _prep_argv(root, "ivf_torch", extra + ["--device", "cpu"])])
        _run_jax(jprep, _prep_argv(root, "ivf_jax", extra), monkeypatch)
    for lang in ("en", "de"):
        t = jidx.read_ivf_index(root / "ivf_torch" / "en-de" / lang / "IVF8.populate.idx")
        j = jidx.read_ivf_index(root / "ivf_jax" / "en-de" / lang / "IVF8.populate.idx")
        np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t._vectors, j._vectors)
        assert np.mean(t._assignments == j._assignments) > 0.97
    for probe in ("2", "8"):
        args = ["--k", "4", "--num_probe", probe]
        tscore.main([str(a) for a in _score_argv(root, f"ivf_t{probe}", "ivf_jax",
                                                 args + ["--device", "cpu"])])
        _run_jax(jscore, _score_argv(root, f"ivf_j{probe}", "ivf_jax", args), monkeypatch)
        _assert_margins(root / f"ivf_t{probe}", root / f"ivf_j{probe}", rtol=1e-5, atol=0)
    tscore.main([str(a) for a in _score_argv(root, "ivf_flat", "idx_torch",
                                             ["--k", "4", "--device", "cpu"])])
    _assert_margins(root / "ivf_t8", root / "ivf_flat", rtol=1e-5, atol=0)


def test_score_align_refuses_sharded_index_and_missing_card(flat_indexes, monkeypatch, caplog):
    """--sharded_index (once refused, naming its ROADMAP item) against the
    JAX CLI's on its 8-device CPU mesh, the port on 8 CPU shards
    (SVECALIGN_CPU_DEVICES): Flat and Flat with an int8 corpus within
    1e-5; IVF8 with the int8 flag (ignored with a warning, as in JAX)
    within 1e-5 of the JAX CLI unsharded. The JAX package's sharded IVF
    searches fp16-rounded copies of the fp32 rows (its IVF reader leaves
    ``_fp16_exact`` True, ROADMAP Queue 3), so it is held within 1e-3 of
    the port's. No card still raises."""
    root = flat_indexes
    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "8")
    for extra in ([], ["--corpus_quant", "int8"]):
        tag = "_".join(["sh"] + extra[-1:])
        args = ["--k", "4", "--sharded_index"] + extra
        tscore.main([str(a) for a in _score_argv(root, f"{tag}_t", "idx_torch",
                                                 args + ["--device", "cpu"])])
        _run_jax(jscore, _score_argv(root, f"{tag}_j", "idx_jax", args), monkeypatch)
        _assert_margins(root / f"{tag}_t", root / f"{tag}_j", rtol=1e-5, atol=1e-6)
    for use_tgt in ([], ["--use_tgt"]):
        tprep.main([str(a) for a in _prep_argv(root, "ivf_sh", use_tgt + [
            "--index_type", "IVF8", "--sample_ratio", "1.0", "--device", "cpu"])])
    args = ["--k", "4", "--num_probe", "3", "--sharded_index", "--corpus_quant", "int8"]
    with caplog.at_level("WARNING"):
        tscore.main([str(a) for a in _score_argv(root, "ivf_sh_t", "ivf_sh",
                                                 args + ["--device", "cpu"])])
    assert any("sharded IVF keeps fp16" in r.getMessage() for r in caplog.records)
    _run_jax(jscore, _score_argv(root, "ivf_sh_j", "ivf_sh", args), monkeypatch)
    _assert_margins(root / "ivf_sh_t", root / "ivf_sh_j", rtol=1e-3, atol=0)
    _run_jax(jscore, _score_argv(root, "ivf_j", "ivf_sh", args[:4]), monkeypatch)
    _assert_margins(root / "ivf_sh_t", root / "ivf_j", rtol=1e-5, atol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscore.main([str(a) for a in _score_argv(root, "x", "idx_torch")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tprep.main([str(a) for a in _prep_argv(root, "x")])


# --- stages 6.8, 6.9, 6.10 -----------------------------------------------------------


def _segments(rng, n):
    out, t = [], int(rng.integers(800, 8000))
    for _ in range(n):
        dur = int(rng.integers(8000, 64000))
        out.append((t, t + dur))
        t += dur + int(rng.integers(1600, 16000))
    return out


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Stage-6.7 output for three pairs (one without a file): overlapping
    1-3-segment spans with margins, some of them tied, and the segment
    files."""
    root = tmp_path_factory.mktemp("scored")
    rng = np.random.default_rng(8)
    meta = []
    adir = root / "margins" / "en-de"
    adir.mkdir(parents=True)
    for i, n in enumerate((60, 45, 30)):
        src, tgt = f"p{i}_en", f"p{i}_de"
        meta.append(f"/audio/en/{src}.wav\t/audio/de/{tgt}.wav\n")
        for lang, stem in (("en", src), ("de", tgt)):
            d = root / "segs" / lang
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{stem}.txt").write_text("".join(f"{s} {e}\n" for s, e in _segments(rng, n)))
        if i == 2:
            continue
        lines = []
        for _ in range(80):
            a, b = int(rng.integers(0, n - 3)), int(rng.integers(0, n - 3))
            la, lb = int(rng.integers(1, 4)), int(rng.integers(1, 4))
            margin = np.float32(rng.choice([1.05, 1.2]) if rng.random() < 0.2
                                else rng.uniform(0.8, 1.4))
            lines.append(f"{list(range(a, a + la))}:{list(range(b, b + lb))}:{margin}\n")
        (adir / f"{src}-{tgt}.txt").write_text("".join(lines))
    (root / "metadata.tsv").write_text("".join(meta))
    return root


def test_prep_tsv_remove_overlaps_sort_match_jax(scored, monkeypatch):
    root = scored

    def prep(out):
        return [root / "metadata.tsv", root / out, *LANGS, "--align_dir", root / "margins",
                "--seg_dir", root / "segs"]

    _run_both(ttsv, jtsv, lambda who: prep(f"tsv_{who}"), monkeypatch)
    _assert_trees_equal(root / "tsv_torch", root / "tsv_jax")

    def rm(who):
        d = root / f"tsv_{who}" / "en-de"
        return ["--output_dir", d, "--output_filename", "align.rm_overlap.tsv.gz",
                "--mining_result_path", d / "align.tsv.gz", "--min_audio_length", "2000",
                "--mining_threshold", "0.0", "--max_overlap", "0.8"]

    _run_both(trm, jrm, rm, monkeypatch)

    def srt(who):
        d = root / f"tsv_{who}" / "en-de"
        return ["--in_tsv", d / "align.rm_overlap.tsv.gz",
                "--out_tsv", d / "align.rm_overlap.sort.tsv.gz"]

    _run_both(tsort, jsort, srt, monkeypatch)
    _assert_trees_equal(root / "tsv_torch", root / "tsv_jax")
    d = root / "tsv_torch" / "en-de"
    with tfu.open(d / "align.tsv.gz") as fp:
        n_all = sum(1 for _ in fp)
    with tfu.open(d / "align.rm_overlap.sort.tsv.gz") as fp:
        margins = [float(line.split("\t")[0]) for line in fp]
    assert 0 < len(margins) < n_all == 160
    assert margins == sorted(margins, reverse=True)
    with pytest.raises(FileExistsError):
        tsort.main([str(a) for a in srt("torch")])


# --- stages 5.1 and 5.2 ------------------------------------------------------------


def test_concat_segs_and_untranslated_concats_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(12)
    meta = []
    for i, n in enumerate((50, 35)):
        src, tgt = f"d{i}_en", f"d{i}_de"
        meta.append(f"/audio/en/{src}.wav\t/audio/de/{tgt}.wav\n")
        for lang, stem, side in (("en", src, "src"), ("de", tgt, "tgt")):
            d = tmp_path / "segs" / lang
            d.mkdir(parents=True, exist_ok=True)
            segs = _segments(rng, n)
            segs.append((segs[-1][1] + 100, segs[-1][1] + 100 + 21 * 16000))  # over the cap
            (d / f"{stem}.txt").write_text("".join(f"{s} {e}\n" for s, e in segs))
            u = tmp_path / "untrans_segs" / "en-de"
            u.mkdir(parents=True, exist_ok=True)
            flagged = sorted(rng.choice(n + 1, size=4, replace=False))
            (u / f"{src}-{tgt}.{side}.txt").write_text("".join(f"{k}\n" for k in flagged))
    (tmp_path / "metadata.tsv").write_text("".join(meta))

    for lang, tgt in (("en", []), ("de", ["--use_tgt"])):
        for overlaps, dur in (("5", "20.0"), ("3", "8.5")):
            _run_both(tconcat, jconcat, lambda who: [
                tmp_path / "metadata.tsv", tmp_path / f"cat_{who}_{overlaps}", "--seg_dir",
                tmp_path / "segs", "--lang", lang, "--num_overlaps", overlaps,
                "--max_dur", dur, *tgt], monkeypatch)
    for overlaps in ("5", "3"):
        _assert_trees_equal(tmp_path / f"cat_torch_{overlaps}", tmp_path / f"cat_jax_{overlaps}")
    _run_both(tuntrans, juntrans, lambda who: [
        tmp_path / "metadata.tsv", tmp_path / f"uncat_{who}", "--seg_dir", tmp_path / "segs",
        "--identical_seg_dir", tmp_path / "untrans_segs", *LANGS], monkeypatch)
    _assert_trees_equal(tmp_path / "uncat_torch", tmp_path / "uncat_jax")
    hits = (tmp_path / "uncat_torch" / "en-de" / "d0_en-d0_de.src.txt").read_text().split("\n")
    assert len([h for h in hits if h]) > 0


# --- chip_smoke.py's mining phase, rehearsed ----------------------------------------


def test_chip_smoke_mining_phase_rehearsal(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_mining`` on the CPU at a tiny size: the same
    stages, files and gates as on the card, with the Flat search forced
    tiled (256-row blocks) and stage 6.7 in chunks of 300 queries."""
    import chip_smoke as cs
    from svecalign_tpu_torch.ops import topk as ttopk

    for name, value in (("MINING_PAIRS", 7), ("MINING_ROWS", 900), ("MINING_SUBSET_PAIRS", 4),
                        ("MINING_SUBSET_ROWS", 500), ("MINING_DIM", 128), ("MINING_IVF", "IVF8"),
                        ("MARGIN_CHECK_ROWS", 200)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(ttopk.FlatIndex, "TILE_THRESHOLD", 1)
    monkeypatch.setattr(ttopk.FlatIndex, "BLOCK", 256)
    monkeypatch.setattr(tscore, "CHUNK_ROWS", 300)
    out = cs.phase_mining(tmp_path, torch.device("cpu"))
    log = capsys.readouterr().out
    assert out["n"] == 900 and out["peak"] is None
    assert set(out["split"]) == {"products", "topk", "merge"}
    assert "[time] stage 6.6 (Flat" in log and "[time] stage 6.7 (Flat, tiled" in log
    assert "two trainings" in log
    assert "bit-equal" in log and "[time] Flat search, one direction" in log
