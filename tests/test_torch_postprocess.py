"""The port's post-align stages against the JAX package's, on the CPU:
the copied ``utils/file_utils`` functions on random alignments, the
host stages 6.1, 6.3 and 6.4 (``postprocess.filter_by_cost``,
``concat_aligns``, ``filter_by_dur``; byte-identical output) and the
stage-6.5 CLI (``postprocess.embed_align``) with both encoders.

Stage 6.5 runs on a synthetic pair (two WAVs written by the port's
writer, their segment and concat-window files, an alignment file as
stage 5.4 writes it, filtered by stage 6.1), each package's
``_build_embed_model`` patched to a small model loaded from one npz.
Its ``.tsv`` files are identical once each CLI's own out-dir prefix is
replaced; the ``.embed`` rows (fp16) agree within one fp16 step at the
rows' magnitude (the fp32 encoders differ by ~1e-5 relative before the
cast).
"""

import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import param_utils as jparams
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.postprocess import concat_aligns as jconcat
from svecalign_tpu.postprocess import embed_align as jembed_align
from svecalign_tpu.postprocess import filter_by_cost as jfilter
from svecalign_tpu.postprocess import filter_by_dur as jdur
from svecalign_tpu.utils import embed_model_utils as jemu
from svecalign_tpu.utils import file_utils as jfu
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.postprocess import concat_aligns as tconcat
from svecalign_tpu_torch.postprocess import embed_align as tembed_align
from svecalign_tpu_torch.postprocess import filter_by_cost as tfilter
from svecalign_tpu_torch.postprocess import filter_by_dur as tdur
from svecalign_tpu_torch.utils import audio_io as taudio
from svecalign_tpu_torch.utils import embed_model_utils as temu
from svecalign_tpu_torch.utils import file_utils as tfu

torch.set_num_threads(2)

LASER_SMALL = dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_dim=128,
                   encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256, conv_pos_kernel=16,
                   conv_pos_groups=4, dtype="float32")
SONAR_SMALL = dict(n_mels=80, model_dim=128, n_layers=2, n_heads=2, ffn_dim=256,
                   conv_kernel=31, pool_dim=128, dtype="float32")
SRC, TGT = "doc_en", "doc_de"


def random_alignments(rng, n_src, n_tgt, p_deletion=0.15):
    """A monotone path of 1-3 segment runs on each side with 6-decimal
    costs, and some deletions, as stage 5.4 writes it."""
    out, i, j = [], 0, 0
    while i < n_src and j < n_tgt:
        if rng.random() < p_deletion:
            if rng.random() < 0.5:
                out.append(([i], [], 0.0))
                i += 1
            else:
                out.append(([], [j], 0.0))
                j += 1
            continue
        a = int(min(rng.integers(1, 4), n_src - i))
        b = int(min(rng.integers(1, 4), n_tgt - j))
        out.append((list(range(i, i + a)), list(range(j, j + b)), float(rng.uniform(0, 1.2))))
        i, j = i + a, j + b
    return out


def alignment_text(aligns):
    return "".join(f"{x}:{y}:{c:.6f}\n" for x, y, c in aligns)


# --- file_utils ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_file_utils_match_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n_src, n_tgt = 40, 37
    src_segs = sorted(int(s) for s in rng.choice(10**6, n_src, replace=False))
    src_segs = [(s, s + int(rng.integers(1000, 9000))) for s in src_segs]
    tgt_segs = [(int(s), int(s) + 4000) for s in sorted(rng.choice(10**6, n_tgt, replace=False))]
    aligns = random_alignments(rng, n_src, n_tgt)
    path = tmp_path / "a.txt"
    path.write_text(alignment_text(aligns))

    assert tfu.read_alignments_with_score(path) == jfu.read_alignments_with_score(path)
    pairs = [(x, y) for x, y, _ in aligns]
    for name, fu in (("t", tfu), ("j", jfu)):
        fu.write_alignment(pairs, tmp_path / f"w_{name}.txt")
        fu.write_segments(src_segs, tmp_path / f"s_{name}.txt.gz")
    assert (tmp_path / "w_t.txt").read_bytes() == (tmp_path / "w_j.txt").read_bytes()
    assert tfu.read_alignments(tmp_path / "w_t.txt") == pairs
    with gzip.open(tmp_path / "s_t.txt.gz", "rt") as a, gzip.open(tmp_path / "s_j.txt.gz", "rt") as b:
        assert a.read() == b.read()
    with tfu.open(tmp_path / "s_t.txt.gz") as fp:
        assert fp.readline() == f"{src_segs[0][0]} {src_segs[0][1]}\n"

    # deletions are skipped, or raise
    for src in (path, pairs):
        assert tfu.alignments_to_timestamps(src, src_segs, tgt_segs) == \
            jfu.alignments_to_timestamps(src, src_segs, tgt_segs)
    with pytest.raises(Exception, match="empty alignments"):
        tfu.alignments_to_timestamps(pairs, src_segs, tgt_segs, ignore_empty=False)
    kept = [(x, y) for x, y in pairs if x and y]
    assert tfu.alignments_to_timestamps(kept, src_segs, tgt_segs, ignore_empty=False) == \
        jfu.alignments_to_timestamps(kept, src_segs, tgt_segs, ignore_empty=False)
    with pytest.raises(TypeError):
        tfu.alignments_to_timestamps(3, src_segs, tgt_segs)

    tfu.delete_if_exist(path)
    assert not path.exists()
    tfu.delete_if_exist(path)  # a missing file is no error


# --- stage 6.1 ---------------------------------------------------------------------


def _filter_tree(root, rng):
    """Three pairs: random alignments, only deletions, and no file."""
    md = root / "metadata.tsv"
    names = [("a_en", "a_de"), ("b_en", "b_de"), ("c_en", "c_de")]
    md.write_text("".join(f"/x/{s}.wav\t/y/{t}.wav\n" for s, t in names))
    adir = root / "align" / "en-de"
    adir.mkdir(parents=True)
    (adir / "a_en-a_de.txt").write_text(alignment_text(random_alignments(rng, 60, 55)))
    (adir / "b_en-b_de.txt").write_text("[0]:[]:0.000000\n[]:[0]:0.000000\n")
    return md


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


@pytest.mark.parametrize("max_cost", [0.7, 0.25])
def test_filter_by_cost_cli_matches_jax(tmp_path, monkeypatch, max_cost):
    md = _filter_tree(tmp_path, np.random.default_rng(3))
    argv = lambda out: [str(md), str(tmp_path / out), "--align_dir", str(tmp_path / "align"),
                        "--max_cost", str(max_cost), "--src_lang", "en", "--tgt_lang", "de"]
    tfilter.main(argv("torch"))
    _run_jax(jfilter, argv("jax"), monkeypatch)
    got = sorted(p.name for p in (tmp_path / "torch" / "en-de").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "jax" / "en-de").iterdir()) == ["a_en-a_de.txt"]
    out = tmp_path / "torch" / "en-de" / "a_en-a_de.txt"
    assert out.read_bytes() == (tmp_path / "jax" / "en-de" / "a_en-a_de.txt").read_bytes()
    kept = tfu.read_alignments_with_score(out)
    assert kept and all(x and y and c <= max_cost for x, y, c in kept)


def test_do_filter_bounds(tmp_path):
    """The bound is inclusive, deletions always go, a missing input is a
    pair with nothing to lose."""
    path = tmp_path / "a.txt"
    path.write_text("[0]:[0]:0.100000\n[1]:[1]:0.900000\n[2]:[]:0.000000\n")
    assert tfilter.do_filter(str(path), str(tmp_path / "lo.txt"), 0.1) == 1 / 3
    assert (tmp_path / "lo.txt").read_text() == "[0]:[0]:0.1\n"
    assert tfilter.do_filter(str(path), str(tmp_path / "none.txt"), 0.05) == 0.0
    assert not (tmp_path / "none.txt").exists()
    assert tfilter.do_filter(str(tmp_path / "gone.txt"), str(tmp_path / "x.txt"), 1.0) == 1.0


# --- stages 6.3 and 6.4 -----------------------------------------------------------


def speech_segments(rng, n):
    """VAD-like segments: 0.3-4 s of speech, 0.1-1.6 s of silence between
    (so that some gaps pass stage 6.3's 1-s rule and some do not)."""
    out, t = [], int(rng.integers(0, 16000))
    for _ in range(n):
        d = int(rng.uniform(0.3, 4.0) * 16000)
        out.append((t, t + d))
        t += d + int(rng.uniform(0.1, 1.6) * 16000)
    return out


@pytest.mark.parametrize("max_num_align,max_dur,both", [(3, 20.0, True), (3, 20.0, False),
                                                         (5, 12.0, True), (1, 20.0, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_alignments_match_jax(seed, max_num_align, max_dur, both):
    rng = np.random.default_rng(10 + seed)
    src, tgt = speech_segments(rng, 120), speech_segments(rng, 110)
    aligns = [(x, y) for x, y, _ in random_alignments(rng, 120, 110) if x and y]
    kw = dict(max_num_align=max_num_align, max_sil=1.0, max_dur=max_dur, sample_rate=16000,
              apply_dur_cond_to_both_sides=both)
    got = tconcat.chain_alignments(aligns, src, tgt, **kw)
    assert got == jconcat.chain_alignments(aligns, src, tgt, **kw)
    assert got[0] == aligns[0] and len(got) >= len(aligns)
    for x, y in got:  # every chain is contiguous
        assert x == list(range(x[0], x[-1] + 1)) and y == list(range(y[0], y[-1] + 1))
    if max_num_align > 1:
        assert len(got) > len(aligns)  # some anchors chain


def _dur_tree(root, rng):
    """Stage 6.1's output for two pairs (one without a file), with their
    segment tables."""
    md = root / "metadata.tsv"
    names = [("a_en", "a_de"), ("c_en", "c_de")]
    md.write_text("".join(f"/x/{s}.wav\t/y/{t}.wav\n" for s, t in names))
    for lang, stem, n in (("en", "a_en", 150), ("de", "a_de", 140)):
        (root / "seg" / lang).mkdir(parents=True)
        tfu.write_segments(speech_segments(rng, n), root / "seg" / lang / f"{stem}.txt")
    adir = root / "align" / "en-de"
    adir.mkdir(parents=True)
    kept = [a for a in random_alignments(rng, 150, 140) if a[0] and a[1]]
    (adir / "a_en-a_de.txt").write_text(alignment_text(kept))
    return md


@pytest.mark.parametrize("min_dur", [1.0, 4.0])
def test_concat_aligns_and_filter_by_dur_cli_match_jax(tmp_path, monkeypatch, min_dur):
    """Stages 6.3 (at the pipeline's settings) and 6.4 through both CLIs:
    byte-identical files, the same files written."""
    md = _dur_tree(tmp_path, np.random.default_rng(4))
    common = lambda d: ["--seg_dir", str(tmp_path / "seg"), "--src_lang", "en",
                        "--tgt_lang", "de", "--align_dir", str(tmp_path / d)]
    for pkg, concat, dur in (("torch", tconcat.main, tdur.main),
                             ("jax", lambda a: _run_jax(jconcat, a, monkeypatch),
                              lambda a: _run_jax(jdur, a, monkeypatch))):
        concat([str(md), str(tmp_path / f"cat_{pkg}"), "--max_num_align", "3",
                "--apply_dur_cond_to_both_sides"] + common("align"))
        dur([str(md), str(tmp_path / f"min_{pkg}"), "--min_dur", str(min_dur)]
            + common(f"cat_{pkg}"))
    for stage in ("cat", "min"):
        t, j = tmp_path / f"{stage}_torch" / "en-de", tmp_path / f"{stage}_jax" / "en-de"
        assert sorted(p.name for p in t.iterdir()) == sorted(p.name for p in j.iterdir()) \
            == ["a_en-a_de.txt"]
        assert (t / "a_en-a_de.txt").read_bytes() == (j / "a_en-a_de.txt").read_bytes()
    segs = {lang: tfu.read_segments(tmp_path / "seg" / lang / f"a_{lang}.txt")
            for lang in ("en", "de")}
    chained = tfu.read_alignments(tmp_path / "cat_torch" / "en-de" / "a_en-a_de.txt")
    kept = tfu.read_alignments(tmp_path / "min_torch" / "en-de" / "a_en-a_de.txt")
    assert 0 < len(kept) < len(chained)
    for x, y in kept:
        assert segs["en"][x[-1]][1] - segs["en"][x[0]][0] >= min_dur * 16000
        assert segs["de"][y[-1]][1] - segs["de"][y[0]][0] >= min_dur * 16000


def test_filter_by_dur_writes_nothing_when_all_short(tmp_path):
    segs = [(i * 32000, i * 32000 + 8000) for i in range(4)]
    tfu.write_segments(segs, tmp_path / "s.txt")
    (tmp_path / "a.txt").write_text("[0]:[0]\n[1, 2]:[1]\n")
    tdur.do_filter(tmp_path / "a.txt", tmp_path / "s.txt", tmp_path / "s.txt", 16000,
                   tmp_path / "out.txt")
    assert not (tmp_path / "out.txt").exists()
    tdur.do_filter(tmp_path / "a.txt", tmp_path / "s.txt", tmp_path / "s.txt", 8000,
                   tmp_path / "out.txt")
    assert (tmp_path / "out.txt").read_text() == "[0]:[0]\n[1, 2]:[1]\n"


# --- stage 6.5 ---------------------------------------------------------------------


def _segments(n_seconds, hop, durs):
    return [(s, s + d) for s, d in zip(range(0, n_seconds * 16000, hop), durs * 40)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A synthetic en/de pair ready for stage 6.5: WAVs, segments, concat
    windows of 1-2 segments (so alignment spans of 3 segments miss), the
    filtered alignments, and npz weights of both small encoders."""
    root = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    segs = {"en": _segments(21, 27000, [9000, 21000, 15000]),
            "de": _segments(21, 25000, [12000, 8000, 18000])}
    for lang, stem in (("en", SRC), ("de", TGT)):
        wav = (0.3 * rng.standard_normal(24 * 16000)).astype(np.float32)
        (root / "raw").mkdir(exist_ok=True)
        taudio.write(str(root / "raw" / f"{stem}.wav"), wav, 16000)
        for sub in ("seg", "cat"):
            (root / sub / lang).mkdir(parents=True)
        s = segs[lang]
        tfu.write_segments(s, root / "seg" / lang / f"{stem}.txt")
        cat = sorted({f"{s[i][0]} {s[j][1]}" for i in range(len(s))
                      for j in range(i, min(i + 2, len(s)))})
        (root / "cat" / lang / f"{stem}.txt").write_text("".join(c + "\n" for c in cat))
    (root / "metadata.tsv").write_text(f"{root / 'raw' / SRC}.wav\t{root / 'raw' / TGT}.wav\n")
    raw = root / "align5" / "en-de"
    raw.mkdir(parents=True)
    aligns = random_alignments(np.random.default_rng(1), len(segs["en"]), len(segs["de"]))
    (raw / f"{SRC}-{TGT}.txt").write_text(alignment_text(aligns))
    tfilter.main([str(root / "metadata.tsv"), str(root / "align"), "--align_dir",
                  str(root / "align5"), "--max_cost", "1.0", "--src_lang", "en",
                  "--tgt_lang", "de"])
    n_align = len(tfu.read_alignments(root / "align" / "en-de" / f"{SRC}-{TGT}.txt"))

    npz = {}
    m = jlaser.LaserSpeechEncoder(jlaser.LaserEncoderConfig(**LASER_SMALL))
    p = jparams.numpy_init(m, (jnp.zeros((1, 4000)), jnp.zeros((1,), jnp.int32)), seed=6)
    npz["speech_laser"] = str(root / "laser.npz")
    jparams.save_params_npz(p, npz["speech_laser"])
    m = jsonar.SonarSpeechEncoder(jsonar.SonarEncoderConfig(**SONAR_SMALL))
    p = jparams.numpy_init(m, (jnp.zeros((1, 50, 160)), jnp.ones((1, 50), bool)), seed=7)
    npz["sonar"] = str(root / "sonar.npz")
    jparams.save_params_npz(p, npz["sonar"])
    return dict(root=root, npz=npz, n_align=n_align)


def _upload(args, kwargs):
    return kwargs.get("upload_precision", args[7] if len(args) > 7 else "int16")


@pytest.fixture
def small_models(pair, monkeypatch):
    """Both packages' loaders build the small models from the pair's npz."""
    def jbuild(kind, *args, **kwargs):
        if kind == "speech_laser":
            m = jlaser.SpeechLaserModel(jlaser.LaserEncoderConfig(**LASER_SMALL),
                                        ckpt_path=pair["npz"][kind], max_tokens=64000,
                                        upload_dtype=_upload(args, kwargs))
            m.BUCKETS = (16000, 32000, 80000)
        else:
            m = jsonar.SonarSpeechModel(
                jsonar.SonarEncoderConfig(**SONAR_SMALL, attention_backend="xla"),
                ckpt_path=pair["npz"][kind], batch_size=4, upload_dtype=_upload(args, kwargs))
            m.BUCKET_FRAMES = (100, 250, 700)
        m.WAVE_BUCKETS_S = (30,)
        return m

    def tbuild(kind, *args, **kwargs):
        if kind == "speech_laser":
            m = tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(**LASER_SMALL),
                                        ckpt_path=pair["npz"][kind], max_tokens=64000,
                                        upload_dtype=_upload(args, kwargs), device="cpu")
            m.BUCKETS = (16000, 32000, 80000)
        else:
            m = tsonar.SonarSpeechModel(tsonar.SonarEncoderConfig(**SONAR_SMALL),
                                        ckpt_path=pair["npz"][kind], batch_size=4,
                                        upload_dtype=_upload(args, kwargs), device="cpu")
            m.BUCKET_FRAMES = (100, 250, 700)
        m.WAVE_BUCKETS_S = (30,)
        return m

    monkeypatch.setattr(jemu, "_build_embed_model", jbuild)
    monkeypatch.setattr(temu, "_build_embed_model", tbuild)
    jemu._model_memo.clear()
    temu._model_memo.clear()
    yield
    jemu._model_memo.clear()
    temu._model_memo.clear()


def _argv(pair, out, kind, use_tgt, align="align"):
    root = pair["root"]
    argv = [str(root / "metadata.tsv"), str(out), "--src_lang", "en", "--tgt_lang", "de",
            "--align_dir", str(root / align), "--seg_dir", str(root / "seg"),
            "--concat_seg_dir", str(root / "cat"), "--concat_seg_embed_dir",
            str(root / "cat_embed"), "--embed_model_type", kind, "--batch_size", "4"]
    return argv + (["--use_tgt"] if use_tgt else [])


def read_embed(path, kind, dim=128):
    if kind == "speech_laser":
        return np.load(path).astype(np.float32)  # a stopes .npy
    return np.fromfile(path, dtype=np.float16).reshape(-1, dim).astype(np.float32)


def fp16_step(rows):
    """One fp16 step at the largest magnitude of ``rows``."""
    return float(np.spacing(np.float16(np.abs(rows).max())))


@pytest.mark.parametrize("use_tgt", [False, True])
@pytest.mark.parametrize("kind", ["speech_laser", "sonar"])
def test_embed_align_cli_matches_jax(pair, small_models, tmp_path, monkeypatch, kind, use_tgt):
    tembed_align.main(_argv(pair, tmp_path / "torch", kind, use_tgt) + ["--device", "cpu"])
    _run_jax(jembed_align, _argv(pair, tmp_path / "jax", kind, use_tgt), monkeypatch)

    side = "tgt" if use_tgt else "src"
    name = f"{SRC}-{TGT}.{side}"
    tdir, jdir = tmp_path / "torch" / "en-de", tmp_path / "jax" / "en-de"
    tsv = (tdir / f"{name}.tsv").read_text()
    assert tsv == (jdir / f"{name}.tsv").read_text().replace(
        (tmp_path / "jax").as_posix(), (tmp_path / "torch").as_posix())
    assert sorted(p.name for p in tdir.iterdir()) == [f"{name}.embed", f"{name}.tsv"]

    lines = [line.split("\t") for line in tsv.splitlines()]
    assert len(lines) == pair["n_align"]
    lang, stem = ("de", TGT) if use_tgt else ("en", SRC)
    n_cat = len(tfu.read_lines(pair["root"] / "cat" / lang / f"{stem}.txt"))
    hits = [int(r) for p, r in lines if p.endswith(f"cat_embed/{lang}/{stem}.embed")]
    misses = [int(r) for p, r in lines if p == (tdir / f"{name}.embed").as_posix()]
    assert hits and misses and len(hits) + len(misses) == len(lines)
    assert max(hits) < n_cat

    got = read_embed(tdir / f"{name}.embed", kind)
    want = read_embed(jdir / f"{name}.embed", kind)
    assert got.shape == want.shape and got.shape[1] == 128
    assert sorted(set(misses)) == list(range(len(got)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=fp16_step(want))

    # the tsv marks the pair as done: a second run leaves it alone
    mtime = (tdir / f"{name}.tsv").stat().st_mtime_ns
    tembed_align.main(_argv(pair, tmp_path / "torch", kind, use_tgt) + ["--device", "cpu"])
    assert (tdir / f"{name}.tsv").stat().st_mtime_ns == mtime


def test_embed_align_raises_on_deletions(pair, small_models, tmp_path):
    """Unfiltered stage-5.4 alignments hold deletions: stage 6.5 raises,
    as the JAX one does (stage 6.1 must run first), and writes no tsv."""
    with pytest.raises(Exception, match="empty alignments"):
        tembed_align.main(_argv(pair, tmp_path, "speech_laser", False, align="align5")
                          + ["--device", "cpu"])
    assert not list((tmp_path / "en-de").glob("*.tsv"))


def test_embed_align_default_device_raises_without_card(pair, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tembed_align.main(_argv(pair, tmp_path, "speech_laser", False))
