"""The port's front-of-pipeline CLIs against the JAX package's, on the CPU
(``--device cpu``; the JAX CLIs in-process with JAX on the CPU): stage 4.1
(``preprocess.segment``, energy and Silero on a seeded ``.npz``), 4.2
(``preprocess.detect_untranslate_segs``), 6.2
(``postprocess.filter_untrans_align``) and ``analysis.dump_alignments``
write the same files, byte for byte, on pairs written by
``chip_smoke.write_front_pair`` (planted untranslated copies among
unrelated speech-like segments), the port with ``--n_proc 2`` too. Also
the ``.ogg`` reader and writer against the JAX package's native ones, the
card rule of the new CLIs, and ``chip_smoke.phase_front`` rehearsed at a
small size.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svecalign_tpu.analysis import dump_alignments as jdump
from svecalign_tpu.models import vad as jvad
from svecalign_tpu.postprocess import filter_untrans_align as jfilter
from svecalign_tpu.preprocess import detect_untranslate_segs as jdetect
from svecalign_tpu.preprocess import segment as jsegment
from svecalign_tpu.utils import audio_io as jaudio
from svecalign_tpu_torch.analysis import dump_alignments as tdump
from svecalign_tpu_torch.postprocess import filter_untrans_align as tfilter
from svecalign_tpu_torch.preprocess import detect_untranslate_segs as tdetect
from svecalign_tpu_torch.preprocess import segment as tsegment
from svecalign_tpu_torch.utils import audio_io as taudio

from .test_torch_vad import threshold_between

torch.set_num_threads(2)

LANGS = ["--src_lang", "en", "--tgt_lang", "de"]
STEMS = ("docA", "docB", "docC")
THRES = 5.0


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + [str(a) for a in argv])
    module.main()


def _assert_trees_equal(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return files


@pytest.fixture(scope="module")
def front(tmp_path_factory):
    """Three 45-second pairs (2, 3 and 0 planted copies) under one root,
    and a pair of silent files with empty segment files; the metadata
    names all four."""
    root = tmp_path_factory.mktemp("front")
    pairs = {}
    for k, (stem, n_planted) in enumerate(zip(STEMS, (2, 3, 0))):
        pairs[stem] = cs.write_front_pair(root, 45, n_planted, seed=40 + k, stem=stem)
    silent = []
    for lang in ("en", "de"):
        p = root / "raw_audios" / lang / f"quiet_{lang}.wav"
        taudio.write(str(p), np.zeros(16000 * 3, np.float32), 16000)
        (root / "segments" / lang / f"quiet_{lang}.txt").write_text("")
        silent.append(str(p))
    lines = [f"{p['en']}\t{p['de']}" for p in pairs.values()] + ["\t".join(silent)]
    (root / "metadata.tsv").write_text("\n".join(lines) + "\n")
    return root, pairs


def test_write_front_pair_plants_copies(front):
    root, pairs = front
    a = pairs["docB"]
    src, tgt = a["segments"]["en"], a["segments"]["de"]
    assert len(a["planted"]) == 3
    x = taudio.read(str(a["en"]))[0]
    y = taudio.read(str(a["de"]))[0]
    for i, j in a["planted"]:
        assert src[i] == tgt[j]
        lo, hi = src[i][0] - 8000, src[i][1] + 8000
        np.testing.assert_array_equal(x[lo:hi], y[lo:hi])
    mids = [(s + e) / 2 for s, e in tgt]
    assert all(m0 < m1 for m0, m1 in zip(mids, mids[1:]))
    # every candidate's verdict is far from the threshold, on either side
    for stem, p in pairs.items():
        mses = cs.untrans_candidates(p["segments"]["en"], p["segments"]["de"], p["en"], p["de"])
        assert set(p["planted"]) <= {k for k, v in mses.items() if v == 0.0}
        assert all(abs(v - THRES) > 0.05 for v in mses.values()), stem


@pytest.mark.parametrize("extra", [[], ["--rank", "1", "--n_shard", "2"]])
def test_segment_energy_cli_matches_jax(front, tmp_path, monkeypatch, extra):
    root, _ = front
    for lang, tgt in (("en", []), ("de", ["--use_tgt"])):
        argv = [root / "metadata.tsv", None, "--lang", lang, *tgt, *extra]
        tsegment.main([str(a) for a in argv[:1]] + [str(tmp_path / "torch")]
                      + [str(a) for a in argv[2:]] + ["--device", "cpu"])
        argv[1] = tmp_path / "jax"
        _run_jax(jsegment, argv, monkeypatch)
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert len(files) == (8 if not extra else 4)
    sizes = {f.name: (tmp_path / "torch" / f).stat().st_size for f in files}
    assert sizes.get("quiet_en.txt", 0) == 0  # the no-speech placeholder
    # a second run skips what exists
    before = {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in files}
    tsegment.main([str(root / "metadata.tsv"), str(tmp_path / "torch"), "--lang", "en",
                   "--device", "cpu", *extra])
    assert before == {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in files}


def test_segment_silero_cli_matches_jax(front, tmp_path, monkeypatch):
    root, pairs = front
    w = jvad._v4_random_weights(jvad.SileroV4Config(), seed=9)
    np.savez(tmp_path / "silero.npz", **w)
    model = jvad.SileroV4VAD(ckpt_path=str(tmp_path / "silero.npz"))
    ens = [line.split("\t")[0] for line in (root / "metadata.tsv").read_text().splitlines()]
    probs = np.concatenate([np.asarray(model.speech_probs(taudio.read(en)[0])) for en in ens])
    argv = ["--lang", "en", "--vad_model", "silero_jax", "--vad_ckpt", tmp_path / "silero.npz",
            "--threshold", repr(threshold_between(probs))]
    tsegment.main([str(root / "metadata.tsv"), str(tmp_path / "torch")]
                  + [str(a) for a in argv] + ["--device", "cpu"])
    _run_jax(jsegment, [root / "metadata.tsv", tmp_path / "jax", *argv], monkeypatch)
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert sum((tmp_path / "torch" / f).stat().st_size > 0 for f in files) >= 3


@pytest.mark.parametrize("n_proc", [1, 2])
def test_detect_untranslate_segs_cli_matches_jax(front, tmp_path, monkeypatch, n_proc):
    root, pairs = front
    argv = ["--seg_dir", root / "segments", *LANGS]
    tdetect.main([str(root / "metadata.tsv"), str(tmp_path / "torch")]
                 + [str(a) for a in argv] + ["--n_proc", str(n_proc), "--device", "cpu"])
    _run_jax(jdetect, [root / "metadata.tsv", tmp_path / "jax", *argv], monkeypatch)
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert len(files) == 8 and not any(f.suffix == ".tmp" for f in files)
    d = tmp_path / "torch" / "en-de"
    for stem, p in pairs.items():
        rows = [(d / f"{stem}_en-{stem}_de.{s}.txt").read_text().split() for s in ("src", "tgt")]
        assert set(p["planted"]) <= {(int(i), int(j)) for i, j in zip(*rows)}
    assert (d / "quiet_en-quiet_de.src.txt").read_text() == ""


def _write_alignments(root, pairs):
    """Per pair: the planted copies paired with their sources, plus 1-1
    and 2-1 alignments of the other segments; docA's file holds its
    planted rows alone, so that stage 6.2 drops it entirely. Returns the
    planted rows' ``[i]:[j]`` per pair."""
    adir = root / "align" / "en-de"
    adir.mkdir(parents=True, exist_ok=True)
    expect_dropped = {}
    for stem, p in pairs.items():
        src, tgt = p["segments"]["en"], p["segments"]["de"]
        planted = p["planted"]
        if stem == "docA":
            rows = [([i], [j]) for i, j in planted]
        else:
            pi, pj = {i for i, _ in planted}, {j for _, j in planted}
            others = list(zip([i for i in range(len(src)) if i not in pi],
                              [j for j in range(len(tgt)) if j not in pj]))
            rows = [([i], [j]) for i, j in planted]
            rows += [([i, i + 1], [j]) if k % 5 == 4 and (i + 1) not in pi and i + 1 < len(src)
                     else ([i], [j]) for k, (i, j) in enumerate(others)]
            rows.sort()
        lines = [f"{a}:{b}:{0.1 + 0.01 * (k % 50):.6f}" for k, (a, b) in enumerate(rows)]
        (adir / f"{stem}_en-{stem}_de.txt").write_text("\n".join(lines) + "\n")
        expect_dropped[stem] = {f"{[i]}:{[j]}" for i, j in planted}
    return expect_dropped


def test_filter_untrans_align_cli_matches_jax(front, tmp_path, monkeypatch):
    root, pairs = front
    expect = _write_alignments(tmp_path, pairs)
    argv = ["--align_dir", tmp_path / "align", "--seg_dir", root / "segments", *LANGS,
            "--save_audio"]
    tfilter.main([str(root / "metadata.tsv"), str(tmp_path / "torch")]
                 + [str(a) for a in argv] + ["--n_proc", "2", "--device", "cpu"])
    _run_jax(jfilter, [root / "metadata.tsv", tmp_path / "jax", *argv], monkeypatch)
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert any(f.suffix == ".ogg" for f in files)
    d = tmp_path / "torch" / "en-de"
    assert not (d / "docA_en-docA_de.txt").exists()  # every alignment dropped: no file
    for stem in ("docB", "docC"):
        lines = (tmp_path / "align" / "en-de" / f"{stem}_en-{stem}_de.txt").read_text()
        kept = (d / f"{stem}_en-{stem}_de.txt").read_text().splitlines()
        lines = lines.splitlines()
        assert kept == [ln for ln in lines if ln in set(kept)]  # original lines, in order
        assert not {ln.rsplit(":", 1)[0] for ln in kept} & expect[stem]
    assert len(list((d / "wavs" / "docB_en-docB_de").glob("*.src.ogg"))) >= 3


def test_dump_alignments_matches_jax(front, tmp_path, monkeypatch):
    root, pairs = front
    _write_alignments(tmp_path, pairs)
    argv = ["--align_dir", tmp_path / "align", "--seg_dir", root / "segments", *LANGS,
            "--max_rows", "7", "--rows_per_page", "3"]
    tdump.main([str(root / "metadata.tsv"), str(tmp_path / "torch")] + [str(a) for a in argv])
    _run_jax(jdump, [root / "metadata.tsv", tmp_path / "jax", *argv], monkeypatch)
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert sum(f.suffix == ".html" for f in files) == 1 + 3 + 3  # 2, 7 and 7 rows
    # the per-pair interface on a file without scores
    p = pairs["docB"]
    plain = tmp_path / "noscore.txt"
    plain.write_text("[0]:[0]\n[1, 2]:[1]\n[]:[3]\n[4]:[4]\n")
    for pkg, main in (("t", tdump.main), ("j", None)):
        argv = ["--align_path", plain, "--src_segs", root / "segments" / "en" / "docB_en.txt",
                "--src_wav", p["en"], "--tgt_segs", root / "segments" / "de" / "docB_de.txt",
                "--tgt_wav", p["de"], "--out_dir", tmp_path / f"pp_{pkg}"]
        if main:
            main([str(a) for a in argv])
        else:
            _run_jax(jdump, argv, monkeypatch)
    files = _assert_trees_equal(tmp_path / "pp_t", tmp_path / "pp_j")
    assert sum(f.suffix == ".ogg" for f in files) == 6  # the deletion has no clip


@pytest.mark.parametrize("channels", [1, 2])
def test_ogg_read_write_match_native(tmp_path, channels):
    """The port's .ogg reader is bit-equal to the JAX package's native one
    on a file that JAX writes, and its writer writes the same bytes."""
    rng = np.random.default_rng(channels)
    wav = (0.2 * rng.standard_normal((40000, channels))).astype(np.float32)
    if channels == 1:
        wav = wav[:, 0]
    theirs, ours = tmp_path / "theirs.ogg", tmp_path / "ours.ogg"
    jaudio.write(str(theirs), wav, 16000)
    taudio.write(str(ours), wav, 16000)
    assert ours.read_bytes() == theirs.read_bytes()
    taudio.write(str(tmp_path / "q.ogg"), wav, 16000, quality=0.9)
    jaudio.write(str(tmp_path / "jq.ogg"), wav, 16000, quality=0.9)
    assert (tmp_path / "q.ogg").read_bytes() == (tmp_path / "jq.ogg").read_bytes()
    assert taudio.info(str(theirs)) == jaudio.info(str(theirs)) == (16000, 40000, channels)
    for start, stop in [(0, None), (1234, 5678), (39000, None), (100, 99999)]:
        got, sr = taudio.read(str(theirs), start=start, stop=stop)
        want, jsr = jaudio.read(str(theirs), start=start, stop=stop)
        assert sr == jsr == 16000 and got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError):
        taudio.read(str(tmp_path / "missing.ogg"))


def test_front_clis_need_the_card(front, tmp_path, monkeypatch):
    """Without a card and without --device cpu each new CLI raises."""
    root, _ = front
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = str(root / "metadata.tsv")
    for main, argv in (
            (tsegment.main, [meta, str(tmp_path / "a"), "--lang", "en"]),
            (tsegment.main, [meta, str(tmp_path / "b"), "--lang", "en", "--vad_model",
                             "silero_jax"]),
            (tdetect.main, [meta, str(tmp_path / "c"), "--seg_dir", str(root / "segments")]
             + LANGS),
            (tfilter.main, [meta, str(tmp_path / "d"), "--align_dir", str(tmp_path),
                            "--seg_dir", str(root / "segments")] + LANGS)):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_chip_smoke_front_phase_rehearsal(tmp_path, capsys):
    res = cs.phase_front(tmp_path, torch.device("cpu"), seconds=45, n_planted=3,
                         latencies=(26.0, 5.1))
    out = capsys.readouterr().out
    assert "all 3 planted among them" in out and "(all 3 planted)" in out
    assert "[front] .ogg round trip" in out and res["ogg snr"] >= cs.OGG_MIN_SNR_DB
    assert res["silero err"] <= cs.SILERO_TOL and res["lstm err"] <= cs.LSTM_TOL
    assert set(res["4.1 silero"]["split"]) == {"features", "lstm", "head"}
    assert set(res["4.2"]["split"]) == set(res["6.2"]["split"]) == {"gate", "read", "fbank", "mse"}
