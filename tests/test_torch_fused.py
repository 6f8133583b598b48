"""The port's fused handoff below the pipeline, on the CPU: the encoders'
``keep_device`` buffers, ``vecalign/batch.py::stage_rows_device``, the
align CLI fed from the row cache, and stages 6.6 and 6.7 fed from it.

Contracts: the device buffer holds exactly the fp16 rows the writer
stores (bit-equal), those rows are within one fp16 step of the JAX
encoder's; device staging equals upload staging bit for bit (and the JAX
package's device staging within 1e-6, as the upload builders are held in
tests/test_torch_batch.py); the align CLI writes identical files fed from
the cache or from the ``.embed`` files at the same bucket composition;
fused mining writes identical index files and margins within 1e-5
relative of the file path, and falls back to it when the cache is
incomplete. Encoders are the small fp32 configs of
tests/test_torch_laser.py and tests/test_torch_sonar.py, random weights
from the JAX package's numpy init (seed 0) on both sides.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.utils import embed_cache as jcache
from svecalign_tpu.vecalign import batch as jbatch
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.ops import topk as ttopk
from svecalign_tpu_torch.postprocess import prep_index, score_align
from svecalign_tpu_torch.seg_align import align
from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.embedding_utils import write_stopes_embedding
from svecalign_tpu_torch.utils.file_utils import read_alignments_with_score
from svecalign_tpu_torch.vecalign import batch as tbatch

torch.set_num_threads(2)

LASER_SMALL = dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_dim=128,
                   encoder_layers=2, encoder_heads=2, encoder_ffn_dim=256, conv_pos_kernel=16,
                   conv_pos_groups=4, dtype="float32")
SONAR_SMALL = dict(n_mels=80, model_dim=128, n_layers=2, n_heads=2, ffn_dim=256,
                   conv_kernel=31, pool_dim=128, dtype="float32")
SPANS = [(0, 16000), (8000, 38000), (30000, 55000), (320000, 344000), (600000, 624000),
         (632000, 700000), (100, 300)]
CACHE_ROWS = 16


@pytest.fixture(autouse=True)
def _fresh_caches():
    for cache in (jcache, embed_cache):
        cache.disable()
        for k in cache.stats:
            cache.stats[k] = 0
    yield
    for cache in (jcache, embed_cache):
        cache.disable()
        for k in cache.stats:
            cache.stats[k] = 0


def _wave(seconds=40, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal(seconds * 16000)).astype(np.float32)
    w[20 * 16000: 25 * 16000] *= 0.01
    return w


@pytest.fixture(scope="module")
def encoders():
    """(JAX, port) model per kind, shrunk buckets, seed-0 weights."""
    j = jlaser.SpeechLaserModel(jlaser.LaserEncoderConfig(**LASER_SMALL), max_tokens=4 * 16000,
                                upload_dtype="fp32")
    t = tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(**LASER_SMALL), max_tokens=4 * 16000,
                                upload_dtype="fp32", device="cpu")
    out = {"speech_laser": (j, t)}
    for m in (j, t):
        m.BUCKETS, m.WAVE_BUCKETS_S = (16000, 32000), (10, 41)
    j = jsonar.SonarSpeechModel(jsonar.SonarEncoderConfig(**SONAR_SMALL, attention_backend="xla"),
                                batch_size=2, upload_dtype="fp32")
    t = tsonar.SonarSpeechModel(tsonar.SonarEncoderConfig(**SONAR_SMALL), batch_size=2,
                                upload_dtype="fp32", device="cpu")
    for m in (j, t):
        m.BUCKET_FRAMES, m.WAVE_BUCKETS_S = (100, 250), (10, 41)
    out["sonar"] = (j, t)
    return out


def _call(model, method, wave, **kw):
    if method == "encode":
        return model.encode([wave[s:e] for s, e in SPANS], **kw)
    return model.encode_spans(wave, SPANS, **kw)


@pytest.mark.parametrize("method", ["encode", "encode_spans"])
@pytest.mark.parametrize("kind", ["speech_laser", "sonar"])
def test_keep_device_buffer_equals_the_written_rows(encoders, kind, method):
    jm, tm = encoders[kind]
    wave = _wave()
    n = len(SPANS)
    for cache in (jcache, embed_cache):
        cache.enable(rows=CACHE_ROWS)
    got, dev = _call(tm, method, wave, keep_device=True, fp16_pull=True)
    assert dev.shape == (CACHE_ROWS, 128) and dev.dtype == torch.float16
    assert got.dtype == np.float16 and got.shape == (n, 128)
    np.testing.assert_array_equal(dev[:n].numpy(), got)
    assert not dev[n:].any()
    want, jdev = _call(jm, method, wave, keep_device=True, fp16_pull=True)
    assert jdev is not None
    step = float(np.spacing(np.float16(np.abs(want).max())))
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0, atol=step)

    # fp32 host rows: the buffer holds their fp16 cast, the writer's bytes
    got32, dev32 = _call(tm, method, wave, keep_device=True)
    assert got32.dtype == np.float32
    np.testing.assert_array_equal(dev32[:n].numpy(), got32.astype(np.float16))
    np.testing.assert_array_equal(got32.astype(np.float16), got)

    # more rows than the cap: no buffer, the host rows unchanged
    embed_cache.max_rows = n - 1
    got2, dev2 = _call(tm, method, wave, keep_device=True, fp16_pull=True)
    assert dev2 is None
    np.testing.assert_array_equal(got2, got)
    np.testing.assert_array_equal(_call(tm, method, wave, fp16_pull=True), got)


# --- stage 5.4 ----------------------------------------------------------------------

KWARGS = dict(final_alignment_types=[(1, 1), (0, 1), (1, 0), (1, 2), (2, 1)],
              del_percentile_frac=0.2, width_over2=4, max_size_full_dp=8,
              costs_sample_size=50, num_samps_for_norm=10)
R_MAX, D, N_OVER = 48, 16, 3


def _doc(rng, n):
    """(host fp16 rows, cache-padded rows, id map) of a document of n
    segments; two NaN rows and a zero row, some ignored ids."""
    e = rng.standard_normal((n * 2, D)).astype(np.float16)
    e[3] = np.nan
    e[5, 2] = np.nan
    e[7] = 0
    padded = np.zeros((R_MAX, D), np.float16)
    padded[: e.shape[0]] = e
    ids = rng.integers(0, n * 2, size=(N_OVER, n)).astype(np.int32)
    ids[1, ::3] = -1
    ids[0, :3] = [3, 5, 7]
    return e, torch.from_numpy(padded), ids


def test_stage_rows_device_equals_upload_and_jax(monkeypatch):
    rng = np.random.default_rng(1)
    a, b, c = _doc(rng, 20), _doc(rng, 18), _doc(rng, 13)
    # three pairs from three documents: a appears in two pairs, once per side
    triples = [(a, b), (c, a), (b, c)]
    up = [(x[0], x[2], y[0], y[2]) for x, y in triples]
    dev = [(x[1], x[2], y[1], y[2]) for x, y in triples]

    banks = []
    build = tbatch._build_doc_tensors_flat
    monkeypatch.setattr(tbatch, "_build_doc_tensors_flat",
                        lambda bank, gids: banks.append(bank.shape) or build(bank, gids))
    before = dict(tbatch.upload_stats)
    h_dev = tbatch.stage_rows_device(dev)
    ids_bytes = tbatch.upload_stats["bytes"] - before["bytes"]
    assert banks == [(3 * R_MAX, D)] * 2  # each document stored once
    assert tbatch.upload_stats["buckets"] == before["buckets"] + 1
    h_up = tbatch.stage_rows_upload(up, device="cpu")
    n_pad, m_pad = h_up[0].shape[2], h_up[1].shape[2]
    assert ids_bytes == 3 * N_OVER * (n_pad + m_pad) * 4  # the id maps alone
    for got, want in zip(h_dev, h_up):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    j_dev = jbatch.stage_rows_device([(jnp.asarray(x[1].numpy()), x[2], jnp.asarray(y[1].numpy()),
                                       y[2]) for x, y in triples])
    for got, want in zip(h_dev[:2], j_dev[:2]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.isfinite(h_dev[0]).all() and not h_dev[0][0, 0, :3].any()

    res_up = tbatch.run_staged(h_up, sampling="paired", **KWARGS)
    res_dev = tbatch.run_staged(h_dev, sampling="paired", **KWARGS)
    for (a_up, s_up), (a_dev, s_dev) in zip(res_up, res_dev):
        assert a_up == a_dev
        np.testing.assert_array_equal(s_up, s_dev)


def test_stage_rows_device_mesh_names_its_roadmap_item():
    """The mesh branch of device staging (once a stub naming its ROADMAP
    item): 8 pairs of 3 documents over a 4-shard CPU mesh give each shard
    a bank of its own pairs' documents, stage exactly what the unsharded
    call stages, and run to the same alignments and costs in both sampling
    modes; a bad sharding or an uneven split raises."""
    from svecalign_tpu_torch.parallel.mesh import Mesh, batch_sharding

    rng = np.random.default_rng(2)
    a, b, c = _doc(rng, 10), _doc(rng, 9), _doc(rng, 12)
    pairs = [(x[1], x[2], y[1], y[2]) for x, y in [(a, b), (a, c), (b, c), (c, a)] * 2]
    mesh = Mesh(["cpu"] * 4)
    whole = tbatch.stage_rows_device(pairs)
    before = dict(tbatch.upload_stats)
    sharded = tbatch.stage_rows_device(pairs, sharding=batch_sharding(mesh))
    assert tbatch.upload_stats["buckets"] == before["buckets"] + 1
    n_pad, m_pad = whole[0].shape[2], whole[1].shape[2]
    assert tbatch.upload_stats["bytes"] - before["bytes"] == 8 * N_OVER * (n_pad + m_pad) * 4
    assert tbatch._pair_mesh(sharded) is mesh and tbatch._pair_mesh(whole) is None
    assert tbatch.bucket_shape(sharded) == tbatch.bucket_shape(whole)
    for i, shard in enumerate(sharded.shards):
        for got, want in zip(shard, whole):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want)[2 * i:2 * i + 2])
    for sampling in ("paired", "shared"):
        res_whole = tbatch.run_staged(whole, sampling=sampling, **KWARGS)
        res_sharded = tbatch.run_staged(sharded, sampling=sampling, **KWARGS)
        assert len(res_sharded) == len(pairs)
        for (a0, s0), (a1, s1) in zip(res_whole, res_sharded):
            assert a0 == a1
            np.testing.assert_array_equal(s0, s1)
    with pytest.raises(TypeError, match="batch_sharding"):
        tbatch.stage_rows_device(pairs, sharding=object())
    with pytest.raises(ValueError, match="evenly"):
        tbatch.stage_rows_device(pairs[:7], sharding=batch_sharding(mesh))
    with pytest.raises(ValueError, match="one"):
        tbatch.stage_rows_device([(a[1], a[2], b[1][:20], b[2])])


SIZES = [(40, 37), (33, 36), (45, 41)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three synthetic stage-5.4 pairs (fp16 stopes rows, d = 32) with
    ignore files, and a one-pair tree of the first pair."""
    root = tmp_path_factory.mktemp("fused_align")
    paths, stems, _ = cs.write_synthetic_corpus(root / "three", SIZES, dim=32, seed=40,
                                                n_ignore=3)
    one, _ = cs.write_synthetic_pair(root / "one", *SIZES[0], dim=32, seed=40, n_ignore=3)
    return {"three": (paths, stems), "one": (one, [cs.STEM])}


def _fill_cache(paths):
    embed_cache.enable(rows=256)
    for f in sorted((paths["root"] / "embeds").rglob("*.embed")):
        embed_cache.put_from_file(str(f), device="cpu")


def _read_all(out_dir, stems):
    return {s: cs.output_path(out_dir, s).read_text() for s in stems}


@pytest.mark.parametrize("fused_batch, file_batch, tree", [(4, 4, "three"), (1, 2, "one")])
def test_align_cli_from_the_cache_equals_the_file_path(corpus, tmp_path, caplog, fused_batch,
                                                        file_batch, tree):
    """Same buckets, same files: --pair_batch 4 over three pairs; at
    --pair_batch 1 the fused run takes the batched driver (a bucket of
    one), held against the file path at --pair_batch 2 on one pair."""
    paths, stems = corpus[tree]
    align.main(cs.cli_argv(paths, tmp_path / "file", "cpu", ["--pair_batch", str(file_batch)]))
    _fill_cache(paths)
    before = dict(tbatch.upload_stats)
    with caplog.at_level(logging.INFO):
        prof = align.main(cs.cli_argv(paths, tmp_path / "fused", "cpu",
                                      ["--pair_batch", str(fused_batch)]))
    assert prof["fused"] == len(stems)
    assert embed_cache.stats["hit"] == 2 * len(stems) and embed_cache.stats["miss"] == 0
    if fused_batch == 1:
        assert "using the batched aligner driver even at pair_batch 1" in caplog.text
    assert "MISSED" not in caplog.text
    # only the id maps are uploaded: two sides of (P, 5 overlaps, 64 gridded) int32
    assert tbatch.upload_stats["bytes"] - before["bytes"] == 2 * 5 * 64 * 4 * len(stems)
    got = _read_all(tmp_path / "fused", stems)
    assert got == _read_all(tmp_path / "file", stems) and all(got.values())


def test_align_cli_warns_when_the_cache_misses(corpus, tmp_path, caplog):
    """A document not in the cache: its pair takes the file path, with a
    warning that names it and the cache stats; outputs stay identical."""
    paths, stems = corpus["three"]
    _fill_cache(paths)
    embed_cache._cache.pop(embed_cache._key(paths["root"] / "embeds" / "de" /
                                            f"{stems[1]}_de.embed"))
    with caplog.at_level(logging.INFO):
        prof = align.main(cs.cli_argv(paths, tmp_path / "fused", "cpu", ["--pair_batch", "4"]))
    assert prof["fused"] == 2
    assert f"fused handoff MISSED 1 pair(s)" in caplog.text and stems[1] in caplog.text
    assert "'miss': 1" in caplog.text
    # every pair is aligned (the buckets are [the file pair] + [the 2 fused])
    assert all(_read_all(tmp_path / "fused", stems).values())


# --- stages 6.6 and 6.7 ---------------------------------------------------------------


def _write_mining_fixture(root, rng, d=16, pairs=(("A_en", "A_de", 5), ("B_en", "B_de", 7))):
    """Post-align mining inputs: per pair and side a fresh embed file and a
    reuse pool, pointer tsvs spanning both, align files, metadata."""
    embed_root = root / "embeds" / "en-de"
    align_root = root / "aligns" / "en-de"
    embed_root.mkdir(parents=True)
    align_root.mkdir(parents=True)
    meta_lines, files = [], {}
    for src_stem, tgt_stem, n in pairs:
        pid = f"{src_stem}-{tgt_stem}"
        meta_lines.append(f"/audio/{src_stem}.ogg\t/audio/{tgt_stem}.ogg\n")
        for side, stem in (("src", src_stem), ("tgt", tgt_stem)):
            fresh = embed_root / f"{pid}.{side}.embed"
            pool = embed_root / f"{stem}.pool.embed"
            for path, rows in ((fresh, n), (pool, n + 2)):
                vals = rng.standard_normal((rows, d)).astype(np.float16).astype(np.float32)
                write_stopes_embedding(vals, str(path), fp16=True)
                files[str(path)] = vals
            with open(embed_root / f"{pid}.{side}.tsv", "w") as fp:
                for i in range(n):
                    fp.write(f"{pool.as_posix()}\t{i + 1}\n" if i % 2
                             else f"{fresh.as_posix()}\t{i}\n")
        (align_root / f"{pid}.txt").write_text("".join(f"[{i}]:[{i}]:0.1\n" for i in range(n)))
    meta = root / "metadata.tsv"
    meta.write_text("".join(meta_lines))
    return meta, files


def _mine(root, meta, tag, index_type="Flat", score_args=()):
    idx_dir, mrg_dir = root / f"idx_{tag}", root / f"margin_{tag}"
    for extra in ([], ["--use_tgt"]):
        prep_index.main([str(meta), str(idx_dir), "--data_dir", str(root / "embeds"),
                         "--src_lang", "en", "--tgt_lang", "de", "--embed_fp16", "--embed_stopes",
                         "--sample_ratio", "1.0", "--index_type", index_type, "--device", "cpu",
                         *extra])
    score_align.main([str(meta), str(mrg_dir), "--embed_dir", str(root / "embeds"),
                      "--align_dir", str(root / "aligns"), "--src_lang", "en", "--tgt_lang", "de",
                      "--index_dir", str(idx_dir), "--embed_fp16", "--embed_stopes", "--k", "4",
                      "--device", "cpu", *score_args])
    margins = {f.name: np.array([s for _, _, s in read_alignments_with_score(f)], np.float64)
               for f in sorted((mrg_dir / "en-de").glob("*.txt"))}
    index_files = {f.relative_to(idx_dir): f.read_bytes() for f in sorted(idx_dir.rglob("*"))
                   if f.is_file()}
    return margins, index_files


def _cache_all(files, skip_last=False):
    embed_cache.enable(rows=16)
    items = sorted(files.items())
    for path, rows in items[:-1] if skip_last else items:
        padded = torch.zeros((16, rows.shape[1]), dtype=torch.float16)
        padded[: rows.shape[0]] = torch.from_numpy(rows.astype(np.float16))
        embed_cache.put(path, rows.shape[0], padded)


@pytest.mark.parametrize("index_type", ["Flat", "IVF8"])
def test_fused_mining_matches_the_file_path(tmp_path, index_type, caplog):
    meta, files = _write_mining_fixture(tmp_path, np.random.default_rng(7))
    ref, ref_idx = _mine(tmp_path, meta, "file", index_type)
    assert ref and all(len(v) for v in ref.values())
    _cache_all(files)
    with caplog.at_level(logging.INFO):
        got, got_idx = _mine(tmp_path, meta, "fused", index_type)
    assert "Fused mode: resolving queries from the device embed cache" in caplog.text
    if index_type == "Flat":
        assert "Device-resident corpus installed (12 rows, no upload)" in caplog.text
        assert embed_cache.stats["gather"] == 4  # two corpora, two query sides
    else:
        assert embed_cache.stats["gather"] == 2
    assert got_idx == ref_idx  # index files byte-identical
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=0)


def test_fused_mining_falls_back_without_a_full_cache(tmp_path, caplog):
    meta, files = _write_mining_fixture(tmp_path, np.random.default_rng(11))
    ref, ref_idx = _mine(tmp_path, meta, "file")
    _cache_all(files, skip_last=True)
    with caplog.at_level(logging.INFO):
        got, got_idx = _mine(tmp_path, meta, "partial")
    assert "Embed cache incomplete; corpus uploads lazily" in caplog.text
    assert embed_cache.stats["gather_miss"] >= 1 and got_idx == ref_idx
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=0)


def test_fused_int8_mining_matches_the_file_int8(tmp_path):
    meta, files = _write_mining_fixture(tmp_path, np.random.default_rng(31))
    ref, _ = _mine(tmp_path, meta, "int8", score_args=("--corpus_quant", "int8"))
    _cache_all(files)
    got, _ = _mine(tmp_path, meta, "int8_fused", score_args=("--corpus_quant", "int8"))
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=0)


def test_quantize_corpus_device_equals_host():
    """The device re-quantisation of an installed corpus: codes and scales
    equal to the host quantizer's, padding rows' corpus_sq kept at inf;
    and a FlatIndex with no host rows searches its device corpus by it."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((300, 24)).astype(np.float16)
    rows[4] = 0
    corpus, sq = ttopk._normalize_corpus(torch.from_numpy(np.pad(rows, ((0, 84), (0, 0)))), 300)
    codes, scales, qsq = ttopk._quantize_corpus_device(corpus, sq)
    want_c, want_s, want_sq = ttopk._quantize_rows_host(corpus.numpy())
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    np.testing.assert_allclose(qsq[:300].numpy(), want_sq[:300], rtol=1e-6)
    assert torch.isinf(qsq[300:]).all() and not codes[300:].any()
    np.testing.assert_allclose(corpus[:300].numpy(), ttopk.normalize_l2(rows), rtol=0, atol=1e-6)

    index = ttopk.FlatIndex(dim=24, corpus_quant="int8", device="cpu")
    index._device_cache = (corpus, sq)  # a device corpus with no host rows behind it
    c8, s8, _ = index._device_corpus_q8(tiled=True)
    np.testing.assert_array_equal(c8.numpy(), codes.numpy())
    np.testing.assert_array_equal(s8.numpy(), scales.numpy())


def test_set_device_corpus_checks_its_rows():
    index = ttopk.FlatIndex(dim=8, device="cpu")
    index.add(np.ones((3, 8), np.float32))
    with pytest.raises(ValueError, match="multiple of"):
        index.set_device_corpus(torch.zeros((3, 8), dtype=torch.float16), 3)
    with pytest.raises(ValueError, match="index of 3"):
        index.set_device_corpus(torch.zeros((ttopk.FlatIndex.BLOCK, 8), dtype=torch.float16), 2)
