"""The port's device mesh (svecalign_tpu_torch.parallel.mesh) and the
paths that shard over it, against the JAX package on the CPU.

JAX runs on the 8-device CPU platform of tests/conftest.py; the port on
8 CPU shards (``Mesh(["cpu"] * 8)``). Inputs come from numpy seeds.

- ``make_mesh``: shapes, the index every card carries, and the errors
  (more cards than present, an axis that does not divide);
- a sharded stage-5.4 bucket against the JAX package's sharded
  ``run_staged`` in paired mode: alignments identical, costs within 1e-5
  relative (fp32 dot products summed in another order, as in
  tests/test_torch_batch.py), and bit-equal to the port's unsharded bucket
  in both sampling modes;
- the sharded kNN tiers against the JAX package's: distances within rtol
  1e-4 / atol 1e-5 and the same id sets; the int8 tier within the int8
  tolerance of JAX's tests; ``ShardedIVFIndex``'s probe semantics and its
  stale-snapshot errors;
- data-parallel LASER and SONAR ``encode_spans`` (fp32) against the JAX
  package's data-parallel models at per-row cosine >= 1 - 1e-5;
- the multi-host hook: two processes join a ``gloo`` group through
  ``SVECALIGN_COORDINATOR`` and ``all_reduce``; a bad rank raises;
- ``chip_smoke.py``'s phase 12 rehearsed on two CPU shards, with its
  pipeline bullet, and its reuse of phase 9's directory.
"""

import inspect
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from svecalign_tpu.models import laser_encoder as jlaser
from svecalign_tpu.models import sonar_encoder as jsonar
from svecalign_tpu.ops import topk as jtopk
from svecalign_tpu.parallel import mesh as jmesh
from svecalign_tpu.vecalign import batch as jbatch
from svecalign_tpu_torch.models import laser_encoder as tlaser
from svecalign_tpu_torch.models import sonar_encoder as tsonar
from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import topk as ttopk
from svecalign_tpu_torch.parallel import mesh as tmesh
from svecalign_tpu_torch.vecalign import batch as tbatch
from tests.test_torch_chain import tiny_card  # noqa: F401 (a fixture)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def _jax_mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return JMesh(np.array(jax.devices()), ("data",))


# --- the mesh ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_errors(monkeypatch):
    m = tmesh.make_mesh(8, device="cpu")
    assert m.shape == {"data": 8, "model": 1} and m.size == 8
    assert m.axis_names == jmesh.make_mesh(8).axis_names
    assert m.data_devices == [torch.device("cpu")] * 8
    m2 = tmesh.make_mesh(8, model_parallel=2, device="cpu")
    assert m2.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="tensor parallelism, for training"):
        m2.data_devices
    with pytest.raises(ValueError, match="model_parallel"):
        tmesh.make_mesh(6, model_parallel=4, device="cpu")
    assert tmesh.make_mesh(device="cpu").shape["data"] == 1  # one CPU device by default
    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "3")
    assert tmesh.make_mesh(device="cpu").shape["data"] == 3
    assert tmesh.default_mesh("cpu").shape["data"] == 3
    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "1")
    assert tmesh.default_mesh("cpu") is None

    # cards: each named by its index; more than present raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = tmesh.make_mesh(device="cuda")
    assert cards.data_devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="asked for 4 cards, 2 present"):
        tmesh.make_mesh(4, device="cuda")
    with pytest.raises(ValueError, match="carry an index"):
        tmesh.Mesh(["cuda", "cuda:0"])
    with pytest.raises(ValueError, match="all be cuda or all be cpu"):
        tmesh.Mesh(["cuda:0", "cpu"])
    one_card = tmesh.Mesh(["cuda:0", "cuda:0"])  # two shards sharing one card
    assert one_card.shape == {"data": 2, "model": 1} and one_card.first == torch.device("cuda:0")


def test_placement_and_shard_runs():
    m = tmesh.Mesh(["cpu"] * 4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = tmesh.batch_sharding(m).put(x)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    reps = tmesh.replicated(m).put(torch.from_numpy(x))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one device, one copy
    with pytest.raises(ValueError, match="evenly"):
        tmesh.batch_sharding(m).put(x[:6])

    seen = tmesh.run_on_shards(m, lambda i, dev, item: (i, tmesh.current_shard(), item), "abcd")
    assert seen == [(0, 0, "a"), (1, 1, "b"), (2, 2, "c"), (3, 3, "d")]
    assert tmesh.current_shard() is None
    counts = {"k": 0}
    _build.SHARD_LAUNCHES.clear()
    tmesh.run_on_shards(m, lambda i, dev, n: [_build.count_launch(counts, "k")
                                              for _ in range(n)], [1, 2, 3, 4])
    assert counts["k"] == 10
    assert {s: _build.SHARD_LAUNCHES[(s, "k")] for s in range(4)} == {0: 1, 1: 2, 2: 3, 3: 4}
    with pytest.raises(ZeroDivisionError):
        tmesh.run_on_shards(m, lambda i, dev, item: 1 // item, [1, 0, 1, 1])


# --- stage 5.4: a sharded bucket ---------------------------------------------------------


KWARGS = dict(final_alignment_types=[(1, 1), (0, 1), (1, 0), (1, 2), (2, 1)],
              del_percentile_frac=0.2, width_over2=4, max_size_full_dp=16,
              costs_sample_size=300, num_samps_for_norm=20)


def _bucket(rng, sizes, d=16, n_over=3):
    pairs = []
    for n0, n1 in sizes:
        e0 = rng.standard_normal((n0 + 5, d)).astype(np.float16)
        e1 = rng.standard_normal((n1 + 5, d)).astype(np.float16)
        pairs.append((e0, rng.integers(-1, n0 + 5, (n_over, n0)).astype(np.int32),
                      e1, rng.integers(-1, n1 + 5, (n_over, n1)).astype(np.int32)))
    return pairs


def test_sharded_bucket_matches_jax_sharded_and_unsharded():
    """8 pairs over 8 shards (one each, as JAX's 8-device mesh splits them)
    and over 2 shards of 4."""
    rng = np.random.default_rng(21)
    pairs = _bucket(rng, [(40, 37), (33, 36), (45, 41), (30, 44), (38, 38), (44, 30),
                          (41, 43), (35, 31)])
    jshard = NamedSharding(_jax_mesh(), P("data"))
    want = jbatch.run_staged(jbatch.stage_rows_upload(pairs, sharding=jshard),
                             sampling="paired", **KWARGS)
    whole = {s: tbatch.run_staged(tbatch.stage_rows_upload(pairs, device="cpu"), sampling=s,
                                  **KWARGS) for s in ("paired", "shared")}
    for devs in (CPU8, ["cpu"] * 2):
        sharding = tmesh.batch_sharding(tmesh.Mesh(devs))
        handle = tbatch.stage_rows_upload(pairs, sharding=sharding)
        got = tbatch.run_staged(handle, sampling="paired", **KWARGS)
        for (a, s), (ja, js) in zip(got, want):
            assert a == [(list(x), list(y)) for x, y in ja]
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=0)
        for sampling in ("paired", "shared"):
            got = tbatch.run_staged(handle, sampling=sampling, **KWARGS) \
                if sampling == "shared" else got
            for (a, s), (wa, ws) in zip(got, whole[sampling]):
                assert a == wa
                np.testing.assert_array_equal(s, ws)


def test_shared_mode_pair_results_do_not_depend_on_the_bucket():
    """Shared mode draws once per depth for the whole bucket: a pair
    aligns the same alone, in a bucket of others and repeated to fill a
    shard (the CLI's padding of a bucket that does not split evenly)."""
    rng = np.random.default_rng(22)
    pairs = _bucket(rng, [(40, 37), (33, 36), (45, 41)])
    alone = tbatch.run_staged(tbatch.stage_rows_upload(pairs[2:], device="cpu"), **KWARGS)
    padded = tbatch.run_staged(tbatch.stage_rows_upload(
        pairs[2:] * 4, sharding=tmesh.batch_sharding(tmesh.Mesh(["cpu"] * 4))), **KWARGS)
    for a, s in padded:
        assert a == alone[0][0]
        np.testing.assert_array_equal(s, alone[0][1])
    # the bucket's padded shapes set its pyramid: same shapes, same result
    grown = tbatch.run_staged(tbatch.stage_rows_upload(pairs[1:], device="cpu"), **KWARGS)
    assert tbatch.bucket_shape(tbatch.stage_rows_upload(pairs[1:], device="cpu"))[1:] == \
        tbatch.bucket_shape(tbatch.stage_rows_upload(pairs[2:], device="cpu"))[1:]
    assert grown[1][0] == alone[0][0]


# --- stage 6.7: the sharded kNN tiers -----------------------------------------------------


def _unit(rng, n, d=64):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_sets(got, want):
    for r in range(len(want)):
        assert set(got[r]) == set(want[r]), r


@pytest.mark.parametrize("device_queries", [False, True])
def test_sharded_search_matches_jax(device_queries):
    rng = np.random.default_rng(2)
    corpus = _unit(rng, 333)  # not divisible by 8
    queries = _unit(rng, 17)
    d_j, i_j = jtopk.sharded_search(queries, corpus, 10)
    mesh = tmesh.Mesh(CPU8)
    if device_queries:
        d_t, i_t = ttopk.ShardedFlatIndex(corpus, mesh).search_device_queries(
            torch.from_numpy(queries), 10)
        d_t, i_t = d_t.numpy(), i_t.numpy()
    else:
        d_t, i_t = ttopk.sharded_search(queries, corpus, 10, mesh)
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-4, atol=1e-5)
    _same_sets(i_t, np.asarray(i_j))
    flat = ttopk.FlatIndex(64, device="cpu")
    flat.add(corpus)
    d_f, i_f = flat.search(queries, 10)
    np.testing.assert_array_equal(d_t, d_f)  # the same products, merged by (distance, id)
    np.testing.assert_array_equal(i_t, i_f)


def test_sharded_search_q8_matches_jax():
    rng = np.random.default_rng(26)
    corpus = _unit(rng, 333)
    queries = _unit(rng, 17)
    jmesh8 = _jax_mesh()
    d_j, i_j = jtopk.sharded_search_q8(queries, 333, 10, jtopk.shard_corpus_q8(corpus, jmesh8))
    d_t, i_t = ttopk.sharded_search_q8(queries, 333, 10,
                                       ttopk.shard_corpus_q8(corpus, tmesh.Mesh(CPU8)))
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-4, atol=1e-5)
    _same_sets(i_t, np.asarray(i_j))
    sh = ttopk.ShardedFlatIndex(corpus, tmesh.Mesh(CPU8), corpus_quant="int8")
    d_p, i_p = sh.search(queries, 400)  # k past ntotal: faiss's padding
    assert d_p.shape == (17, 400) and np.isinf(d_p[:, 333:]).all() and (i_p[:, 333:] == -1).all()
    with pytest.raises(ValueError, match="rows asked"):
        ttopk.sharded_search_q8(queries, 334, 10, sh._prepared)


def test_sharded_flat_from_a_device_corpus():
    """A corpus the fused pipeline installed on the device shards there:
    the same results as the index itself."""
    rng = np.random.default_rng(8)
    rows = _unit(rng, 300, 32)
    idx = ttopk.FlatIndex(32, device="cpu")
    idx.add(rows)
    padded = np.zeros((ttopk.FlatIndex.BLOCK, 32), np.float16)
    padded[:300] = rows
    idx.set_device_corpus(torch.from_numpy(padded), 300)
    q = torch.from_numpy(_unit(rng, 20, 32))
    d_ref, i_ref = idx.search_device_queries(q, 6)
    sh = ttopk.ShardedFlatIndex.from_index(idx, tmesh.Mesh(["cpu"] * 3))
    assert sh._prepared.shards[0]._chunks == []  # no host rows: sliced from the device
    d, i = sh.search_device_queries(q, 6)
    np.testing.assert_array_equal(d.numpy(), d_ref.numpy())
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())
    with pytest.raises(ValueError, match="fewer than k"):
        sh.search_device_queries(q, 301)


def _ivf_pair(corpus, nlist, nprobe, train):
    t = ttopk.IVFIndex(dim=corpus.shape[1], nlist=nlist, nprobe=nprobe, device="cpu")
    j = jtopk.IVFIndex(dim=corpus.shape[1], nlist=nlist, nprobe=nprobe)
    j.train(train)
    t.centroids = np.asarray(j.centroids)  # one coarse quantizer for both packages
    t.nlist = j.nlist
    for ix in (t, j):
        ix.add(corpus)
    return t, j


def test_sharded_ivf_matches_jax_and_single_device():
    rng = np.random.default_rng(11)
    corpus = _unit(rng, 4096)
    queries = _unit(rng, 700)
    t, j = _ivf_pair(corpus, 32, 6, corpus[:2048])
    d_j, i_j = jtopk.ShardedIVFIndex(j).search(queries, 8)
    sh = ttopk.ShardedIVFIndex(t, tmesh.Mesh(CPU8))
    d_t, i_t = sh.search(queries, 8)
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-4, atol=1e-5)
    assert np.mean([set(a) == set(b) for a, b in zip(i_t, np.asarray(i_j))]) > 0.99
    d_1, i_1 = t.search(queries, 8, use_device=True)
    np.testing.assert_array_equal(d_t, d_1)
    np.testing.assert_array_equal(i_t, i_1)
    d_q, i_q = sh.search_device_queries(torch.from_numpy(queries), 8)
    np.testing.assert_array_equal(d_q, d_t)
    np.testing.assert_array_equal(i_q, i_t)


def test_sharded_ivf_rejects_stale_snapshot():
    rng = np.random.default_rng(3)
    corpus = _unit(rng, 1024, 32)
    ivf = ttopk.IVFIndex(dim=32, nlist=8, nprobe=2, device="cpu")
    ivf.train(corpus[:512])
    ivf.add(corpus)
    sh = ttopk.ShardedIVFIndex(ivf, tmesh.Mesh(CPU8))
    ivf.nprobe = 4
    with pytest.raises(RuntimeError, match="nprobe changed"):
        sh.search(corpus[:4], 4)
    ivf.nprobe = 2
    ivf.add(corpus[:8])
    with pytest.raises(RuntimeError, match="grew after sharding"):
        sh.search(corpus[:4], 4)
    with pytest.raises(ValueError, match="trained, populated"):
        ttopk.ShardedIVFIndex(ttopk.IVFIndex(dim=32, device="cpu"), tmesh.Mesh(CPU8))


# --- stages 5.3 and 6.5: data-parallel encoders ----------------------------------------


TINY_LASER = dict(conv_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)), encoder_dim=64,
                  encoder_layers=2, encoder_heads=4, encoder_ffn_dim=128, conv_pos_kernel=16,
                  conv_pos_groups=4, dtype="float32")
TINY_SONAR = dict(n_mels=80, model_dim=64, n_layers=2, n_heads=4, ffn_dim=128, pool_dim=64,
                  dtype="float32")


def _rows_close(a, b, tol=1e-5):
    an = a / np.linalg.norm(a, axis=1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    assert (an * bn).sum(axis=1).min() >= 1 - tol


@pytest.mark.parametrize("kind", ["speech_laser", "sonar"])
def test_data_parallel_encode_spans_matches_jax(kind):
    """8 shards against the JAX package's model on its 8-device mesh (its
    default there), both fp32, same seeded weights; and against the
    port's one-device model. The rows of a chunk round up to a multiple
    of the shard count, as in JAX."""
    rng = np.random.default_rng(3)
    wave = (0.25 * rng.standard_normal(16000 * 8)).astype(np.float32)
    spans = [(3000 * k, 3000 * k + 14000 + 500 * (k % 3)) for k in range(16)]
    mesh = tmesh.Mesh(CPU8)
    if kind == "speech_laser":
        kw = dict(max_tokens=4 * 16000, upload_dtype="fp32")
        jm = jlaser.SpeechLaserModel(jlaser.LaserEncoderConfig(**TINY_LASER), **kw)
        tm = [tlaser.SpeechLaserModel(tlaser.LaserEncoderConfig(**TINY_LASER), device="cpu",
                                      mesh=m, **kw) for m in (mesh, None)]
        for m in [jm, *tm]:
            m.BUCKETS = (16000,)
        assert tm[0]._rows_per_chunk(16000) == jm._rows_for_bucket(16000) == 8
    else:
        kw = dict(batch_size=2, upload_dtype="fp32")
        jm = jsonar.SonarSpeechModel(jsonar.SonarEncoderConfig(**TINY_SONAR,
                                                               attention_backend="xla"), **kw)
        tm = [tsonar.SonarSpeechModel(tsonar.SonarEncoderConfig(**TINY_SONAR), device="cpu",
                                      mesh=m, **kw) for m in (mesh, None)]
        for m in [jm, *tm]:
            m.BUCKET_FRAMES = (50, 100)
        assert tm[0].batch_size == jm.batch_size == 8 and tm[1].batch_size == 2
    for m in [jm, *tm]:
        m.WAVE_BUCKETS_S = (10,)
    assert tm[0].mesh is mesh and tm[0].data_shards == 8 and tm[1].mesh is None
    assert all(r is tm[0].model for r in tm[0]._replicas)  # one CPU: one copy of the weights
    want = np.asarray(jm.encode_spans(wave, spans))
    sharded, single = (m.encode_spans(wave, spans) for m in tm)
    assert sharded.shape == (16, 64) and np.isfinite(sharded).all()
    _rows_close(sharded, want)
    _rows_close(sharded, single)
    out, dev = tm[0].encode_spans(wave, spans, keep_device=True, fp16_pull=True)
    assert dev is None or np.array_equal(dev[:16].numpy(), out)


# --- the multi-host hook ----------------------------------------------------------------

_WORKER = r"""
import torch, torch.distributed as dist
from svecalign_tpu_torch.utils.torch_setup import resolve_device
resolve_device("cpu")  # joins the group named by SVECALIGN_COORDINATOR
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
print(f"rank {dist.get_rank()} of {dist.get_world_size()} sum={x.item()}", flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_coordinator_hook_joins_a_gloo_group():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SVECALIGN_COORDINATOR=f"127.0.0.1:{port}",
                   SVECALIGN_NUM_PROCESSES="2", SVECALIGN_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    for rank in range(2):
        assert any(f"rank {rank} of 2 sum=3.0" in o for o in outs), outs


def test_coordinator_hook_raises_on_a_bad_rank(monkeypatch):
    from svecalign_tpu_torch.utils import torch_setup

    monkeypatch.setenv("SVECALIGN_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SVECALIGN_NUM_PROCESSES", "2")
    monkeypatch.setenv("SVECALIGN_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="not a rank"):
        torch_setup.resolve_device("cpu")
    monkeypatch.delenv("SVECALIGN_COORDINATOR")
    assert torch_setup.join_coordinator("cpu") is False


# --- chip_smoke.py's phase 12, rehearsed ------------------------------------------------


def test_chip_smoke_multi_phase_rehearsal(tiny_card, tmp_path, capsys, monkeypatch):
    """Phase 12 end to end on the CPU over 2 CPU shards, at a tiny size
    (the chain tests' 2-layer encoders, 1-minute documents, 2^11 and 2^10
    mining rows), with the pipeline bullet: SVECALIGN_CPU_DEVICES=2 makes
    the CLIs' meshes two CPU shards, and the one-device run is the
    pipeline with one."""
    import chip_smoke as cs
    from svecalign_tpu_torch import pipeline as tpl
    from svecalign_tpu_torch.utils import embed_model_utils as temu

    tiny = temu._build_embed_model

    def capped(*args, **kwargs):
        p = inspect.signature(temu.load_embed_model).bind(*args, **kwargs)
        p.apply_defaults()
        p.arguments["max_tokens"] = min(p.arguments["max_tokens"], 40 * 16000)
        return tiny(**p.arguments)

    def one_device(meta, out, dev):
        memo = dict(temu._model_memo)
        temu._model_memo.clear()
        try:
            with monkeypatch.context() as m:
                m.setenv("SVECALIGN_CPU_DEVICES", "1")
                tpl.main([str(meta), str(out), "--src_lang", "en", "--tgt_lang", "de",
                          "--stages", cs.MULTI_PIPE_STAGES, "--device", dev])
        finally:
            temu._model_memo.clear()
            temu._model_memo.update(memo)

    monkeypatch.setattr(temu, "_build_embed_model", capped)
    monkeypatch.setenv("SVECALIGN_CPU_DEVICES", "2")
    res = cs.phase_multi(
        tmp_path, torch.device("cpu"), mesh=tmesh.Mesh(["cpu"] * 2),
        sizes=[(40, 37), (33, 36), (45, 41), (30, 44)], dim=32, doc_seconds=60,
        search_rows=1 << 11, sub_rows=1 << 10,
        align_kw=cs._align_kwargs_cli(max_size_full_dp=24, costs_sample_size=300),
        pipeline=True, one_card=one_device)
    out = capsys.readouterr().out
    assert out.count("bit-equal to the unsharded buckets") == 2
    assert "[multi] sonar stage 5.3 over 2 shards" in out
    assert "[multi] ShardedFlatIndex over 2 shards" in out
    assert "score_align --sharded_index margins within" in out
    assert "byte-identical" in out and "alignment files identical" in out
    assert set(res["times"]) == {"checks", "align", "encode", "search", "pipeline"}
    # with cards of their own, LASER is also timed at the pipeline's chunks
    monkeypatch.setattr(cs, "PIPE_MAX_TOKENS", 40 * 16000)
    enc = cs._multi_encode(tmp_path / "chunks", torch.device("cpu"), tmesh.Mesh(["cpu"] * 2), 30,
                           ("speech_laser",), pipeline_chunks=True)
    assert set(enc) == {"speech_laser", "speech_laser_600s"}
    assert "at the pipeline's 40 s chunks" in capsys.readouterr().out


def test_chip_smoke_multi_search_reads_the_mining_phase(tmp_path, monkeypatch, capsys):
    """In the whole script, phase 12's search part reads phase 9's corpus,
    coverage indexes and margins instead of making them again: rehearsed
    at the mining rehearsal's tiny size (tests/test_torch_mining_cli.py)."""
    import chip_smoke as cs
    from svecalign_tpu_torch.postprocess import score_align as tscore

    for name, value in (("MINING_PAIRS", 7), ("MINING_ROWS", 900), ("MINING_SUBSET_PAIRS", 4),
                        ("MINING_SUBSET_ROWS", 500), ("MINING_DIM", 128), ("MINING_IVF", "IVF8"),
                        ("MARGIN_CHECK_ROWS", 200)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(ttopk.FlatIndex, "TILE_THRESHOLD", 1)
    monkeypatch.setattr(ttopk.FlatIndex, "BLOCK", 256)
    monkeypatch.setattr(tscore, "CHUNK_ROWS", 300)
    cpu = torch.device("cpu")
    cs.phase_mining(tmp_path, cpu)
    capsys.readouterr()
    res = cs._multi_search(tmp_path / "multi", cpu, tmesh.Mesh(["cpu"] * 3), None, None, 128,
                           mining_root=tmp_path / "mining")
    log = capsys.readouterr().out
    assert "900 rows a language, read from phase 9's files" in log
    assert "on the 500-row coverage corpus" in log and not (tmp_path / "multi").exists()
    assert res["one_s"] > 0 and res["mesh_s"] > 0
