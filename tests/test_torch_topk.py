"""The port's k-NN search (``svecalign_tpu_torch.ops.topk``) and index
files (``utils.index_utils``) against the JAX package's, on the CPU.

Same numpy inputs through both: Flat dense and tiled (tiling forced by
patching ``TILE_THRESHOLD`` / ``BLOCK`` in both packages), the int8 tier
dense and tiled (also against the dequantised numpy oracle), padding
past ``ntotal``, fp16 corpus storage, k-means, IVF host and device routes
and the full probe against Flat, and the faiss-format files.

Distances agree within 1e-5. Ids are compared where the distance is
isolated: ``torch.topk`` and ``lax.top_k`` may order (or pick) equal
distances differently, so a position whose float64 distance lies within
``TIE_TOL`` of a neighbour's in the sorted list is not compared.
"""

import struct

import numpy as np
import pytest
import torch

from svecalign_tpu.ops import topk as jtopk
from svecalign_tpu.utils import index_utils as jidx
from svecalign_tpu_torch.ops import topk as ttopk
from svecalign_tpu_torch.utils import index_utils as tidx

torch.set_num_threads(2)

DIST_TOL = 1e-5
TIE_TOL = 1e-4
CPU = "cpu"


def _unit_rows(rng, n, d, fp16=False):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x = ttopk.normalize_l2(x)
    return x.astype(np.float16).astype(np.float32) if fp16 else x


def _sorted_d64(queries, corpus):
    q, c = queries.astype(np.float64), corpus.astype(np.float64)
    d = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2 * q @ c.T
    return np.sort(d, axis=1)


def _isolated(d64_sorted, k):
    """(nq, k) bool: positions whose distance is not within TIE_TOL of the
    previous or the next in the row's full sorted list."""
    d = d64_sorted[:, : k + 1]
    gaps = np.diff(d, axis=1)
    left = np.concatenate([np.full((d.shape[0], 1), np.inf), gaps[:, : k - 1]], axis=1)
    return (left > TIE_TOL) & (gaps[:, :k] > TIE_TOL)


def _assert_same(got, want, d64_sorted=None, k=None, min_isolated=0.5):
    (dg, ig), (dw, iw) = got, want
    assert dg.shape == dw.shape and ig.shape == iw.shape
    np.testing.assert_allclose(dg, dw, rtol=DIST_TOL, atol=DIST_TOL)
    if d64_sorted is None:
        np.testing.assert_array_equal(ig, iw)
        return
    iso = _isolated(d64_sorted, k)
    assert iso.mean() >= min_isolated, iso.mean()
    np.testing.assert_array_equal(np.asarray(ig)[iso], np.asarray(iw)[iso])


def _flat_pair(corpus, **kw):
    j = jtopk.FlatIndex(dim=corpus.shape[1], **kw)
    t = ttopk.FlatIndex(dim=corpus.shape[1], device=CPU, **kw)
    j.add(corpus)
    t.add(corpus)
    return j, t


@pytest.fixture
def tiled(monkeypatch):
    """Force the streaming path in both packages (128-row blocks)."""
    for mod in (jtopk, ttopk):
        monkeypatch.setattr(mod.FlatIndex, "TILE_THRESHOLD", 1)
        monkeypatch.setattr(mod.FlatIndex, "BLOCK", 128)


@pytest.mark.parametrize("fp16", [False, True])
def test_flat_dense_matches_jax(fp16):
    rng = np.random.default_rng(1)
    corpus, queries = _unit_rows(rng, 300, 32, fp16), _unit_rows(rng, 40, 32)
    j, t = _flat_pair(corpus)
    got, want = t.search(queries, 8), j.search(queries, 8)
    _assert_same(got, want, _sorted_d64(queries, corpus), 8)
    assert t._device_cache[0].dtype == (torch.float16 if fp16 else torch.float32)
    assert t._device_cache[0].shape[0] == 300  # dense: no padding


@pytest.mark.parametrize("n,k", [(1000, 7), (256, 16), (130, 5)])
def test_flat_tiled_matches_jax_and_dense(tiled, n, k):
    rng = np.random.default_rng(n)
    corpus, queries = _unit_rows(rng, n, 24), _unit_rows(rng, 33, 24)
    j, t = _flat_pair(corpus)
    got = t.search(queries, k)
    assert t._device_cache[0].shape[0] % 128 == 0  # padded to whole blocks
    d64 = _sorted_d64(queries, corpus)
    _assert_same(got, j.search(queries, k), d64, k)
    dense = ttopk.FlatIndex(dim=24, device=CPU)
    dense.add(corpus)
    dense.TILE_THRESHOLD = 1 << 40
    _assert_same(got, dense.search(queries, k), d64, k)


def test_tiled_merge_keeps_the_earlier_block_on_ties(tiled):
    """Duplicate rows in two blocks: the earlier block's row comes first,
    as the JAX scan's ``top_k`` of ``[best, new]`` puts it."""
    rng = np.random.default_rng(5)
    base = _unit_rows(rng, 200, 16)
    corpus = np.concatenate([base, base[:60]])  # rows 200-259 repeat 0-59
    queries = base[:10] + 1e-3 * _unit_rows(rng, 10, 16)
    j, t = _flat_pair(corpus)
    (dg, ig), (dw, iw) = t.search(queries, 4), j.search(queries, 4)
    np.testing.assert_allclose(dg, dw, rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_array_equal(ig[:, :2], iw[:, :2])
    np.testing.assert_array_equal(ig[:, 0], np.arange(10))
    np.testing.assert_array_equal(ig[:, 1], np.arange(10) + 200)


def test_smallest_k_orders_ties_by_index():
    d2 = torch.tensor([[3.0, 1.0, 2.0, 1.0, 1.0, 0.5]])
    d, i = ttopk._smallest_k(d2, 4)
    assert d.tolist() == [[0.5, 1.0, 1.0, 1.0]] and i.tolist() == [[5, 1, 3, 4]]


@pytest.mark.parametrize("tiling", [False, True])
def test_int8_matches_jax_and_dequantized_oracle(request, tiling):
    if tiling:
        request.getfixturevalue("tiled")
    rng = np.random.default_rng(21)
    corpus, queries = _unit_rows(rng, 500, 64), _unit_rows(rng, 20, 64)
    j, t = _flat_pair(corpus, corpus_quant="int8")
    got, want = t.search(queries, 8), j.search(queries, 8)
    np.testing.assert_allclose(got[0], want[0], rtol=DIST_TOL, atol=DIST_TOL)
    codes, scales, csq = ttopk._quantize_rows_host(corpus)
    jcodes, jscales, jcsq = jtopk._quantize_rows_host(corpus)
    for a, b in ((codes, jcodes), (scales, jscales), (csq, jcsq)):
        np.testing.assert_array_equal(a, b)
    deq = codes.astype(np.float64) * scales[:, None]
    full = (queries.astype(np.float64) ** 2).sum(1)[:, None] + (deq ** 2).sum(1)[None] \
        - 2 * queries.astype(np.float64) @ deq.T
    np.testing.assert_allclose(got[0], np.take_along_axis(full, got[1], 1), rtol=0, atol=0.02)
    _assert_same(got, want, np.sort(full, axis=1), 8)


def test_query_upload_fp16_close_to_fp32():
    rng = np.random.default_rng(9)
    corpus, queries = _unit_rows(rng, 500, 64), _unit_rows(rng, 40, 64)
    j, t = _flat_pair(corpus)
    d16, _ = t.search(queries, 8, upload_dtype="float16")
    np.testing.assert_allclose(d16, j.search(queries, 8, upload_dtype="float16")[0],
                               rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_allclose(d16, t.search(queries, 8)[0], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_k_beyond_ntotal_pads_like_jax(quant):
    rng = np.random.default_rng(4)
    corpus = _unit_rows(rng, 6, 32)
    j, t = _flat_pair(corpus, corpus_quant=quant)
    (dg, ig), (dw, iw) = t.search(corpus[:3], 16), j.search(corpus[:3], 16)
    assert dg.shape == ig.shape == (3, 16)
    assert np.isinf(dg[:, 6:]).all() and (ig[:, 6:] == -1).all()
    np.testing.assert_allclose(dg[:, :6], dw[:, :6], rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_array_equal(ig[:, 0], iw[:, 0])
    d, i = ttopk._pad_to_k(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), 5)
    assert d.shape == (2, 5) and np.isinf(d[:, 3:]).all() and (i[:, 3:] == -1).all()


def test_fp16_storage_is_exact():
    """A corpus exact in fp16 is stored fp16 and searched exactly: the
    same distances as an fp32-stored copy, bit for bit."""
    rng = np.random.default_rng(6)
    corpus, queries = _unit_rows(rng, 200, 32, fp16=True), _unit_rows(rng, 10, 32)
    a = ttopk.FlatIndex(dim=32, device=CPU)
    a.add(corpus)
    b = ttopk.FlatIndex(dim=32, device=CPU)
    b.add(corpus)
    b._fp16_exact = False
    da, ia = a.search(queries, 5)
    db, ib = b.search(queries, 5)
    assert a._device_cache[0].dtype == torch.float16
    assert b._device_cache[0].dtype == torch.float32
    np.testing.assert_array_equal(da, db)
    np.testing.assert_array_equal(ia, ib)
    c = ttopk.FlatIndex(dim=32, device=CPU)
    c.add(_unit_rows(rng, 5, 32))  # not fp16-exact
    assert not c._fp16_exact


def test_device_queries_stay_on_device():
    rng = np.random.default_rng(7)
    corpus, queries = _unit_rows(rng, 100, 16), _unit_rows(rng, 12, 16)
    _, t = _flat_pair(corpus)
    d, i = t.search_device_queries(torch.from_numpy(queries).half(), 4)
    assert isinstance(d, torch.Tensor) and d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), t.search(queries, 4, upload_dtype="float16")[0])
    with pytest.raises(ValueError):
        t.search_device_queries(torch.from_numpy(queries), 101)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ttopk.FlatIndex(dim=8), lambda: ttopk.IVFIndex(dim=8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):  # its default mesh: every card
        ttopk.ShardedFlatIndex(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="multiple of"):
        ttopk.FlatIndex(dim=8, device=CPU).set_device_corpus(torch.zeros((3, 8)), 0)


# --- IVF -------------------------------------------------------------------------


def _clustered(rng, n, d, n_clusters, spread=0.3):
    centers = _unit_rows(rng, n_clusters, d)
    lab = rng.integers(0, n_clusters, n)
    return ttopk.normalize_l2(centers[lab] + spread * rng.standard_normal((n, d))
                              .astype(np.float32))


def test_kmeans_iter_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    data = _clustered(rng, 400, 16, 8)
    init = data[np.random.default_rng(42).choice(400, size=10, replace=False)]
    got = ttopk._kmeans_iter(torch.from_numpy(data), torch.from_numpy(init), 10).numpy()
    want = np.asarray(jtopk._kmeans_iter(jnp.asarray(data), jnp.asarray(init), 10))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a_got = ttopk._assign_to_centroids(torch.from_numpy(data), torch.from_numpy(got)).numpy()
    a_want = np.asarray(jtopk._assign_to_centroids(jnp.asarray(data), jnp.asarray(want)))
    np.testing.assert_array_equal(a_got, a_want)
    # an empty list keeps its centroid: a centroid far from every row
    far = np.concatenate([init[:3], -data.mean(0, keepdims=True) * 50])
    far = ttopk.normalize_l2(far)
    got = ttopk._kmeans_iter(torch.from_numpy(data), torch.from_numpy(far), 1).numpy()
    want = np.asarray(jtopk._kmeans_iter(jnp.asarray(data), jnp.asarray(far), 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ivf_pair(corpus, nlist, nprobe):
    """A JAX and a port IVF index in the same state: both trained on the
    corpus, the port given JAX's centroids so that the searches compare."""
    j = jtopk.IVFIndex(dim=corpus.shape[1], nlist=nlist, nprobe=nprobe)
    t = ttopk.IVFIndex(dim=corpus.shape[1], nlist=nlist, nprobe=nprobe, device=CPU)
    j.train(corpus)
    t.train(corpus)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5, atol=1e-5)
    t.centroids = j.centroids.copy()
    j.add(corpus)
    t.add(corpus)
    np.testing.assert_array_equal(t._assignments, j._assignments)
    return j, t


@pytest.mark.parametrize("nq,use_device", [(40, False), (300, None), (600, True)])
def test_ivf_routes_match_jax(nq, use_device):
    rng = np.random.default_rng(12)
    corpus = _clustered(rng, 1500, 32, 12)
    queries = _clustered(rng, nq, 32, 12)
    j, t = _ivf_pair(corpus, nlist=16, nprobe=4)
    got = t.search(queries, 10, use_device=use_device)
    want = j.search(queries, 10, use_device=use_device)
    assert got[0].shape == got[1].shape == (nq, 10)
    np.testing.assert_allclose(got[0], want[0], rtol=DIST_TOL, atol=DIST_TOL)
    # ids where a distance is isolated among the returned ones
    d = want[0].astype(np.float64)
    gaps = np.diff(d, axis=1)
    iso = np.ones_like(d, dtype=bool)
    iso[:, 1:] &= gaps > TIE_TOL
    iso[:, :-1] &= gaps > TIE_TOL
    iso[:, -1] = False  # its successor is not known
    assert iso.mean() > 0.5
    np.testing.assert_array_equal(got[1][iso], want[1][iso])


def test_ivf_full_probe_equals_flat():
    rng = np.random.default_rng(13)
    corpus, queries = _clustered(rng, 700, 32, 6), _clustered(rng, 300, 32, 6)
    ivf = ttopk.IVFIndex(dim=32, nlist=8, nprobe=8, device=CPU)
    ivf.train(corpus)
    ivf.add(corpus)
    flat = ttopk.FlatIndex(dim=32, device=CPU)
    flat.add(corpus)
    d64 = _sorted_d64(queries, corpus)
    want = flat.search(queries, 6)
    for use_device in (False, True):
        _assert_same(ivf.search(queries, 6, use_device=use_device), want, d64, 6)


def test_ivf_device_route_tiny_lists_and_padding():
    """More lists than blocks can hold, k past the probed candidates: +inf
    and id -1 fill, as in JAX."""
    rng = np.random.default_rng(14)
    corpus = _unit_rows(rng, 40, 16)
    queries = _unit_rows(rng, 260, 16)
    j, t = _ivf_pair(corpus, nlist=20, nprobe=1)
    got = t.search(queries, 8, use_device=True)
    want = j.search(queries, 8, use_device=True)
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(want[0]))
    np.testing.assert_array_equal(got[1] == -1, np.isinf(got[0]))
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=DIST_TOL, atol=DIST_TOL)


# --- index files -----------------------------------------------------------------


def test_flat_files_byte_identical_and_cross_readable(tmp_path):
    rng = np.random.default_rng(15)
    vecs = _unit_rows(rng, 50, 24)
    tidx.write_flat_index(vecs, tmp_path / "t.idx")
    jidx.write_flat_index(vecs, tmp_path / "j.idx")
    assert (tmp_path / "t.idx").read_bytes() == (tmp_path / "j.idx").read_bytes()
    np.testing.assert_array_equal(tidx.read_flat_index(tmp_path / "j.idx"), vecs)
    np.testing.assert_array_equal(jidx.read_flat_index(tmp_path / "t.idx"), vecs)
    loaded = tidx.load_index(tmp_path / "j.idx", device=CPU)
    assert isinstance(loaded, ttopk.FlatIndex) and loaded.ntotal == 50
    tidx.write_flat_index(np.zeros((0, 24), np.float32), tmp_path / "empty.idx")
    assert tidx.load_index(tmp_path / "empty.idx", device=CPU).ntotal == 0
    assert [tidx.determine_index_type(n) for n in (10, 4_000_000, 20_000_000)] == [
        jidx.determine_index_type(n) for n in (10, 4_000_000, 20_000_000)]


def test_ivf_files_byte_identical_and_cross_readable(tmp_path):
    rng = np.random.default_rng(16)
    corpus = _clustered(rng, 300, 16, 5)
    j, t = _ivf_pair(corpus, nlist=8, nprobe=3)
    tidx.write_ivf_index(t, tmp_path / "t.idx")
    jidx.write_ivf_index(j, tmp_path / "j.idx")
    assert (tmp_path / "t.idx").read_bytes() == (tmp_path / "j.idx").read_bytes()
    back = jidx.read_ivf_index(tmp_path / "t.idx", nprobe=3)
    np.testing.assert_array_equal(back.centroids, t.centroids)
    np.testing.assert_array_equal(back._vectors, t._vectors)
    np.testing.assert_array_equal(back._assignments, t._assignments)
    mine = tidx.load_index(tmp_path / "j.idx", nprobe=5, device=CPU)
    assert isinstance(mine, ttopk.IVFIndex) and mine.nprobe == 5
    np.testing.assert_array_equal(mine._vectors, j._vectors)
    np.testing.assert_array_equal(mine._assignments, j._assignments)
    # faiss's sparse (list, size) table reads too
    buf = bytearray((tmp_path / "t.idx").read_bytes())
    il = buf.index(b"ilar")
    sizes = np.frombuffer(bytes(buf), np.uint64, 8, il + 32)
    sprs = np.array([v for i, n in enumerate(sizes) if n for v in (i, n)], np.uint64)
    buf[il + 20:il + 20 + 12 + 8 * 8] = b"sprs" + struct.pack("<Q", len(sprs)) + sprs.tobytes()
    (tmp_path / "sprs.idx").write_bytes(bytes(buf))
    back = tidx.read_ivf_index(tmp_path / "sprs.idx", device=CPU)
    np.testing.assert_array_equal(back._vectors, t._vectors)
    np.testing.assert_array_equal(back._assignments, t._assignments)


def test_read_ivf_index_checks_fp16_exactness(tmp_path):
    """A fault of the JAX package's reader: it leaves ``_fp16_exact`` at
    True for any file, so its device route searches an fp16-rounded copy
    of an fp32 corpus and its full probe misses Flat by ~1e-5. The port's
    reader checks the rows (``IVFIndex.set_lists``): its device route
    equals Flat within fp32 rounding."""
    rng = np.random.default_rng(17)
    corpus, queries = _clustered(rng, 600, 32, 6), _clustered(rng, 300, 32, 6)
    ivf = ttopk.IVFIndex(dim=32, nlist=8, nprobe=8, device=CPU)
    ivf.train(corpus)
    ivf.add(corpus)
    tidx.write_ivf_index(ivf, tmp_path / "ivf.idx")
    mine = tidx.read_ivf_index(tmp_path / "ivf.idx", device=CPU)
    theirs = jidx.read_ivf_index(tmp_path / "ivf.idx")
    assert not mine._fp16_exact and theirs._fp16_exact
    flat = ttopk.FlatIndex(dim=32, device=CPU)
    flat.add(corpus)
    want = flat.search(queries, 6)[0]
    np.testing.assert_allclose(mine.search(queries, 6, use_device=True)[0], want,
                               rtol=DIST_TOL, atol=1e-6)
    err = np.abs(theirs.search(queries, 6, use_device=True)[0] - want).max()
    assert err > 1e-5, err
