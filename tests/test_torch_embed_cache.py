"""The port's fused-pipeline row cache (svecalign_tpu_torch.utils.embed_cache)
against the JAX package's (svecalign_tpu.utils.embed_cache), on the CPU:
the same puts, gets and gathers on both give the same ``stats`` and byte
accounting, and the gathered rows are bit-equal, padding rows zero. The
rows are fp16 from a numpy seed; the JAX side holds them as jax arrays,
the port as CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.utils import embed_cache as jcache
from svecalign_tpu_torch.utils import embed_cache as tcache
from svecalign_tpu_torch.utils.embedding_utils import write_stopes_embedding

ROWS, DIM = 16, 8


@pytest.fixture(autouse=True)
def _fresh_caches():
    for cache in (jcache, tcache):
        cache.disable()
        for k in cache.stats:
            cache.stats[k] = 0
    yield
    for cache in (jcache, tcache):
        cache.disable()
        for k in cache.stats:
            cache.stats[k] = 0


def _doc(rng, n, rows=ROWS, dim=DIM):
    """A cache entry: (rows, dim) fp16 whose first n rows are the document's."""
    padded = np.zeros((rows, dim), np.float16)
    padded[:n] = rng.standard_normal((n, dim)).astype(np.float16)
    return padded


def _put_both(path, n, padded):
    jcache.put(path, n, jnp.asarray(padded))
    tcache.put(path, n, torch.from_numpy(padded))


def test_put_get_stats_and_bytes_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS)
    docs = {str(tmp_path / f"d{i}.embed"): (n, _doc(rng, n)) for i, n in enumerate((5, 16, 9))}
    for path, (n, padded) in docs.items():
        _put_both(path, n, padded)
    _put_both(str(tmp_path / "d0.embed"), 5, docs[str(tmp_path / "d0.embed")][1])  # re-put
    assert tcache._bytes == jcache._bytes == 3 * ROWS * DIM * 2
    for path, (n, padded) in docs.items():
        got = tcache.get(path)
        want = jcache.get(path)
        assert got[0] == want[0] == n
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # a relative path names the same entry as its absolute form
    monkeypatch.chdir(tmp_path)
    assert tcache.get("d1.embed")[0] == jcache.get("d1.embed")[0] == 16
    assert tcache.get(tmp_path / "nope.embed") is None
    assert jcache.get(tmp_path / "nope.embed") is None
    assert tcache.stats == jcache.stats
    assert tcache.stats == {"put": 4, "rejected": 0, "hit": 4, "miss": 1, "gather": 0,
                            "gather_miss": 0}


def test_byte_cap_rejects_and_reput_is_accounted(tmp_path):
    rng = np.random.default_rng(1)
    entry_bytes = ROWS * DIM * 2
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS, byte_cap=2 * entry_bytes)
    a, b, c = (_doc(rng, 4) for _ in range(3))
    _put_both("a.embed", 4, a)
    _put_both("b.embed", 4, b)
    _put_both("c.embed", 4, c)  # over the cap: rejected
    _put_both("a.embed", 4, c)  # a re-put replaces, within the cap
    for cache in (jcache, tcache):
        assert cache._bytes == 2 * entry_bytes
    assert tcache.get("c.embed") is None and jcache.get("c.embed") is None
    np.testing.assert_array_equal(tcache.get("a.embed")[1].numpy(), c)
    np.testing.assert_array_equal(np.asarray(jcache.get("a.embed")[1]), c)
    assert tcache.stats == jcache.stats
    assert tcache.stats["rejected"] == 1 and tcache.stats["put"] == 3
    # disabled: put and get do nothing
    tcache.disable()
    tcache.put("d.embed", 4, torch.from_numpy(a))
    assert tcache.get("d.embed") is None and tcache._bytes == 0 and not tcache._cache


@pytest.mark.parametrize("pad_multiple", [1, 8, 1024])
def test_gather_rows_bit_equal_with_zero_padding(pad_multiple):
    rng = np.random.default_rng(2)
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS)
    docs = {"x.embed": (7, _doc(rng, 7)), "y.embed": (12, _doc(rng, 12))}
    for path, (n, padded) in docs.items():
        _put_both(path, n, padded)
    entries = [("y.embed", 11), ("x.embed", 0), ("x.embed", 6), ("y.embed", 0), ("y.embed", 3),
               ("x.embed", 6)]
    got, n = tcache.gather_rows_device(entries, pad_multiple=pad_multiple)
    want, jn = jcache.gather_rows_device(entries, pad_multiple=pad_multiple)
    assert n == jn == len(entries)
    assert got.dtype == torch.float16 and got.shape[0] == -(-n // pad_multiple) * pad_multiple
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:n].numpy(),
                                  np.stack([docs[p][1][r] for p, r in entries]))
    assert not got[n:].any()
    assert tcache.stats == jcache.stats and tcache.stats["gather"] == 1
    # the stack is built once and reused until the cache changes
    stack = tcache._stack
    tcache.gather_rows_device(entries[:2])
    assert tcache._stack is stack
    tcache.put("z.embed", 1, torch.zeros((ROWS, DIM), dtype=torch.float16))
    assert tcache._stack is None


def test_gather_rejects_rows_beyond_document_length():
    """A row past the document's real row count misses (the file path then
    raises), never gathers a zero padding row; so does an uncached path."""
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS)
    rows = np.zeros((ROWS, 4), np.float16)
    rows[:3] = 1.0
    _put_both("doc.embed", 3, rows)
    for cache in (jcache, tcache):
        assert cache.gather_rows_device([("doc.embed", 2)]) is not None
        assert cache.gather_rows_device([("doc.embed", 3)]) is None
        assert cache.gather_rows_device([("doc.embed", -1)]) is None
        assert cache.gather_rows_device([("other.embed", 0)]) is None
        assert cache.gather_rows_device([]) is None
    assert tcache.stats == jcache.stats and tcache.stats["gather_miss"] == 3


def test_mixed_shapes_turn_the_gather_off():
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS)
    _put_both("a.embed", 2, np.ones((ROWS, DIM), np.float16))
    _put_both("b.embed", 2, np.ones((ROWS, DIM + 1), np.float16))
    assert tcache.gather_rows_device([("a.embed", 0)]) is None
    assert jcache.gather_rows_device([("a.embed", 0)]) is None
    assert tcache.stats == jcache.stats and tcache.stats["gather_miss"] == 1


def test_clear_disable_and_index_registry(tmp_path):
    tcache.enable(rows=ROWS)
    tcache.put("a.embed", 2, torch.ones((ROWS, DIM), dtype=torch.float16))
    index = object()
    tcache.register_index(tmp_path / "Flat.populate.idx", index)
    assert tcache.get_index(str(tmp_path / "Flat.populate.idx")) is index
    assert tcache.gather_rows_device([("a.embed", 1)]) is not None
    tcache.clear()
    assert tcache.enabled and tcache._bytes == 0 and tcache._stack is None
    assert tcache.get("a.embed") is None and tcache.get_index(tmp_path / "Flat.populate.idx") is None
    assert tcache.gather_rows_device([("a.embed", 1)]) is None
    tcache.register_index("i.idx", index)
    tcache.disable()
    assert not tcache.enabled and tcache.get_index("i.idx") is None
    tcache.register_index("i.idx", index)  # ignored while disabled
    tcache.enable()
    assert tcache.get_index("i.idx") is None and tcache.max_rows == 4096


def test_put_from_file_pads_the_file_rows(tmp_path):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, DIM)).astype(np.float32)
    path = tmp_path / "doc.embed"
    write_stopes_embedding(rows, str(path), fp16=True)
    for cache in (jcache, tcache):
        cache.enable(rows=ROWS)
    tcache.put_from_file(str(path), device="cpu")
    jcache.put_from_file(str(path))
    n, got = tcache.get(path)
    jn, want = jcache.get(path)
    assert n == jn == 5 and got.shape == (ROWS, DIM) and got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:5].numpy(), rows.astype(np.float16))
    assert not got[5:].any()
