"""Exact and IVF k-NN search with torch products and ``torch.topk``.

Port of the JAX package's ``ops/topk.py`` (reference
svecalign/utils/mining_utils.py:14-42, postprocess/score_align.py:118-161,
where faiss-gpu does the search). No kernel of ours: the JAX package
computes the similarities with XLA ``jnp.dot`` at ``Precision.HIGHEST``
(full fp32) and selects with ``jax.lax.top_k``; here they are cuBLAS
products with TF32 off (:mod:`svecalign_tpu_torch.utils.torch_setup`) and
``torch.topk``. The two ``lax.scan`` block searches become a Python loop
over corpus blocks with a running top-k merge, and the k-means
``lax.scan`` a loop of Lloyd iterations.

Distance semantics match faiss IndexFlatL2 on L2-normalized vectors:
``search`` returns squared-L2 distances ``||q||^2 + ||c||^2 - 2 q.c``
(computed with true norms) so the margin code keeps the reference's
``cos = (2 - L2^2) / 2`` conversion.

Tie order. ``jax.lax.top_k`` puts the lower index first among equal
values, and the tiled merge concatenates ``[best, new]`` so the earlier
block's row wins a tie. ``torch.topk`` promises no order among ties (nor
which of them it keeps when they straddle the k-th place), so
:func:`_smallest_k` re-sorts what it returns by (distance, index) and the
merge is a stable sort: ids then equal JAX's wherever the k-th and
(k+1)-th distances differ. Stage 6.7 reads only the distances, so its
margins do not depend on the tie order at all.

The fused pipeline hands rows that stay on the card: a Flat corpus
gathered from the embed cache (``FlatIndex.set_device_corpus``, normalised
on the device; re-quantised there for ``corpus_quant="int8"``) and query
rows (:func:`normalize_rows_device`).

The sharded tiers (``ShardedFlatIndex``, ``ShardedIVFIndex``: faiss's
fp16-shard in the reference) split the corpus row-wise over a mesh's data
axis (``parallel/mesh.py``). Each shard searches its rows on its own
device with the single-device code (the tiled Flat search; the IVF probe,
gather and product), the ids offset to global rows; the per-shard
``(nq, k)`` candidates are copied to the mesh's first device and merged
there by a stable sort on distance in shard order, so ties resolve to the
lower global row, as in single-device Flat (the JAX package all-gathers
them and runs one ``top_k``). One thread issues every shard's search
before anything waits: the launches are asynchronous.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.parallel.mesh import Mesh, make_mesh
from svecalign_tpu_torch.utils.phase_clock import PhaseClock
from svecalign_tpu_torch.utils.torch_setup import resolve_device

search_seconds = {}
"""With SVECALIGN_SEARCH_PROFILE=1: cumulative wall seconds of the Flat
searches by phase (``products``, ``topk``, ``merge``), the device
synchronised at each phase's end."""


def normalize_l2(x: np.ndarray) -> np.ndarray:
    """L2 normalization matching faiss.normalize_L2 (float32)."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.sqrt(np.sum(x * x, axis=1, keepdims=True))
    return x / np.where(norms == 0, 1.0, norms)


def normalize_rows_device(rows: torch.Tensor) -> torch.Tensor:
    """L2 normalization of a tensor's rows in fp32, on its device, with
    :func:`normalize_l2`'s zero-row convention (fused query rows)."""
    x = rows.float()
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.where(norms == 0, 1.0, norms)


def _normalize_corpus(rows: torch.Tensor, n: int):
    """Gathered fp16 rows -> (fp32 L2-normalized corpus, corpus_sq), rows
    at ``n`` and past zero with ``corpus_sq = inf`` (padding never wins a
    top-k): the device side of ``FlatIndex.set_device_corpus``."""
    x = normalize_rows_device(rows)
    valid = torch.arange(x.shape[0], device=x.device) < n
    sq = torch.where(valid, torch.sum(x * x, dim=1), float("inf"))
    return torch.where(valid[:, None], x, 0.0), sq


def _exact_in_fp16(x: np.ndarray) -> bool:
    return np.array_equal(x, x.astype(np.float16).astype(np.float32))


def _clock(device: torch.device) -> PhaseClock:
    return PhaseClock(device, search_seconds, "SVECALIGN_SEARCH_PROFILE")


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values of each row, ascending, equal values in
    ascending column order (``lax.top_k(-d2, k)`` up to ties at the k-th
    place; see the module docstring)."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx, perm = torch.sort(idx, dim=1)
    vals, perm2 = torch.sort(torch.gather(vals, 1, perm), dim=1, stable=True)
    return vals, torch.gather(idx, 1, perm2)


def _merge(best_d, best_i, new_d, new_i, k: int):
    """Running top-k merge: ``[best, new]`` by a stable sort, so the
    earlier block keeps a tie (the JAX scan's ``top_k`` of the concat)."""
    cand_d = torch.cat([best_d, new_d], dim=1)
    cand_i = torch.cat([best_i, new_i], dim=1)
    d, pos = torch.sort(cand_d, dim=1, stable=True)
    return d[:, :k].contiguous(), torch.gather(cand_i, 1, pos[:, :k])


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=1, keepdim=True)


def _search_dense(queries, corpus, corpus_sq, k: int):
    """``(q_sq + corpus_sq) - 2 q.c`` in fp32 (the fp16 corpus and fp16
    query uploads upcast here), then the k smallest."""
    clock = _clock(queries.device)
    q = queries.float()
    d2 = (_row_sq(q) + corpus_sq[None, :]).addmm_(q, corpus.float().T, alpha=-2.0)
    clock.mark("products")
    out = _smallest_k(d2, k)
    clock.mark("topk")
    return out


def _search_dense_tiled(queries, corpus, corpus_sq, k: int, block: int):
    """Streaming exact search: loop over ``block``-row corpus blocks, keep
    a running top-k. Memory is one (nq, block) fp32 distance buffer,
    written in place (``addmm_``) block after block. The corpus is padded
    to a multiple of ``block`` with ``corpus_sq = +inf`` on padding rows."""
    clock = _clock(queries.device)
    q = queries.float()
    q_sq = _row_sq(q)
    nq = q.shape[0]
    buf = torch.empty((nq, block), dtype=torch.float32, device=q.device)
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=q.device)
    for blk in range(corpus.shape[0] // block):
        rows = slice(blk * block, (blk + 1) * block)
        torch.add(q_sq, corpus_sq[None, rows], out=buf)
        buf.addmm_(q, corpus[rows].float().T, alpha=-2.0)
        clock.mark("products")
        d, i = _smallest_k(buf, k)
        clock.mark("topk")
        best_d, best_i = _merge(best_d, best_i, d, i + blk * block, k)
        clock.mark("merge")
    return best_d, best_i


def _quantize_rows_host(corpus: np.ndarray):
    """Symmetric per-row int8 quantization of a corpus (host side).

    Returns ``(codes int8, scales f32, corpus_sq f32)`` where
    ``codes * scales[:, None]`` is the dequantized corpus and ``corpus_sq``
    is computed from the DEQUANTIZED rows, so distances produced with
    these tensors are exactly the L2 geometry of the quantized corpus
    (~1e-3 relative vs the fp32 original on L2-normalized embeddings)."""
    corpus = np.asarray(corpus, dtype=np.float32)
    amax = np.max(np.abs(corpus), axis=1) if corpus.size else np.zeros(0)
    scales = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
    codes = np.clip(np.rint(corpus / scales[:, None]), -127, 127).astype(np.int8)
    deq = codes.astype(np.float32) * scales[:, None]
    corpus_sq = np.sum(deq * deq, axis=1).astype(np.float32)
    return codes, scales, corpus_sq


def _quantize_corpus_device(corpus: torch.Tensor, corpus_sq: torch.Tensor):
    """:func:`_quantize_rows_host` on the device, for a corpus installed by
    ``FlatIndex.set_device_corpus`` (fp32 normalized rows, ``corpus_sq =
    inf`` on padding rows, which stays inf). ``torch.round`` rounds half
    to even, as ``np.rint``. In JAX this branch is unreachable (every int8
    run quantizes on the host); it is ported as JAX has it."""
    amax = torch.amax(torch.abs(corpus), dim=1)
    scales = torch.where(amax == 0, 1.0, amax / 127.0)
    codes = torch.clamp(torch.round(corpus / scales[:, None]), -127, 127).to(torch.int8)
    deq = codes.float() * scales[:, None]
    sq = torch.sum(deq * deq, dim=1)
    return codes, scales.float(), torch.where(torch.isinf(corpus_sq), float("inf"), sq)


def _bf16_sims(qb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 products accumulated and returned in fp32 (the JAX
    ``preferred_element_type=float32``): one cuBLAS bf16 GEMM on the card.
    int8 codes are exact in bf16 and a bf16 x bf16 product is exact in
    fp32, so the CPU's fp32 product of the same values is the same sum."""
    cb = codes.to(torch.bfloat16)
    if qb.is_cuda:
        return torch.mm(qb, cb.T, out_dtype=torch.float32)
    return qb.float() @ cb.float().T


def _q8_distances(qb, q_sq, codes, scales, corpus_sq):
    sims = _bf16_sims(qb, codes).mul_(scales[None, :])
    return (q_sq + corpus_sq[None, :]).sub_(sims, alpha=2.0)


def _search_dense_q8(queries, codes, scales, corpus_sq, k: int):
    """Exact search over an int8-quantized corpus: queries rounded to
    bf16, one bf16 GEMM with fp32 output, times the per-row scales."""
    clock = _clock(queries.device)
    d2 = _q8_distances(queries.to(torch.bfloat16), _row_sq(queries.float()), codes, scales,
                       corpus_sq)
    clock.mark("products")
    out = _smallest_k(d2, k)
    clock.mark("topk")
    return out


def _search_dense_tiled_q8(queries, codes, scales, corpus_sq, k: int, block: int):
    """Streaming variant of :func:`_search_dense_q8` (the block loop of
    :func:`_search_dense_tiled`; padding rows have ``corpus_sq = inf``)."""
    clock = _clock(queries.device)
    qb = queries.to(torch.bfloat16)
    q_sq = _row_sq(queries.float())
    nq = queries.shape[0]
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=queries.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=queries.device)
    for blk in range(codes.shape[0] // block):
        rows = slice(blk * block, (blk + 1) * block)
        d2 = _q8_distances(qb, q_sq, codes[rows], scales[rows], corpus_sq[rows])
        clock.mark("products")
        d, i = _smallest_k(d2, k)
        del d2
        clock.mark("topk")
        best_d, best_i = _merge(best_d, best_i, d, i + blk * block, k)
        clock.mark("merge")
    return best_d, best_i


def _pad_to_k(d2: np.ndarray, idx: np.ndarray, k: int):
    """Pad search results out to (nq, k): faiss IndexFlatL2 always returns
    k columns, with missing neighbors as +inf distance / -1 id."""
    if d2.shape[1] >= k:
        return d2, idx
    nq, missing = d2.shape[0], k - d2.shape[1]
    d2 = np.concatenate([d2, np.full((nq, missing), np.inf, d2.dtype)], axis=1)
    idx = np.concatenate([idx, np.full((nq, missing), -1, idx.dtype)], axis=1)
    return d2, idx


def _as_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device`` (copied first when it is read-only, as
    the index readers' ``frombuffer`` arrays are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _upload_queries(queries, upload_dtype: str, device: torch.device) -> torch.Tensor:
    """Host queries to the device, as fp16 (upcast in the search) when
    ``upload_dtype == "float16"``, else fp32; tensors pass as they are."""
    if isinstance(queries, torch.Tensor):
        return queries.to(device)
    queries = np.asarray(queries)
    return _as_tensor(queries.astype(np.float16 if upload_dtype == "float16" else np.float32,
                                     copy=False), device)


class FlatIndex:
    """Exact (Flat) index: the whole corpus lives in device memory.

    ``add`` accumulates vectors; ``search`` returns (squared L2, ids), both
    shaped (n_queries, k): the faiss IndexFlatL2 contract. ``device`` is
    where the corpus lives and the search runs ("cuda" unless the caller
    asks for the CPU; CUDA without a card raises)."""

    # above this many similarity-matrix cells, stream the corpus in blocks
    TILE_THRESHOLD = 1 << 28
    BLOCK = 1 << 15

    def __init__(self, dim: int = 1024, query_upload: str = "float32",
                 corpus_quant: str = "none", device="cuda"):
        self.dim = dim
        # "float16" halves the query upload (~1e-3 relative distance noise)
        self.query_upload = query_upload
        # "int8": per-row symmetric int8 device corpus, half fp16's memory,
        # searched by a bf16 GEMM (~1e-3 relative distance noise)
        if corpus_quant not in ("none", "int8"):
            raise ValueError(f"corpus_quant must be 'none' or 'int8', got {corpus_quant!r}")
        self.corpus_quant = corpus_quant
        self.device = resolve_device(device)
        self._chunks = []
        self._device_cache = None  # (corpus, corpus_sq) on device
        self._device_cache_q8 = None  # (codes, scales, corpus_sq) on device
        self._fp16_exact = True  # all added vectors round-trip through fp16
        self._installed_rows = 0  # rows of a device corpus with no host rows

    @property
    def ntotal(self) -> int:
        return sum(c.shape[0] for c in self._chunks) if self._chunks else self._installed_rows

    def add(self, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"want (n, {self.dim}) vectors, got {vectors.shape}")
        self._fp16_exact = self._fp16_exact and _exact_in_fp16(vectors)
        self._chunks.append(vectors)
        self._device_cache = None
        self._device_cache_q8 = None

    @property
    def corpus(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, self.dim), dtype=np.float32)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks, axis=0)]
        return self._chunks[0]

    def _device_corpus(self, tiled: bool):
        """Upload the corpus (+ padding for the tiled path) once; cache.

        When every added vector is exactly fp16-representable (the .embed
        files are fp16), the device copy is fp16: half the upload bytes and
        memory, upcast exactly in the search (bit-identical distances).
        ``corpus_sq`` is summed on the host, as in JAX."""
        if self._device_cache is None:
            n = self.ntotal
            if tiled:
                pad = (-n) % self.BLOCK
                corpus = np.pad(self.corpus, ((0, pad), (0, 0)))
                corpus_sq = np.sum(corpus * corpus, axis=1)
                corpus_sq[n:] = np.inf  # padding rows never win
            else:
                corpus = self.corpus
                corpus_sq = np.sum(corpus * corpus, axis=1)
            if self._fp16_exact:
                corpus = corpus.astype(np.float16)
            self._device_cache = (_as_tensor(corpus, self.device),
                                  _as_tensor(corpus_sq, self.device))
        return self._device_cache

    def _device_corpus_q8(self, tiled: bool):
        """int8 tier of :meth:`_device_corpus`: codes (a quarter of the
        fp32 bytes) and per-row scales, uploaded once; cached. A device
        corpus with no host rows behind it is quantized on the device (the
        JAX condition: prep_index's fused index also holds its host rows,
        so every int8 run quantizes on the host there)."""
        if self._device_cache_q8 is None and self._device_cache is not None \
                and not self._chunks:
            self._device_cache_q8 = _quantize_corpus_device(*self._device_cache)
        if self._device_cache_q8 is None:
            n = self.ntotal
            codes, scales, corpus_sq = _quantize_rows_host(self.corpus)
            if tiled:
                pad = (-n) % self.BLOCK
                codes = np.pad(codes, ((0, pad), (0, 0)))
                scales = np.pad(scales, (0, pad), constant_values=1.0)
                corpus_sq = np.pad(corpus_sq, (0, pad), constant_values=np.inf)
            self._device_cache_q8 = tuple(
                _as_tensor(a, self.device) for a in (codes, scales, corpus_sq))
        return self._device_cache_q8

    def set_device_corpus(self, rows_fp16: torch.Tensor, n_valid: int) -> None:
        """Install a corpus assembled on the device (the fused pipeline; no
        upload): ``rows_fp16`` is an (n_padded, dim) fp16 tensor of
        unnormalized rows gathered from ``utils/embed_cache.py``, n_padded a
        multiple of ``BLOCK``. It is normalized on the device and padding
        rows get ``corpus_sq = inf``; distances then equal the host path's
        up to the fp32 summation order of the norms."""
        if rows_fp16.shape[0] % self.BLOCK:
            raise ValueError(f"{rows_fp16.shape[0]} rows: not a multiple of {self.BLOCK}")
        if n_valid != self.ntotal:
            raise ValueError(f"{n_valid} device rows for an index of {self.ntotal}")
        self._device_cache = _normalize_corpus(rows_fp16.to(self.device), n_valid)
        self._device_cache_q8 = None

    def _install(self, rows: torch.Tensor, corpus_sq: torch.Tensor) -> None:
        """Hold ``rows`` (normalized, on this index's device; no host rows
        behind them) and their ``corpus_sq`` as the whole corpus, padded
        to whole blocks with ``corpus_sq = inf``: a shard of a device
        corpus (``ShardedFlatIndex.from_index``)."""
        n = rows.shape[0]
        pad = (-n) % self.BLOCK
        self._chunks = []
        self._installed_rows = n
        self._device_cache = (
            torch.nn.functional.pad(rows, (0, 0, 0, pad)),
            torch.cat([corpus_sq, corpus_sq.new_full((pad,), float("inf"))]))
        self._device_cache_q8 = None

    def _search_core(self, queries: torch.Tensor, k_eff: int):
        """Search over device-resident queries -> device (d2, idx)."""
        tiled = self.ntotal * queries.shape[0] > self.TILE_THRESHOLD
        if self.corpus_quant == "int8":
            codes, scales, corpus_sq = self._device_corpus_q8(tiled)
            if not tiled and codes.shape[0] != self.ntotal:
                tiled = True  # cache built padded; reuse it tiled
            if tiled and codes.shape[0] % self.BLOCK != 0:
                self._device_cache_q8 = None  # rebuild with padding
                codes, scales, corpus_sq = self._device_corpus_q8(True)
            if tiled:
                return _search_dense_tiled_q8(queries, codes, scales, corpus_sq, k_eff,
                                              self.BLOCK)
            return _search_dense_q8(queries, codes, scales, corpus_sq, k_eff)
        corpus, corpus_sq = self._device_corpus(tiled)
        if not tiled and corpus.shape[0] != self.ntotal:
            tiled = True  # cache built padded for the tiled path; reuse it tiled
        if tiled and corpus.shape[0] % self.BLOCK != 0:
            self._device_cache = None  # rebuild with padding
            corpus, corpus_sq = self._device_corpus(True)
        if tiled:
            return _search_dense_tiled(queries, corpus, corpus_sq, k_eff, self.BLOCK)
        return _search_dense(queries, corpus, corpus_sq, k_eff)

    def search_device_queries(self, queries: torch.Tensor, k: int):
        """Device-to-device search: ``queries`` is an (nq, dim) tensor on
        the index's device (any float dtype; upcast in the search), and the
        (d2, idx) results stay there. Requires ``ntotal >= k``."""
        if self.ntotal < k:
            raise ValueError(f"index holds {self.ntotal} rows, fewer than k = {k}")
        return self._search_core(queries.to(self.device), k)

    def search(self, queries, k: int, upload_dtype: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``upload_dtype="float16"`` (or ``query_upload`` at construction)
        uploads the queries at half the bytes; the search upcasts on the
        device (~1e-3 relative noise on the distances)."""
        q = _upload_queries(queries, upload_dtype or self.query_upload, self.device)
        k_eff = min(k, self.ntotal)
        d2, idx = self._search_core(q, k_eff)
        return _pad_to_k(d2.cpu().numpy(), idx.cpu().numpy(), k)


# ---------------------------------------------------------------------------
# sharded Flat: the corpus row-sharded over a mesh's data axis
# ---------------------------------------------------------------------------


def _mesh_or_all(mesh: Optional[Mesh], device="cuda") -> Mesh:
    return mesh if mesh is not None else make_mesh(device=device)


def _merge_shards(parts, k: int, device: torch.device):
    """Per-shard ``(d2, global ids)``, each sorted by (distance, id), to
    the k best of all on ``device``: concatenated in shard order (a
    device-to-device copy each) and stably sorted by distance, so a tie
    goes to the lower global row."""
    cand_d = torch.cat([d.to(device) for d, _ in parts], dim=1)
    cand_i = torch.cat([i.to(device) for _, i in parts], dim=1)
    d, pos = torch.sort(cand_d, dim=1, stable=True)
    k = min(k, cand_d.shape[1])
    return d[:, :k].contiguous(), torch.gather(cand_i, 1, pos[:, :k])


class ShardedCorpus:
    """A corpus row-sharded over a mesh's data axis: shard s holds rows
    ``[s * per_shard, (s + 1) * per_shard)`` of the corpus (the last ones
    short; a shard past the end holds none) as a :class:`FlatIndex` on its
    device, which keeps the single-device layout and search (fp16 rows
    when exact, ``corpus_sq`` summed on the host, 32768-row tiles)."""

    def __init__(self, mesh: Mesh, shards: List[Optional[FlatIndex]], per_shard: int,
                 ntotal: int):
        self.mesh, self.shards, self.per_shard, self.ntotal = mesh, shards, per_shard, ntotal

    def search(self, queries: torch.Tensor, k: int):
        """Device queries -> the merged (d2, global ids) on the mesh's
        first device: each shard's k best (fewer where it holds fewer
        rows), then :func:`_merge_shards`."""
        parts = []
        for s, shard in enumerate(self.shards):
            if shard is None:
                continue
            d, i = shard._search_core(queries.to(shard.device), min(k, shard.ntotal))
            parts.append((d, i + s * self.per_shard))
        return _merge_shards(parts, k, self.mesh.first)


def shard_corpus(corpus: np.ndarray, mesh: Optional[Mesh] = None, corpus_quant: str = "none",
                 query_upload: str = "float32", device="cuda") -> ShardedCorpus:
    """Row-shard a host corpus over the mesh's data devices (every local
    device of ``device``'s type when ``mesh`` is None): ``ceil(n / shards)``
    rows a shard, each uploaded straight to its device. Reusable across
    searches. ``corpus_quant="int8"`` quantizes each shard's rows per row,
    as one device would (:func:`shard_corpus_q8`)."""
    mesh = _mesh_or_all(mesh, device)
    corpus = np.asarray(corpus, dtype=np.float32)
    devs = mesh.data_devices
    n, dim = corpus.shape
    per = -(-n // len(devs))
    shards = []
    for s, dev in enumerate(devs):
        rows = corpus[s * per:(s + 1) * per]
        if not len(rows):
            shards.append(None)
            continue
        shard = FlatIndex(dim, query_upload, corpus_quant, dev)
        shard.add(rows)
        shards.append(shard)
    return ShardedCorpus(mesh, shards, per, n)


def shard_corpus_q8(corpus: np.ndarray, mesh: Optional[Mesh] = None,
                    device="cuda") -> ShardedCorpus:
    """int8 tier of :func:`shard_corpus`: each shard's rows quantized per
    row (codes, scales, the dequantized rows' ``corpus_sq``), half fp16's
    memory a shard."""
    return shard_corpus(corpus, mesh, corpus_quant="int8", device=device)


def sharded_search(queries, corpus: Optional[np.ndarray], k: int, mesh: Optional[Mesh] = None,
                   prepared: Optional[ShardedCorpus] = None, query_upload: str = "float32",
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN with the corpus row-sharded over a mesh: each shard's
    tiled search on its device, the per-shard candidates merged on the
    first device (:class:`ShardedCorpus`); ``prepared`` (from
    :func:`shard_corpus`) reuses the device-resident shards. Returns host
    (d2, ids), ``min(k, n)`` columns."""
    if prepared is None:
        prepared = shard_corpus(corpus, mesh, query_upload=query_upload, device=device)
    q = _upload_queries(queries, query_upload, prepared.mesh.first)
    d2, idx = prepared.search(q, min(k, prepared.ntotal))
    return d2.cpu().numpy(), idx.cpu().numpy()


def sharded_search_q8(queries, n_total: int, k: int, prepared: ShardedCorpus,
                      query_upload: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sharded_search` over an int8 corpus (:func:`shard_corpus_q8`):
    each shard's bf16 GEMM search, merged as in the fp path."""
    if prepared.ntotal != n_total:
        raise ValueError(f"{n_total} rows asked for a corpus of {prepared.ntotal}")
    return sharded_search(queries, None, k, prepared=prepared, query_upload=query_upload)


class ShardedFlatIndex:
    """Flat index whose corpus is row-sharded over a mesh's data axis.

    The :class:`FlatIndex` ``search`` contract; for corpora past one
    card's memory (faiss's fp16-shard). Shards hold fp16 rows when every
    row is exact in fp16 (checked per shard, as ``FlatIndex.add`` does);
    ``corpus_quant="int8"`` composes row-sharding with int8 rows (~1e-3
    distance noise). :meth:`from_index` shards a live index, taking a
    corpus the fused pipeline installed on the device by device-to-device
    copies."""

    def __init__(self, corpus, mesh: Optional[Mesh] = None, query_upload: str = "float32",
                 corpus_quant: str = "none", device="cuda"):
        if corpus_quant not in ("none", "int8"):
            raise ValueError(f"corpus_quant must be 'none' or 'int8', got {corpus_quant!r}")
        self.query_upload = query_upload
        self.corpus_quant = corpus_quant
        if isinstance(corpus, ShardedCorpus):
            self._prepared = corpus
            self.dim = next(s.dim for s in corpus.shards if s is not None)
        else:
            corpus = np.asarray(corpus, dtype=np.float32)
            self.dim = corpus.shape[1]
            self._prepared = shard_corpus(corpus, mesh, corpus_quant, query_upload, device)
        self.mesh = self._prepared.mesh

    @classmethod
    def from_index(cls, index: FlatIndex, mesh: Optional[Mesh] = None,
                   corpus_quant: str = "none") -> "ShardedFlatIndex":
        """Shard a loaded or live :class:`FlatIndex`. A corpus already on
        the device (``set_device_corpus`` in the fused pipeline, or an
        earlier search's upload) is sliced there and each slice copied to
        its shard's device; otherwise the host rows are uploaded shard by
        shard."""
        mesh = _mesh_or_all(mesh, index.device)
        dev_corpus = index._device_cache
        if dev_corpus is None:
            return cls(index.corpus, mesh, index.query_upload, corpus_quant)
        rows, sq = dev_corpus
        n, devs = index.ntotal, mesh.data_devices
        per = -(-n // len(devs))
        shards = []
        for s, dev in enumerate(devs):
            lo, hi = s * per, min((s + 1) * per, n)
            if lo >= hi:
                shards.append(None)
                continue
            shard = FlatIndex(index.dim, index.query_upload, corpus_quant, dev)
            shard._install(rows[lo:hi].to(dev), sq[lo:hi].to(dev))
            shards.append(shard)
        return cls(ShardedCorpus(mesh, shards, per, n), query_upload=index.query_upload,
                   corpus_quant=corpus_quant)

    @property
    def ntotal(self) -> int:
        return self._prepared.ntotal

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = _upload_queries(queries, self.query_upload, self.mesh.first)
        d2, idx = self._prepared.search(q, min(k, self.ntotal))
        return _pad_to_k(d2.cpu().numpy(), idx.cpu().numpy(), k)

    def search_device_queries(self, queries: torch.Tensor, k: int):
        """Device queries (any device; copied to each shard's), results on
        the mesh's first device. Requires ``ntotal >= k``."""
        if self.ntotal < k:
            raise ValueError(f"index holds {self.ntotal} rows, fewer than k = {k}")
        return self._prepared.search(queries, k)


# ---------------------------------------------------------------------------
# IVF: k-means coarse quantizer + nprobe search (approximate, for the
# tens-of-millions regime where a dense product per query batch is wasteful)
# ---------------------------------------------------------------------------


def _assign_to_centroids(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """List of each row: the centroid of largest dot product, the first on
    a tie (``torch.argmax``, as ``jnp.argmax``)."""
    return torch.argmax(vectors @ centroids.T, dim=1)


def _kmeans_iter(data: torch.Tensor, centroids: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``n_iter`` Lloyd iterations on unit vectors (spherical k-means).

    The per-list sums are reproducible on the card: rows are sorted by
    list (stable) and each list summed in row order by
    ``torch.segment_reduce``, not scattered with atomics. An empty list
    keeps its centroid; centroids are renormalised with a 1e-12 floor."""
    nlist = centroids.shape[0]
    c = centroids
    for _ in range(n_iter):
        assign = _assign_to_centroids(data, c)
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=nlist)
        sums = torch.segment_reduce(data[order], "sum", lengths=counts, axis=0)
        counts = counts.to(torch.float32)[:, None]
        new_c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
        norms = torch.sqrt(torch.sum(new_c * new_c, dim=1, keepdim=True))
        c = new_c / torch.clamp(norms, min=1e-12)
    return c


def _ivf_probe_and_blocks(queries, centroids, row_list, nprobe: int, block: int):
    """Probe the nprobe nearest lists per query and mark which corpus
    blocks (of ``block`` rows, corpus sorted by list) hold candidates.
    Returns (probe mask (m, nlist), needed block ids, ascending)."""
    c_sims = queries @ centroids.T
    probe = torch.topk(c_sims, nprobe, dim=1).indices
    m, nlist = queries.shape[0], centroids.shape[0]
    probe_mask = torch.zeros((m, nlist), dtype=torch.bool, device=queries.device)
    probe_mask.scatter_(1, probe, True)
    mask_any = probe_mask.any(dim=0)
    rows_needed = (row_list >= 0) & mask_any[row_list.clamp(min=0)]
    block_needed = rows_needed.view(-1, block).any(dim=1)
    return probe_mask, torch.nonzero(block_needed).flatten()


def _ivf_gather_search(queries, probe_mask, blocks, vec_blocks, sq_blocks, list_blocks,
                       id_blocks, k: int):
    """Score the gathered corpus blocks densely; candidates of unprobed
    lists (and padding) are +inf, and an +inf result gets id -1."""
    cand_v = vec_blocks[blocks].reshape(-1, vec_blocks.shape[-1]).float()
    cand_sq = sq_blocks[blocks].reshape(-1)
    cand_list = list_blocks[blocks].reshape(-1)
    cand_id = id_blocks[blocks].reshape(-1)
    d2 = (_row_sq(queries) + cand_sq[None, :]).addmm_(queries, cand_v.T, alpha=-2.0)
    probed = (cand_list[None, :] >= 0) & probe_mask[:, cand_list.clamp(min=0)]
    d2 = torch.where(probed, d2, torch.full_like(d2, float("inf")))
    d, pos = _smallest_k(d2, k)
    ids = cand_id[pos].to(torch.int64)
    return d, torch.where(torch.isinf(d), torch.full_like(ids, -1), ids)


class IVFIndex:
    """Inverted-file index: k-means centroids + per-list storage.

    Training (Lloyd iterations) and search (centroid product -> probe
    lists -> exact top-k within the probed subset) run on ``device``.
    Query batches of at least ``DEVICE_MIN_QUERIES`` take the device path:
    the corpus lives on the device sorted by list, probed lists map to
    contiguous blocks, and only the needed blocks are gathered into one
    dense product + top-k per chunk. Smaller batches take the host path
    (numpy), as in JAX."""

    # device path constants: corpus block rows, query chunk rows
    BLOCK = 512
    QUERY_CHUNK = 512
    # dispatch: use the device path for query batches at least this large
    DEVICE_MIN_QUERIES = 256

    def __init__(self, dim: int = 1024, nlist: int = 1024, nprobe: int = 128,
                 query_upload: str = "float32", device="cuda"):
        self.dim = dim
        self.nlist = nlist
        self.nprobe = nprobe
        self.query_upload = query_upload
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self._vectors = np.zeros((0, dim), dtype=np.float32)
        self._assignments = np.zeros((0,), dtype=np.int64)
        self._device_state = None
        self._fp16_exact = True

    @property
    def ntotal(self) -> int:
        return self._vectors.shape[0]

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return _as_tensor(a, self.device)

    def train(self, sample: np.ndarray, n_iter: int = 10, seed: int = 42) -> None:
        sample = np.asarray(sample, dtype=np.float32)
        rng = np.random.default_rng(seed)
        nlist = min(self.nlist, sample.shape[0])
        init = sample[rng.choice(sample.shape[0], size=nlist, replace=False)]
        self.centroids = _kmeans_iter(self._to_device(sample), self._to_device(init),
                                      n_iter).cpu().numpy()
        self.nlist = nlist

    def add(self, vectors: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("train the index before adding vectors")
        vectors = np.asarray(vectors, dtype=np.float32)
        self._fp16_exact = self._fp16_exact and _exact_in_fp16(vectors)
        # assign on the device; only the (n,) list ids come back
        assign = _assign_to_centroids(self._to_device(vectors),
                                      self._to_device(self.centroids)).cpu().numpy()
        self._vectors = np.concatenate([self._vectors, vectors])
        self._assignments = np.concatenate([self._assignments, assign])
        self._device_state = None

    def set_lists(self, vectors: np.ndarray, assignments: np.ndarray) -> None:
        """Install a populated corpus and its list ids, as an index file
        holds them. Whether the rows are exact in fp16 is checked here, as
        in :meth:`add`: the JAX package's readers leave its flag at True,
        so its device route then searches an fp16-rounded copy of an fp32
        corpus (~1e-5 relative distance error, no longer exact)."""
        self._vectors = np.asarray(vectors, dtype=np.float32)
        self._assignments = np.asarray(assignments, dtype=np.int64)
        self._fp16_exact = _exact_in_fp16(self._vectors)
        self._device_state = None

    def _build_device_state(self):
        """Sort the corpus by list, pad to whole blocks (+1 all-padding
        block), and upload everything once; reused across searches."""
        order = np.argsort(self._assignments, kind="stable")
        n = self._vectors.shape[0]
        bs = self.BLOCK
        n_pad = ((n + bs - 1) // bs + 1) * bs  # +1 trailing pad block
        # fp16 device copy when lossless (upcast exactly in the search)
        dt = np.float16 if self._fp16_exact else np.float32
        vec = np.zeros((n_pad, self.dim), dt)
        vec[:n] = self._vectors[order].astype(dt)
        sq = np.full((n_pad,), np.inf, np.float32)
        sq[:n] = np.sum(self._vectors[order] * self._vectors[order], axis=1)
        row_list = np.full((n_pad,), -1, np.int64)
        row_list[:n] = self._assignments[order]
        ids = np.full((n_pad,), -1, np.int64)
        ids[:n] = order
        nb = n_pad // bs
        self._device_state = dict(
            vec_blocks=self._to_device(vec.reshape(nb, bs, self.dim)),
            sq_blocks=self._to_device(sq.reshape(nb, bs)),
            list_blocks=self._to_device(row_list.reshape(nb, bs)),
            id_blocks=self._to_device(ids.reshape(nb, bs)),
            row_list=self._to_device(row_list),
            centroids=self._to_device(self.centroids.astype(np.float32)),
            n_blocks=nb,
        )
        return self._device_state

    def search_device(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Device IVF search for large query batches.

        Per chunk of ``QUERY_CHUNK`` queries (the last zero-padded): probe
        lists on the device, read the needed blocks' ids back (the one
        host read per chunk), pad their count to a power of two with the
        trailing all-padding block, and run one dense product + masked
        top-k over them. Tensor queries are sliced on their device."""
        st = self._device_state or self._build_device_state()
        chunk = self.QUERY_CHUNK
        if isinstance(queries, torch.Tensor):
            qall = queries.to(self.device, torch.float32)
        else:
            qall = _upload_queries(queries, self.query_upload, self.device).float()
        nq = qall.shape[0]
        if nq % chunk:
            qall = torch.nn.functional.pad(qall, (0, 0, 0, chunk - nq % chunk))
        nprobe = min(self.nprobe, self.nlist)
        nb = st["n_blocks"]
        d_out = np.full((nq, k), np.inf, dtype=np.float32)
        i_out = np.full((nq, k), -1, dtype=np.int64)
        pad_block = torch.tensor([nb - 1], device=self.device)
        for q0 in range(0, nq, chunk):
            m = min(chunk, nq - q0)
            qj = qall[q0:q0 + chunk]
            probe_mask, blocks = _ivf_probe_and_blocks(qj, st["centroids"], st["row_list"],
                                                       nprobe, self.BLOCK)
            count = blocks.numel()
            g = max(count, 1)
            g = min(1 << (g - 1).bit_length(), nb)
            blocks = torch.cat([blocks, pad_block.expand(g - count)])
            kk = min(k, g * self.BLOCK)
            d2, ids = _ivf_gather_search(qj, probe_mask, blocks, st["vec_blocks"],
                                         st["sq_blocks"], st["list_blocks"], st["id_blocks"],
                                         kk)
            d_out[q0:q0 + m, :kk] = d2[:m].cpu().numpy()
            i_out[q0:q0 + m, :kk] = ids[:m].cpu().numpy()
        return d_out, i_out

    def search_device_queries(self, queries: torch.Tensor, k: int):
        """(nq, dim) tensor queries on the index's device, no host staging;
        the (nq, k) results come back to the host, as in JAX."""
        if self.ntotal < k:
            raise ValueError(f"index holds {self.ntotal} rows, fewer than k = {k}")
        return self.search_device(queries, k)

    def search(self, queries, k: int, use_device: Optional[bool] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe the nprobe nearest lists per query; exact distances within
        the probed subset. Batches of ``DEVICE_MIN_QUERIES`` or more run on
        the device (:meth:`search_device`); smaller ones on the host, in
        bounded-memory chunks, after the centroid product on the device."""
        queries = np.asarray(queries, dtype=np.float32)
        if use_device is None:
            use_device = queries.shape[0] >= self.DEVICE_MIN_QUERIES
        if use_device and self.ntotal:
            return self.search_device(queries, k)
        nq = queries.shape[0]
        nprobe = min(self.nprobe, self.nlist)
        c_sims = (self._to_device(queries) @ self._to_device(self.centroids).T).cpu().numpy()
        probe = np.argsort(-c_sims, axis=1)[:, :nprobe]  # (nq, nprobe)

        order = np.argsort(self._assignments, kind="stable")
        sorted_assign = self._assignments[order]
        starts = np.searchsorted(sorted_assign, np.arange(self.nlist))
        counts = np.searchsorted(sorted_assign, np.arange(self.nlist), side="right") - starts
        corpus_sq = np.sum(self._vectors * self._vectors, axis=1)
        q_sq = np.sum(queries * queries, axis=1)

        d_out = np.full((nq, k), np.inf, dtype=np.float32)
        i_out = np.full((nq, k), -1, dtype=np.int64)

        # chunk queries so the candidate row block stays bounded
        mean_cand = max(int(counts[probe].mean() * nprobe), 1) if nq else 1
        q_chunk = max(1, int(2_000_000 / mean_cand))
        for q0 in range(0, nq, q_chunk):
            qs = slice(q0, min(q0 + q_chunk, nq))
            p = probe[qs]  # (m, nprobe)
            cnt = counts[p]  # candidates per (query, list)
            tot = cnt.sum(axis=1)  # per query
            if tot.sum() == 0:
                continue
            # flat candidate ids: for each (query, list), the run
            # order[starts[l] : starts[l]+counts[l]]
            reps = cnt.ravel()
            base = np.repeat(starts[p].ravel(), reps)
            within = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
            cand = order[base + within]  # global row ids, flat
            q_of = np.repeat(np.arange(p.shape[0]), tot)

            dots = np.einsum("nd,nd->n", self._vectors[cand], queries[qs][q_of])
            d2 = q_sq[qs][q_of] + corpus_sq[cand] - 2.0 * dots

            # per-query top-k via lexsort on (query, distance)
            sel = np.lexsort((d2, q_of))
            q_sorted = q_of[sel]
            rank = np.arange(len(sel)) - np.searchsorted(q_sorted, q_sorted)
            keep = rank < k
            rows = q_sorted[keep] + q0
            cols = rank[keep]
            d_out[rows, cols] = d2[sel][keep]
            i_out[rows, cols] = cand[sel][keep]
        return d_out, i_out


# ---------------------------------------------------------------------------
# sharded IVF: the list-sorted corpus blocks spread row-wise over the mesh
# (the reference's fp16-shard spreads whatever index was loaded, IVF too)
# ---------------------------------------------------------------------------


class ShardedIVFIndex:
    """IVF index whose list-sorted corpus blocks are sharded over a mesh's
    data axis.

    The probe semantics of :class:`IVFIndex` (the same result sets): each
    shard holds a contiguous run of the list-sorted blocks, plus one
    all-padding block, and per query chunk probes the lists with its copy
    of the centroids, gathers its own needed blocks (padded to a power of
    two with its padding block) and scores them; the per-shard candidates
    merge on the first device (:func:`_merge_shards`).

    Snapshot semantics, as in JAX: the wrapped index's vectors,
    assignments and nprobe are copied at construction, and a search over
    a wrapped index that has since grown or changed its nprobe raises."""

    BLOCK = IVFIndex.BLOCK
    QUERY_CHUNK = IVFIndex.QUERY_CHUNK

    def __init__(self, ivf: IVFIndex, mesh: Optional[Mesh] = None,
                 query_upload: Optional[str] = None):
        if not ivf.is_trained or ivf.ntotal == 0:
            raise ValueError("shard a trained, populated IVFIndex")
        self.mesh = _mesh_or_all(mesh, ivf.device)
        self.dim = ivf.dim
        self.nlist = ivf.nlist
        self.nprobe = ivf.nprobe
        self.query_upload = query_upload or ivf.query_upload
        self._ntotal = ivf.ntotal
        self._source = ivf
        self._source_nprobe = ivf.nprobe

        devs = self.mesh.data_devices
        bs = self.BLOCK
        n = ivf.ntotal
        order = np.argsort(ivf._assignments, kind="stable")
        nb = -(-max(-(-n // bs), 1) // len(devs)) * len(devs)  # blocks, mesh-divisible
        nb_shard = nb // len(devs)
        n_pad = nb * bs
        dt = np.float16 if ivf._fp16_exact else np.float32
        vec = np.zeros((n_pad, self.dim), dt)
        vec[:n] = ivf._vectors[order].astype(dt)
        sq = np.full((n_pad,), np.inf, np.float32)
        sq[:n] = np.sum(ivf._vectors[order] * ivf._vectors[order], axis=1)
        row_list = np.full((n_pad,), -1, np.int64)
        row_list[:n] = ivf._assignments[order]
        ids = np.full((n_pad,), -1, np.int64)
        ids[:n] = order
        centroids = np.asarray(ivf.centroids, np.float32)

        def blocks(a, s, fill):
            # the shard's blocks and one all-padding block after them
            part = a.reshape((nb, bs) + a.shape[1:])[s * nb_shard:(s + 1) * nb_shard]
            return np.concatenate([part, np.full((1,) + part.shape[1:], fill, a.dtype)])

        self._shards = []
        for s, dev in enumerate(devs):
            listb = blocks(row_list, s, -1)
            self._shards.append(dict(
                device=dev,
                vec_blocks=_as_tensor(blocks(vec, s, 0), dev),
                sq_blocks=_as_tensor(blocks(sq, s, np.inf), dev),
                list_blocks=_as_tensor(listb, dev),
                id_blocks=_as_tensor(blocks(ids, s, -1), dev),
                row_list=_as_tensor(listb.reshape(-1), dev),
                centroids=_as_tensor(centroids, dev),
                n_blocks=nb_shard + 1,
            ))

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def _check_fresh(self) -> None:
        """Refuse to search a stale snapshot (raises, not asserts: the
        guard must survive ``python -O``)."""
        if self._source.ntotal != self._ntotal:
            raise RuntimeError(
                f"wrapped IVFIndex grew after sharding ({self._source.ntotal}"
                f" vs {self._ntotal} rows); rebuild the ShardedIVFIndex")
        if self._source.nprobe != self._source_nprobe:
            raise RuntimeError(
                f"wrapped IVFIndex nprobe changed after sharding "
                f"({self._source.nprobe} vs {self._source_nprobe}); rebuild the ShardedIVFIndex")

    def _search_chunk(self, qj: torch.Tensor, k: int):
        """One query chunk: each shard's probe, gather and product on its
        device, then the merge on the first device."""
        nprobe = min(self.nprobe, self.nlist)
        parts = []
        for st in self._shards:
            q = qj.to(st["device"])
            probe_mask, blocks = _ivf_probe_and_blocks(q, st["centroids"], st["row_list"],
                                                       nprobe, self.BLOCK)
            count, nb = blocks.numel(), st["n_blocks"]
            g = min(1 << (max(count, 1) - 1).bit_length(), nb)
            pad_block = torch.tensor([nb - 1], device=q.device)
            blocks = torch.cat([blocks, pad_block.expand(g - count)])
            parts.append(_ivf_gather_search(q, probe_mask, blocks, st["vec_blocks"],
                                            st["sq_blocks"], st["list_blocks"], st["id_blocks"],
                                            min(k, g * self.BLOCK)))
        return _merge_shards(parts, k, self.mesh.first)

    def _run_chunks(self, qall: torch.Tensor, nq: int, k: int):
        self._check_fresh()
        chunk = self.QUERY_CHUNK
        if qall.shape[0] % chunk:
            qall = torch.nn.functional.pad(qall, (0, 0, 0, chunk - qall.shape[0] % chunk))
        d_out = np.full((nq, k), np.inf, dtype=np.float32)
        i_out = np.full((nq, k), -1, dtype=np.int64)
        for q0 in range(0, nq, chunk):
            m = min(chunk, nq - q0)
            d2, ids = self._search_chunk(qall[q0:q0 + chunk], k)
            cols = d2.shape[1]
            d_out[q0:q0 + m, :cols] = d2[:m].cpu().numpy()
            i_out[q0:q0 + m, :cols] = ids[:m].cpu().numpy()
        return d_out, i_out

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        q = _upload_queries(queries, self.query_upload, self.mesh.first).float()
        return self._run_chunks(q, queries.shape[0], k)

    def search_device_queries(self, queries: torch.Tensor, k: int):
        """Device queries, sliced into chunks where they are; the (nq, k)
        results come back to the host, as :class:`IVFIndex`'s do."""
        if self.ntotal < k:
            raise ValueError(f"index holds {self.ntotal} rows, fewer than k = {k}")
        return self._run_chunks(queries.to(self.mesh.first, torch.float32), queries.shape[0], k)
