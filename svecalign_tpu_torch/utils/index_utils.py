"""Index file IO and type selection.

Port of the JAX package's ``utils/index_utils.py``, host only: the files
are byte-identical to the JAX writer's for the same index state, and each
package reads the other's. Flat indexes are stored in the faiss ``IndexFlatL2`` binary format
(fourcc ``IxF2``) and IVF indexes in the faiss ``IndexIVFFlat`` format
(fourcc ``IwFl``: ivf header + nested IxF2 quantizer + direct map +
``ilar`` ArrayInvertedLists) for byte-level interop: our stages can load
indexes written by the reference's faiss pipeline and vice versa at both
the Flat and the mining-scale IVF tiers. (Replaces stopes train_index /
load_index — reference svecalign/utils/mining_utils.py:14-42,
score_align.py:192-217, prep_index.py:188-258.) A legacy native .npz IVF
container from round 1 is still readable.
"""

import struct
from pathlib import Path
from typing import Union

import numpy as np

from svecalign_tpu_torch.ops.topk import FlatIndex, IVFIndex
from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)

_FLAT_MAGIC = b"IxF2"
_IVF_MAGIC = "svecalign_ivf"


def _check(ok: bool, msg) -> None:
    """Validate file contents (a check that ``python -O`` keeps)."""
    if not ok:
        raise ValueError(msg)


def determine_index_type(n_embeddings: int) -> str:
    """Pick an index type by corpus size (role of stopes
    determine_faiss_index_type, reference prep_index.py:246).

    The thresholds are the JAX package's: they decide which index, and so
    which results, a corpus gets, so they are not retuned for the card."""
    if n_embeddings < 4_000_000:
        return "Flat"
    if n_embeddings < 20_000_000:
        return "IVF16384"
    return "IVF131072"


def write_flat_index(vectors: np.ndarray, path: Union[str, Path]) -> None:
    """Write vectors as a faiss-compatible IndexFlatL2 file."""
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    ntotal, d = vectors.shape
    with open(path, "wb") as fp:
        fp.write(_FLAT_MAGIC)
        fp.write(struct.pack("<i", d))
        fp.write(struct.pack("<q", ntotal))
        fp.write(struct.pack("<qq", 1 << 20, 1 << 20))  # legacy fields
        fp.write(struct.pack("<B", 1))  # is_trained
        fp.write(struct.pack("<i", 1))  # METRIC_L2
        fp.write(struct.pack("<Q", ntotal * d))
        fp.write(vectors.tobytes())


def read_flat_index(path: Union[str, Path]) -> np.ndarray:
    """Read a faiss IndexFlatL2 file into an (ntotal, d) float32 matrix."""
    with open(path, "rb") as fp:
        magic = fp.read(4)
        if magic != _FLAT_MAGIC:
            raise ValueError(f"{path}: not a Flat (IxF2) index (got {magic!r})")
        d, = struct.unpack("<i", fp.read(4))
        ntotal, = struct.unpack("<q", fp.read(8))
        fp.read(16)  # legacy
        fp.read(1)  # is_trained
        metric, = struct.unpack("<i", fp.read(4))
        _check(metric == 1, f"only METRIC_L2 supported, got {metric}")
        n, = struct.unpack("<Q", fp.read(8))
        _check(n == ntotal * d, f"{path}: {n} floats for {ntotal} x {d}")
        data = np.frombuffer(fp.read(n * 4), dtype=np.float32)
    return data.reshape(ntotal, d)


def _write_index_header(fp, d: int, ntotal: int, metric: int = 1) -> None:
    fp.write(struct.pack("<i", d))
    fp.write(struct.pack("<q", ntotal))
    fp.write(struct.pack("<qq", 1 << 20, 1 << 20))  # legacy fields
    fp.write(struct.pack("<B", 1))  # is_trained
    fp.write(struct.pack("<i", metric))  # 1 = METRIC_L2


def write_ivf_index(index: IVFIndex, path: Union[str, Path]) -> None:
    """Write a faiss-compatible IndexIVFFlat (``IwFl``) file.

    Layout per faiss impl/index_write.cpp (1.7.x): fourcc, index header,
    nlist/nprobe (uint64), nested IndexFlatL2 quantizer holding the
    centroids, direct map (NoMap), then ArrayInvertedLists (``ilar``):
    nlist, code_size, 'full' size table, and per non-empty list the raw
    fp32 codes followed by the int64 ids. Our ids are insertion order
    (faiss sequential ``add``).
    """
    cent = np.ascontiguousarray(index.centroids, dtype=np.float32)
    nlist, d = cent.shape
    vecs = np.ascontiguousarray(index._vectors, dtype=np.float32)
    assign = np.asarray(index._assignments, dtype=np.int64)
    n = vecs.shape[0]
    with open(path, "wb") as fp:
        fp.write(b"IwFl")
        _write_index_header(fp, d, n)
        fp.write(struct.pack("<QQ", nlist, index.nprobe))
        # quantizer: IndexFlatL2 over the centroids
        fp.write(_FLAT_MAGIC)
        _write_index_header(fp, d, nlist)
        fp.write(struct.pack("<Q", nlist * d))
        fp.write(cent.tobytes())
        # direct map: type NoMap, empty id array
        fp.write(struct.pack("<B", 0))
        fp.write(struct.pack("<Q", 0))
        # inverted lists
        fp.write(b"ilar")
        fp.write(struct.pack("<QQ", nlist, d * 4))
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=nlist).astype(np.uint64)
        fp.write(b"full")
        fp.write(struct.pack("<Q", nlist))
        fp.write(sizes.tobytes())
        vecs_sorted = vecs[order]
        ids_sorted = order.astype(np.int64)
        off = 0
        for i in range(nlist):
            c = int(sizes[i])
            if c:
                fp.write(vecs_sorted[off : off + c].tobytes())
                fp.write(ids_sorted[off : off + c].tobytes())
                off += c


def read_ivf_index(path: Union[str, Path], nprobe: int = 128, device="cuda") -> IVFIndex:
    """Read a faiss IndexIVFFlat (``IwFl``) file, including ones written
    by faiss itself (both 'full' and 'sprs' inverted-list size tables)."""
    with open(path, "rb") as fp:
        buf = fp.read()
    off = 0

    def take(n):
        nonlocal off
        out = buf[off : off + n]
        off += n
        return out

    def u(fmt):
        size = struct.calcsize(fmt)
        return struct.unpack("<" + fmt, take(size))

    _check(take(4) == b"IwFl", f"{path}: not an IndexIVFFlat (IwFl) file")
    d, = u("i")
    ntotal, = u("q")
    take(16)  # legacy
    take(1)  # is_trained
    metric, = u("i")
    _check(metric == 1, f"only METRIC_L2 supported, got {metric}")
    nlist, file_nprobe = u("QQ")

    # nested quantizer (IndexFlatL2)
    _check(take(4) == _FLAT_MAGIC, "quantizer is not IndexFlatL2")
    qd, = u("i")
    qn, = u("q")
    take(16)
    take(1)
    u("i")
    nfloats, = u("Q")
    _check(qd == d and qn == nlist and nfloats == nlist * d,
           f"{path}: quantizer {qn} x {qd} does not match {nlist} x {d}")
    centroids = np.frombuffer(take(nlist * d * 4), dtype=np.float32).reshape(
        nlist, d
    ).copy()

    # direct map
    dm_type, = u("B")
    dm_count, = u("Q")
    take(dm_count * 8)
    if dm_type == 2:  # Hashtable map: count + (key, value) pairs
        n_hash, = u("Q")
        take(n_hash * 16)

    # inverted lists
    _check(take(4) == b"ilar", "only ArrayInvertedLists supported")
    il_nlist, code_size = u("QQ")
    _check(il_nlist == nlist and code_size == d * 4,
           f"{path}: lists {il_nlist}, code size {code_size}")
    list_type = take(4)
    count, = u("Q")
    table = np.frombuffer(take(count * 8), dtype=np.uint64)
    sizes = np.zeros(nlist, dtype=np.int64)
    if list_type == b"full":
        sizes[:] = table.astype(np.int64)
    elif list_type == b"sprs":
        sizes[table[0::2].astype(np.int64)] = table[1::2].astype(np.int64)
    else:
        raise ValueError(f"unknown inverted-list size table {list_type!r}")

    vectors = np.zeros((ntotal, d), dtype=np.float32)
    assignments = np.zeros(ntotal, dtype=np.int64)
    seen = np.zeros(ntotal, dtype=bool)
    for i in range(nlist):
        c = int(sizes[i])
        if not c:
            continue
        codes = np.frombuffer(take(c * d * 4), dtype=np.float32).reshape(c, d)
        ids = np.frombuffer(take(c * 8), dtype=np.int64)
        if np.any(ids < 0) or np.any(ids >= ntotal):
            raise ValueError(f"{path}: non-sequential faiss ids unsupported")
        vectors[ids] = codes
        assignments[ids] = i
        seen[ids] = True
    _check(seen.all() or ntotal == 0, "duplicate/missing ids in inverted lists")

    idx = IVFIndex(dim=d, nlist=int(nlist), nprobe=nprobe or int(file_nprobe), device=device)
    idx.centroids = centroids
    idx.set_lists(vectors, assignments)
    return idx


def load_index(
    path: Union[str, Path], index_type: str = "Flat", nprobe: int = 128, device="cuda"
) -> Union[FlatIndex, IVFIndex]:
    """Load a populated index file onto ``device``, auto-detecting the
    container. In a fused pipeline run the live index that prep_index just
    built (its corpus possibly gathered on the card) is returned instead
    of reading the file again (``utils/embed_cache.py``'s registry)."""
    registered = embed_cache.get_index(path)
    if registered is not None:
        if hasattr(registered, "nprobe"):
            registered.nprobe = nprobe
        return registered
    path = str(path)
    with open(path, "rb") as fp:
        head = fp.read(4)
    if head == _FLAT_MAGIC:
        vectors = read_flat_index(path)
        idx = FlatIndex(dim=vectors.shape[1], device=device)
        if vectors.shape[0]:
            idx.add(vectors)
        return idx
    if head == b"IwFl":
        return read_ivf_index(path, nprobe=nprobe, device=device)
    # legacy round-1 npz container (IVF)
    data = np.load(path, allow_pickle=False)
    if str(data["magic"]) != _IVF_MAGIC:
        raise ValueError(f"{path}: not a Flat, IVF or legacy IVF index")
    idx = IVFIndex(
        dim=data["centroids"].shape[1],
        nlist=data["centroids"].shape[0],
        nprobe=nprobe,
        device=device,
    )
    idx.centroids = data["centroids"]
    idx.set_lists(data["vectors"], data["assignments"])
    return idx
