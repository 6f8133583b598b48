"""Device-resident embedding handoff for the fused pipeline mode.

Port of the JAX package's ``utils/embed_cache.py``. The stages' only IPC
is the filesystem: the embed stage (5.3) writes ``.embed`` files that the
align stage (5.4) reads back and uploads again. When both run in one
process (``python -m svecalign_tpu_torch.pipeline --fused``) the rows were
just computed on the card, so this module keeps each document's fp16 rows
there between the stages, keyed by the final ``.embed`` path. The files
are still written (resume, inspection, stage 6.5's reuse and the CLI
contract keep working); the cache only short-circuits the read and the
upload of stage 5.4, stage 6.6's Flat corpus and stage 6.7's queries.

The rules are the JAX module's, so that a port run's ``stats`` equal the
JAX run's on the same inputs: every entry is a ``(max_rows, dim)`` fp16
tensor whose first ``n_rows`` rows are the document's; a document with
more than ``max_rows`` rows is not cached (the encoders return no buffer
for it); ``put`` rejects an entry once ``max_bytes`` are referenced. In
JAX the one global row count was an XLA compile rule (one shape, one
program); here it keeps the storage uniform, so that
:func:`gather_rows_device` gathers from one stack with one index upload.

The state is process-global, as in JAX; :func:`enable`, :func:`disable`
and :func:`clear` set it.
"""

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)

enabled: bool = False
max_rows: int = 4096
max_bytes: int = 4 << 30

_cache: Dict[str, Tuple[int, torch.Tensor]] = {}
_bytes: int = 0
# (path -> (slot, n_rows), (n_files, max_rows, dim) device stack); built
# lazily by gather_rows_device, dropped on put and clear. The stack
# duplicates the cached bytes on the device (both are bounded by max_bytes).
_stack = None
# live index objects handed from prep_index to score_align in a fused run
# (the .populate.idx file is still written; this skips the re-read and upload)
_index_registry: Dict[str, object] = {}
stats = {"put": 0, "rejected": 0, "hit": 0, "miss": 0, "gather": 0,
         "gather_miss": 0}


def _key(path) -> str:
    return os.path.abspath(str(path))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def enable(rows: int = 4096, byte_cap: int = 4 << 30) -> None:
    """Turn the fused handoff on for this process."""
    global enabled, max_rows, max_bytes
    enabled = True
    max_rows = rows
    max_bytes = byte_cap


def disable() -> None:
    global enabled
    enabled = False
    clear()


def clear() -> None:
    """Drop every cached device buffer and registered index (the memory is
    freed once no caller holds them)."""
    global _bytes, _stack
    _cache.clear()
    _index_registry.clear()
    _bytes = 0
    _stack = None


def put(path, n_rows: int, device_rows: Optional[torch.Tensor]) -> None:
    """Cache ``device_rows``, a (max_rows, dim) fp16 tensor whose first
    ``n_rows`` rows are the document's embeddings, under the final
    ``.embed`` path."""
    global _bytes, _stack
    if not enabled or device_rows is None:
        return
    key = _key(path)
    nbytes = _nbytes(device_rows)
    # a re-put of the same path (an in-process re-run) replaces the entry,
    # so its bytes leave the budget first
    old = _cache.get(key)
    old_bytes = _nbytes(old[1]) if old is not None else 0
    if _bytes - old_bytes + nbytes > max_bytes:
        if stats["rejected"] == 0:
            logger.warning(
                f"embed_cache: device cap {max_bytes >> 20} MiB reached; "
                "further documents fall back to the file+upload path"
            )
        stats["rejected"] += 1
        return
    _cache[key] = (n_rows, device_rows)
    _bytes += nbytes - old_bytes
    _stack = None
    stats["put"] += 1


def get(path) -> Optional[Tuple[int, torch.Tensor]]:
    """(n_rows, (max_rows, dim) fp16 device tensor) for a cached path."""
    if not enabled:
        return None
    entry = _cache.get(_key(path))
    stats["hit" if entry is not None else "miss"] += 1
    return entry


def _ensure_stack():
    """(path -> (slot, n_rows), (n_files, max_rows, dim) fp16 stack) or
    None: one stack of every cached document, built once and reused by
    every gather until the cache changes. None when the cache is empty or
    the entries disagree on shape, dtype or device (two encoders in one
    run)."""
    global _stack
    if _stack is not None:
        return _stack
    if not _cache:
        return None
    paths = sorted(_cache)
    tensors = [_cache[p][1] for p in paths]
    first = tensors[0]
    if any((t.shape, t.dtype, t.device) != (first.shape, first.dtype, first.device)
           for t in tensors):
        logger.warning("embed_cache: mixed entry shapes; device gather off")
        return None
    slots = {p: (i, _cache[p][0]) for i, p in enumerate(paths)}
    _stack = (slots, torch.stack(tensors))
    return _stack


def gather_rows_device(entries: Sequence[Tuple[object, int]], pad_multiple: int = 1024):
    """Assemble embedding rows on the device from the cached documents.

    ``entries`` is an ordered [(embed_path, row_id), ...], the content of
    an embed-pointer tsv. Returns ``(rows, n)``: ``rows`` an (n_padded,
    dim) fp16 tensor whose first ``n`` rows are the requested embeddings,
    ``n_padded`` = ``n`` rounded up to ``pad_multiple``, padding rows
    zero. One int64 index tensor is uploaded. Returns None when any
    document is not cached, or a row id is at or past the document's real
    row count (a stale pointer tsv must reach the file path, which
    raises, rather than gather a zero padding row)."""
    if not enabled or not entries:
        return None
    stack = _ensure_stack()
    if stack is None:
        stats["gather_miss"] += 1
        return None
    slot_of, dev_stack = stack
    rows_per, dim = dev_stack.shape[1], dev_stack.shape[2]
    flat = []
    for path, row_id in entries:
        slot = slot_of.get(_key(path))
        if slot is None or not 0 <= row_id < slot[1]:
            stats["gather_miss"] += 1
            return None
        flat.append(slot[0] * rows_per + row_id)
    n = len(flat)
    n_pad = -(-n // pad_multiple) * pad_multiple
    idx = np.zeros((n_pad,), dtype=np.int64)  # padding reads row 0, zeroed below
    idx[:n] = flat
    rows = dev_stack.view(-1, dim).index_select(0, torch.from_numpy(idx).to(dev_stack.device))
    rows[n:] = 0
    stats["gather"] += 1
    return rows, n


def register_index(path, index) -> None:
    """Hand a live index on the device from prep_index to score_align in
    one process (the ``.populate.idx`` file stays the durable copy)."""
    if enabled:
        _index_registry[_key(path)] = index


def get_index(path):
    return _index_registry.get(_key(path)) if enabled else None


def put_from_file(path, device="cuda") -> None:
    """Load a written stopes (``.npy``) ``.embed`` file and cache it as
    the embed stage's handoff would have: fp16 rows zero-padded to
    (max_rows, dim) on ``device``, keyed by the path. For tools that fill
    the handoff without running the embed stage; call :func:`enable`
    first. SONAR's headerless raw files are not read here."""
    from svecalign_tpu_torch.utils.torch_setup import resolve_device

    rows = np.load(path).astype(np.float16)
    padded = torch.zeros((max_rows, rows.shape[1]), dtype=torch.float16,
                         device=resolve_device(device))
    padded[: rows.shape[0]] = torch.from_numpy(rows)
    put(path, rows.shape[0], padded)
