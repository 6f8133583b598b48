"""Host-level sharding and multiprocessing.

Copied from the JAX package's ``utils/mp_utils.py`` (reference
svecalign/utils/mp_utils.py:7-66): ``--rank/--n_shard`` slices the sorted
input file list contiguously; ``--n_proc`` starts worker processes over
contiguous data slices with no IPC.

The JAX version forks. A forked child cannot use CUDA, and fork is unsafe
in a process that already runs torch's threads, so the port's workers
always start with the ``spawn`` method: they import the worker function
by its module path and get their arguments pickled.
"""

import multiprocessing
from typing import Callable, List, Tuple

from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)


def get_shard_range(tot: int, nshard: int, rank: int) -> Tuple[int, int]:
    """Contiguous, rounded split of ``tot`` items into ``nshard`` shards."""
    if not 0 <= rank < nshard:
        raise ValueError(f"invalid rank/nshard {rank}/{nshard}")
    start = round(tot / nshard * rank)
    end = round(tot / nshard * (rank + 1))
    if start >= end:
        raise ValueError(f"empty shard: start={start}, end={end}")
    logger.info(
        f"rank {rank} of {nshard}, process {end - start} ({start}-{end}) out of {tot}"
    )
    return start, end


def start_multi_processes(data: List, n_proc: int, func: Callable, *args, **kwargs) -> None:
    """Run ``func(pid, data_slice, *args, **kwargs)`` on ``n_proc``
    contiguous slices of ``data``, in ``spawn``-started workers; with one
    process (or one item) in this process. ``func`` must be a module-level
    function and its arguments picklable. Raises if a worker fails."""
    if n_proc <= 0:
        raise ValueError(f"{n_proc} should be larger than 0.")

    n_proc = min(n_proc, len(data)) or 1
    if n_proc == 1:
        logger.info("Single process")
        func(0, data, *args, **kwargs)
        return

    ctx = multiprocessing.get_context("spawn")
    procs = []
    for pid in range(n_proc):
        start, end = get_shard_range(len(data), nshard=n_proc, rank=pid)
        procs.append(ctx.Process(target=func, args=(pid, data[start:end], *args), kwargs=kwargs))
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    failed = [pid for pid, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"worker processes {failed} of {n_proc} failed "
                           f"(exit codes {[procs[i].exitcode for i in failed]})")
