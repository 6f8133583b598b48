"""Host-level sharding of a stage's input list.

Copied from the JAX package's ``utils/mp_utils.py`` (reference
svecalign/utils/mp_utils.py:7-66): ``--rank/--n_shard`` slices the sorted
input file list contiguously.
"""

from typing import Tuple

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
