"""Process-wide PyTorch configuration for the port's entry points.

The counterpart of the JAX package's ``utils/jax_setup.py``. Two things:

- full fp32 products: the JAX costs use ``Precision.HIGHEST``, so TF32 is
  switched off for both cuBLAS and cuDNN (TF32 costs drift by ~1e-3 and
  flip DP ties);
- device resolution: entry points run on the card unless the caller asks
  for the CPU. There is no fallback: asking for CUDA on a machine without
  a usable card raises;
- the multi-host hook (JAX ``jax_setup.py:32-47``): with
  ``SVECALIGN_COORDINATOR=host:port`` set, plus ``SVECALIGN_NUM_PROCESSES``
  and ``SVECALIGN_PROCESS_ID``, the first entry point to resolve a device
  joins a ``torch.distributed`` process group (``nccl`` for the cards,
  ``gloo`` for the CPU). The JAX package logs a failed join and goes on;
  here it raises, since running alone when a pod was asked for would be a
  hidden fallback. The file-level ``--rank/--n_shard`` sharding stays the
  cross-job mechanism; the devices of one process form a mesh
  (``parallel/mesh.py``).
"""

import os
from datetime import timedelta

import torch

DEVICES = ("cuda", "cpu")
COORDINATOR_ENV = "SVECALIGN_COORDINATOR"
JOIN_TIMEOUT_S = 300


def join_coordinator(device_type: str) -> bool:
    """Join the process group that ``SVECALIGN_COORDINATOR`` names, once
    per process; False when the variable is unset. Raises when the join
    fails or the variables disagree."""
    import torch.distributed as dist

    coord = os.environ.get(COORDINATOR_ENV)
    if not coord:
        return False
    if dist.is_initialized():
        return True
    world = int(os.environ.get("SVECALIGN_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("SVECALIGN_PROCESS_ID", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"SVECALIGN_PROCESS_ID={rank} is not a rank of "
                         f"SVECALIGN_NUM_PROCESSES={world}")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{coord}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    return True


def resolve_device(device="cuda") -> torch.device:
    """Pin fp32 and return the torch device for ``device`` ("cuda", "cpu"
    or a ``torch.device``); raises when CUDA is asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    join_coordinator(dev.type)
    return dev
