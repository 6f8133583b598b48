"""Device meshes: one process driving a grid of devices.

Port of the JAX package's ``parallel/mesh.py``. JAX's mesh is a single
controller: one process places shards on its local devices and
``shard_map`` runs the same code on each. The counterpart here is one
process that holds a ``(data, model)`` grid of ``torch.device`` and runs
each shard's work on its device. No collective is needed on any
data-parallel path of the pipeline: the aligner's pairs and the encoders'
rows are independent, and the sharded kNN search gathers each shard's
``(nq, k)`` candidates on the mesh's first device with device-to-device
copies and merges them there.

- ``data`` axis: the rows of an encoder chunk, the pairs of an aligner
  bucket, the rows of a kNN corpus;
- ``model`` axis: tensor parallelism of the encoders for training
  (``models/training.py::shard_train_step``), by the partition rules
  :func:`encoder_param_spec` and :func:`shard_params`; the inference
  paths are data-parallel and take meshes whose model axis is 1.

:func:`make_mesh` takes the first ``n_devices`` local devices. A
:class:`Mesh` can also be built from an explicit list in which devices
repeat: ``Mesh([cuda:0, cuda:0])`` is a two-shard mesh on one card, which
runs every sharded code path (split, per-shard work, peer copies, merge)
where only one card is present; the tests and the one-card smoke use it.
On the CPU, ``n_devices`` CPU shards play the role of the JAX tests'
``--xla_force_host_platform_device_count``; ``SVECALIGN_CPU_DEVICES``
says how many "local" CPU devices there are (default 1).

Host-level sharding keeps the reference's ``--rank/--n_shard`` file
contract (``utils/mp_utils.py``); ``utils/torch_setup.py`` joins a
multi-host job from ``SVECALIGN_COORDINATOR``.
"""

import contextlib
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.utils.torch_setup import resolve_device

AXIS_NAMES = ("data", "model")
CPU_DEVICES_ENV = "SVECALIGN_CPU_DEVICES"


def local_device_count(device_type: str) -> int:
    """Visible cards for "cuda"; for "cpu", ``SVECALIGN_CPU_DEVICES``
    (default 1)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return int(os.environ.get(CPU_DEVICES_ENV, "1"))
    raise ValueError(f"device type must be cuda or cpu, got {device_type!r}")


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        # an index-less "cuda" means whatever card is current where it is
        # used: a mesh names each of its cards
        raise ValueError("mesh devices must carry an index: cuda:0, not cuda")
    if dev.type == "cpu":
        dev = torch.device("cpu")  # CPU tensors report no index
    return dev


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``.

    ``devices``: a flat sequence (a ``(len, 1)`` grid) or a 2-D grid of
    devices or device strings; devices may repeat. ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Tuple[str, str] = AXIS_NAMES):
        arr = np.array([[_as_device(d) for d in row] for row in _rows(devices)], dtype=object)
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) != 2:
            raise ValueError(f"want two axis names, got {axis_names}")
        if len({d.type for d in arr.flat}) != 1:
            raise ValueError("a mesh's devices must all be cuda or all be cpu")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per data shard. Data-parallel paths replicate over
        no model axis, so they refuse a mesh whose model axis is not 1."""
        if self.devices.shape[1] != 1:
            raise ValueError(
                f"a data-parallel path takes a model axis of 1, got {self.devices.shape[1]}: "
                "the model axis is tensor parallelism, for training "
                "(models/training.py::shard_train_step)")
        return list(self.devices[:, 0])

    @property
    def grid(self) -> List[List[torch.device]]:
        """The ``(data, model)`` grid: ``grid[i][j]`` holds model shard
        ``j`` of data shard ``i`` (training's tensor-parallel step)."""
        return [list(row) for row in self.devices]

    @property
    def first(self) -> torch.device:
        """Where merged results live: the first data shard's device."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in row] for row in self.devices]}, {self.axis_names})"


def _rows(devices):
    devices = list(devices)
    if devices and isinstance(devices[0], (list, tuple, np.ndarray)):
        return [list(r) for r in devices]
    return [[d] for d in devices]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device="cuda",
              axis_names: Tuple[str, str] = AXIS_NAMES) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` local devices
    of ``device``'s type (all of them when None). Cards are named by their
    index; asking for more cards than are present raises. On the CPU
    ``n_devices`` shards share the one CPU."""
    dev = resolve_device(device)
    available = local_device_count(dev.type)
    n = available if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if dev.type == "cuda" and n > available:
        raise ValueError(f"asked for {n} cards, {available} present")
    if n % model_parallel:
        raise ValueError(f"{n} devices do not divide into model_parallel={model_parallel}")
    if dev.type == "cuda":
        flat = [torch.device("cuda", i) for i in range(n)]
    else:
        flat = [torch.device("cpu")] * n
    grid = [flat[r * model_parallel:(r + 1) * model_parallel]
            for r in range(n // model_parallel)]
    return Mesh(grid, axis_names)


def default_mesh(device) -> Optional[Mesh]:
    """The encoders' default, JAX's: a mesh over every local device of
    ``device``'s type when there is more than one, else None."""
    dev = resolve_device(device)
    return make_mesh(device=dev.type) if local_device_count(dev.type) > 1 else None


# ---------------------------------------------------------------------------
# placement: the counterparts of NamedSharding(mesh, P("data")) and P()
# ---------------------------------------------------------------------------


def shard_slices(n: int, mesh: Mesh) -> List[slice]:
    """Contiguous slices of a leading axis of ``n``, one per data shard;
    ``n`` must divide evenly over the data axis (JAX's rule)."""
    k = mesh.devices.shape[0]
    if n % k:
        raise ValueError(f"a leading axis of {n} does not split evenly over {k} data shards")
    step = n // k
    return [slice(i * step, (i + 1) * step) for i in range(k)]


class Sharding(NamedTuple):
    """Where a value goes on a mesh: its leading axis split over the data
    axis (``batch``), or a whole copy on every data shard."""

    mesh: Mesh
    batch: bool

    def put(self, x) -> List[torch.Tensor]:
        """One tensor per data shard, on that shard's device, from a numpy
        array or a tensor on any device (a device-to-device copy)."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        devs = self.mesh.data_devices
        if not self.batch:
            return replicate(t, devs)
        return [t[s].to(d) for s, d in zip(shard_slices(t.shape[0], self.mesh), devs)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis over the data axis."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def replicate(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """One copy of ``value`` per device, made once per distinct device:
    shards on one device share it."""
    made = {}
    for d in devices:
        if d not in made:
            made[d] = value.to(d)
    return [made[d] for d in devices]


# ---------------------------------------------------------------------------
# tensor parallelism: the encoders' partition rules over the model axis
# ---------------------------------------------------------------------------


def encoder_param_spec(key: str, value: torch.Tensor) -> Optional[int]:
    """The torch axis of ``state_dict[key]`` split over the ``model`` axis,
    or None where the tensor is replicated: the JAX package's rule on the
    port's keys. FFN expansions split their hidden units, contractions
    their input; attention projections split heads, the output projection
    on its input; conv and norm parameters and every bias replicate. A
    torch Linear weight is (out, in), flax's kernel (in, out), so each
    axis is the other one of JAX's."""
    name = key.replace(".", "/")
    if value.dim() < 2 or not name.endswith("weight"):
        return None
    if any(f in name for f in ("ffn_in", "ffn1_in", "ffn2_in")):
        return 0  # flax P(None, "model")
    if any(f in name for f in ("ffn_out", "ffn1_out", "ffn2_out")):
        return 1  # flax P("model", None)
    if "attn" in name and "out" not in name:
        return 0  # flax P(None, "model", None) on (d, heads, dh)
    if "attn/out/" in name:
        return 1  # flax P("model", None, None) on (heads, dh, d)
    return None


def model_slice(n: int, j: int, model_parallel: int) -> slice:
    """Model shard ``j``'s part of an axis of ``n``."""
    if n % model_parallel:
        raise ValueError(f"an axis of {n} does not split over {model_parallel} model shards")
    step = n // model_parallel
    return slice(j * step, (j + 1) * step)


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh) -> List[List[Dict]]:
    """Place a ``state_dict`` on the mesh by :func:`encoder_param_spec`:
    ``out[i][j][key]`` is model shard ``j``'s slice (or the whole tensor,
    where it is replicated) on device ``grid[i][j]``. Each slice is copied
    once per distinct device; slicing and copies are differentiable, so
    gradients of the shards reach the tensors given."""
    grid = mesh.devices
    n_data, n_model = grid.shape
    out = [[{} for _ in range(n_model)] for _ in range(n_data)]
    for key, value in state_dict.items():
        axis = encoder_param_spec(key, value)
        made = {}
        for i, j in np.ndindex(n_data, n_model):
            part = None if axis is None else j
            if (part, grid[i, j]) not in made:
                piece = value
                if axis is not None:
                    s = model_slice(value.shape[axis], j, n_model)
                    piece = value.narrow(axis, s.start, s.stop - s.start)
                made[(part, grid[i, j])] = piece.to(grid[i, j])
            out[i][j][key] = made[(part, grid[i, j])]
    return out


# ---------------------------------------------------------------------------
# running the shards
# ---------------------------------------------------------------------------

_local = threading.local()


def current_shard() -> Optional[int]:
    """The data shard whose work the calling thread is issuing, or None."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def shard_scope(index: int, device: torch.device):
    """Issue the enclosed work as data shard ``index``: kernel launches
    are counted for it (``ops/_build.py::count_launch``), and on a card it
    is the current device."""
    prev = current_shard()
    _local.shard = index
    try:
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield
    finally:
        _local.shard = prev


def run_on_shards(mesh: Mesh, fn: Callable, per_shard: Sequence) -> list:
    """``fn(index, device, item)`` for each data shard and its item, in
    shard order on the calling thread, each under :func:`shard_scope`;
    the results in shard order. A shard's work overlaps the next shard's
    only where neither waits for the other: a shard that waits on the
    host (a pull) holds the others back, and so does a copy between
    devices, which runs on the source device's current stream after the
    work queued there (the encoders queue every shard's copy-in before
    any replay for this reason: ``encode_common._span_forward``). One
    worker thread per shard was measured slower on one card and on four:
    the shards' launches pass the interpreter lock back and forth
    (``PERF.md``)."""
    devs = mesh.data_devices
    if len(per_shard) != len(devs):
        raise ValueError(f"{len(per_shard)} items for {len(devs)} data shards")
    out = []
    for i, (dev, item) in enumerate(zip(devs, per_shard)):
        with shard_scope(i, dev):
            out.append(fn(i, dev, item))
    return out
