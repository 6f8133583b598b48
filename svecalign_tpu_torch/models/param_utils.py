"""Parameter IO and the numpy init, shared by the port's models.

The JAX models keep their weights as flax trees, saved as ``.npz`` files
of flattened ``'a/b/c'`` keys (``save_params_npz``). The port's modules
mirror the flax module names, so a flax path maps to a ``state_dict`` key
mechanically (``/`` -> ``.``), and each leaf by its layer kind:

- Dense ``kernel`` (in, out)            -> ``Linear.weight`` (out, in)
- depthwise Conv ``kernel`` (k, 1, h)   -> ``Conv1d.weight`` (h, 1, k)
- LayerNorm ``scale`` / ``bias``        -> ``weight`` / ``bias``
- Dense ``bias`` and bare parameters (``distance_embedding``, the
  pooler's ``query``)                   -> as they are

Random weights follow the JAX package's numpy init exactly: leaves in the
order JAX flattens the flax tree (sorted paths), kernels N(0, 1/fan_in),
biases 0, scales 1, from ``np.random.default_rng(seed)``.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from svecalign_tpu_torch.models.w2v_bert import FlaxLayerNorm
from svecalign_tpu_torch.utils.log_utils import logging

logger = logging.getLogger(__name__)


def numpy_init_leaf(path: Tuple[str, ...], shape: Tuple[int, ...], rng: np.random.Generator):
    """One flax leaf of the numpy init: kernels ~ N(0, 1/fan_in), biases 0,
    norm scales 1 (fan_in = product of all but the last axis)."""
    name = path[-1]
    if name == "scale":
        return np.ones(shape, np.float32)
    if name == "bias":
        return np.zeros(shape, np.float32)
    fan_in = int(np.prod(shape[:-1])) or 1
    return rng.normal(0.0, fan_in**-0.5, shape).astype(np.float32)


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{'a/b/c': array}`` params of a JAX ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: np.asarray(v) for k, v in data.items()}


def _leaf_map(module: nn.Module) -> List[Tuple[Tuple[str, ...], str, str]]:
    """(flax path, state_dict key, kind) of every parameter of ``module``,
    in JAX's flattening order. kind: dense, conv or plain."""
    out = []
    for mod_name, mod in module.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for pname, _ in mod.named_parameters(recurse=False):
            if isinstance(mod, nn.Linear):
                leaf, kind = ("kernel", "dense") if pname == "weight" else (pname, "plain")
            elif isinstance(mod, nn.Conv1d):
                leaf, kind = "kernel", "conv"
            elif isinstance(mod, FlaxLayerNorm):
                leaf, kind = ("scale" if pname == "weight" else pname), "plain"
            else:
                leaf, kind = pname, "plain"
            key = f"{mod_name}.{pname}" if mod_name else pname
            out.append((prefix + (leaf,), key, kind))
    return sorted(out)


def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return arr.T  # (in, out) -> (out, in)
    if kind == "conv":
        return arr.transpose(2, 1, 0)  # (k, 1, h) -> (h, 1, k)
    return arr


def params_from_jax(
    flat: Dict[str, np.ndarray], module: nn.Module, seed: int = 0, source: str = "params",
) -> Dict[str, torch.Tensor]:
    """The fp32 ``state_dict`` of ``module`` from a JAX model's flat
    ``'a/b/c'`` params. Raises on unknown or mis-shaped leaves; missing
    leaves are drawn with :func:`numpy_init_leaf` (so ``flat={}`` gives
    the JAX package's random init for ``seed``) and, when ``flat`` is not
    empty, logged with a warning."""
    leaves = _leaf_map(module)
    want = {"/".join(path) for path, _, _ in leaves}
    extra = sorted(k for k in flat if k not in want)
    if extra:
        raise KeyError(f"{source}: {len(extra)} unknown parameter paths, e.g. {extra[0]} "
                       "-- wrong architecture/config?")
    shapes = dict(module.state_dict().items())
    rng = np.random.default_rng(seed)
    state, missing = {}, []
    for path, key, kind in leaves:
        torch_shape = tuple(shapes[key].shape)
        name = "/".join(path)
        if name in flat:
            arr = np.asarray(flat[name], np.float32)
            got = _to_torch(arr, kind)
            if tuple(got.shape) != torch_shape:
                raise ValueError(f"{source}: shape mismatch at {name}: {arr.shape} does not "
                                 f"map to {torch_shape}")
        else:
            missing.append(name)
            # dense and conv kernels are the torch layout reversed
            flax_shape = torch_shape if kind == "plain" else torch_shape[::-1]
            got = _to_torch(numpy_init_leaf(path, flax_shape, rng), kind)
        state[key] = torch.from_numpy(np.ascontiguousarray(got))
    if missing and flat:
        logger.warning(f"{source}: {len(missing)} parameters not in the checkpoint "
                       f"(e.g. {missing[0]}) kept at random init -- trunk-only checkpoint?")
    return state
