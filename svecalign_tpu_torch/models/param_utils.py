"""Parameter IO and the numpy init, shared by the port's models.

The JAX models keep their weights as flax trees, saved as ``.npz`` files
of flattened ``'a/b/c'`` keys (``save_params_npz``). The port's modules
mirror the flax module names, so a flax path maps to a ``state_dict`` key
mechanically (``/`` -> ``.``), and each leaf by its layer kind:

- Dense ``kernel`` (in, out)            -> ``Linear.weight`` (out, in)
- Conv ``kernel`` (k, in / groups, out) -> ``Conv1d.weight`` (out, in / groups, k):
  depthwise (k, 1, h), strided (10, 1, 512), grouped (128, 64, 1024)
- attention ``DenseGeneral`` kernels, on a module that names its flax
  leaves (``flax_leaves``, ``flax_heads``): query/key/value (d, heads, dh)
  -> ``Linear.weight`` (heads dh, d), their biases (heads, dh) -> (heads dh,);
  out (heads, dh, d) -> (d, heads dh)
- LayerNorm / GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
- Dense and Conv ``bias`` and bare parameters (``distance_embedding``,
  the ``relative`` flavor's ``pos_bias_u`` / ``pos_bias_v``, the pooler's
  ``query``)                            -> as they are

Random weights follow the JAX package's numpy init exactly: leaves in the
order JAX flattens the flax tree (sorted paths), kernels N(0, 1/fan_in),
biases 0, scales 1, from ``np.random.default_rng(seed)``.

The map runs both ways: :func:`params_from_jax` reads a JAX ``.npz`` into
a ``state_dict``, :func:`params_to_jax` and :func:`save_params_npz` write
a module's weights back in the flax layout, so a file written by either
package loads in the other.
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


def _flax_shape(shape: Tuple[int, ...], kind: str, heads: int) -> Tuple[int, ...]:
    """The flax leaf shape of a torch parameter of ``shape``."""
    if kind in ("dense", "conv"):
        return shape[::-1]  # (out, in) -> (in, out); (out, in, k) -> (k, in, out)
    if kind == "heads_in":
        return (shape[1], heads, shape[0] // heads)
    if kind == "heads_bias":
        return (heads, shape[0] // heads)
    if kind == "heads_out":
        return (heads, shape[1] // heads, shape[0])
    return shape


def _leaf_map(module: nn.Module) -> List[Tuple[Tuple[str, ...], str, str, Tuple[int, ...]]]:
    """(flax path, state_dict key, kind, flax shape) of every parameter of
    ``module``, in JAX's flattening order. kind: dense, conv, heads_in,
    heads_bias, heads_out or plain."""
    out = []
    for mod_name, mod in module.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        named = getattr(mod, "flax_leaves", None)
        for pname, param in mod.named_parameters(recurse=False):
            if named is not None:
                leaf, kind = named[pname]
            elif isinstance(mod, (nn.Linear, nn.Conv1d)):
                if pname == "bias":
                    leaf, kind = "bias", "plain"
                else:
                    leaf, kind = "kernel", ("dense" if isinstance(mod, nn.Linear) else "conv")
            elif isinstance(mod, FlaxLayerNorm):
                leaf, kind = ("scale" if pname == "weight" else pname), "plain"
            else:
                leaf, kind = pname, "plain"
            key = f"{mod_name}.{pname}" if mod_name else pname
            shape = _flax_shape(tuple(param.shape), kind, getattr(mod, "flax_heads", 1))
            out.append((prefix + (leaf,), key, kind, shape))
    return sorted(out)


def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return arr.T  # (in, out) -> (out, in)
    if kind == "conv":
        return arr.transpose(2, 1, 0)  # (k, in / groups, out) -> (out, in / groups, k)
    if kind == "heads_in":
        return arr.reshape(arr.shape[0], -1).T  # (d, heads, dh) -> (heads dh, d)
    if kind == "heads_bias":
        return arr.reshape(-1)  # (heads, dh) -> (heads dh,)
    if kind == "heads_out":
        return arr.reshape(-1, arr.shape[-1]).T  # (heads, dh, d) -> (d, heads dh)
    return arr


def _to_flax(arr: np.ndarray, kind: str, flax_shape: Tuple[int, ...]) -> np.ndarray:
    """The inverse of :func:`_to_torch`."""
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(2, 1, 0)
    if kind in ("heads_in", "heads_out"):
        # (heads dh, d) -> (d, heads, dh); (d, heads dh) -> (heads, dh, d)
        return arr.T.reshape(flax_shape)
    return arr.reshape(flax_shape)  # heads_bias: (heads dh,) -> (heads, dh)


def params_to_jax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The flat ``'a/b/c'`` fp32 params of ``module`` in the flax layout:
    the inverse of :func:`params_from_jax`."""
    state = module.state_dict()
    out = {}
    for path, key, kind, flax_shape in _leaf_map(module):
        arr = state[key].detach().float().cpu().numpy()
        # a copy: a CPU tensor's numpy view would follow later updates
        out["/".join(path)] = np.array(_to_flax(arr, kind, flax_shape), dtype=np.float32)
    return out


def save_params_npz(module: nn.Module, path: str) -> None:
    """Write ``module``'s weights as a JAX ``.npz`` (flattened ``'a/b/c'``
    keys, the counterpart of the JAX package's ``save_params_npz``)."""
    np.savez(path, **params_to_jax(module))


def params_from_jax(
    flat: Dict[str, np.ndarray], module: nn.Module, seed: int = 0, source: str = "params",
) -> Dict[str, torch.Tensor]:
    """The fp32 ``state_dict`` of ``module`` from a JAX model's flat
    ``'a/b/c'`` params. Raises on unknown or mis-shaped leaves; missing
    leaves are drawn with :func:`numpy_init_leaf` (so ``flat={}`` gives
    the JAX package's random init for ``seed``) and, when ``flat`` is not
    empty, logged with a warning."""
    leaves = _leaf_map(module)
    want = {"/".join(path) for path, *_ in leaves}
    extra = sorted(k for k in flat if k not in want)
    if extra:
        raise KeyError(f"{source}: {len(extra)} unknown parameter paths, e.g. {extra[0]} "
                       "-- wrong architecture/config?")
    rng = np.random.default_rng(seed)
    state, missing = {}, []
    for path, key, kind, flax_shape in leaves:
        name = "/".join(path)
        if name in flat:
            arr = np.asarray(flat[name], np.float32)
            if arr.shape != flax_shape:
                raise ValueError(f"{source}: shape mismatch at {name}: {arr.shape}, want "
                                 f"{flax_shape}")
            got = _to_torch(arr, kind)
        else:
            missing.append(name)
            got = _to_torch(numpy_init_leaf(path, flax_shape, rng), kind)
        state[key] = torch.from_numpy(np.ascontiguousarray(got))
    if missing and flat:
        logger.warning(f"{source}: {len(missing)} parameters not in the checkpoint "
                       f"(e.g. {missing[0]}) kept at random init -- trunk-only checkpoint?")
    return state
