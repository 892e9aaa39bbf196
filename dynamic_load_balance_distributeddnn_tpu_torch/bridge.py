"""Carry weights from a flax parameter tree into a port model.

The port's modules carry flax's auto-names, so the bridge maps parameter
*paths*, not positions:

- ``.../Conv_k/kernel``  HWIO  -> ``...Conv_k.weight``  OIHW; the same
  rule carries RegNet's ``.../GroupedConv_k/kernel`` ``(3, 3, in/g, out)``
  to its ``nn.Conv2d(groups=g)``'s ``(out, in/g, 3, 3)``
- ``.../Dense_k/kernel`` [in, out] -> ``...Dense_k.weight`` [out, in]
- ``.../GroupNorm_k/scale``, ``.../LayerNorm_k/scale`` -> ``....weight``
  (``bias`` -> ``bias``)
- ``.../attn/{query,key,value}/kernel`` ``[in, H, hd]`` (``DenseGeneral``)
  -> ``...attn.query.weight`` ``[H*hd, in]``, bias ``[H, hd]`` -> ``[H*hd]``
- ``.../attn/out/kernel`` ``[H, hd, out]`` -> ``...attn.out.weight``
  ``[out, H*hd]``
- ``.../Embed_k/embedding`` ``[V, E]`` -> ``...Embed_k.weight``

Dense inputs need no row permutation: the port flattens its activations in
flax's (h, w, c) order. A gradient tree has the parameter tree's layout, so
the same function carries ``jax.grad`` results across. Leaves may be any
array ``numpy.asarray`` accepts; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert(path: tuple, leaf: np.ndarray):
    *mods, name = path
    if name == "kernel":
        if leaf.ndim == 4:  # conv HWIO -> OIHW
            return ".".join(mods) + ".weight", leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 2:  # dense [in, out] -> [out, in]
            return ".".join(mods) + ".weight", leaf.T
        if leaf.ndim == 3:  # DenseGeneral over heads
            if mods[-1] == "out":  # [H, hd, out] -> [out, H*hd]
                return ".".join(mods) + ".weight", leaf.reshape(-1, leaf.shape[-1]).T
            # [in, H, hd] -> [H*hd, in]
            return ".".join(mods) + ".weight", leaf.reshape(leaf.shape[0], -1).T
        raise ValueError(f"{'/'.join(path)}: kernel of rank {leaf.ndim}")
    if name in ("scale", "embedding"):
        return ".".join(mods) + ".weight", leaf
    if name == "bias":  # a DenseGeneral bias [H, hd] flattens to [H*hd]
        return ".".join(mods) + ".bias", leaf.reshape(-1)
    raise ValueError(f"{'/'.join(path)}: unknown flax parameter {name!r}")


def params_from_flax(flax_params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from a flax tree (with or without the
    outer ``{"params": ...}``). Raises unless every model parameter is
    covered exactly once, with the right shape."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(flax_params).items():
        key, arr = _convert(path, leaf)
        if key not in expected:
            raise KeyError(f"flax parameter {'/'.join(path)} -> {key}: not in the model")
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{key}: flax shape {tuple(arr.shape)} vs model {tuple(expected[key].shape)}"
            )
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
    missing = set(expected) - set(out)
    if missing:
        raise KeyError(f"model parameters with no flax counterpart: {sorted(missing)}")
    return out
