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

``flax_leaf_order`` is the other direction's order: the port's parameter
names in the order JAX's ``tree_flatten`` visits the flax tree (each
level's keys sorted, depth first), which is not ``model.parameters()``
order. A leaf's index in it is the ``i`` of the JAX package's per-leaf keys
(``fold_in(rng, i + 0x7FFF)``, ``train/steps.py`` ``_compressed_psum``).
``flax_index`` maps each element of a port parameter to its position in
the flax leaf's row-major ravel, which is where the JAX package's dither
index of that element comes from.
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


def flax_path(model: nn.Module, name: str) -> tuple:
    """The flax path of the port parameter ``name`` (the inverse of
    ``_convert``'s name mapping)."""
    *mods, leaf = name.split(".")
    if leaf == "weight":  # a norm's scale, an embedding table, else a kernel
        kind = type(model.get_submodule(".".join(mods))).__name__
        leaf = "scale" if "Norm" in kind else "embedding" if "Embed" in kind else "kernel"
    return tuple(mods) + (leaf,)


def flax_leaf_order(model: nn.Module) -> list:
    """The model's parameter names in JAX's ``tree_flatten`` order of the
    flax tree: the flax paths sorted (each level's keys sorted, depth first)."""
    names = [n for n, _ in model.named_parameters()]
    return sorted(names, key=lambda n: flax_path(model, n))


def flax_index(model: nn.Module, name: str) -> torch.Tensor:
    """For each element of the port parameter ``name``, its index in the
    row-major ravel of the flax leaf (int64, the parameter's shape): the
    inverse of ``_convert``'s transposes. A ``DenseGeneral`` kernel
    ``[in, H, hd]`` or ``[H, hd, out]`` ravels as its 2-D ``[in, H*hd]`` or
    ``[H*hd, out]``, so every 2-D kernel is a transposed dense one."""
    p = model.get_parameter(name)
    if flax_path(model, name)[-1] == "kernel":
        if p.dim() == 4:  # OIHW <- HWIO
            o, i, h, w = p.shape
            return torch.arange(p.numel()).reshape(h, w, i, o).permute(3, 2, 0, 1)
        if p.dim() == 2:  # [out, in] <- [in, out]
            return torch.arange(p.numel()).reshape(p.shape[1], p.shape[0]).T
    return torch.arange(p.numel()).reshape(p.shape)


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
