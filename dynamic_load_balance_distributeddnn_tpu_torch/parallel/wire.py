"""The quantized gradient wire, flat part (the JAX package's ``parallel/wire.py``).

The ``int8`` wire: 127 levels of a scale shared over the participants (the
max of ``|v|``, one scalar collective), **stochastic** rounding
(``floor(v / scale + u)`` with ``u`` a uniform dither, so
``E[dequant] == v``), and an integer sum over the participants. The ``int4``
wire rounds to the nearest of 7 levels. ``_dither`` is the JAX package's
murmur3 finalizer over the element index and a key-derived seed, computed
here in int64 and masked to 32 bits, so on the same key and index it gives
the JAX field bit for bit; the keys come from ``parallel/prng.py``.

**The sum's dtype.** The JAX package sums the int8 codes of ``n``
participants in the narrowest integer type that holds ``n * levels``
(``wire_sum_dtype``: int16 for the int8 wire). Neither gloo nor NCCL reduces
int16, and gloo's int8 sum wraps. The port carries the same integer sum in
``float16`` while ``n * levels <= 2048`` (every partial sum an integer of at
most 2048 in magnitude, which float16 holds exactly: 2 bytes an element, as
JAX's int16), and in int32 above that (``transport_dtype``). The sum is
exact either way, so on the same values, keys and dither indices the
dequantized result is the JAX package's. The port's flat gradient buffer
keeps each parameter in torch's layout, not flax's, so its callers pass
each element's flax ravel position as its dither index
(``train/combine.py``).
``wire_payload_bytes`` reports the port's element size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import Key, key_data

WIRE_FORMATS = ("fp32", "int8", "int4")
_LEVELS = {"int8": 127, "int4": 7}
_FP16_EXACT = 2048  # the largest magnitude up to which float16 holds every integer
_M = 0xFFFFFFFF


def wire_levels(wire: str) -> int:
    return _LEVELS[wire]


def wire_sum_dtype(wire: str, n_participants: int) -> str:
    """The JAX package's integer dtype for the wire sum (its name): the
    narrowest that holds ``n_participants * levels``."""
    if n_participants * _LEVELS[wire] <= 127:
        return "int8"
    if n_participants * _LEVELS[wire] <= 32767:
        return "int16"
    return "int32"


def transport_dtype(wire: str, n_participants: int) -> torch.dtype:
    """The dtype the port's wire sum travels in: float16 while every
    partial sum is an integer float16 holds exactly, else int32."""
    if n_participants * _LEVELS[wire] <= _FP16_EXACT:
        return torch.float16
    return torch.int32


def wire_payload_bytes(wire: str, n_participants: int) -> int:
    """Bytes an element a reduction on this wire moves in the port."""
    if wire == "fp32":
        return 4
    return torch.empty((), dtype=transport_dtype(wire, n_participants)).element_size()


def dither_seed(key: Key) -> int:
    """``kd[0] ^ (kd[-1] * 0x9E3779B9)`` of the key's data, mod 2**32."""
    kd = key_data(key)
    return kd[0] ^ ((kd[-1] * 0x9E3779B9) & _M)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` below 2**32, without an int64
    overflow: ``c`` split in 16-bit halves keeps every product below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M


def murmur_uniform(index: torch.Tensor, seed) -> torch.Tensor:
    """The dither field: U[0, 1) float32 from the murmur3 finalizer of
    ``index * 2654435761 + seed`` (int64 tensors or ints; 32-bit values)."""
    x = (_mul32(index, 2654435761) + seed) & _M
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _dither(key: Key, shape, device=None) -> torch.Tensor:
    """U[0, 1) dither of ``shape`` from ``key`` (the JAX ``_dither``)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return murmur_uniform(idx, dither_seed(key)).reshape(tuple(shape))


def quantize_stochastic(v: torch.Tensor, key: Key, scale, levels: int,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased stochastic rounding to ``[-levels, levels]`` steps of
    ``scale`` (``u``: the dither field, made from ``key`` when not given)."""
    if u is None:
        u = _dither(key, v.shape, v.device)
    return torch.clamp(torch.floor(v.to(torch.float32) / scale + u), -levels, levels)


def quantize_nearest(v: torch.Tensor, scale, levels: int) -> torch.Tensor:
    """Round-to-nearest (half to even, as ``jnp.round``) to ``[-levels, levels]``."""
    return torch.clamp(torch.round(v.to(torch.float32) / scale), -levels, levels)


def wire_scale(amax: torch.Tensor, levels: int) -> torch.Tensor:
    """``max(amax / levels, tiny)``: the shared step of the codes. XLA
    computes a division by a constant as a product with its f32
    reciprocal, and so does this, so the step is the JAX package's."""
    return torch.clamp_min(amax * (1.0 / levels), torch.finfo(torch.float32).tiny)


def _codes(v, key, scale, wire, u=None):
    levels = _LEVELS[wire]
    if wire == "int8":
        return quantize_stochastic(v, key, scale, levels, u)
    return quantize_nearest(v, scale, levels)


def compressed_reduce(v: torch.Tensor, key: Key, mesh, n_participants: int,
                      wire: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compressed all-reduce of ``v`` over ``mesh`` (``parallel/mesh.py``
    ``DataMesh``): ``(total, sent)``, the dequantized sum and this
    participant's dequantized contribution (the error-feedback residual is
    ``v - sent``; zero on the fp32 wire)."""
    if wire == "fp32":
        total = v.clone()
        mesh.all_reduce_(total)
        return total, v
    amax = torch.amax(torch.abs(v)).reshape(1).to(torch.float32)
    mesh.all_reduce_(amax, op="max")
    scale = wire_scale(amax[0], _LEVELS[wire])
    q = _codes(v, key, scale, wire)
    s = q.to(transport_dtype(wire, n_participants))
    mesh.all_reduce_(s)
    return s.to(torch.float32) * scale, q * scale


def compressed_reduce_scatter_ef(v: torch.Tensor, key: Key, mesh, n_participants: int,
                                 wire: str, index: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compressed reduce-scatter of the flat ``v`` (its length a
    multiple of the axis size): ``(this rank's block of the sum, sent)``.
    ``index``: each element's dither index (int64, ``v``'s length), where
    ``v`` is not laid out as the JAX vector it stands for; else its position."""
    chunk = v.numel() // mesh.size
    if wire == "fp32":
        out = torch.empty(chunk, dtype=v.dtype, device=v.device)
        return mesh.reduce_scatter(out, v), v
    amax = torch.amax(torch.abs(v)).reshape(1).to(torch.float32)
    mesh.all_reduce_(amax, op="max")
    scale = wire_scale(amax[0], _LEVELS[wire])
    u = None if index is None or wire != "int8" else murmur_uniform(index, dither_seed(key))
    q = _codes(v, key, scale, wire, u)
    s = q.to(transport_dtype(wire, n_participants))
    out = torch.empty(chunk, dtype=s.dtype, device=v.device)
    mesh.reduce_scatter(out, s)
    return out.to(torch.float32) * scale, q * scale


def compressed_reduce_scatter(v: torch.Tensor, key: Key, mesh, n_participants: int,
                              wire: str, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual-free reduce-scatter (the flat ZeRO-1 path's gradient
    collective on the quantized wire)."""
    return compressed_reduce_scatter_ef(v, key, mesh, n_participants, wire, index)[0]


def compressed_reduce_leaves(flat: torch.Tensor, sizes: Sequence[int], keys: Sequence[Key],
                             mesh, n_participants: int, wire: str = "int8",
                             index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`compressed_reduce` of each leaf of a flat buffer (leaf ``i`` the
    next ``sizes[i]`` elements, dithered from ``keys[i]``), the leaves
    batched into two collectives: one max of the leaves' ``amax`` vector
    and one sum of their codes. ``index``: each element's position in the
    JAX package's ravel of the leaves (int64, at least ``sum(sizes)`` long;
    default its position in ``flat``), whose offset within its leaf is the
    element's dither index. Element for element the per-leaf math; returns
    the dequantized sums in a new flat tensor."""
    dev = flat.device
    sizes_t = torch.tensor(list(sizes), dtype=torch.int64, device=dev)
    n = int(sum(sizes))
    v = flat[:n]
    leaf = torch.repeat_interleave(torch.arange(len(sizes), device=dev), sizes_t)
    amax = torch.zeros(len(sizes), dtype=torch.float32, device=dev).scatter_reduce_(
        0, leaf, torch.abs(v).to(torch.float32), "amax", include_self=False)
    mesh.all_reduce_(amax, op="max")
    scale = torch.repeat_interleave(wire_scale(amax, _LEVELS[wire]), sizes_t)
    u = None
    if wire == "int8":
        starts = torch.cumsum(sizes_t, 0) - sizes_t
        pos = torch.arange(n, dtype=torch.int64, device=dev) if index is None else index[:n]
        seeds = torch.tensor([dither_seed(k) for k in keys], dtype=torch.int64, device=dev)
        u = murmur_uniform(pos - starts[leaf], seeds[leaf])
    q = _codes(v, None, scale, wire, u)
    s = q.to(transport_dtype(wire, n_participants))
    mesh.all_reduce_(s)
    out = torch.zeros_like(flat)
    out[:n] = s.to(torch.float32) * scale
    return out
