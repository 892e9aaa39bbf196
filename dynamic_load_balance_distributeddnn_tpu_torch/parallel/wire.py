"""The quantized gradient wire (the JAX package's ``parallel/wire.py``).

The ``int8`` wire: 127 levels of a scale shared over the participants (the
max of ``|v|``, one scalar collective), **stochastic** rounding
(``floor(v / scale + u)`` with ``u`` a uniform dither, so
``E[dequant] == v``), and an integer sum over the participants. The ``int4``
wire rounds to the nearest of 7 levels. ``_dither`` is the JAX package's
murmur3 finalizer over the element index and a key-derived seed, computed
here in int64 and masked to 32 bits, so on the same key and index it gives
the JAX field bit for bit; the keys come from ``parallel/prng.py``.

**The sum's dtype.** The JAX package sums the codes of ``n`` participants in
the narrowest integer type that holds ``n * levels`` (``wire_sum_dtype``:
int8 for the int4 wire up to 18 participants, int16 for the int8 wire).
gloo and NCCL both sum int8, which wraps only on an overflow that ``n *
levels <= 127`` rules out, so the port carries those sums in int8 as the
JAX package does. Neither reduces int16: the port carries the int8 wire's
sum in ``float16`` while ``n * levels <= 2048`` (every partial sum an
integer of at most 2048 in magnitude, which float16 holds exactly: 2 bytes
an element, as JAX's int16), and in int32 above that (``transport_dtype``).
The sum is exact either way, so on the same values, keys and dither
indices the dequantized result is the JAX package's.
``wire_payload_bytes`` reports the port's element size: the JAX package's
up to 16 participants a hop.

**The tree** (``--grad_comm hier``, :func:`tree_allreduce`): the JAX
package's N-level spine over the sub-axes of ``parallel/mesh.py``
(``DataMesh.tree_axes``): an fp32 reduce-scatter over the innermost level,
an error-fed compressed reduce-scatter a middle level, a compressed
all-reduce over the outermost one, then all-gathers back down; per-hop
error-feedback residuals, per-hop keys ``fold_in(key, i)``. The vector it
takes is laid out as the JAX package's ravel (the caller permutes the
port's buffer into that order, ``train/combine.py``), so each rank holds
the elements the JAX device of its coordinates holds, every hop's scale is
the JAX scale and every dither index the JAX index.

The port's flat gradient buffer keeps each parameter in torch's layout,
not flax's, so the flat wire's callers pass each element's flax ravel
position as its dither index (``train/combine.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import Key, fold_in, key_data

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
    """The dtype the port's wire sum travels in: int8 where the JAX package
    sums in int8 (no partial sum can pass 127), float16 while every partial
    sum is an integer float16 holds exactly, else int32."""
    if n_participants * _LEVELS[wire] <= 127:
        return torch.int8
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


def _hop(v: torch.Tensor, key: Key, mesh, n_participants: int, wire: str, scatter: bool,
         index: Optional[torch.Tensor] = None):
    """One hop over ``mesh`` (an all-reduce, or a reduce-scatter of the
    flat ``v``): ``(this rank's sum or block of it, codes, scale, the codes'
    sum)``; the last three are None on the fp32 wire."""
    if wire == "fp32":
        if scatter:
            out = torch.empty(v.numel() // mesh.size, dtype=v.dtype, device=v.device)
            return mesh.reduce_scatter(out, v), None, None, None
        return mesh.all_reduce_(v.clone()), None, None, None
    amax = torch.amax(torch.abs(v)).reshape(1).to(torch.float32)
    mesh.all_reduce_(amax, op="max")
    scale = wire_scale(amax[0], _LEVELS[wire])
    u = None if index is None or wire != "int8" else murmur_uniform(index, dither_seed(key))
    q = _codes(v, key, scale, wire, u)
    s = q.to(transport_dtype(wire, n_participants))
    if scatter:
        s = mesh.reduce_scatter(torch.empty(v.numel() // mesh.size, dtype=s.dtype,
                                            device=v.device), s)
    else:
        mesh.all_reduce_(s)
    s = s.to(torch.float32)
    return s * scale, q, scale, s


def _sent(v: torch.Tensor, q: Optional[torch.Tensor], scale) -> torch.Tensor:
    return v if q is None else q * scale


def ef_residual(v: torch.Tensor, q: Optional[torch.Tensor], scale) -> torch.Tensor:
    """The error-feedback residual ``v - q * scale`` rounded once, as XLA
    computes the JAX package's ``v - sent`` (a fused multiply-subtract):
    in f64, where the product of a code and the f32 scale is exact; ``v -
    v`` on the fp32 wire (zero, as the JAX package's).

    The single rounding copies the fusion of XLA's CPU backend in JAX and
    jaxlib 0.9.0, which the tests hold the port to bit for bit. Should a
    later XLA stop fusing it, the fallback is the plain f32 ``v - q *
    scale`` (two roundings: residuals within 1 ulp of the reference's,
    without the f64 pass over the hop's chunk), here and in
    :func:`_add_residual`."""
    if q is None:
        return v - v
    return (v.double() - q.double() * scale.double()).to(torch.float32)


def _add_residual(v: torch.Tensor, summed: Optional[torch.Tensor], scale,
                  r: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``v + residual`` on a hop's input. Where ``v`` is
    a compressed hop's output ``summed * scale``, XLA fuses the two into
    one multiply-add, rounded once: so here in f64, where the product is
    exact (the same XLA fusion, and the same f32 fallback, as
    :func:`ef_residual`)."""
    if r is None:
        return v + 0.0
    if summed is None:
        return v + r
    return (summed.double() * scale.double() + r.double()).to(torch.float32)


def compressed_reduce(v: torch.Tensor, key: Key, mesh, n_participants: int,
                      wire: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compressed all-reduce of ``v`` over ``mesh`` (``parallel/mesh.py``
    ``DataMesh``): ``(total, sent)``, the dequantized sum and this
    participant's dequantized contribution (the error-feedback residual is
    ``v - sent``, :func:`ef_residual`; zero on the fp32 wire)."""
    total, q, scale, _ = _hop(v, key, mesh, n_participants, wire, scatter=False)
    return total, _sent(v, q, scale)


def compressed_reduce_scatter_ef(v: torch.Tensor, key: Key, mesh, n_participants: int,
                                 wire: str, index: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compressed reduce-scatter of the flat ``v`` (its length a
    multiple of the axis size): ``(this rank's block of the sum, sent)``.
    ``index``: each element's dither index (int64, ``v``'s length), where
    ``v`` is not laid out as the JAX vector it stands for; else its position."""
    out, q, scale, _ = _hop(v, key, mesh, n_participants, wire, scatter=True, index=index)
    return out, _sent(v, q, scale)


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


# ------------------------------------------------------------------ the tree


def tree_hop_widths(n_elems: int, sizes: Tuple[int, ...], pad_multiple: int = 0) -> Tuple[int, ...]:
    """The elements a participant carries across each hop of the tree,
    outermost first: ``widths[-1]`` the whole padded vector, ``widths[0]``
    the top chunk that crosses the slowest link. The vector is padded to a
    multiple of the inner levels' product, or of ``pad_multiple`` (ZeRO-1
    pads to the whole rank count), which must be a multiple of it. The
    residuals' lengths (hops 0..k-1) and the bytes a step come from here."""
    inner = 1
    for s in sizes[1:]:
        inner *= s
    m = max(int(pad_multiple), inner)
    if m % inner:
        raise ValueError(f"pad_multiple {pad_multiple} not a multiple of {inner}")
    padded = -(-n_elems // m) * m
    widths = []
    div = 1
    for s in reversed(sizes[1:]):
        widths.append(padded // div)
        div *= s
    widths.append(padded // div)
    return tuple(reversed(widths))


def tree_hop_bytes(n_elems: int, sizes: Tuple[int, ...],
                   wires: Tuple[str, ...]) -> Tuple[Tuple[int, float], ...]:
    """The bytes a participant moves a combine on each hop of the tree, as
    ``(level, bytes)`` pairs from the innermost hop out (the JAX package's
    accounting, without ZeRO-1's padding): the innermost reduce-scatter and
    all-gather carry the whole vector at f32 twice, each middle hop its
    vector on its wire up and at f32 down, and the last pair, level 0, is
    the top chunk on the outermost wire (the one that crosses hosts)."""
    widths = tree_hop_widths(n_elems, sizes)
    hops = [(len(sizes) - 1, 2.0 * n_elems * 4)]
    for i in range(1, len(sizes) - 1):
        hops.append((i, widths[i] * (wire_payload_bytes(wires[i], sizes[i]) + 4)))
    hops.append((0, float(widths[0] * wire_payload_bytes(wires[0], sizes[0]))))
    return tuple(hops)


# Modeled quantize and dequantize memory passes a wire, priced at the fastest
# level's rate; int4 carries an accuracy tax on top of its two passes (its
# rounding is biased), so it wins only on a link about 20x slower than the
# fastest (int8 needs about 6x to beat fp32).
_WIRE_COST_PASSES = {"fp32": 0.0, "int8": 3.0, "int4": 8.0}


def choose_wires(sizes: Tuple[int, ...], level_bytes_per_s) -> Tuple[str, ...]:
    """Each hop's wire from the measured level rates (outermost first):
    hop ``i`` costs ``payload_bytes(wire, sizes[i]) / rate_i + passes(wire)
    * 4 / rate_ref`` an element, the cheapest wins (ties toward less
    compression). The innermost hop is always fp32, and so is a hop whose
    rate was not measured. The same rates give the same wires on every
    rank."""
    rates = [float(r) if r and float(r) > 0 else 0.0 for r in level_bytes_per_s]
    if len(rates) != len(sizes):
        raise ValueError("one measured rate per level")
    r_ref = max(rates) if rates else 0.0
    out = []
    for i, (s, r) in enumerate(zip(sizes, rates)):
        if i == len(sizes) - 1 or r <= 0.0 or r_ref <= 0.0:
            out.append("fp32")
            continue
        out.append(min(WIRE_FORMATS, key=lambda w: wire_payload_bytes(w, s) / r
                       + _WIRE_COST_PASSES[w] * 4.0 / r_ref))
    return tuple(out)


def tree_allreduce(flat: torch.Tensor, key: Key, axes: Sequence, wires: Sequence[str],
                   residuals: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The N-level combine spine (the JAX ``tree_allreduce``) of this rank's
    f32 vector ``flat`` (laid out as the JAX package's ravel) over ``axes``,
    this rank's sub-axis of each level, outermost first
    (``DataMesh.tree_axes``); ``wires[i]`` is hop ``i``'s codec, the
    innermost ``"fp32"``. The vector is padded to a multiple of the inner
    levels' product; up: an exact reduce-scatter over the innermost level,
    an error-fed compressed reduce-scatter a middle level, a compressed
    all-reduce over the outermost one; down: all-gathers over levels 1..k.
    ``residuals``: None or one vector a hop 0..k-1 (``tree_hop_widths``).
    Returns the summed vector (``flat``'s length) and the new residuals
    (zero on fp32 hops); hop ``i`` dithers with ``fold_in(key, i)``."""
    k = len(axes) - 1
    if k < 1 or len(wires) != k + 1:
        raise ValueError("tree_allreduce needs >= 2 aligned levels")
    if wires[-1] != "fp32":
        raise ValueError(f"innermost hop must ride the fp32 wire, got {wires[-1]!r} "
                         "(residuals exist only for hops 0..k-1)")
    t_real = flat.numel()
    inner = 1
    for a in axes[1:]:
        inner *= a.size
    padded = -(-t_real // inner) * inner
    v = torch.zeros(padded, dtype=torch.float32, device=flat.device)
    v[:t_real] = flat
    v = axes[k].reduce_scatter(torch.empty(padded // axes[k].size, device=flat.device), v)
    total, new_res = tree_up(v, key, axes, wires, residuals)
    out = total
    for a in axes[1:]:  # down: the gathers invert the scatters
        out = a.all_gather(torch.empty(out.numel() * a.size, device=out.device), out)
    return out[:t_real], new_res


def tree_up(v: torch.Tensor, key: Key, axes: Sequence, wires: Sequence[str],
            residuals: Optional[Sequence[torch.Tensor]] = None):
    """The tree's hops above the innermost: ``v`` (this rank's block after
    the innermost reduce-scatter) through an error-fed compressed
    reduce-scatter a middle level (innermost first), then a compressed
    all-reduce over the outermost level, each error-fed by its residual.
    Returns the summed top chunk and the new residual of each hop 0..k-1
    (:func:`ef_residual`)."""
    k = len(axes) - 1
    new_res: List[Optional[torch.Tensor]] = [None] * k
    summed = scale = None  # the last hop's codes' sum and scale (None after an fp32 hop)
    for i in range(k - 1, -1, -1):  # the middle hops scatter, the outermost reduces
        r = None if residuals is None else residuals[i]
        vi = _add_residual(v, summed, scale, r)
        prev = summed, scale
        v, q, scale, summed = _hop(vi, fold_in(key, i), axes[i], axes[i].size, wires[i],
                                   scatter=i > 0)
        if r is None and prev[0] is not None and q is not None:
            # XLA recomputes the input (the last hop's sum times its scale)
            # inside the residual's fusion and rounds it once with the
            # subtraction of the rounded ``q * scale``
            new_res[i] = (prev[0].double() * prev[1].double()
                          - (q * scale).double()).to(torch.float32)
        else:
            new_res[i] = ef_residual(vi, q, scale)
    return v, new_res


def hier_tree_allreduce(flat: torch.Tensor, key: Key, host_axis, device_axis, wire: str,
                        residual: Optional[torch.Tensor] = None):
    """The two-level combine (the JAX ``hier_tree_allreduce``): an fp32
    in-host reduce-scatter, one compressed cross-host hop, the in-host
    all-gather. Returns ``(summed vector, new residual)``."""
    out, res = tree_allreduce(flat, key, (host_axis, device_axis), (wire, "fp32"),
                              None if residual is None else (residual,))
    return out, res[0]
