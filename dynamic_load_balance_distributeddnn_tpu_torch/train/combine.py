"""The gradient combine across ranks (the JAX package's ``combine_update``,
``_compressed_psum``, ``_zero1_update`` and their probe twins,
``train/steps.py``).

A rank's workers add their weighted gradients into ``.grad``; the combine
then sums ``.grad`` over the ranks and applies SGD-momentum, the JAX
``combine_update`` with its stacked sum replaced by one collective.

**One flat buffer.** :class:`FlatGrads` makes every parameter's ``.grad`` a
view into one flat f32 buffer: the leaves in JAX's ``tree_flatten`` order of
the flax tree (``bridge.flax_leaf_order``), each raveled in its parameter's
memory layout (``as_strided`` with the parameter's strides, so a
channels-last kernel's gradient keeps the parameter's layout), padded with
zeros to a multiple of the rank count (``train/state.py``
``zero1_padded_size``). The backward accumulates into the views in place,
the collective runs once over the whole buffer (not once a leaf), and the
addresses never move, so a captured step graph writes ``.grad`` where the
collective reads it.

**The JAX package's step.** The JAX package ravels each leaf in flax's
layout (``HWIO`` kernels, ``[in, out]`` dense ones), the port's buffer in
torch's (``OIHW`` or channels-last, ``[out, in]``). The int8 wire's dither
is a function of an element's index, so the buffer carries each element's
position in the JAX package's ravel (``FlatGrads.index``, from
``bridge.flax_index``) and the dither is drawn at that position: on the same
gradients and keys each element gets the JAX package's code, and the
combine's result is the JAX package's, element for element. Every other
step of the combines is elementwise or a sum over ranks, so the layout
changes nothing else. ZeRO-1's chunks are the buffer's 1/n blocks, so a
rank's chunk holds other elements than the JAX device's of the same index;
the gathered trace, and so the parameters, are the same.

**The three combines** (:meth:`RankCombine.step`):

- the sum: one all-reduce of the buffer, then ``optimizer.step()``;
- ``--compress_grads int8`` (the JAX ``_compressed_psum``): each leaf on the
  int8 wire with its own shared scale and its key ``fold_in(rng, i +
  0x7FFF)``, ``i`` its leaf index, the leaves batched into two collectives
  (``parallel/wire.py`` ``compressed_reduce_leaves``), then
  ``optimizer.step()``;
- ``--shard_update`` (ZeRO-1, the JAX ``_zero1_update`` on a flat mesh): a
  reduce-scatter of the buffer (on the int8 wire under ``--compress_grads``,
  key ``fold_in(rng, 0x2E01)``) into this rank's 1/n chunk, the momentum
  update on the chunk (``trace = momentum * trace + g``, torch's own
  ``mul_``/``add_``), an all-gather of the chunks' new trace, and each
  parameter's ``add_(trace, alpha=-lr)``: the replicated
  ``optimizer.step()``'s ops on the same values, so the two agree bit for
  bit whenever the summed gradient does (two ranks: one addition either
  way). The gathered quantity is the update up to its ``-lr`` (the JAX
  package gathers the update itself), the same bytes.

**The tree** (``--grad_comm hier``, the JAX ``_hier_combine`` and the hier
branch of ``_zero1_update``): the buffer is permuted into the JAX
package's ravel order (one gather by the inverse of ``FlatGrads.index``),
summed up and down the topology tree (``parallel/wire.py``
``tree_allreduce`` over the sub-axes of ``DataMesh.tree_axes``, one
error-feedback residual a hop 0..k-1, zero on fp32 hops, as the JAX
``attach_comm_residual`` lays them out) and permuted back (one gather by
``FlatGrads.index``). In that order a rank holds, after each
reduce-scatter, the chunk the JAX device of its coordinates holds, so each
hop's shared scale and each element's dither index are the JAX package's
and the sums, the residuals and the update are its own, bit for bit,
wherever the per-hop sums are exact (integer codes; two f32 terms). Under
``--shard_update`` the momentum chunk is the JAX one, in that order: the
top hop's sum re-split across the outermost level, the trace gathered back
outermost level first, then permuted to the buffer's layout and applied
with torch SGD's op, as the flat ZeRO-1 does.

Each combine is timed on the host from a device synchronize to the end of
its collectives (``collective_s``): under gloo the collectives block the
host, staged through pinned memory (``parallel/mesh.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.bridge import flax_index, flax_leaf_order
from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire as wirefmt
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import Key, fold_in, fold_in_many
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import (
    shard_optimizer_state,
    zero1_padded_size,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import combine_probe


class FlatGrads:
    """Every parameter's ``.grad`` a view into one flat buffer (module
    docstring): ``model``'s parameters in the flat order (``order``).
    With ``flax_layout``, ``index`` is each buffer element's position in
    the JAX package's ``ravel_pytree`` of the flax tree (int64; the padding
    keeps its own positions): the dither index of the int8 wire."""

    def __init__(self, model: torch.nn.Module, n_shards: int, flax_layout: bool = False):
        named = dict(model.named_parameters())
        self.order = flax_leaf_order(model)
        self.params = [named[k] for k in self.order]
        for p in self.params:
            if not (p.is_contiguous() or p.is_contiguous(memory_format=torch.channels_last)):
                raise ValueError(f"a parameter of shape {tuple(p.shape)} is not dense")
        self.sizes = [p.numel() for p in self.params]
        self.total = sum(self.sizes)
        self.padded = zero1_padded_size(self.params, n_shards)
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]
        dev = self.params[0].device
        self.flat = torch.zeros(self.padded, dtype=torch.float32, device=dev)
        for p, g in zip(self.params, self.views(self.flat)):
            p.grad = g
        self.index: Optional[torch.Tensor] = None
        if flax_layout:
            index = torch.arange(self.padded, dtype=torch.int64)
            for name, off, v in zip(self.order, self.offsets, self.views(index)):
                v.copy_(flax_index(model, name) + off)
            self.index = index.to(dev)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's view of a flat buffer laid out as this one."""
        return [torch.as_strided(buf, p.shape, p.stride(), off)
                for p, off in zip(self.params, self.offsets)]

    def ravel(self, tensors: Sequence[torch.Tensor], out: Optional[torch.Tensor] = None):
        """A flat buffer holding ``tensors`` (one a parameter, flat order)."""
        out = torch.zeros_like(self.flat) if out is None else out
        for v, t in zip(self.views(out), tensors):
            v.copy_(t)
        return out


def apply_trace(params: Sequence[torch.Tensor], traces: Sequence[torch.Tensor], lr: float) -> None:
    """``p += -lr * trace`` with the op torch's SGD applies its momentum
    buffer with: ``_foreach_add_`` on the card, ``add_`` a tensor on the
    CPU (its default single-tensor loop)."""
    with torch.no_grad():
        if params[0].is_cuda:
            torch._foreach_add_(list(params), list(traces), alpha=-lr)
        else:
            for p, t in zip(params, traces):
                p.add_(t, alpha=-lr)


class RankCombine:
    """The combine of one rank (module docstring). ``mesh`` is the data
    axis (``parallel/mesh.py``; size 1 without a process group); ``tree``
    the topology tree's ``(names, sizes)`` and ``wires`` its hops' codecs
    under ``--grad_comm hier``."""

    def __init__(self, mesh, model: torch.nn.Module, optimizer: torch.optim.SGD,
                 momentum: float, shard_update: bool = False, compress: str = "",
                 tree: Optional[Tuple[Sequence[str], Sequence[int]]] = None,
                 wires: Sequence[str] = ()):
        self.mesh, self.optimizer = mesh, optimizer
        self.n = mesh.size
        self.momentum = float(momentum)
        self.shard_update, self.compress = bool(shard_update), compress
        self.grads = FlatGrads(model, self.n, flax_layout=compress == "int8" or tree is not None)
        self.order, self.params = self.grads.order, self.grads.params
        self.collective_s: List[float] = []  # each combine's collective wall
        self.axes = None
        if tree is not None:
            self._init_tree(*tree, wires)
        if self.shard_update:
            self.chunk = self.grads.padded // self.n
            self.mom = shard_optimizer_state(optimizer, self.params, self.n, mesh.rank)
            if self.axes is not None:  # the JAX chunk: this rank's block of the permuted vector
                full = self.mesh.all_gather(torch.empty_like(self.grads.flat), self.mom)
                self.mom = self._to_jax(full, padded=True)[self.off:self.off + self.chunk].clone()
            for group in optimizer.param_groups:
                # the trace lives in the chunk: no full buffer is made again
                # (prepare_step_state) and optimizer.step() is never called
                group["momentum"] = 0.0
            self.g_chunk = torch.zeros_like(self.mom)
            self.trace = torch.zeros_like(self.grads.flat)
            self.trace_views = self.grads.views(self.trace)

    def _init_tree(self, names: Sequence[str], sizes: Sequence[int], wires: Sequence[str]) -> None:
        """The tree's sub-axes, the permutation into the JAX ravel order
        (``perm``: for each JAX position, its buffer element), zero
        residuals and, under ZeRO-1, this rank's chunk offset in that order
        (the JAX ``_zero1_update``'s mixed-radix ``off``)."""
        self.tree = (tuple(names), tuple(int(s) for s in sizes))
        self.wires = tuple(wires)
        if len(self.wires) != len(self.tree[0]) or self.wires[-1] != "fp32":
            raise ValueError(f"wires {self.wires} for levels {self.tree}: one a level, "
                             "the innermost fp32")
        self.axes = self.mesh.tree_axes(*self.tree)
        t, index = self.grads.total, self.grads.index
        self.perm = torch.empty(t, dtype=torch.int64, device=index.device)
        self.perm[index[:t]] = torch.arange(t, device=index.device)
        widths = wirefmt.tree_hop_widths(t, self.tree[1], self.n if self.shard_update else 0)
        if self.shard_update and widths[-1] != self.grads.padded:
            raise ValueError(f"the tree pads to {widths[-1]}, ZeRO-1 to {self.grads.padded}")
        self.residuals = [torch.zeros(w, dtype=torch.float32, device=self.grads.flat.device)
                          for w in widths[:-1]]
        chunk = self.grads.padded // self.n
        self.off = self.axes[0].rank * chunk + sum(a.rank * w for a, w in zip(self.axes[1:], widths))

    def _to_jax(self, buf: torch.Tensor, padded: bool = False) -> torch.Tensor:
        """The buffer's real elements in the JAX ravel order (``padded``:
        followed by the buffer's zero padding)."""
        t = self.grads.total
        vec = buf[:t][self.perm]
        return torch.cat([vec, buf.new_zeros(buf.numel() - t)]) if padded else vec

    def _from_jax(self, vec: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
        """``vec`` (the JAX ravel order) written into ``buf``'s layout."""
        t = self.grads.total
        buf[:t] = vec[self.grads.index[:t]]
        return buf

    def describe(self) -> Dict[str, object]:
        out = {"flat_elems": self.grads.total, "padded_elems": self.grads.padded,
               "leaves": len(self.params), "shard_update": self.shard_update,
               "compress_grads": self.compress}
        if self.shard_update:
            out["momentum_chunk_elems"] = int(self.mom.numel())
        if self.axes is not None:
            out.update(grad_comm="hier", levels=[[a, s] for a, s in zip(*self.tree)],
                       wires=list(self.wires), residual_elems=[r.numel() for r in self.residuals],
                       groups=[list(a.ranks) for a in self.axes])
        return out

    def momentum_by_name(self) -> Dict[str, torch.Tensor]:
        """ZeRO-1's momentum as each parameter's buffer, for a checkpoint:
        the chunks of every rank gathered into the buffer's layout (on the
        tree from the JAX order), views of one flat tensor. A collective
        across ranks: every rank calls it."""
        if not self.shard_update:
            raise ValueError("the momentum lives in the optimizer without --shard_update")
        if self.n == 1:
            full = self.mom
        elif self.axes is not None:
            full = self._from_jax(self._tree_gather(self.mom), torch.zeros_like(self.trace))
        else:
            full = self.mesh.all_gather(torch.empty_like(self.trace), self.mom)
        return dict(zip(self.order, self.grads.views(full)))

    @torch.no_grad()
    def load_momentum(self, by_name: Dict[str, torch.Tensor]) -> None:
        """This rank's chunk, in place, from a checkpoint's momentum by
        parameter name (:meth:`momentum_by_name`'s inverse): the buffer's
        1/n block, or on the tree the block at ``off`` of the JAX order."""
        full = self.grads.ravel([by_name[k].to(self.grads.flat.device) for k in self.order])
        if self.axes is not None:
            chunk = self._to_jax(full, padded=True)[self.off:self.off + self.chunk]
        else:
            r = self.mesh.rank
            chunk = full[r * self.chunk:(r + 1) * self.chunk]
        self.mom.copy_(chunk)

    def residual_rows(self) -> List[torch.Tensor]:
        """The error-feedback residuals of every rank, one ``[n, width]``
        tensor a hop (row ``i`` rank ``i``'s, as the JAX ``comm_residual``
        keeps one row a device). A collective: every rank calls it."""
        return [self.mesh.all_gather(torch.empty(self.n * r.numel(), device=r.device), r)
                .view(self.n, -1) for r in self.residuals]

    def load_residual_rows(self, rows: Sequence[torch.Tensor], row: Optional[int] = None) -> None:
        """This rank's residuals from :meth:`residual_rows`' tensors: row
        ``row`` of each (default this rank's; the elastic tier across
        processes picks the row of the process's original ident)."""
        row = self.mesh.rank if row is None else row
        if len(rows) != len(self.residuals) or any(
                tuple(t.shape) != (self.n, r.numel()) for t, r in zip(rows, self.residuals)):
            raise ValueError(f"residual rows {[tuple(t.shape) for t in rows]} do not fit "
                             f"{self.n} ranks of {[r.numel() for r in self.residuals]}")
        self.residuals = [t[row].to(r.device, r.dtype).clone()
                          for t, r in zip(rows, self.residuals)]

    # ---------------------------------------------------------------- step

    def _sync(self) -> None:
        if self.grads.flat.is_cuda:
            torch.cuda.synchronize(self.grads.flat.device)

    def step(self, lr: float, key: Key) -> None:
        """The combine and update of one step, in place; ``key`` is the
        JAX ``rng`` the compressed wire and ZeRO-1 fold their keys from."""
        self._sync()
        t0 = time.perf_counter()
        flat = self.grads.flat
        if self.axes is not None:
            self._tree_step(flat, lr, key, t0)
            return
        if self.shard_update:
            g = self._scatter(flat, key, self.g_chunk)
            self._sync()
            self.collective_s.append(time.perf_counter() - t0)
            with torch.no_grad():
                self.mom.mul_(self.momentum).add_(g)
            t1 = time.perf_counter()
            self.mesh.all_gather(self.trace, self.mom)
            self._sync()
            self.collective_s[-1] += time.perf_counter() - t1
            apply_trace(self.params, self.trace_views, lr)
            return
        if self.compress == "int8":
            flat.copy_(self._compressed(flat, key))
        else:
            self.mesh.all_reduce_(flat)
        self._sync()
        self.collective_s.append(time.perf_counter() - t0)
        self.optimizer.step()

    def _tree_step(self, flat: torch.Tensor, lr: float, key: Key, t0: float) -> None:
        """The hier combine and update (the JAX ``_hier_combine`` and the
        replicated update, or the hier branch of ``_zero1_update``), the
        residuals carried to the next step."""
        if self.shard_update:
            g, self.residuals = self._tree_scatter(flat, key, self.residuals)
            self._sync()
            self.collective_s.append(time.perf_counter() - t0)
            with torch.no_grad():
                self.mom.mul_(self.momentum).add_(g)
            t1 = time.perf_counter()
            self._from_jax(self._tree_gather(self.mom), self.trace)
            self._sync()
            self.collective_s[-1] += time.perf_counter() - t1
            apply_trace(self.params, self.trace_views, lr)
            return
        out, self.residuals = wirefmt.tree_allreduce(self._to_jax(flat), key, self.axes, self.wires,
                                                     self.residuals)
        self._from_jax(out, flat)
        self._sync()
        self.collective_s.append(time.perf_counter() - t0)
        self.optimizer.step()

    def _tree_scatter(self, flat: torch.Tensor, key: Key, residuals):
        """ZeRO-1's gradient collective on the tree (the hier branch of the
        JAX ``_zero1_update``): this rank's chunk of the summed gradient
        and the new residuals, key ``fold_in(key, 0x2E01)`` folded by hop."""
        a = self.axes[-1]
        v = a.reduce_scatter(torch.empty(self.grads.padded // a.size, device=flat.device),
                             self._to_jax(flat, padded=True))
        total, new = wirefmt.tree_up(v, fold_in(key, 0x2E01), self.axes, self.wires, residuals)
        r0 = self.axes[0].rank
        return total[r0 * self.chunk:(r0 + 1) * self.chunk], new

    def _tree_gather(self, chunk: torch.Tensor) -> torch.Tensor:
        """The chunks gathered back in the JAX order, the outermost level
        first: the whole padded vector."""
        out = chunk
        for a in self.axes:
            out = a.all_gather(torch.empty(out.numel() * a.size, device=out.device), out)
        return out

    def _compressed(self, flat: torch.Tensor, key: Key) -> torch.Tensor:
        keys = fold_in_many(key, [i + 0x7FFF for i in range(len(self.params))])
        return wirefmt.compressed_reduce_leaves(flat, self.grads.sizes, keys, self.mesh, self.n,
                                                index=self.grads.index)

    def _scatter(self, flat: torch.Tensor, key: Key, out: torch.Tensor) -> torch.Tensor:
        if self.compress == "int8":
            return wirefmt.compressed_reduce_scatter(flat, fold_in(key, 0x2E01), self.mesh,
                                                     self.n, "int8", self.grads.index)
        return self.mesh.reduce_scatter(out, flat)

    # -------------------------------------------------------------- probes

    @torch.no_grad()
    def probe(self, flat: torch.Tensor, lr: float, with_comm: bool = True):
        """The combine's twin on a flat gradient buffer of its own: the same
        collectives (``with_comm``) and update math, into new tensors; the
        parameters, ``.grad`` and the momentum are not written."""
        key = (0, 0)  # the result is discarded: any key
        if self.axes is not None:
            return self._tree_probe(flat, lr, key, with_comm)
        if self.shard_update:
            if with_comm:
                g = self._scatter(flat, key, torch.empty_like(self.g_chunk))
            else:
                r = self.mesh.rank
                g = flat[r * self.chunk:(r + 1) * self.chunk]
            mom = self.mom * self.momentum + g
            trace = torch.zeros_like(self.trace)
            if with_comm:
                self.mesh.all_gather(trace, mom)
            else:
                trace[self.mesh.rank * self.chunk:(self.mesh.rank + 1) * self.chunk] = mom
            return torch._foreach_add(self.params, self.grads.views(trace), alpha=-lr)
        total = flat.clone()
        if with_comm:
            if self.compress == "int8":
                total = self._compressed(total, key)
            else:
                self.mesh.all_reduce_(total)
        return combine_probe(self.optimizer, [self.grads.views(total)], params=self.params)

    def _tree_probe(self, flat: torch.Tensor, lr: float, key: Key, with_comm: bool):
        """The hier combine's twin: the residuals are read, not written."""
        if self.shard_update:
            if with_comm:
                g, _ = self._tree_scatter(flat, key, self.residuals)
            else:
                g = self._to_jax(flat, padded=True)[self.off:self.off + self.chunk]
            mom = self.mom * self.momentum + g
            if with_comm:
                vec = self._tree_gather(mom)
            else:
                vec = torch.zeros_like(self.trace)
                vec[self.off:self.off + self.chunk] = mom
            trace = self._from_jax(vec, torch.zeros_like(self.trace))
            return torch._foreach_add(self.params, self.grads.views(trace), alpha=-lr)
        total = flat.clone()
        if with_comm:
            out, _ = wirefmt.tree_allreduce(self._to_jax(flat), key, self.axes, self.wires,
                                            self.residuals)
            self._from_jax(out, total)
        return combine_probe(self.optimizer, [self.grads.views(total)], params=self.params)

    def probe_psum(self) -> None:
        """The standalone gradient collective: a sum of a zero buffer (the
        JAX ``comm_probe``)."""
        self.mesh.all_reduce_(torch.zeros_like(self.grads.flat))
