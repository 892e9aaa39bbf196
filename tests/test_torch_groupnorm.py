"""K1 (GroupNorm + relu) on the CPU: the tiled route's launch plan, and the
plain version against the JAX package's Pallas kernel at DenseNet widths.

``plan`` is pure Python, so its guarantees are checked here for every
GroupNorm shape of DenseNet-121 at the vision path's batches and for the
card tests' shapes: each channel covered once by whole groups, 16-byte tile
rows, shared memory and cluster within the H100's limits, each row of each
slab given to exactly one block, and no block without rows. tests/test_torch_cuda.py holds the kernels themselves to the plain
version on a card.

Tolerances, as in tests/test_pallas.py: forward atol 1e-4 (f32 statistics,
different reduction order), gradients atol 5e-4; bf16 atol 3e-2 (inputs
and outputs rounded to 8 significant bits on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.ops.pallas import fused_group_norm
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import (
    DenseNet,
    DenseNet121,
    gn_shapes,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import bound, gn_work
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
    MAX_CLUSTER,
    MAX_THREADS,
    general_plan,
    group_norm,
    group_norm_bwd_ref,
    group_norm_ref,
    group_norm_stats_ref,
    plan,
    tiled_plan,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

DENSENET121 = (6, 12, 24, 16)
# the card tests' shapes (tests/test_torch_cuda.py), and S = 999 / 1000,
# which a cluster's ranks split unevenly / evenly
OTHER_SHAPES = [
    ((4, 64, 64), 32), ((2, 16, 96), 32), ((3, 10, 24), 8), ((2, 9, 300), 1),
    ((2, 1000, 96), 32), ((2, 999, 160), 32), ((2, 1024, 64), 32), ((3, 16, 128), 32),
    ((2, 1, 1024), 32), ((4, 64, 992), 32), ((2, 32, 512), 32), ((4, 256, 128), 32),
    ((3, 10, 18), 6), ((8, 64, 992), 32), ((32, 16, 1024), 32), ((4, 1024, 64), 32),
    ((300, 16, 1024), 32), ((16, 64, 512), 32),
]
SMEM_LIMIT = 227 * 1024


def _assert_plan_holds(b, s, c, groups, dtype, backward):
    """The guarantees of a plan for ``[b, s, c]``; returns it."""
    p = plan(b, s, c, groups, dtype, backward)
    cg = c // groups
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if p.route == "general":
        assert p == general_plan(s, cg, backward)
        return p
    assert p.route == "tiled"
    # whole groups, tiles covering each channel exactly once
    assert p.tile % cg == 0 and c % p.tile == 0
    covered = np.zeros(c, dtype=int)
    for t in range(c // p.tile):
        covered[t * p.tile:(t + 1) * p.tile] += 1
    assert (covered == 1).all()
    # 16-byte rows: the tile and C whole vectors (then every tile starts on
    # a vector); at least 128 bytes a tile row where C allows
    elem = 16 // vec
    assert c % vec == 0 and p.tile % vec == 0
    assert p.tile * elem >= 128 or p.tile == c
    nvec = p.tile // vec
    assert p.vpad >= nvec and p.vpad & (p.vpad - 1) == 0 and p.vpad < 2 * nvec
    # the cluster splits S into whole rows, every rank with at least one
    assert 1 <= p.cluster <= MAX_CLUSTER and p.cluster & (p.cluster - 1) == 0
    assert p.rows * p.cluster >= s and (p.cluster - 1) * p.rows < s
    # threads: whole warps, whole tile rows, within the kernel's bound
    assert p.threads % 32 == 0 and p.threads % p.vpad == 0 and p.threads <= MAX_THREADS
    # shared memory: the staged rows (x, and dy backward) and the sums
    parts = p.threads // max(p.vpad, 32)
    staged = p.rows * p.tile * elem * (2 if backward else 1)
    assert p.smem == staged + 4 * (2 * parts * p.tile + 4 * p.tile + 2 * (p.tile // cg))
    assert p.smem <= SMEM_LIMIT
    # the kernel's grid (C / tile * cluster, B) gives block x the tile
    # x // cluster and the rows [rank * rows, (rank + 1) * rows) of S, rank
    # = x % cluster: every block gets rows, and each (tile, row) of a batch
    # element falls to exactly one block
    owners = np.zeros((c // p.tile, s), dtype=int)
    for x in range((c // p.tile) * p.cluster):
        tile, rank = divmod(x, p.cluster)
        s0 = rank * p.rows
        assert s0 < s, (x, p)
        owners[tile, s0:min(s0 + p.rows, s)] += 1
    assert (owners == 1).all()
    return p


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 32, 128, 160])
def test_plan_holds_for_every_densenet121_call(b, dtype, backward):
    """All 120 GroupNorm calls of DenseNet-121 take the tiled route, under
    its guarantees."""
    shapes = gn_shapes(b, DENSENET121, 32)
    assert len(shapes) == 120
    for bb, s, c in shapes:
        assert _assert_plan_holds(bb, s, c, 32, dtype, backward).route == "tiled", (s, c)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", OTHER_SHAPES)
def test_plan_holds_for_other_shapes(shape, groups, dtype, backward):
    _assert_plan_holds(*shape, groups, dtype, backward)


@pytest.mark.parametrize("c,groups", [(18, 6), (30, 3), (6, 2), (300, 1), (12, 4)])
def test_plan_takes_the_general_route_where_rows_are_not_16_byte_vectors(c, groups):
    """C % 4 != 0 (f32) or C % 8 != 0 (bf16): no tile row is whole
    16-byte vectors."""
    for dtype, vec in ((torch.float32, 4), (torch.bfloat16, 8)):
        for backward in (False, True):
            p = plan(2, 16, c, groups, dtype, backward)
            assert (p.route == "general") == (c % vec != 0), (c, dtype, p)


def test_plan_takes_the_general_route_where_a_slab_does_not_fit_a_cluster():
    # 16,384 rows of a 32-channel tile: 2 MB f32, 256 KB a block at 8 blocks
    assert plan(2, 16384, 64, 32).route == "general"
    assert plan(2, 16384, 64, 32, torch.float32, True).route == "general"
    assert plan(2, 4096, 64, 32).route == "tiled"


def test_plan_splits_s_over_a_cluster_where_slabs_are_large():
    big = plan(128, 1024, 64, 32)  # a 128 KB slab
    assert big.route == "tiled" and big.cluster == 2 and big.rows == 512
    assert plan(128, 1024, 64, 32, torch.float32, True).cluster == 4  # x and dy: 256 KB
    assert plan(1, 256, 64, 32).cluster == 1  # a 32 KB slab, however few the slabs
    assert plan(2, 1, 1024, 32).cluster == 1  # one row: nothing to split


def test_plan_sizes_blocks_by_their_rows():
    """Two threads a staged row, from 64 to 256, never more than the slab's
    16-byte vectors."""
    assert plan(128, 1024, 64, 32).threads == 256  # 512 rows a cluster rank
    assert plan(128, 64, 512, 32).threads == 128
    assert plan(128, 16, 1024, 32).threads == 64
    assert plan(2, 1, 1024, 32).threads == 32  # one row of 8 vectors: one warp


def test_tiled_plan_is_plans_geometry():
    """``plan`` is ``tiled_plan`` at the tile, cluster and block size it
    picks; a forced launch keeps the block within the slab's vectors and at
    least one warp and one tile row."""
    for shape, dtype, backward in (((128, 1024, 64), torch.float32, True),
                                   ((3, 16, 128), torch.bfloat16, False),
                                   ((16, 64, 512), torch.float32, False)):
        p = plan(*shape, 32, dtype, backward)
        assert tiled_plan(shape[1], p.tile, shape[2] // 32, p.cluster, p.threads, dtype,
                          backward) == p
    assert tiled_plan(64, 32, 2, 1, 512, torch.float32, False).threads == 512
    assert tiled_plan(16, 32, 4, 8, 256, torch.float32, False).threads == 32  # 2 rows x 8 vectors
    forced = tiled_plan(16, 512, 16, 1, 64, torch.float32, True)  # a 128-vector row
    assert forced.threads == 128 and forced.vpad == 128 and forced.rows == 16


def test_densenet_gn_shapes_match_the_model():
    """``gn_shapes`` gives the GroupNorm calls a forward makes, in order."""
    for model, b, image, blocks in ((DenseNet((2, 2), growth_rate=32, image_size=16), 2, 16, (2, 2)),
                                    (DenseNet121(), 1, 32, DENSENET121)):
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append((i[0].shape[0], i[0].shape[2] * i[0].shape[3], i[0].shape[1])))
            for m in model.modules() if isinstance(m, GroupNorm)]
        with torch.no_grad():
            model(torch.zeros(b, image, image, 3))
        for h in hooks:
            h.remove()
        assert seen == gn_shapes(b, blocks, 32, image_size=image)


def test_gn_work_counts_each_byte_once():
    work = gn_work([(2, 16, 64), (1, 4, 32)], groups=32)
    n = 2 * 16 * 64 + 4 * 32
    params, stats = 2 * 4 * (64 + 32), 2 * 4 * 32 * 3
    assert work["groupnorm_fwd"] == (2 * 4 * n + params + stats, 6 * n)
    assert work["groupnorm_bwd"] == (3 * 4 * n + 2 * params + stats, 16 * n)
    assert gn_work([(2, 16, 64)], elem=2)["groupnorm_fwd"][0] == 2 * 2 * 2048 + 2 * 4 * 64 + 2 * 4 * 64
    # the bound of one DenseNet-121 worker pass at b = 128, f32
    ms, by = bound(*gn_work(gn_shapes(128, DENSENET121, 32))["groupnorm_fwd"])
    assert by == "bytes" and 1.48 < ms < 1.49


def _gn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32), (1 + 0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32), rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 4, 1024), (2, 64, 128)])
def test_group_norm_matches_pallas_at_densenet_widths(shape, dtype):
    """``group_norm`` on the CPU (the plain version) against the JAX
    package's ``fused_group_norm`` (its Pallas kernel, interpret mode on the
    CPU), G = 32, relu on: y and the gradients of sum(y * dy)."""
    x, s, b, dy = _gn_inputs(shape, 3)
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    fwd_tol, grad_tol = (1e-4, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    xj = jnp.asarray(x).astype(jdt)[:, None]  # [B, 1, S, C]: NHWC with H = 1
    want_y = fused_group_norm(xj, jnp.asarray(s), jnp.asarray(b), 32, relu=True)

    def loss(xx, ss, bb):
        y = fused_group_norm(xx, ss, bb, 32, relu=True).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(dy)[:, None])

    import jax

    want = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(s), jnp.asarray(b))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st, bt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = group_norm(xt, st, bt, 32, relu=True)
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y.astype(jnp.float32))[:, 0], atol=fwd_tol, rtol=0)
    for got, ref in zip((xt.grad, st.grad, bt.grad), want):
        ref = np.asarray(ref.astype(jnp.float32)).reshape(got.shape)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=grad_tol, rtol=1e-4)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 16, 64), 32), ((3, 10, 24), 8), ((2, 9, 30), 3)])
def test_group_norm_bwd_ref_is_the_gradient_of_group_norm_ref(shape, groups, relu):
    """The plain backward from the plain statistics equals autograd through
    the plain forward (f32, atol 1e-5: the same sums in another order)."""
    x, s, b, dy = (torch.from_numpy(a) for a in _gn_inputs(shape, 4))
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    want = torch.autograd.grad(group_norm_ref(xr, sr, br, groups, 1e-6, relu), (xr, sr, br), dy)
    mean, rstd = group_norm_stats_ref(x, groups, 1e-6)
    got = group_norm_bwd_ref(x, dy, s, b, mean, rstd, groups, relu)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 4, 1024), (2, 64, 128)])
def test_group_norm_bwd_ref_matches_pallas_at_densenet_widths(shape):
    """The plain backward, from the plain statistics, against the JAX
    package's ``fused_group_norm`` gradients (its custom VJP), G = 32, relu
    on, f32: dx, dscale and dbias of sum(y * dy), gradients atol 5e-4."""
    import jax

    x, s, b, dy = _gn_inputs(shape, 5)
    xj = jnp.asarray(x)[:, None]

    def loss(xx, ss, bb):
        return jnp.sum(fused_group_norm(xx, ss, bb, 32, relu=True) * jnp.asarray(dy)[:, None])

    want = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(s), jnp.asarray(b))
    xt = torch.from_numpy(x)
    mean, rstd = group_norm_stats_ref(xt, 32, 1e-6)
    got = group_norm_bwd_ref(xt, torch.from_numpy(dy), torch.from_numpy(s), torch.from_numpy(b),
                             mean, rstd, 32, relu=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), atol=5e-4, rtol=1e-4)
