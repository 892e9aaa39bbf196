"""The port's gradient wire and host collectives against the JAX package's.

Bit for bit, on the same inputs and keys:

- ``parallel/prng.py``'s threefry copy: ``key_data(fold_in(PRNGKey(s), d))``
  equals ``jax.random``'s over a grid of seeds and fold-in data;
- ``_dither``, ``quantize_stochastic`` and ``quantize_nearest`` equal the
  JAX ``parallel/wire.py`` functions;
- the compressed sums over 2 and 4 gloo ranks (one ``tests/_torch_dist_helpers.py``
  world each, ``file://`` rendezvous): ``compressed_reduce`` on the int8 and
  int4 wires (the total and each rank's sent codes), the int8
  ``compressed_reduce_scatter`` and the leaf-batched ``compressed_reduce_leaves``
  equal the JAX functions under ``shard_map`` over as many CPU devices, each
  device's key ``fold_in(PRNGKey(seed), index)``.

``exchange_times`` gathers each rank's slice in rank order, and the probe
vote is the OR of the ranks' votes, on 2 and 4 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dynamic_load_balance_distributeddnn_tpu.parallel import wire as jw
from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import data_mesh, shard_map
from dynamic_load_balance_distributeddnn_tpu_torch.parallel import prng
from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire as pw
from tests._torch_dist_helpers import launch
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SEED = 77
WIDTH = 256  # divisible by every world size below
SIZES = [100, 56, 100]  # the leaves of compressed_reduce_leaves


def _jkey(seed, d):
    return jax.random.fold_in(jax.random.PRNGKey(seed), d)


@pytest.mark.parametrize("seed", [0, 1, 31 * 1234 + 2, 0x5D1E, 2**31 - 1, -7])
def test_threefry_key_data_equals_jax(seed):
    for d in (0, 1, 2, 3, 0x7FFF, 0x7FFF + 361, 0x2E01, 2**32 - 1, 123456789):
        want = tuple(int(v) for v in np.asarray(jax.random.key_data(_jkey(seed, d))))
        assert prng.key_data(prng.fold_in(prng.prng_key(seed), d)) == want, (seed, d)
    nested = jax.random.fold_in(jax.random.fold_in(_jkey(seed, 5), 3), 0x7FFF + 2)
    got = prng.fold_in(prng.fold_in(prng.fold_in(prng.prng_key(seed), 5), 3), 0x7FFF + 2)
    assert prng.key_data(got) == tuple(int(v) for v in np.asarray(jax.random.key_data(nested)))
    many = prng.fold_in_many(prng.prng_key(seed), range(10))
    assert many == [prng.fold_in(prng.prng_key(seed), d) for d in range(10)]


@pytest.mark.parametrize("shape,seed,d", [((1000,), 0, 5), ((17, 33), 1234 * 31, 0x7FFF + 3),
                                          ((3, 4, 5, 6), 7, 0x2E01)])
def test_dither_and_quantizers_equal_jax(shape, seed, d):
    jk, pk = _jkey(seed, d), prng.fold_in(prng.prng_key(seed), d)
    a = np.asarray(jw._dither(jk, shape))
    b = pw._dither(pk, shape).numpy()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    v = np.random.default_rng(seed % 1000).standard_normal(shape).astype(np.float32) * 3
    scale = np.float32(np.abs(v).max() / 127)
    a = np.asarray(jw.quantize_stochastic(jnp.asarray(v), jk, scale, 127))
    b = pw.quantize_stochastic(torch.from_numpy(v), pk, torch.tensor(scale), 127).numpy()
    assert np.array_equal(a, b)
    a = np.asarray(jw.quantize_nearest(jnp.asarray(v), scale * 17, 7))
    b = pw.quantize_nearest(torch.from_numpy(v), torch.tensor(scale * 17), 7).numpy()
    assert np.array_equal(a, b)
    assert pw.wire_sum_dtype("int8", 2) == jnp.dtype(jw.wire_sum_dtype("int8", 2)).name
    assert pw.wire_sum_dtype("int4", 2) == jnp.dtype(jw.wire_sum_dtype("int4", 2)).name


def _inputs(world):
    return np.random.default_rng(world).standard_normal((world, WIDTH)).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    v = _inputs(n)
    out = launch(n, {"c": {"kind": "collectives", "v": v, "seed": SEED, "sizes": SIZES}},
                 tmp_path_factory.mktemp(f"codec{n}"), timeout=180)
    return n, v, [o["c"] for o in out]


def _jax_wire(n, v):
    """The JAX wire on ``n`` CPU devices, device d holding row d."""
    mesh = data_mesh(jax.devices()[:n])

    def per_shard(x):
        x = x[0]
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), jax.lax.axis_index("data"))
        total, sent = jw.compressed_reduce(x, key, "data", n, "int8")
        t4, s4 = jw.compressed_reduce(x, key, "data", n, "int4")
        scat = jw.compressed_reduce_scatter(x, key, "data", n, "int8")
        leaves, off = [], 0
        for i, size in enumerate(SIZES):
            lt, _ = jw.compressed_reduce(x[off:off + size], jax.random.fold_in(key, i + 0x7FFF),
                                         "data", n, "int8")
            leaves.append(lt)
            off += size
        return (total[None], sent[None], t4[None], s4[None], scat[None],
                jnp.concatenate(leaves)[None])

    fn = shard_map(per_shard, mesh=mesh, in_specs=P("data"), out_specs=(P("data"),) * 6,
                   check_vma=False)
    return [np.asarray(a) for a in jax.jit(fn)(jnp.asarray(v))]


def test_compressed_sums_equal_jax_bit_for_bit(world):
    n, v, got = world
    total, sent, t4, s4, scat, leaves = _jax_wire(n, v)
    for r, g in enumerate(got):
        assert g["backend"] == "gloo"
        assert np.array_equal(g["total"].numpy(), total[r]), r
        assert np.array_equal(g["sent"].numpy(), sent[r]), r
        assert np.array_equal(g["total4"].numpy(), t4[r]), r
        assert np.array_equal(g["sent4"].numpy(), s4[r]), r
        assert np.array_equal(g["scattered"].numpy(), scat[r]), r
        assert np.array_equal(g["leaves"].numpy()[:sum(SIZES)], leaves[r]), r
    # the wire is unbiased and close: within n steps of the exact sum
    step = np.abs(v).max() / 127.0
    assert np.abs(got[0]["total"].numpy() - v.sum(axis=0)).max() <= n * step + 1e-6


def test_exchange_times_and_the_probe_vote(world):
    n, _, got = world
    want = np.concatenate([[10.0 * r + 0.5, 10.0 * r + 0.25] for r in range(n)])
    for g in got:
        assert np.array_equal(g["times"], want)
        assert g["votes"] == [False, True]  # no rank votes; only the last rank votes


def test_wire_dtype_holds_the_jax_integer_sum():
    """float16 carries every partial sum of ``n * 127`` exactly up to 2048,
    at JAX's 2 bytes an element; above it int32."""
    assert pw.transport_dtype("int8", 2) == torch.float16
    assert pw.transport_dtype("int8", 16) == torch.float16  # 16 * 127 = 2032
    assert pw.transport_dtype("int8", 17) == torch.int32
    assert pw.wire_payload_bytes("int8", 2) == jnp.dtype(jw.wire_sum_dtype("int8", 2)).itemsize
    assert pw.wire_payload_bytes("fp32", 2) == 4
    codes = torch.full((16,), 127.0).to(torch.float16)
    assert float(codes.float().sum()) == 16 * 127
    assert all(float(torch.tensor(k, dtype=torch.float16)) == k for k in range(-2048, 2049))
