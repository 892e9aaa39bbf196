"""The port's on-device augmentation against the JAX package's.

JAX's threefry and torch's Philox never draw the same numbers, so the crop
offsets and flip flags are drawn exactly as ``ops/augment.py`` draws them
(``jax.random.split``, ``randint``, ``bernoulli``) and injected into the
port's ``augment_images``. Same uint8 input, same draws: outputs agree
within atol 1e-6 (the same f32 normalize arithmetic; crop and flip move
values without arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.data.datasets import NORM_STATS
from dynamic_load_balance_distributeddnn_tpu.ops.augment import (
    augment_images as jax_augment,
    normalize_images as jax_normalize,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.augment import (
    augment_images,
    normalize_images,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SHAPES = {"cifar10": (6, 32, 32, 3), "mnist": (5, 28, 28, 1)}


def _batch(name, seed):
    return np.random.RandomState(seed).randint(0, 256, SHAPES[name]).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_augment_matches_jax_with_injected_draws(name, seed):
    x = _batch(name, seed)
    mean, std = NORM_STATS[name]
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment(x, rng, mean, std))
    # the draws of ops/augment.py, reproduced
    k_crop, k_flip = jax.random.split(rng)
    offs = np.asarray(jax.random.randint(k_crop, (x.shape[0], 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (x.shape[0],)))
    got = augment_images(
        torch.from_numpy(x), mean, std,
        offsets=torch.from_numpy(offs), flips=torch.from_numpy(flips),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_normalize_matches_jax(name):
    x = _batch(name, 3)
    mean, std = NORM_STATS[name]
    np.testing.assert_allclose(
        normalize_images(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jax_normalize(x, mean, std)),
        atol=1e-6,
    )


def test_augment_draws_come_from_the_generator():
    x = torch.from_numpy(_batch("cifar10", 4))
    mean, std = NORM_STATS["cifar10"]
    a = augment_images(x, mean, std, generator=torch.Generator().manual_seed(5))
    b = augment_images(x, mean, std, generator=torch.Generator().manual_seed(5))
    c = augment_images(x, mean, std, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # zero offset, no flip = the centre-shifted crop: the top-left 4 rows of
    # padding, then the image
    z = augment_images(
        x, mean, std, offsets=torch.zeros(6, 2, dtype=torch.long),
        flips=torch.zeros(6, dtype=torch.bool),
    )
    assert float(z[:, :4].abs().max()) == 0.0
    torch.testing.assert_close(z[:, 4:, 4:], normalize_images(x, mean, std)[:, :28, :28])
