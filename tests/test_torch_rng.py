"""The port's threefry twin reproduces jax.random bit for bit."""

import jax
import numpy as np
import pytest

from sos_slam_tpu_torch.utils import rng

SEEDS = [0, 1, 42, 3141592, 2 ** 31 - 1, 2 ** 32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                  rng.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    kk = rng.PRNGKey(seed)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, num)),
                                      rng.split(kk, num))
    for d in (0, 1, 17, 99, 990000, 2 ** 32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(k, d)),
                                      rng.fold_in(kk, d))
    # chained derivations, as the keyframe keys are made
    a = jax.random.fold_in(jax.random.fold_in(k, 12), 1)
    b = rng.fold_in(rng.fold_in(kk, 12), 1)
    np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("shape", [(), (7,), (30, 40), (1, 1), (15, 20),
                                   (192, 256)])
def test_uniform_shapes(shape):
    """The selector's draw shapes (block grids, full-image keep masks)."""
    for seed in (3, 11):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
        kk = rng.fold_in(rng.PRNGKey(seed), 99)
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, shape)),
                                      rng.uniform(kk, shape))


def test_split_then_uniform_many_keys():
    k = jax.random.PRNGKey(5)
    kk = rng.PRNGKey(5)
    for _ in range(20):
        k, sub = jax.random.split(k)
        kk, ssub = rng.split(kk)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(sub, (4, 6))),
            rng.uniform(ssub, (4, 6)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_device_equals_the_host_draw(seed):
    """The device twin of `uniform` (the keyframe chain's draws) gives the
    host draw's bits."""
    import torch
    k = rng.fold_in(rng.PRNGKey(seed), 12)
    for shape in ((7,), (192, 256), (3, 5, 4)):
        a = rng.uniform(k, shape)
        b = rng.uniform_device(torch.as_tensor(k.astype(np.int64)),
                               shape).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
