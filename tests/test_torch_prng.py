# The port's threefry draws (spark_rapids_ml_tpu_torch/ops/prng.py) against
# jax.random and the JAX package's compat.threefry_2x32 on the CPU, at the
# shapes the UMAP path draws at: the layout's (P, n_pad) firing grid and
# (256,) negative table, the transform's (nq, k) firing draws and (nq, k, S)
# negatives.
#
# Tolerances: bits, keys, uniform and randint are equal bit for bit;
# normal is within 4 ulps (XLA's log1p and the port's may round apart).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.compat import threefry_2x32 as ref_threefry

from spark_rapids_ml_tpu_torch.ops import prng


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _words(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_jax_config_the_port_copies():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_threefry_2x32_matches_compat(n):
    rng = np.random.default_rng(n)
    kd = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    want = _words(ref_threefry(jnp.asarray(kd), jnp.asarray(counts)))
    got = prng.threefry_2x32(torch.from_numpy(kd.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_keys_fold_in_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _key_data(jk))
    for e in (0, 3, 199, 0x5CA1E):
        np.testing.assert_array_equal(prng.fold_in(tk, e).numpy(), _key_data(jax.random.fold_in(jk, e)))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(), _key_data(jax.random.split(jk, num)))
    # a batch of epoch keys in one call, as the layout draws them
    epochs = torch.arange(12)
    sub = prng.split(prng.fold_in(tk, epochs))
    for e in range(12):
        want = _key_data(jax.random.split(jax.random.fold_in(jk, e)))
        np.testing.assert_array_equal(sub[e].numpy(), want)


@pytest.mark.parametrize("shape", [(36, 320), (7,), (128, 8, 5)], ids=["layout", "ragged", "transform"])
def test_random_bits_and_uniform(shape):
    jk, tk = jax.random.PRNGKey(7), prng.prng_key(7)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(), _words(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(), np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_uniform_random_init_bounds(seed):
    # _random_init draws uniform [-10, 10): XLA fuses the scale and shift
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.uniform(jk, (320, 2), jnp.float32, -10.0, 10.0))
    np.testing.assert_array_equal(prng.uniform(tk, (320, 2), -10.0, 10.0).numpy(), want)


@pytest.mark.parametrize("maxval", [1, 2, 7, 256, 320, 20000, 65537, 12345677, 2**31 - 1])
@pytest.mark.parametrize("shape", [(256,), (64, 12, 5)], ids=["table", "transform"])
def test_randint(maxval, shape):
    jk, tk = jax.random.PRNGKey(11), prng.prng_key(11)
    want = np.asarray(jax.random.randint(jk, shape, 0, maxval))
    np.testing.assert_array_equal(prng.randint(tk, shape, 0, maxval).numpy(), want)


def test_randint_traced_maxval_and_batched_keys():
    # the layout's table: randint(k2, (256,), 0, max(valid_count, 1)) with a
    # traced valid_count, drawn for a block of epochs at once
    jk, tk = jax.random.PRNGKey(3), prng.prng_key(3)
    draw = jax.jit(lambda k, m: jax.random.randint(k, (256,), 0, jnp.maximum(m, 1)))
    valids = (0, 1, 300, 99999)
    for valid, want in zip(valids, jax.device_get([draw(jk, jnp.int32(v)) for v in valids])):
        got = prng.randint(tk, (256,), 0, torch.tensor(max(valid, 1)))
        np.testing.assert_array_equal(got.numpy(), want)
    sub = prng.split(prng.fold_in(tk, torch.arange(6)))
    tables = prng.randint(sub[:, 1], (256,), 0, 333)
    wants = jax.device_get([
        jax.random.randint(jax.random.split(jax.random.fold_in(jk, e))[1], (256,), 0, 333) for e in range(6)
    ])
    for e, want in enumerate(wants):
        np.testing.assert_array_equal(tables[e].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 9])
def test_normal_within_4_ulps(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.normal(jk, (4096, 3)))
    got = prng.normal(tk, (4096, 3)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, ulps.max()
