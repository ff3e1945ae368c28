"""The port's key stream (``utils/random.py``) and the draws over it
(``ops/dropout.py``'s ``bits``, ``uniform``, ``bernoulli``, ``gumbel``,
``categorical``) against ``jax.random`` and the JAX package's
``RngManager``, on the CPU.

Keys, ``fold_in``, ``split``, ``bits``, ``uniform``, ``bernoulli`` and
``categorical`` must equal JAX's bit for bit (jax 0.9 with
``jax_threefry_partitionable``), as must ``RngManager.next_key`` and flax's
static path fold. ``gumbel``'s uniform draw is bit-exact; its two fp32 logs
are not, because XLA's CPU log rounds some draws differently from torch's,
so the draws agree to 4 ulp of their value (an error that moves an argmax
only at a near tie of the logits).
"""

import zlib

import flax.core.scope as flax_scope
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu.utils.random import RngManager as JaxRngManager
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax, key_to_jax
from smdistributed_modelparallel_tpu_torch.ops import dropout as draws
from smdistributed_modelparallel_tpu_torch.utils import random


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, -1])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(random.key(seed), _data(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 2**32 - 1, zlib.crc32(b"dropout")])
def test_fold_in_matches_jax(data):
    k = jax.random.key(42)
    np.testing.assert_array_equal(random.fold_in(random.key(42), data), _data(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_matches_jax(n):
    k = jax.random.fold_in(jax.random.key(3), 9)
    np.testing.assert_array_equal(random.split(key_from_jax(_data(k)), n), _data(jax.random.split(k, n)))


@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (2, 128, 64)])
def test_bits_match_jax(shape):
    k = jax.random.key(11)
    got = draws.bits(random.key(11), shape).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    if shape:  # a shard's part of the flat index space
        flat = np.asarray(jax.random.bits(k, shape, jnp.uint32)).ravel()
        part = draws.bits(random.key(11), (flat.size - 3,), offset=3).numpy().view(np.uint32)
        np.testing.assert_array_equal(part, flat[3:])
    if shape == ():
        assert random.bits32(random.key(11)) == int(np.asarray(jax.random.bits(k, (), jnp.uint32)))


def test_uniform_bernoulli_and_categorical_match_jax():
    k, pk = jax.random.key(5), random.key(5)
    shape = (4, 33, 17)
    np.testing.assert_array_equal(draws.uniform(pk, shape).numpy().view(np.uint32),
                                  np.asarray(jax.random.uniform(k, shape)).view(np.uint32))
    np.testing.assert_array_equal(draws.bernoulli(pk, 0.9, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(k, 0.9, shape)))
    logits = (np.random.default_rng(0).standard_normal((16, 97)) * 2).astype(np.float32)
    logits[:, 5] = -np.inf  # a filtered token
    np.testing.assert_array_equal(draws.categorical(pk, torch.from_numpy(logits)).numpy(),
                                  np.asarray(jax.random.categorical(k, jnp.asarray(logits))))


def test_gumbel_matches_jax():
    k, pk = jax.random.key(8), random.key(8)
    want = np.asarray(jax.random.gumbel(k, (8, 1000)))
    got = draws.gumbel(pk, (8, 1000)).numpy()
    # The same uniform draw, u in [tiny, 1): bit-exact.
    u = np.asarray(jax.random.uniform(k, (8, 1000), minval=np.finfo(np.float32).tiny, maxval=1.0))
    np.testing.assert_array_equal(
        draws.uniform(pk, (8, 1000), minval=np.finfo(np.float32).tiny).numpy().view(np.uint32), u.view(np.uint32))
    np.testing.assert_allclose(got, want, rtol=4 * 2.0**-23, atol=4 * 2.0**-23)


@pytest.mark.parametrize("streams", [("step",), ("step", "step", "dropout", "step", "init_dropout")])
def test_rng_manager_matches_jax(streams):
    want, got = JaxRngManager(7), random.RngManager(7)
    for s in streams:
        np.testing.assert_array_equal(got.next_key(s), _data(want.next_key(s)))
    got.reset()
    want.reset()
    np.testing.assert_array_equal(got.init_rngs()["dropout"], _data(want.init_rngs()["dropout"]))


@pytest.mark.parametrize("data", [(1,), ("Dropout_0", 1), ("transformer", "seq_layers", "layer", "attention", 2),
                                  ("a", 300, "ü")])
def test_static_fold_matches_flax(data):
    k = jax.random.key(4)
    np.testing.assert_array_equal(random.fold_in_static(random.key(4), data),
                                  _data(flax_scope._fold_in_static(k, data)))


def test_key_conversion_round_trip_and_rejects_generators():
    k = jax.random.split(jax.random.key(9))[1]
    mine = key_from_jax(jax.random.key_data(k))
    assert mine.dtype == np.uint32 and mine.shape == (2,)
    np.testing.assert_array_equal(_data(jax.random.wrap_key_data(key_to_jax(mine))), _data(k))
    with pytest.raises(TypeError, match="two uint32 words"):
        random.as_key(torch.Generator())
