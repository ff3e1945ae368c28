"""The port's ``nn/utils.PagedKVCache`` and the zoo's paged path against the
JAX package's, on identical numpy inputs.

``append`` moves data only, so its pools, gathered K/V and mask must equal
the JAX function's bit for bit: a decode step (one slot empty, on trash
tables), a padded prefill chunk and a local window; under
``SMP_KV_QUANT=int8`` (quantize, requantize, dequantize) as well, against
the JAX append compiled as the JAX engine compiles it. The paged zoo's logits
for a prefill chunk and then a decode step are held to 1e-5 of max |logit|
in fp32 (the two packages sum in other orders), with learned and rotary
positions.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.nn.utils import PagedKVCache as JaxPagedKVCache
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import kv_pools_from_jax, params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn.utils import PagedKVCache

NB, BT, H, HD, MB = 9, 4, 2, 8, 4


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


class _JaxPool(fnn.Module):
    window: int = None

    @fnn.compact
    def __call__(self, k, v, tables, positions, valid):
        pool = JaxPagedKVCache(self, NB, BT, H, HD, k.dtype)
        return pool.append(k, v, tables, positions, valid=valid, window=self.window)


def _case(name):
    """(k, v, tables, positions, valid, window) as numpy, and the starting
    pools: a decode step over 3 slots (slot 2 empty, on trash tables), a
    padded prefill chunk, and a windowed decode step."""
    rng = np.random.default_rng(sum(map(ord, name)))
    pk, pv = (rng.standard_normal((NB, BT, H, HD)).astype(np.float32) for _ in range(2))
    if name == "decode":
        tables = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
        positions = np.array([6, 2, 0], np.int32)
        T, valid, window = 1, None, None
    elif name == "padded_prefill":
        tables = np.array([[2, 4, 6, 0]], np.int32)
        positions = np.array([8], np.int32)
        T, valid, window = 4, np.array([3], np.int32), None
    else:  # window
        tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
        positions = np.array([13, 5], np.int32)
        T, valid, window = 1, None, 3
    B = tables.shape[0]
    k, v = (rng.standard_normal((B, T, H, HD)).astype(np.float32) for _ in range(2))
    return (k, v, tables, positions, valid, window), (pk, pv)


@pytest.mark.parametrize("name", ["decode", "padded_prefill", "window"])
def test_append_matches_jax_bit_for_bit(name):
    (k, v, tables, positions, valid, window), (pk, pv) = _case(name)
    (jk, jv, jmask), mut = _JaxPool(window=window).apply(
        {"cache": {"pool_key": jnp.asarray(pk), "pool_value": jnp.asarray(pv)}},
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(positions),
        None if valid is None else jnp.asarray(valid), mutable=["cache"],
    )
    pool = PagedKVCache(NB, BT, H, HD, torch.float32, "cpu")
    pool.key.copy_(torch.from_numpy(pk))
    pool.value.copy_(torch.from_numpy(pv))
    tk, tv, tmask = pool.append(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tables), torch.from_numpy(positions),
        valid=None if valid is None else torch.from_numpy(valid), window=window,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tmask.dtype == torch.bool and tmask.shape == jmask.shape
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(pool.key.numpy(), np.asarray(mut["cache"]["pool_key"]))
    np.testing.assert_array_equal(pool.value.numpy(), np.asarray(mut["cache"]["pool_value"]))
    # The write really happened: every live row's slot now holds its K.
    assert not np.array_equal(pool.key.numpy(), pk)


def test_kv_quant_int8_refused(monkeypatch):
    """Under ``SMP_KV_QUANT=int8`` (once refused, now ported) the int8 append
    equals the JAX one bit for bit, as the JAX engine's compiled program
    runs it: int8 pools and fp32 scales (some blocks fresh at 0, the rest
    grown before), gathered K/V dequantized to fp32, the mask, over the
    three cases."""
    monkeypatch.setenv("SMP_KV_QUANT", "int8")
    for name in ("decode", "padded_prefill", "window"):
        (k, v, tables, positions, valid, window), _ = _case(name)
        rng = np.random.default_rng(7)
        pk, pv = (rng.integers(-127, 128, (NB, BT, H, HD)).astype(np.int8) for _ in range(2))
        sk, sv = (np.where(rng.random((NB, H)) < 0.5, 0.0, rng.random((NB, H)) * 0.02).astype(np.float32)
                  for _ in range(2))

        @jax.jit
        def jax_append(cache, k, v, tables, positions, valid):
            return _JaxPool(window=window).apply(cache, k, v, tables, positions, valid, mutable=["cache"])

        cache = {"cache": {"pool_key": pk, "pool_value": pv, "scale_key": sk, "scale_value": sv}}
        (jk, jv, jmask), mut = jax_append(cache, k, v, tables, positions, valid)
        pool = PagedKVCache(NB, BT, H, HD, torch.float32, "cpu")
        assert pool.key.dtype == torch.int8 and pool.scale_key.shape == (NB, H)
        for t, a in zip(pool.pools(), (pk, pv, sk, sv)):
            t.copy_(torch.from_numpy(a))
        tk, tv, tmask = pool.append(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tables), torch.from_numpy(positions),
            valid=None if valid is None else torch.from_numpy(valid), window=window,
        )
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk), err_msg=name)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask), err_msg=name)
        for t, leaf in zip(pool.pools(), ("pool_key", "pool_value", "scale_key", "scale_value")):
            np.testing.assert_array_equal(t.numpy(), np.asarray(mut["cache"][leaf]), err_msg=f"{name} {leaf}")
        # The scales grew where the tokens landed.
        assert (pool.scale_key.numpy() >= sk).all() and (pool.scale_key.numpy() > sk).any()


SMALL = dict(vocab_size=97, max_len=32, d_model=32, n_layers=2, n_heads=4)


@pytest.mark.parametrize("pos_type", ["learned", "rotary"])
def test_paged_zoo_logits_match_jax(pos_type):
    """A padded prefill chunk of two rows at different depths, then a decode
    step over three slots (one empty), through both packages' paged clones
    from the same weights and zero pools: logits within 1e-5 of max |logit|,
    and the pools after both calls agree to the same bound."""
    kw = dict(SMALL, pos_type=pos_type)
    nb, bt, mb = 12, 4, 8
    jmod = JaxTransformerLM(**kw)
    params = jmod.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    jpaged = jmod.clone(paged_blocks=nb, paged_block_tokens=bt, deterministic=True, decode=False,
                        decode_cache_len=None)
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tpaged = tmod.clone(paged_blocks=nb, paged_block_tokens=bt, deterministic=True, decode=False,
                        decode_cache_len=None)

    rng = np.random.default_rng(3)
    prefill = dict(
        ids=rng.integers(0, 97, (2, 6)).astype(np.int32),
        block_tables=np.array([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 0, 0, 0, 0, 0, 0]], np.int32),
        positions=np.array([0, 3], np.int32), valid=np.array([6, 4], np.int32),
    )
    decode = dict(
        ids=rng.integers(0, 97, (3, 1)).astype(np.int32),
        block_tables=np.array([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 0, 0, 0, 0, 0, 0],
                               [0, 0, 0, 0, 0, 0, 0, 0]], np.int32),
        positions=np.array([6, 7, 0], np.int32),
    )
    apply = jax.jit(lambda variables, ids, paged: jpaged.apply(variables, ids, paged=paged, mutable=["cache"]))
    cache = None
    for call in (prefill, decode):
        paged = {k: v for k, v in call.items() if k != "ids"}
        if cache is None:
            shapes = jax.eval_shape(apply, {"params": params}, call["ids"], paged)[1]["cache"]
            cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        want, mut = apply({"params": params, "cache": cache}, call["ids"], paged)
        cache = mut["cache"]
        with torch.inference_mode():
            got = tpaged(torch.from_numpy(call["ids"]).long(),
                         paged={k: torch.from_numpy(v) for k, v in paged.items()})
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    pools = kv_pools_from_jax(jax.tree_util.tree_map(np.asarray, cache))
    for layer, (jk, jv) in zip(tpaged.layers, pools):
        for got, want in ((layer.attn.cache.key, jk), (layer.attn.cache.value, jv)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))


def test_paged_clone_needs_paged_state():
    tpaged = TransformerLM(**SMALL).clone(paged_blocks=4, paged_block_tokens=4)
    with pytest.raises(ValueError, match="paged state"):
        tpaged(torch.zeros((1, 2), dtype=torch.long))
