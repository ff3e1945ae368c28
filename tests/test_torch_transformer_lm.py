"""The port's TransformerLM against the JAX package's, at identical weights.

Weights are made by the JAX package's own init, carried across with
``convert.params_from_jax``, and both models run the same numpy token ids.
fp32 on both sides (``conftest`` pins JAX matmuls to full fp32): logits agree
to 1e-4 absolute on logits of O(1), the summation order being the only
difference.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smdistributed_modelparallel_tpu.models.transformer_lm import (
    TransformerLM as JaxTransformerLM,
)
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2 as port_gpt2
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

SMALL = dict(vocab_size=97, max_len=256, d_model=32, n_layers=2, n_heads=4)
VARIANTS = {
    "learned": dict(),
    "no_positions": dict(pos_type="none"),
    "window": dict(window=5),
    "parallel_block": dict(parallel_block=True),
    "untied_head": dict(tie_weights=False),
    "d_ff_ln_eps": dict(d_ff=48, ln_eps=1e-6),
}


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _pair(variant, seed=0):
    kw = {**SMALL, **VARIANTS[variant]}
    jmod = JaxTransformerLM(**kw)
    params = jmod.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(np_params), strict=True)
    return jmod, params, tmod


def _ids(B, T, seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (B, T)).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_maps_every_leaf(variant):
    """Every flax leaf lands on a port parameter of the transposed shape,
    and the port has no parameter the flax tree lacks (strict load)."""
    _, params, tmod = _pair(variant)
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    sd = tmod.state_dict()
    n_flax = sum(leaf.shape[0] if path.startswith("layers/block/") else 1 for path, leaf in flat.items())
    assert len(sd) == n_flax
    np.testing.assert_array_equal(sd["wte.weight"].numpy(), np.asarray(flat["wte/embedding"]))
    np.testing.assert_array_equal(
        sd["layers.1.attn.qkv.weight"].numpy(),
        np.asarray(flat["layers/block/attn/qkv/kernel"])[1].T,
    )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax(variant):
    jmod, params, tmod = _pair(variant)
    ids = _ids(2, 11)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_logits_match_jax_long_prompt():
    """T >= 128: the length at which the card takes the flash kernel (the
    CPU keeps the plain path in both packages)."""
    jmod, params, tmod = _pair("learned")
    ids = _ids(1, 150, seed=2)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_gpt2_zoo_matches_jax_zoo():
    jax_gpt2 = importlib.import_module("smdistributed_modelparallel_tpu.models.gpt2")

    for size in ("gpt2_124m", "gpt2_350m", "gpt2_774m", "gpt2_1p5b"):
        jmod = jax_gpt2.gpt2(size)
        tmod = port_gpt2(size, device="meta")
        for field in ("vocab_size", "max_len", "d_model", "n_layers", "n_heads", "pos_type", "tie_weights"):
            assert tmod.config[field] == getattr(jmod, field), (size, field)


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="rotary"):
        TransformerLM(**SMALL, pos_type="rotary")
    with pytest.raises(NotImplementedError, match="paged"):
        TransformerLM(**SMALL, paged_blocks=8, paged_block_tokens=16)
    with pytest.raises(NotImplementedError, match="loss mode"):
        TransformerLM(**SMALL)(torch.zeros((1, 4), dtype=torch.long), targets=torch.zeros((1, 4)))


def test_clone_shares_parameters():
    tmod = TransformerLM(**SMALL)
    clone = tmod.clone(decode=True, decode_cache_len=16)
    assert clone.decode and not tmod.decode
    assert clone.wte.weight.data_ptr() == tmod.wte.weight.data_ptr()
