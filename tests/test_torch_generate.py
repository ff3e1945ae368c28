"""The port's ``smp.generate`` against the JAX package's.

Same weights (JAX init carried across by ``convert.params_from_jax``), same
numpy prompts, fp32 on both sides: greedy tokens must be equal, and the
port's KV-cache decode logits must match the JAX model's full forward to
1e-4 (fp32; summation order only). Sampling takes the same key on both
sides (``convert.key_from_jax``) and must give the same tokens, with and
without the top-k and top-p filters; it is also held to its filters, its
key and its support.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as smp_jax
from smdistributed_modelparallel_tpu.generation import _top_k_filter as jax_top_k
from smdistributed_modelparallel_tpu.generation import _top_p_filter as jax_top_p
from smdistributed_modelparallel_tpu.models.transformer_lm import (
    TransformerLM as JaxTransformerLM,
)
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch import generation as port_generation
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax, params_from_jax
from smdistributed_modelparallel_tpu_torch.models.gpt2 import init_gpt2_weights_
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.random import key

SMALL = dict(vocab_size=97, max_len=256, d_model=32, n_layers=2, n_heads=4)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _port_lm(seed=0):
    """A port-only model (no JAX) for the behaviour tests."""
    tmod = TransformerLM(**SMALL)
    return init_gpt2_weights_(tmod, torch.Generator().manual_seed(seed), std=0.5)


def _pair(seed=0, **overrides):
    kw = {**SMALL, **overrides}
    jmod = JaxTransformerLM(**kw)
    params = jmod.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, tmod


def _prompts(B=2, T=130, seed=3):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy_pair():
    """One JAX generate (the costly compile) shared by the parity tests."""
    jmod, params, tmod = _pair()
    ids = _prompts()
    smp_jax.init({})
    want = np.asarray(smp_jax.generate(jmod, jnp.asarray(ids), 8, params=params))
    smp_jax.reset()
    return jmod, params, tmod, ids, want


def test_greedy_tokens_equal_jax(greedy_pair):
    _, _, tmod, ids, want = greedy_pair
    smp_torch.init({})
    model = smp_torch.DistributedModel(tmod, device="cpu")
    got = smp_torch.generate(model, torch.from_numpy(ids).long(), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_step_logits_match_full_forward(greedy_pair):
    jmod, params, tmod, ids, want = greedy_pair
    full = np.asarray(jmod.apply({"params": params}, jnp.asarray(want)))
    T = ids.shape[1]
    dec = tmod.clone(decode=True, decode_cache_len=want.shape[1])
    seq = torch.tensor(want).long()
    with torch.inference_mode():
        logits = [dec(seq[:, :T])[:, -1]]
        for t in range(T, want.shape[1] - 1):
            logits.append(dec(seq[:, t:t + 1])[:, -1])
    got = torch.stack(logits, dim=1).numpy()
    np.testing.assert_allclose(got, full[:, T - 1:-1], rtol=0, atol=1e-4)


def test_window_and_untied_greedy_equal_jax():
    jmod, params, tmod = _pair(seed=1, window=9, tie_weights=False, pos_type="none")
    ids = _prompts(B=1, T=20, seed=4)
    smp_jax.init({})
    want = np.asarray(smp_jax.generate(jmod, jnp.asarray(ids), 6, params=params))
    got = smp_torch.generate(tmod, torch.from_numpy(ids).long(), 6, params=tmod.state_dict()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p", [(1, None), (5, None), (200, None), (None, 0.01), (None, 0.5),
                                         (None, 0.95), (7, 0.9)])
def test_filters_match_jax(top_k, top_p):
    logits = np.random.default_rng(5).standard_normal((3, 97)).astype(np.float32) * 3
    want, got = jnp.asarray(logits), torch.from_numpy(logits)
    if top_k is not None:
        want, got = jax_top_k(want, top_k), port_generation._top_k_filter(got, top_k)
    if top_p is not None:
        want, got = jax_top_p(want, top_p), port_generation._top_p_filter(got, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_keeps_while_mass_before_is_below_p():
    probs = np.asarray([0.6, 0.25, 0.1, 0.05])
    out = port_generation._top_p_filter(torch.log(torch.tensor(probs))[None], 0.7)
    np.testing.assert_array_equal(torch.isfinite(out)[0].numpy(), [True, True, False, False])


@pytest.mark.parametrize("filters", [{}, dict(top_k=5), dict(top_p=0.8), dict(top_k=7, top_p=0.9)],
                         ids=["plain", "top_k", "top_p", "top_k_top_p"])
def test_sampled_tokens_equal_jax(greedy_pair, filters):
    """The same key on both sides: the same sampled tokens (the port
    sampled with ``torch.multinomial`` from a ``torch.Generator`` before)."""
    jmod, params, tmod, ids, _ = greedy_pair
    jkey = jax.random.key(21)
    smp_jax.init({})
    want = np.asarray(smp_jax.generate(jmod, jnp.asarray(ids), 8, params=params, temperature=0.7, rng=jkey,
                                       **filters))
    smp_jax.reset()
    got = smp_torch.generate(tmod, torch.from_numpy(ids).long(), 8, params=tmod.state_dict(), temperature=0.7,
                             rng=key_from_jax(jax.random.key_data(jkey)), **filters).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want[:, ids.shape[1]:], greedy_pair[4][:, ids.shape[1]:])  # it did sample


def _sample(tmod, ids, seed, **kw):
    return smp_torch.generate(tmod, ids, 10, params=tmod.state_dict(), rng=key(seed), **kw)


@pytest.mark.parametrize("filters", [dict(top_k=4), dict(top_p=0.6), dict(top_k=6, top_p=0.8)])
def test_sampling_reproducible_and_inside_support(filters):
    tmod = _port_lm()
    ids = torch.from_numpy(_prompts(B=3, T=12)).long()
    a = _sample(tmod, ids, 11, temperature=0.7, **filters)
    b = _sample(tmod, ids, 11, temperature=0.7, **filters)
    assert torch.equal(a, b)
    # Every sampled token lies in the filtered support of its step.
    with torch.inference_mode():
        logits = tmod(a)[:, ids.shape[1] - 1:-1].float() / 0.7
    kept = logits
    if "top_k" in filters:
        kept = port_generation._top_k_filter(kept, filters["top_k"])
    if "top_p" in filters:
        kept = port_generation._top_p_filter(kept, filters["top_p"])
    chosen = kept.gather(-1, a[:, ids.shape[1]:, None])
    assert torch.isfinite(chosen).all()


def test_eos_freezes_rows():
    tmod = _port_lm()
    ids = torch.from_numpy(_prompts(B=2, T=12)).long()
    free = smp_torch.generate(tmod, ids, 6, params=tmod.state_dict())
    eos = int(free[0, 13])  # row 0 emits it at its second step
    out = smp_torch.generate(tmod, ids, 6, params=tmod.state_dict(), eos_token_id=eos, pad_token_id=96)
    row = out[0, 12:].tolist()
    stop = row.index(eos)
    assert all(t == 96 for t in row[stop + 1:])
    assert torch.equal(out[:, :12 + stop + 1][0], free[0, :12 + stop + 1])


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(max_new_tokens=0), SMPValidationError, "max_new_tokens"),
    (dict(temperature=-1.0), SMPValidationError, "temperature must be >= 0"),
    (dict(temperature=1.0), SMPValidationError, "requires rng"),
    (dict(top_k=5), SMPValidationError, "no effect with temperature == 0"),
    (dict(temperature=1.0, top_k=0, rng="g"), SMPValidationError, "top_k must be >= 1"),
    (dict(temperature=1.0, top_p=1.5, rng="g"), SMPValidationError, "top_p must be in"),
    (dict(num_beams=2, temperature=1.0, rng="g"), SMPValidationError, "beam search is greedy"),
    (dict(num_return_sequences=2), SMPValidationError, "num_return_sequences"),
    (dict(encoder_mask=np.ones((2, 12))), SMPValidationError, "encoder_mask"),
    (dict(max_new_tokens=300), SMPValidationError, "position limit"),
    (dict(num_beams=2, num_return_sequences=3), SMPValidationError, "num_return_sequences"),
    (dict(attention_mask=np.ones((2, 12))), SMPValidationError, "does not accept attention_mask"),
    (dict(temperature=1.0, rng=torch.Generator()), SMPValidationError, "rng is a key"),
])
def test_validation_errors(kwargs, error, match):
    tmod = _port_lm()
    smp_torch.init({})
    model = smp_torch.DistributedModel(tmod, device="cpu")
    kwargs = dict(kwargs)
    if isinstance(kwargs.get("rng"), str):
        kwargs["rng"] = key(0)
    max_new = kwargs.pop("max_new_tokens", 4)
    with pytest.raises(error, match=match):
        smp_torch.generate(model, torch.zeros((2, 12), dtype=torch.long), max_new, **kwargs)


@pytest.mark.parametrize("env", ["SMP_SHAPE_BUCKETS=seq:64,128", "SMP_DECODE_WEIGHTS=int8"])
def test_unported_env_knobs_raise(monkeypatch, env):
    """The two knobs that raised before they were ported now run, and give
    the JAX package's tokens under the same setting (greedy; sampled under
    buckets, which draw from the bucketed key schedule)."""
    name, _, value = env.partition("=")
    monkeypatch.setenv(name, value)
    jmod, params, tmod = _pair(seed=2)
    ids = _prompts(B=2, T=5, seed=6)
    kw = dict(temperature=0.8) if name == "SMP_SHAPE_BUCKETS" else {}
    jkey = jax.random.key(3)
    smp_jax.init({})
    want = np.asarray(smp_jax.generate(jmod, jnp.asarray(ids), 3, params=params, rng=jkey, **kw))
    smp_jax.reset()
    got = smp_torch.generate(tmod, torch.from_numpy(ids).long(), 3, params=tmod.state_dict(),
                             rng=key_from_jax(jax.random.key_data(jkey)), **kw).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_module_without_params_is_rejected():
    tmod = _port_lm()
    with pytest.raises(SMPValidationError, match="requires params"):
        smp_torch.generate(tmod, torch.zeros((1, 4), dtype=torch.long), 2)


def test_decode_cache_protocol_violation():
    tmod = _port_lm()
    dec = tmod.clone(decode=True, decode_cache_len=16)
    with torch.inference_mode():
        dec(torch.zeros((1, 4), dtype=torch.long))
        dec(torch.zeros((1, 1), dtype=torch.long))
        with pytest.raises(ValueError, match="KV-cache protocol violation"):
            dec(torch.zeros((1, 2), dtype=torch.long))


def test_bf16_config_casts_decode_params(monkeypatch):
    """Under bf16 the decode module runs on bf16 copies of every floating
    parameter (LayerNorm and embeddings included); the model keeps fp32."""
    tmod = _port_lm()
    smp_torch.init({"bf16": True})
    model = smp_torch.DistributedModel(tmod, device="cpu")
    seen = {}
    real = port_generation._decode_clone

    def spy(module, cache_len, half):
        mod = real(module, cache_len, half)
        seen.update({k: v.dtype for k, v in mod.state_dict().items()})
        return mod

    monkeypatch.setattr(port_generation, "_decode_clone", spy)
    out = smp_torch.generate(model, torch.from_numpy(_prompts(B=1, T=10)).long(), 3)
    assert out.shape == (1, 13)
    assert seen and set(seen.values()) == {torch.bfloat16}
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
