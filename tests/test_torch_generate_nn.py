"""The port's ``smp.generate`` through ``smp.nn.DistributedTransformerLMHead``
against the JAX package's.

The JAX init of each head (every leaf moved by noise from a seed, so the
logits are far from ties) is carried across by
``convert.lm_head_params_from_jax``; the prompts are numpy draws from a
seed; both sides run fp32 on the CPU. Greedy tokens must be equal over the
layer variants (learned positions with post-LN, NeoX and GPT-J rotary, a
local window, the fused QKV and bias-GELU branch, checkpointed layers), and
the port's KV-cache decode logits must match the JAX model's cacheless
forward to 1e-5 of their largest value (summation order only). Left-padded
prompts must give the JAX package's tokens, and a padded row the tokens of
its unpadded prompt alone; sampled tokens under a key the JAX package's.
BERT-family heads and pad-aware positions refuse to decode in both; a
cross-attention layer decodes on the encoder K/V of its first call and
refuses tensor parallelism.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as smp_jax
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.ops import pallas_gelu, pallas_qkv
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax, lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=97, num_positions=64, causal_mask_size=64, attention_dropout_prob=0.0, hidden_dropout_prob=0.0,
    embedding_dropout_prob=0.0, deterministic=True,
)
ROTARY = dict(use_positional_embedding=False, rotary_dim=8, pre_layernorm=True, post_layernorm=False,
              final_layernorm=True)
VARIANTS = {
    "learned": {},  # GPT-2 style: learned positions, post-LN
    "neox": dict(ROTARY, gpt_neox_type_rotary=True),
    "gptj": dict(ROTARY, pre_layernorm=False, parallel_attn_output=True, single_pre_layernorm=True),
    "window": dict(window_size=5, pre_layernorm=True, post_layernorm=False, final_layernorm=True),
    "fused": dict(fused_bias_gelu=True, pre_layernorm=True, post_layernorm=False, final_layernorm=True),
    "checkpointed": dict(activation_checkpointing=True),
}
T, NEW = 9, 6


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def jax_init(jmod, seed):
    """The JAX module's params at one device (plain arrays: a JAX config an
    earlier test left, e.g. with tp > 1, would box them)."""
    smp_jax.init({})
    try:
        return jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    finally:
        smp_jax.reset()


def head_pair(kw, seed=0, noise=0.3):
    """(JAX head, its params, the port's head on the same weights)."""
    jmod = jax_tr.DistributedTransformerLMHead(**kw)
    params = jax_init(jmod, seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32), params)
    tmod = port_tr.DistributedTransformerLMHead(**kw)
    tmod.load_state_dict(lm_head_params_from_jax(params), strict=True)
    return jmod, params, tmod


def prompts(B=2, length=T, seed=3, vocab=97):
    return np.random.default_rng(seed).integers(1, vocab, (B, length)).astype(np.int32)


def jax_generate(jmod, params, ids, new, cfg=None, **kw):
    smp_jax.init(cfg or {})
    try:
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        return np.asarray(smp_jax.generate(jmod, jnp.asarray(ids), new, params=params, **kw))
    finally:
        smp_jax.reset()


def port_generate(tmod, ids, new, cfg=None, **kw):
    smp_torch.init(cfg or {}, device="cpu")
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return smp_torch.generate(tmod, torch.from_numpy(ids).long(), new, params=tmod.state_dict(), **kw).numpy()


@pytest.fixture(scope="module")
def greedy_runs():
    """Every variant's JAX greedy generate (one compile each) and its
    cacheless logits over the generated sequence."""
    out = {}
    ids = prompts()
    mp = pytest.MonkeyPatch()
    for name, extra in VARIANTS.items():
        kw = dict(HEAD, **extra)
        cfg = None
        if name == "fused":
            mp.setattr(pallas_qkv, "FORCE_INTERPRET", True)
            mp.setattr(pallas_gelu, "FORCE_INTERPRET", True)
            cfg = {"fused_qkv": True}
        jmod, params, tmod = head_pair(kw)
        want = jax_generate(jmod, params, ids, NEW, cfg)
        smp_jax.init(cfg or {})
        full = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(want)))
        smp_jax.reset()
        mp.undo()
        out[name] = dict(tmod=tmod, want=want, full=full, cfg=cfg)
    return ids, out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_tokens_and_decode_logits_equal_jax(greedy_runs, name, monkeypatch):
    ids, runs = greedy_runs
    run = runs[name]
    if name == "fused":
        monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
        monkeypatch.setattr(bg, "_is_cuda", lambda t: True)
        calls = {"matmul_bias": 0, "bias_gelu": 0}
        orig_mb, orig_bg = mb.matmul_bias, bg.bias_gelu

        def spy(name_, fn):
            def call(*a, **k):
                calls[name_] += 1
                return fn(*a, **k)
            return call

        monkeypatch.setattr(mb, "matmul_bias", spy("matmul_bias", orig_mb))
        monkeypatch.setattr(bg, "bias_gelu", spy("bias_gelu", orig_bg))
    got = port_generate(run["tmod"], ids, NEW, run["cfg"])
    np.testing.assert_array_equal(got, run["want"])
    if name == "fused":
        # Every layer of the prefill and of each decode step took the branch.
        assert calls == {"matmul_bias": 2 * NEW, "bias_gelu": 2 * NEW}
    # The decode clone's logits, step by step, against the cacheless forward.
    smp_torch.init(run["cfg"] or {}, device="cpu")
    dec = run["tmod"].clone(decode=True, decode_cache_len=T + NEW, deterministic=True)
    seq = torch.from_numpy(run["want"]).long()
    with torch.inference_mode():
        logits = [dec(seq[:, :T])[:, -1]]
        for t in range(T, T + NEW - 1):
            logits.append(dec(seq[:, t:t + 1])[:, -1])
    got_logits = torch.stack(logits, dim=1).numpy()
    full = run["full"][:, T - 1:-1]
    np.testing.assert_allclose(got_logits, full, rtol=0, atol=1e-5 * np.abs(full).max())


def test_checkpointed_head_generates_in_inference_mode(greedy_runs):
    """The decode clone of a head trained with checkpointed layers keeps the
    flag and runs its layers plainly under inference mode: the same tokens
    as the same weights without checkpointing."""
    ids, runs = greedy_runs
    tmod = runs["checkpointed"]["tmod"]
    assert tmod.clone(decode=True, decode_cache_len=T + NEW).activation_checkpointing
    plain = port_tr.DistributedTransformerLMHead(**HEAD)
    plain.load_state_dict(tmod.state_dict())
    np.testing.assert_array_equal(port_generate(plain, ids, NEW), runs["checkpointed"]["want"])


PADDED_VARIANTS = ("learned", "neox")


@pytest.fixture(scope="module")
def padded_runs():
    """Left-padded prompts through both packages: row 1's real prompt is its
    last 5 tokens."""
    ids = prompts(seed=7)
    ids[1, :4] = 0
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    out = {}
    for name in PADDED_VARIANTS:
        jmod, params, tmod = head_pair(dict(HEAD, **VARIANTS[name]), seed=1)
        out[name] = dict(tmod=tmod, want=jax_generate(jmod, params, ids, NEW, attention_mask=mask))
    return ids, mask, out


@pytest.mark.parametrize("name", PADDED_VARIANTS)
def test_padded_prompts_equal_jax(padded_runs, name):
    ids, mask, runs = padded_runs
    tmod = runs[name]["tmod"]
    got = port_generate(tmod, ids, NEW, attention_mask=mask)
    np.testing.assert_array_equal(got, runs[name]["want"])
    # Boolean and additive masks give the same tokens.
    np.testing.assert_array_equal(port_generate(tmod, ids, NEW, attention_mask=mask.astype(bool)), got)


@pytest.mark.parametrize("name", PADDED_VARIANTS)
def test_padded_row_equals_its_unpadded_prompt(padded_runs, name):
    ids, mask, runs = padded_runs
    tmod = runs[name]["tmod"]
    got = port_generate(tmod, ids, NEW, attention_mask=mask)
    alone = port_generate(tmod, ids[1:, 4:], NEW)
    np.testing.assert_array_equal(got[1, T:], alone[0, T - 4:])
    np.testing.assert_array_equal(got[:1], port_generate(tmod, ids[:1], NEW))


@pytest.mark.parametrize("filters", [dict(temperature=0.7), dict(temperature=0.9, top_k=20, top_p=0.9)],
                         ids=["plain", "top_k_top_p"])
def test_sampled_tokens_equal_jax(filters):
    jmod, params, tmod = head_pair(dict(HEAD, **VARIANTS["neox"]), seed=2, noise=0.1)
    ids = prompts(seed=11)
    jkey = jax.random.key(5)
    want = jax_generate(jmod, params, ids, NEW, rng=jkey, **filters)
    got = port_generate(tmod, ids, NEW, rng=key_from_jax(jax.random.key_data(jkey)), **filters)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, port_generate(tmod, ids, NEW))  # it sampled


def test_bert_family_refuses_decode():
    """No causal mask size: both packages refuse to decode."""
    kw = dict(HEAD, causal_mask_size=None)
    jmod, params, tmod = head_pair(kw)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(Exception):
        jax_generate(jmod, params, ids, 2)
    with pytest.raises(SMPValidationError, match="causal self-attention"):
        port_generate(tmod, ids, 2)


def test_pad_aware_positions_refuse_decode():
    kw = dict(HEAD, position_ids_from_padding=1, num_positions=80)
    jmod, params, tmod = head_pair(kw)
    ids = prompts(B=1, length=4)
    with pytest.raises(Exception, match="position_ids_from_padding"):
        jax_generate(jmod, params, ids, 2)
    with pytest.raises(SMPValidationError, match="position_ids_from_padding"):
        port_generate(tmod, ids, 2)


@pytest.mark.parametrize("mask,match", [
    (np.ones((2, 5), np.int32), "shape"),
    (np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32), "LEFT-padded"),
], ids=["shape", "right_padded"])
def test_mask_validation(mask, match):
    tmod = port_tr.DistributedTransformerLMHead(**HEAD)
    with pytest.raises(SMPValidationError, match=match):
        port_generate(tmod, prompts(length=4), 2, attention_mask=mask)


def test_cross_attention_decode_still_refused(monkeypatch):
    """Cross-attention decodes now (``tests/test_torch_generate_seq2seq.py``):
    its first call computes the encoder K/V, later calls reuse them. Under
    tensor parallelism it is still refused."""
    layer = port_tr.DistributedAttentionLayer(4, 8, 32, cross_attention=True, decode=True, decode_cache_len=8)
    x, enc = torch.randn(2, 1, 32), torch.randn(2, 5, 32)
    first = layer(x, cross_states=enc)
    k, v = layer.cross_kv
    assert k.shape == v.shape == (2, 5, 4, 8)
    torch.testing.assert_close(layer(x, cross_states=2 * enc), first, rtol=0, atol=0)
    assert layer.cross_kv[0] is k
    monkeypatch.setattr(port_tr, "tp_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="tensor_parallel_degree"):
        layer(x, cross_states=enc)
