"""The port's ``smp.nn`` transformer family against the JAX package's.

The same numpy inputs from a seed go through both packages on the CPU:
  - ``attention_core``'s per-layer arguments (``extra_scale``,
    ``qk_compensation``, ``local_select``, ``use_pallas``) against the JAX
    ``attention_core``: fp32 1e-6, bf16 inputs 1e-2 (probabilities rounded
    to bf16 against the same fp32 scores);
  - ``convert.lm_head_params_from_jax`` on a JAX init of ``TINY`` (the
    config of ``tests/test_tp_overlap.py``), loaded with ``strict=True``;
  - ``DistributedTransformerLMHead`` logits on converted weights (every
    leaf perturbed from its init, so biases and layernorms are not trivial),
    over the layer variants: fp32 1e-5 (the same operations, summed in other
    orders, twelve LayerNorm/softmax stages deep); the fused knobs in bf16,
    both packages through their kernels' plain versions at the same rounding
    points: 2e-2 of the logits' largest value;
  - ``DistributedTransformer`` (gated MLP, RMS norms, no MLP bias) and
    ``DistributedTransformerLayer`` with cross-attention: fp32 1e-5;
  - 3 steps of ``@smp.step`` training (``microbatches: 2``, ``fused_qkv``,
    ``fused_bias_gelu=True``, SGD 0.1) with the fused branch taken on CPU
    tensors (the ``_is_cuda`` seams), against the JAX run with the Pallas
    kernels in interpret mode: losses, gradients and parameters to atol
    2e-5, as ``test_fused_qkv_parity_tp1`` holds the JAX package's own;
  - the dispatch switches and what is not ported yet.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.ops import attention as jax_attention
from smdistributed_modelparallel_tpu.ops import pallas_gelu, pallas_qkv
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import moe as port_moe
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.ops import attention as port_attention
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

TINY = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8,
    hidden_size=32, intermediate_size=64, vocab_size=96, num_positions=32,
    causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0,
    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
B, T = 2, 16


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


@pytest.fixture
def fused_branch(monkeypatch):
    """Both packages take their fused branch on the CPU: the JAX Pallas
    kernels in interpret mode, the port's kernels' plain versions through
    the ``_is_cuda`` seams. Returns the port's calls, by kernel."""
    monkeypatch.setattr(pallas_qkv, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_gelu, "FORCE_INTERPRET", True)
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bg, "_is_cuda", lambda t: True)
    calls = {"matmul_bias": 0, "bias_gelu": 0}
    orig_mb, orig_bg = mb.matmul_bias, bg.bias_gelu

    def spy_mb(*a, **k):
        calls["matmul_bias"] += 1
        return orig_mb(*a, **k)

    def spy_bg(*a, **k):
        calls["bias_gelu"] += 1
        return orig_bg(*a, **k)

    monkeypatch.setattr(mb, "matmul_bias", spy_mb)
    monkeypatch.setattr(bg, "bias_gelu", spy_bg)
    return calls


def _ids(seed=0, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _perturbed(params, seed):
    """Every leaf of a JAX init moved by 0.1 * N(0, 1) noise from a seed."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)


def _port_lm_head(kw, params, dtype=torch.float32):
    mod = port_tr.DistributedTransformerLMHead(**kw)
    mod.load_state_dict(lm_head_params_from_jax(params), strict=True)
    return mod.to(dtype)


# ----------------------------------------------------------------------
# attention_core's per-layer arguments
# ----------------------------------------------------------------------

CORE_CASES = {
    "extra_scale": dict(extra_scale=1.0 / 3.0),
    "qk_compensation": dict(qk_compensation=4.0),
    "both_scales": dict(extra_scale=0.5, qk_compensation=2.0, scale=0.3),
    "local_select_true": dict(window=4, local_select=True),
    "local_select_false": dict(window=4, local_select=False),
    "non_causal_window_local_false": dict(causal=False, window=3, local_select=False),
    "use_pallas_false": dict(use_pallas=False),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_attention_core_arguments_match_jax(monkeypatch, case, dtype):
    kw = CORE_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal((B, T, 4, 8)).astype(np.float32) for _ in range(3))
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jkw = dict(kw)
    for name in ("extra_scale", "qk_compensation"):
        if name in jkw:  # the JAX layers pass these as traced fp32 scalars
            jkw[name] = jnp.float32(jkw[name])
    if "local_select" in jkw:
        jkw["local_select"] = jnp.asarray(jkw["local_select"])
    want = jax_attention.attention_core(*(jnp.asarray(a, jd) for a in (q, k, v)), **jkw)
    took_kernel = []
    if "local_select" in kw or kw.get("use_pallas") is False:
        # The kernel path's gate forced open: these keep the plain path all
        # the same.
        monkeypatch.setattr(port_attention, "_kernel_ok", lambda *a: True)
        monkeypatch.setattr(port_attention, "flash_attention", lambda *a, **k: took_kernel.append(1))
    got = port_attention.attention_core(*(torch.from_numpy(a).to(td) for a in (q, k, v)), **kw)
    assert not took_kernel
    tol = 1e-6 if dtype == "fp32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=0, atol=tol)


# ----------------------------------------------------------------------
# Weights carried across
# ----------------------------------------------------------------------


def test_lm_head_params_from_jax_loads_strict():
    jmod = jax_tr.DistributedTransformerLMHead(**TINY)
    params = jmod.init(jax.random.key(0), jnp.asarray(_ids()))["params"]
    sd = lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    mod = port_tr.DistributedTransformerLMHead(**TINY)
    assert set(sd) == set(mod.state_dict())
    mod.load_state_dict(sd, strict=True)
    qkv = np.asarray(params["transformer"]["seq_layers"]["layer"]["attention"]["qkv/kernel"][1])  # [D, 3, H, hd]
    # Column (c, h, k) of layer 1's qkv weight is the flax kernel's [:, c, h, k].
    np.testing.assert_array_equal(sd["transformer.seq_layers.1.attention.qkv.weight"][2 * 32 + 1 * 8 + 3].numpy(),
                                  qkv[:, 2, 1, 3])
    with pytest.raises(KeyError, match="unexpected"):
        lm_head_params_from_jax({"transformer": {"seq_layers": {"layer": {"attention": {"rope/kernel": qkv[None]}}}}})
    with pytest.raises(KeyError, match="unexpected"):
        lm_head_params_from_jax({"pooler": {"kernel": np.zeros((3, 3))}})


# ----------------------------------------------------------------------
# Forward: logits on converted weights
# ----------------------------------------------------------------------

VARIANTS = {
    "pre_ln_embedding_ln_token_types": dict(use_embedding_layernorm=True, num_token_types=3),
    "post_ln_fp32_residual_untied_head": dict(pre_layernorm=False, post_layernorm=True, final_layernorm=False,
                                              fp32_residual_addition=True, tie_input_output_embedding=False,
                                              use_lm_head_bias=True),
    "parallel_gptj_rotary_window": dict(parallel_attn_output=True, single_pre_layernorm=True, rotary_dim=4,
                                        use_positional_embedding=False, window_size=5, attention_in_fp32=True,
                                        distribute_embedding=True),
    "parallel_neox_rotary_layer_idx_scalings_no_bias": dict(
        parallel_attn_output=True, rotary_dim=6, gpt_neox_type_rotary=True, rotary_emb_base=500.0,
        scale_attn_by_layer_idx=True, query_key_layer_scaling=True, use_qkv_bias=False,
        use_attn_dense_bias=False),
    "local_global_window": dict(attention_layers_type=("local", "global"), window_size=4),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lm_head_logits_match_jax(variant):
    kw = dict(TINY, **VARIANTS[variant])
    ids = _ids(1)
    extra = {}
    if kw.get("num_token_types"):
        extra["token_type_ids"] = np.random.default_rng(2).integers(0, 3, (B, T)).astype(np.int32)
    jmod = jax_tr.DistributedTransformerLMHead(**kw)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    params = _perturbed(jmod.init(jax.random.key(0), jnp.asarray(ids), **jextra)["params"], seed=3)
    want = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(ids), **jextra))(params))
    mod = _port_lm_head(kw, params)
    got = mod(torch.from_numpy(ids).long(), **{k: torch.from_numpy(v).long() for k, v in extra.items()})
    assert got.shape == (B, T, kw["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lm_head_fused_knobs_match_jax(fused_branch, dtype):
    """fused_qkv and fused_bias_gelu on in both packages, each through its
    kernel (JAX: the Pallas kernels in interpret mode; the port: the plain
    versions), on bf16-cast or fp32 weights; the unfused port forward agrees
    too in fp32 (where both round at the same points)."""
    kw = dict(TINY, fused_bias_gelu=True)
    ids = _ids(4)
    jmod = jax_tr.DistributedTransformerLMHead(**kw)
    params = _perturbed(jmod.init(jax.random.key(0), jnp.asarray(ids))["params"], seed=5)
    jax_smp.init({"fused_qkv": True})
    smp_torch.init({"fused_qkv": True}, device="cpu")
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), params)
    want = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(ids)))(jparams).astype(jnp.float32))
    mod = _port_lm_head(kw, params, td)
    got = mod(torch.from_numpy(ids).long()).float().detach().numpy()
    assert fused_branch == {"matmul_bias": 2, "bias_gelu": 2}  # one of each per layer
    tol = 1e-5 if dtype == "fp32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if dtype == "fp32":
        smp_torch.init({"fused_qkv": False}, device="cpu")
        unfused = _port_lm_head(dict(kw, fused_bias_gelu=False), params)(torch.from_numpy(ids).long())
        assert fused_branch == {"matmul_bias": 2, "bias_gelu": 2}
        np.testing.assert_allclose(unfused.detach().numpy(), want, rtol=0, atol=1e-5)


def test_use_pallas_kernels_false_keeps_every_kernel_off(fused_branch, monkeypatch):
    smp_torch.init({"fused_qkv": True, "use_pallas_kernels": False}, device="cpu")
    monkeypatch.setattr(port_attention, "_kernel_ok", lambda *a: True)
    flash = []
    monkeypatch.setattr(port_attention, "flash_attention", lambda *a, **k: flash.append(1))
    mod = port_tr.DistributedTransformerLMHead(**dict(TINY, fused_bias_gelu=True))
    out = mod(torch.from_numpy(_ids()).long())
    assert torch.isfinite(out).all()
    assert fused_branch == {"matmul_bias": 0, "bias_gelu": 0} and not flash


def _stacked(layer_params):
    """A single layer's (or a stack's) flax params under the LM head's
    layer path, so ``lm_head_params_from_jax`` names them."""
    return {"transformer": {"seq_layers": {"layer": layer_params}}}


def _strip(sd, prefix):
    return {k.removeprefix(prefix): v for k, v in sd.items()}


def test_transformer_stack_gated_rms_matches_jax():
    kw = dict(num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=48,
              attention_dropout_prob=0.0, hidden_dropout_prob=0.0, causal_mask_size=32, pre_layernorm=True,
              post_layernorm=False, layernorm_type="rms", use_mlp_bias=False, gated_mlp=True, activation="silu")
    x = np.random.default_rng(6).standard_normal((B, T, 32)).astype(np.float32)
    jmod = jax_tr.DistributedTransformer(**kw)
    params = _perturbed(jmod.init(jax.random.key(1), jnp.asarray(x))["params"], seed=7)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = port_tr.DistributedTransformer(**kw)
    mod.load_state_dict(_strip(lm_head_params_from_jax(_stacked(params["seq_layers"]["layer"])), "transformer."),
                        strict=True)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), want, rtol=0, atol=1e-5)


def test_layer_with_cross_attention_matches_jax():
    kw = dict(num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
              attention_dropout_prob=0.0, hidden_dropout_prob=0.0, add_cross_attention=True, pre_layernorm=True,
              post_layernorm=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    cs = rng.standard_normal((B, 11, 32)).astype(np.float32)
    jmod = jax_tr.DistributedTransformerLayer(**kw)
    params = _perturbed(jmod.init(jax.random.key(2), jnp.asarray(x), cross_states=jnp.asarray(cs))["params"], 9)
    want = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(x), cross_states=jnp.asarray(cs)))(
        params))
    mod = port_tr.DistributedTransformerLayer(**kw)
    stacked = jax.tree_util.tree_map(lambda a: a[None], params)
    mod.load_state_dict(_strip(lm_head_params_from_jax(_stacked(stacked)), "transformer.seq_layers.0."),
                        strict=True)
    got = mod(torch.from_numpy(x), cross_states=torch.from_numpy(cs))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Training: 3 fused-knob steps against the JAX run
# ----------------------------------------------------------------------


def test_fused_training_matches_jax(fused_branch):
    """``test_fused_qkv_parity_tp1``'s run, with ``fused_bias_gelu`` too, in
    both packages from the same weights and batch."""
    cfg = {"microbatches": 2, "fused_qkv": True}
    kw = dict(TINY, fused_bias_gelu=True)
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (4, T)).astype(np.int32)

    jax_smp.init(dict(cfg))
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**kw))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, batch):
        logits = model(batch)
        loss = jnp.mean(jax_vpce(logits[:, :-1], batch[:, 1:]))
        model.backward(loss)
        return loss

    def tree(t):
        return lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(t)))

    want, init = [], None
    for _ in range(3):
        want.append(float(jax_step(jmodel, jnp.asarray(ids)).reduce_mean()))
        init = init or tree(jmodel.params)
        want_grads = tree(jmodel.grads)
        jopt.step()
    want_params = tree(jmodel.params)

    smp_torch.init(dict(cfg), device="cpu")
    module = port_tr.DistributedTransformerLMHead(**kw)
    module.load_state_dict(init, strict=True)
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def port_step(model, batch):
        logits = model(batch)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], batch[:, 1:]).mean()
        model.backward(loss)
        return loss

    losses = []
    for _ in range(3):
        losses.append(float(port_step(model, torch.from_numpy(ids).long()).reduce_mean()))
        grads = {k: v.clone() for k, v in model.grads.items()}
        opt.step()
    # Every layer of every microbatch of every step went through both kernels.
    assert fused_branch == {"matmul_bias": 3 * 2 * 2, "bias_gelu": 3 * 2 * 2}
    np.testing.assert_allclose(losses, want, rtol=0, atol=2e-5)
    assert losses[-1] < losses[0]
    assert grads.keys() == want_grads.keys()
    for name, w in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=0, atol=2e-5, err_msg=name)
    for name, w in want_params.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), w.numpy(), rtol=0, atol=2e-5, err_msg=name)


# ----------------------------------------------------------------------
# What is not ported yet
# ----------------------------------------------------------------------


@pytest.mark.parametrize("build, what", [
    # MoE (tests/test_torch_moe.py) and cross-attention under decode
    # (tests/test_torch_generate_seq2seq.py) run now; under tensor
    # parallelism they do not yet.
    (lambda: port_moe.DistributedMoE(32, 64, 2)(torch.zeros(1, 4, 32)), "tensor_parallel_degree"),
    (lambda: port_tr.DistributedAttentionLayer(4, 8, 32, cross_attention=True, decode=True, decode_cache_len=32)(
        torch.zeros(1, 1, 32), cross_states=torch.zeros(1, 3, 32)), "tensor_parallel_degree"),
], ids=["moe", "decode"])
def test_left_out_features_raise(build, what, monkeypatch):
    monkeypatch.setattr(port_tr, "tp_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=what):
        build()


def test_decode_clone_matches_jax_forward():
    """``clone(decode=True)`` of ``TINY`` (pre-LN, learned positions): a
    prefill and single-token steps through the KV caches give the JAX
    module's cacheless logits at every position (fp32, 1e-5), and the clone
    shares the module's parameters."""
    jmod = jax_tr.DistributedTransformerLMHead(**TINY)
    ids = _ids(seed=4)
    params = _perturbed(jmod.init(jax.random.key(0), jnp.asarray(ids))["params"], seed=5)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    mod = _port_lm_head(TINY, params)
    dec = mod.clone(decode=True, decode_cache_len=T, deterministic=True)
    assert dec.decode and dec.word_embedding.weight.data_ptr() == mod.word_embedding.weight.data_ptr()
    x = torch.from_numpy(ids).long()
    with torch.inference_mode():
        got = torch.cat([dec(x[:, :5])] + [dec(x[:, t:t + 1]) for t in range(5, T)], dim=1).numpy()
    assert dec.position_index == T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_training_dropout_and_tp_raise(monkeypatch):
    """Training-mode dropout outside an ``@smp.step`` has no key and raises,
    as flax's ``make_rng`` does in the JAX package (inside a step it runs:
    ``tests/test_torch_dropout_step.py``). Tensor parallelism is ported
    (``tests/test_torch_tp_*.py``): the head runs at tp = 2, and what stays
    refused there (a MoE layer) raises naming ROADMAP item 7."""
    mod = port_tr.DistributedTransformerLMHead(**dict(TINY, attention_dropout_prob=0.1))
    ids = torch.from_numpy(_ids()).long()
    smp_torch.init({}, device="cpu")
    model = smp_torch.DistributedModel(mod)
    with pytest.raises(SMPValidationError, match="needs PRNG for 'dropout'"):
        model(ids)
    model.eval()
    assert torch.isfinite(model(ids)).all()
    monkeypatch.setattr(port_tr, "tp_size", lambda: 2)
    assert torch.isfinite(model(ids)).all()
    moe = smp_torch.DistributedModel(port_tr.DistributedTransformerLMHead(**dict(TINY, num_experts=2))).eval()
    with pytest.raises(NotImplementedError, match="tensor_parallel_degree > 1 .*ROADMAP item 7"):
        moe(ids)
