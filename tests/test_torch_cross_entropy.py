"""The port's LM-head cross-entropy against the JAX package's.

Per-token losses (plain, masked with -100, label-smoothed) and their
gradients against ``nn/cross_entropy.py`` of the JAX package; the fused-CE
dispatch policy ``_want_fused_ce`` decision for decision over sizes, dtypes
and config values; loss-mode ``TransformerLM(ids, targets=...)`` at
identical weights; and, on a CUDA tensor, the dispatch to the fused kernels
(``ops/fused_ce.py``) instead of materialized logits whenever the policy
wants them.

fp32 on both sides: the losses are the same fp32 log-softmax in another
summation order, so they agree to 1e-5 on O(1) values (1e-4 through a
model, whose logits add their own summation-order differences).
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models.transformer_lm import (
    TransformerLM as JaxTransformerLM,
)
from smdistributed_modelparallel_tpu.nn import cross_entropy as jax_ce
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as port_ce
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


def _logits_targets(seed, shape=(3, 7), vocab=50, ignore_frac=0.3):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape + (vocab,))).astype(np.float32)
    targets = rng.integers(0, vocab, shape).astype(np.int32)
    targets[rng.random(shape) < ignore_frac] = -100
    return logits, targets


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_per_token_losses_and_grads_match_jax(masked, label_smoothing):
    logits, targets = _logits_targets(int(masked) * 10 + int(label_smoothing * 10),
                                      ignore_frac=0.3 if masked else 0.0)
    if masked:
        jax_fn = lambda lg: jax_ce.masked_vocab_parallel_cross_entropy(  # noqa: E731
            lg, jnp.asarray(targets), label_smoothing=label_smoothing)
        port_fn = lambda lg: port_ce.masked_vocab_parallel_cross_entropy(  # noqa: E731
            lg, torch.from_numpy(targets).long(), label_smoothing=label_smoothing)
    else:
        jax_fn = lambda lg: jax_ce.vocab_parallel_cross_entropy(  # noqa: E731
            lg, jnp.asarray(targets), label_smoothing=label_smoothing)
        port_fn = lambda lg: port_ce.vocab_parallel_cross_entropy(  # noqa: E731
            lg, torch.from_numpy(targets).long(), label_smoothing=label_smoothing)
    want = np.asarray(jax_fn(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda lg: jnp.sum(jax_fn(lg)))(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    got = port_fn(lg)
    got.sum().backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), want_grad, rtol=1e-5, atol=1e-6)
    if masked:
        assert (got.detach().numpy()[targets == -100] == 0).all()


CONFIGS = [{}, {"fused_ce": True}, {"fused_ce": False}, {"fused_ce_auto_threshold_mb": 1},
           {"fused_ce": "auto", "fused_ce_auto_threshold_mb": 64}]


SIZES = [(512, 1024), (2048, 50257), (8192, 50257), (16384, 50257), (32768, 50257), (21000, 51200)]
DTYPES = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_want_fused_ce_decides_as_jax(cfg):
    """Same decision over logits sizes around the thresholds, in fp32, bf16
    and fp16, under each config."""
    jax_smp.init(dict(cfg))
    smp_torch.init(dict(cfg))
    for N, V in SIZES:
        for jdt, tdt in DTYPES:
            want = jax_ce._want_fused_ce(SimpleNamespace(shape=(N, 8), dtype=jdt), SimpleNamespace(shape=(V, 8)))
            got = port_ce._want_fused_ce(torch.empty((N, 1), dtype=tdt), SimpleNamespace(shape=(V, 8)))
            assert got == want, (cfg, N, V, tdt)


def test_want_fused_ce_uninitialized_is_the_default_policy():
    """Before smp.init the policy is "auto" at 2048 MB, as the JAX
    package's is."""
    got = [port_ce._want_fused_ce(torch.empty((N, 1), dtype=t), SimpleNamespace(shape=(V, 8)))
           for N, V in SIZES for _, t in DTYPES]
    smp_torch.init({})
    assert got == [port_ce._want_fused_ce(torch.empty((N, 1), dtype=t), SimpleNamespace(shape=(V, 8)))
                   for N, V in SIZES for _, t in DTYPES]
    assert any(got) and not all(got)


def test_main_path_logits_materialize():
    """GPT-2 124M at 2 x 1024 tokens per microbatch, bf16: 196 MB of
    logits, below the 2048 MB default, so both packages materialize."""
    smp_torch.init({"bf16": True})
    x = torch.empty((2 * 1024, 1), dtype=torch.bfloat16)
    assert not port_ce._want_fused_ce(x, SimpleNamespace(shape=(50257, 768)))


LM = dict(vocab_size=61, max_len=32, d_model=32, n_layers=2, n_heads=4)


@pytest.mark.parametrize("variant", ["tied", "tied_smoothing", "untied"])
def test_loss_mode_transformer_matches_jax(variant):
    kw = dict(LM, tie_weights=variant != "untied",
              label_smoothing=0.1 if variant == "tied_smoothing" else 0.0)
    jmod = JaxTransformerLM(**kw)
    params = jmod.init(jax.random.key(3), jnp.zeros((1, 4), jnp.int32))["params"]
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, LM["vocab_size"], (2, 12)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)

    def jax_loss(p):
        per = jmod.apply({"params": p}, jnp.asarray(ids), targets=jnp.asarray(tgt))
        return jnp.sum(per), per

    (_, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    per = tmod(torch.from_numpy(ids).long(), targets=torch.from_numpy(tgt).long())
    per.sum().backward()
    assert per.shape == (2, 12) and (per[:, -1] == 0).all()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmod.wte.weight.grad.numpy(), np.asarray(jgrads["wte"]["embedding"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tmod.layers[1].attn.qkv.weight.grad.numpy(),
                               np.asarray(jgrads["layers"]["block"]["attn"]["qkv"]["kernel"])[1].T,
                               rtol=1e-4, atol=1e-5)


def test_loss_mode_refused_under_pipeline_parallelism(monkeypatch):
    # One device cannot hold pp = 2: smp.init refuses it, as the JAX package
    # does. The model's own refusal is held on the config installed past
    # that check.
    cfg = {"pipeline_parallel_degree": 2, "microbatches": 2}
    with pytest.raises(smp_torch.utils.exceptions.DeviceCountError):
        smp_torch.init(cfg)
    smp_torch.init({})
    monkeypatch.setattr(smp_torch.state, "cfg", smp_torch.ModelParallelConfig(cfg))
    with pytest.raises(ValueError, match="pipeline parallelism"):
        TransformerLM(**LM)(torch.zeros((1, 4), dtype=torch.long), targets=torch.zeros((1, 4), dtype=torch.long))


def _ce_inputs():
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.standard_normal((2, 512, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1000, 16)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, (2, 512))).long()
    return h, w, t


@pytest.mark.parametrize("cfg", [{"fused_ce": True}, {"fused_ce_auto_threshold_mb": 1}])
def test_cuda_refuses_to_materialize_in_place_of_the_kernel(monkeypatch, cfg):
    """On a CUDA tensor (the device check patched here), a policy that wants
    the fused kernel calls ``ops.fused_ce.fused_lm_head_ce`` (whose wrappers
    run the plain versions for these CPU tensors) and does not materialize;
    the escape hatch and fused_ce: False materialize, as in the JAX
    package."""
    from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fce

    calls = []
    orig = fce.fused_lm_head_ce
    monkeypatch.setattr(fce, "fused_lm_head_ce", lambda *a, **k: calls.append(a[0].shape) or orig(*a, **k))
    monkeypatch.setattr(port_ce, "_is_cuda", lambda x: True)
    monkeypatch.delenv("SMP_DISABLE_FUSED_CE", raising=False)
    h, w, t = _ce_inputs()  # 1024 x 1000 fp32 logits: 3.9 MB
    smp_torch.init(cfg)
    want = port_ce.vocab_parallel_cross_entropy(h @ w.t(), t)
    torch.testing.assert_close(port_ce.fused_lm_head_cross_entropy(h, w, t), want)
    assert calls == [(1024, 16)]
    monkeypatch.setenv("SMP_DISABLE_FUSED_CE", "1")
    torch.testing.assert_close(port_ce.fused_lm_head_cross_entropy(h, w, t), want)
    monkeypatch.delenv("SMP_DISABLE_FUSED_CE")
    smp_torch.init({**cfg, "fused_ce": False})
    torch.testing.assert_close(port_ce.fused_lm_head_cross_entropy(h, w, t), want)
    assert len(calls) == 1


def test_cpu_forced_fused_ce_warns_and_materializes():
    h, w, t = _ce_inputs()
    smp_torch.init({"fused_ce": True})
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Capture()
    get_logger().addHandler(handler)
    try:
        per = port_ce.fused_lm_head_cross_entropy(h, w, t, ignore_index=7)
    finally:
        get_logger().removeHandler(handler)
    assert any("fused_ce: True requested but the kernel cannot run here" in m for m in records), records
    want = port_ce.masked_vocab_parallel_cross_entropy(h @ w.t(), t, ignore_index=7)
    torch.testing.assert_close(per, want)
