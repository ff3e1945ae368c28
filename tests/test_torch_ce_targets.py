"""Targets outside [0, vocab) through the port's cross-entropy, against the
JAX package's.

The JAX package takes the target logit as a one-hot contraction, so a
target outside [0, V) has target logit 0 and its loss is the row's lse, with
no gradient through a target column. The port's materialized path takes it
by a masked gather and must give the same losses and gradients; its fused
path (the plain versions behind ``ops/fused_ce.fused_lm_head_ce``, reached
through the ``_is_cuda`` seam) must give the same as its materialized one.
Targets -100 (the ignore index), -5 and V sit among in-range ones. fp32 on
both sides: the same log-softmax in another summation order, 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import cross_entropy as jax_ce
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as port_ce

V = 10
OUT_OF_RANGE = (-100, -5, V)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


def _targets(rng, shape):
    t = rng.integers(0, V, shape)
    flat = t.reshape(-1)
    for i, bad in enumerate(OUT_OF_RANGE):
        flat[2 * i + 1] = bad  # each out-of-range value beside in-range ones
    return t.astype(np.int32)


def _logits_targets(seed):
    rng = np.random.default_rng(seed)
    return (3 * rng.standard_normal((3, 5, V))).astype(np.float32), _targets(rng, (3, 5))


def _dce(reduction):
    def jax_fn(lg, t):
        return jax_ce.DistributedCrossEntropy(reduction=reduction).apply({}, lg, t)

    def port_fn(lg, t):
        return port_ce.DistributedCrossEntropy(reduction=reduction)(lg, t)

    return jax_fn, port_fn


FUNCTIONS = {
    "vocab_parallel": (jax_ce.vocab_parallel_cross_entropy, port_ce.vocab_parallel_cross_entropy),
    "masked": (jax_ce.masked_vocab_parallel_cross_entropy, port_ce.masked_vocab_parallel_cross_entropy),
    "module_mean": _dce("mean"),
    "module_sum": _dce("sum"),
    "module_none": _dce("none"),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_out_of_range_targets_match_jax(name):
    """Losses and logit gradients, fp32, 1e-5; the materialized path never
    raises on such a target."""
    jax_fn, port_fn = FUNCTIONS[name]
    logits, targets = _logits_targets(sorted(FUNCTIONS).index(name))
    jt = jnp.asarray(targets)
    want = np.asarray(jax_fn(jnp.asarray(logits), jt))
    want_grad = np.asarray(jax.grad(lambda lg: jnp.sum(jax_fn(lg, jt)))(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    got = port_fn(lg, torch.from_numpy(targets).long())
    got.sum().backward()
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), want_grad, rtol=1e-5, atol=1e-6)


def test_out_of_range_target_loss_is_the_lse():
    """The probe of the fault: a -100 or a V target's loss is its row's lse
    (no target logit), and its row's gradient is the softmax alone."""
    logits, targets = _logits_targets(0)
    lg = torch.from_numpy(logits).requires_grad_()
    t = torch.from_numpy(targets).long()
    per = port_ce.vocab_parallel_cross_entropy(lg, t)
    per.sum().backward()
    lse = torch.logsumexp(torch.from_numpy(logits), dim=-1)
    bad = (t < 0) | (t >= V)
    assert int(bad.sum()) == len(OUT_OF_RANGE)
    torch.testing.assert_close(per.detach()[bad], lse[bad], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lg.grad[bad], torch.softmax(torch.from_numpy(logits), -1)[bad], rtol=1e-6,
                               atol=1e-7)


def _head_inputs(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = (0.5 * rng.standard_normal((V, 16))).astype(np.float32)
    return h, w, _targets(rng, (2, 8))


def _port_head(h, w, t, ignore_index):
    hx = torch.from_numpy(h).requires_grad_()
    wx = torch.from_numpy(w).requires_grad_()
    per = port_ce.fused_lm_head_cross_entropy(hx, wx, torch.from_numpy(t).long(), ignore_index=ignore_index)
    per.sum().backward()
    return per.detach().numpy(), hx.grad.numpy(), wx.grad.numpy()


@pytest.mark.parametrize("ignore_index", [-100, -5])
@pytest.mark.parametrize("branch", ["materialized", "fused"])
def test_fused_lm_head_branches_match_jax(monkeypatch, branch, ignore_index):
    """Both branches of ``fused_lm_head_cross_entropy``: the materialized one
    under the default policy and the fused one (``fused_ce: True`` through
    the ``_is_cuda`` seam: the plain versions behind ``_FusedCEFn``). Each
    gives the JAX package's losses and gradients of hidden and table, fp32,
    1e-5; the ignore index gives 0, the other out-of-range targets the lse."""
    h, w, t = _head_inputs(3)

    def jax_loss(hh, ww):
        per = jax_ce.fused_lm_head_cross_entropy(hh, ww, jnp.asarray(t), ignore_index=ignore_index)
        return jnp.sum(per), per

    (_, want), (want_dh, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    if branch == "fused":
        smp_torch.init({"fused_ce": True})
        monkeypatch.setattr(port_ce, "_is_cuda", lambda x: True)
        monkeypatch.delenv("SMP_DISABLE_FUSED_CE", raising=False)
    else:
        smp_torch.init({})
        assert not port_ce._want_fused_ce(torch.from_numpy(h).reshape(-1, 16), torch.from_numpy(w))
    per, dh, dw = _port_head(h, w, t, ignore_index)
    np.testing.assert_allclose(per, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dh, np.asarray(want_dh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw, np.asarray(want_dw), rtol=1e-5, atol=1e-6)
    assert (per[t == ignore_index] == 0).all()


def test_fused_lm_head_branches_agree(monkeypatch):
    """The port's loss no longer depends on the ``fused_ce`` policy: the two
    branches give the same losses and gradients for out-of-range targets."""
    h, w, t = _head_inputs(4)
    smp_torch.init({"fused_ce": False})
    materialized = _port_head(h, w, t, -100)
    smp_torch.init({"fused_ce": True})
    monkeypatch.setattr(port_ce, "_is_cuda", lambda x: True)
    monkeypatch.delenv("SMP_DISABLE_FUSED_CE", raising=False)
    calls = []
    orig = port_ce.fce.fused_lm_head_ce
    monkeypatch.setattr(port_ce.fce, "fused_lm_head_ce", lambda *a, **k: calls.append(1) or orig(*a, **k))
    fused = _port_head(h, w, t, -100)
    assert calls == [1]
    for a, b in zip(fused, materialized):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
