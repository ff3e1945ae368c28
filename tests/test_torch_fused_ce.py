"""The port's fused LM-head cross-entropy against the JAX package's.

``ops/fused_ce.py``'s plain versions (what the wrappers run on CPU tensors,
and what the card holds the CUDA kernels against) against the Pallas
kernels of ``ops/pallas_ce.py`` run in interpret mode (``FORCE_INTERPRET``,
as ``tests/test_pallas_ce.py`` runs them), on numpy inputs from a seed:
  - forward statistics, dx and dW on ``TestKernelParity``'s shape (N 50,
    V 200, D 32, blocks 16/64, so both paddings are exercised), with label
    smoothing, bf16 inputs, ``smooth_denom`` != V and targets outside
    [0, V): fp32 1e-4; bf16 dx/dW, rounded to bf16 on both sides after fp32
    sums in another order, 1e-2 of the largest value;
  - ``fused_lm_head_ce`` (through ``_FusedCEFn``) against JAX
    ``pc.fused_lm_head_ce``: losses and the gradients of x and w;
  - the dispatcher (``ignore_index``; ``auto_blocks`` and ``fused_ce_ok``);
  - loss-mode ``TransformerLM`` under ``fused_ce: True`` with the card's
    branch taken (``_is_cuda`` patched, so the plain versions run through
    ``_FusedCEFn``): per-token losses and gradients, 1e-4;
  - 3 steps of ``@smp.step`` with ``fused_ce: True`` against the JAX step,
    loss for loss at ``tests/test_torch_step.py``'s tolerances (losses rtol
    2e-4, parameters rtol 2e-3 / atol 2e-4).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.nn import cross_entropy as jax_ce
from smdistributed_modelparallel_tpu.ops import pallas_ce as pc
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as port_ce
from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fce

N, V, D, BN, BV = 50, 200, 32, 16, 64


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


@pytest.fixture
def interpret_kernels():
    pc.FORCE_INTERPRET = True
    yield
    pc.FORCE_INTERPRET = False


@pytest.fixture
def card_branch(monkeypatch):
    """The dispatcher takes the card's branch on CPU tensors; the calls that
    reach ``ops.fused_ce.fused_lm_head_ce`` are recorded as (x's shape,
    x's dtype, w's dtype)."""
    calls = []
    orig = fce.fused_lm_head_ce
    monkeypatch.setattr(port_ce, "_is_cuda", lambda x: True)
    monkeypatch.setattr(fce, "fused_lm_head_ce",
                        lambda *a, **k: calls.append((a[0].shape, a[0].dtype, a[1].dtype)) or orig(*a, **k))
    monkeypatch.delenv("SMP_DISABLE_FUSED_CE", raising=False)
    return calls


def _inputs(seed=0, dtype=np.float32, oob=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, D))).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    if oob:
        # Outside [0, V) and outside the TPU kernel's padded [0, 256) too,
        # where its padding columns would otherwise be hit.
        t[::7] = -3
        t[3::7] = 300
    g = rng.random(N).astype(np.float32)
    g[::5] = 0.0  # ignored rows
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, dtype))
        w = np.asarray(jnp.asarray(w, dtype))
    return x, w, t, g


def _both(a, jdtype):
    """(jax array, torch tensor) of one numpy array, in ``jdtype``."""
    j = jnp.asarray(a, jdtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jdtype])


CASES = {
    "plain": dict(),
    "smoothing": dict(smoothing=0.1),
    "smoothing_denom": dict(smoothing=0.1, smooth_denom=333),
    "oob_targets": dict(oob=True),
    "oob_smoothing": dict(oob=True, smoothing=0.1),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_pallas_kernels(interpret_kernels, case, dtype):
    kw = CASES[case]
    eps, denom = kw.get("smoothing", 0.0), kw.get("smooth_denom")
    x, w, t, g = _inputs(seed=len(case), oob=kw.get("oob", False))
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)

    want = pc._fused_ce_fwd_impl(jx, jw, jt, BN, BV, True, eps)
    got = fce.fused_ce_fwd(tx, tw, tt, eps, block_v=BV)  # CPU tensors: the plain version
    for name, a, b in zip(("lse", "tgt", "logit_sum"), got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
    if kw.get("oob"):
        assert (got[1][::7] == 0).all() and (got[1][3::7] == 0).all()

    lse = want[0]
    dx_want, dw_want = pc._fused_ce_bwd_impl(jx, jw, jt, lse, jg, BN, BV, True, eps, denom)
    tlse = torch.from_numpy(np.array(lse))
    dx = fce.fused_ce_bwd_dx(tx, tw, tt, tlse, tg, eps, denom, block_v=BV)
    dw = fce.fused_ce_bwd_dw(tx, tw, tt, tlse, tg, eps, denom, block_v=BV)
    tol = 1e-4 if dtype == jnp.float32 else 1e-2
    for name, a, b in (("dx", dx, dx_want), ("dw", dw, dw_want)):
        assert a.dtype == tx.dtype and a.shape == b.shape
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max()
        assert err <= tol * max(np.abs(b).max(), 1e-6), (name, err)
    assert (dx[::5] == 0).all()


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_fused_lm_head_ce_matches_jax(interpret_kernels, label_smoothing):
    x, w, t, _ = _inputs(seed=7)

    def jax_loss(x, w):
        per = pc.fused_lm_head_ce(x, w, jnp.asarray(t), BN, BV, True, label_smoothing)
        return jnp.mean(per), per

    (_, want), (gx_want, gw_want) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    per = fce.fused_lm_head_ce(tx, tw, torch.from_numpy(t), BN, BV, label_smoothing)
    per.mean().backward()
    assert per.dtype == torch.float32 and per.grad_fn is not None
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw_want), rtol=1e-4, atol=1e-6)
    if not label_smoothing:
        ref = fce.reference_lm_head_ce(tx.detach(), tw.detach(), torch.from_numpy(t))
        np.testing.assert_allclose(per.detach().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_dispatcher_ignore_index_masks_loss_and_grads(interpret_kernels, card_branch):
    """As ``test_pallas_ce.py::TestDispatcher``: ignored rows give 0 loss and
    0 gradient, and the losses are the JAX dispatcher's."""
    jax_smp.init({"microbatches": 1, "fused_ce": True})
    smp_torch.init({"microbatches": 1, "fused_ce": True})
    x, w, t, _ = _inputs(seed=3)
    h = x[:24].reshape(2, 12, D)
    tt = t[:24].reshape(2, 12).copy()
    tt[:, -3:] = -100
    want = jax.jit(lambda h, w: jax_ce.fused_lm_head_cross_entropy(h, w, jnp.asarray(tt)))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    per = port_ce.fused_lm_head_cross_entropy(th, torch.from_numpy(w), torch.from_numpy(tt).long())
    per.sum().backward()
    assert card_branch == [((24, D), torch.float32, torch.float32)]
    assert per.shape == (2, 12)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert (per[:, -3:] == 0).all() and (th.grad[:, -3:] == 0).all()
    assert th.grad[:, :-3].abs().max() > 0


def test_auto_blocks_and_fused_ce_ok_contract(monkeypatch):
    """The reference tiling: explicit values win, else the TPU defaults; the
    kernels stream D, so no D loses the kernel. ``fused_ce_ok`` is False off
    the card and under the escape hatch, True on the card for any D."""
    monkeypatch.delenv("SMP_DISABLE_FUSED_CE", raising=False)
    for d in (64, 768, 1600, 4096, 8192):
        assert fce.auto_blocks(d) == (256, 1024)
    assert fce.auto_blocks(4096, 256, 1024) == (256, 1024)  # the TPU refuses this one
    assert fce.auto_blocks(768, block_n=64) == (64, 1024)
    assert fce.auto_blocks(4096, block_v=256) == (256, 256)
    x, w = torch.zeros(4, 8192), torch.zeros(16, 8192)
    assert not fce.fused_ce_ok(x, w)  # a CPU tensor
    assert not fce.fused_ce_disabled()
    # fused_ce_ok reads only the device of x: a stand-in on the card.
    on_card = types.SimpleNamespace(is_cuda=True, shape=x.shape)
    assert fce.fused_ce_ok(on_card, w)
    assert fce.fused_ce_ok(on_card, w, 256, 1024)
    monkeypatch.setenv("SMP_DISABLE_FUSED_CE", "1")
    assert fce.fused_ce_disabled()
    assert not fce.fused_ce_ok(on_card, w)


def test_wrappers_count_only_kernel_launches():
    x, w, t, g = _inputs(seed=4)
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dx.launches, fce.fused_ce_bwd_dw.launches)
    tx, tw, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    lse, _, _ = fce.fused_ce_fwd(tx, tw, tt)
    fce.fused_ce_bwd_dx(tx, tw, tt, lse, torch.from_numpy(g))
    fce.fused_ce_bwd_dw(tx, tw, tt, lse, torch.from_numpy(g))
    assert (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dx.launches, fce.fused_ce_bwd_dw.launches) == before
    assert fce._LIB is None  # nothing is built for CPU tensors


def test_distributed_cross_entropy_module_matches_jax():
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    t = rng.integers(0, 40, (3, 5)).astype(np.int32)
    for reduction in ("mean", "sum", "none"):
        jmod = jax_ce.DistributedCrossEntropy(reduction=reduction, label_smoothing=0.1)
        want = jmod.apply({}, jnp.asarray(logits), jnp.asarray(t))
        got = smp_torch.nn.DistributedCrossEntropy(reduction, 0.1)(torch.from_numpy(logits),
                                                                   torch.from_numpy(t).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


LM = dict(vocab_size=64, max_len=16, d_model=16, n_layers=2, n_heads=2)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_loss_mode_transformer_through_fused_ce_matches_jax(interpret_kernels, card_branch, label_smoothing):
    jax_smp.init({"microbatches": 1, "fused_ce": True})
    smp_torch.init({"microbatches": 1, "fused_ce": True})
    kw = dict(LM, label_smoothing=label_smoothing)
    jmod = JaxTransformerLM(**kw)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, LM["vocab_size"], (2, 12)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)
    params = jmod.init(jax.random.key(1), jnp.asarray(ids))["params"]

    def jax_loss(p):
        per = jmod.apply({"params": p}, jnp.asarray(ids), targets=jnp.asarray(tgt))
        return jnp.sum(per), per

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    per = tmod(torch.from_numpy(ids).long(), targets=torch.from_numpy(tgt).long())
    per.sum().backward()
    assert card_branch == [((24, LM["d_model"]), torch.float32, torch.float32)]
    assert per.shape == (2, 12) and (per[:, -1] == 0).all()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmod.wte.weight.grad.numpy(), np.asarray(jgrads["wte"]["embedding"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tmod.ln_f.weight.grad.numpy(), np.asarray(jgrads["ln_f"]["scale"]),
                               rtol=1e-4, atol=1e-5)


def test_loss_mode_trains_as_jax_under_smp_step(interpret_kernels, card_branch):
    """``test_pallas_ce.py::test_loss_mode_trains_under_smp_step`` in both
    packages from the same weights and batch: 3 steps, loss for loss."""
    ids = np.random.default_rng(0).integers(0, LM["vocab_size"], (4, 16)).astype(np.int32)
    cfg = {"microbatches": 2, "fused_ce": True}

    jax_smp.init(dict(cfg))
    jmodel = jax_smp.DistributedModel(JaxTransformerLM(**LM))
    jopt = jax_smp.DistributedOptimizer(optax.adam(1e-2), jmodel)

    @jax_smp.step
    def jax_step(model, batch):
        tgt = jnp.concatenate([batch[:, 1:], jnp.full_like(batch[:, :1], -100)], axis=1)
        per = model(batch, targets=tgt)
        loss = jnp.sum(per) / (per.shape[0] * (per.shape[1] - 1))
        model.backward(loss)
        return loss

    want, init = [], None
    for _ in range(3):
        out = jax_step(jmodel, jnp.asarray(ids))
        if init is None:
            init = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params)))
        want.append(float(out.reduce_mean()))
        jopt.step()
    want_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params)))

    smp_torch.init(dict(cfg), device="cpu")
    module = TransformerLM(**LM)
    module.load_state_dict(init, strict=True)
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8), model)

    @smp_torch.step
    def port_step(model, batch):
        tgt = torch.cat([batch[:, 1:], torch.full_like(batch[:, :1], -100)], dim=1)
        per = model(batch, targets=tgt)
        loss = per.sum() / (per.shape[0] * (per.shape[1] - 1))
        model.backward(loss)
        return loss

    losses = []
    for _ in range(3):
        losses.append(float(port_step(model, torch.from_numpy(ids).long()).reduce_mean()))
        opt.step()
    assert len(card_branch) == 3 * 2  # every microbatch of every step
    np.testing.assert_allclose(losses, want, rtol=2e-4)
    assert losses[-1] < losses[0]
    sd = model.state_dict()
    d = LM["d_model"]
    for name, w in want_params.items():
        got, w = sd[name].numpy(), np.asarray(w)
        if name.endswith("attn.qkv.bias"):
            # The key bias: softmax ignores a per-row shift, so its gradient
            # is zero but for rounding, and Adam moves it by ~lr in a
            # direction the rounding picks. Its q and v parts are held.
            got, w = np.delete(got, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(got, w, rtol=2e-3, atol=2e-4, err_msg=name)


def test_bf16_step_sends_the_half_table_to_the_kernel(card_branch):
    """Under bf16 the tied ``wte.weight`` reaches the kernel in bf16, as the
    activations do, so dW comes back in bf16 and the step sums it into the
    fp32 master gradient (the JAX package's ``dw.astype(w.dtype)``)."""
    smp_torch.init({"microbatches": 2, "bf16": True, "fused_ce": True}, device="cpu")
    model = smp_torch.DistributedModel(TransformerLM(**LM))
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, LM["vocab_size"], (4, 16))).long()

    @smp_torch.step
    def port_step(model, batch):
        tgt = torch.cat([batch[:, 1:], torch.full_like(batch[:, :1], -100)], dim=1)
        loss = model(batch, targets=tgt).mean()
        model.backward(loss)
        return loss

    loss = float(port_step(model, ids).reduce_mean())
    assert card_branch == [((32, LM["d_model"]), torch.bfloat16, torch.bfloat16)] * 2
    grad = model.grads["wte.weight"]
    assert np.isfinite(loss) and grad.dtype == torch.float32
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
