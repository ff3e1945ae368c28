"""The port's training step against the JAX package's.

``@smp.step`` + ``smp.DistributedOptimizer`` of the port (torch optimizers)
and of the JAX package (optax) train the same model from identical weights
on the same numpy batches; per-step losses and the updated parameters must
agree:
  - an MLP with SGD at 1 and 4 microbatches, at ``tests/test_step.py``'s
    tolerances (losses rtol 2e-4 / atol 2e-5, params rtol 2e-3 / atol 2e-4);
  - GPT-2 at the CPU smoke shape of ``bench.py`` (d 128, 2 layers, 4 heads,
    vocab 50257, batch 4, 4 microbatches), seq 128, fp32, AdamW(1e-4) for 5
    steps, in loss mode and in logits mode: losses rtol 2e-4, params rtol
    2e-3 / atol 2e-4 (fp32 throughout; summation order differs);
  - the same in bf16 for 3 steps: both packages round the same values to
    bf16 at different points, so losses agree to 2e-2 relative and the
    first step's gradients to 5e-2 of each leaf's largest gradient;
plus fp16 overflow handling, the loss-scaler arithmetic, and the usage
errors and warnings of ``tests/test_step.py``.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.backend.state import state as jax_state
from smdistributed_modelparallel_tpu.fp16.loss_scaler import DynamicLossScaler as JaxDynamicLossScaler
from smdistributed_modelparallel_tpu.fp16.loss_scaler import LossScaler as JaxLossScaler
from smdistributed_modelparallel_tpu.amp import GradScaler as JaxGradScaler
from smdistributed_modelparallel_tpu.models.gpt2 import gpt2_124m as jax_gpt2_124m
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.amp import GradScaler
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler, LossScaler
from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m
from smdistributed_modelparallel_tpu_torch.utils.exceptions import DeviceCountError, PartitionError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from tests.models import MLP, softmax_xent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's tensors are small, so torch's thread
    pool costs more than it gives (8 threads took 25x longer than one for
    the dropout hash), and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


# ----------------------------------------------------------------------
# MLP with SGD
# ----------------------------------------------------------------------


class TorchMLP(nn.Module):
    """``tests.models.MLP`` in torch: Dense(32), relu, Dense(16), relu,
    Dense(4), with the flax names."""

    def __init__(self, din=8, features=(32, 16, 4)):
        super().__init__()
        dims = (din,) + tuple(features)
        for i in range(len(features)):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n = len(features)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def torch_xent(logits, labels):
    return -torch.log_softmax(logits.float(), dim=-1).gather(-1, labels[:, None].long())[:, 0]


def _mlp_data():
    rng = np.random.default_rng(0)
    return rng.standard_normal((16, 8)).astype(np.float32), rng.integers(0, 4, 16).astype(np.int32)


def _mlp_state_dict(flax_params):
    return {f"{layer}.{'weight' if k == 'kernel' else 'bias'}":
            torch.tensor(np.asarray(v).T if k == "kernel" else np.asarray(v))
            for layer, leaves in flax_params.items() for k, v in leaves.items()}


def _jax_mlp_run(num_mb, x, y, steps=5, cfg=None):
    """The JAX package's MLP training: (init params, per-step losses, final
    params), as tests/test_step.py runs it."""
    jax_smp.init({"microbatches": num_mb, **(cfg or {})})
    model = jax_smp.DistributedModel(MLP())
    optimizer = jax_smp.DistributedOptimizer(optax.sgd(0.1), model)

    @jax_smp.step
    def train_step(model, xb, yb):
        loss = jnp.mean(softmax_xent(model(xb), yb))
        model.backward(loss)
        return loss

    losses, init = [], None
    for _ in range(steps):
        out = train_step(model, jnp.asarray(x), jnp.asarray(y))
        if init is None:
            init = jax.tree_util.tree_map(np.asarray, jax.device_get(model.params))
        losses.append(float(out.reduce_mean()))
        optimizer.step()
    return init, losses, jax.tree_util.tree_map(np.asarray, jax.device_get(model.params))


def _port_mlp(init, cfg):
    smp.init(cfg, device="cpu")
    module = TorchMLP()
    module.load_state_dict(_mlp_state_dict(init))
    model = smp.DistributedModel(module)
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    half = state.cfg.half_dtype

    @smp.step
    def train_step(model, xb, yb):
        # flax's Dense promotes its input to the parameters' dtype; a torch
        # Linear wants the caller to.
        loss = torch_xent(model(xb.to(half or xb.dtype)), yb).mean()
        model.backward(loss)
        return loss

    return model, optimizer, train_step


@pytest.mark.parametrize("num_mb", [1, 4])
def test_mlp_parity_vs_jax_step(num_mb):
    x, y = _mlp_data()
    init, want_losses, want_params = _jax_mlp_run(num_mb, x, y)
    model, optimizer, train_step = _port_mlp(init, {"microbatches": num_mb})
    losses = []
    for _ in range(5):
        out = train_step(model, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(out.reduce_mean()))
        optimizer.step()
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    sd = model.state_dict()
    for name, want in _mlp_state_dict(want_params).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=2e-3, atol=2e-4, err_msg=name)


# ----------------------------------------------------------------------
# GPT-2 at the CPU smoke shape of bench.py
# ----------------------------------------------------------------------

SMOKE = dict(max_len=128, d_model=128, n_layers=2, n_heads=4)
BATCH, SEQ, NUM_MB = 4, 128, 4


def _ids():
    return np.random.default_rng(5).integers(0, 50257, (BATCH, SEQ)).astype(np.int32)


def _jax_ce_loss(logits, ids):
    lg = logits[:, :-1]
    tgt = jnp.take_along_axis(lg, ids[:, 1:, None], axis=-1)[..., 0]
    lse = jax.scipy.special.logsumexp(lg.astype(jnp.float32), axis=-1)
    return jnp.mean(lse - tgt.astype(jnp.float32))


def _torch_ce_loss(logits, ids):
    lg = logits[:, :-1].float()
    tgt = lg.gather(-1, ids[:, 1:, None].long())[..., 0]
    return (torch.logsumexp(lg, dim=-1) - tgt).mean()


def _jax_gpt2_run(ids, mode, steps, bf16=False):
    """bench.py's framework training at the CPU smoke shape: (init params,
    per-step losses, first step's grads, final params)."""
    jax_smp.init({"microbatches": NUM_MB, "bf16": bf16})
    model = jax_smp.DistributedModel(jax_gpt2_124m(**SMOKE))
    optimizer = jax_smp.DistributedOptimizer(optax.adamw(1e-4), model)

    @jax_smp.step
    def train_step(model, batch_ids):
        if mode == "loss":
            tgt = jnp.concatenate([batch_ids[:, 1:], jnp.full_like(batch_ids[:, :1], -100)], axis=1)
            per = model(batch_ids, targets=tgt)
            loss = jnp.sum(per) / (per.shape[0] * (per.shape[1] - 1))
        else:
            loss = _jax_ce_loss(model(batch_ids), batch_ids)
        model.backward(loss)
        return loss

    losses, init, grads = [], None, None
    for _ in range(steps):
        out = train_step(model, jnp.asarray(ids))
        if init is None:
            init = jax.tree_util.tree_map(np.asarray, jax.device_get(model.params))
            grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(model.grads)))
        losses.append(float(out.reduce_mean()))
        optimizer.step()
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(model.params)))
    return params_from_jax(init), losses, grads, final


def _port_gpt2_run(init, ids, mode, steps, bf16=False):
    smp.init({"microbatches": NUM_MB, "bf16": bf16, "fused_step_donation": True}, device="cpu")
    module = gpt2_124m(**SMOKE)
    module.load_state_dict(init, strict=True)
    model = smp.DistributedModel(module)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, batch_ids):
        if mode == "loss":
            tgt = torch.cat([batch_ids[:, 1:], torch.full_like(batch_ids[:, :1], -100)], dim=1)
            per = model(batch_ids, targets=tgt)
            loss = per.sum() / (per.shape[0] * (per.shape[1] - 1))
        else:
            loss = _torch_ce_loss(model(batch_ids), batch_ids)
        model.backward(loss)
        return loss

    losses, grads = [], None
    for _ in range(steps):
        out = train_step(model, torch.from_numpy(ids).long())
        if grads is None:
            grads = {k: g.clone() for k, g in model.grads.items()}
        losses.append(float(out.reduce_mean()))
        optimizer.step()
    return losses, grads, model.state_dict()


@pytest.mark.parametrize("mode", ["loss", "logits"])
def test_gpt2_smoke_shape_trains_as_jax_fp32(mode):
    ids = _ids()
    init, want_losses, _, want_params = _jax_gpt2_run(ids, mode, steps=5)
    losses, _, params = _port_gpt2_run(init, ids, mode, steps=5)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    assert losses[-1] < losses[0]
    for name, want in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), want.numpy(), rtol=2e-3, atol=2e-4, err_msg=name)


def test_gpt2_smoke_shape_trains_as_jax_bf16():
    ids = _ids()
    init, want_losses, want_grads, _ = _jax_gpt2_run(ids, "loss", steps=3, bf16=True)
    losses, grads, params = _port_gpt2_run(init, ids, "loss", steps=3, bf16=True)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-2)
    for name, want in want_grads.items():
        assert grads[name].dtype == torch.float32  # fp32 master params and grads
        err = float((grads[name] - want.float()).abs().max())
        assert err <= 5e-2 * float(want.abs().max()) + 1e-8, (name, err)
    assert all(p.dtype == torch.float32 for p in params.values())


# ----------------------------------------------------------------------
# fp16 loss scaling
# ----------------------------------------------------------------------


def test_fp16_overflow_skips_update_and_backs_off_as_jax():
    """The default scale (2**32) overflows fp16 gradients: the first
    optimizer.step() skips the update and halves the scale, then training
    proceeds, in both packages."""
    x, y = _mlp_data()
    init, _, want_params = _jax_mlp_run(1, x, y, steps=1, cfg={"fp16": True})
    jax_scaler = jax_state.loss_scaler
    for layer, leaves in init.items():  # the JAX package skipped it too
        for k, v in leaves.items():
            np.testing.assert_array_equal(want_params[layer][k], v)
    model, optimizer, train_step = _port_mlp(init, {"microbatches": 1, "fp16": True})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    train_step(model, torch.from_numpy(x), torch.from_numpy(y))
    assert model._grads_finite is False
    optimizer.step()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k  # update skipped
    assert state.loss_scaler.state_dict() == jax_scaler.state_dict()
    assert state.loss_scaler.loss_scale == 2.0 ** 31
    # Back off until the scaled gradients fit fp16, then the update lands.
    for _ in range(40):
        train_step(model, torch.from_numpy(x), torch.from_numpy(y))
        finite = model._grads_finite
        optimizer.step()
        if finite:
            break
    assert finite and not torch.equal(model.state_dict()["dense_0.weight"], before["dense_0.weight"])
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fp16_inf_gradient_skips_update_and_backs_off_as_jax():
    """An inf in one input row makes the step's fp16 gradients non-finite at a
    loss scale that otherwise fits (2**8): the overflow flag, taken from the
    sentinel kernel's count (``health_reduce``, one launch and one
    readback), is False, ``optimizer.step()`` skips the update and halves
    the scale, and the clean steps around it update, in both packages."""
    x, y = _mlp_data()
    x_bad = x.copy()
    x_bad[5, 2] = np.inf
    inputs = (x, x_bad, x)
    jax_smp.init({"microbatches": 2, "fp16": True})
    jax_state.loss_scaler = JaxDynamicLossScaler(init_scale=2.0 ** 8)
    jmodel = jax_smp.DistributedModel(MLP())
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, xb, yb):
        loss = jnp.mean(softmax_xent(model(xb), yb))
        model.backward(loss)
        return loss

    want, init = [], None
    for xb in inputs:
        jax_step(jmodel, jnp.asarray(xb), jnp.asarray(y))
        if init is None:
            init = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
        finite = bool(jmodel._grads_finite)
        jopt.step()
        want.append((finite, jax_state.loss_scaler.state_dict(),
                     jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))))
    model, optimizer, train_step = _port_mlp(init, {"microbatches": 2, "fp16": True})
    state.loss_scaler = DynamicLossScaler(init_scale=2.0 ** 8)
    for xb, (finite, scaler, params) in zip(inputs, want):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        train_step(model, torch.from_numpy(xb), torch.from_numpy(y))
        assert model._grads_finite is finite
        optimizer.step()
        assert state.loss_scaler.state_dict() == scaler
        for k, v in _mlp_state_dict(params).items():
            got = model.state_dict()[k]
            if finite:
                assert not torch.equal(got, before[k]), k
                torch.testing.assert_close(got, v.float(), rtol=0, atol=1e-2)  # fp16 gradients, sgd 0.1
            else:
                assert torch.equal(got, before[k]), k  # update skipped
    assert [f for f, _, _ in want] == [True, False, True]


@pytest.mark.parametrize("make", [
    lambda m: (m.DynamicLossScaler(init_scale=2.0 ** 8, scale_window=3),),
    lambda m: (m.DynamicLossScaler(init_scale=4.0, scale_window=2, delayed_shift=2, min_scale=2.0),),
    lambda m: (m.DynamicLossScaler(scale_window=2, delayed_shift=3, consecutive_hysteresis=True),),
    lambda m: (m.LossScaler(scale=128.0),),
    lambda m: (m.GradScaler(init_scale=16.0, growth_interval=2, backoff_factor=0.25),),
], ids=["dynamic", "hysteresis_min_scale", "consecutive_hysteresis", "static", "grad_scaler"])
def test_loss_scaler_arithmetic_matches_jax(make):
    from types import SimpleNamespace

    jax_mod = SimpleNamespace(DynamicLossScaler=JaxDynamicLossScaler, LossScaler=JaxLossScaler,
                              GradScaler=JaxGradScaler)
    port_mod = SimpleNamespace(DynamicLossScaler=DynamicLossScaler, LossScaler=LossScaler,
                               GradScaler=GradScaler)
    (want,), (got,) = make(jax_mod), make(port_mod)
    for overflow in (False, False, True, False, True, True, False, False, False, False, True, False):
        want.update(overflow)
        got.update(overflow)
        assert got.state_dict() == want.state_dict()
        assert got.loss_scale == want.loss_scale
    fresh = make(port_mod)[0]
    fresh.load_state_dict(got.state_dict())
    assert fresh.state_dict() == got.state_dict()


# ----------------------------------------------------------------------
# Step surface, usage errors and warnings (tests/test_step.py)
# ----------------------------------------------------------------------


def _port_model(num_mb=1, **cfg):
    smp.init({"microbatches": num_mb, **cfg}, device="cpu")
    torch.manual_seed(0)
    return smp.DistributedModel(TorchMLP())


def _train_step():
    @smp.step
    def train_step(model, xb, yb):
        loss = torch_xent(model(xb.to(state.cfg.half_dtype or xb.dtype)), yb).mean()
        model.backward(loss)
        return loss

    return train_step


def _xy():
    x, y = _mlp_data()
    return torch.from_numpy(x), torch.from_numpy(y)


def test_forward_only_step():
    model = _port_model(2)

    @smp.step
    def eval_step(model, xb):
        return model(xb)

    out = eval_step(model, _xy()[0])
    assert out.stack().shape == (2, 8, 4)
    assert out.concat().shape == (16, 4)
    assert model.grads is None


def test_step_output_accessors_and_kwargs():
    model = _port_model(2)

    @smp.step
    def train_step(model, xb, yb=None, scale=1.0):
        logits = model(xb)
        loss = torch_xent(logits, yb).mean() * scale
        model.backward(loss)
        return {"loss": loss, "logits": logits}

    x, y = _xy()
    out = train_step(model, x, yb=y, scale=2.0)
    assert set(out.reduce_mean().keys()) == {"loss", "logits"}
    assert out.concat()["logits"].shape == (16, 4)
    assert not out.stack()["loss"].requires_grad


def test_non_split_inputs_step():
    model = _port_model(4)

    @smp.step(non_split_inputs=["mask"])
    def train_step(model, xb, yb, mask):
        loss = torch_xent(model(xb) * mask, yb).mean()
        model.backward(loss)
        return loss

    x, y = _xy()
    out = train_step(model, x, y, torch.ones(4))
    assert out.stack().shape == (4,)


def test_grads_are_the_microbatch_mean():
    """4 microbatches give the full-batch gradient of the mean loss."""
    model = _port_model(4)
    x, y = _xy()
    _train_step()(model, x, y)
    model.module.zero_grad()
    torch_xent(model.module(x), y).mean().backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(model.grads[name], p.grad, rtol=1e-5, atol=1e-6)


def test_grad_clip_norm_uses_optax_formula():
    model = _port_model(1)
    x, y = _xy()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1.0), model, grad_clip_norm=0.01)
    _train_step()(model, x, y)
    grads = {n: g.clone() for n, g in model.grads.items()}
    gnorm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    optimizer.step()
    scale = min(1.0, 0.01 / (gnorm + 1e-6))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[n] - grads[n] * scale, rtol=1e-6, atol=1e-7)


def test_backward_outside_step_raises():
    model = _port_model()
    with pytest.raises(smp.SMPValidationError):
        model.backward(torch.zeros(()))


def test_optimizer_without_grads_raises():
    model = _port_model()
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)
    with pytest.raises(smp.SMPValidationError):
        optimizer.step()


def test_optimizer_needs_a_torch_optimizer_and_a_model():
    with pytest.raises(smp.SMPValidationError, match="DistributedModel"):
        smp.DistributedOptimizer(torch.optim.SGD([nn.Parameter(torch.zeros(1))], lr=0.1))
    model = _port_model()
    with pytest.raises(smp.SMPValidationError, match="torch.optim.Optimizer"):
        smp.DistributedOptimizer(optax.sgd(0.1), model)


def test_backward_twice_and_missing_backward_raise():
    model = _port_model(2)
    x, y = _xy()

    @smp.step
    def twice(model, xb, yb):
        loss = torch_xent(model(xb), yb).mean()
        model.backward(loss)
        model.backward(loss)

    with pytest.raises(smp.StepUsageError, match="twice"):
        twice(model, x, y)

    calls = []

    @smp.step
    def sometimes(model, xb, yb):
        loss = torch_xent(model(xb), yb).mean()
        if not calls:
            model.backward(loss)
        calls.append(1)
        return loss

    with pytest.raises(smp.StepUsageError, match="not called"):
        sometimes(model, x, y)


def test_step_before_init_raises():
    with pytest.raises(smp.StepUsageError, match="smp.init"):
        _train_step()(None, *_xy())


@pytest.mark.parametrize("cfg,env", [
    ({"pipeline_parallel_degree": 2, "microbatches": 2}, None),
    ({"pipeline_parallel_degree": 2, "virtual_pipeline_degree": 2, "microbatches": 2}, None),
    ({"tensor_parallel_degree": 2, "ddp": True}, None),
    ({"matmul_precision": "fp8"}, None),
    ({}, ("SMP_SHAPE_BUCKETS", "batch:8,16")),
    ({}, ("SMP_HEALTH_CHECK", "cheap")),
    ({}, ("SMP_EXEC_CACHE", "on")),
    ({}, ("SMP_HLO_AUDIT", "on")),
    ({}, ("SMP_CHAOS", "sigterm@step=3")),
    ({}, ("SMP_SUPERVISOR", "on")),
], ids=["pp2", "vpp2", "tp2", "fp8", "shape_buckets", "health", "exec_cache", "hlo_audit", "chaos", "supervisor"])
def test_left_out_features_raise(monkeypatch, cfg, env):
    if env is not None:
        monkeypatch.setenv(*env)
    if cfg.get("pipeline_parallel_degree", 1) * cfg.get("tensor_parallel_degree", 1) > 1:
        # One device cannot hold these degrees: smp.init refuses them, as the
        # JAX package does. The step's own refusal is held on the config
        # installed past that check.
        with pytest.raises(DeviceCountError):
            smp.init(cfg, device="cpu")
        smp.init({}, device="cpu")
        monkeypatch.setattr(state, "cfg", smp.ModelParallelConfig(cfg))
    else:
        smp.init(cfg, device="cpu")
    if cfg.get("virtual_pipeline_degree", 1) > 1:
        # Stays refused at pp > 1 (ROADMAP item 8), when the model is built.
        with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
            smp.DistributedModel(TorchMLP())
        return
    if cfg.get("pipeline_parallel_degree", 1) > 1:
        # Ported since (slice 5a, tests/test_torch_pp_step.py): the model is
        # partitioned when it is built, and a module without pipeline_spec()
        # raises what the JAX package raises for it.
        with pytest.raises(PartitionError, match="requires a pipelineable model"):
            smp.DistributedModel(TorchMLP())
        return
    model = smp.DistributedModel(TorchMLP())
    if env is not None and env[0] in ("SMP_HEALTH_CHECK", "SMP_CHAOS", "SMP_SUPERVISOR"):
        # Ported since (slice 9b, tests/test_torch_health.py and friends):
        # the step trains; the sentinel holds its word, the chaos rule fires
        # at step 3 only, and the supervisor arms nothing at one rank.
        _train_step()(model, *_xy())
        return
    if cfg.get("matmul_precision") == "fp8":
        # Ported since (quant.py): the step trains under fp8. This MLP has no
        # fp8 seam, so its delayed-scaling state stays fresh, as in the JAX
        # package; tests/test_torch_fp8_step.py holds the seams.
        _train_step()(model, *_xy())
        sd = smp.state.quant_state.state_dict()
        assert (sd["amax_history"] == 0).all() and (sd["scale"] == 1.0).all()
        return
    if cfg.get("tensor_parallel_degree", 1) > 1:
        # Ported since (slice 4b, tests/test_torch_tp_step.py): the step
        # trains at tp = 2, and under the overlapped ring too (slice 4c,
        # tests/test_torch_tp_ring.py).
        _train_step()(model, *_xy())
        monkeypatch.setattr(state, "cfg", smp.ModelParallelConfig(dict(cfg, tp_overlap="ring")))
        out = _train_step()(model, *_xy())
        assert np.isfinite(float(out.reduce_mean()))
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        _train_step()(model, *_xy())


def _capture(fn):
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Capture()
    get_logger().addHandler(handler)
    try:
        fn()
    finally:
        get_logger().removeHandler(handler)
    return records


@pytest.mark.parametrize("cfg", [{"fused_optimizer_step": True}, {"fused_optimizer_step": False},
                                 {"fused_step_donation": True}], ids=["fused", "unfused", "donation"])
def test_warns_when_updates_never_installed(cfg):
    model = _port_model(1, **cfg)
    smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)
    x, y = _xy()
    step = _train_step()
    before = model.state_dict()["dense_0.weight"].clone()
    records = _capture(lambda: [step(model, x, y) for _ in range(5)])
    assert any("optimizer.step()" in m and "NOT learning" in m for m in records), records
    # The fused keys change nothing a user observes: parameters move only
    # at optimizer.step().
    assert torch.equal(model.state_dict()["dense_0.weight"], before)


def test_no_warning_when_optimizer_steps_or_eval_steps_interleave():
    model = _port_model(1)
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)
    x, y = _xy()
    step = _train_step()

    @smp.step
    def eval_step(model, xb, yb):
        return torch_xent(model(xb), yb).mean()

    def loop():
        for _ in range(3):
            step(model, x, y)
            for _ in range(4):
                eval_step(model, x, y)
            optimizer.step()

    assert not any("NOT learning" in m for m in _capture(loop))


def test_eval_step_preserves_pending_train_state():
    model = _port_model(1)
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)
    x, y = _xy()
    _train_step()(model, x, y)
    grads = model.grads

    @smp.step
    def eval_step(model, xb, yb):
        return torch_xent(model(xb), yb).mean()

    eval_step(model, x, y)
    assert model.grads is grads
    before = model.state_dict()["dense_0.weight"].clone()
    optimizer.step()
    assert not torch.equal(before, model.state_dict()["dense_0.weight"])
    assert model.grads is None


def test_model_surface():
    model = _port_model()
    assert model.num_parameters() == sum(v.numel() for v in model.state_dict().values())
    assert len(model.parameters()) == 6
    assert model.training and not model.eval().training and model.train().training
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k])


def test_optimizer_state_dict_roundtrip():
    model = _port_model()
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8), model)
    _train_step()(model, *_xy())
    optimizer.step()
    sd = optimizer.state_dict()
    assert sd["state"][0]["step"] == 1
    optimizer.load_state_dict(sd)
    assert optimizer.state_dict()["state"][0]["exp_avg"].equal(sd["state"][0]["exp_avg"])
    optimizer.zero_grad()
    assert model.grads is None


def test_bf16_master_params_stay_fp32():
    model = _port_model(2, bf16=True)
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)
    x, y = _xy()
    step = _train_step()
    l0 = float(step(model, x, y).reduce_mean())
    assert all(g.dtype == torch.float32 for g in model.grads.values())
    optimizer.step()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    l1 = float(step(model, x, y).reduce_mean())
    assert l1 < l0


def test_unknown_f_is_positional_names_tolerant():
    """Steps over builtins/partials still split their positional args."""
    model = _port_model(2)
    out = smp.step(lambda m, xb: F.relu(m(xb)))(model, _xy()[0])
    assert out.concat().shape == (16, 4)
