"""Activation checkpointing of the port against the JAX package's.

``tests/test_memory_systems.py``'s TINY ``DistributedTransformerLMHead``
(4 layers, D 32, 4 heads, vocab 96), fp32, on the weights of a JAX init
(``convert.lm_head_params_from_jax``), on the CPU:
  - ``activation_checkpointing=True`` in both packages (the JAX package's
    ``nn.remat`` of its scan body, the port's checkpointed layers): 3
    ``@smp.step`` steps (2 microbatches, SGD 0.1) at dropout 0 and at
    attention and hidden dropout 0.1, losses, gradients and parameters at
    ``tests/test_torch_dropout_step.py``'s tolerances (losses rtol 2e-4 /
    atol 2e-5, the rest rtol 2e-3 / atol 2e-4). flax's lifted remat draws
    the same keys as the plain scan body, so both sides draw one set of
    dropout masks;
  - the port on against off: gradients equal to 1e-6, every layer parameter
    with a gradient, at dropout 0 and 0.1;
  - ``recompute`` full, stash_weight, stash_all, auto and
    ``offload_activations`` give the same gradients; the bytes a microbatch's
    forward leaves alive for its backward order full < stash_weight <
    stash_all, and stash_all keeps what the unchecked model keeps;
  - the offload bookkeeping with CPU tensors sent down the card's branch:
    every layer input goes to host and back, the backward prefetches all but
    the first one it reads, none at horizon 0;
  - a recompute run by the autograd engine on another thread (as a CUDA
    backward is) under ``matmul_precision: fp8``: the step's finalized quant
    state and gradients equal the unchecked step's;
  - ``smp.set_activation_checkpointing`` sets the flag where the JAX package
    sets it, for "transformer", "", "main", a descendant and an unrelated
    prefix;
  - ``smp.checkpoint`` in both call forms and ``smp.checkpoint_sequential``
    ("each", "group_2") against the JAX functions on the same numpy inputs,
    a checkpointed module inside a step, and ``smp.checkpoint`` staying the
    function after ``import smdistributed_modelparallel_tpu_torch.checkpoint``.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.parallel import memory

TINY = dict(
    num_layers=4, num_attention_heads=4, attention_head_size=8,
    hidden_size=32, intermediate_size=64, vocab_size=96, num_positions=32,
    causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0,
    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
DROPOUT = dict(attention_dropout_prob=0.1, hidden_dropout_prob=0.1)
B, T = 8, 16
SEED = 7  # tensor_parallel_seed of both packages
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
MODES = ("full", "stash_weight", "stash_all", "auto", "offload")


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def init_params():
    jax_smp.init({})
    params = jax_tr.DistributedTransformerLMHead(**TINY).init(jax.random.key(1), jnp.asarray(_ids()))["params"]
    jax_smp.reset()
    return lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _jax_train(ids, steps, **kw):
    """``steps`` SGD(0.1) steps of the JAX package's remat LM head from its
    own init: ``(initial parameters, (losses, gradients, parameters))``."""
    jax_smp.init({"microbatches": 2, "tensor_parallel_seed": SEED})
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**{**TINY, **kw}))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, batch):
        logits = model(batch)
        loss = jnp.mean(jax_vpce(logits[:, :-1], batch[:, 1:]))
        model.backward(loss)
        return loss

    def tree(t):
        return lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(t)))

    losses, grads, init = [], [], None
    for _ in range(steps):
        losses.append(float(jax_step(jmodel, jnp.asarray(ids)).reduce_mean()))
        init = init or tree(jmodel.params)
        grads.append(tree(jmodel.grads))
        jopt.step()
    return init, (losses, grads, tree(jmodel.params))


def _port_model(state_dict, cfg=None, **kw):
    smp_torch.init({"microbatches": 2, "tensor_parallel_seed": SEED, **(cfg or {})}, device="cpu")
    module = port_tr.DistributedTransformerLMHead(**{**TINY, **kw})
    module.load_state_dict(state_dict, strict=True)
    return smp_torch.DistributedModel(module, device="cpu")


def _port_train(state_dict, ids, steps, cfg=None, **kw):
    model = _port_model(state_dict, cfg, **kw)
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def port_step(model, batch):
        loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
        model.backward(loss)
        return loss

    losses, grads = [], []
    for _ in range(steps):
        losses.append(float(port_step(model, torch.from_numpy(ids).long()).reduce_mean()))
        grads.append({k: v.clone() for k, v in model.grads.items()})
        opt.step()
    return losses, grads, model.state_dict()


def _mode_cfg(mode):
    return {"offload_activations": True} if mode == "offload" else {"recompute": mode}


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout0", "dropout0.1"])
def test_three_steps_match_jax_remat(dropout):
    kw = dict(DROPOUT if dropout else {}, activation_checkpointing=True)
    ids = _ids(4)
    init, want = _jax_train(ids, 3, **kw)
    losses, grads, params = _port_train(init, ids, 3, **kw)
    want_losses, want_grads, want_params = want
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    for step, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **PARAM_TOL, err_msg=f"{step} {name}")
    for name, w in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), w.numpy(), **PARAM_TOL, err_msg=name)
    assert losses[-1] < losses[0]


def _layer_params(grads):
    return [n for n in grads if n.startswith("transformer.seq_layers.")]


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout0", "dropout0.1"])
def test_on_equals_off(init_params, dropout):
    kw = DROPOUT if dropout else {}
    ids = _ids(5)
    off = _port_train(init_params, ids, 1, **kw)
    on = _port_train(init_params, ids, 1, activation_checkpointing=True, **kw)
    assert on[0] == off[0]
    names = _layer_params(off[1][0])
    assert len(names) == TINY["num_layers"] * 12 and set(on[1][0]) == set(off[1][0])
    for name, g in off[1][0].items():
        assert float(g.abs().max()) > 0 or name.endswith("qkv.bias"), name
        torch.testing.assert_close(on[1][0][name], g, rtol=0, atol=1e-6, msg=name)


class _Alive(TorchDispatchMode):
    """Every storage an op creates, as weak references: after the forward,
    those still alive are what the graph keeps for the backward."""

    def __init__(self):
        super().__init__()
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                st = t.untyped_storage()
                self.storages[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        return out

    def kept(self, *exclude):
        skip = {t.untyped_storage().data_ptr() for t in exclude}
        return sum(n for ptr, (ref, n) in self.storages.items() if not ref.expired() and ptr not in skip)


def _microbatch(model, ids):
    """One microbatch's forward by hand: the loss, the bound parameters and
    the bytes its graph keeps."""
    bound = {k: v.detach().requires_grad_() for k, v in model.module.named_parameters()}
    model._begin_microbatch(bound, {"dropout": np.array([0, SEED], np.uint32)})
    alive = _Alive()
    with alive:
        loss = vocab_parallel_cross_entropy(model(ids)[:, :-1], ids[:, 1:]).mean()
    kept = alive.kept(loss)
    grads = torch.autograd.grad(loss, list(bound.values()))
    model._end_microbatch()
    return kept, dict(zip(bound, grads))


def test_modes_agree_and_keep_bytes_in_order(init_params):
    ids = torch.from_numpy(_ids(6)).long()
    kept, grads = {}, {}
    for mode in (None, *MODES):
        model = _port_model(init_params, _mode_cfg(mode or "full"), activation_checkpointing=mode is not None,
                            **DROPOUT)
        kept[mode], grads[mode] = _microbatch(model, ids)
    for mode in MODES:
        for name, g in grads[None].items():
            torch.testing.assert_close(grads[mode][name], g, rtol=0, atol=1e-6, msg=f"{mode} {name}")
    assert kept["full"] < kept["stash_weight"] < kept["stash_all"] == kept[None]
    assert kept["auto"] == kept["stash_weight"]
    assert kept["offload"] == kept["full"]  # CPU tensors are already host memory


@pytest.mark.parametrize("horizon", [2, 0])
def test_offload_moves_every_layer_input(init_params, monkeypatch, horizon):
    monkeypatch.setattr(memory, "_is_cuda", lambda t: True)
    monkeypatch.setattr(memory, "offload_stats", dict.fromkeys(memory.offload_stats, 0))
    ids = _ids(7)
    off = _port_train(init_params, ids, 1, **DROPOUT)
    on = _port_train(init_params, ids, 1, {"offload_activations": True, "activation_loading_horizon": horizon},
                     activation_checkpointing=True, **DROPOUT)
    layer_input = (B // 2) * T * TINY["hidden_size"] * 4
    L, mb = TINY["num_layers"], 2
    assert memory.offload_stats == {"to_host": L * mb * layer_input, "to_device": L * mb * layer_input,
                                    "prefetched": (L - 1) * mb if horizon else 0}
    assert on[0] == off[0]
    for name, g in off[1][0].items():
        torch.testing.assert_close(on[1][0][name], g, rtol=0, atol=1e-6, msg=name)


def test_fp8_quant_state_with_recompute_on_another_thread(init_params, monkeypatch):
    """The CUDA autograd engine runs a backward on its own thread, where the
    step's thread-local fp8 trace is not installed: the recompute installs
    it. Here every ``autograd.grad`` runs on a new thread."""
    real_grad = torch.autograd.grad

    def grad_on_a_thread(*args, **kwargs):
        out = {}
        t = threading.Thread(target=lambda: out.update(v=real_grad(*args, **kwargs)))
        t.start()
        t.join()
        return out["v"]

    ids = _ids(8)
    runs = {}
    for on in (False, True):
        cfg = {"matmul_precision": "fp8", "recompute": "full"}
        with monkeypatch.context() as m:
            m.setattr(torch.autograd, "grad", grad_on_a_thread)
            losses, grads, _ = _port_train(init_params, ids, 2, cfg, activation_checkpointing=on)
        runs[on] = (losses, grads, smp_torch.state.quant_state.state_dict())
    (l0, g0, q0), (l1, g1, q1) = runs[False], runs[True]
    assert l1 == l0
    for step in range(2):
        for name, g in g0[step].items():
            torch.testing.assert_close(g1[step][name], g, rtol=0, atol=1e-6, msg=f"{step} {name}")
    for key in ("amax_history", "scale"):
        np.testing.assert_allclose(q1[key], q0[key], rtol=0, atol=1e-6)
    # The 8 product slots and the two score operands (no fused GELU here).
    assert (q1["amax_history"][:, 0] > 0).sum() == 10


@pytest.mark.parametrize("prefix", ["transformer", "", "main", "transformer/seq_layers/0", "word_embedding"])
def test_set_activation_checkpointing_as_jax(prefix):
    jax_smp.init({"microbatches": 2})
    jax_smp.set_activation_checkpointing(prefix)
    want = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**TINY)).module.activation_checkpointing
    smp_torch.init({"microbatches": 2}, device="cpu")
    smp_torch.set_activation_checkpointing(prefix)
    model = smp_torch.DistributedModel(port_tr.DistributedTransformerLMHead(**TINY), device="cpu")
    assert smp_torch.state.module_manager.checkpoint_config(prefix) == {}
    assert want is True
    assert model.module.activation_checkpointing is True
    assert model.module.transformer.activation_checkpointing is True
    smp_torch.init({"microbatches": 2}, device="cpu")  # a new session forgets the registry
    model = smp_torch.DistributedModel(port_tr.DistributedTransformerLMHead(**TINY), device="cpu")
    assert model.module.activation_checkpointing is False


def _f_jax(x):
    return jnp.sum(jnp.tanh(x) ** 2)


def _f_port(x):
    return torch.sum(torch.tanh(x) ** 2)


@pytest.mark.parametrize("form", ["decorator", "immediate"])
def test_smp_checkpoint_matches_jax(form):
    x = np.random.default_rng(0).standard_normal(8).astype(np.float32)
    jax_smp.init({})
    want = np.asarray(jax.grad(lambda v: jax_smp.checkpoint(_f_jax)(v))(jnp.asarray(x)))
    smp_torch.init({}, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    y = smp_torch.checkpoint(_f_port)(xt) if form == "decorator" else smp_torch.checkpoint(_f_port, xt)
    (got,) = torch.autograd.grad(y, xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(y.detach()), float(_f_jax(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("strategy", ["each", "group_2"])
def test_checkpoint_sequential_matches_jax(strategy):
    x = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    jax_fns = [jnp.tanh, jnp.sin, jnp.cos, jnp.tanh]
    port_fns = [torch.tanh, torch.sin, torch.cos, torch.tanh]
    jax_smp.init({})
    want = np.asarray(jax_smp.checkpoint_sequential(jax_fns, jnp.asarray(x), strategy=strategy))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(jax_smp.checkpoint_sequential(jax_fns, v, strategy)))(
        jnp.asarray(x)))
    smp_torch.init({}, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out = smp_torch.checkpoint_sequential(port_fns, xt, strategy=strategy)
    (grad,) = torch.autograd.grad(out.sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="strategy"):
        smp_torch.checkpoint_sequential(port_fns, xt, strategy="every_other")


class _Net(torch.nn.Module):
    def __init__(self, checkpointed):
        super().__init__()
        torch.manual_seed(0)
        self.a = torch.nn.Linear(16, 32)
        self.b = torch.nn.Linear(32, 16)
        self.checkpointed = checkpointed

    def forward(self, x):
        if self.checkpointed == "module":
            return smp_torch.checkpoint(self.b, torch.relu(smp_torch.checkpoint(self.a, x)))
        if self.checkpointed == "sequential":
            return smp_torch.checkpoint_sequential([self.a, torch.relu, self.b], x, "group_2")
        return self.b(torch.relu(self.a(x)))


@pytest.mark.parametrize("how", ["module", "sequential"])
def test_checkpointed_modules_in_a_bf16_step(how):
    """Modules checkpointed inside an ``@smp.step`` recompute on the step's
    bf16 casts (the master parameters are fp32): the gradients equal the
    unchecked model's."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 8, 16)).astype(np.float32))
    grads = {}
    for mode in (None, how):
        smp_torch.init({"microbatches": 2, "bf16": True}, device="cpu")
        model = smp_torch.DistributedModel(_Net(mode), device="cpu")

        @smp_torch.step
        def step(model, x):
            loss = model(x.to(torch.bfloat16)).float().square().mean()
            model.backward(loss)
            return loss

        step(model, x)
        grads[mode] = model.grads
    assert grads[how].keys() == grads[None].keys() == {"a.weight", "a.bias", "b.weight", "b.bias"}
    for name, g in grads[None].items():
        torch.testing.assert_close(grads[how][name], g, rtol=0, atol=0, msg=name)


def test_smp_checkpoint_is_the_function_after_the_submodule_import():
    import smdistributed_modelparallel_tpu_torch.checkpoint  # noqa: F401

    ckpt_module = sys.modules["smdistributed_modelparallel_tpu_torch.checkpoint"]
    assert smp_torch.checkpoint is not ckpt_module and callable(smp_torch.checkpoint)
    assert smp_torch.checkpoint.__module__ == "smdistributed_modelparallel_tpu_torch"
    assert ckpt_module.save_checkpoint is smp_torch.save_checkpoint


def test_context_parallel_refuses_checkpointing(init_params):
    model = _port_model(init_params, activation_checkpointing=True)
    smp_torch.state.cp_sharded = True
    with pytest.raises(NotImplementedError, match="context parallelism"):
        _microbatch(model, torch.from_numpy(_ids()).long())


@pytest.mark.parametrize("cfg, kind", [
    ({}, memory.FULL), ({"recompute": "full"}, memory.FULL), ({"recompute": "stash_weight"}, memory.SELECTIVE),
    ({"recompute": "auto"}, memory.SELECTIVE), ({"recompute": "stash_all"}, memory.SAVE_ALL),
    ({"recompute": "stash_all", "offload_activations": True}, memory.OFFLOAD),
], ids=["default", "full", "stash_weight", "auto", "stash_all", "offload_first"])
def test_remat_policy_maps_the_config(cfg, kind):
    """The JAX package's ``remat_policy``: offload over ``recompute``; and
    the small API around it."""
    smp_torch.init(cfg, device="cpu")
    policy = memory.remat_policy()
    assert policy.kind == kind
    assert policy.horizon == (4 if kind == memory.OFFLOAD else 0)  # activation_loading_horizon's default
    x = torch.ones(3)
    assert memory.name_layer_activation(x) is x
    assert memory.offload_supported() == torch.cuda.is_available()
    assert not memory.module_checkpoint_enabled(smp_torch.state.module_manager, "transformer")
    smp_torch.set_activation_checkpointing("/transformer/")
    assert memory.module_checkpoint_enabled(smp_torch.state.module_manager, "seq_layers", "transformer")
