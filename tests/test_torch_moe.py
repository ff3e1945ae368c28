"""The port's ``DistributedMoE`` (``smp.nn``) against the JAX package's
``nn/moe.py``, on the CPU in fp32.

The same weights (the JAX init, moved by noise from a seed where the routing
should spread) and inputs (numpy draws from a seed) go through both:
  - a bare ``DistributedMoE`` at top-1 and top-2: outputs within 1e-5, the
    load-balancing loss within 1e-6, and the gradients of
    ``sum(out * g) + aux`` for the router and the experts within 1e-5;
  - a zero router (every gate 1/E): ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` would route to others);
  - ``capacity_factor`` 0.5: the same assignments dropped (zero rows);
  - ``router_jitter`` 0.1 in training: the noise from the module's dropout
    key gives the JAX output;
  - ``top_k`` outside [1, E] and ``num_experts % ep`` raise JAX's messages;
  - an LM head with ``num_experts=4`` trained two ``@smp.step`` steps (SGD
    0.1, 2 microbatches) at ``moe_aux_loss_weight`` 1.0, 0.5 and 0: returned
    losses (the user's loss, without the aux) and parameters within 1e-5;
    the same under ``activation_checkpointing``, where each layer records
    its aux once a microbatch (not again in the recompute);
  - ``moe_aux_losses`` over the module (and a dense one: 0.0);
  - greedy ``smp.generate`` through the MoE head: the JAX tokens;
  - a partial checkpoint of the MoE head resumes in the port bit for bit and
    in the JAX package to the same logits.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import moe as jax_moe
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax, lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import moe as port_moe
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

MOE = dict(hidden_size=16, intermediate_size=32, num_experts=4)
B, T, D = 2, 8, 16
HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
    num_experts=4, moe_top_k=2,
)
LM_B, LM_T, MB = 4, 16, 2


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _x(seed=0, shape=(B, T, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_params(module, seed=1, noise=0.3, zero_router=False):
    """The JAX init of a bare ``DistributedMoE``, every leaf moved by noise."""
    jax_smp.init({})
    params = module.init(jax.random.key(seed), jnp.asarray(_x()))["params"]
    rng = np.random.default_rng(seed + 100)
    params = {k: np.asarray(v) + noise * rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    if zero_router:
        params["router/kernel"] = np.zeros_like(params["router/kernel"])
    return params


def _port_moe(params, **kw):
    mod = port_moe.DistributedMoE(**kw)
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(v) for k, v in params.items()}, strict=True)
    return mod


def _jax_apply(module, params, x, rngs=None):
    out, inter = module.apply({"params": params}, jnp.asarray(x), rngs=rngs, mutable=["intermediates"])
    return np.asarray(out), float(jax_moe.moe_aux_losses(inter["intermediates"]))


@pytest.mark.parametrize("top_k", [1, 2])
def test_outputs_aux_and_gradients_match_jax(top_k):
    kw = dict(MOE, top_k=top_k, deterministic=True)
    jmod = jax_moe.DistributedMoE(**kw)
    params = _moe_params(jmod)
    x = _x()
    g = _x(2)
    want, want_aux = _jax_apply(jmod, params, x)

    def f(p):
        out, inter = jmod.apply({"params": p}, jnp.asarray(x), mutable=["intermediates"])
        return jnp.sum(out * g) + jax_moe.moe_aux_losses(inter["intermediates"])

    want_grads = jax.grad(f)(params)
    tmod = _port_moe(params, **kw)
    out = tmod(torch.from_numpy(x))
    aux = port_moe.moe_aux_losses(tmod)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=0, atol=1e-6)
    (out * torch.from_numpy(g)).sum().add(aux).backward()
    for name, p in tmod.named_parameters():
        w = np.asarray(want_grads[name.replace(".", "/")])
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_breaks_ties_as_jax(top_k):
    """Every gate 1/E: JAX routes to experts 0..k-1 and so does the port."""
    kw = dict(MOE, top_k=top_k, capacity_factor=8.0, deterministic=True)
    jmod = jax_moe.DistributedMoE(**kw)
    params = _moe_params(jmod, zero_router=True)
    x = _x(3)
    want, want_aux = _jax_apply(jmod, params, x)
    tmod = _port_moe(params, **kw)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(port_moe.moe_aux_losses(tmod)), want_aux, rtol=0, atol=1e-6)
    # Experts 0..k-1, each at the raw gate 1/E for k = 1 (Switch), at 1/k
    # after the renormalization for k > 1.
    xs = torch.from_numpy(x).reshape(-1, D)
    experts = [torch.nn.functional.gelu(xs @ tmod.fc.kernel[e] + tmod.fc.bias[e], approximate="tanh")
               @ tmod.proj.kernel[e] + tmod.proj.bias[e] for e in range(top_k)]
    weight = 1 / MOE["num_experts"] if top_k == 1 else 1 / top_k
    np.testing.assert_allclose(out.reshape(-1, D), (sum(experts) * weight).detach().numpy(), rtol=0, atol=1e-5)
    _, topk_idx = torch.topk(torch.full((4,), 0.25), top_k)
    assert sorted(topk_idx.tolist()) != list(range(top_k))  # what a bare torch.topk would have routed


def test_capacity_drops_match_jax():
    kw = dict(MOE, top_k=2, capacity_factor=0.5, deterministic=True)
    jmod = jax_moe.DistributedMoE(**kw)
    params = _moe_params(jmod)
    x = _x(4, (B, 16, D))
    want, _ = _jax_apply(jmod, params, x)
    with torch.no_grad():
        out = _port_moe(params, **kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    dropped = np.all(want.reshape(-1, D) == 0.0, axis=-1)
    assert dropped.any()
    np.testing.assert_array_equal(np.all(out.reshape(-1, D) == 0.0, axis=-1), dropped)


def test_router_jitter_draws_jax_noise():
    kw = dict(MOE, top_k=2, router_jitter=0.1)
    jmod = jax_moe.DistributedMoE(**kw, deterministic=False)
    params = _moe_params(jmod)
    x = _x(5)
    key = jax.random.key(11)
    want, want_aux = _jax_apply(jmod, params, x, rngs={"dropout": key})
    plain, _ = _jax_apply(jax_moe.DistributedMoE(**kw, deterministic=True), params, x)
    assert np.abs(want - plain).max() > 1e-3  # the jitter moved the output

    smp.init({}, device="cpu")
    model = smp.DistributedModel(_port_moe(params, **kw), device="cpu")
    bound = dict(model.module.named_parameters())
    model._begin_microbatch(bound, {"dropout": key_from_jax(jax.random.key_data(key))})
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    _, _, differentiated = model._end_microbatch()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(port_moe.moe_aux_losses(model.module)), want_aux, rtol=0, atol=1e-6)
    assert differentiated is None  # no loss marked: nothing to fold into


def test_top_k_and_ep_errors(monkeypatch):
    for k in (0, 5):
        with pytest.raises(Exception) as want:
            jax_moe.DistributedMoE(**MOE, top_k=k).init(jax.random.key(0), jnp.asarray(_x()))
        with pytest.raises(SMPValidationError) as got:
            port_moe.DistributedMoE(**MOE, top_k=k)
        assert str(got.value) == str(want.value)
    monkeypatch.setattr(port_moe.state, "cfg", types.SimpleNamespace(expert_parallel_degree=3, tensor_parallel_degree=1))
    with pytest.raises(SMPValidationError, match=r"num_experts \(4\) must be divisible by expert_parallel_degree"):
        port_moe.DistributedMoE(**MOE, deterministic=True)(torch.from_numpy(_x()))


# ----------------------------------------------------------------------
# The LM head with experts: steps, checkpointing, the aux reader, decode
# ----------------------------------------------------------------------


def _head_params(seed=0, noise=0.3):
    jax_smp.init({})
    jmod = jax_tr.DistributedTransformerLMHead(**HEAD)
    params = jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    jax_smp.reset()
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32), params)


def _ids(seed=6):
    return np.random.default_rng(seed).integers(0, HEAD["vocab_size"], (LM_B, LM_T)).astype(np.int32)


def _jax_steps(ids, cfg, **kw):
    """Two SGD(0.1) steps of the JAX package from its own init: ``(initial
    parameters, (losses, parameters))`` in the port's names."""
    jax_smp.init({"microbatches": MB, "tensor_parallel_seed": 3, **cfg})
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**HEAD, **kw))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def train(model, batch):
        loss = jnp.mean(jax_vpce(model(batch)[:, :-1], batch[:, 1:]))
        model.backward(loss)
        return loss

    def tree(t):
        return lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(t)))

    losses, init = [], None
    for _ in range(2):
        losses.append(float(train(jmodel, jnp.asarray(ids)).reduce_mean()))
        init = init or tree(jmodel.params)  # the parameters change at jopt.step()
        jopt.step()
    out = tree(jmodel.params)
    jax_smp.reset()
    return init, (losses, out)


def _port_steps(init, ids, cfg, **kw):
    smp.init({"microbatches": MB, **cfg}, device="cpu")
    module = port_tr.DistributedTransformerLMHead(**HEAD, **kw)
    module.load_state_dict(init, strict=True)
    model = smp.DistributedModel(module, device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp.step
    def train(model, batch):
        loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
        model.backward(loss)
        return loss

    losses = []
    for _ in range(2):
        losses.append(float(train(model, torch.from_numpy(ids).long()).reduce_mean()))
        opt.step()
    return losses, model.state_dict()


@pytest.fixture(scope="module")
def head_params():
    return _head_params()


def _assert_same_run(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert got[1].keys() == want[1].keys()
    for name, w in want[1].items():
        np.testing.assert_allclose(got[1][name].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's two steps at each aux weight, from its own init
    (one step compile each)."""
    return {w: _jax_steps(_ids(), {"moe_aux_loss_weight": w}) for w in (1.0, 0.5, 0.0)}


@pytest.mark.parametrize("weight", [1.0, 0.5, 0.0])
def test_lm_head_steps_match_jax(jax_runs, weight):
    init, want = jax_runs[weight]
    got = _port_steps(init, _ids(), {"moe_aux_loss_weight": weight})
    _assert_same_run(got, want)
    if weight:
        # The fold moved the routers: the weight-0 run's differ.
        name = "transformer.seq_layers.0.output.router.kernel"
        assert not np.allclose(got[1][name].numpy(), jax_runs[0.0][1][1][name].numpy(), rtol=0, atol=1e-6)


def test_checkpointed_steps_count_the_aux_once(jax_runs, monkeypatch):
    sown = []
    real = smp.DistributedModel._sow_moe_aux
    monkeypatch.setattr(smp.DistributedModel, "_sow_moe_aux",
                        lambda self, aux: (sown.append(self._key_replay is None), real(self, aux)))
    init, want = jax_runs[1.0]
    got = _port_steps(init, _ids(), {"moe_aux_loss_weight": 1.0}, activation_checkpointing=True)
    _assert_same_run(got, want)
    # Each layer recorded once a microbatch; its recompute did not.
    assert sown.count(True) == 2 * MB * HEAD["num_layers"]


def test_moe_aux_losses_reads_the_module(head_params):
    ids = _ids(7)
    jax_smp.init({})
    jmod = jax_tr.DistributedTransformerLMHead(**HEAD, deterministic=True)
    _, inter = jmod.apply({"params": head_params}, jnp.asarray(ids), mutable=["intermediates"])
    want = float(jax_moe.moe_aux_losses(inter["intermediates"]))
    tmod = port_tr.DistributedTransformerLMHead(**HEAD, deterministic=True)
    tmod.load_state_dict(lm_head_params_from_jax(head_params), strict=True)
    assert port_moe.collect_moe_aux(tmod) is None  # nothing sown before a forward
    with torch.no_grad():
        tmod(torch.from_numpy(ids).long())
    np.testing.assert_allclose(float(smp.nn.moe_aux_losses(tmod)), want, rtol=0, atol=1e-6)
    tree = {"a": {"moe_aux_loss": (torch.tensor([1.0, 2.0]),)}, "b": [{"moe_aux_loss": torch.tensor(3.0)}],
            "c": torch.tensor(10.0)}
    assert float(port_moe.moe_aux_losses(tree)) == 6.0
    dense = port_tr.DistributedTransformerLMHead(**dict(HEAD, num_experts=0), deterministic=True)
    dense(torch.from_numpy(ids).long())
    assert port_moe.moe_aux_losses(dense) == 0.0 and port_moe.collect_moe_aux({}) is None


def test_greedy_generate_through_moe_head(head_params):
    ids = np.random.default_rng(8).integers(1, HEAD["vocab_size"], (2, 5)).astype(np.int32)
    jax_smp.init({})
    jmod = jax_tr.DistributedTransformerLMHead(**HEAD, deterministic=True)
    want = np.asarray(jax_smp.generate(jmod, jnp.asarray(ids), 6, params=head_params))
    jax_smp.reset()
    smp.init({}, device="cpu")
    tmod = port_tr.DistributedTransformerLMHead(**HEAD, deterministic=True)
    tmod.load_state_dict(lm_head_params_from_jax(head_params), strict=True)
    got = smp.generate(tmod, torch.from_numpy(ids).long(), 6, params=tmod.state_dict()).numpy()
    np.testing.assert_array_equal(got, want)


def test_partial_checkpoint_round_trips_and_loads_in_jax(head_params, tmp_path):
    """A partial checkpoint of a MoE head: the port resumes it bit for bit,
    the JAX package to the same logits (its ``output/router``, ``fc`` and
    ``proj`` leaves in the JAX layout)."""
    root = str(tmp_path)
    ids = _ids(9)
    kw = dict(HEAD, deterministic=True)
    smp.init({}, device="cpu")
    module = port_tr.DistributedTransformerLMHead(**kw)
    module.load_state_dict(lm_head_params_from_jax(head_params), strict=True)
    model = smp.DistributedModel(module, device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(ids).long()).numpy()
    saved = model.state_dict()
    assert model.reference_state_dict()["transformer/seq_layers/layer/output/fc/kernel"].shape == (2, 4, 32, 64)
    smp.save_checkpoint(root, tag="p")
    smp.reset()

    smp.init({}, device="cpu")
    smp.resume_from_checkpoint(root, tag="p")
    again = smp.DistributedModel(port_tr.DistributedTransformerLMHead(**kw), device="cpu")
    for key, t in saved.items():
        assert torch.equal(again.state_dict()[key], t), key
    smp.reset()

    jax_smp.init({})
    jax_smp.resume_from_checkpoint(root, tag="p")
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**kw))
    got = np.asarray(jmodel(jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
