"""The port's tp registry, auto-distribution, ``DistributedLinear`` family
and softmax surfaces against the JAX package's, on the CPU at tp = 1.

The same numpy inputs and weights go through both packages:
  - ``scaled_masked_softmax`` (no mask, a bool mask, an additive mask) and
    ``scaled_causal_masked_softmax`` (T = S and T < S, with and without a
    window): values and the gradient through ``jax.vjp``, fp32 to 1e-6
    (one softmax; only the summation order differs);
  - ``DistributedLinear``, ``ColumnParallelLinear`` and ``RowParallelLinear``
    with and without bias: the output and the gradients of x, the kernel
    (the port's weight transposed) and the bias, fp32 to 1e-5; tp = 2
    raises, naming the tensor-parallel slice;
  - one ``@smp.step`` of a Column -> Row pair under ``matmul_precision:
    fp8``: the loss to 2e-5 and the amax history of the two seams' four
    slots to rtol 1e-5 (``tests/test_torch_fp8_step.py``'s fp32 bounds);
  - ``tests/test_auto_distribute.py``'s cases on torch modules with the
    JAX flax modules' weights: the context swap, ``smp.model_creation``,
    path marking, the partition stage, output parity and the embedding's
    registration; and a user ``tp_register`` with init, forward and return
    hooks (outputs equal to the JAX package's with the same hooks) and one
    whose init hook declines.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta
from torch import nn

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.backend.state import state as jax_state
from smdistributed_modelparallel_tpu.nn import linear as jax_linear
from smdistributed_modelparallel_tpu.nn import softmax as jax_softmax
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn import (
    ColumnParallelLinear,
    DistributedEmbedding,
    DistributedLinear,
    RowParallelLinear,
    scaled_causal_masked_softmax,
    scaled_masked_softmax,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    NotInitializedError,
    PartitionError,
    SMPUnsupportedError,
    SMPValidationError,
)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# softmax surfaces


def _softmax_check(port_fn, jax_fn, scores, grad):
    want, vjp = jax.vjp(jax_fn, jnp.asarray(scores))
    (want_grad,) = vjp(jnp.asarray(grad))
    x = _t(scores, grad=True)
    got = port_fn(x)
    got.backward(_t(grad))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask_kind", ["none", "bool", "additive"])
def test_scaled_masked_softmax_matches_jax(mask_kind):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    grad = rng.standard_normal(scores.shape).astype(np.float32)
    mask = None
    if mask_kind == "bool":
        mask = rng.random((2, 1, 5, 7)) > 0.4
        mask[..., 0] = True  # every row keeps a key
    elif mask_kind == "additive":
        mask = (rng.standard_normal((2, 1, 1, 7)) * 3).astype(np.float32)
    _softmax_check(lambda x: scaled_masked_softmax(x, None if mask is None else torch.tensor(mask), 0.5),
                   lambda x: jax_softmax.scaled_masked_softmax(x, None if mask is None else jnp.asarray(mask), 0.5),
                   scores, grad)


@pytest.mark.parametrize("T,S,window", [(6, 6, None), (6, 6, 2), (4, 6, None), (4, 6, 3)])
def test_scaled_causal_masked_softmax_matches_jax(T, S, window):
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((1, 2, T, S)).astype(np.float32)
    grad = rng.standard_normal(scores.shape).astype(np.float32)
    _softmax_check(lambda x: scaled_causal_masked_softmax(x, 0.7, window),
                   lambda x: jax_softmax.scaled_causal_masked_softmax(x, 0.7, window), scores, grad)


def test_softmax_keeps_the_scores_dtype():
    scores = torch.randn(2, 4, 4, dtype=torch.bfloat16)
    out = scaled_causal_masked_softmax(scores)
    assert out.dtype == torch.bfloat16
    want = torch.softmax(scores.float().masked_fill(~torch.ones(4, 4, dtype=torch.bool).tril(), -1e30), -1)
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# DistributedLinear, ColumnParallelLinear, RowParallelLinear

LINEARS = {"DistributedLinear": (DistributedLinear, jax_linear.DistributedLinear),
           "ColumnParallelLinear": (ColumnParallelLinear, jax_linear.ColumnParallelLinear),
           "RowParallelLinear": (RowParallelLinear, jax_linear.RowParallelLinear)}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("name", sorted(LINEARS))
def test_linear_matches_jax(name, bias):
    port_cls, jax_cls = LINEARS[name]
    jax_smp.init({})
    smp.init({}, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    g = rng.standard_normal((2, 5, 8)).astype(np.float32)
    jm = jax_cls(8, use_bias=bias)
    params = meta.unbox(jm.init(jax.random.key(0), jnp.asarray(x)))
    if bias:  # a nonzero bias
        params["params"]["bias"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    want, vjp = jax.vjp(lambda p, x: jm.apply(p, x), params, jnp.asarray(x))
    d_params, dx_want = vjp(jnp.asarray(g))

    layer = port_cls(16, 8, bias=bias)
    assert [n for n, _ in layer.named_parameters()] == (["weight", "bias"] if bias else ["weight"])
    with torch.no_grad():
        layer.weight.copy_(_t(params["params"]["kernel"]).T)
        if bias:
            layer.bias.copy_(_t(params["params"]["bias"]))
    xt = _t(x, grad=True)
    out = layer(xt)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(layer.weight.grad.numpy().T, np.asarray(d_params["params"]["kernel"]), rtol=0,
                               atol=1e-5)
    if bias:
        np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(d_params["params"]["bias"]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", sorted(LINEARS))
def test_linear_refuses_tp2(monkeypatch, name):
    """The partitions run at tp = 2 (``tests/test_torch_tp_layers.py``), and
    under ``tp_overlap: "ring"`` too (``tests/test_torch_tp_ring.py``); what
    a linear still refuses there is a partitioned feature count that tp does
    not divide, when it is built."""
    smp.init({}, device="cpu")
    monkeypatch.setattr(state, "cfg", smp.ModelParallelConfig({"tensor_parallel_degree": 2, "ddp": True,
                                                               "tp_overlap": "ring"}))
    what = "out_features" if name == "ColumnParallelLinear" else "in_features"
    with pytest.raises(SMPValidationError, match=f"{name} {what} \\(3\\) must be divisible by "
                                                 "tensor_parallel_degree \\(2\\)"):
        LINEARS[name][0](3, 3)


class JaxPair(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = jax_linear.ColumnParallelLinear(32, name="col")(x)
        return jax_linear.RowParallelLinear(8, name="row")(jax.nn.relu(h))


class Pair(nn.Module):
    def __init__(self):
        super().__init__()
        self.col = ColumnParallelLinear(16, 32)
        self.row = RowParallelLinear(32, 8)

    def forward(self, x):
        return self.row(torch.relu(self.col(x)))


FP8_SLOTS = ("linear_col.x", "linear_col.w", "linear_row.x", "linear_row.w")


def test_fp8_step_through_linear_seams_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    tgt = rng.standard_normal((4, 6, 8)).astype(np.float32)
    cfg = {"matmul_precision": "fp8"}

    jax_smp.init(dict(cfg))
    jmodel = jax_smp.DistributedModel(JaxPair())
    jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, x, t):
        loss = jnp.mean((model(x) - t) ** 2)
        model.backward(loss)
        return loss

    want_loss = float(jax_step(jmodel, jnp.asarray(x), jnp.asarray(tgt)).reduce_mean())
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
    want_q = jax_state.quant_state.state_dict()

    smp.init(dict(cfg), device="cpu")
    module = Pair()
    with torch.no_grad():
        for name in ("col", "row"):
            getattr(module, name).weight.copy_(_t(init[name]["kernel"]).T)
            getattr(module, name).bias.copy_(_t(init[name]["bias"]))
    model = smp.DistributedModel(module)
    smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp.step
    def port_step(model, x, t):
        loss = ((model(x) - t) ** 2).mean()
        model.backward(loss)
        return loss

    got_loss = float(port_step(model, _t(x), _t(tgt)).reduce_mean())
    got_q = smp.state.quant_state.state_dict()
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=2e-5)
    assert list(got_q["slots"]) == list(want_q["slots"])
    for slot in FP8_SLOTS:
        i = list(want_q["slots"]).index(slot)
        assert want_q["amax_history"][i][0] > 0, slot  # the seam ran
        np.testing.assert_allclose(got_q["amax_history"][i], want_q["amax_history"][i], rtol=1e-5, err_msg=slot)


# ---------------------------------------------------------------------------
# auto-distribution (tests/test_auto_distribute.py's cases at tp = 1)


class JaxUserNet(fnn.Module):
    dense1: fnn.Module
    dense2: fnn.Module

    def __call__(self, x):
        return self.dense2(fnn.relu(self.dense1(x)))


class UserNet(nn.Module):
    def __init__(self, dense1, dense2):
        super().__init__()
        self.dense1 = dense1
        self.dense2 = dense2

    def forward(self, x):
        return self.dense2(torch.relu(self.dense1(x)))


def test_tensor_parallelism_context_swaps_linear():
    jax_smp.init({})
    with jax_smp.tensor_parallelism():
        jd1 = fnn.Dense(64)
    jmodel = jax_smp.DistributedModel(JaxUserNet(dense1=jd1, dense2=fnn.Dense(16)))

    smp.init({}, device="cpu")
    with smp.tensor_parallelism():
        d1 = nn.Linear(16, 64)
    d2 = nn.Linear(64, 16)
    net = UserNet(d1, d2)
    x = torch.randn(4, 16)
    ref = net(x).detach()
    model = smp.DistributedModel(net)
    assert isinstance(model.module.dense1, DistributedLinear)
    assert type(model.module.dense2) is nn.Linear
    assert model._tp_replaced == jmodel._tp_replaced == ["dense1"]
    # The swapped layer holds the original's tensors under the same names.
    assert set(model.state_dict()) == {"dense1.weight", "dense1.bias", "dense2.weight", "dense2.bias"}
    torch.testing.assert_close(model.module.dense1.weight, d1.weight, rtol=0, atol=0)
    torch.testing.assert_close(model(x), ref, rtol=0, atol=0)


def test_model_creation_context():
    smp.init({"bf16": True}, device="cpu")
    with smp.model_creation(tensor_parallelism=True):
        d1 = nn.Linear(16, 64)
    model = smp.DistributedModel(UserNet(d1, nn.Linear(64, 16)))
    assert isinstance(model.module.dense1, DistributedLinear)
    assert type(model.module.dense2) is nn.Linear
    # dtype agreeing with the config (bf16 or the fp32 master) is fine...
    with smp.model_creation(dtype=torch.bfloat16):
        pass
    with smp.model_creation(dtype=torch.float32):
        pass
    # ...a conflicting half dtype raises.
    with pytest.raises(SMPValidationError, match="dtype"):
        with smp.model_creation(dtype=torch.float16):
            pass
    with pytest.raises(SMPUnsupportedError, match="not supported"):
        with smp.delay_param_initialization(enabled=False):
            pass
    # The context creates parameters on the model's device.
    smp.init({}, device="meta")
    with smp.delay_param_initialization():
        lin = nn.Linear(4, 4)
    assert lin.weight.is_meta
    # After reset there is no live config to agree with.
    smp.reset()
    with pytest.raises(NotInitializedError, match="smp.init"):
        with smp.model_creation(dtype=torch.bfloat16):
            pass


def test_path_marking_swaps():
    jax_smp.init({})
    jax_smp.set_tensor_parallelism("dense2")
    jmodel = jax_smp.DistributedModel(JaxUserNet(dense1=fnn.Dense(64), dense2=fnn.Dense(16)))

    smp.init({}, device="cpu")
    smp.set_tensor_parallelism("dense2")
    model = smp.DistributedModel(UserNet(nn.Linear(16, 64), nn.Linear(64, 16)))
    assert isinstance(model.module.dense2, DistributedLinear)
    assert type(model.module.dense1) is nn.Linear
    assert model._tp_replaced == jmodel._tp_replaced == ["dense2"]
    # enabled=False takes the mark back.
    smp.init({}, device="cpu")
    smp.set_tensor_parallelism("main/dense2/")
    smp.set_tensor_parallelism("dense2", enabled=False)
    assert smp.DistributedModel(UserNet(nn.Linear(16, 64), nn.Linear(64, 16)))._tp_replaced == []


def test_partition_context_records_stage():
    jax_smp.init({})
    with jax_smp.partition(0):
        jd1 = fnn.Dense(8)
    jmodel = jax_smp.DistributedModel(JaxUserNet(dense1=jd1, dense2=fnn.Dense(8)))

    smp.init({}, device="cpu")
    with smp.partition(0):
        d1 = nn.Linear(8, 8)
    model = smp.DistributedModel(UserNet(d1, nn.Linear(8, 8)))
    assert model.module_manager.get_manual_partitions() == jmodel.module_manager.get_manual_partitions() == {
        "dense1": 0}
    assert smp.get_partition("dense1") == jax_smp.get_partition("dense1") == 0
    with pytest.raises(SMPValidationError, match="module path"):
        smp.get_partition(1)
    # pp = 1 holds stage 0 only.
    with pytest.raises(PartitionError, match="out of range"):
        smp.set_partition("dense2", 1)
    with smp.partition(1):
        d1 = nn.Linear(8, 8)
    with pytest.raises(PartitionError, match="out of range"):
        smp.DistributedModel(UserNet(d1, nn.Linear(8, 8)))


def test_output_parity_after_distribution():
    jax_smp.init({})
    net = JaxUserNet(dense1=fnn.Dense(64), dense2=fnn.Dense(16))
    jax_smp.set_tensor_parallelism("dense1")
    jax_smp.set_tensor_parallelism("dense2")
    jmodel = jax_smp.DistributedModel(net)
    x = np.random.default_rng(4).standard_normal((4, 16)).astype(np.float32)
    mod = jmodel.module
    params = meta.unbox(mod.init(jax.random.key(1), jnp.asarray(x))["params"])
    with jax.set_mesh(jax_state.mesh):
        want = jax.jit(lambda p, x: mod.apply({"params": p}, x))(params, jnp.asarray(x))

    smp.init({}, device="cpu")
    d1, d2 = nn.Linear(16, 64), nn.Linear(64, 16)
    with torch.no_grad():
        for layer, name in ((d1, "dense1"), (d2, "dense2")):
            layer.weight.copy_(_t(params[name]["kernel"]).T)
            layer.bias.copy_(_t(params[name]["bias"]))
    smp.set_tensor_parallelism("dense1")
    smp.set_tensor_parallelism("dense2")
    model = smp.DistributedModel(UserNet(d1, d2))
    assert model._tp_replaced == jmodel._tp_replaced == ["dense1", "dense2"]
    np.testing.assert_allclose(model(_t(x)).detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_embed_registration():
    smp.init({}, device="cpu")
    with smp.tensor_parallelism():
        e = nn.Embedding(64, 16)
        padded = nn.Embedding(64, 16, padding_idx=0)

    class EmbNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb, self.padded = e, padded

        def forward(self, ids):
            return self.emb(ids) + self.padded(ids)

    ids = torch.randint(0, 64, (2, 8))
    ref = EmbNet()(ids).detach()
    model = smp.DistributedModel(EmbNet())
    assert isinstance(model.module.emb, DistributedEmbedding)
    # The built-in hook declines a padding row: DistributedEmbedding has none.
    assert type(model.module.padded) is nn.Embedding
    assert model._tp_replaced == ["emb"]
    torch.testing.assert_close(model(ids), ref, rtol=0, atol=0)


def test_user_registration_hooks_match_jax():
    """A registration with init, forward and return hooks (the JAX
    package's ``TestForwardReturnHooks`` at tp = 1): the same weights give
    the same output, f(2x) + 1, and the parameter names stay the
    distributed class's."""

    def fwd_hook(x, **kw):
        return (x * 2.0,), kw

    def ret_hook(out):
        return out + 1.0

    x = np.random.default_rng(5).standard_normal((2, 4)).astype(np.float32)
    jax_smp.init({})
    jax_state.tp_registry.register(fnn.Dense, jax_linear.DistributedLinear,
                                   init_hook=lambda *a, **f: ((), {"features": f["features"]}),
                                   forward_hook=fwd_hook, return_hook=ret_hook)
    try:
        with jax_smp.tensor_parallelism():
            dense = fnn.Dense(8)
        jmodel = jax_smp.DistributedModel(dense)
        want = jmodel(jnp.asarray(x))
        kernel, bias = np.asarray(jmodel.params["kernel"]), np.asarray(jmodel.params["bias"])
    finally:
        from smdistributed_modelparallel_tpu.nn.auto_distribute import _dense_init_hook

        jax_state.tp_registry.register(fnn.Dense, jax_linear.DistributedLinear, init_hook=_dense_init_hook)

    smp.init({}, device="cpu")
    smp.tp_register_with_module(nn.Linear, DistributedLinear,
                                init_hook=lambda in_f, out_f, bias=True, **kw: ((in_f, out_f), {"bias": bias}),
                                forward_hook=fwd_hook, return_hook=ret_hook)
    with smp.tensor_parallelism():
        dense = nn.Linear(4, 8)
    with torch.no_grad():
        dense.weight.copy_(_t(kernel).T)
        dense.bias.copy_(_t(bias))
    model = smp.DistributedModel(dense)
    assert isinstance(model.module, DistributedLinear)
    assert model._tp_replaced == ["<root>"]
    assert set(model.state_dict()) == {"weight", "bias"}
    np.testing.assert_allclose(model(_t(x)).detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


class Block(nn.Module):
    def __init__(self, width, relative_bias=False):
        super().__init__()
        self.proj = nn.Linear(width, width)
        self.relative_bias = relative_bias

    def forward(self, x):
        return self.proj(x)


def test_tp_register_decorator_and_a_declining_init_hook():
    """``@smp.tp_register`` before ``smp.init`` survives it; an init hook
    returning None leaves that module as it is (the reference's T5
    relative-bias block), and the walk goes on into its children, which the
    context marked too (its ``nn.Linear``)."""

    @smp.tp_register(Block, init_hook=lambda width, relative_bias=False: None if relative_bias else ((width,), {}))
    class DistBlock(nn.Module):
        def __init__(self, width):
            super().__init__()
            self.proj = DistributedLinear(width, width)

        def forward(self, x):
            return self.proj(x)

    smp.init({}, device="cpu")
    with smp.tensor_parallelism():
        plain, declined = Block(8), Block(8, relative_bias=True)
    root = nn.Sequential(plain, declined)
    x = torch.randn(2, 8)
    ref = root(x).detach()
    model = smp.DistributedModel(root)
    assert isinstance(model.module[0], DistBlock) and type(model.module[1]) is Block
    assert isinstance(model.module[1].proj, DistributedLinear)
    assert model._tp_replaced == ["0", "1/proj"]
    # The same names and shapes: the swapped block took the original's tensors.
    torch.testing.assert_close(model(x), ref, rtol=0, atol=0)
    smp.reset()
    assert smp.state.tp_registry is None  # reset drops the registry, user registrations included


def test_public_names_match_the_jax_package():
    """``smp.nn`` exports every name of the JAX package's (the MoE pair
    included), and ``smp`` the slice's ten entry points."""
    import smdistributed_modelparallel_tpu.nn as jax_nn

    jax_names = {n for n in vars(jax_nn) if not n.startswith("_") and not isinstance(getattr(jax_nn, n), type(jax_nn))}
    assert jax_names - set(vars(smp.nn)) == set()
    for name in ("from_hf", "tp_register", "tp_register_with_module", "tensor_parallelism",
                 "set_tensor_parallelism", "partition", "set_partition", "get_partition",
                 "delay_param_initialization", "model_creation"):
        assert callable(getattr(smp, name)) and callable(getattr(jax_smp, name)) and name in smp.__all__, name
