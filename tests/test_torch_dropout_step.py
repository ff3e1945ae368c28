"""Training-time dropout of the port against the JAX package's.

A tiny ``DistributedTransformerLMHead`` (2 layers, D 64, 4 heads, T 128,
vocab 97, fp32, attention, hidden and embedding dropout 0.1) on the weights
of a JAX init (``convert.lm_head_params_from_jax``), in both packages on
the CPU, so attention takes the plain path on both sides:
  - one ``@smp.step`` forward: the output of every ``Dropout_*`` site (read
    with ``capture_intermediates=True`` on the JAX side, with the microbatch
    key the JAX package's ``RngManager`` and ``jax.random`` derive) has the
    same zeros, and the attention modules' outputs agree to 1e-5 (fp32;
    summation order only), which holds the attention masks too;
  - 3 steps (2 microbatches, SGD 0.1): losses, gradients and parameters at
    ``tests/test_torch_step.py``'s tolerances (losses rtol 2e-4 / atol 2e-5,
    gradients and parameters rtol 2e-3 / atol 2e-4);
  - 1 step with both sides on the flash route (the JAX gate patched, the
    Pallas kernel in interpret mode; the port's gate patched, so the
    kernel's plain version runs with the same counter hash);
  - eval mode draws no key and equals the dropout-0 model;
  - the zoo ``TransformerLM(dropout=0.1, deterministic=False)``: one step.

The JAX package's ``DistributedTransformerLMHead`` builds its embedding
``nn.Dropout`` inline in ``embed``, a method flax does not treat as compact,
so with ``embedding_dropout_prob > 0`` it raises ``AssignSubModuleError``
(``ROADMAP.md`` Queue 3). The JAX side here is a test subclass whose
``embed`` is compact, which gives that Dropout its flax auto-name
("Dropout_0" in the root scope); the JAX package's files do not change.
"""

import flax
import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.ops import attention as jax_attention
from smdistributed_modelparallel_tpu.ops import pallas_attention
from smdistributed_modelparallel_tpu.utils.random import RngManager as JaxRngManager
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax, params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.ops import attention as port_attention
from smdistributed_modelparallel_tpu_torch.ops import dropout as port_dropout
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

DROP = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=128,
    vocab_size=97, num_positions=128, causal_mask_size=128, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.1, hidden_dropout_prob=0.1, embedding_dropout_prob=0.1,
)
B, T = 4, 128
SEED = 7  # tensor_parallel_seed of both packages
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)


class JaxLMHead(jax_tr.DistributedTransformerLMHead):
    """The JAX module with ``embed`` compact (see the module docstring)."""

    @nn.compact
    def embed(self, *args, **kwargs):
        return jax_tr.DistributedTransformerLMHead.embed.__wrapped__(self, *args, **kwargs)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


def _jax_session():
    """A default JAX session (tp 1): a test of another file in this worker
    may have left one at tp 2, whose parameters come boxed with partition
    names and whose layers take the tp path."""
    jax_smp.init({})


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, DROP["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def init_params():
    _jax_session()
    ids = jnp.asarray(_ids())
    params = JaxLMHead(**DROP, deterministic=True).init(jax.random.key(1), ids)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, **kw):
    module = port_tr.DistributedTransformerLMHead(**{**DROP, **kw})
    module.load_state_dict(lm_head_params_from_jax(params), strict=True)
    return smp_torch.DistributedModel(module, device="cpu")


def _jax_loss(logits, batch):
    return jnp.mean(jax_vpce(logits[:, :-1], batch[:, 1:]))


def _port_loss(logits, batch):
    return vocab_parallel_cross_entropy(logits[:, :-1], batch[:, 1:]).mean()


def _microbatch_key(step, mb, num_mb):
    """The JAX step program's "dropout" key of microbatch ``mb`` in step
    ``step`` (from 0): the "step" stream's first key, split into (use, next)
    once a step, ``use`` split per microbatch, the stream's index 0 folded
    in."""
    rng = JaxRngManager(SEED).next_key("step")
    for _ in range(step):
        rng = jax.random.split(rng)[1]
    use = jax.random.split(rng)[0]
    return jax.random.fold_in(jax.random.split(use, num_mb)[mb], 0)


def test_every_dropout_site_zeroes_where_jax_does(init_params, monkeypatch):
    ids = _ids(3)
    _jax_session()
    jmod = JaxLMHead(**DROP, deterministic=False)
    _, st = jmod.apply({"params": init_params}, jnp.asarray(ids), rngs={"dropout": _microbatch_key(0, 0, 1)},
                       capture_intermediates=True, mutable=["intermediates"])
    inter = flax.core.unfreeze(st["intermediates"])
    layer = inter["transformer"]["seq_layers"]["layer"]
    want = [np.asarray(inter["Dropout_0"]["__call__"][0])]  # the embedding's
    for i in range(DROP["num_layers"]):
        want += [np.asarray(layer[s]["Dropout_0"]["__call__"][0][i]) for s in ("attention", "output")]
    want_attn = np.asarray(layer["attention"]["__call__"][0])

    seen, attn_out = [], []
    real = port_dropout.dropout
    monkeypatch.setattr(port_dropout, "dropout",
                        lambda x, rate, key: seen.append(real(x, rate, key)) or seen[-1])
    smp_torch.init({"microbatches": 1, "tensor_parallel_seed": SEED}, device="cpu")
    model = _port_model(init_params)
    for m in model.module.transformer.seq_layers:
        m.attention.register_forward_hook(lambda mod, a, out: attn_out.append(out.detach()))

    @smp_torch.step
    def fwd(model, batch):
        return model(batch)

    fwd(model, torch.from_numpy(ids).long())
    # The embedding's, then each layer's attention-output and MLP-output
    # dropouts, in call order.
    assert len(seen) == len(want) == 5
    for i, (got, w) in enumerate(zip((t.detach().numpy() for t in seen), want)):
        np.testing.assert_array_equal(got == 0, w == 0, err_msg=f"site {i}")
        kept = (w != 0).mean()
        assert 0.85 < kept < 0.95
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.stack(attn_out).numpy(), want_attn, rtol=0, atol=1e-5)


def _jax_train(ids, steps, num_mb, module=None, convert=lm_head_params_from_jax):
    """``steps`` SGD(0.1) steps of the JAX package from its own init:
    ``(initial parameters, (losses, gradients, parameters))`` in the
    port's names."""
    jax_smp.init({"microbatches": num_mb, "tensor_parallel_seed": SEED})
    jmodel = jax_smp.DistributedModel(module or JaxLMHead(**DROP))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, batch):
        loss = _jax_loss(model(batch), batch)
        model.backward(loss)
        return loss

    def tree(t):
        return convert(jax.tree_util.tree_map(np.asarray, jax.device_get(t)))

    losses, grads, init = [], [], None
    for _ in range(steps):
        losses.append(float(jax_step(jmodel, jnp.asarray(ids)).reduce_mean()))
        init = init or tree(jmodel.params)  # parameters change at jopt.step()
        grads.append(tree(jmodel.grads))
        jopt.step()
    return init, (losses, grads, tree(jmodel.params))


def _port_train(module, state_dict, ids, steps, num_mb):
    smp_torch.init({"microbatches": num_mb, "tensor_parallel_seed": SEED}, device="cpu")
    module.load_state_dict(state_dict, strict=True)
    model = smp_torch.DistributedModel(module, device="cpu")
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def port_step(model, batch):
        loss = _port_loss(model(batch), batch)
        model.backward(loss)
        return loss

    losses, grads = [], []
    for _ in range(steps):
        losses.append(float(port_step(model, torch.from_numpy(ids).long()).reduce_mean()))
        grads.append({k: v.clone() for k, v in model.grads.items()})
        opt.step()
    return losses, grads, model.state_dict()


def _assert_runs_agree(got, want):
    losses, grads, params = got
    want_losses, want_grads, want_params = want
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    for step, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **PARAM_TOL, err_msg=f"{step} {name}")
    for name, w in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), w.numpy(), **PARAM_TOL, err_msg=name)


def test_three_steps_match_jax():
    ids = _ids(4)
    init, want = _jax_train(ids, 3, 2)
    got = _port_train(port_tr.DistributedTransformerLMHead(**DROP), init, ids, 3, 2)
    _assert_runs_agree(got, want)
    assert got[0][-1] < got[0][0]


def test_flash_route_step_matches_jax(monkeypatch):
    """One step with attention on the flash route on both sides: the
    kernels hash the seed ``bits(key, ())`` of the attention key."""
    monkeypatch.setattr(jax_attention, "_pallas_ok", lambda q, k, v: True)
    monkeypatch.setattr(pallas_attention, "FORCE_INTERPRET", True)
    seeds = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "_kernel_ok", lambda q, k, v: True)
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **k: seeds.append(k["seed"]) or real(*a, **k))
    ids = _ids(5)
    init, want = _jax_train(ids, 1, 1)
    got = _port_train(port_tr.DistributedTransformerLMHead(**DROP), init, ids, 1, 1)
    assert len(seeds) == DROP["num_layers"] and all(isinstance(s, int) for s in seeds)
    _assert_runs_agree(got, want)


def test_eval_mode_draws_no_key_and_equals_dropout_zero(init_params):
    ids = torch.from_numpy(_ids(6)).long()
    smp_torch.init({"microbatches": 1}, device="cpu")
    plain = port_tr.DistributedTransformerLMHead(**{**DROP, **dict.fromkeys(
        ("attention_dropout_prob", "hidden_dropout_prob", "embedding_dropout_prob"), 0.0)})
    plain.load_state_dict(lm_head_params_from_jax(init_params), strict=True)
    model = _port_model(init_params)
    with pytest.raises(SMPValidationError, match="needs PRNG for 'dropout'"):
        model(ids)  # training mode outside a step: no key, as flax's make_rng finds none
    model.eval()

    @smp_torch.step
    def fwd(model, batch):
        return model(batch)

    out = fwd(model, ids).outputs[0]
    assert model._rng_counts == {}
    torch.testing.assert_close(out, plain(ids), rtol=0, atol=0)


ZOO = dict(vocab_size=97, max_len=128, d_model=64, n_layers=2, n_heads=4)


def test_zoo_dropout_step_matches_jax(monkeypatch):
    ids = _ids(8)
    init, want = _jax_train(ids, 1, 2, JaxTransformerLM(**ZOO, dropout=0.1, deterministic=False), params_from_jax)
    calls = []
    real = port_dropout.dropout_fwd
    monkeypatch.setattr(port_dropout, "dropout_fwd", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _port_train(TransformerLM(**ZOO, dropout=0.1, deterministic=False), init, ids, 1, 2)
    # Per microbatch and layer: the attention probabilities and the block output.
    assert len(calls) == 2 * ZOO["n_layers"] * 2
    _assert_runs_agree(got, want)
