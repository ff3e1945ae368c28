"""fp8 delayed-scaling training (``matmul_precision: fp8``) of the port's
``smp.nn.DistributedTransformerLMHead`` against the JAX package's.

``tests/test_quant.py``'s TINY model with ``fused_bias_gelu=True`` trains 3
steps of ``@smp.step`` (``microbatches: 2``, SGD 0.1) in both packages from
the same weights (``convert.lm_head_params_from_jax``) and batch, under the
fused QKV (``fused_qkv: True``: the fp8 rung, the port's through the
kernel's plain version by the ``_is_cuda`` seams, the JAX package's through
the Pallas kernels in interpret mode) and its unfused twin, in fp32 and in
bf16. Held, per step: losses, gradients, parameters, and the
``amax_history``/``scale`` of all 19 slots (the same 11 observed):
  - fp32: the f8 operands are identical in both packages (the casts agree
    bit for bit), so only fp32 summation order differs: losses, gradients
    and parameters to atol 2e-5 (``test_fused_training_matches_jax``'s),
    the quant state to rtol 1e-5;
  - bf16: the packages round activations to bf16 at different points
    (``test_torch_step``'s bf16 case), which moves elements across e4m3 and
    e5m2 rounding boundaries (2**-3 and 2**-2 apart): the gradients differ
    as much as the JAX package's own bf16 and fp32 runs do (4.6-5.4% in
    relative L2 over all leaves on this model, against the port's
    3.8-5.6%), so the gradients are held to 0.1 in relative L2 over all
    leaves; losses to rtol 1e-3; parameters to 5e-3 (three SGD steps of 0.1
    times such gradients; the JAX package's own bf16-fp32 gap is 1.2e-3);
    the quant state to rtol 5e-2 (the updates differ, so later steps'
    activations and their maxima drift by a few percent) and the first
    step's amax column to rtol 1e-2 (same weights: a bf16 ulp or two).
Also: an eval-only step (no ``model.backward``) rolls the forward slots as
the JAX step does, and the zoo ``TransformerLM`` (no fp8 seam) trains under
fp8 and leaves the state fresh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.backend.state import state as jax_state
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.ops import pallas_gelu, pallas_qkv
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch import quant as pq
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

TINY = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8,
    hidden_size=32, intermediate_size=64, vocab_size=96, num_positions=32,
    causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0,
    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
KW = dict(TINY, fused_bias_gelu=True)
STEPS, NUM_MB = 3, 2
OBSERVED = {"qkv.x", "qkv.w", "attn_proj.x", "attn_proj.w", "mlp_fc.x", "mlp_fc.w", "mlp_proj.x", "mlp_proj.w",
            "gelu_in.x", "attn_q.x", "attn_k.x"}
RUNS = [("fused", "fp32"), ("fused", "bf16"), ("unfused", "fp32"), ("unfused", "bf16")]
TOL = {
    "fp32": dict(loss=dict(rtol=0, atol=2e-5), grad=None, param=2e-5, quant=1e-5, first=1e-5),
    "bf16": dict(loss=dict(rtol=1e-3, atol=0), grad=0.1, param=5e-3, quant=5e-2, first=1e-2),
}


def _ids():
    return np.random.default_rng(0).integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)


def _tree(t):
    return lm_head_params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(t)))


def _jax_run(cfg):
    jax_smp.init(dict(cfg))
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**KW))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, batch):
        logits = model(batch)
        loss = jnp.mean(jax_vpce(logits[:, :-1], batch[:, 1:]))
        model.backward(loss)
        return loss

    out = dict(losses=[], grads=[], params=[], quant=[])
    for _ in range(STEPS):
        out["losses"].append(float(jax_step(jmodel, jnp.asarray(_ids())).reduce_mean()))
        out.setdefault("init", _tree(jmodel.params))
        out["grads"].append(_tree(jmodel.grads))
        jopt.step()
        out["params"].append(_tree(jmodel.params))
        out["quant"].append(jax_state.quant_state.state_dict())
    jax_smp.reset()
    return out


def _port_run(cfg, init):
    smp_torch.init(dict(cfg), device="cpu")
    module = port_tr.DistributedTransformerLMHead(**KW)
    module.load_state_dict(init, strict=True)
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def port_step(model, batch):
        logits = model(batch)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], batch[:, 1:]).mean()
        model.backward(loss)
        return loss

    out = dict(losses=[], grads=[], params=[], quant=[])
    for _ in range(STEPS):
        out["losses"].append(float(port_step(model, torch.from_numpy(_ids()).long()).reduce_mean()))
        out["grads"].append({k: v.float().clone() for k, v in model.grads.items()})
        opt.step()
        out["params"].append({k: v.float().clone() for k, v in model.state_dict().items()})
        out["quant"].append(smp_torch.state.quant_state.state_dict())
    smp_torch.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of each (QKV, dtype) in RUNS, and the port's calls
    of the fp8 kernel's wrapper, ``matmul_bias`` and ``bias_gelu``."""
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_qkv, "FORCE_INTERPRET", True)
        mp.setattr(pallas_gelu, "FORCE_INTERPRET", True)
        mp.setattr(mb, "_is_cuda", lambda t: True)
        mp.setattr(bg, "_is_cuda", lambda t: True)
        calls = {}

        def spy(name, fn):
            def wrapped(*a, **k):
                calls[name] = calls.get(name, 0) + 1
                return fn(*a, **k)
            return wrapped

        mp.setattr(pq, "matmul_fp8", spy("matmul_fp8", pq.matmul_fp8))
        mp.setattr(mb, "matmul_bias", spy("matmul_bias", mb.matmul_bias))
        mp.setattr(bg, "bias_gelu", spy("bias_gelu", bg.bias_gelu))
        for qkv, dtype in RUNS:
            cfg = {"microbatches": NUM_MB, "fused_qkv": qkv == "fused", "matmul_precision": "fp8",
                   "bf16": dtype == "bf16"}
            want = _jax_run(cfg)
            calls.clear()
            got = _port_run(cfg, want["init"])
            results[qkv, dtype] = (got, want, dict(calls))
    return results


def _ids_of(run):
    return f"{run[0]}-{run[1]}"


@pytest.mark.parametrize("run", RUNS, ids=_ids_of)
def test_losses_match_jax(runs, run):
    got, want, _ = runs[run]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL[run[1]]["loss"])
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("run", RUNS, ids=_ids_of)
def test_gradients_match_jax(runs, run):
    got, want, _ = runs[run]
    rel = TOL[run[1]]["grad"]
    for step, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.keys() == w.keys()
        if rel is None:
            for name, wv in w.items():
                np.testing.assert_allclose(g[name].numpy(), wv.numpy(), rtol=0, atol=2e-5, err_msg=name)
        else:
            diff = sum(float(((g[n] - wv) ** 2).sum()) for n, wv in w.items())
            norm = sum(float((wv ** 2).sum()) for wv in w.values())
            assert (diff / norm) ** 0.5 <= rel, (step, (diff / norm) ** 0.5)


@pytest.mark.parametrize("run", RUNS, ids=_ids_of)
def test_parameters_match_jax(runs, run):
    got, want, _ = runs[run]
    for p, w in zip(got["params"], want["params"]):
        for name, wv in w.items():
            np.testing.assert_allclose(p[name].numpy(), wv.numpy(), rtol=0, atol=TOL[run[1]]["param"], err_msg=name)


@pytest.mark.parametrize("run", RUNS, ids=_ids_of)
def test_quant_state_matches_jax(runs, run):
    got, want, _ = runs[run]
    rtol = TOL[run[1]]["quant"]
    for step, (g, w) in enumerate(zip(got["quant"], want["quant"])):
        assert g["slots"] == w["slots"]
        live = {s for s, h in zip(w["slots"], w["amax_history"]) if h[0] > 0}
        assert live == OBSERVED
        assert {s for s, h in zip(g["slots"], g["amax_history"]) if h[0] > 0} == live
        # Histories fill one column a step, newest first.
        assert (g["amax_history"][:, step + 1:] == 0).all()
        np.testing.assert_allclose(g["amax_history"], w["amax_history"], rtol=rtol, atol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(g["amax_history"][:, step], w["amax_history"][:, step], rtol=TOL[run[1]]["first"],
                                   atol=0, err_msg="the first step's column")
        np.testing.assert_allclose(g["scale"], w["scale"], rtol=rtol, atol=0, err_msg=f"step {step}")
    final = got["quant"][-1]
    moved = {s for s, sc in zip(final["slots"], final["scale"]) if sc != 1.0}
    assert moved == OBSERVED


@pytest.mark.parametrize("run", RUNS, ids=_ids_of)
def test_route_through_the_fp8_rung(runs, run):
    """The fused QKV's forward product went through ``matmul_fp8`` in every
    layer of every microbatch of every step, and ``matmul_bias`` never; the
    unfused twin through neither. The bias-GELU kernel ran in both."""
    _, _, calls = runs[run]
    n = STEPS * NUM_MB * TINY["num_layers"]
    want = {"matmul_fp8": n, "bias_gelu": n} if run[0] == "fused" else {"bias_gelu": n}
    assert calls == want


def test_eval_only_step_rolls_forward_slots_as_jax(monkeypatch):
    """A step without ``model.backward`` still quantizes and rolls the
    forward slots; its outputs and state match the JAX eval step's."""
    monkeypatch.setattr(pallas_qkv, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_gelu, "FORCE_INTERPRET", True)
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bg, "_is_cuda", lambda t: True)
    cfg = {"microbatches": NUM_MB, "fused_qkv": True, "matmul_precision": "fp8"}
    ids = _ids()
    jax_smp.init(dict(cfg))
    jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**KW))

    @jax_smp.step
    def jax_eval(model, batch):
        return model(batch)

    want = [np.asarray(jax_eval(jmodel, jnp.asarray(ids)).concat()) for _ in range(2)]
    want_qs = jax_state.quant_state.state_dict()
    init = _tree(jmodel.params)
    jax_smp.reset()

    smp_torch.init(dict(cfg), device="cpu")
    module = port_tr.DistributedTransformerLMHead(**KW)
    module.load_state_dict(init, strict=True)
    model = smp_torch.DistributedModel(module)

    @smp_torch.step
    def port_eval(model, batch):
        return model(batch)

    got = [port_eval(model, torch.from_numpy(ids).long()).concat().numpy() for _ in range(2)]
    got_qs = smp_torch.state.quant_state.state_dict()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    assert not np.array_equal(got[0], got[1])  # step 2 quantized with step 1's scales
    np.testing.assert_allclose(got_qs["amax_history"], want_qs["amax_history"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_qs["scale"], want_qs["scale"], rtol=1e-5, atol=0)
    assert {s for s, h in zip(got_qs["slots"], got_qs["amax_history"]) if h[0] > 0} == OBSERVED


def test_zoo_transformer_lm_leaves_quant_state_fresh():
    """The zoo model has no fp8 seam (nor has the JAX package's): under fp8
    it trains as it would under bf16 and the state does not move."""
    smp_torch.init({"microbatches": 2, "matmul_precision": "fp8"}, device="cpu")
    module = TransformerLM(vocab_size=64, max_len=16, d_model=32, n_layers=2, n_heads=4)
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def train_step(model, batch):
        loss = model(batch, targets=batch).mean()
        model.backward(loss)
        return loss

    batch = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 16))).long()
    losses = []
    for _ in range(2):
        losses.append(float(train_step(model, batch).reduce_mean()))
        opt.step()
    assert np.isfinite(losses).all()
    sd = smp_torch.state.quant_state.state_dict()
    assert (sd["amax_history"] == 0).all() and (sd["scale"] == 1.0).all()
    smp_torch.reset()
