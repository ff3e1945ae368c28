"""The port's context-parallel training step against the JAX package's.

Three SGD steps at ``context_parallel_degree: 2`` in two CPU processes
over gloo (each rank handed the full batch, the step slicing its sequence
shard), against the JAX package's cp = 2 step on a 2-device CPU mesh with
the same converted weights and numpy batch (its ring and Ulysses bodies run
the Pallas kernels in interpret mode): per-step losses, the first step's
gradients and the final parameters, fp32. The configurations:
  - the zoo ``TransformerLM`` (learned positions, so the shard's position
    offset shows), ring, 2 microbatches, a masked-mean loss whose count
    the ranks weigh (``model.backward(loss, num_tokens=...)``);
  - the same at 1 microbatch with a plain mean (equal weights);
  - the same as the first under Ulysses;
  - the ``smp.nn`` ``DistributedTransformerLMHead``, ring, 2 microbatches.
Tolerances: losses 2e-5 relative, gradients 1e-4 of each leaf's largest and
parameters 2e-4 absolute: both run the same function in fp32 and differ in
summation order (the ring's merge against GSPMD's global softmax). SGD, as
the JAX package's own cp training tests use: AdamW's first steps move a
parameter by ~lr whatever its gradient's size, so the key bias, whose
gradient is zero but for rounding (softmax ignores a per-row shift), would
move by +-lr in a direction the rounding picks.

Also held, from the same spawned ranks: ``smp.generate`` at cp = 2 gives the
JAX package's tokens (both compute whole sequences on every rank); the
step's refusals (fp16 and fp8 under cp, data parallelism beside it, expert
parallelism, ``context_parallel_impl: allgather``); and the attention
dispatch's refusal of every case the ring and Ulysses do not cover, where
attending over the local shard alone would be wrong.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.ops import context_parallel as jax_cp
from smdistributed_modelparallel_tpu.ops import pallas_attention as jax_pa
from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax, params_from_jax

ZOO = dict(vocab_size=64, max_len=32, d_model=32, n_layers=2, n_heads=4)
LMHEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=32, causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
STEPS, LR = 3, 0.1
# (name, model family, impl, microbatches, loss)
RUNS = [
    ("zoo_ring_mb2_masked", "zoo", "ring", 2, "masked"),
    ("zoo_ring_mb1_mean", "zoo", "ring", 1, "mean"),
    ("zoo_ulysses_mb2_masked", "zoo", "ulysses", 2, "masked"),
    ("lmhead_ring_mb2_masked", "lmhead", "ring", 2, "masked"),
]


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (4, 32)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1).astype(np.int32)
    tgt[0, 3:9] = -100  # rank 0's shard counts fewer tokens than rank 1's
    tgt[2, 20] = -100
    return ids, tgt


def _jax_module(family):
    return JaxTransformerLM(**ZOO) if family == "zoo" else jax_tr.DistributedTransformerLMHead(**LMHEAD)


def _to_port(family, params):
    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return params_from_jax(flat) if family == "zoo" else lm_head_params_from_jax(flat)


def _jax_run(family, impl, mb, loss_kind):
    """(init state dict, losses, first step's grads, final params) of the
    JAX package's cp = 2 step."""
    ids, tgt = _batch()
    jax_pa.FORCE_INTERPRET = True
    jax_cp._ring_flash_fn.cache_clear()
    jax_cp._build_cp_call.cache_clear()
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": mb, "context_parallel_degree": 2, "ddp": True,
                      "context_parallel_impl": impl, "_device_count_override": 2})
        model = jax_smp.DistributedModel(_jax_module(family))
        optimizer = jax_smp.DistributedOptimizer(optax.sgd(LR), model)

        @jax_smp.step
        def train_step(model, ids_, tgt_):
            per = model(ids_, targets=tgt_)
            loss = jnp.mean(per) if loss_kind == "mean" else jnp.sum(per) / jnp.sum(tgt_ != -100)
            model.backward(loss)
            return loss

        losses, init, grads = [], None, None
        for _ in range(STEPS):
            out = train_step(model, jnp.asarray(ids), jnp.asarray(tgt))
            if init is None:
                init = _to_port(family, model.params)
                grads = _to_port(family, model.grads)
            losses.append(float(out.reduce_mean()))
            optimizer.step()
        return init, losses, grads, _to_port(family, model.params)
    finally:
        jax_pa.FORCE_INTERPRET = False
        jax_smp.reset()


def _port_module(family):
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    return TransformerLM(**ZOO) if family == "zoo" else DistributedTransformerLMHead(**LMHEAD)


def _train_worker(rank, world, runs, inits):
    """Each configuration's (losses, first grads, final params) on this
    rank."""
    import smdistributed_modelparallel_tpu_torch as smp

    ids, tgt = (torch.from_numpy(x).long() for x in _batch())
    out = {}
    for (name, family, impl, mb, loss_kind), init in zip(runs, inits):
        smp.init({"microbatches": mb, "context_parallel_degree": world, "ddp": True,
                  "context_parallel_impl": impl}, device="cpu")
        module = _port_module(family)
        module.load_state_dict(init)
        model = smp.DistributedModel(module)
        optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR), model)

        @smp.step
        def train_step(model, ids_, tgt_):
            per = model(ids_, targets=tgt_)
            if loss_kind == "mean":
                loss = per.mean()
                model.backward(loss)
            else:
                count = (tgt_ != -100).sum()
                loss = per.sum() / count
                model.backward(loss, num_tokens=count)
            return loss

        losses, grads = [], None
        for _ in range(STEPS):
            step_out = train_step(model, ids, tgt)
            if grads is None:
                grads = {k: g.numpy().copy() for k, g in model.grads.items()}
            losses.append(float(step_out.reduce_mean()))
            optimizer.step()
        out[name] = (losses, grads, {k: v.numpy().copy() for k, v in model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def port_and_jax():
    jax_runs = {name: _jax_run(*spec) for name, *spec in RUNS}
    per_rank = run_ranks(2, _train_worker, RUNS, [jax_runs[name][0] for name, *_ in RUNS])
    return jax_runs, per_rank


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_cp2_training_matches_jax(port_and_jax, name):
    jax_runs, per_rank = port_and_jax
    _, want_losses, want_grads, want_params = jax_runs[name]
    losses, grads, params = per_rank[0][name]
    np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
    assert losses[-1] < losses[0]
    for k, want in want_grads.items():
        want = want.numpy()
        err = float(np.abs(grads[k] - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-6), (k, err)
    for k, want in want_params.items():
        np.testing.assert_allclose(params[k], want.numpy(), rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_cp_ranks_stay_replicated(port_and_jax, name):
    """The gradients are summed over the group, so both ranks take the same
    updates and report the same losses."""
    _, per_rank = port_and_jax
    (l0, g0, p0), (l1, g1, p1) = per_rank[0][name], per_rank[1][name]
    assert l0 == l1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


# ----------------------------------------------------------------------
# generate at cp = 2, and the refusals
# ----------------------------------------------------------------------


def _expect_raise(fn):
    try:
        fn()
    except Exception as e:  # the test reads the class and the message
        return type(e).__name__, str(e)
    return None


def _refusal_worker(rank, world, init, prompts):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core

    out = {}
    smp.init({"context_parallel_degree": world, "ddp": True}, device="cpu")
    module = TransformerLM(**ZOO)
    module.load_state_dict(init)
    model = smp.DistributedModel(module)
    out["generate"] = smp.generate(model, torch.from_numpy(prompts).long(), 6).numpy()
    out["ranks"] = (smp.rank(), smp.size(), smp.local_rank(), smp.cp_rank(), smp.cp_size(), smp.get_cp_group())
    out["transport"] = state.group("cp").transport

    ids = torch.from_numpy(_batch()[0]).long()

    def step_with(cfg, module_kw=None):
        def run():
            smp.init({"ddp": True, **cfg}, device="cpu")
            m = smp.DistributedModel(TransformerLM(**{**ZOO, **(module_kw or {})}))

            @smp.step
            def train_step(model, ids_):
                loss = model(ids_, targets=ids_).mean()
                model.backward(loss)
                return loss

            train_step(m, ids)
        return _expect_raise(run)

    out["fp16"] = step_with({"context_parallel_degree": 2, "fp16": True})
    out["fp8"] = step_with({"context_parallel_degree": 2, "matmul_precision": "fp8"})
    out["rdp"] = step_with({})
    out["ep"] = step_with({"expert_parallel_degree": 2})
    out["allgather"] = step_with({"context_parallel_degree": 2, "context_parallel_impl": "allgather"})
    out["window"] = step_with({"context_parallel_degree": 2}, dict(window=8))

    smp.init({"context_parallel_degree": 2, "ddp": True}, device="cpu")
    q = torch.zeros(1, 16, 4, 8)
    cases = {
        "bias": dict(bias=torch.zeros(1, 1, 16, 16)),
        "mask_along_t": dict(mask=torch.ones(1, 1, 16, 16, dtype=torch.bool)),
        "local_select": dict(local_select=True, window=4),
        "t_ne_s": dict(k=torch.zeros(1, 8, 4, 8), v=torch.zeros(1, 8, 4, 8)),
        "mixed_dtypes": dict(k=torch.zeros(1, 16, 4, 8, dtype=torch.bfloat16)),
        "use_pallas_false": dict(use_pallas=False),
    }
    state.cp_sharded = True
    try:
        for name, kw in cases.items():
            k, v = kw.pop("k", q), kw.pop("v", q)
            out[f"dispatch_{name}"] = _expect_raise(lambda: attention_core(q, k, v, **kw))
    finally:
        state.cp_sharded = False
    return out


@pytest.fixture(scope="module")
def refusal_runs():
    jmod = JaxTransformerLM(**ZOO)
    params = jmod.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))["params"]
    prompts = np.random.default_rng(5).integers(0, 64, (2, 20)).astype(np.int32)
    jax_smp.reset()
    jax_smp.init({"context_parallel_degree": 2, "ddp": True, "_device_count_override": 2})
    want = np.asarray(jax_smp.generate(jmod, jnp.asarray(prompts), 6, params=params))
    jax_smp.reset()
    return want, run_ranks(2, _refusal_worker, _to_port("zoo", params), prompts)


def test_generate_at_cp2_gives_jax_tokens(refusal_runs):
    want, per_rank = refusal_runs
    for r in per_rank:
        np.testing.assert_array_equal(r["generate"], want)


def test_rank_queries_and_transport(refusal_runs):
    _, per_rank = refusal_runs
    assert [r["ranks"] for r in per_rank] == [(0, 2, 0, 0, 2, [0, 1]), (1, 2, 1, 1, 2, [0, 1])]
    assert all(r["transport"] == "gloo" for r in per_rank)


@pytest.mark.parametrize("case,match", [
    ("fp16", "fp16 under context parallelism"),
    ("fp8", "fp8 under context parallelism"),
    ("rdp", "data parallelism"),
    ("ep", "expert_parallel_degree"),
    ("allgather", "allgather"),
    ("window", "local-attention window"),
])
def test_step_refusals(refusal_runs, case, match):
    _, per_rank = refusal_runs
    for r in per_rank:
        assert r[case] is not None and r[case][0] == "NotImplementedError" and match in r[case][1], r[case]


@pytest.mark.parametrize("case,match", [
    ("bias", "additive bias"),
    ("mask_along_t", "varies along the query axis"),
    ("local_select", "local_select"),
    ("t_ne_s", "T != S"),
    ("mixed_dtypes", "mixed q/k/v dtypes"),
    ("use_pallas_false", "use_pallas_kernels: False"),
])
def test_uncovered_dispatch_raises(refusal_runs, case, match):
    _, per_rank = refusal_runs
    got = per_rank[0][f"dispatch_{case}"]
    assert got is not None and got[0] == "NotImplementedError" and match in got[1], got
