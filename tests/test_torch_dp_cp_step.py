"""The port's step at rdp = 2 beside cp = 2 against the JAX package's.

Four CPU processes over gloo (mesh order rdp, ep, cp: rank 2r + c holds rdp
coordinate r and cp coordinate c). Every cp rank of an rdp group is handed the
same rows, the rdp coordinate's rows of the per-process contract
(``shard_batches``), and the step cuts its sequence shard; the ring runs within
each cp group. The oracle is the JAX package's single-process step at
``context_parallel_degree`` 2 on a 4-device CPU mesh (rdp 2), handed the
stream laid out microbatch-major (``_jax_rows``, as in
``tests/test_torch_dp_step.py``). Three SGD steps, at 2 microbatches, fp32:
  - the zoo ``TransformerLM`` with a plain mean;
  - the ``smp.nn`` LM head with 4 experts, top-2, capacity factor 0.5 (so
    assignments drop), whose routing counts the tokens of all four ranks in
    the JAX package's order (rows over rdp, each row's sequence over cp).
Losses within 2e-5 relative, first-step gradients within 1e-4 of each leaf's
largest, final parameters within 2e-4 absolute (the packages sum in other
orders); the replicas are bit-equal after every step, and the per-token
outputs gather along the sequence, then the rows.
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
from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax, params_from_jax

ZOO = dict(vocab_size=64, max_len=16, d_model=32, n_layers=2, n_heads=4)
HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
    num_experts=4, moe_top_k=2, moe_capacity_factor=0.5,
)
STEPS, LR, MB, RDP, CP, B, T = 3, 0.1, 2, 2, 2, 8, 16
RUNS = ["zoo", "moe"]


def _stream():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, (B, T)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], rng.integers(0, 64, (B, 1))], axis=1).astype(np.int32)
    return ids, tgt


def _jax_rows():
    b = B // (MB * RDP)
    return np.array([r * (B // RDP) + m * b + i for m in range(MB) for r in range(RDP) for i in range(b)])


def _to_port(family, params):
    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    sd = lm_head_params_from_jax(flat) if family == "moe" else params_from_jax(flat)
    return {k: v.numpy().copy() for k, v in sd.items()}


def _jax_run(family):
    ids, tgt = (x[_jax_rows()] for x in _stream())
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": MB, "ddp": True, "context_parallel_degree": CP,
                      "_device_count_override": RDP * CP, "tensor_parallel_seed": 5})
        assert jax_smp.rdp_size() == RDP * CP  # the data degree: rdp x cp
        module = jax_tr.DistributedTransformerLMHead(**HEAD) if family == "moe" else JaxTransformerLM(**ZOO)
        model = jax_smp.DistributedModel(module)
        optimizer = jax_smp.DistributedOptimizer(optax.sgd(LR), model)

        @jax_smp.step
        def train_step(model, ids_, tgt_):
            loss = jnp.mean(model(ids_, targets=tgt_))
            model.backward(loss)
            return loss

        losses, init, grads = [], None, None
        for _ in range(STEPS):
            out = train_step(model, jnp.asarray(ids), jnp.asarray(tgt))
            if init is None:
                init, grads = _to_port(family, model.params), _to_port(family, model.grads)
            losses.append(np.asarray(out.stack(), np.float64).reshape(-1).tolist())
            optimizer.step()
        return init, losses, grads, _to_port(family, model.params)
    finally:
        jax_smp.reset()


def _worker(rank, world, inits):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    torch.set_num_threads(1)
    out = {}
    for family, init in zip(RUNS, inits):
        smp.init({"microbatches": MB, "ddp": True, "context_parallel_degree": CP}, device="cpu")
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        assert (state.topology.rdp_size, smp.cp_size(), state.topology.coords(rank)["rdp"], smp.cp_rank()) == \
            (RDP, CP, rank // CP, rank % CP)
        ids, tgt = (torch.from_numpy(x).long() for x in next(smp.shard_batches(iter([_stream()]))))
        module = DistributedTransformerLMHead(**HEAD) if family == "moe" else TransformerLM(**ZOO)
        # Other weights off rank 0: the build broadcasts rank 0's.
        module.load_state_dict({k: torch.from_numpy(v if rank == 0 else v * 0 + 1) for k, v in init.items()})
        model = smp.DistributedModel(module)
        optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR), model)

        @smp.step
        def train_step(model, ids_, tgt_):
            loss = model(ids_, targets=tgt_).mean()
            model.backward(loss)
            return loss

        losses, grads, prints = [], None, []
        for _ in range(STEPS):
            step_out = train_step(model, ids, tgt)
            if grads is None:
                grads = {k: g.numpy().copy() for k, g in model.grads.items()}
            losses.append(step_out.stack().double().reshape(-1).tolist())
            optimizer.step()
            prints.append(b"".join(p.detach().numpy().tobytes() for p in model.module.parameters()))
        out[family] = (losses, grads, {k: v.numpy().copy() for k, v in model.state_dict().items()}, prints)

        if family == "zoo":
            @smp.step
            def eval_step(model, ids_):
                return model(ids_)

            out["logits"] = eval_step(model, ids).stack().numpy()
            out["rows"] = ids.numpy()
    smp.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    want = {family: _jax_run(family) for family in RUNS}
    per_rank = run_ranks(RDP * CP, _worker, [want[f][0] for f in RUNS])
    return want, per_rank


@pytest.mark.parametrize("family", RUNS)
def test_rdp_cp_step_matches_jax(runs, family):
    want, per_rank = runs
    _, want_losses, want_grads, want_params = want[family]
    for r in per_rank:
        losses, grads, params, _ = r[family]
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
        for k, w in want_grads.items():
            w = w.numpy() if hasattr(w, "numpy") else w
            err = float(np.abs(grads[k] - w).max())
            assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-6), (k, err)
        for k, w in want_params.items():
            np.testing.assert_allclose(params[k], w, rtol=0, atol=2e-4, err_msg=k)
    assert np.mean(want_losses[-1]) < np.mean(want_losses[0])


@pytest.mark.parametrize("family", RUNS)
def test_replicas_bit_equal(runs, family):
    _, per_rank = runs
    first = per_rank[0][family][3]
    for r in per_rank[1:]:
        assert r[family][3] == first
        assert r[family][0] == per_rank[0][family][0]


def test_rows_follow_the_rdp_coordinate_and_outputs_gather(runs):
    """shard_batches gives the cp ranks of an rdp group the same rows; the
    step's per-token outputs come back whole: [MB, B/MB, T, V] on every
    rank, equal across the ranks."""
    _, per_rank = runs
    ids = _stream()[0]
    for rank, r in enumerate(per_rank):
        np.testing.assert_array_equal(r["rows"], ids[(rank // CP) * B // RDP:(rank // CP + 1) * B // RDP])
        assert r["logits"].shape == (MB, B // MB, T, ZOO["vocab_size"])
        np.testing.assert_array_equal(r["logits"], per_rank[0]["logits"])
