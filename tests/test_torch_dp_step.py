"""The port's data-parallel training step against the JAX package's.

Three SGD steps at rdp = 2 in two CPU processes over gloo, each rank handed
its own rows of the global batch (the per-process contract of
``shard_batches``), against the JAX package's rdp = 2 step on a 2-device CPU
mesh with the same converted weights. The JAX step groups microbatch m as
rows [m*B/M, (m+1)*B/M) of the batch it is handed and shards each over rdp;
the port's microbatch m is the union of the ranks' microbatch m. The JAX
batch is the global stream laid out microbatch-major, so both steps put the
same rows in the same microbatch on the same replica (``_jax_rows``). The
configurations, at 2 microbatches:
  - the zoo ``TransformerLM`` with a plain mean;
  - the same with a masked mean whose token counts differ across the ranks
    and the microbatches (``model.backward(loss, num_tokens=...)``);
  - the ``smp.nn`` ``DistributedTransformerLMHead`` with the masked mean.
Tolerances: losses 2e-5 relative, first-step gradients 1e-4 of each leaf's
largest, final parameters 2e-4 absolute (fp32; the two packages sum in other
orders). The replicas are bit-equal after every step: every rank applies
the same reduced gradients.

Also held, in the same two ranks: the step's ``StepOutput`` gathers per-row
outputs along the rows in rank order, and every refusal that stays at rdp =
2 raises naming its ROADMAP item (fp16, fp8, the health sentinel, dropout;
rdp beside cp needs four ranks and is held in
``tests/test_torch_control_plane.py``).
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
LMHEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
STEPS, LR, MB, RDP, B, T = 3, 0.1, 2, 2, 8, 16
# (name, model family, loss)
RUNS = [
    ("zoo_mean", "zoo", "mean"),
    ("zoo_masked", "zoo", "masked"),
    ("lmhead_masked", "lmhead", "masked"),
]


def _stream():
    """The global batch in stream order: rank r is handed rows
    [r*B/R, (r+1)*B/R)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (B, T)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1).astype(np.int32)
    tgt[0, 2:13] = -100  # rank 0's first microbatch counts far fewer tokens than rank 1's
    tgt[1, 5:9] = -100
    tgt[6, 1:4] = -100
    return ids, tgt


def _jax_rows():
    """Row j of the JAX batch is row ``_jax_rows()[j]`` of the stream: JAX
    row m*B/M + r*b + i is the stream's r*B/R + m*b + i (b = B/(M*R))."""
    b = B // (MB * RDP)
    return np.array([r * (B // RDP) + m * b + i for m in range(MB) for r in range(RDP) for i in range(b)])


def _jax_module(family):
    if family == "lmhead":
        return jax_tr.DistributedTransformerLMHead(**LMHEAD)
    return JaxTransformerLM(**ZOO)


def _to_port(family, params):
    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return lm_head_params_from_jax(flat) if family == "lmhead" else params_from_jax(flat)


def _jax_run(family, loss_kind):
    """(init state dict, per-microbatch losses of each step, first step's
    grads, final params) of the JAX package's rdp = 2 step."""
    ids, tgt = (x[_jax_rows()] for x in _stream())
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": MB, "ddp": True, "_device_count_override": RDP})
        assert jax_smp.rdp_size() == RDP
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
            losses.append(np.asarray(out.stack(), np.float64).reshape(-1).tolist())
            optimizer.step()
        return init, losses, grads, _to_port(family, model.params)
    finally:
        jax_smp.reset()


def _port_module(family):
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    if family == "lmhead":
        return DistributedTransformerLMHead(**LMHEAD)
    return TransformerLM(**ZOO)


def _fingerprint(model):
    """Every parameter's bytes: equal fingerprints are bit-equal replicas."""
    return b"".join(p.detach().numpy().tobytes() for p in model.module.parameters())


def _expect_raise(fn):
    try:
        fn()
    except Exception as e:  # the test reads the class and the message
        return type(e).__name__, str(e)
    return None


def _train_worker(rank, world, runs, inits):
    """Each configuration's (per-microbatch losses, first grads, final
    params, a fingerprint after every step) on this rank, then the
    per-row outputs and the refusals."""
    import os

    import smdistributed_modelparallel_tpu_torch as smp

    rows = slice(rank * B // world, (rank + 1) * B // world)
    ids, tgt = (torch.from_numpy(x[rows]).long() for x in _stream())
    out = {}
    for (name, family, loss_kind), init in zip(runs, inits):
        smp.init({"microbatches": MB, "ddp": True}, device="cpu")
        module = _port_module(family)
        # Rank 1 starts from other weights: the build broadcasts rank 0's.
        module.load_state_dict(init if rank == 0 else {k: v * 0 + 1 for k, v in init.items()})
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

        losses, grads, prints = [], None, []
        for _ in range(STEPS):
            step_out = train_step(model, ids, tgt)
            if grads is None:
                grads = {k: g.numpy().copy() for k, g in model.grads.items()}
            losses.append(step_out.stack().double().reshape(-1).tolist())
            optimizer.step()
            prints.append(_fingerprint(model))
        out[name] = (losses, grads, {k: v.numpy().copy() for k, v in model.state_dict().items()}, prints)

    # Per-row outputs gather along the rows, in rank order.
    smp.init({"microbatches": MB, "ddp": True}, device="cpu")
    model = smp.DistributedModel(_port_module("zoo"))

    @smp.step
    def eval_step(model, ids_):
        return model(ids_)

    out["logits"] = eval_step(model, ids).stack().numpy()
    out["local_logits"] = torch.stack([model(x) for x in ids.chunk(MB)]).detach().numpy()
    out["rdp_group"] = (smp.rdp_rank(), smp.rdp_size(), smp.get_rdp_group())

    def step_with(cfg, module_kw=None, env=None):
        def run():
            from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

            smp.init({"ddp": True, "microbatches": 1, **cfg}, device="cpu")
            m = smp.DistributedModel(TransformerLM(**{**ZOO, **(module_kw or {})}))

            @smp.step
            def train_step(model, ids_):
                loss = model(ids_, targets=ids_).mean()
                model.backward(loss)
                return loss

            train_step(m, ids)

        old = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            return _expect_raise(run)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    out["fp16"] = step_with({"fp16": True})
    out["fp8"] = step_with({"matmul_precision": "fp8"})
    out["health"] = step_with({}, env={"SMP_HEALTH_CHECK": "cheap"})
    out["dropout"] = step_with({}, dict(dropout=0.1, deterministic=False))
    smp.reset()
    return out


@pytest.fixture(scope="module")
def port_and_jax():
    jax_runs = {name: _jax_run(*spec) for name, *spec in RUNS}
    per_rank = run_ranks(RDP, _train_worker, RUNS, [jax_runs[name][0] for name, *_ in RUNS])
    return jax_runs, per_rank


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_rdp2_training_matches_jax(port_and_jax, name):
    jax_runs, per_rank = port_and_jax
    _, want_losses, want_grads, want_params = jax_runs[name]
    losses, grads, params, _ = per_rank[0][name]
    np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
    assert np.mean(losses[-1]) < np.mean(losses[0])
    for k, want in want_grads.items():
        want = want.numpy()
        err = float(np.abs(grads[k] - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-6), (k, err)
    for k, want in want_params.items():
        np.testing.assert_allclose(params[k], want.numpy(), rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_rdp_replicas_stay_bit_equal(port_and_jax, name):
    """Both ranks report the same losses and gradients, and their
    parameters are bit-equal after every step (rank 1 was built from other
    weights: the build broadcast rank 0's)."""
    _, per_rank = port_and_jax
    (l0, g0, p0, f0), (l1, g1, p1, f1) = per_rank[0][name], per_rank[1][name]
    assert l0 == l1
    assert f0 == f1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_masked_counts_differ_across_ranks():
    """The masked runs weigh uneven counts: a grouping that disagreed with
    the JAX package's would move their losses and gradients."""
    ids, tgt = _stream()
    b = B // (MB * RDP)
    counts = [[int((tgt[r * B // RDP + m * b:r * B // RDP + (m + 1) * b] != -100).sum()) for r in range(RDP)]
              for m in range(MB)]
    assert all(len(set(c)) > 1 for c in counts), counts


def test_per_row_outputs_gather_in_rank_order(port_and_jax):
    _, per_rank = port_and_jax
    want = np.concatenate([r["local_logits"] for r in per_rank], axis=1)
    for r in per_rank:
        assert r["logits"].shape == (MB, B // MB, T, ZOO["vocab_size"])
        np.testing.assert_array_equal(r["logits"], want)
    assert [r["rdp_group"] for r in per_rank] == [(0, 2, [0, 1]), (1, 2, [0, 1])]


@pytest.mark.parametrize("case,match", [
    ("fp16", "fp16 (the loss scaler's overflow flag) under data parallelism"),
    ("fp8", "matmul_precision: fp8 (the amax) under data parallelism"),
    ("health", "SMP_HEALTH_CHECK (the sentinel's word) under data parallelism"),
    ("dropout", "inside a data-parallel step"),
])
def test_step_refusals_at_rdp2(port_and_jax, case, match):
    _, per_rank = port_and_jax
    for r in per_rank:
        got = r[case]
        assert got is not None and got[0] == "NotImplementedError" and match in got[1], got
        assert "ROADMAP Queue 1 item 6" in got[1], got
