"""The port's tensor-parallel training step against the JAX package's.

Three SGD steps of the ``smp.nn`` ``DistributedTransformerLMHead`` (fp32,
tiny widths) in CPU processes over gloo, against the JAX package's step in
one process on a CPU mesh of the same degrees, from the same converted
weights (the port loads the whole tensors; each rank keeps its part):
  - ``speed``: tp = 2, Megatron's layout (heads and the MLP width over tp),
    the loss from whole logits (logits mode);
  - ``memory``: tp = 2 under ``optimize: "memory"``, the residual stream
    sharded along T between the layers, the loss from the head's loss mode;
  - ``memory_t15``: the same at T = 15, which tp does not divide, so the
    stack takes the speed layout (the JAX package's ``shard_activation``
    drops the axis);
  - ``tp2_rdp2``: tp 2 x rdp 2 on four ranks, each tp pair handed its rdp
    coordinate's rows (the per-process contract; the JAX batch laid out
    microbatch-major, as in ``tests/test_torch_dp_step.py``).
Losses, first-step gradients (gathered whole over tp) and the parameters
after the steps agree within 1e-5; the losses, gradients and parameters
also agree with the port's own tp = 1 step within 1e-5, as
``tests/test_transformer.py``'s tp-parity test holds the JAX package. Replicated parameters stay bit-equal
across the tp ranks after every step. Every part of the step left at tp > 1
raises naming ROADMAP item 7.
"""

import numpy as np
import pytest
import torch

from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax

# The JAX side is imported where it runs: the spawned ranks import this
# module, and need torch alone.

HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
STEPS, LR, MB, B, T = 3, 0.1, 2, 8, 16
# (name, config, ranks, sequence length, loss from whole logits)
RUNS = [
    ("speed", {"tensor_parallel_degree": 2}, 2, T, True),
    ("memory", {"tensor_parallel_degree": 2, "optimize": "memory"}, 2, T, False),
    ("memory_t15", {"tensor_parallel_degree": 2, "optimize": "memory"}, 2, 15, False),
    ("tp2_rdp2", {"tensor_parallel_degree": 2}, 4, T, False),
]


def _stream(t=T):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, (B, t)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1).astype(np.int32)
    tgt[0, 2:9] = -100
    return ids, tgt


def _jax_rows(rdp):
    """Row j of the JAX batch is row ``_jax_rows(rdp)[j]`` of the stream
    (microbatch-major, ``tests/test_torch_dp_step.py``)."""
    b = B // (MB * rdp)
    return np.array([r * (B // rdp) + m * b + i for m in range(MB) for r in range(rdp) for i in range(b)])


def _to_port(params):
    import jax

    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return {k: v.numpy().copy() for k, v in lm_head_params_from_jax(flat).items()}


def _jax_run(cfg, ranks, t, logits_mode):
    """(init state dict, per-microbatch losses of each step, first step's
    grads, final params) of the JAX package's step."""
    import jax.numpy as jnp
    import optax

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr

    rdp = ranks // cfg.get("tensor_parallel_degree", 1)
    ids, tgt = (x[_jax_rows(rdp)] for x in _stream(t))
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": MB, "ddp": True, "_device_count_override": ranks, **cfg})
        model = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**HEAD))
        optimizer = jax_smp.DistributedOptimizer(optax.sgd(LR), model)

        @jax_smp.step
        def train_step(model, ids_, tgt_):
            if logits_mode:
                from smdistributed_modelparallel_tpu.nn.cross_entropy import masked_vocab_parallel_cross_entropy

                per = masked_vocab_parallel_cross_entropy(model(ids_), tgt_)
            else:
                per = model(ids_, targets=tgt_)
            loss = jnp.sum(per) / jnp.sum(tgt_ != -100)
            model.backward(loss)
            return loss

        losses, init, grads = [], None, None
        for _ in range(STEPS):
            out = train_step(model, jnp.asarray(ids), jnp.asarray(tgt))
            if init is None:
                init = _to_port(model.params)
                grads = _to_port(model.grads)
            losses.append(np.asarray(out.stack(), np.float64).reshape(-1).tolist())
            optimizer.step()
        return init, losses, grads, _to_port(model.params)
    finally:
        jax_smp.reset()


def _expect_raise(fn):
    try:
        fn()
    except Exception as e:  # the test reads the class and the message
        return type(e).__name__, str(e)
    return None


def _worker(rank, world, runs, inits):
    """Each configuration's (per-microbatch losses, whole first grads, whole
    final params, replicated-parameter bytes after every step, whether the
    stack ran sequence-parallel) on this rank, then the refusals (none
    with ``world`` 1, the tp = 1 yardstick)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import masked_vocab_parallel_cross_entropy
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    torch.set_num_threads(1)
    out = {}
    for (name, cfg, ranks, t, logits_mode), init in zip(runs, inits):
        if ranks != world:
            continue
        smp.init({"microbatches": MB, "ddp": True, **cfg}, device="cpu")
        rdp = world // cfg.get("tensor_parallel_degree", 1)
        r = smp.rdp_rank()
        ids, tgt = (torch.from_numpy(x[r * B // rdp:(r + 1) * B // rdp]).long() for x in _stream(t))
        model = smp.DistributedModel(DistributedTransformerLMHead(**HEAD))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
        optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR), model)

        @smp.step
        def train_step(model, ids_, tgt_):
            if logits_mode:
                per = masked_vocab_parallel_cross_entropy(model(ids_), tgt_)
            else:
                per = model(ids_, targets=tgt_)
            count = (tgt_ != -100).sum()
            loss = per.sum() / count
            model.backward(loss, num_tokens=count)
            return loss

        losses, grads, prints = [], None, []
        replicated = [n for n, _ in model.named_parameters() if n not in model._tp_specs]
        for _ in range(STEPS):
            step_out = train_step(model, ids, tgt)
            if grads is None:
                grads = {k: g.numpy().copy() for k, g in model._gather_tp(model.grads).items()}
            losses.append(step_out.stack().double().reshape(-1).tolist())
            optimizer.step()
            params = dict(model.named_parameters())
            prints.append(b"".join(params[n].detach().numpy().tobytes() for n in replicated))
        final = {k: v.numpy().copy() for k, v in model._gather_tp(model.module.state_dict()).items()}
        out[name] = dict(losses=losses, grads=grads, params=final, prints=prints,
                         sequence_parallel=model._seq_parallel_ran, sharded=sorted(model._tp_specs))
    if world > 1:
        out["refusals"] = _refusals(smp, world)
    smp.reset()
    return out


def _refusals(smp, world):
    """What stays refused at tp = 2, each as (class, message) or None."""
    import os

    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    ids = torch.zeros((2, 8), dtype=torch.long)

    def step_with(cfg, head=None, env=None, model_fn=None):
        def run():
            smp.init({"ddp": True, "microbatches": 1, "tensor_parallel_degree": 2, **cfg}, device="cpu")
            m = model_fn() if model_fn is not None else smp.DistributedModel(
                DistributedTransformerLMHead(**{**HEAD, **(head or {})}))

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

    if world == 4:
        return {"cp": step_with({"context_parallel_degree": 2}),
                "ep": step_with({"expert_parallel_degree": 2})}

    def encdec():
        from smdistributed_modelparallel_tpu_torch.models.encoder_decoder import EncoderDecoderLM

        smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
        m = smp.DistributedModel(EncoderDecoderLM(64, 32, 1, 1, 4, 64, 16))
        m(ids, ids)

    def from_hf():
        from types import SimpleNamespace

        smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
        smp.from_hf(SimpleNamespace(architectures=["GPT2LMHeadModel"], model_type="gpt2", n_embd=32, n_head=4,
                                    n_layer=1, vocab_size=64, n_positions=16), device="cpu")

    def tp_mark():
        smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
        with smp.tensor_parallelism():
            lin = torch.nn.Linear(32, 32)
        smp.DistributedModel(torch.nn.Sequential(lin))

    def int8_generate():
        smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
        m = smp.DistributedModel(DistributedTransformerLMHead(**HEAD))
        old = os.environ.get("SMP_DECODE_WEIGHTS")
        os.environ["SMP_DECODE_WEIGHTS"] = "int8"
        try:
            smp.generate(m, ids[:1, :4], 2)
        finally:
            if old is None:
                os.environ.pop("SMP_DECODE_WEIGHTS", None)
            else:
                os.environ["SMP_DECODE_WEIGHTS"] = old

    return {
        "ring": step_with({"tp_overlap": "ring"}),
        "fp16": step_with({"fp16": True}),
        "fp8": step_with({"matmul_precision": "fp8"}),
        "health": step_with({}, env={"SMP_HEALTH_CHECK": "cheap"}),
        "dropout": step_with({}, head=dict(hidden_dropout_prob=0.1, deterministic=False)),
        "checkpointing": step_with({}, head=dict(activation_checkpointing=True)),
        "moe": step_with({}, head=dict(num_experts=4)),
        "encdec": _expect_raise(encdec),
        "from_hf": _expect_raise(from_hf),
        "tp_mark": _expect_raise(tp_mark),
        "int8_generate": _expect_raise(int8_generate),
        "heads": _expect_raise(lambda: DistributedTransformerLMHead(**dict(HEAD, num_attention_heads=3))),
        "mlp": _expect_raise(lambda: DistributedTransformerLMHead(**dict(HEAD, intermediate_size=63))),
    }


@pytest.fixture(scope="module")
def runs():
    want = {name: _jax_run(cfg, ranks, t, lm) for name, cfg, ranks, t, lm in RUNS}
    inits = [want[name][0] for name, *_ in RUNS]
    per_rank = {world: run_ranks(world, _worker, RUNS, inits) for world in (2, 4)}
    # The yardstick: the port at tp = 1 in this process, from the speed run's
    # weights, on the speed run's loss.
    threads = torch.get_num_threads()
    try:
        per_rank[1] = [_worker(0, 1, [("tp1", {}, 1, T, False)], [want["speed"][0]])]
    finally:
        torch.set_num_threads(threads)
    return want, per_rank


def _ranks_of(per_rank, name):
    world = next(ranks for n, _, ranks, *_ in RUNS if n == name)
    return per_rank[world]


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_tp_step_matches_jax(runs, name):
    want, per_rank = runs
    _, want_losses, want_grads, want_params = want[name]
    for got in _ranks_of(per_rank, name):
        got = got[name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-6)
        assert np.mean(got["losses"][-1]) < np.mean(got["losses"][0])
        assert set(got["grads"]) == set(want_grads)
        for k, g in want_grads.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=1e-5, err_msg=k)
        for k, p in want_params.items():
            np.testing.assert_allclose(got["params"][k], p, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["speed", "memory"])
def test_tp_step_matches_tp1(runs, name):
    """tp = 2 trains what tp = 1 trains (the JAX package's tp-parity test),
    from the same weights."""
    _, per_rank = runs
    got, want = per_rank[2][0][name], per_rank[1][0]["tp1"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    for key in ("grads", "params"):
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k], v, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_replicated_parameters_stay_bit_equal(runs, name):
    _, per_rank = runs
    ranks = _ranks_of(per_rank, name)
    for r in ranks[1:]:
        assert r[name]["prints"] == ranks[0][name]["prints"]
        assert r[name]["losses"] == ranks[0][name]["losses"]
    assert ranks[0][name]["sharded"] == sorted(
        f"transformer.seq_layers.{i}.{m}" for i in range(2)
        for m in ("attention.qkv.weight", "attention.qkv.bias", "attention.dense.weight", "output.fc.weight",
                  "output.fc.bias", "output.proj.weight"))


def test_memory_layout_runs_sequence_parallel(runs):
    _, per_rank = runs
    flags = {name: per_rank[2][0][name]["sequence_parallel"] for name in ("speed", "memory", "memory_t15")}
    assert flags == {"speed": False, "memory": True, "memory_t15": False}


@pytest.mark.parametrize("case,what", [("heads", "num_attention_heads (3)"), ("mlp", "intermediate_size (63)")])
def test_indivisible_widths_raise(runs, case, what):
    """The heads and the MLP width must divide over tp (the vocabulary need
    not: ``tests/test_torch_tp_layers.py``'s V = 63)."""
    _, per_rank = runs
    for r in per_rank[2]:
        got = r["refusals"][case]
        assert got is not None and got[0] == "SMPValidationError", got
        assert what in got[1] and "tensor_parallel_degree (2)" in got[1], got


@pytest.mark.parametrize("case", ["ring", "fp16", "fp8", "health", "dropout", "checkpointing", "moe", "encdec",
                                  "from_hf", "tp_mark", "int8_generate", "cp", "ep"])
def test_refusals_at_tp2(runs, case):
    _, per_rank = runs
    world = 4 if case in ("cp", "ep") else 2
    for r in per_rank[world]:
        got = r["refusals"][case]
        assert got is not None and got[0] == "NotImplementedError", got
        assert "ROADMAP item 7" in got[1] and "tensor_parallel_degree > 1" in got[1], got
