"""The ``smp.nn`` LM head at pp = 2, the step function's usage errors and
what stays refused at pp > 1.

- ``head``: three SGD steps of the tiny ``DistributedTransformerLMHead``
  (4 layers, a tuple carry ``(hidden, cross_states, attention_mask)`` whose
  side inputs each stage takes from the embedding) at pp = 2 against the JAX
  package's pipelined step and the port's pp = 1 step, with the bounds and
  harness of ``tests/test_torch_pp_step.py``.
- Usage errors, on every rank of a two-stage world, none left blocked: a step
  function without a model call or with two, one that stops calling
  ``model.backward``, and an error raised on one stage only (stage 0's
  embedding), which reaches the other; the world trains on afterwards.
- Refusals: each raises ``NotImplementedError`` naming ROADMAP item 8
  (virtual stages, zero bubble, the recompute plans, fp16, the sentinel,
  dropout inside a stage, checkpointing inside the pipeline, the MoE,
  checkpoints, ``smp.generate``, the serving engine, the encoder-decoder, and
  pp beside tp); a module without ``pipeline_spec`` raises the JAX package's
  ``PartitionError``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_pp_step import as_tuple, case, check_against, ranks_of, run_all, xent

CASES = {"head": case({"pipeline_parallel_degree": 2}, head=True)}


def _expect_raise(fn):
    try:
        fn()
    except Exception as e:  # the test reads the class and the message
        return type(e).__name__, str(e)
    return None


def _usage(rank, world):
    """(class, message) of each usage error on this rank, and the losses of
    a good step after them."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

    class Boom(TransformerLM):
        fail = False

        def embed(self, ids, paged=None):
            if self.fail:
                raise RuntimeError("boom in the embedding")
            return super().embed(ids, paged=paged)

    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 32, (8, 12))).long()
    smp.init({"microbatches": 4, "pipeline_parallel_degree": 2, "ddp": True}, device="cpu")
    torch.manual_seed(0)
    model = smp.DistributedModel(Boom(vocab_size=32, max_len=12, d_model=16, n_layers=4, n_heads=2))
    out = {}

    @smp.step
    def no_call(model, b):
        return b.float().mean()

    @smp.step
    def two_calls(model, b):
        loss = xent(model(b), b) + xent(model(b), b)
        model.backward(loss)
        return loss

    phase = {"later": False}

    @smp.step
    def later(model, b):
        logits = model(b)
        loss = xent(logits, b)
        if phase["later"] == "backward":
            return loss  # model.backward no longer called
        if phase["later"] == "twice":
            loss = loss + xent(model(b), b)
        model.backward(loss)
        return loss

    out["no_call"] = _expect_raise(lambda: no_call(model, ids))
    out["two_calls"] = _expect_raise(lambda: two_calls(model, ids))
    later(model, ids)
    for what in ("backward", "twice"):
        phase["later"] = what
        out[f"later_{what}"] = _expect_raise(lambda: later(model, ids))
    phase["later"] = False
    model.module.fail = True
    out["one_stage"] = _expect_raise(lambda: later(model, ids))
    model.module.fail = False
    out["after"] = later(model, ids).stack().tolist()
    # The JAX package's layout (layers stacked [L, ...]): each stage keeps
    # its rows; smp.get_partition reads the assignment.
    from smdistributed_modelparallel_tpu_torch.convert import params_to_jax

    torch.manual_seed(1)
    whole = TransformerLM(vocab_size=32, max_len=12, d_model=16, n_layers=4, n_heads=2).state_dict()
    model.load_state_dict(params_to_jax(whole))
    mine = model.state_dict()
    out["jax_layout"] = sorted(mine) if all(torch.equal(v, whole[k]) for k, v in mine.items()) else None
    out["partition"] = [smp.get_partition(f"layers/block#{i}") for i in range(4)]
    smp.reset()
    return out


def _refusals(rank, world):
    """(class, message) of each refusal at pp = 2 (pp = 2 x tp = 2 on four
    ranks)."""
    import os

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.encoder_decoder import EncoderDecoderLM
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    ids = torch.zeros((8, 12), dtype=torch.long)
    base = {"microbatches": 4, "pipeline_parallel_degree": 2, "ddp": True}

    def lm(**kw):
        return TransformerLM(vocab_size=32, max_len=12, d_model=16, n_layers=4, n_heads=2, **kw)

    def build(cfg=None, module=None, env=None, then=None):
        def run():
            old = {k: os.environ.get(k) for k in env or {}}
            os.environ.update(env or {})
            try:
                smp.init({**base, **(cfg or {})}, device="cpu")
                model = smp.DistributedModel(module() if module is not None else lm())
                if then is not None:
                    then(model)
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        return _expect_raise(run)

    def train(model):
        @smp.step
        def train_step(model, b):
            loss = xent(model(b), b)
            model.backward(loss)
            return loss

        model.train()
        train_step(model, ids)

    if world == 4:
        return {"beside_tp": build({"tensor_parallel_degree": 2})}

    def engine(model):
        from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

        ServingEngine(model, max_slots=2, num_blocks=8, device="cpu")

    return {
        "vpp2": build({"virtual_pipeline_degree": 2}),
        "zero_bubble": build({"pipeline": "zero_bubble"}),
        "stash_all": build({"recompute": "stash_all"}),
        "fp16": build({"fp16": True}),
        "health": build(env={"SMP_HEALTH_CHECK": "cheap"}),
        "dropout": build(module=lambda: lm(dropout=0.1, deterministic=False), then=train),
        "checkpointing": build(module=lambda: DistributedTransformerLMHead(
            num_layers=2, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
            vocab_size=32, num_positions=16, activation_checkpointing=True)),
        "moe": build(module=lambda: DistributedTransformerLMHead(
            num_layers=2, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
            vocab_size=32, num_positions=16, num_experts=2)),
        "save": build(then=lambda m: smp.save_checkpoint("/nonexistent-pp-ckpt")),
        "resume": build(then=lambda m: smp.resume_from_checkpoint("/nonexistent-pp-ckpt")),
        "reference_state": build(then=lambda m: m.reference_state_dict()),
        "generate": build(then=lambda m: smp.generate(m, ids[:1, :4], 2)),
        "engine": build(then=engine),
        "encdec": build(module=lambda: EncoderDecoderLM(32, 16, 2, 2, 2, 32, 16)),
        "mlp": build(module=lambda: torch.nn.Sequential(torch.nn.Linear(4, 4))),
    }


def _extra(rank, world):
    if world == 4:
        return {"refusals": _refusals(rank, world)}
    return {"usage": _usage(rank, world), "refusals": _refusals(rank, world)}


@pytest.fixture(scope="module")
def runs():
    return run_all(CASES, extra=_extra, worlds=(4,))


def test_head_matches_jax(runs):
    want, per_rank, _ = runs
    check_against(ranks_of(per_rank, "head", CASES), want["head"], "head", CASES["head"])


def test_head_matches_pp1(runs):
    _, per_rank, base = runs
    check_against(ranks_of(per_rank, "head", CASES), as_tuple(base["head"]), "head", CASES["head"])


def test_head_gauges_and_bits(runs):
    want, per_rank, _ = runs
    ranks = per_rank[2]
    for r in ranks:
        assert r["head"]["gauges"] == want["head"][4] and want["head"][4]
        assert r["head"]["prints"] == ranks[0]["head"]["prints"]
    # The replicated parameters: the embeddings and the final norm.
    assert sorted(ranks[0]["head"]["replicated"]) == ["ln_f.bias", "ln_f.weight", "position_embedding.weight",
                                                     "word_embedding.weight"]


@pytest.mark.parametrize("what,match", [
    ("no_call", "exactly one model(...) call per step function (got 0)"),
    ("two_calls", "exactly one model(...) call per step function (got 2)"),
    ("later_backward", "model.backward(loss) was not called"),
    ("later_twice", "exactly one model(...) call per step function (got 2)"),
])
def test_usage_errors_raise_on_every_rank(runs, what, match):
    _, per_rank, _ = runs
    for r in per_rank[2]:
        got = r["extra"]["usage"][what]
        assert got is not None and got[0] == "StepUsageError" and match in got[1], got


def test_jax_layout_loads_by_stage(runs):
    """A state in the JAX package's layout (stacked layers) loads on each
    stage as its rows; ``smp.get_partition`` gives the assignment."""
    _, per_rank, _ = runs
    for stage, r in enumerate(per_rank[2]):
        layers = {int(k.split(".")[1]) for k in r["extra"]["usage"]["jax_layout"] if k.startswith("layers.")}
        assert layers == {2 * stage, 2 * stage + 1}
        assert "wte.weight" in r["extra"]["usage"]["jax_layout"] and "ln_f.weight" in r["extra"]["usage"]["jax_layout"]
        assert r["extra"]["usage"]["partition"] == [0, 0, 1, 1]


def test_error_on_one_stage_reaches_the_other(runs):
    _, per_rank, _ = runs
    first, second = (r["extra"]["usage"] for r in per_rank[2])
    assert first["one_stage"] == ("RuntimeError", "boom in the embedding")
    assert second["one_stage"] == ("RuntimeError", "pipeline stage 0: boom in the embedding")
    # The world trains on after the failed steps, the two stages agreeing.
    assert first["after"] == second["after"] and np.isfinite(first["after"]).all()


@pytest.mark.parametrize("what", ["vpp2", "zero_bubble", "stash_all", "fp16", "health", "dropout", "checkpointing",
                                  "moe", "save", "resume", "reference_state", "generate", "engine", "encdec",
                                  "beside_tp"])
def test_refusals_name_roadmap_item_8(runs, what):
    _, per_rank, _ = runs
    world = 4 if what == "beside_tp" else 2
    for r in per_rank[world]:
        got = r["extra"]["refusals"][what]
        assert got is not None and got[0] == "NotImplementedError" and "ROADMAP item 8" in got[1], got


def test_unpipelineable_module_raises_partition_error(runs):
    _, per_rank, _ = runs
    for r in per_rank[2]:
        got = r["extra"]["refusals"]["mlp"]
        assert got is not None and got[0] == "PartitionError" and "requires a pipelineable model" in got[1], got
