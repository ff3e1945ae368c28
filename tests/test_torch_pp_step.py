"""The port's pipeline-parallel training step against the JAX package's.

Three SGD steps of ``tests/test_pipeline.py``'s tiny zoo ``TransformerLM``
(vocab 32, T 12, d 16, 2 heads, 4 layers, batch 8 in 4 microbatches, fp32)
in gloo worlds of CPU processes, one process a stage, against the JAX
package's pipelined step at the same pp in one process (a CPU mesh of
``_device_count_override`` devices), from the same converted weights (each
port rank loads the whole state and keeps its stage's rows):
  - ``pp2``: the default schedule (``pipeline: "interleaved"`` at v = 1,
    plain 1F1B, window ``active_microbatches`` = pp + 2 = 4);
  - ``pp4``: four stages, two middle ones that both receive and send;
  - ``simple``: ``pipeline: "simple"``, the fill-drain executor;
  - ``forward_only``: a step function without ``model.backward`` (the
    fill-drain executor, no gradients), its logits compared.
Losses agree within 1e-5, first-step gradients (gathered over the stages)
within 1e-5 of each leaf's largest value, and the parameters after the steps
within 1e-5; the same holds against the port's own pp = 1 step. The
replicated parameters (the embeddings, the final norm) are bit-equal across
the stages after every step, and the bubble gauges equal the JAX package's.
``tests/test_torch_pp_options.py`` holds the windows, uneven stages and
clipping; ``tests/test_torch_pp_nn.py`` the ``smp.nn`` LM head, the usage
errors and the refusals. The harness here is shared with both.
"""

import numpy as np
import pytest
import torch

from chip_smoke import run_ranks

# The JAX side is imported where it runs: the spawned ranks import this
# module, and need torch alone.

STEPS, LR, MB, B, T, V = 3, 0.1, 4, 8, 12, 32
HEAD = dict(
    num_layers=4, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
    vocab_size=V, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)


def case(cfg, world=2, layers=4, forward_only=False, clip=None, head=False):
    return dict(cfg=cfg, world=world, layers=layers, forward_only=forward_only, clip=clip, head=head)


CASES = {
    "pp2": case({"pipeline_parallel_degree": 2}),
    "pp4": case({"pipeline_parallel_degree": 4}, world=4),
    "simple": case({"pipeline_parallel_degree": 2, "pipeline": "simple"}),
    "forward_only": case({"pipeline_parallel_degree": 2}, forward_only=True),
}


def _ids():
    return np.random.default_rng(7).integers(0, V, (B, T)).astype(np.int32)


def _to_port(params, head):
    import jax

    from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax, params_from_jax

    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    convert = lm_head_params_from_jax if head else params_from_jax
    return {k: v.numpy().copy() for k, v in convert(flat).items()}


def _gauges(report, schedule):
    """{(name, state label): value} of the pipeline gauges of ``schedule``."""
    out = {}
    for name, metric in report["metrics"].items():
        if name.startswith("smp_pipeline_"):
            for series in metric["series"]:
                labels = series["labels"]
                if labels.get("schedule") == schedule:
                    out[(name, labels.get("state", ""))] = series["value"]
    return out


def schedule_of(c):
    return "1f1b" if not c["forward_only"] and c["cfg"].get("pipeline") != "simple" else "fill_drain"


def jax_run(c):
    """(init state dict, per-microbatch losses of each step, first step's
    grads, final params, pipeline gauges) of the JAX package's step; a
    forward-only case gives its logits in place of the losses."""
    import jax.numpy as jnp
    import optax

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
    from smdistributed_modelparallel_tpu.utils.telemetry import telemetry
    from tests.models import softmax_xent

    cfg = c["cfg"]
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": MB, "ddp": True, "_device_count_override": cfg["pipeline_parallel_degree"],
                      **cfg})
        if c["head"]:
            module = jax_tr.DistributedTransformerLMHead(**dict(HEAD, num_layers=c["layers"]))
        else:
            module = TransformerLM(vocab_size=V, max_len=T, d_model=16, n_layers=c["layers"], n_heads=2)
        model = jax_smp.DistributedModel(module)
        optimizer = jax_smp.DistributedOptimizer(optax.sgd(LR), model, grad_clip_norm=c["clip"])
        ids = jnp.asarray(_ids())

        if c["forward_only"]:
            @jax_smp.step
            def eval_step(model, batch):
                return model(batch)

            out = eval_step(model, ids)
            return (_to_port(model.params, c["head"]), np.asarray(out.stack()), None, None,
                    _gauges(telemetry.report(), "fill_drain"))

        @jax_smp.step
        def train_step(model, batch):
            logits = model(batch)
            loss = jnp.mean(softmax_xent(logits[:, :-1], batch[:, 1:]))
            model.backward(loss)
            return loss

        losses, init, grads = [], None, None
        for _ in range(STEPS):
            out = train_step(model, ids)
            if init is None:
                # The parameters change at optimizer.step() only: these are
                # the weights the JAX package drew lazily in the first step.
                init = _to_port(model.params, c["head"])
                grads = _to_port(model.grads, c["head"])
            losses.append(np.asarray(out.stack(), np.float64).tolist())
            optimizer.step()
        return init, losses, grads, _to_port(model.params, c["head"]), _gauges(telemetry.report(), schedule_of(c))
    finally:
        jax_smp.reset()
        jax_smp.init({})


def jax_runs(cases):
    return {name: jax_run(c) for name, c in cases.items()}


def xent(logits, ids):
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, ids[:, 1:, None]).squeeze(-1).mean()


def port_case(name, c, init, pp=None):
    """This rank's run of case ``c`` (at ``pp`` stages when given, else the
    case's): per-microbatch losses, first-step gradients and final
    parameters of the stage's part, the replicated parameters' bytes after
    every step, the pipeline gauges and the host's transfer count."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    cfg = dict(c["cfg"])
    if pp is not None:
        cfg["pipeline_parallel_degree"] = pp
    smp.init({"microbatches": MB, "ddp": True, **cfg}, device="cpu")
    if c["head"]:
        module = DistributedTransformerLMHead(**dict(HEAD, num_layers=c["layers"]))
    else:
        module = TransformerLM(vocab_size=V, max_len=T, d_model=16, n_layers=c["layers"], n_heads=2)
    model = smp.DistributedModel(module)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR), model,
                                         grad_clip_norm=c["clip"])
    ids = torch.from_numpy(_ids()).long()
    replicated = [n for n, _ in model.named_parameters() if n not in model._pp_layer_params]
    out = {"replicated": replicated, "layers": sorted(model._pp_layer_params)}
    if c["forward_only"]:
        @smp.step
        def eval_step(model, batch):
            return model(batch)

        out["logits"] = eval_step(model, ids).stack().numpy()
        out["params"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        out["gauges"] = _gauges(telemetry.report(), "fill_drain")
        return out

    @smp.step
    def train_step(model, batch):
        loss = xent(model(batch), batch)
        model.backward(loss)
        return loss

    losses, grads, prints = [], None, []
    for _ in range(STEPS):
        step_out = train_step(model, ids)
        if grads is None:
            grads = {k: g.numpy().copy() for k, g in model.grads.items()}
        losses.append(step_out.stack().double().tolist())
        optimizer.step()
        params = dict(model.named_parameters())
        prints.append(b"".join(params[n].detach().numpy().tobytes() for n in replicated))
    out.update(losses=losses, grads=grads, prints=prints,
               params={k: v.numpy().copy() for k, v in model.state_dict().items()},
               gauges=_gauges(telemetry.report(), schedule_of(c)) if smp.pp_size() > 1 else {},
               transfers=getattr(model, "_pp_transfers", 0))
    return out


def worker(rank, world, cases, inits, extra=None):
    """Every case of ``world`` ranks, then ``extra(rank, world)``."""
    import smdistributed_modelparallel_tpu_torch as smp

    torch.set_num_threads(1)
    out = {}
    for name, c in cases.items():
        if c["world"] == world:
            out[name] = port_case(name, c, inits[name])
    if extra is not None:
        out["extra"] = extra(rank, world)
    smp.reset()
    return out


def yardstick(cases, inits):
    """The port at pp = 1 in this process, case by case."""
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        return {name: port_case(name, dict(c, cfg={k: v for k, v in c["cfg"].items()
                                                   if k not in ("pipeline_parallel_degree", "pipeline")}),
                                inits[name], pp=1)
                for name, c in cases.items()}
    finally:
        import smdistributed_modelparallel_tpu_torch as smp

        smp.reset()
        torch.set_num_threads(threads)


def run_all(cases, extra=None, worlds=()):
    """The JAX runs, the port's worlds (every case's, and ``worlds``) and
    the port's pp = 1 runs."""
    want = jax_runs(cases)
    inits = {name: w[0] for name, w in want.items()}
    per_rank = {world: run_ranks(world, worker, cases, inits, extra, timeout=300)
                for world in sorted({c["world"] for c in cases.values()} | set(worlds))}
    return want, per_rank, yardstick(cases, inits)


def merged(ranks, key):
    """The stages' dicts under ``key`` as one; a replicated entry must be
    bit-equal on every stage."""
    out = {}
    for r in ranks:
        for k, v in r[key].items():
            if k in out:
                np.testing.assert_array_equal(out[k], v, err_msg=k)
            out[k] = v
    return out


def check_against(got_ranks, want, name, c):
    """Losses, gradients and parameters of a port run (its ranks) against
    ``want`` (a JAX run or the pp = 1 yardstick, as its tuple)."""
    _, w_losses, w_grads, w_params, _ = want
    if c["forward_only"]:
        np.testing.assert_allclose(got_ranks[-1][name]["logits"], w_losses, rtol=0,
                                   atol=1e-5 * np.abs(w_losses).max())
        for r in got_ranks[:-1]:
            assert np.array_equal(r[name]["logits"], got_ranks[-1][name]["logits"])
        return
    for r in got_ranks:
        np.testing.assert_allclose(r[name]["losses"], w_losses, rtol=1e-5, atol=1e-6)
    assert np.mean(got_ranks[0][name]["losses"][-1]) < np.mean(got_ranks[0][name]["losses"][0])
    grads = merged([r[name] for r in got_ranks], "grads")
    assert set(grads) == set(w_grads)
    for k, g in w_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-5 * max(np.abs(g).max(), 1e-30), err_msg=k)
    params = merged([r[name] for r in got_ranks], "params")
    assert set(params) == set(w_params)
    for k, p in w_params.items():
        np.testing.assert_allclose(params[k], p, rtol=0, atol=1e-5, err_msg=k)


def as_tuple(run):
    """A port pp = 1 run as the JAX runs' tuple."""
    if "logits" in run:
        return None, run["logits"], None, run["params"], None
    return None, run["losses"], run["grads"], run["params"], None


@pytest.fixture(scope="module")
def runs():
    return run_all(CASES)


def ranks_of(per_rank, name, cases=CASES):
    return per_rank[cases[name]["world"]]


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_jax(runs, name):
    want, per_rank, _ = runs
    check_against(ranks_of(per_rank, name), want[name], name, CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_pp1(runs, name):
    _, per_rank, base = runs
    check_against(ranks_of(per_rank, name), as_tuple(base[name]), name, CASES[name])


@pytest.mark.parametrize("name", ["pp2", "pp4", "simple"])
def test_replicated_parameters_stay_bit_equal(runs, name):
    _, per_rank, _ = runs
    ranks = ranks_of(per_rank, name)
    for r in ranks[1:]:
        assert r[name]["prints"] == ranks[0][name]["prints"]
        assert r[name]["replicated"] == ranks[0][name]["replicated"]
    # Each stage holds its layers only: together, every layer once.
    layers = [n for r in ranks for n in r[name]["layers"]]
    assert len(layers) == len(set(layers)) and {n.split(".")[1] for n in layers} == {"0", "1", "2", "3"}


@pytest.mark.parametrize("name", list(CASES))
def test_bubble_gauges_match_jax(runs, name):
    want, per_rank, _ = runs
    for r in ranks_of(per_rank, name):
        assert r[name]["gauges"] == want[name][4] and want[name][4]
