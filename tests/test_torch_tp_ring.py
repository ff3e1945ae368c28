"""The port's overlapped tensor parallelism (``tp_overlap: "ring"``) against
the JAX package's.

Two parts, in CPU processes over gloo (``chip_smoke.run_ranks``), each world
spawned once for the module:

- the rings alone (``ops/collective_matmul.py``): ``ring_ag_matmul`` and
  ``ring_rs_matmul`` at tp 2 and 4, replicated input and the rank's T block,
  forward and gradients within 1e-5 of the same products on whole tensors;
- three SGD steps of the ``smp.nn`` ``DistributedTransformerLMHead`` (fp32,
  tiny widths, ``fused_qkv`` and ``fused_bias_gelu``) under the ring:
  ``ring_speed`` (tp = 2), ``ring_memory`` (``optimize: "memory"``),
  ``ring_tp2_rdp2`` (four ranks; and with activation checkpointing,
  ``ring_ckpt_tp2_rdp2``) and ``ring_t15`` (T = 15, which tp does not
  divide: the non-ring path, with the warning; held against the port's tp =
  1 step alone). The port's fused QKV and
  bias-GELU take their card branch through the ``_is_cuda`` seams (the
  kernels' plain versions run on the CPU), so every QKV ring chunk goes
  through ``matmul_bias``; the JAX package's Pallas kernels run in
  interpret mode (``FORCE_INTERPRET``). Losses, first-step gradients
  (gathered whole) and the parameters after the steps agree within 1e-5
  with: the JAX package's ring step; its tp = 2 step without the ring; the
  port's tp = 1 step. Replicated parameters stay bit-equal across the tp
  ranks, and the ring's hops and chunk launches are counted.

In this image the JAX package's own ring does not build:
``utils/jax_compat.ensure_optimization_barrier_rules`` tests
``optimization_barrier_p in batching.primitive_batchers``, which on jax 0.9
is a ``PrimitiveBatchersProxy`` that cannot be iterated, so it raises
``TypeError`` (``tests/test_tp_overlap.py`` fails four tests on it). jax 0.9
ships the batching rule, so the JAX side here runs its ring with that
function patched to return True, in both ``utils.jax_compat`` and
``ops.collective_matmul`` (which imports the name); no file of the JAX
package changes. ``tests/test_torch_tp_options.py`` runs the other training
options at tp = 2 on this file's harness.
"""

import contextlib
import os

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
STEPS, LR, MB, B, T, SEED = 3, 0.1, 2, 8, 16, 7
RING = {"tensor_parallel_degree": 2, "tp_overlap": "ring", "fused_qkv": True}
FUSED = {"fused_bias_gelu": True}
# (name, config, ranks, sequence length, head overrides, options); options:
# "fused" the _is_cuda seams, "flash" attention's kernel gate (the flash
# kernels' plain versions), "scale" an fp16 loss scaler's initial scale,
# "poison" (step, parameter, {rank: flat index}) an inf in a gradient from
# that step on, "health" the sentinel's words, "quant" the fp8 state, "env"
# variables set around the run.
RUNS = [
    ("ring_speed", RING, 2, T, FUSED, {"fused": True}),
    ("ring_memory", {**RING, "optimize": "memory"}, 2, T, FUSED, {"fused": True}),
    ("ring_tp2_rdp2", RING, 4, T, FUSED, {"fused": True}),
    ("ring_t15", RING, 2, 15, FUSED, {"fused": True}),
    # Checkpointing changes no value: held against ring_tp2_rdp2's JAX run.
    ("ring_ckpt_tp2_rdp2", RING, 4, T, {**FUSED, "activation_checkpointing": True}, {"fused": True}),
]
JAX_OF = {"ring_ckpt_tp2_rdp2": "ring_tp2_rdp2"}  # runs held against another run's JAX numbers
TOL = dict(loss=dict(rtol=1e-5, atol=1e-6), grad=1e-5, param=1e-5)


def _stream(t=T):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, HEAD["vocab_size"], (B, t)).astype(np.int32)
    tgt = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1).astype(np.int32)
    tgt[0, 2:9] = -100
    return ids, tgt


def _jax_rows(rdp):
    """Row j of the JAX batch is row ``_jax_rows(rdp)[j]`` of the stream
    (microbatch-major, ``tests/test_torch_dp_step.py``)."""
    b = B // (MB * rdp)
    return np.array([r * (B // rdp) + m * b + i for m in range(MB) for r in range(rdp) for i in range(b)])


@contextlib.contextmanager
def _environ(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dispatch_counts(report):
    """``{(metric, labels): count}`` of the fused-kernel and fp8 dispatch
    counters in a telemetry report (the JAX package's or the port's)."""
    out = {}
    for name in ("smp_fused_kernel_dispatch_total", "smp_quant_dispatch_total"):
        for series in report["metrics"].get(name, {}).get("series", []):
            out[(name, tuple(sorted(series["labels"].items())))] = series["value"]
    return out


# -- the JAX side ---------------------------------------------------------


@contextlib.contextmanager
def jax_ring_patched(fused):
    """The JAX ring with ``ensure_optimization_barrier_rules`` patched (see
    the module docstring) and, under ``fused``, the Pallas kernels in
    interpret mode."""
    from smdistributed_modelparallel_tpu.ops import collective_matmul, pallas_gelu, pallas_qkv
    from smdistributed_modelparallel_tpu.utils import jax_compat

    saved = [(m, n, getattr(m, n)) for m, n in ((jax_compat, "ensure_optimization_barrier_rules"),
                                                (collective_matmul, "ensure_optimization_barrier_rules"),
                                                (pallas_qkv, "FORCE_INTERPRET"), (pallas_gelu, "FORCE_INTERPRET"))]
    jax_compat.ensure_optimization_barrier_rules = collective_matmul.ensure_optimization_barrier_rules = \
        lambda: True
    pallas_qkv.FORCE_INTERPRET = pallas_gelu.FORCE_INTERPRET = bool(fused)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _to_port(params):
    import jax

    flat = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return {k: v.numpy().copy() for k, v in lm_head_params_from_jax(flat).items()}


def _jax_head(head):
    """The JAX module; with embedding dropout a subclass whose ``embed`` is
    compact (``tests/test_torch_dropout_step.py``: the JAX package's inline
    Dropout in ``embed`` raises otherwise)."""
    import flax.linen as nn

    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr

    base = jax_tr.DistributedTransformerLMHead
    if head.get("embedding_dropout_prob", 0.0) <= 0.0:
        return base(**{**HEAD, **head})

    class JaxLMHead(base):
        @nn.compact
        def embed(self, *args, **kwargs):
            return base.embed.__wrapped__(self, *args, **kwargs)

    return JaxLMHead(**{**HEAD, **head})


def jax_run(cfg, ranks, t, head, opts):
    """The JAX package's run: (init state dict, per-microbatch losses of each
    step, first step's grads, final params, extras)."""
    import jax.numpy as jnp
    import optax

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.backend.state import state as jax_state
    from smdistributed_modelparallel_tpu.fp16.loss_scaler import DynamicLossScaler
    from smdistributed_modelparallel_tpu.utils import health as jax_health

    rdp = ranks // cfg.get("tensor_parallel_degree", 1)
    ids, tgt = (x[_jax_rows(rdp)] for x in _stream(t))
    ring = cfg.get("tp_overlap") == "ring"
    with (jax_ring_patched(opts.get("fused")) if ring else contextlib.nullcontext()), _environ(opts.get("env", {})):
        try:
            jax_smp.reset()
            jax_smp.init({"microbatches": MB, "ddp": True, "_device_count_override": ranks,
                          "tensor_parallel_seed": SEED, **cfg})
            if opts.get("scale"):
                jax_state.loss_scaler = DynamicLossScaler(init_scale=opts["scale"])
            model = jax_smp.DistributedModel(_jax_head(head))
            optimizer = jax_smp.DistributedOptimizer(optax.sgd(LR), model)

            @jax_smp.step
            def train_step(model, ids_, tgt_):
                loss = jnp.sum(model(ids_, targets=tgt_)) / jnp.sum(tgt_ != -100)
                model.backward(loss)
                return loss

            losses, init, grads, extra = [], None, None, {"scale": [], "health": [], "quant": []}
            jax_smp.telemetry.reset()
            for _ in range(STEPS):
                out = train_step(model, jnp.asarray(ids), jnp.asarray(tgt))
                if init is None:
                    init = _to_port(model.params)
                    grads = _to_port(model.grads)
                losses.append(np.asarray(out.stack(), np.float64).reshape(-1).tolist())
                if opts.get("health"):
                    jax_health.monitor.flush()
                    extra["health"].append(jax_health.monitor.last_check["tags"])
                optimizer.step()
                if opts.get("scale"):
                    extra["scale"].append(jax_state.loss_scaler.state_dict())
                if opts.get("quant"):
                    extra["quant"].append(jax_state.quant_state.state_dict())
            extra["dispatch"] = dispatch_counts(jax_smp.telemetry.report())
            return init, losses, grads, _to_port(model.params), extra
        finally:
            # Leave a default session (tp 1): one left at tp = 2 would box the
            # parameters of the next file's JAX modules in this worker with
            # partition names (the layers read the config's tp degree).
            jax_smp.reset()
            jax_smp.init({})


# -- the port's ranks -----------------------------------------------------


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _patch_seams(stack):
    """The fused QKV and bias-GELU take their card branch on CPU tensors (the
    kernels' plain versions run)."""
    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

    for mod in (mb, bg):
        stack.enter_context(_patched(mod, "_is_cuda", lambda t: True))


def _counting(stack):
    """Count the ring's hops (``ppermute_start`` calls) and its chunk
    products through ``matmul_bias``."""
    from smdistributed_modelparallel_tpu_torch.backend import collectives
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

    counts = {"hops": 0, "chunks": 0}
    start, fwd = collectives.TensorGroup.ppermute_start, mb.matmul_bias_fwd

    def counted_start(self, *a, **k):
        counts["hops"] += 1
        return start(self, *a, **k)

    def counted_fwd(*a, **k):
        counts["chunks"] += 1
        return fwd(*a, **k)

    stack.enter_context(_patched(collectives.TensorGroup, "ppermute_start", counted_start))
    stack.enter_context(_patched(mb, "matmul_bias_fwd", counted_fwd))
    return counts


def _poison_grads(stack, step_at, name, index):
    """From step ``step_at`` on (counted from 0), the step's gradient of
    ``name`` gets an inf at flat ``index`` of this rank's tensor (None:
    none) after the division, before the overflow check."""
    import importlib

    step_mod = importlib.import_module("smdistributed_modelparallel_tpu_torch.step")
    real = step_mod.StepFunction._finish_grads
    calls = [0]

    def poisoned(self, *args, **kwargs):
        grads = real(self, *args, **kwargs)
        if calls[0] >= step_at and index is not None:
            with torch.no_grad():
                grads[name].view(-1)[index] = float("inf")
        calls[0] += 1
        return grads

    stack.enter_context(_patched(step_mod.StepFunction, "_finish_grads", poisoned))


def _run_one(smp, world, cfg, t, head, opts, init):
    """One configuration on this rank: losses, whole first grads, whole final
    params, replicated-parameter bytes a step and the extras."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead
    from smdistributed_modelparallel_tpu_torch.ops import collective_matmul as cm
    from smdistributed_modelparallel_tpu_torch.utils import health

    counts = opts["_counts"]
    with _environ(opts.get("env", {})):
        smp.init({"microbatches": MB, "ddp": True, "tensor_parallel_seed": SEED, **cfg}, device="cpu")
        if opts.get("scale"):
            state.loss_scaler = DynamicLossScaler(init_scale=opts["scale"])
        rdp = world // cfg.get("tensor_parallel_degree", 1)
        r = smp.rdp_rank()
        ids, tgt = (torch.from_numpy(x[r * B // rdp:(r + 1) * B // rdp]).long() for x in _stream(t))
        model = smp.DistributedModel(DistributedTransformerLMHead(**{**HEAD, **head}))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
        optimizer = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR), model)

        @smp.step
        def train_step(model, ids_, tgt_):
            count = (tgt_ != -100).sum()
            loss = model(ids_, targets=tgt_).sum() / count
            model.backward(loss, num_tokens=count)
            return loss

        out = dict(losses=[], grads=None, prints=[], scale=[], health=[], quant=[], finite=[])
        replicated = [n for n, _ in model.named_parameters() if n not in model._tp_specs]
        cm._FALLBACK_WARNED.clear()
        before = dict(counts)
        for _ in range(STEPS):
            step_out = train_step(model, ids, tgt)
            if out["grads"] is None:
                grads = model._gather_tp(model.grads) if model._tp_specs else model.grads
                out["grads"] = {k: g.numpy().copy() for k, g in grads.items()}
            out["losses"].append(step_out.stack().double().reshape(-1).tolist())
            if opts.get("health"):
                health.monitor.flush()
                out["health"].append(health.monitor.last_check["tags"])
            out["finite"].append(model._grads_finite)
            optimizer.step()
            params = dict(model.named_parameters())
            out["prints"].append(b"".join(params[n].detach().numpy().tobytes() for n in replicated))
            if opts.get("scale"):
                out["scale"].append(state.loss_scaler.state_dict())
            if opts.get("quant"):
                out["quant"].append(state.quant_state.state_dict())
        out["dispatch"] = dispatch_counts(smp.telemetry.report())
        sd = model.module.state_dict()
        final = model._gather_tp(sd) if model._tp_specs else sd
        out.update(params={k: v.numpy().copy() for k, v in final.items()},
                   counts={k: counts[k] - before[k] for k in counts}, warned=sorted(cm._FALLBACK_WARNED),
                   sequence_parallel=model._seq_parallel_ran)
        smp.reset()
    return out


def _ring_units(smp, world):
    """The rings alone at tp = ``world``: the largest difference of each
    output and gradient to the same products on whole tensors."""
    from smdistributed_modelparallel_tpu_torch.nn.utils import tp_group, tp_rank
    from smdistributed_modelparallel_tpu_torch.ops import collective_matmul as cm

    smp.init({"tensor_parallel_degree": world, "ddp": True}, device="cpu")
    me, g = tp_rank(), torch.Generator().manual_seed(3)
    Bu, Tu, D, Fd = 2, 4 * world, 8, 4 * world
    Fl = Fd // world
    x = torch.randn(Bu, Tu, D, generator=g, dtype=torch.float32)
    w = torch.randn(Fd, D, generator=g, dtype=torch.float32)
    b = torch.randn(Fd, generator=g, dtype=torch.float32)
    gy = torch.randn(Bu, Tu, Fd, generator=g, dtype=torch.float32)
    xk = torch.randn(Bu, Tu, Fd, generator=g, dtype=torch.float32)
    go = torch.randn(Bu, Tu, D, generator=g, dtype=torch.float32)
    cols, tl = slice(me * Fl, (me + 1) * Fl), slice(me * Tu // world, (me + 1) * Tu // world)
    errs = {}

    def leaf(t):
        return t.detach().clone().requires_grad_()

    def err(got, want):
        return float((got - want).abs().max())

    for seq_sharded in (False, True):
        # The all-gather ring: the whole input (or its T block), this rank's
        # output columns. The input's gradient sums every rank's columns.
        xs, ws, bs = leaf(x[:, tl] if seq_sharded else x), leaf(w[cols]), leaf(b[cols])
        y = cm.ring_ag_matmul(xs, ws, bs, seq_sharded=seq_sharded)
        (y * gy[..., cols]).sum().backward()
        dx = gy @ w
        errs[f"ag_{seq_sharded}"] = max(
            err(y, x @ w[cols].t() + b[cols]), err(xs.grad, dx[:, tl] if seq_sharded else dx),
            err(ws.grad, gy[..., cols].reshape(-1, Fl).t() @ x.reshape(-1, D)), err(bs.grad, gy[..., cols].sum((0, 1))))
        # The reduce-scatter ring: this rank's contraction block; its output
        # the rank's T block (True) or the whole, gathered (False).
        wt = w.t()[:, cols].contiguous()  # [D, Fl]: the whole weight w.t() [D, Fd]'s columns
        xr, wr = leaf(xk[..., cols]), leaf(wt)
        o = cm.ring_rs_matmul(xr, wr, seq_sharded=seq_sharded)
        (o * (go[:, tl] if seq_sharded else go)).sum().backward()
        errs[f"rs_{seq_sharded}"] = max(
            err(o, (xk @ w)[:, tl] if seq_sharded else xk @ w), err(xr.grad, go @ wt),
            err(wr.grad, go.reshape(-1, D).t() @ xk[..., cols].reshape(-1, Fl)))
    # The standalone linears under the ring: a ColumnParallelLinear into a
    # RowParallelLinear gives what the pair gives without it (outputs and
    # every gradient), the JAX layer's "logical value is identical".
    from smdistributed_modelparallel_tpu_torch import nn as smp_nn
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    pair = torch.nn.Sequential(smp_nn.ColumnParallelLinear(D, Fd), torch.nn.ReLU(), smp_nn.RowParallelLinear(Fd, D))
    got = {}
    for mode in ("off", "ring"):
        state.cfg._values["tp_overlap"] = mode
        xs = leaf(x)
        out = pair(xs)
        pair.zero_grad()
        (out * go).sum().backward()
        got[mode] = [out, xs.grad] + [p.grad.clone() for p in pair.parameters()]
    errs["linears"] = max(err(a, b) for a, b in zip(got["ring"], got["off"]))
    assert tp_group().size == world
    smp.reset()
    return errs


def worker(rank, world, runs, inits):
    """Each configuration of ``runs`` with ``world`` ranks on this rank (one
    torch thread); then, at world 2 and 4, the rings alone. Every patch is
    undone before it returns (the tp = 1 runs are in the test's process)."""
    import smdistributed_modelparallel_tpu_torch as smp

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with contextlib.ExitStack() as outer:
            counts = _counting(outer)
            for (name, cfg, ranks, t, head, opts), init in zip(runs, inits):
                if ranks != world:
                    continue
                with contextlib.ExitStack() as stack:
                    if opts.get("fused"):
                        _patch_seams(stack)
                    if opts.get("poison") is not None:
                        step_at, param, index_by_rank = opts["poison"]
                        _poison_grads(stack, step_at, param, index_by_rank.get(rank))
                    if opts.get("flash"):
                        from smdistributed_modelparallel_tpu_torch.ops import attention

                        stack.enter_context(_patched(attention, "_kernel_ok", lambda q, k, v: True))
                    out[name] = _run_one(smp, world, cfg, t, head, {**opts, "_counts": counts}, init)
            if world > 1 and any(ranks == world for _, _, ranks, *_ in runs):
                out["units"] = _ring_units(smp, world)
    finally:
        torch.set_num_threads(threads)
        smp.reset()
    return out


def port_runs(runs, inits, worlds=(2, 4)):
    """{world: [rank results]} of ``worker`` over ``runs``."""
    return {world: run_ranks(world, worker, runs, inits) for world in worlds}


def port_tp1(runs, inits):
    """The port at tp = 1 in this process: each of ``runs`` by name."""
    return worker(0, 1, runs, inits)


@pytest.fixture(scope="module")
def runs():
    # ring_t15 runs no ring: it is held against the port's tp = 1 step.
    want = {name: jax_run(cfg, ranks, t, head, opts) for name, cfg, ranks, t, head, opts in RUNS
            if t == T and name not in JAX_OF}
    want.update({name: want[of] for name, of in JAX_OF.items()})
    # The JAX package's tp = 2 step without the ring, on ring_speed's weights.
    plain = jax_run({"tensor_parallel_degree": 2}, 2, T, FUSED, {})
    init = want["ring_speed"][0]
    per_rank = port_runs(RUNS, [want[name][0] if name in want else init for name, *_ in RUNS])
    tp1 = port_tp1([("tp1", {}, 1, T, FUSED, {}), ("tp1_t15", {}, 1, 15, FUSED, {})], [init, init])
    return want, plain, per_rank, tp1


def _ranks_of(per_rank, name):
    world = next(ranks for n, _, ranks, *_ in RUNS if n == name)
    return per_rank[world]


def assert_run_matches(got, want, tol=TOL):
    """Losses, first-step gradients and final parameters within ``tol``."""
    want_losses, want_grads, want_params = want
    np.testing.assert_allclose(got["losses"], want_losses, **tol["loss"])
    assert set(got["grads"]) == set(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=tol["grad"], err_msg=k)
    for k, p in want_params.items():
        np.testing.assert_allclose(got["params"][k], p, rtol=0, atol=tol["param"], err_msg=k)


@pytest.mark.parametrize("name", [r[0] for r in RUNS if r[3] == T])
def test_ring_step_matches_jax_ring(runs, name):
    want, _, per_rank, _ = runs
    _, losses, grads, params, _ = want[name]
    for got in _ranks_of(per_rank, name):
        assert_run_matches(got[name], (losses, grads, params))
        assert np.mean(got[name]["losses"][-1]) < np.mean(got[name]["losses"][0])


@pytest.mark.parametrize("name", ["ring_speed", "ring_memory"])
def test_ring_step_matches_jax_without_the_ring(runs, name):
    """The ring changes how the tp step computes, not what: the JAX
    package's tp = 2 step without it gives the same numbers."""
    _, plain, per_rank, _ = runs
    assert_run_matches(per_rank[2][0][name], plain[1:4])


@pytest.mark.parametrize("name,base", [("ring_speed", "tp1"), ("ring_memory", "tp1"), ("ring_t15", "tp1_t15")])
def test_ring_step_matches_tp1(runs, name, base):
    _, _, per_rank, tp1 = runs
    for got in per_rank[2]:
        assert_run_matches(got[name], (tp1[base]["losses"], tp1[base]["grads"], tp1[base]["params"]))


@pytest.mark.parametrize("name", [r[0] for r in RUNS if r[3] == T and r[0] not in JAX_OF])
def test_ring_dispatch_counts_match_jax(runs, name):
    """``smp_fused_kernel_dispatch_total`` (the fused QKV inside the ring, the
    bias-GELU) counts what the JAX package's traces count."""
    want, _, per_rank, _ = runs
    for r in _ranks_of(per_rank, name):
        assert r[name]["dispatch"] == want[name][4]["dispatch"]
        assert r[name]["dispatch"][("smp_fused_kernel_dispatch_total", (("kernel", "qkv"), ("path", "pallas")))] > 0


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_ring_replicated_parameters_stay_bit_equal(runs, name):
    _, _, per_rank, _ = runs
    ranks = _ranks_of(per_rank, name)
    for r in ranks[1:]:
        assert r[name]["prints"] == ranks[0][name]["prints"]
        assert r[name]["losses"] == ranks[0][name]["losses"]


@pytest.mark.parametrize("name,hops,chunks,sp", [
    # 2 layers x 2 microbatches x 3 steps; a layer's forward takes one hop in
    # each of its four rings (tp - 1 = 1), its backward two in each
    # all-gather ring (x and the dx accumulator) and one in each
    # reduce-scatter ring; each QKV ring runs tp = 2 matmul_bias chunks.
    ("ring_speed", 120, 24, False),
    ("ring_memory", 120, 24, True),
    ("ring_tp2_rdp2", 120, 24, False),
    ("ring_t15", 0, 0, False),
    # Each layer's recompute replays its forward's four hops and two chunks.
    ("ring_ckpt_tp2_rdp2", 168, 48, False),
])
def test_ring_hops_and_chunk_launches(runs, name, hops, chunks, sp):
    _, _, per_rank, _ = runs
    for r in _ranks_of(per_rank, name):
        assert r[name]["counts"] == {"hops": hops, "chunks": chunks}
        assert r[name]["sequence_parallel"] is sp


def test_indivisible_sequence_keeps_the_non_ring_path_with_a_warning(runs):
    """T = 15: every ring warns once and the layers keep the non-ring path
    (the JAX package's ``test_indivisible_seq_falls_back_correct_and_flagged``)."""
    _, _, per_rank, _ = runs
    for r in per_rank[2]:
        assert r["ring_t15"]["warned"] == [("ag", 15, 2), ("rs", 15, 2)]
        assert r["ring_speed"]["warned"] == []


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ring", ["ag_False", "ag_True", "rs_False", "rs_True", "linears"])
def test_ring_alone_matches_whole_products(runs, world, ring):
    """ring_ag_matmul / ring_rs_matmul (fp32) on a replicated input (False)
    and on the rank's T block (True): outputs and gradients within 1e-5 of
    the products on whole tensors, on every rank, at tp 2 and 4; and a
    ColumnParallelLinear into a RowParallelLinear with and without the
    ring."""
    _, _, per_rank, _ = runs
    for r in per_rank[world]:
        assert r["units"][ring] < 1e-5, r["units"]
