"""The port's vocab-parallel cross-entropy at tp = 2 against the JAX package's.

Two CPU processes over gloo against the JAX package at tp = 2 on a 2-device
CPU mesh (``tests/test_pallas_ce.py``'s tp cases; its tp = 4 case run at
tp = 2), fp32, within 2e-5:
  - the fused composition (``pallas_ce.make_vocab_parallel_fused_ce`` through
    ``_build_tp_fused_ce``, the Pallas kernels in interpret mode) against the
    port's ``ops/fused_ce.vocab_parallel_fused_ce`` (each rank's [V/2, D]
    rows through the kernels' plain versions, the tied head's dispatch taken
    by patching ``nn.cross_entropy._is_cuda``): loss, dx and dW, with and
    without label smoothing, from a table whole on every rank (cut there, dW
    gathered back) and from a vocab-sharded one (``vocab_size``);
  - the dispatcher: ``fused_ce: True`` reaches the fused path at V = 64 (the
    JAX one reaches ``make_vocab_parallel_fused_ce``), ignored labels give no
    loss and no gradient; at V = 63, which tp does not divide, both packages
    materialize the logits and the port logs the JAX package's warning;
  - the materialized Megatron path over vocab-sharded logits
    (``vocab_parallel_cross_entropy(..., vocab_size=V)``): V = 64 and the
    uneven V = 63 (shards of 32 and 31 rows), with smoothing and ignored
    labels: loss and the logits' gradient.
"""

import numpy as np
import pytest
import torch

from chip_smoke import run_ranks

# The JAX side is imported where it runs: the spawned ranks import this
# module, and need torch alone.

N, D = 24, 16


def _xwt(V):
    """``tests/test_pallas_ce.py``'s inputs (its ``_xwt`` at N 24, D 16)."""
    import jax

    ks = jax.random.split(jax.random.key(0), 3)
    x = jax.random.normal(ks[0], (N, D))
    w = jax.random.normal(ks[1], (V, D)) * 0.1
    t = jax.random.randint(ks[2], (N,), 0, V)
    return x, w, t


def _np(*xs):
    return [np.asarray(x) for x in xs]


def _jax_cases():
    """{case: (inputs, loss, grads)} of the JAX package at tp = 2."""
    import jax
    import jax.numpy as jnp

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.backend.state import state as jax_state
    from smdistributed_modelparallel_tpu.nn import cross_entropy as jax_ce
    from smdistributed_modelparallel_tpu.ops import pallas_ce as pc

    out = {}
    jax_smp.reset()
    old = pc.FORCE_INTERPRET
    pc.FORCE_INTERPRET = True
    try:
        jax_smp.init({"tensor_parallel_degree": 2, "ddp": True, "_device_count_override": 2, "microbatches": 1})
        x, w, t = _xwt(64)
        for smoothing in (0.0, 0.1):
            fn = jax_ce._build_tp_fused_ce(jax_state.mesh, 64, 8, 16, True, smoothing)
            with jax.set_mesh(jax_state.mesh):
                per = jax.jit(fn)(x, w, t)
                grads = jax.jit(jax.grad(lambda x, w: jnp.mean(fn(x, w, t)), argnums=(0, 1)))(x, w)
            out[f"fused_{smoothing}"] = (_np(x, w, t), np.asarray(per), _np(*grads))
        jax_smp.reset()
        calls = []
        orig = pc.make_vocab_parallel_fused_ce
        pc.make_vocab_parallel_fused_ce = lambda *a, **k: calls.append(1) or orig(*a, **k)
        try:
            for V in (64, 63):
                before = len(calls)
                x, w, t = _xwt(V)
                tt = t.at[-3:].set(-100).reshape(2, 12)
                jax_smp.init({"tensor_parallel_degree": 2, "ddp": True, "_device_count_override": 2,
                              "microbatches": 1, "fused_ce": True})
                f = lambda h, w: jax_ce.fused_lm_head_cross_entropy(h, w, tt)  # noqa: E731
                with jax.set_mesh(jax_state.mesh):
                    per = jax.jit(f)(x.reshape(2, 12, D), w)
                    grads = jax.jit(jax.grad(lambda h, w: jnp.sum(f(h, w)), argnums=(0, 1)))(x.reshape(2, 12, D), w)
                out[f"dispatch_{V}"] = (_np(x, w, tt), np.asarray(per), _np(*grads), len(calls) - before)
                jax_smp.reset()
        finally:
            pc.make_vocab_parallel_fused_ce = orig
        jax_smp.init({"tensor_parallel_degree": 2, "ddp": True, "_device_count_override": 2, "microbatches": 1})
        for V, smoothing in ((64, 0.0), (64, 0.1), (63, 0.1)):
            logits = jax.random.normal(jax.random.key(5), (2, 8, V)) * 2.0
            tgt = jax.random.randint(jax.random.key(6), (2, 8), 0, V).at[0, :3].set(-100)
            f = lambda lg: jax_ce.masked_vocab_parallel_cross_entropy(lg, tgt, label_smoothing=smoothing)  # noqa
            with jax.set_mesh(jax_state.mesh):
                per = jax.jit(f)(logits)
                g = jax.jit(jax.grad(lambda lg: jnp.sum(f(lg) * jnp.arange(1.0, 17.0).reshape(2, 8))))(logits)
            out[f"materialized_{V}_{smoothing}"] = (_np(logits, tgt), np.asarray(per), [np.asarray(g)])
    finally:
        pc.FORCE_INTERPRET = old
        jax_smp.reset()
        jax_smp.init({})  # a default session: one left at tp 2 boxes the next file's JAX parameters
    return out


def _worker(rank, world, want):
    import logging

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.collectives import gather_from_tp
    from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as ce
    from smdistributed_modelparallel_tpu_torch.nn.utils import tp_group
    from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fce
    from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

    torch.set_num_threads(1)
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    get_logger().addHandler(handler)
    ce._is_cuda = lambda x: True  # the card's dispatch; the kernels' plain versions on the CPU
    out = {}

    smp.init({"tensor_parallel_degree": 2, "ddp": True, "microbatches": 1, "fused_ce": True}, device="cpu")
    calls = []
    orig = fce.vocab_parallel_fused_ce
    fce.vocab_parallel_fused_ce = lambda *a, **k: calls.append(1) or orig(*a, **k)
    for smoothing in (0.0, 0.1):
        (x, w, t), *_ = want[f"fused_{smoothing}"]
        tt = torch.from_numpy(t).long()
        for table in ("whole", "sharded"):
            xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in (x, w)]
            wl = xs[1].chunk(2, dim=0)[rank] if table == "sharded" else xs[1]
            per = ce.fused_lm_head_cross_entropy(xs[0], wl, tt, label_smoothing=smoothing,
                                                 vocab_size=64 if table == "sharded" else None)
            per.mean().backward()
            out[f"fused_{smoothing}_{table}"] = (per.detach().numpy(), [xs[0].grad.numpy(), xs[1].grad.numpy()])
    out["fused_calls"] = len(calls)
    smp.reset()
    for V in (64, 63):
        (x, w, tt), *_ = want[f"dispatch_{V}"]
        smp.init({"tensor_parallel_degree": 2, "ddp": True, "microbatches": 1, "fused_ce": True}, device="cpu")
        calls.clear()
        xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in (x.reshape(2, 12, D), w)]
        per = ce.fused_lm_head_cross_entropy(xs[0], xs[1], torch.from_numpy(tt).long())
        per.sum().backward()
        out[f"dispatch_{V}"] = (per.detach().numpy(), [xs[0].grad.numpy(), xs[1].grad.numpy()], len(calls))
        smp.reset()
    smp.init({"tensor_parallel_degree": 2, "ddp": True, "microbatches": 1}, device="cpu")
    g = tp_group()
    for V, smoothing in ((64, 0.0), (64, 0.1), (63, 0.1)):
        (logits, tgt), *_ = want[f"materialized_{V}_{smoothing}"]
        full = torch.from_numpy(np.array(logits))
        per_rank = -(-V // 2)
        local = full[..., rank * per_rank:(rank + 1) * per_rank].clone().requires_grad_()
        per = ce.masked_vocab_parallel_cross_entropy(local, torch.from_numpy(tgt).long(), label_smoothing=smoothing,
                                                     vocab_size=V)
        (per * torch.arange(1.0, 17.0).reshape(2, 8)).sum().backward()
        dl = gather_from_tp(local.grad, g, -1, sizes=[per_rank, V - per_rank])
        out[f"materialized_{V}_{smoothing}"] = (per.detach().numpy(), [dl.numpy()])
    fce.vocab_parallel_fused_ce = orig
    out["warnings"] = warnings
    smp.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    want = _jax_cases()
    return want, run_ranks(2, _worker, want)


@pytest.mark.parametrize("table", ["whole", "sharded"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_vocab_parallel_matches_jax(runs, smoothing, table):
    want, per_rank = runs
    _, per, grads = want[f"fused_{smoothing}"]
    for r, got in enumerate(per_rank):
        got_per, (dx, dw) = got[f"fused_{smoothing}_{table}"]
        np.testing.assert_allclose(got_per, per, rtol=0, atol=2e-5)
        np.testing.assert_allclose(dx, grads[0], rtol=0, atol=2e-5)
        if table == "sharded":  # dW stays on the rank's rows
            np.testing.assert_allclose(dw[r * 32:(r + 1) * 32], grads[1][r * 32:(r + 1) * 32], rtol=0, atol=2e-5)
            assert not dw[(1 - r) * 32:(2 - r) * 32].any()
        else:
            np.testing.assert_allclose(dw, grads[1], rtol=0, atol=2e-5)
        assert got["fused_calls"] == 4


@pytest.mark.parametrize("V", [64, 63])
def test_dispatcher_matches_jax(runs, V):
    """fused_ce: True at tp 2: the fused composition where tp divides V, the
    materialized logits (and the JAX package's warning) where it does not;
    ignored labels give 0 loss and no gradient."""
    want, per_rank = runs
    _, per, grads, jax_calls = want[f"dispatch_{V}"]
    assert (jax_calls > 0) == (V == 64)  # the JAX dispatch reached make_vocab_parallel_fused_ce
    for got in per_rank:
        got_per, (dh, dw), calls = got[f"dispatch_{V}"]
        assert calls == (1 if V == 64 else 0)
        np.testing.assert_allclose(got_per, per, rtol=0, atol=2e-5)
        np.testing.assert_array_equal(got_per.reshape(-1)[-3:], 0.0)
        np.testing.assert_array_equal(dh.reshape(N, D)[-3:], 0.0)
        np.testing.assert_allclose(dh, grads[0], rtol=0, atol=2e-5)
        np.testing.assert_allclose(dw, grads[1], rtol=0, atol=2e-5)
        if V == 63:
            assert any("vocab 63 not divisible by tp 2" in m and "materializing [24, 63] logits" in m
                       for m in got["warnings"]), got["warnings"]


@pytest.mark.parametrize("case", ["64_0.0", "64_0.1", "63_0.1"])
def test_materialized_vocab_parallel_matches_jax(runs, case):
    want, per_rank = runs
    _, per, (g,) = want[f"materialized_{case}"]
    for got in per_rank:
        got_per, (dl,) = got[f"materialized_{case}"]
        np.testing.assert_allclose(got_per, per, rtol=0, atol=2e-5)
        np.testing.assert_array_equal(got_per[0, :3], 0.0)
        np.testing.assert_allclose(dl, g, rtol=0, atol=2e-5)
