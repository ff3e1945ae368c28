"""The port's tp = 2 training step with every single-card training option,
against the JAX package's tp = 2 step and the port's tp = 1 step.

``tests/test_torch_tp_ring.py``'s harness (CPU processes over gloo, the
tiny fp32 ``smp.nn`` LM head, 3 SGD steps, 2 microbatches; the world
spawned once for the module), at the same bounds (losses rtol 1e-5 / atol
1e-6, first-step gradients gathered whole and final parameters 1e-5):

- dropouts 0.1 (attention probabilities, attention and MLP outputs,
  embedding) in the speed and memory layouts and under the ring (memory):
  every rank draws the keys a tp = 1 step draws, each shard its part of the
  masks (the rank's heads, its T runs), so the numbers are tp = 1's. The
  JAX side is a subclass whose ``embed`` is compact
  (``tests/test_torch_dropout_step.py``). Also the flash route (the port's
  gate patched, the kernels' plain versions hash the global heads) against
  tp = 1 on the same route;
- activation checkpointing with those dropouts (speed; ring and memory):
  the recompute replays the tp regions, ring hops and keys; the values are
  those of the step without it, the JAX package's included;
- fp16 (the loss scaler from 2**16): the scale's trajectory, the overflow
  flags and the numbers (to fp16's own bounds: ``FP16_TOL``,
  ``FP16_JAX_TOL``); and a gradient shard that overflows on rank 1 only
  (an inf put in after the division) skips the step on both ranks and moves
  the scale, as an inf at the same element does at tp = 1;
- fp8 (``matmul_precision: "fp8"``), without and with the ring (memory):
  the 19-slot amax history and scales after each step equal the JAX
  package's (rtol 1e-5, ``tests/test_torch_fp8_step.py``'s fp32 bound);
- the sentinel (``SMP_HEALTH_CHECK=full``, memory layout; ``cheap`` beside
  fp16): the decoded ``[K, 3]`` word of every step equals the JAX
  package's (counts and first bad microbatch exactly, maxima to 1e-5
  relative), replicated tensors counted once.
Beside it: the plain index-mapped dropout and bits against
``jax.random.bits``/``bernoulli`` of the whole tensor, and (``cuda``) the
index-mapped kernels against their plain versions.
"""

import numpy as np
import pytest
import torch

from test_torch_tp_ring import HEAD, RING, T, TOL, assert_run_matches, jax_run, port_runs, port_tp1
from smdistributed_modelparallel_tpu_torch.ops import dropout as port_dropout
from smdistributed_modelparallel_tpu_torch.utils import random

DROP = dict(attention_dropout_prob=0.1, hidden_dropout_prob=0.1, embedding_dropout_prob=0.1)
CKPT = dict(DROP, activation_checkpointing=True)
TP2 = {"tensor_parallel_degree": 2}
PLAIN_RING = {k: v for k, v in RING.items() if k != "fused_qkv"}
MEMORY = {"optimize": "memory"}
SCALE = 2.0 ** 16
# An inf in rank 1's shard of layer 0's fc weight from the second step on;
# at tp = 1 the same element, row F / 2 of the whole weight.
POISON_PARAM = "transformer.seq_layers.0.output.fc.weight"
POISON_TP2 = (1, POISON_PARAM, {1: 0})
POISON_TP1 = (1, POISON_PARAM, {0: (HEAD["intermediate_size"] // 2) * HEAD["hidden_size"]})
CHEAP, FULL = {"SMP_HEALTH_CHECK": "cheap"}, {"SMP_HEALTH_CHECK": "full"}
# fp16 computes in fp16: 11 significant bits, so a gradient near 0.25 moves in
# steps of 2**-13 (1.2e-4), and at tp = 2 each rank's partial product rounds
# before the all-reduce. Against the port's tp = 1 the fp16 runs are held to
# two such steps (losses to 1e-4 relative, parameters after three SGD steps
# of 0.1 to 1e-4, the sentinel's maxima to 1e-3 relative). XLA and torch
# round fp16 at other points besides (a gradient summed over 128 tokens
# differs by up to 4.3e-4), so against the JAX package the gradients are
# held to 1e-3, the parameters to 2e-4 and the maxima to 5e-3 relative;
# tests/test_torch_step.py holds its fp16 parameters to 1e-2.
FP16_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), grad=2.5e-4, param=1e-4)
FP16_JAX_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), grad=1e-3, param=2e-4)


def _tol(name, jax=False):
    if not name.startswith("fp16"):
        return TOL
    return FP16_JAX_TOL if jax else FP16_TOL
# (name, config, ranks, T, head overrides, options, JAX run it is held
# against (None: none), tp = 1 run it is held against (None: none))
CASES = [
    ("dropout_speed", TP2, 2, T, DROP, {}, "dropout_speed", "tp1_dropout"),
    ("dropout_memory", {**TP2, **MEMORY}, 2, T, DROP, {}, "dropout_memory", "tp1_dropout"),
    ("dropout_ring_memory", {**PLAIN_RING, **MEMORY}, 2, T, DROP, {}, "dropout_ring_memory", "tp1_dropout"),
    ("dropout_flash", TP2, 2, T, DROP, {"flash": True}, None, "tp1_dropout_flash"),
    ("ckpt_speed", TP2, 2, T, CKPT, {}, "dropout_speed", "tp1_dropout"),
    ("ckpt_ring_memory", {**PLAIN_RING, **MEMORY}, 2, T, CKPT, {}, "dropout_ring_memory", "tp1_dropout"),
    ("fp16", {**TP2, "fp16": True}, 2, T, {}, {"scale": SCALE, "health": True, "env": CHEAP}, "fp16", "tp1_fp16"),
    ("fp16_poison", {**TP2, "fp16": True}, 2, T, {}, {"scale": SCALE, "poison": POISON_TP2}, None,
     "tp1_fp16_poison"),
    ("fp8", {**TP2, "matmul_precision": "fp8"}, 2, T, {}, {"quant": True}, "fp8", "tp1_fp8"),
    ("fp8_ring_memory", {**PLAIN_RING, **MEMORY, "matmul_precision": "fp8"}, 2, T, {}, {"quant": True},
     "fp8_ring_memory", None),
    ("health_memory", {**TP2, **MEMORY}, 2, T, {}, {"health": True, "env": FULL}, "health_memory", "tp1_health"),
]
TP1 = [
    ("tp1_dropout", {}, 1, T, DROP, {}),
    ("tp1_dropout_flash", {}, 1, T, DROP, {"flash": True}),
    ("tp1_fp16", {"fp16": True}, 1, T, {}, {"scale": SCALE, "health": True, "env": CHEAP}),
    ("tp1_fp16_poison", {"fp16": True}, 1, T, {}, {"scale": SCALE, "poison": POISON_TP1}),
    ("tp1_fp8", {"matmul_precision": "fp8"}, 1, T, {}, {"quant": True}),
    ("tp1_health", {}, 1, T, {}, {"health": True, "env": FULL}),
]
JAX_RUNS = sorted({c[6] for c in CASES if c[6] is not None})


@pytest.fixture(scope="module")
def runs():
    specs = {name: (cfg, ranks, t, head, opts) for name, cfg, ranks, t, head, opts, *_ in CASES}
    want = {name: jax_run(*specs[name]) for name in JAX_RUNS}
    init = want["dropout_speed"][0]
    for name in JAX_RUNS:  # one seed, one model: every JAX run starts from the same weights
        assert all(np.array_equal(want[name][0][k], v) for k, v in init.items()), name
    port = port_runs([c[:6] for c in CASES], [want[c[6]][0] if c[6] else init for c in CASES], worlds=(2,))
    tp1 = port_tp1(TP1, [init] * len(TP1))
    return want, port[2], tp1


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[6] is not None])
def test_option_matches_jax_tp2(runs, name):
    want, ranks, _ = runs
    _, losses, grads, params, _ = want[_case(name)[6]]
    for r in ranks:
        assert_run_matches(r[name], (losses, grads, params), _tol(name, jax=True))


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[7] is not None])
def test_option_matches_tp1(runs, name):
    _, ranks, tp1 = runs
    base = tp1[_case(name)[7]]
    for r in ranks:
        assert_run_matches(r[name], (base["losses"], base["grads"], base["params"]), _tol(name))
        assert r[name]["finite"] == base["finite"]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_option_keeps_replicated_parameters_bit_equal(runs, name):
    _, ranks, _ = runs
    assert ranks[1][name]["prints"] == ranks[0][name]["prints"]
    assert ranks[1][name]["losses"] == ranks[0][name]["losses"]


def test_dropout_draws_masks(runs):
    """Dropout is on: its steps' losses are not the dropout-free ones."""
    _, ranks, tp1 = runs
    assert not np.allclose(ranks[0]["dropout_speed"]["losses"], tp1["tp1_health"]["losses"], rtol=1e-3)


def test_fp16_loss_scale_trajectory_matches_jax(runs):
    want, ranks, tp1 = runs
    jax_scale = want["fp16"][4]["scale"]
    for r in ranks:
        assert r["fp16"]["scale"] == jax_scale == tp1["tp1_fp16"]["scale"]


def test_one_rank_shard_overflow_skips_the_step_on_every_rank(runs):
    """An inf in rank 1's gradient shard alone: both ranks see the overflow,
    skip the update and back the scale off, as tp = 1 does for the same
    element."""
    _, ranks, tp1 = runs
    base = tp1["tp1_fp16_poison"]
    assert base["finite"] == [True, False, False]
    for r in ranks:
        got = r["fp16_poison"]
        assert got["finite"] == base["finite"] and got["scale"] == base["scale"]
        assert got["scale"][1]["scale"] == got["scale"][0]["scale"] / 2
    # Skipped steps leave the parameters as the last clean step left them.
    np.testing.assert_array_equal(ranks[0]["fp16_poison"]["prints"][2], ranks[0]["fp16_poison"]["prints"][0])


@pytest.mark.parametrize("name", ["fp8", "fp8_ring_memory"])
def test_fp8_amax_and_scales_match_jax(runs, name):
    want, ranks, tp1 = runs
    states = want[name][4]["quant"]
    for r in ranks:
        for step, (g, w) in enumerate(zip(r[name]["quant"], states)):
            assert g["slots"] == w["slots"]
            live = {s for s, h in zip(w["slots"], w["amax_history"]) if h[0] > 0}
            assert {s for s, h in zip(g["slots"], g["amax_history"]) if h[0] > 0} == live
            np.testing.assert_allclose(g["amax_history"], w["amax_history"], rtol=1e-5, atol=0, err_msg=f"{step}")
            np.testing.assert_allclose(g["scale"], w["scale"], rtol=1e-5, atol=0, err_msg=f"{step}")
    if name == "fp8":
        for g, w in zip(ranks[0][name]["quant"], tp1["tp1_fp8"]["quant"]):
            np.testing.assert_allclose(g["amax_history"], w["amax_history"], rtol=1e-5, atol=0)
    else:  # the ring's boundary slots replace the four product seams'
        live = {s for s, h in zip(states[0]["slots"], states[0]["amax_history"]) if h[0] > 0}
        assert {"ring_ag.x", "ring_ag.w", "ring_rs.x", "ring_rs.w"} <= live and not live & {"qkv.x", "mlp_fc.x"}


@pytest.mark.parametrize("name", ["fp8", "fp8_ring_memory"])
def test_fp8_dispatch_counts_match_jax(runs, name):
    """``smp_quant_dispatch_total`` at the tp seams (the product seams, or the
    ring's ``ring_ag``/``ring_rs``) counts what the JAX package's traces
    count."""
    want, ranks, _ = runs
    sites = {dict(labels)["site"] for (metric, labels) in want[name][4]["dispatch"]
             if metric == "smp_quant_dispatch_total"}
    assert sites >= ({"ring_ag", "ring_rs"} if "ring" in name else {"qkv", "mlp_fc"})
    for r in ranks:
        assert r[name]["dispatch"] == want[name][4]["dispatch"]


def _assert_words_match(got, want, rel):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for tag in w:
            assert g[tag]["bad"] == w[tag]["bad"] and g[tag]["microbatch"] == w[tag]["microbatch"], tag
            assert g[tag]["absmax"] == pytest.approx(w[tag]["absmax"], rel=rel), tag


@pytest.mark.parametrize("name", ["fp16", "health_memory"])
def test_sentinel_words_match_jax_and_tp1(runs, name):
    want, ranks, tp1 = runs
    rel = (5e-3, 1e-3) if name == "fp16" else (1e-5, 1e-5)
    for r in ranks:
        _assert_words_match(r[name]["health"], want[name][4]["health"], rel[0])
        _assert_words_match(r[name]["health"], tp1[_case(name)[7]]["health"], rel[1])
    assert set(ranks[0]["health_memory"]["health"][0]) == {"grads", "loss", "outputs", "params"}


# -- the index map ---------------------------------------------------------

SHARDS = [
    # (whole shape, dim cut, parts): a tp rank's heads of [B, H, T, S]
    # probabilities, its T block of [B, T, D], and a flat range.
    ((2, 4, 6, 6), 1, 2),
    ((3, 8, 5), 1, 2),
    ((3, 8, 5), 1, 4),
    ((40,), 0, 4),
]


def _jax_whole(shape, seed):
    import jax

    key = jax.random.key(seed)
    bits = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    keep = np.asarray(jax.random.bernoulli(key, 0.9, shape))
    return key, bits, keep


@pytest.mark.parametrize("shape,dim,parts", SHARDS)
def test_index_mapped_draws_are_slices_of_the_whole(shape, dim, parts):
    """``threefry_bits`` and ``dropout_fwd`` with ``nn.utils.shard_index``'s
    map give each part exactly its slice of the whole tensor's
    ``jax.random.bits`` and ``bernoulli`` (the plain versions, on the
    CPU)."""
    import jax

    from smdistributed_modelparallel_tpu_torch.convert import key_from_jax
    from smdistributed_modelparallel_tpu_torch.nn.utils import shard_index

    key, bits, keep = _jax_whole(shape, 11)
    k = key_from_jax(jax.random.key_data(key))
    x = torch.ones(shape)
    for index in range(parts):
        part = [slice(None)] * len(shape)
        n = shape[dim] // parts
        part[dim] = slice(index * n, (index + 1) * n)
        local = torch.ones(x[tuple(part)].shape)
        offset, run, stride = shard_index(local.shape, dim, index, parts)
        got = port_dropout.threefry_bits(k, local.numel(), offset, run=run, stride=stride).numpy()
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF, bits[tuple(part)].reshape(-1))
        y, mask = port_dropout.dropout_fwd(local, 0.1, k, (offset, run, stride))
        np.testing.assert_array_equal(mask.numpy(), keep[tuple(part)])


def test_index_map_refuses_a_run_longer_than_its_stride():
    with pytest.raises(ValueError, match="run"):
        port_dropout.threefry_bits(random.key(0), 8, 0, run=4, stride=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim,parts", SHARDS + [((2, 12, 1024, 1024), 1, 2), ((2, 1024, 768), 1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_index_mapped_kernels_match_plain_versions(cuda, shape, dim, parts, dtype):
    """``smp_threefry_bits`` and ``smp_dropout_fwd`` under the index map
    (each part of ``shape`` cut along ``dim``) equal their plain versions
    bit for bit; ``dropout_bwd`` reads the mask as before."""
    from smdistributed_modelparallel_tpu_torch.nn.utils import shard_index

    k = random.key(2**32 + 9)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for index in range(parts):
        local = list(shape)
        local[dim] //= parts
        offset, run, stride = shard_index(local, dim, index, parts)
        n = int(np.prod(local))
        before = (port_dropout.threefry_bits.launches, port_dropout.dropout_fwd.launches)
        got = port_dropout.threefry_bits(k, n, offset, device=cuda, run=run, stride=stride)
        want = port_dropout.reference_threefry_bits(k, n, offset, cuda, run, stride)
        assert torch.equal(got, want)
        x = torch.randn(local, generator=gen, device=cuda).to(dtype)
        y, mask = port_dropout.dropout_fwd(x, 0.1, k, (offset, run, stride))
        y_ref, keep = port_dropout.reference_dropout_fwd(x, 0.1, k, (offset, run, stride))
        torch.cuda.synchronize()
        assert torch.equal(mask.bool(), keep)
        assert torch.equal(y.view(torch.uint8), y_ref.contiguous().view(torch.uint8))  # bit for bit
        assert (port_dropout.threefry_bits.launches, port_dropout.dropout_fwd.launches) == (before[0] + 1,
                                                                                           before[1] + 1)
