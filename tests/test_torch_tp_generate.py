"""``smp.generate`` through the ``smp.nn`` head at tp = 2 against the JAX
package's.

The JAX head's init, every leaf moved by noise from a seed (so the logits
are far from ties), goes through ``convert.lm_head_params_from_jax`` into a
``DistributedModel`` in each of two gloo ranks (each keeps its part of the
whole tensors); fp32 on the CPU. The JAX package generates at tp = 2 on a
2-device mesh (``tests/test_generate.py``'s ``test_tp4_matches_single_device``
method at tp = 2, and its ``test_wrapped_model_generate``). Both ranks must
give the JAX package's tokens: greedy, greedy from left-padded prompts (the
decode caches hold the rank's H/2 heads beside ``pad_row_offset``), under
``optimize: "memory"`` (a prefill that tp divides runs the stack
sequence-parallel), with a vocab-split tied table (V = 97: the logits
gathered from uneven shards before the sampler), 2 beams, and sampled under
a key.
"""

import numpy as np
import pytest
import torch

from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax, lm_head_params_from_jax

# The JAX side is imported where it runs: the spawned ranks import this
# module, and need torch alone.

HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=97, num_positions=64, causal_mask_size=64, attention_dropout_prob=0.0, hidden_dropout_prob=0.0,
    embedding_dropout_prob=0.0, deterministic=True, pre_layernorm=True, post_layernorm=False, final_layernorm=True,
)
T, NEW = 8, 6
# (name, head overrides, generate keyword arguments, padded prompts, config)
CASES = [
    ("greedy", {}, {}, False, {}),
    ("padded", {}, {}, True, {}),
    ("memory", {}, {}, False, {"optimize": "memory"}),
    ("vocab_split", {"distribute_embedding": True}, {}, True, {}),
    ("beams", {}, {"num_beams": 2}, False, {}),
    ("sampled", {}, {"temperature": 1.0, "top_k": 20}, False, {}),
]
KEY = 11


def _prompts(padded):
    ids = np.random.default_rng(5).integers(0, 97, (3, T)).astype(np.int32)
    mask = np.ones((3, T), np.int32)
    if padded:
        mask[0, :3] = 0
        mask[2, :1] = 0
        ids = np.where(mask == 1, ids, 0).astype(np.int32)
    return ids, mask


def _jax_params(kw, seed=0, noise=0.3):
    import jax
    import jax.numpy as jnp

    import smdistributed_modelparallel_tpu as smp_jax
    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr

    jmod = jax_tr.DistributedTransformerLMHead(**kw)
    smp_jax.init({})
    try:
        params = jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    finally:
        smp_jax.reset()
    rng = np.random.default_rng(seed + 100)
    return jmod, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32), params)


def _jax_cases():
    """{case: (whole port weights, the JAX package's tokens at tp = 2)},
    and the sampler's key as the port takes it."""
    import jax
    import jax.numpy as jnp

    import smdistributed_modelparallel_tpu as smp_jax

    out = {"key": key_from_jax(jax.random.key_data(jax.random.key(KEY)))}
    for name, head, kw, padded, cfg in CASES:
        jmod, params = _jax_params({**HEAD, **head})
        ids, mask = _prompts(padded)
        smp_jax.init({"tensor_parallel_degree": 2, "ddp": True, "_device_count_override": 2, **cfg})
        try:
            extra = {"attention_mask": jnp.asarray(mask)} if padded else {}
            if "temperature" in kw:
                extra["rng"] = jax.random.key(KEY)
            tokens = smp_jax.generate(jmod, jnp.asarray(ids), NEW, params=params, **kw, **extra)
        finally:
            smp_jax.reset()
        port = {k: v.numpy().copy() for k, v in lm_head_params_from_jax(params).items()}
        out[name] = (port, np.asarray(tokens))
    return out


def _worker(rank, world, want):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead

    torch.set_num_threads(1)
    out = {}
    for name, head, kw, padded, cfg in CASES:
        weights, _ = want[name]
        smp.init({"tensor_parallel_degree": 2, "ddp": True, **cfg}, device="cpu")
        model = smp.DistributedModel(DistributedTransformerLMHead(**{**HEAD, **head}))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        ids, mask = _prompts(padded)
        extra = {"attention_mask": torch.from_numpy(mask)} if padded else {}
        if "temperature" in kw:
            extra["rng"] = want["key"]
        out[name] = smp.generate(model, torch.from_numpy(ids).long(), NEW, **kw, **extra).numpy()
        out[name + "_heads"] = model.module.transformer.seq_layers[0].attention.tp_heads
        smp.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    want = _jax_cases()
    return want, run_ranks(2, _worker, want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_tp2_generate_matches_jax(runs, name):
    want, per_rank = runs
    tokens = want[name][1]
    for r in per_rank:
        np.testing.assert_array_equal(r[name], tokens)
        assert r[name + "_heads"] == 2  # each rank decodes its H/2 heads
    assert tokens.shape[-1] == T + NEW
