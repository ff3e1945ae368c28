"""The port's beam search (``smp.generate(..., num_beams=N)``) against the
JAX package's, token for token.

The zoo ``TransformerLM`` (JAX init through ``convert.params_from_jax``) and
``smp.nn.DistributedTransformerLMHead`` (through
``convert.lm_head_params_from_jax``) on numpy prompts, fp32 on the CPU, 4
beams: without EOS and with an EOS that the beams emit (the most frequent
token of the EOS-free run, so the finished store fills and rows stop), at
``length_penalty`` 0.6 and 1.0, returning 1 and 3 sequences, and with
left-padded prompts. A padded row's beams must equal its unpadded prompt's.
"""

import numpy as np
import pytest
import torch

import jax

from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

from test_torch_generate_nn import HEAD, head_pair, jax_generate, jax_init, port_generate, prompts

BEAMS, T, NEW = 4, 7, 6
ZOO = dict(vocab_size=97, max_len=64, d_model=32, n_layers=2, n_heads=4)
# (model, eos: None or "forced", length_penalty, num_return_sequences, padded)
CASES = [
    ("zoo", None, 1.0, 1, False),
    ("zoo", None, 0.6, 3, False),
    ("zoo", "forced", 1.0, 1, False),
    ("zoo", "forced", 0.6, 3, False),
    ("nn", None, 0.6, 3, False),
    ("nn", "forced", 1.0, 1, False),
    ("nn", None, 1.0, 1, True),
    ("nn", "forced", 0.6, 3, True),
]


def _id(case):
    model, eos, lp, r, padded = case
    return f"{model}-eos_{eos}-lp{lp}-r{r}" + ("-padded" if padded else "")


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def zoo_pair(seed=0, noise=0.3, **overrides):
    """(JAX zoo model, its params moved by noise, the port's model on them)."""
    kw = dict(ZOO, **overrides)
    jmod = JaxTransformerLM(**kw)
    params = jax_init(jmod, seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32), params)
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(params))
    return jmod, params, tmod


def _inputs(padded):
    ids = prompts(length=T, seed=21)
    if not padded:
        return ids, {}
    ids[1, :3] = 0
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    return ids, {"attention_mask": mask}


@pytest.fixture(scope="module")
def beam_runs():
    """Every case through the JAX package, and the EOS of each model: the
    most frequent token of its EOS-free beams."""
    models = {"zoo": zoo_pair(), "nn": head_pair(HEAD, seed=4)}
    eos = {}
    for name, (jmod, params, _) in models.items():
        free = jax_generate(jmod, params, _inputs(False)[0], NEW, num_beams=BEAMS)[:, T:]
        eos[name] = int(np.bincount(free.ravel()).argmax())
    want = {}
    for case in CASES:
        name, e, lp, r, padded = case
        jmod, params, _ = models[name]
        ids, kw = _inputs(padded)
        want[case] = jax_generate(jmod, params, ids, NEW, num_beams=BEAMS, length_penalty=lp,
                                  num_return_sequences=r, eos_token_id=eos[name] if e else None, **kw)
    return models, eos, want


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_beams_equal_jax(beam_runs, case):
    models, eos, want = beam_runs
    name, e, lp, r, padded = case
    tmod = models[name][2]
    ids, kw = _inputs(padded)
    got = port_generate(tmod, ids, NEW, num_beams=BEAMS, length_penalty=lp, num_return_sequences=r,
                        eos_token_id=eos[name] if e else None, **kw)
    assert got.shape == ((2, r, T + NEW) if r > 1 else (2, T + NEW))
    np.testing.assert_array_equal(got, want[case])
    if e:
        # The EOS entered the finished store: some hypothesis ends with it.
        assert (got[..., T:] == eos[name]).any()


def test_padded_beams_equal_the_unpadded_prompt(beam_runs):
    models, eos, _ = beam_runs
    tmod = models["nn"][2]
    ids, kw = _inputs(True)
    got = port_generate(tmod, ids, NEW, num_beams=BEAMS, **kw)
    alone = port_generate(tmod, ids[1:, 3:], NEW, num_beams=BEAMS)
    np.testing.assert_array_equal(got[1, T:], alone[0, T - 3:])


def test_one_beam_is_greedy(beam_runs):
    tmod = beam_runs[0]["zoo"][2]
    ids = _inputs(False)[0]
    np.testing.assert_array_equal(port_generate(tmod, ids, NEW, num_beams=1), port_generate(tmod, ids, NEW))


def test_beams_reorder_the_decode_caches(beam_runs, monkeypatch):
    """Every decode step but the last gathers each layer's cache to the
    surviving parents."""
    from smdistributed_modelparallel_tpu_torch.nn.utils import DecodeKVCache

    calls = []
    real = DecodeKVCache.reorder
    monkeypatch.setattr(DecodeKVCache, "reorder", lambda self, index: (calls.append(index.shape), real(self, index)))
    tmod = beam_runs[0]["nn"][2]
    port_generate(tmod, _inputs(False)[0], NEW, num_beams=BEAMS)
    assert calls == [torch.Size([2 * BEAMS])] * (HEAD["num_layers"] * (NEW - 1))
