"""The T5 family of ``smp.from_hf`` in the port against HuggingFace
``transformers`` and the JAX package, on the CPU in fp32.

``tests/test_huggingface.py``'s tiny T5 configs (v1.0: relu, tied; v1.1:
gated-gelu, untied), each a ``T5ForConditionalGeneration`` from seed 0 whose
weights are then moved by noise (so the logits are not near zero):
  - ``from_hf`` logits with an int64 encoder mask within atol 2e-4 / rtol
    2e-3 of ``transformers`` and within 1e-5 of the largest logit of the
    JAX package's ``from_hf``; greedy ``smp.generate`` gives ``transformers``' greedy
    ``generate`` tokens;
  - the translators: HF -> smp -> HF gives the source bit for bit, and the
    port's output equals the JAX package's key for key;
  - a full ``smp.save_checkpoint`` writes the HF names, which load into
    ``transformers`` with the same logits;
  - ``config_to_smp_layer`` declines the relative-bias block, and the
    registry's ``T5Block`` hook leaves that block as it is and swaps the
    others for ``DistributedTransformerLayer``;
  - two ``@smp.step`` steps (SGD 0.1) with T5's dropout 0.1 equal the JAX
    package's at ``tests/test_torch_dropout_step.py``'s tolerances.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn.huggingface import t5 as jax_t5
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.models import EncoderDecoderLM
from smdistributed_modelparallel_tpu_torch.nn import DistributedTransformerLayer
from smdistributed_modelparallel_tpu_torch.nn.huggingface import t5 as port_t5

transformers = pytest.importorskip("transformers")

DIALECTS = {"v1.0": dict(feed_forward_proj="relu"),
            "v1.1": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)}
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _cfg(name, **kw):
    """``tests/test_huggingface.py``'s ``_t5_cfg``."""
    base = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, num_layers=2, num_decoder_layers=2, d_ff=64,
                dropout_rate=0.0, **DIALECTS[name])
    base.update(kw)
    return transformers.T5Config(**base)


def _hf(name, noise=0.05, **kw):
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(_cfg(name, **kw)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(noise * torch.randn(p.shape, generator=g))
    return hf


def _inputs():
    rng = np.random.RandomState(0)
    enc, dec = rng.randint(0, 64, (2, 12)), rng.randint(0, 64, (2, 8))
    mask = np.ones((2, 12), dtype=np.int64)
    mask[:, -3:] = 0
    return enc, dec, mask


def _hf_logits(hf, enc, dec, mask=None):
    with torch.no_grad():
        return hf(input_ids=torch.tensor(enc), attention_mask=None if mask is None else torch.tensor(mask),
                  decoder_input_ids=torch.tensor(dec)).logits.numpy()


@pytest.mark.parametrize("name", list(DIALECTS))
def test_logits_match_hf_and_jax(name):
    hf = _hf(name)
    enc, dec, mask = _inputs()
    ref = _hf_logits(hf, enc, dec, mask)
    assert np.abs(ref).max() > 0.1
    jax_smp.init({})
    jmodel = jax_smp.from_hf(hf, deterministic=True)
    want = np.asarray(jmodel(jnp.asarray(enc), jnp.asarray(dec), encoder_mask=jnp.asarray(mask)))
    smp.init({}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    assert isinstance(model.module, EncoderDecoderLM) and model.module.t5_compat
    with torch.no_grad():
        got = model(torch.tensor(enc), torch.tensor(dec), encoder_mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    toks = smp.generate(model, torch.tensor(enc), 6, encoder_mask=torch.tensor(mask)).numpy()
    hf_toks = hf.generate(input_ids=torch.tensor(enc), attention_mask=torch.tensor(mask), max_new_tokens=6,
                          do_sample=False, num_beams=1, decoder_start_token_id=0, eos_token_id=None,
                          min_length=0).numpy()
    np.testing.assert_array_equal(toks, hf_toks)


@pytest.mark.parametrize("name", list(DIALECTS))
def test_translators_round_trip_and_equal_jax(name):
    hf = _hf(name)
    sd = hf.state_dict()
    config = hf.config
    flat = port_t5.translate_hf_state_dict(sd, config=config)
    want = jax_t5.translate_hf_state_dict(sd, config=config)
    assert flat.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(flat[key], want[key], err_msg=key)
    back = port_t5.translate_state_dict_to_hf(flat, config=config)
    want_back = jax_t5.translate_state_dict_to_hf(want, config=config)
    assert back.keys() == want_back.keys()
    for key, src in sd.items():
        if key in back:
            np.testing.assert_array_equal(np.asarray(back[key]), src.numpy(), err_msg=key)
            np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(want_back[key]), err_msg=key)
    assert set(sd) - set(back) == set()


@pytest.mark.parametrize("name", list(DIALECTS))
def test_full_save_writes_hf_names(name, tmp_path):
    hf = _hf(name)
    enc, dec, mask = _inputs()
    smp.init({}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    smp.save_checkpoint(str(tmp_path), tag="t", partial=False)
    saved = pickle.loads((tmp_path / "t").read_bytes())["model"]
    assert set(saved) == set(hf.state_dict())
    fresh = transformers.T5ForConditionalGeneration(hf.config).eval()
    fresh.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in saved.items()})
    with torch.no_grad():
        ours = model(torch.tensor(enc), torch.tensor(dec), encoder_mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(_hf_logits(fresh, enc, dec, mask), ours, rtol=0, atol=1e-5 * np.abs(ours).max())


def test_layer_hook_declines_the_relative_bias_block():
    from transformers.models.t5.modeling_t5 import T5Block

    config = _cfg("v1.0", is_decoder=False)
    assert port_t5.config_to_smp_layer(config, has_relative_attention_bias=True) is None
    kw = port_t5.config_to_smp_layer(config)
    assert kw == jax_t5.config_to_smp_layer(config)
    smp.init({}, device="cpu")
    with smp.tensor_parallelism():
        blocks = torch.nn.ModuleList([T5Block(config, has_relative_attention_bias=True, layer_idx=0),
                                      T5Block(config, has_relative_attention_bias=False, layer_idx=1)])
    model = smp.DistributedModel(blocks, device="cpu")
    assert type(model.module[0]) is T5Block
    assert isinstance(model.module[1], DistributedTransformerLayer)
    layer = DistributedTransformerLayer(**kw, deterministic=True)
    assert layer(torch.ones(1, 8, 32)).shape == (1, 8, 32)


def _loss_jax(logits, dec):
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    return jnp.mean(lse - jnp.take_along_axis(logits, dec[:, 1:, None], axis=-1)[..., 0])


def _loss_port(logits, dec):
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), dec[:, 1:].reshape(-1))


def test_two_dropout_steps_match_jax():
    hf = _hf("v1.0", dropout_rate=0.1)
    enc, dec, mask = _inputs()
    jax_smp.init({"microbatches": 1, "tensor_parallel_seed": 9})
    jmodel = jax_smp.from_hf(hf)
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jstep(model, enc, dec, mask):
        loss = _loss_jax(model(enc, dec[:, :-1], encoder_mask=mask), dec)
        model.backward(loss)
        return loss

    want = []
    for _ in range(2):
        want.append(float(jstep(jmodel, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(mask)).reduce_mean()))
        jopt.step()
    want_params = jmodel.state_dict()
    jax_smp.reset()

    smp.init({"microbatches": 1, "tensor_parallel_seed": 9}, device="cpu")
    model = smp.from_hf(hf, device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp.step
    def step(model, enc, dec, mask):
        loss = _loss_port(model(enc, dec[:, :-1], encoder_mask=mask), dec)
        model.backward(loss)
        return loss

    got = []
    for _ in range(2):
        got.append(float(step(model, torch.tensor(enc), torch.tensor(dec), torch.tensor(mask)).reduce_mean()))
        opt.step()
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    params = model.reference_state_dict()
    assert params.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(params[key], w, **PARAM_TOL, err_msg=key)
