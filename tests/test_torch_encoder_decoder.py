"""The port's ``models.encoder_decoder`` against the JAX package's, on the
CPU in fp32.

The same weights (a JAX init moved by noise from a seed, carried across by
``convert.encdec_params_from_jax``) and inputs (numpy draws from a seed):
  - ``relative_position_bucket``: bit-equal over [-1000, 1000), both
    directions;
  - logits of both dialects (the default with learned positions, and
    ``t5_compat``; gated and untied; a ``d_kv`` apart from ``d_model / H``
    with the vocab-split ``DistributedEmbedding``)
    under 2-D int, 2-D bool and 4-D additive float encoder masks, within
    1e-5 of the largest logit;
  - two ``@smp.step`` steps (SGD 0.1, 2 microbatches) with dropout 0.1 from
    the JAX package's own init: losses and parameters at
    ``tests/test_torch_dropout_step.py``'s tolerances (the dropout masks come
    from the JAX scopes, ``decoder/.../crossattention`` included);
  - ``activation_checkpointing``: the step's gradients equal the unchecked
    step's (the encoder's too: the decoder layers' recompute reads the same
    cross states);
  - a partial checkpoint of the port resumes in the JAX package to the same
    logits, and in the port bit for bit;
  - ``pipeline_spec`` names the pipeline slice.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models import encoder_decoder as jax_ed
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch import convert
from smdistributed_modelparallel_tpu_torch.models import encoder_decoder as port_ed

BASE = dict(vocab_size=64, d_model=32, enc_layers=2, dec_layers=2, n_heads=4, d_ff=64, max_len=16)
VARIANTS = {
    "default": {},
    "default_dkv": dict(d_kv=16, distribute_embedding=True),
    "t5": dict(t5_compat=True),
    "t5_gated_untied": dict(t5_compat=True, gated_mlp=True, tie_embeddings=False, activation="gelu_erf"),
}
B, S, TD = 2, 12, 8
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
SEED = 5  # tensor_parallel_seed of both packages


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], shape).astype(np.int32)


def _masks():
    keep = np.ones((B, S), np.int32)
    keep[1, -4:] = 0
    additive = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return {"int": keep, "bool": keep.astype(bool), "float": additive}


def _params(jmod, seed=0, noise=0.3):
    jax_smp.init({})
    params = jax.jit(jmod.init)(jax.random.key(seed), jnp.asarray(_ids(0, (B, S))),
                                jnp.asarray(_ids(1, (B, TD))))["params"]
    jax_smp.reset()
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32), params)


def _port(kw, params):
    mod = port_ed.EncoderDecoderLM(**kw)
    mod.load_state_dict(convert.encdec_params_from_jax(params), strict=True)
    return mod


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
def test_relative_position_bucket_is_bit_equal(bidirectional):
    rel = np.arange(-1000, 1000, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=32, max_distance=128)
    want = np.asarray(jax_ed.relative_position_bucket(jnp.asarray(rel), **kw))
    got = port_ed.relative_position_bucket(torch.from_numpy(rel).long(), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def variant_params():
    return {name: _params(jax_ed.EncoderDecoderLM(**BASE, **extra)) for name, extra in VARIANTS.items()}


@pytest.mark.parametrize("mask", ["int", "bool", "float"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_match_jax(variant_params, name, mask):
    kw = dict(BASE, **VARIANTS[name], deterministic=True)
    params = variant_params[name]
    enc, dec, m = _ids(2, (B, S)), _ids(3, (B, TD)), _masks()[mask]
    jax_smp.init({})
    want = np.asarray(jax_ed.EncoderDecoderLM(**kw).apply({"params": params}, jnp.asarray(enc), jnp.asarray(dec),
                                                          jnp.asarray(m)))
    with torch.no_grad():
        got = _port(kw, params)(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # The mask acts: the padded row's logits move without it.
    with torch.no_grad():
        bare = _port(kw, params)(torch.from_numpy(enc).long(), torch.from_numpy(dec).long())
    assert np.abs(bare[1].numpy() - got[1].numpy()).max() > 1e-4
    np.testing.assert_allclose(bare[0].numpy(), got[0].numpy(), rtol=0, atol=1e-5 * np.abs(want).max())


def _loss_jax(logits, dec):
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, dec[:, 1:, None], axis=-1)[..., 0]
    return jnp.mean(lse - tgt)


def _loss_port(logits, dec):
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), dec[:, 1:].reshape(-1))


def _jax_train(kw, enc, dec, mask, steps=2):
    """``steps`` SGD(0.1) steps of the JAX package from its own init:
    ``(initial parameters, (losses, parameters))`` in the port's names."""
    jax_smp.init({"microbatches": 2, "tensor_parallel_seed": SEED})
    jmodel = jax_smp.DistributedModel(jax_ed.EncoderDecoderLM(**kw))
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def train(model, enc, dec, mask):
        loss = _loss_jax(model(enc, dec[:, :-1], mask), dec)
        model.backward(loss)
        return loss

    def tree(t):
        return convert.encdec_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(t)))

    losses, init = [], None
    for _ in range(steps):
        losses.append(float(train(jmodel, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(mask)).reduce_mean()))
        init = init or tree(jmodel.params)  # the parameters change at jopt.step()
        jopt.step()
    out = tree(jmodel.params)
    jax_smp.reset()
    return init, (losses, out)


def _port_model(kw, state_dict, cfg=None):
    smp.init({"microbatches": 2, "tensor_parallel_seed": SEED, **(cfg or {})}, device="cpu")
    module = port_ed.EncoderDecoderLM(**kw)
    module.load_state_dict(state_dict, strict=True)
    model = smp.DistributedModel(module, device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp.step
    def train(model, enc, dec, mask):
        loss = _loss_port(model(enc, dec[:, :-1], mask), dec)
        model.backward(loss)
        return loss

    return model, opt, train


def _batch(seed=4):
    enc, dec = _ids(seed, (4, S)), _ids(seed + 1, (4, TD))
    mask = np.ones((4, S), np.int32)
    mask[1, -5:] = 0
    mask[3, -2:] = 0
    return enc, dec, mask


def _tensors(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


@pytest.mark.parametrize("name", ["default", "t5"])
def test_dropout_steps_match_jax(name):
    kw = dict(BASE, **VARIANTS[name], dropout=0.1)
    enc, dec, mask = _batch()
    init, (want_losses, want_params) = _jax_train(kw, enc, dec, mask)
    model, opt, train = _port_model(kw, init)
    losses = []
    for _ in range(2):
        losses.append(float(train(model, *_tensors(enc, dec, mask)).reduce_mean()))
        opt.step()
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    got = model.state_dict()
    assert got.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), **PARAM_TOL, err_msg=key)
    # Dropout acted: the eval-mode loss of the same weights differs.
    model.eval()
    with torch.no_grad():
        e, d, m = _tensors(enc, dec, mask)
        assert abs(float(_loss_port(model(e, d[:, :-1], m), d)) - losses[-1]) > 1e-4


def test_checkpointed_gradients_equal_unchecked(variant_params):
    kw = dict(BASE, **VARIANTS["t5"], dropout=0.1)
    state = convert.encdec_params_from_jax(variant_params["t5"])
    grads = {}
    for ckpt in (False, True):
        model, _, train = _port_model(dict(kw, activation_checkpointing=ckpt), state)
        train(model, *_tensors(*_batch(6)))
        grads[ckpt] = model.grads
        smp.reset()
    assert grads[True].keys() == grads[False].keys()
    for key, g in grads[False].items():
        torch.testing.assert_close(grads[True][key], g, rtol=0, atol=1e-6, msg=key)
    assert float(grads[True]["encoder.seq_layers.0.attention.qkv.weight"].abs().max()) > 0


def test_partial_checkpoint_resumes_in_jax_and_port(variant_params, tmp_path):
    root = str(tmp_path)
    kw = dict(BASE, **VARIANTS["default"], deterministic=True)
    enc, dec, mask = _batch(8)
    smp.init({}, device="cpu")
    model = smp.DistributedModel(_port(kw, variant_params["default"]), device="cpu")
    with torch.no_grad():
        want = model(*_tensors(enc, dec, mask)).numpy()
    saved = model.state_dict()
    smp.save_checkpoint(root, tag="p")
    smp.reset()

    smp.init({}, device="cpu")
    smp.resume_from_checkpoint(root, tag="p")
    again = smp.DistributedModel(port_ed.EncoderDecoderLM(**kw), device="cpu")
    for key, t in saved.items():
        assert torch.equal(again.state_dict()[key], t), key
    smp.reset()

    jax_smp.init({})
    jax_smp.resume_from_checkpoint(root, tag="p")
    jmodel = jax_smp.DistributedModel(jax_ed.EncoderDecoderLM(**kw))
    got = np.asarray(jmodel(jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_pipeline_spec_names_its_slice():
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        port_ed.t5_style(enc_layers=1, dec_layers=1, d_model=32, n_heads=4, d_kv=8, d_ff=64, vocab_size=64,
                         device="meta").pipeline_spec()
    assert port_ed.t5_style_3b(device="meta").num_attention_heads == 32
