"""``smp.generate``'s seq2seq branch of the port against the JAX package's,
on the ``EncoderDecoderLM`` of both dialects, on the CPU in fp32.

The JAX init of each model (every leaf moved by noise from a seed, so the
logits are far from ties) is carried across by
``convert.encdec_params_from_jax``; the encoder inputs are numpy draws from
a seed. The tokens must be equal, start token first: greedy with and
without ``encoder_mask``, sampled under a threefry key, and 3 beams
returning 2 at ``length_penalty`` 0.8, without EOS, with the EOS-free
beams' most frequent token as EOS, and with the mask. The argument errors are
the JAX package's.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models import encoder_decoder as jax_ed
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch import convert
from smdistributed_modelparallel_tpu_torch.models import encoder_decoder as port_ed
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

BASE = dict(vocab_size=64, d_model=32, enc_layers=2, dec_layers=2, n_heads=4, d_ff=64, max_len=16,
            deterministic=True)
DIALECTS = {"default": {}, "t5": dict(t5_compat=True, gated_mlp=True, tie_embeddings=False)}
B, S, NEW = 2, 12, 6
BEAMS = dict(num_beams=3, num_return_sequences=2, length_penalty=0.8)
MODES = {
    "greedy": {},
    "greedy_masked": dict(encoder_mask=True),
    "sampled": dict(temperature=1.0, top_k=20, rng=True),
    "beams": BEAMS,
    "beams_eos": dict(BEAMS, eos_token_id=True),
    "beams_masked": dict(BEAMS, encoder_mask=True),
}


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _enc():
    return np.random.default_rng(3).integers(1, BASE["vocab_size"], (B, S)).astype(np.int32)


def _mask():
    keep = np.ones((B, S), np.int32)
    keep[1, -5:] = 0
    return keep


def _pair(name, noise=0.3):
    kw = dict(BASE, **DIALECTS[name])
    jmod = jax_ed.EncoderDecoderLM(**kw)
    jax_smp.init({})
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 2), jnp.int32))
    jax_smp.reset()
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + noise * rng.standard_normal(a.shape).astype(np.float32),
        params["params"])
    tmod = port_ed.EncoderDecoderLM(**kw)
    tmod.load_state_dict(convert.encdec_params_from_jax(params), strict=True)
    return jmod, params, tmod


def _args(mode, eos):
    """(JAX keyword arguments, the port's) of a mode."""
    jk, pk = {}, {}
    for key, value in MODES[mode].items():
        if key == "encoder_mask":
            jk[key], pk[key] = jnp.asarray(_mask()), torch.from_numpy(_mask())
        elif key == "rng":
            k = jax.random.key(7)
            jk[key], pk[key] = k, convert.key_from_jax(jax.random.key_data(k))
        elif key == "eos_token_id":
            jk[key] = pk[key] = eos
        else:
            jk[key] = pk[key] = value
    return jk, pk


@pytest.fixture(scope="module", params=list(DIALECTS))
def runs(request):
    """Every mode's JAX tokens for a dialect (one generate compile each), the
    port's model and the EOS the EOS runs take."""
    jmod, params, tmod = _pair(request.param)
    enc = jnp.asarray(_enc())
    jax_smp.init({})
    want, eos = {}, None
    for mode in MODES:
        jk, _ = _args(mode, eos)
        want[mode] = np.asarray(jax_smp.generate(jmod, enc, NEW, params=params, **jk))
        if mode == "beams":
            # The EOS-free beams' most frequent generated token.
            eos = collections.Counter(want[mode][..., 1:].ravel().tolist()).most_common(1)[0][0]
    jax_smp.reset()
    return tmod, want, eos


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_jax(runs, mode):
    tmod, want, eos = runs
    _, pk = _args(mode, eos)
    smp.init({}, device="cpu")
    got = smp.generate(tmod, torch.from_numpy(_enc()).long(), NEW, params=tmod.state_dict(), **pk).numpy()
    shape = (B, 2, 1 + NEW) if "num_beams" in MODES[mode] else (B, 1 + NEW)
    assert got.shape == want[mode].shape == shape
    np.testing.assert_array_equal(got, want[mode])
    assert (got[..., 0] == 0).all()  # decoder_start_token_id
    if mode == "beams_eos":
        assert (got == eos).any() and not np.array_equal(got, want["beams"])  # the EOS store took part


def test_encoder_mask_and_start_token_act(runs):
    tmod, want, _ = runs
    assert not np.array_equal(want["greedy"][1], want["greedy_masked"][1])
    smp.init({}, device="cpu")
    got = smp.generate(tmod, torch.from_numpy(_enc()).long(), NEW, params=tmod.state_dict(),
                       decoder_start_token_id=3).numpy()
    assert (got[:, 0] == 3).all()


@pytest.mark.parametrize("kwargs, match", [
    (dict(attention_mask=np.ones((B, S), np.int32)), "seq2seq models take encoder_mask, not attention_mask"),
    (dict(new=16), "decoder length"),
    (dict(enc_len=17), "encoder prompt length"),
], ids=["attention_mask", "decoder_length", "encoder_length"])
def test_argument_errors_match_jax(kwargs, match):
    kw = dict(kwargs)
    new = kw.pop("new", NEW)
    enc = np.ones((B, kw.pop("enc_len", S)), np.int32)
    jmod = jax_ed.EncoderDecoderLM(**BASE)
    tmod = port_ed.EncoderDecoderLM(**BASE)
    jax_smp.init({})
    with pytest.raises(Exception, match=match):
        jax_smp.generate(jmod, jnp.asarray(enc), new, params={}, **{k: jnp.asarray(v) for k, v in kw.items()})
    smp.init({}, device="cpu")
    with pytest.raises(SMPValidationError, match=match):
        smp.generate(tmod, torch.from_numpy(enc).long(), new, params=tmod.state_dict(),
                     **{k: torch.from_numpy(v) for k, v in kw.items()})
