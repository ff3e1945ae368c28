"""``smp.from_hf`` and the HF family translators of the port against the
JAX package's and HuggingFace ``transformers``, on the CPU in fp32.

``tests/test_huggingface.py``'s tiny configs, each a randomly initialized
``transformers`` model (seed 0), go through both packages' ``smp.from_hf``:
  - logits (hidden states for BERT, RoBERTa and the ViT encoder): the port
    against the JAX package within 1e-5 (the same operations summed in other
    orders), both against HF within that file's 2e-4 / 2e-3; RoBERTa's
    pad-aware positions on left- and right-padded rows;
  - the translators: HF -> smp -> HF gives the source's tensors, and the
    port's ``translate_to_hf`` output equals the JAX package's key for key and
    bit for bit, a wrapper architecture's (``BertForMaskedLM``) included;
  - ``_match_weights``: a clean translator reports nothing, a corrupted one
    the same mismatched keys as the JAX package's, and the check is off by
    default;
  - the registry holds the HF classes; with ``transformers`` hidden,
    ``smp.init`` still works and a duck-typed model (``chip_smoke.HFModel``,
    what phase H hands ``from_hf`` on the card) gives the same logits, as it
    does beside ``transformers``; chip_smoke's published configs resolve to
    the kwargs of the ``transformers`` configs they name;
  - two ``@smp.step`` steps (SGD 0.1) of the tiny GPT-2 from ``from_hf``
    against the JAX package's: losses and updated parameters within 1e-5;
    the ViT encoder trains under ``@smp.step`` as in the JAX package;
  - a full checkpoint with ``translate_if_full``: its ``model`` dict equals
    the JAX package's for the same weights and loads into
    ``transformers.GPT2LMHeadModel`` with the same logits;
  - a T5 config builds the encoder-decoder, whose pipeline decomposition
    raises, naming the pipeline slice.
"""

import dataclasses
import logging
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import huggingface as jax_hf
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.utils.logger import get_logger as jax_logger
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.nn import huggingface as port_hf
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger as port_logger

transformers = pytest.importorskip("transformers")

LM_FAMILIES = ["gpt2", "gptj", "gptneox", "bert", "gptneo", "roberta"]
ALL_FAMILIES = LM_FAMILIES + ["vit"]
HF_CLASSES = {"gpt2": "GPT2LMHeadModel", "gptj": "GPTJForCausalLM", "gptneox": "GPTNeoXForCausalLM",
              "bert": "BertModel", "gptneo": "GPTNeoForCausalLM", "roberta": "RobertaModel", "vit": "ViTModel"}


def _tiny_configs():
    """``tests/test_huggingface.py``'s configs."""
    return {
        "gpt2": transformers.GPT2Config(n_embd=32, n_layer=2, n_head=2, vocab_size=64, n_positions=32, attn_pdrop=0.0,
                                        resid_pdrop=0.0, embd_pdrop=0.0),
        "gptj": transformers.GPTJConfig(n_embd=32, n_layer=2, n_head=2, vocab_size=64, n_positions=32, rotary_dim=8,
                                        attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0, tie_word_embeddings=False),
        "gptneox": transformers.GPTNeoXConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                              intermediate_size=64, vocab_size=64, max_position_embeddings=32,
                                              rotary_pct=0.5, tie_word_embeddings=False, attention_dropout=0.0,
                                              hidden_dropout=0.0),
        "bert": transformers.BertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                        intermediate_size=64, vocab_size=64, max_position_embeddings=32,
                                        type_vocab_size=2, attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0),
        "gptneo": transformers.GPTNeoConfig(hidden_size=32, num_layers=2, num_heads=2, vocab_size=64,
                                            max_position_embeddings=32, intermediate_size=64,
                                            attention_types=[[["global", "local"], 1]], window_size=8,
                                            attention_dropout=0.0, resid_dropout=0.0, embed_dropout=0.0),
        "roberta": transformers.RobertaConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                              intermediate_size=64, vocab_size=64, max_position_embeddings=36,
                                              type_vocab_size=1, pad_token_id=1, attention_probs_dropout_prob=0.0,
                                              hidden_dropout_prob=0.0),
        "vit": transformers.ViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                      intermediate_size=64, image_size=8, patch_size=4,
                                      attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0),
    }


def _hf_model(name, cls=None):
    torch.manual_seed(0)
    return getattr(transformers, cls or HF_CLASSES[name])(_tiny_configs()[name]).eval()


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _ids(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, 64, shape)


def _call_kwargs(name, ids, lib):
    if name in ("bert", "roberta"):
        return {"token_type_ids": lib.zeros_like(ids)}
    return {}


def _jax_out(name, hf, ids, **kw):
    jax_smp.init({})
    model = jax_smp.from_hf(hf, deterministic=True)
    j_ids = jnp.asarray(ids)
    return np.asarray(model(j_ids, **_call_kwargs(name, j_ids, jnp), **kw))


def _port_out(name, hf, ids, **kw):
    smp.init({}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    t_ids = torch.tensor(ids)
    with torch.no_grad():
        return model(t_ids, **_call_kwargs(name, t_ids, torch), **kw).numpy()


def _hf_out(name, hf, ids, **kw):
    t_ids = torch.tensor(ids)
    with torch.no_grad():
        out = hf(t_ids, **_call_kwargs(name, t_ids, torch), **kw)
    return (out.last_hidden_state if name in ("bert", "roberta") else out.logits).numpy()


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_from_hf_matches_jax_and_hf(name):
    hf = _hf_model(name)
    ids = _ids()
    got, want, ref = _port_out(name, hf, ids), _jax_out(name, hf, ids), _hf_out(name, hf, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(want, ref, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("name", ["gptneox", "gptj"])
def test_tied_from_hf_matches_jax(name):
    """A tied GPT-NeoX or GPT-J loads: the translator's ``lm_head`` entries
    have no place in the tied module and are not taken, as in the JAX
    package. GPT-J's JAX logits drop the HF head bias under a tied head
    (ROADMAP Queue 3), and the port gives the JAX package's."""
    config = _tiny_configs()[name]  # a fresh config
    config.tie_word_embeddings = True
    torch.manual_seed(0)
    hf = getattr(transformers, HF_CLASSES[name])(config).eval()
    ids = _ids()
    got, want = _port_out(name, hf, ids), _jax_out(name, hf, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_missing_parameter_raises_as_jax():
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

    smp.init({}, device="cpu")
    model = smp.from_hf(_hf_model("gpt2"), device="cpu")
    flat = model.reference_state_dict()
    flat.pop(sorted(flat)[0])
    with pytest.raises(SMPValidationError, match="Missing parameter"):
        model.load_state_dict(flat)


def test_vit_encoder_matches_jax_and_hf():
    hf = _hf_model("vit")
    hidden = np.random.RandomState(0).randn(2, 5, 32).astype(np.float32)
    jax_smp.init({})
    want = np.asarray(jax_smp.from_hf(hf, deterministic=True)(jnp.asarray(hidden)))
    smp.init({}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    assert type(model.module) is smp.nn.DistributedTransformer
    with torch.no_grad():
        got = model(torch.tensor(hidden)).numpy()
        ref = hf.encoder(torch.tensor(hidden)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    # The bare stack's checkpoint layout is the JAX package's flat keys.
    assert sorted(model.reference_state_dict()) == sorted(jax_smp.state.model.state_dict())


def test_roberta_padded_positions_match_jax_and_hf():
    hf = _hf_model("roberta")
    pad = hf.config.pad_token_id
    ids = _ids(3)
    ids[ids == pad] = pad + 1
    ids[0, :5] = pad   # left padding
    ids[1, -4:] = pad  # right padding
    keep = ids != pad
    want = _jax_out("roberta", hf, ids, attention_mask=jnp.asarray(keep)[:, None, None, :])
    got = _port_out("roberta", hf, ids, attention_mask=torch.tensor(keep)[:, None, None, :])
    ref = _hf_out("roberta", hf, ids, attention_mask=torch.tensor(keep).long())
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[keep], ref[keep], atol=2e-4, rtol=2e-3)


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("name", ALL_FAMILIES)
def test_translators_round_trip_and_match_jax(name):
    hf = _hf_model(name)
    config = hf.config
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    fam, jfam = port_hf.family_for(hf), jax_hf.family_for(hf)
    assert (fam.name, fam.architectures, fam.target) == (jfam.name, jfam.architectures, jfam.target)
    assert fam.config_to_smp(config) == jfam.config_to_smp(config)
    flat = fam.translate_from_hf(sd, config=config)
    _assert_same_dict(flat, jfam.translate_from_hf(sd, config=config))
    back = fam.translate_to_hf(flat, config=config)
    _assert_same_dict(back, jfam.translate_to_hf(flat, config=config))
    assert set(back) <= set(sd)
    for k, v in back.items():
        assert np.array_equal(np.asarray(v), sd[k]), k


def test_wrapper_architecture_export_matches_jax():
    hf = _hf_model("bert", "BertForMaskedLM")
    jax_smp.init({})
    _, jflat, jfam = jax_hf.translate_model(hf)
    smp.init({}, device="cpu")
    module, flat, fam = port_hf.translate_model(hf)
    assert next(module.parameters()).is_meta  # the weights fill it when the model is placed
    back = fam.translate_to_hf(flat, config=hf.config)
    _assert_same_dict(back, jfam.translate_to_hf(jflat, config=hf.config))
    sd = hf.state_dict()
    body = [k for k in back if "encoder.layer" in k or "embeddings." in k]
    assert body and all(k in sd for k in body)
    for k in body:
        assert np.array_equal(np.asarray(back[k]), sd[k].numpy()), k


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _logged(get_logger, fn):
    handler, logger = _Records(), get_logger()
    level = logger.level
    logger.setLevel(logging.INFO)  # the round trip's success is an info record
    logger.addHandler(handler)
    try:
        fn()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.messages


def _mismatched(messages):
    return sorted(m.split("MISMATCH ")[1].split(":")[0] for m in messages if "MISMATCH" in m)


@pytest.mark.parametrize("case", ["clean", "corrupted", "off"])
def test_match_weights_reports_as_jax(monkeypatch, case):
    hf = _hf_model("gpt2")
    cfg = {"microbatches": 1, "_match_weights": case != "off"}
    if case == "corrupted":
        for mod in (port_hf, jax_hf):
            fam = mod.families()["gpt2"]

            def corrupt(sd, config=None, _orig=fam.translate_from_hf):
                flat = dict(_orig(sd, config=config))
                key = next(iter(flat))
                flat[key] = flat[key] + 1.0
                return flat

            monkeypatch.setitem(mod.families(), "gpt2", dataclasses.replace(fam, translate_from_hf=corrupt))

    def port():
        smp.init(dict(cfg), device="cpu")
        smp.from_hf(hf, deterministic=True, device="cpu")

    def jax_side():
        jax_smp.init(dict(cfg))
        jax_smp.from_hf(hf, deterministic=True)

    got, want = _logged(port_logger, port), _logged(jax_logger, jax_side)
    if case == "off":
        assert not any("_match_weights" in m for m in got + want)
        return
    assert _mismatched(got) == _mismatched(want)
    if case == "clean":
        assert not _mismatched(got)
        assert any("translated keys round-trip against" in m for m in got)
    else:
        assert _mismatched(got) == ["lm_head.weight", "transformer.wte.weight"]  # tied
        assert any("translator pair is inconsistent" in m for m in got)


def test_registry_holds_the_hf_classes():
    smp.init({}, device="cpu")
    for name, cls in HF_CLASSES.items():
        assert smp.state.tp_registry.is_supported(getattr(transformers, cls)), name
    # An HF model built inside the context is swapped for its smp.nn module.
    with smp.tensor_parallelism():
        hf = transformers.GPT2LMHeadModel(_tiny_configs()["gpt2"])
    model = smp.DistributedModel(hf, device="cpu")
    assert type(model.module) is smp.nn.DistributedTransformerLMHead and model._tp_replaced == ["<root>"]
    kwargs = port_hf.families()["gpt2"].config_to_smp(hf.config)
    assert {k: model.module.config[k] for k in kwargs} == kwargs


def _duck(hf):
    return chip_smoke.HFModel(hf.config.to_dict(), hf.state_dict())


@pytest.mark.parametrize("name", ["gpt2", "vit"])
def test_without_transformers_a_duck_typed_model_gives_the_same_output(monkeypatch, name):
    hf = _hf_model(name)
    x = np.random.RandomState(0).randn(2, 5, 32).astype(np.float32) if name == "vit" else _ids()
    smp.init({}, device="cpu")
    with torch.no_grad():
        want = smp.from_hf(hf, device="cpu").eval()(torch.tensor(x)).numpy()
    smp.reset()
    monkeypatch.setitem(sys.modules, "transformers", None)
    smp.init({}, device="cpu")
    assert not any("transformers" in type(c).__module__ or c.__module__.startswith("transformers")
                   for c in smp.state.tp_registry._map)
    with torch.no_grad():
        got = smp.from_hf(_duck(hf), device="cpu").eval()(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ALL_FAMILIES)
def test_chip_smoke_configs_resolve_as_transformers(name):
    """Phase H's published configs hold every field the family reads, with
    ``transformers``' meaning: the same kwargs as the config class built
    from them."""
    fields = dict(chip_smoke.HF_CONFIGS[name])
    duck = chip_smoke.HFModel(fields, {})
    real = getattr(transformers, fields["architectures"][0]).config_class(
        **{k: v for k, v in fields.items() if k not in ("architectures", "model_type")})
    assert port_hf.family_for(duck).name == name
    assert port_hf.family_for(duck).config_to_smp(duck.config) == port_hf.family_for(real).config_to_smp(real)


def test_two_training_steps_match_jax():
    hf = _hf_model("gpt2")
    ids = _ids(1, (4, 16))

    jax_smp.init({"microbatches": 2})
    jmodel = jax_smp.from_hf(hf, deterministic=True)
    jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

    @jax_smp.step
    def jax_step(model, ids):
        logits = model(ids)
        loss = jnp.mean(jax_vpce(logits[:, :-1], ids[:, 1:]))
        model.backward(loss)
        return loss

    want = []
    for _ in range(2):
        want.append(float(jax_step(jmodel, jnp.asarray(ids)).reduce_mean()))
        jopt.step()
    want_params = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}

    smp.init({"microbatches": 2}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp.step
    def port_step(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    got = []
    for _ in range(2):
        got.append(float(port_step(model, torch.tensor(ids)).reduce_mean()))
        opt.step()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[1] < got[0]
    params = model.reference_state_dict()
    assert sorted(params) == sorted(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_vit_encoder_trains_under_smp_step():
    hf = _hf_model("vit")
    smp.init({"microbatches": 2}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.05), model)

    @smp.step
    def train_step(model, hidden, target):
        loss = ((model(hidden) - target) ** 2).mean()
        model.backward(loss)
        return loss

    rng = np.random.RandomState(0)
    hidden, target = torch.tensor(rng.randn(4, 5, 32), dtype=torch.float32), torch.tensor(rng.randn(4, 5, 32),
                                                                                         dtype=torch.float32)
    losses = []
    for _ in range(4):
        losses.append(float(train_step(model, hidden, target).reduce_mean()))
        opt.step()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_full_checkpoint_translates_to_hf(tmp_path):
    hf = _hf_model("gpt2")
    ids = _ids(2)
    jax_smp.init({})
    jmodel = jax_smp.from_hf(hf, deterministic=True)
    jmodel(jnp.asarray(ids))  # the staged HF weights apply at the first call
    jax_smp.save_checkpoint(str(tmp_path / "jax"), tag="t", model=jmodel, partial=False, translate_if_full=True)
    smp.init({}, device="cpu")
    model = smp.from_hf(hf, deterministic=True, device="cpu")
    smp.save_checkpoint(str(tmp_path / "port"), tag="t", partial=False)
    got, want = (pickle.loads((tmp_path / d / "t").read_bytes())["model"] for d in ("port", "jax"))
    _assert_same_dict(got, want)
    assert sorted(got) == sorted(hf.state_dict())
    fresh = transformers.GPT2LMHeadModel(_tiny_configs()["gpt2"]).eval()
    fresh.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in got.items()})
    with torch.no_grad():
        np.testing.assert_allclose(fresh(torch.tensor(ids)).logits.numpy(), model(torch.tensor(ids)).numpy(),
                                   rtol=0, atol=1e-5)
    # Without translate_if_full, or when the translator raises, the dict
    # stays in the JAX package's keys.
    smp.save_checkpoint(str(tmp_path / "raw"), tag="t", partial=False, translate_if_full=False)
    raw = pickle.loads((tmp_path / "raw" / "t").read_bytes())["model"]
    _assert_same_dict(raw, model.reference_state_dict())
    model._translate_functions = (lambda sd: {}["missing"], None)
    smp.save_checkpoint(str(tmp_path / "failed"), tag="t", partial=False)
    _assert_same_dict(pickle.loads((tmp_path / "failed" / "t").read_bytes())["model"], raw)


def test_t5_names_its_slice():
    """T5 builds now (the zoo's ``EncoderDecoderLM`` in its t5_compat
    dialect; ``tests/test_torch_hf_t5.py``); its pipeline decomposition
    names the pipeline slice."""
    from smdistributed_modelparallel_tpu_torch.models import EncoderDecoderLM

    config = transformers.T5Config(vocab_size=64, d_model=32, d_kv=8, num_heads=4, num_layers=2, d_ff=64)
    smp.init({}, device="cpu")
    model = smp.from_hf(config, device="cpu")
    assert isinstance(model.module, EncoderDecoderLM) and model.module.t5_compat
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        model.module.pipeline_spec()
