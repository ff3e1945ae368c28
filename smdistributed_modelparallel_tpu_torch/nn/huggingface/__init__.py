"""HuggingFace model families: ``smp.from_hf`` and the tp registry's HF
entries.

Counterpart of ``smdistributed_modelparallel_tpu/nn/huggingface/__init__.py``
with the same eight families (GPT-2, GPT-J, GPT-Neo, GPT-NeoX, BERT, RoBERTa,
ViT, T5): each maps an HF config onto ``smp.nn.DistributedTransformerLMHead``
keyword arguments (ViT's encoder onto a bare ``DistributedTransformer``, T5
onto the zoo's ``EncoderDecoderLM`` in its ``t5_compat`` dialect) and
translates an HF state dict to and from the JAX package's flat layout, which
``DistributedModel`` maps onto the port's torch names. The registry also
holds T5's layer-level hook (``T5Block`` -> ``DistributedTransformerLayer``,
declining the block that holds the relative-attention bias).

``transformers`` is optional and never imported here: ``smp.from_hf`` takes
any object with a ``config`` (its ``architectures`` or ``model_type`` name
the family) and a ``state_dict()`` of HF-named tensors, or a bare config;
where the caller has imported ``transformers``, ``smp.init`` (and
``smp.tensor_parallelism()``) also register its classes in the tp registry
(``register_predefined_hooks``). The model built from weights is
made on the meta device and takes the translated tensors when the
``DistributedModel`` places it, so no random init is spent on it. Its full
checkpoints translate back to the source's HF names (``translate_if_full``).
Under the ``_match_weights`` config key the translation is checked by a round
trip against the source state dict, key by key.
"""

import dataclasses
import sys
from dataclasses import dataclass
from typing import Callable, Optional

from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


@dataclass(frozen=True)
class HFFamily:
    name: str
    architectures: tuple
    config_to_smp: Callable
    translate_from_hf: Optional[Callable]  # hf sd -> flat smp dict
    translate_to_hf: Optional[Callable]    # flat smp dict -> hf sd
    # The module the family maps onto: "lmhead" (the full model ->
    # DistributedTransformerLMHead), "transformer" (the encoder stack ->
    # DistributedTransformer; ViT's scope) or "encdec" (T5 ->
    # models.encoder_decoder.EncoderDecoderLM).
    target: str = "lmhead"


def _target_class(target):
    from smdistributed_modelparallel_tpu_torch.nn.transformer import (
        DistributedTransformer,
        DistributedTransformerLMHead,
    )

    if target == "encdec":
        from smdistributed_modelparallel_tpu_torch.models.encoder_decoder import EncoderDecoderLM

        return EncoderDecoderLM
    return DistributedTransformer if target == "transformer" else DistributedTransformerLMHead


def _families():
    from smdistributed_modelparallel_tpu_torch.nn.huggingface import (
        bert,
        gpt2,
        gptj,
        gptneo,
        gptneox,
        roberta,
        t5,
        vit,
    )

    return {
        name: HFFamily(
            name=name,
            architectures=mod.HF_ARCHITECTURES,
            config_to_smp=mod.config_to_smp,
            translate_from_hf=mod.translate_hf_state_dict,
            translate_to_hf=mod.translate_state_dict_to_hf,
            target=getattr(mod, "TARGET", "lmhead"),
        )
        for name, mod in (("gpt2", gpt2), ("gptj", gptj), ("gptneo", gptneo), ("gptneox", gptneox),
                          ("bert", bert), ("roberta", roberta), ("vit", vit), ("t5", t5))
    }


_FAMILIES_CACHE = None


def families():
    global _FAMILIES_CACHE
    if _FAMILIES_CACHE is None:
        _FAMILIES_CACHE = _families()
    return _FAMILIES_CACHE


def _matches(cand, name, architectures):
    return cand in architectures or cand.lower().replace("-", "").replace("_", "") == name


def family_for(config_or_model):
    """The HFFamily of an HF model, a config, or an architecture name."""
    if isinstance(config_or_model, str):
        candidates = [config_or_model]
    else:
        config = getattr(config_or_model, "config", config_or_model)
        candidates = [type(config_or_model).__name__]
        candidates += list(getattr(config, "architectures", None) or [])
        mt = getattr(config, "model_type", None)  # a config class: GPT2Config -> "gpt2"
        if mt:
            candidates.append(mt)
    for fam in families().values():
        if any(_matches(cand, fam.name, fam.architectures) for cand in candidates):
            return fam
    raise SMPValidationError(
        f"No HF translation registered for {candidates}; supported architectures: "
        f"{[a for f in families().values() for a in f.architectures]}"
    )


_BODY_PREFIXES = ("bert.", "roberta.", "vit.", "transformer.", "gpt_neox.", "model.")


def _adapt_to_source_keys(to_hf, source_keys):
    """Wrap a family's to-HF translator so its output keys match a specific
    source model's layout.

    Translators emit each family's canonical layout (bare body keys for the
    encoder families, ``transformer.``-prefixed for the GPT LM-head
    families); wrapper architectures (``BertForMaskedLM`` -> ``bert.*``, a
    bare ``GPT2Model`` -> unprefixed) differ only by a body prefix, which the
    wrapper adds or strips where that makes a key match the source, so a full
    checkpoint loads back into the class ``smp.from_hf`` was given."""
    source_keys = frozenset(source_keys)

    def adapted(flat, config=None):
        fixed = {}
        for k, v in to_hf(flat, config=config).items():
            hit = k if k in source_keys else None
            for p in _BODY_PREFIXES:
                if hit is not None:
                    break
                if p + k in source_keys:
                    hit = p + k
                elif k.startswith(p) and k[len(p):] in source_keys:
                    hit = k[len(p):]
            fixed[hit or k] = v
        return fixed

    return adapted


def _match_weights_check(flat, to_hf, sd, config, name):
    """The ``_match_weights`` check: translate the distributed weights back to
    the HF layout and compare each key with the source state dict. Logs one
    warning per mismatched key (shape, or values more than 1e-5 apart) and a
    summary; returns the mismatches."""
    import numpy as np

    from smdistributed_modelparallel_tpu_torch.nn.huggingface.common import to_np

    back = to_hf(flat, config=config)
    problems, skipped, compared = [], [], 0
    for k, src in sd.items():
        if k not in back:
            # Buffers (causal masks, inv_freq) do not round-trip; weight keys
            # missing here are the translator faults this check exists for,
            # so they are counted and reported below.
            skipped.append(k)
            continue
        compared += 1
        got, want = to_np(back[k]), to_np(src)
        if got.shape != want.shape:
            problems.append(f"{k}: shape {got.shape} != {want.shape}")
            continue
        diff = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))) if got.size else 0.0
        if diff > 1e-5:
            problems.append(f"{k}: max |diff| {diff:.3e}")
    for p in problems:
        logger.warning("_match_weights [%s]: MISMATCH %s", name, p)
    if compared == 0:
        logger.warning(
            "_match_weights [%s]: NO source keys round-tripped (%d skipped: %s...) — the to-HF translator "
            "emits none of the source layout's keys, so nothing was verified.", name, len(skipped), skipped[:5])
    elif problems:
        logger.warning("_match_weights [%s]: %d of %d translated keys do not match the source model — the "
                       "translator pair is inconsistent.", name, len(problems), compared)
    else:
        logger.info("_match_weights [%s]: all %d translated keys round-trip against the source model (%d source "
                    "keys skipped as untranslated buffers).", name, compared, len(skipped))
    return problems


def translate_model(model_or_config, **overrides):
    """``(module, flat, family)`` for an HF model or config: the smp.nn module
    of its config (``overrides`` added to the keyword arguments), the
    translated state dict (None for a bare config) and the family, whose
    to-HF translator emits the source's own keys. A module with weights to
    come is built on the meta device."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    fam = family_for(model_or_config)
    config = getattr(model_or_config, "config", model_or_config)
    kwargs = fam.config_to_smp(config)
    kwargs.update(overrides)
    flat = None
    if hasattr(model_or_config, "state_dict"):
        sd = model_or_config.state_dict()
        flat = fam.translate_from_hf(sd, config=config)
        adapted_to_hf = _adapt_to_source_keys(fam.translate_to_hf, sd.keys())
        if state.initialized and state.cfg._match_weights:
            _match_weights_check(flat, adapted_to_hf, sd, config, fam.name)
        fam = dataclasses.replace(fam, translate_to_hf=adapted_to_hf)
        kwargs.setdefault("device", "meta")
    return _target_class(fam.target)(**kwargs), flat, fam


def register_predefined_hooks(registry):
    """Register the HF classes of the families in the tp registry, their init
    hooks mapping the config. Skipped, without an error, while
    ``transformers`` is not imported (or absent): no HF model exists to mark
    yet, and its import costs seconds. ``smp.init`` and the
    ``smp.tensor_parallelism()`` context call it, so a model built inside
    the context after ``import transformers`` is covered."""
    transformers = sys.modules.get("transformers")
    if transformers is None:
        return

    for fam in families().values():
        target_cls = _target_class(fam.target)
        for arch in fam.architectures:
            hf_cls = getattr(transformers, arch, None)
            if hf_cls is None:
                continue

            def _init_hook(config, _fam=fam, **kw):
                out = _fam.config_to_smp(config)
                out.update(kw)
                return (), out

            # No translate_functions: the registry keys them by distributed
            # class, which the families share; smp.from_hf hands each model
            # its own.
            registry.register(hf_cls, target_cls, init_hook=_init_hook)

    # T5's layer-level hook, beside the full-model family: T5Block ->
    # DistributedTransformerLayer; the hook declines (returns None for) the
    # block that holds the relative-attention bias, which stays as it is.
    t5_block = getattr(getattr(getattr(getattr(transformers, "models", None), "t5", None), "modeling_t5", None),
                       "T5Block", None)
    if t5_block is not None:
        from smdistributed_modelparallel_tpu_torch.nn.huggingface import t5
        from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLayer

        def _t5_init_hook(config, has_relative_attention_bias=False, layer_idx=None, **kw):
            # layer_idx: HF's T5Stack numbers its blocks; a stack hands the
            # layer its index at call time instead.
            out = t5.config_to_smp_layer(config, has_relative_attention_bias)
            if out is None:
                return None
            out.update(kw)
            return (), out

        registry.register(t5_block, DistributedTransformerLayer, init_hook=_t5_init_hook)


def from_hf(model_or_config, rngs=("dropout",), device=None, **overrides):
    """``smp.from_hf(hf_model_or_config)``: an ``smp.DistributedModel`` on
    ``device`` (None: as ``DistributedModel`` resolves it) of the family's
    smp.nn module, holding the translated HF weights (random ones for a bare
    config), whose full checkpoints translate back to the source's HF names.
    ``overrides`` are the module's keyword arguments (e.g.
    ``fused_bias_gelu=True``)."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.model import DistributedModel
    from smdistributed_modelparallel_tpu_torch.nn.transformer import refuse_tp

    refuse_tp("smp.from_hf")
    module, flat, fam = translate_model(model_or_config, **overrides)
    if flat is not None:
        if state.loaded_model_state is not None:
            logger.warning("Overwriting previously staged checkpoint state with HF weights.")
        state.loaded_model_state = flat
    try:
        return DistributedModel(module, device=device, rngs=rngs,
                                translate_functions=(fam.translate_to_hf, fam.translate_from_hf))
    finally:
        if flat is not None and state.loaded_model_state is flat:  # the model failed before taking them
            state.loaded_model_state = None
