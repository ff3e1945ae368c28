"""HF T5 translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/t5.py`` (numpy
only; the port keeps its own): ``T5ForConditionalGeneration`` and ``T5Model``
build the ``models.encoder_decoder.EncoderDecoderLM`` t5_compat dialect
(RMSNorm, bucketed relative-position bias, bias-free dense layers, unscaled
attention, the tied head's rescale), and the state dict translates both ways
between HF's names and the JAX package's flat layout, which
``DistributedModel`` maps onto the port's torch names
(``convert.encdec_params_from_jax``). Both dialects: classic v1.0 (relu FFN,
tied embeddings: t5-small ... 11B) and v1.1/flan-T5 (gated-gelu
``wi_0``/``wi_1`` FFN, untied ``lm_head``). ``config_to_smp_layer`` is the
layer-level hook (``T5Block`` -> ``DistributedTransformerLayer``), which
declines the block that holds the relative-attention bias.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("T5ForConditionalGeneration", "T5Model")
TARGET = "encdec"

ENC = "encoder/seq_layers/layer"
DEC = "decoder/seq_layers/layer"


def config_to_smp(config):
    """HF T5Config -> EncoderDecoderLM (t5_compat) kwargs. Handles both
    the classic v1.0 dialect and gated/untied v1.1 (flan-T5)."""
    act = getattr(config, "dense_act_fn", "relu")
    return {
        "gated_mlp": bool(getattr(config, "is_gated_act", False)),
        "tie_embeddings": bool(getattr(config, "tie_word_embeddings", True)),
        "vocab_size": config.vocab_size,
        "d_model": config.d_model,
        "enc_layers": config.num_layers,
        "dec_layers": config.num_decoder_layers,
        "n_heads": config.num_heads,
        "d_ff": config.d_ff,
        "d_kv": config.d_kv,
        "max_len": getattr(config, "n_positions", 512),
        "dropout": config.dropout_rate,
        "activation": c.act_from_hf(act),
        "layernorm_epsilon": config.layer_norm_epsilon,
        "relative_attention_num_buckets":
            config.relative_attention_num_buckets,
        "relative_attention_max_distance":
            getattr(config, "relative_attention_max_distance", 128),
        "initializer_range": config.initializer_factor * 1.0,
        "t5_compat": True,
    }


def _qkv_from_hf(qw, kw, vw, H, hd):
    """torch [inner, D] q/k/v -> fused [D, 3, H, hd] kernel."""
    D = qw.shape[1]
    mats = [w.T.reshape(D, H, hd) for w in (qw, kw, vw)]
    return np.stack(mats, axis=1)


def _self_attn(lay, sd, p, H, hd):
    lay["attention/layernorm/scale"] = sd[f"{p}.layer.0.layer_norm.weight"]
    lay["attention/qkv/kernel"] = _qkv_from_hf(
        sd[f"{p}.layer.0.SelfAttention.q.weight"],
        sd[f"{p}.layer.0.SelfAttention.k.weight"],
        sd[f"{p}.layer.0.SelfAttention.v.weight"],
        H, hd,
    )
    ow = sd[f"{p}.layer.0.SelfAttention.o.weight"]  # [D, inner]
    lay["attention/dense/kernel"] = ow.T.reshape(H, hd, ow.shape[0])


def _mlp(lay, sd, p, li, gated):
    lay["output/layernorm/scale"] = sd[f"{p}.layer.{li}.layer_norm.weight"]
    if gated:
        # v1.1: wi_0 is the ACTIVATED branch (our "gate"), wi_1 the linear
        # multiplier (our "fc"): out = act(gate(x)) * fc(x) @ proj.
        lay["output/gate/kernel"] = (
            sd[f"{p}.layer.{li}.DenseReluDense.wi_0.weight"].T
        )
        lay["output/fc/kernel"] = (
            sd[f"{p}.layer.{li}.DenseReluDense.wi_1.weight"].T
        )
    else:
        lay["output/fc/kernel"] = (
            sd[f"{p}.layer.{li}.DenseReluDense.wi.weight"].T
        )
    lay["output/proj/kernel"] = sd[f"{p}.layer.{li}.DenseReluDense.wo.weight"].T


def translate_hf_state_dict(sd, config=None):
    """HF T5 torch state dict -> flat '/'-keyed smp param dict."""
    if config is None:
        raise SMPValidationError("config required for T5 translation.")
    if "decoder.block.0.layer.0.SelfAttention.q.weight" not in sd:
        # family_for's model_type fallback can route any t5-typed model
        # here (e.g. T5EncoderModel) — fail with a clear error instead of
        # a KeyError mid-translation.
        raise SMPValidationError(
            "State dict is not a full T5 encoder-decoder (no decoder "
            f"blocks); supported architectures: {HF_ARCHITECTURES}."
        )
    sd = {k: c.to_np(v) for k, v in sd.items()}
    H, hd = config.num_heads, config.d_kv
    gated = bool(getattr(config, "is_gated_act", False))
    tied = bool(getattr(config, "tie_word_embeddings", True))

    out = {
        "shared_embedding/embedding": sd["shared.weight"],
        "enc_rel_bias/embedding": sd[
            "encoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"
        ],
        "dec_rel_bias/embedding": sd[
            "decoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"
        ],
        "encoder_ln/scale": sd["encoder.final_layer_norm.weight"],
        "decoder_ln/scale": sd["decoder.final_layer_norm.weight"],
    }

    enc_layers = []
    for i in range(config.num_layers):
        p = f"encoder.block.{i}"
        lay = {}
        _self_attn(lay, sd, p, H, hd)
        _mlp(lay, sd, p, 1, gated)
        enc_layers.append(lay)
    for k, v in c.stack_layers(enc_layers).items():
        out[f"{ENC}/{k}"] = v

    dec_layers = []
    for i in range(config.num_decoder_layers):
        p = f"decoder.block.{i}"
        lay = {}
        _self_attn(lay, sd, p, H, hd)
        # Cross attention (layer.1): separate q + fused kv kernels.
        D = config.d_model
        lay["crossattention/layernorm/scale"] = sd[
            f"{p}.layer.1.layer_norm.weight"
        ]
        lay["crossattention/query/kernel"] = (
            sd[f"{p}.layer.1.EncDecAttention.q.weight"].T.reshape(D, H, hd)
        )
        lay["crossattention/key_value/kernel"] = np.stack(
            [
                sd[f"{p}.layer.1.EncDecAttention.k.weight"].T.reshape(D, H, hd),
                sd[f"{p}.layer.1.EncDecAttention.v.weight"].T.reshape(D, H, hd),
            ],
            axis=1,
        )
        ow = sd[f"{p}.layer.1.EncDecAttention.o.weight"]
        lay["crossattention/dense/kernel"] = ow.T.reshape(H, hd, D)
        _mlp(lay, sd, p, 2, gated)
        dec_layers.append(lay)
    for k, v in c.stack_layers(dec_layers).items():
        out[f"{DEC}/{k}"] = v
    if not tied:
        out["lm_head/kernel"] = sd["lm_head.weight"].T
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF T5 naming (torch tensor layout)."""
    enc_qkv = flat[f"{ENC}/attention/qkv/kernel"]
    Le = enc_qkv.shape[0]
    Ld = flat[f"{DEC}/attention/qkv/kernel"].shape[0]
    D = enc_qkv.shape[1]
    inner = enc_qkv.shape[3] * enc_qkv.shape[4]

    gated = f"{ENC}/output/gate/kernel" in flat
    tied = "lm_head/kernel" not in flat
    shared = np.asarray(flat["shared_embedding/embedding"])
    out = {
        "shared.weight": shared,
        "encoder.embed_tokens.weight": shared,
        "decoder.embed_tokens.weight": shared,
        "lm_head.weight": (
            shared if tied else np.asarray(flat["lm_head/kernel"]).T
        ),
        "encoder.block.0.layer.0.SelfAttention"
        ".relative_attention_bias.weight":
            np.asarray(flat["enc_rel_bias/embedding"]),
        "decoder.block.0.layer.0.SelfAttention"
        ".relative_attention_bias.weight":
            np.asarray(flat["dec_rel_bias/embedding"]),
        "encoder.final_layer_norm.weight":
            np.asarray(flat["encoder_ln/scale"]),
        "decoder.final_layer_norm.weight":
            np.asarray(flat["decoder_ln/scale"]),
    }

    def put_self(p, stack_prefix, i):
        g = lambda key: np.asarray(flat[f"{stack_prefix}/{key}"][i])
        qkv = g("attention/qkv/kernel")          # [D, 3, H, hd]
        for j, name in enumerate(("q", "k", "v")):
            out[f"{p}.layer.0.SelfAttention.{name}.weight"] = (
                qkv[:, j].reshape(D, inner).T
            )
        out[f"{p}.layer.0.SelfAttention.o.weight"] = (
            g("attention/dense/kernel").reshape(inner, D).T
        )
        out[f"{p}.layer.0.layer_norm.weight"] = g("attention/layernorm/scale")

    def put_mlp(p, stack_prefix, i, li):
        g = lambda key: np.asarray(flat[f"{stack_prefix}/{key}"][i])
        if gated:
            out[f"{p}.layer.{li}.DenseReluDense.wi_0.weight"] = (
                g("output/gate/kernel").T
            )
            out[f"{p}.layer.{li}.DenseReluDense.wi_1.weight"] = (
                g("output/fc/kernel").T
            )
        else:
            out[f"{p}.layer.{li}.DenseReluDense.wi.weight"] = (
                g("output/fc/kernel").T
            )
        out[f"{p}.layer.{li}.DenseReluDense.wo.weight"] = g("output/proj/kernel").T
        out[f"{p}.layer.{li}.layer_norm.weight"] = g("output/layernorm/scale")

    for i in range(Le):
        p = f"encoder.block.{i}"
        put_self(p, ENC, i)
        put_mlp(p, ENC, i, 1)
    for i in range(Ld):
        p = f"decoder.block.{i}"
        put_self(p, DEC, i)
        g = lambda key: np.asarray(flat[f"{DEC}/{key}"][i])
        out[f"{p}.layer.1.EncDecAttention.q.weight"] = (
            g("crossattention/query/kernel").reshape(D, inner).T
        )
        kv = g("crossattention/key_value/kernel")  # [D, 2, H, hd]
        out[f"{p}.layer.1.EncDecAttention.k.weight"] = (
            kv[:, 0].reshape(D, inner).T
        )
        out[f"{p}.layer.1.EncDecAttention.v.weight"] = (
            kv[:, 1].reshape(D, inner).T
        )
        out[f"{p}.layer.1.EncDecAttention.o.weight"] = (
            g("crossattention/dense/kernel").reshape(inner, D).T
        )
        out[f"{p}.layer.1.layer_norm.weight"] = (
            g("crossattention/layernorm/scale")
        )
        put_mlp(p, DEC, i, 2)
    return out


def config_to_smp_layer(config, has_relative_attention_bias=False):
    """Layer-level hook (reference parity): HF T5Config (+ block flag) ->
    DistributedTransformerLayer kwargs, or None for the relative-bias
    block (left undistributed), mirroring
    ``hf_t5_transformer_layer_init_hook`` (reference ``t5.py:11-31``)."""
    if has_relative_attention_bias:
        return None
    if config.d_kv * config.num_heads != config.d_model:
        raise SMPValidationError(
            f"d_kv ({config.d_kv}) * num_heads ({config.num_heads}) must "
            f"equal d_model ({config.d_model}) for T5."
        )
    return {
        "num_attention_heads": config.num_heads,
        "attention_head_size": config.d_kv,
        "hidden_size": config.d_model,
        "intermediate_size": config.d_ff,
        "attention_dropout_prob": config.dropout_rate,
        "hidden_dropout_prob": config.dropout_rate,
        "add_cross_attention": bool(config.is_decoder),
        "causal_mask_size": config.n_positions if config.is_decoder and hasattr(config, "n_positions") else None,
        "pre_layernorm": True,
        "post_layernorm": False,
        "use_qkv_bias": False,
        "use_attn_dense_bias": False,
        "use_mlp_bias": False,
        "layernorm_type": "rms",          # exact T5 RMSNorm (goes beyond
        # the reference, which approximated with standard LayerNorm)
        "scale_attention_scores": False,  # T5 does not scale by 1/sqrt(hd)
    }
