"""HF ViT translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/vit.py``.

Parity target: reference ``torch/nn/huggingface/vit.py`` —
``hf_vit_encoder_init_hook`` (``:33-51``) + encoder state-dict translators.
Scope matches the reference: the ENCODER stack only (``ViTEncoder`` ->
``DistributedTransformer``); patch/CLS/position embeddings, the final
layernorm, and the pooler stay outside (they are elementwise/embedding
work with no TP dimension worth distributing).

The family's ``target`` is therefore "transformer": ``translate_model``
builds a bare ``DistributedTransformer`` taking [B, tokens, D] hidden
states, and the flat key space is rooted at ``seq_layers/layer``.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("ViTModel", "ViTForImageClassification")
TARGET = "transformer"

# DistributedTransformer standalone: no "transformer/" root.
L_ENC = "seq_layers/layer"


def config_to_smp(config):
    """HF ViTConfig -> DistributedTransformer kwargs (reference
    ``hf_vit_encoder_init_hook``)."""
    if config.hidden_size % config.num_attention_heads != 0:
        raise SMPValidationError(
            f"hidden_size ({config.hidden_size}) must be divisible by "
            f"num_attention_heads ({config.num_attention_heads})."
        )
    if config.hidden_act not in ("gelu", "gelu_new", "relu"):
        raise SMPValidationError(
            "Only gelu/gelu_new/relu activations are supported for ViT."
        )
    return {
        "num_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "attention_head_size": config.hidden_size // config.num_attention_heads,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "activation": c.act_from_hf(config.hidden_act),
        "hidden_dropout_prob": config.hidden_dropout_prob,
        "attention_dropout_prob": config.attention_probs_dropout_prob,
        "initializer_range": config.initializer_range,
        "layernorm_epsilon": config.layer_norm_eps,
        "scale_attention_scores": True,
        # ViT blocks are pre-LN (layernorm_before / layernorm_after);
        # bidirectional (no causal mask).
        "pre_layernorm": True,
        "post_layernorm": False,
        "causal_mask_size": None,
        "use_qkv_bias": config.qkv_bias,
    }


def translate_hf_state_dict(sd, config=None):
    """HF ViT torch state dict (ViTModel or the bare encoder) -> flat
    '/'-keyed smp param dict for DistributedTransformer."""
    sd = {k: c.to_np(v) for k, v in sd.items()}
    prefix = next(
        (
            p for p in ("vit.encoder.layer.", "encoder.layer.", "layer.")
            if any(k.startswith(p) for k in sd)
        ),
        None,
    )
    if prefix is None:
        raise SMPValidationError("No ViT encoder layers found in state dict.")
    n_layers = c.num_layers_in(sd, prefix, prefix.count("."))
    if config is None:
        raise SMPValidationError("config required to infer head count.")
    H = config.num_attention_heads
    D = sd[f"{prefix}0.attention.output.dense.weight"].shape[0]
    hd = D // H

    layers = []
    for i in range(n_layers):
        p = f"{prefix}{i}"
        a = f"{p}.attention.attention"
        lay = {
            "attention/layernorm/scale": sd[f"{p}.layernorm_before.weight"],
            "attention/layernorm/bias": sd[f"{p}.layernorm_before.bias"],
            "attention/qkv/kernel": c.fused_qkv_from_separate(
                sd[f"{a}.query.weight"],
                sd[f"{a}.key.weight"],
                sd[f"{a}.value.weight"],
                H, hd, transpose=True,
            ),
            "attention/dense/kernel": c.attn_out_from_hf(
                sd[f"{p}.attention.output.dense.weight"], H, hd, transpose=True
            ),
            "attention/dense/bias": sd[f"{p}.attention.output.dense.bias"],
            "output/layernorm/scale": sd[f"{p}.layernorm_after.weight"],
            "output/layernorm/bias": sd[f"{p}.layernorm_after.bias"],
            "output/fc/kernel": sd[f"{p}.intermediate.dense.weight"].T,
            "output/fc/bias": sd[f"{p}.intermediate.dense.bias"],
            "output/proj/kernel": sd[f"{p}.output.dense.weight"].T,
            "output/proj/bias": sd[f"{p}.output.dense.bias"],
        }
        if f"{a}.query.bias" in sd:  # absent when config.qkv_bias=False
            lay["attention/qkv/bias"] = np.stack([
                sd[f"{a}.query.bias"].reshape(H, hd),
                sd[f"{a}.key.bias"].reshape(H, hd),
                sd[f"{a}.value.bias"].reshape(H, hd),
            ], axis=0)
        layers.append(lay)
    out = {}
    for k, v in c.stack_layers(layers).items():
        out[f"{L_ENC}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF ViT encoder naming (torch layout)."""
    n_layers = flat[f"{L_ENC}/attention/qkv/kernel"].shape[0]
    D = flat[f"{L_ENC}/attention/dense/bias"].shape[1]
    has_bias = f"{L_ENC}/attention/qkv/bias" in flat
    out = {}
    for i in range(n_layers):
        # Bare body keys — the registered ViTModel layout (wrapper models
        # like ViTForImageClassification prepend "vit." themselves).
        p = f"encoder.layer.{i}"
        a = f"{p}.attention.attention"
        g = lambda key: np.asarray(flat[f"{L_ENC}/{key}"][i])
        out[f"{p}.layernorm_before.weight"] = g("attention/layernorm/scale")
        out[f"{p}.layernorm_before.bias"] = g("attention/layernorm/bias")
        qw, kw, vw = c.separate_qkv_from_fused(
            g("attention/qkv/kernel"), transpose=True
        )
        out[f"{a}.query.weight"] = qw
        out[f"{a}.key.weight"] = kw
        out[f"{a}.value.weight"] = vw
        if has_bias:
            qb, kb, vb = (
                g("attention/qkv/bias")[j].reshape(-1) for j in range(3)
            )
            out[f"{a}.query.bias"] = qb
            out[f"{a}.key.bias"] = kb
            out[f"{a}.value.bias"] = vb
        out[f"{p}.attention.output.dense.weight"] = (
            g("attention/dense/kernel").reshape(-1, D).T
        )
        out[f"{p}.attention.output.dense.bias"] = g("attention/dense/bias")
        out[f"{p}.layernorm_after.weight"] = g("output/layernorm/scale")
        out[f"{p}.layernorm_after.bias"] = g("output/layernorm/bias")
        out[f"{p}.intermediate.dense.weight"] = g("output/fc/kernel").T
        out[f"{p}.intermediate.dense.bias"] = g("output/fc/bias")
        out[f"{p}.output.dense.weight"] = g("output/proj/kernel").T
        out[f"{p}.output.dense.bias"] = g("output/proj/bias")
    return out
