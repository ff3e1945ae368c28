"""HF GPT-NeoX translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/gptneox.py``.

Parity target: reference ``torch/nn/huggingface/gptneox.py`` —
``hf_gptneox_transformer_init_hook`` and the bidirectional state-dict
translators.

GPT-NeoX structure: NeoX-style rotary on the first ``rotary_pct`` of each
head, parallel attention+MLP residual fed by TWO layernorms
(input_layernorm / post_attention_layernorm), fused qkv whose output dim is
[H, 3, hd]-interleaved (unlike GPT-2's [3, H, hd]), untied ``embed_out``
LM head without bias.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("GPTNeoXForCausalLM", "GPTNeoXModel")


def config_to_smp(config):
    """HF GPTNeoXConfig -> DistributedTransformerLMHead kwargs.

    Mirrors reference ``hf_gptneox_transformer_init_hook``
    (``torch/nn/huggingface/gptneox.py:35-92``).
    """
    if config.hidden_size % config.num_attention_heads != 0:
        raise SMPValidationError(
            f"hidden_size ({config.hidden_size}) must be divisible by "
            f"num_attention_heads ({config.num_attention_heads})."
        )
    if config.hidden_act not in ("gelu", "gelu_new", "relu"):
        raise SMPValidationError(
            "Only gelu/gelu_new/relu activations are supported for GPT-NeoX."
        )
    hd = config.hidden_size // config.num_attention_heads
    rotary_pct = getattr(config, "rotary_pct", 1.0)
    rotary_base = getattr(
        config, "rotary_emb_base", getattr(config, "rope_theta", 10000.0)
    )
    return {
        "num_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "attention_head_size": hd,
        "hidden_size": config.hidden_size,
        "vocab_size": config.vocab_size,
        "rotary_dim": int(hd * rotary_pct),
        "rotary_emb_base": float(rotary_base),
        "gpt_neox_type_rotary": True,
        "mask_value": -1e9,
        "use_positional_embedding": False,
        "parallel_attn_output": bool(getattr(config, "use_parallel_residual", True)),
        "use_lm_head_bias": False,
        "tie_input_output_embedding": bool(config.tie_word_embeddings),
        "use_attn_dense_bias": True,
        "use_qkv_bias": True,
        "final_layernorm": True,
        "single_pre_layernorm": False,
        "activation": c.act_from_hf(config.hidden_act),
        "add_lm_head": True,
        "intermediate_size": config.intermediate_size,
        "attention_dropout_prob": 0.0,
        "hidden_dropout_prob": 0.0,
        "embedding_dropout_prob": 0.0,
        "layernorm_epsilon": config.layer_norm_eps,
        "initializer_range": config.initializer_range,
        "use_normal_initialization": True,
        "pre_layernorm": True,
        "post_layernorm": False,
        "causal_mask_size": config.max_position_embeddings,
        "num_positions": config.max_position_embeddings,
        "scale_attention_scores": True,
        "_scale_qkv_fan_out": True,
        "query_key_layer_scaling": False,
        "attention_in_fp32": False,
    }


def _qkv_from_neox(w, b, H, hd):
    """HF [3D, D] weight (out dim [H, 3, hd]-interleaved) + [3D] bias ->
    our [D, 3, H, hd] kernel and [3, H, hd] bias."""
    D = w.shape[1]
    kernel = w.reshape(H, 3, hd, D).transpose(3, 1, 0, 2)
    bias = b.reshape(H, 3, hd).transpose(1, 0, 2)
    return kernel, bias


def _qkv_to_neox(kernel, bias):
    """Our [D, 3, H, hd] / [3, H, hd] -> HF [3D, D] / [3D]."""
    D = kernel.shape[0]
    w = kernel.transpose(2, 1, 3, 0).reshape(-1, D)
    b = bias.transpose(1, 0, 2).reshape(-1)
    return w, b


def translate_hf_state_dict(sd, config=None):
    """HF GPT-NeoX torch state dict -> flat '/'-keyed smp param dict."""
    sd = {k: c.to_np(v) for k, v in sd.items()}
    prefix = "gpt_neox." if "gpt_neox.embed_in.weight" in sd else ""
    n_layers = c.num_layers_in(sd, f"{prefix}layers.", 1 + (1 if prefix else 0))
    if config is None:
        raise SMPValidationError("config required to infer head count.")
    H = config.num_attention_heads
    D = sd[f"{prefix}embed_in.weight"].shape[1]
    hd = D // H

    out = {
        c.WTE: sd[f"{prefix}embed_in.weight"],
        f"{c.LN_F}/scale": sd[f"{prefix}final_layer_norm.weight"],
        f"{c.LN_F}/bias": sd[f"{prefix}final_layer_norm.bias"],
    }
    if "embed_out.weight" in sd:
        out[c.LM_HEAD] = sd["embed_out.weight"].T
    layers = []
    for i in range(n_layers):
        p = f"{prefix}layers.{i}"
        qkv_w, qkv_b = _qkv_from_neox(
            sd[f"{p}.attention.query_key_value.weight"],
            sd[f"{p}.attention.query_key_value.bias"],
            H, hd,
        )
        lay = {
            "attention/layernorm/scale": sd[f"{p}.input_layernorm.weight"],
            "attention/layernorm/bias": sd[f"{p}.input_layernorm.bias"],
            "output/layernorm/scale": sd[f"{p}.post_attention_layernorm.weight"],
            "output/layernorm/bias": sd[f"{p}.post_attention_layernorm.bias"],
            "attention/qkv/kernel": qkv_w,
            "attention/qkv/bias": qkv_b,
            "attention/dense/kernel": c.attn_out_from_hf(
                sd[f"{p}.attention.dense.weight"], H, hd, transpose=True
            ),
            "attention/dense/bias": sd[f"{p}.attention.dense.bias"],
            "output/fc/kernel": sd[f"{p}.mlp.dense_h_to_4h.weight"].T,
            "output/fc/bias": sd[f"{p}.mlp.dense_h_to_4h.bias"],
            "output/proj/kernel": sd[f"{p}.mlp.dense_4h_to_h.weight"].T,
            "output/proj/bias": sd[f"{p}.mlp.dense_4h_to_h.bias"],
        }
        layers.append(lay)
    for k, v in c.stack_layers(layers).items():
        out[f"{c.L}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF GPT-NeoX naming (torch tensor layout)."""
    n_layers = flat[f"{c.L}/attention/qkv/kernel"].shape[0]
    D = flat[c.WTE].shape[1]
    out = {
        "gpt_neox.embed_in.weight": flat[c.WTE],
        "gpt_neox.final_layer_norm.weight": flat[f"{c.LN_F}/scale"],
        "gpt_neox.final_layer_norm.bias": flat[f"{c.LN_F}/bias"],
    }
    if c.LM_HEAD in flat:
        out["embed_out.weight"] = np.asarray(flat[c.LM_HEAD]).T
    else:
        out["embed_out.weight"] = flat[c.WTE]
    for i in range(n_layers):
        p = f"gpt_neox.layers.{i}"
        g = lambda key: np.asarray(flat[f"{c.L}/{key}"][i])
        out[f"{p}.input_layernorm.weight"] = g("attention/layernorm/scale")
        out[f"{p}.input_layernorm.bias"] = g("attention/layernorm/bias")
        out[f"{p}.post_attention_layernorm.weight"] = g("output/layernorm/scale")
        out[f"{p}.post_attention_layernorm.bias"] = g("output/layernorm/bias")
        w, b = _qkv_to_neox(g("attention/qkv/kernel"), g("attention/qkv/bias"))
        out[f"{p}.attention.query_key_value.weight"] = w
        out[f"{p}.attention.query_key_value.bias"] = b
        out[f"{p}.attention.dense.weight"] = g("attention/dense/kernel").reshape(-1, D).T
        out[f"{p}.attention.dense.bias"] = g("attention/dense/bias")
        out[f"{p}.mlp.dense_h_to_4h.weight"] = g("output/fc/kernel").T
        out[f"{p}.mlp.dense_h_to_4h.bias"] = g("output/fc/bias")
        out[f"{p}.mlp.dense_4h_to_h.weight"] = g("output/proj/kernel").T
        out[f"{p}.mlp.dense_4h_to_h.bias"] = g("output/proj/bias")
    return out
