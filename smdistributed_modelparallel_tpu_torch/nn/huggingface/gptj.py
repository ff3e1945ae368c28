"""HF GPT-J translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/gptj.py``.

Parity target: reference ``torch/nn/huggingface/gptj.py`` —
``hf_gptj_transformer_init_hook`` (config mapping) and the bidirectional
state-dict translators (``translate_hf_state_dict_to_smdistributed_gptj`` /
``translate_state_dict_to_hf_gptj``).

GPT-J structure: no positional embedding (rotary on the first
``rotary_dim`` channels), a SINGLE pre-layernorm feeding attention and MLP
in parallel (``parallel_attn_output`` + ``single_pre_layernorm``), no
qkv/attn-dense biases, untied LM head WITH bias.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("GPTJForCausalLM", "GPTJModel")


def config_to_smp(config):
    """HF GPTJConfig -> DistributedTransformerLMHead kwargs.

    Mirrors reference ``hf_gptj_transformer_init_hook``
    (``torch/nn/huggingface/gptj.py:34-84``).
    """
    if config.n_embd % config.n_head != 0:
        raise SMPValidationError(
            f"n_embd ({config.n_embd}) must be divisible by n_head ({config.n_head})."
        )
    if config.activation_function not in ("gelu_new", "gelu", "relu"):
        raise SMPValidationError(
            "Only gelu_new/gelu/relu activations are supported for GPT-J."
        )
    return {
        "num_layers": config.n_layer,
        "num_attention_heads": config.n_head,
        "attention_head_size": config.n_embd // config.n_head,
        "hidden_size": config.n_embd,
        "vocab_size": config.vocab_size,
        "rotary_dim": config.rotary_dim,
        "mask_value": -1e9,
        "use_positional_embedding": False,
        "parallel_attn_output": True,
        "use_lm_head_bias": True,
        "tie_input_output_embedding": bool(config.tie_word_embeddings),
        "use_attn_dense_bias": False,
        "use_qkv_bias": False,
        "final_layernorm": True,
        "single_pre_layernorm": True,
        "activation": c.act_from_hf(config.activation_function),
        "add_lm_head": True,
        "intermediate_size": (
            config.n_inner if config.n_inner is not None else 4 * config.n_embd
        ),
        "attention_dropout_prob": config.attn_pdrop,
        "hidden_dropout_prob": config.resid_pdrop,
        "embedding_dropout_prob": config.embd_pdrop,
        "layernorm_epsilon": config.layer_norm_epsilon,
        "initializer_range": config.initializer_range,
        "use_normal_initialization": True,
        "pre_layernorm": False,
        "post_layernorm": False,
        "causal_mask_size": config.n_positions,
        "num_positions": config.n_positions,
        "scale_attention_scores": bool(getattr(config, "scale_attn_weights", True)),
        "_scale_qkv_fan_out": True,
        "query_key_layer_scaling": False,
        "attention_in_fp32": False,
    }


def translate_hf_state_dict(sd, config=None):
    """HF GPT-J torch state dict -> flat '/'-keyed smp param dict."""
    sd = {k: c.to_np(v) for k, v in sd.items()}
    prefix = "transformer." if "transformer.wte.weight" in sd else ""
    n_layers = c.num_layers_in(sd, f"{prefix}h.", 1 + (1 if prefix else 0))
    D = sd[f"{prefix}wte.weight"].shape[1]
    if config is None:
        raise SMPValidationError("config required to infer head count.")
    H = config.n_head
    hd = D // H

    out = {
        c.WTE: sd[f"{prefix}wte.weight"],
        f"{c.LN_F}/scale": sd[f"{prefix}ln_f.weight"],
        f"{c.LN_F}/bias": sd[f"{prefix}ln_f.bias"],
    }
    if "lm_head.weight" in sd:
        out[c.LM_HEAD] = sd["lm_head.weight"].T  # torch Linear [out, in]
        if "lm_head.bias" in sd:
            out["lm_head/bias"] = sd["lm_head.bias"]
    layers = []
    for i in range(n_layers):
        p = f"{prefix}h.{i}"
        lay = {
            "attention/layernorm/scale": sd[f"{p}.ln_1.weight"],
            "attention/layernorm/bias": sd[f"{p}.ln_1.bias"],
            # torch Linear [out, in]; no biases in GPT-J attention.
            "attention/qkv/kernel": c.fused_qkv_from_separate(
                sd[f"{p}.attn.q_proj.weight"],
                sd[f"{p}.attn.k_proj.weight"],
                sd[f"{p}.attn.v_proj.weight"],
                H, hd, transpose=True,
            ),
            "attention/dense/kernel": c.attn_out_from_hf(
                sd[f"{p}.attn.out_proj.weight"], H, hd, transpose=True
            ),
            "output/fc/kernel": sd[f"{p}.mlp.fc_in.weight"].T,
            "output/fc/bias": sd[f"{p}.mlp.fc_in.bias"],
            "output/proj/kernel": sd[f"{p}.mlp.fc_out.weight"].T,
            "output/proj/bias": sd[f"{p}.mlp.fc_out.bias"],
        }
        layers.append(lay)
    for k, v in c.stack_layers(layers).items():
        out[f"{c.L}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF GPT-J naming (torch tensor layout)."""
    n_layers = flat[f"{c.L}/attention/qkv/kernel"].shape[0]
    D = flat[c.WTE].shape[1]
    out = {
        "transformer.wte.weight": flat[c.WTE],
        "transformer.ln_f.weight": flat[f"{c.LN_F}/scale"],
        "transformer.ln_f.bias": flat[f"{c.LN_F}/bias"],
    }
    if c.LM_HEAD in flat:
        out["lm_head.weight"] = np.asarray(flat[c.LM_HEAD]).T
        if "lm_head/bias" in flat:
            out["lm_head.bias"] = flat["lm_head/bias"]
    else:  # tied
        out["lm_head.weight"] = flat[c.WTE]
    for i in range(n_layers):
        p = f"transformer.h.{i}"
        g = lambda key: np.asarray(flat[f"{c.L}/{key}"][i])
        out[f"{p}.ln_1.weight"] = g("attention/layernorm/scale")
        out[f"{p}.ln_1.bias"] = g("attention/layernorm/bias")
        qw, kw, vw = c.separate_qkv_from_fused(
            g("attention/qkv/kernel"), transpose=True
        )
        out[f"{p}.attn.q_proj.weight"] = qw
        out[f"{p}.attn.k_proj.weight"] = kw
        out[f"{p}.attn.v_proj.weight"] = vw
        out[f"{p}.attn.out_proj.weight"] = g("attention/dense/kernel").reshape(-1, D).T
        out[f"{p}.mlp.fc_in.weight"] = g("output/fc/kernel").T
        out[f"{p}.mlp.fc_in.bias"] = g("output/fc/bias")
        out[f"{p}.mlp.fc_out.weight"] = g("output/proj/kernel").T
        out[f"{p}.mlp.fc_out.bias"] = g("output/proj/bias")
    return out
