"""HF GPT-Neo translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/gptneo.py``.

Parity target: reference ``torch/nn/huggingface/gptneo.py`` —
``hf_gptneo_transformer_lm_head_init_hook`` (config mapping incl. the
``attention_types`` -> per-layer local/global expansion, ``:34-87``) and the
state-dict translators (``:146-300``).

Layernorm-placement note: as with GPT-2, the reference expresses GPT-Neo's
pre-LN blocks as (pre=True, post=True) in its own convention; in this
framework's semantics that is ``pre_layernorm=True, post_layernorm=False,
final_layernorm=True``.

Weight-layout notes: unlike GPT-2's Conv1D ([in, out]) weights, GPT-Neo
uses ``nn.Linear`` everywhere ([out, in] — transpose on the way in);
q/k/v are separate projections WITHOUT bias, the attention output
projection has bias.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("GPTNeoForCausalLM", "GPTNeoModel")


def expand_attention_types(attention_types, num_layers):
    """HF ``attention_types`` ([[["global", "local"], 6]]) -> per-layer
    tuple. Parity: reference ``gptneo.py:44-52``."""
    layers = []
    for item in attention_types:
        kinds, repeat = item
        for _ in range(repeat):
            layers.extend(kinds)
    if len(layers) != num_layers:
        raise SMPValidationError(
            f"attention_types expands to {len(layers)} layers; expected "
            f"{num_layers}."
        )
    return tuple(layers)


def config_to_smp(config):
    """HF GPTNeoConfig -> DistributedTransformerLMHead kwargs."""
    if config.hidden_size % config.num_heads != 0:
        raise SMPValidationError(
            f"hidden_size ({config.hidden_size}) must be divisible by "
            f"num_heads ({config.num_heads})."
        )
    if config.activation_function not in ("gelu_new", "gelu", "relu"):
        raise SMPValidationError(
            "Only gelu_new/gelu/relu activations are supported for GPT-Neo."
        )
    return {
        "num_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "attention_head_size": config.hidden_size // config.num_heads,
        "hidden_size": config.hidden_size,
        "vocab_size": config.vocab_size,
        "activation": c.act_from_hf(config.activation_function),
        "add_lm_head": True,
        "tie_input_output_embedding": True,
        "intermediate_size": (
            config.intermediate_size
            if config.intermediate_size is not None
            else 4 * config.hidden_size
        ),
        "attention_dropout_prob": config.attention_dropout,
        "hidden_dropout_prob": config.resid_dropout,
        "embedding_dropout_prob": config.embed_dropout,
        "layernorm_epsilon": config.layer_norm_epsilon,
        "initializer_range": config.initializer_range,
        "attention_layers_type": expand_attention_types(
            config.attention_types, config.num_layers
        ),
        "use_normal_initialization": True,
        "pre_layernorm": True,
        "post_layernorm": False,
        "final_layernorm": True,
        "causal_mask_size": config.max_position_embeddings,
        "num_positions": config.max_position_embeddings,
        "window_size": config.window_size,
        "_scale_qkv_fan_out": True,
        # GPT-Neo does NOT scale scores by 1/sqrt(hd).
        "scale_attention_scores": False,
        "attention_in_fp32": True,
        "use_qkv_bias": False,
        "mask_value": -1e9,
    }


def translate_hf_state_dict(sd, config=None):
    """HF GPT-Neo torch state dict -> flat '/'-keyed smp param dict."""
    sd = {
        k: c.to_np(v) for k, v in sd.items()
        if not (k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"))
    }
    prefix = "transformer." if "transformer.wte.weight" in sd else ""
    n_layers = c.num_layers_in(sd, f"{prefix}h.", 1 + (1 if prefix else 0))
    if config is None:
        raise SMPValidationError("config required to infer head count.")
    H = config.num_heads
    D = sd[f"{prefix}wte.weight"].shape[1]
    hd = D // H

    out = {
        c.WTE: sd[f"{prefix}wte.weight"],
        c.WPE: sd[f"{prefix}wpe.weight"],
        f"{c.LN_F}/scale": sd[f"{prefix}ln_f.weight"],
        f"{c.LN_F}/bias": sd[f"{prefix}ln_f.bias"],
    }
    layers = []
    for i in range(n_layers):
        p = f"{prefix}h.{i}"
        a = f"{p}.attn.attention"
        lay = {
            "attention/layernorm/scale": sd[f"{p}.ln_1.weight"],
            "attention/layernorm/bias": sd[f"{p}.ln_1.bias"],
            "attention/qkv/kernel": c.fused_qkv_from_separate(
                sd[f"{a}.q_proj.weight"],
                sd[f"{a}.k_proj.weight"],
                sd[f"{a}.v_proj.weight"],
                H, hd, transpose=True,
            ),
            "attention/dense/kernel": c.attn_out_from_hf(
                sd[f"{a}.out_proj.weight"], H, hd, transpose=True
            ),
            "attention/dense/bias": sd[f"{a}.out_proj.bias"],
            "output/layernorm/scale": sd[f"{p}.ln_2.weight"],
            "output/layernorm/bias": sd[f"{p}.ln_2.bias"],
            "output/fc/kernel": sd[f"{p}.mlp.c_fc.weight"].T,
            "output/fc/bias": sd[f"{p}.mlp.c_fc.bias"],
            "output/proj/kernel": sd[f"{p}.mlp.c_proj.weight"].T,
            "output/proj/bias": sd[f"{p}.mlp.c_proj.bias"],
        }
        layers.append(lay)
    for k, v in c.stack_layers(layers).items():
        out[f"{c.L}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF GPT-Neo naming (torch tensor layout)."""
    n_layers = flat[f"{c.L}/attention/qkv/kernel"].shape[0]
    D = flat[c.WTE].shape[1]
    out = {
        "transformer.wte.weight": flat[c.WTE],
        "transformer.wpe.weight": flat[c.WPE],
        "transformer.ln_f.weight": flat[f"{c.LN_F}/scale"],
        "transformer.ln_f.bias": flat[f"{c.LN_F}/bias"],
        "lm_head.weight": flat[c.WTE],
    }
    for i in range(n_layers):
        p = f"transformer.h.{i}"
        a = f"{p}.attn.attention"
        g = lambda key: np.asarray(flat[f"{c.L}/{key}"][i])
        out[f"{p}.ln_1.weight"] = g("attention/layernorm/scale")
        out[f"{p}.ln_1.bias"] = g("attention/layernorm/bias")
        qw, kw, vw = c.separate_qkv_from_fused(
            g("attention/qkv/kernel"), transpose=True
        )
        out[f"{a}.q_proj.weight"] = qw
        out[f"{a}.k_proj.weight"] = kw
        out[f"{a}.v_proj.weight"] = vw
        out[f"{a}.out_proj.weight"] = g("attention/dense/kernel").reshape(-1, D).T
        out[f"{a}.out_proj.bias"] = g("attention/dense/bias")
        out[f"{p}.ln_2.weight"] = g("output/layernorm/scale")
        out[f"{p}.ln_2.bias"] = g("output/layernorm/bias")
        out[f"{p}.mlp.c_fc.weight"] = g("output/fc/kernel").T
        out[f"{p}.mlp.c_fc.bias"] = g("output/fc/bias")
        out[f"{p}.mlp.c_proj.weight"] = g("output/proj/kernel").T
        out[f"{p}.mlp.c_proj.bias"] = g("output/proj/bias")
    return out
