"""HF GPT-2 translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/gpt2.py``.

Parity target: reference ``torch/nn/huggingface/gpt2.py`` —
``hf_gpt2_transformer_lm_head_init_hook`` (config mapping, ``:41-82``) and
``translate_hf_state_dict_to_smdistributed_gpt2`` /
``translate_state_dict_to_hf_gpt2`` (``:344-541``).

Layernorm-placement note: the reference maps GPT-2 with its own
(pre=True, post=True) convention; in this framework's semantics GPT-2 is
``pre_layernorm=True, post_layernorm=False, final_layernorm=True`` — the
actual pre-LN GPT-2 block structure.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("GPT2LMHeadModel", "GPT2Model")


def config_to_smp(config):
    """HF GPT2Config -> DistributedTransformerLMHead kwargs."""
    if config.n_embd % config.n_head != 0:
        raise SMPValidationError(
            f"n_embd ({config.n_embd}) must be divisible by n_head ({config.n_head})."
        )
    if config.activation_function not in ("gelu_new", "gelu", "relu"):
        raise SMPValidationError(
            "Only gelu_new/gelu/relu activations are supported for GPT-2."
        )
    return {
        "num_layers": config.n_layer,
        "num_attention_heads": config.n_head,
        "attention_head_size": config.n_embd // config.n_head,
        "hidden_size": config.n_embd,
        "vocab_size": config.vocab_size,
        "activation": c.act_from_hf(config.activation_function),
        "add_lm_head": True,
        "tie_input_output_embedding": True,
        "intermediate_size": (
            config.n_inner if config.n_inner is not None else 4 * config.n_embd
        ),
        "attention_dropout_prob": config.attn_pdrop,
        "hidden_dropout_prob": config.resid_pdrop,
        "embedding_dropout_prob": config.embd_pdrop,
        "layernorm_epsilon": config.layer_norm_epsilon,
        "initializer_range": config.initializer_range,
        "use_normal_initialization": True,
        "pre_layernorm": True,
        "post_layernorm": False,
        "final_layernorm": True,
        "causal_mask_size": config.n_positions,
        "num_positions": config.n_positions,
        "scale_attention_scores": config.scale_attn_weights,
        "scale_attn_by_layer_idx": config.scale_attn_by_inverse_layer_idx,
        "query_key_layer_scaling": config.reorder_and_upcast_attn,
        "attention_in_fp32": config.reorder_and_upcast_attn,
    }


def translate_hf_state_dict(sd, config=None):
    """HF GPT-2 torch state dict -> flat '/'-keyed smp param dict."""
    sd = {k: c.to_np(v) for k, v in sd.items()}
    prefix = "transformer." if "transformer.wte.weight" in sd else ""
    n_layers = c.num_layers_in(sd, f"{prefix}h.", 1 + (1 if prefix else 0))
    D = sd[f"{prefix}wte.weight"].shape[1]
    qkv0 = sd[f"{prefix}h.0.attn.c_attn.weight"]
    H = config.n_head if config is not None else None
    if H is None:
        raise SMPValidationError("config required to infer head count.")
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
        lay = {}
        lay[f"attention/layernorm/scale"] = sd[f"{p}.ln_1.weight"]
        lay[f"attention/layernorm/bias"] = sd[f"{p}.ln_1.bias"]
        # Conv1D [in, out]: 3D out is (3, H, hd)-contiguous.
        lay["attention/qkv/kernel"] = sd[f"{p}.attn.c_attn.weight"].reshape(
            D, 3, H, hd
        )
        lay["attention/qkv/bias"] = sd[f"{p}.attn.c_attn.bias"].reshape(3, H, hd)
        lay["attention/dense/kernel"] = sd[f"{p}.attn.c_proj.weight"].reshape(
            H, hd, D
        )
        lay["attention/dense/bias"] = sd[f"{p}.attn.c_proj.bias"]
        lay["output/layernorm/scale"] = sd[f"{p}.ln_2.weight"]
        lay["output/layernorm/bias"] = sd[f"{p}.ln_2.bias"]
        lay["output/fc/kernel"] = sd[f"{p}.mlp.c_fc.weight"]
        lay["output/fc/bias"] = sd[f"{p}.mlp.c_fc.bias"]
        lay["output/proj/kernel"] = sd[f"{p}.mlp.c_proj.weight"]
        lay["output/proj/bias"] = sd[f"{p}.mlp.c_proj.bias"]
        layers.append(lay)
    stacked = c.stack_layers(layers)
    for k, v in stacked.items():
        out[f"{c.L}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF GPT-2 naming (torch tensor layout)."""
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
        g = lambda key: np.asarray(flat[f"{c.L}/{key}"][i])
        out[f"{p}.ln_1.weight"] = g("attention/layernorm/scale")
        out[f"{p}.ln_1.bias"] = g("attention/layernorm/bias")
        out[f"{p}.attn.c_attn.weight"] = g("attention/qkv/kernel").reshape(D, -1)
        out[f"{p}.attn.c_attn.bias"] = g("attention/qkv/bias").reshape(-1)
        out[f"{p}.attn.c_proj.weight"] = g("attention/dense/kernel").reshape(-1, D)
        out[f"{p}.attn.c_proj.bias"] = g("attention/dense/bias")
        out[f"{p}.ln_2.weight"] = g("output/layernorm/scale")
        out[f"{p}.ln_2.bias"] = g("output/layernorm/bias")
        out[f"{p}.mlp.c_fc.weight"] = g("output/fc/kernel")
        out[f"{p}.mlp.c_fc.bias"] = g("output/fc/bias")
        out[f"{p}.mlp.c_proj.weight"] = g("output/proj/kernel")
        out[f"{p}.mlp.c_proj.bias"] = g("output/proj/bias")
    return out
