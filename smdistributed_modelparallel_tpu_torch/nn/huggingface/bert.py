"""HF BERT translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/bert.py``.

Parity target: reference ``torch/nn/huggingface/bert.py`` (the reference
distributes ``BertEncoder`` only, keeping HF embeddings; here the whole
``BertModel`` body — embeddings with token types + post-embedding
layernorm, post-LN encoder stack — maps onto
``DistributedTransformerLMHead``; the pooler has no counterpart and is
dropped, as in the reference).

State-dict convention: the from-HF translator accepts bare ``BertModel``
keys or ``bert.``-prefixed ones; the to-HF translator EMITS bare body keys
(the registered architecture's layout — wrapper models prepend their own
prefix).
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HF_ARCHITECTURES = ("BertModel", "BertForMaskedLM", "BertForPreTraining")


def config_to_smp(config):
    """HF BertConfig -> DistributedTransformerLMHead kwargs."""
    if config.hidden_size % config.num_attention_heads != 0:
        raise SMPValidationError(
            f"hidden_size ({config.hidden_size}) must be divisible by "
            f"num_attention_heads ({config.num_attention_heads})."
        )
    if config.hidden_act not in ("gelu", "gelu_new", "relu"):
        raise SMPValidationError(
            "Only gelu/gelu_new/relu activations are supported for BERT."
        )
    return {
        "num_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "attention_head_size": config.hidden_size // config.num_attention_heads,
        "hidden_size": config.hidden_size,
        "vocab_size": config.vocab_size,
        "intermediate_size": config.intermediate_size,
        "activation": c.act_from_hf(config.hidden_act),
        "attention_dropout_prob": config.attention_probs_dropout_prob,
        "hidden_dropout_prob": config.hidden_dropout_prob,
        "embedding_dropout_prob": config.hidden_dropout_prob,
        "layernorm_epsilon": config.layer_norm_eps,
        "initializer_range": config.initializer_range,
        "use_normal_initialization": True,
        # BERT is post-LN and bidirectional.
        "pre_layernorm": False,
        "post_layernorm": True,
        "final_layernorm": False,
        "causal_mask_size": None,
        "num_positions": config.max_position_embeddings,
        "num_token_types": config.type_vocab_size,
        "use_embedding_layernorm": True,
        "add_lm_head": False,
        "query_key_layer_scaling": False,
        "attention_in_fp32": False,
    }


def translate_hf_state_dict(sd, config=None):
    """HF BERT torch state dict -> flat '/'-keyed smp param dict."""
    sd = {k: c.to_np(v) for k, v in sd.items()}
    prefix = "bert." if "bert.embeddings.word_embeddings.weight" in sd else ""
    n_layers = c.num_layers_in(
        sd, f"{prefix}encoder.layer.", 2 + (1 if prefix else 0)
    )
    if config is None:
        raise SMPValidationError("config required to infer head count.")
    H = config.num_attention_heads
    D = sd[f"{prefix}embeddings.word_embeddings.weight"].shape[1]
    hd = D // H

    e = f"{prefix}embeddings"
    out = {
        c.WTE: sd[f"{e}.word_embeddings.weight"],
        c.WPE: sd[f"{e}.position_embeddings.weight"],
        c.TTE: sd[f"{e}.token_type_embeddings.weight"],
        f"{c.EMB_LN}/scale": sd[f"{e}.LayerNorm.weight"],
        f"{c.EMB_LN}/bias": sd[f"{e}.LayerNorm.bias"],
    }
    layers = []
    for i in range(n_layers):
        p = f"{prefix}encoder.layer.{i}"
        a = f"{p}.attention"
        lay = {
            "attention/qkv/kernel": c.fused_qkv_from_separate(
                sd[f"{a}.self.query.weight"],
                sd[f"{a}.self.key.weight"],
                sd[f"{a}.self.value.weight"],
                H, hd, transpose=True,
            ),
            "attention/qkv/bias": np.stack([
                sd[f"{a}.self.query.bias"].reshape(H, hd),
                sd[f"{a}.self.key.bias"].reshape(H, hd),
                sd[f"{a}.self.value.bias"].reshape(H, hd),
            ], axis=0),
            "attention/dense/kernel": c.attn_out_from_hf(
                sd[f"{a}.output.dense.weight"], H, hd, transpose=True
            ),
            "attention/dense/bias": sd[f"{a}.output.dense.bias"],
            "attention/post_layernorm/scale": sd[f"{a}.output.LayerNorm.weight"],
            "attention/post_layernorm/bias": sd[f"{a}.output.LayerNorm.bias"],
            "output/fc/kernel": sd[f"{p}.intermediate.dense.weight"].T,
            "output/fc/bias": sd[f"{p}.intermediate.dense.bias"],
            "output/proj/kernel": sd[f"{p}.output.dense.weight"].T,
            "output/proj/bias": sd[f"{p}.output.dense.bias"],
            "output/post_layernorm/scale": sd[f"{p}.output.LayerNorm.weight"],
            "output/post_layernorm/bias": sd[f"{p}.output.LayerNorm.bias"],
        }
        layers.append(lay)
    for k, v in c.stack_layers(layers).items():
        out[f"{c.L}/{k}"] = v
    return out


def translate_state_dict_to_hf(flat, config=None):
    """Flat smp param dict -> HF BERT naming (torch tensor layout)."""
    n_layers = flat[f"{c.L}/attention/qkv/kernel"].shape[0]
    D = flat[c.WTE].shape[1]
    out = {
        "embeddings.word_embeddings.weight": flat[c.WTE],
        "embeddings.position_embeddings.weight": flat[c.WPE],
        "embeddings.token_type_embeddings.weight": flat[c.TTE],
        "embeddings.LayerNorm.weight": flat[f"{c.EMB_LN}/scale"],
        "embeddings.LayerNorm.bias": flat[f"{c.EMB_LN}/bias"],
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        a = f"{p}.attention"
        g = lambda key: np.asarray(flat[f"{c.L}/{key}"][i])
        qw, kw, vw = c.separate_qkv_from_fused(
            g("attention/qkv/kernel"), transpose=True
        )
        qb, kb, vb = (g("attention/qkv/bias")[j].reshape(-1) for j in range(3))
        out[f"{a}.self.query.weight"] = qw
        out[f"{a}.self.query.bias"] = qb
        out[f"{a}.self.key.weight"] = kw
        out[f"{a}.self.key.bias"] = kb
        out[f"{a}.self.value.weight"] = vw
        out[f"{a}.self.value.bias"] = vb
        out[f"{a}.output.dense.weight"] = g("attention/dense/kernel").reshape(-1, D).T
        out[f"{a}.output.dense.bias"] = g("attention/dense/bias")
        out[f"{a}.output.LayerNorm.weight"] = g("attention/post_layernorm/scale")
        out[f"{a}.output.LayerNorm.bias"] = g("attention/post_layernorm/bias")
        out[f"{p}.intermediate.dense.weight"] = g("output/fc/kernel").T
        out[f"{p}.intermediate.dense.bias"] = g("output/fc/bias")
        out[f"{p}.output.dense.weight"] = g("output/proj/kernel").T
        out[f"{p}.output.dense.bias"] = g("output/proj/bias")
        out[f"{p}.output.LayerNorm.weight"] = g("output/post_layernorm/scale")
        out[f"{p}.output.LayerNorm.bias"] = g("output/post_layernorm/bias")
    return out
