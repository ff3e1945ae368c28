"""Shared helpers of the HuggingFace config and state-dict translators.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/common.py`` (the
translators are numpy and import no JAX; the port keeps its own copies). The
translators write the JAX package's flat '/'-keyed layout of
``smp.nn.DistributedTransformerLMHead``, per-layer tensors stacked on a
leading [num_layers] axis (the flax ``nn.scan``); ``DistributedModel`` maps
that layout onto the port's torch names (``convert.lm_head_params_from_jax``),
as it does for a checkpoint.
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.convert import to_numpy

# Flat '/'-keyed paths of DistributedTransformerLMHead parameters.
L = "transformer/seq_layers/layer"
WTE = "word_embedding/embedding"
WPE = "position_embedding/embedding"
TTE = "token_type_embedding/embedding"
EMB_LN = "embedding_layernorm"
LN_F = "ln_f"
LM_HEAD = "lm_head/kernel"


def act_from_hf(name):
    """HF activation name -> ours. HF's "gelu" is the EXACT erf form
    (ACT2FN); "gelu_new"/"gelu_pytorch_tanh" are the tanh approximation
    (our "gelu")."""
    return {
        "gelu": "gelu_erf",
        "gelu_new": "gelu",
        "gelu_pytorch_tanh": "gelu",
        "relu": "relu",
    }[name]


# torch tensor (bf16 included) or array -> numpy.
to_np = to_numpy


def stack_layers(per_layer):
    """[{key: arr} per layer] -> {key: arr stacked on a new leading axis}."""
    out = {}
    for key in per_layer[0]:
        out[key] = np.stack([d[key] for d in per_layer], axis=0)
    return out


def num_layers_in(sd, prefix, idx_pos):
    """Highest layer index + 1 for keys like '{prefix}.{i}.'."""
    last = -1
    for key in sd:
        if key.startswith(prefix):
            try:
                last = max(last, int(key.split(".")[idx_pos]))
            except (ValueError, IndexError):
                pass
    return last + 1


def fused_qkv_from_separate(qw, kw, vw, H, hd, transpose=False):
    """Separate q/k/v [D, D] (or torch [out,in] with transpose=True) ->
    our fused [D, 3, H, hd] kernel."""
    mats = []
    for w in (qw, kw, vw):
        w = to_np(w)
        if transpose:
            w = w.T  # torch Linear stores [out, in]
        D = w.shape[0]
        mats.append(w.reshape(D, H, hd))
    return np.stack(mats, axis=1)  # [D, 3, H, hd]


def separate_qkv_from_fused(kernel, transpose=False):
    """Our [D, 3, H, hd] -> three [D, D] (or [out, in] with transpose)."""
    D = kernel.shape[0]
    outs = []
    for c in range(3):
        w = kernel[:, c].reshape(D, -1)
        outs.append(w.T if transpose else w)
    return outs


def attn_out_from_hf(w, H, hd, transpose=False):
    """HF attention output proj [D_in, D_out] (Conv1D) or [out, in]
    (Linear, transpose=True) -> our [H, hd, D]."""
    w = to_np(w)
    if transpose:
        w = w.T
    D_out = w.shape[1]
    return w.reshape(H, hd, D_out)
