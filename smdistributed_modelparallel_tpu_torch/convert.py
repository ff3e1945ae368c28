"""Carry ``TransformerLM`` and ``DistributedTransformerLMHead`` weights from
the JAX package to this one.

``params_from_jax`` maps the flax parameter tree of
``smdistributed_modelparallel_tpu.models.transformer_lm.TransformerLM``
(as numpy arrays) onto the ``state_dict`` of this package's
``TransformerLM``:
  - ``layers/block/...`` leaves carry a leading [n_layers] axis (flax
    ``nn.scan``); layer i becomes ``layers.<i>....``;
  - a flax ``Dense`` kernel is [in, out], a torch ``Linear`` weight
    [out, in]: kernels are transposed;
  - LayerNorm ``scale`` is ``weight``; embeddings are ``embedding`` ->
    ``weight``; the tied head has no weight of its own (it reads
    ``wte.weight``), an untied one is ``lm_head``.

``lm_head_params_from_jax`` does the same for the flax tree of
``smdistributed_modelparallel_tpu.nn.transformer.DistributedTransformerLMHead``
onto this package's ``nn.transformer.DistributedTransformerLMHead``, whose
layer leaves sit under ``transformer/seq_layers/layer/`` with the leading
[num_layers] axis. Multi-axis kernels become ``nn.Linear`` weights: the qkv
kernel [D, 3, H, hd] is flattened to [D, 3*H*hd] (columns (c, h, k)) and
transposed, the output projection [H, hd, D] flattened to [H*hd, D] and
transposed, and their biases flattened. A leaf it does not know raises.

``quant_state_from_jax`` carries the fp8 delayed-scaling state
(``QuantState.state_dict()``) across.
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if not hasattr(tree, "items"):
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _leaf(path, value):
    """(torch name suffix, tensor) for one flax leaf."""
    *mods, kind = path.split("/")
    arr = np.asarray(value)
    if kind == "kernel":
        name, arr = "weight", arr.T
    elif kind in ("scale", "embedding"):
        name = "weight"
    elif kind == "bias":
        name = "bias"
    else:
        raise KeyError(f"unexpected flax leaf {path!r}")
    return ".".join(mods + [name]), torch.tensor(arr)


def params_from_jax(params):
    """flax params (nested dict or '/'-joined flat dict of arrays) ->
    ``state_dict`` of the port's ``TransformerLM``."""
    out = {}
    for path, value in _flatten(params).items():
        if path.startswith("layers/block/"):
            rest = path.removeprefix("layers/block/")
            stacked = np.asarray(value)
            for i in range(stacked.shape[0]):
                name, t = _leaf(rest, stacked[i])
                out[f"layers.{i}.{name}"] = t
        else:
            name, t = _leaf(path, value)
            out[name] = t
    return out


# Kernels of DistributedTransformerLMHead's tree by module path, with the
# number of leading (input) axes each contracts; every other axis is output.
_LMHEAD_KERNELS = {
    "attention/qkv": 1,             # [D, 3, H, hd]
    "attention/dense": 2,           # [H, hd, D]
    "crossattention/query": 1,      # [D, H, hd]
    "crossattention/key_value": 1,  # [D, 2, H, hd]
    "crossattention/dense": 2,      # [H, hd, D]
    "output/fc": 1,                 # [D, F]
    "output/gate": 1,               # [D, F]
    "output/proj": 1,               # [F, D]
    "lm_head": 1,                   # [D, V]
}
_LMHEAD_NORMS = {
    "attention/layernorm", "attention/post_layernorm", "crossattention/layernorm",
    "crossattention/post_layernorm", "output/layernorm", "output/post_layernorm", "ln_f",
    "embedding_layernorm",
}
_LMHEAD_EMBEDDINGS = {"word_embedding", "position_embedding", "token_type_embedding"}
_LAYER_PREFIX = "transformer/seq_layers/layer/"


def _lm_head_leaf(path, value):
    """(torch name, tensor) for one leaf of DistributedTransformerLMHead's
    tree (the layer axis already taken off)."""
    mod, kind = path.rsplit("/", 1)
    arr = np.asarray(value)
    if kind == "kernel" and mod in _LMHEAD_KERNELS:
        n_in = _LMHEAD_KERNELS[mod]
        arr = arr.reshape(int(np.prod(arr.shape[:n_in])), -1).T
        name = "weight"
    elif kind == "bias" and (mod in _LMHEAD_KERNELS or mod in _LMHEAD_NORMS):
        arr, name = arr.reshape(-1), "bias"
    elif kind == "scale" and mod in _LMHEAD_NORMS:
        name = "weight"
    elif kind == "embedding" and mod in _LMHEAD_EMBEDDINGS:
        name = "weight"
    else:
        raise KeyError(f"unexpected DistributedTransformerLMHead leaf {path!r}")
    return f"{mod.replace('/', '.')}.{name}", torch.tensor(np.ascontiguousarray(arr))


def lm_head_params_from_jax(params):
    """flax params of ``DistributedTransformerLMHead`` (nested dict or
    '/'-joined flat dict of arrays) -> ``state_dict`` of the port's
    ``DistributedTransformerLMHead``."""
    out = {}
    for path, value in _flatten(params).items():
        if path.startswith(_LAYER_PREFIX):
            stacked = np.asarray(value)
            for i in range(stacked.shape[0]):
                name, t = _lm_head_leaf(path.removeprefix(_LAYER_PREFIX), stacked[i])
                out[f"transformer.seq_layers.{i}.{name}"] = t
        else:
            name, t = _lm_head_leaf(path, value)
            out[name] = t
    return out


def quant_state_from_jax(sd):
    """The JAX package's ``QuantState.state_dict()`` (numpy) -> the port's
    ``quant.QuantState`` state dict, for ``load_state_dict``. Both keep the
    same format (fp32 ``amax_history`` [slots, history], ``scale`` [slots]
    and the ``slots`` names), so this checks the shapes and copies; the
    slot-keyed restore happens in ``load_state_dict``."""
    slots = [str(s) for s in sd["slots"]]
    hist = np.array(sd["amax_history"], np.float32)
    scale = np.array(sd["scale"], np.float32)
    if hist.ndim != 2 or hist.shape[0] != len(slots) or scale.shape != (len(slots),):
        raise ValueError(f"malformed QuantState: amax_history {hist.shape}, scale {scale.shape}, "
                         f"{len(slots)} slots")
    return {"amax_history": hist, "scale": scale, "slots": slots}
