"""Carry ``TransformerLM`` weights from the JAX package to this one.

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
