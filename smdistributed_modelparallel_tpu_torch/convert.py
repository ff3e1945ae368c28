"""Carry ``TransformerLM``, ``DistributedTransformerLMHead`` and
``EncoderDecoderLM`` weights between the JAX package and this one.

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
(``QuantState.state_dict()``) across, and ``key_from_jax``/``key_to_jax`` a
random key: the port's key (``utils/random``) is the two uint32 words of
``jax.random.key_data``, so the same key gives the same dropout masks and
sampled tokens in both packages.

``kv_pools_from_jax`` and ``kv_pools_to_jax`` carry the serving engine's
paged KV pools both ways: the JAX engine's cache tree
``{"layers": {"block": {"attn": {"pool_key", "pool_value"}}}}``, each leaf
[n_layers, num_blocks, block_tokens, H, hd] (flax ``nn.scan`` stacks the
layers), under ``SMP_KV_QUANT=int8`` with ``scale_key``/``scale_value``
[n_layers, num_blocks, H] beside the int8 pools, against the port's
per-layer pools (``ServingEngine.kv_pools()``), bit for bit.

A ``DistributedMoE`` in a layer (``num_experts > 0``) keeps the flax leaves
as they are, both ways: ``output/router/kernel`` [D, E], ``output/fc/kernel``
[E, D, F] and ``bias`` [E, F], ``output/proj/kernel`` [E, F, D] and ``bias``
[E, D] become ``output.router.kernel``, ``output.fc.kernel``, ... .

``encdec_params_from_jax`` and ``encdec_params_to_jax`` do the same for
``models.encoder_decoder.EncoderDecoderLM``: its two stacks
(``encoder/seq_layers/layer/``, ``decoder/seq_layers/layer/``, the latter
with ``crossattention``), ``shared_embedding``, the relative-bias tables
(``enc_rel_bias``, ``dec_rel_bias``) or position tables, ``encoder_ln``,
``decoder_ln`` and an untied ``lm_head``.

``transformer_params_from_jax`` and ``transformer_params_to_jax`` do the
same for a bare ``DistributedTransformer`` (the ViT encoder's module), whose
flax leaves sit under ``seq_layers/layer/``: the LM head's map of its
``transformer`` subtree.

``params_to_jax`` and ``lm_head_params_to_jax`` are the exact inverses: a
port ``state_dict`` (or any ``{torch name: tensor}`` of the same names, such
as AdamW's moments) becomes the '/'-joined flat dict of numpy arrays that the
JAX package's ``DistributedModel.state_dict()`` gives, layers stacked on the
leading scan axis, kernels transposed back to [in, out] and the multi-axis
kernels reshaped back to [D, 3, H, hd] and [H, hd, D]. A round trip through
both directions gives the same bits. This is the layout of the checkpoints
both packages write (``checkpoint.py``).

bf16 leaves. numpy has no bf16 of its own: ``to_numpy`` gives
``ml_dtypes.bfloat16`` arrays where ``ml_dtypes`` is installed and raw
2-byte ``|V2`` arrays where it is not; either way an ``.npz`` stores ``|V2``,
as the JAX package's files do. ``to_torch`` reads both back as
``torch.bfloat16``, bit for bit.
"""

import functools

import numpy as np
import torch

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # numpy then holds bf16 as raw 2-byte records
    _BF16 = np.dtype("V2")


def is_bf16(dtype):
    """True for the numpy dtypes that hold bf16: ``ml_dtypes.bfloat16`` and
    the ``|V2`` that an ``.npz`` stores it as."""
    dtype = np.dtype(dtype)
    return dtype.name == "bfloat16" or (dtype.kind == "V" and dtype.itemsize == 2 and dtype.fields is None)


def numpy_dtype(dtype):
    """The numpy dtype that holds a torch dtype's values."""
    if dtype == torch.bfloat16:
        return _BF16
    return torch.empty((), dtype=dtype).numpy().dtype


def to_numpy(value, copy=False):
    """Host numpy array of a tensor (or array-like); bf16 as ``_BF16``.
    ``copy``: the array owns its memory (a later in-place update of the
    tensor cannot reach it)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        t = t.to("cpu", copy=True) if copy else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    arr = np.asarray(value)
    return arr.copy() if copy else arr


def to_torch(value):
    """CPU tensor of a numpy array, sharing its memory (a read-only array is
    copied first); bf16 and ``|V2`` arrays become ``torch.bfloat16``.
    Tensors pass through."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    if is_bf16(arr.dtype):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=""):
    if not hasattr(tree, "items"):
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _leaf(path, value):
    """(torch name suffix, tensor) for one flax leaf (a tensor)."""
    *mods, kind = path.split("/")
    if kind == "kernel":
        name, value = "weight", value.T
    elif kind in ("scale", "embedding"):
        name = "weight"
    elif kind == "bias":
        name = "bias"
    else:
        raise KeyError(f"unexpected flax leaf {path!r}")
    return ".".join(mods + [name]), value.contiguous()


def params_from_jax(params):
    """flax params (nested dict or '/'-joined flat dict of arrays or
    tensors) -> ``state_dict`` of the port's ``TransformerLM``, on the
    tensors' device (the CPU for arrays)."""
    out = {}
    for path, value in _flatten(params).items():
        value = to_torch(value)
        if path.startswith("layers/block/"):
            rest = path.removeprefix("layers/block/")
            stacked = value
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
    "embedding_layernorm", "encoder_ln", "decoder_ln",
}
_LMHEAD_EMBEDDINGS = {"word_embedding", "position_embedding", "token_type_embedding", "shared_embedding",
                      "enc_rel_bias", "dec_rel_bias", "enc_position_embedding", "dec_position_embedding"}
_LAYER_PREFIX = "transformer/seq_layers/layer/"
# EncoderDecoderLM's two stacks.
_ENCDEC_PREFIXES = ("encoder/seq_layers/layer/", "decoder/seq_layers/layer/")
# A DistributedMoE in a layer's "output" slot: its leaves keep the flax
# names and shapes (router [D, E], fc [E, D, F] + [E, F], proj [E, F, D] +
# [E, D]), kernels as ``kernel`` in torch too.
_MOE_MODS = {"output/router", "output/fc", "output/proj"}


def _is_moe_leaf(mod, kind, arr):
    """Whether a leaf (a flax path's module and kind, or a torch name's, the
    layer axis taken off) is a DistributedMoE's: the router, or an expert
    kernel (3-D; torch calls it ``kernel`` too) or bias (2-D)."""
    if mod not in _MOE_MODS:
        return False
    return mod == "output/router" or (kind == "kernel" and arr.dim() == 3) or (kind == "bias" and arr.dim() == 2)


def _lm_head_leaf(path, value):
    """(torch name, tensor) for one leaf of DistributedTransformerLMHead's
    tree (a tensor; the layer axis already taken off)."""
    mod, kind = path.rsplit("/", 1)
    arr = value
    if _is_moe_leaf(mod, kind, arr):
        name = kind
    elif kind == "kernel" and mod in _LMHEAD_KERNELS:
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
    return f"{mod.replace('/', '.')}.{name}", arr.contiguous()


def _stacks_from_jax(params, prefixes):
    """flax params whose layer stacks sit under ``prefixes`` (each
    ``<stack>/seq_layers/layer/``) -> the port's ``state_dict`` names
    (``<stack>.seq_layers.<i>....``)."""
    out = {}
    for path, value in _flatten(params).items():
        value = to_torch(value)
        prefix = next((p for p in prefixes if path.startswith(p)), None)
        if prefix is not None:
            stack = prefix.removesuffix("/layer/").replace("/", ".")
            for i in range(value.shape[0]):
                name, t = _lm_head_leaf(path.removeprefix(prefix), value[i])
                out[f"{stack}.{i}.{name}"] = t
        else:
            name, t = _lm_head_leaf(path, value)
            out[name] = t
    return out


def lm_head_params_from_jax(params):
    """flax params of ``DistributedTransformerLMHead`` (nested dict or
    '/'-joined flat dict of arrays or tensors) -> ``state_dict`` of the
    port's ``DistributedTransformerLMHead``, on the tensors' device (the CPU
    for arrays)."""
    return _stacks_from_jax(params, (_LAYER_PREFIX,))


def encdec_params_from_jax(params):
    """flax params of ``models.encoder_decoder.EncoderDecoderLM`` ->
    ``state_dict`` of the port's ``EncoderDecoderLM``: the LM head's leaf map
    over its two stacks (``encoder/seq_layers/layer/``,
    ``decoder/seq_layers/layer/`` with its ``crossattention``), the shared
    embedding, the position tables or relative-bias tables, the final norms
    and an untied ``lm_head``."""
    return _stacks_from_jax(params, _ENCDEC_PREFIXES)


def _to_jax_arrays(out, layers, what, host=True):
    """The flat dict of host arrays: ``out``'s tensors (views of the input
    are copied) and ``{flax key: {layer index: tensor}}`` stacked on a
    leading axis on their device, each copied to the host once. With
    ``host=False`` the tensors stay on their device (``out``'s as views)."""
    flat = {key: to_numpy(t.contiguous(), copy=t.is_contiguous()) if host else t for key, t in out.items()}
    for key, per in layers.items():
        if sorted(per) != list(range(len(per))):
            raise KeyError(f"{what} {key!r}: layers {sorted(per)} are not 0..{len(per) - 1}")
        stacked = torch.stack([per[i] for i in range(len(per))])
        flat[key] = to_numpy(stacked) if host else stacked
    return flat


def _leaf_to_jax(name, value):
    """(flax path, tensor view) for one ``TransformerLM`` tensor (no layer
    index)."""
    *mods, kind = name.split(".")
    arr = value.detach()
    if kind == "bias":
        flax_kind = "bias"
    elif kind != "weight":
        raise KeyError(f"unexpected TransformerLM tensor {name!r}")
    elif mods[-1].startswith("ln"):
        flax_kind = "scale"
    elif mods[-1] in ("wte", "wpe"):
        flax_kind = "embedding"
    else:
        flax_kind, arr = "kernel", arr.T
    return "/".join(mods + [flax_kind]), arr


def params_to_jax(state_dict, host=True):
    """``state_dict`` of the port's ``TransformerLM`` (or tensors of the
    same names) -> the JAX package's flat '/'-keyed dict of numpy arrays;
    the inverse of ``params_from_jax``. ``host=False``: tensors on their
    device instead (``quant.py`` quantizes in this layout)."""
    out, layers = {}, {}
    for name, value in state_dict.items():
        if name.startswith("layers."):
            i, rest = name.removeprefix("layers.").split(".", 1)
            key, arr = _leaf_to_jax(rest, value)
            layers.setdefault("layers/block/" + key, {})[int(i)] = arr
        else:
            key, arr = _leaf_to_jax(name, value)
            out[key] = arr
    return _to_jax_arrays(out, layers, "TransformerLM tensor", host)


def _lm_head_kernel_shape(mod, n_in, n_out, H):
    """The flax kernel shape of an ``nn.Linear`` [out, in] (transposed)."""
    return {
        "attention/qkv": (n_in, 3, H, -1),
        "attention/dense": (H, -1, n_out),
        "crossattention/query": (n_in, H, -1),
        "crossattention/key_value": (n_in, 2, H, -1),
        "crossattention/dense": (H, -1, n_out),
    }.get(mod, (n_in, n_out))


def _lm_head_leaf_to_jax(name, value, H):
    """(flax path, tensor) for one ``DistributedTransformerLMHead`` tensor
    (no layer index); ``H`` is the number of attention heads."""
    mod, kind = name.rsplit(".", 1)
    mod = mod.replace(".", "/")
    arr = value.detach()
    if _is_moe_leaf(mod, kind, arr):
        flax_kind = kind
    elif kind == "weight" and mod in _LMHEAD_KERNELS:
        n_out, n_in = arr.shape
        arr, flax_kind = arr.T.reshape(_lm_head_kernel_shape(mod, n_in, n_out, H)), "kernel"
    elif kind == "bias" and mod in _LMHEAD_KERNELS:
        shape = _lm_head_kernel_shape(mod, 0, arr.shape[0], H)[_LMHEAD_KERNELS[mod]:]
        arr, flax_kind = arr.reshape(shape), "bias"
    elif kind == "bias" and mod in _LMHEAD_NORMS:
        flax_kind = "bias"
    elif kind == "weight" and mod in _LMHEAD_NORMS:
        flax_kind = "scale"
    elif kind == "weight" and mod in _LMHEAD_EMBEDDINGS:
        flax_kind = "embedding"
    else:
        raise KeyError(f"unexpected DistributedTransformerLMHead tensor {name!r}")
    return f"{mod}/{flax_kind}", arr


def _stacks_to_jax(state_dict, num_attention_heads, prefixes, what, host):
    """The inverse of ``_stacks_from_jax``."""
    out, layers = {}, {}
    torch_prefixes = [(p.replace("/layer/", "/").replace("/", "."), p) for p in prefixes]
    for name, value in state_dict.items():
        hit = next(((tp, fp) for tp, fp in torch_prefixes if name.startswith(tp)), None)
        if hit is not None:
            i, rest = name.removeprefix(hit[0]).split(".", 1)
            key, arr = _lm_head_leaf_to_jax(rest, value, num_attention_heads)
            layers.setdefault(hit[1] + key, {})[int(i)] = arr
        else:
            key, arr = _lm_head_leaf_to_jax(name, value, num_attention_heads)
            out[key] = arr
    return _to_jax_arrays(out, layers, what, host)


def lm_head_params_to_jax(state_dict, num_attention_heads, host=True):
    """``state_dict`` of the port's ``DistributedTransformerLMHead`` (or
    tensors of the same names) -> the JAX package's flat '/'-keyed dict of
    numpy arrays; the inverse of ``lm_head_params_from_jax``.
    ``num_attention_heads`` splits the qkv and output-projection kernels
    back into their head axes. ``host=False``: tensors on their device
    instead."""
    return _stacks_to_jax(state_dict, num_attention_heads, (_LAYER_PREFIX,), "DistributedTransformerLMHead tensor",
                          host)


def encdec_params_to_jax(state_dict, num_attention_heads, host=True):
    """``state_dict`` of the port's ``EncoderDecoderLM`` -> the JAX package's
    flat dict; the inverse of ``encdec_params_from_jax``."""
    return _stacks_to_jax(state_dict, num_attention_heads, _ENCDEC_PREFIXES, "EncoderDecoderLM tensor", host)


def transformer_params_from_jax(params):
    """flax params of a bare ``DistributedTransformer`` (the layer stack, its
    leaves under ``seq_layers/layer/``) -> ``state_dict`` of the port's
    ``DistributedTransformer``: the LM head's map of its ``transformer``
    subtree."""
    sd = lm_head_params_from_jax({"transformer/" + k: v for k, v in _flatten(params).items()})
    return {k.removeprefix("transformer."): v for k, v in sd.items()}


def transformer_params_to_jax(state_dict, num_attention_heads, host=True):
    """``state_dict`` of the port's ``DistributedTransformer`` -> the JAX
    package's flat dict (keys under ``seq_layers/layer/``); the inverse of
    ``transformer_params_from_jax``."""
    flat = lm_head_params_to_jax({"transformer." + k: v for k, v in state_dict.items()}, num_attention_heads, host)
    return {k.removeprefix("transformer/"): v for k, v in flat.items()}


def jax_layout(module, host=True):
    """``(to_jax, from_jax)``: the maps between ``module``'s ``state_dict``
    and the JAX package's flat keys for the same model, by its class (the
    zoo's ``TransformerLM`` and ``EncoderDecoderLM``,
    ``DistributedTransformerLMHead``, a bare ``DistributedTransformer``);
    ``host`` as for ``params_to_jax``. None for a module the JAX package has
    no counterpart for."""
    from smdistributed_modelparallel_tpu_torch.models.encoder_decoder import EncoderDecoderLM
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import (
        DistributedAttentionLayer,
        DistributedTransformer,
        DistributedTransformerLMHead,
    )

    if isinstance(module, TransformerLM):
        return functools.partial(params_to_jax, host=host), params_from_jax
    for cls, to_jax, from_jax in (
            (DistributedTransformerLMHead, lm_head_params_to_jax, lm_head_params_from_jax),
            (EncoderDecoderLM, encdec_params_to_jax, encdec_params_from_jax),
            (DistributedTransformer, transformer_params_to_jax, transformer_params_from_jax)):
        if isinstance(module, cls):
            heads = [m.num_attention_heads for m in module.modules() if isinstance(m, DistributedAttentionLayer)]
            return functools.partial(to_jax, num_attention_heads=heads[0] if heads else 1, host=host), from_jax
    return None


_KV_LEAVES = ("pool_key", "pool_value", "scale_key", "scale_value")


def kv_pools_from_jax(cache):
    """The JAX serving engine's cache tree (numpy or JAX arrays) -> a list of
    CPU tensors, one tuple a layer: ``(key, value)``, each [num_blocks,
    block_tokens, H, hd], and under ``SMP_KV_QUANT=int8`` (int8 pools) also
    ``scale_key`` and ``scale_value``, each [num_blocks, H] fp32."""
    attn = cache["layers"]["block"]["attn"]
    leaves = [to_torch(attn[name]) for name in _KV_LEAVES if name in attn]
    keys, values = leaves[:2]
    if keys.shape != values.shape or keys.dim() != 5 or len(leaves) not in (2, 4):
        raise ValueError(f"malformed paged KV cache: pool_key {tuple(keys.shape)}, pool_value {tuple(values.shape)}"
                         f", {len(leaves)} leaves")
    return [tuple(t[i].clone() for t in leaves) for i in range(keys.shape[0])]


def kv_pools_to_jax(pools):
    """Per-layer pools (``(key, value)`` or, int8, ``(key, value, scale_key,
    scale_value)``) -> the JAX serving engine's cache tree of numpy arrays,
    layers stacked on the leading axis; the inverse of
    ``kv_pools_from_jax``."""
    n = len(pools[0])
    attn = {name: to_numpy(torch.stack([p[j].detach() for p in pools])) for j, name in enumerate(_KV_LEAVES[:n])}
    return {"layers": {"block": {"attn": attn}}}


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


def key_from_jax(key_data):
    """The port's key from a JAX key's data (``jax.random.key_data(k)``, or
    a raw uint32 [2] ``PRNGKey``): a numpy uint32 array of shape (2,)."""
    from smdistributed_modelparallel_tpu_torch.utils.random import as_key

    return as_key(np.asarray(key_data))


def key_to_jax(key):
    """A port key as JAX key data: pass it to ``jax.random.wrap_key_data``
    (or use it as a raw ``PRNGKey``)."""
    from smdistributed_modelparallel_tpu_torch.utils.random import as_key

    return as_key(key).copy()
