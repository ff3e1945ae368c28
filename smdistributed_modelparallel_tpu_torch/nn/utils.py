"""Helpers of the ``smp.nn`` layers: the tp queries, activation sharding,
the dropout switch, the fused bias-GELU dispatch, parameter casting and the
decode KV cache.

Counterparts on one device of ``smdistributed_modelparallel_tpu/nn/
utils.py``: ``tp_size``/``tp_enabled``, ``tp_ring_active`` (False until the
tensor-parallel slice), ``shard_activation`` (the identity: there is no mesh
to constrain over), ``resolve_deterministic``, ``fused_bias_gelu`` (its
tp = 1 branch, with the fp8 epilogue input), ``half_cast`` and ``DecodeKVCache``.
"""

import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state


def tp_size():
    if state.cfg is None:
        return 1
    return state.cfg.tensor_parallel_degree


def tp_enabled():
    return tp_size() > 1


def tp_ring_active():
    """Whether the overlapped-tp ring path applies: never yet (the ring,
    ``ops/collective_matmul.py``, arrives with the tensor-parallel slice)."""
    return False


def shard_activation(x, *spec):
    """Constrain an activation to a partition over the mesh. On one device
    every axis has size 1, so this is the identity, as the JAX function is
    for trivial axes."""
    return x


def resolve_deterministic(explicit):
    """Whether dropout should be skipped: an explicit bool wins; None defers
    to the wrapping ``DistributedModel``'s train/eval mode (the reference's
    modules follow ``model.train()``/``.eval()``)."""
    if explicit is not None:
        return explicit
    model = state.model
    if model is not None:
        return not model.training
    return True


def fused_bias_gelu(h, b):
    """Dispatch ``gelu(h + b)`` to the fused kernels (``ops/bias_gelu.py``).
    At tp = 1 it is a direct call. Callers guard with
    ``bias_gelu.bias_gelu_ok``.

    Under an fp8 step (``matmul_precision: fp8``) the epilogue INPUT rounds to
    the e4m3 grid with the ``gelu_in.x`` slot's delayed scale (straight-
    through gradient) before the kernel, as in the JAX package."""
    from smdistributed_modelparallel_tpu_torch.ops.bias_gelu import bias_gelu

    if quant.fp8_trace_active():
        h = quant.fake_quant(h, "gelu_in.x")
    if tp_enabled():
        raise NotImplementedError(
            "fused_bias_gelu under tensor parallelism (the tp manual region) "
            "is not ported to PyTorch yet (the tensor-parallel slice)."
        )
    return bias_gelu(h, b)


def half_cast(state_dict, half):
    """Cast every floating tensor of a state dict to ``half`` (None = no-op).

    As in the JAX package, every floating parameter is cast, LayerNorm
    scales and embeddings included."""
    if half is None:
        return state_dict
    return {
        k: v.to(half) if torch.is_floating_point(v) else v
        for k, v in state_dict.items()
    }


class DecodeKVCache:
    """Preallocated per-layer K/V buffers for autoregressive decoding.

    Protocol (see ``generation.py``): the first append on a fresh cache may
    carry a whole prompt chunk (the prefill), which then attends causally
    over itself, since the cache holds nothing before it. Every later append
    is a T=1 decode step that attends over the whole cache under the mask
    ``col <= index`` (banded to ``window`` when set). Both write their K/V
    into ``cache_len`` slots at ``index``; the buffers are updated in place.
    """

    def __init__(self, shape, dtype, device):
        B, C, H, hd = shape
        if C is None:
            raise ValueError(
                "decode=True requires decode_cache_len (total generation "
                "length) on the module."
            )
        self.key = torch.zeros((B, C, H, hd), dtype=dtype, device=device)
        self.value = torch.zeros((B, C, H, hd), dtype=dtype, device=device)
        self.index = 0
        self.cache_len = C
        self._fresh = True

    def append(self, k, v, window=None):
        """Write chunk K/V ([B, T, H, hd]) at the current index.

        Returns ``(k_attend, v_attend, mask)``: for a prefill chunk the chunk
        itself with ``mask=None`` (the caller runs plain causal attention);
        for a decode step the full cache plus a [1, 1, 1, cache_len] boolean
        mask selecting positions <= index (banded to ``window`` when set).
        """
        T = k.shape[1]
        if T > 1 and not self._fresh:
            raise ValueError(
                "KV-cache protocol violation: a multi-token (prefill) "
                "chunk is only valid on a fresh cache; later calls must "
                "decode one token at a time (the chunk would silently "
                "ignore all previously cached positions)."
            )
        self._fresh = False
        i = self.index
        self.key[:, i:i + T] = k
        self.value[:, i:i + T] = v
        self.index = i + T
        if T > 1:
            return k, v, None
        cols = torch.arange(self.cache_len, device=k.device)
        keep = cols <= i
        if window is not None:
            keep = keep & (i - cols < window)
        return self.key, self.value, keep[None, None, None, :]
