"""Parameter casting and the decode KV cache.

Counterparts of ``half_cast`` and ``DecodeKVCache`` in
``smdistributed_modelparallel_tpu/nn/utils.py``.
"""

import torch


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
