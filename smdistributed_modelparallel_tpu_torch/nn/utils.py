"""Helpers of the ``smp.nn`` layers: the tp queries, activation sharding,
the dropout switch, a module's dropout key and the dropout dispatch, the
fused bias-GELU dispatch, parameter casting, the attention-mask helpers of
padded prompts, the decode KV cache and the paged KV cache of the serving
engine.

Counterparts on one device of ``smdistributed_modelparallel_tpu/nn/
utils.py``: ``tp_size``/``tp_enabled``, ``tp_ring_active`` (False until the
tensor-parallel slice), ``shard_activation`` (the identity: there is no mesh
to constrain over), ``resolve_deterministic``, ``fused_bias_gelu`` (its
tp = 1 branch, with the fp8 epilogue input), ``half_cast``, ``mask_keep_2d``,
``pad_row_offset``, ``DecodeKVCache`` and ``PagedKVCache``.
``make_rng`` is flax's ``Module.make_rng`` for the port's modules and
``dropout`` flax's ``nn.Dropout`` (``ops/dropout.py``).
"""

import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.ops import dropout as dropout_op
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


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


def make_rng(module, name="dropout", child=None):
    """The key flax's ``make_rng(name)`` gives ``module`` (or its child scope
    ``child``, e.g. an inline ``nn.Dropout``'s auto-name "Dropout_0") in the
    current model call: ``DistributedModel.make_rng`` of the model being
    called. Raises where flax finds no such key: outside an ``@smp.step``."""
    model = state.calling_model or state.model
    if model is None:
        raise SMPValidationError(
            f"{type(module).__name__} needs PRNG for {name!r}: a module draws its {name} key inside an "
            "@smp.step of a DistributedModel."
        )
    return model.make_rng(module, name, child)


def dropout(x, rate, key):
    """flax's ``nn.Dropout(rate, deterministic=False)(x)`` with ``key``
    (``ops/dropout.dropout``: the kernel on the card). Under context
    parallelism a rank holds a sequence shard of the activation, whose part
    of the global mask is not drawn yet, so it raises."""
    if state.cp_sharded:
        raise NotImplementedError(
            "hidden and embedding dropout under context parallelism (each rank's part of the global mask, "
            "drawn at its shard's offset) is not ported to PyTorch yet (ROADMAP Queue 1 item 6: what context "
            "parallelism left behind); attention dropout is."
        )
    return dropout_op.dropout(x, rate, key)


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


def mask_keep_2d(mask):
    """Boolean [B, T] keep flags from an attention mask in any accepted form
    ([B, T] or [B, 1, 1, T]; bool, 0/1 integer or additive float: "keep" is
    ``> -1.0``), or None when absent or not reducible to per-key flags."""
    if mask is None:
        return None
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        mask = mask[:, 0, 0, :]
    if mask.dim() != 2:
        return None
    if mask.dtype == torch.bool:
        return mask
    if not torch.is_floating_point(mask):
        return mask != 0
    return mask > -1.0  # additive: 0 keep, large negative drop


def pad_row_offset(mask):
    """The [B] position offset (int, at most 0) of LEFT-padded rows, or None
    when no mask applies: ``sum(keep) - width``, from the prompt mask at the
    prefill and from the [B, 1, 1, C] step mask (generated columns kept)
    alike. A row whose keep flags are not a left-pad shape (0..0 1..1) gets
    0: a mask that only blocks keys must not shift positions."""
    keep = mask_keep_2d(mask)
    if keep is None:
        return None
    is_leftpad = (keep[:, 1:] >= keep[:, :-1]).all(dim=1)
    off = keep.sum(dim=1) - keep.shape[1]
    return torch.where(is_leftpad, off, torch.zeros_like(off))


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

    def reorder(self, index):
        """Gather the buffers along the batch axis (beam search: each row
        takes its surviving parent's K/V), as the JAX package's
        ``_reorder_beam_cache`` gathers ``cached_key``/``cached_value``. The
        index and the protocol state stay."""
        self.key = self.key.index_select(0, index)
        self.value = self.value.index_select(0, index)


class PagedKVCache:
    """Block-pooled K/V cache of one attention layer, for the serving engine.

    Where ``DecodeKVCache`` gives every sequence a private [B, cache_len, H,
    hd] buffer, this holds ONE pool of ``num_blocks`` token blocks
    (``key``/``value``, each [num_blocks, block_tokens, H, hd], in the
    activation dtype on the model's device) shared by every sequence in
    flight. The host-side allocator (``serving/kv_cache.BlockAllocator``)
    hands out blocks and builds each sequence's block table (logical block j
    lives at pool block ``table[j]``). Pool block 0 is the TRASH block:
    unused table entries point at it, so inactive decode slots and padded
    prefill tails write there, and the position-derived mask never attends
    it.

    Call protocol (the engine's two programs):
    - decode step: k/v [S, 1, H, hd], one token a slot at ``positions[b]``;
    - prefill chunk: k/v [B, C, H, hd] written at ``positions[b] + t``;
      rows ``t >= valid[b]`` are padding and write to the trash block.
    Both return the gathered table [B, max_blocks * block_tokens, H, hd] and
    the mask ``col <= positions[b] + t`` ([B, 1, T, S] bool), as the JAX
    package's ``PagedKVCache.append`` does, so attention takes the plain
    path there and here.

    Under ``SMP_KV_QUANT=int8`` (read at construction) the pools are int8
    with ``scale_key``/``scale_value`` [num_blocks, H] fp32 beside them
    (running block maxima that only grow): an append grows the touched
    blocks' scales, requantizes them and writes its tokens quantized
    (``quant.kv_quantize_append``); the gathered table is dequantized to
    the activation dtype (``quant.kv_dequantize_gather``).
    """

    def __init__(self, num_blocks, block_tokens, heads, head_dim, dtype, device):
        self.quantized = quant.kv_quant_mode() == "int8"
        self.dtype = dtype
        shape = (num_blocks, block_tokens, heads, head_dim)
        pool_dtype = quant.kv_pool_dtype(dtype)
        self.key = torch.zeros(shape, dtype=pool_dtype, device=device)
        self.value = torch.zeros(shape, dtype=pool_dtype, device=device)
        if self.quantized:
            self.scale_key = torch.zeros((num_blocks, heads), dtype=torch.float32, device=device)
            self.scale_value = torch.zeros((num_blocks, heads), dtype=torch.float32, device=device)
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens

    def pools(self):
        """The pool tensors: ``(key, value)``, and under int8 ``(key, value,
        scale_key, scale_value)``."""
        if self.quantized:
            return self.key, self.value, self.scale_key, self.scale_value
        return self.key, self.value

    def append(self, k, v, block_tables, positions, valid=None, window=None):
        """Write chunk K/V into the pools, in place, and return ``(k_all,
        v_all, mask)``.

        Args:
          k, v: [B, T, H, hd] chunk K/V (T = 1 decode, T = chunk prefill).
          block_tables: [B, max_blocks] integer pool-block ids in sequence
            order; unused entries 0 (the trash block).
          positions: [B] absolute position of the chunk's first token.
          valid: optional [B]; rows ``t >= valid[b]`` are padding.
          window: optional local-attention band width.
        """
        B, T, H, hd = k.shape
        bt = self.block_tokens
        max_blocks = block_tables.shape[1]
        tables = block_tables.long()
        t = torch.arange(T, device=k.device)
        pos = positions.long()[:, None] + t[None, :]                        # [B, T]
        blk = torch.gather(tables, 1, (pos // bt).clamp(0, max_blocks - 1))
        dest = blk * bt + pos % bt
        if valid is not None:
            # Padded chunk tail: into the trash block, at offset t so that a
            # chunk no wider than a block never writes one slot twice.
            dest = torch.where(t[None, :] < valid.long()[:, None], dest, (t % bt)[None, :])
        flat = dest.reshape(-1)
        k, v = k.reshape(B * T, H, hd), v.reshape(B * T, H, hd)
        if self.quantized:
            # Grow the touched blocks' scales, requantize the pools on them,
            # then write the tokens quantized last (one rounding, not two).
            blk_flat = flat // bt
            self.key, self.scale_key, k = quant.kv_quantize_append(self.key, self.scale_key, k, blk_flat)
            self.value, self.scale_value, v = quant.kv_quantize_append(self.value, self.scale_value, v, blk_flat)
        pk = self.key.view(self.num_blocks * bt, H, hd)
        pv = self.value.view(self.num_blocks * bt, H, hd)
        pk.index_copy_(0, flat, k)
        pv.index_copy_(0, flat, v)
        # Gather every table slot: the logical position of column j is j.
        slots = (tables[:, :, None] * bt + torch.arange(bt, device=k.device)[None, None, :]).reshape(B, max_blocks * bt)
        k_all = pk[slots]                                                   # [B, S, H, hd]
        v_all = pv[slots]
        if self.quantized:
            slot_blocks = slots // bt
            k_all = quant.kv_dequantize_gather(k_all, self.scale_key, slot_blocks, self.dtype)
            v_all = quant.kv_dequantize_gather(v_all, self.scale_value, slot_blocks, self.dtype)
        cols = torch.arange(max_blocks * bt, device=k.device)
        keep = cols[None, None, :] <= pos[:, :, None]                       # [B, T, S]
        if window is not None:
            keep = keep & (pos[:, :, None] - cols[None, None, :] < window)
        return k_all, v_all, keep[:, None, :, :]
