"""The ``smp.nn`` transformer family.

Counterpart of ``smdistributed_modelparallel_tpu/nn/transformer.py``, as
``torch.nn`` modules (the stack and the LM head give the JAX modules'
``pipeline_spec()``: a tuple carry, the stacked ``layer_xs``, a stage's layer
range through ``apply_layers``):

- ``DistributedAttentionLayer``: self- or cross-attention; the fused QKV
  projection (``fused_qkv`` in the config) through ``ops/matmul_bias.py``
  (``ops/matmul_fp8.py`` under fp8), or the unfused product with the bias
  added in the activation dtype;
  rotary positions (GPT-J and NeoX), the per-layer ``scale_attn_by_layer_idx``
  and ``query_key_layer_scaling`` factors and ``attention_layers_type``'s
  local/global switch, all handed to ``ops/attention.attention_core``;
- ``DistributedTransformerOutputLayer``: the MLP, with the fc epilogue
  through ``ops/bias_gelu.py`` under ``fused_bias_gelu``, and ``gated_mlp``;
- ``DistributedTransformerLayer``: pre/post/single-pre layernorm,
  ``parallel_attn_output``, ``fp32_residual_addition``, cross-attention;
- ``DistributedTransformer``: the layer stack, an ``nn.ModuleList`` that
  hands each layer its ``layer_idx`` and ``is_local`` as Python values (the
  JAX package's ``nn.scan`` passes them as traced xs);
- ``DistributedTransformerLMHead``: embeddings, the stack and the (tied)
  head, in logits and loss mode; the tied head in loss mode goes through
  ``nn/cross_entropy.fused_lm_head_cross_entropy``.

Parameter names follow the flax tree, so ``convert.lm_head_params_from_jax``
maps one onto the other: ``word_embedding``, ``position_embedding``,
``transformer.seq_layers.<i>.attention.qkv`` (an ``nn.Linear`` whose output
columns run (q/k/v, head, head_dim), the flax [D, 3, H, hd] kernel
flattened), ``attention.dense`` (the [H, hd, D] kernel), ``output.fc``,
``output.proj``, ``ln_f``. A layernorm that flax names
``attention/layernorm`` lives in the attention module here
(``attention.layernorm``) and is applied by the layer, as in flax.

Under ``matmul_precision: fp8`` (inside an ``@smp.step``, where
``quant.fp8_trace_active()``) the JAX package's fp8 seams run through
``quant``: the QKV, attention output, MLP fc (and gate) and proj products
(``fp8_matmul``, slots ``qkv``, ``attn_proj``, ``mlp_fc``, ``mlp_proj``), and
the fake-quantized score operands (``attn_q.x``, ``attn_k.x``) and bias-GELU
input (``gelu_in.x``). The cross-attention key/value product stays as built,
as in the JAX package.

The config keys ``fused_qkv``, ``use_pallas_kernels`` and ``optimize`` are
read through ``state.cfg``; ``use_pallas_kernels: False`` keeps every kernel
off, the flash kernels included. The dispatch decisions are counted as the
JAX package counts them while it traces (``smp_fused_kernel_dispatch_total``
for the fused QKV and bias-GELU, ``smp_quant_dispatch_total`` for the fp8
seams): noted through ``nn/utils.program_tick`` and replayed as the JAX
package's traces count them (``model.replay_program_ticks``).

Dropout in training mode (``deterministic`` None follows the
``DistributedModel``'s ``train()``/``eval()``) at the JAX package's four
sites, each with its flax scope key (``nn/utils.make_rng``): the attention
probabilities (``attention_core``'s ``dropout_rng``, scope "attention"), the
attention output and the MLP output (their inline ``nn.Dropout``,
"attention/Dropout_0" and "output/Dropout_0"), and the embedding (the LM
head's "Dropout_0"). Under context parallelism only the attention dropout
runs (the ring hashes global positions); the other three raise. At tp > 1
each rank draws its part of the whole mask (below).

Activation checkpointing (``activation_checkpointing=True`` on the stack or
the LM head, whose flag is its stack's, or ``smp.set_activation_checkpointing``
before the ``DistributedModel`` is built): each layer of the stack is one
checkpointed region under ``parallel/memory.remat_policy()`` (the JAX
package's ``nn.remat`` of the scan body), recomputed in the backward on the
parameter tensors and dropout keys of its forward.

``decode=True`` (``smp.generate``'s copy, ``DistributedTransformerLMHead.clone``):
each self-attention layer keeps a ``nn/utils.DecodeKVCache`` (post-rotary K),
the first call on it (the prefill) attends causally over its chunk, later
single-token calls over the cache under ``col <= index`` combined with the
caller's mask; a left-padded prompt's mask shifts each row's rotary and
learned positions back by its pad count (``nn/utils.pad_row_offset``).

A cross-attention layer under ``decode`` (the encoder-decoder's decoder)
computes the encoder K/V once, at its first call, and keeps them
(``cross_kv``, the JAX module's ``cache/cross_kv``); later calls reuse them
whatever ``cross_states`` they are given.

``num_experts > 0`` makes a layer's MLP a ``nn/moe.DistributedMoE`` (named
``output``, its layernorms attached to it as to the dense MLP), which records
its load-balancing loss on the model being called.

Tensor parallelism (tp > 1), the JAX module's two layouts (``optimize``),
written as Megatron's explicit regions over the tp group
(``backend/collectives.py``) where GSPMD places the collectives there:
- ``"speed"``: self-attention holds H/tp heads (the QKV weight's rows (c, h,
  k) and bias by head, the output projection's input columns; ``tp_heads``),
  its input enters by copy-to-tp and its output projection's partial sums
  are all-reduced before the replicated bias; the MLP likewise, ``fc`` (and
  ``gate``) column-parallel over F, ``proj`` row-parallel, the fused
  bias-GELU on the rank's [.., F/tp] block. The residual stream, the
  layernorms and the row-parallel biases are replicated;
- ``"memory"``: the stack scatters its input along T, each sublayer gathers
  T before its column-parallel product and reduce-scatters T after its
  row-parallel one, the stack gathers its output (a replicated result), and
  the layernorms and residual adds run on the rank's T shard; the step sums
  the replicated parameters' gradients of such a stack over tp
  (``DistributedModel._stack_replicated``). Where tp does not divide T the
  speed layout runs (the JAX package's ``shard_activation`` drops the axis).
The weights are drawn whole, then cut (``nn/utils.shard_parameters_``); the
heads and the MLP width must divide over tp (``SMPValidationError``). The
tied head's logits are whole on every rank (a vocab-split table's gathered);
its loss goes through the vocab-parallel CE (``nn/cross_entropy.py``).

``tp_overlap: "ring"`` at tp > 1 (``ops/collective_matmul.py``): the QKV
and MLP fc products are all-gather rings, the attention and MLP output
projections reduce-scatter rings (the non-decode self-attention calls only;
the bias of a row-parallel product added once after its ring). Under
``"speed"`` the replicated residual enters a ring as the rank's T block and
the row-parallel ring's T-sharded sum is gathered back; under ``"memory"``
the residual already is the rank's T block. With ``fused_qkv`` each QKV
ring chunk is one ``ops/matmul_bias`` launch; without the ring the fused
QKV kernel is inert at tp > 1 (``matmul_bias.fused_qkv_ok``), as in the JAX
package. Where tp does not divide T the ring warns once and the layer keeps
its non-ring path. Dropout at tp > 1 draws the masks a tp = 1 model draws
from the same keys: the attention probabilities of the rank's heads
(``attention_core``'s ``head0``/``head_total``), the hidden dropout's whole
mask on a replicated activation and the rank's T runs of it on a T block.
Refused at tp > 1 (``refuse_tp``, ROADMAP item 7b): cross-attention (the
encoder-decoder) and ``DistributedMoE``.

Not ported yet, raising ``NotImplementedError``: activation checkpointing
under context parallelism.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.collectives import (
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    reduce_scatter_to_tp,
    scatter_to_tp,
)
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    fused_lm_head_cross_entropy,
    masked_vocab_parallel_cross_entropy,
)
from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
from smdistributed_modelparallel_tpu_torch.nn.layer_norm import DistributedLayerNorm
from smdistributed_modelparallel_tpu_torch.nn.utils import (
    DecodeKVCache,
    TPSpec,
    divisible_by_tp,
    dropout,
    fused_bias_gelu,
    make_rng,
    normal_weight_,
    pad_row_offset,
    program_scope,
    program_tick,
    resolve_deterministic,
    sequence_parallel,
    shard_activation,
    shard_parameters_,
    tp_group,
    tp_rank as _tp_rank,
    tp_size,
)
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import collective_matmul as cm
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core
from smdistributed_modelparallel_tpu_torch.parallel import memory
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


def _cfg(name, default):
    cfg = state.cfg
    return getattr(cfg, name) if cfg is not None and name in cfg else default


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    # Exact erf gelu (HF BERT's "gelu"; the tanh form above is HF's
    # "gelu_new" and the reference's fused bias_gelu).
    "gelu_erf": lambda x: F.gelu(x),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
}


def _not_ported(what, where):
    return NotImplementedError(f"{what} is not ported to PyTorch yet ({where}).")


def refuse_tp(what):
    """Raise for a feature that stays refused at tensor_parallel_degree > 1."""
    if tp_size() > 1:
        raise NotImplementedError(
            f"{what} at tensor_parallel_degree > 1 is not ported to PyTorch yet (ROADMAP item 7b)."
        )


def _tp_in(hidden, seq_sharded):
    """The full activation a layer's column-parallel products read: the
    sequence-parallel shard gathered along T (backward: reduce-scatter), or
    the replicated input entering the tp region (backward: all-reduce)."""
    group = tp_group()
    return gather_from_tp(hidden, group, 1) if seq_sharded else copy_to_tp(hidden, group)


def _tp_out(partial, seq_sharded):
    """The row-parallel product's partial sums reduced over tp: scattered
    along T under sequence parallelism, else all-reduced."""
    group = tp_group()
    return reduce_scatter_to_tp(partial, group, 1) if seq_sharded else reduce_from_tp(partial, group)


def _dropout(module, x, rate, seq_sharded=False):
    """The inline ``nn.Dropout(rate, deterministic=False)`` of ``module``'s
    flax body ("Dropout_0" in its scope), when its rate is above 0 and the
    model trains; ``seq_sharded``: x is the rank's T block, which draws its
    part of the whole mask."""
    if rate > 0.0 and not resolve_deterministic(module.deterministic):
        return dropout(x, rate, make_rng(module, "dropout", "Dropout_0"), seq_sharded=seq_sharded)
    return x


@torch.no_grad()
def _normal_(modules, std, generator=None):
    """The JAX initializers: normal(0, std) weights (a tp shard's slice of
    a whole draw) and zero biases."""
    for m in modules:
        normal_weight_(m, std, generator)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


@torch.no_grad()
def init_weights_(module, std=0.02, generator=None):
    """Redraw every weight of ``module`` as the JAX initializers give it:
    normal(0, ``std``) kernels (the experts' too) and embeddings, zero
    biases, unit layernorms;
    from ``generator`` (a ``torch.Generator`` on the module's device)."""
    from smdistributed_modelparallel_tpu_torch.nn.moe import DistributedMoE

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, DistributedEmbedding)):
            _normal_([m], std, generator)
        elif isinstance(m, DistributedLayerNorm):
            m.reset_parameters()
        elif isinstance(m, DistributedMoE):
            m.reset_parameters(std, generator)
    return module


def _linear(x, weight, bias=None, site=None, col=False):
    """``x @ weight^T`` in x's dtype, then ``+ bias`` in that dtype: the
    flax einsum with the bias added after the product is rounded. Under an
    fp8 step the product of a named seam (``site``) is ``quant.fp8_matmul``'s,
    as the JAX layers' ``_fp8_mm`` seams are; ``col``: a column-parallel
    product, whose output at tp > 1 is the rank's block (the backward's
    cotangent scale is then the tp group's)."""
    if site is not None and quant.fp8_trace_active():
        program_tick("quant", site, "fp8")
        y = quant.fp8_matmul(x, weight.to(x.dtype), site, grad_group=tp_group() if col else None)
    else:
        y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def apply_rotary(q, k, rotary_dim, base=10000.0, neox_style=False, offset=0):
    """Rotary position embedding on the first ``rotary_dim`` channels of
    [B, T, H, hd] q and k: interleaved pairs (GPT-J) or half-split
    (``neox_style``). ``offset`` (int or [B] tensor) shifts the absolute
    positions."""

    def rot(x):
        T = x.shape[1]
        d = rotary_dim
        x_rot, x_pass = x[..., :d], x[..., d:]
        half = d // 2
        freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
        off = torch.as_tensor(offset, dtype=torch.float32, device=x.device)
        t = off[..., None] + torch.arange(T, dtype=torch.float32, device=x.device)  # [T] or [B, T]
        angles = t[..., None] * freqs                                               # [.., T, half]
        cos = torch.cos(angles)[..., None, :]
        sin = torch.sin(angles)[..., None, :]
        if cos.dim() == 3:  # scalar offset
            cos, sin = cos[None], sin[None]
        if neox_style:
            x1, x2 = x_rot[..., :half], x_rot[..., half:]
            rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        else:
            x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
            rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x_rot.shape)
        return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)

    return rot(q), rot(k)


class DistributedAttentionLayer(nn.Module):
    """Multi-head (self or cross) attention.

    Self-attention holds ``qkv`` (D -> 3*H*hd, columns (c, h, k)); cross-
    attention ``query`` (D -> H*hd) and ``key_value`` (D -> 2*H*hd); both
    ``dense`` (H*hd -> D). ``forward`` takes the stack's ``layer_idx`` and
    ``is_local`` (None outside a stack).
    """

    def __init__(self, num_attention_heads, attention_head_size, hidden_size, attention_dropout_prob=0.1,
                 hidden_dropout_prob=0.1, cross_attention=False, causal_mask_size=None, mask_value=-1e4,
                 attention_in_fp32=False, query_key_layer_scaling=False, scale_attention_scores=True,
                 scale_attn_by_layer_idx=False, initializer_range=0.02, use_qkv_bias=True,
                 use_attn_dense_bias=True, rotary_dim=None, rotary_emb_base=None, gpt_neox_type_rotary=False,
                 window_size=None, decode=False, decode_cache_len=None, deterministic=None, dtype=None,
                 device=None):
        super().__init__()
        H, hd, D = num_attention_heads, attention_head_size, hidden_size
        self.num_attention_heads = H
        self.attention_head_size = hd
        self.attention_dropout_prob = attention_dropout_prob
        self.hidden_dropout_prob = hidden_dropout_prob
        self.cross_attention = cross_attention
        self.causal_mask_size = causal_mask_size
        self.mask_value = mask_value
        self.attention_in_fp32 = attention_in_fp32
        self.query_key_layer_scaling = query_key_layer_scaling
        self.scale_attention_scores = scale_attention_scores
        self.scale_attn_by_layer_idx = scale_attn_by_layer_idx
        self.rotary_dim = rotary_dim
        self.rotary_emb_base = rotary_emb_base
        self.gpt_neox_type_rotary = gpt_neox_type_rotary
        self.window_size = window_size
        self.decode = decode
        self.decode_cache_len = decode_cache_len
        self.deterministic = deterministic
        self.cache = None  # the DecodeKVCache of a decode module, made at its first call
        self.cross_kv = None  # a decode cross-attention's encoder (k, v), computed at its first call
        kw = dict(dtype=dtype, device=device)
        if cross_attention:
            self.query = nn.Linear(D, H * hd, bias=use_qkv_bias, **kw)
            self.key_value = nn.Linear(D, 2 * H * hd, bias=use_qkv_bias, **kw)
            projections = [self.query, self.key_value]
        else:
            self.qkv = nn.Linear(D, 3 * H * hd, bias=use_qkv_bias, **kw)
            projections = [self.qkv]
        self.dense = nn.Linear(H * hd, D, bias=use_attn_dense_bias, **kw)
        _normal_(projections + [self.dense], initializer_range)
        # Under tensor parallelism self-attention holds H/tp heads: the qkv
        # rows and the output projection's input columns of its heads.
        self.tp_heads = H
        if not cross_attention:
            divisible_by_tp(H, "num_attention_heads")
            qkv = TPSpec(0, 3 * H * hd, 3, hd)
            shard_parameters_(self, {"qkv.weight": qkv, "qkv.bias": qkv, "dense.weight": TPSpec(1, H * hd, 1, hd)})
            self.tp_heads = self.qkv.weight.shape[0] // (3 * hd)

    def _fused_qkv_wanted(self, hidden, ring=False):
        """Whether the fused QKV kernel runs: the config's knob as the step
        reads it (``collective_matmul.fused_qkv_effective``: the generic
        kernel switch, and at tp > 1 the ring) and the kernel's own dispatch
        precondition (inside the ring it takes the chunk products)."""
        if not cm.fused_qkv_effective():
            return False
        return mb.fused_qkv_ok(hidden, ring=ring, tp=tp_size())

    def _self_qkv(self, hidden, seq_sharded=False):
        """(q, k, v), each [B, T, H/tp, hd]. ``hidden`` is what the layer
        received: replicated, or the rank's T block under ``seq_sharded``.
        Under ``tp_overlap: "ring"`` the column-parallel product is
        ``ops/collective_matmul.ring_ag_matmul`` (the fused kernel a chunk
        under ``fused_qkv``); else the input enters the tp region whole."""
        w = self.qkv.weight.to(hidden.dtype)
        b = None if self.qkv.bias is None else self.qkv.bias.to(hidden.dtype)
        H, hd = self.tp_heads, self.attention_head_size
        knob = _cfg("fused_qkv", False) and _cfg("use_pallas_kernels", True)
        if not self.decode and cm.ring_applies("ag", hidden, seq_sharded):
            fused = self._fused_qkv_wanted(hidden, ring=True)
            qkv = cm.ring_ag_matmul(hidden, w, b, seq_sharded=seq_sharded, fused=fused, call="qkv")
            if knob:
                program_tick("fused", "qkv", "pallas" if fused else "fallback")
            B, T = qkv.shape[:2]
            qkv = qkv.reshape(B, T, 3, H, hd)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        hidden = _tp_in(hidden, seq_sharded)
        fused = self._fused_qkv_wanted(hidden)
        if knob:
            program_tick("fused", "qkv", "pallas" if fused else "fallback")
        B, T, D = hidden.shape
        if fused:
            # One kernel against the [3*H*hd, D] weight, bias in the epilogue
            # (rounded to the activation dtype first, as the JAX call site's
            # qkv_bias.astype(hidden.dtype) does). Under an fp8 step, the fp8
            # rung: e4m3 operands through ops/matmul_fp8, dequant and bias in
            # the epilogue.
            if quant.fp8_trace_active():
                program_tick("quant", "qkv", "fp8")
                qkv = quant.fp8_matmul(hidden.reshape(-1, D), w, "qkv", bias=b, use_pallas=True)
            else:
                qkv = mb.matmul_bias(hidden.reshape(-1, D), w, b)
            qkv = qkv.reshape(B, T, 3, H, hd)
        else:
            qkv = _linear(hidden, w, site="qkv", col=True).reshape(B, T, 3, H, hd)
            if b is not None:
                qkv = qkv + b.reshape(3, H, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _cross_qkv(self, hidden, cross_states):
        """(q, k, v) of cross-attention; q alone without ``cross_states``."""
        B, T = hidden.shape[:2]
        H, hd = self.num_attention_heads, self.attention_head_size
        q = _linear(hidden, self.query.weight, site="qkv").reshape(B, T, H, hd)
        if self.query.bias is not None:
            q = q + self.query.bias.reshape(H, hd).to(q.dtype)
        if cross_states is None:
            return q
        cs = cross_states.to(torch.promote_types(cross_states.dtype, hidden.dtype))
        kv = F.linear(cs, self.key_value.weight.to(cs.dtype)).reshape(B, cs.shape[1], 2, H, hd)
        if self.key_value.bias is not None:
            kv = kv + self.key_value.bias.reshape(2, H, hd).to(kv.dtype)
        return q, kv[:, :, 0], kv[:, :, 1]

    def forward(self, hidden, cross_states=None, attention_mask=None, layer_idx=None, is_local=None,
                seq_sharded=False):
        """``seq_sharded``: ``hidden`` is this rank's T shard of the sequence-
        parallel residual stream (``optimize: "memory"``), and so is the
        output."""
        if self.cross_attention:
            refuse_tp("cross-attention (the encoder-decoder)")
            hidden = _tp_in(hidden, seq_sharded)
            if cross_states is None:
                raise SMPValidationError("cross_attention=True requires cross_states input.")
            if self.decode and self.cross_kv is not None:
                # The encoder K/V of the first decode call serve every later one.
                q = self._cross_qkv(hidden, None)
                k, v = self.cross_kv
            else:
                q, k, v = self._cross_qkv(hidden, cross_states)
                if self.decode:
                    self.cross_kv = (k, v)
        else:
            q, k, v = self._self_qkv(hidden, seq_sharded)
        B, T = q.shape[:2]
        q, k, v = (shard_activation(t) for t in (q, k, v))
        # Under context parallelism a step holds the rank's shard of each
        # sequence, which starts at cp_rank * T (0 outside a step).
        pos_offset = state.sequence_offset(T)
        cache = None
        if self.decode and not self.cross_attention:
            if self.causal_mask_size is None:
                raise SMPValidationError(
                    "decode=True requires causal self-attention (causal_mask_size set); BERT-family encoders do "
                    "not decode."
                )
            if self.cache is None:
                self.cache = DecodeKVCache((B, self.decode_cache_len, self.tp_heads, self.attention_head_size),
                                           k.dtype, k.device)
            cache = self.cache
            # Left-padded prompts: each row's absolute positions shift back
            # by its pad count (nn/utils.pad_row_offset).
            row_off = pad_row_offset(attention_mask)
            pos_offset = cache.index if row_off is None else cache.index + row_off
        if self.rotary_dim is not None and not self.cross_attention:
            # The cache stores post-rotary K: a chunk rotates once, at its
            # absolute (cache-slot) positions.
            q, k = apply_rotary(q, k, self.rotary_dim, base=self.rotary_emb_base or 10000.0,
                                neox_style=self.gpt_neox_type_rotary, offset=pos_offset)
        decode_mask = None
        if cache is not None:
            k, v, decode_mask = cache.append(k, v, window=self.window_size)
            if decode_mask is not None:
                # A decode step attends over the cache; the caller's mask
                # (the padded prompt's, generated columns kept) still applies.
                if attention_mask is None:
                    attention_mask = decode_mask
                elif attention_mask.dtype == torch.bool:
                    attention_mask = attention_mask & decode_mask
                else:
                    attention_mask = attention_mask + torch.where(decode_mask, 0.0, self.mask_value).to(
                        attention_mask.dtype)

        hd = self.attention_head_size
        scale = 1.0 / math.sqrt(hd) if self.scale_attention_scores else 1.0
        extra_scale = qk_compensation = None
        if self.scale_attn_by_layer_idx and layer_idx is not None:
            # Net scores scaled by 1/(layer_idx+1).
            extra_scale = 1.0 / (layer_idx + 1.0)
        if self.query_key_layer_scaling and layer_idx is not None:
            # Numerics only: q pre-divided, the fp32 scores multiplied back.
            qk_compensation = layer_idx + 1.0
        dropout_rng = (
            None
            if resolve_deterministic(self.deterministic) or self.attention_dropout_prob == 0.0
            else make_rng(self, "dropout")
        )
        if quant.fp8_trace_active():
            # The score operands round to the e4m3 grid with their slots'
            # delayed scales (straight-through gradient); the attention then
            # runs as built.
            q = quant.fake_quant(q, "attn_q.x")
            k = quant.fake_quant(k, "attn_k.x")
        ctx = attention_core(
            q, k, v,
            # A decode step replaces causal and window with the cache mask.
            causal=self.causal_mask_size is not None and not self.cross_attention and decode_mask is None,
            window=self.window_size if decode_mask is None else None,
            local_select=is_local,
            scale=scale,
            extra_scale=extra_scale,
            qk_compensation=qk_compensation,
            mask=attention_mask,
            mask_value=self.mask_value,
            attention_in_fp32=self.attention_in_fp32,
            dropout_rate=self.attention_dropout_prob,
            dropout_rng=dropout_rng,
            use_pallas=_cfg("use_pallas_kernels", True),
            # A tp rank's heads draw their part of the whole mask.
            **({} if self.tp_heads == self.num_attention_heads else
               dict(head0=_tp_rank() * self.tp_heads, head_total=self.num_attention_heads)),
        )
        ctx = ctx.reshape(B, T, -1)
        if not self.decode and not self.cross_attention and cm.ring_applies("rs", ctx):
            out = cm.ring_rs_matmul(ctx, self.dense.weight.to(ctx.dtype), seq_sharded=seq_sharded, call="attn_proj")
        else:
            out = _tp_out(_linear(ctx, self.dense.weight, site="attn_proj"), seq_sharded)
        if self.dense.bias is not None:
            out = out + self.dense.bias.to(out.dtype)
        return _dropout(self, out, self.hidden_dropout_prob, seq_sharded)


class DistributedTransformerOutputLayer(nn.Module):
    """The MLP: ``fc`` (D -> F), the activation, ``proj`` (F -> D); with
    ``gated_mlp`` also ``gate`` (D -> F, no bias): act(gate(x)) * fc(x)."""

    def __init__(self, hidden_size, intermediate_size, hidden_dropout_prob=0.1, activation="gelu",
                 initializer_range=0.02, fused_bias_gelu=False, use_mlp_bias=True, gated_mlp=False,
                 deterministic=None, dtype=None, device=None):
        super().__init__()
        D, Fd = hidden_size, intermediate_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.activation = activation
        self.fused_bias_gelu = fused_bias_gelu
        self.use_mlp_bias = use_mlp_bias
        self.gated_mlp = gated_mlp
        self.deterministic = deterministic
        kw = dict(dtype=dtype, device=device)
        self.fc = nn.Linear(D, Fd, bias=use_mlp_bias, **kw)
        linears = [self.fc]
        if gated_mlp:
            self.gate = nn.Linear(D, Fd, bias=False, **kw)
            linears.append(self.gate)
        self.proj = nn.Linear(Fd, D, bias=use_mlp_bias, **kw)
        _normal_(linears + [self.proj], initializer_range)
        # Under tensor parallelism: fc (and gate) column-parallel over F, proj
        # row-parallel; the proj bias is replicated.
        divisible_by_tp(Fd, "intermediate_size")
        cols = TPSpec(0, Fd)
        specs = {"fc.weight": cols, "fc.bias": cols, "proj.weight": TPSpec(1, Fd)}
        if gated_mlp:
            specs["gate.weight"] = cols
        shard_parameters_(self, specs)

    def _fused_gelu_wanted(self, hidden):
        """Whether the fused bias+GELU kernels run: the module's flag, a bias
        to fold, no gate, the generic kernel switch, the tanh-GELU family
        and the kernels' own precondition."""
        if not (self.fused_bias_gelu and self.use_mlp_bias and not self.gated_mlp):
            return False
        if not _cfg("use_pallas_kernels", True):
            return False
        ok = bg.bias_gelu_ok(self.activation, hidden)
        program_tick("fused", "bias_gelu", "pallas" if ok else "fallback")
        return ok

    def forward(self, hidden, seq_sharded=False):
        """``seq_sharded`` as for ``DistributedAttentionLayer``. Under
        ``tp_overlap: "ring"`` the column-parallel products are
        ``ring_ag_matmul`` (bias-free before the fused bias-GELU) and the
        row-parallel one ``ring_rs_matmul``."""
        ring = cm.ring_applies("ag", hidden, seq_sharded)
        full = hidden if ring else _tp_in(hidden, seq_sharded)

        def col(weight, bias=None, call="mlp_fc"):
            if ring:
                return cm.ring_ag_matmul(hidden, weight.to(hidden.dtype),
                                         None if bias is None else bias.to(hidden.dtype), seq_sharded=seq_sharded,
                                         call=call)
            return _linear(full, weight, bias, site="mlp_fc", col=True)

        if self._fused_gelu_wanted(full):
            h = col(self.fc.weight)
            # The bias rounded to the activation dtype first, as the JAX call
            # site's fc_bias.astype(h.dtype) does; the kernels widen it.
            h = fused_bias_gelu(h, self.fc.bias.to(h.dtype))
        else:
            h = col(self.fc.weight, self.fc.bias)
            act = _ACTIVATIONS[self.activation]
            h = act(col(self.gate.weight, call="mlp_gate")) * h if self.gated_mlp else act(h)
        if ring:
            out = cm.ring_rs_matmul(h, self.proj.weight.to(h.dtype), seq_sharded=seq_sharded, call="mlp_proj")
        else:
            out = _tp_out(_linear(h, self.proj.weight, site="mlp_proj"), seq_sharded)
        if self.proj.bias is not None:
            out = out + self.proj.bias.to(out.dtype)
        return _dropout(self, out, self.hidden_dropout_prob, seq_sharded)


class DistributedTransformerLayer(nn.Module):
    """One transformer block: attention and MLP with pre/post/single-pre
    layernorm, ``parallel_attn_output``, ``fp32_residual_addition`` and an
    optional cross-attention block (``crossattention``)."""

    def __init__(self, num_attention_heads, attention_head_size, hidden_size, intermediate_size,
                 attention_dropout_prob=0.1, hidden_dropout_prob=0.1, activation="gelu", layernorm_epsilon=1e-5,
                 mask_value=-1e4, add_cross_attention=False, pre_layernorm=False, post_layernorm=True,
                 single_pre_layernorm=False, attention_in_fp32=False, query_key_layer_scaling=False,
                 scale_attention_scores=True, scale_attn_by_layer_idx=False, fp32_residual_addition=False,
                 fused_bias_gelu=False, initializer_range=0.02, use_qkv_bias=True, use_attn_dense_bias=True,
                 rotary_dim=None, rotary_emb_base=None, gpt_neox_type_rotary=False, window_size=None,
                 parallel_attn_output=False, causal_mask_size=None, layernorm_type="layer", use_mlp_bias=True,
                 gated_mlp=False, num_experts=0, moe_top_k=2, moe_capacity_factor=1.25, decode=False,
                 decode_cache_len=None, deterministic=None, dtype=None, device=None):
        super().__init__()
        self.pre_layernorm = pre_layernorm
        self.post_layernorm = post_layernorm
        self.single_pre_layernorm = single_pre_layernorm
        self.parallel_attn_output = parallel_attn_output
        self.fp32_residual_addition = fp32_residual_addition
        self.add_cross_attention = add_cross_attention
        attn_kw = dict(
            num_attention_heads=num_attention_heads, attention_head_size=attention_head_size,
            hidden_size=hidden_size, attention_dropout_prob=attention_dropout_prob,
            hidden_dropout_prob=hidden_dropout_prob, mask_value=mask_value, attention_in_fp32=attention_in_fp32,
            scale_attention_scores=scale_attention_scores, initializer_range=initializer_range,
            use_qkv_bias=use_qkv_bias, use_attn_dense_bias=use_attn_dense_bias, deterministic=deterministic,
            dtype=dtype, device=device,
        )
        self.attention = DistributedAttentionLayer(
            causal_mask_size=causal_mask_size, query_key_layer_scaling=query_key_layer_scaling,
            scale_attn_by_layer_idx=scale_attn_by_layer_idx, rotary_dim=rotary_dim,
            rotary_emb_base=rotary_emb_base, gpt_neox_type_rotary=gpt_neox_type_rotary,
            window_size=window_size, decode=decode, decode_cache_len=decode_cache_len, **attn_kw,
        )
        if num_experts > 0:
            from smdistributed_modelparallel_tpu_torch.nn.moe import DistributedMoE

            self.output = DistributedMoE(
                hidden_size=hidden_size, intermediate_size=intermediate_size, num_experts=num_experts,
                top_k=moe_top_k, capacity_factor=moe_capacity_factor, hidden_dropout_prob=hidden_dropout_prob,
                activation=activation, initializer_range=initializer_range, deterministic=deterministic,
                dtype=dtype, device=device,
            )
        else:
            self.output = DistributedTransformerOutputLayer(
                hidden_size=hidden_size, intermediate_size=intermediate_size, hidden_dropout_prob=hidden_dropout_prob,
                activation=activation, initializer_range=initializer_range, fused_bias_gelu=fused_bias_gelu,
                use_mlp_bias=use_mlp_bias, gated_mlp=gated_mlp, deterministic=deterministic, dtype=dtype,
                device=device,
            )
        rms = layernorm_type == "rms"

        def ln():
            return DistributedLayerNorm(hidden_size, epsilon=layernorm_epsilon, rms=rms, use_bias=not rms,
                                        dtype=dtype, device=device)

        # The layernorms sit where flax names them ("attention/layernorm",
        # ...): in the sublayer modules, applied by this block.
        if parallel_attn_output:
            self.attention.layernorm = ln()
            if pre_layernorm and not single_pre_layernorm:
                self.output.layernorm = ln()
        else:
            if pre_layernorm or single_pre_layernorm:
                self.attention.layernorm = ln()
            if post_layernorm:
                self.attention.post_layernorm = ln()
            if pre_layernorm and not single_pre_layernorm:
                self.output.layernorm = ln()
            if post_layernorm:
                self.output.post_layernorm = ln()
        if add_cross_attention:
            self.crossattention = DistributedAttentionLayer(cross_attention=True, **attn_kw)
            if pre_layernorm:
                self.crossattention.layernorm = ln()
            if post_layernorm:
                self.crossattention.post_layernorm = ln()

    def forward(self, hidden, cross_states=None, attention_mask=None, layer_idx=None, is_local=None,
                seq_sharded=False):
        # attention_mask may be a (self_mask, cross_mask) pair, as in the JAX
        # stack's carry. seq_sharded: hidden is this rank's T shard of the
        # sequence-parallel residual stream; the layernorms and residual adds
        # run on it, the sublayers gather and scatter T.
        cross_attention_mask = None
        if isinstance(attention_mask, tuple):
            attention_mask, cross_attention_mask = attention_mask
        res_dtype = torch.float32 if self.fp32_residual_addition else hidden.dtype
        attn, mlp = self.attention, self.output

        def add(*terms):
            out = terms[0].to(res_dtype)
            for t in terms[1:]:
                out = out + t.to(res_dtype)
            return out.to(hidden.dtype)

        sp = {"seq_sharded": True} if seq_sharded else {}
        x = hidden
        if self.parallel_attn_output:
            # GPT-J shares one LN (single_pre_layernorm); GPT-NeoX
            # (pre_layernorm, two LNs) feeds the MLP from its own.
            h = attn.layernorm(x)
            h_mlp = mlp.layernorm(x) if hasattr(mlp, "layernorm") else h
            return add(x, attn(h, attention_mask=attention_mask, layer_idx=layer_idx, is_local=is_local, **sp),
                       mlp(h_mlp, **sp))

        h = attn.layernorm(x) if self.pre_layernorm or self.single_pre_layernorm else x
        x = add(x, attn(h, attention_mask=attention_mask, layer_idx=layer_idx, is_local=is_local, **sp))
        if self.post_layernorm:
            x = attn.post_layernorm(x)

        if self.add_cross_attention and cross_states is not None:
            cross = self.crossattention
            h = cross.layernorm(x) if self.pre_layernorm else x
            x = add(x, cross(h, cross_states=cross_states, attention_mask=cross_attention_mask))
            if self.post_layernorm:
                x = cross.post_layernorm(x)

        h = mlp.layernorm(x) if self.pre_layernorm and not self.single_pre_layernorm else x
        x = add(x, mlp(h, **sp))
        if self.post_layernorm:
            x = mlp.post_layernorm(x)
        return x


class DistributedTransformer(nn.Module):
    """The layer stack ``seq_layers`` of ``DistributedTransformerLayer``;
    ``attention_layers_type`` ("local"/"global" per layer, GPT-Neo) selects
    the window band per layer; ``activation_checkpointing`` runs each layer
    as a checkpointed region (``parallel/memory``). Takes the layer's keyword
    arguments too."""

    _flax_scan_body = "layer"  # seq_layers is flax's nn.scan over "layer"

    def __init__(self, num_layers=12, num_attention_heads=32, attention_head_size=32, hidden_size=1024,
                 intermediate_size=4096, attention_layers_type=None, activation_checkpointing=False,
                 device=None, **layer_kwargs):
        super().__init__()
        if attention_layers_type is not None and len(attention_layers_type) != num_layers:
            raise SMPValidationError("attention_layers_type must have num_layers entries.")
        self.attention_layers_type = attention_layers_type
        self.activation_checkpointing = activation_checkpointing
        self.hidden_size = hidden_size
        self.seq_layers = nn.ModuleList(
            DistributedTransformerLayer(num_attention_heads, attention_head_size, hidden_size, intermediate_size,
                                        device=device, **layer_kwargs)
            for _ in range(num_layers)
        )

    def forward(self, hidden, cross_states=None, attention_mask=None):
        return self.layer_range(hidden, cross_states, attention_mask, 0, len(self.seq_layers))

    # -- pipeline decomposition: identity embed/head carrying the side
    # inputs, as in the JAX module ---------------------------------------

    def embed(self, hidden, cross_states=None, attention_mask=None):
        return (hidden, cross_states, attention_mask)

    def head(self, carry):
        return carry[0] if isinstance(carry, tuple) else carry

    def apply_layers(self, carry, start, end):
        hidden, cross_states, attention_mask = carry
        return (self.layer_range(hidden, cross_states, attention_mask, start, end), cross_states, attention_mask)

    def layer_xs(self):
        """The JAX stack's per-layer inputs, as numpy: ``layer_idx`` and,
        with ``attention_layers_type``, ``is_local``."""
        import numpy as np

        xs = {"layer_idx": np.arange(len(self.seq_layers), dtype=np.int32)}
        if self.attention_layers_type is not None:
            xs["is_local"] = np.asarray([t == "local" for t in self.attention_layers_type], dtype=bool)
        return xs

    def pipeline_spec(self, layer_path="seq_layers/layer", root=None):
        from smdistributed_modelparallel_tpu_torch.parallel.pipeline import PipelineSpec

        layer = self.seq_layers[0]
        return PipelineSpec(layer_path=layer_path, num_layers=len(self.seq_layers), layer_module=self.seq_layers,
                            embed_method="embed" if root is not None else None,
                            head_method="head" if root is not None else None,
                            layer_xs=self.layer_xs(), carry_is_tuple=True,
                            hidden_size=self.hidden_size, seq_len=layer.attention.causal_mask_size)

    def layer_range(self, hidden, cross_states, attention_mask, start, end):
        """Layers ``[start, end)`` of the stack, each with its global index
        (the whole stack: ``forward``; a pipeline stage: its range)."""
        types = self.attention_layers_type
        policy = offloader = None
        if self.activation_checkpointing:
            policy = memory.remat_policy()
            if policy.kind == memory.OFFLOAD:
                offloader = memory.Offloader(policy.horizon)  # one stack: the backward prefetches across it
        # optimize="memory": the residual stream between the layers is
        # sharded along T over tp (Megatron's sequence parallelism). The stack
        # takes a replicated input and gives a replicated output, so what is
        # around it (embeddings, head) is as in the speed layout.
        seq_sharded = sequence_parallel(hidden.shape[1])
        if seq_sharded:
            hidden = scatter_to_tp(hidden, tp_group(), 1)
            model = state.calling_model
            if model is not None:
                model._note_sequence_parallel()
        with program_scope("stack", id(self)):
            for i in range(start, end):
                layer = self.seq_layers[i]
                kw = dict(cross_states=cross_states, attention_mask=attention_mask, layer_idx=i,
                          is_local=None if types is None else types[i] == "local")
                if seq_sharded:
                    kw["seq_sharded"] = True
                if policy is None:
                    hidden = layer(hidden, **kw)
                else:
                    hidden = memory.run_checkpointed(layer, (hidden,), kw, policy, offloader)
        if seq_sharded:
            hidden = gather_from_tp(hidden, tp_group(), 1, split_grad=True)
        return hidden


class DistributedTransformerLMHead(nn.Module):
    """Embeddings + ``DistributedTransformer`` + LM head, with the JAX
    module's fields as keyword arguments (same names and defaults).

    ``forward(input_ids, token_type_ids=None, attention_mask=None,
    targets=None)``: ids [B, T] -> logits [B, T, V]; with ``targets`` ([B,
    T] int, -100 = ignored) -> per-token fp32 losses instead (pp = 1 only).
    """

    def __init__(self, num_layers=12, num_attention_heads=32, attention_head_size=32, hidden_size=1024,
                 intermediate_size=4096, vocab_size=30522, num_positions=1024, attention_dropout_prob=0.1,
                 hidden_dropout_prob=0.1, embedding_dropout_prob=0.1, activation="gelu", layernorm_epsilon=1e-5,
                 mask_value=-1e4, num_token_types=0, causal_mask_size=None, add_cross_attention=False,
                 add_lm_head=True, initializer_range=0.02, use_normal_initialization=False, pre_layernorm=False,
                 post_layernorm=True, attention_in_fp32=False, query_key_layer_scaling=False,
                 fp32_residual_addition=False, fused_softmax=True, fused_bias_gelu=False,
                 distribute_embedding=False, _scale_qkv_fan_out=False, _precision_test=False, rotary_dim=None,
                 rotary_emb_base=None, gpt_neox_type_rotary=False, use_positional_embedding=True,
                 position_ids_from_padding: Optional[int] = None, parallel_attn_output=False,
                 use_lm_head_bias=False, attention_layers_type=None, use_qkv_bias=True, use_attn_dense_bias=True,
                 window_size=None, final_layernorm=False, tie_input_output_embedding=True,
                 single_pre_layernorm=False, scale_attention_scores=True, scale_attn_by_layer_idx=False,
                 activation_checkpointing=False, use_embedding_layernorm=False, num_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, label_smoothing=0.0, decode=False, decode_cache_len=None,
                 deterministic=None, dtype=None, device=None):
        config = {k: v for k, v in locals().items() if k not in ("self", "__class__", "device")}
        super().__init__()
        # The constructor's arguments, for clone().
        self.config = config
        D = hidden_size
        self.num_attention_heads = num_attention_heads
        self.num_positions = num_positions
        self.decode = decode
        # Under decode: the absolute position of the next token, which learned
        # positions need before the layer stack (the JAX module's cache
        # variable "position_index").
        self.position_index = 0
        self.embedding_dropout_prob = embedding_dropout_prob
        self.use_positional_embedding = use_positional_embedding
        self.position_ids_from_padding = position_ids_from_padding
        self.num_token_types = num_token_types
        self.use_embedding_layernorm = use_embedding_layernorm
        self.final_layernorm = final_layernorm
        self.pre_layernorm = pre_layernorm
        self.add_lm_head = add_lm_head
        self.tie_input_output_embedding = tie_input_output_embedding
        self.label_smoothing = label_smoothing
        self.deterministic = deterministic
        kw = dict(dtype=dtype, device=device)
        if distribute_embedding:
            self.word_embedding = DistributedEmbedding(vocab_size, D, split="vocab", init_scale=initializer_range,
                                                       **kw)
        else:
            self.word_embedding = nn.Embedding(vocab_size, D, **kw)
        embeddings = [self.word_embedding]
        if use_positional_embedding:
            self.position_embedding = nn.Embedding(num_positions, D, **kw)
            embeddings.append(self.position_embedding)
        if num_token_types > 0:
            self.token_type_embedding = nn.Embedding(num_token_types, D, **kw)
            embeddings.append(self.token_type_embedding)
        if use_embedding_layernorm:
            self.embedding_layernorm = DistributedLayerNorm(D, epsilon=layernorm_epsilon, **kw)
        self.transformer = DistributedTransformer(
            num_layers=num_layers, num_attention_heads=num_attention_heads,
            attention_head_size=attention_head_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size, attention_layers_type=attention_layers_type,
            activation_checkpointing=activation_checkpointing, attention_dropout_prob=attention_dropout_prob,
            hidden_dropout_prob=hidden_dropout_prob, activation=activation, layernorm_epsilon=layernorm_epsilon,
            mask_value=mask_value, add_cross_attention=add_cross_attention, pre_layernorm=pre_layernorm,
            post_layernorm=post_layernorm, single_pre_layernorm=single_pre_layernorm,
            attention_in_fp32=attention_in_fp32, query_key_layer_scaling=query_key_layer_scaling,
            scale_attention_scores=scale_attention_scores, scale_attn_by_layer_idx=scale_attn_by_layer_idx,
            fp32_residual_addition=fp32_residual_addition, fused_bias_gelu=fused_bias_gelu,
            initializer_range=initializer_range, use_qkv_bias=use_qkv_bias,
            use_attn_dense_bias=use_attn_dense_bias, rotary_dim=rotary_dim, rotary_emb_base=rotary_emb_base,
            gpt_neox_type_rotary=gpt_neox_type_rotary, window_size=window_size,
            parallel_attn_output=parallel_attn_output, causal_mask_size=causal_mask_size,
            num_experts=num_experts, moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor,
            decode=decode, decode_cache_len=decode_cache_len, deterministic=deterministic, **kw,
        )
        if final_layernorm or pre_layernorm:
            self.ln_f = DistributedLayerNorm(D, epsilon=layernorm_epsilon, **kw)
        if add_lm_head and not tie_input_output_embedding:
            self.lm_head = nn.Linear(D, vocab_size, bias=use_lm_head_bias, **kw)
            embeddings.append(self.lm_head)
        _normal_(embeddings, initializer_range)

    @property
    def activation_checkpointing(self):
        """The flax field: whether the stack checkpoints its layers (the
        stack's own flag, which the LM head hands it)."""
        return self.transformer.activation_checkpointing

    @activation_checkpointing.setter
    def activation_checkpointing(self, on):
        self.transformer.activation_checkpointing = on

    def clone(self, **overrides):
        """A module of this config with ``overrides``, sharing (not copying)
        this module's parameters: the counterpart of flax ``Module.clone``,
        which ``smp.generate`` calls for its decode copy (``decode=True,
        decode_cache_len=..., deterministic=True``)."""
        config = dict(self.config, activation_checkpointing=self.activation_checkpointing)
        new = type(self)(**{**config, **overrides}, device="meta")
        new.load_state_dict(self.state_dict(), assign=True)
        return new

    def embed(self, input_ids, token_type_ids=None, attention_mask=None):
        """Embeddings of ``input_ids``: ``(x, None, attention_mask)``, the
        JAX package's carry."""
        x = self.word_embedding(input_ids)
        if self.use_positional_embedding:
            pad = self.position_ids_from_padding
            T = input_ids.shape[-1]
            if pad is not None and self.decode:
                raise SMPValidationError(
                    "decode=True is unsupported with position_ids_from_padding (RoBERTa-style pad-aware positions)."
                )
            if pad is not None:
                if state.cp_sharded:
                    raise NotImplementedError(
                        "position_ids_from_padding under context parallelism (a cumulative count "
                        "across the sequence shards) is not ported to PyTorch yet (a later "
                        "context-parallel slice)."
                    )
                # RoBERTa-style pad-aware positions (HF
                # create_position_ids_from_input_ids).
                ne = (input_ids != pad).long()
                pos = torch.cumsum(ne, dim=-1) * ne + pad
            elif self.decode:
                # The absolute offset of this chunk; left-padded prompts shift
                # each row back by its pad count, as the attention layers'
                # rotary offsets do.
                idx = self.position_index
                self.position_index = idx + T
                row_off = pad_row_offset(attention_mask)
                start = idx if row_off is None else (idx + row_off)[:, None]
                pos = (start + torch.arange(T, device=input_ids.device)[None, :]).clamp_min(0)
            else:
                # Under context parallelism the shard starts at cp_rank * T.
                start = state.sequence_offset(T)
                pos = torch.arange(start, start + T, device=input_ids.device)[None, :]
            x = x + self.position_embedding(pos)
        if self.num_token_types > 0 and token_type_ids is not None:
            x = x + self.token_type_embedding(token_type_ids)
        if self.use_embedding_layernorm:
            x = self.embedding_layernorm(x)
        x = _dropout(self, x, self.embedding_dropout_prob)
        return shard_activation(x), None, attention_mask

    def _tied_logits(self, x):
        w = self.word_embedding.weight
        if isinstance(self.word_embedding, DistributedEmbedding):
            # A vocab-split table gives this rank's vocab shard: gathered, so
            # the head's logits are whole on every tp rank.
            return self.word_embedding.gather_logits(self.word_embedding.attend(x))
        dtype = torch.promote_types(x.dtype, w.dtype)  # flax Embed.attend promotes
        return F.linear(x.to(dtype), w.to(dtype))

    def head(self, carry, targets=None):
        x = carry[0] if isinstance(carry, tuple) else carry
        if self.final_layernorm or self.pre_layernorm:
            x = self.ln_f(x)
        if not self.add_lm_head:
            return x
        emb = self.word_embedding
        dim_split = isinstance(emb, DistributedEmbedding) and emb.split == "dim" and tp_size() > 1
        if targets is not None and self.tie_input_output_embedding and not dim_split:
            # Tied head in loss mode: the fused-CE dispatch decides whether
            # the logits materialize (per vocab shard under tp).
            vocab_sharded = isinstance(emb, DistributedEmbedding) and emb.vocab_sharded
            return fused_lm_head_cross_entropy(x, emb.weight, targets, label_smoothing=self.label_smoothing,
                                               vocab_size=emb.num_embeddings if vocab_sharded else None)
        if self.tie_input_output_embedding:
            logits = self._tied_logits(x)
        else:
            dtype = torch.promote_types(x.dtype, self.lm_head.weight.dtype)  # flax Dense promotes
            logits = _linear(x.to(dtype), self.lm_head.weight, self.lm_head.bias)
        if targets is None:
            return logits
        return masked_vocab_parallel_cross_entropy(logits, targets, label_smoothing=self.label_smoothing)

    def apply_layers(self, carry, start, end):
        """Layers ``[start, end)`` of the stack on the carry ``(hidden,
        cross_states, attention_mask)``: a pipeline stage's work."""
        return self.transformer.apply_layers(carry, start, end)

    def pipeline_spec(self):
        """The JAX module's decomposition (``layer_path=
        "transformer/seq_layers/layer"``, a tuple carry, the stacked
        ``layer_xs``): ``embed``, the stack's layers, ``head``."""
        spec = self.transformer.pipeline_spec("transformer/seq_layers/layer", root=self)
        spec.seq_len = self.config["causal_mask_size"] or self.num_positions
        return spec

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, targets=None):
        if targets is not None and state.cfg is not None and state.cfg.pipeline_parallel_degree > 1:
            raise SMPValidationError(
                "model(ids, targets=...) is not available under pipeline "
                "parallelism; compute the loss from logits."
            )
        x, cross, amask = self.embed(input_ids, token_type_ids, attention_mask)
        x = self.transformer(x, attention_mask=amask)
        return self.head((x, cross, amask), targets=targets)


__all__ = [
    "DistributedAttentionLayer",
    "DistributedTransformer",
    "DistributedTransformerLMHead",
    "DistributedTransformerLayer",
    "DistributedTransformerOutputLayer",
    "apply_rotary",
    "init_weights_",
]
