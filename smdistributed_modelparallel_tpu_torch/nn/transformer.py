"""The ``smp.nn`` transformer family.

Counterpart of ``smdistributed_modelparallel_tpu/nn/transformer.py`` on one
device (pp = tp = dp = 1), as ``torch.nn`` modules:

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
off, the flash kernels included. Not ported yet, each raising
``NotImplementedError``: MoE (``num_experts > 0``), activation checkpointing,
``decode=True`` (generation through the LM head), training-time dropout, and
tensor parallelism (``optimize="memory"`` included).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    fused_lm_head_cross_entropy,
    masked_vocab_parallel_cross_entropy,
)
from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
from smdistributed_modelparallel_tpu_torch.nn.layer_norm import DistributedLayerNorm
from smdistributed_modelparallel_tpu_torch.nn.utils import (
    fused_bias_gelu,
    resolve_deterministic,
    shard_activation,
    tp_size,
)
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core
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


def _check_tp():
    if tp_size() > 1:
        memory = " under optimize='memory'" if _cfg("optimize", "speed") == "memory" else ""
        raise _not_ported(f"tensor_parallel_degree > 1{memory} in the smp.nn layers", "the tensor-parallel slice")


def _check_dropout(rate, deterministic):
    if rate > 0.0 and not resolve_deterministic(deterministic):
        raise _not_ported("training-time dropout in the smp.nn layers", "a later slice")


@torch.no_grad()
def _normal_(modules, std, generator=None):
    """The JAX initializers: normal(0, std) weights and zero biases."""
    for m in modules:
        m.weight.normal_(0.0, std, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


@torch.no_grad()
def init_weights_(module, std=0.02, generator=None):
    """Redraw every weight of ``module`` as the JAX initializers give it:
    normal(0, ``std``) kernels and embeddings, zero biases, unit layernorms;
    from ``generator`` (a ``torch.Generator`` on the module's device)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, DistributedEmbedding)):
            _normal_([m], std, generator)
        elif isinstance(m, DistributedLayerNorm):
            m.reset_parameters()
    return module


def _linear(x, weight, bias=None, site=None):
    """``x @ weight^T`` in x's dtype, then ``+ bias`` in that dtype: the
    flax einsum with the bias added after the product is rounded. Under an
    fp8 step the product of a named seam (``site``) is ``quant.fp8_matmul``'s,
    as the JAX layers' ``_fp8_mm`` seams are."""
    if site is not None and quant.fp8_trace_active():
        y = quant.fp8_matmul(x, weight.to(x.dtype), site)
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
        if decode:
            raise _not_ported("decode=True (generation through the smp.nn layers)", "a later slice")
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
        self.deterministic = deterministic
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

    def _fused_qkv_wanted(self, hidden):
        """Whether the fused QKV kernel runs: the config knob, the generic
        kernel switch, and the kernel's own dispatch precondition."""
        if not (_cfg("fused_qkv", False) and _cfg("use_pallas_kernels", True)):
            return False
        return mb.fused_qkv_ok(hidden, ring=False, tp=tp_size())

    def _self_qkv(self, hidden):
        B, T, D = hidden.shape
        H, hd = self.num_attention_heads, self.attention_head_size
        w = self.qkv.weight.to(hidden.dtype)
        b = None if self.qkv.bias is None else self.qkv.bias.to(hidden.dtype)
        if self._fused_qkv_wanted(hidden):
            # One kernel against the [3*H*hd, D] weight, bias in the epilogue
            # (rounded to the activation dtype first, as the JAX call site's
            # qkv_bias.astype(hidden.dtype) does). Under an fp8 step, the fp8
            # rung: e4m3 operands through ops/matmul_fp8, dequant and bias in
            # the epilogue.
            if quant.fp8_trace_active():
                qkv = quant.fp8_matmul(hidden.reshape(-1, D), w, "qkv", bias=b, use_pallas=True)
            else:
                qkv = mb.matmul_bias(hidden.reshape(-1, D), w, b)
            qkv = qkv.reshape(B, T, 3, H, hd)
        else:
            qkv = _linear(hidden, w, site="qkv").reshape(B, T, 3, H, hd)
            if b is not None:
                qkv = qkv + b.reshape(3, H, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _cross_qkv(self, hidden, cross_states):
        B, T = hidden.shape[:2]
        H, hd = self.num_attention_heads, self.attention_head_size
        q = _linear(hidden, self.query.weight, site="qkv").reshape(B, T, H, hd)
        if self.query.bias is not None:
            q = q + self.query.bias.reshape(H, hd).to(q.dtype)
        cs = cross_states.to(torch.promote_types(cross_states.dtype, hidden.dtype))
        kv = F.linear(cs, self.key_value.weight.to(cs.dtype)).reshape(B, cs.shape[1], 2, H, hd)
        if self.key_value.bias is not None:
            kv = kv + self.key_value.bias.reshape(2, H, hd).to(kv.dtype)
        return q, kv[:, :, 0], kv[:, :, 1]

    def forward(self, hidden, cross_states=None, attention_mask=None, layer_idx=None, is_local=None):
        _check_tp()
        B, T = hidden.shape[:2]
        if self.cross_attention:
            if cross_states is None:
                raise SMPValidationError("cross_attention=True requires cross_states input.")
            q, k, v = self._cross_qkv(hidden, cross_states)
        else:
            q, k, v = self._self_qkv(hidden)
        q, k, v = (shard_activation(t) for t in (q, k, v))
        if self.rotary_dim is not None and not self.cross_attention:
            q, k = apply_rotary(q, k, self.rotary_dim, base=self.rotary_emb_base or 10000.0,
                                neox_style=self.gpt_neox_type_rotary, offset=state.sequence_offset(T))

        hd = self.attention_head_size
        scale = 1.0 / math.sqrt(hd) if self.scale_attention_scores else 1.0
        extra_scale = qk_compensation = None
        if self.scale_attn_by_layer_idx and layer_idx is not None:
            # Net scores scaled by 1/(layer_idx+1).
            extra_scale = 1.0 / (layer_idx + 1.0)
        if self.query_key_layer_scaling and layer_idx is not None:
            # Numerics only: q pre-divided, the fp32 scores multiplied back.
            qk_compensation = layer_idx + 1.0
        _check_dropout(self.attention_dropout_prob, self.deterministic)
        if quant.fp8_trace_active():
            # The score operands round to the e4m3 grid with their slots'
            # delayed scales (straight-through gradient); the attention then
            # runs as built.
            q = quant.fake_quant(q, "attn_q.x")
            k = quant.fake_quant(k, "attn_k.x")
        ctx = attention_core(
            q, k, v,
            causal=self.causal_mask_size is not None and not self.cross_attention,
            window=self.window_size,
            local_select=is_local,
            scale=scale,
            extra_scale=extra_scale,
            qk_compensation=qk_compensation,
            mask=attention_mask,
            mask_value=self.mask_value,
            attention_in_fp32=self.attention_in_fp32,
            use_pallas=_cfg("use_pallas_kernels", True),
        )
        out = _linear(ctx.reshape(B, T, -1), self.dense.weight, self.dense.bias, site="attn_proj")
        _check_dropout(self.hidden_dropout_prob, self.deterministic)
        return out


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

    def _fused_gelu_wanted(self, hidden):
        """Whether the fused bias+GELU kernels run: the module's flag, a bias
        to fold, no gate, the generic kernel switch, the tanh-GELU family
        and the kernels' own precondition."""
        if not (self.fused_bias_gelu and self.use_mlp_bias and not self.gated_mlp):
            return False
        if not _cfg("use_pallas_kernels", True):
            return False
        return bg.bias_gelu_ok(self.activation, hidden)

    def forward(self, hidden):
        _check_tp()
        if self._fused_gelu_wanted(hidden):
            h = _linear(hidden, self.fc.weight, site="mlp_fc")
            # The bias rounded to the activation dtype first, as the JAX call
            # site's fc_bias.astype(h.dtype) does; the kernels widen it.
            h = fused_bias_gelu(h, self.fc.bias.to(h.dtype))
        else:
            h = _linear(hidden, self.fc.weight, self.fc.bias, site="mlp_fc")
            act = _ACTIVATIONS[self.activation]
            h = act(_linear(hidden, self.gate.weight, site="mlp_fc")) * h if self.gated_mlp else act(h)
        out = _linear(h, self.proj.weight, self.proj.bias, site="mlp_proj")
        _check_dropout(self.hidden_dropout_prob, self.deterministic)
        return out


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
        if num_experts > 0:
            raise _not_ported("num_experts > 0 (DistributedMoE)", "the MoE slice")
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

    def forward(self, hidden, cross_states=None, attention_mask=None, layer_idx=None, is_local=None):
        # attention_mask may be a (self_mask, cross_mask) pair, as in the JAX
        # stack's carry.
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

        x = hidden
        if self.parallel_attn_output:
            # GPT-J shares one LN (single_pre_layernorm); GPT-NeoX
            # (pre_layernorm, two LNs) feeds the MLP from its own.
            h = attn.layernorm(x)
            h_mlp = mlp.layernorm(x) if hasattr(mlp, "layernorm") else h
            return add(x, attn(h, attention_mask=attention_mask, layer_idx=layer_idx, is_local=is_local),
                       mlp(h_mlp))

        h = attn.layernorm(x) if self.pre_layernorm or self.single_pre_layernorm else x
        x = add(x, attn(h, attention_mask=attention_mask, layer_idx=layer_idx, is_local=is_local))
        if self.post_layernorm:
            x = attn.post_layernorm(x)

        if self.add_cross_attention and cross_states is not None:
            cross = self.crossattention
            h = cross.layernorm(x) if self.pre_layernorm else x
            x = add(x, cross(h, cross_states=cross_states, attention_mask=cross_attention_mask))
            if self.post_layernorm:
                x = cross.post_layernorm(x)

        h = mlp.layernorm(x) if self.pre_layernorm and not self.single_pre_layernorm else x
        x = add(x, mlp(h))
        if self.post_layernorm:
            x = mlp.post_layernorm(x)
        return x


class DistributedTransformer(nn.Module):
    """The layer stack ``seq_layers`` of ``DistributedTransformerLayer``;
    ``attention_layers_type`` ("local"/"global" per layer, GPT-Neo) selects
    the window band per layer. Takes the layer's keyword arguments too."""

    def __init__(self, num_layers=12, num_attention_heads=32, attention_head_size=32, hidden_size=1024,
                 intermediate_size=4096, attention_layers_type=None, activation_checkpointing=False,
                 device=None, **layer_kwargs):
        super().__init__()
        if activation_checkpointing:
            raise _not_ported("activation_checkpointing=True (per-layer remat)",
                              "the parallel/memory.remat_policy slice")
        if attention_layers_type is not None and len(attention_layers_type) != num_layers:
            raise SMPValidationError("attention_layers_type must have num_layers entries.")
        self.attention_layers_type = attention_layers_type
        self.seq_layers = nn.ModuleList(
            DistributedTransformerLayer(num_attention_heads, attention_head_size, hidden_size, intermediate_size,
                                        device=device, **layer_kwargs)
            for _ in range(num_layers)
        )

    def forward(self, hidden, cross_states=None, attention_mask=None):
        types = self.attention_layers_type
        for i, layer in enumerate(self.seq_layers):
            is_local = None if types is None else types[i] == "local"
            hidden = layer(hidden, cross_states=cross_states, attention_mask=attention_mask, layer_idx=i,
                           is_local=is_local)
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
        super().__init__()
        if decode:
            raise _not_ported("decode=True (smp.generate through DistributedTransformerLMHead)", "a later slice")
        D = hidden_size
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
            deterministic=deterministic, **kw,
        )
        if final_layernorm or pre_layernorm:
            self.ln_f = DistributedLayerNorm(D, epsilon=layernorm_epsilon, **kw)
        if add_lm_head and not tie_input_output_embedding:
            self.lm_head = nn.Linear(D, vocab_size, bias=use_lm_head_bias, **kw)
            embeddings.append(self.lm_head)
        _normal_(embeddings, initializer_range)

    def embed(self, input_ids, token_type_ids=None, attention_mask=None):
        """Embeddings of ``input_ids``: ``(x, None, attention_mask)``, the
        JAX package's carry."""
        x = self.word_embedding(input_ids)
        if self.use_positional_embedding:
            pad = self.position_ids_from_padding
            T = input_ids.shape[-1]
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
            else:
                # Under context parallelism the shard starts at cp_rank * T.
                start = state.sequence_offset(T)
                pos = torch.arange(start, start + T, device=input_ids.device)[None, :]
            x = x + self.position_embedding(pos)
        if self.num_token_types > 0 and token_type_ids is not None:
            x = x + self.token_type_embedding(token_type_ids)
        if self.use_embedding_layernorm:
            x = self.embedding_layernorm(x)
        _check_dropout(self.embedding_dropout_prob, self.deterministic)
        return shard_activation(x), None, attention_mask

    def _tied_logits(self, x):
        w = self.word_embedding.weight
        if isinstance(self.word_embedding, DistributedEmbedding):
            return self.word_embedding.attend(x)
        dtype = torch.promote_types(x.dtype, w.dtype)  # flax Embed.attend promotes
        return F.linear(x.to(dtype), w.to(dtype))

    def head(self, carry, targets=None):
        x = carry[0] if isinstance(carry, tuple) else carry
        if self.final_layernorm or self.pre_layernorm:
            x = self.ln_f(x)
        if not self.add_lm_head:
            return x
        if targets is not None and self.tie_input_output_embedding:
            # Tied head in loss mode: the fused-CE dispatch decides whether
            # the logits materialize.
            return fused_lm_head_cross_entropy(x, self.word_embedding.weight, targets,
                                               label_smoothing=self.label_smoothing)
        if self.tie_input_output_embedding:
            logits = self._tied_logits(x)
        else:
            dtype = torch.promote_types(x.dtype, self.lm_head.weight.dtype)  # flax Dense promotes
            logits = _linear(x.to(dtype), self.lm_head.weight, self.lm_head.bias)
        if targets is None:
            return logits
        return masked_vocab_parallel_cross_entropy(logits, targets, label_smoothing=self.label_smoothing)

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
