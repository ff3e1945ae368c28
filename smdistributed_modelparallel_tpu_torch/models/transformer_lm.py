"""Decoder-only transformer LM, the flagship model family.

Counterpart of ``smdistributed_modelparallel_tpu/models/transformer_lm.py``
(``CausalSelfAttention``, ``TransformerLayer``, ``TransformerLM``) as
``torch.nn`` modules. Submodule names follow the flax parameter tree
(``wte``, ``wpe``, ``layers.<i>.attn.qkv``, ``ln_f``, ...), so
``convert.params_from_jax`` maps one onto the other; the flax ``nn.scan``
layer stack is an ``nn.ModuleList`` here.

Supported: learned or no positions, a local-attention ``window``, parallel
(GPT-J) blocks, pre/post LayerNorm, tied or untied head, loss mode
(``model(ids, targets=...)`` -> per-token losses, with label smoothing),
and the KV-cache decode clone that ``generate`` drives. Not yet ported:
rotary positions, paged (serving) decoding and training-time dropout.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    fused_lm_head_cross_entropy,
    masked_vocab_parallel_cross_entropy,
)
from smdistributed_modelparallel_tpu_torch.nn.utils import DecodeKVCache
from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _not_ported(what, where):
    return NotImplementedError(f"{what} is not ported to PyTorch yet ({where}).")


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention.

    ``decode=True`` enables the KV-cache path: the first call on a fresh
    cache (the prefill) attends causally over its own chunk and keeps the
    flash-attention path; every later T=1 call attends over the cache.
    """

    def __init__(self, d_model, n_heads, dropout=0.0, attention_in_fp32=False,
                 rotary=False, rotary_dim=None, window=None,
                 deterministic=True, decode=False, decode_cache_len=None,
                 paged_blocks=None, paged_block_tokens=None, device=None):
        super().__init__()
        if rotary:
            raise _not_ported("rotary positions", "long-context slice")
        if paged_blocks is not None:
            raise _not_ported("paged KV-cache decoding", "ServingEngine slice")
        self.d_model = d_model
        self.n_heads = n_heads
        self.dropout = dropout
        self.attention_in_fp32 = attention_in_fp32
        self.window = window
        self.deterministic = deterministic
        self.decode = decode
        self.decode_cache_len = decode_cache_len
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.proj = nn.Linear(d_model, d_model, device=device)
        self.cache = None

    def forward(self, x):
        B, T, D = x.shape
        H = self.n_heads
        hd = D // H
        q, k, v = self.qkv(x).split(D, dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, H, hd)
        v = v.reshape(B, T, H, hd)
        decode_mask = None
        if self.decode:
            if self.cache is None:
                self.cache = DecodeKVCache(
                    (B, self.decode_cache_len, H, hd), k.dtype, k.device
                )
            k, v, decode_mask = self.cache.append(k, v, window=self.window)
        out = attention_core(
            q, k, v,
            causal=decode_mask is None,
            window=self.window if decode_mask is None else None,
            mask=decode_mask,
            attention_in_fp32=self.attention_in_fp32,
        ).reshape(B, T, D)
        return self.proj(out)


class TransformerLayer(nn.Module):
    """One pre/post-LN transformer block."""

    def __init__(self, d_model, n_heads, d_ff, dropout=0.0, pre_layernorm=True,
                 post_layernorm=False, attention_in_fp32=False, rotary=False,
                 rotary_dim=None, window=None, parallel_block=False,
                 deterministic=True, ln_eps=1e-5, decode=False,
                 decode_cache_len=None, paged_blocks=None,
                 paged_block_tokens=None, device=None):
        super().__init__()
        if dropout > 0.0 and not deterministic:
            raise _not_ported("training-time dropout", "a later slice")
        self.parallel_block = parallel_block
        self.pre_layernorm = pre_layernorm
        self.post_layernorm = post_layernorm
        self.attn = CausalSelfAttention(
            d_model, n_heads, dropout, attention_in_fp32, rotary, rotary_dim,
            window, deterministic, decode, decode_cache_len, paged_blocks,
            paged_block_tokens, device=device,
        )
        self.fc = nn.Linear(d_model, d_ff, device=device)
        self.proj = nn.Linear(d_ff, d_model, device=device)
        if parallel_block or pre_layernorm:
            self.ln1 = nn.LayerNorm(d_model, eps=ln_eps, device=device)
        if not parallel_block and pre_layernorm:
            self.ln2 = nn.LayerNorm(d_model, eps=ln_eps, device=device)
        if not parallel_block and post_layernorm:
            self.ln1_post = nn.LayerNorm(d_model, eps=ln_eps, device=device)
            self.ln2_post = nn.LayerNorm(d_model, eps=ln_eps, device=device)

    def mlp(self, h):
        return self.proj(_gelu(self.fc(h)))

    def forward(self, x):
        if self.parallel_block:
            h = self.ln1(x)
            return x + self.attn(h) + self.mlp(h)
        h = self.ln1(x) if self.pre_layernorm else x
        x = x + self.attn(h)
        if self.post_layernorm:
            x = self.ln1_post(x)
        h = self.ln2(x) if self.pre_layernorm else x
        x = x + self.mlp(h)
        if self.post_layernorm:
            x = self.ln2_post(x)
        return x


class TransformerLM(nn.Module):
    """Embeddings + transformer stack + (tied) LM head."""

    def __init__(self, vocab_size, max_len, d_model, n_layers, n_heads,
                 d_ff=None, dropout=0.0, pos_type="learned", tie_weights=True,
                 parallel_block=False, attention_in_fp32=False,
                 window: Optional[int] = None, rotary_dim=None,
                 deterministic=True, ln_eps=1e-5, label_smoothing=0.0,
                 decode=False, decode_cache_len=None, paged_blocks=None,
                 paged_block_tokens=None, device=None):
        super().__init__()
        if pos_type not in ("learned", "none"):
            raise _not_ported(f"pos_type={pos_type!r}", "long-context slice")
        self.config = dict(
            vocab_size=vocab_size, max_len=max_len, d_model=d_model,
            n_layers=n_layers, n_heads=n_heads, d_ff=d_ff, dropout=dropout,
            pos_type=pos_type, tie_weights=tie_weights,
            parallel_block=parallel_block, attention_in_fp32=attention_in_fp32,
            window=window, rotary_dim=rotary_dim, deterministic=deterministic,
            ln_eps=ln_eps, label_smoothing=label_smoothing, decode=decode,
            decode_cache_len=decode_cache_len, paged_blocks=paged_blocks,
            paged_block_tokens=paged_block_tokens,
        )
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.pos_type = pos_type
        self.tie_weights = tie_weights
        self.decode = decode
        self.label_smoothing = label_smoothing
        self.wte = nn.Embedding(vocab_size, d_model, device=device)
        if pos_type == "learned":
            self.wpe = nn.Embedding(max_len, d_model, device=device)
        self.layers = nn.ModuleList(
            TransformerLayer(
                d_model, n_heads, d_ff or 4 * d_model, dropout,
                attention_in_fp32=attention_in_fp32, window=window,
                parallel_block=parallel_block, deterministic=deterministic,
                ln_eps=ln_eps, decode=decode, decode_cache_len=decode_cache_len,
                paged_blocks=paged_blocks,
                paged_block_tokens=paged_block_tokens, device=device,
            )
            for _ in range(n_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=ln_eps, device=device)
        if not tie_weights:
            self.lm_head = nn.Linear(d_model, vocab_size, bias=False, device=device)
        # Absolute position of the next token under decode: learned
        # positions need it before the layer stack.
        self.position_index = 0

    def clone(self, **overrides):
        """A module of this config with ``overrides``, sharing (not copying)
        this module's parameters: the counterpart of flax ``Module.clone``,
        used for the decode clone."""
        new = type(self)(**{**self.config, **overrides}, device="meta")
        new.load_state_dict(self.state_dict(), assign=True)
        return new

    def embed(self, ids):
        x = self.wte(ids)
        if self.pos_type == "learned":
            # Under context parallelism a step holds the rank's shard of
            # each sequence, which starts at cp_rank * Tl.
            start = state.sequence_offset(ids.shape[-1])
            if self.decode:
                start = self.position_index
                self.position_index = start + ids.shape[-1]
            pos = torch.arange(start, start + ids.shape[-1], device=ids.device)
            x = x + self.wpe(pos)[None]
        return x

    def head(self, x, targets=None):
        x = self.ln_f(x)
        if targets is not None and self.tie_weights:
            # Tied head in loss mode: the fused-CE dispatch
            # (nn/cross_entropy.py) decides whether the logits materialize.
            return fused_lm_head_cross_entropy(
                x, self.wte.weight, targets, label_smoothing=self.label_smoothing,
            )
        logits = F.linear(x, self.wte.weight) if self.tie_weights else self.lm_head(x)
        if targets is None:
            return logits
        return masked_vocab_parallel_cross_entropy(
            logits, targets, label_smoothing=self.label_smoothing,
        )

    def forward(self, ids, targets=None):
        """ids [B, T] -> logits [B, T, V]; with ``targets`` ([B, T] int,
        -100 = ignored) -> per-token fp32 losses [B, T] instead. Loss mode
        needs pipeline degree 1, as in the JAX package."""
        if targets is not None and state.cfg is not None and state.cfg.pipeline_parallel_degree > 1:
            raise ValueError(
                "model(ids, targets=...) is not available under "
                "pipeline parallelism; compute the loss from logits."
            )
        x = self.embed(ids)
        for layer in self.layers:
            x = layer(x)
        return self.head(x, targets)

