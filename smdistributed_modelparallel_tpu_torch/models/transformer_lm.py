"""Decoder-only transformer LM, the flagship model family.

Counterpart of ``smdistributed_modelparallel_tpu/models/transformer_lm.py``
(``CausalSelfAttention``, ``TransformerLayer``, ``TransformerLM``) as
``torch.nn`` modules. Submodule names follow the flax parameter tree
(``wte``, ``wpe``, ``layers.<i>.attn.qkv``, ``ln_f``, ...), so
``convert.params_from_jax`` maps one onto the other; the flax ``nn.scan``
layer stack is an ``nn.ModuleList`` here.

``pipeline_spec()`` decomposes it for pipeline parallelism: ``embed``, the
layers (``apply_layers`` runs a stage's range) and ``head``.

Supported: learned, rotary (NeoX half-split, on the first ``rotary_dim``
channels) or no positions, a local-attention ``window``, parallel (GPT-J)
blocks, pre/post LayerNorm, tied or untied head, loss mode
(``model(ids, targets=...)`` -> per-token losses, with label smoothing),
the KV-cache decode clone that ``generate`` drives, the paged clone that
``serving.ServingEngine`` drives (``paged_blocks``: K/V in a block pool
shared by every sequence, ``nn/utils.PagedKVCache``, with the per-call block
tables and positions passed as ``forward(ids, paged=...)``), and
training-time dropout (``dropout > 0`` with ``deterministic=False``: the
attention probabilities and each block's output, with the JAX package's
keys, scopes "layers/block/attn" and "layers/block/Dropout_0";
``nn/utils.make_rng``).
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
from smdistributed_modelparallel_tpu_torch.nn.transformer import apply_rotary
from smdistributed_modelparallel_tpu_torch.nn.utils import DecodeKVCache, PagedKVCache, dropout, make_rng
from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention.

    ``decode=True`` enables the KV-cache path: the first call on a fresh
    cache (the prefill) attends causally over its own chunk and keeps the
    flash-attention path; every later T=1 call attends over the cache.
    ``paged_blocks`` enables the paged path of the serving engine: K/V go
    into the layer's block pool (``cache``, a ``PagedKVCache`` the engine
    creates, or created at the first call) and each call attends over its
    sequence's gathered blocks under a position mask, on the plain path.
    With ``rotary``, q and k rotate at their absolute positions before K
    enters either cache.
    """

    def __init__(self, d_model, n_heads, dropout=0.0, attention_in_fp32=False,
                 rotary=False, rotary_dim=None, window=None,
                 deterministic=True, decode=False, decode_cache_len=None,
                 paged_blocks=None, paged_block_tokens=None, device=None):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.dropout = dropout
        self.attention_in_fp32 = attention_in_fp32
        self.rotary = rotary
        self.rotary_dim = rotary_dim
        self.window = window
        self.deterministic = deterministic
        self.decode = decode
        self.decode_cache_len = decode_cache_len
        self.paged_blocks = paged_blocks
        self.paged_block_tokens = paged_block_tokens
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.proj = nn.Linear(d_model, d_model, device=device)
        self.cache = None

    def forward(self, x, paged=None):
        B, T, D = x.shape
        H = self.n_heads
        hd = D // H
        q, k, v = self.qkv(x).split(D, dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, H, hd)
        v = v.reshape(B, T, H, hd)
        if self.paged_blocks is not None:
            if paged is None:
                raise ValueError(
                    "paged KV-cache decoding needs the per-call paged state (block_tables/positions): drive "
                    "this module through smp.serving.ServingEngine."
                )
            if self.cache is None:
                self.cache = PagedKVCache(self.paged_blocks, self.paged_block_tokens, H, hd, k.dtype, k.device)
            pos_offset = paged["positions"]
        elif self.decode:
            if self.cache is None:
                self.cache = DecodeKVCache(
                    (B, self.decode_cache_len, H, hd), k.dtype, k.device
                )
            pos_offset = self.cache.index
        else:
            # Under context parallelism a step holds the rank's shard of
            # each sequence, which starts at cp_rank * T.
            pos_offset = state.sequence_offset(T)
        if self.rotary:
            # The caches hold post-rotary K: a chunk rotates at its absolute
            # positions once, on write.
            q, k = apply_rotary(q, k, self.rotary_dim or hd, neox_style=True, offset=pos_offset)
        decode_mask = None
        if self.paged_blocks is not None:
            k, v, decode_mask = self.cache.append(
                k, v, paged["block_tables"], paged["positions"], valid=paged.get("valid"), window=self.window,
            )
        elif self.decode:
            k, v, decode_mask = self.cache.append(k, v, window=self.window)
        drop_rng = None
        if self.dropout > 0.0 and not self.deterministic:
            drop_rng = make_rng(self, "dropout")
        out = attention_core(
            q, k, v,
            causal=decode_mask is None,
            window=self.window if decode_mask is None else None,
            mask=decode_mask,
            attention_in_fp32=self.attention_in_fp32,
            dropout_rate=self.dropout if not self.deterministic else 0.0,
            dropout_rng=drop_rng,
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
        self.dropout = dropout
        self.deterministic = deterministic
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

    def forward(self, x, paged=None):
        if self.parallel_block:
            h = self.ln1(x)
            x = x + self.attn(h, paged=paged) + self.mlp(h)
        else:
            h = self.ln1(x) if self.pre_layernorm else x
            x = x + self.attn(h, paged=paged)
            if self.post_layernorm:
                x = self.ln1_post(x)
            h = self.ln2(x) if self.pre_layernorm else x
            x = x + self.mlp(h)
            if self.post_layernorm:
                x = self.ln2_post(x)
        if self.dropout > 0.0 and not self.deterministic:
            x = dropout(x, self.dropout, make_rng(self, "dropout", "Dropout_0"))
        return x


class TransformerLM(nn.Module):
    """Embeddings + transformer stack + (tied) LM head."""

    _flax_scan_body = "block"  # layers is flax's nn.scan over "block"

    def __init__(self, vocab_size, max_len, d_model, n_layers, n_heads,
                 d_ff=None, dropout=0.0, pos_type="learned", tie_weights=True,
                 parallel_block=False, attention_in_fp32=False,
                 window: Optional[int] = None, rotary_dim=None,
                 deterministic=True, ln_eps=1e-5, label_smoothing=0.0,
                 decode=False, decode_cache_len=None, paged_blocks=None,
                 paged_block_tokens=None, device=None):
        super().__init__()
        if pos_type not in ("learned", "rotary", "none"):
            raise ValueError(f"pos_type must be 'learned', 'rotary' or 'none', got {pos_type!r}")
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
                attention_in_fp32=attention_in_fp32, rotary=pos_type == "rotary",
                rotary_dim=rotary_dim, window=window,
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
        used for the decode clone of ``generate`` and the paged clone of the
        serving engine (``paged_blocks=..., paged_block_tokens=...,
        deterministic=True, decode=False, decode_cache_len=None``)."""
        new = type(self)(**{**self.config, **overrides}, device="meta")
        new.load_state_dict(self.state_dict(), assign=True)
        return new

    def embed(self, ids, paged=None):
        x = self.wte(ids)
        if self.pos_type == "learned":
            if paged is not None:
                # Per-row absolute positions: continuous batching mixes
                # sequences at different depths in one decode batch.
                pos = paged["positions"].long()[:, None] + torch.arange(ids.shape[-1], device=ids.device)[None, :]
                return x + self.wpe(pos.clamp(0, self.max_len - 1))
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

    def forward(self, ids, targets=None, paged=None):
        """ids [B, T] -> logits [B, T, V]; with ``targets`` ([B, T] int,
        -100 = ignored) -> per-token fp32 losses [B, T] instead. Loss mode
        needs pipeline degree 1, as in the JAX package. ``paged`` is the
        serving engine's per-call state (``block_tables``, ``positions`` and
        optionally ``valid``), for a ``paged_blocks`` clone only."""
        if targets is not None and state.cfg is not None and state.cfg.pipeline_parallel_degree > 1:
            raise ValueError(
                "model(ids, targets=...) is not available under "
                "pipeline parallelism; compute the loss from logits."
            )
        return self.head(self.trunk(ids, paged=paged), targets)

    def trunk(self, ids, paged=None):
        """The embedding and the layers: ids [B, T] -> hidden [B, T, D]
        before the final norm and the head (the serving engine's prefill
        stops here on a chunk that samples nothing)."""
        x = self.embed(ids, paged=paged)
        for layer in self.layers:
            x = layer(x, paged=paged)
        return x

    def apply_layers(self, x, start, end):
        """Layers ``[start, end)`` on the hidden ``x``: a pipeline stage's
        work (``pipeline_spec``)."""
        for layer in self.layers[start:end]:
            x = layer(x)
        return x

    def pipeline_spec(self):
        """The JAX module's decomposition (``layer_path="layers/block"``):
        ``embed``, the layer stack, ``head``."""
        from smdistributed_modelparallel_tpu_torch.parallel.pipeline import PipelineSpec

        return PipelineSpec(layer_path="layers/block", num_layers=len(self.layers), layer_module=self.layers,
                            hidden_size=self.wte.embedding_dim, seq_len=self.max_len)

