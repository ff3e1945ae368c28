"""Encoder-decoder (T5-style) model from ``smp.nn`` pieces.

Counterpart of ``smdistributed_modelparallel_tpu/models/encoder_decoder.py``
on one device: a bidirectional encoder stack, a causal decoder stack with
cross-attention, shared token embeddings and a tied (or untied) LM head, all
on ``smp.nn.DistributedTransformer``, so the fused QKV, the flash kernels and
activation checkpointing apply as they do to the LM head.

Two dialects, as in the JAX package:

- the default: learned absolute positions and LayerNorm;
- ``t5_compat=True``: HF-T5-weight-compatible: RMSNorm, one bucketed
  relative-position bias table a stack shared by its layers, no absolute
  positions, bias-free dense layers, unscaled scores, ``NEG`` as the mask
  value and the tied head's ``d_model ** -0.5``. ``nn/huggingface/t5.py``
  builds this dialect from an HF ``T5Config``. The relative bias reaches
  attention as a per-head additive mask, which keeps every layer on the plain
  attention path, as the JAX gate does.

Module names follow the flax tree (``shared_embedding``, ``enc_rel_bias``,
``dec_rel_bias``, ``enc_position_embedding``, ``dec_position_embedding``,
``encoder``, ``encoder_ln``, ``decoder``, ``decoder_ln``, ``lm_head``), so
``convert.encdec_params_from_jax`` maps the JAX tree onto it and the dropout
keys come from the JAX package's scopes (``decoder/.../crossattention``
included).

Generation (``smp.generate``'s seq2seq branch) calls ``encode`` once and then
``decode_step`` on a ``clone(decode=True, ...)``: the decoder's
self-attention layers keep KV caches, its cross-attention layers the encoder
K/V of their first call, and ``decoder_position`` counts the decoder tokens
seen (the JAX module's ``cache/decoder_position``).

Not ported yet: ``pipeline_spec`` (the decoder stack as pipeline stages; the
pipeline slice) and tensor parallelism (``forward`` and ``encode`` raise at
tp > 1, ROADMAP item 7b).
"""

from typing import Optional

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
from smdistributed_modelparallel_tpu_torch.nn.layer_norm import DistributedLayerNorm
from smdistributed_modelparallel_tpu_torch.nn.transformer import (
    DistributedTransformer,
    _linear,
    _normal_,
    _not_ported,
    refuse_tp,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

NEG = -1e9


def relative_position_bucket(rel_pos, *, bidirectional, num_buckets, max_distance):
    """T5's log-spaced relative-position buckets of ``rel_pos`` (memory
    position minus query position, an integer tensor), as the JAX function
    computes them in fp32."""
    ret = torch.zeros_like(rel_pos)
    n = num_buckets
    if bidirectional:
        n = n // 2
        ret = ret + (rel_pos > 0).to(rel_pos.dtype) * n
        rel = rel_pos.abs()
    else:
        rel = -torch.clamp_max(rel_pos, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    # jnp.log(max_distance / max_exact): an fp32 log.
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32, device=rel_pos.device))
    log_big = max_exact + (
        torch.log(rel.clamp_min(1).float() / max_exact) / denom * (n - max_exact)
    ).to(torch.int32).to(rel_pos.dtype)
    log_big = torch.clamp_max(log_big, n - 1)
    return ret + torch.where(is_small, rel, log_big)


class EncoderDecoderLM(nn.Module):
    """Seq2seq LM: encoder ids and decoder ids -> decoder logits, with the
    JAX module's fields as keyword arguments (same names and defaults)."""

    def __init__(self, vocab_size, d_model, enc_layers, dec_layers, n_heads, d_ff, max_len, d_kv: Optional[int] = None,
                 dropout=0.0, initializer_range=0.02, activation="gelu", activation_checkpointing=False,
                 distribute_embedding=False, t5_compat=False, gated_mlp=False, tie_embeddings=True,
                 relative_attention_num_buckets=32, relative_attention_max_distance=128, layernorm_epsilon=1e-5,
                 decode=False, decode_cache_len=None, deterministic=None, dtype=None, device=None):
        config = {k: v for k, v in locals().items() if k not in ("self", "__class__", "device")}
        super().__init__()
        self.config = config  # the constructor's arguments, for clone()
        D, H = d_model, n_heads
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_attention_heads = H
        self.max_len = max_len
        self.t5_compat = t5_compat
        self.tie_embeddings = tie_embeddings
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.decode = decode
        self.decode_cache_len = decode_cache_len
        self.decoder_position = 0  # under decode: the decoder tokens seen so far
        kw = dict(dtype=dtype, device=device)
        common = dict(
            num_attention_heads=H, attention_head_size=d_kv or D // H, hidden_size=D, intermediate_size=d_ff,
            attention_dropout_prob=dropout, hidden_dropout_prob=dropout, activation=activation, pre_layernorm=True,
            post_layernorm=False, initializer_range=initializer_range,
            activation_checkpointing=activation_checkpointing, layernorm_epsilon=layernorm_epsilon,
            deterministic=deterministic, gated_mlp=gated_mlp, **kw,
        )
        if t5_compat:
            common.update(layernorm_type="rms", use_mlp_bias=False, use_qkv_bias=False, use_attn_dense_bias=False,
                          scale_attention_scores=False, mask_value=NEG)
        if distribute_embedding:
            self.shared_embedding = DistributedEmbedding(vocab_size, D, split="vocab", init_scale=initializer_range,
                                                         **kw)
            tables = []
        else:
            self.shared_embedding = nn.Embedding(vocab_size, D, **kw)
            tables = [self.shared_embedding]
        if t5_compat:
            # One bucketed bias table a stack, shared by its layers.
            self.enc_rel_bias = nn.Embedding(relative_attention_num_buckets, H, **kw)
            self.dec_rel_bias = nn.Embedding(relative_attention_num_buckets, H, **kw)
            tables += [self.enc_rel_bias, self.dec_rel_bias]
        else:
            self.enc_position_embedding = nn.Embedding(max_len, D, **kw)
            self.dec_position_embedding = nn.Embedding(max_len, D, **kw)
            tables += [self.enc_position_embedding, self.dec_position_embedding]
        rms = t5_compat
        self.encoder = DistributedTransformer(num_layers=enc_layers, causal_mask_size=None, **common)
        self.encoder_ln = DistributedLayerNorm(D, epsilon=layernorm_epsilon, rms=rms, use_bias=not rms, **kw)
        self.decoder = DistributedTransformer(num_layers=dec_layers, causal_mask_size=max_len,
                                              add_cross_attention=True, decode=decode,
                                              decode_cache_len=decode_cache_len, **common)
        self.decoder_ln = DistributedLayerNorm(D, epsilon=layernorm_epsilon, rms=rms, use_bias=not rms, **kw)
        if not tie_embeddings:
            self.lm_head = nn.Linear(D, vocab_size, bias=False, **kw)
            tables.append(self.lm_head)
        _normal_(tables, initializer_range)

    @property
    def activation_checkpointing(self):
        """The flax field: whether both stacks checkpoint their layers."""
        return self.encoder.activation_checkpointing and self.decoder.activation_checkpointing

    @activation_checkpointing.setter
    def activation_checkpointing(self, on):
        self.encoder.activation_checkpointing = on
        self.decoder.activation_checkpointing = on

    def clone(self, **overrides):
        """A module of this config with ``overrides``, sharing (not copying)
        this module's parameters (flax ``Module.clone``; ``smp.generate``'s
        decode copy)."""
        config = dict(self.config, activation_checkpointing=self.activation_checkpointing)
        new = type(self)(**{**config, **overrides}, device="meta")
        new.load_state_dict(self.state_dict(), assign=True)
        return new

    # -- masks and biases ------------------------------------------------

    @staticmethod
    def _pad4d(encoder_mask):
        """[B, S] or [B, 1, 1, S] padding mask -> additive fp32 [B, 1, 1, S].
        Boolean and integer masks are keep-flags (HF's int64 0/1 attention
        masks), floats are additive already."""
        if encoder_mask is None:
            return None
        if encoder_mask.dim() == 2:
            encoder_mask = encoder_mask[:, None, None, :]
        if not encoder_mask.is_floating_point():
            return torch.where(encoder_mask != 0, 0.0, NEG).float()
        return encoder_mask.float()

    def _bias(self, table, ctx, mem, bidirectional):
        """[1, H, T, S] fp32 additive bias of the query positions ``ctx``
        [T, 1] against the memory positions ``mem`` [1, S]."""
        buckets = relative_position_bucket(mem - ctx, bidirectional=bidirectional,
                                           num_buckets=self.relative_attention_num_buckets,
                                           max_distance=self.relative_attention_max_distance)
        return table(buckets).permute(2, 0, 1)[None].float()

    def _rel_bias(self, table, T, S, bidirectional, device):
        return self._bias(table, torch.arange(T, device=device)[:, None], torch.arange(S, device=device)[None, :],
                          bidirectional)

    # -- the forward, as the JAX package decomposes it --------------------

    def embed(self, encoder_ids, decoder_ids, encoder_mask=None):
        """Everything before the decoder stack: the embeddings, the whole
        encoder and the decoder's carry ``(hidden, cross_states, (self_mask,
        cross_mask))``."""
        pad = self._pad4d(encoder_mask)
        h_e = self.encode(encoder_ids, encoder_mask)
        T = decoder_ids.shape[-1]
        dev = decoder_ids.device
        if self.t5_compat:
            dec_mask = self._rel_bias(self.dec_rel_bias, T, T, False, dev)
            h_d = self.shared_embedding(decoder_ids)
        else:
            dec_mask = None
            h_d = self.shared_embedding(decoder_ids) + self.dec_position_embedding(torch.arange(T, device=dev)[None])
        # The decoder's mask slot carries (self_mask, cross_mask): the relative
        # bias on self-attention, the encoder padding on cross-attention.
        masks = (dec_mask, pad) if dec_mask is not None or pad is not None else None
        return h_d, h_e, masks

    def head(self, carry):
        h_d = carry[0] if isinstance(carry, tuple) else carry
        h_d = self.decoder_ln(h_d)
        if not self.tie_embeddings:
            # The untied head (T5 v1.1) is not rescaled; flax Dense promotes.
            dtype = torch.promote_types(h_d.dtype, self.lm_head.weight.dtype)
            return _linear(h_d.to(dtype), self.lm_head.weight)
        if self.t5_compat:
            h_d = h_d * torch.tensor(self.d_model ** -0.5, dtype=h_d.dtype, device=h_d.device)
        if isinstance(self.shared_embedding, DistributedEmbedding):
            return self.shared_embedding.attend(h_d)
        w = self.shared_embedding.weight
        dtype = torch.promote_types(h_d.dtype, w.dtype)  # flax Embed.attend promotes
        return torch.nn.functional.linear(h_d.to(dtype), w.to(dtype))

    def forward(self, encoder_ids, decoder_ids, encoder_mask=None):
        refuse_tp("the encoder-decoder")
        h_d, h_e, masks = self.embed(encoder_ids, decoder_ids, encoder_mask)
        h_d = self.decoder(h_d, cross_states=h_e, attention_mask=masks)
        return self.head(h_d)

    # -- generation (smp.generate's seq2seq branch) ------------------------

    def encode(self, encoder_ids, encoder_mask=None):
        """The encoder alone: run once a generation."""
        refuse_tp("the encoder-decoder")
        pad = self._pad4d(encoder_mask)
        S = encoder_ids.shape[-1]
        dev = encoder_ids.device
        if self.t5_compat:
            enc_mask = self._rel_bias(self.enc_rel_bias, S, S, True, dev)
            if pad is not None:
                enc_mask = enc_mask + pad
            h_e = self.shared_embedding(encoder_ids)
        else:
            enc_mask = pad
            h_e = self.shared_embedding(encoder_ids) + self.enc_position_embedding(torch.arange(S, device=dev)[None])
        return self.encoder_ln(self.encoder(h_e, attention_mask=enc_mask))

    def decode_step(self, decoder_ids, encoder_hidden, encoder_mask=None):
        """One KV-cached decoder chunk (``decode=True``): embeds
        ``decoder_ids`` at its absolute position, runs the decoder over the
        caches and returns the chunk's logits."""
        if not self.decode:
            raise SMPValidationError("decode_step needs the decode copy: clone(decode=True, decode_cache_len=...).")
        pad = self._pad4d(encoder_mask)
        T = decoder_ids.shape[-1]
        dev = decoder_ids.device
        start = self.decoder_position
        self.decoder_position = start + T
        if self.t5_compat:
            # Bias rows at the chunk's absolute positions: a T = 1 step attends
            # the whole cache (the layer adds the <= index mask), a T > 1 first
            # chunk attends itself, so its columns are its own positions.
            ctx = start + torch.arange(T, device=dev)[:, None]
            if T > 1:
                mem = start + torch.arange(T, device=dev)[None, :]
            else:
                mem = torch.arange(self.decode_cache_len, device=dev)[None, :]
            dec_mask = self._bias(self.dec_rel_bias, ctx, mem, False)
            h_d = self.shared_embedding(decoder_ids)
        else:
            dec_mask = None
            h_d = (self.shared_embedding(decoder_ids)
                   + self.dec_position_embedding(start + torch.arange(T, device=dev)[None]))
        masks = (dec_mask, pad) if dec_mask is not None or pad is not None else None
        h_d = self.decoder(h_d, cross_states=encoder_hidden, attention_mask=masks)
        return self.head(h_d)

    def pipeline_spec(self):
        raise _not_ported("EncoderDecoderLM.pipeline_spec (the decoder stack as pipeline stages)",
                          "a later part of the pipeline slice, ROADMAP item 8")


_CONFIGS = {
    # BASELINE #5's shape: T5-3B (d_kv 128 -> 4096-wide attention; ~2.8B
    # parameters).
    "t5_style_3b": dict(d_model=1024, enc_layers=24, dec_layers=24, n_heads=32, d_kv=128, d_ff=16384),
    "t5_style_small": dict(d_model=512, enc_layers=6, dec_layers=6, n_heads=8, d_kv=64, d_ff=2048),
}


def t5_style(size="t5_style_small", vocab_size=32128, max_len=512, **overrides):
    cfg = dict(_CONFIGS[size])
    cfg.update(vocab_size=vocab_size, max_len=max_len)
    cfg.update(overrides)
    return EncoderDecoderLM(**cfg)


def t5_style_3b(**overrides):
    return t5_style("t5_style_3b", **overrides)


__all__ = ["EncoderDecoderLM", "NEG", "relative_position_bucket", "t5_style", "t5_style_3b"]
