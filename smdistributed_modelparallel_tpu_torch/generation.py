"""Autoregressive generation with KV caches: ``smp.generate``.

Counterpart of ``smdistributed_modelparallel_tpu/generation.py`` for
decoder-only models. A prefill pass over the prompt (the flash-attention
path when the prompt is long enough) is followed by single-token decode
steps, with greedy / temperature / top-k / top-p sampling and per-row EOS
freezing. The JAX package compiles the whole loop into one program; here it
is a Python loop of eager steps. Beams, seq2seq models, padded prompts
(``attention_mask``), shape buckets and int8 decode weights arrive with
later slices and raise ``NotImplementedError`` until then.
"""

import os

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.utils import half_cast
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


def _top_k_filter(logits, top_k):
    top_k = min(top_k, logits.shape[-1])  # HF convention: clamp to vocab
    kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
    return torch.where(logits >= kth, logits, -torch.inf)


def _top_p_filter(logits, top_p):
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens whose cumulative probability BEFORE them is < top_p
    # (always keeps the most likely token).
    keep = (cum - probs) < top_p
    thresh = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, -torch.inf)


def _make_sampler(temperature, top_k, top_p):
    if temperature == 0.0:
        return lambda logits, rng: torch.argmax(logits, dim=-1)

    def sample(logits, rng):
        logits = logits / temperature
        if top_k is not None:
            logits = _top_k_filter(logits, top_k)
        if top_p is not None:
            logits = _top_p_filter(logits, top_p)
        probs = torch.softmax(logits, dim=-1).to(rng.device)
        return torch.multinomial(probs, 1, generator=rng)[:, 0].to(logits.device)

    return sample


def _not_ported(what):
    return NotImplementedError(
        f"smp.generate: {what} is not ported to PyTorch yet (a later slice)."
    )


def _decode_clone(module, cache_len, half):
    """The decode-mode copy of ``module`` on half-cast parameters (shared,
    not copied, when no cast applies)."""
    try:
        decode_mod = module.clone(
            decode=True, decode_cache_len=cache_len, deterministic=True
        )
    except (AttributeError, TypeError) as e:
        raise SMPValidationError(
            f"{type(module).__name__} does not support KV-cache decoding "
            "(needs clone() with decode/decode_cache_len/deterministic — the "
            "TransformerLM zoo family does)."
        ) from e
    if half is not None:
        decode_mod.load_state_dict(half_cast(module.state_dict(), half), assign=True)
    return decode_mod


def _decode_loop(decode_mod, ids, max_new_tokens, sampler, eos_token_id,
                 pad_token_id, rng):
    """Prefill, then sample-feed-sample: returns the [B, max_new_tokens]
    generated ids."""
    logits = decode_mod(ids)
    tok = sampler(logits[:, -1].float(), rng)
    done = torch.zeros_like(tok, dtype=torch.bool)
    if eos_token_id is not None:
        done = tok == eos_token_id
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits = decode_mod(tok[:, None])
        nxt = sampler(logits[:, -1].float(), rng)
        if eos_token_id is not None:
            nxt = torch.where(done, pad_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def generate(model, input_ids, max_new_tokens, *, temperature=0.0,
             top_k=None, top_p=None, eos_token_id=None, pad_token_id=0,
             rng=None, params=None, encoder_mask=None, attention_mask=None,
             decoder_start_token_id=0, num_beams=1, length_penalty=1.0,
             num_return_sequences=1):
    """Generate ``max_new_tokens`` continuation tokens for each prompt.

    Args:
      model: a ``DistributedModel`` wrapping a decode-capable LM (the
        ``TransformerLM`` zoo family), or such a module directly (then
        ``params``, a state dict, is required).
      input_ids: [B, T] int prompt tokens (unpadded).
      max_new_tokens: number of tokens to append.
      temperature: 0.0 = greedy argmax (default); > 0 samples.
      top_k / top_p: optional sampling filters (compose: k then p).
      eos_token_id: when set, rows that emit EOS are frozen and padded with
        ``pad_token_id`` for the remaining steps.
      rng: ``torch.Generator`` for sampling (required when temperature > 0);
        sampling runs on its device.
      params: state dict override (defaults to the model's).
    The other arguments keep the JAX package's surface; beams, seq2seq and
    ``attention_mask`` are not ported yet.

    Returns: [B, T + max_new_tokens] — prompts with continuations.
    """
    if state.cfg is not None and state.cfg.pipeline_parallel_degree > 1:
        raise _not_ported("pipeline_parallel_degree > 1")
    if max_new_tokens < 1:
        raise SMPValidationError("max_new_tokens must be >= 1.")
    if hasattr(model, "module"):  # DistributedModel
        module = model.module
    else:
        module = model
        if params is None:
            raise SMPValidationError(
                "generate(module, ...) requires params=..."
            )
    if hasattr(module, "encode") and hasattr(module, "decode_step"):
        raise _not_ported("seq2seq generation")
    if encoder_mask is not None:
        raise SMPValidationError(
            "decoder-only models take attention_mask, not encoder_mask."
        )
    if attention_mask is not None:
        raise _not_ported("padded prompts (attention_mask)")
    if temperature < 0.0:
        raise SMPValidationError(
            "temperature must be >= 0 (0 = greedy); a negative value "
            "would sample from the probability-inverted distribution."
        )
    if temperature > 0.0 and rng is None:
        raise SMPValidationError("temperature > 0 requires rng=torch.Generator(...)")
    if temperature == 0.0 and num_beams == 1 and (
        top_k is not None or top_p is not None
    ):
        raise SMPValidationError(
            "top_k/top_p have no effect with temperature == 0 (greedy "
            "argmax); pass temperature > 0 to sample (e.g. temperature"
            "=1.0), or drop the filters."
        )
    if top_k is not None and top_k < 1:
        raise SMPValidationError("top_k must be >= 1.")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise SMPValidationError("top_p must be in (0, 1].")
    if num_beams > 1 and (temperature > 0.0 or top_k is not None
                          or top_p is not None):
        raise SMPValidationError(
            "beam search is greedy (num_beams > 1 requires temperature == "
            "0 and no top_k/top_p filters)."
        )
    if not 1 <= num_return_sequences <= num_beams:
        raise SMPValidationError(
            "num_return_sequences must be in [1, num_beams]."
        )
    if num_beams > 1:
        raise _not_ported("beam search")
    if any(part.partition(":")[0].strip() == "seq"
           for part in os.environ.get("SMP_SHAPE_BUCKETS", "").split(";")):
        raise _not_ported("decode-length shape buckets (SMP_SHAPE_BUCKETS)")
    if os.environ.get("SMP_DECODE_WEIGHTS", "").strip().lower() == "int8":
        raise _not_ported("int8 decode weights (SMP_DECODE_WEIGHTS=int8)")

    device = next(module.parameters()).device
    input_ids = torch.as_tensor(input_ids, device=device)
    B, T = input_ids.shape
    cache_len = T + max_new_tokens
    limit = getattr(module, "max_len", None)
    if limit is not None and cache_len > limit:
        raise SMPValidationError(
            f"prompt + max_new_tokens ({cache_len}) exceeds the model's "
            f"position limit ({limit})."
        )

    half = state.cfg.half_dtype if state.cfg is not None else None
    with torch.inference_mode():
        if params is not None:
            module = module.clone()
            module.load_state_dict(params, assign=True)
        decode_mod = _decode_clone(module, cache_len, half)
        sampler = _make_sampler(float(temperature), top_k, top_p)
        new_tokens = _decode_loop(
            decode_mod, input_ids, max_new_tokens, sampler, eos_token_id,
            pad_token_id, rng,
        ).to(input_ids.dtype)
        return torch.cat([input_ids, new_tokens], dim=1)
