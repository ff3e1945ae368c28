"""Autoregressive generation with KV caches: ``smp.generate``.

Counterpart of ``smdistributed_modelparallel_tpu/generation.py`` for
decoder-only models (the zoo ``TransformerLM`` and ``smp.nn``'s
``DistributedTransformerLMHead``) and the zoo's seq2seq ``EncoderDecoderLM``.
A prefill pass over the prompt (the flash-attention path when the prompt is
long enough) is followed by
single-token decode steps, with greedy / temperature / top-k / top-p
sampling and per-row EOS freezing, or with beam search. The JAX package
compiles the whole loop into one program; here it is a Python loop of eager
steps. Sampling takes the JAX package's key schedule: ``rng`` is a key
(``utils/random.key(seed)``, or a JAX key's data through
``convert.key_from_jax``), split once into one key a new token, and each
token is ``categorical(key, logits)``: the argmax of the filtered logits plus
a Gumbel draw, whose bits come from ``csrc/dropout.cu``'s threefry kernel on
the card. With the same weights, prompt and key both packages sample the
same tokens.

Also as in the JAX package: LEFT-padded prompts (``attention_mask``, for a
module whose ``forward`` takes one: each row's positions shift back by its
pad count and pads are never attended), beam search (beams folded into the
batch, HF scoring), decode-length buckets (``SMP_SHAPE_BUCKETS`` "seq"
sizes: the decode length rounds up and a mask-capable module's prompt is
left-padded to a bucket; the extra columns are sliced off) and
``SMP_DECODE_WEIGHTS=int8`` (the weights round-trip through the serving
engine's per-channel int8 grid before the half cast).

Seq2seq models (``encode`` and ``decode_step``: the zoo's
``EncoderDecoderLM``) run the JAX package's seq2seq branch: the encoder once
(``encoder_mask`` for its padding), then ``decoder_start_token_id`` and each
new token through the decoder's caches; the cross-attention K/V of the first
step serve every later one, and the beams of a row share them. The output
is the start token and the new ones. Pipeline parallelism raises
``NotImplementedError``.
"""

import inspect

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.utils import DecodeKVCache, half_cast
from smdistributed_modelparallel_tpu_torch.ops.dropout import categorical
from smdistributed_modelparallel_tpu_torch.utils import exec_cache, random
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
        # A true division, as the JAX package's and the serving engine's: a
        # Python divisor would multiply by its reciprocal on the card.
        logits = logits / torch.full((1,), temperature, dtype=logits.dtype, device=logits.device)
        if top_k is not None:
            logits = _top_k_filter(logits, top_k)
        if top_p is not None:
            logits = _top_p_filter(logits, top_p)
        return categorical(rng, logits, axis=-1)

    return sample


def _not_ported(what):
    return NotImplementedError(
        f"smp.generate: {what} is not ported to PyTorch yet (a later slice)."
    )


def _decode_params(module, half):
    """The decode copy's parameters, or None when ``module``'s own serve:
    under ``SMP_DECODE_WEIGHTS=int8`` the weights round-trip through the
    serving engine's int8 grid first (``quant.fake_quant_decode_params``),
    then the half cast of the training step's compute dtype, as the JAX
    package's ``_half_cast`` does."""
    int8 = quant.decode_weights_mode() == "int8"
    if half is None and not int8:
        return None
    params = module.state_dict()
    if int8:
        params = quant.fake_quant_decode_params(params, module)
    return half_cast(params, half)


def _decode_clone(module, cache_len, half):
    """The decode-mode copy of ``module`` on its decode parameters (shared,
    not copied, when neither int8 nor a half cast applies)."""
    try:
        decode_mod = module.clone(
            decode=True, decode_cache_len=cache_len, deterministic=True
        )
    except (AttributeError, TypeError) as e:
        raise SMPValidationError(
            f"{type(module).__name__} does not support KV-cache decoding "
            "(needs clone() with decode/decode_cache_len/deterministic — the "
            "TransformerLM zoo family, smp.nn DistributedTransformerLMHead and EncoderDecoderLM do)."
        ) from e
    params = _decode_params(module, half)
    if params is not None:
        decode_mod.load_state_dict(params, assign=True)
    return decode_mod


def _step_masks(mask, max_new_tokens):
    """(prefill [B, 1, 1, T], step [B, 1, 1, T + max_new]) boolean masks from
    a [B, T] LEFT-padded prompt mask; the generated columns are kept."""
    mask = mask.bool()
    step = torch.cat([mask, mask.new_ones((mask.shape[0], max_new_tokens))], dim=1)
    return mask[:, None, None, :], step[:, None, None, :]


def _mask_kwargs(mask, max_new_tokens):
    """The prefill's and the steps' keyword arguments for ``mask`` (none
    without one)."""
    if mask is None:
        return {}, {}
    pre, step = _step_masks(mask, max_new_tokens)
    return {"attention_mask": pre}, {"attention_mask": step}


def _decoder_only(decode_mod, ids, mask, max_new_tokens):
    """(first logits, step) of a decoder-only decode copy: the prefill over
    the prompt, and ``step(tok)`` feeding one [B, 1] token chunk."""
    pre_kw, step_kw = _mask_kwargs(mask, max_new_tokens)
    return decode_mod(ids, **pre_kw), lambda tok: decode_mod(tok, **step_kw)


def _seq2seq(decode_mod, enc_ids, enc_mask, start, repeat):
    """(first logits, step) of a seq2seq decode copy: the encoder runs once
    (its states and mask repeated ``repeat`` times a row, for beams), then
    the [B * repeat, 1] ``start`` tokens and every later token through
    ``decode_step`` against the cached cross-attention K/V."""
    h_e = decode_mod.encode(enc_ids, enc_mask).repeat_interleave(repeat, dim=0)
    if enc_mask is not None:
        enc_mask = enc_mask.repeat_interleave(repeat, dim=0)
    return (decode_mod.decode_step(start, h_e, enc_mask),
            lambda tok: decode_mod.decode_step(tok, h_e, enc_mask))


def _decode_loop(first_logits, step, max_new_tokens, sampler, eos_token_id, pad_token_id, rng):
    """Sample-feed-sample from the first logits: returns the [B,
    max_new_tokens] generated ids. Token t is sampled with ``split(rng,
    max_new_tokens)[t]``."""
    rngs = random.split(rng, max_new_tokens)
    tok = sampler(first_logits[:, -1].float(), rngs[0])
    done = torch.zeros_like(tok, dtype=torch.bool)
    if eos_token_id is not None:
        done = tok == eos_token_id
    out = [tok]
    for step_rng in rngs[1:]:
        logits = step(tok[:, None])
        nxt = sampler(logits[:, -1].float(), step_rng)
        if eos_token_id is not None:
            nxt = torch.where(done, pad_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


# ----------------------------------------------------------------------
# Beam search (greedy beams, HF-compatible scoring: length_penalty
# normalization at EOS time, early_stopping=True semantics)
# ----------------------------------------------------------------------

_NEG = -1e9


def _top_k(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _length_norm(scores, length, length_penalty, constant):
    """``scores / float32(length) ** length_penalty`` as the JAX program
    computes it: XLA folds a division by a constant into a multiply by the
    reciprocal (``constant``), and divides by a traced length."""
    d = np.float32(length) ** np.float32(length_penalty)
    if constant:
        return scores * float(np.float32(1.0) / d)
    return scores / torch.full((1,), float(d), dtype=scores.dtype, device=scores.device)


def _reorder_caches(decode_mod, parent_flat):
    """Gather every decode cache of ``decode_mod`` along the folded [B*N]
    beam axis to the surviving parents."""
    for m in decode_mod.modules():
        cache = getattr(m, "cache", None)
        if isinstance(cache, DecodeKVCache):
            cache.reorder(parent_flat)


def _beam_search(decode_mod, first_logits, step_fn, B, max_new_tokens, num_beams, eos_token_id,
                 pad_token_id, length_penalty, num_return_sequences):
    """The JAX package's ``_build_beam_generator``: returns the [B, max_new]
    (or, R > 1, [B, R, max_new]) generated ids.

    Beams fold into the batch (the caller repeats the prompt, or the
    encoder's states, N times a row: ``first_logits`` and ``step_fn`` act on
    [B * N] rows); each step takes the top 2N candidates over [N x V] fp32
    log-softmaxes, routes EOS candidates ranked within the top N into a
    best-N finished store (scores over ``(step + 1) ** length_penalty``),
    continues the top N others and gathers the self-attention caches to
    their parents (a row's beams share its encoder K/V)."""
    N = num_beams
    logits = first_logits
    dev = logits.device
    rows = torch.arange(B, device=dev)[:, None]
    # Step 0: the N beams of a row are clones, so only beam 0 proposes (HF
    # seeds the beam scores [0, -inf, ...]).
    beam_scores = torch.full((B, N), _NEG, device=dev)
    beam_scores[:, 0] = 0.0
    seqs = torch.zeros((B, N, max_new_tokens), dtype=torch.long, device=dev)
    fin_scores = torch.full((B, N), _NEG, device=dev)
    fin_seqs = torch.zeros_like(seqs)
    fin_len = torch.zeros((B, N), dtype=torch.long, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    in_top_n = torch.arange(2 * N, device=dev)[None, :] < N
    for step in range(max_new_tokens):
        if step:
            logits = step_fn(tok[:, None])
        logprobs = torch.log_softmax(logits[:, -1].float(), dim=-1)
        V = logprobs.shape[-1]
        cand = beam_scores[:, :, None] + logprobs.reshape(B, N, V)
        s2, i2 = _top_k(cand.reshape(B, N * V), 2 * N)
        tok2, par2 = i2 % V, i2 // V
        if eos_token_id is not None:
            # The finished store: this step's EOS candidates (the parent's
            # sequence without the EOS) merge with the kept hypotheses; the
            # best N stay. Frozen rows (N finished) add nothing.
            eos2 = tok2 == eos_token_id
            norm = _length_norm(s2, step + 1, length_penalty, constant=step == 0)
            cand_fin = torch.where(eos2 & in_top_n & ~stopped[:, None], norm, _NEG)
            all_scores = torch.cat([fin_scores, cand_fin], dim=1)
            all_seqs = torch.cat([fin_seqs, seqs[rows, par2]], dim=1)
            all_len = torch.cat([fin_len, torch.full((B, 2 * N), step, dtype=torch.long, device=dev)], dim=1)
            fin_scores, fidx = _top_k(all_scores, N)
            fin_seqs = torch.take_along_dim(all_seqs, fidx[:, :, None], dim=1)
            fin_len = torch.take_along_dim(all_len, fidx, dim=1)
            stopped = stopped | ((fin_scores > _NEG / 2).sum(dim=1) >= N)
            s2 = torch.where(eos2, _NEG, s2)
        beam_scores, pos = _top_k(s2, N)
        tokN, parN = torch.gather(tok2, 1, pos), torch.gather(par2, 1, pos)
        seqs = seqs[rows, parN]
        seqs[:, :, step] = tokN
        if step + 1 < max_new_tokens:
            _reorder_caches(decode_mod, (rows * N + parN).reshape(-1))
        tok = tokN.reshape(-1)

    # HF's finalize: rows not stopped also offer their live beams, over the
    # full generated length; the best hypotheses win, as hyp + EOS + pad.
    final_norm = _length_norm(beam_scores, max_new_tokens, length_penalty, constant=True)
    live = final_norm if eos_token_id is None else torch.where(~stopped[:, None], final_norm, _NEG)
    all_scores = torch.cat([fin_scores, live], dim=1)
    all_seqs = torch.cat([fin_seqs, seqs], dim=1)
    all_len = torch.cat([fin_len, torch.full((B, N), max_new_tokens, dtype=torch.long, device=dev)], dim=1)
    _, best = _top_k(all_scores, num_return_sequences)
    seq = torch.take_along_dim(all_seqs, best[:, :, None], dim=1)
    length = torch.take_along_dim(all_len, best, dim=1)[:, :, None]
    cols = torch.arange(max_new_tokens, device=dev)[None, None, :]
    eos_fill = eos_token_id if eos_token_id is not None else pad_token_id
    out = torch.where(cols < length, seq, torch.where(cols == length, eos_fill, pad_token_id))
    return out[:, 0] if num_return_sequences == 1 else out


def _takes_mask(module):
    return "attention_mask" in inspect.signature(type(module).forward).parameters


def _bucket(module, input_ids, attention_mask, max_new_tokens, pad_token_id, limit):
    """Decode-length buckets (``SMP_SHAPE_BUCKETS`` "seq" sizes), as the JAX
    package applies them: ``max_new_tokens`` rounds up to a bucket, and a
    mask-capable module's prompt is left-padded to one; a bucket never
    pushes the request past ``limit``. Returns the (possibly padded) ids,
    mask and decode length."""
    sizes = (exec_cache.bucket_policy() or {}).get("seq")
    if not sizes:
        return input_ids, attention_mask, max_new_tokens
    B, T = input_ids.shape
    new_b = exec_cache.bucket_for(max_new_tokens, sizes)
    if new_b is not None and not (limit is not None and T + new_b > limit):
        max_new_tokens = new_b
    t_b = exec_cache.bucket_for(T, sizes)
    if t_b is not None and limit is not None and t_b + max_new_tokens > limit:
        t_b = None
    if t_b is not None and t_b != T and _takes_mask(module):
        pad_w = t_b - T
        input_ids = torch.cat([input_ids.new_full((B, pad_w), pad_token_id), input_ids], dim=1)
        keep = attention_mask.int() if attention_mask is not None else input_ids.new_ones((B, T), dtype=torch.int32)
        attention_mask = torch.cat([keep.new_zeros((B, pad_w)), keep], dim=1)
    return input_ids, attention_mask, max_new_tokens


def generate(model, input_ids, max_new_tokens, *, temperature=0.0,
             top_k=None, top_p=None, eos_token_id=None, pad_token_id=0,
             rng=None, params=None, encoder_mask=None, attention_mask=None,
             decoder_start_token_id=0, num_beams=1, length_penalty=1.0,
             num_return_sequences=1):
    """Generate ``max_new_tokens`` continuation tokens for each prompt.

    Args:
      model: a ``DistributedModel`` wrapping a decode-capable LM (the
        ``TransformerLM`` zoo family, ``smp.nn.DistributedTransformerLMHead``
        or the zoo's seq2seq ``EncoderDecoderLM``, ``smp.from_hf`` models
        included), or such a module directly (then ``params``, a state dict,
        is required).
      input_ids: [B, T] int prompt tokens; the ENCODER input of a seq2seq
        model. Decoder-only prompts of different true lengths are
        LEFT-padded, with ``attention_mask`` marking the real tokens;
        without a mask they are taken as unpadded.
      max_new_tokens: number of tokens to append.
      temperature: 0.0 = greedy argmax (default); > 0 samples.
      top_k / top_p: optional sampling filters (compose: k then p).
      eos_token_id: when set, rows that emit EOS are frozen and padded with
        ``pad_token_id`` for the remaining steps.
      rng: a key for sampling (required when temperature > 0):
        ``utils.random.key(seed)``, or ``convert.key_from_jax`` of a JAX key's
        data to sample the JAX package's tokens. Sampling runs on the
        model's device.
      params: state dict override (defaults to the model's).
      encoder_mask: seq2seq only: [B, T] encoder padding mask (1/True =
        keep; a float mask is additive), for the encoder and the
        cross-attention.
      attention_mask: decoder-only: [B, T] LEFT-padded prompt mask (1/True =
        real token), for a module whose ``forward`` takes one (the smp.nn
        family).
      decoder_start_token_id: seq2seq only: the decoder's first token.
      num_beams: > 1 switches to beam search (greedy beams; temperature 0).
        Hypothesis scores are sum-logprob / (length ** length_penalty) with
        ``early_stopping=True`` semantics.
      num_return_sequences: beams only: the top R hypotheses a row, as a
        [B, R, L] tensor.

    Returns: decoder-only, [B, T + max_new_tokens]: prompts with
    continuations; seq2seq, [B, 1 + max_new_tokens]: the start token and the
    generated ids ([B, R, ...] for R > 1); with beams, a finished hypothesis
    is "hypothesis + EOS + pad".
    """
    # Under context parallelism every rank decodes whole sequences, as the
    # JAX package's program computes them on the global arrays: the same
    # tokens on every rank (only a step shards the sequence).
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
    seq2seq = hasattr(module, "encode") and hasattr(module, "decode_step")
    if encoder_mask is not None and not seq2seq:
        raise SMPValidationError(
            "decoder-only models take attention_mask, not encoder_mask."
        )
    device = next(module.parameters()).device
    input_ids = torch.as_tensor(input_ids, device=device)
    if attention_mask is not None:
        if seq2seq:
            raise SMPValidationError("seq2seq models take encoder_mask, not attention_mask.")
        if not _takes_mask(module):
            raise SMPValidationError(
                f"{type(module).__name__} does not accept attention_mask; padded-prompt generation needs the "
                "smp.nn DistributedTransformerLMHead family."
            )
        attention_mask = torch.as_tensor(attention_mask, device=device)
        if attention_mask.shape != input_ids.shape:
            raise SMPValidationError(
                f"attention_mask shape {tuple(attention_mask.shape)} != prompt shape {tuple(input_ids.shape)}."
            )
        # A right-padded mask would sample the first continuation from a
        # masked pad position's logits.
        m = attention_mask.bool()
        if not bool((m[:, 1:] >= m[:, :-1]).all() and m[:, -1].all()):
            raise SMPValidationError(
                "attention_mask must be LEFT-padded (rows 0..0 1..1 with the last column kept); right-padded "
                "prompts would generate from a pad position."
            )
    if encoder_mask is not None:
        encoder_mask = torch.as_tensor(encoder_mask, device=device)
    if temperature < 0.0:
        raise SMPValidationError(
            "temperature must be >= 0 (0 = greedy); a negative value "
            "would sample from the probability-inverted distribution."
        )
    if temperature > 0.0 and rng is None:
        raise SMPValidationError("temperature > 0 requires rng=utils.random.key(...)")
    if isinstance(rng, torch.Generator):
        raise SMPValidationError(
            "rng is a key, as in the JAX package: utils.random.key(seed), or convert.key_from_jax("
            "jax.random.key_data(k)); a torch.Generator draws other numbers than jax.random."
        )
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
    # The quant knobs are validated here as the JAX package's program key
    # reads them; SMP_KV_QUANT concerns only the serving engine's pools.
    quant.serving_key_suffix()

    rng = random.key(0) if rng is None else random.as_key(rng)
    limit = getattr(module, "max_len", None) or getattr(module, "num_positions", None)
    orig_ids, orig_new = input_ids, max_new_tokens
    if num_beams == 1 and not seq2seq:
        # Beam scores normalize by max_new_tokens: beams never bucket.
        input_ids, attention_mask, max_new_tokens = _bucket(module, input_ids, attention_mask, max_new_tokens,
                                                            pad_token_id, limit)
    B, T = input_ids.shape
    # A seq2seq decoder caches its start token and the generated ones.
    cache_len = 1 + max_new_tokens if seq2seq else T + max_new_tokens
    if limit is not None and cache_len > limit:
        raise SMPValidationError(
            f"{'decoder length' if seq2seq else 'prompt'} + max_new_tokens "
            f"({cache_len}) exceeds the model's position limit ({limit})."
        )
    if limit is not None and seq2seq and T > limit:
        raise SMPValidationError(
            f"encoder prompt length ({T}) exceeds the model's position limit ({limit})."
        )

    half = state.cfg.half_dtype if state.cfg is not None else None
    with torch.inference_mode():
        if params is not None:
            module = module.clone()
            module.load_state_dict(params, assign=True)
        decode_mod = _decode_clone(module, cache_len, half)
        N = num_beams
        if seq2seq:
            start = input_ids.new_full((B * N, 1), decoder_start_token_id)
            first, step = _seq2seq(decode_mod, input_ids, encoder_mask, start, repeat=N)
            prompts = start[::N]
        else:
            mask = None if attention_mask is None else attention_mask.repeat_interleave(N, dim=0)
            first, step = _decoder_only(decode_mod, input_ids.repeat_interleave(N, dim=0), mask, max_new_tokens)
            prompts = input_ids
        if num_beams > 1:
            new_tokens = _beam_search(decode_mod, first, step, B, max_new_tokens, num_beams, eos_token_id,
                                      pad_token_id, float(length_penalty), num_return_sequences)
            new_tokens = new_tokens.to(input_ids.dtype)
            if num_return_sequences > 1:
                prompts = prompts[:, None].expand(B, num_return_sequences, prompts.shape[1])
                return torch.cat([prompts, new_tokens], dim=2)
            return torch.cat([prompts, new_tokens], dim=1)
        sampler = _make_sampler(float(temperature), top_k, top_p)
        new_tokens = _decode_loop(first, step, max_new_tokens, sampler, eos_token_id, pad_token_id,
                                  rng).to(input_ids.dtype)
        if seq2seq:
            return torch.cat([prompts, new_tokens], dim=1)
        # A bucketed run: the caller sees exactly the (prompt, max_new) asked.
        return torch.cat([orig_ids, new_tokens[:, :orig_new]], dim=1)
