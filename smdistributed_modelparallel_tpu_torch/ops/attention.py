"""Attention compute core.

Counterpart of ``smdistributed_modelparallel_tpu/ops/attention.py``: one
entry point, ``attention_core``, over [B, T, H, hd] tensors, with the same
dispatch:
  1. the flash-attention kernel (``ops/flash_attention.py``) when q lies on a
     CUDA device and the shapes pass the same gate as the JAX package's
     ``_pallas_ok`` (so both packages send the same calls to their kernel);
  2. otherwise plain PyTorch that reproduces the JAX package's jnp body.
The kernel path is differentiable through the flash backward kernels
(``flash_attention``'s ``autograd.Function``) and takes attention dropout
with the kernels' counter hash. The ``smp.nn`` layers' per-layer arguments
(``extra_scale``, ``qk_compensation``, ``local_select``) and the
``use_pallas_kernels`` switch (``use_pallas``) take the JAX entry point's
semantics; the layers pass them as Python numbers, which the plain path
rounds to fp32 where the JAX package's traced fp32 scalars are. The plain
path's dropout arrives with the slice that uses it.

Context parallelism. While an ``@smp.step`` runs on the rank's sequence shard
(``state.cp_sharded``), attention goes to the cp ring or Ulysses
(``ops/context_parallel.cp_attention``) under the JAX package's conditions: no
bias, a mask only as key padding, no ``local_select``, no window, T == S and
one dtype. Where they fail, the JAX package falls through to GSPMD on the
global arrays; the port holds only the local shard, where the same
fall-through would attend over the shard alone and give a wrong answer
without a word, so each uncovered case raises instead.
"""

import math
import os
from typing import Optional

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention


def causal_window_mask(T, S, window=None, device=None):
    """[T, S] boolean lower-triangular mask, optionally banded to ``window``."""
    rows = torch.arange(T, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    offset = S - T
    mask = cols <= rows + offset
    if window is not None:
        mask = mask & (rows + offset - cols < window)
    return mask


def _as_key_padding_bias(mask, mask_value):
    """Reduce a broadcastable attention mask to additive fp32 [B, S] form,
    or None if it varies along T (then the plain path runs)."""
    if mask is None:
        return None
    if mask.dim() == 2:  # already [B, S]
        reduced = mask
    elif mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        reduced = mask[:, 0, 0, :]
    else:
        return None
    if reduced.dtype == torch.bool:
        return torch.where(reduced, 0.0, mask_value).float()
    return reduced.float()


def _kernel_ok(q, k, v):
    """The JAX package's ``_pallas_ok`` with "on TPU" read as "q is a CUDA
    tensor": uniform dtypes, 128 <= T, S <= 8192, hd <= 256, and
    ``SMP_DISABLE_PALLAS_ATTN`` unset."""
    if os.environ.get("SMP_DISABLE_PALLAS_ATTN", "0") == "1":
        return False
    if not q.is_cuda:
        return False
    if not (q.dtype == k.dtype == v.dtype):
        return False
    T, S, hd = q.shape[1], k.shape[1], q.shape[-1]
    return T >= 128 and S >= 128 and T <= 8192 and S <= 8192 and hd <= 256


def _cp_dispatch(q, k, v, causal, window, local_select, scale, bias, mask, mask_value, rate, seed,
                 use_pallas):
    """Attention over the rank's sequence shard: ``cp_attention``, or an
    error naming what it does not cover."""
    from smdistributed_modelparallel_tpu_torch.ops.context_parallel import cp_attention

    kpad = _as_key_padding_bias(mask, mask_value)
    uncovered = [what for what, bad in (
        ("an additive bias", bias is not None),
        ("a mask that varies along the query axis", mask is not None and kpad is None),
        ("per-layer local/global selection (local_select)", local_select is not None),
        ("a local-attention window", window is not None),
        (f"T != S ({q.shape[1]} != {k.shape[1]})", q.shape[1] != k.shape[1]),
        ("mixed q/k/v dtypes", not (q.dtype == k.dtype == v.dtype)),
        ("use_pallas_kernels: False (the JAX package's plain ring body)", not use_pallas),
    ) if bad]
    if uncovered:
        raise NotImplementedError(
            f"context parallelism (cp = {state.topology.cp_size}) does not cover {', '.join(uncovered)}: the "
            "JAX package attends over the global sequence there, and this rank holds only its shard."
        )
    return cp_attention(q, k, v, scale=float(scale), causal=causal, kpad=kpad, dropout_rate=rate,
                        seed=seed if rate > 0.0 else None)


def _f32(x):
    """``x`` rounded to fp32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def attention_core(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    local_select: Optional[bool] = None,
    scale: Optional[float] = None,
    extra_scale: Optional[float] = None,
    qk_compensation: Optional[float] = None,
    bias=None,
    mask=None,
    mask_value: float = -1e4,
    attention_in_fp32: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    use_pallas: bool = True,
):
    """Multi-head attention over [B, T, H, hd] q and [B, S, H, hd] k/v.

    Args:
      causal/window: static masking (window = local attention band).
      local_select: per-layer local/global switch (GPT-Neo
        ``attention_layers_type``): when given, the causal window band
        applies only if it is True. Like the JAX gate, it keeps the call on
        the plain path.
      scale: score scale; default 1/sqrt(hd). Applied to q before the
        product so half-precision scores cannot overflow.
      extra_scale: multiplier on the scale (``scale_attn_by_layer_idx``:
        1/(layer_idx+1)); the product is taken in fp32. On the kernel path
        it folds into the kernel's scale.
      qk_compensation: c of ``query_key_layer_scaling`` (layer_idx+1): the
        plain path pre-divides q's scale by c and multiplies the fp32 scores
        back by c. The kernel's score math is fp32 throughout, so, as in the
        JAX gate, it needs no compensation and keeps the kernel path.
      bias: additive [B|1, H|1, T, S] bias.
      mask: additive or boolean mask broadcastable to [B, 1, T, S]
        (True/0 = keep).
      mask_value: additive value for masked positions (default -1e4).
      attention_in_fp32: run the plain path's score product in fp32 (the
        kernel's score math is always fp32).
      dropout_rate/seed: attention-probability dropout, active when
        ``dropout_rate > 0`` and ``seed`` (an int the caller draws from an
        explicit ``torch.Generator``) is given; the JAX package's
        ``_fold_scale_and_seed`` draws its int32 seed the same way from its
        rng. Only the kernel path takes it.
      use_pallas: False keeps the call off the flash kernels (the config's
        ``use_pallas_kernels``).
    Returns: [B, T, H, hd].
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if extra_scale is not None:
        scale = _f32(_f32(scale) * _f32(extra_scale))
    rate = float(dropout_rate) if seed is not None else 0.0
    if state.cp_sharded:
        return _cp_dispatch(q, k, v, causal, window, local_select, scale, bias, mask, mask_value, rate,
                            seed, use_pallas)
    use_kernel = use_pallas and bias is None and local_select is None and _kernel_ok(q, k, v)
    kpad = _as_key_padding_bias(mask, mask_value) if use_kernel else None
    if use_kernel and (mask is None or kpad is not None):
        o, _ = flash_attention(q, k, v, kpad, seed=seed if rate > 0.0 else None,
                               scale=float(scale), causal=causal, window=window,
                               dropout_rate=rate)
        return o
    if rate > 0.0:
        raise NotImplementedError(
            "attention dropout on the plain attention path (the JAX package's "
            "jnp dropout in ops/attention.py) is not ported to PyTorch yet; "
            "only the flash kernel path (CUDA, 128 <= T, S <= 8192) takes it."
        )

    T, S = q.shape[1], k.shape[1]
    compute_dtype = torch.float32 if attention_in_fp32 else q.dtype
    # Pre-scale q in fp32 so a half-precision score product cannot overflow
    # (a Python scale multiplies an fp32 tensor in fp32, as the jnp path's
    # fp32 scalar does, without a host-to-device copy).
    pre = _f32(scale)
    if qk_compensation is not None:
        pre = _f32(pre / _f32(qk_compensation))
    qc = (q.float() * pre).to(compute_dtype)
    kc = k.to(compute_dtype)
    scores = torch.einsum("bthd,bshd->bhts", qc, kc).float()
    if qk_compensation is not None:
        scores = scores * _f32(qk_compensation)
    if causal:
        banded = window is not None and (local_select is None or bool(local_select))
        cmask = causal_window_mask(T, S, window if banded else None, device=q.device)
        scores = torch.where(cmask, scores, mask_value)
    elif window is not None:
        # Non-causal local attention: symmetric band of width `window`.
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        band = (rows + (S - T) - cols).abs() < window
        scores = torch.where(band, scores, mask_value)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, mask_value)
        else:
            scores = scores + mask.float()
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)
