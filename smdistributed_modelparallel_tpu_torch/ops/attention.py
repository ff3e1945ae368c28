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
with the kernels' counter hash. Context parallelism, per-layer local
selection, the traced scale factors of the JAX entry point and the plain
path's dropout arrive with the slices that use them.
"""

import math
import os
from typing import Optional

import torch

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


def attention_core(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    bias=None,
    mask=None,
    mask_value: float = -1e4,
    attention_in_fp32: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
):
    """Multi-head attention over [B, T, H, hd] q and [B, S, H, hd] k/v.

    Args:
      causal/window: static masking (window = local attention band).
      scale: score scale; default 1/sqrt(hd).
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
    Returns: [B, T, H, hd].
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    rate = float(dropout_rate) if seed is not None else 0.0
    use_kernel = bias is None and _kernel_ok(q, k, v)
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
    qc = (q.float() * float(scale)).to(compute_dtype)
    kc = k.to(compute_dtype)
    scores = torch.einsum("bthd,bshd->bhts", qc, kc).float()
    if causal:
        cmask = causal_window_mask(T, S, window, device=q.device)
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
