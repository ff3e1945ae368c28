"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_attention.py``
(``flash_attention`` and its forward kernel ``_fwd_kernel``). The kernel is
``csrc/flash_fwd.cu``; ``flash_attention_reference`` is the same function in
plain PyTorch. ``flash_attention`` runs the plain version for a tensor on the
CPU and the kernel for a CUDA tensor; it never falls back from one to the
other.

Both reproduce the TPU kernel's conventions, so they agree with it bit for
bit in the dropout mask and to rounding elsewhere:
  - masked scores are -1e30, not -inf; the scale multiplies the fp32 scores
    after the product; probabilities are rounded to v's dtype before the
    second product;
  - a row with no kept column visited gets output 0 and the LSE sentinel
    1e30; a row whose visited columns are all masked gets the mean of the
    visited v's (padding columns count, with v = 0), as in the TPU kernel;
  - dropout uses the TPU kernel's counter hash, with the flat batch-major
    ``b*H + h`` index (remapped by ``head0``/``head_total``) and the row
    stride ``counter_len``, which defaults to S rounded up to ``block_k``.

``block_q``/``block_k`` are the TPU kernel's tiling (``pallas_attn_block_q/k``
in the config, else 256/512, clamped as ``_clamp_block`` does). They decide
the visited kv range and the default dropout stride above, nothing else: the
CUDA kernel's own tiles are fixed.
"""

import ctypes
import math

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state

NEG_INF = -1e30
LSE_MASKED = 1e30  # lse sentinel for rows with no visited column

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_BLOCK_Q = 64  # query rows per CTA of csrc/flash_fwd.cu


def resolve_blocks(block_q, block_k):
    """Reference tiling: an explicit argument wins, else the config's
    ``pallas_attn_block_{q,k}``, else the TPU kernel's default 256/512."""
    cfg = state.cfg
    if block_q is None:
        block_q = (cfg.pallas_attn_block_q if cfg else None) or 256
    if block_k is None:
        block_k = (cfg.pallas_attn_block_k if cfg else None) or 512
    return block_q, block_k


def _clamp_block(block, dim):
    """min(block, dim rounded up to 128), as the TPU kernel clamps."""
    return min(block, ((dim + 127) // 128) * 128)


def _ref_tiling(block_q, block_k, T, S):
    """(block_q, block_k, s_pad) of the TPU kernel for these lengths."""
    block_q, block_k = resolve_blocks(block_q, block_k)
    block_q = _clamp_block(block_q, T)
    block_k = _clamp_block(block_k, S)
    return block_q, block_k, -(-S // block_k) * block_k


def _mul32(x, c):
    """x * c mod 2**32 for int64 tensors x < 2**32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def dropout_keep(seed, bh, rows, cols, s_total, rate):
    """Keep mask of the TPU kernel's counter hash (``_dropout_keep``), in
    uint32 arithmetic carried in int64 tensors."""
    m = 0xFFFFFFFF
    idx = (_mul32(bh, 0x9E3779B9) + _mul32(rows, s_total & m) + cols) & m
    x = (idx + (int(seed) & m)) & m
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= min(int(rate * 4294967296.0), 4294967295)


def _kv_range(rows, block_q, block_k, T, S, s_pad, causal, window):
    """Per-row [c_lo, c_hi) of kv columns the TPU kernel visits for the q
    block that holds each row (``_kv_bounds``)."""
    offset = S - T
    num_kv = s_pad // block_k
    q_lo = (rows // block_q) * block_q
    q_hi = q_lo + block_q
    if causal:
        hi = torch.clamp((q_hi - 1 + offset) // block_k + 1, max=num_kv)
    elif window is not None:
        hi = torch.clamp((q_hi - 1 + offset + window - 1) // block_k + 1, max=num_kv)
    else:
        hi = torch.full_like(rows, num_kv)
    if window is not None:
        lo = torch.clamp((q_lo + offset - window + 1) // block_k, min=0)
    else:
        lo = torch.zeros_like(rows)
    return lo * block_k, hi * block_k


def _check(q, k, v, kpad_bias, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,T,H,hd] and k, v [B,S,H,hd].")
    B, T, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kpad_bias is not None and (
        kpad_bias.dim() != 2 or kpad_bias.shape[0] not in (1, B) or kpad_bias.shape[1] != k.shape[1]
    ):
        raise ValueError(f"kpad_bias must be [B|1, S], got {tuple(kpad_bias.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_reference(q, k, v, kpad_bias=None, seed=None, head0=None,
                              scale=None, causal=True, window=None,
                              dropout_rate=0.0, block_q=None, block_k=None,
                              head_total=None, counter_len=None):
    """Plain PyTorch version of the kernel; materialises [B, H, T, S].

    Returns ``(o [B, T, H, hd] in q's dtype, lse [B, H, T] fp32)``."""
    _check(q, k, v, kpad_bias, window)
    B, T, H, hd = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bq, bk, s_pad = _ref_tiling(block_q, block_k, T, S)
    dev = q.device
    qf = q.permute(0, 2, 1, 3).float()
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))  # fp32: bf16 products are exact
    if scale != 1.0:
        s = s * float(scale)
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    rows = torch.arange(T, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None, :]
    offset = S - T
    keep = torch.ones((T, S), dtype=torch.bool, device=dev)
    if causal:
        keep &= cols <= rows + offset
        if window is not None:
            keep &= rows + offset - cols < window
    elif window is not None:
        keep &= (rows + offset - cols).abs() < window
    s = torch.where(keep, s, NEG_INF)
    c_lo, c_hi = _kv_range(rows, bq, bk, T, S, s_pad, causal, window)
    s = torch.where((cols >= c_lo) & (cols < c_hi), s, -math.inf)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    # Visited padding columns [S, s_pad) score -1e30 (v = 0): p = 1 only
    # when every visited score is -1e30.
    n_pad = torch.clamp(c_hi - torch.clamp(c_lo, min=S), min=0).float()
    l = p.sum(-1, keepdim=True) + torch.where(m == NEG_INF, n_pad, 0.0)
    rate = float(dropout_rate) if seed is not None else 0.0
    if rate > 0.0:
        b_idx = torch.arange(B, device=dev)[:, None]
        h_idx = torch.arange(H, device=dev)[None, :]
        if head0 is None:
            bh = b_idx * H + h_idx
        else:
            bh = b_idx * (head_total or H) + int(head0) + h_idx
        s_total = counter_len if counter_len is not None else s_pad
        dkeep = dropout_keep(seed, bh[:, :, None, None], rows, cols, s_total, rate)
        p = torch.where(dkeep, p, 0.0)
    acc = torch.matmul(p.to(v.dtype).float(), vf)
    if rate > 0.0:
        acc = acc * (1.0 / (1.0 - rate))
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), LSE_MASKED)
    return o.to(q.dtype).permute(0, 2, 1, 3), lse[..., 0]


def flash_attention(q, k, v, kpad_bias=None, seed=None, head0=None,
                    scale=None, causal=True, window=None, dropout_rate=0.0,
                    block_q=None, block_k=None, head_total=None,
                    counter_len=None):
    """Flash attention over [B, T, H, hd] q and [B, S, H, hd] k/v.

    ``kpad_bias``: additive fp32 [B|1, S] bias (0 keep / -1e30 drop).
    ``seed``: integer enabling dropout at ``dropout_rate``.
    ``head0``/``head_total``/``counter_len``: global dropout-hash coordinates
    for head-sharded callers, as in the JAX package. Returns ``(o, lse)``:
    o [B, T, H, hd] in q's dtype, lse [B, H, T] fp32.

    A CPU tensor runs ``flash_attention_reference``; a CUDA tensor launches
    ``csrc/flash_fwd.cu`` (bf16, fp16 or fp32; hd <= 256) or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, kpad_bias, seed, head0, scale, causal, window,
            dropout_rate, block_q, block_k, head_total, counter_len,
        )
    _check(q, k, v, kpad_bias, window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes one of {list(_DTYPE_CODE)} for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, T, H, hd = q.shape
    S = k.shape[1]
    if hd > 256:
        raise ValueError(f"flash_attention kernel takes hd <= 256, got {hd}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bq, bk, s_pad = _ref_tiling(block_q, block_k, T, S)
    if bq % _KERNEL_BLOCK_Q:
        raise ValueError(f"block_q must be a multiple of {_KERNEL_BLOCK_Q}, got {bq}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    kpad = None
    if kpad_bias is not None:
        kpad = kpad_bias.to(device=q.device, dtype=torch.float32).contiguous()
    rate = float(dropout_rate) if seed is not None else 0.0
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = lib.smp_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kpad.data_ptr() if kpad is not None else None, o.data_ptr(), lse.data_ptr(),
            B, T, S, H, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            (kpad.stride(0) if kpad.shape[0] > 1 else 0) if kpad is not None else 0,
            float(scale), int(bool(causal)), int(window or 0), int(rate > 0.0),
            (int(seed) & 0xFFFFFFFF) if rate > 0.0 else 0,
            min(int(rate * 4294967296.0), 4294967295),
            (counter_len if counter_len is not None else s_pad) & 0xFFFFFFFF,
            1.0 / (1.0 - rate),
            0 if head0 is None else int(head0),
            H if head0 is None else int(head_total or H),
            bq, bk, s_pad,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.smp_cuda_error_string(err).decode()}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("flash_fwd")
        c_int, c_uint, c_ll, c_float, c_ptr = (
            ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
        )
        lib.smp_flash_fwd.argtypes = (
            [c_int] + [c_ptr] * 6 + [c_int] * 5 + [c_ll] * 13
            + [c_float, c_int, c_int, c_int, c_uint, c_uint, c_uint, c_float]
            + [c_int] * 5 + [c_ptr]
        )
        lib.smp_flash_fwd.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB

