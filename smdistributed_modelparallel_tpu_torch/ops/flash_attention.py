"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_attention.py``:
``flash_attention`` and its ``custom_vjp``, whose kernels are the forward
``_fwd_kernel`` and the backward ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``.
Here they are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, wired
together by a ``torch.autograd.Function``, and their ids mode
(``flash_fwd_with_ids``, ``flash_bwd_dq_ids``, ``flash_bwd_dkv_ids``: one
pair of a context-parallel ring step, section below). Each kernel's wrapper
(``flash_attention``'s forward, ``flash_bwd_dq``, ``flash_bwd_dkv``) runs
its plain PyTorch version for tensors on the CPU and its kernel for CUDA
tensors; it never falls back from one to the other.

Every kernel (the forward and each backward pass, plain and ids mode) has
two forms, one contract, and ``_route`` picks by the operands alone:
``"wgmma"`` (tensor cores fed by TMA) for fp16 and bf16 with hd 64 on
TMA-ready strides, ``"simt"`` (the CUDA cores) for the rest. A route never
gives way to the other when a build or a launch fails. Each wrapper counts
tensor-core launches in ``.launches`` and CUDA-core launches in
``.simt_launches``.

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
    stride ``counter_len``, which defaults to S rounded up to ``block_k``;
  - the backward recomputes p = exp(s - lse) from the saved LSE on the kept
    pairs only, takes delta = rowsum(dO * O) in fp32, and rounds ds to the
    operand dtype before dq = ds K and dk = ds^T Q, and the dropped p to
    dO's dtype before dv = p^T dO.

``block_q``/``block_k`` are the TPU kernel's tiling (``pallas_attn_block_q/k``
in the config, else 256/512, clamped as ``_clamp_block`` does). They decide
the visited kv range and the default dropout stride above, nothing else: the
CUDA kernels' own tiles are fixed.
"""

import ctypes
import math

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state

NEG_INF = -1e30
LSE_MASKED = 1e30  # lse sentinel for rows with no visited column

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_BLOCK_Q = 64  # query rows per CTA of csrc/flash_fwd.cu


def resolve_blocks(block_q, block_k, default_k=512):
    """Reference tiling: an explicit argument wins, else the config's
    ``pallas_attn_block_{q,k}``, else the TPU kernel's default 256 and
    ``default_k`` (512; 256 in ids mode)."""
    cfg = state.cfg
    if block_q is None:
        block_q = (cfg.pallas_attn_block_q if cfg else None) or 256
    if block_k is None:
        block_k = (cfg.pallas_attn_block_k if cfg else None) or default_k
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


def _structural_keep(T, S, causal, window, device):
    """[T, S] pairs kept by the TPU kernels' ``_tile_mask`` (causal and
    window band; rows < T and cols < S hold by construction)."""
    rows = torch.arange(T, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    offset = S - T
    keep = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        keep &= cols <= rows + offset
        if window is not None:
            keep &= rows + offset - cols < window
    elif window is not None:
        keep &= (rows + offset - cols).abs() < window
    return keep


def _dropout_mask(seed, B, H, rows, cols, head0, head_total, s_total, rate):
    """[B, H, T, S] dropout keep bits, hashed at the global ``b*H + h``
    index remapped by ``head0``/``head_total`` (``_bh_remap``) and at the
    row and column indices ``rows`` [T] and ``cols`` [S] (int64)."""
    device = rows.device
    b_idx = torch.arange(B, device=device)[:, None]
    h_idx = torch.arange(H, device=device)[None, :]
    if head0 is None:
        bh = b_idx * H + h_idx
    else:
        bh = b_idx * (head_total or H) + int(head0) + h_idx
    return dropout_keep(seed, bh[:, :, None, None], rows[:, None], cols[None, :], s_total, rate)


def _bhsd(x):
    """[B, L, H, hd] -> fp32 [B, H, L, hd]."""
    return x.permute(0, 2, 1, 3).float()


def flash_attention_reference(q, k, v, kpad_bias=None, seed=None, head0=None,
                              scale=None, causal=True, window=None,
                              dropout_rate=0.0, block_q=None, block_k=None,
                              head_total=None, counter_len=None):
    """Plain PyTorch version of the forward kernel; materialises
    [B, H, T, S].

    Returns ``(o [B, T, H, hd] in q's dtype, lse [B, H, T] fp32)``."""
    _check(q, k, v, kpad_bias, window)
    B, T, H, hd = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bq, bk, s_pad = _ref_tiling(block_q, block_k, T, S)
    dev = q.device
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2))  # fp32: bf16 products are exact
    if scale != 1.0:
        s = s * float(scale)
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    s = torch.where(_structural_keep(T, S, causal, window, dev), s, NEG_INF)
    rows = torch.arange(T, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None, :]
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
        s_total = counter_len if counter_len is not None else s_pad
        dkeep = _dropout_mask(seed, B, H, torch.arange(T, device=dev), torch.arange(S, device=dev),
                              head0, head_total, s_total, rate)
        p = torch.where(dkeep, p, 0.0)
    acc = torch.matmul(p.to(v.dtype).float(), _bhsd(v))
    if rate > 0.0:
        acc = acc * (1.0 / (1.0 - rate))
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), LSE_MASKED)
    return o.to(q.dtype).permute(0, 2, 1, 3), lse[..., 0]


def _is_cuda(x):
    """Whether a kernel would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch with meta tensors)."""
    return x.is_cuda


def _check_cuda(name, q, k, v, *others):
    """The kernels' contract: one CUDA device, one dtype of fp32/fp16/bf16
    for q, k, v (and dO), hd <= 256."""
    tensors = (q, k, v) + others
    if not (_is_cuda(q) and all(x.device == q.device for x in tensors)):
        raise ValueError(f"{name}: q, k, v must share one CUDA device, got {[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"{name} kernel takes one of {list(_DTYPE_CODE)} for q, k, v; got "
                        f"{[x.dtype for x in tensors]}")
    if q.shape[-1] > 256:
        raise ValueError(f"{name} kernel takes hd <= 256, got {q.shape[-1]}")


def _unit_stride(*tensors):
    return tuple(x if x.stride(-1) == 1 else x.contiguous() for x in tensors)


def _dropout_args(seed, dropout_rate, counter_len, s_pad):
    """(has_dropout, seed, keep threshold, row stride, 1/(1-rate)) as the
    kernels take them."""
    rate = float(dropout_rate) if seed is not None else 0.0
    return (
        int(rate > 0.0),
        (int(seed) & 0xFFFFFFFF) if rate > 0.0 else 0,
        min(int(rate * 4294967296.0), 4294967295),
        (counter_len if counter_len is not None else s_pad) & 0xFFFFFFFF,
        1.0 / (1.0 - rate),
    )


def _kpad_arg(kpad_bias, device):
    """(fp32 contiguous kpad or None, its batch stride: 0 broadcasts)."""
    if kpad_bias is None:
        return None, 0
    kpad = kpad_bias.to(device=device, dtype=torch.float32).contiguous()
    return kpad, (kpad.stride(0) if kpad.shape[0] > 1 else 0)


def _flash_fwd(q, k, v, kpad_bias, seed, head0, scale, causal, window,
               dropout_rate, block_q, block_k, head_total, counter_len):
    """The forward kernel's wrapper: the plain version for CPU tensors,
    ``csrc/flash_fwd.cu`` on ``_route``'s route for CUDA tensors (bf16, fp16
    or fp32; hd <= 256), else it raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, kpad_bias, seed, head0, scale, causal, window,
            dropout_rate, block_q, block_k, head_total, counter_len,
        )
    _check(q, k, v, kpad_bias, window)
    _check_cuda("flash_attention", q, k, v)
    B, T, H, hd = q.shape
    S = k.shape[1]
    bq, bk, s_pad = _ref_tiling(block_q, block_k, T, S)
    if bq % _KERNEL_BLOCK_Q:
        raise ValueError(f"block_q must be a multiple of {_KERNEL_BLOCK_Q}, got {bq}")
    q, k, v = _unit_stride(q, k, v)
    kpad, kpad_sb = _kpad_arg(kpad_bias, q.device)
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    route = _route(q, k, v)
    _launch(route, "flash_fwd", q.device, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kpad.data_ptr() if kpad is not None else None, None, None, o.data_ptr(), lse.data_ptr(),
        B, T, S, H, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], kpad_sb,
        float(scale), int(bool(causal)), int(window or 0),
        *_dropout_args(seed, dropout_rate, counter_len, s_pad),
        0 if head0 is None else int(head0),
        H if head0 is None else int(head_total or H),
        bq, bk, s_pad,
    ))
    _count(flash_attention, route)
    return o, lse


class _FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with the TPU kernels' backward, as ``_fa_fwd`` /
    ``_fa_bwd`` wire it: the forward saves (q, k, v, o, lse, kpad_bias) and
    the dropout coordinates; the backward runs ``flash_attention_bwd``.
    lse is an output that carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kpad_bias, seed, head0, scale, causal, window,
                dropout_rate, block_q, block_k, head_total, counter_len):
        o, lse = _flash_fwd(q, k, v, kpad_bias, seed, head0, scale, causal,
                            window, dropout_rate, block_q, block_k,
                            head_total, counter_len)
        ctx.save_for_backward(q, k, v, o, lse, kpad_bias)
        ctx.coords = (seed, head0, scale, causal, window, dropout_rate,
                      block_q, block_k, head_total, counter_len)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, kpad_bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, kpad_bias, *ctx.coords)
        return (dq, dk, dv) + (None,) * 11


def flash_attention(q, k, v, kpad_bias=None, seed=None, head0=None,
                    scale=None, causal=True, window=None, dropout_rate=0.0,
                    block_q=None, block_k=None, head_total=None,
                    counter_len=None):
    """Flash attention over [B, T, H, hd] q and [B, S, H, hd] k/v.

    ``kpad_bias``: additive fp32 [B|1, S] bias (0 keep / -1e30 drop).
    ``seed``: integer enabling dropout at ``dropout_rate``.
    ``head0``/``head_total``/``counter_len``: global dropout-hash coordinates
    for head-sharded callers, as in the JAX package. Returns ``(o, lse)``:
    o [B, T, H, hd] in q's dtype, differentiable in q, k and v through the
    backward kernels; lse [B, H, T] fp32, without a gradient.

    CPU tensors run the plain versions (``flash_attention_reference``,
    ``flash_attention_bwd_reference``); CUDA tensors launch
    ``csrc/flash_fwd.cu`` and, in the backward, ``csrc/flash_bwd.cu``, each
    on ``_route``'s route (bf16, fp16 or fp32; hd <= 256), or raise.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    block_q, block_k = resolve_blocks(block_q, block_k)  # fixed for the backward
    return _FlashAttentionFn.apply(
        q, k, v, kpad_bias, seed, head0, float(scale), causal, window,
        dropout_rate, block_q, block_k, head_total, counter_len,
    )


flash_attention.launches = 0  # launches of the tensor-core forward kernel
flash_attention.simt_launches = 0  # launches of the CUDA-core forward kernel


# ----------------------------------------------------------------------
# Backward
# ----------------------------------------------------------------------


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B, H, T]: the pass the JAX package
    runs in XLA outside its backward kernels."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, kpad_bias, seed, head0, scale,
               causal, window, dropout_rate, block_q, block_k, head_total,
               counter_len):
    """(ds, p_drop), fp32 [B, H, T, S], of the TPU backward kernels:
    p = keep ? exp(s - lse) : 0 recomputed from the saved LSE, dp = dO V^T
    (dropped and rescaled under dropout), ds = p * (dp - delta) * scale."""
    _check(q, k, v, kpad_bias, window)
    B, T, H, hd = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _, _, s_pad = _ref_tiling(block_q, block_k, T, S)
    dev = q.device
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2))
    if scale != 1.0:
        s = s * float(scale)
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    keep = _structural_keep(T, S, causal, window, dev)
    p = torch.where(keep, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(_bhsd(do), _bhsd(v).transpose(-1, -2))
    rate = float(dropout_rate) if seed is not None else 0.0
    p_drop = p
    if rate > 0.0:
        s_total = counter_len if counter_len is not None else s_pad
        dkeep = _dropout_mask(seed, B, H, torch.arange(T, device=dev), torch.arange(S, device=dev),
                              head0, head_total, s_total, rate)
        inv_keep = 1.0 / (1.0 - rate)
        dp = torch.where(dkeep, dp * inv_keep, 0.0)
        p_drop = torch.where(dkeep, p * inv_keep, 0.0)
    ds = p * (dp - delta.float()[..., None]) * float(scale)
    return ds, p_drop


def flash_bwd_dq_reference(q, k, v, do, lse, delta, kpad_bias=None, seed=None,
                           head0=None, scale=None, causal=True, window=None,
                           dropout_rate=0.0, block_q=None, block_k=None,
                           head_total=None, counter_len=None):
    """Plain PyTorch version of the dq kernel: dq = round_k(ds) K, in q's
    dtype."""
    ds, _ = _bwd_terms(q, k, v, do, lse, delta, kpad_bias, seed, head0, scale,
                       causal, window, dropout_rate, block_q, block_k,
                       head_total, counter_len)
    return _dq_from(ds, q, k)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, kpad_bias=None, seed=None,
                            head0=None, scale=None, causal=True, window=None,
                            dropout_rate=0.0, block_q=None, block_k=None,
                            head_total=None, counter_len=None):
    """Plain PyTorch version of the dk/dv kernel: dk = round_q(ds)^T Q and
    dv = round_dO(p_drop)^T dO, in k's and v's dtypes."""
    ds, p_drop = _bwd_terms(q, k, v, do, lse, delta, kpad_bias, seed, head0,
                            scale, causal, window, dropout_rate, block_q,
                            block_k, head_total, counter_len)
    return _dkv_from(ds, p_drop, q, k, v, do)


def _dq_from(ds, q, k):
    return torch.matmul(ds.to(k.dtype).float(), _bhsd(k)).to(q.dtype).permute(0, 2, 1, 3)


def _dkv_from(ds, p_drop, q, k, v, do):
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _bhsd(q))
    dv = torch.matmul(p_drop.to(do.dtype).float().transpose(-1, -2), _bhsd(do))
    return dk.to(k.dtype).permute(0, 2, 1, 3), dv.to(v.dtype).permute(0, 2, 1, 3)


def flash_attention_bwd_reference(q, k, v, o, do, lse, kpad_bias=None,
                                  seed=None, head0=None, scale=None,
                                  causal=True, window=None, dropout_rate=0.0,
                                  block_q=None, block_k=None, head_total=None,
                                  counter_len=None):
    """Plain PyTorch version of the two backward kernels with the delta pass
    before them; materialises [B, H, T, S]. Returns ``(dq, dk, dv)`` in q's,
    k's and v's dtypes."""
    delta = attention_delta(o, do)
    ds, p_drop = _bwd_terms(q, k, v, do, lse, delta, kpad_bias, seed, head0,
                            scale, causal, window, dropout_rate, block_q,
                            block_k, head_total, counter_len)
    return (_dq_from(ds, q, k),) + _dkv_from(ds, p_drop, q, k, v, do)


_TC_HEAD_DIM = 64  # the head dim the tensor-core kernels take


def _route(*operands):
    """The kernel that takes the attention operands (q, k, v for the
    forward; q, k, v and dO for the backward; each with a unit head-dim
    stride): ``"wgmma"`` (tensor cores fed by TMA) for fp16 or bf16 with hd
    64, 16-byte aligned bases and batch, row and head strides that are
    positive multiples of 16 bytes, which are TMA's rules (q, k and v may be
    views into a fused QKV output); else ``"simt"`` (the CUDA cores): fp32
    (the tensor cores give fp32 only as TF32, which the contract excludes),
    every other head dim, and empty operands. hd 128 stays on the CUDA
    cores: at n = 128 the backward's dk and dv accumulators (64 registers a
    thread each) with the score tiles and A fragments (96) exceed the 216
    registers a consumer thread has in this design; the forward's would fit,
    but its tests and timings are later work."""
    q = operands[0]
    if q.dtype not in (torch.bfloat16, torch.float16) or q.shape[-1] != _TC_HEAD_DIM:
        return "simt"
    for x in operands:
        if x.numel() == 0 or x.data_ptr() % 16 or any(st <= 0 or st % 8 for st in x.stride()[:3]):
            return "simt"
    return "wgmma"


def _bwd_launch(kernel, q, k, v, do, lse, delta, kpad_bias, dq, dk, dv, seed,
                head0, scale, causal, window, dropout_rate, block_q, block_k,
                head_total, counter_len, ids=(None, None)):
    """Launch one kernel of ``csrc/flash_bwd.cu`` on ``_route``'s route:
    ``smp_flash_bwd_dq`` into dq, or ``smp_flash_bwd_dkv`` into dk and dv
    (the unused outputs are None); ``ids`` (int32 q_ids, kv_ids) selects ids
    mode, whose outputs are fp32. Returns the route."""
    _check(q, k, v, kpad_bias, window)
    _check_cuda(kernel, q, k, v, do)
    B, T, H, hd = q.shape
    S = k.shape[1]
    if do.shape != q.shape:
        raise ValueError(f"{kernel}: do must be shaped like q {tuple(q.shape)}, got {tuple(do.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _, _, s_pad = _ref_tiling(block_q, block_k, T, S)
    q, k, v, do = _unit_stride(q, k, v, do)
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    delta = delta.to(device=q.device, dtype=torch.float32).contiguous()
    if lse.shape != (B, H, T) or delta.shape != (B, H, T):
        raise ValueError(f"{kernel}: lse and delta must be [B, H, T], got {tuple(lse.shape)}, {tuple(delta.shape)}")
    kpad, kpad_sb = _kpad_arg(kpad_bias, q.device)
    layouts = (q, k, v, do, q if dq is None else dq, k if dk is None else dk, v if dv is None else dv)
    strides = (ctypes.c_longlong * 22)(*[st for x in layouts for st in x.stride()[:3]], kpad_sb)
    outs = [x.data_ptr() for x in (dq, dk, dv) if x is not None]
    route = _route(q, k, v, do)
    _launch(route, kernel, q.device, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kpad.data_ptr() if kpad is not None else None,
        *(x.data_ptr() if x is not None else None for x in ids),
        *outs, B, T, S, H, hd, strides, float(scale), int(bool(causal)), int(window or 0),
        *_dropout_args(seed, dropout_rate, counter_len, s_pad),
        0 if head0 is None else int(head0),
        H if head0 is None else int(head_total or H),
    ))
    return route


def _launch(route, kernel, device, args):
    """Call ``smp_<kernel>`` (``flash_fwd``, ``flash_bwd_dq`` or
    ``flash_bwd_dkv``) with ``route``'s kernel on ``device``'s current
    stream; raise if the launch was refused."""
    lib = _kernel() if kernel == "flash_fwd" else _bwd_kernel()
    with torch.cuda.device(device):
        err = getattr(lib, f"smp_{kernel}")(int(route == "wgmma"), *args,
                                            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


def _count(fn, route):
    """One launch of ``fn``'s kernel: ``.launches`` counts the tensor-core
    route, ``.simt_launches`` the CUDA-core route."""
    if route == "wgmma":
        fn.launches += 1
    else:
        fn.simt_launches += 1


def flash_bwd_dq(q, k, v, do, lse, delta, kpad_bias=None, seed=None,
                 head0=None, scale=None, causal=True, window=None,
                 dropout_rate=0.0, block_q=None, block_k=None,
                 head_total=None, counter_len=None):
    """dq of the backward: the plain version for CPU tensors, the dq kernel
    of ``csrc/flash_bwd.cu`` (``_bwd_dq_kernel``'s counterpart) for CUDA
    tensors, else it raises. ``lse`` is the forward's, ``delta`` is
    ``attention_delta(o, do)``."""
    coords = (seed, head0, scale, causal, window, dropout_rate, block_q,
              block_k, head_total, counter_len)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, kpad_bias, *coords)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _count(flash_bwd_dq, _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, kpad_bias, dq, None, None, *coords))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, kpad_bias=None, seed=None,
                  head0=None, scale=None, causal=True, window=None,
                  dropout_rate=0.0, block_q=None, block_k=None,
                  head_total=None, counter_len=None):
    """(dk, dv) of the backward: the plain version for CPU tensors, the
    dk/dv kernel of ``csrc/flash_bwd.cu`` (``_bwd_dkv_kernel``'s
    counterpart) for CUDA tensors, else it raises."""
    coords = (seed, head0, scale, causal, window, dropout_rate, block_q,
              block_k, head_total, counter_len)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, kpad_bias, *coords)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _count(flash_bwd_dkv, _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, kpad_bias, None, dk, dv, *coords))
    return dk, dv


flash_bwd_dq.launches = 0  # launches of the tensor-core dq kernel
flash_bwd_dq.simt_launches = 0  # launches of the CUDA-core dq kernel
flash_bwd_dkv.launches = 0
flash_bwd_dkv.simt_launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, kpad_bias=None, seed=None,
                        head0=None, scale=None, causal=True, window=None,
                        dropout_rate=0.0, block_q=None, block_k=None,
                        head_total=None, counter_len=None):
    """Backward of ``flash_attention`` (``_fa_bwd``): ``(dq, dk, dv)`` from
    the forward's q, k, v, o and lse and the output gradient ``do``. CPU
    tensors run ``flash_attention_bwd_reference``; CUDA tensors take delta
    in one fp32 reduction and launch the dq and dk/dv kernels; any other
    device raises."""
    coords = (seed, head0, scale, causal, window, dropout_rate, block_q,
              block_k, head_total, counter_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, do, lse, kpad_bias, *coords)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd runs on CPU or CUDA tensors, got {q.device}")
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, kpad_bias, *coords)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, kpad_bias, *coords)
    return dq, dk, dv


# ----------------------------------------------------------------------
# Index-vector ("ids") mode: one (q block, kv block) pair of a cp ring
# ----------------------------------------------------------------------
#
# Counterparts of the JAX package's ``flash_fwd_with_ids`` and
# ``flash_bwd_with_ids`` (``pallas_attention.py:796``, ``:821``): the same
# kernels with ``has_ids=True``. Not autograd surfaces: the ring
# (``ops/context_parallel.py``) calls the forward per ring step, merging
# partials online, and the backward per step with the global lse. What
# ids mode changes from the plain entry points:
#   - the mask: padding by local index, causal by the global ids ``q_ids``
#     [T] and ``kv_ids`` [S] (``_ids_mask``; no window in ids mode);
#   - the visited range: every reference kv block, but under causal a block
#     whose smallest valid column id exceeds the largest valid row id of
#     the reference q block is skipped (``_ids_rmax``/``_ids_cmin``). This
#     decides which rows average the visited v's (all masked) and which get
#     0 and the 1e30 sentinel (nothing visited);
#   - dropout hashes the global ids with the ``counter_len`` stride;
#   - o, dq, dk and dv come back in fp32, for the ring's fp32 accumulators;
#   - the reference kv block defaults to 256, not 512.


def _ids_tiling(block_q, block_k, T, S):
    """(block_q, block_k, s_pad) of the TPU kernel in ids mode."""
    block_q, block_k = resolve_blocks(block_q, block_k, default_k=256)
    block_q = _clamp_block(block_q, T)
    block_k = _clamp_block(block_k, S)
    return block_q, block_k, -(-S // block_k) * block_k


def _check_ids(q, k, q_ids, kv_ids):
    if q_ids.shape != (q.shape[1],) or kv_ids.shape != (k.shape[1],):
        raise ValueError(f"q_ids must be [T] and kv_ids [S], got {tuple(q_ids.shape)}, {tuple(kv_ids.shape)} "
                         f"for T={q.shape[1]}, S={k.shape[1]}")


def _ids_visited(q_ids, kv_ids, bq, bk, causal):
    """([T, S] visited pairs, [T] whether the last reference kv block, which
    holds the padding columns, is visited): every block, or under causal
    the blocks whose smallest column id is at most the largest row id of
    the row's reference q block."""
    T, S = q_ids.shape[0], kv_ids.shape[0]
    dev = q_ids.device
    if not causal:
        return torch.ones((T, S), dtype=torch.bool, device=dev), torch.ones(T, dtype=torch.bool, device=dev)
    nq, nk = -(-T // bq), -(-S // bk)
    rmax = torch.full((nq * bq,), -1, dtype=torch.int64, device=dev)
    rmax[:T] = q_ids
    rmax = rmax.view(nq, bq).amax(1)
    cmin = torch.full((nk * bk,), 2**30, dtype=torch.int64, device=dev)
    cmin[:S] = kv_ids
    cmin = cmin.view(nk, bk).amin(1)
    vis = cmin[None, :] <= rmax[:, None]  # [nq, nk]
    rows = torch.arange(T, device=dev) // bq
    cols = torch.arange(S, device=dev) // bk
    return vis[rows][:, cols], vis[rows, nk - 1]


def flash_fwd_with_ids_reference(q, k, v, kpad_bias, q_ids, kv_ids, *, scale, causal, seed=None,
                                 dropout_rate=0.0, counter_len=None, block_q=None, block_k=None,
                                 head0=None, head_total=None):
    """Plain PyTorch version of the ids-mode forward kernel; materialises
    [B, H, T, S]. Returns ``(o [B, T, H, hd] fp32, lse [B, H, T] fp32)``."""
    _check(q, k, v, kpad_bias, None)
    _check_ids(q, k, q_ids, kv_ids)
    B, T, H, hd = q.shape
    S = k.shape[1]
    bq, bk, s_pad = _ids_tiling(block_q, block_k, T, S)
    q_ids, kv_ids = q_ids.long(), kv_ids.long()
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2))
    if scale != 1.0:
        s = s * float(scale)
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    if causal:
        s = torch.where(kv_ids[None, :] <= q_ids[:, None], s, NEG_INF)
    visited, last_visited = _ids_visited(q_ids, kv_ids, bq, bk, causal)
    s = torch.where(visited, s, -math.inf)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    # Visited padding columns [S, s_pad) score -1e30 (v = 0): p = 1 only
    # when every visited score is -1e30.
    n_pad = torch.where(last_visited, float(s_pad - S), 0.0)[:, None]
    l = p.sum(-1, keepdim=True) + torch.where(m == NEG_INF, n_pad, 0.0)
    rate = float(dropout_rate) if seed is not None else 0.0
    if rate > 0.0:
        s_total = counter_len if counter_len is not None else s_pad
        p = torch.where(_dropout_mask(seed, B, H, q_ids, kv_ids, head0, head_total, s_total, rate), p, 0.0)
    acc = torch.matmul(p.to(v.dtype).float(), _bhsd(v))
    if rate > 0.0:
        acc = acc * (1.0 / (1.0 - rate))
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), LSE_MASKED)
    return o.permute(0, 2, 1, 3), lse[..., 0]


def _bwd_terms_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, seed, head0, scale, causal,
                   dropout_rate, block_q, block_k, head_total, counter_len):
    """(ds, p_drop), fp32 [B, H, T, S], of the ids-mode backward kernels.
    The visited range decides nothing here: a skipped block is all masked
    (p = 0)."""
    _check(q, k, v, kpad_bias, None)
    _check_ids(q, k, q_ids, kv_ids)
    B, T, H, hd = q.shape
    S = k.shape[1]
    _, _, s_pad = _ids_tiling(block_q, block_k, T, S)
    q_ids, kv_ids = q_ids.long(), kv_ids.long()
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2))
    if scale != 1.0:
        s = s * float(scale)
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = torch.where(kv_ids[None, :] <= q_ids[:, None], p, 0.0)
    dp = torch.matmul(_bhsd(do), _bhsd(v).transpose(-1, -2))
    rate = float(dropout_rate) if seed is not None else 0.0
    p_drop = p
    if rate > 0.0:
        s_total = counter_len if counter_len is not None else s_pad
        dkeep = _dropout_mask(seed, B, H, q_ids, kv_ids, head0, head_total, s_total, rate)
        inv_keep = 1.0 / (1.0 - rate)
        dp = torch.where(dkeep, dp * inv_keep, 0.0)
        p_drop = torch.where(dkeep, p * inv_keep, 0.0)
    ds = p * (dp - delta.float()[..., None]) * float(scale)
    return ds, p_drop


def flash_bwd_dq_ids_reference(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, *, scale, causal,
                               seed=None, dropout_rate=0.0, counter_len=None, block_q=None,
                               block_k=None, head0=None, head_total=None):
    """Plain PyTorch version of the ids-mode dq kernel: dq = round_k(ds) K,
    fp32."""
    ds, _ = _bwd_terms_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, seed, head0, scale,
                           causal, dropout_rate, block_q, block_k, head_total, counter_len)
    return torch.matmul(ds.to(k.dtype).float(), _bhsd(k)).permute(0, 2, 1, 3)


def flash_bwd_dkv_ids_reference(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, *, scale, causal,
                                seed=None, dropout_rate=0.0, counter_len=None, block_q=None,
                                block_k=None, head0=None, head_total=None):
    """Plain PyTorch version of the ids-mode dk/dv kernel: dk =
    round_q(ds)^T Q and dv = round_dO(p_drop)^T dO, fp32."""
    ds, p_drop = _bwd_terms_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, seed, head0, scale,
                                causal, dropout_rate, block_q, block_k, head_total, counter_len)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _bhsd(q))
    dv = torch.matmul(p_drop.to(do.dtype).float().transpose(-1, -2), _bhsd(do))
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _ids_arg(ids, device):
    return ids.to(device=device, dtype=torch.int32).contiguous()


def flash_fwd_with_ids(q, k, v, kpad_bias, q_ids, kv_ids, *, scale, causal, seed=None,
                       dropout_rate=0.0, counter_len=None, block_q=None, block_k=None, head0=None,
                       head_total=None):
    """One blockwise forward over a (q block, kv block) pair with global
    ids: ``(o [B, T, H, hd] fp32, lse [B, H, T] fp32 with the 1e30
    sentinel)``. The plain version for CPU tensors, ``csrc/flash_fwd.cu`` in
    ids mode on ``_route``'s route for CUDA tensors (bf16, fp16 or fp32; hd
    <= 256), else it raises."""
    if q.device.type == "cpu":
        return flash_fwd_with_ids_reference(
            q, k, v, kpad_bias, q_ids, kv_ids, scale=scale, causal=causal, seed=seed,
            dropout_rate=dropout_rate, counter_len=counter_len, block_q=block_q, block_k=block_k,
            head0=head0, head_total=head_total)
    _check(q, k, v, kpad_bias, None)
    _check_ids(q, k, q_ids, kv_ids)
    _check_cuda("flash_fwd_with_ids", q, k, v)
    B, T, H, hd = q.shape
    S = k.shape[1]
    bq, bk, s_pad = _ids_tiling(block_q, block_k, T, S)
    if bq % _KERNEL_BLOCK_Q or bk % _KERNEL_BLOCK_Q:
        raise ValueError(f"ids mode takes reference blocks that are multiples of {_KERNEL_BLOCK_Q}, got {bq}, {bk}")
    q, k, v = _unit_stride(q, k, v)
    kpad, kpad_sb = _kpad_arg(kpad_bias, q.device)
    qi, ki = _ids_arg(q_ids, q.device), _ids_arg(kv_ids, q.device)
    o = torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    route = _route(q, k, v)
    _launch(route, "flash_fwd", q.device, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kpad.data_ptr() if kpad is not None else None, qi.data_ptr(), ki.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, T, S, H, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], kpad_sb,
        float(scale), int(bool(causal)), 0, *_dropout_args(seed, dropout_rate, counter_len, s_pad),
        0 if head0 is None else int(head0),
        H if head0 is None else int(head_total or H),
        bq, bk, s_pad,
    ))
    _count(flash_fwd_with_ids, route)
    return o, lse


def flash_bwd_dq_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, *, scale, causal, seed=None,
                     dropout_rate=0.0, counter_len=None, block_q=None, block_k=None, head0=None,
                     head_total=None):
    """dq (fp32) of one ring pair: the plain version for CPU tensors, the dq
    kernel of ``csrc/flash_bwd.cu`` in ids mode for CUDA tensors, else it
    raises."""
    kw = dict(scale=scale, causal=causal, seed=seed, dropout_rate=dropout_rate, counter_len=counter_len,
              block_q=block_q, block_k=block_k, head0=head0, head_total=head_total)
    if q.device.type == "cpu":
        return flash_bwd_dq_ids_reference(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, **kw)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _count(flash_bwd_dq_ids,
           _bwd_launch_ids("flash_bwd_dq", q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, dq, None, None, kw))
    return dq


def flash_bwd_dkv_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, *, scale, causal, seed=None,
                      dropout_rate=0.0, counter_len=None, block_q=None, block_k=None, head0=None,
                      head_total=None):
    """(dk, dv) (fp32) of one ring pair: the plain version for CPU tensors,
    the dk/dv kernel of ``csrc/flash_bwd.cu`` in ids mode for CUDA tensors,
    else it raises."""
    kw = dict(scale=scale, causal=causal, seed=seed, dropout_rate=dropout_rate, counter_len=counter_len,
              block_q=block_q, block_k=block_k, head0=head0, head_total=head_total)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ids_reference(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, **kw)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _count(flash_bwd_dkv_ids,
           _bwd_launch_ids("flash_bwd_dkv", q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, None, dk, dv, kw))
    return dk, dv


flash_fwd_with_ids.launches = 0  # tensor-core launches, as flash_attention's
flash_fwd_with_ids.simt_launches = 0
flash_bwd_dq_ids.launches = 0  # tensor-core launches, as flash_bwd_dq's
flash_bwd_dq_ids.simt_launches = 0
flash_bwd_dkv_ids.launches = 0
flash_bwd_dkv_ids.simt_launches = 0


def flash_bwd_with_ids(q, k, v, o, do, lse, kpad_bias, q_ids, kv_ids, *, scale, causal, seed=None,
                       dropout_rate=0.0, counter_len=None, block_q=None, block_k=None, head0=None,
                       head_total=None):
    """Backward of one ring pair given the global output ``o``, its
    gradient ``do`` and the global lse [B, H, T] (1e30 sentinel rows):
    ``(dq, dk, dv)`` in fp32, with delta = rowsum(dO * O) taken first in one
    fp32 reduction."""
    kw = dict(scale=scale, causal=causal, seed=seed, dropout_rate=dropout_rate, counter_len=counter_len,
              block_q=block_q, block_k=block_k, head0=head0, head_total=head_total)
    delta = attention_delta(o, do)
    dq = flash_bwd_dq_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, **kw)
    dk, dv = flash_bwd_dkv_ids(q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, **kw)
    return dq, dk, dv


def _bwd_launch_ids(kernel, q, k, v, do, lse, delta, kpad_bias, q_ids, kv_ids, dq, dk, dv, kw):
    _check_ids(q, k, q_ids, kv_ids)
    bq, bk, s_pad = _ids_tiling(kw["block_q"], kw["block_k"], q.shape[1], k.shape[1])
    return _bwd_launch(kernel, q, k, v, do, lse, delta, kpad_bias, dq, dk, dv, kw["seed"], kw["head0"],
                       kw["scale"], kw["causal"], None, kw["dropout_rate"], bq, bk, kw["head_total"],
                       kw["counter_len"], ids=(_ids_arg(q_ids, q.device), _ids_arg(kv_ids, q.device)))


_LIB = None  # csrc/flash_fwd.cu, loaded at the first launch
_BWD_LIB = None  # csrc/flash_bwd.cu


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("flash_fwd")
        c_int, c_uint, c_ll, c_float, c_ptr = (
            ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
        )
        lib.smp_flash_fwd.argtypes = (
            [c_int, c_int] + [c_ptr] * 8 + [c_int] * 5 + [c_ll] * 13
            + [c_float, c_int, c_int, c_int, c_uint, c_uint, c_uint, c_float]
            + [c_int] * 5 + [c_ptr]
        )
        lib.smp_flash_fwd.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_kernel():
    global _BWD_LIB
    if _BWD_LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("flash_bwd")
        c_int, c_uint, c_float, c_ptr = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
        tail = (
            [c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [c_float, c_int, c_int, c_int, c_uint, c_uint, c_uint, c_float, c_int, c_int, c_ptr]
        )
        lib.smp_flash_bwd_dq.argtypes = [c_int, c_int] + [c_ptr] * 10 + tail
        lib.smp_flash_bwd_dkv.argtypes = [c_int, c_int] + [c_ptr] * 11 + tail
        lib.smp_flash_bwd_dq.restype = c_int
        lib.smp_flash_bwd_dkv.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB
