"""Fused LM-head cross-entropy: the CUDA kernels' wrappers and their plain
versions.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_ce.py``:
``fused_lm_head_ce`` and its ``custom_vjp``, whose kernels are the forward
``_fwd_kernel`` and the backward ``_bwd_dx_kernel`` / ``_bwd_dw_kernel``.
Here they are the three kernels of ``csrc/fused_ce.cu``, wired together by
a ``torch.autograd.Function``. Each kernel's wrapper (``fused_ce_fwd``,
``fused_ce_bwd_dx``, ``fused_ce_bwd_dw``) runs its plain PyTorch version for
tensors on the CPU and its kernel for CUDA tensors; it never falls back from
one to the other.

The CE of ``x @ w^T`` (x [N, D], w [V, D], the tied head's layout) never
materializes the [N, V] logits. Both versions reproduce the TPU kernels'
conventions:
  - logits are fp32 products of the fp32-cast inputs; columns >= V are
    -1e30 and count for nothing;
  - a target outside [0, V) never hits, so its target logit is 0;
  - lse = m + log(max(l, 1e-30)) from the online max m and sum-exp l;
  - the backward recomputes p = exp(logits - lse) from the saved lse and
    forms dlog = (p - target_mass) * g with target_mass = (1 - eps) onehot +
    eps / (smooth_denom or V) on the valid columns, rounded in that order;
    dx and dW are fp32 sums cast to x's and w's dtypes.

``block_n``/``block_v`` are the TPU kernel's tiling and are reference
coordinates only: ``block_v`` sets the plain versions' vocab chunks (their
memory is O(N * block_v)); the CUDA kernels' own tiles are stated in
``csrc/fused_ce.cu``.

Each kernel has two forms, one contract, picked by the operands alone. The
forward's ``_fwd_route``: ``"wgmma"`` (tensor cores fed by TMA: 128 x 256
tiles of z in registers, D streamed, an online-softmax epilogue) for bf16 or
fp16 x and w, contiguous, D a multiple of 8 on 16-byte aligned bases;
``"simt"`` (the CUDA cores: 64 x 64 tiles of z, D streamed 32 columns at a
time, so every D runs) for the rest. The backward's ``_route``, for each of
dx and dW:
``"wgmma"`` (tensor cores fed by TMA: a cluster of ceil(D / 256) CTAs splits
D, each holds its 256 columns of the fp32 sum of 128 owned rows in
registers, and fp32 dlog enters the products as a bf16 hi/lo pair) for bf16
x and w, contiguous, D a multiple of 8 up to 2048 on 16-byte aligned bases;
``"simt"`` (the CUDA cores, 64 x 64 tiles, D streamed) for the rest. fp32
has no tensor-core form in the contract (TF32 keeps 11 bits), and fp16
would flush dlog (~p / N, often below 6e-5) into its subnormals. A route
never gives way to the other when a build or a launch fails. Each wrapper's
``.launches`` counts the tensor-core launches, ``.simt_launches`` the
CUDA-core ones.
"""

import ctypes
import os

import torch

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_TILE = 64  # rows and vocab columns of a tile of csrc/fused_ce.cu
_MAX_CHUNKS = 16   # bounds the fp32 partial buffers: chunks x rows x D
_TC_OWNED = 128    # owned rows of a tensor-core cluster
_TC_MAX_D = 2048   # 256 columns a CTA, 8 CTAs a cluster (the portable limit)
_TC_FWD_ROWS, _TC_FWD_COLS = 128, 256  # a tensor-core forward CTA's rows, and the vocab columns of its tiles


def _chunks(width, lo, hi):
    """[c0, c1) ranges of ``width``-wide chunks of [lo, hi)."""
    return [(c, min(c + width, hi)) for c in range(lo, hi, width)]


def fused_ce_fwd_reference(x, w, targets, smoothing=0.0, block_v=1024):
    """Plain PyTorch version of the forward kernel: the online max/sum-exp
    over ``block_v``-wide vocab chunks, in fp32.

    Returns ``(lse, tgt, logit_sum or None)``, each fp32 [N]."""
    N = x.shape[0]
    V = w.shape[0]
    block_v = min(block_v, V)
    xf = x.float()
    t = targets.long()
    m = torch.full((N,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros(N, dtype=torch.float32, device=x.device)
    tgt = torch.zeros_like(l)
    logit_sum = torch.zeros_like(l) if smoothing else None
    for v0, v1 in _chunks(block_v, 0, V):
        # The TPU kernel's padding columns (-1e30) add exp(-1e30 - m) = 0.
        logits = xf @ w[v0:v1].float().t()
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = torch.exp(m - m_new) * l + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        hit = (t >= v0) & (t < v1)
        picked = logits.gather(1, torch.where(hit, t - v0, 0)[:, None])[:, 0]
        tgt = tgt + torch.where(hit, picked, 0.0)
        if smoothing:
            logit_sum = logit_sum + logits.sum(dim=1)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return lse, tgt, logit_sum


def _dlog(logits, v0, t, lse, g, smoothing, smooth_denom, V):
    """(p - target_mass) * g of one vocab chunk, as the TPU kernels form it."""
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(v0, v0 + logits.shape[1], device=logits.device)
    target_mass = (cols[None, :] == t[:, None]).float()
    if smoothing:
        target_mass = (1.0 - smoothing) * target_mass + smoothing / (smooth_denom or V)
    return (p - target_mass) * g[:, None]


def fused_ce_bwd_dx_reference(x, w, targets, lse, g, smoothing=0.0,
                              smooth_denom=None, block_v=1024):
    """Plain PyTorch version of the dx kernel: sum over ``block_v``-wide
    vocab chunks of dlog @ w in fp32, cast to x's dtype."""
    V = w.shape[0]
    xf = x.float()
    t = targets.long()
    lse = lse.float()
    g = g.float()
    dx = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for v0, v1 in _chunks(min(block_v, V), 0, V):
        wf = w[v0:v1].float()
        dx += _dlog(xf @ wf.t(), v0, t, lse, g, smoothing, smooth_denom, V) @ wf
    return dx.to(x.dtype)


def fused_ce_bwd_dw_reference(x, w, targets, lse, g, smoothing=0.0,
                              smooth_denom=None, block_v=1024):
    """Plain PyTorch version of the dW kernel: per ``block_v``-wide vocab
    chunk, dlog^T @ x in fp32, cast to w's dtype."""
    V = w.shape[0]
    xf = x.float()
    t = targets.long()
    lse = lse.float()
    g = g.float()
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    for v0, v1 in _chunks(min(block_v, V), 0, V):
        wf = w[v0:v1].float()
        dlog = _dlog(xf @ wf.t(), v0, t, lse, g, smoothing, smooth_denom, V)
        dw[v0:v1] = (dlog.t() @ xf).to(w.dtype)
    return dw


def _assemble_loss(lse, tgt, logit_sum, V, smoothing):
    if not smoothing:
        return lse - tgt
    # loss = (1-eps)*(lse - tgt) + eps*(lse - mean(logits))
    #      = lse - (1-eps)*tgt - (eps/V)*sum(logits)
    return lse - (1.0 - smoothing) * tgt - (smoothing / V) * logit_sum


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_cuda(name, x, w, targets, *rows):
    """The kernels' contract: x [N, D] and w [V, D] of one dtype (fp32, fp16
    or bf16) and [N] targets and per-row vectors, all on one CUDA device."""
    tensors = (x, w, targets) + rows
    if not (_is_cuda(x) and all(a.device == x.device for a in tensors)):
        raise ValueError(f"{name}: inputs must share one CUDA device, got {[str(a.device) for a in tensors]}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes x and w in one of {list(_DTYPE_CODE)}; got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x must be [N, D] and w [V, D], got {tuple(x.shape)}, {tuple(w.shape)}")
    N, V = x.shape[0], w.shape[0]
    if N < 1 or V < 1:
        raise ValueError(f"{name}: needs N >= 1 and V >= 1, got N={N}, V={V}")
    if any(a.shape != (N,) for a in (targets,) + rows):
        raise ValueError(f"{name}: targets and per-row vectors must be [{N}], got "
                         f"{[tuple(a.shape) for a in (targets,) + rows]}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"{name}: targets must be integers, got {targets.dtype}")


def _chunk_tiles(owned, walked, device):
    """Tiles of the walked dimension per CTA of the CUDA-core kernels: enough
    chunks of it that the grid holds about four CTAs per SM, at most
    ``_MAX_CHUNKS``."""
    owned_tiles = -(-owned // _KERNEL_TILE)
    walked_tiles = -(-walked // _KERNEL_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = min(walked_tiles, _MAX_CHUNKS, max(1, -(-4 * sms // owned_tiles)))
    per = -(-walked_tiles // chunks)
    return per, -(-walked_tiles // per)


def _fill_chunks(blocks, walked_tiles, slots):
    """(tiles per chunk, chunks) of a walk of ``walked_tiles`` tiles split
    over a grid of ``blocks`` x chunks, of which ``slots`` run at once: the
    fewest chunks (at most ``_MAX_CHUNKS``) that fill at least 85% of the
    card's last wave, else the chunk count that fills it best."""
    mc = max(1, slots)

    def fill(c):
        return blocks * c / (-(-blocks * c // mc) * mc)

    candidates = range(1, min(_MAX_CHUNKS, walked_tiles) + 1)
    chunks = next((c for c in candidates if fill(c) >= 0.85), None)
    if chunks is None:
        chunks = max(candidates, key=lambda c: (fill(c), -c))
    per = -(-walked_tiles // chunks)
    return per, -(-walked_tiles // per)


def _cluster_chunks(owned, walked, max_clusters):
    """(tiles per chunk, chunks) of the walked dimension for the tensor-core
    backward, whose grid is one cluster per (128 owned rows, chunk) and of
    which ``max_clusters`` fit the card at once (``_fill_chunks``). One chunk
    needs no fp32 partial buffer."""
    return _fill_chunks(-(-owned // _TC_OWNED), -(-walked // _KERNEL_TILE), max_clusters)


def _fwd_chunks(N, V, sms):
    """(256-wide vocab tiles per chunk, chunks) for the tensor-core forward,
    whose grid is one CTA per (128 rows, chunk), one CTA an SM (its ring
    takes 192 KB of shared memory), so ``sms`` run at once
    (``_fill_chunks``)."""
    return _fill_chunks(-(-N // _TC_FWD_ROWS), -(-V // _TC_FWD_COLS), sms)


_MAX_CLUSTERS = {}  # (device index, dw, D) -> cudaOccupancyMaxActiveClusters


def max_clusters(device, dw, D):
    """How many clusters of the tensor-core dx (or, with ``dw``, dW) kernel
    at this D the card holds at once."""
    key = (torch.device(device).index, bool(dw), int(D))
    if key not in _MAX_CLUSTERS:
        lib = _kernel()
        with torch.cuda.device(device):
            n = lib.smp_fused_ce_bwd_wgmma_clusters(int(bool(dw)), int(D))
        if n <= 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {lib.smp_cuda_error_string(-n).decode()}")
        _MAX_CLUSTERS[key] = n
    return _MAX_CLUSTERS[key]


def _route(x, w):
    """The backward kernel that takes x [N, D] and w [V, D]: ``"wgmma"``
    (tensor cores fed by TMA) for bf16, contiguous, D a multiple of 8 (rows
    of 16 bytes, TMA's rule) up to 2048 (a cluster of at most 8 CTAs of 256
    columns) on 16-byte aligned bases; else ``"simt"`` (the CUDA cores): fp32
    and fp16 (see the module docstring), ragged or misaligned operands."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return "simt"
    D = x.shape[-1]
    if not (0 < D <= _TC_MAX_D and D % 8 == 0 and x.is_contiguous() and w.is_contiguous()):
        return "simt"
    return "wgmma" if x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 else "simt"


def _fwd_route(x, w):
    """The forward kernel that takes x [N, D] and w [V, D]: ``"wgmma"`` for
    bf16 or fp16, both of one dtype, contiguous, D a multiple of 8 on
    16-byte aligned bases (D has no upper bound: it is the K loop); else
    ``"simt"``: fp32 (no TF32 in the contract), ragged or misaligned
    operands."""
    if x.dtype not in (torch.bfloat16, torch.float16) or w.dtype != x.dtype:
        return "simt"
    D = x.shape[-1]
    if not (D > 0 and D % 8 == 0 and x.is_contiguous() and w.is_contiguous()):
        return "simt"
    return "wgmma" if x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 else "simt"


def _args(x, w, targets):
    return x.contiguous(), w.contiguous(), targets.to(torch.int32).contiguous()


def _count(fn, route):
    """One launch of ``fn``'s kernel: ``.launches`` counts the tensor-core
    route, ``.simt_launches`` the CUDA-core route."""
    if route == "wgmma":
        fn.launches += 1
    else:
        fn.simt_launches += 1


def fused_ce_fwd(x, w, targets, smoothing=0.0, block_v=1024):
    """Forward statistics ``(lse, tgt, logit_sum or None)``, fp32 [N]: the
    plain version for CPU tensors, one of ``csrc/fused_ce.cu``'s forward
    kernels (``_fwd_kernel``'s counterparts; ``_fwd_route`` picks) for CUDA
    tensors, else it raises."""
    if not _is_cuda(x):
        return fused_ce_fwd_reference(x, w, targets, smoothing, block_v)
    _check_cuda("fused_ce_fwd", x, w, targets)
    route = _fwd_route(x, w)
    x, w, t = _args(x, w, targets)
    N = x.shape[0]
    lse, tgt = (torch.empty(N, dtype=torch.float32, device=x.device) for _ in range(2))
    lsum = torch.empty(N, dtype=torch.float32, device=x.device) if smoothing else None
    _fwd_launch(route, x, w, t, lse, tgt, lsum)
    _count(fused_ce_fwd, route)
    return lse, tgt, lsum


def _fwd_launch(route, x, w, t, lse, tgt, lsum):
    """Launch ``route``'s forward kernel of ``csrc/fused_ce.cu`` and the
    merge of its chunks into lse, tgt and lsum (the logit sum, or None
    without smoothing) on x's device and current stream; raise if the launch
    was refused."""
    (N, D), V = x.shape, w.shape[0]
    lib = _kernel()
    if route == "wgmma":
        per, chunks = _fwd_chunks(N, V, torch.cuda.get_device_properties(x.device).multi_processor_count)
        entry = lib.smp_fused_ce_fwd_wgmma
    else:
        per, chunks = _chunk_tiles(N, V, x.device)
        entry = lib.smp_fused_ce_fwd
    part = torch.empty((4, chunks, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), t.data_ptr(), N, V, D,
            int(lsum is not None), per, part.data_ptr(), lse.data_ptr(), tgt.data_ptr(),
            None if lsum is None else lsum.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


def _bwd_launch(fn, dw, x, w, targets, lse, g, smoothing, smooth_denom):
    """dx (or, with ``dw``, dW) from ``_route``'s kernel, counted on ``fn``:
    ``.launches`` for the tensor cores, ``.simt_launches`` for the CUDA
    cores."""
    name = fn.__name__
    _check_cuda(name, x, w, targets, lse, g)
    route = _route(x, w)
    x, w, t = _args(x, w, targets)
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    out = torch.empty((w.shape[0] if dw else x.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    eps = float(smoothing)
    _launch(route, dw, x, w, t, lse, g, eps, eps / (smooth_denom or w.shape[0]) if eps else 0.0, out)
    _count(fn, route)
    return out


def _launch(route, dw, x, w, t, lse, g, eps, eps_d, out):
    """Launch ``route``'s dx (dW with ``dw``) kernel of ``csrc/fused_ce.cu``
    into ``out`` on x's device and current stream, with the fp32 partial
    buffer its walk chunks need; raise if the launch was refused."""
    (N, D), V = x.shape, w.shape[0]
    owned, walked = (V, N) if dw else (N, V)
    lib = _kernel()
    if route == "wgmma":
        per, chunks = _cluster_chunks(owned, walked, max_clusters(x.device, dw, D))
        entry = lib.smp_fused_ce_bwd_wgmma
    else:
        per, chunks = _chunk_tiles(owned, walked, x.device)
        entry = lib.smp_fused_ce_bwd
    part = None
    if chunks > 1 or route == "simt":
        part = torch.empty((chunks, owned, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(
            _DTYPE_CODE[x.dtype], int(dw), x.data_ptr(), w.data_ptr(), t.data_ptr(),
            lse.data_ptr(), g.data_ptr(), N, V, D, int(bool(eps)), 1.0 - eps, eps_d, per,
            None if part is None else part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        name = "fused_ce_bwd_dw" if dw else "fused_ce_bwd_dx"
        raise RuntimeError(f"{name} ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


def fused_ce_bwd_dx(x, w, targets, lse, g, smoothing=0.0, smooth_denom=None,
                    block_v=1024):
    """dx [N, D] in x's dtype: the plain version for CPU tensors, one of the
    dx kernels of ``csrc/fused_ce.cu`` (``_bwd_dx_kernel``'s counterparts;
    ``_route`` picks) for CUDA tensors, else it raises. ``lse`` is the
    forward's, ``g`` the fp32 loss cotangent (0 on ignored rows)."""
    if not _is_cuda(x):
        return fused_ce_bwd_dx_reference(x, w, targets, lse, g, smoothing, smooth_denom, block_v)
    return _bwd_launch(fused_ce_bwd_dx, False, x, w, targets, lse, g, smoothing, smooth_denom)


def fused_ce_bwd_dw(x, w, targets, lse, g, smoothing=0.0, smooth_denom=None,
                    block_v=1024):
    """dW [V, D] in w's dtype: the plain version for CPU tensors, one of the
    dW kernels of ``csrc/fused_ce.cu`` (``_bwd_dw_kernel``'s counterparts;
    ``_route`` picks) for CUDA tensors, else it raises."""
    if not _is_cuda(x):
        return fused_ce_bwd_dw_reference(x, w, targets, lse, g, smoothing, smooth_denom, block_v)
    return _bwd_launch(fused_ce_bwd_dw, True, x, w, targets, lse, g, smoothing, smooth_denom)


fused_ce_fwd.launches = 0          # launches of csrc/fused_ce.cu's tensor-core forward
fused_ce_fwd.simt_launches = 0     # ... of its CUDA-core forward
fused_ce_bwd_dx.launches = 0       # ... of its tensor-core dx kernel
fused_ce_bwd_dx.simt_launches = 0  # ... of its CUDA-core dx kernel
fused_ce_bwd_dw.launches = 0       # ... of its tensor-core dW kernel
fused_ce_bwd_dw.simt_launches = 0  # ... of its CUDA-core dW kernel


def _is_cuda(x):
    """Whether the kernels would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch)."""
    return x.is_cuda


class _FusedCEFn(torch.autograd.Function):
    """``fused_lm_head_ce`` with the TPU kernels' backward, as ``_fce_fwd`` /
    ``_fce_bwd`` wire it: the forward saves (x, w, targets, lse); the
    backward runs the dx and dW kernels."""

    @staticmethod
    def forward(ctx, x, w, targets, block_v, smoothing):
        lse, tgt, logit_sum = fused_ce_fwd(x, w, targets, smoothing, block_v)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.coords = (smoothing, block_v)
        return _assemble_loss(lse, tgt, logit_sum, w.shape[0], smoothing)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        smoothing, block_v = ctx.coords
        g = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_ce_bwd_dx(x, w, targets, lse, g, smoothing, None, block_v)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(x, w, targets, lse, g, smoothing, None, block_v)
        return dx, dw, None, None, None


def fused_lm_head_ce(x, w, targets, block_n=256, block_v=1024, label_smoothing=0.0):
    """Per-token CE of ``x @ w^T`` against ``targets`` without materializing
    the logits. x: [N, D]; w: [V, D]; targets: [N] int. ``label_smoothing``:
    HF/T5-convention uniform smoothing. Returns fp32 [N] losses,
    differentiable in x and w. ``block_n`` keeps the JAX signature: neither
    the plain versions nor the kernels tile rows by it.

    CPU tensors run the plain versions; CUDA tensors launch
    ``csrc/fused_ce.cu`` (fp32, fp16 or bf16; any D; on the tensor cores
    where ``_fwd_route`` and ``_route`` allow), or raise. x and w of
    different dtypes meet in the wider one (both kernels compute in fp32)."""
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
    return _FusedCEFn.apply(x, w, targets, block_v, float(label_smoothing))


def reference_lm_head_ce(x, w, targets):
    """Materialized-logits oracle of ``fused_lm_head_ce`` (no smoothing)."""
    logits = x.float() @ w.float().t()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[:, 0]
    tgt = logits.gather(-1, targets.long()[:, None])[:, 0]
    return lse - tgt


def auto_blocks(D, block_n=None, block_v=None):
    """(block_n, block_v) of the reference tiling: the given values, else the
    TPU kernel's defaults 256 and 1024. The TPU's 12 MiB VMEM budget does not
    carry over: the CUDA kernels stream D, so every D fits and this never
    returns None (None would mean "the kernel cannot run here")."""
    return (256 if block_n is None else block_n, 1024 if block_v is None else block_v)


def fused_ce_disabled():
    """``SMP_DISABLE_FUSED_CE=1``: the operator escape hatch."""
    return os.environ.get("SMP_DISABLE_FUSED_CE", "0") == "1"


def fused_ce_ok(x, w, block_n=None, block_v=None):
    """Dispatch precondition: x on a CUDA device and the escape hatch unset.
    Every block configuration runs (see ``auto_blocks``), so ``block_n`` and
    ``block_v`` only keep the JAX signature. Off the card it is False, as the
    JAX package's is off its TPU."""
    return x.is_cuda and not fused_ce_disabled()


_LIB = None  # csrc/fused_ce.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("fused_ce")
        c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        for entry in (lib.smp_fused_ce_fwd, lib.smp_fused_ce_fwd_wgmma):
            entry.argtypes = [c_int] + [c_ptr] * 3 + [c_int] * 5 + [c_ptr] * 5
            entry.restype = c_int
        for entry in (lib.smp_fused_ce_bwd, lib.smp_fused_ce_bwd_wgmma):
            entry.argtypes = [c_int, c_int] + [c_ptr] * 5 + [c_int] * 4 + [c_float, c_float, c_int] + [c_ptr] * 3
            entry.restype = c_int
        lib.smp_fused_ce_bwd_wgmma_clusters.argtypes = [c_int, c_int]
        lib.smp_fused_ce_bwd_wgmma_clusters.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
