"""Matrix product with the bias in the epilogue (the fused QKV projection):
the CUDA kernel's wrapper and its plain version.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_qkv.py``:
``matmul_bias`` and its ``custom_vjp``, whose forward kernel is
``_mm_bias_kernel``. Here the forward is ``csrc/matmul_bias.cu``, wired by a
``torch.autograd.Function`` whose backward is ``_mb_bwd``'s plain fp32
products (``torch.matmul``, as the JAX package leaves them to XLA). The
kernel's wrapper ``matmul_bias_fwd`` runs the plain version for tensors on
the CPU and a kernel for CUDA tensors; it never falls back from one to the
other.

Two kernels, one contract, and ``_route`` picks by the operands alone:
``"wgmma"`` (tensor cores fed by TMA) for bf16 and fp16 operands whose rows
are a multiple of 16 bytes (D % 8 == 0) on 16-byte aligned bases, which are
TMA's rules; ``"simt"`` (the CUDA cores) for the rest, fp32 operands (the
tensor cores offer fp32 only as TF32, which the contract excludes) and a D
or pointer that TMA cannot take. A route never gives way to the other when a
build or a launch fails. ``matmul_bias_fwd.launches`` counts the
tensor-core launches, ``.simt_launches`` the CUDA-core ones.

Layout: ``w`` is the port's parameter as the attention layer holds it, an
``nn.Linear``-style [F, D] weight, i.e. the JAX kernel's w [D, F]
transposed. Both versions compute ``y = x w^T + b`` as the TPU kernel does:
operands cast to fp32, an fp32 product, the bias added in fp32 once the sum
is complete, one rounding to x's dtype.

The JAX gate ``fused_qkv_ok`` also refuses a D for which no tile fits the
TPU's 12 MiB VMEM budget (``_auto_blocks``: D above about 19.6k). Both CUDA
kernels stream D through shared memory, so together they take any D and the
port's gate never refuses one.
"""

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def reference_matmul_bias(x, w, b=None):
    """Plain PyTorch version of the kernel: ``x [N, D] @ w[F, D]^T (+ b [F])``
    in fp32, one rounding to x's dtype."""
    y = x.float() @ w.float().t()
    if b is not None:
        y = y + b.reshape(-1).float()
    return y.to(x.dtype)


def _check_cuda(x, w, b):
    """The kernels' contract: x [N, D] and w [F, D] of one dtype (fp32, fp16
    or bf16) and b [F] (any floating dtype), all on one CUDA device."""
    tensors = (x, w) + (() if b is None else (b,))
    if not (_is_cuda(x) and all(a.device == x.device for a in tensors)):
        raise ValueError(f"matmul_bias: inputs must share one CUDA device, got {[str(a.device) for a in tensors]}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"matmul_bias kernel takes x and w in one of {list(_DTYPE_CODE)}; got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"matmul_bias: x must be [N, D] and w [F, D], got {tuple(x.shape)}, {tuple(w.shape)}")
    if b is not None and (b.numel() != w.shape[0] or not b.dtype.is_floating_point):
        raise ValueError(f"matmul_bias: b must be a floating [{w.shape[0]}], got {b.dtype} {tuple(b.shape)}")


def _route(dtype, D, x_ptr, w_ptr):
    """The kernel that takes x [N, D] and w [F, D] of ``dtype`` at these
    addresses: ``"wgmma"`` when TMA can stage them (bf16 or fp16, rows of a
    positive multiple of 16 bytes, 16-byte aligned bases), else ``"simt"``."""
    if dtype not in (torch.bfloat16, torch.float16) or D <= 0:
        return "simt"
    return "wgmma" if (2 * D) % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0 else "simt"


def matmul_bias_fwd(x, w, b=None):
    """``x @ w^T (+ b)`` in x's dtype: the plain version for CPU tensors, one
    of ``csrc/matmul_bias.cu``'s kernels (``_mm_bias_kernel``'s counterpart;
    ``_route`` picks) for CUDA tensors, else it raises."""
    if x.device.type == "cpu":
        return reference_matmul_bias(x, w, b)
    _check_cuda(x, w, b)
    x, w = x.contiguous(), w.contiguous()
    if b is not None:  # the kernels read a bias in x's dtype or in fp32 as it is
        b = b.reshape(-1).contiguous()
        if b.dtype != x.dtype:
            b = b.float()  # as the plain version widens (or rounds) it
    y = torch.empty((x.shape[0], w.shape[0]), dtype=x.dtype, device=x.device)
    route = _route(x.dtype, x.shape[1], x.data_ptr(), w.data_ptr())
    _launch(route, x, w, b, y)
    if route == "wgmma":
        matmul_bias_fwd.launches += 1
    else:
        matmul_bias_fwd.simt_launches += 1
    return y


matmul_bias_fwd.launches = 0  # launches of the tensor-core kernel
matmul_bias_fwd.simt_launches = 0  # launches of the CUDA-core kernel


def _launch(route, x, w, b, y):
    """Launch ``route``'s kernel on x's device and current stream; raise if
    the launch was refused. ``b`` is None or a contiguous [F] bias in x's
    dtype or in fp32."""
    lib = _kernel()
    entry = lib.smp_matmul_bias_wgmma if route == "wgmma" else lib.smp_matmul_bias_simt
    (N, D), F = x.shape, w.shape[0]
    bias = (None, 1) if b is None else (b.data_ptr(), int(b.dtype == torch.float32))
    with torch.cuda.device(x.device):
        err = entry(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), *bias, y.data_ptr(), N, D, F,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_bias ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


class _MatmulBiasFn(torch.autograd.Function):
    """``matmul_bias`` with ``_mb_bwd``'s backward: dy in fp32, dx = dy w
    and dw = dy^T x as fp32 products cast to x's and w's dtypes, db the fp32
    row sum cast to dy's dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.had_bias = b is not None
        return matmul_bias_fwd(x, w, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dyf = dy.float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (dyf @ w.float()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (dyf.t() @ x.float()).to(w.dtype)
        if ctx.had_bias and ctx.needs_input_grad[2]:
            db = dyf.sum(0).to(dy.dtype)
        return dx, dw, db


def matmul_bias(x, w, b=None):
    """``x [N, D] @ w [F, D]^T (+ b [F])`` through the fused kernel (bias in
    the epilogue, one pass over the output). Differentiable in x, w and b;
    the backward is plain fp32 products. CPU tensors run the plain version."""
    return _MatmulBiasFn.apply(x, w, None if b is None else b.reshape(-1))


def _is_cuda(x):
    """Whether the kernel would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch)."""
    return x.is_cuda


def fused_qkv_ok(x, ring=False, tp=1):
    """Dispatch precondition for the fused QKV projection: the JAX package's
    ``fused_qkv_ok`` with "on TPU" read as "the activation ``x`` [..., D] is
    a CUDA tensor", and at tp > 1 only inside the ring. Any D runs (see the
    module docstring), so D does not enter."""
    if not _is_cuda(x):
        return False
    return not (tp > 1 and not ring)


_LIB = None  # csrc/matmul_bias.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("matmul_bias")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        for entry in (lib.smp_matmul_bias_wgmma, lib.smp_matmul_bias_simt):
            entry.argtypes = [c_int] + [c_ptr] * 3 + [c_int, c_ptr] + [c_int] * 3 + [c_ptr]
            entry.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
