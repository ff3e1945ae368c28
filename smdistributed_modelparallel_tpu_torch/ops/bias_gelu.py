"""Fused bias + tanh-GELU, forward and backward: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_gelu.py``:
``bias_gelu`` and its ``custom_vjp``, whose kernels are ``_fwd_kernel``
(``gelu(x + b)``) and ``_bwd_kernel`` (``dpre = g * gelu'(x + b)`` in
fp32). Here they are the two kernels of ``csrc/bias_gelu.cu``, wired by a
``torch.autograd.Function`` whose backward then forms ``dx = dpre`` in x's
dtype and ``db`` = the fp32 row sum of dpre in b's dtype, as ``_bg_bwd``
does. Each kernel's wrapper (``bias_gelu_fwd``, ``bias_gelu_bwd``) runs its
plain PyTorch version for tensors on the CPU and its kernel for CUDA
tensors; it never falls back from one to the other, and counts its kernel's
launches in ``.launches``.

Both versions compute in fp32 from ``u = float(x) + float(b)`` in the TPU
kernel's order of operations; the forward rounds once to x's dtype, the
backward keeps dpre in fp32 so that db sums unrounded values.
"""

import ctypes
import math

import torch

_SQRT_2_OVER_PI = float(math.sqrt(2.0 / math.pi))
_COEFF = 0.044715

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _gelu_tanh(u):
    inner = _SQRT_2_OVER_PI * (u + _COEFF * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(inner))


def _dgelu_tanh(u):
    inner = _SQRT_2_OVER_PI * (u + _COEFF * u * u * u)
    t = torch.tanh(inner)
    sech2 = 1.0 - t * t
    dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _COEFF * u * u)
    return 0.5 * (1.0 + t) + 0.5 * u * sech2 * dinner


def reference_bias_gelu(x, b):
    """Plain PyTorch version of the forward kernel: ``gelu_tanh(x + b)`` in
    fp32, rounded to x's dtype."""
    return _gelu_tanh(x.float() + b.float()).to(x.dtype)


def reference_bias_gelu_bwd(x, b, g):
    """Plain PyTorch version of the backward kernel: ``g * gelu'(x + b)``,
    fp32."""
    return g.float() * _dgelu_tanh(x.float() + b.float())


def _check_cuda(name, x, b, g=None):
    """The kernels' contract: x [..., F] (and g, its shape and dtype) in one
    of fp32, fp16 or bf16, b a floating [F], all on one CUDA device."""
    tensors = (x, b) + (() if g is None else (g,))
    if not (x.is_cuda and all(a.device == x.device for a in tensors)):
        raise ValueError(f"{name}: inputs must share one CUDA device, got {[str(a.device) for a in tensors]}")
    if x.dtype not in _DTYPE_CODE or (g is not None and g.dtype != x.dtype):
        raise TypeError(f"{name} kernel takes x (and g) in one of {list(_DTYPE_CODE)}; got "
                        f"{x.dtype}{'' if g is None else f', {g.dtype}'}")
    if x.dim() < 1 or b.shape != (x.shape[-1],) or not b.dtype.is_floating_point:
        raise ValueError(f"{name}: b must be a floating [{x.shape[-1] if x.dim() else '?'}], got "
                         f"{b.dtype} {tuple(b.shape)}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"{name}: g must be shaped like x {tuple(x.shape)}, got {tuple(g.shape)}")


def _launch(name, bwd, x, b, g, out):
    F = x.shape[-1]
    N = x.numel() // F if F else 0
    bf = b.float().contiguous()  # exact: the kernels add in fp32
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.smp_bias_gelu(
            _DTYPE_CODE[x.dtype], int(bwd), x.data_ptr(), bf.data_ptr(), None if g is None else g.data_ptr(),
            out.data_ptr(), N, F, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.smp_cuda_error_string(err).decode()}")


def bias_gelu_fwd(x, b):
    """``gelu_tanh(x + b)`` in x's dtype over x [..., F] and b [F]: the
    plain version for CPU tensors, ``csrc/bias_gelu.cu``'s forward kernel
    (``_fwd_kernel``'s counterpart) for CUDA tensors, else it raises."""
    if x.device.type == "cpu":
        return reference_bias_gelu(x, b)
    _check_cuda("bias_gelu_fwd", x, b)
    x = x.contiguous()
    y = torch.empty_like(x)
    _launch("bias_gelu_fwd", False, x, b, None, y)
    bias_gelu_fwd.launches += 1
    return y


def bias_gelu_bwd(x, b, g):
    """``dpre = g * gelu_tanh'(x + b)``, fp32 and shaped like x: the plain
    version for CPU tensors, ``csrc/bias_gelu.cu``'s backward kernel
    (``_bwd_kernel``'s counterpart) for CUDA tensors, else it raises."""
    if x.device.type == "cpu":
        return reference_bias_gelu_bwd(x, b, g)
    _check_cuda("bias_gelu_bwd", x, b, g)
    x, g = x.contiguous(), g.contiguous()
    dpre = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("bias_gelu_bwd", True, x, b, g, dpre)
    bias_gelu_bwd.launches += 1
    return dpre


bias_gelu_fwd.launches = 0  # launches of csrc/bias_gelu.cu's forward
bias_gelu_bwd.launches = 0  # ... of its backward


class _BiasGeluFn(torch.autograd.Function):
    """``bias_gelu`` with ``_bg_bwd``'s backward: the forward saves (x, b);
    the backward runs the dpre kernel, then dx = dpre in x's dtype and db =
    the fp32 row sum of dpre in b's dtype."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.save_for_backward(x, b)
        return bias_gelu_fwd(x, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dpre = bias_gelu_bwd(x, b, g.to(x.dtype))
        dx = dpre.to(x.dtype) if ctx.needs_input_grad[0] else None
        db = dpre.reshape(-1, x.shape[-1]).sum(0).to(b.dtype) if ctx.needs_input_grad[1] else None
        return dx, db


def bias_gelu(x, b):
    """``gelu(x + b)`` (tanh approximation) over ``x [..., F]`` and ``b
    [F]`` in one fused pass. Differentiable in x and b. CPU tensors run the
    plain versions; CUDA tensors launch ``csrc/bias_gelu.cu`` or raise."""
    return _BiasGeluFn.apply(x, b)


def _is_cuda(x):
    """Whether the kernels would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch)."""
    return x.is_cuda


def bias_gelu_ok(activation, x):
    """Dispatch precondition: the tanh-GELU family (HF "gelu_new", the
    reference's fused bias_gelu polynomial) and, for the JAX gate's "on
    TPU", the activation ``x`` on a CUDA device."""
    return activation in ("gelu", "gelu_new") and _is_cuda(x)


_LIB = None  # csrc/bias_gelu.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("bias_gelu")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.smp_bias_gelu.argtypes = [c_int, c_int] + [c_ptr] * 4 + [c_int, c_int, c_ptr]
        lib.smp_bias_gelu.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
